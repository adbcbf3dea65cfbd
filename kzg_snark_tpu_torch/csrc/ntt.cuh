// Thread bodies of the NTT kernels (decimation in time, input in
// bit-reversed order, output in natural order).
//
// x and y are (NL, n) Fr arrays in Montgomery form; tw is the (NL, n/2) table
// of root powers w^k.  A stage of span s pairs i with i + s and multiplies
// the upper element by w^((i mod s) * n / (2 s)), the schedule of
// kzg_snark_tpu/ops/ntt.py NttContext._transform.
#pragma once

#include "chain.cuh"

// (lo, hi) = (lo + w hi, lo - w hi), the product on PROD_CHAIN
// (chain.cuh): the passes are bound by the product's instructions.
template <int NL>
KZG_HD void ntt_butterfly(uint32_t lo[NL], uint32_t hi[NL],
                          const uint32_t w[NL], const FieldConsts<NL>& F) {
  uint32_t prod[NL];
  fe_mul_chain(prod, hi, w, F);
  fe_sub(hi, lo, prod, F);
  fe_add(lo, lo, prod, F);
}

// A pass of the multi-stage kernel (ntt_kernels.cu k_ntt_pass): stages
// s0 .. s0 + g - 1 of a transform of n = 2^k.  Those stages combine the
// elements i = hi 2^(s0+g) + m 2^s0 + lo that share hi and lo, over the
// 2^g values of m.  A block holds 2^lcb consecutive lo columns x 2^g values
// of m, lcb = min(s0, tile_bits - g): local element e = m 2^lcb + lo_local,
// so a limb row is read in runs of 2^lcb consecutive words, and the first
// pass (s0 = 0) reads contiguous tiles.  In local terms stage s is a plain
// DIT stage of span S = 2^(lcb + s - s0) over the block's E = 2^(g + lcb)
// elements; it needs S twiddles, which the block stages in shared memory,
// every stage's at once, stage s at offset S - 2^lcb of an (NL, E) array.
//
// A block holds at most 2^NTT_MAX_TILE_BITS elements and as many
// twiddles, 64 bytes an element of shared memory.
#define NTT_MAX_TILE_BITS 11
#define NTT_THREADS 256

// The plan's tile, log2, for a transform of 2^log_n: at 2^14..2^18, the
// sizes where tiles were measured, the fastest there (PERF.md); elsewhere
// the former fixed tile, 10 bits: one pass up to 2^10, two to 2^20.  A
// transform of 2^k is ceil(k / t) passes.
#define NTT_TILE_BITS 10
KZG_HD int ntt_tile_bits(int log_n) {
  if (log_n < 14 || log_n > 18) return NTT_TILE_BITS;
  return log_n <= 15 ? 8 : log_n == 16 ? 9 : 10;
}

struct NttPass {
  int64_t n;       // transform size 2^k
  int s0, g;       // the pass runs stages s0 .. s0 + g - 1
  int lcb;         // log2 of the lo columns a block holds
  int ebits;       // log2 of the elements a block holds: g + lcb
  int64_t blocks;  // n / 2^ebits
};

KZG_HD NttPass ntt_pass_geometry(int64_t n, int s0, int g, int tile_bits) {
  NttPass P;
  P.n = n;
  P.s0 = s0;
  P.g = g;
  P.lcb = s0 < tile_bits - g ? s0 : tile_bits - g;
  P.ebits = g + P.lcb;
  P.blocks = n >> P.ebits;
  return P;
}

// Column of the block's first lo: (lo chunk) 2^lcb.
KZG_HD int64_t ntt_pass_lo0(const NttPass& P, int64_t b) {
  return (b & (((int64_t)1 << (P.s0 - P.lcb)) - 1)) << P.lcb;
}

// Global column of local element e of block b.
KZG_HD int64_t ntt_pass_col(const NttPass& P, int64_t b, int e) {
  int64_t hi = b >> (P.s0 - P.lcb);
  int lo = e & ((1 << P.lcb) - 1);
  return (hi << (P.s0 + P.g)) + ((int64_t)(e >> P.lcb) << P.s0) +
         ntt_pass_lo0(P, b) + lo;
}

// Tile word idx < NL 2^ebits (limb idx >> ebits, element idx mod 2^ebits of
// the (NL, 2^ebits) tile) is word ntt_pass_word(idx) of x, (NL, n).
KZG_HD int64_t ntt_pass_word(const NttPass& P, int64_t b, int idx) {
  int k = idx >> P.ebits;
  int e = idx & ((1 << P.ebits) - 1);
  return k * P.n + ntt_pass_col(P, b, e);
}

// Offset of local stage s's twiddles in the block's (NL, E) twiddle array.
KZG_HD int ntt_pass_tw_off(const NttPass& P, int s) {
  return (1 << (P.lcb + s - P.s0)) - (1 << P.lcb);
}

// Word idx < NL S of stage s's twiddles: its place in ws, (NL, E), and (the
// return value) its word in the (NL, n/2) table of w^j.  The element pairs
// at span 2^s take w^((i mod 2^s) n / 2^(s+1)); local q < S = 2^(lcb + s -
// s0), q = mm 2^lcb + lo_local, stands for i mod 2^s = mm 2^s0 + lo0 +
// lo_local.
KZG_HD int64_t ntt_pass_tw_word(const NttPass& P, int64_t b, int s, int idx,
                                int* dst) {
  int sb = P.lcb + s - P.s0;
  int k = idx >> sb;
  int q = idx & ((1 << sb) - 1);
  int64_t r = ((int64_t)(q >> P.lcb) << P.s0) + ntt_pass_lo0(P, b) +
              (q & ((1 << P.lcb) - 1));
  *dst = (k << P.ebits) + ntt_pass_tw_off(P, s) + q;
  return k * (P.n / 2) + r * (P.n >> (s + 1));
}

// Butterfly j < E/2 of local stage s on the tile xs (radix 2: the last
// stage of a pass with an odd number of stages).
template <int NL>
KZG_HD void ntt_pass_radix2(const NttPass& P, int s, uint32_t* xs,
                            const uint32_t* ws, int j,
                            const FieldConsts<NL>& F) {
  const int sb = P.lcb + s - P.s0;
  const int E = 1 << P.ebits;
  const int p = j & ((1 << sb) - 1);
  const int e0 = ((j >> sb) << (sb + 1)) + p;
  uint32_t a[NL], c[NL], w[NL];
  fe_load<NL>(a, xs, E, e0);
  fe_load<NL>(c, xs, E, e0 + (1 << sb));
  fe_load<NL>(w, ws, E, ntt_pass_tw_off(P, s) + p);
  ntt_butterfly(a, c, w, F);
  fe_store<NL>(xs, E, e0, a);
  fe_store<NL>(xs, E, e0 + (1 << sb), c);
}

// Group j < E/4 of local stages s and s + 1 (spans S and 2S) in registers:
// elements e0 + {0, S, 2S, 3S}; stage s pairs (0, 1) and (2, 3) with
// twiddle p, stage s + 1 pairs (0, 2) with p and (1, 3) with p + S.
template <int NL>
KZG_HD void ntt_pass_radix4(const NttPass& P, int s, uint32_t* xs,
                            const uint32_t* ws, int j,
                            const FieldConsts<NL>& F) {
  const int sb = P.lcb + s - P.s0;
  const int E = 1 << P.ebits;
  const int S = 1 << sb;
  const int p = j & (S - 1);
  const int e0 = ((j >> sb) << (sb + 2)) + p;
  const int wa = ntt_pass_tw_off(P, s) + p;
  const int wb = ntt_pass_tw_off(P, s + 1) + p;
  uint32_t x0[NL], x1[NL], x2[NL], x3[NL], w[NL];
  fe_load<NL>(x0, xs, E, e0);
  fe_load<NL>(x1, xs, E, e0 + S);
  fe_load<NL>(x2, xs, E, e0 + 2 * S);
  fe_load<NL>(x3, xs, E, e0 + 3 * S);
  fe_load<NL>(w, ws, E, wa);
  ntt_butterfly(x0, x1, w, F);
  ntt_butterfly(x2, x3, w, F);
  fe_load<NL>(w, ws, E, wb);
  ntt_butterfly(x0, x2, w, F);
  fe_load<NL>(w, ws, E, wb + S);
  ntt_butterfly(x1, x3, w, F);
  fe_store<NL>(xs, E, e0, x0);
  fe_store<NL>(xs, E, e0 + S, x1);
  fe_store<NL>(xs, E, e0 + 2 * S, x2);
  fe_store<NL>(xs, E, e0 + 3 * S, x3);
}

// K10: one stage combine on pre-aligned rows (the scan-mode NTT):
// out[i] = mask[i] ? xl[i] - tw[i] xu[i] : xl[i] + tw[i] xu[i] over (NL, n).
template <int NL>
KZG_HD void fr_butterfly_thread(int64_t i, const uint32_t* xl,
                                const uint32_t* xu, const uint32_t* tw,
                                const int32_t* mask, uint32_t* out, int64_t n,
                                const FieldConsts<NL>& F) {
  uint32_t a[NL], b[NL], w[NL], prod[NL];
  fe_load<NL>(a, xl, n, i);
  fe_load<NL>(b, xu, n, i);
  fe_load<NL>(w, tw, n, i);
  fe_mul(prod, b, w, F);
  if (mask[i]) {
    fe_sub(a, a, prod, F);
  } else {
    fe_add(a, a, prod, F);
  }
  fe_store<NL>(out, n, i, a);
}
