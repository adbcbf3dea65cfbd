// Pieces of the scan and power kernels (fr_scan_kernels.cu) that are plain
// per-thread code: element indexing, the scan's operation and identity, the
// single-pass scan's state (its tile records, the look-back's lane values,
// the reset), the power's thread body and the inversion route's per-thread
// steps.  __host__ __device__, so csrc/host_check.cpp runs the same code
// under g++ in the CPU tests.
//
// A scan reads n elements of an (NL, ld) limb-major array with column step
// inc (0 reads one element n times, 1 walks the array).  Logical element l
// of a forward scan is column l; of a reverse scan, column n - 1 - l.  The
// scan cuts the logical order into tiles of SCAN_TILE elements, a block a
// tile, each thread taking SCAN_PASS_PER consecutive ones.  The inversion
// route of fr_pow takes the same tiles, SCAN_PER elements a thread.
#pragma once

#include "inv.cuh"

#define SCAN_THREADS 128
#define SCAN_PER 4
#define SCAN_TILE (SCAN_THREADS * SCAN_PER)
// fr_scan's block: the same tile over 256 threads of 2 elements, so a
// block's chain of dependent products is shorter (a fold and an output
// each, where 4 elements take 3 and 3, for one more level of the block's
// scan).  fr_pow's inversion route keeps SCAN_THREADS and SCAN_PER.
#define SCAN_PASS_THREADS 256
#define SCAN_PASS_PER (SCAN_TILE / SCAN_PASS_THREADS)

enum { SCAN_OP_MUL = 0, SCAN_OP_ADD = 1 };

KZG_HD int64_t scan_col(int64_t l, int64_t n, bool reverse) {
  return reverse ? n - 1 - l : l;
}

KZG_HD int64_t scan_tiles(int64_t n) {
  return (n + SCAN_TILE - 1) / SCAN_TILE;
}

// The identity of the operation: Montgomery one for the product, 0 for
// the sum.
template <int OP, int NL>
KZG_HD void scan_identity(uint32_t r[NL], const FieldConsts<NL>& F) {
#pragma unroll
  for (int k = 0; k < NL; k++) r[k] = OP == SCAN_OP_MUL ? F.one[k] : 0u;
}

// r = a (op) b, the product on PROD_CHAIN (chain.cuh).  r may alias a or
// b.
template <int OP, int NL>
KZG_HD void scan_op(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL],
                    const FieldConsts<NL>& F) {
  if (OP == SCAN_OP_ADD) {
    fe_add(r, a, b, F);
  } else {
    fe_mul_chain(r, a, b, F);
  }
}

// Logical element l of the scan, or the identity past its end.
template <int OP, int NL>
KZG_HD void scan_load(uint32_t r[NL], const uint32_t* a, int64_t ld,
                      int64_t inc, int64_t l, int64_t n, bool reverse,
                      const FieldConsts<NL>& F) {
  if (l < n) {
    fe_load<NL>(r, a, ld, scan_col(l, n, reverse) * inc);
  } else {
    scan_identity<OP>(r, F);
  }
}

// The single-pass scan's state (fr_scan's scratch): 32-bit words, zero
// before a stream's first scan and left zero by every scan.  Word 0 is the
// tile ticket (a block takes the next tile when it starts, so it waits only
// on tiles whose blocks already run), word 1 counts the blocks done; tile
// t's record is the SCAN_REC words from SCAN_REC (t + 1): its flag, its
// aggregate (words 1 ..) and its inclusive prefix (words 1 + SCAN_MAX_NL
// ..).  The last block done clears the flags and both counters.
#define SCAN_REC 32
#define SCAN_MAX_NL 12
// Predecessors a look-back step reads: one a thread of fr_scan's block
// when the last tile reaches tile 0 in one step, else a warp's lanes (a
// step of the whole block costs every warp a butterfly, which blocks
// sharing an SM pay in scheduler slots).
#define SCAN_WINDOW SCAN_PASS_THREADS
#define SCAN_WINDOW_NARROW 32

KZG_HD int scan_window(int64_t tiles) {
  return tiles - 1 <= SCAN_WINDOW ? SCAN_WINDOW : SCAN_WINDOW_NARROW;
}

enum { SCAN_FLAG_NONE = 0, SCAN_FLAG_AGG = 1, SCAN_FLAG_INCL = 2 };

KZG_HD int64_t scan_state_words(int64_t n) {
  return SCAN_REC * (scan_tiles(n) + 1);
}

KZG_HD uint32_t* scan_rec(uint32_t* state, int64_t t) {
  return state + SCAN_REC * (t + 1);
}

// A word another block may have written in this launch: through the L2.
KZG_HD uint32_t scan_ld(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

// Tile t's aggregate (flag SCAN_FLAG_AGG) or inclusive prefix
// (SCAN_FLAG_INCL): the words, then the flag by a release store.
template <int NL>
KZG_HD void scan_publish(uint32_t* state, int64_t t, uint32_t flag,
                         const uint32_t v[NL]) {
  uint32_t* rec = scan_rec(state, t);
  uint32_t* dst = rec + 1 + (flag == SCAN_FLAG_INCL ? SCAN_MAX_NL : 0);
#pragma unroll
  for (int k = 0; k < NL; k++) dst[k] = v[k];
#ifdef __CUDA_ARCH__
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(rec), "r"(flag)
               : "memory");
#else
  rec[0] = flag;
#endif
}

// A total alone: tile t's aggregate, no flag (the block's count of done
// orders it before the last block reads it).
template <int NL>
KZG_HD void scan_put_aggregate(uint32_t* state, int64_t t,
                               const uint32_t v[NL]) {
  uint32_t* dst = scan_rec(state, t) + 1;
#pragma unroll
  for (int k = 0; k < NL; k++) dst[k] = v[k];
}

// Position i's value in a look-back step over the tiles hi, hi - 1, ...
// (tile = hi - i), given `first`, the lowest position whose tile holds its
// inclusive prefix (the window's size if none): the positions below it
// give their tiles' aggregates, position first its inclusive prefix, the
// others (and tiles below 0) the identity.  The step's result is the
// product or sum over its positions: the prefix of tiles hi - first .. hi
// if an inclusive prefix was found.
template <int OP, int NL>
KZG_HD void scan_lookback_value(uint32_t r[NL], uint32_t* state, int64_t tile,
                                int pos, int first,
                                const FieldConsts<NL>& F) {
  if (tile < 0 || pos > first) {
    scan_identity<OP>(r, F);
    return;
  }
  const uint32_t* src =
      scan_rec(state, tile) + 1 + (pos == first ? SCAN_MAX_NL : 0);
#pragma unroll
  for (int k = 0; k < NL; k++) r[k] = scan_ld(src + k);
}

// The last block done: the flags of the tiles and the two counters back to
// zero for the stream's next scan.
KZG_HD void scan_state_reset(uint32_t* state, int64_t tiles) {
  for (int64_t t = 0; t < tiles; t++) scan_rec(state, t)[0] = 0;
  state[0] = 0;
  state[1] = 0;
}

// r = b^e by square-and-multiply from the least significant bit on the
// PROD_CHAIN squaring and product; e has nbits = bit_length(e) bits, as NL
// words (low word first); b^0 = one for every b, so 0^0 = 1 and 0^e = 0
// for e > 0.  Where a bit is set, the product and the next squaring are
// independent and sit in one basic block, so the scheduler can overlap
// them: the chain is about nbits products long, not nbits plus the number
// of set bits.  r may alias b.
template <int NL>
KZG_HD void fe_pow_chain(uint32_t r[NL], const uint32_t b[NL],
                         const uint32_t e[NL], int nbits,
                         const FieldConsts<NL>& F) {
  uint32_t x[NL], acc[NL];
  fe_copy<NL>(acc, F.one);
  if (nbits > 0) {
    fe_copy<NL>(x, b);
#pragma unroll 1
    for (int k = 0; k + 1 < nbits; k++) {
      if ((e[k >> 5] >> (k & 31)) & 1u) {
        fe_mul_chain(acc, acc, x, F);
        fe_sqr_chain(x, x, F);
      } else {
        fe_sqr_chain(x, x, F);
      }
    }
    fe_mul_chain(acc, acc, x, F);  // the top bit is set
  }
  fe_copy<NL>(r, acc);
}

// a^e for column i of an (NL, n) array (the general route of fr_pow).
template <int NL>
KZG_HD void fe_pow_thread(int64_t i, const uint32_t* a, uint32_t* out,
                          int64_t n, const uint32_t e[NL], int nbits,
                          const FieldConsts<NL>& F) {
  uint32_t r[NL];
  fe_load<NL>(r, a, n, i);
  fe_pow_chain(r, r, e, nbits, F);
  fe_store<NL>(out, n, i, r);
}

// fr_pow's route depends only on the exponent: e = p - 2 (an inversion, 0
// mapping to 0) takes the block-batched inversion, any other e the
// square-and-multiply.
template <int NL>
KZG_HD bool pow_is_inversion(const uint32_t e[NL], const FieldConsts<NL>& F) {
  uint32_t two[NL] = {2u}, pm2[NL];
  fe_sub_raw<NL>(pm2, F.p, two);
  uint32_t diff = 0;
#pragma unroll
  for (int k = 0; k < NL; k++) diff |= pm2[k] ^ e[k];
  return diff == 0;
}

// The inversion route, per block a tile of SCAN_TILE elements (Montgomery's
// trick as a product tree, 4 levels): a thread's SCAN_PER = 4 elements,
// zeros taken as one, give the pair products p01, p23 and their total
// (inv_chunk_up); the block finds each thread's "others", the product of
// every other thread's total (a butterfly across the warp, then across the
// warps), and inverts the tile's total once; a thread's total inverse is
// its others times that inverse, and inv_chunk_down sends it down the pair
// tree: 1 / c0 = c1 / p01 = c1 p23 / t, and so on, zeros back to 0.
static_assert(SCAN_PER == 4, "the inversion's pair tree takes 4 elements");

// x = one where x = 0; returns whether it was 0.
template <int NL>
KZG_HD bool inv_zero_as_one(uint32_t x[NL], const FieldConsts<NL>& F) {
  const bool z = fe_is_zero<NL>(x);
  fe_select<NL>(x, z, F.one, x);
  return z;
}

// c0..c3 (no zero) -> p01 = c0 c1, p23 = c2 c3, tot = p01 p23.
template <int NL>
KZG_HD void inv_chunk_up(const uint32_t c0[NL], const uint32_t c1[NL],
                         const uint32_t c2[NL], const uint32_t c3[NL],
                         uint32_t p01[NL], uint32_t p23[NL],
                         uint32_t tot[NL], const FieldConsts<NL>& F) {
  fe_mul_chain(p01, c0, c1, F);
  fe_mul_chain(p23, c2, c3, F);
  fe_mul_chain(tot, p01, p23, F);
}

// One level of the butterfly: the partner group's product y joins both
// the group's product acc and the others oth.
template <int NL>
KZG_HD void inv_others_step(uint32_t acc[NL], uint32_t oth[NL],
                            const uint32_t y[NL], const FieldConsts<NL>& F) {
  fe_mul_chain(oth, oth, y, F);
  fe_mul_chain(acc, acc, y, F);
}

// c[j] (in place) = 1 / c[j] from the pair products and the inverse of the
// chunk's total; where zero[j], 0.
template <int NL>
KZG_HD void inv_chunk_down(uint32_t c0[NL], uint32_t c1[NL], uint32_t c2[NL],
                           uint32_t c3[NL], const uint32_t p01[NL],
                           const uint32_t p23[NL], const uint32_t itot[NL],
                           unsigned zero, const FieldConsts<NL>& F) {
  uint32_t i01[NL], i23[NL], x[NL];
  const uint32_t z[NL] = {};
  fe_mul_chain(i01, p23, itot, F);
  fe_mul_chain(i23, p01, itot, F);
  fe_copy<NL>(x, c0);
  fe_mul_chain(c0, c1, i01, F);
  fe_mul_chain(c1, x, i01, F);
  fe_copy<NL>(x, c2);
  fe_mul_chain(c2, c3, i23, F);
  fe_mul_chain(c3, x, i23, F);
  fe_select<NL>(c0, zero & 1u, z, c0);
  fe_select<NL>(c1, zero & 2u, z, c1);
  fe_select<NL>(c2, zero & 4u, z, c2);
  fe_select<NL>(c3, zero & 8u, z, c3);
}
