// Pieces of the scan and power kernels (fr_scan_kernels.cu) that are plain
// per-thread code: element indexing, the scan's operation and identity, the
// fix-up pass's thread body, the power's thread body and the inversion
// route's per-thread steps.  __host__ __device__, so csrc/host_check.cpp
// runs the same code under g++ in the CPU tests.
//
// A scan reads n elements of an (NL, ld) limb-major array with column step
// inc (0 reads one element n times, 1 walks the array).  Logical element l
// of a forward scan is column l; of a reverse scan, column n - 1 - l.  The
// tile pass cuts the logical order into tiles of SCAN_TILE elements, each
// thread of a block taking SCAN_PER consecutive ones.  The inversion route
// of fr_pow takes the same tiles.
#pragma once

#include "inv.cuh"

#define SCAN_THREADS 128
#define SCAN_PER 4
#define SCAN_TILE (SCAN_THREADS * SCAN_PER)

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

// r = a (op) b.  r may alias a or b.
template <int OP, int NL>
KZG_HD void scan_op(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL],
                    const FieldConsts<NL>& F) {
  if (OP == SCAN_OP_ADD) {
    fe_add(r, a, b, F);
  } else {
    fe_mul(r, a, b, F);
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

// Fix-up pass, one thread a column i of the (NL, n) output: the tile-local
// exclusive scan already in out, combined with the exclusive prefix of its
// tile (column t of the (NL, tiles) prefix array).
template <int OP, int NL>
KZG_HD void scan_fixup_thread(int64_t i, uint32_t* out, int64_t n,
                              const uint32_t* prefix, int64_t tiles,
                              bool reverse, const FieldConsts<NL>& F) {
  int64_t t = scan_col(i, n, reverse) / SCAN_TILE;
  if (t == 0) return;  // the first tile's prefix is the identity
  uint32_t x[NL], c[NL];
  fe_load<NL>(x, out, n, i);
  fe_load<NL>(c, prefix, tiles, t);
  scan_op<OP>(x, c, x, F);
  fe_store<NL>(out, n, i, x);
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
