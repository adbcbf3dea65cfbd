// Pieces of the scan and exponentiation kernels (fr_scan_kernels.cu) that
// are plain per-thread code: element indexing, the scan's operation and
// identity, the fix-up pass's thread body and the exponentiation's thread
// body.  __host__ __device__, so csrc/host_check.cpp runs the same code
// under g++ in the CPU tests.
//
// A scan reads n elements of an (NL, ld) limb-major array with column step
// inc (0 reads one element n times, 1 walks the array).  Logical element l
// of a forward scan is column l; of a reverse scan, column n - 1 - l.  The
// tile pass cuts the logical order into tiles of SCAN_TILE elements, each
// thread of a block taking SCAN_PER consecutive ones.
#pragma once

#include "field.cuh"

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

// a^e for column i of an (NL, n) array: square-and-multiply from the least
// significant bit, in registers.  e has nbits = bit_length(e) bits, as NL
// words (low word first); a^0 = one for every a, so 0^0 = 1 and 0^e = 0
// for e > 0.  Where a bit is set, the product and the next squaring are
// independent and sit in one basic block, so the scheduler can overlap
// them: a thread's chain is about nbits products long, not nbits plus the
// number of set bits.
template <int NL>
KZG_HD void fe_pow_thread(int64_t i, const uint32_t* a, uint32_t* out,
                          int64_t n, const uint32_t e[NL], int nbits,
                          const FieldConsts<NL>& F) {
  uint32_t r[NL], b[NL];
  fe_copy<NL>(r, F.one);
  if (nbits > 0) {
    fe_load<NL>(b, a, n, i);
#pragma unroll 1
    for (int k = 0; k + 1 < nbits; k++) {
      if ((e[k >> 5] >> (k & 31)) & 1u) {
        fe_mul(r, r, b, F);
        fe_mul(b, b, b, F);
      } else {
        fe_mul(b, b, b, F);
      }
    }
    fe_mul(r, r, b, F);  // the top bit is set
  }
  fe_store<NL>(out, n, i, r);
}
