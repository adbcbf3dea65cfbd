// The carry-chained Montgomery product and squaring (the product policy
// PROD_CHAIN of curve.cuh), generic over an even limb count NL.
//
// Why: fe_mul (field.cuh) writes each 32 x 32-bit step as a 64-bit
// multiply-add and shifts its carry out; on sm_90a that is 448
// instructions a product at 8 words, 190 of them IADD3 for the carries
// (cuobjdump -sass, chip_smoke.py's build phase).  Here each 32 x 32-bit
// product is a pair, mad.lo and madc.hi of the same operands into two
// neighbouring words of one carry chain, which ptxas fuses into one
// IMAD.WIDE.U32 with carry in and out: 184 instructions, 136 of them
// multiplies.  The chains are PTX, one asm volatile block each
// (csrc/chain_ptx.cuh, generated by utils/gen_chain_ptx.py): the carry
// flag does not survive between asm statements.
//
// Both functions are exact: canonical values in and out, the integers of
// fe_mul, so every Jacobian representative of the curve formulas is
// unchanged.
//
// The product (CIOS on a paired sum; the structure of Supranational's
// sppark mont_t): the running sum is T = e + 2^32 o; a b_i's products of
// even j go to e at words (j, j+1), those of odd j to o at (j-1, j), so no
// pair straddles a chain.  Each row adds a b_i and m p (m = e[0] pinv,
// which zeroes e[0]); dividing by 2^32 is free: the arrays swap roles, e[0]
// of the new e takes o[1] and the new o shifts down two words inside the
// chain that adds the next odd products (pm_shift_odd).  With a, b < p <
// 2^(32 NL - 1) and 2p + 2^(32 NL - 30) < 2^(32 NL) (true of BN254,
// BLS12-381 Fr and Fq by a wide margin) no chain carries out of its array;
// after NL rows e + o[1..] < 2p and one conditional subtraction ends it.
// The squaring (SOS, each cross product once): a^2 = sum_i a_i v_i with
// v_i's words a_i, a_{i+1} << 1, then the words of 2a; the 2 NL-word sum
// is ce + 2^32 co + 2^(32 NL) k (products at even words in ce pairs, at odd
// words in co pairs, each chain's carry into k); the reduction takes the
// true word i = ce[i] + co[i-1] + the carry out of word i - 1, adds m p
// the same way, and sums the high words into the result.  NL (NL + 1) / 2
// products and NL^2 for the reduction: 192 instructions at 8 words, 108 of
// them multiplies; 14 % faster than the product on an NVIDIA H100 80GB
// HBM3 at 700 W (the product loops of chip_smoke.py's build phase).
//
// Each step is a function of its words with the same meaning in both
// forms: the PTX under __CUDA_ARCH__ (checked on the card against the plain
// versions), the portable C++ mirror below everywhere else (g++ builds it
// into csrc/host_check.cpp, which the CPU tests hold to the plain
// versions; tests/test_torch_host_build.py also interprets the PTX text
// itself).  The mirror follows the PTX instruction by instruction: the
// same words in the same order, each carry an explicit 0 / 1.
#pragma once

#include "field.cuh"

#ifdef __CUDACC__
#include "chain_ptx.cuh"
#endif

namespace chain_c {

// d = lo(x y) + c + cf; cf = the carry out (0 or 1): mad.lo / madc.lo.
KZG_HD uint32_t mad_lo(uint32_t x, uint32_t y, uint32_t c, uint32_t& cf) {
  uint64_t s = (uint64_t)(uint32_t)(x * y) + c + cf;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}

// d = hi(x y) + c + cf: mad.hi / madc.hi.
KZG_HD uint32_t mad_hi(uint32_t x, uint32_t y, uint32_t c, uint32_t& cf) {
  uint64_t s = (((uint64_t)x * y) >> 32) + c + cf;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}

// d = x + y + cf: add.cc / addc.
KZG_HD uint32_t add_c(uint32_t x, uint32_t y, uint32_t& cf) {
  uint64_t s = (uint64_t)x + y + cf;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}

// The product keeps its running sum as T = e + 2^32 o, e and o NL words:
// a b_i's products of even j go to e (lo at word j, hi at j + 1), those of
// odd j to o (at j - 1, j), so each pair of a chain is one 32 x 32-bit
// product (one IMAD.WIDE.U32 with carry after ptxas), none split.

// e, o = a b: the first row, without carries (C on both sides).
template <int NL>
KZG_HD void pm_first(uint32_t* e, uint32_t* o, const uint32_t* a,
                     uint32_t b) {
  for (int j = 0; j < NL; j += 2) {
    uint64_t w = (uint64_t)a[j] * b;
    e[j] = (uint32_t)w;
    e[j + 1] = (uint32_t)(w >> 32);
    w = (uint64_t)a[j + 1] * b;
    o[j] = (uint32_t)w;
    o[j + 1] = (uint32_t)(w >> 32);
  }
}

// e[0] += o[1]; o = (o >> 64) + sum_{j odd} a_j b 2^(32 (j-1)) + that
// carry (at o[0], weight 2^32 against e[0]).
template <int NL>
KZG_HD void pm_shift_odd(uint32_t* e, uint32_t* o, const uint32_t* a,
                         uint32_t b) {
  uint32_t cf = 0;
  e[0] = add_c(e[0], o[1], cf);
  for (int j = 0; j < NL; j += 2) {
    uint32_t lo = j + 2 < NL ? o[j + 2] : 0, hi = j + 3 < NL ? o[j + 3] : 0;
    o[j] = mad_lo(a[j + 1], b, lo, cf);
    o[j + 1] = mad_hi(a[j + 1], b, hi, cf);
  }
}

// e += sum_{j even} a_j b 2^(32 j); its carry into o[NL - 1].
template <int NL>
KZG_HD void pm_even(uint32_t* e, uint32_t* o, const uint32_t* a,
                    uint32_t b) {
  uint32_t cf = 0;
  for (int j = 0; j < NL; j += 2) {
    e[j] = mad_lo(a[j], b, e[j], cf);
    e[j + 1] = mad_hi(a[j], b, e[j + 1], cf);
  }
  o[NL - 1] += cf;
}

// o += sum_{j odd} m p_j 2^(32 (j-1)) (no carry leaves o).
template <int NL>
KZG_HD void pm_reduce_odd(uint32_t* o, const uint32_t* p, uint32_t m) {
  uint32_t cf = 0;
  for (int j = 1; j < NL; j += 2) {
    o[j - 1] = mad_lo(m, p[j], o[j - 1], cf);
    o[j] = mad_hi(m, p[j], o[j], cf);
  }
}

// e += sum_{j even} m p_j 2^(32 j); its carry into o[NL - 1].
template <int NL>
KZG_HD void pm_reduce_even(uint32_t* e, uint32_t* o, const uint32_t* p,
                           uint32_t m) {
  pm_even<NL>(e, o, p, m);
}

// e[0..NL-1) += o[1..NL); the carry into e[NL - 1].
template <int NL>
KZG_HD void pm_merge(uint32_t* e, const uint32_t* o) {
  uint32_t cf = 0;
  for (int j = 0; j < NL - 1; j++) e[j] = add_c(e[j], o[j + 1], cf);
  e[NL - 1] += cf;
}

// t[0..NL) = t - p if t[0..NL] >= p, else t (t < 2p).
template <int NL>
KZG_HD void final_sub(uint32_t* t, const uint32_t* p) {
  uint32_t d[NL], borrow = 0;
  for (int j = 0; j < NL; j++) {
    uint64_t s = (uint64_t)t[j] - p[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  bool lt = t[NL] - borrow == 0xFFFFFFFFu;
  for (int j = 0; j < NL; j++) t[j] = lt ? t[j] : d[j];
}

// The squaring keeps its 2 NL-word sum as ce + 2^32 co + 2^(32 NL) k: a
// product at an even word goes to a pair of ce, at an odd word to a pair
// of co (co[x] is word x + 1), and each chain's carry to k (k[x] is word
// NL + x); at word 2 NL the carry is 0 and dropped.

// One row: xs[j] ys[j] at words pos0 + j, j < len.
template <int NL>
KZG_HD void row_chains(uint32_t* ce, uint32_t* co, uint32_t* k, int pos0,
                       int len, const uint32_t* xs, const uint32_t* ys) {
  for (int parity = 0; parity < 2; parity++) {
    uint32_t cf = 0;
    int last = -1;
    for (int j = 0; j < len; j++) {
      const int pos = pos0 + j;
      if ((pos & 1) != parity) continue;
      uint32_t* w = parity ? co + pos - 1 : ce + pos;
      w[0] = mad_lo(xs[j], ys[j], w[0], cf);
      w[1] = mad_hi(xs[j], ys[j], w[1], cf);
      last = pos;
    }
    if (last >= 0 && last + 2 < 2 * NL) k[last + 2 - NL] += cf;
  }
}

// ce, co, k += a^2 = sum_i a_i v_i, v_i's words j >= i: a_i, a_{i+1} << 1,
// then a2_j (the words of 2a).
template <int NL>
KZG_HD void sq_products(uint32_t* ce, uint32_t* co, uint32_t* k,
                        const uint32_t* a, const uint32_t* a2) {
  for (int i = 0; i < NL; i++) {
    uint32_t xs[NL], ys[NL];
    for (int j = i; j < NL; j++) {
      xs[j - i] = a[i];
      ys[j - i] = j == i ? a[i] : j == i + 1 ? a[j] << 1 : a2[j];
    }
    row_chains<NL>(ce, co, k, 2 * i, NL - i, xs, ys);
  }
}

// Montgomery reduction of the sum: word by word, w_i = ce[i] + co[i-1] +
// kk (kk: the carry out of word i - 1), m = w_i pinv, m p added at words
// i..i+NL-1; then ce[NL..2NL) = the words NL.. of ce + co + k + kk.
template <int NL>
KZG_HD void sq_redc(uint32_t* ce, uint32_t* co, uint32_t* k,
                    const uint32_t* p, uint32_t pinv) {
  uint32_t kk = 0, m, cf, ms[NL];
  for (int i = 0; i < NL; i++) {
    if (i == 0) {
      m = ce[0] * pinv;
    } else {
      cf = kk;
      add_c(ce[i - 1], i >= 2 ? co[i - 2] : 0, cf);
      kk = cf;
      m = (ce[i] + co[i - 1] + kk) * pinv;
    }
    for (int j = 0; j < NL; j++) ms[j] = m;
    row_chains<NL>(ce, co, k, i, NL, ms, p);
  }
  cf = kk;
  add_c(ce[NL - 1], co[NL - 2], cf);  // cf: the carry into word NL
  for (int j = 0; j < NL; j++)
    ce[NL + j] = add_c(ce[NL + j], co[NL - 1 + j], cf);
  cf = 0;
  for (int j = 0; j < NL; j++) ce[NL + j] = add_c(ce[NL + j], k[j], cf);
}

}  // namespace chain_c

// The steps: PTX on the card, the mirror elsewhere.
#ifdef __CUDA_ARCH__
#define KZG_CHAIN(step, ...) ChainPtx<NL>::step(__VA_ARGS__)
#else
#define KZG_CHAIN(step, ...) chain_c::step<NL>(__VA_ARGS__)
#endif

// One row after the first: T = T / 2^32 + a b (the roles of the two
// arrays swap every row: e here is the o of the row before, whose e[0] was
// reduced to 0), then T += m p with m = e[0] pinv, which zeroes e[0].
template <int NL>
KZG_HD void pm_row(uint32_t* e, uint32_t* o, const uint32_t* a, uint32_t b,
                   const FieldConsts<NL>& F) {
  KZG_CHAIN(pm_shift_odd, e, o, a, b);
  KZG_CHAIN(pm_even, e, o, a, b);
  const uint32_t m = e[0] * F.pinv;
  KZG_CHAIN(pm_reduce_odd, o, F.p, m);
  KZG_CHAIN(pm_reduce_even, e, o, F.p, m);
}

// Montgomery product a b R^{-1} mod p: CIOS on the paired sum (NL even).
template <int NL>
KZG_HD void fe_mul_chain(uint32_t r[NL], const uint32_t a[NL],
                         const uint32_t b[NL], const FieldConsts<NL>& F) {
  static_assert(NL % 2 == 0, "the paired product takes an even limb count");
  uint32_t ev[NL], od[NL], t[NL + 1];
  chain_c::pm_first<NL>(ev, od, a, b[0]);
  const uint32_t m = ev[0] * F.pinv;
  KZG_CHAIN(pm_reduce_odd, od, F.p, m);
  KZG_CHAIN(pm_reduce_even, ev, od, F.p, m);
#pragma unroll
  for (int i = 1; i < NL - 1; i += 2) {
    pm_row<NL>(od, ev, a, b[i], F);
    pm_row<NL>(ev, od, a, b[i + 1], F);
  }
  pm_row<NL>(od, ev, a, b[NL - 1], F);
  KZG_CHAIN(pm_merge, ev, od);
  fe_copy<NL>(t, ev);
  t[NL] = 0;
  KZG_CHAIN(final_sub, t, F.p);
  fe_copy<NL>(r, t);
}

// Montgomery square a^2 R^{-1} mod p: each cross product once.
template <int NL>
KZG_HD void fe_sqr_chain(uint32_t r[NL], const uint32_t a[NL],
                         const FieldConsts<NL>& F) {
  uint32_t ce[2 * NL], co[2 * NL - 1], k[NL], a2[NL], t[NL + 1];
#pragma unroll
  for (int j = 0; j < 2 * NL; j++) ce[j] = 0;
#pragma unroll
  for (int j = 0; j < 2 * NL - 1; j++) co[j] = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) k[j] = 0;
  a2[0] = a[0] << 1;
#pragma unroll
  for (int j = 1; j < NL; j++) a2[j] = (a[j] << 1) | (a[j - 1] >> 31);
  KZG_CHAIN(sq_products, ce, co, k, a, a2);
  KZG_CHAIN(sq_redc, ce, co, k, F.p, F.pinv);
  fe_copy<NL>(t, ce + NL);
  t[NL] = 0;
  KZG_CHAIN(final_sub, t, F.p);
  fe_copy<NL>(r, t);
}

#undef KZG_CHAIN
