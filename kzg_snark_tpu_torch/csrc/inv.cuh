// Modular inversion by Bernstein-Yang divsteps ("safegcd", Bernstein and
// Yang, "Fast constant-time gcd computation and modular inversion", 2019),
// in the form of libsecp256k1's modinv32: signed 30-bit limbs, divsteps in
// batches of 30 on the low limbs, each batch's 2x2 transition matrix then
// applied to f, g and, mod p, to d, e.  Constant time: a fixed number of
// batches, ceil(floor((49 d + 57) / 17) / 30) for d = 32 NL bits (741
// divsteps, 25 batches at 8 words; 1110, 37 batches at 12), which bounds
// the divsteps that any f = p, g < p < 2^d need to reach g = 0; the steps
// themselves are branch-free.  The provers invert witness-dependent values
// (PLONK's grand-product denominators), so the time must not depend on
// them, as the reference's Fermat chain does not.
//
// fe_inv_raw: a^-1 mod p of a canonical integer a (0 maps to 0); with a in
// Montgomery form (a R) that is (a R)^-1, and one Montgomery product by
// R^3 mod p makes it a^-1 R (fe_inv_mont).  R^3 mod p and p^-1 mod 2^30
// come from the host (ops/scan.py), beside the consts block.
//
// __host__ __device__: csrc/host_check.cpp runs the same code under g++.
// Every loop over limbs has compile-time bounds and is unrolled, so the
// limbs stay in registers.
#pragma once

#include "chain.cuh"

// The inversion's constants beside FieldConsts: R^3 mod p (NL words) and
// p^-1 mod 2^30.
template <int NL>
struct InvConsts {
  uint32_t r3[NL];
  uint32_t pinv30;
};

template <int NL>
struct Safegcd {
  static constexpr int S = (32 * NL + 29) / 30;  // signed 30-bit limbs
  static constexpr int DIVSTEPS = (49 * 32 * NL + 57) / 17;
  static constexpr int BATCHES = (DIVSTEPS + 29) / 30;
  // The fixed count of the two widths the port inverts at (741 divsteps
  // at 8 words, 1110 at 12), rounded up to whole batches.
  static_assert(NL != 8 || BATCHES == 25, "safegcd batches at 8 words");
  static_assert(NL != 12 || BATCHES == 37, "safegcd batches at 12 words");
};

#define KZG_M30 0x3FFFFFFF

// NL words (least significant first) -> S limbs of 30 bits, each in
// [0, 2^30).
template <int NL, int S>
KZG_HD void s30_from_words(int32_t r[S], const uint32_t a[NL]) {
#pragma unroll
  for (int i = 0; i < S; i++) {
    const int bit = 30 * i, w = bit >> 5, sh = bit & 31;
    uint64_t x = w < NL ? a[w] : 0u;
    if (w + 1 < NL) x |= (uint64_t)a[w + 1] << 32;
    r[i] = (int32_t)((x >> sh) & KZG_M30);
  }
}

// S limbs in [0, 2^30) of a value below 2^(32 NL) -> NL words.  Word w
// starts at bit 32 w = 30 i + sh with sh even, at most 28, so limbs i and
// i + 1 hold its 32 bits.
template <int NL, int S>
KZG_HD void s30_to_words(uint32_t r[NL], const int32_t v[S]) {
#pragma unroll
  for (int w = 0; w < NL; w++) {
    const int i = 32 * w / 30, sh = 32 * w % 30;
    uint64_t x = (uint64_t)(uint32_t)v[i] >> sh;
    if (i + 1 < S) x |= (uint64_t)(uint32_t)v[i + 1] << (30 - sh);
    r[w] = (uint32_t)x;
  }
}

// 30 divsteps on the low bits of f (odd) and g: delta' and the transition
// matrix t = (u, v, q, r), scaled by 2^30: 2^30 (f', g') = (u f + v g,
// q f + r g).  A divstep: if delta > 0 and g is odd, (delta, f, g) ->
// (1 - delta, g, (g - f) / 2), else (1 + delta, f, (g + (g mod 2) f) / 2);
// here as masks (c1: delta > 0, c2: g odd), no branch.  |u| + |v| and
// |q| + |r| stay at most 2^30.
KZG_HD int32_t s30_divsteps(int32_t delta, uint32_t f, uint32_t g,
                            int32_t t[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < 30; i++) {
    uint32_t c1 = (uint32_t)((0 - delta) >> 31);
    const uint32_t c2 = 0u - (g & 1u);
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;
    delta = (int32_t)(((uint32_t)delta ^ c1) - c1) + 1;
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return delta;
}

// (f, g) = t (f, g) / 2^30, exactly (the low 30 bits of both products
// are 0 by the choice of t).  Lower limbs leave in [0, 2^30), the top limb
// signed.
template <int S>
KZG_HD void s30_update_fg(int32_t f[S], int32_t g[S], const int32_t t[4]) {
  const int64_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = u * f[0] + v * g[0];
  int64_t cg = q * f[0] + r * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < S; i++) {
    cf += u * f[i] + v * g[i];
    cg += q * f[i] + r * g[i];
    f[i - 1] = (int32_t)cf & KZG_M30;
    cf >>= 30;
    g[i - 1] = (int32_t)cg & KZG_M30;
    cg >>= 30;
  }
  f[S - 1] = (int32_t)cf;
  g[S - 1] = (int32_t)cg;
}

// (d, e) = t (d, e) / 2^30 mod p: md, me multiples of p added so that the
// low 30 bits vanish (and p or more where d or e is negative); d, e stay
// in (-2p, p) (libsecp256k1's modinv32_update_de_30).
template <int S>
KZG_HD void s30_update_de(int32_t d[S], int32_t e[S], const int32_t t[4],
                          const int32_t mod[S], uint32_t pinv30) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d[S - 1] >> 31, se = e[S - 1] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
  int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
  md -= (int32_t)((pinv30 * (uint32_t)cd + (uint32_t)md) & KZG_M30);
  me -= (int32_t)((pinv30 * (uint32_t)ce + (uint32_t)me) & KZG_M30);
  cd += (int64_t)mod[0] * md;
  ce += (int64_t)mod[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < S; i++) {
    cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)mod[i] * md;
    ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)mod[i] * me;
    d[i - 1] = (int32_t)cd & KZG_M30;
    cd >>= 30;
    e[i - 1] = (int32_t)ce & KZG_M30;
    ce >>= 30;
  }
  d[S - 1] = (int32_t)cd;
  e[S - 1] = (int32_t)ce;
}

// d in (-2p, p) -> sign d mod p in [0, p), limbs in [0, 2^30); sign is f's
// top limb (f = +-1 at the end).
template <int S>
KZG_HD void s30_normalize(int32_t d[S], int32_t sign, const int32_t mod[S]) {
  int32_t c = d[S - 1] >> 31;
#pragma unroll
  for (int i = 0; i < S; i++) d[i] += mod[i] & c;
  c = sign >> 31;
#pragma unroll
  for (int i = 0; i < S; i++) d[i] = (d[i] ^ c) - c;
#pragma unroll
  for (int i = 0; i + 1 < S; i++) {
    d[i + 1] += d[i] >> 30;
    d[i] &= KZG_M30;
  }
  c = d[S - 1] >> 31;
#pragma unroll
  for (int i = 0; i < S; i++) d[i] += mod[i] & c;
#pragma unroll
  for (int i = 0; i + 1 < S; i++) {
    d[i + 1] += d[i] >> 30;
    d[i] &= KZG_M30;
  }
}

// r = a^-1 mod p for a canonical a (0 -> 0): f = p, g = a, d = 0, e = 1
// (f = d a, g = e a mod p throughout); after the batches g = 0, f = +-1 and
// a^-1 = sign(f) d.  r may alias a.
template <int NL>
KZG_HD void fe_inv_raw(uint32_t r[NL], const uint32_t a[NL],
                       const FieldConsts<NL>& F, uint32_t pinv30) {
  constexpr int S = Safegcd<NL>::S;
  int32_t mod[S], f[S], g[S], d[S], e[S], t[4];
  s30_from_words<NL, S>(mod, F.p);
  s30_from_words<NL, S>(g, a);
#pragma unroll
  for (int i = 0; i < S; i++) {
    f[i] = mod[i];
    d[i] = 0;
    e[i] = i == 0;
  }
  int32_t delta = 1;
#pragma unroll 1
  for (int b = 0; b < Safegcd<NL>::BATCHES; b++) {
    delta = s30_divsteps(delta, (uint32_t)f[0], (uint32_t)g[0], t);
    s30_update_de<S>(d, e, t, mod, pinv30);
    s30_update_fg<S>(f, g, t);
  }
  s30_normalize<S>(d, f[S - 1], mod);
  s30_to_words<NL, S>(r, d);
}

// r = a^-1 R mod p for a = x R in Montgomery form (0 -> 0): (x R)^-1 by
// safegcd, times R^3 by one Montgomery product.  r may alias a.
template <int NL>
KZG_HD void fe_inv_mont(uint32_t r[NL], const uint32_t a[NL],
                        const FieldConsts<NL>& F, const InvConsts<NL>& I) {
  uint32_t x[NL];
  fe_inv_raw<NL>(x, a, F, I.pinv30);
  fe_mul_chain(r, x, I.r3, F);
}
