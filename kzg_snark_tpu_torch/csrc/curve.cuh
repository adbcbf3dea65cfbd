// Short-Weierstrass (a = 0) group law in Jacobian coordinates over field.cuh.
//
// Counterpart of kzg_snark_tpu/ops/regcurve.py (RegCurve): the same formulas
// (dbl-2009-l, add-2007-bl, madd-2007-bl), exact field arithmetic, so every
// representative (X, Y, Z) equals the JAX package's whatever the order of
// evaluation or the product policy.  The identity is Z = 0.
// Where the TPU computed every case and selected lane-wise, a thread here
// branches: the selected value is the same.
#pragma once

#include "chain.cuh"

template <int NL>
struct G1J {
  uint32_t X[NL], Y[NL], Z[NL];
};

// A point batch in device memory is (3, NL, m): coordinate c, limb k, point
// i at (c * NL + k) * m + i.
template <int NL>
KZG_HD void g1_load(G1J<NL>& P, const uint32_t* base, int64_t m, int64_t i) {
  fe_load<NL>(P.X, base, m, i);
  fe_load<NL>(P.Y, base + NL * m, m, i);
  fe_load<NL>(P.Z, base + 2 * NL * m, m, i);
}

template <int NL>
KZG_HD void g1_store(uint32_t* base, int64_t m, int64_t i, const G1J<NL>& P) {
  fe_store<NL>(base, m, i, P.X);
  fe_store<NL>(base + NL * m, m, i, P.Y);
  fe_store<NL>(base + 2 * NL * m, m, i, P.Z);
}

// The identity as CurveOps.identity writes it: (one, one, 0).
template <int NL>
KZG_HD void g1_set_identity(G1J<NL>& P, const FieldConsts<NL>& F) {
  fe_copy<NL>(P.X, F.one);
  fe_copy<NL>(P.Y, F.one);
  for (int k = 0; k < NL; k++) P.Z[k] = 0;
}

// Product policies: which Montgomery product (and squaring) the formulas
// run.  PROD_CIOS: fe_mul, straight-line (the default); PROD_CHAIN:
// fe_mul_chain and the true squaring fe_sqr_chain (chain.cuh), for K6, K7,
// K9, the ladder and the bucket MSM.  (Value 1 was a rolled CIOS loop, no
// longer used.)
enum { PROD_CIOS = 0, PROD_CHAIN = 2 };

template <int POL, int NL>
KZG_HD void fmul(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL],
                 const FieldConsts<NL>& F) {
  if (POL == PROD_CHAIN) {
    fe_mul_chain(r, a, b, F);
  } else {
    fe_mul(r, a, b, F);
  }
}

template <int POL, int NL>
KZG_HD void fsqr(uint32_t r[NL], const uint32_t a[NL],
                 const FieldConsts<NL>& F) {
  if (POL == PROD_CHAIN) {
    fe_sqr_chain(r, a, F);
  } else {
    fmul<POL>(r, a, a, F);
  }
}

// dbl-2009-l; the identity maps to Z3 = 0.
template <int POL = PROD_CIOS, int NL>
KZG_HD void g1_double(G1J<NL>& R, const G1J<NL>& P, const FieldConsts<NL>& F) {
  uint32_t A[NL], B[NL], C[NL], t[NL], D[NL], E[NL], FF[NL], X3[NL], Y3[NL],
      Z3[NL], u[NL];
  fsqr<POL>(A, P.X, F);
  fsqr<POL>(B, P.Y, F);
  fsqr<POL>(C, B, F);
  fe_add(t, P.X, B, F);
  fsqr<POL>(t, t, F);
  fe_sub(D, t, A, F);
  fe_sub(D, D, C, F);
  fe_double(D, D, F);
  fe_double(E, A, F);
  fe_add(E, E, A, F);
  fsqr<POL>(FF, E, F);
  fe_double(u, D, F);
  fe_sub(X3, FF, u, F);
  fe_double(u, C, F);
  fe_double(u, u, F);
  fe_double(u, u, F);  // 8C
  fe_sub(t, D, X3, F);
  fmul<POL>(Y3, E, t, F);
  fe_sub(Y3, Y3, u, F);
  fmul<POL>(Z3, P.Y, P.Z, F);
  fe_double(Z3, Z3, F);
  fe_copy<NL>(R.X, X3);
  fe_copy<NL>(R.Y, Y3);
  fe_copy<NL>(R.Z, Z3);
}

// Complete Jacobian + Jacobian (add-2007-bl with the case analysis of
// RegCurve.add).  R may alias P or Q.
template <int POL = PROD_CIOS, int NL>
KZG_HD void g1_add(G1J<NL>& R, const G1J<NL>& P, const G1J<NL>& Q,
                   const FieldConsts<NL>& F) {
  bool p_inf = fe_is_zero<NL>(P.Z);
  bool q_inf = fe_is_zero<NL>(Q.Z);
  if (p_inf) {
    R = Q;
    return;
  }
  if (q_inf) {
    R = P;
    return;
  }
  uint32_t Z1Z1[NL], Z2Z2[NL], U1[NL], U2[NL], S1[NL], S2[NL], H[NL], Rr[NL];
  fsqr<POL>(Z1Z1, P.Z, F);
  fsqr<POL>(Z2Z2, Q.Z, F);
  fmul<POL>(U1, P.X, Z2Z2, F);
  fmul<POL>(U2, Q.X, Z1Z1, F);
  fmul<POL>(S1, P.Y, Q.Z, F);
  fmul<POL>(S1, S1, Z2Z2, F);
  fmul<POL>(S2, Q.Y, P.Z, F);
  fmul<POL>(S2, S2, Z1Z1, F);
  fe_sub(H, U2, U1, F);
  fe_sub(Rr, S2, S1, F);
  if (fe_is_zero<NL>(H)) {
    if (fe_is_zero<NL>(Rr)) {
      g1_double<POL>(R, P, F);
    } else {
      fe_copy<NL>(R.X, F.one);
      fe_copy<NL>(R.Y, F.one);
      for (int k = 0; k < NL; k++) R.Z[k] = 0;
    }
    return;
  }
  uint32_t HH[NL], I[NL], J[NL], r2[NL], V[NL], X3[NL], Y3[NL], Z3[NL], t[NL];
  fsqr<POL>(HH, H, F);
  fe_double(I, HH, F);
  fe_double(I, I, F);
  fmul<POL>(J, H, I, F);
  fe_double(r2, Rr, F);
  fmul<POL>(V, U1, I, F);
  fsqr<POL>(X3, r2, F);
  fe_sub(X3, X3, J, F);
  fe_double(t, V, F);
  fe_sub(X3, X3, t, F);
  fe_sub(t, V, X3, F);
  fmul<POL>(Y3, r2, t, F);
  fmul<POL>(t, S1, J, F);
  fe_double(t, t, F);
  fe_sub(Y3, Y3, t, F);
  fe_add(t, P.Z, Q.Z, F);
  fsqr<POL>(t, t, F);
  fe_sub(t, t, Z1Z1, F);
  fe_sub(t, t, Z2Z2, F);
  fmul<POL>(Z3, t, H, F);
  fe_copy<NL>(R.X, X3);
  fe_copy<NL>(R.Y, Y3);
  fe_copy<NL>(R.Z, Z3);
}

// Thread bodies of the K6 / K7 / K9 replacements: one point per thread.
//
// K6, K7 and K9 run the product policy PROD_CHAIN.  Their formulas are those
// of g1_add (add-2007-bl) and of madd-2007-bl (RegCurve.add_mixed) with
// RegCurve's case analysis, so every representative is theirs; the order is the registers': each coordinate is
// loaded where it is first used, each output coordinate stored as soon as it
// is known, so fewer field elements are live at once.  The rare cases (an
// identity operand, P = Q, P = -Q) read their operands again from memory.

// P = +-Q in an add (H = 0): 2P where R = 0 (P = Q), else the identity.
template <int NL>
KZG_HD void g1_add_exceptional(uint32_t* out, const uint32_t* p, int64_t m,
                               int64_t i, bool equal,
                               const FieldConsts<NL>& F) {
  G1J<NL> R;
  if (equal) {
    g1_load(R, p, m, i);
    g1_double<PROD_CHAIN>(R, R, F);
  } else {
    fe_copy<NL>(R.X, F.one);
    fe_copy<NL>(R.Y, F.one);
    for (int k = 0; k < NL; k++) R.Z[k] = 0;
  }
  g1_store(out, m, i, R);
}

// The end both formulas share: r = 2 Rr, X3 = r^2 - J - 2V,
// Y3 = r (V - X3) - 2 S J, stored.  Rr, J and V are overwritten.
template <int NL>
KZG_HD void g1_add_tail(uint32_t* out, int64_t m, int64_t i, uint32_t Rr[NL],
                        uint32_t J[NL], uint32_t V[NL], const uint32_t S[NL],
                        const FieldConsts<NL>& F) {
  uint32_t t[NL], u[NL];
  fe_double(Rr, Rr, F);                            // r
  fsqr<PROD_CHAIN>(t, Rr, F);
  fe_sub(t, t, J, F);
  fe_double(u, V, F);
  fe_sub(t, t, u, F);                              // X3
  fe_store<NL>(out, m, i, t);
  fe_sub(V, V, t, F);
  fmul<PROD_CHAIN>(V, Rr, V, F);
  fmul<PROD_CHAIN>(J, S, J, F);
  fe_double(J, J, F);
  fe_sub(V, V, J, F);                              // Y3
  fe_store<NL>(out + NL * m, m, i, V);
}

template <int NL>
KZG_HD void g1_add_thread(int64_t i, const uint32_t* p, const uint32_t* q,
                          uint32_t* out, int64_t m, const FieldConsts<NL>& F) {
  const int64_t Y = NL * m, Z = 2 * NL * m;
  uint32_t Z1[NL], Z2[NL];
  fe_load<NL>(Z1, p + Z, m, i);
  fe_load<NL>(Z2, q + Z, m, i);
  const bool p_inf = fe_is_zero<NL>(Z1);
  if (p_inf || fe_is_zero<NL>(Z2)) {
    G1J<NL> S;
    g1_load(S, p_inf ? q : p, m, i);
    g1_store(out, m, i, S);
    return;
  }
  // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H; S1 = Y1 Z2^3, S2 = Y2 Z1^3 (the
  // same field values as Y1 Z2 Z2Z2, Y2 Z1 Z1Z1).
  uint32_t Z1Z1[NL], Z2Z2[NL], ZZ[NL], U1[NL], H[NL], S1[NL], Rr[NL], t[NL];
  fsqr<PROD_CHAIN>(Z1Z1, Z1, F);
  fsqr<PROD_CHAIN>(Z2Z2, Z2, F);
  fe_add(ZZ, Z1, Z2, F);
  fsqr<PROD_CHAIN>(ZZ, ZZ, F);
  fe_sub(ZZ, ZZ, Z1Z1, F);
  fe_sub(ZZ, ZZ, Z2Z2, F);
  fmul<PROD_CHAIN>(Z1, Z1, Z1Z1, F);               // Z1^3
  fmul<PROD_CHAIN>(Z2, Z2, Z2Z2, F);               // Z2^3
  fe_load<NL>(t, q, m, i);                         // X2
  fmul<PROD_CHAIN>(H, t, Z1Z1, F);                 // U2
  fe_load<NL>(t, p, m, i);                         // X1
  fmul<PROD_CHAIN>(U1, t, Z2Z2, F);
  fe_sub(H, H, U1, F);                             // H = U2 - U1
  fe_load<NL>(t, p + Y, m, i);                     // Y1
  fmul<PROD_CHAIN>(S1, t, Z2, F);
  fe_load<NL>(t, q + Y, m, i);                     // Y2
  fmul<PROD_CHAIN>(Rr, t, Z1, F);                  // S2
  fe_sub(Rr, Rr, S1, F);                           // S2 - S1
  if (fe_is_zero<NL>(H)) {
    g1_add_exceptional(out, p, m, i, fe_is_zero<NL>(Rr), F);
    return;
  }
  fmul<PROD_CHAIN>(ZZ, ZZ, H, F);
  fe_store<NL>(out + Z, m, i, ZZ);                 // Z3
  uint32_t I[NL], J[NL], V[NL];
  fsqr<PROD_CHAIN>(I, H, F);                       // HH
  fe_double(I, I, F);
  fe_double(I, I, F);                              // I = 4 HH
  fmul<PROD_CHAIN>(J, H, I, F);
  fmul<PROD_CHAIN>(V, U1, I, F);
  g1_add_tail(out, m, i, Rr, J, V, S1, F);
}

template <int NL>
KZG_HD void g1_double_thread(int64_t i, const uint32_t* p, uint32_t* out,
                             int64_t m, const FieldConsts<NL>& F) {
  G1J<NL> P;
  g1_load(P, p, m, i);
  g1_double<PROD_CHAIN>(P, P, F);
  g1_store(out, m, i, P);
}

// K9: p (3, NL, m) + the affine point (qx, qy), complete.  qx and qy are
// (NL, qn) planes with qn dividing m; point i takes column i % qn, so one
// point (qn = 1) or one point per lane (qn = lanes) broadcasts without
// being materialized at full width.
template <int NL>
KZG_HD void g1_add_mixed_thread(int64_t i, const uint32_t* p,
                                const uint32_t* qx, const uint32_t* qy,
                                int64_t qn, uint32_t* out, int64_t m,
                                const FieldConsts<NL>& F) {
  const int64_t Y = NL * m, Z = 2 * NL * m, j = i % qn;
  uint32_t Z1[NL], t[NL];
  fe_load<NL>(Z1, p + Z, m, i);
  if (fe_is_zero<NL>(Z1)) {                   // (qx, qy, 1)
    fe_load<NL>(t, qx, qn, j);
    fe_store<NL>(out, m, i, t);
    fe_load<NL>(t, qy, qn, j);
    fe_store<NL>(out + Y, m, i, t);
    fe_store<NL>(out + Z, m, i, F.one);
    return;
  }
  uint32_t Z1Z1[NL], H[NL], Rr[NL];
  fsqr<PROD_CHAIN>(Z1Z1, Z1, F);
  fe_load<NL>(t, qx, qn, j);
  fmul<PROD_CHAIN>(H, t, Z1Z1, F);                 // U2
  fe_load<NL>(t, p, m, i);                         // X1
  fe_sub(H, H, t, F);                              // H = U2 - X1
  fe_load<NL>(t, qy, qn, j);
  fmul<PROD_CHAIN>(Rr, t, Z1, F);
  fmul<PROD_CHAIN>(Rr, Rr, Z1Z1, F);               // S2
  fe_load<NL>(t, p + Y, m, i);                     // Y1
  fe_sub(Rr, Rr, t, F);                            // S2 - Y1
  if (fe_is_zero<NL>(H)) {
    g1_add_exceptional(out, p, m, i, fe_is_zero<NL>(Rr), F);
    return;
  }
  uint32_t HH[NL], I[NL], J[NL], V[NL];
  fsqr<PROD_CHAIN>(HH, H, F);
  fe_add(t, Z1, H, F);
  fsqr<PROD_CHAIN>(t, t, F);
  fe_sub(t, t, Z1Z1, F);
  fe_sub(t, t, HH, F);
  fe_store<NL>(out + Z, m, i, t);                  // Z3
  fe_double(I, HH, F);
  fe_double(I, I, F);                              // I = 4 HH
  fmul<PROD_CHAIN>(J, H, I, F);
  fe_load<NL>(t, p, m, i);                         // X1
  fmul<PROD_CHAIN>(V, t, I, F);
  fe_load<NL>(t, p + Y, m, i);                     // Y1
  g1_add_tail(out, m, i, Rr, J, V, t, F);
}

// K7 (with K6's body) as the small MSM and CurveOps.scale use it.
//
// Highest set bit of an S-word scalar whose words lie `stride` apart; -1
// for zero.
KZG_HD int scalar_top_bit(const uint32_t* s, int64_t stride, int S) {
  for (int w = S - 1; w >= 0; w--) {
    const uint32_t v = s[w * stride];
    if (v == 0) continue;
#ifdef __CUDA_ARCH__
    return 32 * w + 31 - __clz(v);
#else
    return 32 * w + 31 - __builtin_clz(v);
#endif
  }
  return -1;
}

// acc = s P by the double-and-add ladder of the JAX _small_msm_core and
// CurveOps.scale: for each bit row b from the least significant up,
// acc = bit ? acc + base : acc, then base = 2 base, with base = P at row 0.
// The add is skipped where the bit is 0 and the ladder stops at the
// scalar's highest set bit; neither changes acc or its representative.
// P is point i of the (3, NL, n) batch `pts`; s is the scalar's first word,
// its S words `stride` apart.  acc and base stay in registers.
template <int NL>
KZG_HD void g1_ladder_thread(G1J<NL>& acc, const uint32_t* pts, int64_t n,
                             int64_t i, const uint32_t* s, int64_t stride,
                             int S, const FieldConsts<NL>& F) {
  g1_set_identity(acc, F);
  const int top = scalar_top_bit(s, stride, S);
  if (top < 0) return;
  G1J<NL> base;
  g1_load(base, pts, n, i);
#pragma unroll 1
  for (int b = 0;; b++) {
    if ((s[(b >> 5) * stride] >> (b & 31)) & 1)
      g1_add<PROD_CHAIN>(acc, acc, base, F);
    if (b == top) break;
    g1_double<PROD_CHAIN>(base, base, F);
  }
}

// Thread t's share of one level of CurveOps.tree_sum over S[0, m): an odd
// level is padded with the identity at its end, and t < h = ceil(m / 2)
// takes S[t] + S[t + h].  The result stays in S[0, h).
template <int NL>
KZG_HD void g1_tree_pair(G1J<NL>* S, int m, int t, const FieldConsts<NL>& F) {
  const int h = (m + 1) / 2;
  if (t >= h) return;
  G1J<NL> A = S[t], B;
  if (t + h < m) {
    B = S[t + h];
  } else {
    g1_set_identity(B, F);
  }
  g1_add<PROD_CHAIN>(A, A, B, F);
  S[t] = A;
}
