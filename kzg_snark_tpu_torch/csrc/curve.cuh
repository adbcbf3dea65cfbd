// Short-Weierstrass (a = 0) group law in Jacobian coordinates over field.cuh.
//
// Counterpart of kzg_snark_tpu/ops/regcurve.py (RegCurve): the same formulas
// in the same order (dbl-2009-l, add-2007-bl, madd-2007-bl), so every
// representative (X, Y, Z) equals the JAX package's.  The identity is Z = 0.
// Where the TPU computed every case and selected lane-wise, a thread here
// branches: the selected value is the same.
#pragma once

#include "field.cuh"

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

// LAT = true: the product with the small loop body (fe_mul_compact).
template <bool LAT, int NL>
KZG_HD void fmul(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL],
                 const FieldConsts<NL>& F) {
  if (LAT) {
    fe_mul_compact(r, a, b, F);
  } else {
    fe_mul(r, a, b, F);
  }
}

template <bool LAT, int NL>
KZG_HD void fsqr(uint32_t r[NL], const uint32_t a[NL],
                 const FieldConsts<NL>& F) {
  fmul<LAT>(r, a, a, F);
}

// dbl-2009-l; the identity maps to Z3 = 0.
template <bool LAT = false, int NL>
KZG_HD void g1_double(G1J<NL>& R, const G1J<NL>& P, const FieldConsts<NL>& F) {
  uint32_t A[NL], B[NL], C[NL], t[NL], D[NL], E[NL], FF[NL], X3[NL], Y3[NL],
      Z3[NL], u[NL];
  fsqr<LAT>(A, P.X, F);
  fsqr<LAT>(B, P.Y, F);
  fsqr<LAT>(C, B, F);
  fe_add(t, P.X, B, F);
  fsqr<LAT>(t, t, F);
  fe_sub(D, t, A, F);
  fe_sub(D, D, C, F);
  fe_double(D, D, F);
  fe_double(E, A, F);
  fe_add(E, E, A, F);
  fsqr<LAT>(FF, E, F);
  fe_double(u, D, F);
  fe_sub(X3, FF, u, F);
  fe_double(u, C, F);
  fe_double(u, u, F);
  fe_double(u, u, F);  // 8C
  fe_sub(t, D, X3, F);
  fmul<LAT>(Y3, E, t, F);
  fe_sub(Y3, Y3, u, F);
  fmul<LAT>(Z3, P.Y, P.Z, F);
  fe_double(Z3, Z3, F);
  fe_copy<NL>(R.X, X3);
  fe_copy<NL>(R.Y, Y3);
  fe_copy<NL>(R.Z, Z3);
}

// Complete Jacobian + Jacobian (add-2007-bl with the case analysis of
// RegCurve.add).  R may alias P or Q.
template <bool LAT = false, int NL>
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
  fsqr<LAT>(Z1Z1, P.Z, F);
  fsqr<LAT>(Z2Z2, Q.Z, F);
  fmul<LAT>(U1, P.X, Z2Z2, F);
  fmul<LAT>(U2, Q.X, Z1Z1, F);
  fmul<LAT>(S1, P.Y, Q.Z, F);
  fmul<LAT>(S1, S1, Z2Z2, F);
  fmul<LAT>(S2, Q.Y, P.Z, F);
  fmul<LAT>(S2, S2, Z1Z1, F);
  fe_sub(H, U2, U1, F);
  fe_sub(Rr, S2, S1, F);
  if (fe_is_zero<NL>(H)) {
    if (fe_is_zero<NL>(Rr)) {
      g1_double<LAT>(R, P, F);
    } else {
      fe_copy<NL>(R.X, F.one);
      fe_copy<NL>(R.Y, F.one);
      for (int k = 0; k < NL; k++) R.Z[k] = 0;
    }
    return;
  }
  uint32_t HH[NL], I[NL], J[NL], r2[NL], V[NL], X3[NL], Y3[NL], Z3[NL], t[NL];
  fsqr<LAT>(HH, H, F);
  fe_double(I, HH, F);
  fe_double(I, I, F);
  fmul<LAT>(J, H, I, F);
  fe_double(r2, Rr, F);
  fmul<LAT>(V, U1, I, F);
  fsqr<LAT>(X3, r2, F);
  fe_sub(X3, X3, J, F);
  fe_double(t, V, F);
  fe_sub(X3, X3, t, F);
  fe_sub(t, V, X3, F);
  fmul<LAT>(Y3, r2, t, F);
  fmul<LAT>(t, S1, J, F);
  fe_double(t, t, F);
  fe_sub(Y3, Y3, t, F);
  fe_add(t, P.Z, Q.Z, F);
  fsqr<LAT>(t, t, F);
  fe_sub(t, t, Z1Z1, F);
  fe_sub(t, t, Z2Z2, F);
  fmul<LAT>(Z3, t, H, F);
  fe_copy<NL>(R.X, X3);
  fe_copy<NL>(R.Y, Y3);
  fe_copy<NL>(R.Z, Z3);
}

// Shared general case of madd-2007-bl: P + (qx, qy, 1).  Returns H and Rr so
// the complete variant can classify the equal and opposite cases.
template <int NL>
KZG_HD void g1_madd_general(G1J<NL>& R, uint32_t H[NL], uint32_t Rr[NL],
                            const G1J<NL>& P, const uint32_t qx[NL],
                            const uint32_t qy[NL], const FieldConsts<NL>& F) {
  uint32_t Z1Z1[NL], U2[NL], S2[NL];
  fe_square(Z1Z1, P.Z, F);
  fe_mul(U2, qx, Z1Z1, F);
  fe_mul(S2, qy, P.Z, F);
  fe_mul(S2, S2, Z1Z1, F);
  fe_sub(H, U2, P.X, F);
  fe_sub(Rr, S2, P.Y, F);
  uint32_t HH[NL], I[NL], J[NL], r2[NL], V[NL], X3[NL], Y3[NL], Z3[NL], t[NL];
  fe_square(HH, H, F);
  fe_double(I, HH, F);
  fe_double(I, I, F);
  fe_mul(J, H, I, F);
  fe_double(r2, Rr, F);
  fe_mul(V, P.X, I, F);
  fe_square(X3, r2, F);
  fe_sub(X3, X3, J, F);
  fe_double(t, V, F);
  fe_sub(X3, X3, t, F);
  fe_sub(t, V, X3, F);
  fe_mul(Y3, r2, t, F);
  fe_mul(t, P.Y, J, F);
  fe_double(t, t, F);
  fe_sub(Y3, Y3, t, F);
  fe_add(t, P.Z, H, F);
  fe_square(t, t, F);
  fe_sub(t, t, Z1Z1, F);
  fe_sub(Z3, t, HH, F);
  fe_copy<NL>(R.X, X3);
  fe_copy<NL>(R.Y, Y3);
  fe_copy<NL>(R.Z, Z3);
}

// Incomplete mixed add (RegCurve.add_mixed_fast): exact when P is the
// identity and when P == -q; P == q yields the identity instead of 2q.
template <int NL>
KZG_HD void g1_add_mixed_fast(G1J<NL>& R, const G1J<NL>& P,
                              const uint32_t qx[NL], const uint32_t qy[NL],
                              const FieldConsts<NL>& F) {
  if (fe_is_zero<NL>(P.Z)) {
    fe_copy<NL>(R.X, qx);
    fe_copy<NL>(R.Y, qy);
    fe_copy<NL>(R.Z, F.one);
    return;
  }
  uint32_t H[NL], Rr[NL];
  g1_madd_general(R, H, Rr, P, qx, qy, F);
}

// Complete mixed add (RegCurve.add_mixed); q must be a finite point.
template <int NL>
KZG_HD void g1_add_mixed(G1J<NL>& R, const G1J<NL>& P, const uint32_t qx[NL],
                         const uint32_t qy[NL], const FieldConsts<NL>& F) {
  if (fe_is_zero<NL>(P.Z)) {
    fe_copy<NL>(R.X, qx);
    fe_copy<NL>(R.Y, qy);
    fe_copy<NL>(R.Z, F.one);
    return;
  }
  G1J<NL> S;
  uint32_t H[NL], Rr[NL];
  g1_madd_general(S, H, Rr, P, qx, qy, F);
  if (fe_is_zero<NL>(H)) {
    if (fe_is_zero<NL>(Rr)) {
      g1_double(R, P, F);
    } else {
      fe_copy<NL>(R.X, F.one);
      fe_copy<NL>(R.Y, F.one);
      for (int k = 0; k < NL; k++) R.Z[k] = 0;
    }
    return;
  }
  R = S;
}

// Thread bodies of the K6 / K7 / K9 replacements: one point per thread.
template <int NL>
KZG_HD void g1_add_thread(int64_t i, const uint32_t* p, const uint32_t* q,
                          uint32_t* out, int64_t m, const FieldConsts<NL>& F) {
  G1J<NL> P, Q, R;
  g1_load(P, p, m, i);
  g1_load(Q, q, m, i);
  g1_add(R, P, Q, F);
  g1_store(out, m, i, R);
}

template <int NL>
KZG_HD void g1_double_thread(int64_t i, const uint32_t* p, uint32_t* out,
                             int64_t m, const FieldConsts<NL>& F) {
  G1J<NL> P, R;
  g1_load(P, p, m, i);
  g1_double(R, P, F);
  g1_store(out, m, i, R);
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
  G1J<NL> P, R;
  uint32_t x[NL], y[NL];
  g1_load(P, p, m, i);
  int64_t j = i % qn;
  fe_load<NL>(x, qx, qn, j);
  fe_load<NL>(y, qy, qn, j);
  g1_add_mixed(R, P, x, y, F);
  g1_store(out, m, i, R);
}
