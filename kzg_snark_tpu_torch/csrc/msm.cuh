// Thread bodies of the bucket-route MSM: the sorted-bucket accumulate (the K8
// replacement) and the reduction of its partials (in place of the K6 / K7
// chains of the lane fold, suffix ladder and Horner fold).
//
// The schedule comes from the wrapper (ops/msm_kernel.py): every nonzero
// signed digit of every (set, window) is an entry, the entries are sorted by
// bucket key (set * W + window) * half + |digit| - 1 (stable, so a bucket's
// points keep index order), and each bucket's run is cut into chunks
// (msm_chunks.cuh: at most T entries on the chunk route; at the bucket's
// start and every L entries of the whole order on the range route).
//
// xy:        (n, 2 NL) uint32, point-major affine Montgomery (x limbs, y
//            limbs).
// entries:   (E,) int32, point index << 1 | sign, in bucket order; on the
//            range route each chunk's first entry | MSM_CHUNK_START.
// chunk_off: (C + 1,) int32, chunk c covers entries [chunk_off[c],
//            chunk_off[c + 1]); chunks are in bucket order.
// run_chunks: (R + 1,) int32 on the range route, accumulate thread r walks
//            chunks [run_chunks[r], run_chunks[r + 1]); none on the chunk
//            route, where thread r takes chunk r.
// bco:       (nb + 1,) int32, bucket b owns chunks [bco[b], bco[b + 1]).
// partials:  (3, NL, C) uint32 Jacobian, one per chunk.
//
// Every product and squaring is the carry-chain one (PROD_CHAIN,
// chain.cuh); the formulas are curve.cuh's, so every Jacobian
// representative is that of the plain versions.
#pragma once

#include "curve.cuh"
#include "msm_chunks.cuh"

template <int NL>
KZG_HD void g1_select(G1J<NL>& R, bool c, const G1J<NL>& A, const G1J<NL>& B) {
  fe_select<NL>(R.X, c, A.X, B.X);
  fe_select<NL>(R.Y, c, A.Y, B.Y);
  fe_select<NL>(R.Z, c, A.Z, B.Z);
}

// Entry -> its point's affine words (x, y), the sign and the chunk-start
// bit not applied.
template <int NL>
KZG_HD void msm_load_point(uint32_t x[NL], uint32_t y[NL], const uint32_t* xy,
                           int32_t entry) {
  const uint32_t* p =
      xy + (int64_t)(((uint32_t)entry & ~MSM_CHUNK_START) >> 1) * 2 * NL;
#ifdef __CUDA_ARCH__
  // 16-byte loads: a row is 8 NL bytes (64 or 96), so each stays aligned.
  const uint4* v = reinterpret_cast<const uint4*>(p);
  uint4 q[NL / 2];
#pragma unroll
  for (int j = 0; j < NL / 2; j++) q[j] = __ldg(v + j);
#pragma unroll
  for (int j = 0; j < NL / 4; j++) {
    x[4 * j] = q[j].x; x[4 * j + 1] = q[j].y;
    x[4 * j + 2] = q[j].z; x[4 * j + 3] = q[j].w;
    y[4 * j] = q[NL / 4 + j].x; y[4 * j + 1] = q[NL / 4 + j].y;
    y[4 * j + 2] = q[NL / 4 + j].z; y[4 * j + 3] = q[NL / 4 + j].w;
  }
#else
  for (int k = 0; k < NL; k++) {
    x[k] = p[k];
    y[k] = p[NL + k];
  }
#endif
}

// The adds of the accumulate and the window sums, in place on a point in
// registers: the formulas and case analysis of RegCurve.add_mixed /
// add_mixed_fast (madd-2007-bl) and g1_add (add-2007-bl), so every
// representative is theirs, in the order of K6's and K9's thread bodies:
// each input is used up as early as it can be and Z3 is known before X3,
// so fewer field elements are live at once (the carry chains are asm
// blocks, which the compiler keeps in source order).  P is kept whole up
// to the case split: its doubling is the P = Q case.

// P = 2 P (dbl-2009-l, g1_double's values), Z3 = 2 Y Z first.
template <int NL>
KZG_HD void g1_double_acc(G1J<NL>& P, const FieldConsts<NL>& F) {
  uint32_t A[NL], B[NL], C[NL], D[NL];
  fsqr<PROD_CHAIN>(B, P.Y, F);
  fmul<PROD_CHAIN>(P.Z, P.Y, P.Z, F);
  fe_double(P.Z, P.Z, F);                          // Z3
  fsqr<PROD_CHAIN>(A, P.X, F);
  fsqr<PROD_CHAIN>(C, B, F);
  fe_add(D, P.X, B, F);
  fsqr<PROD_CHAIN>(D, D, F);
  fe_sub(D, D, A, F);
  fe_sub(D, D, C, F);
  fe_double(D, D, F);                              // D
  fe_double(B, A, F);
  fe_add(A, B, A, F);                              // E = 3A
  fsqr<PROD_CHAIN>(P.X, A, F);
  fe_double(B, D, F);
  fe_sub(P.X, P.X, B, F);                          // X3 = E^2 - 2D
  fe_sub(D, D, P.X, F);
  fmul<PROD_CHAIN>(D, A, D, F);
  fe_double(C, C, F);
  fe_double(C, C, F);
  fe_double(C, C, F);                              // 8C
  fe_sub(P.Y, D, C, F);                            // Y3
}

// P += (qx, qy), q finite; COMPLETE: RegCurve.add_mixed, else
// add_mixed_fast (exact but where P = q, which gives the identity).
// next() runs once, where qx and qy are used up (after the rare doubling
// of the complete add): the accumulate loads its next point into their
// registers there.
template <bool COMPLETE, int NL, typename Next>
KZG_HD void g1_madd_acc(G1J<NL>& P, const uint32_t qx[NL],
                        const uint32_t qy[NL], const FieldConsts<NL>& F,
                        Next next) {
  if (fe_is_zero<NL>(P.Z)) {
    fe_copy<NL>(P.X, qx);
    fe_copy<NL>(P.Y, qy);
    fe_copy<NL>(P.Z, F.one);
    next();
    return;
  }
  uint32_t Z1Z1[NL], H[NL], Rr[NL];
  fsqr<PROD_CHAIN>(Z1Z1, P.Z, F);
  fmul<PROD_CHAIN>(H, qx, Z1Z1, F);                // U2
  fe_sub(H, H, P.X, F);                            // H = U2 - X1
  fmul<PROD_CHAIN>(Rr, qy, P.Z, F);
  fmul<PROD_CHAIN>(Rr, Rr, Z1Z1, F);               // S2
  fe_sub(Rr, Rr, P.Y, F);                          // S2 - Y1
  if (COMPLETE && fe_is_zero<NL>(H)) {
    if (fe_is_zero<NL>(Rr)) {
      g1_double_acc(P, F);
    } else {
      g1_set_identity(P, F);
    }
    next();
    return;
  }
  next();
  uint32_t HH[NL], t[NL];
  fsqr<PROD_CHAIN>(HH, H, F);
  fe_add(t, P.Z, H, F);
  fsqr<PROD_CHAIN>(t, t, F);
  fe_sub(t, t, Z1Z1, F);
  fe_sub(P.Z, t, HH, F);                           // Z3
  fe_double(HH, HH, F);
  fe_double(HH, HH, F);                            // I = 4 HH
  uint32_t* const J = Z1Z1;
  fmul<PROD_CHAIN>(J, H, HH, F);
  fmul<PROD_CHAIN>(t, P.X, HH, F);                 // V
  fe_double(Rr, Rr, F);                            // r
  fsqr<PROD_CHAIN>(P.X, Rr, F);
  fe_sub(P.X, P.X, J, F);
  fe_double(H, t, F);
  fe_sub(P.X, P.X, H, F);                          // X3
  fe_sub(t, t, P.X, F);
  fmul<PROD_CHAIN>(t, Rr, t, F);
  fmul<PROD_CHAIN>(J, P.Y, J, F);
  fe_double(J, J, F);
  fe_sub(P.Y, t, J, F);                            // Y3
}

// Complete P += Q (g1_add); Q may alias P.
template <int NL>
KZG_HD void g1_add_acc(G1J<NL>& P, const G1J<NL>& Q,
                       const FieldConsts<NL>& F) {
  if (fe_is_zero<NL>(P.Z)) {
    P = Q;
    return;
  }
  if (fe_is_zero<NL>(Q.Z)) return;
  uint32_t Z1Z1[NL], Z2Z2[NL], ZZ[NL], U1[NL], H[NL], S1[NL], Rr[NL];
  fsqr<PROD_CHAIN>(Z1Z1, P.Z, F);
  fsqr<PROD_CHAIN>(Z2Z2, Q.Z, F);
  fe_add(ZZ, P.Z, Q.Z, F);
  fsqr<PROD_CHAIN>(ZZ, ZZ, F);
  fe_sub(ZZ, ZZ, Z1Z1, F);
  fe_sub(ZZ, ZZ, Z2Z2, F);                         // (Z1 + Z2)^2 - Z1Z1 - Z2Z2
  fmul<PROD_CHAIN>(U1, P.X, Z2Z2, F);
  fmul<PROD_CHAIN>(H, Q.X, Z1Z1, F);               // U2
  fe_sub(H, H, U1, F);                             // H = U2 - U1
  fmul<PROD_CHAIN>(S1, P.Y, Q.Z, F);
  fmul<PROD_CHAIN>(S1, S1, Z2Z2, F);
  fmul<PROD_CHAIN>(Rr, Q.Y, P.Z, F);
  fmul<PROD_CHAIN>(Rr, Rr, Z1Z1, F);               // S2
  fe_sub(Rr, Rr, S1, F);                           // S2 - S1
  if (fe_is_zero<NL>(H)) {
    if (fe_is_zero<NL>(Rr)) {
      g1_double_acc(P, F);
    } else {
      g1_set_identity(P, F);
    }
    return;
  }
  fmul<PROD_CHAIN>(P.Z, ZZ, H, F);                 // Z3
  uint32_t* const I = Z1Z1;
  uint32_t* const J = Z2Z2;
  fsqr<PROD_CHAIN>(I, H, F);
  fe_double(I, I, F);
  fe_double(I, I, F);                              // I = 4 HH
  fmul<PROD_CHAIN>(J, H, I, F);
  fmul<PROD_CHAIN>(U1, U1, I, F);                  // V
  fe_double(Rr, Rr, F);                            // r
  fsqr<PROD_CHAIN>(P.X, Rr, F);
  fe_sub(P.X, P.X, J, F);
  fe_double(H, U1, F);
  fe_sub(P.X, P.X, H, F);                          // X3
  fe_sub(U1, U1, P.X, F);
  fmul<PROD_CHAIN>(U1, Rr, U1, F);
  fmul<PROD_CHAIN>(J, S1, J, F);
  fe_double(J, J, F);
  fe_sub(P.Y, U1, J, F);                           // Y3
}

// Thread r: chunks [run_chunks[r], run_chunks[r + 1]) (chunk r alone when
// run_chunks is null), walked as one run of entries.  A chunk's first
// point is loaded with Z = 1 (not added to a point, so the incomplete add
// never meets acc == q on a duplicate-free basis); the rest are mixed-added
// in entry order, y negated for a negative digit.  Inside a run each next
// chunk's first entry carries MSM_CHUNK_START: there the partial is stored
// and the chunk starts from the identity, whose add loads its point with
// Z = 1.  The next entry's gather is issued inside the current add, once
// the current point is used up (into the same registers), across chunk
// ends too, so its random read overlaps the add's products.
template <bool COMPLETE, int NL>
KZG_HD void msm_accumulate_thread(int64_t r, const uint32_t* xy,
                                  const int32_t* entries,
                                  const int32_t* chunk_off,
                                  const int32_t* run_chunks,
                                  uint32_t* partials, int64_t chunks,
                                  const FieldConsts<NL>& F) {
  const int32_t first = run_chunks ? run_chunks[r] : (int32_t)r;
  const int32_t s = chunk_off[first];
  const int32_t e = chunk_off[run_chunks ? run_chunks[r + 1] : r + 1];
  uint32_t* out = partials + first;  // this chunk's partial, words `chunks`
                                     // apart
  G1J<NL> acc;
  int32_t ent = entries[s];
  msm_load_point<NL>(acc.X, acc.Y, xy, ent);
  if (ent & 1) fe_neg(acc.Y, acc.Y, F);
  fe_copy<NL>(acc.Z, F.one);
  uint32_t x[NL], y[NL];
  if (s + 1 < e) {
    ent = entries[s + 1];
    msm_load_point<NL>(x, y, xy, ent);
  }
#pragma unroll 1
  for (int32_t j = s + 1; j < e; j++) {
    if ((uint32_t)ent & MSM_CHUNK_START) {
      g1_store(out++, chunks, 0, acc);
      g1_set_identity(acc, F);
    }
    if (ent & 1) fe_neg(y, y, F);
    const bool more = j + 1 < e;
    const int32_t next = more ? entries[j + 1] : 0;
    g1_madd_acc<COMPLETE>(acc, x, y, F, [&] {
      if (more) msm_load_point<NL>(x, y, xy, next);
    });
    ent = next;
  }
  g1_store(out, chunks, 0, acc);
}

// Doubling that leaves the identity alone (its X, Y stay as they are).
template <int NL>
KZG_HD void g1_double_finite(G1J<NL>& P, const FieldConsts<NL>& F) {
  if (!fe_is_zero<NL>(P.Z)) g1_double_acc(P, F);
}

// acc = m R by the c-bit double-and-add from the top bit: the end of a
// window-sum piece (csrc/probe/mont_probe.cu times it on a lone warp).
template <int NL>
KZG_HD void msm_piece_scale(G1J<NL>& acc, const G1J<NL>& R, int64_t m, int c,
                            const FieldConsts<NL>& F) {
  g1_set_identity(acc, F);
  for (int bit = c - 1; bit >= 0; bit--) {
    g1_double_finite(acc, F);
    if ((m >> bit) & 1) g1_add_acc(acc, R, F);
  }
}

// One thread's share of a window sum sum_m m B_m (B_m: the sum of bucket m's
// chunk partials; m = 1..half).
//
// The window's events, in descending m, are: the chunk partials of bucket m
// (R += P), then one step (Wt += R), so at the step of m, R is the suffix
// sum S_m and sum_m S_m = sum_m m B_m.  The E = chunks + half events are cut
// into tpw contiguous pieces of near-equal length, so a heavy bucket's chunks
// spread over many threads.  A piece with running sum R and weighted sum Wt
// contributes Wt + off R, off = the steps after it (the bucket whose step is
// pending when it ends), by a double-and-add over c bits.
//
// Positions are counted in ascending order A: step(m) at
// bco[base + m - 1] - cb + m - 1, then bucket m's chunks, chunk ch at
// ch - cb + m (cb = bco[base]).  Thread g walks A downward from
// E - 1 - g E / tpw.  All adds are complete: suffix sums of structured
// inputs can meet equal points.
template <int NL>
KZG_HD void msm_window_piece(G1J<NL>& V, int64_t wi, int64_t g, int64_t tpw,
                             const uint32_t* partials, int64_t chunks,
                             const int32_t* bco, int64_t half, int c,
                             const FieldConsts<NL>& F) {
  int64_t base = wi * half;
  int64_t cb = bco[base];
  int64_t E = (int64_t)bco[base + half] - cb + half;
  int64_t a = g * E / tpw, b = (g + 1) * E / tpw;
  G1J<NL> R, Wt;
  g1_set_identity(R, F);
  g1_set_identity(Wt, F);
  int64_t m = 0;
  if (b > a) {
    int64_t hi = E - 1 - a;
    int64_t lo_m = 1, hi_m = half;  // largest m with step(m) <= hi
    while (lo_m < hi_m) {
      int64_t mid = (lo_m + hi_m + 1) >> 1;
      if ((int64_t)bco[base + mid - 1] - cb + mid - 1 <= hi) {
        lo_m = mid;
      } else {
        hi_m = mid - 1;
      }
    }
    m = lo_m;
    int64_t sp = (int64_t)bco[base + m - 1] - cb + m - 1;
    for (int64_t p = hi; p >= E - b; p--) {
      bool st = p == sp;
      G1J<NL> X, Q;
      if (st) {
        Q = R;
      } else {
        g1_load(Q, partials, chunks, cb + p - m);
      }
      g1_select(X, st, Wt, R);
      g1_add_acc(X, Q, F);
      if (st) {
        Wt = X;
        m--;
        if (m >= 1) sp = (int64_t)bco[base + m - 1] - cb + m - 1;
      } else {
        R = X;
      }
    }
  }
  G1J<NL> acc;
  msm_piece_scale(acc, R, m, c, F);
  V = Wt;
  g1_add_acc(V, acc, F);
}

// One step of the window-sum block's tree: thread t < s adds sh[t + s].
template <int NL>
KZG_HD void msm_block_tree_step(G1J<NL>* sh, int t, int s,
                                const FieldConsts<NL>& F) {
  G1J<NL> A = sh[t];
  g1_add_acc(A, sh[t + s], F);
  sh[t] = A;
}

// ---------------------------------------------------------------------------
// The Horner fold on the lanes of one warp.
//
// Its chain is c (W - 1) doublings and W complete adds, each dependent on the
// one before: a single thread pays every product in turn.  Here the
// independent products of each curve operation run side by side, one a lane,
// in levels; after a level every lane holds every result (__shfl_sync), and
// every lane runs the add / sub steps itself, so the warp never diverges.
// dbl-2009-l is three levels (2, 3 and 2 products), add-2007-bl five (5, 4,
// 2, 3 and 2): the depth of 2 squarings and a product, and of a squaring and
// four products.  On the host (g++) a level computes its products one after
// another: the same formula and operand lists, lane by lane.
// ---------------------------------------------------------------------------

// x = a[k]: lane k's operand among the K of a level.
template <int K, int NL>
KZG_HD void lane_operand(uint32_t x[NL], const uint32_t* const (&a)[K],
                         int k) {
  fe_copy<NL>(x, a[0]);
#pragma unroll
  for (int j = 1; j < K; j++) fe_select<NL>(x, k == j, a[j], x);
}

// One level of K independent products out[k] = a[k] b[k] (SQR: a[k]^2).
// Lane k < K computes out[k] (lanes past K repeat the last); then every lane
// of the warp holds all K.  out may alias an operand.
template <bool SQR, int K, int NL>
KZG_HD void lanes_level(uint32_t* const (&out)[K],
                        const uint32_t* const (&a)[K],
                        const uint32_t* const (&b)[K], int lane,
                        const FieldConsts<NL>& F) {
#ifdef __CUDA_ARCH__
  uint32_t x[NL], r[NL];
  const int k = lane < K ? lane : K - 1;
  lane_operand<K, NL>(x, a, k);
  if (SQR) {
    fsqr<PROD_CHAIN>(r, x, F);
  } else {
    uint32_t y[NL];
    lane_operand<K, NL>(y, b, k);
    fmul<PROD_CHAIN>(r, x, y, F);
  }
#pragma unroll
  for (int j = 0; j < K; j++)
#pragma unroll
    for (int w = 0; w < NL; w++) out[j][w] = __shfl_sync(0xFFFFFFFFu, r[w], j);
#else
  (void)lane;
  uint32_t r[K][NL];
  for (int k = 0; k < K; k++) {
    uint32_t x[NL];
    lane_operand<K, NL>(x, a, k);
    if (SQR) {
      fsqr<PROD_CHAIN>(r[k], x, F);
    } else {
      uint32_t y[NL];
      lane_operand<K, NL>(y, b, k);
      fmul<PROD_CHAIN>(r[k], x, y, F);
    }
  }
  for (int k = 0; k < K; k++) fe_copy<NL>(out[k], r[k]);
#endif
}

// dbl-2009-l (g1_double's values) on the lanes; the identity maps to Z = 0.
template <int NL>
KZG_HD void g1_double_lanes(G1J<NL>& P, int lane, const FieldConsts<NL>& F) {
  uint32_t A[NL], B[NL], C[NL], t[NL], E[NL], FF[NL], D[NL], u[NL];
  lanes_level<true, 2, NL>({A, B}, {P.X, P.Y}, {P.X, P.Y}, lane, F);
  fe_add(t, P.X, B, F);
  fe_double(E, A, F);
  fe_add(E, E, A, F);
  lanes_level<true, 3, NL>({C, t, FF}, {B, t, E}, {B, t, E}, lane, F);
  fe_sub(D, t, A, F);
  fe_sub(D, D, C, F);
  fe_double(D, D, F);
  fe_double(u, D, F);
  fe_sub(FF, FF, u, F);                            // X3
  fe_sub(t, D, FF, F);
  lanes_level<false, 2, NL>({t, u}, {E, P.Y}, {t, P.Z}, lane, F);
  fe_double(C, C, F);
  fe_double(C, C, F);
  fe_double(C, C, F);                              // 8C
  fe_sub(P.Y, t, C, F);
  fe_double(P.Z, u, F);
  fe_copy<NL>(P.X, FF);
}

// Complete P += Q (g1_add's values and case analysis) on the lanes.
template <int NL>
KZG_HD void g1_add_lanes(G1J<NL>& P, const G1J<NL>& Q, int lane,
                         const FieldConsts<NL>& F) {
  if (fe_is_zero<NL>(P.Z)) {
    P = Q;
    return;
  }
  if (fe_is_zero<NL>(Q.Z)) return;
  uint32_t Z1Z1[NL], Z2Z2[NL], ZZ[NL], S1[NL], S2[NL], U1[NL], U2[NL];
  fe_add(ZZ, P.Z, Q.Z, F);
  lanes_level<false, 5, NL>({Z1Z1, Z2Z2, ZZ, S1, S2},
                            {P.Z, Q.Z, ZZ, P.Y, Q.Y},
                            {P.Z, Q.Z, ZZ, Q.Z, P.Z}, lane, F);
  lanes_level<false, 4, NL>({U1, U2, S1, S2}, {P.X, Q.X, S1, S2},
                            {Z2Z2, Z1Z1, Z2Z2, Z1Z1}, lane, F);
  fe_sub(U2, U2, U1, F);                           // H
  fe_sub(S2, S2, S1, F);                           // Rr
  if (fe_is_zero<NL>(U2)) {
    if (fe_is_zero<NL>(S2)) {
      g1_double_lanes(P, lane, F);
    } else {
      g1_set_identity(P, F);
    }
    return;
  }
  fe_sub(ZZ, ZZ, Z1Z1, F);
  fe_sub(ZZ, ZZ, Z2Z2, F);
  fe_double(S2, S2, F);                            // r = 2 Rr
  uint32_t HH[NL], X3[NL];
  lanes_level<true, 2, NL>({HH, X3}, {U2, S2}, {U2, S2}, lane, F);
  fe_double(HH, HH, F);
  fe_double(HH, HH, F);                            // I = 4 HH
  uint32_t* const J = Z1Z1;
  uint32_t* const V = Z2Z2;
  lanes_level<false, 3, NL>({J, V, P.Z}, {U2, U1, ZZ}, {HH, HH, U2}, lane,
                            F);
  fe_sub(X3, X3, J, F);
  fe_double(U1, V, F);
  fe_sub(X3, X3, U1, F);
  fe_sub(V, V, X3, F);
  lanes_level<false, 2, NL>({V, J}, {S2, S1}, {V, J}, lane, F);
  fe_double(J, J, F);
  fe_sub(P.Y, V, J, F);
  fe_copy<NL>(P.X, X3);
}

// Window totals of one scalar set: S holds its W windows' P partials each
// (window w's at S[w P ..]); one level of the halving tree, m partials a
// window now and h = ceil(m / 2) after: pair i (of W (m - h)) adds
// S[w P + j + h] into S[w P + j].
template <int NL>
KZG_HD void msm_total_pair(G1J<NL>* S, int pieces, int m, int i,
                           const FieldConsts<NL>& F) {
  const int h = (m + 1) / 2;
  const int w = i / (m - h), j = i % (m - h);
  G1J<NL>* s = S + w * pieces;
  G1J<NL> A = s[j];
  g1_add_acc(A, s[j + h], F);
  s[j] = A;
}

// acc = 2^c acc + S_w from the top window down (window totals at S[w P]),
// on the lanes of one warp.
template <int NL>
KZG_HD void msm_horner(G1J<NL>& acc, const G1J<NL>* S, int windows,
                       int pieces, int c, int lane,
                       const FieldConsts<NL>& F) {
  g1_set_identity(acc, F);
#pragma unroll 1
  for (int w = windows - 1; w >= 0; w--) {
#pragma unroll 1
    for (int i = 0; i < c; i++)
      if (!fe_is_zero<NL>(acc.Z)) g1_double_lanes(acc, lane, F);
    g1_add_lanes(acc, S[w * pieces], lane, F);
  }
}
