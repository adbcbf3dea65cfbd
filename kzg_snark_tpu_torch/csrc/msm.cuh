// Thread bodies of the bucket-route MSM: the sorted-bucket accumulate (the K8
// replacement) and the reduction of its partials (in place of the K6 / K7
// chains of the lane fold, suffix ladder and Horner fold).
//
// The schedule comes from the wrapper (ops/msm_kernel.py): every nonzero
// signed digit of every (set, window) is an entry, the entries are sorted by
// bucket key (set * W + window) * half + |digit| - 1 (stable, so a bucket's
// points keep index order), and each bucket's run is cut into chunks of at
// most T entries.
//
// xy:        (n, 2 NL) uint32, point-major affine Montgomery (x limbs, y
//            limbs).
// entries:   (E,) int32, point index << 1 | sign, in bucket order.
// chunk_off: (C + 1,) int32, chunk c covers entries [chunk_off[c],
//            chunk_off[c + 1]); chunks are in bucket order.
// bco:       (nb + 1,) int32, bucket b owns chunks [bco[b], bco[b + 1]).
// partials:  (3, NL, C) uint32 Jacobian, one per chunk.
#pragma once

#include "curve.cuh"

template <int NL>
KZG_HD void g1_select(G1J<NL>& R, bool c, const G1J<NL>& A, const G1J<NL>& B) {
  fe_select<NL>(R.X, c, A.X, B.X);
  fe_select<NL>(R.Y, c, A.Y, B.Y);
  fe_select<NL>(R.Z, c, A.Z, B.Z);
}

// Entry -> the affine point (x, y), y negated for a negative digit.
template <int NL>
KZG_HD void msm_load_entry(uint32_t x[NL], uint32_t y[NL], const uint32_t* xy,
                           int32_t entry, const FieldConsts<NL>& F) {
  const uint32_t* p = xy + (int64_t)((uint32_t)entry >> 1) * 2 * NL;
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
  if (entry & 1) fe_neg(y, y, F);
}

// Chunk c: its first point is loaded with Z = 1 (not added to the identity,
// so the incomplete add never meets acc == q on a duplicate-free basis),
// the rest are mixed-added in entry order.
template <bool COMPLETE, int NL>
KZG_HD void msm_accumulate_thread(int64_t c, const uint32_t* xy,
                                  const int32_t* entries,
                                  const int32_t* chunk_off, uint32_t* partials,
                                  int64_t chunks, const FieldConsts<NL>& F) {
  int32_t s = chunk_off[c], e = chunk_off[c + 1];
  G1J<NL> acc;
  msm_load_entry(acc.X, acc.Y, xy, entries[s], F);
  fe_copy<NL>(acc.Z, F.one);
  for (int32_t j = s + 1; j < e; j++) {
    uint32_t x[NL], y[NL];
    msm_load_entry(x, y, xy, entries[j], F);
    if (COMPLETE) {
      g1_add_mixed(acc, acc, x, y, F);
    } else {
      g1_add_mixed_fast(acc, acc, x, y, F);
    }
  }
  g1_store(partials, chunks, c, acc);
}

// The reduction runs long chains of curve operations on few threads, so it
// takes the product with the small loop body (PROD_COMPACT): same values.
//
// Doubling that leaves the identity alone (its X, Y stay as they are).
template <int NL>
KZG_HD void g1_double_finite(G1J<NL>& P, const FieldConsts<NL>& F) {
  if (!fe_is_zero<NL>(P.Z)) g1_double<PROD_COMPACT>(P, P, F);
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
      g1_add<PROD_COMPACT>(X, X, Q, F);
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
  g1_set_identity(acc, F);
  for (int bit = c - 1; bit >= 0; bit--) {
    g1_double_finite(acc, F);
    if ((m >> bit) & 1) g1_add<PROD_COMPACT>(acc, acc, R, F);
  }
  g1_add<PROD_COMPACT>(V, Wt, acc, F);
}

// Window wi's total: the sum of its P block partials in order.
template <int NL>
KZG_HD void msm_window_total(G1J<NL>& S, const uint32_t* wparts, int64_t m,
                             int64_t wi, int pieces, const FieldConsts<NL>& F) {
  g1_load(S, wparts, m, wi * pieces);
  for (int j = 1; j < pieces; j++) {
    G1J<NL> Q;
    g1_load(Q, wparts, m, wi * pieces + j);
    g1_add<PROD_COMPACT>(S, S, Q, F);
  }
}

// acc = 2^c acc + S_w from the top window down.
template <int NL>
KZG_HD void msm_horner(G1J<NL>& acc, const G1J<NL>* S, int windows, int c,
                       const FieldConsts<NL>& F) {
  g1_set_identity(acc, F);
  for (int w = windows - 1; w >= 0; w--) {
    for (int i = 0; i < c; i++) g1_double_finite(acc, F);
    g1_add<PROD_COMPACT>(acc, acc, S[w], F);
  }
}
