// Thread bodies of the SRS fixed-base table kernel (srs_kernels.cu), shared
// with the CPU build (host_check.cpp).
//
// The table T[j, v] = v 2^(c j) G, j < W windows, v < 2^c, is a (3, NL, W 2^c)
// point array: column j 2^c + v.  It is built as ops/srs.py
// fixed_base_table_plain builds it, so every Jacobian representative is
// the same: the window bases by a chain of c doublings each (T[j, 1]), the
// identity (one, one, 0) at T[j, 0], then levels count = 2, 4, ..., 2^(c-1):
// step_j = 2 T[j, count / 2], then T[j, v + count] = T[j, v] + step_j for
// v < count.
#pragma once

#include "curve.cuh"

// One thread: the window bases, c (W - 1) dependent doublings.  With the
// unrolled product (fe_mul): the rolled one, which halved the MSM
// reduction's one-thread chains, made this kernel slower on an H100 (2.62
// against 2.04 ms at c = 8, W = 32; chip_smoke.py's chains phase).
template <int NL>
KZG_HD void fbt_chain(const uint32_t* base, uint32_t* table, int windows,
                      int c, const FieldConsts<NL>& F) {
  const int64_t m = (int64_t)windows << c;
  G1J<NL> P;
  g1_load(P, base, 1, 0);
  g1_store(table, m, 1, P);
  for (int j = 1; j < windows; j++) {
    for (int d = 0; d < c; d++) g1_double(P, P, F);
    g1_store(table, m, ((int64_t)j << c) + 1, P);
  }
}

template <int NL>
KZG_HD void fbt_identity_thread(int j, uint32_t* table, int windows, int c,
                                const FieldConsts<NL>& F) {
  G1J<NL> I;
  fe_copy<NL>(I.X, F.one);
  fe_copy<NL>(I.Y, F.one);
  for (int k = 0; k < NL; k++) I.Z[k] = 0;
  g1_store(table, (int64_t)windows << c, (int64_t)j << c, I);
}

// Level `count`, thread j < W: steps[j] = 2 T[j, count / 2]; steps is
// (3, NL, W).
template <int NL>
KZG_HD void fbt_step_thread(int j, int count, const uint32_t* table,
                            uint32_t* steps, int windows, int c,
                            const FieldConsts<NL>& F) {
  G1J<NL> P;
  g1_load(P, table, (int64_t)windows << c, ((int64_t)j << c) + count / 2);
  g1_double(P, P, F);
  g1_store(steps, windows, j, P);
}

// Level `count`, thread idx < W count: T[j, v + count] = T[j, v] + steps[j]
// for j = idx / count, v = idx mod count.
template <int NL>
KZG_HD void fbt_add_thread(int64_t idx, int count, uint32_t* table,
                           const uint32_t* steps, int windows, int c,
                           const FieldConsts<NL>& F) {
  const int64_t m = (int64_t)windows << c;
  int64_t j = idx / count;
  int64_t v = idx % count;
  G1J<NL> P, Q;
  g1_load(P, table, m, (j << c) + v);
  g1_load(Q, steps, windows, j);
  g1_add(P, P, Q, F);
  g1_store(table, m, (j << c) + v + count, P);
}
