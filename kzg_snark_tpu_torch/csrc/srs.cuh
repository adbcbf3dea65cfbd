// Thread bodies of the SRS fixed-base table kernel (srs_kernels.cu), shared
// with the CPU build (host_check.cpp).
//
// The table T[j, v] = v 2^(c j) G, j < W windows, v < 2^c, is a (3, NL, W 2^c)
// point array: column j 2^c + v.  It is built as ops/srs.py
// fixed_base_table_plain builds it, so every Jacobian representative is
// the same: the window bases by a chain of c doublings each (T[j, 1]), the
// identity (one, one, 0) at T[j, 0], then levels count = 2, 4, ..., 2^(c-1):
// step = 2 T[j, count / 2], then T[j, v + count] = T[j, v] + step for
// v < count.  T[j, count / 2] is the previous level's step word for word
// (the identity plus a point is that point), so a row keeps its step in
// registers and doubles it once a level.
//
// The chain runs on the lanes of one warp (msm.cuh: g1_double_lanes, the
// MSM fold's doubling, each level's independent products one a lane); a row
// runs on a group of FBT_GROUP_THREADS threads, its step doubled on each
// warp's lanes and its adds one a thread, every product on PROD_CHAIN.
#pragma once

#include "msm.cuh"

// A row group: two warps.  At c = 8 the last level's 128 adds are two a
// thread.
#define FBT_GROUP_THREADS 64
// The launch srs_kernels.cu makes: a cluster of FBT_CLUSTER blocks, block 0
// the chain's warp, each other block FBT_GROUPS row groups.  A block of 32 +
// 3 x 64 threads may hold 255 registers a thread, so the 12-word instance
// does not spill.
#define FBT_CLUSTER 16
#define FBT_GROUPS 3
// Row groups of the launch: a table of more windows than this hands a group
// a second window.
#define FBT_UNITS ((FBT_CLUSTER - 1) * FBT_GROUPS)

// The window bases B_j = 2^(c j) base, j < W, on the lanes of one warp
// (lane in 0..31; the host runs a level's products one after another):
// c doublings a base after the first.  Lane 0 stores B_j at T[j, 1], then
// publish(j) runs on every lane.
template <int NL, typename Publish>
KZG_HD void fbt_chain_lanes(const uint32_t* base, uint32_t* table,
                            int windows, int c, int lane,
                            const FieldConsts<NL>& F, Publish publish) {
  const int64_t m = (int64_t)windows << c;
  G1J<NL> P;
  g1_load(P, base, 1, 0);
#pragma unroll 1
  for (int j = 0; j < windows; j++) {
#pragma unroll 1
    for (int d = 0; j > 0 && d < c; d++) g1_double_lanes(P, lane, F);
    if (lane == 0) g1_store(table, m, ((int64_t)j << c) + 1, P);
    publish(j);
  }
}

// Window j's identity (one, one, 0) at T[j, 0].
template <int NL>
KZG_HD void fbt_identity(int64_t j, uint32_t* table, int windows, int c,
                         const FieldConsts<NL>& F) {
  G1J<NL> I;
  g1_set_identity(I, F);
  g1_store(table, (int64_t)windows << c, j << c, I);
}

// Level `count` of window j, thread t of a group of `threads`: T[j, v +
// count] = T[j, v] + step for v = t, t + threads, ... below count (the
// complete add, T[j, v] on the left as in the plain version).
template <int NL>
KZG_HD void fbt_level_adds(int64_t j, int count, const G1J<NL>& step, int t,
                           int threads, uint32_t* table, int windows, int c,
                           const FieldConsts<NL>& F) {
  const int64_t m = (int64_t)windows << c, row = j << c;
#pragma unroll 1
  for (int v = t; v < count; v += threads) {
    G1J<NL> P;
    g1_load(P, table, m, row + v);
    g1_add_acc(P, step, F);
    g1_store(table, m, row + v + count, P);
  }
}
