// Thread body of the Pippenger bucket pass (the K8 replacement).
//
// One thread owns one (window, lane) cell and a private table of NB buckets
// (magnitudes 1..NB) in device memory; it walks the points i = lane,
// lane + lanes, ... and mixed-adds (-1)^sign P_i into bucket |digit|.  No two
// threads share a bucket, so there are no collisions and no atomics.  A
// zero digit touches nothing (the TPU kernel sent it to a trash bucket).
//
// px, py: (8, npts) Fq Montgomery affine coordinates (npts a multiple of
//         lanes; padding points are finite and carry digit 0).
// digits: (windows, npts) int32, encoded mag | sign << 7.
// table:  (NB, 3, 8, cells) uint32, cells = windows * lanes, cell index
//         window * lanes + lane, so neighbouring threads touch
//         neighbouring words.
#pragma once

#include "curve.cuh"

KZG_HD void msm_bucket_thread(int64_t cell, const uint32_t* px,
                              const uint32_t* py, int64_t npts,
                              const int32_t* digits, uint32_t* table,
                              int64_t cells, int64_t lanes, int nb,
                              int complete, const FieldConsts& F) {
  int64_t w = cell / lanes;
  int64_t lane = cell - w * lanes;
  for (int b = 0; b < nb; b++) {
    uint32_t* bk = table + (int64_t)b * 3 * NL * cells;
    for (int k = 0; k < NL; k++) {
      bk[k * cells + cell] = F.one[k];
      bk[(NL + k) * cells + cell] = F.one[k];
      bk[(2 * NL + k) * cells + cell] = 0;
    }
  }
  const int32_t* dig = digits + w * npts;
  for (int64_t i = lane; i < npts; i += lanes) {
    uint32_t d = (uint32_t)dig[i];
    int mag = (int)(d & 0x7F);
    if (mag == 0) continue;
    uint32_t qx[NL], qy[NL];
    fe_load(qx, px, npts, i);
    fe_load(qy, py, npts, i);
    if (d >> 7) fe_neg(qy, qy, F);
    uint32_t* bk = table + (int64_t)(mag - 1) * 3 * NL * cells;
    G1J cur, nxt;
    g1_load(cur, bk + cell, cells, 0);
    if (complete) {
      g1_add_mixed(nxt, cur, qx, qy, F);
    } else {
      g1_add_mixed_fast(nxt, cur, qx, qy, F);
    }
    g1_store(bk + cell, cells, 0, nxt);
  }
}
