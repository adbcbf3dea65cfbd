// Thread bodies of the NTT stage kernels (decimation in time, input in
// bit-reversed order, output in natural order).
//
// x and y are (8, n) Fr arrays in Montgomery form; tw is the (8, n/2) table
// of root powers w^k.  A stage of span s pairs i with i + s and multiplies
// the upper element by w^((i mod s) * n / (2 s)), the schedule of
// kzg_snark_tpu/ops/ntt.py NttContext._transform.
#pragma once

#include "field.cuh"

KZG_HD void ntt_butterfly(uint32_t lo[NL], uint32_t hi[NL],
                          const uint32_t w[NL], const FieldConsts& F) {
  uint32_t prod[NL];
  fe_mul(prod, hi, w, F);
  fe_sub(hi, lo, prod, F);
  fe_add(lo, lo, prod, F);
}

// One stage of span s; thread t < n/2 owns one butterfly.
KZG_HD void ntt_radix2_thread(int64_t t, const uint32_t* x, uint32_t* y,
                              const uint32_t* tw, int64_t n, int64_t s,
                              const FieldConsts& F) {
  int64_t j = t & (s - 1);
  int64_t i0 = (t - j) * 2 + j;
  int64_t i1 = i0 + s;
  uint32_t a[NL], b[NL], w[NL];
  fe_load(a, x, n, i0);
  fe_load(b, x, n, i1);
  fe_load(w, tw, n / 2, j * (n / (2 * s)));
  ntt_butterfly(a, b, w, F);
  fe_store(y, n, i0, a);
  fe_store(y, n, i1, b);
}

// Two stages, spans s and 2s, in one pass; thread t < n/4 owns the four
// elements base + {0, s, 2s, 3s} of one 4s block and does four butterflies.
KZG_HD void ntt_radix4_thread(int64_t t, const uint32_t* x, uint32_t* y,
                              const uint32_t* tw, int64_t n, int64_t s,
                              const FieldConsts& F) {
  int64_t j = t & (s - 1);
  int64_t base = (t - j) * 4 + j;
  int64_t half = n / 2;
  uint32_t x0[NL], x1[NL], x2[NL], x3[NL], w[NL];
  fe_load(x0, x, n, base);
  fe_load(x1, x, n, base + s);
  fe_load(x2, x, n, base + 2 * s);
  fe_load(x3, x, n, base + 3 * s);
  fe_load(w, tw, half, j * (n / (2 * s)));
  ntt_butterfly(x0, x1, w, F);
  ntt_butterfly(x2, x3, w, F);
  int64_t stride_b = n / (4 * s);
  fe_load(w, tw, half, j * stride_b);
  ntt_butterfly(x0, x2, w, F);
  fe_load(w, tw, half, (j + s) * stride_b);
  ntt_butterfly(x1, x3, w, F);
  fe_store(y, n, base, x0);
  fe_store(y, n, base + s, x1);
  fe_store(y, n, base + 2 * s, x2);
  fe_store(y, n, base + 3 * s, x3);
}

// K10: one stage combine on pre-aligned rows (the scan-mode NTT):
// out[i] = mask[i] ? xl[i] - tw[i] xu[i] : xl[i] + tw[i] xu[i] over (8, n).
KZG_HD void fr_butterfly_thread(int64_t i, const uint32_t* xl,
                                const uint32_t* xu, const uint32_t* tw,
                                const int32_t* mask, uint32_t* out, int64_t n,
                                const FieldConsts& F) {
  uint32_t a[NL], b[NL], w[NL], prod[NL];
  fe_load(a, xl, n, i);
  fe_load(b, xu, n, i);
  fe_load(w, tw, n, i);
  fe_mul(prod, b, w, F);
  if (mask[i]) {
    fe_sub(a, a, prod, F);
  } else {
    fe_add(a, a, prod, F);
  }
  fe_store(out, n, i, a);
}
