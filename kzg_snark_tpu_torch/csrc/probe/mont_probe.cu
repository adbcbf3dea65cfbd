// Measurement probes of the Montgomery product policies, not part of the
// kernel library (utils/build.py builds this file apart):
//
// * probe_copy / probe_mul / probe_sqr: one product or squaring a kernel,
//   never launched; utils/build.sass_product_counts compiles them to a
//   cubin and counts each one's instructions by opcode (cuobjdump -sass),
//   less those of probe_copy (the same loads and stores).
// * probe_loop: every thread runs `reps` dependent products (x = x y) or
//   squarings (x = x^2) on its own element, so a launch over many threads
//   times the product's throughput on the card (kzg_probe_loop, timed by
//   chip_smoke.py's build phase).
// * probe_piece_scale: the window-sum piece's c-bit double-and-add
//   (msm.cuh msm_piece_scale), `reps` times in a dependent chain on each
//   thread's point (kzg_probe_piece_scale): on one warp, its latency.
// * probe_inv: `reps` dependent inversions of each thread's element, by
//   safegcd (inv.cuh fe_inv_mont) or by Fermat's chain x^(p-2) on
//   PROD_CHAIN (scan.cuh fe_pow_chain) (kzg_probe_inv): on one warp, the
//   floor of fr_pow's inversion route at width 1 and that of the chain.
#include <cuda_runtime.h>
#include <string.h>

#include "../msm.cuh"
#include "../scan.cuh"

template <int NL>
__global__ void probe_copy(uint32_t* r, const uint32_t* a, const uint32_t* b,
                           FieldConsts<NL> F) {
  uint32_t x[NL], y[NL];
  fe_load<NL>(x, a, 1, 0);
  fe_load<NL>(y, b, 1, 0);
  for (int k = 0; k < NL; k++) x[k] ^= y[k];
  fe_store<NL>(r, 1, 0, x);
}

template <int POL, int NL>
__global__ void probe_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                          FieldConsts<NL> F) {
  uint32_t x[NL], y[NL], z[NL];
  fe_load<NL>(x, a, 1, 0);
  fe_load<NL>(y, b, 1, 0);
  fmul<POL>(z, x, y, F);
  fe_store<NL>(r, 1, 0, z);
}

template <int POL, int NL>
__global__ void probe_sqr(uint32_t* r, const uint32_t* a, const uint32_t* b,
                          FieldConsts<NL> F) {
  uint32_t x[NL], z[NL];
  fe_load<NL>(x, a, 1, 0);
  fsqr<POL>(z, x, F);
  fe_store<NL>(r, 1, 0, z);
}

template __global__ void probe_copy<8>(uint32_t*, const uint32_t*,
                                       const uint32_t*, FieldConsts<8>);
template __global__ void probe_copy<12>(uint32_t*, const uint32_t*,
                                        const uint32_t*, FieldConsts<12>);
#define KZG_PROBE(POL, NL)                                                  \
  template __global__ void probe_mul<POL, NL>(                              \
      uint32_t*, const uint32_t*, const uint32_t*, FieldConsts<NL>);        \
  template __global__ void probe_sqr<POL, NL>(                              \
      uint32_t*, const uint32_t*, const uint32_t*, FieldConsts<NL>);
KZG_PROBE(PROD_CIOS, 8)
KZG_PROBE(PROD_CIOS, 12)
KZG_PROBE(PROD_CHAIN, 8)
KZG_PROBE(PROD_CHAIN, 12)

template <int SQR, int POL, int NL>
__global__ void __launch_bounds__(128)
    probe_loop(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
               uint32_t* __restrict__ out, int64_t n, int reps,
               FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a[NL], b[NL];
  fe_load<NL>(a, x, n, i);
  fe_load<NL>(b, y, n, i);
#pragma unroll 1
  for (int r = 0; r < reps; r++) {
    if (SQR) {
      fsqr<POL>(a, a, F);
    } else {
      fmul<POL>(a, a, b, F);
    }
  }
  fe_store<NL>(out, n, i, a);
}

template <int SQR, int POL, int NL>
static int launch_loop(const void* x, const void* y, void* out, int64_t n,
                       int reps, const void* consts, void* stream) {
  probe_loop<SQR, POL, NL><<<(unsigned)((n + 127) / 128), 128, 0,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n, reps,
      consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

template <int NL>
static int loop_by_policy(int sqr, int pol, const void* x, const void* y,
                          void* out, int64_t n, int reps, const void* consts,
                          void* stream) {
  if (pol == PROD_CIOS)
    return sqr ? launch_loop<1, PROD_CIOS, NL>(x, y, out, n, reps, consts,
                                               stream)
               : launch_loop<0, PROD_CIOS, NL>(x, y, out, n, reps, consts,
                                               stream);
  if (pol == PROD_CHAIN)
    return sqr ? launch_loop<1, PROD_CHAIN, NL>(x, y, out, n, reps, consts,
                                                stream)
               : launch_loop<0, PROD_CHAIN, NL>(x, y, out, n, reps, consts,
                                                stream);
  return KZG_BAD_LIMBS;
}

// `reps` products (sqr = 0: x = x y) or squarings (sqr = 1) of policy
// `pol` on each of n elements; (NL, n) operands, NL from the consts block.
extern "C" int kzg_probe_loop(int sqr, int pol, const void* x, const void* y,
                              void* out, int64_t n, int reps,
                              const void* consts, void* stream) {
  return KZG_BY_LIMBS(consts, loop_by_policy, sqr, pol, x, y, out, n, reps,
                      consts, stream);
}

// Thread i < n: R = point i of pts (3, NL, n), then `reps` times
// R = mult_i R by msm_piece_scale over c bits; R to column i of out.
template <int NL>
__global__ void __launch_bounds__(128)
    probe_piece_scale(const uint32_t* __restrict__ pts,
                      const int64_t* __restrict__ mult, int64_t n, int c,
                      int reps, uint32_t* __restrict__ out,
                      FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1J<NL> R, acc;
  g1_load(R, pts, n, i);
#pragma unroll 1
  for (int r = 0; r < reps; r++) {
    msm_piece_scale(acc, R, mult[i], c, F);
    R = acc;
  }
  g1_store(out, n, i, R);
}

template <int NL>
static int launch_piece_scale(const void* pts, const void* mult, int64_t n,
                              int c, int reps, void* out, const void* consts,
                              void* stream) {
  probe_piece_scale<NL><<<(unsigned)((n + 127) / 128), 128, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)pts, (const int64_t*)mult, n, c, reps,
      (uint32_t*)out, consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

extern "C" int kzg_probe_piece_scale(const void* pts, const void* mult,
                                     int64_t n, int c, int reps, void* out,
                                     const void* consts, void* stream) {
  return KZG_BY_LIMBS(consts, launch_piece_scale, pts, mult, n, c, reps, out,
                      consts, stream);
}

template <int NL>
struct ProbeExponent {
  uint32_t w[NL];
};

// Thread i < n: x = element i, then `reps` times x = 1 / x (route 0:
// safegcd, route 1: x^e by the chain, e = p - 2); x to column i of out.
template <int NL>
__global__ void __launch_bounds__(128)
    probe_inv(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
              int64_t n, int reps, int route, ProbeExponent<NL> e, int nbits,
              InvConsts<NL> I, FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a[NL];
  fe_load<NL>(a, x, n, i);
#pragma unroll 1
  for (int r = 0; r < reps; r++) {
    if (route == 0) {
      fe_inv_mont(a, a, F, I);
    } else {
      fe_pow_chain(a, a, e.w, nbits, F);
    }
  }
  fe_store<NL>(out, n, i, a);
}

template <int NL>
static int launch_inv(int route, const void* x, void* out, int64_t n,
                      int reps, const void* exponent, int nbits,
                      const void* inv_consts, const void* consts,
                      void* stream) {
  ProbeExponent<NL> e;
  memcpy(e.w, exponent, sizeof(e.w));
  InvConsts<NL> I;
  memcpy(&I, inv_consts, sizeof(I));
  probe_inv<NL><<<(unsigned)((n + 127) / 128), 128, 0,
                  (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)out,
                                          n, reps, route, e, nbits, I,
                                          consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

// `reps` dependent inversions (route 0: safegcd; 1: x^e on the chain) of
// each of n elements, (NL, n) operands in Montgomery form.
extern "C" int kzg_probe_inv(int route, const void* x, void* out, int64_t n,
                             int reps, const void* exponent, int nbits,
                             const void* inv_consts, const void* consts,
                             void* stream) {
  return KZG_BY_LIMBS(consts, launch_inv, route, x, out, n, reps, exponent,
                      nbits, inv_consts, consts, stream);
}
