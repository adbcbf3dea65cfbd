// K6, K7 and K9 replacements: batched complete Jacobian add, doubling and
// complete mixed add (Jacobian + affine) on G1.
//
// Replaces kzg_snark_tpu/ops/pallas_fr.py:_add_call (fused_curve_add),
// :_double_call (fused_curve_double) and :_add_mixed_call
// (fused_curve_add_mixed).  K6 / K7 build the SRS table and window bases,
// fold the MSM bucket tables (lanes, bucket suffix ladder, windows) and run
// the Horner fold; K9 is the step of the scan MSM (256 < n < 2048) and of
// the random-basis build.
//
// What bounds it on the H100: a complete add is about 16 Montgomery products
// and 20 add/subs on 12 NL-byte points (96 bytes at BN254, 144 at
// BLS12-381; three points moved): compute-bound at large batches,
// launch-bound in the Horner fold, where the batch is the number of
// scalars.  The mixed add is about 11 products and reads one point of P (q
// broadcasts) and writes one.  Design: one thread per point, the formulas
// of curve.cuh in registers, limb-major (3, NL, m) words for coalesced
// loads; K9's q has a column period (i % qn), so its callers' broadcast
// point is read from a small table, never expanded.  Instantiated at
// NL = 8 (BN254 Fq) and NL = 12 (BLS12-381 Fq); the entry points take the
// limb count from the consts block.
#include <cuda_runtime.h>
#include <string.h>

#include "curve.cuh"

namespace {

constexpr int kThreads = 128;

template <int NL>
__global__ void k_g1_add(const uint32_t* __restrict__ p,
                         const uint32_t* __restrict__ q,
                         uint32_t* __restrict__ out, int64_t m,
                         FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  g1_add_thread(i, p, q, out, m, F);
}

template <int NL>
__global__ void k_g1_double(const uint32_t* __restrict__ p,
                            uint32_t* __restrict__ out, int64_t m,
                            FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  g1_double_thread(i, p, out, m, F);
}

template <int NL>
__global__ void k_g1_add_mixed(const uint32_t* __restrict__ p,
                               const uint32_t* __restrict__ qx,
                               const uint32_t* __restrict__ qy, int64_t qn,
                               uint32_t* __restrict__ out, int64_t m,
                               FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  g1_add_mixed_thread(i, p, qx, qy, qn, out, m, F);
}

unsigned blocks_of(int64_t m) {
  return (unsigned)((m + kThreads - 1) / kThreads);
}

template <int NL>
int launch_add(const void* p, const void* q, void* out, int64_t m,
               const void* consts, void* stream) {
  k_g1_add<NL><<<blocks_of(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, m,
      consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

template <int NL>
int launch_double(const void* p, void* out, int64_t m, const void* consts,
                  void* stream) {
  k_g1_double<NL><<<blocks_of(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (uint32_t*)out, m, consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

template <int NL>
int launch_add_mixed(const void* p, const void* qx, const void* qy,
                     int64_t qn, void* out, int64_t m, const void* consts,
                     void* stream) {
  k_g1_add_mixed<NL><<<blocks_of(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)qx, (const uint32_t*)qy, qn,
      (uint32_t*)out, m, consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kzg_g1_add(const void* p, const void* q, void* out, int64_t m,
                          const void* consts, void* stream) {
  if (m <= 0) return 0;
  return KZG_BY_LIMBS(consts, launch_add, p, q, out, m, consts, stream);
}

extern "C" int kzg_g1_double(const void* p, void* out, int64_t m,
                             const void* consts, void* stream) {
  if (m <= 0) return 0;
  return KZG_BY_LIMBS(consts, launch_double, p, out, m, consts, stream);
}

extern "C" int kzg_g1_add_mixed(const void* p, const void* qx, const void* qy,
                                int64_t qn, void* out, int64_t m,
                                const void* consts, void* stream) {
  if (m <= 0) return 0;
  return KZG_BY_LIMBS(consts, launch_add_mixed, p, qx, qy, qn, out, m,
                      consts, stream);
}
