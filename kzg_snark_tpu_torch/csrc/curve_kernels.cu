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
// What bounds it on the H100: a complete add is 11 Montgomery products and
// 5 squarings (add-2007-bl) and 20 add/subs on 12 NL-byte points (96 bytes
// at BN254, 144 at BLS12-381; three points moved): compute-bound at large
// batches, launch-bound in the Horner fold, where the batch is the number of
// scalars.  The mixed add is 7 products and 4 squarings and reads one point
// of P (q broadcasts) and writes one.  Design: one thread per point, the
// formulas of curve.cuh in registers, limb-major (3, NL, m) words for
// coalesced loads; K9's q has a column period (i % qn), so its callers'
// broadcast point is read from a small table, never expanded.
//
// K6 and K9 run the product policy PROD_CHAIN (csrc/chain.cuh): each 32 x
// 32-bit product is one mad.lo and one mad.hi with the carries on the carry
// flag, and a squaring computes each cross product once.  Their thread
// bodies load each coordinate where it is first used, and at 8 words their
// launch bounds ask for 4 blocks of 128 threads an SM (at most 128
// registers): 528 resident blocks, so 2^16 points (512 blocks) run in one
// wave.  At 12 words no bound is set: the formulas need about twice the
// registers, and the build prints what they take.  K7 keeps PROD_CIOS.
// Instantiated at NL = 8 (BN254 Fq) and NL = 12 (BLS12-381 Fq); the entry
// points take the limb count from the consts block.
#include <cuda_runtime.h>
#include <string.h>

#include "curve.cuh"

namespace {

constexpr int kThreads = 128;

// Blocks an SM that K6 and K9 ask their registers to allow.
constexpr int chain_min_blocks(int NL) { return NL == 8 ? 4 : 1; }

template <int NL>
__global__ void __launch_bounds__(kThreads, chain_min_blocks(NL))
    k_g1_add(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
             uint32_t* __restrict__ out, int64_t m, FieldConsts<NL> F) {
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
__global__ void __launch_bounds__(kThreads, chain_min_blocks(NL))
    k_g1_add_mixed(const uint32_t* __restrict__ p,
                   const uint32_t* __restrict__ qx,
                   const uint32_t* __restrict__ qy, int64_t qn,
                   uint32_t* __restrict__ out, int64_t m, FieldConsts<NL> F) {
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

template <int NL>
int blocks_per_sm(int kernel) {
  int blocks = 0;
  cudaError_t rc =
      kernel == 0   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, k_g1_add<NL>, kThreads, 0)
      : kernel == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, k_g1_add_mixed<NL>, kThreads, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, k_g1_double<NL>, kThreads, 0);
  return rc == cudaSuccess ? blocks : -(int)rc;
}

}  // namespace

// Resident blocks of kThreads an SM of kernel 0 (K6), 1 (K9) or 2 (K7) at
// `limbs` words, from the CUDA occupancy calculator; negative on error.
extern "C" int kzg_g1_blocks_per_sm(int kernel, int limbs) {
  return limbs == 8    ? blocks_per_sm<8>(kernel)
         : limbs == 12 ? blocks_per_sm<12>(kernel)
                       : KZG_BAD_LIMBS;
}

extern "C" int kzg_g1_threads() { return kThreads; }

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
