// K7 (and K6's row adds) as the SRS build uses them: the fixed-base table
// T[j, v] = v 2^(c j) G in one launch.
//
// Replaces kzg_snark_tpu/ops/pallas_fr.py:_double_call (fused_curve_double)
// and :_add_call (fused_curve_add) as kzg_snark_tpu/ops/srs.py's table
// build uses them: there, and in the port until now, a host loop of
// c (W - 1) one-point doublings (248 at c = 8, W = 32), then c - 1 levels
// of a W-point doubling and a W count-point add, each a launch: about 262
// launches of 20-47 us of host time each for a few microseconds of work.
//
// What bounds it on the H100: not bytes (one point in, W 2^c out, 12 NL
// bytes each) nor products (about 130k Montgomery products at c = 8, W =
// 32: 1 us on the card at 8 words), but the window bases' chain: c (W - 1)
// dependent doublings on one thread.  Instantiated at NL = 8 (BN254) and
// NL = 12 (BLS12-381: 144-byte points, 12 x 12-word products).
// Design: one block.  Thread 0 runs the chain in registers and stores each
// base; then the c - 1 levels run across the block's threads with
// __syncthreads between their doubling and add steps (the steps in shared
// memory, the table in device memory, written and read by this block
// only).  The formulas and their order are srs.cuh's, so the table equals
// the plain version word for word.
#include <cuda_runtime.h>
#include <string.h>

#include "srs.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxWindows = 512;   // the steps' 12 NL W bytes of shared memory

template <int NL>
__global__ void __launch_bounds__(kThreads)
    k_g1_fixed_base_table(const uint32_t* __restrict__ base,
                          uint32_t* __restrict__ table, int windows, int c,
                          FieldConsts<NL> F) {
  extern __shared__ uint32_t steps[];  // (3, NL, windows)
  if (threadIdx.x == 0) fbt_chain(base, table, windows, c, F);
  for (int j = threadIdx.x; j < windows; j += blockDim.x)
    fbt_identity_thread(j, table, windows, c, F);
  __syncthreads();
  for (int count = 2; count < (1 << c); count *= 2) {
    for (int j = threadIdx.x; j < windows; j += blockDim.x)
      fbt_step_thread(j, count, table, steps, windows, c, F);
    __syncthreads();
    for (int64_t idx = threadIdx.x; idx < (int64_t)windows * count;
         idx += blockDim.x)
      fbt_add_thread(idx, count, table, steps, windows, c, F);
    __syncthreads();
  }
}

template <int NL>
int launch_table(const void* base, void* table, int windows, int c,
                 const void* consts, void* stream) {
  size_t smem = (size_t)3 * NL * sizeof(uint32_t) * windows;
  k_g1_fixed_base_table<NL><<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)base, (uint32_t*)table, windows, c,
      consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

}  // namespace

// base (3, NL, 1) -> table (3, NL, windows 2^c).
extern "C" int kzg_g1_fixed_base_table(const void* base, void* table,
                                       int windows, int c, const void* consts,
                                       void* stream) {
  if (windows < 1 || windows > kMaxWindows || c < 1 || c > 16)
    return (int)cudaErrorInvalidValue;
  return KZG_BY_LIMBS(consts, launch_table, base, table, windows, c, consts,
                      stream);
}
