// K2-K5 and K10 replacements: NTT stages over Fr.
//
// Replaces kzg_snark_tpu/ops/ntt_stage.py:_local_pair_call (K2) and
// :_paired_pair_call (K4) with the radix-4 kernel (two stages, spans s and
// 2s, per pass), and :_local_stage_call (K3) and :_paired_stage_call (K5)
// with the radix-2 kernel (one stage at any span).  The TPU split stages by
// whether a span fitted inside one (8, 128) tile; here one kernel serves
// every span.
//
// What bounds it on the H100: each stage reads and writes the (8, n) array
// once (64 bytes an element) for half a Montgomery product an element, so
// a stage is memory-bound; the radix-4 pass halves the passes over device
// memory.  At n = 2^18 the array is 8 MB and stays in the 50 MB L2.
// Design: one thread per butterfly (radix 2) or per four-element group
// (radix 4), twiddles read from one (8, n/2) power table, out of place.
//
// K10 replaces kzg_snark_tpu/ops/pallas_fr.py:_butterfly_call
// (fused_butterfly), the stage combine of the scan-mode NTT
// (kzg_snark_tpu/ops/ntt.py:_transform_scan): the caller aligns the pairs
// with two rolls and passes a full-width twiddle row and the upper-half
// mask.  It reads 3 x 32 + 4 bytes and writes 32 per element for one
// Montgomery product: memory-bound.  One thread per element.
#include <cuda_runtime.h>
#include <string.h>

#include "ntt.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void k_ntt_radix2(const uint32_t* __restrict__ x,
                             uint32_t* __restrict__ y,
                             const uint32_t* __restrict__ tw, int64_t n,
                             int64_t s, FieldConsts F) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
  ntt_radix2_thread(t, x, y, tw, n, s, F);
}

__global__ void k_ntt_radix4(const uint32_t* __restrict__ x,
                             uint32_t* __restrict__ y,
                             const uint32_t* __restrict__ tw, int64_t n,
                             int64_t s, FieldConsts F) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 4) return;
  ntt_radix4_thread(t, x, y, tw, n, s, F);
}

__global__ void k_fr_butterfly(const uint32_t* __restrict__ xl,
                               const uint32_t* __restrict__ xu,
                               const uint32_t* __restrict__ tw,
                               const int32_t* __restrict__ mask,
                               uint32_t* __restrict__ out, int64_t n,
                               FieldConsts F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fr_butterfly_thread(i, xl, xu, tw, mask, out, n, F);
}

}  // namespace

// One launch: radix 2 (one stage of span s) or radix 4 (spans s and 2s).
extern "C" int kzg_ntt_stage(const void* x, void* y, const void* tw,
                             int64_t n, int64_t span, int radix,
                             const void* consts, void* stream) {
  int64_t work = n / radix;
  if (work <= 0) return 0;
  FieldConsts F;
  memcpy(&F, consts, sizeof(F));
  unsigned blocks = (unsigned)((work + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (radix == 4) {
    k_ntt_radix4<<<blocks, kThreads, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, n, span, F);
  } else {
    k_ntt_radix2<<<blocks, kThreads, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, n, span, F);
  }
  return (int)cudaGetLastError();
}

extern "C" int kzg_fr_butterfly(const void* xl, const void* xu, const void* tw,
                                const void* mask, void* out, int64_t n,
                                const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldConsts F;
  memcpy(&F, consts, sizeof(F));
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  k_fr_butterfly<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)xl, (const uint32_t*)xu, (const uint32_t*)tw,
      (const int32_t*)mask, (uint32_t*)out, n, F);
  return (int)cudaGetLastError();
}
