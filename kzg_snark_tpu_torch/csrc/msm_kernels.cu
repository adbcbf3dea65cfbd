// K8 replacement: the Pippenger bucket pass on G1.
//
// Replaces kzg_snark_tpu/ops/msm_kernel.py:_pass_call.  The TPU kernel kept
// one 65-bucket table per (window, lane) in VMEM and routed points to
// buckets with select trees, 8 windows per pass, because Mosaic has no
// scatter and VMEM holds 16 MB.  Neither limit exists here: every window
// runs in one launch and a thread indexes its bucket directly.
//
// What bounds it on the H100: each point-window pair costs one mixed add
// (7M + 4S, ~11 Montgomery products) plus a 96-byte read and write of the
// bucket, so the pass is integer-multiply bound; with one thread per
// (window, lane) cell, 37 windows x 256 lanes = 9472 threads (about 72 per
// SM) leave latency poorly hidden.  Design: no atomics and no sorting; each
// thread walks its lane's points in order, and its private buckets live in
// a (64, 3, 8, cells) table laid out so that a warp's accesses coalesce.
// Sorting points by bucket and wider windows are for later work.
#include <cuda_runtime.h>
#include <string.h>

#include "msm.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void k_msm_bucket(const uint32_t* __restrict__ px,
                             const uint32_t* __restrict__ py, int64_t npts,
                             const int32_t* __restrict__ digits,
                             uint32_t* __restrict__ table, int64_t cells,
                             int64_t lanes, int nb, int complete,
                             FieldConsts F) {
  int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  msm_bucket_thread(cell, px, py, npts, digits, table, cells, lanes, nb,
                    complete, F);
}

}  // namespace

extern "C" int kzg_msm_bucket(const void* px, const void* py, int64_t npts,
                              const void* digits, void* table,
                              int64_t windows, int64_t lanes, int nb,
                              int complete, const void* consts, void* stream) {
  int64_t cells = windows * lanes;
  if (cells <= 0) return 0;
  FieldConsts F;
  memcpy(&F, consts, sizeof(F));
  int64_t blocks = (cells + kThreads - 1) / kThreads;
  k_msm_bucket<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, npts,
      (const int32_t*)digits, (uint32_t*)table, cells, lanes, nb, complete,
      F);
  return (int)cudaGetLastError();
}
