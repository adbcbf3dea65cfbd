// The bucket-route MSM on G1: msm_accumulate (the K8 redesign) and
// msm_reduce (two launches: window sums, then the Horner fold).
//
// msm_accumulate replaces kzg_snark_tpu/ops/msm_kernel.py:_pass_call.  The
// TPU kernel kept one 65-bucket table per (window, lane) in VMEM and routed
// points with select trees, because Mosaic has no scatter or sort; that
// forced c = 7 (37 windows) and, ported as it was, left one thread per
// (window, lane) cell (9472 threads at 2^16 points) walking a 58 MB bucket
// table in device memory.  Here the wrapper sorts the nonzero digits by
// bucket (plain torch, like the XLA ops around the JAX kernels), c grows
// with n (10 at 2^16: 26 windows), and each thread accumulates one chunk of
// at most T points of one bucket in registers: one thread per chunk (about
// 1.1e5 at 2^16), one (3, NL) partial written per chunk, no table and no
// atomics.  What bounds it: the mixed adds (11 Montgomery products each,
// about 1.5e3 32-bit products) are integer-multiply bound; the gathers read
// 64 bytes of a point-major table per entry.
//
// msm_reduce replaces the K6 / K7 reduction of
// kzg_snark_tpu/ops/msm_kernel.py:360-438 (lane fold, suffix ladder, Horner:
// about 300 launches of a few points each).  Launch 1, one group of blocks
// per (set, window): running sums over the window's chunk partials, cut into
// equal pieces of events (msm.cuh), each piece's Wt + off R, then a tree in
// shared memory in a fixed order.  Launch 2, one block per scalar set: the
// window totals, then the Horner fold acc = 2^c acc + S_w on one thread.
// No atomics on points, so the plain version gives the same
// representatives.  What bounds it: not operations (a few hundred thousand
// curve operations) but each thread's chain of dependent curve operations,
// a few microseconds each on one thread; the Horner fold is one chain of
// about 254 doublings.  Its curve formulas take fe_mul_compact, whose small
// loop body the instruction cache holds.
//
// Both are instantiated at NL = 8 (BN254 Fq) and NL = 12 (BLS12-381 Fq, 144
// bytes a Jacobian point: the window-sum tree's 128 points take 18 KB of
// shared memory); the entry points take the limb count from the consts
// block.
#include <cuda_runtime.h>
#include <string.h>

#include "msm.cuh"

namespace {

constexpr int kAccThreads = 128;
constexpr int kReduceThreads = 128;  // most threads of a window-sum block
constexpr int kHornerThreads = 32;   // windows a set (c >= 8: at most 32)

template <bool COMPLETE, int NL>
__global__ void __launch_bounds__(kAccThreads)
    k_msm_accumulate(const uint32_t* __restrict__ xy,
                     const int32_t* __restrict__ entries,
                     const int32_t* __restrict__ chunk_off,
                     uint32_t* __restrict__ partials, int64_t chunks,
                     FieldConsts<NL> F) {
  int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  msm_accumulate_thread<COMPLETE>(c, xy, entries, chunk_off, partials, chunks,
                                  F);
}

template <int NL>
__global__ void __launch_bounds__(kReduceThreads)
    k_msm_window_sums(const uint32_t* __restrict__ partials, int64_t chunks,
                      const int32_t* __restrict__ bco, int64_t half, int c,
                      int64_t tpw, int pieces, uint32_t* __restrict__ wparts,
                      FieldConsts<NL> F) {
  __shared__ G1J<NL> sh[kReduceThreads];
  int t = threadIdx.x;
  int64_t wi = blockIdx.x / pieces;
  int64_t g = (int64_t)(blockIdx.x % pieces) * blockDim.x + t;
  G1J<NL> V;
  msm_window_piece(V, wi, g, tpw, partials, chunks, bco, half, c, F);
  sh[t] = V;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) {
      G1J<NL> A = sh[t], B = sh[t + s];
      g1_add<PROD_COMPACT>(A, A, B, F);
      sh[t] = A;
    }
    __syncthreads();
  }
  if (t == 0) g1_store(wparts, gridDim.x, blockIdx.x, sh[0]);
}

template <int NL>
__global__ void __launch_bounds__(kHornerThreads)
    k_msm_horner(const uint32_t* __restrict__ wparts, int windows, int pieces,
                 int c, uint32_t* __restrict__ out, int64_t sets,
                 FieldConsts<NL> F) {
  __shared__ G1J<NL> S[kHornerThreads];
  int w = threadIdx.x;
  int64_t m = sets * windows * pieces;
  if (w < windows)
    msm_window_total(S[w], wparts, m, blockIdx.x * windows + w, pieces, F);
  __syncthreads();
  if (w == 0) {
    G1J<NL> acc;
    msm_horner(acc, S, windows, c, F);
    g1_store(out, sets, blockIdx.x, acc);
  }
}

template <int NL>
int launch_accumulate(const void* xy, const void* entries,
                      const void* chunk_off, int64_t chunks, void* partials,
                      int complete, const void* consts, void* stream) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  unsigned blocks = (unsigned)((chunks + kAccThreads - 1) / kAccThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (complete) {
    k_msm_accumulate<true, NL><<<blocks, kAccThreads, 0, s>>>(
        (const uint32_t*)xy, (const int32_t*)entries,
        (const int32_t*)chunk_off, (uint32_t*)partials, chunks, F);
  } else {
    k_msm_accumulate<false, NL><<<blocks, kAccThreads, 0, s>>>(
        (const uint32_t*)xy, (const int32_t*)entries,
        (const int32_t*)chunk_off, (uint32_t*)partials, chunks, F);
  }
  return (int)cudaGetLastError();
}

template <int NL>
int launch_window_sums(const void* partials, int64_t chunks, const void* bco,
                       int64_t windows, int64_t half, int c, int64_t tpw,
                       int threads, void* wparts, const void* consts,
                       void* stream) {
  int pieces = (int)(tpw / threads);
  k_msm_window_sums<NL><<<(unsigned)(windows * pieces), threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)partials, chunks, (const int32_t*)bco, half, c, tpw,
      pieces, (uint32_t*)wparts, consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

template <int NL>
int launch_horner(const void* wparts, int64_t sets, int windows, int pieces,
                  int c, void* out, const void* consts, void* stream) {
  k_msm_horner<NL><<<(unsigned)sets, kHornerThreads, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)wparts, windows, pieces, c, (uint32_t*)out, sets,
      consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kzg_msm_accumulate(const void* xy, const void* entries,
                                  const void* chunk_off, int64_t chunks,
                                  void* partials, int complete,
                                  const void* consts, void* stream) {
  if (chunks <= 0) return 0;
  return KZG_BY_LIMBS(consts, launch_accumulate, xy, entries, chunk_off,
                      chunks, partials, complete, consts, stream);
}

// windows = sets * W; tpw a power of two; the block has min(tpw, 128)
// threads and each window tpw / that many blocks.
extern "C" int kzg_msm_window_sums(const void* partials, int64_t chunks,
                                   const void* bco, int64_t windows,
                                   int64_t half, int c, int64_t tpw,
                                   void* wparts, const void* consts,
                                   void* stream) {
  if (windows <= 0) return 0;
  int threads = (int)(tpw < kReduceThreads ? tpw : kReduceThreads);
  if (threads < 1 || (threads & (threads - 1)) || tpw % threads) return -1;
  return KZG_BY_LIMBS(consts, launch_window_sums, partials, chunks, bco,
                      windows, half, c, tpw, threads, wparts, consts, stream);
}

extern "C" int kzg_msm_horner(const void* wparts, int64_t sets, int windows,
                              int pieces, int c, void* out,
                              const void* consts, void* stream) {
  if (sets <= 0) return 0;
  if (windows > kHornerThreads) return -1;
  return KZG_BY_LIMBS(consts, launch_horner, wparts, sets, windows, pieces, c,
                      out, consts, stream);
}
