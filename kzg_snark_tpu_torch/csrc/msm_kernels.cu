// The bucket-route MSM on G1: msm_accumulate (the K8 redesign) and
// msm_reduce (two launches: window sums, then the Horner fold).
//
// msm_accumulate replaces kzg_snark_tpu/ops/msm_kernel.py:_pass_call.  The
// TPU kernel kept one 65-bucket table per (window, lane) in VMEM and routed
// points with select trees, because Mosaic has no scatter or sort; that
// forced c = 7 (37 windows) and, ported as it was, left one thread per
// (window, lane) cell (9472 threads at 2^16 points) walking a 58 MB bucket
// table in device memory.  Here the wrapper sorts the nonzero digits by
// bucket (msm_schedule_kernels.cu), c grows with n (10 at 2^16: 26
// windows), and each thread accumulates the sorted entries of its work in
// registers, one (3, NL) partial written a chunk (a piece of one bucket), no
// table and no atomics.  Two routes, chosen by the wrapper from the MSM's
// shapes (ops/msm_kernel.py accumulate_run), one loop
// (msm.cuh msm_accumulate_thread):
//   chunk route: one thread a chunk of at most T = 16 entries of one bucket
//     (about 1.1e5 threads at 2^16).  What bounds its partials: a bucket of
//     m entries writes ceil(m / T), so at 128-256 entries a bucket (2^20
//     points) the reduction merges 8-16 partials a bucket back; and a
//     bucket's short last chunk idles its warp's other lanes.
//   range route: one thread a run of L consecutive sorted entries, across
//     bucket and segment bounds, storing its partial at each chunk start it
//     meets (the entry's MSM_CHUNK_START bit) and restarting there.  Every
//     thread does L entries, and the partials are about E / L + the
//     nonempty buckets.  What bounds L: the runs, E / L, have to fill the
//     card, and past a bucket's load a longer run saves few partials, so
//     the route is taken only where both leave L above T (L = 128 at the
//     2^20 cell's calls: 2.4 M partials in place of 10.4 M at 8 sets).
// What bounds both: integer products.  A mixed add is 4 squarings
// and 7 products (about 1.4e3 32-bit products at 8 words) for 64 bytes
// gathered, so the card's multipliers, not its memory, set the time.  The
// design: the carry-chained product (PROD_CHAIN, chain.cuh: 184
// instructions a product at 8 words against CIOS's 448), K9's launch
// bounds (4 blocks of 128 threads an SM at 8 words, 3 for the complete
// add; no bound at 12), an in-place mixed add that uses each input up
// early (msm.cuh g1_madd_acc), and each chunk's next gather issued inside
// the current add, so the random read overlaps the products.
//
// msm_reduce replaces the K6 / K7 reduction of
// kzg_snark_tpu/ops/msm_kernel.py:360-438 (lane fold, suffix ladder, Horner:
// about 300 launches of a few points each).  Launch 1, one group of blocks
// per (set, window): running sums over the window's chunk partials, cut into
// equal pieces of events (msm.cuh), each piece's Wt + off R by a c-bit
// double-and-add, then a tree in shared memory in a fixed order; every
// product PROD_CHAIN, and up to 255 registers a thread (232 at 8 words: 2
// blocks of 128 an SM).  What bounds it: the events (a complete add each)
// and each thread's fixed tail, its c-bit double-and-add and its share of
// the tree.  On the chunk route the threads a window follow the events,
// about 8 a thread.  On the range route, with about a quarter of the
// events, the launch takes at most about one wave (ops/msm_kernel.py
// window_threads): more threads only add tails (8 sets at 2^20: 2.8 ms at
// 128 threads a window, 4.3 at 1024).  Launch
// 2, one block per scalar set: the window totals as a halving tree over
// each window's block partials (one add a thread a level), then the Horner
// fold acc = 2^c acc + S_w on the 32 lanes of one warp.  What bounds it:
// its depth, c (W - 1) doublings and W adds one after another (about 250
// doublings at 2^16), which one thread ran product by product.  Here each
// curve operation's independent products run on separate lanes, a level at
// a time, the results exchanged by __shfl_sync (msm.cuh): a doubling costs
// the latency of 2 squarings and a product, an add that of a squaring and
// 4 products.  No atomics on points, so the plain version gives the same
// representatives.
//
// Both are instantiated at NL = 8 (BN254 Fq) and NL = 12 (BLS12-381 Fq, 144
// bytes a Jacobian point: the window-sum tree's 128 points take 18 KB of
// shared memory, the fold's up to 256 partials 36 KB); the entry points
// take the limb count from the consts block.
#include <cuda_runtime.h>
#include <string.h>

#include "msm.cuh"

namespace {

constexpr int kAccThreads = 128;
constexpr int kReduceThreads = 128;  // most threads of a window-sum block
constexpr int kFoldThreads = 128;    // threads of a fold block
constexpr int kFoldWindows = 32;     // windows a set (c >= 8: at most 32)
constexpr int kFoldPoints = 256;     // block partials a set (W x pieces)

// Blocks an SM that the accumulate's registers must allow: K9's bound, 4
// at 8 words (128 registers); the complete add's case split costs a few
// registers more, and at 128 it spilled, so it asks for 3 (170).  At 12
// words no bound.
constexpr int acc_min_blocks(int NL, bool complete) {
  return NL == 8 ? (complete ? 3 : 4) : 1;
}

// Thread r < threads: run r of run_chunks, or chunk r where it is null.
template <bool COMPLETE, int NL>
__global__ void __launch_bounds__(kAccThreads, acc_min_blocks(NL, COMPLETE))
    k_msm_accumulate(const uint32_t* __restrict__ xy,
                     const int32_t* __restrict__ entries,
                     const int32_t* __restrict__ chunk_off,
                     const int32_t* __restrict__ run_chunks, int64_t threads,
                     uint32_t* __restrict__ partials, int64_t chunks,
                     FieldConsts<NL> F) {
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= threads) return;
  msm_accumulate_thread<COMPLETE>(r, xy, entries, chunk_off, run_chunks,
                                  partials, chunks, F);
}

template <int NL>
__global__ void __launch_bounds__(kReduceThreads, 1)
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
    if (t < s) msm_block_tree_step(sh, t, s, F);
    __syncthreads();
  }
  if (t == 0) g1_store(wparts, gridDim.x, blockIdx.x, sh[0]);
}

// Block j folds set j: its W x pieces block partials into shared memory,
// the window totals' halving tree, then the Horner fold on warp 0.
template <int NL>
__global__ void __launch_bounds__(kFoldThreads, 1)
    k_msm_horner(const uint32_t* __restrict__ wparts, int windows, int pieces,
                 int c, uint32_t* __restrict__ out, int64_t sets,
                 FieldConsts<NL> F) {
  __shared__ G1J<NL> S[kFoldPoints];
  const int t = threadIdx.x, per = windows * pieces;
  const int64_t m = sets * per;
  for (int i = t; i < per; i += blockDim.x)
    g1_load(S[i], wparts, m, (int64_t)blockIdx.x * per + i);
  __syncthreads();
  for (int k = pieces; k > 1; k = (k + 1) / 2) {
    for (int i = t; i < windows * (k / 2); i += blockDim.x)
      msm_total_pair(S, pieces, k, i, F);
    __syncthreads();
  }
  if (t < 32) {
    G1J<NL> acc;
    msm_horner(acc, S, windows, pieces, c, t, F);
    if (t == 0) g1_store(out, sets, blockIdx.x, acc);
  }
}

template <int NL>
int acc_blocks_per_sm(int complete) {
  int blocks = 0;
  cudaError_t rc =
      complete ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, k_msm_accumulate<true, NL>, kAccThreads, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, k_msm_accumulate<false, NL>, kAccThreads, 0);
  return rc == cudaSuccess ? blocks : -(int)rc;
}

template <int NL>
int launch_accumulate(const void* xy, const void* entries,
                      const void* chunk_off, const void* run_chunks,
                      int64_t threads, int64_t chunks, void* partials,
                      int complete, const void* consts, void* stream) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  unsigned blocks = (unsigned)((threads + kAccThreads - 1) / kAccThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (complete) {
    k_msm_accumulate<true, NL><<<blocks, kAccThreads, 0, s>>>(
        (const uint32_t*)xy, (const int32_t*)entries,
        (const int32_t*)chunk_off, (const int32_t*)run_chunks, threads,
        (uint32_t*)partials, chunks, F);
  } else {
    k_msm_accumulate<false, NL><<<blocks, kAccThreads, 0, s>>>(
        (const uint32_t*)xy, (const int32_t*)entries,
        (const int32_t*)chunk_off, (const int32_t*)run_chunks, threads,
        (uint32_t*)partials, chunks, F);
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
  k_msm_horner<NL><<<(unsigned)sets, kFoldThreads, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)wparts, windows, pieces, c, (uint32_t*)out, sets,
      consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

}  // namespace

// Resident blocks an SM of the accumulate (complete or incomplete add) at
// `limbs` words, blocks of kzg_msm_acc_threads(), from the CUDA occupancy
// calculator; negative on error.
extern "C" int kzg_msm_acc_blocks_per_sm(int complete, int limbs) {
  return limbs == 8    ? acc_blocks_per_sm<8>(complete)
         : limbs == 12 ? acc_blocks_per_sm<12>(complete)
                       : KZG_BAD_LIMBS;
}

extern "C" int kzg_msm_acc_threads() { return kAccThreads; }

// run_chunks null: one thread a chunk (threads = chunks); else `threads`
// runs, thread r walking chunks [run_chunks[r], run_chunks[r + 1]).
extern "C" int kzg_msm_accumulate(const void* xy, const void* entries,
                                  const void* chunk_off,
                                  const void* run_chunks, int64_t threads,
                                  int64_t chunks, void* partials,
                                  int complete, const void* consts,
                                  void* stream) {
  if (chunks <= 0 || threads <= 0) return 0;
  return KZG_BY_LIMBS(consts, launch_accumulate, xy, entries, chunk_off,
                      run_chunks, threads, chunks, partials, complete, consts,
                      stream);
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

// windows <= 32 and windows * pieces <= 256 (the window-sum launch gives
// at most 8 pieces a window).
extern "C" int kzg_msm_horner(const void* wparts, int64_t sets, int windows,
                              int pieces, int c, void* out,
                              const void* consts, void* stream) {
  if (sets <= 0) return 0;
  if (windows < 1 || windows > kFoldWindows || pieces < 1 ||
      windows * pieces > kFoldPoints)
    return -1;
  return KZG_BY_LIMBS(consts, launch_horner, wparts, sets, windows, pieces, c,
                      out, consts, stream);
}
