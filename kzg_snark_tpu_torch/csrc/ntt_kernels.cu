// K2-K5 and K10 replacements: NTT passes and the scan-mode combine over Fr.
//
// ntt_pass replaces kzg_snark_tpu/ops/ntt_stage.py:_local_pair_call (K2),
// :_paired_pair_call (K4), :_local_stage_call (K3) and :_paired_stage_call
// (K5).  The TPU split stages by whether a span fitted inside one (8, 128)
// tile, a launch for each stage or pair of stages; here one kernel runs as
// many stages as a shared-memory tile holds, so a transform of n = 2^k is
// ceil(k / t) launches, t = ntt_tile_bits(k) (ntt.cuh): one up to 2^10,
// two from 2^11 to 2^20.
//
// What bounds it on the H100: a DIT transform does k n / 2 Montgomery
// products (136 32-bit products each) and must read and write the (8, n)
// array once: at 2^18 that is 0.019 ms of products against 0.006 ms of
// bytes, so fused stages are bound by operations; below about 2^17 the
// card has too few independent butterflies a stage to hide a product's
// latency.  Design (ntt.cuh for the indexing): a block copies its tile (a
// group of elements that the pass's stages combine only among themselves)
// limb row by limb row in runs of consecutive words, and every stage's
// twiddles from the (8, n/2) table, into shared memory by cp.async, all in
// flight at once; then it runs the stages in pairs, each thread four
// elements through two stages in registers (a radix-2 stage last when the
// pass has an odd number), with one __syncthreads a pair; it stores the
// tile at the end.  Every block reads all of its elements before it writes
// any and blocks own disjoint elements, so a pass may run in place.  The
// butterflies run the carry-chained product (chain.cuh, PROD_CHAIN): 184
// SASS instructions a product at 8 words against fe_mul's 448, 104
// registers, no spill.  Shared memory: 64 bytes an element (the tile and
// its twiddles), 64 KB a block at 10-bit tiles.  The tile is chosen by n
// where tiles were measured: the fastest of 2^8..2^11 at 2^14..2^18
// (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's ntt phase, PERF.md):
// 8 bits at 2^14 and 2^15 (2^14: 0.0294 ms), 9 at 2^16 (0.0346 ms: 128
// blocks, where 8 bits leaves the second pass one-word runs, 0.0445), 10
// at 2^17 and 2^18 (2^18: 0.0942 ms, from 0.1199 on fe_mul); every
// two-pass split of 2^14..2^18, each pass with its own tile, was within
// 3 % of these.  Other sizes keep the fixed 10-bit tile of before.  The transforms are over Fr, 8 words
// on both curves (BN254, BLS12-381), so both kernels are instantiated at
// NL = 8 alone; an entry point given another limb count returns
// KZG_BAD_LIMBS.
//
// K10 replaces kzg_snark_tpu/ops/pallas_fr.py:_butterfly_call
// (fused_butterfly), the stage combine of the scan-mode NTT
// (kzg_snark_tpu/ops/ntt.py:_transform_scan): the caller aligns the pairs
// with two rolls and passes a full-width twiddle row and the upper-half
// mask.  It reads 3 x 32 + 4 bytes and writes 32 per element for one
// Montgomery product: memory-bound.  One thread per element.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <string.h>

#include "ntt.cuh"

namespace {

constexpr int kThreads = 256;

// One block a tile; x and y may be the same array.
template <int NL>
__global__ void __launch_bounds__(NTT_THREADS)
    k_ntt_pass(const uint32_t* x, uint32_t* y, const uint32_t* __restrict__ tw,
               NttPass P, FieldConsts<NL> F) {
  extern __shared__ uint32_t sm[];
  const int E = 1 << P.ebits;
  uint32_t* xs = sm;           // (NL, E): the tile
  uint32_t* ws = sm + NL * E;  // (NL, E): every stage's twiddles
  const int64_t b = blockIdx.x;
  // Tile and twiddles by asynchronous copies (cp.async), all in flight at
  // once: a loop of plain loads would wait on each load in turn.
  for (int idx = threadIdx.x; idx < NL * E; idx += blockDim.x)
    __pipeline_memcpy_async(&xs[idx], &x[ntt_pass_word(P, b, idx)], 4);
  for (int s = P.s0; s < P.s0 + P.g; s++)
    for (int idx = threadIdx.x; idx < (NL << (P.lcb + s - P.s0));
         idx += blockDim.x) {
      int dst;
      int64_t src = ntt_pass_tw_word(P, b, s, idx, &dst);
      __pipeline_memcpy_async(&ws[dst], &tw[src], 4);
    }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  int s = P.s0;
  for (; s + 1 < P.s0 + P.g; s += 2) {
    for (int j = threadIdx.x; j < E / 4; j += blockDim.x)
      ntt_pass_radix4(P, s, xs, ws, j, F);
    __syncthreads();
  }
  if (s < P.s0 + P.g) {
    for (int j = threadIdx.x; j < E / 2; j += blockDim.x)
      ntt_pass_radix2(P, s, xs, ws, j, F);
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < NL * E; idx += blockDim.x)
    y[ntt_pass_word(P, b, idx)] = xs[idx];
}

template <int NL>
__global__ void k_fr_butterfly(const uint32_t* __restrict__ xl,
                               const uint32_t* __restrict__ xu,
                               const uint32_t* __restrict__ tw,
                               const int32_t* __restrict__ mask,
                               uint32_t* __restrict__ out, int64_t n,
                               FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fr_butterfly_thread(i, xl, xu, tw, mask, out, n, F);
}

// Shared memory of a pass: the tile and its twiddles, 2 x 4 NL bytes an
// element.
template <int NL>
size_t pass_smem(int ebits) {
  return (size_t)(8 * NL) << ebits;
}

template <int NL>
int launch_pass(const void* x, void* y, const void* tw, int64_t n, int s0,
                int g, int tile_bits, const void* consts, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      k_ntt_pass<NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pass_smem<NL>(NTT_MAX_TILE_BITS));
  if (attr != cudaSuccess) return (int)attr;
  NttPass P = ntt_pass_geometry(n, s0, g, tile_bits);
  int groups = P.ebits >= 2 ? 1 << (P.ebits - 2) : 1;
  int threads = groups < NTT_THREADS ? groups : NTT_THREADS;
  k_ntt_pass<NL><<<(unsigned)P.blocks, threads, pass_smem<NL>(P.ebits),
                   (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, P,
      consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

template <int NL>
int launch_butterfly(const void* xl, const void* xu, const void* tw,
                     const void* mask, void* out, int64_t n,
                     const void* consts, void* stream) {
  unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  k_fr_butterfly<NL><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)xl, (const uint32_t*)xu, (const uint32_t*)tw,
      (const int32_t*)mask, (uint32_t*)out, n, consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's tile (log2) for a transform of 2^log_n (ntt_tile_bits): the
// launches of that transform are ceil(log_n / tile).
extern "C" int kzg_ntt_tile(int log_n) { return ntt_tile_bits(log_n); }

// One pass: stages s0 .. s0 + g - 1 of the transform of x (NL, n), n = 2^k,
// into y (which may be x), with tiles of 2^tile_bits elements.
extern "C" int kzg_ntt_pass(const void* x, void* y, const void* tw, int64_t n,
                            int s0, int g, int tile_bits, const void* consts,
                            void* stream) {
  if (n < 2 || (n & (n - 1)) || tile_bits < 1 ||
      tile_bits > NTT_MAX_TILE_BITS || g < 1 || g > tile_bits || s0 < 0 ||
      ((int64_t)1 << (s0 + g)) > n)
    return (int)cudaErrorInvalidValue;
  if (consts_limbs(consts) != 8) return KZG_BAD_LIMBS;
  return launch_pass<8>(x, y, tw, n, s0, g, tile_bits, consts, stream);
}

extern "C" int kzg_fr_butterfly(const void* xl, const void* xu, const void* tw,
                                const void* mask, void* out, int64_t n,
                                const void* consts, void* stream) {
  if (n <= 0) return 0;
  if (consts_limbs(consts) != 8) return KZG_BAD_LIMBS;
  return launch_butterfly<8>(xl, xu, tw, mask, out, n, consts, stream);
}
