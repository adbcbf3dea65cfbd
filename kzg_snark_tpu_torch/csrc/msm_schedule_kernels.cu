// The bucket MSM's schedule (FusedMsm.schedule, ops/msm_kernel.py steps
// 1-2): from k scalar sets of n points to the sorted entries, the chunks
// that msm_accumulate reads and the buckets' chunk offsets that msm_reduce
// reads.  Three entry points, one a step:
//
//   kzg_msm_digits          one thread a (set, point) scalar: its 8 limbs
//                           read once, coalesced across the points ((k, 8,
//                           n) lays them out so), the signed-digit carry
//                           chain run serially in registers over the W
//                           windows (signed_digits' recoding), and for each
//                           window the int32 sort key and the payload
//                           i << 1 | sign written in (set, window, i)
//                           order, a zero digit with key -1.  The block's
//                           tile histograms of the first sort pass come
//                           out of the same pass (shared memory).  A tile
//                           is 512 to 4096 entries by n (SchedulePlan.tile),
//                           so a small n still spreads over the SMs.
//   kzg_msm_sort_pass       one stable LSD counting pass over the keys
//                           inside each (set, window) segment: per-tile
//                           histograms, a scan a segment, a stable scatter.
//                           The first pass drops the zero digits, so its
//                           output is compact: segment s at [base[s],
//                           base[s + 1]), base the nonzero digits' scan.
//   kzg_msm_bucket_offsets  the buckets' runs in the sorted keys (no
//                           atomics: a run's first and last position write
//                           its bounds), each bucket's chunks (msm_chunks.cuh:
//                           ceil(count / CHUNK) on the chunk route, its
//                           start and the accumulate runs' starts inside it
//                           on the range route) scanned a segment, then
//                           across segments, one thread a bucket writing
//                           its own chunk offsets and, on the range route,
//                           the first chunk of each run that starts in it
//                           (the run pass, a thread an entry, sets the
//                           chunk-start bit of each chunk's first
//                           payload);
//                           the chunk total C, the busiest window's chunks
//                           and the entry count E in one 3-word block, the
//                           host's one read a call.
//
// Replaces no Pallas kernel: the JAX package's schedule was XLA ops around
// its kernels (kzg_snark_tpu/ops/msm_kernel.py signed_digits and the
// digit routing of _pass_call), and the port ran it as about 35 torch ops a
// call (signed_digits, bucket_schedule: int64 temporaries over every
// digit, a radix sort, a bincount and gathers, 61-63 bytes a digit at the
// peak) and four host waits (the nonzero count, bincount's min and max, the
// totals).  What bounds it: bytes.  It does no field arithmetic; each step
// reads and writes each digit's key and payload a few times, so the card's
// 3.35 TB/s sets the time.  The design moves each digit's 8 bytes as
// little as the sort allows: the digits pass reads the scalars once and
// writes the keys and payloads once, each counting pass reads and writes
// them once more (two passes of at most 9 bits: one at c <= 10, two above,
// SchedulePlan.passes), the run pass reads the sorted keys once, and no
// pass holds an int64 or any temporary of the digits' size but the two
// key and payload buffers it reads and writes.  Stability: a tile's
// entries go in order warp by warp, each warp walking its own contiguous
// stretch 32 at a time; a lane's rank among its warp's earlier entries of
// its bin comes from its peers of the round (a ballot a bit of the bin)
// and the warp's running count, so within a bucket the entries stay in
// ascending point index, as torch.sort(stable=True) left them; the tile
// is sorted so in shared memory and written out a bin's run at a time, so
// the stores coalesce.  Counts that need no order are shared-memory
// atomic adds.  Every count and offset is exact integer arithmetic in a
// fixed order: two runs give the same words.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's schedule
// phase): 8 sets at 2^20, c = 14: the digits 0.72 ms, the two passes
// 3.47, the offsets 0.75, against their bytes' bound of 0.46 / 1.51 /
// 0.20 (the plain torch schedule 49.1 ms; torch.sort of the same keys
// with its payload gather 8.74); 9 sets at 4096, c = 10: 0.026 / 0.033 /
// 0.017.
// Tried and dropped: ranks from __match_any_sync with each entry stored
// straight to its place (two passes 10.6 ms at 2^20), and a fixed tile of
// 4096 (the blob cell's digits on 9 blocks, 0.165 ms).
#include <cuda_runtime.h>
#include <stdint.h>

#include "msm_chunks.cuh"

namespace {

constexpr int kThreads = 256;               // a tile block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 512;               // 9 bits a pass
constexpr int kScanThreads = 1024;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes of the warp whose bin equals this lane's, bins below 2^bits
// and the sentinel 2^bits: one ballot a bit.
__device__ __forceinline__ unsigned peers_of(int bin, int bits) {
  unsigned peers = 0xffffffffu;
  for (int j = 0; j <= bits; j++) {
    const bool one = (bin >> j) & 1;
    const unsigned m = __ballot_sync(0xffffffffu, one);
    peers &= one ? m : ~m;
  }
  return peers;
}

// Exclusive scan of value(0 .. len - 1) into out, in rounds of one block;
// every thread returns the total.  value(i) may read out[i] (in place).
template <class F>
__device__ int64_t block_scan(int32_t* out, int64_t len, F value) {
  __shared__ int32_t sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int64_t carry = 0;
  for (int64_t r = 0; r < len; r += blockDim.x) {
    const int64_t i = r + threadIdx.x;
    const int32_t v = i < len ? value(i) : 0;
    int32_t x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int32_t s = lane < warps ? sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      sums[lane] = s;
    }
    __syncthreads();
    if (i < len)
      out[i] = (int32_t)(carry + (warp ? sums[warp - 1] : 0) + x - v);
    carry += sums[warps - 1];
    __syncthreads();
  }
  return carry;
}

// Block b: tile b % tiles of set b / tiles, `tile` points, for all W
// windows; dynamic shared memory holds the W x 2^bits0 tile histograms.
__global__ void __launch_bounds__(kThreads)
    k_msm_digits(const uint32_t* __restrict__ scalars, int64_t n, int W, int c,
                 int bits0, int tile, int64_t tiles,
                 int32_t* __restrict__ keys, int32_t* __restrict__ pay,
                 int32_t* __restrict__ hist) {
  extern __shared__ int32_t h[];
  const int B = 1 << bits0;
  for (int q = threadIdx.x; q < W * B; q += kThreads) h[q] = 0;
  __syncthreads();
  const int64_t set = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int half = 1 << (c - 1), full = 1 << c;
  const uint64_t mask = (uint64_t)full - 1;
  for (int r = 0; r < tile; r += kThreads) {
    const int64_t i = t * tile + r + threadIdx.x;
    if (i >= n) break;
    const uint32_t* sc = scalars + set * 8 * n + i;
    uint64_t buf = 0;
    int have = 0, next = 0, carry = 0;
    for (int w = 0; w < W; w++) {
      if (have < c) {  // c <= 16: one limb tops the buffer up
        buf |= (uint64_t)(next < 8 ? sc[(int64_t)next * n] : 0) << have;
        have += 32;
        next++;
      }
      const int v = (int)(buf & mask) + carry;
      buf >>= c;
      have -= c;
      const int flip = v >= half && w < W - 1;
      const int mag = flip ? full - v : v;
      carry = flip;
      const int64_t seg = set * W + w;
      keys[seg * n + i] = mag ? (int32_t)(seg * half + mag - 1) : -1;
      pay[seg * n + i] = (int32_t)(i << 1) | flip;
      if (mag) atomicAdd(&h[w * B + ((mag - 1) & (B - 1))], 1);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < W * B; q += kThreads)
    hist[((set * W + q / B) * B + q % B) * tiles + t] = h[q];
}

// The input range of segment s: the first pass reads the digits' layout
// [s n, s n + n), a later pass the compact one [base[s], base[s + 1]).
__device__ __forceinline__ void segment_range(int64_t s, int64_t n,
                                              const int32_t* base, int compact,
                                              int64_t& lo, int64_t& hi) {
  lo = compact ? base[s] : s * n;
  hi = compact ? base[s + 1] : lo + n;
}

// A later pass's tile histograms: block b, tile b % tiles of segment b /
// tiles.
__global__ void __launch_bounds__(kThreads)
    k_msm_sort_hist(const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ base, int shift, int bits,
                    int tile, int64_t tiles, int32_t* __restrict__ hist) {
  __shared__ int32_t h[kMaxBins];
  const int B = 1 << bits;
  for (int q = threadIdx.x; q < B; q += kThreads) h[q] = 0;
  __syncthreads();
  const int64_t s = blockIdx.x / tiles, t = blockIdx.x % tiles;
  int64_t lo, hi;
  segment_range(s, 0, base, 1, lo, hi);
  lo += t * tile;
  hi = hi < lo + tile ? hi : lo + tile;
  for (int64_t p = lo + threadIdx.x; p < hi; p += kThreads)
    atomicAdd(&h[(keys[p] >> shift) & (B - 1)], 1);
  __syncthreads();
  for (int q = threadIdx.x; q < B; q += kThreads)
    hist[(s * B + q) * tiles + t] = h[q];
}

// Block s: segment s's B x tiles histograms, in place, to their exclusive
// scan in (bin, tile) order; its total to tot[s] when tot is given.
__global__ void __launch_bounds__(kScanThreads)
    k_msm_sort_scan(int32_t* __restrict__ hist, int64_t len,
                    int32_t* __restrict__ tot) {
  int32_t* a = hist + blockIdx.x * len;
  const int64_t total = block_scan(a, len, [&](int64_t i) { return a[i]; });
  if (tot && threadIdx.x == 0) tot[blockIdx.x] = (int32_t)total;
}

// One block: base[0 .. S] the exclusive scan of tot[0 .. S - 1] and its
// total; *most the largest tot when given.
__global__ void __launch_bounds__(kScanThreads)
    k_msm_segment_scan(const int32_t* __restrict__ tot, int64_t S,
                       int32_t* __restrict__ base,
                       int32_t* __restrict__ most) {
  __shared__ int32_t top;
  if (threadIdx.x == 0) top = 0;
  const int64_t total =
      block_scan(base, S, [&](int64_t i) { return tot[i]; });
  if (most) {
    for (int64_t i = threadIdx.x; i < S; i += blockDim.x)
      atomicMax(&top, tot[i]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    base[S] = (int32_t)total;
    if (most) *most = top;
  }
}

// The stable scatter of one pass: block b, tile b % tiles of segment b /
// tiles.  Warp w takes the tile's entries w span .. (w + 1) span - 1, span
// = tile / kWarps, 32 at a time in order, so an entry's place in the tile
// is (warp, round, lane).  (1) Each warp counts its bins.  (2) Each bin's
// start in the tile (a scan over the bins), each warp's start in it, and
// the bin's shift from the tile to the output: base[s] + the tile's offset
// from the scan, less its start in the tile.  (3) The entries again, each
// to shared memory at its warp's running start in its bin plus its rank
// among its peers of the round, so the tile is sorted there, stable.  (4)
// The sorted tile out in order: a bin's entries go to consecutive
// addresses, so the stores coalesce.  Keys below 0 (zero digits, first
// pass only) are dropped.  Dynamic shared memory: 2 tile + (kWarps + 1)
// 2^bits words.
__global__ void __launch_bounds__(kThreads)
    k_msm_sort_scatter(const int32_t* __restrict__ keys,
                       const int32_t* __restrict__ pay,
                       const int32_t* __restrict__ base, int compact,
                       int64_t n, int shift, int bits, int tile, int64_t tiles,
                       const int32_t* __restrict__ offs,
                       int32_t* __restrict__ keys_out,
                       int32_t* __restrict__ pay_out) {
  extern __shared__ int32_t sm[];
  const int B = 1 << bits, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int span = tile / kWarps;
  int32_t* sk = sm;
  int32_t* sv = sk + tile;
  int32_t* cnt = sv + tile;
  int32_t* shift_out = cnt + kWarps * B;
  int32_t* mine = cnt + warp * B;
  const int64_t s = blockIdx.x / tiles, t = blockIdx.x % tiles;
  int64_t lo, hi;
  segment_range(s, n, base, compact, lo, hi);
  const int64_t first = lo + t * tile + (int64_t)warp * span + lane;
  for (int q = lane; q < B; q += 32) mine[q] = 0;
  __syncwarp();
  for (int r = 0; r < span; r += 32) {
    const int64_t p = first + r;
    const int32_t key = p < hi ? keys[p] : -1;
    if (key >= 0) atomicAdd(&mine[(key >> shift) & (B - 1)], 1);
  }
  __syncthreads();
  const int64_t count = block_scan(shift_out, B, [&](int64_t q) {
    int32_t total = 0;
    for (int w = 0; w < kWarps; w++) total += cnt[w * B + q];
    return total;
  });
  for (int q = threadIdx.x; q < B; q += kThreads) {
    int32_t run = shift_out[q];
    shift_out[q] = base[s] + offs[(s * B + q) * tiles + t] - run;
    for (int w = 0; w < kWarps; w++) {
      const int32_t k = cnt[w * B + q];
      cnt[w * B + q] = run;
      run += k;
    }
  }
  __syncthreads();
  for (int r = 0; r < span; r += 32) {
    const int64_t p = first + r;
    const int32_t key = p < hi ? keys[p] : -1;
    const int bin = key >= 0 ? (key >> shift) & (B - 1) : B;
    const unsigned peers = peers_of(bin, bits);
    const int32_t at = bin < B ? mine[bin] : 0;
    __syncwarp();
    if (bin < B) {
      if (lane == __ffs(peers) - 1) mine[bin] = at + __popc(peers);
      const int32_t q = at + __popc(peers & lanemask_lt());
      sk[q] = key;
      sv[q] = pay[p];
    }
    __syncwarp();
  }
  __syncthreads();
  for (int q = threadIdx.x; q < count; q += kThreads) {
    const int32_t key = sk[q];
    const int64_t d = q + shift_out[(key >> shift) & (B - 1)];
    keys_out[d] = key;
    pay_out[d] = sv[q];
  }
}

// Thread p < E: a bucket's first position writes its start, its last its
// end (start and end zeroed before: an empty bucket counts 0); on the range
// route (run > 0) a chunk's first payload gets MSM_CHUNK_START.
__global__ void k_msm_bucket_runs(const int32_t* __restrict__ keys,
                                  const int32_t* __restrict__ base, int64_t S,
                                  int run, int32_t* __restrict__ start,
                                  int32_t* __restrict__ end,
                                  int32_t* __restrict__ pay) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t E = base[S];
  if (p >= E) return;
  const int32_t g = keys[p];
  const bool first = p == 0 || keys[p - 1] != g;
  if (first) start[g] = (int32_t)p;
  if (p + 1 == E || keys[p + 1] != g) end[g] = (int32_t)(p + 1);
  if (run && msm_range_chunk_start(p, first, run))
    pay[p] = (int32_t)((uint32_t)pay[p] | MSM_CHUNK_START);
}

// Block s: the chunks of segment s's buckets, scanned into bco (local to
// the segment), their total to tot[s].
__global__ void __launch_bounds__(kScanThreads)
    k_msm_bucket_chunks(const int32_t* __restrict__ start,
                        const int32_t* __restrict__ end, int64_t half,
                        int chunk, int run, int32_t* __restrict__ bco,
                        int32_t* __restrict__ tot) {
  const int64_t b0 = blockIdx.x * half;
  const int64_t total = block_scan(bco + b0, half, [&](int64_t m) {
    return msm_bucket_chunk_count(start[b0 + m], end[b0 + m], chunk, run);
  });
  if (threadIdx.x == 0) tot[blockIdx.x] = (int32_t)total;
}

// Thread b < nb: bucket b's chunk offset (its segment's base added), its
// chunks' entry offsets and, on the range route, the runs that start in
// it; thread nb: the tails and info = (C, the busiest window's chunks, E).
__global__ void k_msm_chunk_offsets(
    const int32_t* __restrict__ start, const int32_t* __restrict__ end,
    const int32_t* __restrict__ cbase, const int32_t* __restrict__ base,
    const int32_t* __restrict__ most, int64_t S, int64_t half, int chunk,
    int run, int32_t* __restrict__ bco, int32_t* __restrict__ chunk_off,
    int32_t* __restrict__ run_chunks, int32_t* __restrict__ info) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nb = S * half;
  if (b < nb) {
    const int32_t cb = bco[b] + cbase[b / half];
    bco[b] = cb;
    msm_bucket_chunk_offsets(start[b], end[b], chunk, run, cb, chunk_off,
                             run_chunks);
  } else if (b == nb) {
    const int32_t C = cbase[S], E = base[S];
    bco[nb] = C;
    chunk_off[C] = E;
    if (run) run_chunks[((int64_t)E + run - 1) / run] = C;
    info[0] = C;
    info[1] = *most;
    info[2] = E;
  }
}

#define KZG_LAUNCHED()                          \
  do {                                          \
    const cudaError_t rc = cudaGetLastError(); \
    if (rc != cudaSuccess) return (int)rc;      \
  } while (0)

}  // namespace

// Step 1: scalars (k, 8, n) -> keys, payloads (k W n) and the first pass's
// tile histograms (k W, 2^bits0, tiles), tiles = ceil(n / tile), the tile
// a multiple of kThreads.
extern "C" int kzg_msm_digits(const void* scalars, int64_t sets, int64_t n,
                              int windows, int c, int bits0, int tile,
                              int64_t tiles, void* keys, void* pay, void* hist,
                              void* stream) {
  if (sets <= 0 || n <= 0) return 0;
  if (c < 2 || c > 16 || bits0 < 1 || bits0 > 9 || tile % kThreads ||
      tiles * tile < n)
    return -1;
  const size_t smem = sizeof(int32_t) * (size_t)windows << bits0;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        k_msm_digits, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  k_msm_digits<<<(unsigned)(sets * tiles), kThreads, smem,
                 (cudaStream_t)stream>>>(
      (const uint32_t*)scalars, n, windows, c, bits0, tile, tiles,
      (int32_t*)keys, (int32_t*)pay, (int32_t*)hist);
  return (int)cudaGetLastError();
}

// Step 2, one counting pass by the key bits shift .. shift + bits - 1:
// keys, pay -> keys_out, pay_out.  The first pass (first = 1) takes hist
// from kzg_msm_digits, drops the zero digits and writes base (segments +
// 1: the compact layout's segment starts and E), tot its scratch; a later
// pass counts its own histograms into hist over the compact layout.
extern "C" int kzg_msm_sort_pass(const void* keys, const void* pay,
                                 void* hist, void* tot, void* base,
                                 int64_t segments, int64_t n, int tile,
                                 int64_t tiles, int shift, int bits, int first,
                                 void* keys_out, void* pay_out, void* stream) {
  if (segments <= 0 || n <= 0) return 0;
  if (bits < 1 || bits > 9 || tile % kThreads) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)(segments * tiles);
  if (!first) {
    k_msm_sort_hist<<<blocks, kThreads, 0, s>>>(
        (const int32_t*)keys, (const int32_t*)base, shift, bits, tile, tiles,
        (int32_t*)hist);
    KZG_LAUNCHED();
  }
  k_msm_sort_scan<<<(unsigned)segments, kScanThreads, 0, s>>>(
      (int32_t*)hist, (int64_t)tiles << bits, first ? (int32_t*)tot : nullptr);
  KZG_LAUNCHED();
  if (first) {
    k_msm_segment_scan<<<1, kScanThreads, 0, s>>>(
        (const int32_t*)tot, segments, (int32_t*)base, nullptr);
    KZG_LAUNCHED();
  }
  const size_t smem = sizeof(int32_t) * (2 * tile + ((kWarps + 1) << bits));
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        k_msm_sort_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  k_msm_sort_scatter<<<blocks, kThreads, smem, s>>>(
      (const int32_t*)keys, (const int32_t*)pay, (const int32_t*)base,
      first ? 0 : 1, n, shift, bits, tile, tiles, (const int32_t*)hist,
      (int32_t*)keys_out, (int32_t*)pay_out);
  return (int)cudaGetLastError();
}

// Step 3: the sorted keys (digits long, the first E = base[segments] in
// bucket order) -> bco (segments half + 1), chunk_off (C + 1 of its
// capacity), on the range route (run > 0) run_chunks (ceil(E / run) + 1 of
// its capacity) and MSM_CHUNK_START on each chunk's first entry of the
// sorted payloads pay, in place (both untouched on the chunk route), and
// info (C, the busiest window's chunks, E).  bounds (2 segments half), tot
// (segments), cbase (segments + 1) and most (1) are scratch.
extern "C" int kzg_msm_bucket_offsets(const void* keys, const void* base,
                                      int64_t segments, int64_t half,
                                      int64_t digits, int chunk, int run,
                                      void* bounds, void* tot, void* cbase,
                                      void* most, void* bco, void* chunk_off,
                                      void* run_chunks, void* pay, void* info,
                                      void* stream) {
  if (segments <= 0 || half <= 0 || chunk <= 0 || run < 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nb = segments * half;
  int32_t* start = (int32_t*)bounds;
  int32_t* end = start + nb;
  cudaError_t rc = cudaMemsetAsync(bounds, 0, sizeof(int32_t) * 2 * nb, s);
  if (rc != cudaSuccess) return (int)rc;
  if (digits > 0) {
    k_msm_bucket_runs<<<(unsigned)((digits + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>((const int32_t*)keys,
                                          (const int32_t*)base, segments, run,
                                          start, end, (int32_t*)pay);
    KZG_LAUNCHED();
  }
  k_msm_bucket_chunks<<<(unsigned)segments, kScanThreads, 0, s>>>(
      start, end, half, chunk, run, (int32_t*)bco, (int32_t*)tot);
  KZG_LAUNCHED();
  k_msm_segment_scan<<<1, kScanThreads, 0, s>>>(
      (const int32_t*)tot, segments, (int32_t*)cbase, (int32_t*)most);
  KZG_LAUNCHED();
  k_msm_chunk_offsets<<<(unsigned)((nb + kThreads) / kThreads), kThreads, 0,
                        s>>>(start, end, (const int32_t*)cbase,
                             (const int32_t*)base, (const int32_t*)most,
                             segments, half, chunk, run, (int32_t*)bco,
                             (int32_t*)chunk_off, (int32_t*)run_chunks,
                             (int32_t*)info);
  return (int)cudaGetLastError();
}
