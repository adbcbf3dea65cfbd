// K1 as the provers' chains use it: an exclusive scan of a field array
// (fr_scan) and a fixed-exponent power of every element (fr_pow).
//
// Replaces kzg_snark_tpu/ops/pallas_fr.py:_mul_call as the lax.scan chains
// of kzg_snark_tpu/ops/fr.py:308-445 use it (pow_const, batch_inv,
// exclusive_prefix_prod, suffix_sums_exclusive, sum_reduce): the JAX
// package runs each chain as one device loop, where one K1 launch a step
// from the host would cost a launch's 20-47 us of host time per product.
//
// fr_scan: out[l] = a[0] (op) ... (op) a[l - 1] in the logical order
// (forward, or reverse: l counts from the last column), op the Montgomery
// product (identity R mod p) or the modular sum (identity 0); also the total
// on request.  Field products and sums are exact, so the association order
// does not change a result.  Three launches, whatever n:
//   tiles   one block a tile of SCAN_TILE logical elements: a coalesced load
//           of each limb into shared memory, each thread folds SCAN_PER
//           consecutive elements in registers, the warp scans its threads'
//           totals with __shfl_up_sync on the NL words, one thread scans the
//           4 warp totals; writes the tile-local exclusive scan (coalesced,
//           through shared memory) and the tile's total;
//   totals  one block scans the tile totals (in place: each becomes its
//           tile's exclusive prefix) with the same tile code, tile after
//           tile, and writes the grand total;
//   fixup   one thread an element combines it with its tile's prefix.
// This is scan-then-propagate rather than a single pass with decoupled
// look-back: no block waits on another (no spinning on flags, no order of
// block scheduling to rely on), and the fix-up is a short fully parallel
// pass where a reduce-first design would repeat the tile pass's chain.  A
// total without the scan (sum_reduce) is the first two launches, the tile
// pass writing no elements.
//
// fr_pow: a^e of every element, one launch whatever n; the route depends
// only on e (pow_is_inversion, scan.cuh):
//   e = p - 2  an inversion, 0 mapping to 0 (k_fr_inv): a block a tile of
//              SCAN_TILE elements loaded as the tile pass loads them;
//              Montgomery's trick as a product tree: a thread's 4
//              elements (zeros taken as one) up a pair tree, the others of
//              each thread's total by a butterfly across the warp and of
//              each warp's by one across warp 0, one safegcd inversion of
//              the tile's total (inv.cuh: constant time, 741 divsteps in
//              25 batches of 30 at 8 words, 1110 in 37 at 12), the
//              inverses down the trees, zeros back to 0.  5 products an
//              element, a chain of 13 products and one inversion a block.
//   other e    one thread an element, square-and-multiply on the
//              PROD_CHAIN squaring and product (chain.cuh).
// This replaces one thread an element running Fermat's chain on fe_mul
// (about 380 dependent products for e = r - 2): at width 1, where 18 of
// PLONK's 21 launches and all of Marlin's run, that was 0.248 ms; the
// safegcd on a lone warp takes 27.8 us where the chain on PROD_CHAIN takes
// 161 us (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's build phase).
//
// Both are instantiated at NL = 8 (Fr of both curves, BN254 Fq) and NL = 12
// (BLS12-381 Fq: the batched inversions of its points); the entry points
// take the limb count from the consts block.
//
// What bounds them on the H100: a scan must read 32 bytes and write 32 an
// element and do one product; this design moves 128 bytes an element (the
// local scan is written and read once more) and does about 3 products
// (fold, output, fix-up) plus a chain of about 2 SCAN_PER + 10 dependent
// products a block.  At the provers' sizes (n <= 2^18: at most 512 tiles)
// the blocks' dependent chains, not bytes, set the time.  fr_pow's
// inversion route: at width 1 the block's chain (one safegcd and 13
// products: the design's own floor, 0.034 ms at 8 words with its safegcd
// as measured; no bound, since batch inversion at width 1 is one
// inversion); at 2^18 its 5 products an element (0.011 ms of products,
// where what batch inversion needs, 3 an element and one inversion, is
// 0.0064 ms) spread over 512 blocks, each as long as that chain.
//
// Products: the scan passes use the unrolled fe_mul.  A CIOS product with
// its outer loop rolled (the MSM reduction's product until it took
// PROD_CHAIN) was slower here on an H100 80GB HBM3 at 700 W in the
// single-block totals pass (the product scan at 2^16: 0.0401 against
// 0.0345 ms; chip_smoke.py, see PERF.md).
#include <cuda_runtime.h>
#include <string.h>

#include "scan.cuh"

namespace {

constexpr int kWarps = SCAN_THREADS / 32;
constexpr int kSmStride = SCAN_TILE + SCAN_TILE / 32;  // a pad word in 32
constexpr int kFixThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Padded shared-memory slot of tile element e: a thread's SCAN_PER
// consecutive elements fall in distinct banks across the warp.
__device__ __forceinline__ int slot(int e) { return e + (e >> 5); }

template <int NL>
__device__ __forceinline__ void sm_load(uint32_t r[NL], const uint32_t* sm,
                                        int e) {
#pragma unroll
  for (int k = 0; k < NL; k++) r[k] = sm[k * kSmStride + slot(e)];
}

template <int NL>
__device__ __forceinline__ void sm_store(uint32_t* sm, int e,
                                         const uint32_t r[NL]) {
#pragma unroll
  for (int k = 0; k < NL; k++) sm[k * kSmStride + slot(e)] = r[k];
}

// Tile load: logical elements [base, base + SCAN_TILE) of (a, ld, inc, n,
// reverse) into sm, the identity past n; limb row by limb row, so a warp
// reads consecutive words.
template <int OP, int NL>
__device__ __forceinline__ void tile_load(const uint32_t* a, int64_t ld,
                                          int64_t inc, int64_t n,
                                          bool reverse, int64_t base,
                                          uint32_t* sm,
                                          const FieldConsts<NL>& F) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < NL; k++) {
    const uint32_t id = OP == SCAN_OP_MUL ? F.one[k] : 0u;
#pragma unroll
    for (int j = 0; j < SCAN_PER; j++) {
      const int e = t + j * SCAN_THREADS;
      const int64_t l = base + e;
      sm[k * kSmStride + slot(e)] =
          l < n ? a[k * ld + scan_col(l, n, reverse) * inc] : id;
    }
  }
}

// Tile store: the tile in sm to its logical columns of the (NL, n) array
// out, those below n.
template <int NL>
__device__ __forceinline__ void tile_store(uint32_t* out, int64_t n,
                                           bool reverse, int64_t base,
                                           const uint32_t* sm) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < NL; k++) {
#pragma unroll
    for (int j = 0; j < SCAN_PER; j++) {
      const int e = t + j * SCAN_THREADS;
      const int64_t l = base + e;
      if (l < n)
        out[k * n + scan_col(l, n, reverse)] = sm[k * kSmStride + slot(e)];
    }
  }
}

// One tile of a scan by one block: logical elements [base, base +
// SCAN_TILE) of (a, ld, inc, n, reverse).  carry (the same in every
// thread) is the tile's exclusive prefix on entry and the next tile's on
// return.  If out is not null, writes carry (op) the exclusive scan of the
// tile into the (NL, n) array out; out may be a itself (dense, forward).
template <int OP, int NL>
__device__ __forceinline__ void block_scan_tile(
    const uint32_t* a, int64_t ld, int64_t inc, int64_t n, bool reverse,
    int64_t base, uint32_t carry[NL], uint32_t* out, uint32_t* sm,
    uint32_t* wsm, const FieldConsts<NL>& F) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  __syncthreads();  // the previous tile is done with sm and wsm
  tile_load<OP, NL>(a, ld, inc, n, reverse, base, sm, F);
  __syncthreads();

  uint32_t acc[NL], x[NL], y[NL];
  sm_load<NL>(acc, sm, t * SCAN_PER);
#pragma unroll 1
  for (int j = 1; j < SCAN_PER; j++) {
    sm_load<NL>(x, sm, t * SCAN_PER + j);
    scan_op<OP>(acc, acc, x, F);
  }
  // Inclusive scan of the threads' totals across the warp.
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < NL; k++) y[k] = __shfl_up_sync(kFull, acc[k], d);
    if (lane >= d) scan_op<OP>(acc, y, acc, F);
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < NL; k++) wsm[w * NL + k] = acc[k];
  }
  // The thread's exclusive prefix within its warp.
#pragma unroll
  for (int k = 0; k < NL; k++) y[k] = __shfl_up_sync(kFull, acc[k], 1);
  if (lane == 0) scan_identity<OP>(y, F);
  __syncthreads();
  if (t == 0) {  // warp prefixes, the carry folded in, and the tile total
    fe_copy<NL>(acc, carry);
#pragma unroll 1
    for (int v = 0; v < kWarps; v++) {
#pragma unroll
      for (int k = 0; k < NL; k++) {
        x[k] = wsm[v * NL + k];
        wsm[v * NL + k] = acc[k];
      }
      scan_op<OP>(acc, acc, x, F);
    }
#pragma unroll
    for (int k = 0; k < NL; k++) wsm[kWarps * NL + k] = acc[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NL; k++) {
    x[k] = wsm[w * NL + k];
    carry[k] = wsm[kWarps * NL + k];
  }
  if (out == nullptr) return;
  scan_op<OP>(acc, x, y, F);  // the thread's exclusive prefix
#pragma unroll 1
  for (int j = 0; j < SCAN_PER; j++) {
    sm_load<NL>(x, sm, t * SCAN_PER + j);
    sm_store<NL>(sm, t * SCAN_PER + j, acc);
    if (j + 1 < SCAN_PER) scan_op<OP>(acc, acc, x, F);
  }
  __syncthreads();
  tile_store<NL>(out, n, reverse, base, sm);
}

// Launch 1: tile-local exclusive scans (if out) and tile totals.
template <int OP, int NL>
__global__ void __launch_bounds__(SCAN_THREADS)
    k_scan_tiles(const uint32_t* __restrict__ a, int64_t ld, int64_t inc,
                 int64_t n, int reverse, uint32_t* __restrict__ out,
                 uint32_t* __restrict__ totals, int64_t tiles,
                 FieldConsts<NL> F) {
  __shared__ uint32_t sm[NL * kSmStride];
  __shared__ uint32_t wsm[(kWarps + 1) * NL];
  uint32_t carry[NL];
  scan_identity<OP>(carry, F);
  block_scan_tile<OP, NL>(a, ld, inc, n, reverse,
                          (int64_t)blockIdx.x * SCAN_TILE, carry, out, sm,
                          wsm, F);
  if (threadIdx.x == 0) fe_store<NL>(totals, tiles, blockIdx.x, carry);
}

// Launch 2, one block: the tile totals become their tiles' exclusive
// prefixes (if prefixes), and total gets the grand total (if not null).
template <int OP, int NL>
__global__ void __launch_bounds__(SCAN_THREADS)
    k_scan_totals(uint32_t* totals, int64_t tiles, int prefixes,
                  uint32_t* total, FieldConsts<NL> F) {
  __shared__ uint32_t sm[NL * kSmStride];
  __shared__ uint32_t wsm[(kWarps + 1) * NL];
  uint32_t carry[NL];
  scan_identity<OP>(carry, F);
  for (int64_t base = 0; base < tiles; base += SCAN_TILE)
    block_scan_tile<OP, NL>(totals, tiles, 1, tiles, false, base, carry,
                         prefixes ? totals : nullptr, sm, wsm, F);
  if (threadIdx.x == 0 && total != nullptr) fe_store<NL>(total, 1, 0, carry);
}

// Launch 3: every element of a tile after the first takes its prefix.
template <int OP, int NL>
__global__ void k_scan_fixup(uint32_t* __restrict__ out, int64_t n,
                             const uint32_t* __restrict__ prefix,
                             int64_t tiles, int reverse, FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  scan_fixup_thread<OP>(i, out, n, prefix, tiles, reverse != 0, F);
}

template <int OP, int NL>
int launch_scan(const uint32_t* a, int64_t ld, int64_t inc, int64_t n,
                int reverse, uint32_t* out, uint32_t* total,
                uint32_t* scratch, const FieldConsts<NL>& F, cudaStream_t s) {
  const int64_t tiles = scan_tiles(n);
  k_scan_tiles<OP, NL><<<(unsigned)tiles, SCAN_THREADS, 0, s>>>(
      a, ld, inc, n, reverse, out, scratch, tiles, F);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int prefixes = out != nullptr;
  k_scan_totals<OP, NL><<<1, SCAN_THREADS, 0, s>>>(scratch, tiles, prefixes,
                                               total, F);
  rc = (int)cudaGetLastError();
  if (rc || !prefixes) return rc;
  k_scan_fixup<OP, NL><<<(unsigned)((n + kFixThreads - 1) / kFixThreads),
                     kFixThreads, 0, s>>>(out, n, scratch, tiles, reverse, F);
  return (int)cudaGetLastError();
}

template <int NL>
struct Exponent {
  uint32_t w[NL];
};

// The general route: one thread an element, square-and-multiply.
template <int NL>
__global__ void k_fr_pow(const uint32_t* __restrict__ a,
                         uint32_t* __restrict__ out, int64_t n, Exponent<NL> e,
                         int nbits, FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe_pow_thread(i, a, out, n, e.w, nbits, F);
}

// The group products of a butterfly over lanes 2^lo .. 2^(hi-1) apart:
// acc becomes the product over the 2^hi lanes' group, oth that over the
// group without this lane's own acc.
template <int NL>
__device__ __forceinline__ void warp_others(uint32_t acc[NL],
                                            uint32_t oth[NL], int hi,
                                            const FieldConsts<NL>& F) {
  uint32_t y[NL];
#pragma unroll 1
  for (int d = 1; d < (1 << hi); d <<= 1) {
#pragma unroll
    for (int k = 0; k < NL; k++) y[k] = __shfl_xor_sync(kFull, acc[k], d);
    inv_others_step(acc, oth, y, F);
  }
}

// The inversion route (e = p - 2), one block a tile of SCAN_TILE elements:
// the tile into shared memory as fr_scan's tile pass loads it (one past
// n); a thread's 4 elements, zeros as one, up its pair tree; the others
// of each thread's total by a butterfly across its warp, of each warp's
// total by one across warp 0's first lanes; lane 0 of warp 0 inverts the
// tile's total by safegcd; the inverses go down the trees, zeros back to
// 0, and leave through shared memory as the scan's tiles do.
template <int NL>
__global__ void __launch_bounds__(SCAN_THREADS)
    k_fr_inv(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
             int64_t n, InvConsts<NL> I, FieldConsts<NL> F) {
  __shared__ uint32_t sm[NL * kSmStride];
  __shared__ uint32_t wsm[kWarps * NL];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
  tile_load<SCAN_OP_MUL, NL>(a, n, 1, n, false, base, sm, F);
  __syncthreads();
  uint32_t c0[NL], c1[NL], c2[NL], c3[NL], p01[NL], p23[NL], acc[NL],
      oth[NL];
  const int e0 = t * SCAN_PER;
  sm_load<NL>(c0, sm, e0);
  sm_load<NL>(c1, sm, e0 + 1);
  sm_load<NL>(c2, sm, e0 + 2);
  sm_load<NL>(c3, sm, e0 + 3);
  const unsigned zero = inv_zero_as_one(c0, F) | inv_zero_as_one(c1, F) << 1 |
                        inv_zero_as_one(c2, F) << 2 |
                        inv_zero_as_one(c3, F) << 3;
  inv_chunk_up(c0, c1, c2, c3, p01, p23, acc, F);
  fe_copy<NL>(oth, F.one);
  warp_others(acc, oth, 5, F);  // acc: the warp's total
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NL; k++) wsm[w * NL + k] = acc[k];
  }
  __syncthreads();
  if (w == 0) {
    uint32_t wacc[NL], woth[NL];
#pragma unroll
    for (int k = 0; k < NL; k++)
      wacc[k] = lane < kWarps ? wsm[lane * NL + k] : F.one[k];
    fe_copy<NL>(woth, F.one);
    warp_others(wacc, woth, 2, F);  // wacc: the tile's total
    static_assert(kWarps == 4, "warp 0's butterfly takes 2 levels");
    if (lane == 0) fe_inv_mont(wacc, wacc, F, I);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < NL; k++) wacc[k] = __shfl_sync(kFull, wacc[k], 0);
    fe_mul_chain(woth, woth, wacc, F);  // 1 / (warp lane's total)
    if (lane < kWarps) {
#pragma unroll
      for (int k = 0; k < NL; k++) wsm[lane * NL + k] = woth[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NL; k++) acc[k] = wsm[w * NL + k];
  fe_mul_chain(acc, oth, acc, F);  // 1 / (this thread's total)
  inv_chunk_down(c0, c1, c2, c3, p01, p23, acc, zero, F);
  sm_store<NL>(sm, e0, c0);
  sm_store<NL>(sm, e0 + 1, c1);
  sm_store<NL>(sm, e0 + 2, c2);
  sm_store<NL>(sm, e0 + 3, c3);
  __syncthreads();
  tile_store<NL>(out, n, false, base, sm);
}

template <int NL>
int run_scan(const void* a, int64_t ld, int64_t inc, int64_t n, int op,
             int reverse, void* out, void* total, void* scratch,
             const void* consts, void* stream) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  cudaStream_t s = (cudaStream_t)stream;
  if (op == SCAN_OP_MUL)
    return launch_scan<SCAN_OP_MUL>((const uint32_t*)a, ld, inc, n, reverse,
                                    (uint32_t*)out, (uint32_t*)total,
                                    (uint32_t*)scratch, F, s);
  return launch_scan<SCAN_OP_ADD>((const uint32_t*)a, ld, inc, n, reverse,
                                  (uint32_t*)out, (uint32_t*)total,
                                  (uint32_t*)scratch, F, s);
}

template <int NL>
int run_pow(const void* a, int64_t n, const void* exponent, int nbits,
            const void* inv_consts, void* out, const void* consts,
            void* stream) {
  Exponent<NL> e;
  memcpy(e.w, exponent, sizeof(e.w));
  const FieldConsts<NL> F = consts_of<NL>(consts);
  cudaStream_t s = (cudaStream_t)stream;
  if (pow_is_inversion<NL>(e.w, F)) {
    InvConsts<NL> I;
    memcpy(&I, inv_consts, sizeof(I));
    k_fr_inv<NL><<<(unsigned)scan_tiles(n), SCAN_THREADS, 0, s>>>(
        (const uint32_t*)a, (uint32_t*)out, n, I, F);
    return (int)cudaGetLastError();
  }
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  k_fr_pow<NL><<<blocks, threads, 0, s>>>((const uint32_t*)a, (uint32_t*)out,
                                          n, e, nbits, F);
  return (int)cudaGetLastError();
}

}  // namespace

// SCAN_TILE, the elements of a tile: the scratch array of an n-element
// scan has ceil(n / SCAN_TILE) columns.
extern "C" int kzg_scan_tile() { return SCAN_TILE; }

// a: (NL, ld) words read at columns scan_col(l) * inc, l < n (n >= 1);
// out: (NL, n) or null (total only); total: (NL, 1) or null; scratch:
// (NL, scan_tiles(n)).  Launches 3 kernels, or 2 when out is null.
extern "C" int kzg_fr_scan(const void* a, int64_t ld, int64_t inc, int64_t n,
                           int op, int reverse, void* out, void* total,
                           void* scratch, const void* consts, void* stream) {
  if (n <= 0) return 0;
  return KZG_BY_LIMBS(consts, run_scan, a, ld, inc, n, op, reverse, out,
                      total, scratch, consts, stream);
}

// a, out: (NL, n) dense; exponent: NL words, low first, of bit length
// nbits; inv_consts: InvConsts<NL> (R^3 mod p, p^-1 mod 2^30), read when
// the exponent is p - 2.  One launch.
extern "C" int kzg_fr_pow(const void* a, int64_t n, const void* exponent,
                          int nbits, const void* inv_consts, void* out,
                          const void* consts, void* stream) {
  if (n <= 0) return 0;
  return KZG_BY_LIMBS(consts, run_pow, a, n, exponent, nbits, inv_consts,
                      out, consts, stream);
}
