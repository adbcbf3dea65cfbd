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
// does not change a result.  One launch, whatever n, a total alone too: a
// single pass with decoupled look-back (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", 2016; k_scan below).  A
// block takes its tile from a ticket in the order blocks start, so it waits
// only on blocks that already run; the state (flags, aggregates, inclusive
// prefixes) is a per-stream scratch that every launch leaves zeroed, so no
// memset launch comes between scans.  Each element is read once and
// written once, and every product is PROD_CHAIN's.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's chains phase):
// the product scan with its total at (8, 2^16) 0.021-0.024 ms against its
// bytes' bound of 0.0013 and its own floor of 21 dependent products
// (0.0093 ms at a lone warp's latency), the sum 0.012, a total alone
// 0.009; one tile (no look-back) 0.011 / 0.006, most of it the launch and
// a block's round trips to the L2.  The look-back's window follows the
// tile count (scan_window): at 2^16 a block-wide step of 256 tiles takes
// the last of 128 tiles straight to tile 0 (with warp 0's 32 it stepped
// back four times: 0.023 ms); at 2^18 (512 tiles, three blocks an SM) a
// block-wide step costs every warp a butterfly in scheduler slots (0.064 ms),
// warp 0's steps of 32 0.062, the parent's three launches 0.059.  Also
// tried, slower: loading tile blockIdx.x while the ticket was taken (a
// reload when they differ), and values tagged with the scan's epoch word
// by word in place of flags (each poll reads 2 NL words: a sum at 2^18
// 0.075 ms against 0.027).
//
// Why a look-back and not a cluster: the other design, one cluster of 8 or
// 16 blocks walking the array in rounds (each block scanning its chunk as
// k_scan scans a tile, the chunks' aggregates exchanged through distributed
// shared memory at a cluster barrier; timed in the same phase, then
// removed), took 0.026 / 0.065 / 0.251 ms at 2^14 / 2^16 / 2^18
// with 16 blocks (0.036 / 0.127 / 0.497 with 8) against the look-back's
// 0.017 / 0.021 / 0.062, and 0.113 against 0.035 at 12 words: 16 SMs
// serialise what 132 share (each thread folds and writes 8 elements a
// round, in turn).
//
// fr_pow: a^e of every element, one launch whatever n; the route depends
// only on e (pow_is_inversion, scan.cuh):
//   e = p - 2  an inversion, 0 mapping to 0 (k_fr_inv): a block a tile of
//              SCAN_TILE elements loaded as fr_scan loads its tiles;
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
// element (8 words) and do one product: 0.0013 ms at 2^16 by bytes.  The
// design's own floor is one block's chain of dependent products (its fold,
// the warp's and the block's scans, a look-back step's butterfly, the
// prefixes and its outputs) at a lone warp's product latency; at the
// provers' sizes (n <= 2^18: at most 512 tiles, one or a few blocks an SM)
// that chain, not bytes, sets the time.  fr_pow's
// inversion route: at width 1 the block's chain (one safegcd and 13
// products: the design's own floor, 0.034 ms at 8 words with its safegcd
// as measured; no bound, since batch inversion at width 1 is one
// inversion); at 2^18 its 5 products an element (0.011 ms of products,
// where what batch inversion needs, 3 an element and one inversion, is
// 0.0064 ms) spread over 512 blocks, each as long as that chain.
#include <cuda_runtime.h>
#include <string.h>

#include "scan.cuh"

namespace {

constexpr int kWarps = SCAN_THREADS / 32;
constexpr int kPassWarps = SCAN_PASS_THREADS / 32;
constexpr int kSmStride = SCAN_TILE + SCAN_TILE / 32;  // a pad word in 32
constexpr unsigned kFull = 0xffffffffu;

// Padded shared-memory slot of tile element e: a thread's SCAN_PER (or
// SCAN_PASS_PER) consecutive elements fall in distinct banks across the
// warp.
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
// reverse) into sm, the identity past n, by a block of THREADS; limb row by
// limb row, so a warp reads consecutive words.
template <int OP, int NL, int THREADS = SCAN_THREADS>
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
    for (int j = 0; j < SCAN_TILE / THREADS; j++) {
      const int e = t + j * THREADS;
      const int64_t l = base + e;
      sm[k * kSmStride + slot(e)] =
          l < n ? a[k * ld + scan_col(l, n, reverse) * inc] : id;
    }
  }
}

// Tile store: the tile in sm to its logical columns of the (NL, n) array
// out, those below n, by a block of THREADS.
template <int NL, int THREADS = SCAN_THREADS>
__device__ __forceinline__ void tile_store(uint32_t* out, int64_t n,
                                           bool reverse, int64_t base,
                                           const uint32_t* sm) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < NL; k++) {
#pragma unroll
    for (int j = 0; j < SCAN_TILE / THREADS; j++) {
      const int e = t + j * THREADS;
      const int64_t l = base + e;
      if (l < n)
        out[k * n + scan_col(l, n, reverse)] = sm[k * kSmStride + slot(e)];
    }
  }
}

// The single-pass scan, one block of SCAN_PASS_THREADS a tile of SCAN_TILE
// logical elements:
//   1. thread 0 takes the next tile from the ticket (state word 0) and
//      the block loads it into shared memory (coalesced, limb row by limb
//      row);
//   2. each thread folds its SCAN_PASS_PER elements, the warp scans its
//      threads' totals (__shfl_up_sync), warp 0 scans the warps' totals:
//      the tile's aggregate, which lane kPassWarps publishes (tile 0: as
//      its inclusive prefix);
//   3. the block looks back (tiles > 0): each thread of the window (the
//      block when the last tile reaches tile 0 in one step of SCAN_WINDOW,
//      else warp 0; scan_window) reads the flag of one of the tiles below
//      the window's top and waits until it is published; the nearest
//      inclusive prefix ends the look-back (the aggregates above it and it
//      are combined: in warp 0 by a butterfly only as deep as its lane,
//      else by every warp and then across the warps), else the window's
//      aggregates are combined and the window steps back;
//   4. lane kPassWarps of warp 0 publishes the tile's inclusive prefix (the
//      last tile: writes the total), the lanes below it fold the prefix
//      into the warps' exclusive prefixes;
//   5. each thread writes its elements' exclusive scan through shared
//      memory (coalesced); then the publishing lane counts the block done
//      (the last block done resets the state).
// A total alone skips 3-5: each block leaves its aggregate and counts
// itself done; the last block folds all the aggregates into the total.
template <int OP, int NL>
__global__ void __launch_bounds__(SCAN_PASS_THREADS)
    k_scan(const uint32_t* __restrict__ a, int64_t ld, int64_t inc,
           int64_t n, int reverse, uint32_t* __restrict__ out,
           uint32_t* __restrict__ total, uint32_t* state, int64_t tiles,
           FieldConsts<NL> F) {
  constexpr int kPer = SCAN_PASS_PER;
  __shared__ uint32_t sm[NL * kSmStride];
  __shared__ uint32_t wsm[kPassWarps * NL];
  __shared__ uint32_t ticket;
  __shared__ int wfirst[kPassWarps], last;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) ticket = atomicAdd(&state[0], 1u);
  __syncthreads();
  const int64_t tile = ticket, base = tile * SCAN_TILE;
  tile_load<OP, NL, SCAN_PASS_THREADS>(a, ld, inc, n, reverse != 0, base, sm,
                                       F);
  __syncthreads();

  uint32_t acc[NL], x[NL], y[NL], v[NL], z[NL];
  sm_load<NL>(acc, sm, t * kPer);
#pragma unroll 1
  for (int j = 1; j < kPer; j++) {
    sm_load<NL>(x, sm, t * kPer + j);
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
  // y: the thread's exclusive prefix within its warp.
#pragma unroll
  for (int k = 0; k < NL; k++) y[k] = __shfl_up_sync(kFull, acc[k], 1);
  if (lane == 0) scan_identity<OP>(y, F);
  __syncthreads();

  if (w == 0) {
    // Lanes below kPassWarps: the warps' totals, scanned; x: lane v's
    // exclusive prefix (v <= kPassWarps; lane kPassWarps's is the
    // aggregate).
    if (lane < kPassWarps) {
#pragma unroll
      for (int k = 0; k < NL; k++) v[k] = wsm[lane * NL + k];
    } else {
      scan_identity<OP>(v, F);
    }
#pragma unroll 1
    for (int d = 1; d < kPassWarps; d <<= 1) {
#pragma unroll
      for (int k = 0; k < NL; k++) x[k] = __shfl_up_sync(kFull, v[k], d);
      if (lane >= d && lane < kPassWarps) scan_op<OP>(v, x, v, F);
    }
#pragma unroll
    for (int k = 0; k < NL; k++) x[k] = __shfl_up_sync(kFull, v[k], 1);
    if (lane == 0) scan_identity<OP>(x, F);
    if (lane == kPassWarps && out == nullptr) {
      scan_put_aggregate<NL>(state, tile, x);
      uint32_t done;  // after the aggregate (release)
      asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], %2;"
                   : "=r"(done)
                   : "l"(state + 1), "r"(1u)
                   : "memory");
      last = done == (uint32_t)(tiles - 1);
    } else if (lane == kPassWarps) {
      scan_publish<NL>(state, tile,
                       tile == 0 ? SCAN_FLAG_INCL : SCAN_FLAG_AGG, x);
    }
  }

  if (out == nullptr) {
    // A total alone looks back at nothing: the last block done (which has
    // every aggregate: acquire) folds them all, a thread a column of
    // tiles, then the warps' butterflies and warp 0's across them.
    __syncthreads();
    if (!last) return;
    scan_identity<OP>(v, F);
#pragma unroll 1
    for (int64_t i = t; i < tiles; i += SCAN_PASS_THREADS) {
      const uint32_t* src = scan_rec(state, i) + 1;
#pragma unroll
      for (int k = 0; k < NL; k++) z[k] = scan_ld(src + k);
      scan_op<OP>(v, v, z, F);
    }
#pragma unroll 1
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int k = 0; k < NL; k++) z[k] = __shfl_xor_sync(kFull, v[k], d);
      scan_op<OP>(v, v, z, F);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < NL; k++) wsm[w * NL + k] = v[k];
    }
    __syncthreads();
    if (w == 0) {
      if (lane < kPassWarps) {
#pragma unroll
        for (int k = 0; k < NL; k++) v[k] = wsm[lane * NL + k];
      } else {
        scan_identity<OP>(v, F);
      }
#pragma unroll 1
      for (int d = 1; d < kPassWarps; d <<= 1) {
#pragma unroll
        for (int k = 0; k < NL; k++) z[k] = __shfl_xor_sync(kFull, v[k], d);
        scan_op<OP>(v, v, z, F);
      }
      if (lane == 0) {
        fe_store<NL>(total, 1, 0, v);
        scan_state_reset(state, tiles);
      }
    }
    return;
  }

  // The look-back: pre (warp 0), the product or sum of every tile before
  // this one, win tiles a step (scan_window); a window of 32 is warp 0's
  // alone, the block waits for it at the barrier after.
  const int win = scan_window(tiles);
  const bool wide = win > 32;
  uint32_t pre[NL];
  scan_identity<OP>(pre, F);
#pragma unroll 1
  for (int64_t hi = tile - 1; hi >= 0 && (wide || w == 0); hi -= win) {
    const int64_t tt = hi - t;
    uint32_t flag = SCAN_FLAG_AGG;  // tiles below 0: the identity
    if (t < win && tt >= 0) {
      const uint32_t* fp = scan_rec(state, tt);
      do {
        asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                     : "=r"(flag)
                     : "l"(fp)
                     : "memory");
      } while (flag == SCAN_FLAG_NONE);
    }
    const unsigned incl = __ballot_sync(kFull, flag == SCAN_FLAG_INCL);
    int first = incl ? w * 32 + __ffs(incl) - 1 : SCAN_WINDOW;
    if (wide) {
      if (lane == 0) wfirst[w] = first;
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPassWarps; u++) first = min(first, wfirst[u]);
    }
    if (t < win) {
      scan_lookback_value<OP>(v, state, tt, t, first, F);
    } else {
      scan_identity<OP>(v, F);
    }
    // Positions 0 .. first hold the window's values: a butterfly over the
    // smallest power of two of lanes that covers them (every warp's 32 and
    // then the warps' sums, if they reach past warp 0) leaves their
    // product or sum in lane 0 of warp 0.
    const int levels = first < 32 ? first : 31;
    const bool across = wide && first >= 32;
    if (w == 0 || across) {
#pragma unroll 1
      for (int d = 1; d <= levels; d <<= 1) {
#pragma unroll
        for (int k = 0; k < NL; k++) z[k] = __shfl_xor_sync(kFull, v[k], d);
        scan_op<OP>(v, v, z, F);
      }
    }
    if (across) {
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NL; k++) wsm[w * NL + k] = v[k];
      }
      __syncthreads();
      if (w == 0) {
        if (lane < kPassWarps) {
#pragma unroll
          for (int k = 0; k < NL; k++) v[k] = wsm[lane * NL + k];
        } else {
          scan_identity<OP>(v, F);
        }
#pragma unroll 1
        for (int d = 1; d < kPassWarps; d <<= 1) {
#pragma unroll
          for (int k = 0; k < NL; k++)
            z[k] = __shfl_xor_sync(kFull, v[k], d);
          scan_op<OP>(v, v, z, F);
        }
      }
    }
    if (w == 0) {
#pragma unroll
      for (int k = 0; k < NL; k++) v[k] = __shfl_sync(kFull, v[k], 0);
      scan_op<OP>(pre, v, pre, F);
    }
    if (wide) __syncthreads();  // wfirst and wsm are free again
    if (first < win) break;
  }

  if (w == 0) {
    // x: the warps' exclusive prefixes, lane kPassWarps the aggregate.
    scan_op<OP>(x, pre, x, F);
    if (lane < kPassWarps) {
#pragma unroll
      for (int k = 0; k < NL; k++) wsm[lane * NL + k] = x[k];
    }
    if (lane == kPassWarps) {
      if (tile > 0) scan_publish<NL>(state, tile, SCAN_FLAG_INCL, x);
      if (tile == tiles - 1 && total != nullptr) fe_store<NL>(total, 1, 0, x);
    }
  }
  __syncthreads();

  {
#pragma unroll
    for (int k = 0; k < NL; k++) x[k] = wsm[w * NL + k];
    scan_op<OP>(acc, x, y, F);  // the thread's exclusive prefix
#pragma unroll 1
    for (int j = 0; j < kPer; j++) {
      sm_load<NL>(x, sm, t * kPer + j);
      sm_store<NL>(sm, t * kPer + j, acc);
      if (j + 1 < kPer) scan_op<OP>(acc, acc, x, F);
    }
    __syncthreads();
    tile_store<NL, SCAN_PASS_THREADS>(out, n, reverse != 0, base, sm);
  }
  if (t == kPassWarps) {
    // This block reads no more of the state and has published: count it
    // done (acq_rel, after its publication); the last block done clears
    // the flags.
    uint32_t done;
    asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], %2;"
                 : "=r"(done)
                 : "l"(state + 1), "r"(1u)
                 : "memory");
    if (done == (uint32_t)(tiles - 1)) scan_state_reset(state, tiles);
  }
}

template <int OP, int NL>
int launch_scan(const uint32_t* a, int64_t ld, int64_t inc, int64_t n,
                int reverse, uint32_t* out, uint32_t* total, uint32_t* state,
                const FieldConsts<NL>& F, cudaStream_t s) {
  const int64_t tiles = scan_tiles(n);
  k_scan<OP, NL><<<(unsigned)tiles, SCAN_PASS_THREADS, 0, s>>>(
      a, ld, inc, n, reverse, out, total, state, tiles, F);
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
// the tile into shared memory as fr_scan loads its tiles (one past
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

// SCAN_TILE, the elements of a tile (fr_scan's and fr_pow's inversion
// route's).
extern "C" int kzg_scan_tile() { return SCAN_TILE; }

// SCAN_WINDOW, the tiles one look-back step of fr_scan reads.
extern "C" int kzg_scan_window() { return SCAN_WINDOW; }

// The 32-bit words of fr_scan's scratch for n elements (scan_state_words).
extern "C" int64_t kzg_scan_state_words(int64_t n) {
  return scan_state_words(n);
}

// a: (NL, ld) words read at columns scan_col(l) * inc, l < n (n >= 1);
// out: (NL, n) or null (total only); total: (NL, 1) or null; scratch: the
// single-pass state, kzg_scan_state_words(n) words, zero before a stream's
// first scan, left zero by each, used by one stream at a time.  One launch.
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
