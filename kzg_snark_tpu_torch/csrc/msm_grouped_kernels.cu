// The grouped MSM on G1 (ops/msm_grouped.py): G groups of n points, each
// with its own points and its own k scalar sets, in one call, with no host
// wait.  FK20's cell proofs (ops/fk20.py) are two such calls: 128 groups of
// 64 points and k blobs for the circulant's products, then k groups of 128
// points and 128 sets for the G1 transform.
//
// The shared-base route (msm_schedule_kernels.cu, msm_kernels.cu) sizes its
// launches from the sorted digits, so the host reads their totals once a
// call; at n = 64 its plan would spend a 512-entry sort tile and a
// 1024-thread scan block on each (set, window) of 64 digits, and its fold
// takes at most 32 windows.  Here every shape follows from (G, k, n, c)
// alone:
//
//   k_msm_grouped_schedule     one block a (group, set) scalar set, one
//                              thread a point: the signed-digit recoding
//                              of k_msm_digits, then for each window a
//                              stable counting sort of its n digits in
//                              shared memory (each digit's rank among the
//                              earlier digits of its bucket), written at
//                              the segment's fixed stride n: entries
//                              (group point index << 1 | sign) in bucket
//                              order, the zero digits last; the 2^(c-1) + 1
//                              bucket offsets of the segment; and each
//                              bucket's first slot, a slot being at most
//                              GROUP_CHUNK of a bucket's entries.
//   k_msm_accumulate_grouped   one thread a (segment, slot): the slot's
//                              entries mixed-added in order (K8's adds);
//                              with complete adds, the fast add first and
//                              the complete one only for a slot where the
//                              fast one met acc = +-q.
//   k_msm_window_sums_grouped  one thread a segment: sum_m m B_m by running
//                              sums from the top bucket down, B_m's slot
//                              partials added in order.
//   k_msm_horner_grouped       one thread a scalar set: acc = 2^c acc + S_w
//                              from the top window.
//
// Slots, not buckets, a thread: equal scalars in a set put all of a
// window's digits in one bucket, and the G1 transform's rows hold 63 equal
// scalars (the DFT's matrix); one thread a bucket then walked 63 adds
// while its warp's others walked about 4 (36.9 ms a 9-blob batch against
// 9.1 on random scalars; NVIDIA H100 80GB HBM3, 700.00 W).  The fold runs a
// thread a set: at 1152 sets it matched msm.cuh's fold on a warp's lanes
// (3.55 against 3.45 ms) and at 8192 sets, the set-up table's, took 5.6
// against 19.7 ms.
//
// What bounds it: integer products, as the shared-base kernels; the
// schedule moves each digit's 8 bytes once.  Every add is a formula of
// curve.cuh / msm.cuh in a fixed order, so the plain versions give the same
// Jacobian representatives.
#include <cuda_runtime.h>
#include <stdint.h>

#include "msm.cuh"

namespace {

constexpr int kMaxGroupPoints = 1024;  // a schedule block's threads
constexpr int kAccThreads = 128;
constexpr int kSumThreads = 128;
constexpr int kFoldThreads = 32;       // one warp a block: sets spread out
constexpr int kMaxWindows = 64;        // c >= 4 at 255 bits

// Block `set` (group set / k): scalar set `set` of (G k, 8, n); thread i
// point i.  Shared: the window's bins (blockDim), the bucket counts (half
// + 1, the zero digits' bin last) and the buckets' first slots (half + 1).
__global__ void __launch_bounds__(kMaxGroupPoints)
    k_msm_grouped_schedule(const uint32_t* __restrict__ scalars, int64_t n,
                           int64_t sets_per_group, int W, int c, int chunk,
                           int32_t* __restrict__ entries,
                           int32_t* __restrict__ offsets,
                           int32_t* __restrict__ slots) {
  extern __shared__ int32_t sm[];
  const int half = 1 << (c - 1), full = 1 << c;
  const uint64_t mask = (uint64_t)full - 1;
  int32_t* bin_of = sm;
  int32_t* cnt = sm + blockDim.x;
  int32_t* first = cnt + half + 1;
  const int64_t set = blockIdx.x, group = set / sets_per_group;
  const int i = threadIdx.x;
  const bool live = i < n;
  uint32_t limb[8];
#pragma unroll
  for (int j = 0; j < 8; j++)
    limb[j] = live ? scalars[(set * 8 + j) * n + i] : 0;
  uint64_t buf = 0;
  int have = 0, next = 0, carry = 0;
  for (int w = 0; w < W; w++) {
    if (have < c) {  // c <= 16: one limb tops the buffer up
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 8; j++)
        if (j == next) v = limb[j];
      buf |= (uint64_t)v << have;
      have += 32;
      next++;
    }
    const int v = (int)(buf & mask) + carry;
    buf >>= c;
    have -= c;
    const int flip = v >= half && w < W - 1;
    const int mag = flip ? full - v : v;
    carry = flip;
    const int bin = mag ? mag - 1 : half;
    for (int q = i; q <= half; q += blockDim.x) cnt[q] = 0;
    bin_of[i] = live ? bin : half + 1;
    __syncthreads();
    if (live) atomicAdd(&cnt[bin], 1);
    __syncthreads();
    if (i == 0) {
      int32_t run = 0, slot = 0;
      for (int q = 0; q <= half; q++) {
        const int32_t k = cnt[q];
        cnt[q] = run;
        first[q] = slot;
        run += k;
        slot += (k + chunk - 1) / chunk;
      }
    }
    __syncthreads();
    const int64_t seg = set * W + w;
    if (live) {
      int32_t rank = 0;
      for (int j = 0; j < i; j++) rank += bin_of[j] == bin;
      entries[seg * n + cnt[bin] + rank] =
          (int32_t)(((group * n + i) << 1) | flip);
    }
    for (int q = i; q <= half; q += blockDim.x) {
      offsets[seg * (half + 1) + q] = cnt[q];
      slots[seg * (half + 1) + q] = first[q];
    }
    __syncthreads();
  }
}

// The entries [s, e) mixed-added in order, the first loaded with Z = 1
// (msm.cuh's msm_accumulate_thread on a range; an empty range gives the
// identity).  Returns whether an add met acc = +-q: the fast add's Z3 =
// 2 Z1 H is then 0, and nowhere else.
template <bool COMPLETE, int NL>
__device__ __forceinline__ bool grouped_bucket(G1J<NL>& acc, int64_t s,
                                               int64_t e, const uint32_t* xy,
                                               const int32_t* entries,
                                               const FieldConsts<NL>& F) {
  bool met = false;
  if (s >= e) {
    g1_set_identity(acc, F);
    return met;
  }
  int32_t ent = entries[s];
  msm_load_point<NL>(acc.X, acc.Y, xy, ent);
  if (ent & 1) fe_neg(acc.Y, acc.Y, F);
  fe_copy<NL>(acc.Z, F.one);
  uint32_t x[NL], y[NL];
  if (s + 1 < e) {
    ent = entries[s + 1];
    msm_load_point<NL>(x, y, xy, ent);
  }
#pragma unroll 1
  for (int64_t j = s + 1; j < e; j++) {
    if (ent & 1) fe_neg(y, y, F);
    const bool more = j + 1 < e;
    const int32_t nxt = more ? entries[j + 1] : 0;
    g1_madd_acc<COMPLETE>(acc, x, y, F, [&] {
      if (more) msm_load_point<NL>(x, y, xy, nxt);
    });
    met |= fe_is_zero<NL>(acc.Z);
    ent = nxt;
  }
  return met;
}

// Slot b with the complete add throughout: the rare slot whose fast adds
// met acc = +-q.  Not inlined, so its registers do not weigh on the fast
// loop; where no add meets that case the two adds compute the same values,
// so the slot's point is the complete add's.
template <int NL>
__device__ __noinline__ void grouped_slot_complete(
    int64_t s, int64_t e, const uint32_t* xy, const int32_t* entries,
    uint32_t* partials, int64_t count, int64_t b, FieldConsts<NL> F) {
  G1J<NL> acc;
  grouped_bucket<true>(acc, s, e, xy, entries, F);
  g1_store(partials, count, b, acc);
}

// Thread b: slot b % cap of segment b / cap, cap = the slots a segment may
// hold; the slot of bucket m (the last m with first[m] <= slot) covers
// entries off[m] + chunk (slot - first[m]) onwards, at most chunk of them.
// Slots past the segment's last hold the identity.
template <bool COMPLETE, int NL>
__global__ void __launch_bounds__(kAccThreads)
    k_msm_accumulate_grouped(const uint32_t* __restrict__ xy,
                             const int32_t* __restrict__ entries,
                             const int32_t* __restrict__ offsets,
                             const int32_t* __restrict__ slots, int64_t n,
                             int64_t half, int64_t cap, int64_t count,
                             int chunk, uint32_t* __restrict__ partials,
                             FieldConsts<NL> F) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= count) return;
  const int64_t seg = b / cap, slot = b % cap;
  const int32_t* first = slots + seg * (half + 1);
  if (slot >= first[half]) {
    G1J<NL> id;
    g1_set_identity(id, F);
    g1_store(partials, count, b, id);
    return;
  }
  int lo = 0, hi = (int)half - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= slot) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int32_t* off = offsets + seg * (half + 1);
  const int64_t s = seg * n + off[lo] + (int64_t)chunk * (slot - first[lo]);
  const int64_t end = seg * n + off[lo + 1];
  const int64_t e = s + chunk < end ? s + chunk : end;
  G1J<NL> acc;
  if (grouped_bucket<false>(acc, s, e, xy, entries, F) && COMPLETE) {
    grouped_slot_complete<NL>(s, e, xy, entries, partials, count, b, F);
    return;
  }
  g1_store(partials, count, b, acc);
}

template <int NL>
__global__ void __launch_bounds__(kSumThreads)
    k_msm_window_sums_grouped(const uint32_t* __restrict__ partials,
                              const int32_t* __restrict__ slots,
                              int64_t half, int64_t cap, int64_t segments,
                              uint32_t* __restrict__ sums,
                              FieldConsts<NL> F) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= segments) return;
  const int32_t* first = slots + s * (half + 1);
  G1J<NL> R, Wt;
  g1_set_identity(R, F);
  g1_set_identity(Wt, F);
#pragma unroll 1
  for (int64_t m = half - 1; m >= 0; m--) {
#pragma unroll 1
    for (int32_t q = first[m]; q < first[m + 1]; q++) {
      G1J<NL> B;
      g1_load(B, partials, segments * cap, s * cap + q);
      g1_add_acc(R, B, F);
    }
    g1_add_acc(Wt, R, F);
  }
  g1_store(sums, segments, s, Wt);
}

template <int NL>
__global__ void __launch_bounds__(kFoldThreads)
    k_msm_horner_grouped(const uint32_t* __restrict__ sums, int64_t sets,
                         int windows, int c, uint32_t* __restrict__ out,
                         FieldConsts<NL> F) {
  const int64_t set = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (set >= sets) return;
  G1J<NL> acc;
  g1_set_identity(acc, F);
#pragma unroll 1
  for (int w = windows - 1; w >= 0; w--) {
#pragma unroll 1
    for (int i = 0; i < c; i++) g1_double_finite(acc, F);
    G1J<NL> S;
    g1_load(S, sums, sets * windows, set * windows + w);
    g1_add_acc(acc, S, F);
  }
  g1_store(out, sets, set, acc);
}

template <int NL>
int launch_accumulate(const void* xy, const void* entries,
                      const void* offsets, const void* slots, int64_t n,
                      int64_t half, int64_t cap, int64_t count, int chunk,
                      void* partials, int complete, const void* consts,
                      void* stream) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  const unsigned blocks = (unsigned)((count + kAccThreads - 1) / kAccThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (complete) {
    k_msm_accumulate_grouped<true, NL><<<blocks, kAccThreads, 0, s>>>(
        (const uint32_t*)xy, (const int32_t*)entries,
        (const int32_t*)offsets, (const int32_t*)slots, n, half, cap, count,
        chunk, (uint32_t*)partials, F);
  } else {
    k_msm_accumulate_grouped<false, NL><<<blocks, kAccThreads, 0, s>>>(
        (const uint32_t*)xy, (const int32_t*)entries,
        (const int32_t*)offsets, (const int32_t*)slots, n, half, cap, count,
        chunk, (uint32_t*)partials, F);
  }
  return (int)cudaGetLastError();
}

template <int NL>
int launch_window_sums(const void* partials, const void* slots, int64_t half,
                       int64_t cap, int64_t segments, void* sums,
                       const void* consts, void* stream) {
  k_msm_window_sums_grouped<NL>
      <<<(unsigned)((segments + kSumThreads - 1) / kSumThreads), kSumThreads,
         0, (cudaStream_t)stream>>>((const uint32_t*)partials,
                                    (const int32_t*)slots, half, cap,
                                    segments, (uint32_t*)sums,
                                    consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

template <int NL>
int launch_horner(const void* sums, int64_t sets, int windows, int c,
                  void* out, const void* consts, void* stream) {
  k_msm_horner_grouped<NL>
      <<<(unsigned)((sets + kFoldThreads - 1) / kFoldThreads), kFoldThreads,
         0, (cudaStream_t)stream>>>((const uint32_t*)sums, sets, windows, c,
                                    (uint32_t*)out, consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

}  // namespace

// Scalars (G k, 8, n) -> entries (G k W n), bucket offsets and first slots
// (G k W, 2^(c-1) + 1 each); n <= 1024, 2 <= c <= 10.
extern "C" int kzg_msm_grouped_schedule(const void* scalars, int64_t sets,
                                        int64_t sets_per_group, int64_t n,
                                        int windows, int c, int chunk,
                                        void* entries, void* offsets,
                                        void* slots, void* stream) {
  if (sets <= 0 || n <= 0) return 0;
  if (n > kMaxGroupPoints || c < 2 || c > 10 || sets_per_group <= 0 ||
      chunk < 1)
    return -1;
  const int threads = (int)((n + 31) / 32 * 32);
  const size_t smem = sizeof(int32_t) * (threads + 2 * ((1 << (c - 1)) + 1));
  k_msm_grouped_schedule<<<(unsigned)sets, threads, smem,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)scalars, n, sets_per_group, windows, c, chunk,
      (int32_t*)entries, (int32_t*)offsets, (int32_t*)slots);
  return (int)cudaGetLastError();
}

// Slot partials (3, L, segments cap) from the schedule; count = segments
// cap.
extern "C" int kzg_msm_accumulate_grouped(
    const void* xy, const void* entries, const void* offsets,
    const void* slots, int64_t n, int64_t half, int64_t cap, int64_t count,
    int chunk, void* partials, int complete, const void* consts,
    void* stream) {
  if (count <= 0) return 0;
  return KZG_BY_LIMBS(consts, launch_accumulate, xy, entries, offsets, slots,
                      n, half, cap, count, chunk, partials, complete, consts,
                      stream);
}

// Window sums (3, L, segments) from the slot partials.
extern "C" int kzg_msm_window_sums_grouped(const void* partials,
                                           const void* slots, int64_t half,
                                           int64_t cap, int64_t segments,
                                           void* sums, const void* consts,
                                           void* stream) {
  if (segments <= 0) return 0;
  return KZG_BY_LIMBS(consts, launch_window_sums, partials, slots, half, cap,
                      segments, sums, consts, stream);
}

// The results (3, L, sets) from the window sums (3, L, sets W); W <= 64.
extern "C" int kzg_msm_horner_grouped(const void* sums, int64_t sets,
                                      int windows, int c, void* out,
                                      const void* consts, void* stream) {
  if (sets <= 0) return 0;
  if (windows < 1 || windows > kMaxWindows) return -1;
  return KZG_BY_LIMBS(consts, launch_horner, sums, sets, windows, c, out,
                      consts, stream);
}
