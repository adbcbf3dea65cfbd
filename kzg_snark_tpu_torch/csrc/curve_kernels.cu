// K6, K7 and K9 replacements: batched complete Jacobian add, doubling and
// complete mixed add (Jacobian + affine) on G1.
//
// Replaces kzg_snark_tpu/ops/pallas_fr.py:_add_call (fused_curve_add),
// :_double_call (fused_curve_double) and :_add_mixed_call
// (fused_curve_add_mixed).  K6 folds the scan MSM's bucket tables (lanes,
// bucket suffix ladder, windows) and sums the SRS build's windows; K9 is the
// step of the scan MSM (256 < n < 2048) and of the random-basis build; K7
// and K6 as the small MSM uses them are g1_ladder, below.
//
// What bounds it on the H100: a complete add is 11 Montgomery products and
// 5 squarings (add-2007-bl) and 20 add/subs on 12 NL-byte points (96 bytes
// at BN254, 144 at BLS12-381; three points moved): compute-bound at large
// batches, launch-bound in the Horner fold, where the batch is the number of
// scalars.  The mixed add is 7 products and 4 squarings and reads one point
// of P (q broadcasts) and writes one.  Design: one thread per point, the
// formulas of curve.cuh in registers, limb-major (3, NL, m) words for
// coalesced loads; K9's q has a column period (i % qn), so its callers'
// broadcast point is read from a small table, never expanded.
//
// K6, K7 and K9 run the product policy PROD_CHAIN (csrc/chain.cuh): each
// 32 x 32-bit product is one mad.lo and one mad.hi with the carries on the
// carry flag, and a squaring computes each cross product once (dbl-2009-l
// is 5 squarings and 2 products).  K6 and K9 load each coordinate where it
// is first used; at 8 words the three kernels' launch bounds ask for 4
// blocks of 128 threads an SM (at most 128 registers): 528 resident blocks,
// so 2^16 points (512 blocks) run in one wave.  At 12 words no bound is
// set: the formulas need about twice the registers, and the build prints
// what they take.
//
// g1_ladder is K7, with K6's add, as the small MSM (n <= 256) and
// CurveOps.scale use it: the whole double-and-add ladder in one launch,
// where the TPU ran a scan over 256 bit rows of one K6 and one K7 launch
// each.  At n <= 256 the card holds every thread at once, so the time is
// one thread's chain: up to 255 doublings (7 Montgomery products each) and
// up to 256 complete adds (16), one after another on one thread.  So one
// thread per (set, point) keeps acc and base in registers through all rows,
// skips the add where the bit is 0 and stops after the scalar's highest set
// bit; occupancy does not matter at this width, so the launch bounds give
// it up to 255 registers.  Summed (TREE, the small MSM) it runs one block
// per set and its halving tree in shared memory in CurveOps.tree_sum's
// order (256 Jacobian points of 144 bytes at 12 words: 36 KB); else
// (CurveOps.scale) the same kernel writes every s_ji P_i, one thread per
// (set, point) over any n.  A row's add and its doubling are independent:
// the add's dependent depth is 2 squarings and 3 products, the doubling's
// 2 and 1.  chip_smoke.py prints that critical-path floor and the serial
// cost of one thread's products beside the usual bound.
// Instantiated at NL = 8 (BN254 Fq) and NL = 12 (BLS12-381 Fq); the entry
// points take the limb count from the consts block.
#include <cuda_runtime.h>
#include <string.h>

#include "curve.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLadderPoints = 256;  // most points of a summed ladder (a block)

// Blocks an SM that K6, K7 and K9 ask their registers to allow.
constexpr int chain_min_blocks(int NL) { return NL == 8 ? 4 : 1; }

template <int NL>
__global__ void __launch_bounds__(kThreads, chain_min_blocks(NL))
    k_g1_add(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
             uint32_t* __restrict__ out, int64_t m, FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  g1_add_thread(i, p, q, out, m, F);
}

template <int NL>
__global__ void __launch_bounds__(kThreads, chain_min_blocks(NL))
    k_g1_double(const uint32_t* __restrict__ p,
                            uint32_t* __restrict__ out, int64_t m,
                            FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  g1_double_thread(i, p, out, m, F);
}

template <int NL>
__global__ void __launch_bounds__(kThreads, chain_min_blocks(NL))
    k_g1_add_mixed(const uint32_t* __restrict__ p,
                   const uint32_t* __restrict__ qx,
                   const uint32_t* __restrict__ qy, int64_t qn,
                   uint32_t* __restrict__ out, int64_t m, FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  g1_add_mixed_thread(i, p, qx, qy, qn, out, m, F);
}

// The ladder.  TREE: block j sums set j over the n = blockDim.x points, a
// thread a point, the halving tree in shared memory; out (3, NL, sets).
// Else thread j n + i writes s_ji P_i to column j n + i of out (3, NL,
// sets n).  Scalars (sets, S, sp) words, sp = n or 1 (one scalar for every
// point).  TREE is a template parameter, so the small MSM's instantiation
// carries no branch of the other form.
template <int NL, bool TREE>
__global__ void __launch_bounds__(kLadderPoints, 1)
    k_g1_ladder(const uint32_t* __restrict__ pts,
                const uint32_t* __restrict__ scalars, int S, int64_t sp,
                uint32_t* __restrict__ out, int64_t n, int64_t sets,
                FieldConsts<NL> F) {
  G1J<NL> acc;
  if (!TREE) {
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= sets * n) return;
    const int64_t j = idx / n, i = idx % n;
    g1_ladder_thread(acc, pts, n, i,
                     scalars + j * S * sp + (sp == 1 ? 0 : i), sp, S, F);
    g1_store(out, sets * n, idx, acc);
    return;
  }
  __shared__ G1J<NL> sh[TREE ? kLadderPoints : 1];
  const int m0 = blockDim.x, t = threadIdx.x;
  const int64_t j = blockIdx.x;
  g1_ladder_thread(acc, pts, m0, t, scalars + j * S * sp + (sp == 1 ? 0 : t),
                   sp, S, F);
  sh[t] = acc;
  __syncthreads();
  for (int m = m0; m > 1; m = (m + 1) / 2) {
    g1_tree_pair(sh, m, t, F);
    __syncthreads();
  }
  if (t == 0) g1_store(out, sets, j, sh[0]);
}

unsigned blocks_of(int64_t m) {
  return (unsigned)((m + kThreads - 1) / kThreads);
}

template <int NL>
int launch_add(const void* p, const void* q, void* out, int64_t m,
               const void* consts, void* stream) {
  k_g1_add<NL><<<blocks_of(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, m,
      consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

template <int NL>
int launch_double(const void* p, void* out, int64_t m, const void* consts,
                  void* stream) {
  k_g1_double<NL><<<blocks_of(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (uint32_t*)out, m, consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

template <int NL>
int launch_add_mixed(const void* p, const void* qx, const void* qy,
                     int64_t qn, void* out, int64_t m, const void* consts,
                     void* stream) {
  k_g1_add_mixed<NL><<<blocks_of(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)qx, (const uint32_t*)qy, qn,
      (uint32_t*)out, m, consts_of<NL>(consts));
  return (int)cudaGetLastError();
}

template <int NL>
int launch_ladder(const void* pts, const void* scalars, int S, int64_t sp,
                  void* out, int64_t n, int64_t sets, int tree,
                  const void* consts, void* stream) {
  const uint32_t* p = (const uint32_t*)pts;
  const uint32_t* s = (const uint32_t*)scalars;
  cudaStream_t st = (cudaStream_t)stream;
  if (tree) {
    k_g1_ladder<NL, true><<<(unsigned)sets, (unsigned)n, 0, st>>>(
        p, s, S, sp, (uint32_t*)out, n, sets, consts_of<NL>(consts));
  } else {
    k_g1_ladder<NL, false><<<blocks_of(sets * n), kThreads, 0, st>>>(
        p, s, S, sp, (uint32_t*)out, n, sets, consts_of<NL>(consts));
  }
  return (int)cudaGetLastError();
}

template <int NL>
int blocks_per_sm(int kernel) {
  int blocks = 0;
  cudaError_t rc =
      kernel == 0   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, k_g1_add<NL>, kThreads, 0)
      : kernel == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, k_g1_add_mixed<NL>, kThreads, 0)
      : kernel == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, k_g1_double<NL>, kThreads, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, k_g1_ladder<NL, true>, kLadderPoints, 0);
  return rc == cudaSuccess ? blocks : -(int)rc;
}

}  // namespace

// Resident blocks an SM of kernel 0 (K6), 1 (K9) or 2 (K7), blocks of
// kThreads, or 3 (the summed ladder, blocks of kLadderPoints) at `limbs`
// words, from the CUDA occupancy calculator; negative on error.
extern "C" int kzg_g1_blocks_per_sm(int kernel, int limbs) {
  return limbs == 8    ? blocks_per_sm<8>(kernel)
         : limbs == 12 ? blocks_per_sm<12>(kernel)
                       : KZG_BAD_LIMBS;
}

extern "C" int kzg_g1_threads() { return kThreads; }

extern "C" int kzg_g1_add(const void* p, const void* q, void* out, int64_t m,
                          const void* consts, void* stream) {
  if (m <= 0) return 0;
  return KZG_BY_LIMBS(consts, launch_add, p, q, out, m, consts, stream);
}

extern "C" int kzg_g1_double(const void* p, void* out, int64_t m,
                             const void* consts, void* stream) {
  if (m <= 0) return 0;
  return KZG_BY_LIMBS(consts, launch_double, p, out, m, consts, stream);
}

// K7 and K6 as the small MSM uses them: points (3, NL, n), scalars (sets,
// S, sp) canonical words with sp = n or 1.  tree = 1: out (3, NL, sets),
// sum_i s_ji P_i, n at most kLadderPoints; tree = 0: out (3, NL, sets n),
// every s_ji P_i.
extern "C" int kzg_g1_ladder(const void* pts, const void* scalars, int S,
                             int64_t sp, void* out, int64_t n, int64_t sets,
                             int tree, const void* consts, void* stream) {
  if (sets <= 0) return 0;
  if (n <= 0 || S <= 0 || (sp != 1 && sp != n) ||
      (tree && n > kLadderPoints))
    return -1;
  return KZG_BY_LIMBS(consts, launch_ladder, pts, scalars, S, sp, out, n,
                      sets, tree, consts, stream);
}

extern "C" int kzg_g1_add_mixed(const void* p, const void* qx, const void* qy,
                                int64_t qn, void* out, int64_t m,
                                const void* consts, void* stream) {
  if (m <= 0) return 0;
  return KZG_BY_LIMBS(consts, launch_add_mixed, p, qx, qy, qn, out, m,
                      consts, stream);
}
