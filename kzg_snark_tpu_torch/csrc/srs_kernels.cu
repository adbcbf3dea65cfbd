// K7 (and K6's row adds) as the SRS build uses them: the fixed-base table
// T[j, v] = v 2^(c j) G in one launch.
//
// Replaces kzg_snark_tpu/ops/pallas_fr.py:_double_call (fused_curve_double)
// and :_add_call (fused_curve_add) as kzg_snark_tpu/ops/srs.py's table
// build uses them: a host loop of c (W - 1) one-point doublings (248 at
// c = 8, W = 32), then c - 1 levels of a W-point doubling and a W count-point
// add, each a launch.
//
// What bounds it on the H100: not bytes (one point in, W 2^c out, 12 NL
// bytes each) nor products (about 130k Montgomery products at c = 8, W =
// 32: 1 us on the card at 8 words), but the window bases' chain: c (W - 1)
// dependent doublings, then the last window's row, c - 1 levels of a
// doubling and an add.  Instantiated at NL = 8 (BN254) and NL = 12
// (BLS12-381: 144-byte points, 12 x 12-word products).
//
// Design: one launch of a thread-block cluster (Hopper; the hardware
// schedules its blocks together).  Warp 0 of block 0 runs the chain on its
// lanes (srs.cuh fbt_chain_lanes: a doubling's independent products one a
// lane, three product levels deep, on PROD_CHAIN).  Each window's row needs
// only its base, so rows are built as their bases come, off the chain's
// SM: window j goes to row group j mod U of the other blocks (U =
// FBT_UNITS = 45 groups of two warps), which waits on a counter in its own
// shared memory that the chain's lane 0 raises through distributed shared
// memory (a release store at cluster scope after storing B_j; the group's
// acquire load, then B_j from device memory).  A group runs its rows' levels with a named
// barrier between them, its step doubled on each warp's lanes and its adds
// one a thread.  The cluster's blocks are co-scheduled, so no block waits on
// one that is not running; past U windows a group takes its next window
// when the chain reaches it.  The formulas and their order are srs.cuh's,
// so the table equals the plain version word for word.
//
// Why a cluster (chip_smoke.py's chains phase timed each launch shape, then
// the shapes that lost were removed; NVIDIA H100 80GB HBM3, 700.00 W): the
// other way, one block whose other warps build the rows beside the chain,
// took 1.17-1.34 / 2.42-2.43 ms at c = 8, W = 32 (8 / 12 words): the rows
// on the chain's SM slowed its doubling from 2.2 to 4.5-5.2 us.  Clusters
// of 8 and 16 blocks, with one or three row groups a block, took 0.624-
// 0.633 / 1.45-1.56 ms, alike within their spread; kept: 16 blocks of three
// groups, so W <= 45 windows never share a group.  The chain's doubling
// takes 2.2 / 5.0-5.5 us against the 1.19 / 2.47 us of its three product
// levels: the formula's additions and subtractions, which run on every
// lane in turn, and the lanes' shuffles.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <string.h>

#include "srs.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 32 + FBT_GROUPS * FBT_GROUP_THREADS;
constexpr int kMaxWindows = 512;

__device__ __forceinline__ void st_release_cluster(unsigned* p, unsigned v) {
  asm volatile("st.release.cluster.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire_cluster(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.cluster.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The threads of row group g (warps 1 + 2 g and 2 + 2 g) meet.
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(FBT_GROUP_THREADS)
               : "memory");
}

template <int NL>
__global__ void __launch_bounds__(kThreads, 1)
    k_g1_fixed_base_table(const uint32_t* __restrict__ base, uint32_t* table,
                          int windows, int c, FieldConsts<NL> F) {
  // ready[g]: the windows of this block's group g whose base is stored.
  __shared__ unsigned ready[FBT_GROUPS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  constexpr int blocks = FBT_CLUSTER - 1;  // the row groups' blocks
  if (t < FBT_GROUPS) ready[t] = 0;
  cluster.sync();
  if (rank == 0 && w == 0) {
    // Window j -> group u = j mod FBT_UNITS: block 1 + u mod blocks, group
    // u / blocks there; it is that group's (j / FBT_UNITS)-th window.
    fbt_chain_lanes(base, table, windows, c, lane, F, [&](int j) {
      if (lane == 0) {
        const int u = j % FBT_UNITS;
        unsigned* flag = cluster.map_shared_rank(&ready[u / blocks],
                                                 (unsigned)(1 + u % blocks));
        st_release_cluster(flag, (unsigned)(j / FBT_UNITS + 1));
      }
    });
  } else if (rank >= 1 && w >= 1) {
    const int g = (w - 1) / 2, gt = t - 32 - g * FBT_GROUP_THREADS;
    const int u = (rank - 1) + g * blocks;
    const int64_t m = (int64_t)windows << c;
#pragma unroll 1
    for (int j = u, k = 1; j < windows; j += FBT_UNITS, k++) {
      while (ld_acquire_cluster(&ready[g]) < (unsigned)k) __nanosleep(100);
      if (gt == 0) fbt_identity((int64_t)j, table, windows, c, F);
      G1J<NL> step;
      g1_load(step, table, m, ((int64_t)j << c) + 1);
#pragma unroll 1
      for (int count = 2; count < (1 << c); count <<= 1) {
        g1_double_lanes(step, lane, F);
        group_sync(g);  // the entries below count are stored
        fbt_level_adds((int64_t)j, count, step, gt, FBT_GROUP_THREADS, table,
                       windows, c, F);
      }
    }
  }
  cluster.sync();  // no block leaves while the chain may write its ready
}

template <int NL>
int launch_table(const void* base, void* table, int windows, int c,
                 const void* consts, void* stream) {
  auto kernel = k_g1_fixed_base_table<NL>;
  // FBT_CLUSTER = 16 is past the portable cluster size of 8.
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = FBT_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(FBT_CLUSTER);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, kernel, (const uint32_t*)base,
                          (uint32_t*)table, windows, c,
                          consts_of<NL>(consts));
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

}  // namespace

// base (3, NL, 1) -> table (3, NL, windows 2^c), 1 <= windows <= 512, 1 <=
// c <= 16.
extern "C" int kzg_g1_fixed_base_table(const void* base, void* table,
                                       int windows, int c, const void* consts,
                                       void* stream) {
  if (windows < 1 || windows > kMaxWindows || c < 1 || c > 16)
    return (int)cudaErrorInvalidValue;
  return KZG_BY_LIMBS(consts, launch_table, base, table, windows, c, consts,
                      stream);
}
