// CPU build of the kernels' thread bodies (g++ only, never nvcc).
//
// Each entry loops over the thread indices a launch would cover and calls
// the same __host__ __device__ body the CUDA kernel calls, so the tests on
// a machine without a card check the kernels' arithmetic and indexing
// against the plain PyTorch versions.  Each entry is a template on the limb
// count NL (impl_*), instantiated at 8 and 12 words and chosen by the consts
// block's limb count, as the CUDA entry points choose theirs (the NTT's at 8
// words only: its field is Fr).
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "msm.cuh"
#include "msm_chunks.cuh"
#include "ntt.cuh"
#include "scan.cuh"
#include "srs.cuh"

template <int NL>
static int impl_fr_ewise(int op, const void* a, int64_t lda, int64_t inca,
                         const void* b, int64_t ldb, int64_t incb,
                         void* out, int64_t n, const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  const uint32_t* x = (const uint32_t*)a;
  const uint32_t* y = (const uint32_t*)b;
  uint32_t* o = (uint32_t*)out;
  for (int64_t i = 0; i < n; i++) {
    if (op == FE_OP_MUL) {
      fe_ewise_thread<FE_OP_MUL>(i, x, lda, inca, y, ldb, incb, o, n, F);
    } else if (op == FE_OP_ADD) {
      fe_ewise_thread<FE_OP_ADD>(i, x, lda, inca, y, ldb, incb, o, n, F);
    } else {
      fe_ewise_thread<FE_OP_SUB>(i, x, lda, inca, y, ldb, incb, o, n, F);
    }
  }
  return 0;
}

// The carry-chain product (square = 0) or squaring (square = 1) of
// chain.cuh, as its C++ mirror: (NL, n) dense operands.
template <int NL>
static int impl_fe_chain(int square, const void* a, const void* b, void* out,
                         int64_t n, const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  for (int64_t i = 0; i < n; i++) {
    uint32_t x[NL], y[NL], r[NL];
    fe_load<NL>(x, (const uint32_t*)a, n, i);
    fe_load<NL>(y, (const uint32_t*)b, n, i);
    if (square) {
      fe_sqr_chain(r, x, F);
    } else {
      fe_mul_chain(r, x, y, F);
    }
    fe_store<NL>((uint32_t*)out, n, i, r);
  }
  return 0;
}

template <int NL>
static int impl_g1_add(const void* p, const void* q, void* out, int64_t m,
                       const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  for (int64_t i = 0; i < m; i++)
    g1_add_thread(i, (const uint32_t*)p, (const uint32_t*)q,
                              (uint32_t*)out, m, F);
  return 0;
}

template <int NL>
static int impl_g1_double(const void* p, void* out, int64_t m,
                          const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  for (int64_t i = 0; i < m; i++)
    g1_double_thread(i, (const uint32_t*)p, (uint32_t*)out, m, F);
  return 0;
}

template <int NL>
static int impl_g1_add_mixed(const void* p, const void* qx, const void* qy,
                             int64_t qn, void* out, int64_t m,
                             const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  for (int64_t i = 0; i < m; i++)
    g1_add_mixed_thread(i, (const uint32_t*)p,
                                    (const uint32_t*)qx, (const uint32_t*)qy,
                                    qn, (uint32_t*)out, m, F);
  return 0;
}

// The ladder launch: block after block, every thread's ladder, then (tree)
// the block's halving tree level after level in the kernel's order.
template <int NL>
static int impl_g1_ladder(const void* pts, const void* scalars, int S,
                          int64_t sp, void* out, int64_t n, int64_t sets,
                          int tree, const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  const uint32_t* p = (const uint32_t*)pts;
  const uint32_t* s = (const uint32_t*)scalars;
  G1J<NL>* sh = new G1J<NL>[n];
  for (int64_t j = 0; j < sets; j++) {
    for (int64_t i = 0; i < n; i++)
      g1_ladder_thread(sh[i], p, n, i, s + j * S * sp + (sp == 1 ? 0 : i), sp,
                       S, F);
    if (!tree) {
      for (int64_t i = 0; i < n; i++)
        g1_store((uint32_t*)out, sets * n, j * n + i, sh[i]);
      continue;
    }
    for (int m = (int)n; m > 1; m = (m + 1) / 2)
      for (int t = 0; t < m; t++) g1_tree_pair(sh, m, t, F);
    g1_store((uint32_t*)out, sets, j, sh[0]);
  }
  delete[] sh;
  return 0;
}

template <int NL>
static int impl_fr_butterfly(const void* xl, const void* xu, const void* tw,
                             const void* mask, void* out, int64_t n,
                             const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  for (int64_t i = 0; i < n; i++)
    fr_butterfly_thread(i, (const uint32_t*)xl, (const uint32_t*)xu,
                        (const uint32_t*)tw, (const int32_t*)mask,
                        (uint32_t*)out, n, F);
  return 0;
}

extern "C" int host_ntt_tile(int log_n) { return ntt_tile_bits(log_n); }

// One pass as k_ntt_pass runs it, block after block: the tile and every
// stage's twiddles loaded, the stages in radix-4 pairs (a radix-2 stage
// last when g is odd), the tile stored.  y may be x.  Any tile_bits >= g,
// so the tests can take tiny tiles.
template <int NL>
static int impl_ntt_pass(const void* x, void* y, const void* tw, int64_t n,
                         int s0, int g, int tile_bits,
                         const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  NttPass P = ntt_pass_geometry(n, s0, g, tile_bits);
  const int E = 1 << P.ebits;
  uint32_t* xs = new uint32_t[NL * E];
  uint32_t* ws = new uint32_t[NL * E];
  for (int64_t b = 0; b < P.blocks; b++) {
    for (int idx = 0; idx < NL * E; idx++)
      xs[idx] = ((const uint32_t*)x)[ntt_pass_word(P, b, idx)];
    for (int s = s0; s < s0 + g; s++)
      for (int idx = 0; idx < (NL << (P.lcb + s - s0)); idx++) {
        int dst;
        int64_t src = ntt_pass_tw_word(P, b, s, idx, &dst);
        ws[dst] = ((const uint32_t*)tw)[src];
      }
    int s = s0;
    for (; s + 1 < s0 + g; s += 2)
      for (int j = 0; j < E / 4; j++) ntt_pass_radix4(P, s, xs, ws, j, F);
    if (s < s0 + g)
      for (int j = 0; j < E / 2; j++) ntt_pass_radix2(P, s, xs, ws, j, F);
    for (int idx = 0; idx < NL * E; idx++)
      ((uint32_t*)y)[ntt_pass_word(P, b, idx)] = xs[idx];
  }
  delete[] xs;
  delete[] ws;
  return 0;
}

// The table kernel in its order: the chain on the lanes (a level's
// products one after another, msm.cuh lanes_level), then each row group's
// windows (j = u, u + U, ...; U the library launch's groups) level by
// level: the step doubled on the lanes, then the group's threads' adds in
// thread order.
template <int NL>
static int impl_g1_fixed_base_table(const void* base, void* table,
                                    int windows, int c,
                                    const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  uint32_t* T = (uint32_t*)table;
  const int64_t m = (int64_t)windows << c;
  const int units = FBT_UNITS;
  fbt_chain_lanes((const uint32_t*)base, T, windows, c, 0, F, [](int) {});
  for (int u = 0; u < units; u++) {
    for (int j = u; j < windows; j += units) {
      fbt_identity((int64_t)j, T, windows, c, F);
      G1J<NL> step;
      g1_load(step, T, m, ((int64_t)j << c) + 1);
      for (int count = 2; count < (1 << c); count <<= 1) {
        g1_double_lanes(step, 0, F);
        for (int t = 0; t < FBT_GROUP_THREADS; t++)
          fbt_level_adds((int64_t)j, count, step, t, FBT_GROUP_THREADS, T,
                         windows, c, F);
      }
    }
  }
  return 0;
}

template <int NL>
static int impl_msm_accumulate(const void* xy, const void* entries,
                               const void* chunk_off, const void* run_chunks,
                               int64_t threads, int64_t chunks,
                               void* partials, int complete,
                               const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  for (int64_t r = 0; r < threads; r++) {
    if (complete) {
      msm_accumulate_thread<true>(r, (const uint32_t*)xy,
                                  (const int32_t*)entries,
                                  (const int32_t*)chunk_off,
                                  (const int32_t*)run_chunks,
                                  (uint32_t*)partials, chunks, F);
    } else {
      msm_accumulate_thread<false>(r, (const uint32_t*)xy,
                                   (const int32_t*)entries,
                                   (const int32_t*)chunk_off,
                                   (const int32_t*)run_chunks,
                                   (uint32_t*)partials, chunks, F);
    }
  }
  return 0;
}

// The window-sum launch: every block's threads, then its shared-memory tree
// in the kernel's order (thread t < s takes t + s, s halving).
template <int NL>
static int impl_msm_window_sums(const void* partials, int64_t chunks,
                                const void* bco, int64_t windows,
                                int64_t half, int c, int64_t tpw,
                                void* wparts, const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  int64_t threads = tpw < 128 ? tpw : 128;
  int64_t pieces = tpw / threads;
  int64_t blocks = windows * pieces;
  G1J<NL>* sh = new G1J<NL>[threads];
  for (int64_t blk = 0; blk < blocks; blk++) {
    int64_t wi = blk / pieces;
    for (int64_t t = 0; t < threads; t++)
      msm_window_piece(sh[t], wi, (blk % pieces) * threads + t, tpw,
                       (const uint32_t*)partials, chunks,
                       (const int32_t*)bco, half, c, F);
    for (int64_t s = threads / 2; s > 0; s >>= 1)
      for (int64_t t = 0; t < s; t++) msm_block_tree_step(sh, t, s, F);
    g1_store((uint32_t*)wparts, blocks, blk, sh[0]);
  }
  delete[] sh;
  return 0;
}

// The fold launch: each set's block partials, the window totals' tree level
// by level, then the Horner fold, whose lane-level products the host runs
// one after another (msm.cuh lanes_level).
template <int NL>
static int impl_msm_horner(const void* wparts, int64_t sets, int windows,
                           int pieces, int c, void* out,
                           const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  const int per = windows * pieces;
  G1J<NL>* S = new G1J<NL>[per];
  int64_t m = sets * per;
  for (int64_t s = 0; s < sets; s++) {
    for (int i = 0; i < per; i++)
      g1_load(S[i], (const uint32_t*)wparts, m, s * per + i);
    for (int k = pieces; k > 1; k = (k + 1) / 2)
      for (int i = 0; i < windows * (k / 2); i++)
        msm_total_pair(S, pieces, k, i, F);
    G1J<NL> acc;
    msm_horner(acc, S, windows, pieces, c, 0, F);
    g1_store((uint32_t*)out, sets, s, acc);
  }
  delete[] S;
  return 0;
}

// The single-pass scan (k_scan), block by block, on the state `state`
// (scan_state_words(n) words, zero on entry and, as the kernel leaves it,
// on return).  Each block's tile is folded and its outputs written by one
// loop (the kernel's shared-memory and shuffle steps are its own; the
// element indexing, tiling, operation, publication and look-back positions
// are the same code).  Schedules: 0, the blocks one after another in
// ticket order (each look-back finds its predecessor's inclusive prefix);
// 1, every block publishes its aggregate before any looks back, and the
// look-backs run from the last tile down (each reads aggregates, `window`
// positions a step, down to tile 0's prefix).  A total alone (out null)
// takes the kernel's other path: no look-back, the last block done folds
// every tile's aggregate.
template <int OP, int NL>
static void host_lookback(uint32_t* state, int64_t tile, int window,
                          uint32_t pre[NL], const FieldConsts<NL>& F) {
  scan_identity<OP>(pre, F);
  for (int64_t hi = tile - 1; hi >= 0; hi -= window) {
    int first = window;
    for (int pos = window - 1; pos >= 0; pos--) {
      const int64_t tt = hi - pos;
      if (tt >= 0 && scan_rec(state, tt)[0] == SCAN_FLAG_INCL) first = pos;
      if (tt >= 0 && scan_rec(state, tt)[0] == SCAN_FLAG_NONE) abort();
    }
    uint32_t win[NL], v[NL];
    scan_identity<OP>(win, F);
    for (int pos = 0; pos < window; pos++) {
      scan_lookback_value<OP>(v, state, hi - pos, pos, first, F);
      scan_op<OP>(win, win, v, F);
    }
    scan_op<OP>(pre, win, pre, F);
    if (first < window) break;
  }
}

template <int OP, int NL>
static void host_scan(const uint32_t* a, int64_t ld, int64_t inc, int64_t n,
                      bool reverse, uint32_t* out, uint32_t* total,
                      uint32_t* state, int schedule, int window,
                      const FieldConsts<NL>& F) {
  const int64_t tiles = scan_tiles(n);
  uint32_t* agg = new uint32_t[NL * tiles];
  uint32_t x[NL], pre[NL], run[NL];
  auto fold = [&](int64_t tile) {
    scan_identity<OP>(run, F);
    for (int64_t e = 0; e < SCAN_TILE; e++) {
      scan_load<OP>(x, a, ld, inc, tile * SCAN_TILE + e, n, reverse, F);
      scan_op<OP>(run, run, x, F);
    }
  };
  if (out == nullptr) {  // a total alone: the last block folds every tile's
    for (int64_t tile = 0; tile < tiles; tile++) {
      if (state[0]++ != (uint32_t)tile) abort();  // the ticket
      fold(tile);
      scan_put_aggregate<NL>(state, tile, run);
      if (state[1]++ != (uint32_t)(tiles - 1)) continue;
      scan_identity<OP>(run, F);
      for (int64_t i = 0; i < tiles; i++)
        scan_op<OP>(run, run, scan_rec(state, i) + 1, F);
      if (total != nullptr) fe_store<NL>(total, 1, 0, run);
      scan_state_reset(state, tiles);
    }
    delete[] agg;
    return;
  }
  auto aggregate = [&](int64_t tile) {
    fold(tile);
    fe_store<NL>(agg, tiles, tile, run);
    scan_publish<NL>(state, tile, tile == 0 ? SCAN_FLAG_INCL : SCAN_FLAG_AGG,
                     run);
  };
  auto finish = [&](int64_t tile) {
    host_lookback<OP, NL>(state, tile, window, pre, F);
    fe_load<NL>(x, agg, tiles, tile);
    scan_op<OP>(run, pre, x, F);
    if (tile > 0) scan_publish<NL>(state, tile, SCAN_FLAG_INCL, run);
    if (tile == tiles - 1 && total != nullptr) fe_store<NL>(total, 1, 0, run);
    for (int64_t e = 0; e < SCAN_TILE; e++) {
      const int64_t l = tile * SCAN_TILE + e;
      scan_load<OP>(x, a, ld, inc, l, n, reverse, F);
      if (l < n) fe_store<NL>(out, n, scan_col(l, n, reverse), pre);
      scan_op<OP>(pre, pre, x, F);
    }
    if (state[1]++ == (uint32_t)(tiles - 1)) scan_state_reset(state, tiles);
  };
  for (int64_t tile = 0; tile < tiles; tile++) {
    if (state[0]++ != (uint32_t)tile) abort();  // the ticket
    aggregate(tile);
    if (schedule == 0) finish(tile);
  }
  if (schedule == 1)
    for (int64_t tile = tiles - 1; tile >= 0; tile--) finish(tile);
  delete[] agg;
}

extern "C" int host_scan_tile() { return SCAN_TILE; }

extern "C" int64_t host_scan_state_words(int64_t n) {
  return scan_state_words(n);
}

template <int NL>
static int impl_fr_scan(int op, const void* a, int64_t ld, int64_t inc,
                        int64_t n, int reverse, void* out, void* total,
                        void* state, int schedule, int window,
                        const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  if (op == SCAN_OP_MUL) {
    host_scan<SCAN_OP_MUL, NL>((const uint32_t*)a, ld, inc, n, reverse != 0,
                               (uint32_t*)out, (uint32_t*)total,
                               (uint32_t*)state, schedule, window, F);
  } else {
    host_scan<SCAN_OP_ADD, NL>((const uint32_t*)a, ld, inc, n, reverse != 0,
                               (uint32_t*)out, (uint32_t*)total,
                               (uint32_t*)state, schedule, window, F);
  }
  return 0;
}

// The inversion route's tile as k_fr_inv runs it: each thread's 4 elements
// (one past n, zeros as one) up the pair tree, the butterflies across each
// warp's lanes and across the warp totals level by level, the tile total
// inverted (safegcd and the R^3 product), then down the trees.
template <int NL>
static void host_inv_tile(const uint32_t* a, uint32_t* out, int64_t n,
                          int64_t base, const InvConsts<NL>& I,
                          const FieldConsts<NL>& F) {
  constexpr int T = SCAN_THREADS, W = SCAN_THREADS / 32;
  static uint32_t c[T][4][NL], p01[T][NL], p23[T][NL], acc[T][NL],
      oth[T][NL], y[T][NL];
  unsigned zero[T];
  for (int t = 0; t < T; t++) {
    zero[t] = 0;
    for (int j = 0; j < 4; j++) {
      const int64_t l = base + t * SCAN_PER + j;
      if (l < n) {
        fe_load<NL>(c[t][j], a, n, l);
      } else {
        fe_copy<NL>(c[t][j], F.one);
      }
      zero[t] |= (unsigned)inv_zero_as_one(c[t][j], F) << j;
    }
    inv_chunk_up(c[t][0], c[t][1], c[t][2], c[t][3], p01[t], p23[t], acc[t],
                 F);
    fe_copy<NL>(oth[t], F.one);
  }
  for (int d = 1; d < 32; d <<= 1) {
    for (int t = 0; t < T; t++) fe_copy<NL>(y[t], acc[t ^ d]);
    for (int t = 0; t < T; t++) inv_others_step(acc[t], oth[t], y[t], F);
  }
  uint32_t wacc[32][NL], woth[32][NL], wy[32][NL];
  for (int l = 0; l < 32; l++) {
    fe_copy<NL>(wacc[l], l < W ? acc[32 * l] : F.one);
    fe_copy<NL>(woth[l], F.one);
  }
  for (int d = 1; d < W; d <<= 1) {
    for (int l = 0; l < 32; l++) fe_copy<NL>(wy[l], wacc[l ^ d]);
    for (int l = 0; l < 32; l++) inv_others_step(wacc[l], woth[l], wy[l], F);
  }
  uint32_t itile[NL];
  fe_inv_mont(itile, wacc[0], F, I);
  for (int l = 0; l < W; l++) fe_mul_chain(woth[l], woth[l], itile, F);
  for (int t = 0; t < T; t++) {
    uint32_t itot[NL];
    fe_mul_chain(itot, oth[t], woth[t >> 5], F);
    inv_chunk_down(c[t][0], c[t][1], c[t][2], c[t][3], p01[t], p23[t], itot,
                   zero[t], F);
    for (int j = 0; j < 4; j++) {
      const int64_t l = base + t * SCAN_PER + j;
      if (l < n) fe_store<NL>(out, n, l, c[t][j]);
    }
  }
}

// fr_pow by its route: the inversion's tiles when the exponent is p - 2,
// else every thread's square-and-multiply.
template <int NL>
static int impl_fr_pow(const void* a, int64_t n, const void* exponent,
                       int nbits, const void* inv_consts, void* out,
                       const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  const uint32_t* e = (const uint32_t*)exponent;
  if (pow_is_inversion<NL>(e, F)) {
    InvConsts<NL> I;
    memcpy(&I, inv_consts, sizeof(I));
    for (int64_t b = 0; b < scan_tiles(n); b++)
      host_inv_tile<NL>((const uint32_t*)a, (uint32_t*)out, n,
                        b * SCAN_TILE, I, F);
    return 0;
  }
  for (int64_t i = 0; i < n; i++)
    fe_pow_thread(i, (const uint32_t*)a, (uint32_t*)out, n, e, nbits, F);
  return 0;
}

// The safegcd alone: out[i] = a[i]^-1 mod p on plain integers (0 -> 0).
template <int NL>
static int impl_fe_inv(const void* a, void* out, int64_t n, uint32_t pinv30,
                       const void* consts) {
  const FieldConsts<NL> F = consts_of<NL>(consts);
  for (int64_t i = 0; i < n; i++) {
    uint32_t x[NL];
    fe_load<NL>(x, (const uint32_t*)a, n, i);
    fe_inv_raw<NL>(x, x, F, pinv30);
    fe_store<NL>((uint32_t*)out, n, i, x);
  }
  return 0;
}

template <int NL>
static int impl_pow_route(const void* exponent, const void* consts) {
  return pow_is_inversion<NL>((const uint32_t*)exponent,
                              consts_of<NL>(consts));
}

// The entries, each dispatching on the consts block's limb count.

extern "C" int host_fr_ewise(int op, const void* a, int64_t lda, int64_t inca,
                             const void* b, int64_t ldb, int64_t incb,
                             void* out, int64_t n, const void* consts) {
  return KZG_BY_LIMBS(consts, impl_fr_ewise, op, a, lda, inca, b, ldb, incb,
                      out, n, consts);
}

extern "C" int host_fe_chain(int square, const void* a, const void* b,
                             void* out, int64_t n, const void* consts) {
  return KZG_BY_LIMBS(consts, impl_fe_chain, square, a, b, out, n, consts);
}

extern "C" int host_g1_add(const void* p, const void* q, void* out, int64_t m,
                           const void* consts) {
  return KZG_BY_LIMBS(consts, impl_g1_add, p, q, out, m, consts);
}

extern "C" int host_g1_double(const void* p, void* out, int64_t m,
                              const void* consts) {
  return KZG_BY_LIMBS(consts, impl_g1_double, p, out, m, consts);
}

extern "C" int host_g1_add_mixed(const void* p, const void* qx, const void* qy,
                                 int64_t qn, void* out, int64_t m,
                                 const void* consts) {
  return KZG_BY_LIMBS(consts, impl_g1_add_mixed, p, qx, qy, qn, out, m, consts);
}

extern "C" int host_g1_ladder(const void* pts, const void* scalars, int S,
                              int64_t sp, void* out, int64_t n, int64_t sets,
                              int tree, const void* consts) {
  return KZG_BY_LIMBS(consts, impl_g1_ladder, pts, scalars, S, sp, out, n,
                      sets, tree, consts);
}

extern "C" int host_fr_butterfly(const void* xl, const void* xu, const void* tw,
                                 const void* mask, void* out, int64_t n,
                                 const void* consts) {
  if (consts_limbs(consts) != 8) return KZG_BAD_LIMBS;
  return impl_fr_butterfly<8>(xl, xu, tw, mask, out, n, consts);
}

extern "C" int host_ntt_pass(const void* x, void* y, const void* tw, int64_t n,
                             int s0, int g, int tile_bits,
                             const void* consts) {
  if (consts_limbs(consts) != 8) return KZG_BAD_LIMBS;
  return impl_ntt_pass<8>(x, y, tw, n, s0, g, tile_bits, consts);
}

extern "C" int host_g1_fixed_base_table(const void* base, void* table,
                                        int windows, int c,
                                        const void* consts) {
  return KZG_BY_LIMBS(consts, impl_g1_fixed_base_table, base, table, windows, c,
                      consts);
}

extern "C" int host_msm_accumulate(const void* xy, const void* entries,
                                   const void* chunk_off,
                                   const void* run_chunks, int64_t threads,
                                   int64_t chunks, void* partials,
                                   int complete, const void* consts) {
  return KZG_BY_LIMBS(consts, impl_msm_accumulate, xy, entries, chunk_off,
                      run_chunks, threads, chunks, partials, complete,
                      consts);
}

// kzg_msm_bucket_offsets' last three steps on the E sorted keys, a bucket
// at a time in the kernels' order: the buckets' runs, each segment's chunk
// scan (msm_chunks.cuh's counts), the segments' scan and the busiest, then
// each bucket's chunk offsets (and run starts and chunk-start bits in the
// E payloads pay) and the tails.  bco (S half + 1), chunk_off (C + 1),
// run_chunks (ceil(E / run) + 1 where run > 0), info (C, the busiest
// window's chunks, E).
extern "C" int host_msm_bucket_offsets(const void* keys, int64_t E,
                                       int64_t segments, int64_t half,
                                       int chunk, int run, void* bco,
                                       void* chunk_off, void* run_chunks,
                                       void* pay, void* info) {
  const int32_t* k = (const int32_t*)keys;
  int32_t* b = (int32_t*)bco;
  int32_t* out = (int32_t*)info;
  const int64_t nb = segments * half;
  int32_t* start = (int32_t*)calloc(2 * nb + segments + 1, sizeof(int32_t));
  if (!start) return -1;
  int32_t* end = start + nb;
  int32_t* cbase = end + nb;
  int32_t* entries = (int32_t*)pay;
  for (int64_t p = 0; p < E; p++) {
    const bool first = p == 0 || k[p - 1] != k[p];
    if (first) start[k[p]] = (int32_t)p;
    if (p + 1 == E || k[p + 1] != k[p]) end[k[p]] = (int32_t)(p + 1);
    if (run && msm_range_chunk_start(p, first, run))
      entries[p] = (int32_t)((uint32_t)entries[p] | MSM_CHUNK_START);
  }
  int32_t most = 0;
  for (int64_t s = 0; s < segments; s++) {
    int32_t total = 0;
    for (int64_t m = 0; m < half; m++) {
      const int64_t q = s * half + m;
      b[q] = total;
      total += msm_bucket_chunk_count(start[q], end[q], chunk, run);
    }
    cbase[s + 1] = cbase[s] + total;
    most = total > most ? total : most;
  }
  for (int64_t q = 0; q < nb; q++) {
    b[q] += cbase[q / half];
    msm_bucket_chunk_offsets(start[q], end[q], chunk, run, b[q],
                             (int32_t*)chunk_off, (int32_t*)run_chunks);
  }
  const int32_t C = cbase[segments];
  b[nb] = C;
  ((int32_t*)chunk_off)[C] = (int32_t)E;
  if (run) ((int32_t*)run_chunks)[(E + run - 1) / run] = C;
  out[0] = C;
  out[1] = most;
  out[2] = (int32_t)E;
  free(start);
  return 0;
}

extern "C" int host_msm_window_sums(const void* partials, int64_t chunks,
                                    const void* bco, int64_t windows,
                                    int64_t half, int c, int64_t tpw,
                                    void* wparts, const void* consts) {
  return KZG_BY_LIMBS(consts, impl_msm_window_sums, partials, chunks, bco,
                      windows, half, c, tpw, wparts, consts);
}

extern "C" int host_msm_horner(const void* wparts, int64_t sets, int windows,
                               int pieces, int c, void* out,
                               const void* consts) {
  return KZG_BY_LIMBS(consts, impl_msm_horner, wparts, sets, windows, pieces, c,
                      out, consts);
}

// The scan on the caller's state (scan_state_words(n) words, zero) in the
// given schedule (host_scan) with look-back steps of `window` tiles (the
// kernel's: SCAN_WINDOW); the state is left as the kernel leaves it.
extern "C" int host_fr_scan_state(int op, const void* a, int64_t ld,
                                  int64_t inc, int64_t n, int reverse,
                                  void* out, void* total, void* state,
                                  int schedule, int window,
                                  const void* consts) {
  return KZG_BY_LIMBS(consts, impl_fr_scan, op, a, ld, inc, n, reverse, out,
                      total, state, schedule, window, consts);
}

extern "C" int host_scan_window() { return SCAN_WINDOW; }

extern "C" int host_fr_pow(const void* a, int64_t n, const void* exponent,
                           int nbits, const void* inv_consts, void* out,
                           const void* consts) {
  return KZG_BY_LIMBS(consts, impl_fr_pow, a, n, exponent, nbits, inv_consts,
                      out, consts);
}

extern "C" int host_fe_inv(const void* a, void* out, int64_t n,
                           uint32_t pinv30, const void* consts) {
  return KZG_BY_LIMBS(consts, impl_fe_inv, a, out, n, pinv30, consts);
}

// 1 if fr_pow takes the inversion route for this exponent, else 0.
extern "C" int host_pow_route(const void* exponent, const void* consts) {
  return KZG_BY_LIMBS(consts, impl_pow_route, exponent, consts);
}
