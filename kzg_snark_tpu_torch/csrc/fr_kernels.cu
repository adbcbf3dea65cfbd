// K1 replacement: elementwise Montgomery product, plus the add and sub
// entry points the field backend routes through the card.
//
// Replaces kzg_snark_tpu/ops/pallas_fr.py:_mul_call (fused_mul), which ran
// the iNTT n^-1 scale and the coset shifts; on this port every field mul,
// square, add, sub and neg on a CUDA tensor comes here.
//
// What bounds it on the H100: an 8-word mul reads 64 bytes and writes 32 per
// element and does 64 32x32->64 multiply-adds for the product plus 64 for
// the reduction, about 2 integer ops per byte: memory-bound at large n
// until the CIOS loop's dependent carries limit issue rate; a 12-word mul
// (BLS12-381 Fq) does 2.25 times the products on 1.5 times the bytes.
// add/sub are memory-bound.  Design: one thread per element, limb-major
// (NL, n) words so each warp's loads of one limb are one coalesced 128-byte
// line; operands may broadcast one element (column step 0), which saves
// materialising the scalar operand of the many scalar-times-vector
// products.  Instantiated at NL = 8 and 12; the entry points take the limb
// count from the consts block.
#include <cuda_runtime.h>
#include <string.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

template <int OP, int NL>
__global__ void k_fr_ewise(const uint32_t* __restrict__ a, int64_t lda,
                           int64_t inca, const uint32_t* __restrict__ b,
                           int64_t ldb, int64_t incb,
                           uint32_t* __restrict__ out, int64_t n,
                           FieldConsts<NL> F) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe_ewise_thread<OP>(i, a, lda, inca, b, ldb, incb, out, n, F);
}

template <int NL, int OP>
int launch_ewise(const void* a, int64_t lda, int64_t inca, const void* b,
                 int64_t ldb, int64_t incb, void* out, int64_t n,
                 const void* consts, void* stream) {
  if (n <= 0) return 0;
  const FieldConsts<NL> F = consts_of<NL>(consts);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  k_fr_ewise<OP, NL><<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)a, lda, inca, (const uint32_t*)b, ldb, incb,
      (uint32_t*)out, n, F);
  return (int)cudaGetLastError();
}

template <int NL>
int launch_mul(const void* a, int64_t lda, int64_t inca, const void* b,
               int64_t ldb, int64_t incb, void* out, int64_t n,
               const void* consts, void* stream) {
  return launch_ewise<NL, FE_OP_MUL>(a, lda, inca, b, ldb, incb, out, n,
                                     consts, stream);
}

template <int NL>
int launch_add(const void* a, int64_t lda, int64_t inca, const void* b,
               int64_t ldb, int64_t incb, void* out, int64_t n,
               const void* consts, void* stream) {
  return launch_ewise<NL, FE_OP_ADD>(a, lda, inca, b, ldb, incb, out, n,
                                     consts, stream);
}

template <int NL>
int launch_sub(const void* a, int64_t lda, int64_t inca, const void* b,
               int64_t ldb, int64_t incb, void* out, int64_t n,
               const void* consts, void* stream) {
  return launch_ewise<NL, FE_OP_SUB>(a, lda, inca, b, ldb, incb, out, n,
                                     consts, stream);
}

}  // namespace

extern "C" int kzg_fr_mul(const void* a, int64_t lda, int64_t inca,
                          const void* b, int64_t ldb, int64_t incb, void* out,
                          int64_t n, const void* consts, void* stream) {
  return KZG_BY_LIMBS(consts, launch_mul, a, lda, inca, b, ldb, incb, out, n,
                      consts, stream);
}

extern "C" int kzg_fr_add(const void* a, int64_t lda, int64_t inca,
                          const void* b, int64_t ldb, int64_t incb, void* out,
                          int64_t n, const void* consts, void* stream) {
  return KZG_BY_LIMBS(consts, launch_add, a, lda, inca, b, ldb, incb, out, n,
                      consts, stream);
}

extern "C" int kzg_fr_sub(const void* a, int64_t lda, int64_t inca,
                          const void* b, int64_t ldb, int64_t incb, void* out,
                          int64_t n, const void* consts, void* stream) {
  return KZG_BY_LIMBS(consts, launch_sub, a, lda, inca, b, ldb, incb, out, n,
                      consts, stream);
}
