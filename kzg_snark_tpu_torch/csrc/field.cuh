// Montgomery arithmetic over NL x 32-bit limbs (R = 2^(32 NL)), generic over
// the limb count: NL = 8 for BN254 Fr and Fq and BLS12-381 Fr (R = 2^256),
// NL = 12 for BLS12-381 Fq (R = 2^384).
//
// Counterpart of kzg_snark_tpu/ops/regfield.py (RegField): the same canonical
// values in and out (every op takes and returns elements < p), the same
// Montgomery form (R = 2^256 or 2^384, so the integers equal the JAX
// package's 16 x 16-bit or 24 x 16-bit limb form).  The functions are
// __host__ __device__: nvcc builds them into the kernels, and g++ builds them
// into a CPU library that the tests use to check this very code against the
// plain PyTorch versions.  Every function is a template on NL; the kernels
// are instantiated at both widths in one library, and each C entry point
// takes the limb count from the consts block (KZG_BY_LIMBS).
//
// The modulus must satisfy p < 2^(32 NL - 1) (fe_add's sum of two elements
// never carries out of NL words); BLS12-381 Fr (255 bits) is the widest
// 8-word modulus.
//
// Layout in device memory: an (NL, n) array of uint32 words, limb-major (limb
// k of element i at k * ld + i), least significant limb first.  Neighbouring
// threads read neighbouring words.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define KZG_HD static __host__ __device__ __forceinline__
#else
#define KZG_HD static inline
#endif

// Field constants, passed to every kernel by value.
template <int NL>
struct FieldConsts {
  uint32_t p[NL];    // modulus
  uint32_t one[NL];  // R mod p: Montgomery one
  uint32_t pinv;     // -p^{-1} mod 2^32
};

// The consts block a C entry point takes (ops/limbs.py FieldConsts.ptr):
// word 0 is the limb count NL, then the words of FieldConsts<NL>.
static inline int consts_limbs(const void* block) {
  return (int)((const uint32_t*)block)[0];
}

template <int NL>
static inline FieldConsts<NL> consts_of(const void* block) {
  FieldConsts<NL> F;
  memcpy(&F, (const uint32_t*)block + 1, sizeof(F));
  return F;
}

// fn<8>(...) or fn<12>(...) by the consts block's limb count; other counts
// return KZG_BAD_LIMBS.
#define KZG_BAD_LIMBS (-1)
#define KZG_BY_LIMBS(consts, fn, ...)                     \
  (consts_limbs(consts) == 8    ? fn<8>(__VA_ARGS__)      \
   : consts_limbs(consts) == 12 ? fn<12>(__VA_ARGS__)     \
                                : KZG_BAD_LIMBS)

template <int NL>
KZG_HD void fe_copy(uint32_t r[NL], const uint32_t a[NL]) {
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = a[i];
}

template <int NL>
KZG_HD void fe_select(uint32_t r[NL], bool c, const uint32_t a[NL],
                      const uint32_t b[NL]) {
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = c ? a[i] : b[i];
}

template <int NL>
KZG_HD bool fe_is_zero(const uint32_t a[NL]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) acc |= a[i];
  return acc == 0;
}

template <int NL>
KZG_HD void fe_load(uint32_t r[NL], const uint32_t* base, int64_t ld,
                    int64_t i) {
#pragma unroll
  for (int k = 0; k < NL; k++) r[k] = base[k * ld + i];
}

template <int NL>
KZG_HD void fe_store(uint32_t* base, int64_t ld, int64_t i,
                     const uint32_t a[NL]) {
#pragma unroll
  for (int k = 0; k < NL; k++) base[k * ld + i] = a[k];
}

// r = a - b mod 2^(32 NL); returns the borrow (0 or 1).  r may alias a or b.
template <int NL>
KZG_HD uint32_t fe_sub_raw(uint32_t r[NL], const uint32_t a[NL],
                           const uint32_t b[NL]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t d = (uint64_t)a[i] - b[i] - borrow;
    r[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

// r = a + b mod 2^(32 NL); returns the carry (0 or 1).  r may alias a or b.
template <int NL>
KZG_HD uint32_t fe_add_raw(uint32_t r[NL], const uint32_t a[NL],
                           const uint32_t b[NL]) {
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t s = (uint64_t)a[i] + b[i] + carry;
    r[i] = (uint32_t)s;
    carry = s >> 32;
  }
  return (uint32_t)carry;
}

// (a + b) mod p.  p < 2^(32 NL - 1), so a + b never carries out of NL words.
template <int NL>
KZG_HD void fe_add(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL],
                   const FieldConsts<NL>& F) {
  uint32_t s[NL], d[NL];
  fe_add_raw<NL>(s, a, b);
  uint32_t borrow = fe_sub_raw<NL>(d, s, F.p);
  fe_select<NL>(r, borrow != 0, s, d);
}

// (a - b) mod p.
template <int NL>
KZG_HD void fe_sub(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL],
                   const FieldConsts<NL>& F) {
  uint32_t d[NL], c[NL];
  uint32_t borrow = fe_sub_raw<NL>(d, a, b);
  fe_add_raw<NL>(c, d, F.p);
  fe_select<NL>(r, borrow != 0, c, d);
}

template <int NL>
KZG_HD void fe_double(uint32_t r[NL], const uint32_t a[NL],
                      const FieldConsts<NL>& F) {
  fe_add(r, a, a, F);
}

template <int NL>
KZG_HD void fe_neg(uint32_t r[NL], const uint32_t a[NL],
                   const FieldConsts<NL>& F) {
  uint32_t z[NL] = {};
  fe_sub(r, z, a, F);
}

// Montgomery product a b R^{-1} mod p (CIOS).  With a, b < p the running
// value stays below a + p < 2p (NL + 1 words; t[NL] != 0 only if 2p > R,
// which p < R/2 rules out), so one conditional subtraction ends it.
template <int NL>
KZG_HD void fe_mul(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL],
                   const FieldConsts<NL>& F) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int i = 0; i < NL + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NL] + c;
    t[NL] = (uint32_t)s;
    t[NL + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * F.pinv;
    s = (uint64_t)m * F.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NL; j++) {
      s = (uint64_t)m * F.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NL] + c;
    t[NL - 1] = (uint32_t)s;
    t[NL] = t[NL + 1] + (uint32_t)(s >> 32);
  }
  uint32_t d[NL];
  uint32_t borrow = fe_sub_raw<NL>(d, t, F.p);
  fe_select<NL>(r, borrow == 0 || t[NL] != 0, d, t);
}

template <int NL>
KZG_HD void fe_square(uint32_t r[NL], const uint32_t a[NL],
                      const FieldConsts<NL>& F) {
  fe_mul(r, a, a, F);
}

// Elementwise thread bodies shared by the K1 kernels and the CPU build.
// Operand x is read at limb stride ldx and column step incx (0 broadcasts a
// single element over the batch, 1 walks it); the output is (NL, n) dense.
enum { FE_OP_MUL = 0, FE_OP_ADD = 1, FE_OP_SUB = 2 };

template <int OP, int NL>
KZG_HD void fe_ewise_thread(int64_t i, const uint32_t* a, int64_t lda,
                            int64_t inca, const uint32_t* b, int64_t ldb,
                            int64_t incb, uint32_t* out, int64_t n,
                            const FieldConsts<NL>& F) {
  uint32_t x[NL], y[NL], r[NL];
  fe_load<NL>(x, a, lda, i * inca);
  fe_load<NL>(y, b, ldb, i * incb);
  if (OP == FE_OP_MUL) {
    fe_mul(r, x, y, F);
  } else if (OP == FE_OP_ADD) {
    fe_add(r, x, y, F);
  } else {
    fe_sub(r, x, y, F);
  }
  fe_store<NL>(out, n, i, r);
}
