// Generated by kzg_snark_tpu_torch/utils/gen_chain_ptx.py; do not edit.
//
// The carry-chain steps of csrc/chain.cuh in inline PTX, one asm volatile
// block for each carry chain, unrolled at 8 and 12 words.  Device code
// only: chain.cuh takes these under __CUDA_ARCH__ and its C++ mirror
// elsewhere.
#pragma once

#include <stdint.h>

template <int W>
struct ChainPtx;


template <>
struct ChainPtx<8> {
  static __device__ __forceinline__ void pm_shift_odd(uint32_t* e, uint32_t* o, const uint32_t* a, uint32_t b) {
    asm volatile(
        "{\n\t"
        "add.cc.u32 %0, %0, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %9, %3;\n\t"
        "madc.hi.cc.u32 %1, %10, %9, %4;\n\t"
        "madc.lo.cc.u32 %3, %11, %9, %5;\n\t"
        "madc.hi.cc.u32 %4, %11, %9, %6;\n\t"
        "madc.lo.cc.u32 %5, %12, %9, %7;\n\t"
        "madc.hi.cc.u32 %6, %12, %9, %8;\n\t"
        "madc.lo.cc.u32 %7, %13, %9, 0;\n\t"
        "madc.hi.u32 %8, %13, %9, 0;\n\t"
        "}"
        : "+r"(e[0]), "+r"(o[1]), "+r"(o[0]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]), "+r"(o[7])
        : "r"(b), "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]));
  }
  static __device__ __forceinline__ void pm_even(uint32_t* e, uint32_t* o, const uint32_t* a, uint32_t b) {
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %10, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %10, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %9, %3;\n\t"
        "madc.lo.cc.u32 %4, %12, %9, %4;\n\t"
        "madc.hi.cc.u32 %5, %12, %9, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %9, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %9, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(o[7])
        : "r"(b), "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]));
  }
  static __device__ __forceinline__ void pm_reduce_odd(uint32_t* o, const uint32_t* p, uint32_t m) {
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %8, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %8, %11, %5;\n\t"
        "madc.lo.cc.u32 %6, %8, %12, %6;\n\t"
        "madc.hi.u32 %7, %8, %12, %7;\n\t"
        "}"
        : "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]), "+r"(o[7])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]));
  }
  static __device__ __forceinline__ void pm_reduce_even(uint32_t* e, uint32_t* o, const uint32_t* p, uint32_t m) {
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(o[7])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]));
  }
  static __device__ __forceinline__ void pm_merge(uint32_t* e, const uint32_t* o) {
    asm volatile(
        "{\n\t"
        "add.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32 %7, %7, 0;\n\t"
        "}"
        : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7])
        : "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]));
  }
  static __device__ __forceinline__ void final_sub(uint32_t* t, const uint32_t* p) {
    asm volatile(
        "{\n\t"
        ".reg .u32 q_d0, q_d1, q_d2, q_d3, q_d4, q_d5, q_d6, q_d7, q_h;\n\t"
        "sub.cc.u32 q_d0, %0, %8;\n\t"
        "subc.cc.u32 q_d1, %1, %9;\n\t"
        "subc.cc.u32 q_d2, %2, %10;\n\t"
        "subc.cc.u32 q_d3, %3, %11;\n\t"
        "subc.cc.u32 q_d4, %4, %12;\n\t"
        "subc.cc.u32 q_d5, %5, %13;\n\t"
        "subc.cc.u32 q_d6, %6, %14;\n\t"
        "subc.cc.u32 q_d7, %7, %15;\n\t"
        "subc.u32 q_h, %16, 0;\n\t"
        "{ .reg .pred q_lt;\n\t"
        "setp.eq.u32 q_lt, q_h, 0xFFFFFFFF;\n\t"
        "selp.u32 %0, %0, q_d0, q_lt;\n\t"
        "selp.u32 %1, %1, q_d1, q_lt;\n\t"
        "selp.u32 %2, %2, q_d2, q_lt;\n\t"
        "selp.u32 %3, %3, q_d3, q_lt;\n\t"
        "selp.u32 %4, %4, q_d4, q_lt;\n\t"
        "selp.u32 %5, %5, q_d5, q_lt;\n\t"
        "selp.u32 %6, %6, q_d6, q_lt;\n\t"
        "selp.u32 %7, %7, q_d7, q_lt;\n\t"
        "}\n\t"
        "}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7])
        : "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]), "r"(t[8]));
  }
  static __device__ __forceinline__ void sq_products(uint32_t* ce, uint32_t* co, uint32_t* k, const uint32_t* a, const uint32_t* a2) {
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %11, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %12, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %12, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(ce[0]), "+r"(ce[1]), "+r"(ce[2]), "+r"(ce[3]), "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(k[0])
        : "r"(a[0]), "r"(a2[2]), "r"(a2[4]), "r"(a2[6]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(co[0]), "+r"(co[1]), "+r"(co[2]), "+r"(co[3]), "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(k[1])
        : "r"(a[0]), "r"((a[1] << 1)), "r"(a2[3]), "r"(a2[5]), "r"(a2[7]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %11, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %12, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %12, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(ce[2]), "+r"(ce[3]), "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(k[2])
        : "r"(a[1]), "r"(a2[3]), "r"(a2[5]), "r"(a2[7]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %7, %8, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %8, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %10, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %10, %5;\n\t"
        "addc.u32 %6, %6, 0;\n\t"
        "}"
        : "+r"(co[2]), "+r"(co[3]), "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(k[1])
        : "r"(a[1]), "r"((a[2] << 1)), "r"(a2[4]), "r"(a2[6]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %7, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %8, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %8, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %9, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %9, %5;\n\t"
        "addc.u32 %6, %6, 0;\n\t"
        "}"
        : "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(k[2])
        : "r"(a[2]), "r"(a2[4]), "r"(a2[6]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %7, %8, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %8, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %10, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %10, %5;\n\t"
        "addc.u32 %6, %6, 0;\n\t"
        "}"
        : "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(k[3])
        : "r"(a[2]), "r"((a[3] << 1)), "r"(a2[5]), "r"(a2[7]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %7, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %8, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %8, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %9, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %9, %5;\n\t"
        "addc.u32 %6, %6, 0;\n\t"
        "}"
        : "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(k[4])
        : "r"(a[3]), "r"(a2[5]), "r"(a2[7]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %7, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "}"
        : "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(k[3])
        : "r"(a[3]), "r"((a[4] << 1)), "r"(a2[6]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %5, %5, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %5, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %6, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %6, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "}"
        : "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(k[4])
        : "r"(a[4]), "r"(a2[6]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %7, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "}"
        : "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(k[5])
        : "r"(a[4]), "r"((a[5] << 1)), "r"(a2[7]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %5, %5, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %5, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %6, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %6, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "}"
        : "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(k[6])
        : "r"(a[5]), "r"(a2[7]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;\n\t"
        "}"
        : "+r"(co[10]), "+r"(co[11]), "+r"(k[5])
        : "r"(a[5]), "r"((a[6] << 1)));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %3, %3, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %3, %1;\n\t"
        "addc.u32 %2, %2, 0;\n\t"
        "}"
        : "+r"(ce[12]), "+r"(ce[13]), "+r"(k[6])
        : "r"(a[6]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;\n\t"
        "}"
        : "+r"(co[12]), "+r"(co[13]), "+r"(k[7])
        : "r"(a[6]), "r"((a[7] << 1)));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %2, %2, %0;\n\t"
        "madc.hi.u32 %1, %2, %2, %1;\n\t"
        "}"
        : "+r"(ce[14]), "+r"(ce[15])
        : "r"(a[7]));
  }
  static __device__ __forceinline__ void sq_redc(uint32_t* ce, uint32_t* co, uint32_t* k, const uint32_t* p, uint32_t pinv) {
    uint32_t kk = 0, m;
    asm volatile(
        "{\n\t"
        "mul.lo.u32 %0, %2, %1;\n\t"
        "}"
        : "=r"(m)
        : "r"(pinv), "r"(ce[0]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(ce[0]), "+r"(ce[1]), "+r"(ce[2]), "+r"(ce[3]), "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(k[0])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(co[0]), "+r"(co[1]), "+r"(co[2]), "+r"(co[3]), "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(k[1])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %3, 0;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %4, %5;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(ce[0]), "r"(ce[1]), "r"(co[0]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(ce[2]), "+r"(ce[3]), "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(k[2])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(co[0]), "+r"(co[1]), "+r"(co[2]), "+r"(co[3]), "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(k[1])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[0]), "r"(ce[1]), "r"(ce[2]), "r"(co[1]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(ce[2]), "+r"(ce[3]), "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(k[2])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(co[2]), "+r"(co[3]), "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(k[3])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[1]), "r"(ce[2]), "r"(ce[3]), "r"(co[2]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(k[4])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(co[2]), "+r"(co[3]), "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(k[3])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[2]), "r"(ce[3]), "r"(ce[4]), "r"(co[3]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(k[4])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(k[5])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[3]), "r"(ce[4]), "r"(ce[5]), "r"(co[4]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(k[6])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(k[5])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[4]), "r"(ce[5]), "r"(ce[6]), "r"(co[5]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(k[6])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(k[7])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[5]), "r"(ce[6]), "r"(ce[7]), "r"(co[6]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %8, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %8, %11, %5;\n\t"
        "madc.lo.cc.u32 %6, %8, %12, %6;\n\t"
        "madc.hi.u32 %7, %8, %12, %7;\n\t"
        "}"
        : "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(k[7])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q;\n\t"
        "add.cc.u32 q_q, %0, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %1, %2;\n\t"
        "addc.u32 %0, 0, 0;\n\t"
        "}"
        : "+r"(kk)
        : "r"(ce[7]), "r"(co[6]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q;\n\t"
        "add.cc.u32 q_q, %8, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.u32 %7, %7, %16;\n\t"
        "}"
        : "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15])
        : "r"(kk), "r"(co[7]), "r"(co[8]), "r"(co[9]), "r"(co[10]), "r"(co[11]), "r"(co[12]), "r"(co[13]), "r"(co[14]));
    asm volatile(
        "{\n\t"
        "add.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32 %7, %7, %15;\n\t"
        "}"
        : "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15])
        : "r"(k[0]), "r"(k[1]), "r"(k[2]), "r"(k[3]), "r"(k[4]), "r"(k[5]), "r"(k[6]), "r"(k[7]));
  }
};

template <>
struct ChainPtx<12> {
  static __device__ __forceinline__ void pm_shift_odd(uint32_t* e, uint32_t* o, const uint32_t* a, uint32_t b) {
    asm volatile(
        "{\n\t"
        "add.cc.u32 %0, %0, %1;\n\t"
        "madc.lo.cc.u32 %2, %14, %13, %3;\n\t"
        "madc.hi.cc.u32 %1, %14, %13, %4;\n\t"
        "madc.lo.cc.u32 %3, %15, %13, %5;\n\t"
        "madc.hi.cc.u32 %4, %15, %13, %6;\n\t"
        "madc.lo.cc.u32 %5, %16, %13, %7;\n\t"
        "madc.hi.cc.u32 %6, %16, %13, %8;\n\t"
        "madc.lo.cc.u32 %7, %17, %13, %9;\n\t"
        "madc.hi.cc.u32 %8, %17, %13, %10;\n\t"
        "madc.lo.cc.u32 %9, %18, %13, %11;\n\t"
        "madc.hi.cc.u32 %10, %18, %13, %12;\n\t"
        "madc.lo.cc.u32 %11, %19, %13, 0;\n\t"
        "madc.hi.u32 %12, %19, %13, 0;\n\t"
        "}"
        : "+r"(e[0]), "+r"(o[1]), "+r"(o[0]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]), "+r"(o[7]), "+r"(o[8]), "+r"(o[9]), "+r"(o[10]), "+r"(o[11])
        : "r"(b), "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(a[9]), "r"(a[11]));
  }
  static __device__ __forceinline__ void pm_even(uint32_t* e, uint32_t* o, const uint32_t* a, uint32_t b) {
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %14, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %14, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %15, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %15, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %16, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %16, %13, %5;\n\t"
        "madc.lo.cc.u32 %6, %17, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %17, %13, %7;\n\t"
        "madc.lo.cc.u32 %8, %18, %13, %8;\n\t"
        "madc.hi.cc.u32 %9, %18, %13, %9;\n\t"
        "madc.lo.cc.u32 %10, %19, %13, %10;\n\t"
        "madc.hi.cc.u32 %11, %19, %13, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]), "+r"(e[10]), "+r"(e[11]), "+r"(o[11])
        : "r"(b), "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(a[8]), "r"(a[10]));
  }
  static __device__ __forceinline__ void pm_reduce_odd(uint32_t* o, const uint32_t* p, uint32_t m) {
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %12, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %12, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %12, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %12, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %12, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %16, %7;\n\t"
        "madc.lo.cc.u32 %8, %12, %17, %8;\n\t"
        "madc.hi.cc.u32 %9, %12, %17, %9;\n\t"
        "madc.lo.cc.u32 %10, %12, %18, %10;\n\t"
        "madc.hi.u32 %11, %12, %18, %11;\n\t"
        "}"
        : "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]), "+r"(o[7]), "+r"(o[8]), "+r"(o[9]), "+r"(o[10]), "+r"(o[11])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
  }
  static __device__ __forceinline__ void pm_reduce_even(uint32_t* e, uint32_t* o, const uint32_t* p, uint32_t m) {
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]), "+r"(e[10]), "+r"(e[11]), "+r"(o[11])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
  }
  static __device__ __forceinline__ void pm_merge(uint32_t* e, const uint32_t* o) {
    asm volatile(
        "{\n\t"
        "add.cc.u32 %0, %0, %12;\n\t"
        "addc.cc.u32 %1, %1, %13;\n\t"
        "addc.cc.u32 %2, %2, %14;\n\t"
        "addc.cc.u32 %3, %3, %15;\n\t"
        "addc.cc.u32 %4, %4, %16;\n\t"
        "addc.cc.u32 %5, %5, %17;\n\t"
        "addc.cc.u32 %6, %6, %18;\n\t"
        "addc.cc.u32 %7, %7, %19;\n\t"
        "addc.cc.u32 %8, %8, %20;\n\t"
        "addc.cc.u32 %9, %9, %21;\n\t"
        "addc.cc.u32 %10, %10, %22;\n\t"
        "addc.u32 %11, %11, 0;\n\t"
        "}"
        : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]), "+r"(e[10]), "+r"(e[11])
        : "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]), "r"(o[8]), "r"(o[9]), "r"(o[10]), "r"(o[11]));
  }
  static __device__ __forceinline__ void final_sub(uint32_t* t, const uint32_t* p) {
    asm volatile(
        "{\n\t"
        ".reg .u32 q_d0, q_d1, q_d2, q_d3, q_d4, q_d5, q_d6, q_d7, q_d8, q_d9, q_d10, q_d11, q_h;\n\t"
        "sub.cc.u32 q_d0, %0, %12;\n\t"
        "subc.cc.u32 q_d1, %1, %13;\n\t"
        "subc.cc.u32 q_d2, %2, %14;\n\t"
        "subc.cc.u32 q_d3, %3, %15;\n\t"
        "subc.cc.u32 q_d4, %4, %16;\n\t"
        "subc.cc.u32 q_d5, %5, %17;\n\t"
        "subc.cc.u32 q_d6, %6, %18;\n\t"
        "subc.cc.u32 q_d7, %7, %19;\n\t"
        "subc.cc.u32 q_d8, %8, %20;\n\t"
        "subc.cc.u32 q_d9, %9, %21;\n\t"
        "subc.cc.u32 q_d10, %10, %22;\n\t"
        "subc.cc.u32 q_d11, %11, %23;\n\t"
        "subc.u32 q_h, %24, 0;\n\t"
        "{ .reg .pred q_lt;\n\t"
        "setp.eq.u32 q_lt, q_h, 0xFFFFFFFF;\n\t"
        "selp.u32 %0, %0, q_d0, q_lt;\n\t"
        "selp.u32 %1, %1, q_d1, q_lt;\n\t"
        "selp.u32 %2, %2, q_d2, q_lt;\n\t"
        "selp.u32 %3, %3, q_d3, q_lt;\n\t"
        "selp.u32 %4, %4, q_d4, q_lt;\n\t"
        "selp.u32 %5, %5, q_d5, q_lt;\n\t"
        "selp.u32 %6, %6, q_d6, q_lt;\n\t"
        "selp.u32 %7, %7, q_d7, q_lt;\n\t"
        "selp.u32 %8, %8, q_d8, q_lt;\n\t"
        "selp.u32 %9, %9, q_d9, q_lt;\n\t"
        "selp.u32 %10, %10, q_d10, q_lt;\n\t"
        "selp.u32 %11, %11, q_d11, q_lt;\n\t"
        "}\n\t"
        "}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11])
        : "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]), "r"(p[8]), "r"(p[9]), "r"(p[10]), "r"(p[11]), "r"(t[12]));
  }
  static __device__ __forceinline__ void sq_products(uint32_t* ce, uint32_t* co, uint32_t* k, const uint32_t* a, const uint32_t* a2) {
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %16, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %17, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %17, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %18, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %18, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[0]), "+r"(ce[1]), "+r"(ce[2]), "+r"(ce[3]), "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(k[0])
        : "r"(a[0]), "r"(a2[2]), "r"(a2[4]), "r"(a2[6]), "r"(a2[8]), "r"(a2[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[0]), "+r"(co[1]), "+r"(co[2]), "+r"(co[3]), "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(k[1])
        : "r"(a[0]), "r"((a[1] << 1)), "r"(a2[3]), "r"(a2[5]), "r"(a2[7]), "r"(a2[9]), "r"(a2[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %16, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %17, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %17, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %18, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %18, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[2]), "+r"(ce[3]), "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(k[2])
        : "r"(a[1]), "r"(a2[3]), "r"(a2[5]), "r"(a2[7]), "r"(a2[9]), "r"(a2[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %11, %12, %0;\n\t"
        "madc.hi.cc.u32 %1, %11, %12, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %14, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %14, %5;\n\t"
        "madc.lo.cc.u32 %6, %11, %15, %6;\n\t"
        "madc.hi.cc.u32 %7, %11, %15, %7;\n\t"
        "madc.lo.cc.u32 %8, %11, %16, %8;\n\t"
        "madc.hi.cc.u32 %9, %11, %16, %9;\n\t"
        "addc.u32 %10, %10, 0;\n\t"
        "}"
        : "+r"(co[2]), "+r"(co[3]), "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(k[1])
        : "r"(a[1]), "r"((a[2] << 1)), "r"(a2[4]), "r"(a2[6]), "r"(a2[8]), "r"(a2[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %11, %11, %0;\n\t"
        "madc.hi.cc.u32 %1, %11, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %12, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
        "madc.lo.cc.u32 %6, %11, %14, %6;\n\t"
        "madc.hi.cc.u32 %7, %11, %14, %7;\n\t"
        "madc.lo.cc.u32 %8, %11, %15, %8;\n\t"
        "madc.hi.cc.u32 %9, %11, %15, %9;\n\t"
        "addc.u32 %10, %10, 0;\n\t"
        "}"
        : "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(k[2])
        : "r"(a[2]), "r"(a2[4]), "r"(a2[6]), "r"(a2[8]), "r"(a2[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %11, %12, %0;\n\t"
        "madc.hi.cc.u32 %1, %11, %12, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %14, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %14, %5;\n\t"
        "madc.lo.cc.u32 %6, %11, %15, %6;\n\t"
        "madc.hi.cc.u32 %7, %11, %15, %7;\n\t"
        "madc.lo.cc.u32 %8, %11, %16, %8;\n\t"
        "madc.hi.cc.u32 %9, %11, %16, %9;\n\t"
        "addc.u32 %10, %10, 0;\n\t"
        "}"
        : "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(k[3])
        : "r"(a[2]), "r"((a[3] << 1)), "r"(a2[5]), "r"(a2[7]), "r"(a2[9]), "r"(a2[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %11, %11, %0;\n\t"
        "madc.hi.cc.u32 %1, %11, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %12, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
        "madc.lo.cc.u32 %6, %11, %14, %6;\n\t"
        "madc.hi.cc.u32 %7, %11, %14, %7;\n\t"
        "madc.lo.cc.u32 %8, %11, %15, %8;\n\t"
        "madc.hi.cc.u32 %9, %11, %15, %9;\n\t"
        "addc.u32 %10, %10, 0;\n\t"
        "}"
        : "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(k[4])
        : "r"(a[3]), "r"(a2[5]), "r"(a2[7]), "r"(a2[9]), "r"(a2[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(k[3])
        : "r"(a[3]), "r"((a[4] << 1)), "r"(a2[6]), "r"(a2[8]), "r"(a2[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %11, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %12, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %12, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(k[4])
        : "r"(a[4]), "r"(a2[6]), "r"(a2[8]), "r"(a2[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(co[14]), "+r"(co[15]), "+r"(k[5])
        : "r"(a[4]), "r"((a[5] << 1)), "r"(a2[7]), "r"(a2[9]), "r"(a2[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %11, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %12, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %12, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "}"
        : "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(ce[16]), "+r"(ce[17]), "+r"(k[6])
        : "r"(a[5]), "r"(a2[7]), "r"(a2[9]), "r"(a2[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %7, %8, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %8, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %10, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %10, %5;\n\t"
        "addc.u32 %6, %6, 0;\n\t"
        "}"
        : "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(co[14]), "+r"(co[15]), "+r"(k[5])
        : "r"(a[5]), "r"((a[6] << 1)), "r"(a2[8]), "r"(a2[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %7, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %8, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %8, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %9, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %9, %5;\n\t"
        "addc.u32 %6, %6, 0;\n\t"
        "}"
        : "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(ce[16]), "+r"(ce[17]), "+r"(k[6])
        : "r"(a[6]), "r"(a2[8]), "r"(a2[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %7, %8, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %8, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %10, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %10, %5;\n\t"
        "addc.u32 %6, %6, 0;\n\t"
        "}"
        : "+r"(co[12]), "+r"(co[13]), "+r"(co[14]), "+r"(co[15]), "+r"(co[16]), "+r"(co[17]), "+r"(k[7])
        : "r"(a[6]), "r"((a[7] << 1)), "r"(a2[9]), "r"(a2[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %7, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %8, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %8, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %9, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %9, %5;\n\t"
        "addc.u32 %6, %6, 0;\n\t"
        "}"
        : "+r"(ce[14]), "+r"(ce[15]), "+r"(ce[16]), "+r"(ce[17]), "+r"(ce[18]), "+r"(ce[19]), "+r"(k[8])
        : "r"(a[7]), "r"(a2[9]), "r"(a2[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %7, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "}"
        : "+r"(co[14]), "+r"(co[15]), "+r"(co[16]), "+r"(co[17]), "+r"(k[7])
        : "r"(a[7]), "r"((a[8] << 1)), "r"(a2[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %5, %5, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %5, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %6, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %6, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "}"
        : "+r"(ce[16]), "+r"(ce[17]), "+r"(ce[18]), "+r"(ce[19]), "+r"(k[8])
        : "r"(a[8]), "r"(a2[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %7, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "}"
        : "+r"(co[16]), "+r"(co[17]), "+r"(co[18]), "+r"(co[19]), "+r"(k[9])
        : "r"(a[8]), "r"((a[9] << 1)), "r"(a2[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %5, %5, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %5, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %6, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %6, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "}"
        : "+r"(ce[18]), "+r"(ce[19]), "+r"(ce[20]), "+r"(ce[21]), "+r"(k[10])
        : "r"(a[9]), "r"(a2[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;\n\t"
        "}"
        : "+r"(co[18]), "+r"(co[19]), "+r"(k[9])
        : "r"(a[9]), "r"((a[10] << 1)));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %3, %3, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %3, %1;\n\t"
        "addc.u32 %2, %2, 0;\n\t"
        "}"
        : "+r"(ce[20]), "+r"(ce[21]), "+r"(k[10])
        : "r"(a[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;\n\t"
        "}"
        : "+r"(co[20]), "+r"(co[21]), "+r"(k[11])
        : "r"(a[10]), "r"((a[11] << 1)));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %2, %2, %0;\n\t"
        "madc.hi.u32 %1, %2, %2, %1;\n\t"
        "}"
        : "+r"(ce[22]), "+r"(ce[23])
        : "r"(a[11]));
  }
  static __device__ __forceinline__ void sq_redc(uint32_t* ce, uint32_t* co, uint32_t* k, const uint32_t* p, uint32_t pinv) {
    uint32_t kk = 0, m;
    asm volatile(
        "{\n\t"
        "mul.lo.u32 %0, %2, %1;\n\t"
        "}"
        : "=r"(m)
        : "r"(pinv), "r"(ce[0]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[0]), "+r"(ce[1]), "+r"(ce[2]), "+r"(ce[3]), "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(k[0])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[0]), "+r"(co[1]), "+r"(co[2]), "+r"(co[3]), "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(k[1])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %3, 0;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %4, %5;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(ce[0]), "r"(ce[1]), "r"(co[0]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[2]), "+r"(ce[3]), "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(k[2])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[0]), "+r"(co[1]), "+r"(co[2]), "+r"(co[3]), "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(k[1])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[0]), "r"(ce[1]), "r"(ce[2]), "r"(co[1]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[2]), "+r"(ce[3]), "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(k[2])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[2]), "+r"(co[3]), "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(k[3])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[1]), "r"(ce[2]), "r"(ce[3]), "r"(co[2]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(k[4])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[2]), "+r"(co[3]), "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(k[3])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[2]), "r"(ce[3]), "r"(ce[4]), "r"(co[3]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[4]), "+r"(ce[5]), "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(k[4])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(co[14]), "+r"(co[15]), "+r"(k[5])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[3]), "r"(ce[4]), "r"(ce[5]), "r"(co[4]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(ce[16]), "+r"(ce[17]), "+r"(k[6])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[4]), "+r"(co[5]), "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(co[14]), "+r"(co[15]), "+r"(k[5])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[4]), "r"(ce[5]), "r"(ce[6]), "r"(co[5]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[6]), "+r"(ce[7]), "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(ce[16]), "+r"(ce[17]), "+r"(k[6])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(co[14]), "+r"(co[15]), "+r"(co[16]), "+r"(co[17]), "+r"(k[7])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[5]), "r"(ce[6]), "r"(ce[7]), "r"(co[6]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(ce[16]), "+r"(ce[17]), "+r"(ce[18]), "+r"(ce[19]), "+r"(k[8])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[6]), "+r"(co[7]), "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(co[14]), "+r"(co[15]), "+r"(co[16]), "+r"(co[17]), "+r"(k[7])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[6]), "r"(ce[7]), "r"(ce[8]), "r"(co[7]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[8]), "+r"(ce[9]), "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(ce[16]), "+r"(ce[17]), "+r"(ce[18]), "+r"(ce[19]), "+r"(k[8])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(co[14]), "+r"(co[15]), "+r"(co[16]), "+r"(co[17]), "+r"(co[18]), "+r"(co[19]), "+r"(k[9])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[7]), "r"(ce[8]), "r"(ce[9]), "r"(co[8]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(ce[16]), "+r"(ce[17]), "+r"(ce[18]), "+r"(ce[19]), "+r"(ce[20]), "+r"(ce[21]), "+r"(k[10])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[8]), "+r"(co[9]), "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(co[14]), "+r"(co[15]), "+r"(co[16]), "+r"(co[17]), "+r"(co[18]), "+r"(co[19]), "+r"(k[9])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[8]), "r"(ce[9]), "r"(ce[10]), "r"(co[9]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(ce[10]), "+r"(ce[11]), "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(ce[16]), "+r"(ce[17]), "+r"(ce[18]), "+r"(ce[19]), "+r"(ce[20]), "+r"(ce[21]), "+r"(k[10])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(co[14]), "+r"(co[15]), "+r"(co[16]), "+r"(co[17]), "+r"(co[18]), "+r"(co[19]), "+r"(co[20]), "+r"(co[21]), "+r"(k[11])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q, q_w;\n\t"
        "add.cc.u32 q_q, %1, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %4, %3;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        "add.u32 q_w, %5, %6;\n\t"
        "add.u32 q_w, q_w, %1;\n\t"
        "mul.lo.u32 %0, q_w, %2;\n\t"
        "}"
        : "=r"(m), "+r"(kk)
        : "r"(pinv), "r"(co[9]), "r"(ce[10]), "r"(ce[11]), "r"(co[10]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %12, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %12, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %12, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %12, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %12, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %16, %7;\n\t"
        "madc.lo.cc.u32 %8, %12, %17, %8;\n\t"
        "madc.hi.cc.u32 %9, %12, %17, %9;\n\t"
        "madc.lo.cc.u32 %10, %12, %18, %10;\n\t"
        "madc.hi.u32 %11, %12, %18, %11;\n\t"
        "}"
        : "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(ce[16]), "+r"(ce[17]), "+r"(ce[18]), "+r"(ce[19]), "+r"(ce[20]), "+r"(ce[21]), "+r"(ce[22]), "+r"(ce[23])
        : "r"(m), "r"(p[1]), "r"(p[3]), "r"(p[5]), "r"(p[7]), "r"(p[9]), "r"(p[11]));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(co[10]), "+r"(co[11]), "+r"(co[12]), "+r"(co[13]), "+r"(co[14]), "+r"(co[15]), "+r"(co[16]), "+r"(co[17]), "+r"(co[18]), "+r"(co[19]), "+r"(co[20]), "+r"(co[21]), "+r"(k[11])
        : "r"(m), "r"(p[0]), "r"(p[2]), "r"(p[4]), "r"(p[6]), "r"(p[8]), "r"(p[10]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q;\n\t"
        "add.cc.u32 q_q, %0, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 q_q, %1, %2;\n\t"
        "addc.u32 %0, 0, 0;\n\t"
        "}"
        : "+r"(kk)
        : "r"(ce[11]), "r"(co[10]));
    asm volatile(
        "{\n\t"
        ".reg .u32 q_q;\n\t"
        "add.cc.u32 q_q, %12, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 %0, %0, %13;\n\t"
        "addc.cc.u32 %1, %1, %14;\n\t"
        "addc.cc.u32 %2, %2, %15;\n\t"
        "addc.cc.u32 %3, %3, %16;\n\t"
        "addc.cc.u32 %4, %4, %17;\n\t"
        "addc.cc.u32 %5, %5, %18;\n\t"
        "addc.cc.u32 %6, %6, %19;\n\t"
        "addc.cc.u32 %7, %7, %20;\n\t"
        "addc.cc.u32 %8, %8, %21;\n\t"
        "addc.cc.u32 %9, %9, %22;\n\t"
        "addc.cc.u32 %10, %10, %23;\n\t"
        "addc.u32 %11, %11, %24;\n\t"
        "}"
        : "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(ce[16]), "+r"(ce[17]), "+r"(ce[18]), "+r"(ce[19]), "+r"(ce[20]), "+r"(ce[21]), "+r"(ce[22]), "+r"(ce[23])
        : "r"(kk), "r"(co[11]), "r"(co[12]), "r"(co[13]), "r"(co[14]), "r"(co[15]), "r"(co[16]), "r"(co[17]), "r"(co[18]), "r"(co[19]), "r"(co[20]), "r"(co[21]), "r"(co[22]));
    asm volatile(
        "{\n\t"
        "add.cc.u32 %0, %0, %12;\n\t"
        "addc.cc.u32 %1, %1, %13;\n\t"
        "addc.cc.u32 %2, %2, %14;\n\t"
        "addc.cc.u32 %3, %3, %15;\n\t"
        "addc.cc.u32 %4, %4, %16;\n\t"
        "addc.cc.u32 %5, %5, %17;\n\t"
        "addc.cc.u32 %6, %6, %18;\n\t"
        "addc.cc.u32 %7, %7, %19;\n\t"
        "addc.cc.u32 %8, %8, %20;\n\t"
        "addc.cc.u32 %9, %9, %21;\n\t"
        "addc.cc.u32 %10, %10, %22;\n\t"
        "addc.u32 %11, %11, %23;\n\t"
        "}"
        : "+r"(ce[12]), "+r"(ce[13]), "+r"(ce[14]), "+r"(ce[15]), "+r"(ce[16]), "+r"(ce[17]), "+r"(ce[18]), "+r"(ce[19]), "+r"(ce[20]), "+r"(ce[21]), "+r"(ce[22]), "+r"(ce[23])
        : "r"(k[0]), "r"(k[1]), "r"(k[2]), "r"(k[3]), "r"(k[4]), "r"(k[5]), "r"(k[6]), "r"(k[7]), "r"(k[8]), "r"(k[9]), "r"(k[10]), "r"(k[11]));
  }
};
