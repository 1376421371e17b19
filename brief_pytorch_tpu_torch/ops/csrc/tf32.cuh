// 3xTF32 products on mma.sync.m16n8k8, shared by the fused train kernel's
// narrow layout (csrc/fused_train.cu) and the tensor-core chain of the
// decode and batch-major forward kernels (csrc/chain_tc.cuh).  The CPU twins are ops/fused_train.py
// tf32_split and pack_fragments.
//
// Fragments as in the PTX ISA: lane = 4g + t;
// A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B (8 x 8): b0 (t, g), b1 (t + 4, g); C (16 x 8): c0 (g, 2t), c1 (g,
// 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
//
// x = big + small, a b = as bb + ab bs + ab bb: float32 accuracy from
// three TF32 products.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace brief {

// x = big + small for 3xTF32 (ops/fused_train.py tf32_split): big is x
// rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (half a TF32 ulp
// added to the magnitude, the 13 low bits cleared: 2 instructions, where
// cvt.rna compiles to 5 with its inf and NaN checks); small = x - big is
// exact in float32 and goes in whole: the tensor core reads its top 19
// bits (toward zero), so big + small errs by at most 2^-21 |x|.  A NaN
// or inf x gives a NaN small, which the products carry on.
__device__ __forceinline__ void split_tf32(float x, uint32_t* big,
                                           uint32_t* small) {
  const uint32_t b = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  *big = b;
  *small = __float_as_uint(x - __uint_as_float(b));
}

// split_tf32 with small rounded to TF32 as well (csrc/chain_tc.cuh's
// sums): big + small errs by at most 2^-22 |x|, where the tensor
// core's truncation of a whole small errs by up to 2^-21 |x|.
__device__ __forceinline__ void split_tf32_nearest(float x, uint32_t* big,
                                                   uint32_t* small) {
  const uint32_t b = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  *big = b;
  *small = (__float_as_uint(x - __uint_as_float(b)) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b: mma_tf32 on a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// A lane's two entries of a packed B fragment: {b0 big, b1 big, b0 small,
// b1 small}; kNearest rounds the small parts (split_tf32_nearest)
template <bool kNearest = false>
__device__ __forceinline__ float4 pack_b(float w0, float w1) {
  uint32_t b0, s0, b1, s1;
  if (kNearest) {
    split_tf32_nearest(w0, &b0, &s0);
    split_tf32_nearest(w1, &b1, &s1);
  } else {
    split_tf32(w0, &b0, &s0);
    split_tf32(w1, &b1, &s1);
  }
  return make_float4(__uint_as_float(b0), __uint_as_float(b1),
                     __uint_as_float(s0), __uint_as_float(s1));
}

}  // namespace brief
