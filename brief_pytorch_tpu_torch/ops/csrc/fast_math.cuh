// Fast float32 sine/cosine for the INR kernels (device side).
//
// The device copy of ops/fast_math.py (itself the torch port of
// brief_pytorch_tpu/ops/fast_math.py:37-131), with the same constants:
// a Cody-Waite two-step reduction by 2*pi, a fold to [-pi/2, pi/2], and
// degree-9 odd / degree-8 even minimax polynomials sharing one reduction.
// float32 error <= 2e-6 for |x| <= 40 and <= 8e-6 for |x| <= 200.  nvcc
// contracts the Horner steps into FMAs, so values differ from the plain
// torch version in the last bits only.
//
// Compile with -DBRIEF_EXACT_SINE (ops/build.py does so when
// BRIEF_TPU_EXACT_SINE=1) to use the CUDA math library's sincosf instead.
#pragma once

#include <cuda_runtime.h>

namespace brief {

constexpr float kInv2Pi = 0.15915494309189535f;
constexpr float kC1 = 6.28125f;                 // exact in float32
constexpr float kC2 = 1.9353071795864769e-3f;   // 2*pi - kC1
constexpr float kPi = 3.141592653589793f;
constexpr float kHalfPi = 1.5707963267948966f;
constexpr float kS0 = 9.99999977e-01f;
constexpr float kS1 = -1.66666476e-01f;
constexpr float kS2 = 8.33290001e-03f;
constexpr float kS3 = -1.98009088e-04f;
constexpr float kS4 = 2.59051028e-06f;
constexpr float kK0 = 9.99999953e-01f;
constexpr float kK1 = -4.99999054e-01f;
constexpr float kK2 = 4.16635848e-02f;
constexpr float kK3 = -1.38537053e-03f;
constexpr float kK4 = 2.31539532e-05f;

// r in [-pi/2, pi/2] with sin(x) = sin(r); *flip is set where cos(x) = -cos(r).
__device__ __forceinline__ float reduce_half_pi(float x, bool* flip) {
  const float k = rintf(x * kInv2Pi);   // round half to even, as jnp.round
  float r = x - k * kC1;
  r = r - k * kC2;                      // r in [-pi, pi]
  *flip = fabsf(r) > kHalfPi;
  r = r > kHalfPi ? kPi - r : r;
  r = r < -kHalfPi ? -kPi - r : r;
  return r;
}

__device__ __forceinline__ float sin_poly(float r, float r2) {
  float p = kS4 * r2 + kS3;
  p = p * r2 + kS2;
  p = p * r2 + kS1;
  p = p * r2 + kS0;
  return r * p;
}

__device__ __forceinline__ float fast_sin(float x) {
#ifdef BRIEF_EXACT_SINE
  return sinf(x);
#else
  bool flip;
  const float r = reduce_half_pi(x, &flip);
  return sin_poly(r, r * r);
#endif
}

__device__ __forceinline__ void fast_sincos(float x, float* s, float* c) {
#ifdef BRIEF_EXACT_SINE
  sincosf(x, s, c);
#else
  bool flip;
  const float r = reduce_half_pi(x, &flip);
  const float r2 = r * r;
  *s = sin_poly(r, r2);
  float q = kK4 * r2 + kK3;
  q = q * r2 + kK2;
  q = q * r2 + kK1;
  q = q * r2 + kK0;
  *c = flip ? -q : q;
#endif
}

}  // namespace brief
