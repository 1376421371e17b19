// Elementwise fast_sincos over a float32 array: exposes the device copy of
// the fast sine (fast_math.cuh) so that it can be held against the plain
// torch version (ops/fast_math.py) on the card.  Not on the training or
// decode path: the fused kernels inline fast_math.cuh themselves.
#include <cuda_runtime.h>

#include "fast_math.cuh"

namespace {

__global__ void fast_sincos_kernel(const float* __restrict__ x,
                                   float* __restrict__ s,
                                   float* __restrict__ c, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) brief::fast_sincos(x[i], &s[i], &c[i]);
}

}  // namespace

extern "C" int brief_fast_sincos(const float* x, float* s, float* c,
                                 long long n, void* stream) {
  const int block = 256;
  const long long grid = (n + block - 1) / block;
  fast_sincos_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      x, s, c, n);
  return (int)cudaGetLastError();
}
