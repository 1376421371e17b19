// One layer of an activation chain for one coordinate, shared by the
// fused train and decode kernels.
//
// Activations live in shared memory, one column per thread: row r of the
// block's activation buffer holds feature r of every coordinate of the
// tile, at A[r * stride + thread].  A thread reads and writes only its own
// column here, so no synchronisation is needed between layers.
//
// Weights live in shared memory as W (fin, fout_pad) with the columns
// zero-padded to a multiple of kChunk floats, so one output chunk of
// kChunk accumulators stays in registers while the input features stream
// once from shared memory: two 16-byte broadcast loads of weights and one
// load of the input per kChunk multiply-adds.
#pragma once

#include <cuda_runtime.h>

#include "fast_math.cuh"

namespace brief {

constexpr int kMaxLayers = 16;
constexpr int kChunk = 8;

enum Act { kActNone = 0, kActSine = 1, kActRelu = 2, kActSigmoid = 3 };

__host__ __device__ __forceinline__ int round_up8(int x) {
  return (x + 7) & ~7;
}

// act(z) and d act/dz.  For sine one shared range reduction gives both.
__device__ __forceinline__ void act_fwd(int act, float w0, float z, float* h,
                                        float* d) {
  switch (act) {
    case kActSine: {
      float s, c;
      fast_sincos(w0 * z, &s, &c);
      *h = s;
      *d = w0 * c;
      break;
    }
    case kActRelu:
      *h = fmaxf(z, 0.f);
      *d = z > 0.f ? 1.f : 0.f;
      break;
    case kActSigmoid: {
      const float s = 1.f / (1.f + expf(-z));
      *h = s;
      *d = s * (1.f - s);
      break;
    }
    default:
      *h = z;
      *d = 1.f;
  }
}

__device__ __forceinline__ float act_only(int act, float w0, float z) {
  switch (act) {
    case kActSine: return fast_sin(w0 * z);
    case kActRelu: return fmaxf(z, 0.f);
    case kActSigmoid: return 1.f / (1.f + expf(-z));
    default: return z;
  }
}

// out rows [h_row, h_row + fout) = act(W^T in + b) for this thread's
// column; with kStoreD also rows [d_row, d_row + fout) = act'(z).  A
// non-null `mask` (fout 0/1 floats, device memory) multiplies both, as the
// block fleet's width padding needs.
template <bool kStoreD>
__device__ __forceinline__ void layer_forward(
    const float* __restrict__ sw, const float* __restrict__ sb, float* A,
    int stride, int col, int in_row, int fin, int fout, int act, float w0,
    int h_row, int d_row, const float* __restrict__ mask = nullptr) {
  const int fop = round_up8(fout);
  for (int o0 = 0; o0 < fout; o0 += kChunk) {
    float z[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) z[k] = 0.f;
    for (int i = 0; i < fin; ++i) {
      const float x = A[(in_row + i) * stride + col];
      const float4 wa = *reinterpret_cast<const float4*>(sw + i * fop + o0);
      const float4 wb =
          *reinterpret_cast<const float4*>(sw + i * fop + o0 + 4);
      z[0] = fmaf(wa.x, x, z[0]);
      z[1] = fmaf(wa.y, x, z[1]);
      z[2] = fmaf(wa.z, x, z[2]);
      z[3] = fmaf(wa.w, x, z[3]);
      z[4] = fmaf(wb.x, x, z[4]);
      z[5] = fmaf(wb.y, x, z[5]);
      z[6] = fmaf(wb.z, x, z[6]);
      z[7] = fmaf(wb.w, x, z[7]);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int o = o0 + k;
      if (o < fout) {
        const float zz = z[k] + sb[o];
        if (kStoreD) {
          float h, d;
          act_fwd(act, w0, zz, &h, &d);
          if (mask != nullptr) {
            const float m = __ldg(mask + o);
            h *= m;
            d *= m;
          }
          A[(h_row + o) * stride + col] = h;
          A[(d_row + o) * stride + col] = d;
        } else {
          float h = act_only(act, w0, zz);
          if (mask != nullptr) h *= __ldg(mask + o);
          A[(h_row + o) * stride + col] = h;
        }
      }
    }
  }
}

// Copy layer weights W (fin, fout) row-major from global memory into a
// zero-padded (fin, round_up8(fout)) shared tile; optionally also the
// transpose (fout, round_up8(fin)).  Called by every thread of the block.
__device__ __forceinline__ void load_weights(const float* __restrict__ W,
                                             int fin, int fout, float* sw,
                                             float* swt, float* sb) {
  const int fop = round_up8(fout), fip = round_up8(fin);
  for (int e = threadIdx.x; e < fin * fop; e += blockDim.x) {
    const int i = e / fop, o = e - i * fop;
    sw[e] = o < fout ? W[i * fout + o] : 0.f;
  }
  if (swt != nullptr) {
    for (int e = threadIdx.x; e < fout * fip; e += blockDim.x) {
      const int o = e / fip, i = e - o * fip;
      swt[e] = i < fin ? W[i * fout + o] : 0.f;
    }
  }
  for (int e = threadIdx.x; e < fout; e += blockDim.x) {
    sb[e] = W[fin * fout + e];
  }
}

}  // namespace brief
