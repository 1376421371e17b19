// The layer products of the fused train kernel's wide layout
// (csrc/fused_train.cu): chains whose weights do not fit in shared
// memory.  ops/wide.py is the Python side of this file.
//
// A block works on a tile of kT coordinates (kT in 64, 32, 16, 8) with
// 4 * kT threads.  The tile's activations are rows of kT floats (row r =
// feature r of every coordinate of the tile).  Each layer's weights stay
// in device memory in a packed copy, zero-padded to (rowpad, colpad) =
// (round64(fin + 1), round64(fout)) with the bias as row fin (the input
// carries a row of ones at fin, so the bias is one more row of the same
// product).  The products stream that copy through shared memory in slabs
// of kKS rows (forward) or kKS columns (input gradient), double buffered
// with cp.async, so a slab's 16-byte copies overlap the products on the
// previous one.
//
// The activation operand lives in shared memory: two buffers of rows, a
// layer reading one and writing the other: 2 * round32(width + 1) * kT
// floats, which at kT = 8 holds up to 3,327 features.  Wider chains take
// the streamed form (csrc/fused_train_stream.cu).
//
// A product block is 64 outputs (or inputs) x kT coordinates; thread t
// owns the 4 x 4 micro-tile of outputs 4 * (t / (kT / 4)) + a and
// coordinates 4 * (t % (kT / 4)) + c, so every pair of 16-byte shared
// reads (or 8 of them in the input gradient) feeds 16 (64) multiply-adds.
#pragma once

#include <cuda_runtime.h>

#include "chain.cuh"

namespace brief {
namespace wide {

constexpr int kOB = 64;                  // outputs (inputs) per product block
constexpr int kKS = 32;                  // slab depth
constexpr int kSlabStride = kKS + 4;     // input-gradient slab row, floats
constexpr int kSlab = kOB * kSlabStride; // floats per slab buffer (>= kKS * kOB)

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kN>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN));
}

// Layer l's row of the wide layout's table (ops/fused_train.py
// wide_table): its widths and activation, its parameters' offset in the
// packed parameters (W (fin, fout), then b), its packed copy's offset and
// row stride, its scratch rows (input, h, d / g; h_row -1 for the last
// layer), its unit mask's offset (-1: none), its dW tiles [tile0,
// tile_end), w0.
struct __align__(16) Layer {
  int fin, fout, act, p_off, wp_off, colpad, x_row, h_row, g_row, mask_off;
  int tile0, tile_end;
  float w0;
  int pad[3];
};
static_assert(sizeof(Layer) == 64, "ops/fused_train.py WIDE_ROW_WORDS");

// wp[fb][wp_off + r * colpad + c] = W[r][c] (r < fin), b[c] (r == fin), 0
// elsewhere, for layer l = blockIdx.y of chain fb = blockIdx.z.
__global__ void pack_weights_kernel(const float* __restrict__ params,
                                    float* __restrict__ wp,
                                    const Layer* __restrict__ layers,
                                    int n_params, int wp_total) {
  const Layer ly = ld_row(layers + blockIdx.y);
  params += (size_t)blockIdx.z * n_params + ly.p_off;
  wp += (size_t)blockIdx.z * wp_total + ly.wp_off;
  const int size = round_up(ly.fin + 1, kOB) * ly.colpad;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < size;
       e += gridDim.x * blockDim.x) {
    const int r = e / ly.colpad, c = e - r * ly.colpad;
    wp[e] = (r <= ly.fin && c < ly.fout) ? params[r * ly.fout + c] : 0.f;
  }
}

// `blocks` blocks of 256 threads per layer: ops/fused_train.py sizes them
// for its largest packed layer.
inline cudaError_t pack_weights(const float* params, float* wp,
                                const Layer* layers, int n_layers,
                                int n_params, int wp_total, int n_fleet,
                                int blocks, cudaStream_t s) {
  pack_weights_kernel<<<dim3(blocks, n_layers, n_fleet), 256, 0, s>>>(
      params, wp, layers, n_params, wp_total);
  return cudaGetLastError();
}

// acc[a][c] = sum_{k < kend} Wp[k][o0 + 4 oq + a] * X[k][4 cu + c]: the
// pre-activation of outputs o0 .. o0 + 63 of the tile.  Wp: a layer's
// packed weights (row stride colpad); X: the input rows in shared memory
// (kend a multiple of kKS), rows fin .. kend - 1 a ones row then zeros.
// `slab`: 2 * kSlab floats.  Called by every thread; ends after a
// barrier.
template <int kT>
__device__ __forceinline__ void forward_block(const float* __restrict__ Wp,
                                              int colpad, int o0, int kend,
                                              const float* X, float* slab,
                                              float (&acc)[4][4]) {
  constexpr int kNT = 4 * kT, kCQ = kT / 4;
  const int t = threadIdx.x, cu = t % kCQ, oq = t / kCQ;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  const int ns = kend / kKS;
  auto load = [&](int s) {
    float* dst = slab + (s & 1) * kSlab;
    const float* src = Wp + (size_t)s * kKS * colpad + o0;
    for (int j = t; j < kKS * (kOB / 4); j += kNT) {
      const int r = j / (kOB / 4), q = j % (kOB / 4);
      cp16(dst + r * kOB + 4 * q, src + (size_t)r * colpad + 4 * q);
    }
    cp_commit();
  };
  load(0);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      load(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* w = slab + (s & 1) * kSlab + 4 * oq;
    const float* x = X + (size_t)s * kKS * kT + 4 * cu;
#pragma unroll 8
    for (int k = 0; k < kKS; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(w + k * kOB);
      const float4 xv = *reinterpret_cast<const float4*>(x + k * kT);
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(wa[a], xa[c], acc[a][c]);
    }
    __syncthreads();   // the slab is refilled two steps on
  }
}

// acc[a][c] = sum_{o < oend} Wp[i0 + 4 iq + a][o] * G[o][4 cu + c]: inputs
// i0 .. i0 + 63 of W_l g_l for the tile (oend a multiple of kKS, rows of G
// in shared memory from fout on zero).  Walks W's rows along o: no
// transposed copy.
template <int kT>
__device__ __forceinline__ void input_grad_block(const float* __restrict__ Wp,
                                                 int colpad, int i0, int oend,
                                                 const float* G, float* slab,
                                                 float (&acc)[4][4]) {
  constexpr int kNT = 4 * kT, kCQ = kT / 4;
  const int t = threadIdx.x, cu = t % kCQ, iq = t / kCQ;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  const int ns = oend / kKS;
  auto load = [&](int s) {
    float* dst = slab + (s & 1) * kSlab;
    const float* src = Wp + (size_t)i0 * colpad + s * kKS;
    for (int j = t; j < kOB * (kKS / 4); j += kNT) {
      const int r = j / (kKS / 4), q = j % (kKS / 4);
      cp16(dst + r * kSlabStride + 4 * q, src + (size_t)r * colpad + 4 * q);
    }
    cp_commit();
  };
  load(0);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      load(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* w = slab + (s & 1) * kSlab + 4 * iq * kSlabStride;
    const float* g = G + (size_t)s * kKS * kT + 4 * cu;
#pragma unroll 2
    for (int o = 0; o < kKS; o += 4) {
      float4 gv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        gv[b] = *reinterpret_cast<const float4*>(g + (o + b) * kT);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 wv =
            *reinterpret_cast<const float4*>(w + a * kSlabStride + o);
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][0] = fmaf(wa[b], gv[b].x, acc[a][0]);
          acc[a][1] = fmaf(wa[b], gv[b].y, acc[a][1]);
          acc[a][2] = fmaf(wa[b], gv[b].z, acc[a][2]);
          acc[a][3] = fmaf(wa[b], gv[b].w, acc[a][3]);
        }
      }
    }
    __syncthreads();
  }
}

// Rows [from, to) of a tile buffer: a row of ones at `from` when `ones`,
// zeros after it.  Called by every thread, no barrier.
template <int kT>
__device__ __forceinline__ void fill_rows(float* A, int from, int to,
                                          bool ones) {
  for (int e = threadIdx.x; e < (to - from) * kT; e += 4 * kT) {
    A[from * kT + e] = (ones && e < kT) ? 1.f : 0.f;
  }
}

}  // namespace wide
}  // namespace brief
