// Fused train-step gradients of a plain activation chain, for Hopper.
//
// Replaces the Pallas TPU kernel of brief_pytorch_tpu/ops/pallas_train.py
// (_make_train_kernel / _fused_grads_padded / fused_train_grads): one pass
// over a coordinate batch runs the chain forward (storing each layer's
// activation h_l and derivative d_l; for sine one range reduction gives
// both), the weighted datal2 / datasmoothl1 loss with the weight_thres
// override, and a backward with no transcendentals that sums dW and db
// over the batch.  Output: loss and gradients divided by N * Cout.
//
// What bounds it on an H100: operations.  At the default run's shapes
// (SIREN 5 x 22, N = 262,144) it reads ~5 MB (3.3 TB/s: ~1.6 us) but
// does ~2.4 GFLOP of chain products plus ~88 sincos per coordinate
// (67 TFLOP/s float32: ~45 us).  Tensor cores are unused: the chain is
// 22 wide, and this first version keeps float32 CUDA-core arithmetic so
// it agrees with the plain version to float32 rounding.
//
// Design:
//  * A block owns a tile of T coordinates (T = blockDim.x, one per
//    thread) and walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...
//    (a persistent grid of a few blocks per SM), so the TPU grid's
//    in-order accumulation becomes a loop inside the block.
//  * h_l and d_l of the tile stay in shared memory, one column per
//    thread (rows padded to T + 1 floats so that the weight-gradient
//    phase, where a warp reads one column index across many rows, hits
//    distinct banks).  Nothing per coordinate goes to device memory.
//  * Weights live in shared memory for the whole block, twice: W padded
//    for the forward chunks and W^T padded for the backward's input
//    gradient.
//  * Weight gradients: after a layer's output gradient g_l is in shared
//    memory, thread t owns parameter entries e = t, t + T, ... of that
//    layer and sums g_l[o] * h_{l-1}[i] over the tile's coordinates into
//    a per-block accumulator in shared memory.  At the end each block
//    writes its partial sums; a second kernel adds the partials of all
//    blocks in block order.  No float atomics: the result is the same on
//    every run with the same grid.
//  * The input gradient g_{l-1} = d_{l-1} * (W_l g_l) overwrites d_{l-1}
//    in place, in the thread's own column.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

using brief::kMaxLayers;
using brief::round_up8;

struct TrainDesc {
  int n_layers, c_in, c_out, n_params, stride;
  int acc_off, red_off, act_off;
  int fin[kMaxLayers], fout[kMaxLayers], act[kMaxLayers];
  int p_off[kMaxLayers], sw_off[kMaxLayers], swt_off[kMaxLayers];
  int sb_off[kMaxLayers], h_row[kMaxLayers], dg_row[kMaxLayers];
  float w0[kMaxLayers];
};

constexpr int kMetaHead = 8;
constexpr int kMetaPerLayer = 9;

__global__ void fused_train_kernel(const float* __restrict__ coords,
                                   const float* __restrict__ values,
                                   const float* __restrict__ weights,
                                   const float* __restrict__ params,
                                   float* __restrict__ partial, int n,
                                   TrainDesc d, int loss, float beta,
                                   int has_thres, float thres) {
  extern __shared__ __align__(16) float sm[];
  const int T = blockDim.x, t = threadIdx.x, S = d.stride, L = d.n_layers;
  float* acc = sm + d.acc_off;
  float* A = sm + d.act_off;

  for (int l = 0; l < L; ++l) {
    brief::load_weights(params + d.p_off[l], d.fin[l], d.fout[l],
                        sm + d.sw_off[l], sm + d.swt_off[l], sm + d.sb_off[l]);
  }
  for (int e = t; e < d.n_params; e += T) acc[e] = 0.f;
  float loss_acc = 0.f;
  __syncthreads();

  const int n_tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int idx = tile * T + t;
    const bool valid = idx < n;

    // ---- forward: own column; h_l and d_l into shared memory ----
    for (int c = 0; c < d.c_in; ++c) {
      A[c * S + t] = valid ? coords[(size_t)c * n + idx] : 0.f;
    }
    for (int l = 0; l < L; ++l) {
      brief::layer_forward<true>(sm + d.sw_off[l], sm + d.sb_off[l], A, S, t,
                                 l == 0 ? 0 : d.h_row[l - 1], d.fin[l],
                                 d.fout[l], d.act[l], d.w0[l], d.h_row[l],
                                 d.dg_row[l]);
    }

    // ---- loss and dL/dz of the last layer (padding lanes weigh 0) ----
    const int last = L - 1;
    for (int c = 0; c < d.c_out; ++c) {
      const float p = A[(d.h_row[last] + c) * S + t];
      float y = 0.f, wv = 0.f;
      if (valid) {
        y = values[(size_t)c * n + idx];
        wv = weights[(size_t)c * n + idx];
      }
      float weff = (has_thres && p <= thres) ? 1.f : wv;
      weff = valid ? weff : 0.f;
      const float e = p - y;
      float le, g;
      if (loss == 0) {  // datal2
        le = e * e;
        g = 2.f * weff * e;
      } else {          // datasmoothl1
        const float ae = fabsf(e);
        le = ae < beta ? 0.5f * ae * ae / beta : ae - 0.5f * beta;
        const float sg = (float)((e > 0.f) - (e < 0.f));
        g = weff * (ae < beta ? e / beta : sg);
      }
      loss_acc += weff * le;
      float* dg = &A[(d.dg_row[last] + c) * S + t];
      *dg = g * *dg;
    }
    __syncthreads();

    // ---- backward, last layer first ----
    for (int l = L - 1; l >= 0; --l) {
      const int fin = d.fin[l], fout = d.fout[l];
      const float* G = A + d.dg_row[l] * S;
      const float* H = A + (l == 0 ? 0 : d.h_row[l - 1]) * S;
      float* accl = acc + d.p_off[l];
      const int nw = fin * fout;
      // weight and bias gradients: reads every column of g_l and h_{l-1}
      for (int e = t; e < nw + fout; e += T) {
        float s = 0.f;
        if (e < nw) {
          const int i = e / fout, o = e - i * fout;
          const float* g = G + o * S;
          const float* h = H + i * S;
          for (int u = 0; u < T; ++u) s = fmaf(g[u], h[u], s);
        } else {
          const float* g = G + (e - nw) * S;
          for (int u = 0; u < T; ++u) s += g[u];
        }
        accl[e] += s;
      }
      // input gradient into d_{l-1}, own column only
      if (l > 0) {
        const float* swt = sm + d.swt_off[l];
        const int fip = round_up8(fin);
        float* D = A + d.dg_row[l - 1] * S;
        for (int i0 = 0; i0 < fin; i0 += brief::kChunk) {
          float z[brief::kChunk];
#pragma unroll
          for (int k = 0; k < brief::kChunk; ++k) z[k] = 0.f;
          for (int o = 0; o < fout; ++o) {
            const float x = G[o * S + t];
            const float4 wa =
                *reinterpret_cast<const float4*>(swt + o * fip + i0);
            const float4 wb =
                *reinterpret_cast<const float4*>(swt + o * fip + i0 + 4);
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
          for (int k = 0; k < brief::kChunk; ++k) {
            const int i = i0 + k;
            if (i < fin) D[i * S + t] = z[k] * D[i * S + t];
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- this block's partial sums: gradients, then the loss ----
  float* out = partial + (size_t)blockIdx.x * (d.n_params + 1);
  for (int e = t; e < d.n_params; e += T) out[e] = acc[e];
  float* red = sm + d.red_off;
  red[t] = loss_acc;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  if (t == 0) out[d.n_params] = red[0];
}

// out[p] = (sum over blocks b, in order, of partial[b][p]) / m
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int n_blocks,
                                       int width, float m) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= width) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * width + p];
  out[p] = s / m;
}

}  // namespace

extern "C" {

// Blocks of `block` threads using `smem_bytes` of dynamic shared memory
// that fit on one SM at once, and the device's SM count.
int brief_fused_train_occupancy(int block, int smem_bytes, int* blocks_per_sm,
                                int* sm_count) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_train_kernel, block, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// meta: n_layers, c_in, c_out, n_params, stride, acc_off, red_off, act_off,
// then per layer: fin, fout, act, p_off, sw_off, swt_off, sb_off, h_row,
// dg_row.  partial: (grid, n_params + 1) scratch; out: (n_params + 1,),
// the gradients in the packed parameter layout followed by the loss.
int brief_fused_train(const float* coords, const float* values,
                      const float* weights, const float* params,
                      float* partial, float* out, int n, const int* meta,
                      const float* w0s, int loss, float beta, int has_thres,
                      float thres, int grid, int block, int smem_bytes,
                      void* stream) {
  TrainDesc d;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || d.n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.n_params = meta[3];
  d.stride = meta[4];
  d.acc_off = meta[5];
  d.red_off = meta[6];
  d.act_off = meta[7];
  for (int l = 0; l < d.n_layers; ++l) {
    const int* m = meta + kMetaHead + kMetaPerLayer * l;
    d.fin[l] = m[0];
    d.fout[l] = m[1];
    d.act[l] = m[2];
    d.p_off[l] = m[3];
    d.sw_off[l] = m[4];
    d.swt_off[l] = m[5];
    d.sb_off[l] = m[6];
    d.h_row[l] = m[7];
    d.dg_row[l] = m[8];
    d.w0[l] = w0s[l];
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      fused_train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  fused_train_kernel<<<grid, block, smem_bytes, s>>>(
      coords, values, weights, params, partial, n, d, loss, beta, has_thres,
      thres);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = d.n_params + 1;
  reduce_partials_kernel<<<(width + 255) / 256, 256, 0, s>>>(
      partial, out, grid, width, (float)((double)n * d.c_out));
  return (int)cudaGetLastError();
}

}  // extern "C"
