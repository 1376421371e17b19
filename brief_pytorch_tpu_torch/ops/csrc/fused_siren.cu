// Fused batch-major forward of a plain activation chain for explicitly
// given coordinates, for Hopper.
//
// Replaces the Pallas TPU kernel of brief_pytorch_tpu/ops/pallas_siren.py
// (_make_kernel / _fused_forward, entry fused_chain_apply):
// h <- act_l(w0_l * (h @ W_l + b_l)) through every layer, coords (N, C)
// row-major -> out (N, Cout) row-major, with no activation written to
// device memory between layers.
//
// What bounds it on an H100: operations.  SIREN 5 x 22 on N = 262,144
// coordinates reads and writes ~4.2 MB (3.35 TB/s: ~1.3 us) but does ~0.8
// GFLOP of chain products plus 88 sines per coordinate (67 TFLOP/s
// float32: ~16 us).  Tensor cores are unused: float32 CUDA-core arithmetic
// in the plain version's order of multiply-adds keeps the two within
// float32 rounding.
//
// Design (not the TPU kernel's (tile, f) batch-major tiles padded to 128
// lanes):
//  * A block owns a tile of T consecutive coordinates.  It copies their
//    T * C floats from the (N, C) array with consecutive threads on
//    consecutive addresses, and masks the tail of the last tile itself, so
//    N needs no padding on the host.  Indices are 64-bit.
//  * Activations are feature-major in shared memory, one column per
//    coordinate, ping-ponging between two buffers of max(widths) rows.
//  * Q = blockDim.x / T threads share a coordinate: thread (q, u) computes
//    chunks q, q + Q, ... of 8 output features of a layer for coordinate
//    u, eight accumulators in registers while the input column streams
//    once from shared memory, then a barrier.  A warp holds 32 coordinates
//    of one q, so weight loads are broadcasts and activation loads are
//    conflict-free.  Q is 1 for narrow chains (many blocks per SM) and up
//    to 16 for wide ones, whose large tile leaves one block per SM.
//  * Two layouts of the weights (kSmemW), both W (fin, round8(fout)) with
//    zero-padded columns, then the bias:
//    - narrow chains: in shared memory for the whole block;
//    - wide chains (e.g. 3-186x4-1, 428 KB of weights): a padded copy in
//      device memory, made by a small kernel before the main one and read
//      through the read-only path with 16-byte loads (it stays in L2).
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

using brief::kChunk;
using brief::kMaxLayers;
using brief::round_up8;

constexpr int kMaxThreads = 512;

struct SirenDesc {
  int n_layers, c_in, c_out, tile, act_off, buf_rows, padded;
  int fin[kMaxLayers], fout[kMaxLayers], act[kMaxLayers];
  int p_off[kMaxLayers], pw_off[kMaxLayers];
  float w0[kMaxLayers];
};

constexpr int kMetaHead = 7;
constexpr int kMetaPerLayer = 5;

template <bool kSmemW>
__device__ __forceinline__ float4 load4(const float* p) {
  if (kSmemW) return *reinterpret_cast<const float4*>(p);
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <bool kSmemW>
__device__ __forceinline__ float load1(const float* p) {
  return kSmemW ? *p : __ldg(p);
}

// Rows [out_row, out_row + fout) of column u = act(W^T in + b) for the
// output chunks o0 = o_begin, o_begin + o_step, ...; the multiply-adds of
// chain.cuh's layer_forward in the same order.  w: W (fin, round8(fout))
// then the bias, in shared (kSmemW) or device memory.
template <bool kSmemW>
__device__ __forceinline__ void layer_chunks(const float* __restrict__ w,
                                             float* A, int S, int u,
                                             int in_row, int fin, int fout,
                                             int act, float w0, int out_row,
                                             int o_begin, int o_step) {
  const int fop = round_up8(fout);
  const float* bias = w + fin * fop;
  for (int o0 = o_begin; o0 < fout; o0 += o_step) {
    float z[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) z[k] = 0.f;
    for (int i = 0; i < fin; ++i) {
      const float x = A[(in_row + i) * S + u];
      const float4 wa = load4<kSmemW>(w + i * fop + o0);
      const float4 wb = load4<kSmemW>(w + i * fop + o0 + 4);
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
        A[(out_row + o) * S + u] =
            brief::act_only(act, w0, z[k] + load1<kSmemW>(bias + o));
      }
    }
  }
}

// The padded copy of the packed parameters for the wide layout: per layer
// W (fin, round8(fout)) with zero columns, then the bias padded likewise.
__global__ void pad_params_kernel(const float* __restrict__ params,
                                  float* __restrict__ padded, SirenDesc d) {
  const int l = blockIdx.y;
  const int fin = d.fin[l], fout = d.fout[l], fop = round_up8(fout);
  const float* src = params + d.p_off[l];
  float* dst = padded + d.pw_off[l];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < (fin + 1) * fop;
       e += gridDim.x * blockDim.x) {
    const int i = e / fop, o = e - i * fop;   // row fin is the bias
    dst[e] = o < fout ? src[i * fout + o] : 0.f;
  }
}

template <bool kSmemW>
__global__ void __launch_bounds__(kMaxThreads)
fused_siren_kernel(const float* __restrict__ coords,
                   const float* __restrict__ params,
                   float* __restrict__ out, long long n, SirenDesc d) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, NT = blockDim.x, T = d.tile, L = d.n_layers;
  const int Q = NT / T, u = t % T, q = t / T;
  float* A = sm + d.act_off;

  if (kSmemW) {
    for (int l = 0; l < L; ++l) {
      float* sw = sm + d.pw_off[l];
      brief::load_weights(params + d.p_off[l], d.fin[l], d.fout[l], sw,
                          nullptr, sw + d.fin[l] * round_up8(d.fout[l]));
    }
  }

  // the tile's coordinates: a contiguous run of T * C floats of the (N, C)
  // array, transposed into rows [0, C) of the first buffer
  const long long first = (long long)blockIdx.x * T;
  const long long total = n * d.c_in;
  for (int e = t; e < T * d.c_in; e += NT) {
    const long long g = first * d.c_in + e;
    const int row = e % d.c_in, col = e / d.c_in;
    A[row * T + col] = g < total ? coords[g] : 0.f;
  }
  __syncthreads();

  int in_row = 0;
  for (int l = 0; l < L; ++l) {
    const int out_row = in_row == 0 ? d.buf_rows : 0;
    const float* w = kSmemW ? sm + d.pw_off[l] : params + d.pw_off[l];
    layer_chunks<kSmemW>(w, A, T, u, in_row, d.fin[l], d.fout[l], d.act[l],
                         d.w0[l], out_row, q * kChunk, Q * kChunk);
    in_row = out_row;
    // the Q threads of a column share it: the next layer's input must be whole
    __syncthreads();
  }

  const long long total_out = n * d.c_out;
  for (int e = t; e < T * d.c_out; e += NT) {
    const long long g = first * d.c_out + e;
    const int row = e % d.c_out, col = e / d.c_out;
    if (g < total_out) out[g] = A[(in_row + row) * T + col];
  }
}

}  // namespace

extern "C" {

// meta: n_layers, c_in, c_out, tile, act_off, buf_rows, padded, then per
// layer: fin, fout, act, p_off, pw_off.  w0: one per layer.  params: the
// packed (W, b) of every layer; scratch: `padded` floats of device memory
// for the wide layout (smem_weights 0), else unused.
int brief_fused_siren(const float* coords, const float* params,
                      float* scratch, float* out, long long n,
                      const int* meta, const float* w0, int smem_weights,
                      int threads, int smem_bytes, void* stream) {
  SirenDesc d;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || d.n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.tile = meta[3];
  d.act_off = meta[4];
  d.buf_rows = meta[5];
  d.padded = meta[6];
  if (d.tile < 1 || threads > kMaxThreads || threads % d.tile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < d.n_layers; ++l) {
    const int* lm = meta + kMetaHead + kMetaPerLayer * l;
    d.fin[l] = lm[0];
    d.fout[l] = lm[1];
    d.act[l] = lm[2];
    d.p_off[l] = lm[3];
    d.pw_off[l] = lm[4];
    d.w0[l] = w0[l];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long grid = (n + d.tile - 1) / d.tile;
  if (grid < 1 || grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem_weights) {
    err = cudaFuncSetAttribute(fused_siren_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    fused_siren_kernel<true><<<(unsigned)grid, threads, smem_bytes, s>>>(
        coords, params, out, n, d);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    pad_params_kernel<<<dim3(8, d.n_layers), 256, 0, s>>>(params, scratch, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fused_siren_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    fused_siren_kernel<false><<<(unsigned)grid, threads, smem_bytes, s>>>(
        coords, scratch, out, n, d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
