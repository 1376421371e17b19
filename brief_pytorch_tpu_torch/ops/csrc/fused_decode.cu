// Fused full-grid decode of a plain activation chain, for Hopper.
//
// Replaces the Pallas TPU kernel of brief_pytorch_tpu/ops/pallas_decode.py
// (_make_decode_kernel / _plane_coords / _decode_grid_padded /
// fused_decode_grid): the chain's forward over every voxel of the grid,
// with each voxel's coordinates built inside the kernel.  Output: (pop,
// Cout) float32 in row-major voxel order.
//
// What bounds it on an H100: operations.  A 256^3 grid at f = 22 writes
// 67 MB (3.3 TB/s: ~20 us) but does ~52 GFLOP of chain products plus 88
// sines per voxel (67 TFLOP/s float32: ~0.8 ms).
//
// Design:
//  * One thread per voxel, blocks of T voxels.  The thread splits its flat
//    index into the lead-axis index and the plane axes' indices.  The lead
//    coordinate is lo + i * step (rounded as the TPU kernel does, with no
//    fused multiply-add); the plane coordinates are looked up in small
//    per-axis tables of axis_linspace values that the wrapper builds, so
//    they equal the plain version's bit for bit.  The SIRENPos warp is
//    folded into the tables and into the lead coordinate.
//  * All weights live in shared memory for the whole block; activations
//    ping-pong between two shared buffers, one column per thread.
//  * This kernel takes a chain whose weights plus 2 * max_width * T
//    activation floats fit the 227 KB (232,448 bytes) a block may use
//    (ops/fused_decode.py lowers T from 128 to 64 to 32); a wider chain
//    takes the wide form below.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "wide.cuh"

namespace {

using brief::kMaxLayers;

constexpr int kMaxPlaneAxes = 3;

struct DecodeDesc {
  int n_layers, c_in, c_out, stride, act_off, buf_rows;
  int n_plane, has_enc;
  long long plane_size[kMaxPlaneAxes];
  int table_off[kMaxPlaneAxes];
  float lo, step, enc_scale0;
  int fin[kMaxLayers], fout[kMaxLayers], act[kMaxLayers];
  int p_off[kMaxLayers], sw_off[kMaxLayers], sb_off[kMaxLayers];
  float w0[kMaxLayers];
};

__global__ void fused_decode_kernel(const float* __restrict__ params,
                                    const float* __restrict__ tables,
                                    float* __restrict__ out, long long pop,
                                    long long plane, DecodeDesc d) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, S = d.stride, L = d.n_layers;
  for (int l = 0; l < L; ++l) {
    brief::load_weights(params + d.p_off[l], d.fin[l], d.fout[l],
                        sm + d.sw_off[l], nullptr, sm + d.sb_off[l]);
  }
  __syncthreads();

  const long long v = (long long)blockIdx.x * blockDim.x + t;
  const bool valid = v < pop;
  const long long vv = valid ? v : pop - 1;
  const long long lead = vv / plane;
  long long p = vv - lead * plane;

  // two activation buffers of buf_rows rows each: rows [0, buf_rows) and
  // [buf_rows, 2 * buf_rows); layer l reads one and writes the other
  float* A = sm + d.act_off;
  float z0 = __fadd_rn(d.lo, __fmul_rn((float)lead, d.step));
  if (d.has_enc) z0 = brief::fast_sin(__fmul_rn(d.enc_scale0, z0));
  A[t] = z0;
  for (int a = d.n_plane - 1; a >= 0; --a) {
    const long long ia = p % d.plane_size[a];
    p /= d.plane_size[a];
    A[(1 + a) * S + t] = tables[d.table_off[a] + ia];
  }
  int in_row = 0;
  for (int l = 0; l < L; ++l) {
    const int out_row = in_row == 0 ? d.buf_rows : 0;
    brief::layer_forward<false>(sm + d.sw_off[l], sm + d.sb_off[l], A, S, t,
                                in_row, d.fin[l], d.fout[l], d.act[l],
                                d.w0[l], out_row, 0);
    in_row = out_row;
  }
  if (valid) {
    for (int c = 0; c < d.c_out; ++c) {
      out[vv * d.c_out + c] = A[(in_row + c) * S + t];
    }
  }
}


// ---------------------------------------------------------------------------
// The wide form: chains whose weights do not fit in shared memory (the
// SingleTask default on the 64x512x512 demo volumes, 5 x 191 and 5 x 242),
// forward only, on the train kernel's wide-layout products (csrc/wide.cuh):
// a block decodes kT voxels with 4 * kT threads, builds their coordinates
// as fused_decode_kernel does (the same formulas and tables, bit for bit)
// into one activation buffer, and runs each layer as 64-output blocks over
// W slabs streamed through shared memory, the activations ping-ponging
// between two buffers.  Bound: operations (64x512x512 at 5 x 191: 3.7
// TFLOP, 55 ms at 67 TFLOP/s).
// ---------------------------------------------------------------------------
namespace wl = brief::wide;

struct WideDecodeDesc {
  int n_layers, c_in, c_out, rows_max, n_plane, has_enc;
  long long plane_size[kMaxPlaneAxes];
  int table_off[kMaxPlaneAxes];
  float lo, step, enc_scale0;
  int fin[kMaxLayers], fout[kMaxLayers], act[kMaxLayers];
  int wp_off[kMaxLayers], colpad[kMaxLayers];
  float w0[kMaxLayers];
};

template <int kT>
__global__ void __launch_bounds__(4 * kT) fused_decode_wide_kernel(
    const float* __restrict__ wp, const float* __restrict__ tables,
    float* __restrict__ out, long long pop, long long plane,
    WideDecodeDesc d) {
  constexpr int kNT = 4 * kT, kCQ = kT / 4;
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, cu = t % kCQ, q4 = 4 * (t / kCQ);
  float* X = sm;
  float* Y = sm + d.rows_max * kT;
  float* slab = sm + 2 * d.rows_max * kT;
  const long long base = (long long)blockIdx.x * kT;

  // coordinates, a ones row, zeros to the slab boundary
  const int c_end = wl::round_up(d.c_in + 1, wl::kKS);
  for (int e = t; e < c_end * kT; e += kNT) {
    const int r = e / kT, u = e - r * kT;
    float v = r == d.c_in ? 1.f : 0.f;
    if (r < d.c_in) {
      const long long vx = base + u;
      const long long vv = vx < pop ? vx : pop - 1;
      const long long lead = vv / plane;
      long long p = vv - lead * plane;
      if (r == 0) {
        v = __fadd_rn(d.lo, __fmul_rn((float)lead, d.step));
        if (d.has_enc) v = brief::fast_sin(__fmul_rn(d.enc_scale0, v));
      } else {
        const int a = r - 1;
        for (int b = d.n_plane - 1; b > a; --b) p /= d.plane_size[b];
        v = tables[d.table_off[a] + p % d.plane_size[a]];
      }
    }
    X[e] = v;
  }
  __syncthreads();

  float acc[4][4];
  for (int l = 0; l < d.n_layers; ++l) {
    const int fout = d.fout[l];
    for (int o0 = 0; o0 < fout; o0 += wl::kOB) {
      wl::forward_block<kT>(wp + d.wp_off[l], d.colpad[l], o0,
                            wl::round_up(d.fin[l] + 1, wl::kKS), X, slab,
                            acc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int o = o0 + q4 + a;
        if (o >= fout) continue;
        float h[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          h[c] = brief::act_only(d.act[l], d.w0[l], acc[a][c]);
        *reinterpret_cast<float4*>(Y + o * kT + 4 * cu) =
            make_float4(h[0], h[1], h[2], h[3]);
      }
    }
    wl::fill_rows<kT>(Y, fout, wl::round_up(fout + 1, wl::kKS), true);
    __syncthreads();
    float* sw = X;
    X = Y;
    Y = sw;
  }
  for (int e = t; e < kT * d.c_out; e += kNT) {
    const int u = e / d.c_out, c = e - u * d.c_out;
    if (base + u < pop) out[(base + u) * d.c_out + c] = X[c * kT + u];
  }
}

template <int kT>
cudaError_t launch_wide(long long pop, long long plane, int smem_bytes,
                        cudaStream_t s, const float* wp, const float* tables,
                        float* out, const WideDecodeDesc& d) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_wide_kernel<kT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const long long grid = (pop + kT - 1) / kT;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_decode_wide_kernel<kT><<<(unsigned)grid, 4 * kT, smem_bytes, s>>>(
      wp, tables, out, pop, plane, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// meta: n_layers, c_in, c_out, stride, act_off, buf_rows, n_plane, has_enc,
// plane_size[3], table_off[3], then per layer: fin, fout, act, p_off,
// sw_off, sb_off.  fmeta: lo, step, enc_scale0, then w0 per layer.
int brief_fused_decode(const float* params, const float* tables, float* out,
                       long long pop, const int* meta, const float* fmeta,
                       int block, int smem_bytes, void* stream) {
  DecodeDesc d;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || d.n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.stride = meta[3];
  d.act_off = meta[4];
  d.buf_rows = meta[5];
  d.n_plane = meta[6];
  d.has_enc = meta[7];
  if (d.n_plane < 1 || d.n_plane > kMaxPlaneAxes) return (int)cudaErrorInvalidValue;
  long long plane = 1;
  for (int a = 0; a < kMaxPlaneAxes; ++a) {
    d.plane_size[a] = meta[8 + a];
    d.table_off[a] = meta[8 + kMaxPlaneAxes + a];
    if (a < d.n_plane) plane *= d.plane_size[a];
  }
  const int* lm = meta + 8 + 2 * kMaxPlaneAxes;
  for (int l = 0; l < d.n_layers; ++l) {
    d.fin[l] = lm[6 * l + 0];
    d.fout[l] = lm[6 * l + 1];
    d.act[l] = lm[6 * l + 2];
    d.p_off[l] = lm[6 * l + 3];
    d.sw_off[l] = lm[6 * l + 4];
    d.sb_off[l] = lm[6 * l + 5];
    d.w0[l] = fmeta[3 + l];
  }
  d.lo = fmeta[0];
  d.step = fmeta[1];
  d.enc_scale0 = fmeta[2];
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (pop + block - 1) / block;
  fused_decode_kernel<<<(unsigned)grid, block, smem_bytes, (cudaStream_t)stream>>>(
      params, tables, out, pop, plane, d);
  return (int)cudaGetLastError();
}


// The wide form (ops/fused_decode.py wide_plan).  meta: n_layers, c_in,
// c_out, rows_max, n_plane, has_enc, n_params, wp_total, plane_size[3],
// table_off[3], then per layer: fin, fout, act, p_off, wp_off, colpad.
// fmeta: lo, step, enc_scale0, then w0 per layer.  wp: (wp_total,)
// scratch for the packed weights.  `tile` voxels per block (64, 32, 16 or
// 8).
int brief_fused_decode_wide(const float* params, float* wp,
                            const float* tables, float* out, long long pop,
                            const int* meta, const float* fmeta, int tile,
                            int smem_bytes, void* stream) {
  WideDecodeDesc d;
  brief::wide::Packed pk;
  d.n_layers = pk.n_layers = meta[0];
  if (d.n_layers < 1 || d.n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.rows_max = meta[3];
  d.n_plane = meta[4];
  d.has_enc = meta[5];
  pk.n_params = meta[6];
  pk.wp_total = meta[7];
  if (d.n_plane < 1 || d.n_plane > kMaxPlaneAxes)
    return (int)cudaErrorInvalidValue;
  long long plane = 1;
  for (int a = 0; a < kMaxPlaneAxes; ++a) {
    d.plane_size[a] = meta[8 + a];
    d.table_off[a] = meta[8 + kMaxPlaneAxes + a];
    if (a < d.n_plane) plane *= d.plane_size[a];
  }
  const int* lm = meta + 8 + 2 * kMaxPlaneAxes;
  for (int l = 0; l < d.n_layers; ++l) {
    d.fin[l] = pk.fin[l] = lm[6 * l + 0];
    d.fout[l] = pk.fout[l] = lm[6 * l + 1];
    d.act[l] = lm[6 * l + 2];
    pk.p_off[l] = lm[6 * l + 3];
    d.wp_off[l] = pk.wp_off[l] = lm[6 * l + 4];
    d.colpad[l] = pk.colpad[l] = lm[6 * l + 5];
    d.w0[l] = fmeta[3 + l];
  }
  pk.wp_off[d.n_layers] = pk.wp_total;
  d.lo = fmeta[0];
  d.step = fmeta[1];
  d.enc_scale0 = fmeta[2];
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = brief::wide::pack_weights(params, wp, pk, 1, s);
  if (err != cudaSuccess) return (int)err;
  switch (tile) {
    case 64: err = launch_wide<64>(pop, plane, smem_bytes, s, wp, tables,
                                   out, d); break;
    case 32: err = launch_wide<32>(pop, plane, smem_bytes, s, wp, tables,
                                   out, d); break;
    case 16: err = launch_wide<16>(pop, plane, smem_bytes, s, wp, tables,
                                   out, d); break;
    case 8: err = launch_wide<8>(pop, plane, smem_bytes, s, wp, tables,
                                 out, d); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
