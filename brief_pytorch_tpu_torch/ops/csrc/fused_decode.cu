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
//  * Gate: the weights plus 2 * max_width * T activation floats must fit
//    the 227 KB (232,448 bytes) a block may use; ops/fused_decode.py
//    lowers T from 128 to 64 to 32 before it declines a chain, which then
//    decodes through the plain torch chain in slabs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

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

}  // extern "C"
