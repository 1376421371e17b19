// Fused full-grid decode of a plain activation chain, for Hopper.
//
// Replaces the Pallas TPU kernel of brief_pytorch_tpu/ops/pallas_decode.py
// (_make_decode_kernel / _plane_coords / _decode_grid_padded /
// fused_decode_grid): the chain's forward over every voxel of the grid,
// with each voxel's coordinates built inside the kernel.  Output: (pop,
// Cout) float32 in row-major voxel order.
//
// What bounds it on an H100: operations.  With the products on the tensor
// cores in 3xTF32 (3 x the product flops at 495 TFLOP/s) the sines on the
// CUDA cores weigh as much as the products at 5 x 22 (64^3: ~5.5 us), and
// the products dominate at 5 x 191 (64x512x512: ~22 ms); the output (4
// bytes a voxel) is far below either.
//
// Design: the tensor-core chain of csrc/chain_tc.cuh (its narrow form,
// weights resident in shared memory and a warp's tiles in registers; its
// wide form, a TMA ring of weight slabs and 128-voxel block tiles), with
// layer 0's input from GridInput.  The narrow form splits the weights in
// each block, so a call is one launch; for the wide form pack_kernel
// splits them once per call.  Each k-block's three products are summed
// from zero and added in float32 (chain_tc.cuh), float32's accuracy.
//  * Coordinates are built as the TPU kernel builds them, bit for bit as
//    the plain version does: the lead axis lo + i * step (no fused
//    multiply-add, SIRENPos-warped), the other axes from small
//    axis_linspace tables the wrapper builds.  The flat voxel index
//    splits into axis indices with 32-bit multiply-shift divisions
//    prepared on the host (ops/fused_decode.py fast_divisor); grids of
//    2^31 voxels or more take 64-bit division.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_tc.cuh"

namespace {

using brief::ChainDesc;
using brief::kMaxLayers;
using brief::kWideStride;
using brief::kWideVox;

constexpr int kMaxPlaneAxes = 3;

// n / d for 0 <= n < 2^31 (ops/fused_decode.py fast_divisor): the high
// word of n * mul shifted right; mul = 0 stands for d = 1.
struct FastDiv {
  unsigned mul;
  int shift;
};

__device__ __forceinline__ int fast_div(int n, FastDiv f) {
  return f.mul == 0u ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shift);
}

// Layer 0's input of voxel v: its coordinates, built from the grid.
struct GridInput {
  const float* tables;   // axis_linspace of each plane axis
  long long plane;
  int index64;           // pop >= 2^31: 64-bit index arithmetic
  int n_plane, has_enc;
  int size[kMaxPlaneAxes], table_off[kMaxPlaneAxes];
  FastDiv div_plane, div_axis[kMaxPlaneAxes];
  float lo, step, enc_scale0;

  // Coordinate features 0 .. 3 of voxel v < pop (zeros past c_in).
  __device__ __forceinline__ void coords(long long v, float (&x)[4]) const {
    int idx[kMaxPlaneAxes];
    long long lead;
    if (!index64) {
      const int vi = (int)v;
      const int q = fast_div(vi, div_plane);
      int p = vi - q * (int)plane;
      lead = q;
#pragma unroll
      for (int k = 0; k < kMaxPlaneAxes; ++k) {
        const int a = kMaxPlaneAxes - 1 - k;
        idx[a] = 0;
        if (a < n_plane) {
          const int r = fast_div(p, div_axis[a]);
          idx[a] = p - r * size[a];
          p = r;
        }
      }
    } else {
      lead = v / plane;
      long long p = v - lead * plane;
#pragma unroll
      for (int k = 0; k < kMaxPlaneAxes; ++k) {
        const int a = kMaxPlaneAxes - 1 - k;
        idx[a] = 0;
        if (a < n_plane) {
          idx[a] = (int)(p % size[a]);
          p /= size[a];
        }
      }
    }
    float z0 = __fadd_rn(lo, __fmul_rn((float)lead, step));
    if (has_enc) z0 = brief::fast_sin(__fmul_rn(enc_scale0, z0));
    x[0] = z0;
#pragma unroll
    for (int a = 0; a < kMaxPlaneAxes; ++a)
      x[1 + a] = a < n_plane ? __ldg(tables + table_off[a] + idx[a]) : 0.f;
  }

  // The narrow form: the coordinates of voxels v0 + 16 m and + 8 in
  // k-block 0 of the C fragment layout, zeros elsewhere.
  template <int kNT, int kM>
  __device__ __forceinline__ void narrow_input(float (&h)[kM][kNT][4],
                                               long long v0, int t,
                                               const ChainDesc& d) const {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int k = 0; k < kNT; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[m][k][e] = 0.f;
      float x[4], y[4];
      const long long va = v0 + 16 * m, vb = va + 8;
      coords(va < d.n ? va : d.n - 1, x);
      coords(vb < d.n ? vb : d.n - 1, y);
      if (t < 2) {
        h[m][0][0] = t == 0 ? x[0] : x[2];
        h[m][0][1] = t == 0 ? x[1] : x[3];
        h[m][0][2] = t == 0 ? y[0] : y[2];
        h[m][0][3] = t == 0 ? y[1] : y[3];
      }
    }
  }

  // The wide form: coordinates into rows 0 .. 3, zeros into rows 4 .. 7
  __device__ __forceinline__ void wide_input(float* X, long long base,
                                             const ChainDesc& d) const {
    const int u = threadIdx.x % kWideVox, half = threadIdx.x / kWideVox;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (half == 0) {
      const long long v = base + u;
      coords(v < d.n ? v : d.n - 1, x);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) X[(4 * half + r) * kWideStride + u] = x[r];
  }
};

// Device kernels brief_fused_decode has launched in this process: one a
// call in the narrow form, two in the wide forms (pack_kernel first).
unsigned long long kernels_launched = 0;

}  // namespace

extern "C" {

// The decode of one grid (ops/fused_decode.py fused_decode_grid).
// meta: n_layers, c_in, c_out, n_plane, has_enc, index64, n_tiles, rows,
// packed_floats, stages (wide form), then size[3], table_off[3], then the divisors' (mul,
// shift) of the plane and of each plane axis (8 ints), then per layer:
// fin, fout, kb, nt, frag_off, bias_off, act.  fmeta: lo, step,
// enc_scale0, then w0 per layer.  wb: W then b of each layer (device
// pointers).  form: 0 narrow (inst = kNT), 1 wide (inst = kNW), 2 wide
// with its activations in `scratch`.  packed: (packed_floats,) scratch
// for the wide forms' split weights (unused by the narrow form).
int brief_fused_decode(const float* tables, float* out, float* packed,
                       float* scratch, const void* const* wb, long long pop,
                       const int* meta, const float* fmeta, int form,
                       int inst, int grid, int smem_bytes, void* stream) {
  ChainDesc d;
  GridInput in;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || d.n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  in.n_plane = meta[3];
  in.has_enc = meta[4];
  in.index64 = meta[5];
  d.n_tiles = meta[6];
  d.rows = meta[7];
  d.packed_floats = meta[8];
  d.stages = meta[9];
  if (in.n_plane < 1 || in.n_plane > kMaxPlaneAxes || d.c_in > 4)
    return (int)cudaErrorInvalidValue;
  d.n = pop;
  in.tables = tables;
  in.plane = 1;
  const int* m = meta + 10;
  for (int a = 0; a < kMaxPlaneAxes; ++a) {
    in.size[a] = m[a];
    in.table_off[a] = m[kMaxPlaneAxes + a];
    if (a < in.n_plane) in.plane *= m[a];
  }
  m += 2 * kMaxPlaneAxes;
  in.div_plane = FastDiv{(unsigned)m[0], m[1]};
  for (int a = 0; a < kMaxPlaneAxes; ++a)
    in.div_axis[a] = FastDiv{(unsigned)m[2 + 2 * a], m[3 + 2 * a]};
  m += 2 + 2 * kMaxPlaneAxes;
  brief::read_layers(d, m, fmeta + 3, wb);
  in.lo = fmeta[0];
  in.step = fmeta[1];
  in.enc_scale0 = fmeta[2];

  cudaStream_t s = (cudaStream_t)stream;
  if (form != 0) {
    if (packed == nullptr) return (int)cudaErrorInvalidValue;
    brief::pack_kernel<<<(d.packed_floats / 4 + 255) / 256, 256, 0, s>>>(
        packed, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++kernels_launched;
  }
  const int err = brief::launch_chain(d, in, packed, out, scratch, form,
                                      inst, grid, smem_bytes, s);
  if (err == (int)cudaSuccess) ++kernels_launched;
  return err;
}

// kernels_launched, the count of the kernels a call launches
// (fused_decode.kernels_launched); its low 31 bits.
int brief_fused_decode_kernels(void) {
  return (int)(kernels_launched & 0x7fffffffull);
}

}  // extern "C"
