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
//    axis_linspace tables the wrapper builds.  Each axis is a row of the
//    call's table (GridAxis, after the chain's layers).  The narrow form
//    (grids of 2 to 4 axes) copies them into its launch parameters and
//    splits the flat voxel index into the lead index and each plane
//    axis's from the last; the wide form takes any number of axes, axis
//    a's index of voxel v being v / stride_a - (v / stride_{a-1}) size_a.
//    The divisions are 32-bit multiply-shifts prepared on the host
//    (ops/fused_decode.py fast_divisor); grids of 2^31 voxels or more
//    take 64-bit division.
//  * Chains with a layer wider than 256 features take the streamed form
//    of csrc/chain_stream.cuh (brief_fused_decode_stream): its thin end
//    layers as reductions, its square layers on 128 x 128 tensor-core
//    tiles, the coordinates from GridInput::coord.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_stream.cuh"
#include "chain_tc.cuh"

namespace {

using brief::ChainDesc;
using brief::kWideStride;
using brief::kWideVox;

// Axis a of the grid: its voxel stride (the product of the later axes'
// sizes; the plane for the lead axis), its size, its axis_linspace
// table's offset (plane axes), and the multiply-shift divisions by its
// stride and by its size (ops/fused_decode.py fast_divisor; mul 0 stands
// for 1).
struct __align__(16) GridAxis {
  long long stride;
  int size, table_off;
  unsigned mul;
  int shift;
  unsigned size_mul;
  int size_shift;
};
static_assert(sizeof(GridAxis) == 32, "ops/fused_decode.py AXIS_ROW_WORDS");

constexpr int kMaxPlaneAxes = 3;   // the narrow form's grids: 2 to 4 axes

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
  const float* tables;    // axis_linspace of each plane axis
  const GridAxis* axes;   // c_in rows, device memory (the wide form)
  long long plane;
  int index64;            // pop >= 2^31: 64-bit index arithmetic
  int n_plane, has_enc;
  // the narrow form's plane axes (grids of at most 4 axes), copied from
  // the table into the launch parameters
  int size[kMaxPlaneAxes], table_off[kMaxPlaneAxes];
  FastDiv div_plane, div_axis[kMaxPlaneAxes];
  float lo, step, enc_scale0;

  // The lead coordinate of lead index q
  __device__ __forceinline__ float lead(long long q) const {
    const float z0 = __fadd_rn(lo, __fmul_rn((float)q, step));
    return has_enc ? brief::fast_sin(__fmul_rn(enc_scale0, z0)) : z0;
  }

  // The narrow form: coordinate features 0 .. 3 of voxel v < pop (zeros
  // past c_in): the lead index v / plane, then each plane axis's from the
  // last, dividing the rest by its size.
  __device__ __forceinline__ void coords(long long v, float (&x)[4]) const {
    int idx[kMaxPlaneAxes];
    long long q;
    if (!index64) {
      const int vi = (int)v;
      const int qi = fast_div(vi, div_plane);
      int p = vi - qi * (int)plane;
      q = qi;
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
      q = v / plane;
      long long p = v - q * plane;
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
    x[0] = lead(q);
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

  // v / stride of axis a (the table's row), v < pop
  __device__ __forceinline__ long long quot(long long v, int a) const {
    if (index64) return v / __ldg(&axes[a].stride);
    const unsigned mul = __ldg(&axes[a].mul);
    return mul == 0u ? v
                     : (long long)(__umulhi((unsigned)v, mul) >>
                                   __ldg(&axes[a].shift));
  }

  // The wide form: coordinates into rows 0 .. c_in - 1 (any number of
  // axes, from the table: axis a's index is v / stride_a - (v /
  // stride_{a-1}) size_a), zeros into rows c_in .. in_rows - 1
  __device__ __forceinline__ void wide_input(float* X, long long base,
                                             const ChainDesc& d) const {
    for (int e = threadIdx.x; e < d.in_rows * kWideVox; e += brief::kThreads) {
      const int r = e / kWideVox, u = e - r * kWideVox;
      const long long v = base + u < d.n ? base + u : d.n - 1;
      float x = 0.f;
      if (r == 0) {
        x = lead(quot(v, 0));
      } else if (r < d.c_in) {
        const int idx = (int)(quot(v, r) - quot(v, r - 1) *
                              __ldg(&axes[r].size));
        x = __ldg(tables + __ldg(&axes[r].table_off) + idx);
      }
      X[r * kWideStride + u] = x;
    }
  }

  // The streamed form (csrc/chain_stream.cuh): coordinate r of voxel v <
  // pop, as wide_input builds it
  __device__ __forceinline__ float coord(long long v, int r, int) const {
    if (r == 0) return lead(quot(v, 0));
    const int idx = (int)(quot(v, r) - quot(v, r - 1) * __ldg(&axes[r].size));
    return __ldg(tables + __ldg(&axes[r].table_off) + idx);
  }
};

// Device kernels brief_fused_decode has launched in this process: one a
// call in the narrow form, two in the wide form (pack_kernel first); and
// those of brief_fused_decode_stream (ops/chain_stream.py stream_kernels).
unsigned long long kernels_launched = 0;

}  // namespace

extern "C" {

// The decode of one grid (ops/fused_decode.py fused_decode_grid).
// meta: n_layers, c_in (the grid's axes), c_out, has_enc, index64,
// n_tiles, stages (wide form), in_rows, pack_blocks (wide form).
// fmeta: lo, step, enc_scale0.  table: device memory, n_layers
// ChainLayer rows then c_in GridAxis rows (ops/fused_decode.py
// chain_table, axis_table); head: the same words in host memory.  form:
// 0 narrow (inst = kNT), 1 wide (inst = kNW).  packed: scratch for the
// wide form's split weights (unused by the narrow form).
int brief_fused_decode(const float* tables, float* out, float* packed,
                       const void* table, const void* head, long long pop,
                       const int* meta, const float* fmeta, int form,
                       int inst, int grid, int smem_bytes, void* stream) {
  ChainDesc d;
  GridInput in;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || table == nullptr || pop < 1)
    return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  in.has_enc = meta[3];
  in.index64 = meta[4];
  d.n_tiles = meta[5];
  d.stages = meta[6];
  d.in_rows = meta[7];
  const int pack_blocks = meta[8];
  if (d.c_in < 2) return (int)cudaErrorInvalidValue;
  d.n = pop;
  d.layer = static_cast<const brief::ChainLayer*>(table);
  in.tables = tables;
  in.axes = reinterpret_cast<const GridAxis*>(d.layer + d.n_layers);
  if (form == 0) {   // the narrow form's plane axes, from the host's copy
    if (d.c_in > kMaxPlaneAxes + 1 || head == nullptr)
      return (int)cudaErrorInvalidValue;
    const GridAxis* ax = reinterpret_cast<const GridAxis*>(
        static_cast<const brief::ChainLayer*>(head) + d.n_layers);
    in.n_plane = d.c_in - 1;
    in.plane = ax[0].stride;
    in.div_plane = FastDiv{ax[0].mul, ax[0].shift};
    for (int a = 0; a < kMaxPlaneAxes; ++a) {
      const bool on = a < in.n_plane;
      in.size[a] = on ? ax[1 + a].size : 1;
      in.table_off[a] = on ? ax[1 + a].table_off : 0;
      in.div_axis[a] = on ? FastDiv{ax[1 + a].size_mul, ax[1 + a].size_shift}
                          : FastDiv{0u, 0};
    }
  }
  in.lo = fmeta[0];
  in.step = fmeta[1];
  in.enc_scale0 = fmeta[2];

  cudaStream_t s = (cudaStream_t)stream;
  if (form != 0) {
    const cudaError_t err = brief::pack_chain(packed, d, pack_blocks, s);
    if (err != cudaSuccess) return (int)err;
    ++kernels_launched;
  }
  const int err = brief::launch_chain(d, head, in, packed, out, form, inst,
                                      grid, smem_bytes, s);
  if (err == (int)cudaSuccess) ++kernels_launched;
  return err;
}

// The decode of one grid in the streamed form (csrc/chain_stream.cuh;
// ops/chain_stream.py, every chain with a layer wider than 256
// features).  meta: n_layers, c_in (the grid's axes), c_out, has_enc,
// index64, R (rows a chunk), S (splits of the thin sums), n_fb (their
// feature blocks), pack_blocks, h_floats (floats of one H buffer).  fmeta:
// lo, step, enc_scale0.  table: device memory, n_layers StreamLayer rows
// then c_in GridAxis rows (ops/chain_stream.py stream_table,
// ops/fused_decode.py axis_table); head: the same words in host memory.
// wp, h (two buffers of h_floats), part: the caller's scratch.
int brief_fused_decode_stream(const float* tables, float* out, float* wp,
                              float* h, float* part, const void* table,
                              const void* head, long long pop,
                              const int* meta, const float* fmeta,
                              void* stream) {
  namespace cs = brief::chain_stream;
  cs::StreamDesc d;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || table == nullptr || pop < 1 || meta[1] < 2)
    return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.R = meta[5];
  d.S = meta[6];
  d.n_fb = meta[7];
  d.n = pop;
  d.base = 0;
  d.layer = static_cast<const cs::StreamLayer*>(table);
  d.h0 = h;
  d.h1 = h == nullptr ? nullptr : h + (size_t)meta[9];
  d.part = part;
  d.wp = wp;
  d.out = out;
  GridInput in{};
  in.tables = tables;
  in.axes = reinterpret_cast<const GridAxis*>(d.layer + d.n_layers);
  in.has_enc = meta[3];
  in.index64 = meta[4];
  in.lo = fmeta[0];
  in.step = fmeta[1];
  in.enc_scale0 = fmeta[2];
  return cs::launch_stream(in, d, static_cast<const cs::StreamLayer*>(head),
                           meta[8], (cudaStream_t)stream, &kernels_launched);
}

// kernels_launched, the count of the kernels a call launches
// (fused_decode.kernels_launched); its low 31 bits.
int brief_fused_decode_kernels(void) {
  return (int)(kernels_launched & 0x7fffffffull);
}

}  // extern "C"
