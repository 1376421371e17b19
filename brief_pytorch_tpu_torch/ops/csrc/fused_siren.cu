// Fused batch-major forward of a plain activation chain for explicitly
// given coordinates, for Hopper.
//
// Replaces the Pallas TPU kernel of brief_pytorch_tpu/ops/pallas_siren.py
// (_make_kernel / _fused_forward, entry fused_chain_apply):
// h <- act_l(w0_l * (h @ W_l + b_l)) through every layer, coords (N, C)
// row-major -> out (N, Cout) row-major, with no activation written to
// device memory between layers (chains past 256 features, which take the
// streamed form, aside).
//
// What bounds it on an H100: operations.  SIREN 5 x 22 on N = 262,144
// coordinates reads and writes ~4.2 MB (3.35 TB/s: ~1.3 us) but does ~0.8
// GFLOP of chain products and 88 sines per coordinate: with the products
// on the tensor cores in 3xTF32 (~5 us at 495 TFLOP/s) the sines on the
// CUDA cores weigh as much (~5.5 us at 67 TFLOP/s); at 3-186x4-1 the
// products dominate.
//
// Design: the tensor-core chain of csrc/chain_tc.cuh, the one kernel 2
// (csrc/fused_decode.cu) runs, with layer 0's input from RowInput, rows
// of the (N, C) array:
//  * the narrow form (chains whose pre-split weights fit in shared memory,
//    at most 12 n-tiles and input k-blocks): each block splits the layers'
//    W and b, read in place, into TF32 big and small while it fills its
//    shared memory, so a call is one launch; lane (g, t) of a warp loads
//    features 8k + 2t and 8k + 2t + 1 of rows v0 + 16 m + g and + 8
//    straight from the row-major array into its C fragments;
//  * the wide form (every other chain of at most 256 features, of any
//    depth, C included): pack_kernel splits the weights once per call for
//    the TMA slab ring; each 128-row tile's input is copied from the
//    contiguous rows into feature-major rows of 132 floats in shared
//    memory (consecutive threads on consecutive addresses);
//  * rows past N are clamped to N - 1 and never stored; offsets are 64-bit
//    (N * C may pass 2^31);
//  * the sums are chain_tc.cuh's: each k-block's three products
//    summed from zero and added with a float32 add, the small parts
//    rounded to TF32, so the chain keeps float32's accuracy (the tensor
//    core truncates its sums);
//  * chains with a layer (or an input) wider than 256 features take the
//    streamed form of csrc/chain_stream.cuh (brief_fused_siren_stream),
//    the rows read by RowInput::coord.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_stream.cuh"
#include "chain_tc.cuh"

namespace {

using brief::ChainDesc;
using brief::kThreads;
using brief::kWideStride;
using brief::kWideVox;

// Layer 0's input of row v: row v of the (n, c_in) array x.
struct RowInput {
  const float* x;

  // The narrow form: k-blocks k < ceil(c_in / 8) of rows v0 + 16 m and
  // + 8 in the C fragment layout, zeros past c_in and in the other
  // k-blocks.  Read straight from the row-major array: staging a warp's
  // tile through shared memory first was slower at c_in 2 and 3.
  template <int kNT, int kM>
  __device__ __forceinline__ void narrow_input(float (&h)[kM][kNT][4],
                                               long long v0, int t,
                                               const ChainDesc& d) const {
    const int C = d.c_in;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const long long va = v0 + 16 * m, vb = va + 8;
      const float* ra = x + (va < d.n ? va : d.n - 1) * C;
      const float* rb = x + (vb < d.n ? vb : d.n - 1) * C;
#pragma unroll
      for (int k = 0; k < kNT; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) h[m][k][e] = 0.f;
        const int f = 8 * k + 2 * t;
        if (8 * k < C) {
          if (f < C) {
            h[m][k][0] = __ldg(ra + f);
            h[m][k][2] = __ldg(rb + f);
          }
          if (f + 1 < C) {
            h[m][k][1] = __ldg(ra + f + 1);
            h[m][k][3] = __ldg(rb + f + 1);
          }
        }
      }
    }
  }

  // The wide form: rows 0 .. c_in - 1 of the block tile's input from the
  // tile's contiguous 128 c_in floats, zeros in rows c_in .. in_rows - 1.
  __device__ __forceinline__ void wide_input(float* X, long long base,
                                             const ChainDesc& d) const {
    const int C = d.c_in;
    for (int e = threadIdx.x; e < kWideVox * C; e += kThreads) {
      const int u = e / C, r = e - u * C;
      const long long v = base + u;
      X[r * kWideStride + u] = __ldg(x + (v < d.n ? v : d.n - 1) * C + r);
    }
    for (int e = threadIdx.x; e < (d.in_rows - C) * kWideVox;
         e += kThreads)
      X[(C + e / kWideVox) * kWideStride + e % kWideVox] = 0.f;
  }

  // The streamed form (csrc/chain_stream.cuh): feature r of row v < n
  __device__ __forceinline__ float coord(long long v, int r, int c_in) const {
    return __ldg(x + v * c_in + r);
  }
};

}  // namespace

extern "C" {

// The forward of one call (ops/fused_siren.py _launch).  meta: n_layers,
// c_in, c_out, n_tiles, stages (wide form), in_rows, pack_blocks (wide
// form).  table: device memory, n_layers ChainLayer rows
// (ops/fused_decode.py chain_table); head: the same rows in host memory.
// form: 0 narrow (inst = kNT; packed unused), 1 wide (inst = kNW); packed:
// device memory for the wide form's split weights.
int brief_fused_siren(const float* coords, float* out, float* packed,
                      const void* table, const void* head, long long n,
                      const int* meta, int form, int inst, int grid,
                      int smem_bytes, void* stream) {
  ChainDesc d;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || table == nullptr || n < 1)
    return (int)cudaErrorInvalidValue;
  d.n = n;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.n_tiles = meta[3];
  d.stages = meta[4];
  d.in_rows = meta[5];
  const int pack_blocks = meta[6];
  if (d.c_in < 1 || d.c_out < 1) return (int)cudaErrorInvalidValue;
  d.layer = static_cast<const brief::ChainLayer*>(table);
  const RowInput in{coords};
  cudaStream_t s = (cudaStream_t)stream;
  if (form != 0) {
    const cudaError_t err = brief::pack_chain(packed, d, pack_blocks, s);
    if (err != cudaSuccess) return (int)err;
  }
  return brief::launch_chain(d, head, in, form == 0 ? nullptr : packed,
                             out, form, inst, grid, smem_bytes, s);
}

// The forward of one call in the streamed form (csrc/chain_stream.cuh;
// ops/chain_stream.py, every chain with a layer or an input wider than
// 256 features).  meta: n_layers, c_in, c_out, R (rows a chunk), S (splits of
// the thin sums), n_fb (their feature blocks), pack_blocks, h_floats
// (floats of one H buffer).  table: device memory, n_layers StreamLayer
// rows (ops/chain_stream.py stream_table); head: the same rows in host
// memory.  wp, h (two buffers of h_floats), part: the caller's scratch.
int brief_fused_siren_stream(const float* coords, float* out, float* wp,
                             float* h, float* part, const void* table,
                             const void* head, long long n, const int* meta,
                             void* stream) {
  namespace cs = brief::chain_stream;
  cs::StreamDesc d;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || table == nullptr || n < 1)
    return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.R = meta[3];
  d.S = meta[4];
  d.n_fb = meta[5];
  d.n = n;
  d.base = 0;
  d.layer = static_cast<const cs::StreamLayer*>(table);
  d.h0 = h;
  d.h1 = h == nullptr ? nullptr : h + (size_t)meta[7];
  d.part = part;
  d.wp = wp;
  d.out = out;
  unsigned long long launched = 0;
  return cs::launch_stream(RowInput{coords}, d,
                           static_cast<const cs::StreamLayer*>(head),
                           meta[6], (cudaStream_t)stream, &launched);
}

}  // extern "C"
