// The weights of the fused train kernel's wide layout
// (csrc/fused_train.cu): chains whose weights do not fit in shared
// memory.  ops/wide.py is the Python side of this file.
//
// Every layer's weights stay in device memory, packed once per call into
// mma.sync.m16n8k8 B fragments already split into TF32 big and small
// halves (pack_b<true>, csrc/tf32.cuh), so that a product reads one
// 16-byte word a lane and fragment and splits nothing: the forward pack
// of W ((fin, fout): its bias is added after the product) and the
// input-gradient pack of W^T ((fout, fin)).  A pack of a (K, N) matrix is
// cut into chunks of kNC columns; chunk c holds its round_kp(K) / 8
// k-blocks in order, each 8 fragments (n-tiles) of 32 lanes x 4 floats:
// lane 4g + t of fragment (kb, j) holds big(b0), big(b1), small(b0),
// small(b1) of b0 = B[8 kb + t][64 c + 8 j + g], b1 = B[8 kb + t + 4][..],
// zeros past B.  A slab of a product is a few consecutive k-blocks of one
// chunk: one contiguous run of 16-byte copies.
#pragma once

#include <cuda_runtime.h>

#include "chain.cuh"
#include "tf32.cuh"

namespace brief {
namespace wide {

constexpr int kThreads = 512;  // a block: 16 warps
constexpr int kNC = 64;        // output columns of a chunk (8 n-tiles)
constexpr int kFrag = 128;     // floats of a packed fragment
constexpr int kStages = 3;     // slabs in the ring

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
// packed parameters (W (fin, fout), then b), its forward and
// input-gradient packs' offsets, the scratch rows of its output z_{l+1}
// (which becomes h_{l+1}; -1 for the last layer) and of its input h_l (0:
// the coordinates' rows), its unit mask's offset (-1: none), its dW
// partial sums' offset, splits of the coordinates and coordinates a
// split, w0, and the rows of the G buffer that holds g_{l+1}.
struct __align__(16) Layer {
  int fin, fout, act, p_off;
  int wf_off, wb_off, out_row, in_row;
  int mask_off, part_off, splits, chunk;
  float w0;
  int g_row, pad[2];
};
static_assert(sizeof(Layer) == 64, "ops/fused_train.py WIDE_ROW_WORDS");

// Float4s of one pack of a (k, n) matrix, k padded to a multiple of kp
__host__ __device__ __forceinline__ int pack_words(int k, int n, int kp) {
  return round_up(k, kp) * round_up(n, kNC) / 2;
}

// Layer blockIdx.y's two packs for chain blockIdx.z (ops/wide.py
// pack_layer), a thread a lane of a fragment; kp: the k extent's
// multiple (the tile's slab depth).
__global__ void pack_weights_kernel(const float* __restrict__ params,
                                    float* __restrict__ wp,
                                    const Layer* __restrict__ layers,
                                    int n_params, int wp_total, int kp) {
  const Layer ly = ld_row(layers + blockIdx.y);
  const float* w = params + (size_t)blockIdx.z * n_params + ly.p_off;
  wp += (size_t)blockIdx.z * wp_total;
  const int nf = pack_words(ly.fin, ly.fout, kp);
  const int total = nf + pack_words(ly.fout, ly.fin, kp);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const bool fwd = e < nf;
    const int x = fwd ? e : e - nf;
    const int K = fwd ? ly.fin : ly.fout, N = fwd ? ly.fout : ly.fin;
    const int kbs = round_up(K, kp) / 8;
    const int lane = x & 31, frag = x >> 5;
    const int j = frag & 7, kb = (frag >> 3) % kbs, c = (frag >> 3) / kbs;
    const int r0 = 8 * kb + (lane & 3), col = kNC * c + 8 * j + (lane >> 2);
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 4 * h;
      v[h] = 0.f;
      if (r < K && col < N)   // forward B[r][col] = W[r][col]; else W[col][r]
        v[h] = fwd ? w[(size_t)r * ly.fout + col]
                   : w[(size_t)col * ly.fout + r];
    }
    reinterpret_cast<float4*>(wp + (fwd ? ly.wf_off : ly.wb_off))[x] =
        pack_b<true>(v[0], v[1]);
  }
}

}  // namespace wide
}  // namespace brief
