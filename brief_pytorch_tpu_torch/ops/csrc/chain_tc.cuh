// The tensor-core chain shared by the grid decode (csrc/fused_decode.cu,
// kernel 2) and the batch-major forward (csrc/fused_siren.cu, kernel 3):
// h <- act_l(w0_l (h W_l + b_l)) through a plain chain, float32 out, every
// product mma.sync.m16n8k8 TF32 in 3xTF32 (csrc/tf32.cuh).  The kernels
// differ only in where layer 0's input comes from, an input policy `In`:
// kernel 2's GridInput builds it from the voxel index, kernel 3's RowInput
// reads row v of an (N, C) array.  A policy provides
//   template <int kNT, int kM> void narrow_input(float (&h)[kM][kNT][4],
//       long long v0, int t, const ChainDesc& d) const;
//   void wide_input(float* X, long long base, const ChainDesc& d) const;
// and the caller launches through launch_chain<In>.  The chain's layers
// are rows of a table in device memory (ChainLayer, ops/fused_decode.py
// chain_table), so a chain may have any depth.  Its widths are at most
// 256 features (the input's too): a wider chain takes the streamed form,
// csrc/chain_stream.cuh.
//
// Design (ops/fused_decode.py narrow_plan / wide_plan pick the form):
//  * M = 16 rows, N = 8 outputs, K = 8 inputs; the bias starts the
//    accumulator.  Each layer's W is split into TF32 big and small in
//    B-fragment order (ops/fused_train.py pack_fragments' layout: fragment
//    (kb, nt) of W (fin, fout), lane 4g + t holding W[8kb + 2t][8nt + g]
//    and W[8kb + 2t + 1][8nt + g], big, big, small, small), followed by
//    the biases zero-padded to 8 (packed_entry): in the narrow form by
//    each block while it fills its shared memory, so a call is one
//    launch; in the wide form once per call into device memory by
//    pack_kernel, for the TMA slab ring.
//  * A C fragment (rows g, g + 8; outputs 2t, 2t + 1 of an n-tile) is the
//    next layer's A fragment of the same lane when K pairs features 2t,
//    2t + 1 of a k-block as the B packing does: no shuffle.
//  * The narrow form (chain_narrow_kernel<In, kNT, kM>, chains whose
//    pre-split weights fit in shared memory, at most 12 n-tiles and
//    k-blocks a layer): persistent blocks of 8 warps hold the weights;
//    each warp walks tiles of kM x 16 rows alone and keeps a layer's input
//    and output in registers (kNT n-tiles of C fragments each, the layers
//    in pairs so that nothing is copied); no shared activation store, no
//    barrier per tile.  Paced by instruction issue: the sines (15
//    instructions each) and the splits beside the mma.
//  * The wide form (chain_wide_kernel<In, kNW>): a persistent
//    block of 8 warps carries 128 rows at a time; each layer's B fragments
//    stream through a ring of k-block slabs in shared memory (SlabRing:
//    one thread issues each slab as a TMA bulk copy, mbarriers count the
//    bytes in and the warps' releases out), and each warp takes kNW
//    n-tiles for all 8 m-tiles (or, where a layer has at most kNW n-tiles,
//    as the last one has, one m-tile with all of them), so every 16-byte
//    fragment read feeds 8 row tiles.  The layer's input lives in shared
//    memory (feature-major rows of 132 floats: fragment reads hit 32
//    banks) and the output is written over it after a barrier: a layer of
//    at most 32 n-tiles (256 features) in one pass.  One block of 8 warps
//    an SM: paced by mma.sync between its barriers, and by the epilogues
//    all 8 warps take together.
//  * Sums.  An H100's mma.sync TF32 truncates its 8 products and the
//    accumulator 2 bits below float32's last bit at the largest exponent
//    among them (a product's taken as the sum of its factors'), adds them
//    and rounds the sum toward zero (ops/fused_siren.py mma_tf32_model,
//    equal to the card bit for bit: scripts/mma_tf32_sums.py).  Three such
//    sums a k-block into one accumulator, the small parts truncated as
//    well, put a trained SIREN 2.2x (max) and 3x (mean) further than
//    float32 from float64.  So each k-block's three products are summed
//    from zero and added to the accumulator with float32 adds (round to
//    nearest), and the small parts are rounded to TF32
//    (split_tf32_nearest): float32's accuracy, for 4 adds a 3 mma and
//    2 more integer ops a split, in both forms and both kernels.
//  * A row's value does not depend on the block or warp that computes it
//    (tiles are fixed slices of the rows, no atomics): two calls are
//    bitwise equal.  Rows past n are clamped to n - 1 and never stored.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "tf32.cuh"

namespace brief {

constexpr int kWarps = 8;                   // both forms: 8 warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kWideM = 8;                   // wide form: m-tiles a block tile
constexpr int kWideVox = 16 * kWideM;       // rows a block tile
constexpr int kWideStride = kWideVox + 4;   // activation row, floats
constexpr int kMaxStages = 8;               // wide form: slabs in the ring
constexpr int kBarFloats = 4 * kMaxStages;  // wide form: the ring's barriers

__host__ __device__ constexpr int min_c(int a, int b) { return a < b ? a : b; }

// Layer l's row of the chain's table: its W (fin, fout) and b (fout) as
// the caller holds them, where the packed copy holds its fragments (from
// float4 frag_off, kb x nt of them) and its biases (from float4 bias_off,
// 8 nt floats zero-padded), its activation and w0.
struct __align__(16) ChainLayer {
  const float* w;
  const float* b;
  int frag_off, bias_off, fin, fout, kb, nt, act;
  float w0;
};
static_assert(sizeof(ChainLayer) == 48, "ops/fused_decode.py CHAIN_ROW_WORDS");

// The chain and the call's shape: n rows (voxels of kernel 2), c_in and
// c_out features, layer 0's input rows (8 kb of its k-blocks); `layer`:
// n_layers rows in device memory; `head`: the first ones again, for the
// kernels compiled for chains of at most kParamLayers layers.
struct ChainDesc {
  long long n;
  int n_layers, c_in, c_out, in_rows, n_tiles, stages;
  const ChainLayer* layer;
  ChainLayer head[kParamLayers];
};

// Field f of layer l (csrc/chain.cuh layer_field)
template <bool kDeep, class T>
__device__ __forceinline__ T lf(const ChainDesc& d, int l, T ChainLayer::*f) {
  return layer_field<kDeep>(d.layer, d.head, l, f);
}

// Hopper's bulk copy (TMA, one thread for a whole contiguous slab) and
// the shared-memory barriers that count its bytes in.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}

// One thread: `bytes` from src into dst, completing on `bar`; the fence
// orders the stage's earlier reads (generic proxy, released to this
// thread through a barrier) before the copy's writes (async proxy).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// c[i] = act(c[i]) for kN accumulators, the activation picked once
template <int kN>
__device__ __forceinline__ void activate(float* c, int act, float w0) {
  switch (act) {
    case kActSine:
#pragma unroll
      for (int i = 0; i < kN; ++i) c[i] = fast_sin(w0 * c[i]);
      break;
    case kActRelu:
#pragma unroll
      for (int i = 0; i < kN; ++i) c[i] = fmaxf(c[i], 0.f);
      break;
    case kActSigmoid:
#pragma unroll
      for (int i = 0; i < kN; ++i) c[i] = 1.f / (1.f + expf(-c[i]));
      break;
    default:
      break;
  }
}

// B fragment entry e < 32 kb nt of layer ly's packed weights.
__device__ __forceinline__ float4 frag_entry(const ChainLayer& ly, int e) {
  const int lane = e & 31, frag = e >> 5, kb = frag / ly.nt;
  const int i = 8 * kb + 2 * (lane & 3);
  const int o = 8 * (frag - kb * ly.nt) + (lane >> 2);
  const bool ok = o < ly.fout;
  return pack_b<true>(
      ok && i < ly.fin ? __ldg(ly.w + (size_t)i * ly.fout + o) : 0.f,
      ok && i + 1 < ly.fin ? __ldg(ly.w + (size_t)(i + 1) * ly.fout + o)
                           : 0.f);
}

// Layer ly's packed weights (fragments, then biases zero-padded to 8 nt)
// into `packed`, entries first, first + step, ... of each.
__device__ __forceinline__ void pack_layer(const ChainLayer& ly,
                                           float* packed, int first,
                                           int step) {
  float4* frags = reinterpret_cast<float4*>(packed) + ly.frag_off;
  float* bias = packed + 4 * (size_t)ly.bias_off;
  const int n4 = 32 * ly.kb * ly.nt;
  for (int e = first; e < n4; e += step) frags[e] = frag_entry(ly, e);
  for (int o = first; o < 8 * ly.nt; o += step)
    bias[o] = o < ly.fout ? __ldg(ly.b + o) : 0.f;
}

// Every layer's packed weights into device memory: layer blockIdx.y.
__global__ void pack_kernel(float* __restrict__ packed, ChainDesc d) {
  pack_layer(ld_row(d.layer + blockIdx.y), packed,
             blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

// Host: pack_kernel on stream s, `blocks` blocks of 256 threads a layer
// (ops/fused_decode.py sizes them for the largest layer).
inline cudaError_t pack_chain(float* packed, const ChainDesc& d, int blocks,
                              cudaStream_t s) {
  if (packed == nullptr || blocks < 1) return cudaErrorInvalidValue;
  pack_kernel<<<dim3(blocks, d.n_layers), 256, 0, s>>>(packed, d);
  return cudaGetLastError();
}

// A's big and small parts of an m-tile's k-block
__device__ __forceinline__ void split_a(float a0, float a1, float a2, float a3,
                                        uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split_tf32_nearest(a0, &ab[0], &as[0]);
  split_tf32_nearest(a1, &ab[1], &as[1]);
  split_tf32_nearest(a2, &ab[2], &as[2]);
  split_tf32_nearest(a3, &ab[3], &as[3]);
}

// ---------------------------------------------------------------------------
// The narrow form: kNT n-tiles of registers per layer input and output,
// for each of a warp's kM m-tiles.
// ---------------------------------------------------------------------------
// c[m][j] += h[m] W for n-tiles j < kJ of one layer and the warp's kM
// m-tiles of 16 rows, k-blocks k < KB, in 3xTF32: B fragment (k, j) at
// wf[(k NT + j) 32 + lane], n-tiles past NT repeating the last (their
// outputs are never read).  No branch inside a k-block.  The tiles go in
// groups of 8, each tile's three products summed from zero term by term
// across its group (8 mma between dependent ones, 32 registers of sums),
// then added to c; each B fragment read feeds kM m-tiles.
template <int kNT, int kM, int kJ, bool kAllK>
__device__ __forceinline__ void narrow_product(float (&c)[kM][kNT][4],
                                               const float (&h)[kM][kNT][4],
                                               const float4* wf, int KB,
                                               int NT, int lane) {
  int off[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) off[j] = min(j, NT - 1) * 32 + lane;
#pragma unroll
  for (int k = 0; k < kNT; ++k) {
    if (kAllK || k < KB) {
      uint32_t ab[kM][4], as[kM][4];
#pragma unroll
      for (int m = 0; m < kM; ++m)
        split_a(h[m][k][0], h[m][k][2], h[m][k][1], h[m][k][3], ab[m],
                as[m]);
      // groups of kG n-tiles x kM m-tiles (8 tiles): each tile's three
      // products summed from zero, term by term across the group, then
      // added to c in float32
      constexpr int kG = 8 / kM;
#pragma unroll
      for (int j0 = 0; j0 < kJ; j0 += kG) {
        float4 w[kG];
        float s[kG][kM][4];
#pragma unroll
        for (int j = 0; j < kG; ++j)
          if (j0 + j < kJ) w[j] = wf[k * NT * 32 + off[j0 + j]];
#pragma unroll
        for (int j = 0; j < kG; ++j)
#pragma unroll
          for (int m = 0; m < kM; ++m)
            if (j0 + j < kJ)
              mma_tf32_zero(s[j][m], as[m], __float_as_uint(w[j].x),
                            __float_as_uint(w[j].y));
#pragma unroll
        for (int j = 0; j < kG; ++j)
#pragma unroll
          for (int m = 0; m < kM; ++m)
            if (j0 + j < kJ)
              mma_tf32(s[j][m], ab[m], __float_as_uint(w[j].z),
                       __float_as_uint(w[j].w));
#pragma unroll
        for (int j = 0; j < kG; ++j)
#pragma unroll
          for (int m = 0; m < kM; ++m)
            if (j0 + j < kJ)
              mma_tf32(s[j][m], ab[m], __float_as_uint(w[j].x),
                       __float_as_uint(w[j].y));
#pragma unroll
        for (int j = 0; j < kG; ++j)
#pragma unroll
          for (int m = 0; m < kM; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j0 + j < kJ) c[m][j0 + j][e] += s[j][m][e];
      }
    }
  }
}

// narrow_product over the fewest n-tiles of 1, 2, 3, 6, 9, 12 that cover NT
// (a layer kNT k-blocks deep, as a hidden layer of the widest width or the
// last layer after it is, without a branch per k-block)
template <int kNT, int kM>
__device__ __forceinline__ void narrow_layer(float (&c)[kM][kNT][4],
                                             const float (&h)[kM][kNT][4],
                                             const float4* wf, int KB, int NT,
                                             int lane) {
  if (KB == kNT && NT == kNT) {
    narrow_product<kNT, kM, kNT, true>(c, h, wf, KB, NT, lane);
  } else if (KB == kNT && NT == 1) {   // a last layer
    narrow_product<kNT, kM, 1, true>(c, h, wf, KB, NT, lane);
  } else if (NT <= 1) {
    narrow_product<kNT, kM, 1, false>(c, h, wf, KB, NT, lane);
  } else if (NT <= 2) {
    narrow_product<kNT, kM, 2, false>(c, h, wf, KB, NT, lane);
  } else if (NT <= 3) {
    narrow_product<kNT, kM, 3, false>(c, h, wf, KB, NT, lane);
  } else if (NT <= 6) {
    narrow_product<kNT, kM, min_c(6, kNT), false>(c, h, wf, KB, NT, lane);
  } else if (NT <= 9) {
    narrow_product<kNT, kM, min_c(9, kNT), false>(c, h, wf, KB, NT, lane);
  } else {
    narrow_product<kNT, kM, kNT, false>(c, h, wf, KB, NT, lane);
  }
}

// Layer l of the narrow form for the warp's kM m-tiles: c = act(h W + b)
template <int kNT, int kM, bool kDeep>
__device__ __forceinline__ void narrow_step(float (&c)[kM][kNT][4],
                                            const float (&h)[kM][kNT][4],
                                            const float* sm, const ChainDesc& d,
                                            int l, int lane, int t) {
  const int NT = lf<kDeep>(d, l, &ChainLayer::nt);
  const float* bias = sm + 4 * lf<kDeep>(d, l, &ChainLayer::bias_off);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float2 bv = j < NT
        ? *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t)
        : make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      c[m][j][0] = c[m][j][2] = bv.x;
      c[m][j][1] = c[m][j][3] = bv.y;
    }
  }
  narrow_layer<kNT, kM>(c, h,
                        reinterpret_cast<const float4*>(sm) +
                            lf<kDeep>(d, l, &ChainLayer::frag_off),
                        lf<kDeep>(d, l, &ChainLayer::kb), NT, lane);
  activate<4 * kNT * kM>(&c[0][0][0], lf<kDeep>(d, l, &ChainLayer::act),
                         lf<kDeep>(d, l, &ChainLayer::w0));
}

// The last layer's outputs o < c_out of the warp's rows v < n
template <int kNT, int kM, bool kDeep>
__device__ __forceinline__ void narrow_store(const float (&c)[kM][kNT][4],
                                             float* __restrict__ out,
                                             const ChainDesc& d, long long v0,
                                             int l, int t) {
  const int NT = lf<kDeep>(d, l, &ChainLayer::nt);
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 8 * j + 2 * t + (e & 1);
        const long long v = v0 + 16 * m + 8 * (e >> 1);
        if (j < NT && o < d.c_out && v < d.n)
          out[v * d.c_out + o] = c[m][j][e];
      }
    }
  }
}

// Grid-stride over tiles of 16 kM rows, one a warp; kNT n-tiles of
// registers for a layer's input and for its output, per m-tile.  Each
// block first splits every layer's W and b, read in place, into its
// shared memory.
template <class In, int kNT, int kM, int kMinBlocks, bool kDeep>
__global__ void __launch_bounds__(kThreads, kMinBlocks) chain_narrow_kernel(
    const In in, float* __restrict__ out, ChainDesc d) {
  extern __shared__ __align__(16) float sm[];
  for (int l = 0; l < d.n_layers; ++l)
    pack_layer(layer_row<kDeep>(d.layer, d.head, l), sm, threadIdx.x,
               kThreads);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, L = d.n_layers;
  for (int tile = blockIdx.x * kWarps + warp; tile < d.n_tiles;
       tile += gridDim.x * kWarps) {
    const long long v0 = (long long)tile * (16 * kM) + g;
    // h[m][k][e]: feature 8k + 2t + (e & 1) of row v0 + 16 m + 8 (e >> 1),
    // the C fragment layout; layer 0's input from the policy
    float h[kM][kNT][4];
    in.template narrow_input<kNT, kM>(h, v0, t, d);
    // layers in pairs, h -> c -> h, so no copy between them
    float c[kM][kNT][4];
    for (int l = 0;; l += 2) {
      narrow_step<kNT, kM, kDeep>(c, h, sm, d, l, lane, t);
      if (l + 1 == L) {
        narrow_store<kNT, kM, kDeep>(c, out, d, v0, l, t);
        break;
      }
      narrow_step<kNT, kM, kDeep>(h, c, sm, d, l + 1, lane, t);
      if (l + 2 == L) {
        narrow_store<kNT, kM, kDeep>(h, out, d, v0, l + 1, t);
        break;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The wide form: B fragments streamed in k-block slabs, 128-row tiles.
// ---------------------------------------------------------------------------
// One k-block of the wide form's product for one warp: c[j][m] += A_m B_j
// in 3xTF32 for kJ of its n-tiles (slab fragments jb + js j) and kMt
// m-tiles (A: rows 2t, 2t + 1 of the k-block, rows xa + 16 m and + 8).
// No branch inside.  Every A fragment is loaded first, then the tiles go
// in groups of 2 m-tiles x
// kJ n-tiles, each A fragment split as its group needs it: each tile's
// three products summed from zero, term by term across the group, then
// added to c in float32.
template <int kNW, int kJ, int kMt>
__device__ __forceinline__ void wide_step(float (&c)[kNW][kWideM][4],
                                          const float4* ws, int jb, int js,
                                          const float* xa, int lane) {
  constexpr int S = kWideStride;
  float4 w[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) w[j] = ws[(jb + js * j) * 32 + lane];
  float a[kMt][4];
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
    const float* p = xa + 16 * m;
    a[m][0] = p[0];
    a[m][1] = p[8];
    a[m][2] = p[S];
    a[m][3] = p[S + 8];
  }
#pragma unroll
  for (int m0 = 0; m0 < kMt; m0 += 2) {
    constexpr int kG = kMt < 2 ? kMt : 2;
    uint32_t ab[kG][4], as[kG][4];
    float s[kG][kJ][4];
#pragma unroll
    for (int m = 0; m < kG; ++m)
      split_a(a[m0 + m][0], a[m0 + m][1], a[m0 + m][2], a[m0 + m][3], ab[m],
              as[m]);
#pragma unroll
    for (int m = 0; m < kG; ++m)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        mma_tf32_zero(s[m][j], as[m], __float_as_uint(w[j].x),
                      __float_as_uint(w[j].y));
#pragma unroll
    for (int m = 0; m < kG; ++m)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        mma_tf32(s[m][j], ab[m], __float_as_uint(w[j].z),
                 __float_as_uint(w[j].w));
#pragma unroll
    for (int m = 0; m < kG; ++m)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        mma_tf32(s[m][j], ab[m], __float_as_uint(w[j].x),
                 __float_as_uint(w[j].y));
#pragma unroll
    for (int m = 0; m < kG; ++m)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][m0 + m][e] += s[m][j][e];
  }
}

// The wide form's slab ring of d.stages slabs: thread 0 streams every
// k-block slab that the block's tiles need, in the order the warps
// consume them (tile, layer, pass, k-block), stages - 1 ahead of its own
// warp: slab n fills stage n % stages once every warp has released the
// stage's previous slab (barrier empty) and completes the phase
// (n / stages) & 1 of barrier full.  The weights are the same for every
// tile, so loads run ahead across layer and tile boundaries, during the
// epilogues.
template <int kP, bool kDeep>
struct SlabRing {
  uint64_t* full;
  uint64_t* empty;
  float4* slab;
  // the next slab's stage, the phase its fill completes, whether the
  // stage was filled before; the next slab's tile, layer, pass, k-block
  int stage, phase, reuse, tile, l, nb, kb;

  __device__ __forceinline__ void produce(const ChainDesc& d,
                                          const float* packed) {
    if (tile >= d.n_tiles) return;
    const int st = stage, NT = lf<kDeep>(d, l, &ChainLayer::nt);
    if (reuse) mbar_wait(empty + st, phase ^ 1);
    bulk_load(slab + st * 32 * kP,
              reinterpret_cast<const float4*>(packed) +
                  lf<kDeep>(d, l, &ChainLayer::frag_off) +
                  ((size_t)kb * NT + nb) * 32,
              min(kP, NT - nb) * 512, full + st);
    if (++stage == d.stages) {
      stage = 0;
      phase ^= 1;
      reuse = 1;
    }
    if (++kb == lf<kDeep>(d, l, &ChainLayer::kb)) {
      kb = 0;
      nb += kP;
      if (nb >= NT) {
        nb = 0;
        if (++l == d.n_layers) {
          l = 0;
          tile += gridDim.x;
        }
      }
    }
  }
};

template <class In, int kNW, bool kDeep>
__global__ void __launch_bounds__(kThreads, 1) chain_wide_kernel(
    const float* __restrict__ packed, const In in, float* __restrict__ out,
    ChainDesc d) {
  constexpr int kP = kWarps * kNW;   // n-tiles per pass
  constexpr int kSlab = 32 * kP;     // float4 per slab
  constexpr int S = kWideStride;
  extern __shared__ __align__(16) float sm[];
  SlabRing<kP, kDeep> ring;
  ring.full = reinterpret_cast<uint64_t*>(sm);
  ring.empty = ring.full + kMaxStages;
  ring.slab = reinterpret_cast<float4*>(sm + kBarFloats);
  ring.stage = ring.phase = ring.reuse = ring.l = ring.nb = ring.kb = 0;
  ring.tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, L = d.n_layers;
  float* const X = sm + kBarFloats + d.stages * kSlab * 4;
  if (threadIdx.x == 0) {
    for (int i = 0; i < d.stages; ++i) {
      mbar_init(ring.full + i, 1);
      mbar_init(ring.empty + i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < d.stages - 1; ++i) ring.produce(d, packed);
  }
  int stage = 0, phase = 0;   // the next slab to consume, its fill

  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    const long long base = (long long)tile * kWideVox;
    __syncthreads();   // the previous tile's last layer has read X
    in.wide_input(X, base, d);   // rows 0 .. in_rows - 1 of layer 0's input
    for (int l = 0; l < L; ++l) {
      const int KB = lf<kDeep>(d, l, &ChainLayer::kb);
      const int NT = lf<kDeep>(d, l, &ChainLayer::nt);
      const bool last = l + 1 == L;
      // each warp: m-tiles m0 .. m0 + mc - 1 and the pass's n-tiles
      // jb + js * j, j < kNW
      const bool msplit = NT <= kNW;
      const int m0 = msplit ? warp : 0, mc = msplit ? 1 : kWideM;
      const int jb = msplit ? 0 : warp, js = msplit ? 1 : kWarps;
      for (int nb = 0; nb < NT; nb += kP) {
        const int np = min(kP, NT - nb);
        // this warp's n-tiles of the pass (msplit: all np of them)
        const int cnt = msplit ? np : min(kNW, max(0, (np - warp + 7) / 8));
        __syncthreads();   // X holds the layer input
        float c[kNW][kWideM][4];
#pragma unroll
        for (int j = 0; j < kNW; ++j) {
          const int n = jb + js * j;
          const float2 bv = n < np
              ? __ldg(reinterpret_cast<const float2*>(
                    packed + 4 * (size_t)lf<kDeep>(d, l, &ChainLayer::bias_off) +
                    8 * (nb + n) + 2 * t))
              : make_float2(0.f, 0.f);
#pragma unroll
          for (int m = 0; m < kWideM; ++m) {
            c[j][m][0] = c[j][m][2] = bv.x;
            c[j][m][1] = c[j][m][3] = bv.y;
          }
        }
        for (int kb = 0; kb < KB; ++kb) {
          mbar_wait(ring.full + stage, phase);
          const float4* ws = ring.slab + stage * kSlab;
          const float* xa = X + (8 * kb + 2 * t) * S + 16 * m0 + g;
          if (msplit) {
            switch (np) {
              case 1: wide_step<kNW, 1, 1>(c, ws, jb, js, xa, lane); break;
              case 2: wide_step<kNW, min_c(2, kNW), 1>(c, ws, jb, js, xa, lane); break;
              case 3: wide_step<kNW, min_c(3, kNW), 1>(c, ws, jb, js, xa, lane); break;
              default: wide_step<kNW, min_c(4, kNW), 1>(c, ws, jb, js, xa, lane);
            }
          } else {
            switch (cnt) {
              case 0: break;
              case 1: wide_step<kNW, 1, kWideM>(c, ws, jb, js, xa, lane); break;
              case 2: wide_step<kNW, min_c(2, kNW), kWideM>(c, ws, jb, js, xa, lane); break;
              case 3: wide_step<kNW, min_c(3, kNW), kWideM>(c, ws, jb, js, xa, lane); break;
              default: wide_step<kNW, min_c(4, kNW), kWideM>(c, ws, jb, js, xa, lane);
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(ring.empty + stage);   // released
          if (++stage == d.stages) {
            stage = 0;
            phase ^= 1;
          }
          if (threadIdx.x == 0) ring.produce(d, packed);
        }
        activate<4 * kNW * kWideM>(&c[0][0][0],
                                   lf<kDeep>(d, l, &ChainLayer::act),
                                   lf<kDeep>(d, l, &ChainLayer::w0));
        if (last) {
#pragma unroll
          for (int j = 0; j < kNW; ++j) {
#pragma unroll
            for (int m = 0; m < kWideM; ++m) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int o = 8 * (nb + jb + js * j) + 2 * t + (e & 1);
                const long long v =
                    base + 16 * (m0 + m) + g + 8 * (e >> 1);
                if (m < mc && jb + js * j < np && o < d.c_out && v < d.n)
                  out[v * d.c_out + o] = c[j][m][e];
              }
            }
          }
          continue;
        }
        __syncthreads();   // every warp has read X: in place
#pragma unroll
        for (int j = 0; j < kNW; ++j) {
          const int n = jb + js * j;
          if (n < np) {
            float* y = X + (8 * (nb + n) + 2 * t) * S + 16 * m0 + g;
#pragma unroll
            for (int m = 0; m < kWideM; ++m) {
              if (m < mc) {
                y[16 * m] = c[j][m][0];
                y[16 * m + S] = c[j][m][1];
                y[16 * m + 8] = c[j][m][2];
                y[16 * m + S + 8] = c[j][m][3];
              }
            }
          }
        }
      }
    }
  }
}

// Host: set the kernel's shared memory and launch it on stream s with
// 8 warps a block.  Returns a cudaError_t.
template <class Kernel, class... Args>
int launch(Kernel kernel, int grid, int smem_bytes, cudaStream_t s,
           Args... args) {
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem_bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

// Host: launch form 0 (narrow, inst = kNT) or 1 (wide, inst = kNW) on
// stream s, the instances for chains of any depth (kDeep) or of at most
// kParamLayers layers; packed holds pack_kernel's output for the wide form
// (the narrow form splits the weights itself and ignores it).  Returns a
// cudaError_t.
template <class In, bool kDeep>
int launch_form(const ChainDesc& d, const In& in, const float* packed,
                float* out, int form, int inst, int grid, int smem_bytes,
                cudaStream_t s) {
  if (form == 0) {
    switch (inst) {   // kNT, m-tiles a warp, blocks an SM
      case 3: return launch(chain_narrow_kernel<In, 3, 2, 2, kDeep>, grid,
                            smem_bytes, s, in, out, d);
      case 6: return launch(chain_narrow_kernel<In, 6, 1, 2, kDeep>, grid,
                            smem_bytes, s, in, out, d);
      case 9: return launch(chain_narrow_kernel<In, 9, 2, 1, kDeep>, grid,
                            smem_bytes, s, in, out, d);
      case 12: return launch(chain_narrow_kernel<In, 12, 1, 1, kDeep>, grid,
                             smem_bytes, s, in, out, d);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (form != 1 || packed == nullptr || d.stages < 2 ||
      d.stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  switch (inst) {
    case 1: return launch(chain_wide_kernel<In, 1, kDeep>, grid, smem_bytes,
                          s, packed, in, out, d);
    case 2: return launch(chain_wide_kernel<In, 2, kDeep>, grid, smem_bytes,
                          s, packed, in, out, d);
    case 3: return launch(chain_wide_kernel<In, 3, kDeep>, grid, smem_bytes,
                          s, packed, in, out, d);
    case 4: return launch(chain_wide_kernel<In, 4, kDeep>, grid, smem_bytes,
                          s, packed, in, out, d);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Host: launch_form, the instances that read the chain's rows from the
// launch parameters where it has at most kParamLayers layers (`head`
// filled from the host's copy of the table, `head_rows`), else those that
// read the device table.
template <class In>
int launch_chain(ChainDesc& d, const void* head_rows, const In& in,
                 const float* packed, float* out, int form, int inst,
                 int grid, int smem_bytes, cudaStream_t s) {
  if (d.n_layers > kParamLayers)
    return launch_form<In, true>(d, in, packed, out, form, inst, grid,
                                 smem_bytes, s);
  if (head_rows == nullptr) return (int)cudaErrorInvalidValue;
  memcpy(d.head, head_rows, d.n_layers * sizeof(ChainLayer));
  return launch_form<In, false>(d, in, packed, out, form, inst, grid,
                                smem_bytes, s);
}

}  // namespace brief
