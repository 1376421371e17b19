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
// Design (ops/fused_decode.py choose_plan picks the form):
//  * Every product is mma.sync.m16n8k8 TF32 in 3xTF32 (csrc/tf32.cuh):
//    M = 16 voxels, N = 8 outputs, K = 8 inputs; the bias starts the
//    accumulator.  pack_kernel splits each layer's W into TF32 big and
//    small once per call, in B-fragment order (ops/fused_train.py
//    pack_fragments' layout: fragment (kb, nt) of W (fin, fout), lane 4g
//    + t holding W[8kb + 2t][8nt + g] and W[8kb + 2t + 1][8nt + g], big,
//    big, small, small), followed by the biases zero-padded to 8.
//  * A C fragment (voxels g, g + 8; outputs 2t, 2t + 1 of an n-tile) is
//    the next layer's A fragment of the same lane when K pairs features
//    2t, 2t + 1 of a k-block as the B packing does: no shuffle.
//  * The narrow form (decode_narrow_kernel<kNT, kM>, chains whose
//    pre-split weights fit in shared memory, n-tiles <= 12): persistent
//    blocks of 8 warps load the weights once; each warp walks tiles of kM
//    x 16 voxels alone and keeps a layer's input and output in registers
//    (kNT n-tiles of C fragments each, the layers in pairs so that
//    nothing is copied); no shared activation store, no barrier per tile.
//    Paced by instruction issue: the sines (15 instructions each) and the
//    splits beside the mma (5 x 22: 16 warps per SM).
//  * The wide form (decode_wide_kernel<kNW, kGlobal>): a persistent block
//    of 8 warps decodes 128 voxels at a time; each layer's B fragments
//    stream through a ring of k-block slabs in shared memory (SlabRing:
//    one thread issues each slab as a TMA bulk copy, mbarriers count the
//    bytes in and the warps' releases out), and each warp takes kNW
//    n-tiles for all 8 m-tiles (or, where a layer has at most kNW
//    n-tiles, as the last one has, one m-tile with all of them), so every
//    16-byte fragment read feeds 8 voxel tiles.  The layer's input lives
//    in shared memory (feature-major rows of 132 floats: fragment reads
//    hit 32 banks) and the output is written over it after a barrier.
//    Chains with a layer wider than 256 (kGlobal) keep two activation
//    buffers per block in a device scratch instead and take the outputs
//    in passes of 32 n-tiles.  One block of 8 warps an SM (the input
//    rows and the slabs fill shared memory, the accumulators 128
//    registers a thread): 5 x 191 at ~60% of the tensor cores' mma.sync
//    rate while it multiplies; the waits for slabs and the sine epilogues
//    take the rest.
//  * Coordinates as the TPU kernel builds them, bit for bit as the plain
//    version does: the lead axis lo + i * step (no fused multiply-add,
//    SIRENPos-warped), the other axes from small axis_linspace tables the
//    wrapper builds.  The
//    flat voxel index splits into axis indices with 32-bit multiply-shift
//    divisions prepared on the host (ops/fused_decode.py fast_divisor);
//    grids of 2^31 voxels or more take 64-bit division.
//  * A voxel's value does not depend on the block or warp that decodes it
//    (tiles are fixed slices of the voxel range, no atomics): two calls
//    are bitwise equal.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "tf32.cuh"

namespace {

using brief::kMaxLayers;
using brief::mma_tf32;
using brief::pack_b;
using brief::split_tf32;

constexpr int kMaxPlaneAxes = 3;
constexpr int kWarps = 8;                   // both forms: 8 warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kWideM = 8;                   // wide form: m-tiles a block tile
constexpr int kWideVox = 16 * kWideM;       // voxels a block tile
constexpr int kWideStride = kWideVox + 4;   // activation row, floats
constexpr int kMaxStages = 8;               // wide form: slabs in the ring
constexpr int kBarFloats = 4 * kMaxStages;  // wide form: the ring's barriers

__host__ __device__ constexpr int min_c(int a, int b) { return a < b ? a : b; }

// n / d for 0 <= n < 2^31 (ops/fused_decode.py fast_divisor): the high
// word of n * mul shifted right; mul = 0 stands for d = 1.
struct FastDiv {
  unsigned mul;
  int shift;
};

__device__ __forceinline__ int fast_div(int n, FastDiv f) {
  return f.mul == 0u ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shift);
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

struct Desc {
  // the grid
  long long pop, plane;
  int index64;           // pop >= 2^31: 64-bit index arithmetic
  int n_plane, c_in, c_out, has_enc;
  int size[kMaxPlaneAxes], table_off[kMaxPlaneAxes];
  FastDiv div_plane, div_axis[kMaxPlaneAxes];
  float lo, step, enc_scale0;
  // the chain and its packed copy: fragments of layer l from float4
  // frag_off[l] (kb x nt of them), its biases from float bias_off[l]
  int n_layers, packed_floats, n_tiles, rows, stages;
  int fin[kMaxLayers], fout[kMaxLayers], kb[kMaxLayers], nt[kMaxLayers];
  int frag_off[kMaxLayers + 1], bias_off[kMaxLayers + 1], act[kMaxLayers];
  float w0[kMaxLayers];
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
};

// Coordinate features 0 .. 3 of voxel v < pop (zeros past c_in).
__device__ __forceinline__ void voxel_coords(const Desc& d,
                                             const float* __restrict__ tables,
                                             long long v, float (&x)[4]) {
  int idx[kMaxPlaneAxes];
  long long lead;
  if (!d.index64) {
    const int vi = (int)v;
    const int q = fast_div(vi, d.div_plane);
    int p = vi - q * (int)d.plane;
    lead = q;
#pragma unroll
    for (int k = 0; k < kMaxPlaneAxes; ++k) {
      const int a = kMaxPlaneAxes - 1 - k;
      idx[a] = 0;
      if (a < d.n_plane) {
        const int r = fast_div(p, d.div_axis[a]);
        idx[a] = p - r * d.size[a];
        p = r;
      }
    }
  } else {
    lead = v / d.plane;
    long long p = v - lead * d.plane;
#pragma unroll
    for (int k = 0; k < kMaxPlaneAxes; ++k) {
      const int a = kMaxPlaneAxes - 1 - k;
      idx[a] = 0;
      if (a < d.n_plane) {
        idx[a] = (int)(p % d.size[a]);
        p /= d.size[a];
      }
    }
  }
  float z0 = __fadd_rn(d.lo, __fmul_rn((float)lead, d.step));
  if (d.has_enc) z0 = brief::fast_sin(__fmul_rn(d.enc_scale0, z0));
  x[0] = z0;
#pragma unroll
  for (int a = 0; a < kMaxPlaneAxes; ++a)
    x[1 + a] = a < d.n_plane ? __ldg(tables + d.table_off[a] + idx[a]) : 0.f;
}

// c[i] = act(c[i]) for kN accumulators, the activation picked once
template <int kN>
__device__ __forceinline__ void activate(float* c, int act, float w0) {
  switch (act) {
    case brief::kActSine:
#pragma unroll
      for (int i = 0; i < kN; ++i) c[i] = brief::fast_sin(w0 * c[i]);
      break;
    case brief::kActRelu:
#pragma unroll
      for (int i = 0; i < kN; ++i) c[i] = fmaxf(c[i], 0.f);
      break;
    case brief::kActSigmoid:
#pragma unroll
      for (int i = 0; i < kN; ++i) c[i] = 1.f / (1.f + expf(-c[i]));
      break;
    default:
      break;
  }
}

// Every layer's W split into B fragments (float4 e < frag_off[L]), then
// the biases padded to 8 (floats from bias_off[0]), one float4 a thread.
__global__ void pack_kernel(float* __restrict__ packed, Desc d) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int L = d.n_layers;
  if (e < d.frag_off[L]) {
    int l = 0;
    while (e >= d.frag_off[l + 1]) ++l;
    const int local = e - d.frag_off[l], lane = local & 31;
    const int frag = local >> 5, kb = frag / d.nt[l];
    const int i = 8 * kb + 2 * (lane & 3);
    const int o = 8 * (frag - kb * d.nt[l]) + (lane >> 2);
    const int fin = d.fin[l], fout = d.fout[l];
    const float* W = d.w[l];
    const bool ok = o < fout;
    reinterpret_cast<float4*>(packed)[e] =
        pack_b(ok && i < fin ? W[i * fout + o] : 0.f,
               ok && i + 1 < fin ? W[(i + 1) * fout + o] : 0.f);
  } else if (4 * e < d.packed_floats) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = 4 * e + q;
      int l = 0;
      while (l + 1 < L && f >= d.bias_off[l + 1]) ++l;
      const int o = f - d.bias_off[l];
      v[q] = o < d.fout[l] ? d.b[l][o] : 0.f;
    }
    reinterpret_cast<float4*>(packed)[e] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// The narrow form: kNT n-tiles of registers per layer input and output,
// for each of a warp's kM m-tiles.
// ---------------------------------------------------------------------------
// c[m][j] += h[m] W for n-tiles j < kJ of one layer and the warp's kM
// m-tiles of 16 voxels, k-blocks k < KB, in 3xTF32: B fragment (k, j) at
// wf[(k NT + j) 32 + lane], n-tiles past NT repeating the last (their
// outputs are never read).  No branch inside a k-block, so its 3 kJ kM
// mma are scheduled together, term by term across the tiles (consecutive
// mma are independent); each B fragment read feeds kM m-tiles.
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
      for (int m = 0; m < kM; ++m) {
        split_tf32(h[m][k][0], &ab[m][0], &as[m][0]);
        split_tf32(h[m][k][2], &ab[m][1], &as[m][1]);
        split_tf32(h[m][k][1], &ab[m][2], &as[m][2]);
        split_tf32(h[m][k][3], &ab[m][3], &as[m][3]);
      }
      float4 w[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) w[j] = wf[k * NT * 32 + off[j]];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int m = 0; m < kM; ++m)
          mma_tf32(c[m][j], as[m], __float_as_uint(w[j].x),
                   __float_as_uint(w[j].y));
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int m = 0; m < kM; ++m)
          mma_tf32(c[m][j], ab[m], __float_as_uint(w[j].z),
                   __float_as_uint(w[j].w));
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int m = 0; m < kM; ++m)
          mma_tf32(c[m][j], ab[m], __float_as_uint(w[j].x),
                   __float_as_uint(w[j].y));
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
template <int kNT, int kM>
__device__ __forceinline__ void narrow_step(float (&c)[kM][kNT][4],
                                            const float (&h)[kM][kNT][4],
                                            const float* sm, const Desc& d,
                                            int l, int lane, int t) {
  const int NT = d.nt[l];
  const float* bias = sm + d.bias_off[l];
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
                        reinterpret_cast<const float4*>(sm) + d.frag_off[l],
                        d.kb[l], NT, lane);
  activate<4 * kNT * kM>(&c[0][0][0], d.act[l], d.w0[l]);
}

// The last layer's outputs o < c_out of the warp's voxels v < pop
template <int kNT, int kM>
__device__ __forceinline__ void narrow_store(const float (&c)[kM][kNT][4],
                                             float* __restrict__ out,
                                             const Desc& d, long long v0,
                                             int l, int t) {
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 8 * j + 2 * t + (e & 1);
        const long long v = v0 + 16 * m + 8 * (e >> 1);
        if (j < d.nt[l] && o < d.c_out && v < d.pop)
          out[v * d.c_out + o] = c[m][j][e];
      }
    }
  }
}

// Grid-stride over tiles of 16 kM voxels, one a warp; kNT n-tiles of
// registers for a layer's input and for its output, per m-tile.
template <int kNT, int kM, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks) decode_narrow_kernel(
    const float* __restrict__ packed, const float* __restrict__ tables,
    float* __restrict__ out, Desc d) {
  extern __shared__ __align__(16) float sm[];
  for (int e = threadIdx.x; e < d.packed_floats / 4; e += kThreads)
    reinterpret_cast<float4*>(sm)[e] =
        __ldg(reinterpret_cast<const float4*>(packed) + e);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, L = d.n_layers;
  for (int tile = blockIdx.x * kWarps + warp; tile < d.n_tiles;
       tile += gridDim.x * kWarps) {
    const long long v0 = (long long)tile * (16 * kM) + g;
    // h[m][k][e]: feature 8k + 2t + (e & 1) of voxel v0 + 16 m + 8 (e >> 1),
    // the C fragment layout; layer 0's input is the coordinates (k-block 0)
    float h[kM][kNT][4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int k = 0; k < kNT; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[m][k][e] = 0.f;
      float x[4], y[4];
      const long long va = v0 + 16 * m, vb = va + 8;
      voxel_coords(d, tables, va < d.pop ? va : d.pop - 1, x);
      voxel_coords(d, tables, vb < d.pop ? vb : d.pop - 1, y);
      if (t < 2) {
        h[m][0][0] = t == 0 ? x[0] : x[2];
        h[m][0][1] = t == 0 ? x[1] : x[3];
        h[m][0][2] = t == 0 ? y[0] : y[2];
        h[m][0][3] = t == 0 ? y[1] : y[3];
      }
    }
    // layers in pairs, h -> c -> h, so no copy between them
    float c[kM][kNT][4];
    for (int l = 0;; l += 2) {
      narrow_step<kNT, kM>(c, h, sm, d, l, lane, t);
      if (l + 1 == L) {
        narrow_store<kNT, kM>(c, out, d, v0, l, t);
        break;
      }
      narrow_step<kNT, kM>(h, c, sm, d, l + 1, lane, t);
      if (l + 2 == L) {
        narrow_store<kNT, kM>(h, out, d, v0, l + 1, t);
        break;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The wide form: B fragments streamed in k-block slabs, 128-voxel tiles.
// ---------------------------------------------------------------------------
// One k-block of the wide form's product for one warp: c[j][m] += A_m B_j
// in 3xTF32 for kJ of its n-tiles (slab fragments jb + js j) and kMt
// m-tiles (A: rows 2t, 2t + 1 of the k-block, voxels xa + 16 m and + 8),
// every A fragment loaded and split first.  No branch inside, so its
// 3 kJ kMt mma are scheduled together.
template <int kNW, int kJ, int kMt>
__device__ __forceinline__ void wide_step(float (&c)[kNW][kWideM][4],
                                          const float4* ws, int jb, int js,
                                          const float* xa, int lane) {
  constexpr int S = kWideStride;
  float4 w[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) w[j] = ws[(jb + js * j) * 32 + lane];
  uint32_t ab[kMt][4], as[kMt][4];
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
    const float* p = xa + 16 * m;
    split_tf32(p[0], &ab[m][0], &as[m][0]);
    split_tf32(p[8], &ab[m][1], &as[m][1]);
    split_tf32(p[S], &ab[m][2], &as[m][2]);
    split_tf32(p[S + 8], &ab[m][3], &as[m][3]);
  }
  // term by term over all kJ x kMt accumulators: an mma's accumulator was
  // last written kJ kMt mma earlier
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      mma_tf32(c[j][m], as[m], __float_as_uint(w[j].x),
               __float_as_uint(w[j].y));
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      mma_tf32(c[j][m], ab[m], __float_as_uint(w[j].z),
               __float_as_uint(w[j].w));
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      mma_tf32(c[j][m], ab[m], __float_as_uint(w[j].x),
               __float_as_uint(w[j].y));
}

// The wide form's slab ring of d.stages slabs: thread 0 streams every
// k-block slab that the block's tiles need, in the order the warps
// consume them (tile, layer, pass, k-block), stages - 1 ahead of its own
// warp: slab n fills stage n % stages once every warp has released the
// stage's previous slab (barrier empty) and completes the phase
// (n / stages) & 1 of barrier full.  The weights are the same for every
// tile, so loads run ahead across layer and tile boundaries, during the
// epilogues.
template <int kP>
struct SlabRing {
  uint64_t* full;
  uint64_t* empty;
  float4* slab;
  // the next slab's stage, the phase its fill completes, whether the
  // stage was filled before; the next slab's tile, layer, pass, k-block
  int stage, phase, reuse, tile, l, nb, kb;

  __device__ __forceinline__ void produce(const Desc& d,
                                          const float* packed) {
    if (tile >= d.n_tiles) return;
    const int st = stage, NT = d.nt[l];
    if (reuse) mbar_wait(empty + st, phase ^ 1);
    bulk_load(slab + st * 32 * kP,
              reinterpret_cast<const float4*>(packed) + d.frag_off[l] +
                  ((size_t)kb * NT + nb) * 32,
              min(kP, NT - nb) * 512, full + st);
    if (++stage == d.stages) {
      stage = 0;
      phase ^= 1;
      reuse = 1;
    }
    if (++kb == d.kb[l]) {
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

template <int kNW, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 1) decode_wide_kernel(
    const float* __restrict__ packed, const float* __restrict__ tables,
    float* __restrict__ out, float* __restrict__ scratch, Desc d) {
  constexpr int kP = kWarps * kNW;   // n-tiles per pass
  constexpr int kSlab = 32 * kP;     // float4 per slab
  constexpr int S = kWideStride;
  extern __shared__ __align__(16) float sm[];
  SlabRing<kP> ring;
  ring.full = reinterpret_cast<uint64_t*>(sm);
  ring.empty = ring.full + kMaxStages;
  ring.slab = reinterpret_cast<float4*>(sm + kBarFloats);
  ring.stage = ring.phase = ring.reuse = ring.l = ring.nb = ring.kb = 0;
  ring.tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, L = d.n_layers;
  float* const X0 = kGlobal
      ? scratch + (size_t)blockIdx.x * 2 * d.rows * S
      : sm + kBarFloats + d.stages * kSlab * 4;
  if (threadIdx.x == 0) {
    for (int i = 0; i < d.stages; ++i) {
      mbar_init(ring.full + i, 1);
      mbar_init(ring.empty + i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < d.stages - 1; ++i) ring.produce(d, packed);
  }
  int stage = 0, phase = 0;   // the next slab to consume, its fill
  float* const Y0 = kGlobal ? X0 + (size_t)d.rows * S : X0;

  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    const long long base = (long long)tile * kWideVox;
    float* X = X0;
    float* Y = Y0;
    __syncthreads();   // the previous tile's last layer has read X
    {
      // coordinates into rows 0 .. 3, zeros into rows 4 .. 7
      const int u = threadIdx.x % kWideVox, half = threadIdx.x / kWideVox;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (half == 0) {
        const long long v = base + u;
        voxel_coords(d, tables, v < d.pop ? v : d.pop - 1, x);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) X[(4 * half + r) * S + u] = x[r];
    }
    for (int l = 0; l < L; ++l) {
      const int KB = d.kb[l], NT = d.nt[l];
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
                    packed + d.bias_off[l] + 8 * (nb + n) + 2 * t))
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
        activate<4 * kNW * kWideM>(&c[0][0][0], d.act[l], d.w0[l]);
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
                if (m < mc && jb + js * j < np && o < d.c_out && v < d.pop)
                  out[v * d.c_out + o] = c[j][m][e];
              }
            }
          }
          continue;
        }
        if (!kGlobal) __syncthreads();   // every warp has read X: in place
#pragma unroll
        for (int j = 0; j < kNW; ++j) {
          const int n = jb + js * j;
          if (n < np) {
            float* y = Y + (8 * (nb + n) + 2 * t) * S + 16 * m0 + g;
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
      if (kGlobal) {
        float* sw = X;
        X = Y;
        Y = sw;
      }
    }
  }
}

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
// for the split weights.
int brief_fused_decode(const float* tables, float* out, float* packed,
                       float* scratch, const void* const* wb, long long pop,
                       const int* meta, const float* fmeta, int form,
                       int inst, int grid, int smem_bytes, void* stream) {
  Desc d;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || d.n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.n_plane = meta[3];
  d.has_enc = meta[4];
  d.index64 = meta[5];
  d.n_tiles = meta[6];
  d.rows = meta[7];
  d.packed_floats = meta[8];
  d.stages = meta[9];
  if (d.n_plane < 1 || d.n_plane > kMaxPlaneAxes || d.c_in > 4)
    return (int)cudaErrorInvalidValue;
  d.pop = pop;
  d.plane = 1;
  const int* m = meta + 10;
  for (int a = 0; a < kMaxPlaneAxes; ++a) {
    d.size[a] = m[a];
    d.table_off[a] = m[kMaxPlaneAxes + a];
    if (a < d.n_plane) d.plane *= m[a];
  }
  m += 2 * kMaxPlaneAxes;
  d.div_plane = FastDiv{(unsigned)m[0], m[1]};
  for (int a = 0; a < kMaxPlaneAxes; ++a)
    d.div_axis[a] = FastDiv{(unsigned)m[2 + 2 * a], m[3 + 2 * a]};
  m += 2 + 2 * kMaxPlaneAxes;
  for (int l = 0; l < d.n_layers; ++l) {
    d.fin[l] = m[7 * l + 0];
    d.fout[l] = m[7 * l + 1];
    d.kb[l] = m[7 * l + 2];
    d.nt[l] = m[7 * l + 3];
    d.frag_off[l] = m[7 * l + 4];
    d.bias_off[l] = m[7 * l + 5];
    d.act[l] = m[7 * l + 6];
    d.w0[l] = fmeta[3 + l];
    d.w[l] = static_cast<const float*>(wb[2 * l]);
    d.b[l] = static_cast<const float*>(wb[2 * l + 1]);
  }
  d.frag_off[d.n_layers] = d.bias_off[0] / 4;
  d.bias_off[d.n_layers] = d.packed_floats;
  d.lo = fmeta[0];
  d.step = fmeta[1];
  d.enc_scale0 = fmeta[2];

  cudaStream_t s = (cudaStream_t)stream;
  pack_kernel<<<(d.packed_floats / 4 + 255) / 256, 256, 0, s>>>(packed, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  void (*narrow)(const float*, const float*, float*, Desc) = nullptr;
  void (*wide)(const float*, const float*, float*, float*, Desc) = nullptr;
  if (form == 0) {
    switch (inst) {   // kNT, m-tiles a warp, blocks an SM
      case 3: narrow = decode_narrow_kernel<3, 2, 2>; break;
      case 6: narrow = decode_narrow_kernel<6, 1, 2>; break;
      case 9: narrow = decode_narrow_kernel<9, 2, 1>; break;
      case 12: narrow = decode_narrow_kernel<12, 1, 1>; break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (form == 1) {
    switch (inst) {
      case 1: wide = decode_wide_kernel<1, false>; break;
      case 2: wide = decode_wide_kernel<2, false>; break;
      case 3: wide = decode_wide_kernel<3, false>; break;
      case 4: wide = decode_wide_kernel<4, false>; break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (form == 2 && inst == 4) {
    wide = decode_wide_kernel<4, true>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (grid < 1 || (wide != nullptr &&
                   (d.stages < 2 || d.stages > kMaxStages)))
    return (int)cudaErrorInvalidValue;
  err = narrow != nullptr
      ? cudaFuncSetAttribute(narrow,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes)
      : cudaFuncSetAttribute(wide,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (narrow != nullptr) {
    narrow<<<grid, kThreads, smem_bytes, s>>>(packed, tables, out, d);
  } else {
    wide<<<grid, kThreads, smem_bytes, s>>>(packed, tables, out, scratch, d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
