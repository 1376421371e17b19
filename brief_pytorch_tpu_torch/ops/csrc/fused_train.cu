// Fused train-step gradients of a plain activation chain, for Hopper, for
// one chain or for a fleet of B chains of one padded shape.
//
// Replaces the Pallas TPU kernel of brief_pytorch_tpu/ops/pallas_train.py
// (_make_train_kernel / _fused_grads_padded / fused_train_grads), in its
// single form and in the fleet form that jax.vmap makes of it in
// parallel/block_trainer.run_block_segment: one pass over a coordinate
// batch runs the chain forward (storing each layer's activation h_l and
// derivative d_l; for sine one range reduction gives both), the weighted
// datal2 / datasmoothl1 loss with the weight_thres override, and a
// backward with no transcendentals that sums dW and db over the batch.
// Output per chain: loss and gradients divided by N * Cout.
//
// Fleet form: blockIdx.y is the fleet block.  Its unit masks (one 0/1 row
// per hidden layer, the width padding of block_trainer.stacked_apply)
// multiply h_l and d_l after the activation, so padded units carry 0 and
// every gradient into them is exactly 0; a masked identity layer's
// derivative is its mask.  Its threshold is read per block (-inf: the
// override never fires).
//
// What bounds it on an H100: operations.  At the single run's shapes
// (SIREN 5 x 22, N = 262,144) it reads ~5 MB (3.3 TB/s: ~1.6 us) but does
// ~2.4 GFLOP of chain products plus ~88 sincos per coordinate (67 TFLOP/s
// float32: ~45 us); at the HiP-CT fleet's (4 blocks x 100,000, 3-64x6-1
// padded from 49/52/58/64) ~41 GFLOP on the true widths, ~53 on the padded
// ones.  Tensor cores are unused: this version keeps float32 CUDA-core
// arithmetic so it agrees with the plain version to float32 rounding.
//
// Three layouts (ops/fused_train.py choose_plan takes the first that fits):
//  * narrow (fused_train_kernel, e.g. 5 x 22, 3-7x4-1): W, W^T, the
//    biases and the block's gradient accumulator in shared memory beside
//    the activation tile, one thread per coordinate (5 x 22: 11% of the
//    float32 bound).
//  * tiled (fused_train_tiled_kernel, e.g. 3-64x6-1, 3-66x6-1, 5 x 95):
//    the weights once in shared memory, dW in registers; described below
//    the narrow layout's code.  Paced by shared-memory reads and the
//    sine evaluations (3-64x6-1 fleet: 23% of the bound).
//  * wide (wide_train_kernel + wide_dw_kernel, e.g. 3-191x4-1,
//    3-242x4-1, 3-128x6-1): W streamed through shared memory in slabs,
//    h_l and d_l in a device-memory scratch, dW a split-K product over it;
//    described at its code.
//
// Design of the narrow layout (fused_train_kernel):
//  * A block owns a tile of T coordinates (T = blockDim.x, one per
//    thread) and walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... of
//    its fleet block (a persistent grid of a few blocks per SM), so the
//    TPU grid's in-order accumulation becomes a loop inside the block.
//  * h_l and d_l of the tile stay in shared memory, one column per
//    thread (rows padded to T + 1 floats so that the weight-gradient
//    phase, where a warp reads one column index across many rows, hits
//    distinct banks).  Nothing per coordinate goes to device memory.
//  * W padded for the forward, W^T padded for the backward, the biases
//    and the block's gradient accumulator all live in shared memory.
//  * Weight gradients: after a layer's output gradient g_l is in shared
//    memory, thread t owns parameter entries e = t, t + T, ... of that
//    layer and sums g_l[o] * h_{l-1}[i] over the tile's coordinates into
//    the accumulator.  Each block writes one row of partial sums; a second
//    kernel adds the rows of each fleet block in block order.  No float
//    atomics: the result is the same on every run with the same grid.
//  * The input gradient g_{l-1} = d_{l-1} * (W_l g_l) overwrites d_{l-1}
//    in place, in the thread's own column.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "wide.cuh"

namespace {

using brief::kChunk;
using brief::kMaxLayers;
using brief::round_up8;

// The fleet's fields come last: placed before w0 they make the compiler
// schedule the one-chain kernel's loops measurably slower.
struct TrainDesc {
  int n_layers, c_in, c_out, n_params, stride;
  int acc_off, red_off, act_off;
  int fin[kMaxLayers], fout[kMaxLayers], act[kMaxLayers];
  int p_off[kMaxLayers], sw_off[kMaxLayers], swt_off[kMaxLayers];
  int sb_off[kMaxLayers], h_row[kMaxLayers], dg_row[kMaxLayers];
  float w0[kMaxLayers];
  int mask_width;
  int mask_off[kMaxLayers];
};

constexpr int kMetaHead = 9;
constexpr int kMetaPerLayer = 10;

// This block's row of partial sums (gradients, then the loss) in the
// (B, gridDim.x, n_params + 1) scratch.
__device__ __forceinline__ float* partial_row(float* partial, int fb,
                                              int n_params) {
  return partial +
         ((size_t)fb * gridDim.x + blockIdx.x) * (size_t)(n_params + 1);
}

// The narrow layout.  kFleet: the fleet form (blockIdx.y selects the
// chain, masks per chain); without it one chain and none of the fleet's
// address arithmetic (it slows the one-chain path).  thres: one threshold
// per chain, read when has_thres (-inf never fires); it waits in the first
// slot of the loss reduction buffer, idle until the end, since a register
// held across the kernel slows the one-chain loops.
template <bool kFleet>
__global__ void fused_train_kernel(const float* __restrict__ coords,
                                   const float* __restrict__ values,
                                   const float* __restrict__ weights,
                                   const float* __restrict__ params,
                                   float* __restrict__ partial, int n,
                                   TrainDesc d, int loss, float beta,
                                   int has_thres,
                                   const float* __restrict__ thres,
                                   const float* __restrict__ masks) {
  extern __shared__ __align__(16) float sm[];
  // T threads, one per coordinate of the tile
  const int T = blockDim.x, t = threadIdx.x, S = d.stride, L = d.n_layers;
  const int fb = kFleet ? blockIdx.y : 0;          // fleet block
  const float* mk = nullptr;
  if (kFleet) {
    coords += (size_t)fb * d.c_in * n;
    values += (size_t)fb * d.c_out * n;
    weights += (size_t)fb * d.c_out * n;
    params += (size_t)fb * d.n_params;
    if (masks != nullptr) mk = masks + (size_t)fb * d.mask_width;
  }
  float* acc = sm + d.acc_off;
  float* A = sm + d.act_off;

  for (int l = 0; l < L; ++l) {
    brief::load_weights(params + d.p_off[l], d.fin[l], d.fout[l],
                        sm + d.sw_off[l], sm + d.swt_off[l],
                        sm + d.sb_off[l]);
  }
  for (int e = t; e < d.n_params; e += T) acc[e] = 0.f;
  if (t == 0 && has_thres) sm[d.red_off] = thres[fb];
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
      const int in_row = l == 0 ? 0 : d.h_row[l - 1];
      const float* ml =
          mk == nullptr || d.mask_off[l] < 0 ? nullptr : mk + d.mask_off[l];
      brief::layer_forward<true>(sm + d.sw_off[l], sm + d.sb_off[l], A, S,
                                 t, in_row, d.fin[l], d.fout[l], d.act[l],
                                 d.w0[l], d.h_row[l], d.dg_row[l], ml);
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
      float weff = (has_thres && p <= sm[d.red_off]) ? 1.f : wv;
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
      // weight and bias gradients: reads every column of g_l and h_{l-1};
      // thread t owns entries e = t, t + T, ... of the packed (W, b)
      for (int e = t; e < nw + fout; e += T) {
        float s = 0.f;
        if (e < nw) {
          const int i = e / fout, o = e - i * fout;
          const float* g = G + o * S;
          const float* h = H + i * S;
          for (int v = 0; v < T; ++v) s = fmaf(g[v], h[v], s);
        } else {
          const float* g = G + (e - nw) * S;
          for (int v = 0; v < T; ++v) s += g[v];
        }
        accl[e] += s;
      }
      // input gradient into d_{l-1}, own column only
      if (l > 0) {
        float* D = A + d.dg_row[l - 1] * S;
        const float* swt = sm + d.swt_off[l];
        const int fip = round_up8(fin);
        for (int i0 = 0; i0 < fin; i0 += kChunk) {
          float z[kChunk];
#pragma unroll
          for (int k = 0; k < kChunk; ++k) z[k] = 0.f;
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
          for (int k = 0; k < kChunk; ++k) {
            const int i = i0 + k;
            if (i < fin) D[i * S + t] = z[k] * D[i * S + t];
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- this block's partial sums: gradients, then the loss ----
  float* out = partial_row(partial, fb, d.n_params);
  for (int e = t; e < d.n_params; e += T) out[e] = acc[e];
  float* red = sm + d.red_off;
  __syncthreads();   // every thread is done with the threshold in red[0]
  red[t] = loss_acc;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  if (t == 0) out[d.n_params] = red[0];
}

// out[fb][p] = (sum over blocks g, in order, of partial[fb][g][p]) / m,
// fb = blockIdx.y (the fleet's row offsets slow the one-chain sum, so
// they are compiled in only for the fleet)
template <bool kFleet>
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int n_blocks,
                                       int width, float m) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= width) return;
  if (kFleet) {
    partial += (size_t)blockIdx.y * n_blocks * width;
    out += (size_t)blockIdx.y * width;
  }
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * width + p];
  out[p] = s / m;
}

// ---------------------------------------------------------------------------
// The tiled layout: a kernel of its own (the narrow layout above keeps its
// code), for chains whose weights, stored once, fit in shared memory beside
// a 32-coordinate activation tile, and whose dW fits the threads' registers.
//
// Why: in the old wide layout every multiply-add of the forward and the input
// gradient loaded its W entry from L2, and the dW loop took two shared
// reads per multiply-add plus a device-memory read-modify-write of the
// block's whole partial row per tile.  Here (3-64x6-1: 198,656 bytes, one
// block of 256 threads per SM):
//  * W of every layer once, as (round4(fin + 1), round4(fout)): the bias
//    is row fin, and each layer's input block carries a row of ones, so
//    the bias is one more multiply-add row of the same loops.  The input
//    gradient reads the same rows along o: no W^T copy.
//  * Activation rows of 32 floats (one 128-byte line), their 16-byte
//    chunks XOR-permuted per row quad (elem), h_l / d_l blocks padded to
//    row quads; padding rows stay 0, so padded units add exact zeros.
//  * The forward and the input gradient: each thread a 4 x 2 micro-tile
//    (4 outputs or inputs x 2 coordinates), 8 multiply-adds per one
//    16-byte W read and one 8-byte activation read.  The last layer (one
//    output) splits its inner dimension over 16 lanes and sums by
//    shuffles.  The activation is picked once per micro-tile and the mask
//    read ahead, so its 8 evaluations overlap.
//  * dW: the (fin + 1) x fout gradient of every layer cut into 4 x 4
//    tiles, dealt round-robin to the 256 threads (ops/fused_train.py
//    dw_map: 6 slots, 96 registers at 3-64x6-1, 252 in all and no spill;
//    the 8-slot instance, for chains such as 5 x 95, spills 164 bytes);
//    after the tile's backward, each thread adds H^T G of its tiles over
//    the 32 coordinates (16-byte reads: 64 multiply-adds per 8 reads) into
//    registers it keeps for the whole persistent loop, and writes its
//    block's partial row once at the end.  No atomics: reduce_partials_kernel adds the rows in
//    order, so runs are bitwise equal.
// Tried and dropped (PERF.md, section 6): 4 x 4 micro-tiles with the inner
// dimension split over two lanes (slower), 512 threads (the dW registers
// spill; slower), W rows padded against bank conflicts and the inner loops
// unrolled twice (no change).
// ---------------------------------------------------------------------------
constexpr int kTile = 32;            // coordinates per tile: one 128-byte row
constexpr int kTiledThreads = 256;
constexpr int kCols = 2;             // coordinates per forward / dX micro-tile
constexpr int kColGroups = kTile / kCols;
constexpr int kTiledHead = 8;
constexpr int kTiledPerLayer = 9;
static_assert(kCols == 2, "the micro-tile loops are written for 2 columns");

struct TiledDesc {
  int n_layers, c_in, c_out, n_params, red_off, act_off, mask_width;
  int fin[kMaxLayers], fout[kMaxLayers], act[kMaxLayers], p_off[kMaxLayers];
  int w_off[kMaxLayers], x_row[kMaxLayers], h_row[kMaxLayers];
  int g_row[kMaxLayers], mask_off[kMaxLayers];
  float w0[kMaxLayers];
};

__host__ __device__ __forceinline__ int round_up4(int x) {
  return (x + 3) & ~3;
}

// Float offset of coordinate u of activation row r.  A row is one 128-byte
// line (kTile floats); the 4-float chunks of rows 4j .. 4j + 3 are
// XOR-permuted by j & 7, so 16-byte reads of one chunk from 8 consecutive
// row quads hit 8 distinct bank quads.  Rows of one quad share the
// permutation: elem(4j + a, u) = elem(4j, u) + a * kTile.
__device__ __forceinline__ int elem(int r, int u) {
  return r * kTile + ((((u >> 2) ^ (r >> 2)) & 7) << 2) + (u & 3);
}

// h = act(z), d = act'(z) for the 4 x kCols outputs of a micro-tile, the
// activation chosen once (so the 8 evaluations are independent
// instructions the scheduler can interleave), times the unit mask m[k].
template <int kAct>
__device__ __forceinline__ void act_tile(const float (&z)[4][kCols], float w0,
                                         const float (&m)[4],
                                         float (&h)[4][kCols],
                                         float (&dv)[4][kCols]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      brief::act_fwd(kAct, w0, z[k][c], &h[k][c], &dv[k][c]);
      h[k][c] *= m[k];
      dv[k][c] *= m[k];
    }
  }
}

// Rows [hr, hr + fout) = act(W^T x + b) of the tile and rows [dr, dr + fout)
// = act'; x is rows [xr, xr + fin] (row xr + fin holds ones, W's row fin the
// bias; both zero past it up to the row quad).  A thread owns 4 outputs x kCols coordinates; where the layer has fewer
// such micro-tiles than threads (the last layer), `split` threads share
// one, each a stride of the row quads, summed by shuffles.
__device__ __forceinline__ void tiled_forward(
    const float* __restrict__ W, float* A, int xr, int fin, int fout,
    int act, float w0, int hr, int dr, const float* __restrict__ mask) {
  const int t = threadIdx.x, fop = round_up4(fout);
  const int n_mt = (fop >> 2) * kColGroups;
  int split = 1;
  while (split < 32 && 2 * split * n_mt <= kTiledThreads) split *= 2;
  const int part = t & (split - 1);
  for (int m = t / split; m < n_mt; m += kTiledThreads / split) {
    const int o0 = (m / kColGroups) * 4, u0 = (m % kColGroups) * kCols;
    float mo[4];   // the mask, read ahead of the products
#pragma unroll
    for (int k = 0; k < 4; ++k)
      mo[k] = mask != nullptr && o0 + k < fout ? __ldg(mask + o0 + k) : 1.f;
    float z[4][kCols];
#pragma unroll
    for (int k = 0; k < 4; ++k) z[k][0] = z[k][1] = 0.f;
    for (int q = part; 4 * q <= fin; q += split) {
      const float* x = A + elem(xr + 4 * q, u0);
      const float* w = W + 4 * q * fop + o0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 wv = *reinterpret_cast<const float4*>(w + j * fop);
        const float2 xv = *reinterpret_cast<const float2*>(x + j * kTile);
        z[0][0] = fmaf(wv.x, xv.x, z[0][0]);
        z[0][1] = fmaf(wv.x, xv.y, z[0][1]);
        z[1][0] = fmaf(wv.y, xv.x, z[1][0]);
        z[1][1] = fmaf(wv.y, xv.y, z[1][1]);
        z[2][0] = fmaf(wv.z, xv.x, z[2][0]);
        z[2][1] = fmaf(wv.z, xv.y, z[2][1]);
        z[3][0] = fmaf(wv.w, xv.x, z[3][0]);
        z[3][1] = fmaf(wv.w, xv.y, z[3][1]);
      }
    }
    // split > 1 only when all micro-tiles fit in one pass of whole warps
    for (int s = 1; s < split; s <<= 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        z[k][0] += __shfl_xor_sync(0xffffffffu, z[k][0], s);
        z[k][1] += __shfl_xor_sync(0xffffffffu, z[k][1], s);
      }
    }
    if (part != 0) continue;
    float h[4][kCols], dv[4][kCols];
    switch (act) {
      case brief::kActSine: act_tile<brief::kActSine>(z, w0, mo, h, dv); break;
      case brief::kActRelu: act_tile<brief::kActRelu>(z, w0, mo, h, dv); break;
      case brief::kActSigmoid:
        act_tile<brief::kActSigmoid>(z, w0, mo, h, dv);
        break;
      default: act_tile<brief::kActNone>(z, w0, mo, h, dv);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (o0 + k < fout) {
        *reinterpret_cast<float2*>(A + elem(hr + o0 + k, u0)) =
            make_float2(h[k][0], h[k][1]);
        *reinterpret_cast<float2*>(A + elem(dr + o0 + k, u0)) =
            make_float2(dv[k][0], dv[k][1]);
      }
    }
  }
}

// Rows [dr, dr + fin) *= W g: the input gradient of a layer whose output
// gradient is rows [gr, gr + round4(fout)) (zero past fout).  A thread owns
// 4 inputs x kCols coordinates and walks W's rows along o, so no W^T copy.
__device__ __forceinline__ void tiled_input_grad(const float* __restrict__ W,
                                                 float* A, int fin, int fout,
                                                 int gr, int dr) {
  const int t = threadIdx.x, fop = round_up4(fout);
  const int n_mt = ((fin + 3) >> 2) * kColGroups;
  for (int m = t; m < n_mt; m += kTiledThreads) {
    const int i0 = (m / kColGroups) * 4, u0 = (m % kColGroups) * kCols;
    float z[4][kCols];
#pragma unroll
    for (int a = 0; a < 4; ++a) z[a][0] = z[a][1] = 0.f;
    for (int o = 0; o < fop; o += 4) {
      const float* gq = A + elem(gr + o, u0);   // a row quad: one permutation
      float2 g[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        g[b] = *reinterpret_cast<const float2*>(gq + b * kTile);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 w =
            *reinterpret_cast<const float4*>(W + (i0 + a) * fop + o);
        z[a][0] = fmaf(w.x, g[0].x, z[a][0]);
        z[a][1] = fmaf(w.x, g[0].y, z[a][1]);
        z[a][0] = fmaf(w.y, g[1].x, z[a][0]);
        z[a][1] = fmaf(w.y, g[1].y, z[a][1]);
        z[a][0] = fmaf(w.z, g[2].x, z[a][0]);
        z[a][1] = fmaf(w.z, g[2].y, z[a][1]);
        z[a][0] = fmaf(w.w, g[3].x, z[a][0]);
        z[a][1] = fmaf(w.w, g[3].y, z[a][1]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (i0 + a < fin) {
        float2* p = reinterpret_cast<float2*>(A + elem(dr + i0 + a, u0));
        const float2 dv = *p;
        *p = make_float2(z[a][0] * dv.x, z[a][1] * dv.y);
      }
    }
  }
}

// kSlots: dW tiles per thread.  slot_map (kSlots, kTiledThreads): the
// tile (layer << 16 | ig << 8 | og, or -1) of entries (4 ig + a, 4 og + b),
// a, b < 4, of the layer's (W; b) gradient, bias as row fin, that thread t
// sums in registers for its whole run (ops/fused_train.py dw_map).
template <int kSlots>
__global__ void __launch_bounds__(kTiledThreads, 1) fused_train_tiled_kernel(
    const float* __restrict__ coords, const float* __restrict__ values,
    const float* __restrict__ weights, const float* __restrict__ params,
    const int* __restrict__ slot_map, float* __restrict__ partial, int n,
    TiledDesc d, int loss, float beta, int has_thres,
    const float* __restrict__ thres, const float* __restrict__ masks) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, L = d.n_layers, fb = blockIdx.y;
  coords += (size_t)fb * d.c_in * n;
  values += (size_t)fb * d.c_out * n;
  weights += (size_t)fb * d.c_out * n;
  params += (size_t)fb * d.n_params;
  const float* mk =
      masks == nullptr ? nullptr : masks + (size_t)fb * d.mask_width;
  const float thr = has_thres ? thres[fb] : 0.f;
  float* A = sm + d.act_off;

  // W of layer l as (round4(fin + 1), round4(fout)): row fin is the bias
  // (it follows W in the packed parameters), zeros elsewhere
  for (int l = 0; l < L; ++l) {
    const int fin = d.fin[l], fout = d.fout[l], fop = round_up4(fout);
    const float* W = params + d.p_off[l];
    float* sw = sm + d.w_off[l];
    for (int e = t; e < round_up4(fin + 1) * fop; e += kTiledThreads) {
      const int i = e / fop, o = e - i * fop;
      sw[e] = (i <= fin && o < fout) ? W[i * fout + o] : 0.f;
    }
  }
  // activation rows: zeros (padding rows stay zero), then the ones row
  // after each layer's input
  const int n_rows = d.g_row[L - 1] + round_up4(d.fout[L - 1]);
  for (int e = t; e < n_rows * kTile; e += kTiledThreads) A[e] = 0.f;
  __syncthreads();
  for (int e = t; e < L * kTile; e += kTiledThreads) {
    const int l = e / kTile;
    A[elem(d.x_row[l] + d.fin[l], e - l * kTile)] = 1.f;
  }

  // this thread's dW tiles: first rows of their H and G quads, times kTile
  int hb[kSlots], gb[kSlots];
  float acc[kSlots][16];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int code = slot_map[k * kTiledThreads + t];
    hb[k] = gb[k] = -1;
    if (code >= 0) {
      const int l = code >> 16, ig = (code >> 8) & 255, og = code & 255;
      hb[k] = (d.x_row[l] + 4 * ig) * kTile;
      gb[k] = (d.g_row[l] + 4 * og) * kTile;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[k][j] = 0.f;
  }
  float loss_acc = 0.f;

  const int n_tiles = (n + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kTile;
    for (int e = t; e < d.c_in * kTile; e += kTiledThreads) {
      const int c = e / kTile, u = e - c * kTile, idx = base + u;
      A[elem(c, u)] = idx < n ? coords[(size_t)c * n + idx] : 0.f;
    }
    __syncthreads();

    // ---- forward: h_l and d_l of the tile ----
    for (int l = 0; l < L; ++l) {
      const float* ml =
          mk == nullptr || d.mask_off[l] < 0 ? nullptr : mk + d.mask_off[l];
      tiled_forward(sm + d.w_off[l], A, d.x_row[l], d.fin[l], d.fout[l],
                    d.act[l], d.w0[l], d.h_row[l], d.g_row[l], ml);
      __syncthreads();
    }

    // ---- loss and dL/dz of the last layer (padding lanes weigh 0) ----
    const int last = L - 1;
    for (int e = t; e < d.c_out * kTile; e += kTiledThreads) {
      const int c = e / kTile, u = e - c * kTile, idx = base + u;
      const bool valid = idx < n;
      const float p = A[elem(d.h_row[last] + c, u)];
      float y = 0.f, wv = 0.f;
      if (valid) {
        y = values[(size_t)c * n + idx];
        wv = weights[(size_t)c * n + idx];
      }
      float weff = (has_thres && p <= thr) ? 1.f : wv;
      weff = valid ? weff : 0.f;
      const float er = p - y;
      float le, g;
      if (loss == 0) {  // datal2
        le = er * er;
        g = 2.f * weff * er;
      } else {          // datasmoothl1
        const float ae = fabsf(er);
        le = ae < beta ? 0.5f * ae * ae / beta : ae - 0.5f * beta;
        const float sg = (float)((er > 0.f) - (er < 0.f));
        g = weff * (ae < beta ? er / beta : sg);
      }
      loss_acc += weff * le;
      float* dg = A + elem(d.g_row[last] + c, u);
      *dg = g * *dg;
    }
    __syncthreads();

    // ---- input gradients, last layer first: g_{l-1} over d_{l-1} ----
    for (int l = L - 1; l > 0; --l) {
      tiled_input_grad(sm + d.w_off[l], A, d.fin[l], d.fout[l], d.g_row[l],
                       d.g_row[l - 1]);
      __syncthreads();
    }

    // ---- dW of every layer: each thread its 4 x 4 tiles, in registers ----
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (hb[k] < 0) continue;
      const int hkey = (hb[k] >> 5) & 28, gkey = (gb[k] >> 5) & 28;
#pragma unroll
      for (int uc = 0; uc < kTile / 4; ++uc) {
        float4 h[4], g[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          h[a] = *reinterpret_cast<const float4*>(
              A + hb[k] + a * kTile + ((uc << 2) ^ hkey));
#pragma unroll
        for (int b = 0; b < 4; ++b)
          g[b] = *reinterpret_cast<const float4*>(
              A + gb[k] + b * kTile + ((uc << 2) ^ gkey));
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            float s = acc[k][4 * a + b];
            s = fmaf(h[a].x, g[b].x, s);
            s = fmaf(h[a].y, g[b].y, s);
            s = fmaf(h[a].z, g[b].z, s);
            s = fmaf(h[a].w, g[b].w, s);
            acc[k][4 * a + b] = s;
          }
        }
      }
    }
    __syncthreads();   // the next tile overwrites the coordinates
  }

  // ---- this block's partial sums, written once: gradients, then loss ----
  float* out = partial_row(partial, fb, d.n_params);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int code = slot_map[k * kTiledThreads + t];
    if (code < 0) continue;
    const int l = code >> 16, ig = (code >> 8) & 255, og = code & 255;
    const int fin = d.fin[l], fout = d.fout[l];
    float* outl = out + d.p_off[l];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * ig + a, o = 4 * og + b;   // i == fin: the bias
        if (i <= fin && o < fout) outl[i * fout + o] = acc[k][4 * a + b];
      }
    }
  }
  float* red = sm + d.red_off;
  red[t] = loss_acc;
  __syncthreads();
  for (int s = kTiledThreads / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  if (t == 0) out[d.n_params] = red[0];
}

template <int kSlots>
cudaError_t tiled_occupancy(int smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_train_tiled_kernel<kSlots>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_train_tiled_kernel<kSlots>, kTiledThreads,
      smem_bytes);
}

template <int kSlots>
cudaError_t launch_tiled(dim3 grid, int smem_bytes, cudaStream_t s,
                         const float* coords, const float* values,
                         const float* weights, const float* params,
                         const int* slot_map, float* partial, int n,
                         const TiledDesc& d, int loss, float beta,
                         const float* thres, const float* masks) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_train_tiled_kernel<kSlots>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  fused_train_tiled_kernel<kSlots><<<grid, kTiledThreads, smem_bytes, s>>>(
      coords, values, weights, params, slot_map, partial, n, d, loss, beta,
      thres != nullptr, thres, masks);
  return cudaGetLastError();
}

cudaError_t occupancy(int block, int smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_train_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_train_kernel<false>, block, smem_bytes);
}

template <bool kFleet>
cudaError_t launch(dim3 grid, int block, int smem_bytes, cudaStream_t s,
                   const float* coords, const float* values,
                   const float* weights, const float* params, float* partial,
                   int n, const TrainDesc& d, int loss, float beta,
                   const float* thres, const float* masks) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_train_kernel<kFleet>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  fused_train_kernel<kFleet><<<grid, block, smem_bytes, s>>>(
      coords, values, weights, params, partial, n, d, loss, beta,
      thres != nullptr, thres, masks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide layout: for chains whose weights do not fit in shared memory
// beside a tile (the SingleTask default on the 64x512x512 demo volumes,
// 3-191x4-1 at 80x and 3-242x4-1 at 50x; fleet buckets padded past the
// tiled layout, e.g. 3-128x6-1).  Kernels of its own, with their own
// descriptor; the narrow and tiled layouts keep their code.
//
// Per call:
//  (a) pack_weights_kernel (csrc/wide.cuh): every layer's W with its bias
//      as one more row, zero-padded to (round64(fin + 1), round64(fout)),
//      so that 16-byte cp.async copies of a slab are aligned;
//  (b) wide_train_kernel: a persistent grid over tiles of kT coordinates;
//      per tile the forward (wide::forward_block, one layer at a time,
//      activations ping-ponging between two shared buffers), the loss and
//      the input gradients (wide::input_grad_block).  h_l and d_l of
//      every coordinate go to a scratch in device memory, feature-major
//      with a row stride np = round64(N); the backward turns d_l into
//      g_l in place.  Each block writes its loss partial;
//  (c) wide_dw_kernel: dW_l = sum_u [h_{l-1}; 1][:, u] g_l[:, u]^T as a
//      split-K product over the scratch: a block per (layer, 64 x 64 tile
//      of (fin + 1) x fout, split of the coordinates), 32-coordinate
//      chunks of both operands double-buffered through shared memory,
//      4 x 4 register micro-tiles, its partial row written once;
//  (d) reduce_wide_kernel: the splits' rows and the loss partials summed
//      in a fixed order.  No float atomics, so runs are bitwise equal.
// Why this way: in the old wide layout every multiply-add of the forward
// and the input gradient loaded its W entry from L2, dW took two shared
// reads per multiply-add plus a read-modify-write of the block's whole
// partial row per tile, and all h_l, d_l of a tile had to fit in shared
// memory (so 5-layer chains stopped at 217 features).  Here a W slab in
// shared memory serves a whole tile (64 multiply-adds per float copied),
// the products run on register micro-tiles, and shared memory holds two
// layer rows of the tile and two slabs: any width whose round32(f + 1)
// rows fit at kT = 8 (3,327 features) trains.
// What bounds it: operations (3-191x4-1, N = 100,000: 66 GFLOP, 0.99 ms
// at 67 TFLOP/s) and the scratch traffic (~1.2 GB there: h and d written,
// d read and g written, h and g read by dW; 0.36 ms at 3.35 TB/s).
// ---------------------------------------------------------------------------
namespace wl = brief::wide;

constexpr int kWideHead = 10;
constexpr int kWidePerLayer = 11;
constexpr int kDwThreads = 256;
constexpr int kDwChunk = 32;     // coordinates per dW operand chunk
constexpr int kDwStride = kDwChunk + 4;

struct WideDesc {
  int n_layers, c_in, c_out, n_params, mask_width, rows_max, np, rows_total;
  int wp_total, n_dw_tiles;
  int fin[kMaxLayers], fout[kMaxLayers], act[kMaxLayers];
  int wp_off[kMaxLayers], colpad[kMaxLayers], x_row[kMaxLayers];
  int h_row[kMaxLayers], g_row[kMaxLayers], mask_off[kMaxLayers];
  int p_off[kMaxLayers], tile0[kMaxLayers + 1];
  float w0[kMaxLayers];
};

// The loss of one output entry and its dL/dp times d (datal2 or
// datasmoothl1, weight_thres override: p <= thr weighs 1).
__device__ __forceinline__ float loss_grad(int loss, float beta, bool thr_on,
                                           float thr, float p, float y,
                                           float wv, bool valid, float dd,
                                           float* loss_acc) {
  float weff = (thr_on && p <= thr) ? 1.f : wv;
  weff = valid ? weff : 0.f;
  const float e = p - y;
  float le, g;
  if (loss == 0) {
    le = e * e;
    g = 2.f * weff * e;
  } else {
    const float ae = fabsf(e);
    le = ae < beta ? 0.5f * ae * ae / beta : ae - 0.5f * beta;
    const float sg = (float)((e > 0.f) - (e < 0.f));
    g = weff * (ae < beta ? e / beta : sg);
  }
  *loss_acc += weff * le;
  return g * dd;
}

// (b).  Grid (blocks, B), 4 * kT threads; shared memory: two buffers of
// rows_max rows of kT floats, two slabs, the loss reduction buffer.
template <int kT>
__global__ void __launch_bounds__(4 * kT) wide_train_kernel(
    const float* __restrict__ coords, const float* __restrict__ values,
    const float* __restrict__ weights, const float* __restrict__ wp,
    const float* __restrict__ masks, const float* __restrict__ thres,
    float* __restrict__ scratch, float* __restrict__ lossp, int n,
    WideDesc d, int loss, float beta) {
  constexpr int kNT = 4 * kT, kCQ = kT / 4;
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, cu = t % kCQ, q4 = 4 * (t / kCQ);
  const int fb = blockIdx.y, L = d.n_layers;
  coords += (size_t)fb * d.c_in * n;
  values += (size_t)fb * d.c_out * n;
  weights += (size_t)fb * d.c_out * n;
  wp += (size_t)fb * d.wp_total;
  scratch += (size_t)fb * d.rows_total * d.np;
  const float* mk =
      masks == nullptr ? nullptr : masks + (size_t)fb * d.mask_width;
  const bool thr_on = thres != nullptr;
  const float thr = thr_on ? thres[fb] : 0.f;
  float* buf0 = sm;
  float* buf1 = sm + d.rows_max * kT;
  float* slab = sm + 2 * d.rows_max * kT;
  float* red = slab + 2 * wl::kSlab;
  const size_t np = (size_t)d.np;
  float loss_acc = 0.f;
  float acc[4][4];

  const int n_tiles = d.np / kT;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kT;
    // coordinates (0 past n), a ones row, zeros to the slab boundary; the
    // coordinates also to the scratch (dW of layer 0 reads them there)
    const int c_end = wl::round_up(d.c_in + 1, wl::kKS);
    for (int e = t; e < c_end * kT; e += kNT) {
      const int r = e / kT, u = e - r * kT, idx = base + u;
      float v = r == d.c_in ? 1.f : 0.f;
      if (r < d.c_in) {
        v = idx < n ? coords[(size_t)r * n + idx] : 0.f;
        scratch[(size_t)r * np + idx] = v;
      }
      buf0[e] = v;
    }
    __syncthreads();

    // ---- forward: h_l and d_l of the tile to the scratch ----
    float* X = buf0;
    float* Y = buf1;
    for (int l = 0; l < L; ++l) {
      const int fout = d.fout[l];
      const float* Wl = wp + d.wp_off[l];
      const float* ml =
          mk == nullptr || d.mask_off[l] < 0 ? nullptr : mk + d.mask_off[l];
      float* H = d.h_row[l] < 0 ? nullptr : scratch + d.h_row[l] * np + base;
      float* D = scratch + d.g_row[l] * np + base;
      for (int o0 = 0; o0 < fout; o0 += wl::kOB) {
        wl::forward_block<kT>(Wl, d.colpad[l], o0,
                              wl::round_up(d.fin[l] + 1, wl::kKS), X, slab,
                              acc);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int o = o0 + q4 + a;
          if (o >= fout) continue;
          const float m = ml == nullptr ? 1.f : __ldg(ml + o);
          float h[4], dv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            brief::act_fwd(d.act[l], d.w0[l], acc[a][c], &h[c], &dv[c]);
            h[c] *= m;
            dv[c] *= m;
          }
          const float4 h4 = make_float4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<float4*>(Y + o * kT + 4 * cu) = h4;
          if (H != nullptr)
            *reinterpret_cast<float4*>(H + o * np + 4 * cu) = h4;
          *reinterpret_cast<float4*>(D + o * np + 4 * cu) =
              make_float4(dv[0], dv[1], dv[2], dv[3]);
        }
      }
      wl::fill_rows<kT>(Y, fout, wl::round_up(fout + 1, wl::kKS), true);
      __syncthreads();
      float* sw = X;
      X = Y;
      Y = sw;
    }

    // ---- loss; g of the last layer over its d (padding weighs 0) ----
    {
      float* D = scratch + d.g_row[L - 1] * np + base;
      for (int e = t; e < d.c_out * kT; e += kNT) {
        const int c = e / kT, u = e - c * kT, idx = base + u;
        const bool valid = idx < n;
        float y = 0.f, wv = 0.f;
        if (valid) {
          y = values[(size_t)c * n + idx];
          wv = weights[(size_t)c * n + idx];
        }
        const float g = loss_grad(loss, beta, thr_on, thr, X[e], y, wv,
                                  valid, D[c * np + u], &loss_acc);
        X[e] = g;
        D[c * np + u] = g;
      }
      wl::fill_rows<kT>(X, d.c_out, wl::round_up(d.c_out, wl::kKS), false);
      __syncthreads();
    }

    // ---- input gradients, last layer first: g_{l-1} over d_{l-1} ----
    for (int l = L - 1; l > 0; --l) {
      const int fin = d.fin[l];
      float* D = scratch + d.g_row[l - 1] * np + base;
      for (int i0 = 0; i0 < fin; i0 += wl::kOB) {
        wl::input_grad_block<kT>(wp + d.wp_off[l], d.colpad[l], i0,
                                 wl::round_up(d.fout[l], wl::kKS), X, slab,
                                 acc);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + q4 + a;
          if (i >= fin) continue;
          float4* dp = reinterpret_cast<float4*>(D + i * np + 4 * cu);
          const float4 dv = *dp;
          const float4 g = make_float4(acc[a][0] * dv.x, acc[a][1] * dv.y,
                                       acc[a][2] * dv.z, acc[a][3] * dv.w);
          *reinterpret_cast<float4*>(Y + i * kT + 4 * cu) = g;
          *dp = g;
        }
      }
      wl::fill_rows<kT>(Y, fin, wl::round_up(fin, wl::kKS), false);
      __syncthreads();
      float* sw = X;
      X = Y;
      Y = sw;
    }
  }

  // ---- this block's loss partial ----
  red[t] = loss_acc;
  __syncthreads();
  for (int s = kNT / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  if (t == 0) lossp[(size_t)fb * gridDim.x + blockIdx.x] = red[0];
}

// (c).  Grid (n_dw_tiles, splits, B), kDwThreads threads.  Block (tile,
// split) sums, over coordinates [split * chunk, min(np, (split + 1) *
// chunk)), entries (i0 + to + 16 a, o0 + tu + 16 b) of its layer's
// (fin + 1) x fout gradient (row fin: the bias, against a row of ones);
// thread t: to = t / 16, tu = t % 16.  Rows 16 apart, read at a row stride
// of 36 floats, put a warp's 16 G rows in 8 distinct bank quads.
__global__ void __launch_bounds__(kDwThreads) wide_dw_kernel(
    const float* __restrict__ scratch, float* __restrict__ partial,
    WideDesc d, int chunk) {
  __shared__ __align__(16) float sh[2][wl::kOB * kDwStride];
  __shared__ __align__(16) float sg[2][wl::kOB * kDwStride];
  const int t = threadIdx.x, to = t / 16, tu = t % 16;
  const int fb = blockIdx.z, split = blockIdx.y, tile = blockIdx.x;
  scratch += (size_t)fb * d.rows_total * d.np;
  int l = 0;
  while (tile >= d.tile0[l + 1]) ++l;
  const int fin = d.fin[l], fout = d.fout[l];
  const int n_ob = (fout + wl::kOB - 1) / wl::kOB;
  const int i0 = (tile - d.tile0[l]) / n_ob * wl::kOB;
  const int o0 = (tile - d.tile0[l]) % n_ob * wl::kOB;
  const size_t np = (size_t)d.np;
  const float* H = scratch + d.x_row[l] * np;
  const float* G = scratch + d.g_row[l] * np;
  const int lo = split * chunk, hi = min(d.np, lo + chunk);
  const int n_chunks = (hi - lo) / kDwChunk;

  auto load = [&](int k) {
    const int u0 = lo + k * kDwChunk;
    float* dh = sh[k & 1];
    float* dg = sg[k & 1];
    for (int j = t; j < 2 * wl::kOB * (kDwChunk / 4); j += kDwThreads) {
      const int which = j / (wl::kOB * (kDwChunk / 4));
      const int r = j / (kDwChunk / 4) % wl::kOB, q = j % (kDwChunk / 4);
      if (which == 0) {
        const int i = i0 + r;
        if (i < fin)
          wl::cp16(dh + r * kDwStride + 4 * q, H + i * np + u0 + 4 * q);
        else if (i == fin)
          *reinterpret_cast<float4*>(dh + r * kDwStride + 4 * q) =
              make_float4(1.f, 1.f, 1.f, 1.f);
      } else {
        const int o = o0 + r;
        if (o < fout)
          wl::cp16(dg + r * kDwStride + 4 * q, G + o * np + u0 + 4 * q);
      }
    }
    wl::cp_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  if (n_chunks > 0) load(0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      load(k + 1);
      wl::cp_wait<1>();
    } else {
      wl::cp_wait<0>();
    }
    __syncthreads();
    const float* hh = sh[k & 1] + to * kDwStride;
    const float* gg = sg[k & 1] + tu * kDwStride;
    // the chunk's 32 terms summed apart, then added: a run of thousands
    // of terms in one register loses ~1e-4 of a sum of like signs
    float cs[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) cs[a][b] = 0.f;
#pragma unroll 2
    for (int u = 0; u < kDwChunk; u += 4) {
      float4 h[4], g[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        h[a] = *reinterpret_cast<const float4*>(hh + 16 * a * kDwStride + u);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        g[b] = *reinterpret_cast<const float4*>(gg + 16 * b * kDwStride + u);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float s = cs[a][b];
          s = fmaf(h[a].x, g[b].x, s);
          s = fmaf(h[a].y, g[b].y, s);
          s = fmaf(h[a].z, g[b].z, s);
          s = fmaf(h[a].w, g[b].w, s);
          cs[a][b] = s;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += cs[a][b];
    __syncthreads();
  }
  float* out = partial + ((size_t)fb * gridDim.y + split) * d.n_params +
               d.p_off[l];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + to + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int o = o0 + tu + 16 * b;
      if (i <= fin && o < fout) out[i * fout + o] = acc[a][b];
    }
  }
}

// (d).  out[fb][p] = sum over splits, in order, of partial[fb][s][p] / m
// for p < n_params; out[fb][n_params] = the blocks' loss partials, in
// order, / m.  fb = blockIdx.y.
__global__ void reduce_wide_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ lossp,
                                   float* __restrict__ out, int n_split,
                                   int n_grid, int n_params, float m) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int fb = blockIdx.y;
  if (p > n_params) return;
  float s = 0.f;
  if (p < n_params) {
    partial += (size_t)fb * n_split * n_params + p;
    for (int k = 0; k < n_split; ++k) s += partial[(size_t)k * n_params];
  } else {
    lossp += (size_t)fb * n_grid;
    for (int k = 0; k < n_grid; ++k) s += lossp[k];
  }
  out[(size_t)fb * (n_params + 1) + p] = s / m;
}

template <int kT>
cudaError_t wide_occupancy(int smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      wide_train_kernel<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, wide_train_kernel<kT>, 4 * kT, smem_bytes);
}

template <int kT>
cudaError_t launch_wide(dim3 grid, int smem_bytes, cudaStream_t s,
                        const float* coords, const float* values,
                        const float* weights, const float* wp,
                        const float* masks, const float* thres,
                        float* scratch, float* lossp, int n,
                        const WideDesc& d, int loss, float beta) {
  cudaError_t err = cudaFuncSetAttribute(
      wide_train_kernel<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  wide_train_kernel<kT><<<grid, 4 * kT, smem_bytes, s>>>(
      coords, values, weights, wp, masks, thres, scratch, lossp, n, d, loss,
      beta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The narrow layout's blocks of `block` threads using `smem_bytes` of
// dynamic shared memory that fit on one SM at once, and the device's SM
// count.
int brief_fused_train_occupancy(int block, int smem_bytes,
                                int* blocks_per_sm, int* sm_count) {
  cudaError_t err = occupancy(block, smem_bytes, blocks_per_sm);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// The narrow layout.  meta: n_layers, c_in, c_out, n_params, stride,
// acc_off, red_off, act_off, mask_width (`block` threads, one per
// coordinate of a tile), then per layer: fin, fout, act, p_off, sw_off, swt_off, sb_off, h_row,
// dg_row, mask_off (-1: unmasked).
// coords (B, c_in, n), values / weights (B, c_out, n), params
// (B, n_params), masks (B, mask_width) or null, thres (B,) or null (no
// override); partial: (B, grid, n_params + 1) scratch; out:
// (B, n_params + 1), the gradients in the packed parameter layout followed
// by the loss.  One unmasked chain (B = 1, no masks) runs the kernel
// without the fleet's parts.
int brief_fused_train(const float* coords, const float* values,
                      const float* weights, const float* params,
                      const float* masks, const float* thres, float* partial,
                      float* out, int n, int n_fleet, const int* meta,
                      const float* w0s, int loss, float beta, int grid,
                      int block, int smem_bytes, void* stream) {
  TrainDesc d;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || d.n_layers > kMaxLayers || n_fleet < 1 ||
      n_fleet > 65535)
    return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.n_params = meta[3];
  d.stride = meta[4];
  d.acc_off = meta[5];
  d.red_off = meta[6];
  d.act_off = meta[7];
  d.mask_width = meta[8];
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
    d.mask_off[l] = masks == nullptr ? -1 : m[9];
    d.w0[l] = w0s[l];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid2(grid, n_fleet);
  const bool fleet = n_fleet > 1 || masks != nullptr;
  decltype(&launch<true>) fn = fleet ? &launch<true> : &launch<false>;
  cudaError_t err = fn(grid2, block, smem_bytes, s, coords, values, weights,
                       params, partial, n, d, loss, beta, thres, masks);
  if (err != cudaSuccess) return (int)err;
  const int width = d.n_params + 1;
  const dim3 rgrid((width + 255) / 256, n_fleet);
  const float m = (float)((double)n * d.c_out);
  if (fleet) {
    reduce_partials_kernel<true><<<rgrid, 256, 0, s>>>(partial, out, grid,
                                                       width, m);
  } else {
    reduce_partials_kernel<false><<<rgrid, 256, 0, s>>>(partial, out, grid,
                                                        width, m);
  }
  return (int)cudaGetLastError();
}

// The tiled layout's blocks per SM (kTiledThreads threads, `smem_bytes`)
// for `slots` dW tiles per thread, and the device's SM count.
int brief_fused_train_tiled_occupancy(int slots, int smem_bytes,
                                      int* blocks_per_sm, int* sm_count) {
  cudaError_t err;
  switch (slots) {
    case 4: err = tiled_occupancy<4>(smem_bytes, blocks_per_sm); break;
    case 6: err = tiled_occupancy<6>(smem_bytes, blocks_per_sm); break;
    case 8: err = tiled_occupancy<8>(smem_bytes, blocks_per_sm); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// The tiled layout.  meta: n_layers, c_in, c_out, n_params, red_off,
// act_off, mask_width, slots, then per layer: fin, fout, act, p_off, w_off,
// x_row, h_row, g_row, mask_off (-1: unmasked).  slot_map: (slots,
// kTiledThreads) int32.  The other arguments as for brief_fused_train; the
// kernel always runs in its fleet form (B = 1 for one chain).
int brief_fused_train_tiled(const float* coords, const float* values,
                            const float* weights, const float* params,
                            const float* masks, const float* thres,
                            const int* slot_map, float* partial, float* out,
                            int n, int n_fleet, const int* meta,
                            const float* w0s, int loss, float beta, int grid,
                            int smem_bytes, void* stream) {
  TiledDesc d;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || d.n_layers > kMaxLayers || n_fleet < 1 ||
      n_fleet > 65535)
    return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.n_params = meta[3];
  d.red_off = meta[4];
  d.act_off = meta[5];
  d.mask_width = meta[6];
  const int slots = meta[7];
  for (int l = 0; l < d.n_layers; ++l) {
    const int* m = meta + kTiledHead + kTiledPerLayer * l;
    d.fin[l] = m[0];
    d.fout[l] = m[1];
    d.act[l] = m[2];
    d.p_off[l] = m[3];
    d.w_off[l] = m[4];
    d.x_row[l] = m[5];
    d.h_row[l] = m[6];
    d.g_row[l] = m[7];
    d.mask_off[l] = masks == nullptr ? -1 : m[8];
    d.w0[l] = w0s[l];
  }
  decltype(&launch_tiled<4>) fn;
  switch (slots) {
    case 4: fn = &launch_tiled<4>; break;
    case 6: fn = &launch_tiled<6>; break;
    case 8: fn = &launch_tiled<8>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = fn(dim3(grid, n_fleet), smem_bytes, s, coords, values,
                       weights, params, slot_map, partial, n, d, loss, beta,
                       thres, masks);
  if (err != cudaSuccess) return (int)err;
  const int width = d.n_params + 1;
  reduce_partials_kernel<true><<<dim3((width + 255) / 256, n_fleet), 256, 0,
                                 s>>>(partial, out, grid, width,
                                      (float)((double)n * d.c_out));
  return (int)cudaGetLastError();
}


// The wide layout's blocks per SM (4 * tile threads, `smem_bytes`) and the
// device's SM count.
int brief_fused_train_wide_occupancy(int tile, int smem_bytes,
                                     int* blocks_per_sm, int* sm_count) {
  cudaError_t err;
  switch (tile) {
    case 64: err = wide_occupancy<64>(smem_bytes, blocks_per_sm); break;
    case 32: err = wide_occupancy<32>(smem_bytes, blocks_per_sm); break;
    case 16: err = wide_occupancy<16>(smem_bytes, blocks_per_sm); break;
    case 8: err = wide_occupancy<8>(smem_bytes, blocks_per_sm); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// The wide layout (ops/fused_train.py wide_plan).  meta: n_layers, c_in,
// c_out, n_params, mask_width, rows_max, np, rows_total, wp_total,
// n_dw_tiles, then per layer: fin, fout, act, p_off, wp_off, colpad, x_row,
// h_row, g_row, mask_off (-1: unmasked), tile0.  Scratch the caller
// allocates: wp (B, wp_total) for the packed weights, scratch (B,
// rows_total, np) for h_l and d_l / g_l, partial (B, n_split, n_params),
// lossp (B, grid).  `tile` coordinates per tile (64, 32, 16 or 8), `grid`
// blocks per fleet block, coordinates split into n_split chunks of `chunk`
// (a multiple of 32) for dW.  The other arguments as for brief_fused_train.
int brief_fused_train_wide(const float* coords, const float* values,
                           const float* weights, const float* params,
                           const float* masks, const float* thres, float* wp,
                           float* scratch, float* partial, float* lossp,
                           float* out, int n, int n_fleet, const int* meta,
                           const float* w0s, int loss, float beta, int grid,
                           int tile, int smem_bytes, int n_split, int chunk,
                           void* stream) {
  WideDesc d;
  brief::wide::Packed pk;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || d.n_layers > kMaxLayers || n_fleet < 1 ||
      n_fleet > 65535 || n_split < 1 || n_split > 65535 || chunk % kDwChunk)
    return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.n_params = meta[3];
  d.mask_width = meta[4];
  d.rows_max = meta[5];
  d.np = meta[6];
  d.rows_total = meta[7];
  d.wp_total = meta[8];
  d.n_dw_tiles = meta[9];
  pk.n_layers = d.n_layers;
  pk.n_params = d.n_params;
  pk.wp_total = d.wp_total;
  for (int l = 0; l < d.n_layers; ++l) {
    const int* m = meta + kWideHead + kWidePerLayer * l;
    d.fin[l] = pk.fin[l] = m[0];
    d.fout[l] = pk.fout[l] = m[1];
    d.act[l] = m[2];
    d.p_off[l] = pk.p_off[l] = m[3];
    d.wp_off[l] = pk.wp_off[l] = m[4];
    d.colpad[l] = pk.colpad[l] = m[5];
    d.x_row[l] = m[6];
    d.h_row[l] = m[7];
    d.g_row[l] = m[8];
    d.mask_off[l] = masks == nullptr ? -1 : m[9];
    d.tile0[l] = m[10];
    d.w0[l] = w0s[l];
  }
  d.tile0[d.n_layers] = d.n_dw_tiles;
  pk.wp_off[d.n_layers] = d.wp_total;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = brief::wide::pack_weights(params, wp, pk, n_fleet, s);
  if (err != cudaSuccess) return (int)err;
  decltype(&launch_wide<64>) fn;
  switch (tile) {
    case 64: fn = &launch_wide<64>; break;
    case 32: fn = &launch_wide<32>; break;
    case 16: fn = &launch_wide<16>; break;
    case 8: fn = &launch_wide<8>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  err = fn(dim3(grid, n_fleet), smem_bytes, s, coords, values, weights, wp,
           masks, thres, scratch, lossp, n, d, loss, beta);
  if (err != cudaSuccess) return (int)err;
  wide_dw_kernel<<<dim3(d.n_dw_tiles, n_split, n_fleet), kDwThreads, 0, s>>>(
      scratch, partial, d, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_wide_kernel<<<dim3((d.n_params + 256) / 256, n_fleet), 256, 0, s>>>(
      partial, lossp, out, n_split, grid, d.n_params,
      (float)((double)n * d.c_out));
  return (int)cudaGetLastError();
}

}  // extern "C"
