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
//  * narrow (kSmemW, e.g. 5 x 22, 3-7x4-1): W, W^T, the biases and the
//    block's gradient accumulator in shared memory beside the activation
//    tile, one thread per coordinate (5 x 22: 11% of the float32 bound).
//  * tiled (fused_train_tiled_kernel, e.g. 3-64x6-1, 3-66x6-1, 5 x 95):
//    the weights once in shared memory, dW in registers; described below
//    the two older layouts' code.  Paced by shared-memory reads and the
//    sine evaluations (3-64x6-1 fleet: 23% of the bound).
//  * wide (!kSmemW, e.g. 3-186x4-1): only the activation tile in shared
//    memory; paced by one read of W from L2 per multiply-add (7.5%).
//
// Design of the narrow and wide layouts (fused_train_kernel):
//  * A block owns a tile of T coordinates (T = blockDim.x, one per
//    thread) and walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... of
//    its fleet block (a persistent grid of a few blocks per SM), so the
//    TPU grid's in-order accumulation becomes a loop inside the block.
//  * h_l and d_l of the tile stay in shared memory, one column per
//    thread (rows padded to T + 1 floats so that the weight-gradient
//    phase, where a warp reads one column index across many rows, hits
//    distinct banks).  Nothing per coordinate goes to device memory.
//  * Two layouts of the rest (kSmemW):
//    - narrow chains: W padded for the forward, W^T padded for the
//      backward, the biases and the block's gradient accumulator all live
//      in shared memory;
//    - wide chains (whose weights do not fit in shared memory even once,
//      e.g. 3-186x4-1): W is read from device
//      memory through the read-only path in the same order of
//      multiply-adds (so the two layouts give the same bits), and the
//      block accumulates straight into its own row of partial sums in
//      device memory, a group of entries per thread in flight at once.
//      The tile is small (T = 64 or 32), so Q = 512 / T threads share a
//      coordinate: each computes every Q-th chunk of 8 features of a
//      layer, with a barrier between layers.
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

namespace {

using brief::kChunk;
using brief::kMaxLayers;
using brief::round_up8;

// The fleet's and the wide layout's fields come last: placed before w0
// they make the compiler schedule the one-chain kernel's loops measurably
// slower.
struct TrainDesc {
  int n_layers, c_in, c_out, n_params, stride;
  int acc_off, red_off, act_off;
  int fin[kMaxLayers], fout[kMaxLayers], act[kMaxLayers];
  int p_off[kMaxLayers], sw_off[kMaxLayers], swt_off[kMaxLayers];
  int sb_off[kMaxLayers], h_row[kMaxLayers], dg_row[kMaxLayers];
  float w0[kMaxLayers];
  int mask_width, tile;
  int mask_off[kMaxLayers];
};

constexpr int kMetaHead = 11;
constexpr int kMetaPerLayer = 10;
constexpr int kGroup = 8;   // accumulator entries in flight per thread

// layer_forward<true> of chain.cuh with W (fin, fout) row-major and the
// bias after it, read from device memory, for the output chunks o0 =
// o_begin, o_begin + o_step, ...: the same multiply-adds in the same order.
__device__ __forceinline__ void layer_forward_global(
    const float* __restrict__ W, float* A, int stride, int col, int in_row,
    int fin, int fout, int act, float w0, int h_row, int d_row,
    const float* __restrict__ mask, int o_begin, int o_step) {
  const float* bias = W + fin * fout;
  for (int o0 = o_begin; o0 < fout; o0 += o_step) {
    float z[kChunk];
    int oc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      z[k] = 0.f;
      oc[k] = min(o0 + k, fout - 1);
    }
    for (int i = 0; i < fin; ++i) {
      const float x = A[(in_row + i) * stride + col];
      const float* wr = W + i * fout;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) z[k] = fmaf(__ldg(wr + oc[k]), x, z[k]);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int o = o0 + k;
      if (o < fout) {
        float h, d;
        brief::act_fwd(act, w0, z[k] + __ldg(bias + o), &h, &d);
        if (mask != nullptr) {
          const float m = __ldg(mask + o);
          h *= m;
          d *= m;
        }
        A[(h_row + o) * stride + col] = h;
        A[(d_row + o) * stride + col] = d;
      }
    }
  }
}

// Wide layout: entry e of a layer's packed (W, b) gradient summed over the
// tile's T coordinates: sum_u g[o][u] * h[i][u] for e = i * fout + o < nw, else the
// bias sum_u g[e - nw][u].
__device__ __forceinline__ float tile_grad(const float* G, const float* H,
                                           int S, int T, int nw, int fout,
                                           int e) {
  float s = 0.f;
  if (e < nw) {
    const int i = e / fout, o = e - i * fout;
    const float* g = G + o * S;
    const float* h = H + i * S;
    for (int u = 0; u < T; ++u) s = fmaf(g[u], h[u], s);
  } else {
    const float* g = G + (e - nw) * S;
    for (int u = 0; u < T; ++u) s += g[u];
  }
  return s;
}

// This block's row of partial sums (gradients, then the loss) in the
// (B, gridDim.x, n_params + 1) scratch.
__device__ __forceinline__ float* partial_row(float* partial, int fb,
                                              int n_params) {
  return partial +
         ((size_t)fb * gridDim.x + blockIdx.x) * (size_t)(n_params + 1);
}

// kFleet: the fleet form (blockIdx.y selects the chain, masks per chain);
// without it one chain and none of the fleet's address arithmetic (it
// slows the one-chain path).  thres: one threshold per chain, read when
// has_thres (-inf never fires).  In the shared-memory layout it waits in
// the first slot of the loss reduction buffer, idle until the end, since a
// register held across the kernel slows the one-chain loops; the wide
// layout is faster with the register.
template <bool kSmemW, bool kFleet>
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
  // NT threads, T coordinates per tile, Q = NT / T threads per coordinate
  // (1 in the narrow layout); thread t works on coordinate u of the tile
  // and on the q-th share of each layer's features
  const int NT = blockDim.x, t = threadIdx.x, S = d.stride, L = d.n_layers;
  const int T = kSmemW ? NT : d.tile, Q = kSmemW ? 1 : NT / T;
  const int u = kSmemW ? t : t % T, q = kSmemW ? 0 : t / T;
  const int fb = kFleet ? blockIdx.y : 0;          // fleet block
  const float* mk = nullptr;
  if (kFleet) {
    coords += (size_t)fb * d.c_in * n;
    values += (size_t)fb * d.c_out * n;
    weights += (size_t)fb * d.c_out * n;
    params += (size_t)fb * d.n_params;
    if (masks != nullptr) mk = masks + (size_t)fb * d.mask_width;
  }
  float thr = 0.f;
  if (!kSmemW && has_thres) thr = thres[fb];
  // the wide layout accumulates straight into its row of partial sums
  float* acc = kSmemW ? sm + d.acc_off : partial_row(partial, fb, d.n_params);
  float* A = sm + d.act_off;

  if (kSmemW) {
    for (int l = 0; l < L; ++l) {
      brief::load_weights(params + d.p_off[l], d.fin[l], d.fout[l],
                          sm + d.sw_off[l], sm + d.swt_off[l],
                          sm + d.sb_off[l]);
    }
  }
  for (int e = t; e < d.n_params; e += NT) acc[e] = 0.f;
  if (kSmemW && t == 0 && has_thres) sm[d.red_off] = thres[fb];
  float loss_acc = 0.f;
  __syncthreads();

  const int n_tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int idx = tile * T + u;
    const bool valid = idx < n;

    // ---- forward: own column; h_l and d_l into shared memory ----
    for (int c = q; c < d.c_in; c += Q) {
      A[c * S + u] = valid ? coords[(size_t)c * n + idx] : 0.f;
    }
    for (int l = 0; l < L; ++l) {
      // the Q threads of a column share it: the layer's input must be whole
      if (!kSmemW) __syncthreads();
      const int in_row = l == 0 ? 0 : d.h_row[l - 1];
      const float* ml =
          mk == nullptr || d.mask_off[l] < 0 ? nullptr : mk + d.mask_off[l];
      if (kSmemW) {
        brief::layer_forward<true>(sm + d.sw_off[l], sm + d.sb_off[l], A, S,
                                   t, in_row, d.fin[l], d.fout[l], d.act[l],
                                   d.w0[l], d.h_row[l], d.dg_row[l], ml);
      } else {
        layer_forward_global(params + d.p_off[l], A, S, u, in_row, d.fin[l],
                             d.fout[l], d.act[l], d.w0[l], d.h_row[l],
                             d.dg_row[l], ml, q * kChunk, Q * kChunk);
      }
    }
    if (!kSmemW) __syncthreads();

    // ---- loss and dL/dz of the last layer (padding lanes weigh 0) ----
    const int last = L - 1;
    for (int c = q; c < d.c_out; c += Q) {
      const float p = A[(d.h_row[last] + c) * S + u];
      float y = 0.f, wv = 0.f;
      if (valid) {
        y = values[(size_t)c * n + idx];
        wv = weights[(size_t)c * n + idx];
      }
      float weff =
          (has_thres && p <= (kSmemW ? sm[d.red_off] : thr)) ? 1.f : wv;
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
      float* dg = &A[(d.dg_row[last] + c) * S + u];
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
      // weight and bias gradients: reads every column of g_l and h_{l-1}
      if (kSmemW) {
        // tile_grad written out: so the one-chain kernel schedules faster
        for (int e = t; e < nw + fout; e += NT) {
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
      } else {
        // the accumulator is in device memory: kGroup of the thread's
        // entries at a time, so their loads are in flight together
        for (int e0 = t; e0 < nw + fout; e0 += kGroup * NT) {
          float a[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const int e = e0 + j * NT;
            a[j] = e < nw + fout ? accl[e] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const int e = e0 + j * NT;
            if (e < nw + fout)
              accl[e] = a[j] + tile_grad(G, H, S, T, nw, fout, e);
          }
        }
      }
      // input gradient into d_{l-1}, own column only
      if (l > 0) {
        float* D = A + d.dg_row[l - 1] * S;
        const float* swt = sm + d.swt_off[l];
        const float* W = params + d.p_off[l];
        const int fip = round_up8(fin);
        for (int i0 = q * kChunk; i0 < fin; i0 += Q * kChunk) {
          float z[kChunk];
#pragma unroll
          for (int k = 0; k < kChunk; ++k) z[k] = 0.f;
          if (kSmemW) {
            for (int o = 0; o < fout; ++o) {
              const float x = G[o * S + u];
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
          } else {
            int ic[kChunk];
#pragma unroll
            for (int k = 0; k < kChunk; ++k) ic[k] = min(i0 + k, fin - 1) * fout;
            for (int o = 0; o < fout; ++o) {
              const float x = G[o * S + u];
#pragma unroll
              for (int k = 0; k < kChunk; ++k)
                z[k] = fmaf(__ldg(W + ic[k] + o), x, z[k]);
            }
          }
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            const int i = i0 + k;
            if (i < fin) D[i * S + u] = z[k] * D[i * S + u];
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- this block's partial sums: gradients, then the loss ----
  float* out = partial_row(partial, fb, d.n_params);
  if (kSmemW) {
    for (int e = t; e < d.n_params; e += NT) out[e] = acc[e];
  }
  float* red = sm + d.red_off;
  __syncthreads();   // every thread is done with the threshold in red[0]
  red[t] = loss_acc;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
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
// The tiled layout: a kernel of its own (the two layouts above keep their
// code), for chains whose weights, stored once, fit in shared memory beside
// a 32-coordinate activation tile, and whose dW fits the threads' registers.
//
// Why: in the wide layout every multiply-add of the forward and the input
// gradient loads its W entry from L2, and the dW loop takes two shared
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

template <bool kSmemW>
cudaError_t occupancy(int block, int smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_train_kernel<kSmemW, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_train_kernel<kSmemW, false>, block, smem_bytes);
}

template <bool kSmemW, bool kFleet>
cudaError_t launch(dim3 grid, int block, int smem_bytes, cudaStream_t s,
                   const float* coords, const float* values,
                   const float* weights, const float* params, float* partial,
                   int n, const TrainDesc& d, int loss, float beta,
                   const float* thres, const float* masks) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_train_kernel<kSmemW, kFleet>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  fused_train_kernel<kSmemW, kFleet><<<grid, block, smem_bytes, s>>>(
      coords, values, weights, params, partial, n, d, loss, beta,
      thres != nullptr, thres, masks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of `block` threads using `smem_bytes` of dynamic shared memory
// that fit on one SM at once for the layout `smem_weights`, and the
// device's SM count.
int brief_fused_train_occupancy(int smem_weights, int block, int smem_bytes,
                                int* blocks_per_sm, int* sm_count) {
  cudaError_t err = smem_weights
                        ? occupancy<true>(block, smem_bytes, blocks_per_sm)
                        : occupancy<false>(block, smem_bytes, blocks_per_sm);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// meta: n_layers, c_in, c_out, n_params, stride, acc_off, red_off, act_off,
// smem_weights, mask_width, tile (coordinates per tile; `block` threads),
// then per layer: fin, fout, act, p_off, sw_off, swt_off, sb_off, h_row,
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
  const bool smem_weights = meta[8] != 0;
  d.mask_width = meta[9];
  d.tile = meta[10];
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
  decltype(&launch<true, true>) fn =
      smem_weights ? (fleet ? &launch<true, true> : &launch<true, false>)
                   : (fleet ? &launch<false, true> : &launch<false, false>);
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

}  // extern "C"
