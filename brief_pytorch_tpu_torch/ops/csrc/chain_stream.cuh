// Kernels 2 and 3's streamed form, for Hopper: the forward of a plain
// activation chain with a layer (or an input) wider than 256 features
// (3-383x4-1, 3-1024x4-1, 3-20971-1, [3, 4096, 4096, 1], ...), over the
// voxels of a grid (kernel 2, csrc/fused_decode.cu GridInput) or the rows
// of an (N, C) array (kernel 3, csrc/fused_siren.cu RowInput).  The port of
// brief_pytorch_tpu/ops/pallas_decode.py (_decode_grid_padded) and
// pallas_siren.py (_fused_forward) for those chains; ops/chain_stream.py is
// the Python side (the plan, the table, the CPU model `stream_model`).
// 256 features is the widest layer the wide form of csrc/chain_tc.cuh
// holds in shared memory.
//
// What bounds it on an H100: operations.  A chain with one hidden layer
// (3-F-1) does N F sines (16 flops each at 67 TFLOP/s: 3-20971-1 on 64^3
// in 1.31 ms) and nothing the tensor cores could take; a square layer
// (both sides wider than 8) does 2 N fin fout flops of products, 3 x that
// in 3xTF32 at 495 TFLOP/s ([3, 4096, 4096, 1] at N = 65,536: 13.3 ms;
// 3-383x4-1 on 64x512x512: 89.8 ms).  The wide form's scratch instance,
// which took these chains before and is gone, made a round trip of every
// layer's activations through a device scratch per block, read the A
// operand from device memory in every warp, took the outputs in passes of
// 32 n-tiles and padded a thin last layer to an 8-wide n-tile.
//
// Design, a chain of L layers (h_0 the row's coordinates, In::coord):
//  * thin in: layer 0 when L >= 2 and c_in + 1 <= 8.  h_1 is computed from
//    the coordinates where it is read: the bias, then one fmaf a
//    coordinate (z_from_x), then the activation; never a product;
//  * thin out: the last layer when L >= 2 and c_out <= 8: a reduction over
//    its input features, never an n-tile padded to 8;
//  * 3-F-1 (both ends thin, no other layer): chain_stream_thin_kernel, a
//    thread 4 rows, the features in blocks of 256 (their weights staged in
//    shared memory), each block's sums from zero by fmaf and added in order
//    to the thread's sums over its split of the features; the splits' sums
//    (as many as fill the card) added in order, after the bias, by
//    chain_stream_end_kernel.  No scratch but those partial sums;
//  * square layers (the others): C = H^T W on tiles of 128 rows and 128
//    columns (or 64, where a layer's outputs pad to fewer columns: 257-320
//    features take 320, not 384) of 8 warps,
//    mma.sync.m16n8k8 TF32 in 3xTF32 (operands split as they are read from
//    shared memory, the small parts rounded: csrc/tf32.cuh
//    split_tf32_nearest), k-slabs of 32 of both operands through a ring of
//    3 cp.async stages that every warp of the block reads (no warp loads a
//    fragment from device memory); each k-block's three products summed
//    from zero and added in float32, the k-blocks in groups of 32 from zero
//    (never a long sum in one accumulator): `mainloop`, kernel 1's
//    product loop.  W is copied once a call,
//    zero-padded to whole tiles (chain_stream_pack_kernel).  The rows go in
//    chunks of R (ops/chain_stream.py: the layer inputs H at most 256 MB):
//    chain_stream_prep_kernel writes the first square layer's input (h_1
//    from the coordinates for a thin layer 0, else the coordinates), each
//    square layer's epilogue the next square layer's input (the other H
//    buffer), the output, or, before a thin last layer, its sums over the
//    tile's 128 or 64 features (a thread's 8 or 4 by fmaf from zero, then
//    its 4 lanes, then the 4 warps, in that order), which
//    chain_stream_end_kernel adds in order after the bias.
// No float atomics, every sum in a fixed order: a row's value does not
// depend on the block that computes it, and two calls are bitwise equal.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_tc.cuh"

namespace brief {
namespace chain_stream {

constexpr int kWM = 2, kWN = 4;  // warps of a product block along m and n
constexpr int kMT = 4, kNT = 4;  // a warp's mma tiles (16 x 8) along m, n
constexpr int kGThreads = 32 * kWM * kWN;
constexpr int kGM = kWM * 16 * kMT, kGN = kWN * 8 * kNT;   // 128 x 128
constexpr int kGN64 = kGN / 2;   // the narrow tile's columns: kNT / 2
constexpr int kGK = 32;                         // slab depth
constexpr int kGStages = 3;                     // slabs in the ring
constexpr int kSK = 128 + 8;     // a k-major slab row, floats (8 mod 32)
constexpr int kTile = kGK * kSK; // floats of one operand's slab
constexpr int kStage = 2 * kTile;
constexpr int kGroupK = 32;      // k-blocks a group of the sums
constexpr int kAcc = 4 * kMT * kNT;   // a thread's accumulators
constexpr int kGemmSmem = 4 * (kGStages * kStage + kAcc * kGThreads);
static_assert(kGM == 128 && kGN == 128 && kGN64 == 64,
              "ops/chain_stream.py GM, GN, GN64");

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

// z_1 of a row from its coordinates x (zero-padded to kX - 1) and layer
// 0's column w: W_0[c][o] for c < kX - 1 (zero-padded), b_0[o] last.  The
// bias first, then one fmaf a coordinate (a padded term adds 0 * 0), as
// kernel 1's streamed form computes it (csrc/fused_train_stream.cu).
template <int kX>
__device__ __forceinline__ float z_from_x(const float* x, const float* w) {
  float z = w[kX - 1];
#pragma unroll
  for (int c = 0; c < kX - 1; ++c) z = fmaf(x[c], w[c], z);
  return z;
}

// The 128 x 8 kWN kNTt tile's sums (kNTt = kNT: 128 columns; kNT / 2:
// 64) over k-slabs [0, 32 KT) of A (k-major: A[k][m] at A + k lda + m,
// rows m0..) and B (k-major: B[k][n], columns n0..), kernel 1's product
// loop (csrc/fused_train_stream.cu stream_gemm_kernel, whose own copy
// keeps its SASS) with both operands k-major: K in slabs of 32 through a
// ring of kGStages cp.async stages that every warp of the block reads,
// shared memory rows of 128 + 8 floats (every fragment read of a warp
// hits 32 banks); warp w takes rows 16 kMT (w / kWN) and columns 8 kNTt
// (w % kWN): kMT x kNTt mma tiles, operands split as they are read, each
// k-block's three 3xTF32 products summed from zero into `s` and added to
// the group's sums in float32; every kGroupK k-blocks the group is added
// to the running total and starts again from zero.  On return the
// group's sums of the thread's fragment (i, j) are in grp[i][j], the
// running totals in shared memory at sm + kGStages kStage (element
// ((i kNTt + j) 4 + e) kGThreads + t), and the ring is free.
template <int kNTt>
__device__ __forceinline__ void mainloop(float (&grp)[kMT][kNTt][4],
                                         float* sm, const float* A,
                                         size_t lda, const float* B,
                                         size_t ldb, int m0, int n0, int KT) {
  constexpr int kC4 = 2 * kWN * kNTt;   // 16-byte copies a slab row of B
  float* tot = sm + kGStages * kStage;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3, wm = warp / kWN, wn = warp % kWN;

  // a stage: kGK rows of 128 floats of A and of 8 kWN kNTt floats of B,
  // 1024 + 32 kC4 16-byte copies
  auto load = [&](int kt, int stage) {
    const int kk = kt * kGK;
    float* st = sm + stage * kStage;
#pragma unroll
    for (int j = 0; j < 1024 / kGThreads; ++j) {
      const int c = t + j * kGThreads, r = c >> 5, c4 = c & 31;
      cp16(st + r * kSK + 4 * c4, A + (size_t)(kk + r) * lda + m0 + 4 * c4);
      if (j < kGK * kC4 / kGThreads) {
        const int rb = c / kC4, cb = c % kC4;
        cp16(st + kTile + rb * kSK + 4 * cb,
             B + (size_t)(kk + rb) * ldb + n0 + 4 * cb);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNTt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) grp[i][j][e] = 0.f;
#pragma unroll 8
  for (int e = 0; e < 4 * kMT * kNTt; ++e) tot[e * kGThreads + t] = 0.f;

#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_commit();
  }
  int kb_all = 0;   // k-blocks summed so far
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<kGStages - 2>();
    __syncthreads();   // slab kt is in; slab kt - 1's stage is free
    if (kt + kGStages - 1 < KT)
      load(kt + kGStages - 1, (kt + kGStages - 1) % kGStages);
    cp_commit();
    const float* as = sm + (kt % kGStages) * kStage;
    const float* bs = as + kTile;
#pragma unroll
    for (int kb = 0; kb < kGK / 8; ++kb, ++kb_all) {
      if (kb_all > 0 && kb_all % kGroupK == 0) {   // a new group
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNTt; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[((i * kNTt + j) * 4 + e) * kGThreads + t] += grp[i][j][e];
              grp[i][j][e] = 0.f;
            }
      }
      const int k = 8 * kb + q;
      uint32_t bb[kNTt][2], bsm[kNTt][2];
#pragma unroll
      for (int j = 0; j < kNTt; ++j) {
        const int n = 8 * kNTt * wn + 8 * j + g;
        split_tf32_nearest(bs[k * kSK + n], &bb[j][0], &bsm[j][0]);
        split_tf32_nearest(bs[(k + 4) * kSK + n], &bb[j][1], &bsm[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int m = 16 * kMT * wm + 16 * i + g;
        uint32_t ab[4], asm_[4];
        split_a(as[k * kSK + m], as[k * kSK + m + 8], as[(k + 4) * kSK + m],
                as[(k + 4) * kSK + m + 8], ab, asm_);
#pragma unroll
        for (int j = 0; j < kNTt; ++j) {
          float s[4];
          mma_tf32_zero(s, asm_, bb[j][0], bb[j][1]);
          mma_tf32(s, ab, bsm[j][0], bsm[j][1]);
          mma_tf32(s, ab, bb[j][0], bb[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) grp[i][j][e] += s[e];
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring's stages are free for the epilogue
}

constexpr int kFB = 256;                 // features a block of the thin sums
constexpr int kRowsT = 4;                // rows a thread of the thin kernel
constexpr int kThinRows = kRowsT * 256;  // rows a block of the thin kernel
constexpr int kXMax = 8;                 // c_in + 1 a thin layer 0 may have
constexpr int kCOMax = 8;                // c_out a thin last layer may have
static_assert(kWN * kCOMax * kGM <= kGStages * kStage, "the epilogue's sums");

// Layer l's row of the table (ops/chain_stream.py stream_table): its W
// (fin, fout) and b as the caller holds them, widths, activation and w0,
// and its zero-padded W copy (square layers; -1: thin): offset in floats
// and row stride (wp_cols, a multiple of gn); round32(fin) rows; gn, the
// columns of its product tiles (kGN or kGN64).
struct __align__(16) StreamLayer {
  const float* w;
  const float* b;
  int fin, fout, act;
  float w0;
  int wp_off, wp_cols, gn, pad1;
};
static_assert(sizeof(StreamLayer) == 48, "ops/chain_stream.py ROW_WORDS");

// The call and its current chunk of rows [base, base + R): the table, the
// two layer-input buffers H (rows of R floats), the partial sums (per
// split or feature tile, c_out rows of R floats), the padded W copies,
// the output (n, c_out); S splits of the thin sums' n_fb feature blocks.
struct StreamDesc {
  long long n, base;
  int n_layers, c_in, c_out, R, S, n_fb;
  const StreamLayer* layer;
  float* h0;
  float* h1;
  float* part;
  float* wp;
  float* out;
};

__device__ __forceinline__ float act1(int act, float w0, float z) {
  activate<1>(&z, act, w0);
  return z;
}

// Layer 0's column o as z_from_x<kX> reads it
template <int kX>
__device__ __forceinline__ float w0_entry(const StreamLayer& l0, int c_in,
                                          int o, int c) {
  if (o >= l0.fout) return 0.f;
  if (c == kX - 1) return __ldg(l0.b + o);
  return c < c_in ? __ldg(l0.w + (size_t)c * l0.fout + o) : 0.f;
}

// W of the square layers zero-padded to (round32(fin), wp_cols), so that
// every 16-byte copy of a slab is aligned and none reads past it.  Grid
// (blocks, n_layers).
__global__ void chain_stream_pack_kernel(StreamDesc d) {
  const StreamLayer ly = ld_row(d.layer + blockIdx.y);
  if (ly.wp_off < 0) return;
  float* dst = d.wp + ly.wp_off;
  const long long size = (long long)round_up(ly.fin, kGK) * ly.wp_cols;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < size; e += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(e / ly.wp_cols);
    const int c = (int)(e - (long long)r * ly.wp_cols);
    dst[e] = r < ly.fin && c < ly.fout ? __ldg(ly.w + (size_t)r * ly.fout + c)
                                       : 0.f;
  }
}

// H0 = the first square layer's input for the chunk's 128-row tile
// blockIdx.x, rows blockIdx.y * 256 + (t >> 7) + 2 k < round32(fin): h_1
// from the coordinates (t0), or the coordinates themselves; zeros past
// fin.  Rows past n repeat row n - 1.  256 threads, a thread one row.
template <class In>
__global__ void __launch_bounds__(256) chain_stream_prep_kernel(
    const In in, StreamDesc d, int t0) {
  __shared__ float s_w[256 * kXMax];
  const int t = threadIdx.x, uu = t & 127, i0 = blockIdx.y * 256;
  const long long v0 = d.base + (long long)blockIdx.x * kGM + uu;
  const long long v = v0 < d.n ? v0 : d.n - 1;
  float* H = d.h0 + (size_t)blockIdx.x * kGM + uu;
  if (t0) {
    const StreamLayer l0 = ld_row(d.layer);
    for (int e = t; e < 256 * kXMax; e += 256)
      s_w[e] = w0_entry<kXMax>(l0, d.c_in, i0 + e / kXMax, e % kXMax);
    float x[kXMax - 1];
#pragma unroll
    for (int c = 0; c < kXMax - 1; ++c)
      x[c] = c < d.c_in ? in.coord(v, c, d.c_in) : 0.f;
    __syncthreads();
    const int rows = min(256, round_up(l0.fout, kGK) - i0);
    for (int j = t >> 7; j < rows; j += 2) {
      const int i = i0 + j;
      const float z = z_from_x<kXMax>(x, s_w + j * kXMax);
      H[(size_t)i * d.R] = i < l0.fout ? act1(l0.act, l0.w0, z) : 0.f;
    }
  } else {
    const int rows = min(256, round_up(d.c_in, kGK) - i0);
    for (int j = t >> 7; j < rows; j += 2) {
      const int i = i0 + j;
      H[(size_t)i * d.R] = i < d.c_in ? in.coord(v, i, d.c_in) : 0.f;
    }
  }
}

// 3-F-1: the sums of split blockIdx.y of the feature blocks for the
// chunk's rows blockIdx.x * kThinRows + t + 256 k (k < kRowsT):
// part[split][c][u] = sum over the split's blocks, in order, of each
// block's sum from zero of h_1[o] W_1[o][c] by fmaf, o in order.  kX:
// layer 0's column as z_from_x reads it (>= c_in + 1), kCO >= c_out.
template <class In, int kX, int kCO>
__global__ void __launch_bounds__(256) chain_stream_thin_kernel(
    const In in, StreamDesc d) {
  __shared__ __align__(16) float s_wx[kFB * kX];
  __shared__ __align__(16) float s_wl[kFB * kCO];
  const int t = threadIdx.x, split = blockIdx.y;
  const StreamLayer l0 = ld_row(d.layer), l1 = ld_row(d.layer + 1);
  const int F = l0.fout, c_out = d.c_out;
  const int u0 = blockIdx.x * kThinRows + t;
  float x[kRowsT][kX - 1];
#pragma unroll
  for (int k = 0; k < kRowsT; ++k) {
    const long long v0 = d.base + u0 + 256 * k;
    const long long v = v0 < d.n ? v0 : d.n - 1;
#pragma unroll
    for (int c = 0; c < kX - 1; ++c)
      x[k][c] = c < d.c_in ? in.coord(v, c, d.c_in) : 0.f;
  }
  float tot[kRowsT][kCO];
#pragma unroll
  for (int k = 0; k < kRowsT; ++k)
#pragma unroll
    for (int c = 0; c < kCO; ++c) tot[k][c] = 0.f;
  const int per = (d.n_fb + d.S - 1) / d.S;
  const int fb1 = min(d.n_fb, (split + 1) * per);
  for (int fb = split * per; fb < fb1; ++fb) {
    const int f0 = fb * kFB, cnt = min(kFB, F - f0);
    __syncthreads();   // the last block's weights are read
    for (int e = t; e < kFB * kX; e += 256)
      s_wx[e] = w0_entry<kX>(l0, d.c_in, f0 + e / kX, e % kX);
    for (int e = t; e < kFB * kCO; e += 256) {
      const int o = f0 + e / kCO, c = e % kCO;
      s_wl[e] = o < F && c < c_out ? __ldg(l1.w + (size_t)o * c_out + c)
                                   : 0.f;
    }
    __syncthreads();
    float blk[kRowsT][kCO];
#pragma unroll
    for (int k = 0; k < kRowsT; ++k)
#pragma unroll
      for (int c = 0; c < kCO; ++c) blk[k][c] = 0.f;
#pragma unroll 2
    for (int j = 0; j < cnt; ++j) {
      float z[kRowsT];
#pragma unroll
      for (int k = 0; k < kRowsT; ++k)
        z[k] = z_from_x<kX>(x[k], s_wx + j * kX);
      activate<kRowsT>(z, l0.act, l0.w0);
#pragma unroll
      for (int k = 0; k < kRowsT; ++k)
#pragma unroll
        for (int c = 0; c < kCO; ++c)
          blk[k][c] = fmaf(z[k], s_wl[j * kCO + c], blk[k][c]);
    }
#pragma unroll
    for (int k = 0; k < kRowsT; ++k)
#pragma unroll
      for (int c = 0; c < kCO; ++c) tot[k][c] += blk[k][c];
  }
#pragma unroll
  for (int k = 0; k < kRowsT; ++k) {
    const int u = u0 + 256 * k;
    if (d.base + u < d.n)
      for (int c = 0; c < c_out; ++c)
        d.part[((size_t)split * c_out + c) * d.R + u] = tot[k][c];
  }
}

// The chain's output for the chunk's rows u < rows: z = b_{L-1} + the T
// partial sums in order, then the last layer's activation.
__global__ void chain_stream_end_kernel(StreamDesc d, int T, int rows) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= rows) return;
  const StreamLayer ly = ld_row(d.layer + d.n_layers - 1);
  for (int c = 0; c < d.c_out; ++c) {
    float z = __ldg(ly.b + c);
    for (int k = 0; k < T; ++k)
      z += d.part[((size_t)k * d.c_out + c) * d.R + u];
    d.out[(d.base + u) * d.c_out + c] = act1(ly.act, ly.w0, z);
  }
}

// Square layer l on the chunk's 128-row tile blockIdx.y and output tile
// blockIdx.x of 8 kWN kNTt columns (128 or 64): C[u][o] = sum_i H[i][u]
// Wp[i][o] (H = h0, or h1 where src), both operands k-major, summed by
// `mainloop`.  Then z = C + b and h = act(z), and by kEpi:
//   0: the next square layer's input, the other H buffer (zeros past fout);
//   1: the chain's output (o < c_out, rows < n);
//   2: before a thin last layer L - 1, the tile's partial sums over its
//      features, part[tile][c][u] = sum_o h[u][o] W_{L-1}[o][c].
template <int kEpi, int kNTt>
__global__ void __launch_bounds__(kGThreads, 1) chain_stream_gemm_kernel(
    StreamDesc d, int l, int src) {
  extern __shared__ __align__(16) float sm[];
  const float* tot = sm + kGStages * kStage;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3, wm = warp / kWN, wn = warp % kWN;
  const StreamLayer ly = ld_row(d.layer + l);
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * (8 * kWN * kNTt);
  float grp[kMT][kNTt][4];
  mainloop<kNTt>(grp, sm, src ? d.h1 : d.h0, d.R, d.wp + ly.wp_off,
                 ly.wp_cols, m0, n0, round_up(ly.fin, kGK) / kGK);

  // ---- epilogue: fragment (i, j) holds rows 16 kMT wm + 16 i + g (+ 8)
  // and columns 8 kNTt wn + 8 j + 2 q (+ 1) of the tile; h in place ----
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNTt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 8 * kNTt * wn + 8 * j + 2 * q + (e & 1);
        const float v = tot[((i * kNTt + j) * 4 + e) * kGThreads + t] +
                        grp[i][j][e];
        grp[i][j][e] =
            n < ly.fout ? act1(ly.act, ly.w0, v + __ldg(ly.b + n)) : 0.f;
      }
  if (kEpi == 0 || kEpi == 1) {
    float* H = src ? d.h0 : d.h1;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNTt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 16 * kMT * wm + 16 * i + g + (e >= 2 ? 8 : 0);
          const int n = n0 + 8 * kNTt * wn + 8 * j + 2 * q + (e & 1);
          if (kEpi == 0) {
            H[(size_t)n * d.R + m] = grp[i][j][e];
          } else if (n < d.c_out && d.base + m < d.n) {
            d.out[(d.base + m) * d.c_out + n] = grp[i][j][e];
          }
        }
    return;
  }
  // kEpi 2: per output c, each thread's 8 features of a row by fmaf from
  // zero (j, then the pair), its 4 lanes ((q0 + q1) + (q2 + q3)), then the
  // 4 warps along n in order
  const StreamLayer nx = ld_row(d.layer + l + 1);
  float* red = sm;   // [kWN][c_out][kGM]
  for (int c = 0; c < d.c_out; ++c) {
    float w[kNTt][2];
#pragma unroll
    for (int j = 0; j < kNTt; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int n = n0 + 8 * kNTt * wn + 8 * j + 2 * q + p;
        w[j][p] = n < nx.fin ? __ldg(nx.w + (size_t)n * d.c_out + c) : 0.f;
      }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kNTt; ++j)
#pragma unroll
          for (int p = 0; p < 2; ++p) s = fmaf(grp[i][j][2 * hh + p], w[j][p], s);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (q == 0)
          red[(wn * d.c_out + c) * kGM + 16 * kMT * wm + 16 * i + g + 8 * hh] =
              s;
      }
  }
  __syncthreads();
  for (int e = t; e < d.c_out * kGM; e += kGThreads) {
    const int c = e / kGM, r = e - c * kGM;
    float s = red[c * kGM + r];
#pragma unroll
    for (int w = 1; w < kWN; ++w) s += red[(w * d.c_out + c) * kGM + r];
    d.part[((size_t)blockIdx.x * d.c_out + c) * d.R + m0 + r] = s;
  }
}

template <int kEpi, int kNTt>
cudaError_t gemm_tile(const StreamDesc& d, int l, int src, dim3 grid,
                      cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      chain_stream_gemm_kernel<kEpi, kNTt>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return err;
  chain_stream_gemm_kernel<kEpi, kNTt>
      <<<grid, kGThreads, kGemmSmem, s>>>(d, l, src);
  return cudaGetLastError();
}

// Square layer l (its row `ly` in host memory) on the chunk's `tiles` row
// tiles, in the instance of its column tile (ly.gn: kGN or kGN64)
template <int kEpi>
cudaError_t gemm(const StreamDesc& d, const StreamLayer& ly, int l, int src,
                 int tiles, cudaStream_t s) {
  if (ly.gn == kGN)
    return gemm_tile<kEpi, kNT>(d, l, src, dim3(ly.wp_cols / kGN, tiles), s);
  if (ly.gn == kGN64)
    return gemm_tile<kEpi, kNT / 2>(d, l, src,
                                    dim3(ly.wp_cols / kGN64, tiles), s);
  return cudaErrorInvalidValue;
}

template <class In, int kX, int kCO>
cudaError_t thin(const In& in, const StreamDesc& d, int rows,
                 cudaStream_t s) {
  chain_stream_thin_kernel<In, kX, kCO>
      <<<dim3((rows + kThinRows - 1) / kThinRows, d.S), 256, 0, s>>>(in, d);
  return cudaGetLastError();
}

// Host: one call of the streamed form on stream s, `head` the table's
// rows in host memory (the launches' shapes), d.R rows a chunk; every
// kernel launched adds one to *launched.  Returns a cudaError_t.
template <class In>
int launch_stream(const In& in, StreamDesc d, const StreamLayer* head,
                  int pack_blocks, cudaStream_t s,
                  unsigned long long* launched) {
  const int L = d.n_layers;
  const bool t0 = L >= 2 && d.c_in + 1 <= kXMax;
  const bool tl = L >= 2 && d.c_out <= kCOMax;
  if (L < 1 || head == nullptr || d.n < 1 || d.R < kGM || d.R % kGM ||
      d.c_in < 1 || d.c_out < 1 || d.S < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
#define BRIEF_CHECK(x)                            \
  do {                                            \
    err = (x);                                    \
    if (err != cudaSuccess) return (int)err;      \
    ++*launched;                                  \
  } while (0)
  const bool thin_only = L == 2 && t0 && tl;
  if (!thin_only) {
    chain_stream_pack_kernel<<<dim3(pack_blocks, L), 256, 0, s>>>(d);
    BRIEF_CHECK(cudaGetLastError());
  }
  const int first = t0 ? 1 : 0;   // the first square layer
  for (long long base = 0; base < d.n; base += d.R) {
    d.base = base;
    const int rows = (int)(d.n - base < d.R ? d.n - base : d.R);
    const int tiles = (rows + kGM - 1) / kGM;
    if (thin_only) {
      const int kx = d.c_in + 1 <= 4 ? 4 : 8;
      const int kco = d.c_out <= 1 ? 1 : d.c_out <= 4 ? 4 : 8;
      switch (kx * 16 + kco) {
        case 4 * 16 + 1: BRIEF_CHECK((thin<In, 4, 1>(in, d, rows, s))); break;
        case 4 * 16 + 4: BRIEF_CHECK((thin<In, 4, 4>(in, d, rows, s))); break;
        case 4 * 16 + 8: BRIEF_CHECK((thin<In, 4, 8>(in, d, rows, s))); break;
        case 8 * 16 + 1: BRIEF_CHECK((thin<In, 8, 1>(in, d, rows, s))); break;
        case 8 * 16 + 4: BRIEF_CHECK((thin<In, 8, 4>(in, d, rows, s))); break;
        default: BRIEF_CHECK((thin<In, 8, 8>(in, d, rows, s)));
      }
      chain_stream_end_kernel<<<(rows + 255) / 256, 256, 0, s>>>(d, d.S, rows);
      BRIEF_CHECK(cudaGetLastError());
      continue;
    }
    const int in_rows = round_up(t0 ? head[0].fout : d.c_in, kGK);
    chain_stream_prep_kernel<In>
        <<<dim3(tiles, (in_rows + 255) / 256), 256, 0, s>>>(in, d, (int)t0);
    BRIEF_CHECK(cudaGetLastError());
    int src = 0;
    for (int l = first; l < (tl ? L - 1 : L); ++l) {
      if (l == L - 1) {
        BRIEF_CHECK(gemm<1>(d, head[l], l, src, tiles, s));
      } else if (tl && l == L - 2) {
        BRIEF_CHECK(gemm<2>(d, head[l], l, src, tiles, s));
      } else {
        BRIEF_CHECK(gemm<0>(d, head[l], l, src, tiles, s));
        src ^= 1;
      }
    }
    if (tl) {
      chain_stream_end_kernel<<<(rows + 255) / 256, 256, 0, s>>>(
          d, head[L - 2].wp_cols / head[L - 2].gn, rows);
      BRIEF_CHECK(cudaGetLastError());
    }
  }
#undef BRIEF_CHECK
  return (int)cudaSuccess;
}

}  // namespace chain_stream
}  // namespace brief
