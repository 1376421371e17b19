// Kernel 1's streamed form, for Hopper: the fused train-step gradients of
// a plain activation chain with a layer wider than the wide layout takes
// (352 features; e.g. 3-20971-1, 3-4096-1, [3, 4096, 4096, 1]), for
// one chain or a fleet of B chains of one padded shape.  The port of
// brief_pytorch_tpu/ops/pallas_train.py (_fused_grads_padded) for those
// chains; ops/fused_train.py choose_plan sends them here, ops/stream.py is
// the Python side (the plan, the table, the CPU twin `stream_emulation`).
//
// A chain of L layers, h_0 the coordinates, z_{l+1} = W_l^T h_l + b_l,
// h_{l+1} = act_l(z_{l+1}) m_l, and three kinds of layer:
//  * thin in: layer 0 when c_in + 1 <= 8.  z_1 is never stored: whoever
//    reads h_1 or d_1 recomputes it from the coordinates (z_from_x, c_in
//    fmaf, the same order everywhere, then the same fast sincos), so every
//    copy equals the others bit for bit;
//  * thin out: the last layer when c_out <= 8.  Its forward is a reduction
//    over the features (stream_thin_fwd_kernel: each thread carries its
//    coordinates through a block of 256 features, the block's sums are
//    partials added in order by the loss); its backward
//    (stream_thin_bwd_kernel) gives its dW as per-feature sums over the
//    coordinates and g_{L-1} = (W g_L) d_{L-1} as a rank-c_out update;
//  * the others ("square" layers, both sides wider than that): products on
//    the tensor cores (stream_gemm_kernel): mma.sync.m16n8k8 TF32 in
//    3xTF32 (operands split as they are read, small parts rounded:
//    csrc/tf32.cuh split_tf32_nearest), each k-block's three products
//    summed from zero and added in float32, the k-blocks in groups of
//    kGroupK from zero (never a long sum in one accumulator), 128 x 128
//    tiles of 8 warps fed by a ring of kGStages cp.async slabs.
// The scratch (device memory, rows of np = round256(N) floats) holds one
// row set per stored hidden layer: its pre-activation z, which the
// backward later overwrites with its g.  h and d are recomputed from z
// where they are read (stream_prep_kernel makes h_l once per product, the
// input-gradient epilogue d_{l}); one transient row set H holds the
// operand h_l of the current product.  3-20971-1 stores nothing but g_L
// and the forward's partials; [3, 4096, 4096, 1] stores z_2 and H.
//
// Per call (brief_fused_train_stream):
//   pack W of the square layers, zero-padded to 128 x 128 tiles;
//   forward: per square layer, prep H = h_l, z_{l+1} = H^T W + b; the thin
//   last layer's partials; the loss, g_L;
//   backward: the thin last layer (its dW, and g_{L-1} written over
//   z_{L-1}, or for L = 2 layer 0's dW at once); per square layer, last
//   first: prep H = h_l, dW_l = H g_{l+1}^T and db_l in splits of the
//   coordinates, g_l = (W_l g_{l+1}) d_l over z_l; layer 0's dW (thin in);
//   the splits' partials added in a fixed order.  No float atomics:
//   two calls are bitwise equal.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "tf32.cuh"

namespace {

using brief::ld_row;
using brief::mma_tf32;
using brief::mma_tf32_zero;
using brief::split_tf32_nearest;

constexpr int kWM = 2, kWN = 4;  // warps of a product block along m and n
constexpr int kMT = 4, kNT = 4;  // a warp's mma tiles (16 x 8) along m, n
constexpr int kGThreads = 32 * kWM * kWN;
constexpr int kGM = kWM * 16 * kMT, kGN = kWN * 8 * kNT;   // 128 x 128
constexpr int kGK = 32;                         // slab depth
constexpr int kGStages = 3;                     // slabs in the ring
constexpr int kSK = 128 + 8;     // k-major operand row, floats (8 mod 32)
constexpr int kSM = kGK + 4;     // k-minor operand row, floats (4 mod 32)
constexpr int kTile = 128 * kSM; // floats of one operand's slab (>= kGK kSK)
constexpr int kStage = 2 * kTile;
constexpr int kGroupK = 32;      // k-blocks a group of the sums
constexpr int kAcc = 4 * kMT * kNT;   // a thread's accumulators
constexpr int kGemmSmem = 4 * (kGStages * kStage + kAcc * kGThreads);
static_assert(kGM == 128 && kGN == 128, "ops/stream.py GM, GN");
constexpr int kFB = 256;         // features a block of the thin kernels
constexpr int kChunk = 32;       // coordinates a chunk of the thin sums
constexpr int kZS = kChunk + 1;  // row of the thin backward's z / g tile
constexpr int kXMax = 8;         // x terms (c_in, zero-padded) and the bias

static_assert(kTile >= kGK * kSK, "a k-major slab fits the slab");

// Layer l's row of the table (ops/stream.py stream_table): widths,
// activation and w0, its parameters' offset, its padded W copy (square
// layers; -1: thin) and that copy's row stride, the scratch rows of its
// output z_{l+1} / g_{l+1} (-1: not stored), its unit mask's offset (-1:
// none), and the regions of the partial sums of its W (fin x fout floats
// a split) and of its b (fout a split): offset, splits of the coordinates,
// coordinates a split.  A thin layer's W and b share their splits.
struct __align__(16) StreamLayer {
  int fin, fout, act, p_off;
  int wp_off, wp_cols, out_row, mask_off;
  int part_off, splits, chunk, bpart_off;
  float w0;
  int bsplits, bchunk, pad;
};
static_assert(sizeof(StreamLayer) == 64, "ops/stream.py STREAM_ROW_WORDS");

// The call: the caller's tensors, the table, the scratch and its layout
// (per chain: rows_total rows of np floats, H at h_row, the thin last
// layer's partials at pp_row, n_pp blocks of c_out rows; part_total
// floats of partial sums; wp_total floats of padded W), whether the ends
// are thin, the loss kernel's blocks.  blockIdx.z is the chain (the dW
// product: chain * splits + split).
struct StreamDesc {
  const float* coords;
  const float* values;
  const float* weights;
  const float* params;
  const float* masks;
  const float* thres;
  const StreamLayer* layer;
  float* scratch;
  float* wp;
  float* partial;
  double* lossp;
  int n, np, n_layers, c_in, c_out, n_params, mask_width, rows_total;
  int h_row, pp_row, n_pp, part_total, wp_total, t0, tl, loss_blocks;
};

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

__device__ __forceinline__ float* chain_scratch(const StreamDesc& d, int fb) {
  return d.scratch + (size_t)fb * d.rows_total * d.np;
}

// Layer ly's unit mask in chain fb, or null
__device__ __forceinline__ const float* out_mask(const StreamDesc& d,
                                                 const StreamLayer& ly,
                                                 int fb) {
  return d.masks == nullptr || ly.mask_off < 0
             ? nullptr
             : d.masks + (size_t)fb * d.mask_width + ly.mask_off;
}

// h and d of z through layer ly's activation and mask entry i
__device__ __forceinline__ void act_mask(const StreamLayer& ly,
                                         const float* m, int i, float z,
                                         float* h, float* dv) {
  brief::act_fwd(ly.act, ly.w0, z, h, dv);
  if (m != nullptr) {
    const float mv = __ldg(m + i);
    *h *= mv;
    *dv *= mv;
  }
}

// z_1 of a coordinate from its c_in values x (zero-padded to kX - 1) and
// layer 0's column w: W_0[c][o] for c < kX - 1 (zero-padded), b_0[o] last.
// The bias first, then one fmaf a coordinate channel: every kernel that
// recomputes z_1 gets the same bits (a padded term adds 0 * 0).
template <int kX>
__device__ __forceinline__ float z_from_x(const float* x, const float* w) {
  float z = w[kX - 1];
#pragma unroll
  for (int c = 0; c < kX - 1; ++c) z = fmaf(x[c], w[c], z);
  return z;
}

// Layer 0's column o (p0: its parameters) as z_from_x<kX> reads it
template <int kX>
__device__ __forceinline__ void w0_column(const float* p0, int c_in, int f1,
                                          int o, float* w) {
  const bool in = o < f1;
#pragma unroll
  for (int c = 0; c < kX - 1; ++c)
    w[c] = in && c < c_in ? __ldg(p0 + (size_t)c * f1 + o) : 0.f;
  w[kX - 1] = in ? __ldg(p0 + (size_t)c_in * f1 + o) : 0.f;
}

// ---------------------------------------------------------------------------
// W of the square layers, zero-padded to (round128(fin), wp_cols =
// round128(fout)), so that every 16-byte copy of a slab is aligned and no
// tile reads past it.  Grid (blocks, n_layers, B).
__global__ void stream_pack_kernel(StreamDesc d) {
  const StreamLayer ly = ld_row(d.layer + blockIdx.y);
  if (ly.wp_off < 0) return;
  const float* w = d.params + (size_t)blockIdx.z * d.n_params + ly.p_off;
  float* dst = d.wp + (size_t)blockIdx.z * d.wp_total + ly.wp_off;
  const long long size = (long long)round_up(ly.fin, kGM) * ly.wp_cols;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < size; e += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(e / ly.wp_cols), c = (int)(e - (long long)r * ly.wp_cols);
    dst[e] = r < ly.fin && c < ly.fout ? w[(size_t)r * ly.fout + c] : 0.f;
  }
}

// H = h_l, the input of square layer l, rows round128(fin) (zero past
// fin): the coordinates (l = 0), h_1 recomputed from them (l = 1, thin
// in), or act(z_l) m from the scratch.  Grid (np / 128, rows / 8, B),
// blocks of 32 x 8: a thread 4 coordinates of one row.
__global__ void __launch_bounds__(256) stream_prep_kernel(StreamDesc d,
                                                          int l) {
  const int fb = blockIdx.z, r = blockIdx.y * 8 + threadIdx.y;
  const int u = blockIdx.x * 128 + 4 * threadIdx.x;
  const StreamLayer ly = ld_row(d.layer + l);
  float* scratch = chain_scratch(d, fb);
  const size_t np = d.np;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (r < ly.fin) {
    const float* coords = d.coords + (size_t)fb * d.c_in * d.n;
    if (l == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = u + k < d.n ? coords[(size_t)r * d.n + u + k] : 0.f;
    } else {
      const StreamLayer in = ld_row(d.layer + l - 1);
      const float* m = out_mask(d, in, fb);
      float z[4];
      if (l == 1 && d.t0) {
        float w[kXMax];
        w0_column<kXMax>(d.params + (size_t)fb * d.n_params + in.p_off,
                         d.c_in, in.fout, r, w);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float x[kXMax - 1];
#pragma unroll
          for (int c = 0; c < kXMax - 1; ++c)
            x[c] = c < d.c_in && u + k < d.n ? coords[(size_t)c * d.n + u + k]
                                             : 0.f;
          z[k] = z_from_x<kXMax>(x, w);
        }
      } else {
        const float4 zz = *reinterpret_cast<const float4*>(
            scratch + (size_t)(in.out_row + r) * np + u);
        z[0] = zz.x;
        z[1] = zz.y;
        z[2] = zz.z;
        z[3] = zz.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float dv;
        act_mask(in, m, r, z[k], &v[k], &dv);
      }
    }
  }
  *reinterpret_cast<float4*>(scratch + (size_t)(d.h_row + r) * np + u) =
      make_float4(v[0], v[1], v[2], v[3]);
}

// ---------------------------------------------------------------------------
// The square layers' products, C[m][n] = sum_k A[m][k] B[k][n] on 128 x
// 128 tiles, K in slabs of 32 through a ring of kGStages cp.async stages:
//   kMode 0, forward of layer l: C[u][o] = sum_i H[i][u] Wp[i][o]; stored
//     with the bias added as z_{l+1} (out_row);
//   kMode 1, input gradient of layer l: C[u][i] = sum_o G[o][u] Wp[i][o],
//     G = g_{l+1} (out_row); times d_l (from z_l, or recomputed from the
//     coordinates for l = 1 with a thin layer 0), stored as g_l over z_l
//     (or into H);
//   kMode 2, dW of layer l: C[i][o] = sum_u H[i][u] G[o][u] over split
//     blockIdx.z % S of the coordinates; its partial sums.
// Shared memory: an operand whose k runs along its rows in global memory
// ("k-minor": rows of 32 + 4 floats) or along its columns ("k-major":
// rows of 128 + 8), so every fragment read of a warp hits 32 banks; the
// accumulators' running totals (one column of kAcc per thread).  Warp w
// takes rows 16 kMT (w / kWN) and columns 8 kNT (w % kWN) of the tile:
// kMT x kNT mma tiles, operands split as they are read, each k-block's
// three products summed from zero into `s` and added to the group's sums
// in float32; every kGroupK k-blocks the group is added to the running
// total and starts again from zero.
template <int kMode>
__global__ void __launch_bounds__(kGThreads, 1) stream_gemm_kernel(
    StreamDesc d, int l, int S) {
  constexpr bool kAMajor = kMode != 2;   // A k-major (H or G rows by u)
  constexpr bool kBMajor = kMode == 0;   // B k-major (Wp rows by o)
  extern __shared__ __align__(16) float sm[];
  float* tot = sm + kGStages * kStage;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3, wm = warp / kWN, wn = warp % kWN;
  const int fb = blockIdx.z / S, split = blockIdx.z - fb * S;
  const StreamLayer ly = ld_row(d.layer + l);
  const size_t np = d.np;
  float* scratch = chain_scratch(d, fb);
  const float* wp = d.wp + (size_t)fb * d.wp_total + ly.wp_off;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const float* A;
  const float* B;
  size_t lda, ldb;
  int k0, k1;
  if (kMode == 0) {
    A = scratch + (size_t)d.h_row * np;
    lda = np;
    B = wp;
    ldb = ly.wp_cols;
    k0 = 0;
    k1 = round_up(ly.fin, kGK);
  } else if (kMode == 1) {
    A = scratch + (size_t)ly.out_row * np;
    lda = np;
    B = wp;
    ldb = ly.wp_cols;
    k0 = 0;
    k1 = round_up(ly.fout, kGK);
  } else {
    A = scratch + (size_t)d.h_row * np;
    lda = np;
    B = scratch + (size_t)ly.out_row * np;
    ldb = np;
    k0 = split * ly.chunk;
    k1 = min(d.np, k0 + ly.chunk);
  }
  const int KT = (k1 - k0) / kGK;

  // one operand's slab: kGK rows x 128 (k-major) or 128 rows x kGK, 1024
  // 16-byte copies
  auto slab = [&](float* dst, const float* src, size_t ld, bool major,
                  int kk, int x0) {
#pragma unroll
    for (int j = 0; j < 1024 / kGThreads; ++j) {
      const int c = t + j * kGThreads;
      if (major) {
        const int r = c >> 5, c4 = c & 31;
        cp16(dst + r * kSK + 4 * c4, src + (size_t)(kk + r) * ld + x0 + 4 * c4);
      } else {
        const int r = c >> 3, c4 = c & 7;
        cp16(dst + r * kSM + 4 * c4, src + (size_t)(x0 + r) * ld + kk + 4 * c4);
      }
    }
  };
  auto load = [&](int kt, int stage) {
    const int kk = k0 + kt * kGK;
    float* st = sm + stage * kStage;
    slab(st, A, lda, kAMajor, kk, m0);
    slab(st + kTile, B, ldb, kBMajor, kk, n0);
  };

  float grp[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) grp[i][j][e] = 0.f;
#pragma unroll 8
  for (int e = 0; e < kAcc; ++e) tot[e * kGThreads + t] = 0.f;

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
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[((i * kNT + j) * 4 + e) * kGThreads + t] += grp[i][j][e];
              grp[i][j][e] = 0.f;
            }
      }
      const int k = 8 * kb + q;
      uint32_t bb[kNT][2], bsm[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = 8 * kNT * wn + 8 * j + g;
        const float b0 = kBMajor ? bs[k * kSK + n] : bs[n * kSM + k];
        const float b1 = kBMajor ? bs[(k + 4) * kSK + n] : bs[n * kSM + k + 4];
        split_tf32_nearest(b0, &bb[j][0], &bsm[j][0]);
        split_tf32_nearest(b1, &bb[j][1], &bsm[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int m = 16 * kMT * wm + 16 * i + g;
        float a[4];
        if (kAMajor) {
          a[0] = as[k * kSK + m];
          a[1] = as[k * kSK + m + 8];
          a[2] = as[(k + 4) * kSK + m];
          a[3] = as[(k + 4) * kSK + m + 8];
        } else {
          a[0] = as[m * kSM + k];
          a[1] = as[(m + 8) * kSM + k];
          a[2] = as[m * kSM + k + 4];
          a[3] = as[(m + 8) * kSM + k + 4];
        }
        uint32_t ab[4], asm_[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32_nearest(a[e], &ab[e], &asm_[e]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
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

  // ---- epilogue: fragment (i, j) holds rows 16 kMT wm + 16 i + g (+ 8)
  // and columns 8 kNT wn + 8 j + 2 q (+ 1) of the tile ----
  const int c_in = d.c_in;
  StreamLayer in;
  const float* min_ = nullptr;
  bool xsrc = false;
  int tgt = 0;
  float* xs = sm;                  // kMode 1 from the coordinates:
  float* ws = sm + kXMax * kGM;    // x of the tile's rows, W_0 of its columns
  if (kMode == 1) {
    in = ld_row(d.layer + l - 1);
    min_ = out_mask(d, in, fb);
    xsrc = l == 1 && d.t0;
    tgt = in.out_row >= 0 ? in.out_row : d.h_row;
    if (xsrc) {
      const float* coords = d.coords + (size_t)fb * c_in * d.n;
      const float* p0 = d.params + (size_t)fb * d.n_params + in.p_off;
      for (int e = t; e < (kXMax - 1) * kGM; e += kGThreads) {
        const int c = e / kGM, u = m0 + e % kGM;
        xs[e] = c < c_in && u < d.n ? coords[(size_t)c * d.n + u] : 0.f;
      }
      for (int e = t; e < kXMax * kGN; e += kGThreads) {
        const int c = e / kGN, i = n0 + e % kGN;
        const bool ok = i < in.fout;
        ws[e] = c < kXMax - 1 ? (ok && c < c_in
                                     ? __ldg(p0 + (size_t)c * in.fout + i)
                                     : 0.f)
                              : (ok ? __ldg(p0 + (size_t)c_in * in.fout + i)
                                    : 0.f);
      }
      __syncthreads();
    }
  }
  const float* bias = d.params + (size_t)fb * d.n_params + ly.p_off +
                      (size_t)ly.fin * ly.fout;
  float* part = d.partial + (size_t)fb * d.part_total + ly.part_off +
                (size_t)split * ly.fin * ly.fout;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mr = 16 * kMT * wm + 16 * i + g + (e >= 2 ? 8 : 0);
        const int nc = 8 * kNT * wn + 8 * j + 2 * q + (e & 1);
        const int m = m0 + mr, n = n0 + nc;
        const float v = tot[((i * kNT + j) * 4 + e) * kGThreads + t] +
                        grp[i][j][e];
        if (kMode == 0) {          // z_{l+1}[o = n][u = m]
          // ---- streamed: store z
          scratch[(size_t)(ly.out_row + n) * np + m] =
              v + (n < ly.fout ? __ldg(bias + n) : 0.f);
          // ---- streamed: stored
        } else if (kMode == 1) {   // g_l[i = n][u = m]
          float gv = 0.f;
          if (n < ly.fin) {
            float z;
            if (xsrc) {
              float x[kXMax - 1], w[kXMax];
#pragma unroll
              for (int c = 0; c < kXMax - 1; ++c) x[c] = xs[c * kGM + mr];
#pragma unroll
              for (int c = 0; c < kXMax; ++c) w[c] = ws[c * kGN + nc];
              z = z_from_x<kXMax>(x, w);
            } else {
              z = scratch[(size_t)(in.out_row + n) * np + m];
            }
            float h, dv;
            act_mask(in, min_, n, z, &h, &dv);
            gv = v * dv;
          }
          scratch[(size_t)(tgt + n) * np + m] = gv;
        } else if (m < ly.fin && n < ly.fout) {   // dW[i = m][o = n]
          part[(size_t)m * ly.fout + n] = v;
        }
      }
}

// ---------------------------------------------------------------------------
// The thin last layer's forward: partial z_L over blocks of kFB features,
// pp[fblock][c][u] = sum_{o in the block} h_{L-1}[o][u] W[o][c], a thread
// 2 coordinates, the block's features in order into one float32 sum
// each (fmaf).  h_{L-1} from z_{L-1} in the scratch, or (L = 2, thin in)
// recomputed from the coordinates.  Grid (fblocks, np / 256, B), 128
// threads; kX: layer 0's column as z_from_x reads it, kCO >= c_out.
template <int kX, int kCO>
__global__ void __launch_bounds__(128) stream_thin_fwd_kernel(StreamDesc d) {
  __shared__ __align__(16) float s_wl[kFB * kCO];
  __shared__ __align__(16) float s_wx[kFB * kX];
  const int t = threadIdx.x, fb = blockIdx.z, f0 = blockIdx.x * kFB;
  const int L = d.n_layers, u = blockIdx.y * 256 + 2 * t;
  const StreamLayer ly = ld_row(d.layer + L - 1);
  const bool xsrc = L == 2 && d.t0;
  const StreamLayer in = ld_row(d.layer + (xsrc ? 0 : L - 2));
  const float* m = out_mask(d, in, fb);
  const float* p = d.params + (size_t)fb * d.n_params;
  const int F = ly.fin, c_out = ly.fout, cnt = min(kFB, F - f0);
  for (int e = t; e < kFB * kCO; e += 128) {
    const int o = f0 + e / kCO, c = e % kCO;
    s_wl[e] = o < F && c < c_out ? p[ly.p_off + (size_t)o * c_out + c] : 0.f;
  }
  if (xsrc)
    for (int o = t; o < kFB; o += 128)
      w0_column<kX>(p + in.p_off, d.c_in, F, f0 + o, s_wx + o * kX);
  float x[2][kX - 1];
  if (xsrc) {
    const float* coords = d.coords + (size_t)fb * d.c_in * d.n;
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int c = 0; c < kX - 1; ++c)
        x[k][c] = c < d.c_in && u + k < d.n ? coords[(size_t)c * d.n + u + k]
                                            : 0.f;
  }
  __syncthreads();
  float* scratch = chain_scratch(d, fb);
  const size_t np = d.np;
  const float* zp = scratch + (size_t)(xsrc ? 0 : in.out_row) * np + u;
  float acc[2][kCO];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int c = 0; c < kCO; ++c) acc[k][c] = 0.f;
  for (int j = 0; j < cnt; ++j) {
    const int o = f0 + j;
    float z[2];
    if (xsrc) {
#pragma unroll
      for (int k = 0; k < 2; ++k) z[k] = z_from_x<kX>(x[k], s_wx + j * kX);
    } else {
      const float2 zz = *reinterpret_cast<const float2*>(zp + (size_t)o * np);
      z[0] = zz.x;
      z[1] = zz.y;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float h, dv;
      act_mask(in, m, o, z[k], &h, &dv);
#pragma unroll
      for (int c = 0; c < kCO; ++c)
        acc[k][c] = fmaf(h, s_wl[j * kCO + c], acc[k][c]);
    }
  }
  for (int c = 0; c < c_out; ++c)
    *reinterpret_cast<float2*>(
        scratch + (size_t)(d.pp_row + blockIdx.x * c_out + c) * np + u) =
        make_float2(acc[0][c], acc[1][c]);
}

// The loss: z_L (the bias, then the thin forward's partials in order; or
// a square last layer's z), the prediction and d_L, the weighted loss
// with the threshold override, g_L stored in the last layer's out rows;
// one loss partial a block, its coordinates' losses added in float64 (a
// halving tree).  Grid (loss_blocks, B), 256 threads, a thread a
// coordinate.
__global__ void __launch_bounds__(256) stream_loss_kernel(StreamDesc d,
                                                          int loss,
                                                          float beta) {
  __shared__ double red[256];
  const int t = threadIdx.x, fb = blockIdx.y, u = blockIdx.x * 256 + t;
  const StreamLayer ly = ld_row(d.layer + d.n_layers - 1);
  const float* m = out_mask(d, ly, fb);
  const float* bias = d.params + (size_t)fb * d.n_params + ly.p_off +
                      (size_t)ly.fin * ly.fout;
  const bool thr_on = d.thres != nullptr;
  const float thr = thr_on ? d.thres[fb] : 0.f;
  float* scratch = chain_scratch(d, fb);
  const size_t np = d.np;
  const bool valid = u < d.n;
  float loss_acc = 0.f;
  for (int c = 0; c < d.c_out; ++c) {
    float z;
    if (d.tl) {
      z = __ldg(bias + c);
      for (int k = 0; k < d.n_pp; ++k)
        z += scratch[(size_t)(d.pp_row + k * d.c_out + c) * np + u];
    } else {
      z = scratch[(size_t)(ly.out_row + c) * np + u];
    }
    float pr, dv;
    act_mask(ly, m, c, z, &pr, &dv);
    float y = 0.f, wv = 0.f;
    if (valid) {
      y = d.values[((size_t)fb * d.c_out + c) * d.n + u];
      wv = d.weights[((size_t)fb * d.c_out + c) * d.n + u];
    }
    scratch[(size_t)(ly.out_row + c) * np + u] = brief::loss_grad(
        loss, beta, thr_on, thr, pr, y, wv, valid, dv, &loss_acc);
  }
  red[t] = loss_acc;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  if (t == 0) d.lossp[(size_t)fb * d.loss_blocks + blockIdx.x] = red[0];
}

// The thin last layer's backward over split blockIdx.y of the
// coordinates, a thread feature o = blockIdx.x * kFB + t (o = F: the bias
// row, h = 1): h and d of z_{L-1} (from the scratch, staged a chunk of 32
// coordinates at a time, or recomputed from the coordinates, whose x sit
// beside g_L in one 16-byte aligned row a coordinate),
// gs = sum_c W[o][c] g_L[c] (fmaf from zero), g = d gs; its dW row
// dW[o][c] = sum_u h g_L[c] and (L = 2, thin in: `dw0`) layer 0's
// dW[c][o] = sum_u x_c g, db[o] = sum_u g, each a chunk's sum from zero
// added to the running one; g written over z_{L-1} (`wg`: L > 2, or a
// square layer 0).  Grid (ceil((F + 1) / kFB), splits, B), kFB threads.
template <int kX, int kCO>
__global__ void __launch_bounds__(kFB) stream_thin_bwd_kernel(StreamDesc d) {
  constexpr int kXG = (kX - 1 + kCO + 3) / 4 * 4;   // x, then g_L
  __shared__ float s_z[kFB * kZS];
  __shared__ __align__(16) float s_xg[kChunk * kXG];
  const int t = threadIdx.x, fb = blockIdx.z, split = blockIdx.y;
  const int L = d.n_layers, f0 = blockIdx.x * kFB, o = f0 + t;
  const StreamLayer ly = ld_row(d.layer + L - 1);
  const bool xsrc = L == 2 && d.t0, wg = !xsrc;
  const StreamLayer in = ld_row(d.layer + (xsrc ? 0 : L - 2));
  const float* m = out_mask(d, in, fb);
  const float* p = d.params + (size_t)fb * d.n_params;
  const float* coords = d.coords + (size_t)fb * d.c_in * d.n;
  const int F = ly.fin, c_out = ly.fout;
  float* scratch = chain_scratch(d, fb);
  const size_t np = d.np;
  float wl[kCO], wx[kX];
#pragma unroll
  for (int c = 0; c < kCO; ++c)
    wl[c] = o < F && c < c_out ? p[ly.p_off + (size_t)o * c_out + c] : 0.f;
  if (xsrc) w0_column<kX>(p + in.p_off, d.c_in, F, o, wx);
  float acc_l[kCO], acc_0[kX];
#pragma unroll
  for (int c = 0; c < kCO; ++c) acc_l[c] = 0.f;
#pragma unroll
  for (int c = 0; c < kX; ++c) acc_0[c] = 0.f;
  const int u_lo = split * ly.chunk, u_hi = min(d.np, u_lo + ly.chunk);
  float* zrows = scratch + (size_t)(xsrc ? 0 : in.out_row) * np;
  const float* gl = scratch + (size_t)ly.out_row * np;
  for (int u0 = u_lo; u0 < u_hi; u0 += kChunk) {
    __syncthreads();   // the last chunk's tiles are read
    for (int e = t; e < kXG * kChunk; e += kFB) {
      const int c = e / kChunk, j = e % kChunk, u = u0 + j;
      float v = 0.f;
      if (c < kX - 1) {
        if (xsrc && c < d.c_in && u < d.n) v = coords[(size_t)c * d.n + u];
      } else if (c - (kX - 1) < c_out) {
        v = gl[(size_t)(c - (kX - 1)) * np + u];
      }
      s_xg[j * kXG + c] = v;
    }
    if (!xsrc) {
      for (int e = t; e < kFB * (kChunk / 4); e += kFB) {
        const int r = e / (kChunk / 4), j = 4 * (e % (kChunk / 4));
        if (f0 + r < F) {
          const float4 v = *reinterpret_cast<const float4*>(
              zrows + (size_t)(f0 + r) * np + u0 + j);
          float* dst = s_z + r * kZS + j;
          dst[0] = v.x;
          dst[1] = v.y;
          dst[2] = v.z;
          dst[3] = v.w;
        }
      }
    }
    __syncthreads();
    float cs_l[kCO], cs_0[kX];
#pragma unroll
    for (int c = 0; c < kCO; ++c) cs_l[c] = 0.f;
#pragma unroll
    for (int c = 0; c < kX; ++c) cs_0[c] = 0.f;
    for (int j = 0; j < kChunk; ++j) {
      float xg[kXG];
#pragma unroll
      for (int c = 0; c < kXG; c += 4)
        *reinterpret_cast<float4*>(xg + c) =
            *reinterpret_cast<const float4*>(s_xg + j * kXG + c);
      const float* g = xg + kX - 1;
      float h = o == F ? 1.f : 0.f;
      if (o < F) {
        const float z = xsrc ? z_from_x<kX>(xg, wx) : s_z[t * kZS + j];
        float dv;
        act_mask(in, m, o, z, &h, &dv);
        float gs = 0.f;
#pragma unroll
        for (int c = 0; c < kCO; ++c) gs = fmaf(wl[c], g[c], gs);
        const float gv = dv * gs;
        if (wg) s_z[t * kZS + j] = gv;
        if (xsrc) {
#pragma unroll
          for (int c = 0; c < kX - 1; ++c) cs_0[c] = fmaf(xg[c], gv, cs_0[c]);
          cs_0[kX - 1] += gv;
        }
      }
#pragma unroll
      for (int c = 0; c < kCO; ++c) cs_l[c] = fmaf(h, g[c], cs_l[c]);
    }
#pragma unroll
    for (int c = 0; c < kCO; ++c) acc_l[c] += cs_l[c];
#pragma unroll
    for (int c = 0; c < kX; ++c) acc_0[c] += cs_0[c];
    if (wg) {
      __syncthreads();
      // ---- streamed: store z
      for (int e = t; e < kFB * (kChunk / 4); e += kFB) {
        const int r = e / (kChunk / 4), j = 4 * (e % (kChunk / 4));
        if (f0 + r < F) {
          const float* src = s_z + r * kZS + j;
          *reinterpret_cast<float4*>(zrows + (size_t)(f0 + r) * np + u0 + j) =
              make_float4(src[0], src[1], src[2], src[3]);
        }
      }
      // ---- streamed: stored
    }
  }
  float* part = d.partial + (size_t)fb * d.part_total;
  if (o < F) {
    float* pw = part + ly.part_off + (size_t)split * F * c_out;
    for (int c = 0; c < c_out; ++c) pw[(size_t)o * c_out + c] = acc_l[c];
  } else if (o == F) {
    float* pb = part + ly.bpart_off + (size_t)split * c_out;
    for (int c = 0; c < c_out; ++c) pb[c] = acc_l[c];
  }
  if (xsrc && o < F) {
    float* pw = part + in.part_off + (size_t)split * d.c_in * F;
    for (int c = 0; c < d.c_in; ++c) pw[(size_t)c * F + o] = acc_0[c];
    part[in.bpart_off + (size_t)split * F + o] = acc_0[kX - 1];
  }
}

// Sums over the coordinates of R rows G (from scratch row `row`): for a
// thin layer 0, its dW[c][o] = sum_u x_c g_1[o] and db[o] = sum_u g_1[o]
// (kX; layer l's splits); for a square layer, its db[o] = sum_u g[o] (!kX;
// its b's splits).  Split blockIdx.y, a chunk of 32 coordinates summed
// from zero and added to the running sums.  Grid (ceil(R / kFB), splits,
// B), kFB threads, a thread a row.
template <bool kX>
__global__ void __launch_bounds__(kFB) stream_rowsum_kernel(StreamDesc d,
                                                            int l, int row,
                                                            int R) {
  constexpr int kNX = kX ? kXMax - 1 : 0;
  __shared__ float s_z[kFB * kZS];
  __shared__ float s_x[kXMax * kChunk];
  const int t = threadIdx.x, fb = blockIdx.z, split = blockIdx.y;
  const int f0 = blockIdx.x * kFB, o = f0 + t;
  const StreamLayer ly = ld_row(d.layer + l);
  const float* coords = d.coords + (size_t)fb * d.c_in * d.n;
  const size_t np = d.np;
  const float* rows = chain_scratch(d, fb) + (size_t)row * np;
  float acc[kNX + 1];
#pragma unroll
  for (int c = 0; c <= kNX; ++c) acc[c] = 0.f;
  const int chunk = kX ? ly.chunk : ly.bchunk;
  const int u_lo = split * chunk, u_hi = min(d.np, u_lo + chunk);
  for (int u0 = u_lo; u0 < u_hi; u0 += kChunk) {
    __syncthreads();
    if (kX) {
      for (int e = t; e < kNX * kChunk; e += kFB) {
        const int c = e / kChunk, u = u0 + e % kChunk;
        s_x[e] = c < d.c_in && u < d.n ? coords[(size_t)c * d.n + u] : 0.f;
      }
    }
    for (int e = t; e < kFB * (kChunk / 4); e += kFB) {
      const int r = e / (kChunk / 4), j = 4 * (e % (kChunk / 4));
      if (f0 + r < R) {
        const float4 v = *reinterpret_cast<const float4*>(
            rows + (size_t)(f0 + r) * np + u0 + j);
        float* dst = s_z + r * kZS + j;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    }
    __syncthreads();
    float cs[kNX + 1];
#pragma unroll
    for (int c = 0; c <= kNX; ++c) cs[c] = 0.f;
    for (int j = 0; j < kChunk; ++j) {
      const float gv = s_z[t * kZS + j];
#pragma unroll
      for (int c = 0; c < kNX; ++c) cs[c] = fmaf(s_x[c * kChunk + j], gv, cs[c]);
      cs[kNX] += gv;
    }
#pragma unroll
    for (int c = 0; c <= kNX; ++c) acc[c] += cs[c];
  }
  if (o < R) {
    float* part = d.partial + (size_t)fb * d.part_total;
#pragma unroll
    for (int c = 0; c < kNX; ++c)
      if (c < d.c_in)
        part[ly.part_off + (size_t)split * d.c_in * R + (size_t)c * R + o] =
            acc[c];
    part[ly.bpart_off + (size_t)split * R + o] = acc[kNX];
  }
}

// out[fb][p] = the splits' partial sums of parameter p, added in order in
// float64, / m; out[fb][n_params] = the loss blocks' partials likewise.
// Grid (ceil((n_params + 1) / 256), B).
__global__ void stream_reduce_kernel(StreamDesc d, float* out, float mdiv) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x, fb = blockIdx.y;
  if (p > d.n_params) return;
  double s = 0.0;
  if (p < d.n_params) {
    int lo = 0, hi = d.n_layers - 1;   // p's layer: the last starting <= p
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (__ldg(&d.layer[mid].p_off) <= p) lo = mid;
      else hi = mid - 1;
    }
    const StreamLayer ly = ld_row(d.layer + lo);
    const int j = p - ly.p_off, nw = ly.fin * ly.fout;
    const float* part = d.partial + (size_t)fb * d.part_total;
    if (j < nw) {
      part += ly.part_off + j;
      for (int k = 0; k < ly.splits; ++k) s += part[(size_t)k * nw];
    } else {
      part += ly.bpart_off + (j - nw);
      for (int k = 0; k < ly.bsplits; ++k) s += part[(size_t)k * ly.fout];
    }
  } else {
    const double* lp = d.lossp + (size_t)fb * d.loss_blocks;
    for (int k = 0; k < d.loss_blocks; ++k) s += lp[k];
  }
  out[(size_t)fb * (d.n_params + 1) + p] = (float)(s / mdiv);
}

template <int kX, int kCO>
void thin_fwd(const StreamDesc& d, int F, int n_fleet, cudaStream_t s) {
  stream_thin_fwd_kernel<kX, kCO>
      <<<dim3((F + kFB - 1) / kFB, d.np / 256, n_fleet), 128, 0, s>>>(d);
}

template <int kX, int kCO>
void thin_bwd(const StreamDesc& d, int F, int splits, int n_fleet,
              cudaStream_t s) {
  stream_thin_bwd_kernel<kX, kCO>
      <<<dim3((F + 1 + kFB - 1) / kFB, splits, n_fleet), kFB, 0, s>>>(d);
}

template <int kMode>
cudaError_t gemm(const StreamDesc& d, int l, dim3 grid, int S,
                 cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      stream_gemm_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGemmSmem);
  if (err != cudaSuccess) return err;
  stream_gemm_kernel<kMode><<<grid, kGThreads, kGemmSmem, s>>>(d, l, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The streamed form (ops/stream.py).  meta: n_layers, c_in, c_out,
// n_params, mask_width, np, rows_total, h_row, pp_row, n_pp, part_total,
// wp_total, t0, tl, loss_blocks, pack_blocks.  table: n_layers
// StreamLayer rows in device memory, `head` the same rows in host memory
// (the launches' shapes).  Scratch the caller allocates: scratch (B,
// rows_total, np), wp (B, wp_total), partial (B, part_total), lossp (B,
// loss_blocks) float64.  coords (B, c_in, n), values / weights (B, c_out, n),
// params (B, n_params), masks (B, mask_width) or null, thres (B,) or null
// (no override); out: (B, n_params + 1), the gradients in the packed
// parameter layout and the loss, divided by n * c_out.
int brief_fused_train_stream(const float* coords, const float* values,
                             const float* weights, const float* params,
                             const float* masks, const float* thres,
                             const void* table, const void* head,
                             float* scratch, float* wp, float* partial,
                             double* lossp, float* out, int n, int n_fleet,
                             const int* meta, int loss, float beta,
                             void* stream) {
  StreamDesc d;
  d.n_layers = meta[0];
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.n_params = meta[3];
  d.mask_width = meta[4];
  d.np = meta[5];
  d.rows_total = meta[6];
  d.h_row = meta[7];
  d.pp_row = meta[8];
  d.n_pp = meta[9];
  d.part_total = meta[10];
  d.wp_total = meta[11];
  d.t0 = meta[12];
  d.tl = meta[13];
  d.loss_blocks = meta[14];
  const int pack_blocks = meta[15];
  const int L = d.n_layers;
  if (L < 2 || table == nullptr || head == nullptr || n < 1 ||
      n_fleet < 1 || n_fleet > 65535 || d.np % 256 || d.np < n ||
      (d.t0 && d.c_in > kXMax - 1) || (d.tl && d.c_out > 8))
    return (int)cudaErrorInvalidValue;
  d.n = n;
  d.coords = coords;
  d.values = values;
  d.weights = weights;
  d.params = params;
  d.masks = masks;
  d.thres = thres;
  d.layer = static_cast<const StreamLayer*>(table);
  d.scratch = scratch;
  d.wp = wp;
  d.partial = partial;
  d.lossp = lossp;
  const StreamLayer* hl = static_cast<const StreamLayer*>(head);
  cudaStream_t s = (cudaStream_t)stream;
  const int kx = d.c_in + 1 <= 4 ? 4 : 8;
  const int kco = d.c_out <= 1 ? 1 : d.c_out <= 4 ? 4 : 8;
  const int fwd_cols = d.np / kGM;
  cudaError_t err = cudaSuccess;
#define BRIEF_THIN(fn, ...)                                        \
  switch (kx * 16 + kco) {                                         \
    case 4 * 16 + 1: fn<4, 1>(__VA_ARGS__); break;                 \
    case 4 * 16 + 4: fn<4, 4>(__VA_ARGS__); break;                 \
    case 4 * 16 + 8: fn<4, 8>(__VA_ARGS__); break;                 \
    case 8 * 16 + 1: fn<8, 1>(__VA_ARGS__); break;                 \
    case 8 * 16 + 4: fn<8, 4>(__VA_ARGS__); break;                 \
    default: fn<8, 8>(__VA_ARGS__);                                \
  }
#define BRIEF_CHECK(x)                          \
  do {                                          \
    err = (x);                                  \
    if (err != cudaSuccess) return (int)err;    \
  } while (0)
  auto prep = [&](int l) {
    stream_prep_kernel<<<dim3(d.np / 128, round_up(hl[l].fin, kGM) / 8,
                              n_fleet),
                         dim3(32, 8), 0, s>>>(d, l);
    return cudaGetLastError();
  };
  if (d.wp_total > 0) {
    stream_pack_kernel<<<dim3(pack_blocks, L, n_fleet), 256, 0, s>>>(d);
    BRIEF_CHECK(cudaGetLastError());
  }

  // ---- forward ----
  int h_holds = -1;   // the layer whose input H holds
  for (int l = 0; l < L; ++l) {
    if (l == 0 && d.t0) continue;
    if (l == L - 1 && d.tl) {
      BRIEF_THIN(thin_fwd, d, hl[l].fin, n_fleet, s);
      BRIEF_CHECK(cudaGetLastError());
      continue;
    }
    BRIEF_CHECK(prep(l));
    h_holds = l;
    BRIEF_CHECK(gemm<0>(d, l, dim3(hl[l].wp_cols / kGN, fwd_cols, n_fleet), 1,
                        s));
  }
  stream_loss_kernel<<<dim3(d.loss_blocks, n_fleet), 256, 0, s>>>(d, loss,
                                                                  beta);
  BRIEF_CHECK(cudaGetLastError());

  // ---- streamed: the backward
  if (d.tl) {
    BRIEF_THIN(thin_bwd, d, hl[L - 1].fin, hl[L - 1].splits, n_fleet, s);
    BRIEF_CHECK(cudaGetLastError());
  }
  for (int l = d.tl ? L - 2 : L - 1; l >= 0; --l) {
    if (l == 0 && d.t0) {
      if (L > 2 || !d.tl) {   // g_1 is in H: layer 0's dW and db
        stream_rowsum_kernel<true>
            <<<dim3((hl[0].fout + kFB - 1) / kFB, hl[0].splits, n_fleet), kFB,
               0, s>>>(d, 0, d.h_row, hl[0].fout);
        BRIEF_CHECK(cudaGetLastError());
      }
      continue;
    }
    if (h_holds != l) BRIEF_CHECK(prep(l));
    h_holds = -1;
    // ---- streamed: dW
    const int S = hl[l].splits;
    BRIEF_CHECK(gemm<2>(d, l,
                        dim3(hl[l].wp_cols / kGN,
                             round_up(hl[l].fin, kGM) / kGM, n_fleet * S),
                        S, s));
    stream_rowsum_kernel<false>
        <<<dim3((hl[l].fout + kFB - 1) / kFB, hl[l].bsplits, n_fleet), kFB,
           0, s>>>(d, l, hl[l].out_row, hl[l].fout);
    BRIEF_CHECK(cudaGetLastError());
    // ---- streamed: dW end
    if (l > 0)
      BRIEF_CHECK(gemm<1>(d, l,
                          dim3(round_up(hl[l].fin, kGN) / kGN, fwd_cols,
                               n_fleet),
                          1, s));
  }
  // ---- streamed: backward end
  // ---- streamed: the reduction
  stream_reduce_kernel<<<dim3((d.n_params + 256) / 256, n_fleet), 256, 0,
                         s>>>(d, out, (float)((double)n * d.c_out));
  // ---- streamed: end
#undef BRIEF_THIN
#undef BRIEF_CHECK
  return (int)cudaGetLastError();
}

}  // extern "C"
