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
// Three layouts (ops/fused_train.py choose_plan takes the first that fits):
//  * narrow (fused_train_kernel, e.g. 5 x 22, 3-7x4-1, the narrow φ
//    families): warp-owned coordinate tiles, the three products on the
//    tensor cores in 3xTF32; described below.
//  * tiled (fused_train_tiled_kernel, e.g. 3-64x6-1, 3-66x6-1, 5 x 64,
//    5 x 95): the weights once in shared memory in float32, a store of
//    every layer's activations for 32-128 coordinates, the three products
//    on the tensor cores in 3xTF32 (operands split as they are read),
//    groups of warps per m-tile, dW jobs in registers, a fleet's chains
//    sharing the grid by their work; described at its code.  Paced by
//    instruction issue, ~10 instructions an mma (the HiP-CT fleet at ~23%
//    of its float32 bound, PERF.md).
//  * wide (wide_tile_kernel + wide_dw_kernel, e.g. 3-191x4-1,
//    3-242x4-1, 3-128x6-1, [3]+[64]x23+[1]): the three products on the
//    tensor cores in 3xTF32, W split once into fragment-ordered packs and
//    streamed through a cp.async slab ring, a tile's activations in
//    shared memory, one z / g row set a layer in a device-memory scratch,
//    dW a split-K product over it; described at its code.  Chains past
//    its reach (a layer wider than 352 features) take the streamed
//    form, csrc/fused_train_stream.cu.
//
// The narrow layout (fused_train_kernel), for chains whose weights and a
// tile's activations fit in shared memory with 8 or more warps per SM:
//  * A block holds one or more groups of warps (5 x 22: two groups of 8).
//    Warp w of a group owns coordinates 16w .. 16w + 15 of the group's
//    tile and carries them through the forward, the loss and the input
//    gradients alone (__syncwarp between layers); the group meets at a
//    named barrier twice a tile, around dW; groups run out of step, so
//    one's barriers hide behind the other's work.  The grid is persistent.
//  * Every product is mma.sync.m16n8k8 TF32 on the tensor cores, in
//    3xTF32: x = big + small (split_tf32), a b = as bb + ab bs + ab bb,
//    which keeps float32 accuracy.  The forward [H, 1] [W; b] and the
//    input gradient G W^T take the warp's 16 coordinates as M; each
//    k-block's three products go out term by term across the n-tiles,
//    so consecutive mma are independent.  dW = [H, 1]^T G contracts over
//    the group's coordinates (K).
//  * Shared memory: W of every layer as (fin + 1, fout) with the bias as
//    row fin, and W^T, both split into big and small once per block and
//    stored in B-fragment order (one 16-byte load per lane and fragment,
//    no bank conflict), read in place from the caller's tensors (no
//    packed copy per call); then one activation store per group,
//    feature-major rows of 16 x warps + 4 floats: the coordinates and a
//    ones row, h_l with a ones row (the next layer's bias input), d_l,
//    which the backward overwrites with g_l in place, and the tile's
//    values and weights (loaded a tile ahead).  With that row stride every
//    fragment access (rows 2t + e by columns g, or rows g by columns t)
//    hits 32 distinct banks.  5 x 22: 230,208 bytes, 16 warps per SM.
//  * dW: each layer's (fin + 1) x fout gradient in 16 x 8 mma tiles, M
//    over fout or fin + 1 (fewest jobs); a job is up to kJobTiles tiles
//    of one M row, sharing its A operand; the jobs are dealt to the
//    group's warps, whose accumulators stay in registers for the whole
//    persistent loop; each group writes its own partial row once.  No
//    atomics: reduce_partials_kernel adds the rows in a fixed order, so
//    runs are bitwise equal.
//  * kSmall (every layer one n-tile wide, e.g. brain64's 3-7x4-1): blocks
//    of 8 warps, three to an SM (24 warps; at most 80 registers), one-tile
//    chunks and jobs, dW's three products in three accumulators.
// What bounds it on an H100: the tensor-core bound (3 x 2.388 GFLOP of
// products at 495 TFLOP/s TF32: 14.5 us at 5 x 22, N = 262,144) and the
// sines (0.577 GFLOP, 8.6 us at 67 TFLOP/s) are far below its time; it is
// bound by instruction throughput (the sine epilogues, the TF32 splits,
// fragment loads and stores) at 16 warps per SM, whose registers (128 a
// thread) and shared memory (the store) leave no room for more.  Chains
// whose weights and store do not fit with 8 warps per SM take the tiled
// layout (faster there than the old one-thread-per-coordinate layout,
// PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "tf32.cuh"
#include "wide.cuh"

namespace {

using brief::ld_row;
using brief::ld_use;

// This block's row of partial sums (gradients, then the loss) in the
// (B, gridDim.x, n_params + 1) scratch.
__device__ __forceinline__ float* partial_row(float* partial, int fb,
                                              int n_params) {
  return partial +
         ((size_t)fb * gridDim.x + blockIdx.x) * (size_t)(n_params + 1);
}

using brief::loss_grad;   // csrc/chain.cuh

// 3xTF32 on mma.sync.m16n8k8: csrc/tf32.cuh
using brief::mma_tf32;
using brief::pack_b;
using brief::split_tf32;

// ---------------------------------------------------------------------------
// The narrow layout (ops/fused_train.py plan).
// ---------------------------------------------------------------------------
constexpr int kNarrowMaxWarps = 16;
constexpr int kSmallWarps = 8;     // the small instance: 3 blocks of 8 per SM
constexpr int kChunkNT = 4;        // output n-tiles per pass of a product
constexpr int kMaxStage = 8;       // staged input floats per lane and tile
constexpr int kJobTiles = 3;       // dW n-tiles of one job (one A row)
constexpr int kMaxJobs = 4;        // dW jobs per warp

// Layer l's row of the narrow layout's table (ops/fused_train.py
// narrow_table).
struct __align__(16) NarrowLayer {
  // W (B, fin, fout), b (B, fout) and the unit mask (B, fout) or null, as
  // the caller holds them (no packed copy per call)
  const float* w;
  const float* b;
  const float* m;
  int fin, fout, act, p_off;
  // forward B fragments: wf_off, kb x nt of them; input-gradient ones
  // (W^T, layers >= 1): wb_off, kbb x ntb
  int wf_off, kb, nt, wb_off, kbb, ntb;
  // store rows: the layer's input (fin + 1 rows, the last a ones row), its
  // h (fout + 1 rows; -1 for the last layer), its d / g (fout rows)
  int x_row, h_row, g_row;
  int mask_off;    // in the block's copy of the masks (-1: none)
  // dW tiles: 1 when M is over fout (A = g, B = [h; 1]), else M over
  // fin + 1
  int dw_gmajor;
  float w0;
};
static_assert(sizeof(NarrowLayer) == 96, "ops/fused_train.py NARROW_ROW_WORDS");

struct NarrowDesc {
  int n_layers, c_in, c_out, n_params, stride, act_off, red_off;
  // groups of warps per block, each with its own store of `rows` rows;
  // the values' and weights' rows; the masks' copy
  int groups, rows, yw_row, mask_sm;
  const NarrowLayer* layer;   // n_layers rows, device memory
  NarrowLayer head[brief::kParamLayers];   // the first rows again
  // dW jobs of warp w of a group: job[kMaxJobs * w + s], coded
  // layer << 24 | m-tile << 16 | first n-tile << 8 | n-tiles (-1: none)
  int job[kMaxJobs * kNarrowMaxWarps];
};

// Field f of layer l, and its whole row (csrc/chain.cuh layer_field,
// layer_row)
template <bool kDeep, class T>
__device__ __forceinline__ T nf(const NarrowDesc& d, int l,
                                T NarrowLayer::*f) {
  return brief::layer_field<kDeep>(d.layer, d.head, l, f);
}

template <bool kDeep>
__device__ __forceinline__ NarrowLayer nrow(const NarrowDesc& d, int l) {
  return brief::layer_row<kDeep>(d.layer, d.head, l);
}

// Every layer's W as B fragments, big and small (float4 per lane):
//  forward (kb, nt): lane 4g + t holds W'[8kb + 2t][8nt + g] and
//    W'[8kb + 2t + 1][8nt + g], W' = [W; b] ((fin + 1) x fout, zeros past);
//  input gradient (kb, nt), layers >= 1: W[8nt + g][8kb + 2t] and
//    W[8nt + g][8kb + 2t + 1] (zeros past fin x fout).
// The A fragments pair the same features (rows 2t and 2t + 1 of a k-block).
// Chain fb's W'[i][o]: W[i][o] for i < fin, b[o] for i == fin.
template <bool kDeep>
__device__ __forceinline__ void pack_narrow_weights(const NarrowDesc& d,
                                                    int fb, float* sm) {
  for (int l = 0; l < d.n_layers; ++l) {
    const NarrowLayer ly = nrow<kDeep>(d, l);
    const int fin = ly.fin, fout = ly.fout, nt = ly.nt;
    const float* W = ly.w + (size_t)fb * fin * fout;
    const float* bias = ly.b + (size_t)fb * fout;
    auto wv = [&](int i, int o) {
      return i < fin ? __ldg(W + i * fout + o) : __ldg(bias + o);
    };
    float4* wf = reinterpret_cast<float4*>(sm + ly.wf_off);
    for (int e = threadIdx.x; e < ly.kb * nt * 32; e += blockDim.x) {
      const int ln = e & 31, frag = e >> 5, kb = frag / nt;
      const int i = 8 * kb + 2 * (ln & 3);
      const int o = 8 * (frag - kb * nt) + (ln >> 2);
      const bool ok = o < fout;
      wf[e] = pack_b(ok && i <= fin ? wv(i, o) : 0.f,
                     ok && i + 1 <= fin ? wv(i + 1, o) : 0.f);
    }
    if (l == 0) continue;
    const int ntb = ly.ntb;
    float4* wb = reinterpret_cast<float4*>(sm + ly.wb_off);
    for (int e = threadIdx.x; e < ly.kbb * ntb * 32; e += blockDim.x) {
      const int ln = e & 31, frag = e >> 5, kb = frag / ntb;
      const int o = 8 * kb + 2 * (ln & 3);
      const int i = 8 * (frag - kb * ntb) + (ln >> 2);
      const bool ok = i < fin;
      wb[e] = pack_b(ok && o < fout ? wv(i, o) : 0.f,
                     ok && o + 1 < fout ? wv(i, o + 1) : 0.f);
    }
  }
}

// A fragment of rows [row0, row0 + nrows) of the store (features; the
// k-block's pairs 2t, 2t + 1 = f0, f0 + 1) x columns col, col + 8
// (coordinates g, g + 8 of the warp), split; rows past nrows read 0.
__device__ __forceinline__ void load_a(const float* A, int S, int row0,
                                       int nrows, int f0, int col,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  const float* p = A + (row0 + f0) * S + col;
  const float v0 = f0 < nrows ? p[0] : 0.f;
  const float v1 = f0 < nrows ? p[8] : 0.f;
  const float v2 = f0 + 1 < nrows ? p[S] : 0.f;
  const float v3 = f0 + 1 < nrows ? p[S + 8] : 0.f;
  split_tf32(v0, &ab[0], &as[0]);
  split_tf32(v1, &ab[1], &as[1]);
  split_tf32(v2, &ab[2], &as[2]);
  split_tf32(v3, &ab[3], &as[3]);
}

// C = the warp's 16 coordinates' rows [row0, row0 + nrows) (A, over
// k-blocks of 8) times the packed B fragments wf (KB x NT), output n-tiles
// nt0 .. nt0 + kN - 1.  The three products of each k-block go out term by
// term across the n-tiles, so the mma that follow one another are
// independent (one accumulator's chain would stall on each).
template <int kN, int kC>
__device__ __forceinline__ void product_n(float (&c)[kC][4],
                                          const float* A, int S, int row0,
                                          int nrows, int col, const float* wf,
                                          int KB, int NT, int nt0, int lane,
                                          int t) {
  // below 3 n-tiles the cross terms go to a second accumulator, so that
  // the chains stay at least 3 deep
  constexpr int kX = kN < 3 ? kN : 1;
  float c2[kX][4];
#pragma unroll
  for (int j = 0; j < kC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kX; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c2[j][e] = 0.f;
  for (int kb = 0; kb < KB; ++kb) {
    uint32_t ab[4], as[4];
    load_a(A, S, row0, nrows, 8 * kb + 2 * t, col, ab, as);
    float4 w[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j)
      w[j] = reinterpret_cast<const float4*>(
          wf)[(kb * NT + nt0 + j) * 32 + lane];
    if (kN < 3) {
#pragma unroll
      for (int j = 0; j < kN; ++j)
        mma_tf32(c2[j % kX], as, __float_as_uint(w[j].x),
                 __float_as_uint(w[j].y));
#pragma unroll
      for (int j = 0; j < kN; ++j)
        mma_tf32(c[j], ab, __float_as_uint(w[j].x), __float_as_uint(w[j].y));
#pragma unroll
      for (int j = 0; j < kN; ++j)
        mma_tf32(c2[j % kX], ab, __float_as_uint(w[j].z),
                 __float_as_uint(w[j].w));
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j)
        mma_tf32(c[j], as, __float_as_uint(w[j].x), __float_as_uint(w[j].y));
#pragma unroll
      for (int j = 0; j < kN; ++j)
        mma_tf32(c[j], ab, __float_as_uint(w[j].z), __float_as_uint(w[j].w));
#pragma unroll
      for (int j = 0; j < kN; ++j)
        mma_tf32(c[j], ab, __float_as_uint(w[j].x), __float_as_uint(w[j].y));
    }
  }
  if (kN < 3) {
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += c2[j % kX][e];
  }
}

// product_n for the n-tiles nt0 .. min(NT, nt0 + kC) - 1
template <int kC>
__device__ __forceinline__ void product_chunk(float (&c)[kC][4],
                                              const float* A, int S, int row0,
                                              int nrows, int col,
                                              const float* wf, int KB, int NT,
                                              int nt0, int lane, int t) {
  if (kC == 1) {
    product_n<1, kC>(c, A, S, row0, nrows, col, wf, KB, NT, nt0, lane, t);
    return;
  }
  switch (min(NT - nt0, kC)) {
    case 1:
      product_n<1, kC>(c, A, S, row0, nrows, col, wf, KB, NT, nt0, lane, t);
      break;
    case 2:
      product_n<2, kC>(c, A, S, row0, nrows, col, wf, KB, NT, nt0, lane, t);
      break;
    case 3:
      product_n<3, kC>(c, A, S, row0, nrows, col, wf, KB, NT, nt0, lane, t);
      break;
    default:
      product_n<(kC < 4 ? kC : 4), kC>(c, A, S, row0, nrows, col, wf, KB, NT,
                                       nt0, lane, t);
  }
}

// A hidden layer's epilogue on a chunk of accumulators: h = act(z) and
// d = act'(z) times the unit mask into rows hr + o and gr + o, the ones
// row hr + fout; the activation fixed at compile time.  Branch-free within
// an n-tile (the stores predicated), so its four evaluations interleave.
template <int kAct, int kC>
__device__ __forceinline__ void hidden_epilogue(
    const float (&c)[kC][4], int nt0, int NT, float w0, int fout,
    const float* ml, float* A, int S, int hr, int gr, int col, int t) {
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    if (nt0 + j < NT) {
      float h[4], dv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        brief::act_fwd(kAct, w0, c[j][e], &h[e], &dv[e]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 8 * (nt0 + j) + 2 * t + (e & 1);
        const int u = col + 8 * (e >> 1);
        float mo = o < fout ? 1.f : 0.f;
        if (ml != nullptr && o < fout) mo = ml[o];
        const float hv = o == fout ? 1.f : h[e] * mo;
        if (o <= fout) A[(hr + o) * S + u] = hv;
        if (o < fout) A[(gr + o) * S + u] = dv[e] * mo;
      }
    }
  }
}

// A dW job: the m-tile m of a layer's dW and its n-tiles n0 .. n0 + cnt - 1,
// sharing the A operand; A rows [ar, ar + an) (M), B rows [br, br + bn)
// (N) of the store.
struct DwJob {
  int l, m, n0, cnt, ar, an, br, bn;
};

template <bool kDeep>
__device__ __forceinline__ DwJob dw_job(const NarrowDesc& d, int code) {
  DwJob w;
  w.l = code >> 24;
  w.m = (code >> 16) & 0xff;
  w.n0 = (code >> 8) & 0xff;
  w.cnt = code & 0xff;
  const NarrowLayer ly = nrow<kDeep>(d, w.l);
  const int hr = ly.x_row, hn = ly.fin + 1;
  const int gr = ly.g_row, gn = ly.fout;
  if (ly.dw_gmajor) {
    w.ar = gr, w.an = gn, w.br = hr, w.bn = hn;
  } else {
    w.ar = hr, w.an = hn, w.br = gr, w.bn = gn;
  }
  return w;
}

// A global load that stays where it stands: the tile-ahead prefetch
// must not be sunk to its use a tile later.
__device__ __forceinline__ float load_early(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Grid (blocks per chain, B), 32 * NW threads (NW <= kNarrowMaxWarps) in
// d.groups groups of warps; kJobs dW jobs per warp at most.  Group q of
// block b is the virtual block b * groups + q: it walks tiles of 16 x its
// warps coordinates, with its own store, its own named barrier (1 + q)
// and its own row of partial sums.
template <int kJobs, bool kSmall, bool kDeep>
__global__ void __launch_bounds__(kSmall ? 32 * kSmallWarps
                                         : 32 * kNarrowMaxWarps,
                                  kSmall ? 3 : 1) fused_train_kernel(
    const float* __restrict__ coords, const float* __restrict__ values,
    const float* __restrict__ weights, float* __restrict__ partial, int n,
    NarrowDesc d, int loss, float beta, const float* __restrict__ thres) {
  // kSmall: every layer one n-tile wide (f + 1 <= 8, e.g. brain64's
  // 3-7x4-1): one-tile chunks and jobs, blocks of at most kSmallWarps
  // warps and at most 80 registers a thread: three blocks share an SM
  constexpr int kC = kSmall ? 1 : kChunkNT;
  constexpr int kJT = kSmall ? 1 : kJobTiles;
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = d.groups, NWg = (blockDim.x >> 5) / G;
  const int grp = warp / NWg, wg = warp - grp * NWg;
  const int g = lane >> 2, t = lane & 3;
  const int S = d.stride, L = d.n_layers, BT = 16 * NWg, u0 = 16 * wg;
  const int fb = blockIdx.y, c_in = d.c_in, c_out = d.c_out;
  coords += (size_t)fb * c_in * n;
  values += (size_t)fb * c_out * n;
  weights += (size_t)fb * c_out * n;
  const bool thr_on = thres != nullptr;
  const float thr = thr_on ? thres[fb] : 0.f;
  float* A = sm + d.act_off + grp * d.rows * S;   // this group's store
  float* msk = sm + d.mask_sm;

  pack_narrow_weights<kDeep>(d, fb, sm);
  for (int l = 0; l < L; ++l) {   // this chain's unit masks, side by side
    const NarrowLayer ly = nrow<kDeep>(d, l);
    if (ly.mask_off < 0) continue;
    for (int e = threadIdx.x; e < ly.fout; e += blockDim.x)
      msk[ly.mask_off + e] = ly.m[(size_t)fb * ly.fout + e];
  }
  // dW jobs: the A rows' and first B rows' store offsets of each
  int pa_off[kJobs], pb_off[kJobs], cnt[kJobs];
  bool a_lo[kJobs], a_hi[kJobs], b_ok[kJobs][kJT];
#pragma unroll
  for (int s = 0; s < kJobs; ++s) {
    const int code = d.job[kMaxJobs * wg + s];
    cnt[s] = 0;
    a_lo[s] = a_hi[s] = false;
    pa_off[s] = pb_off[s] = 0;
#pragma unroll
    for (int k = 0; k < kJT; ++k) b_ok[s][k] = false;
    if (code >= 0) {
      const DwJob w = dw_job<kDeep>(d, code);
      const int ra = 16 * w.m + g, rb = 8 * w.n0 + g;
      cnt[s] = w.cnt;
      a_lo[s] = ra < w.an;
      a_hi[s] = ra + 8 < w.an;
#pragma unroll
      for (int k = 0; k < kJT; ++k)
        b_ok[s][k] = k < w.cnt && rb + 8 * k < w.bn;
      pa_off[s] = (w.ar + ra) * S + t;
      pb_off[s] = (w.br + rb) * S + t;
    }
  }
  // dW: the three products in one sum, or (kSmall, one tile a job) in
  // three, summed at the end, so that no chain of dependent mma is longer
  // than the group's k-steps
  constexpr int kT = kSmall ? 3 : 1;
  float acc[kT][kJobs][kJT][4];
#pragma unroll
  for (int q = 0; q < kT; ++q)
#pragma unroll
    for (int s = 0; s < kJobs; ++s)
#pragma unroll
      for (int k = 0; k < kJT; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][s][k][e] = 0.f;
  float loss_acc = 0.f;
  __syncthreads();

  // inputs of a tile, staged a tile ahead: coordinates, values, weights of
  // the warp's 16 coordinates (channel e >> 4, coordinate e & 15)
  const int n_stage = 16 * (c_in + 2 * c_out);
  float st[kMaxStage];
  auto fetch = [&](int base) {
#pragma unroll
    for (int k = 0; k < kMaxStage; ++k) {
      const int e = lane + 32 * k, ch = e >> 4, idx = base + (e & 15);
      const float* src =
          ch < c_in ? coords + (size_t)ch * n
          : ch < c_in + c_out ? values + (size_t)(ch - c_in) * n
          : weights + (size_t)(ch - c_in - c_out) * n;
      st[k] = e < n_stage && idx < n ? load_early(src + idx) : 0.f;
    }
  };
  const int n_tiles = (n + BT - 1) / BT;
  const int vb = blockIdx.x * G + grp, n_vb = gridDim.x * G;
  const int bar = 1 + grp, bar_threads = 32 * NWg;
  if (vb < n_tiles) fetch(vb * BT + u0);
  for (int tile = vb; tile < n_tiles; tile += n_vb) {
    const int base = tile * BT + u0;   // the warp's first coordinate
    const int x0 = nf<kDeep>(d, 0, &NarrowLayer::x_row);   // coordinates
#pragma unroll
    for (int k = 0; k < kMaxStage; ++k) {
      const int e = lane + 32 * k, ch = e >> 4;
      if (e < n_stage) {
        const int row = ch < c_in ? x0 + ch : d.yw_row + ch - c_in;
        A[row * S + u0 + (e & 15)] = st[k];
      }
    }
    if (lane < 16) A[(x0 + c_in) * S + u0 + lane] = 1.f;
    if (tile + n_vb < n_tiles) fetch(base + n_vb * BT);
    __syncwarp();

    // ---- forward: Z = [H, 1] W' per layer; h (with its ones row) and d
    // into the store; the last layer's loss and dL/dz into its g rows ----
    for (int l = 0; l < L - 1; ++l) {
      const int fout = nf<kDeep>(d, l, &NarrowLayer::fout);
      const int NT = nf<kDeep>(d, l, &NarrowLayer::nt);
      const int act = nf<kDeep>(d, l, &NarrowLayer::act);
      const float w0 = nf<kDeep>(d, l, &NarrowLayer::w0);
      const float* wf = sm + nf<kDeep>(d, l, &NarrowLayer::wf_off);
      const int mo = nf<kDeep>(d, l, &NarrowLayer::mask_off);
      const float* ml = mo < 0 ? nullptr : msk + mo;
      const int hr = nf<kDeep>(d, l, &NarrowLayer::h_row);
      const int gr = nf<kDeep>(d, l, &NarrowLayer::g_row);
      for (int nt0 = 0; nt0 < NT; nt0 += kC) {
        float c[kC][4];
        product_chunk(c, A, S, nf<kDeep>(d, l, &NarrowLayer::x_row),
                      nf<kDeep>(d, l, &NarrowLayer::fin) + 1, u0 + g, wf,
                      nf<kDeep>(d, l, &NarrowLayer::kb), NT, nt0, lane, t);
        switch (act) {
          case brief::kActSine:
            hidden_epilogue<brief::kActSine, kC>(c, nt0, NT, w0, fout, ml, A, S,
                                             hr, gr, u0 + g, t);
            break;
          case brief::kActRelu:
            hidden_epilogue<brief::kActRelu, kC>(c, nt0, NT, w0, fout, ml, A, S,
                                             hr, gr, u0 + g, t);
            break;
          case brief::kActSigmoid:
            hidden_epilogue<brief::kActSigmoid, kC>(c, nt0, NT, w0, fout, ml, A,
                                                S, hr, gr, u0 + g, t);
            break;
          default:
            hidden_epilogue<brief::kActNone, kC>(c, nt0, NT, w0, fout, ml, A, S,
                                             hr, gr, u0 + g, t);
        }
      }
      __syncwarp();
    }
    {
      const int l = L - 1;
      const int NT = nf<kDeep>(d, l, &NarrowLayer::nt);
      const int gr = nf<kDeep>(d, l, &NarrowLayer::g_row);
      const int act = nf<kDeep>(d, l, &NarrowLayer::act);
      const float w0 = nf<kDeep>(d, l, &NarrowLayer::w0);
      const int mo = nf<kDeep>(d, l, &NarrowLayer::mask_off);
      const float* ml = mo < 0 ? nullptr : msk + mo;
      for (int nt0 = 0; nt0 < NT; nt0 += kC) {
        float c[kC][4];
        product_chunk(c, A, S, nf<kDeep>(d, l, &NarrowLayer::x_row),
                      nf<kDeep>(d, l, &NarrowLayer::fin) + 1, u0 + g,
                      sm + nf<kDeep>(d, l, &NarrowLayer::wf_off),
                      nf<kDeep>(d, l, &NarrowLayer::kb), NT, nt0, lane, t);
#pragma unroll
        for (int j = 0; j < kC; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = 8 * (nt0 + j) + 2 * t + (e & 1);
            const int u = u0 + g + 8 * (e >> 1);
            float gv = 0.f;
            if (nt0 + j < NT && o < c_out) {
              float h, dv;
              brief::act_fwd(act, w0, c[j][e], &h, &dv);
              if (ml != nullptr) {
                h *= ml[o];
                dv *= ml[o];
              }
              const bool valid = base + g + 8 * (e >> 1) < n;
              gv = loss_grad(loss, beta, thr_on, thr, h,
                             A[(d.yw_row + o) * S + u],
                             A[(d.yw_row + c_out + o) * S + u], valid, dv,
                             &loss_acc);
              A[(gr + o) * S + u] = gv;
            }
          }
        }
      }
      __syncwarp();
    }

    // ---- input gradients: g_{l-1} = (g_l W_l^T) * d_{l-1}, in place ----
    for (int l = L - 1; l >= 1; --l) {
      const int fin = nf<kDeep>(d, l, &NarrowLayer::fin);
      const int NT = nf<kDeep>(d, l, &NarrowLayer::ntb);
      const int dr = nf<kDeep>(d, l - 1, &NarrowLayer::g_row);
      for (int nt0 = 0; nt0 < NT; nt0 += kC) {
        float c[kC][4];
        product_chunk(c, A, S, nf<kDeep>(d, l, &NarrowLayer::g_row),
                      nf<kDeep>(d, l, &NarrowLayer::fout), u0 + g,
                      sm + nf<kDeep>(d, l, &NarrowLayer::wb_off),
                      nf<kDeep>(d, l, &NarrowLayer::kbb), NT, nt0, lane, t);
        // rows past fin stay inside the store (g_{l-1} is never its last
        // region): read them, write only the layer's own
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          if (nt0 + j < NT) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 8 * (nt0 + j) + 2 * t + (e & 1);
              float* p = A + (dr + i) * S + u0 + g + 8 * (e >> 1);
              const float v = c[j][e] * *p;
              if (i < fin) *p = v;
            }
          }
        }
      }
      __syncwarp();
    }
    group_sync(bar, bar_threads);   // the group's h and g are in its store

    // ---- dW over the group's 16 * NWg coordinates, into the jobs (all
    // kJT tiles of a job computed, B zero past its own, so the mma
    // go out term by term across independent accumulators) ----
    for (int k0 = 0; k0 < BT; k0 += 8) {
#pragma unroll
      for (int s = 0; s < kJobs; ++s) {
        if (cnt[s] > 0) {   // warp-uniform
          const float* pa = A + pa_off[s] + k0;
          uint32_t ab[4], as[4], bb[kJT][2], bs[kJT][2];
          split_tf32(a_lo[s] ? pa[0] : 0.f, &ab[0], &as[0]);
          split_tf32(a_hi[s] ? pa[8 * S] : 0.f, &ab[1], &as[1]);
          split_tf32(a_lo[s] ? pa[4] : 0.f, &ab[2], &as[2]);
          split_tf32(a_hi[s] ? pa[8 * S + 4] : 0.f, &ab[3], &as[3]);
#pragma unroll
          for (int k = 0; k < kJT; ++k) {
            const float* pb = A + pb_off[s] + 8 * k * S + k0;
            split_tf32(b_ok[s][k] ? pb[0] : 0.f, &bb[k][0], &bs[k][0]);
            split_tf32(b_ok[s][k] ? pb[4] : 0.f, &bb[k][1], &bs[k][1]);
          }
#pragma unroll
          for (int k = 0; k < kJT; ++k)
            mma_tf32(acc[kT - 1][s][k], as, bb[k][0], bb[k][1]);
#pragma unroll
          for (int k = 0; k < kJT; ++k)
            mma_tf32(acc[kT / 2][s][k], ab, bs[k][0], bs[k][1]);
#pragma unroll
          for (int k = 0; k < kJT; ++k)
            mma_tf32(acc[0][s][k], ab, bb[k][0], bb[k][1]);
        }
      }
    }
    group_sync(bar, bar_threads);   // before the next tile overwrites it
  }

  // ---- this group's partial sums: each dW entry from its one job ----
  float* out = partial + ((size_t)(fb * gridDim.x + blockIdx.x) * G + grp) *
                             (size_t)(d.n_params + 1);
#pragma unroll
  for (int s = 0; s < kJobs; ++s) {
    const int code = d.job[kMaxJobs * wg + s];
    if (code >= 0) {
      const DwJob w = dw_job<kDeep>(d, code);
      const NarrowLayer ly = nrow<kDeep>(d, w.l);
      const int fin = ly.fin, fout = ly.fout;
#pragma unroll
      for (int k = 0; k < kJT; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * w.m + g + 8 * (e >> 1);
          const int q = 8 * (w.n0 + k) + 2 * t + (e & 1);
          const int i = ly.dw_gmajor ? q : r;
          const int o = ly.dw_gmajor ? r : q;
          if (k < w.cnt && i <= fin && o < fout)
            out[ly.p_off + i * fout + o] =
                kSmall ? acc[0][s][k][e] + (acc[1][s][k][e] +
                                            acc[kT - 1][s][k][e])
                       : acc[0][s][k][e];
        }
      }
    }
  }
  // the loss: lanes by shuffles, the group's warps in order
  for (int s = 16; s > 0; s >>= 1)
    loss_acc += __shfl_xor_sync(0xffffffffu, loss_acc, s);
  float* red = sm + d.red_off;
  if (lane == 0) red[warp] = loss_acc;
  __syncthreads();
  if (wg == 0 && lane == 0) {
    float sum = 0.f;
    for (int w = 0; w < NWg; ++w) sum += red[grp * NWg + w];
    out[d.n_params] = sum;
  }
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
// The tiled layout (ops/fused_train.py tiled_plan): for chains whose
// weights and a tile's activations fit in shared memory once, but whose
// W and W^T, split into TF32 big and small parts, do not fit beside a
// store for 8 or more warps (the narrow layout): 3-66x6-1 has ~22,000
// weights, 4 x 88 KB split both ways.  A kernel of its own.
//
// Design, with the numbers of 3-66x6-1 (the hipct.yaml fleet's bucket):
//  * Every product on the tensor cores, mma.sync.m16n8k8 TF32 in 3xTF32
//    (csrc/tf32.cuh split_tf32_nearest, both parts rounded to TF32): a b =
//    as bb + ab bs + ab bb.  Each k-block's three products are summed from
//    zero and added to a float32 accumulator (csrc/chain_tc.cuh's sums):
//    mma.sync truncates its own sums, which dW over 100,000 coordinates
//    would otherwise carry.  With the small parts truncated instead
//    (split_tf32) a 20-layer fleet drifted 2.3x the plain version's mean
//    distance from float64.
//  * W of every layer once, float32, (fin + 1) x fout with the bias as row
//    0, row stride 4 mod 8 (68 at 66 outputs): 93.4 KB.  A B fragment is
//    split as it is read.  The forward reads W with K paired (features
//    2t, 2t + 1 of a k-block, as the narrow layout), the input gradient
//    reads the same rows along o with K in the plain order (W^T without a
//    copy); with that stride both reads hit 32 banks.  A padded k-block or
//    n-tile reads the next layer's rows (finite weights times zero
//    activations) or output columns it drops.
//  * Activations: a store of rows of 16 x mt coordinates (mt m-tiles a
//    tile; 32 coordinates at 3-66x6-1, 113.7 KB): two input buffers
//    (a ones row and the coordinates, values and weights; the next tile's
//    copied in by cp.async while this one runs), then per layer h (after
//    a ones row, the next layer's bias input) and d, overwritten by g in
//    the backward.  Regions start on rows multiple of 8; coordinate u of
//    row r sits at column u ^ 4 pi(r & 7) (tiled_at), which puts every
//    fragment access on 32 banks without padding the rows.
//  * Work: each layer's output is mt x nt mma tiles (16 coordinates x 8
//    units); warp w takes m-tile w % mt and every (8 / mt)-th n-tile from
//    w / mt, in chunks of kTiledChunk sharing one A fragment.  A width of
//    66 is 9 n-tiles: 18 tiles for 8 warps, 5, 5, 4, 4 on the SM's four
//    schedulers, not a second pass over a layer.
//  * A fleet's padding: the units past a chain's last unmasked one
//    (tiled_width, from its unit masks) are exactly 0, so its products
//    stop at its own k-blocks and n-tiles (the ones row first keeps the
//    bias inside them), and tiled_share_kernel gives each chain a share
//    of the grid by its work (51/54/60/66: 0.74 of the padded products).
//  * Barriers: a coordinate's activations take 880 store rows at
//    3-66x6-1, so the block holds 32 coordinates, fewer than one m-tile a
//    warp.  The warps of one m-tile (a group: 8 / mt warps) carry it
//    through the forward and the input gradients alone and meet at their
//    own named barrier after each layer (2L - 2 a tile, 12 at 7 layers;
//    the two groups run out of step); the block meets twice a tile,
//    before dW (which reads every coordinate) and after it (before the
//    next tile overwrites the store).
//  * dW: layer l's (fin + 1) x fout gradient in 16 x 8 mma tiles (M over
//    fout or fin + 1, whichever gives fewer jobs; ops/fused_train.py
//    tiled_jobs), in jobs of kTiledJob tiles of one row sharing its A
//    fragment, kJ jobs a warp (dw_map; 81 jobs, 11 a warp, at 3-66x6-1;
//    instances 3, 6, 9, 11, 13: 13 is 156 registers of sums, all 255
//    used and none spilled),
//    every job computed (no branch, so their mma chains interleave), each
//    sum in registers for the whole persistent loop.  Each block writes
//    its partial row once; no atomics: reduce_spans_kernel adds a chain's
//    rows in a fixed order, so runs are bitwise equal.
// What bounds it on an H100 at the HiP-CT fleet (4 x 100,000 coordinates,
// true widths 51/54/60/66): the three products, 3 x 33.5 GFLOP at 495
// TFLOP/s TF32 (0.20 ms; mma.sync delivers ~310, scripts/mma_tf32_rate.py)
// and the sines, 2.9 GFLOP at 67 TFLOP/s (0.04 ms).  Beside each mma it
// issues the operands' shared reads and splits and the float32 sums (~10
// instructions an mma), and the epilogues' sines: instruction issue, not
// the tensor cores, paces it (PERF.md).
// ---------------------------------------------------------------------------
constexpr int kTiledWarps = 8;
constexpr int kTiledThreads = 32 * kTiledWarps;
constexpr int kTiledChunk = 3;         // n-tiles of one pass of a product
constexpr int kTiledJob = 3;           // dW tiles of one job (one A row)
constexpr int kTiledDwWeight = 3;      // a dW job's work against a product
                                       // tile's, per tile (tiled_share)
constexpr unsigned kTiledPi = 0x56127430u;   // pi(r & 7), a nibble each
                                             // (ops/fused_train.py TILED_PI)

using brief::mma_tf32_zero;
using brief::split_tf32_nearest;

// Layer l's row of the tiled layout's table (ops/fused_train.py
// tiled_table): widths, activation, offset in the packed parameters, its
// W in shared memory (offset, row stride; the bias as row 0), its store
// rows (input, whose row 0 holds ones; h, -1 for the last layer, its
// units from row 1; d / g), its unit mask's offset in the chain's mask
// row (-1: none), w0, and x_in: the input is the tile's input buffer
// (layer 0), whose rows move with the tile.
struct __align__(16) TiledLayer {
  int fin, fout, act, p_off, w_off, w_stride, x_row, h_row, g_row, mask_off;
  float w0;
  int x_in;
};
static_assert(sizeof(TiledLayer) == 48, "ops/fused_train.py TILED_ROW_WORDS");

struct TiledDesc {
  int n_layers, c_in, c_out, n_params, mask_width, n_fleet, n_tiles;
  int mt;          // m-tiles a tile: 16 mt coordinates, rows of 16 mt floats
  int buf_rows;    // rows of one input buffer; values from its row yw_row
  int yw_row, w_floats, mask_sm, tab_sm, width_sm, desc_sm, red_off, jobs;
  // n_layers rows in device memory (copied to shared memory at tab_sm),
  // then per warp and job slot (jobs a warp) two dW codes
  // (ops/fused_train.py dw_codes)
  const TiledLayer* layer;
};

// 4 pi(r & 7): the column permutation of store row r
__device__ __forceinline__ int tiled_sigma(int r) {
  return (int)((kTiledPi >> (4 * (r & 7))) & 7u) << 2;
}

// Float offset of coordinate u of store row r (ops/fused_train.py
// swizzle), rows of T floats.
__device__ __forceinline__ int tiled_at(int r, int u, int T) {
  return r * T + (u ^ tiled_sigma(r));
}

// cp.async of one float, zero-filled where !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

// A layer's width in chain fb as the products see it: one past its last
// unit whose mask is not 0 (the units past it carry exact zeros), or
// fout unmasked.  One warp; every lane gets it.
__device__ __forceinline__ int tiled_width(const float* masks,
                                           int mask_width, int fb,
                                           const TiledLayer& ly, int lane) {
  if (masks == nullptr || ly.mask_off < 0) return ly.fout;
  const float* m = masks + (size_t)fb * mask_width + ly.mask_off;
  int last = 0;
  for (int o = lane; o < ly.fout; o += 32)
    if (m[o] != 0.f) last = o + 1;
  return __reduce_max_sync(0xffffffffu, last);
}

// Chain fb's products per tile, in (k-block, n-tile) pairs, plus its dW
// jobs at kTiledDwWeight each: the work tiled_share_kernel shares the
// grid by.  widths[l]: the layers' tiled_width.
__device__ __forceinline__ int tiled_work(const TiledDesc& d,
                                          const int* widths, int jobs) {
  int w = kTiledDwWeight * jobs * kTiledWarps, fin = d.c_in;
  for (int l = 0; l < d.n_layers; ++l) {
    const int fout = widths[l];
    w += ((fin + 8) >> 3) * ((fout + 7) >> 3);            // forward
    if (l > 0) w += ((fout + 7) >> 3) * ((fin + 7) >> 3);  // input grad
    fin = fout;
  }
  return w;
}

// One block of kTiledThreads: each chain's work (tiled_work), then the
// grid's `blocks` shared among the chains by it, each at least one and
// at most n_tiles: span[2 c] = chain c's first block, span[2 c + 1] its
// blocks (blocks past the last chain's run idle).  Deterministic, so
// every launch on the same masks makes the same shares.
__global__ void __launch_bounds__(kTiledThreads) tiled_share_kernel(
    TiledDesc d, const float* __restrict__ masks, int blocks,
    int* __restrict__ span) {
  extern __shared__ int widths[];     // n_layers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = 0; c < d.n_fleet; ++c) {
    for (int l = warp; l < d.n_layers; l += kTiledWarps) {
      const int w = tiled_width(masks, d.mask_width, c, ld_row(d.layer + l),
                                lane);
      if (lane == 0) widths[l] = w;
    }
    __syncthreads();
    if (threadIdx.x == 0) span[2 * c] = tiled_work(d, widths, d.jobs);
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  long long total = 0;
  for (int c = 0; c < d.n_fleet; ++c) total += span[2 * c];
  int used = 0;
  for (int c = 0; c < d.n_fleet; ++c) {
    int k = (int)((long long)blocks * span[2 * c] / total);
    k = min(max(k, 1), d.n_tiles);
    span[2 * c + 1] = k;
    used += k;
  }
  // the rest one at a time to the chain with the most work a block; past
  // the grid, one back from the chain with the least
  while (used < blocks) {
    int best = -1;
    for (int c = 0; c < d.n_fleet; ++c)
      if (span[2 * c + 1] < d.n_tiles &&
          (best < 0 || (long long)span[2 * c] * span[2 * best + 1] >
                           (long long)span[2 * best] * span[2 * c + 1]))
        best = c;
    if (best < 0) break;
    ++span[2 * best + 1];
    ++used;
  }
  while (used > blocks) {
    int best = -1;
    for (int c = 0; c < d.n_fleet; ++c)
      if (span[2 * c + 1] > 1 &&
          (best < 0 || (long long)span[2 * c] * span[2 * best + 1] <
                           (long long)span[2 * best] * span[2 * c + 1]))
        best = c;
    --span[2 * best + 1];
    --used;
  }
  for (int c = 0, first = 0; c < d.n_fleet; ++c) {
    const int k = span[2 * c + 1];
    span[2 * c] = first;
    first += k;
  }
}

// c[j] = A x B for the kN n-tiles n0 + j * nstep: A rows [ar, ar + 8 KB)
// of the store by coordinates u, u + 8 (u = 16 m + g), B from W (row
// stride WS).  kPaired (the forward, B = [b; W]): k-block features 2t,
// 2t + 1, B rows of W, columns 8 n + g.  Else (the input gradient, B =
// W^T, W from its row 1): features t, t + 4, B = W[8 n + g][8 kb + t
// (+ 4)].  ar is a multiple of 8, so a lane's rows keep one permutation.
// Branch-free (kN at compile time): the kN chains of three mma
// interleave.
template <int kN, bool kPaired>
__device__ __forceinline__ void tiled_product(float (&c)[kN][4],
                                              const float* S, int T, int ar,
                                              int u, const float* W, int WS,
                                              int KB, int n0, int nstep,
                                              int g, int t) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  const int r0 = kPaired ? 2 * t : t, r1 = kPaired ? 2 * t + 1 : t + 4;
  const int s0 = tiled_sigma(r0), s1 = tiled_sigma(r1);
  const int c00 = r0 * T + (u ^ s0), c01 = r0 * T + ((u + 8) ^ s0);
  const int c10 = r1 * T + (u ^ s1), c11 = r1 * T + ((u + 8) ^ s1);
  const float* a = S + ar * T;
  const int bstep = kPaired ? WS : 4;         // b1's offset from b0
  const int nstride = kPaired ? 8 : 8 * WS;   // one n-tile further
  const int kstep = kPaired ? 8 * WS : 8;     // one k-block further
  const float* w = (kPaired ? W + 2 * t * WS + g : W + g * WS + t) +
                   n0 * nstride;
#pragma unroll 2
  for (int kb = 0; kb < KB; ++kb, a += 8 * T, w += kstep) {
    uint32_t ab[4], as[4];
    split_tf32_nearest(a[c00], &ab[0], &as[0]);
    split_tf32_nearest(a[c01], &ab[1], &as[1]);
    split_tf32_nearest(a[c10], &ab[2], &as[2]);
    split_tf32_nearest(a[c11], &ab[3], &as[3]);
    uint32_t bb[kN][2], bs[kN][2];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float* wj = w + j * nstep * nstride;
      split_tf32_nearest(wj[0], &bb[j][0], &bs[j][0]);
      split_tf32_nearest(wj[bstep], &bb[j][1], &bs[j][1]);
    }
    float dd[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j) mma_tf32_zero(dd[j], as, bb[j][0], bb[j][1]);
#pragma unroll
    for (int j = 0; j < kN; ++j) mma_tf32(dd[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
    for (int j = 0; j < kN; ++j) mma_tf32(dd[j], ab, bb[j][0], bb[j][1]);
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += dd[j][e];
  }
}

// What a warp's chunks of a layer share: the store and its rows of T
// floats, the warp's first coordinate u (= 16 m + g), its n-tile stride
// (the warps of its group), its lane, and the offsets of its four C
// entries (rows 2t + (e & 1), coordinates u + 8 (e >> 1)) from a row
// multiple of 8: off[e] in d / g rows, offh[e] in h rows (units from
// row 1).
struct TiledWarp {
  float* S;
  int T, u, nstep, g, t;
  int off[4], offh[4];
};

// kN n-tiles of a hidden layer from n0: z = [1, h] [b; W] over the
// chain's kb k-blocks, then h = act(z) and d = act'(z) times the unit
// mask into rows h_row + 1 + o and g_row + o (o < fout); the activation
// fixed at compile time, so a tile's four evaluations interleave.
template <int kN, int kAct>
__device__ __forceinline__ void tiled_hidden_chunk(const TiledWarp& x,
                                                   const TiledLayer& ly,
                                                   const float* W, int xr,
                                                   int kb, const float* ml,
                                                   int n0) {
  float c[kN][4];
  tiled_product<kN, true>(c, x.S, x.T, xr, x.u, W, ly.w_stride, kb, n0,
                          x.nstep, x.g, x.t);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int o0 = 8 * (n0 + j * x.nstep);
    float h[4], dv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      brief::act_fwd(kAct, ly.w0, c[j][e], &h[e], &dv[e]);
    float* hp = x.S + (ly.h_row + o0) * x.T;
    float* dp = x.S + (ly.g_row + o0) * x.T;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int o = o0 + 2 * x.t + q;
      if (o < ly.fout) {
        const float m = ml == nullptr ? 1.f : ml[o];
        hp[x.offh[q]] = h[q] * m;
        hp[x.offh[q + 2]] = h[q + 2] * m;
        dp[x.off[q]] = dv[q] * m;
        dp[x.off[q + 2]] = dv[q + 2] * m;
      }
    }
  }
}

// A hidden layer: the warp's n-tiles nfirst, nfirst + nstep, ... below
// NT, in chunks of up to kTiledChunk.
template <int kAct>
__device__ __forceinline__ void tiled_hidden(const TiledWarp& x,
                                             const TiledLayer& ly,
                                             const float* W, int xr, int kb,
                                             int NT, const float* ml,
                                             int nfirst) {
  for (int n0 = nfirst; n0 < NT; n0 += kTiledChunk * x.nstep) {
    const int cnt = (NT - n0 + x.nstep - 1) / x.nstep;
    if (cnt >= 3) {
      tiled_hidden_chunk<3, kAct>(x, ly, W, xr, kb, ml, n0);
    } else if (cnt == 2) {
      tiled_hidden_chunk<2, kAct>(x, ly, W, xr, kb, ml, n0);
    } else {
      tiled_hidden_chunk<1, kAct>(x, ly, W, xr, kb, ml, n0);
    }
  }
}

// kN n-tiles of the last layer from n0: the prediction, the loss against
// the tile's values and weights (rows yr, yr + c_out of its input
// buffer) and g = dL/dz into rows g_row + o (o < c_out).
template <int kN>
__device__ __forceinline__ void tiled_last_chunk(
    const TiledWarp& x, const TiledLayer& ly, const float* W, int xr, int kb,
    const float* ml, int n0, int yr, int n_valid, int loss, float beta,
    bool thr_on, float thr, float* loss_acc) {
  float c[kN][4];
  tiled_product<kN, true>(c, x.S, x.T, xr, x.u, W, ly.w_stride, kb, n0,
                          x.nstep, x.g, x.t);
  const int c_out = ly.fout;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int o0 = 8 * (n0 + j * x.nstep);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = o0 + 2 * x.t + (e & 1);
      const int uu = x.u + 8 * (e >> 1);
      if (o >= c_out) continue;
      float h, dv;
      brief::act_fwd(ly.act, ly.w0, c[j][e], &h, &dv);
      if (ml != nullptr) {
        h *= ml[o];
        dv *= ml[o];
      }
      const float gv = loss_grad(
          loss, beta, thr_on, thr, h, x.S[(yr + o0) * x.T + x.off[e]],
          x.S[tiled_at(yr + c_out + o, uu, x.T)], uu < n_valid, dv, loss_acc);
      x.S[(ly.g_row + o0) * x.T + x.off[e]] = gv;
    }
  }
}

// kN n-tiles of layer l's input gradient from n0: g_{l-1} = (g_l W^T)
// d_{l-1} in place of d_{l-1} (rows dr + i, i < fin), over kb k-blocks
// of g_l.
template <int kN>
__device__ __forceinline__ void tiled_grad_chunk(const TiledWarp& x,
                                                 const TiledLayer& ly,
                                                 const float* W, int dr,
                                                 int kb, int n0) {
  float c[kN][4];
  tiled_product<kN, false>(c, x.S, x.T, ly.g_row, x.u, W + ly.w_stride,
                           ly.w_stride, kb, n0, x.nstep, x.g, x.t);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int i0 = 8 * (n0 + j * x.nstep);
    float* p = x.S + (dr + i0) * x.T;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (i0 + 2 * x.t + (e & 1) < ly.fin) p[x.off[e]] *= c[j][e];
    }
  }
}

// kJ: dW jobs a warp (the instance), kTiledJob tiles each.  Grid: the
// fleet's blocks, shared among its chains by tiled_share_kernel (span);
// kTiledThreads threads, one block an SM.
template <int kJ>
__global__ void __launch_bounds__(kTiledThreads, 1) fused_train_tiled_kernel(
    const float* __restrict__ coords, const float* __restrict__ values,
    const float* __restrict__ weights, const float* __restrict__ params,
    const float* __restrict__ masks, const float* __restrict__ thres,
    const int* __restrict__ span, float* __restrict__ partial, int n,
    TiledDesc d, int loss, float beta) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int L = d.n_layers, c_in = d.c_in, c_out = d.c_out;
  // this block's chain and its place among the chain's blocks
  int fb = 0;
  while (fb < d.n_fleet && blockIdx.x >= span[2 * fb] + span[2 * fb + 1])
    ++fb;
  if (fb == d.n_fleet) return;       // past the last chain's blocks
  const int rank = blockIdx.x - span[2 * fb], n_blocks = span[2 * fb + 1];
  const int MT = d.mt, T = 16 * MT;
  coords += (size_t)fb * c_in * n;
  values += (size_t)fb * c_out * n;
  weights += (size_t)fb * c_out * n;
  params += (size_t)fb * d.n_params;
  const bool thr_on = thres != nullptr;
  const float thr = thr_on ? thres[fb] : 0.f;
  float* S = sm + d.w_floats;            // the activation store
  float* msk = sm + d.mask_sm;
  int* dsc = reinterpret_cast<int*>(sm + d.desc_sm) + warp * kJ;
  TiledLayer* tab = reinterpret_cast<TiledLayer*>(sm + d.tab_sm);
  int* widths = reinterpret_cast<int*>(sm + d.width_sm);
  const int* codes = reinterpret_cast<const int*>(d.layer + L);

  // ---- set-up: zeros, the layer table and the chain's widths, W (bias
  // first), the ones rows, masks, this warp's dW codes ----
  for (int e = tid; e < d.red_off; e += kTiledThreads) sm[e] = 0.f;
  for (int l = tid; l < L; l += kTiledThreads) tab[l] = ld_row(d.layer + l);
  for (int l = warp; l < L; l += kTiledWarps) {
    const int w = tiled_width(masks, d.mask_width, fb, ld_row(d.layer + l),
                              lane);
    if (lane == 0) widths[l] = w;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    const TiledLayer ly = tab[l];
    const int fo = ly.fout, cnt = (ly.fin + 1) * fo;
    const float* src = params + ly.p_off;   // W (fin, fout), then b
    for (int e = tid; e < cnt; e += kTiledThreads) {
      const int i = e / fo;
      sm[ly.w_off + (i < ly.fin ? i + 1 : 0) * ly.w_stride + e - i * fo] =
          src[e];
    }
    for (int e = tid; e < (ly.x_in ? 2 : 1) * T; e += kTiledThreads) {
      const int r = ly.x_row + (e >= T ? d.buf_rows : 0);
      S[tiled_at(r, e % T, T)] = 1.f;
    }
  }
  if (masks != nullptr)
    for (int e = tid; e < d.mask_width; e += kTiledThreads)
      msk[e] = masks[(size_t)fb * d.mask_width + e];
  if (lane < kJ) dsc[lane] = codes[2 * (warp * kJ + lane)];

  // the inputs of tile `tl` (coordinates, values, weights; zeros past n)
  // into input buffer `buf`, by cp.async
  const int n_ch = c_in + 2 * c_out;
  auto stage = [&](int tl, int buf) {
    const int base = tl * T;
    for (int e = tid; e < n_ch * T; e += kTiledThreads) {
      const int ch = e / T, u = e - ch * T, idx = base + u;
      const int r =
          buf * d.buf_rows + (ch < c_in ? 1 + ch : d.yw_row + ch - c_in);
      const float* src = ch < c_in ? coords + (size_t)ch * n
                         : ch < c_in + c_out
                             ? values + (size_t)(ch - c_in) * n
                             : weights + (size_t)(ch - c_in - c_out) * n;
      cp_async4(S + tiled_at(r, u, T), src + min(idx, n - 1), idx < n);
    }
    brief::wide::cp_commit();
  };

  float acc[kJ][kTiledJob][4];
#pragma unroll
  for (int s = 0; s < kJ; ++s)
#pragma unroll
    for (int j = 0; j < kTiledJob; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;
  float loss_acc = 0.f;
  const int grp = warp % MT, gsize = kTiledWarps / MT;   // this warp's group
  TiledWarp x{S, T, 16 * grp + g, gsize, g, t, {}, {}};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 2 * t + (e & 1), uu = x.u + 8 * (e >> 1);
    x.off[e] = r * T + (uu ^ tiled_sigma(r));
    x.offh[e] = (r + 1) * T + (uu ^ tiled_sigma(r + 1));
  }
  const int nfirst = warp / MT;          // its first n-tile of a layer
  const int bar = 1 + grp, bar_threads = 32 * gsize;
  if (rank < d.n_tiles) stage(rank, 0);
  brief::wide::cp_wait<0>();
  __syncthreads();

  int par = 0;
  for (int tile = rank; tile < d.n_tiles; tile += n_blocks, par ^= 1) {
    const int base = tile * T, pr = par * d.buf_rows;
    if (tile + n_blocks < d.n_tiles) stage(tile + n_blocks, par ^ 1);

    // ---- forward: z = [1, h] [b; W] over the chain's own k-blocks and
    // n-tiles; h and d of hidden layers into the store; the last
    // layer's loss and g = dL/dz into its g rows ----
    for (int l = 0, fin = c_in; l < L; ++l) {
      const TiledLayer ly = tab[l];
      const int fout = widths[l];
      const int xr = ly.x_row + (ly.x_in ? pr : 0);
      const int KB = (fin + 8) >> 3, NT = (fout + 7) >> 3;
      const float* W = sm + ly.w_off;
      const float* ml =
          masks == nullptr || ly.mask_off < 0 ? nullptr : msk + ly.mask_off;
      if (l + 1 < L) {
        switch (ly.act) {
          case brief::kActSine:
            tiled_hidden<brief::kActSine>(x, ly, W, xr, KB, NT, ml, nfirst);
            break;
          case brief::kActRelu:
            tiled_hidden<brief::kActRelu>(x, ly, W, xr, KB, NT, ml, nfirst);
            break;
          case brief::kActSigmoid:
            tiled_hidden<brief::kActSigmoid>(x, ly, W, xr, KB, NT, ml,
                                             nfirst);
            break;
          default:
            tiled_hidden<brief::kActNone>(x, ly, W, xr, KB, NT, ml, nfirst);
        }
      } else {
        const int yr = pr + d.yw_row;
        for (int n0 = nfirst; n0 < NT; n0 += kTiledChunk * gsize) {
          const int cnt = (NT - n0 + gsize - 1) / gsize;
          if (cnt >= 3) {
            tiled_last_chunk<3>(x, ly, W, xr, KB, ml, n0, yr, n - base, loss,
                                beta, thr_on, thr, &loss_acc);
          } else if (cnt == 2) {
            tiled_last_chunk<2>(x, ly, W, xr, KB, ml, n0, yr, n - base, loss,
                                beta, thr_on, thr, &loss_acc);
          } else {
            tiled_last_chunk<1>(x, ly, W, xr, KB, ml, n0, yr, n - base, loss,
                                beta, thr_on, thr, &loss_acc);
          }
        }
      }
      fin = fout;
      group_sync(bar, bar_threads);   // the group's layer output is in
    }

    // ---- input gradients, last layer first: g_{l-1} = (g_l W_l^T) d_{l-1}
    // in place of d_{l-1} (rows i < fin), the chain's own k-blocks and
    // n-tiles ----
    for (int l = L - 1; l >= 1; --l) {
      const TiledLayer ly = tab[l];
      const int dr = tab[l - 1].g_row;
      const int KB = (widths[l] + 7) >> 3, NT = (widths[l - 1] + 7) >> 3;
      const float* W = sm + ly.w_off;
      for (int n0 = nfirst; n0 < NT; n0 += kTiledChunk * gsize) {
        const int cnt = (NT - n0 + gsize - 1) / gsize;
        if (cnt >= 3) {
          tiled_grad_chunk<3>(x, ly, W, dr, KB, n0);
        } else if (cnt == 2) {
          tiled_grad_chunk<2>(x, ly, W, dr, KB, n0);
        } else {
          tiled_grad_chunk<1>(x, ly, W, dr, KB, n0);
        }
      }
      if (l > 1) group_sync(bar, bar_threads);
    }
    __syncthreads();   // every group's h and g are in the store

    // ---- dW over the tile's T coordinates into this warp's jobs: kJ
    // jobs of kTiledJob tiles of one row (A, M), sharing its fragment;
    // every job and tile computed (a warp's unused slots read rows 0 and
    // are never written), so the jobs' mma chains interleave ----
    const int sg = tiled_sigma(g);   // rows 16 m + g (+ 8), 8 n + g
    for (int kb = 0; kb < 2 * MT; ++kb) {
      const int ua = (8 * kb + t) ^ sg, ub = (8 * kb + t + 4) ^ sg;
#pragma unroll
      for (int s = 0; s < kJ; ++s) {
        const int code = dsc[s];
        const int ra = (code & 0x1fff) + ((code >> 26) & 1 ? pr : 0);
        const int rb = ((code >> 13) & 0x1fff) + ((code >> 27) & 1 ? pr : 0);
        const float* pa = S + (ra + g) * T;
        uint32_t ab[4], as[4];
        split_tf32_nearest(pa[ua], &ab[0], &as[0]);
        split_tf32_nearest(pa[8 * T + ua], &ab[1], &as[1]);
        split_tf32_nearest(pa[ub], &ab[2], &as[2]);
        split_tf32_nearest(pa[8 * T + ub], &ab[3], &as[3]);
        uint32_t bb[kTiledJob][2], bs[kTiledJob][2];
#pragma unroll
        for (int j = 0; j < kTiledJob; ++j) {
          const float* pb = S + (rb + 8 * j + g) * T;
          split_tf32_nearest(pb[ua], &bb[j][0], &bs[j][0]);
          split_tf32_nearest(pb[ub], &bb[j][1], &bs[j][1]);
        }
        float dd[kTiledJob][4];
#pragma unroll
        for (int j = 0; j < kTiledJob; ++j)
          mma_tf32_zero(dd[j], as, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < kTiledJob; ++j)
          mma_tf32(dd[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
        for (int j = 0; j < kTiledJob; ++j)
          mma_tf32(dd[j], ab, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < kTiledJob; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[s][j][e] += dd[j][e];
      }
    }
    brief::wide::cp_wait<0>();   // the next tile's inputs are in
    __syncthreads();             // before the next tile overwrites the store
  }

  // ---- this block's partial sums, written once: gradients, then loss ----
  float* out = partial + (size_t)blockIdx.x * (d.n_params + 1);
#pragma unroll
  for (int s = 0; s < kJ; ++s) {
    const int code = codes[2 * (warp * kJ + s) + 1];
    if (code < 0) continue;
    const int l = code >> 20, gm = (code >> 19) & 1;
    const int m = (code >> 12) & 127, n0 = (code >> 4) & 255, cnt = code & 15;
    const TiledLayer ly = tab[l];
#pragma unroll
    for (int j = 0; j < kTiledJob; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m + g + 8 * (e >> 1);
        const int q = 8 * (n0 + j) + 2 * t + (e & 1);
        // the input region's row k: the bias (k == 0) or unit k - 1
        const int k = gm ? q : r, o = gm ? r : q;
        const int i = k == 0 ? ly.fin : k - 1;
        if (j < cnt && k <= ly.fin && o < ly.fout)
          out[ly.p_off + i * ly.fout + o] = acc[s][j][e];
      }
    }
  }
  for (int s = 16; s > 0; s >>= 1)
    loss_acc += __shfl_xor_sync(0xffffffffu, loss_acc, s);
  float* red = sm + d.red_off;
  if (lane == 0) red[warp] = loss_acc;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < kTiledWarps; ++w) sum += red[w];
    out[d.n_params] = sum;
  }
}

// out[c][p] = (sum over chain c's blocks, in order, of their partial row
// p) / m, c = blockIdx.y; the blocks from span (tiled_share_kernel).
__global__ void reduce_spans_kernel(const float* __restrict__ partial,
                                    const int* __restrict__ span,
                                    float* __restrict__ out, int width,
                                    float m) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= width) return;
  const int c = blockIdx.y, first = span[2 * c], k = span[2 * c + 1];
  partial += (size_t)first * width + p;
  float s = 0.f;
  for (int b = 0; b < k; ++b) s += partial[(size_t)b * width];
  out[(size_t)c * width + p] = s / m;
}

template <int kJ>
cudaError_t tiled_occupancy(int smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_train_tiled_kernel<kJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_train_tiled_kernel<kJ>, kTiledThreads,
      smem_bytes);
}

template <int kJ>
cudaError_t launch_tiled(int grid, int smem_bytes, cudaStream_t s,
                         const float* coords, const float* values,
                         const float* weights, const float* params,
                         const float* masks, const float* thres,
                         const int* span, float* partial, int n,
                         const TiledDesc& d, int loss, float beta) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_train_tiled_kernel<kJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  fused_train_tiled_kernel<kJ><<<grid, kTiledThreads, smem_bytes, s>>>(
      coords, values, weights, params, masks, thres, span, partial, n, d,
      loss, beta);
  return cudaGetLastError();
}

// (the deep instance's: both instances have the same launch bounds)
template <int kJobs, bool kSmall>
cudaError_t narrow_occupancy(int threads, int smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_train_kernel<kJobs, kSmall, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_train_kernel<kJobs, kSmall, true>, threads,
      smem_bytes);
}

// The instance that reads the layers' rows from the launch parameters
// (at most kParamLayers layers) or from the device table.
template <int kJobs, bool kSmall>
cudaError_t launch_narrow(dim3 grid, int threads, int smem_bytes,
                          cudaStream_t s, const float* coords,
                          const float* values, const float* weights,
                          float* partial, int n, const NarrowDesc& d,
                          int loss, float beta, const float* thres) {
  auto kernel = d.n_layers > brief::kParamLayers
                    ? fused_train_kernel<kJobs, kSmall, true>
                    : fused_train_kernel<kJobs, kSmall, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem_bytes, s>>>(coords, values, weights, partial,
                                           n, d, loss, beta, thres);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The wide layout: for chains whose weights do not fit in shared memory
// beside a tile (the SingleTask default on the 64x512x512 demo volumes,
// 3-191x4-1 at 80x and 3-242x4-1 at 50x; fleet buckets past the tiled
// layout, e.g. 3-128x6-1; the deep chains, 3-78x19-1, [3]+[64]x23+[1];
// ops/fused_train.py wide_plan), up to 352 features a layer; wider ones
// take the streamed form (csrc/fused_train_stream.cu), faster there
// (PERF.md §6).  It replaces, for those chains,
// brief_pytorch_tpu/ops/pallas_train.py _fused_grads_padded
// (pl.pallas_call :281, body _make_train_kernel :70).
//
// Every product runs on the tensor cores: mma.sync.m16n8k8 TF32 in
// 3xTF32 (x = big + small; a b = as bb + ab bs + ab bb), each k-block's
// three products summed from zero and added to the running sum in
// float32 (the tensor core truncates its accumulator: a long run of
// k-blocks left in it drifts).  A chain of L layers, h_0 the coordinates,
// z_{l+1} = W_l^T h_l + b_l, h_{l+1} = act_l(z_{l+1}) m_l.  Per call:
//  (a) pack_weights_kernel (csrc/wide.cuh): W and W^T of every layer,
//      split into TF32 halves once, in the order the fragments are read;
//  (b) wide_tile_kernel, mode 0 (forward): a persistent grid over tiles
//      of kT coordinates (128 or 64), 16 warps a block; the tile's
//      activations stay in shared memory (two buffers, a layer reading
//      one and writing the other), each layer's products stream its
//      forward pack through a ring of kStages cp.async slabs, 64 output
//      columns at a time; the epilogue adds the bias, stores z_{l+1} to
//      the scratch and h_{l+1} to the other buffer; the last layer's
//      epilogue gives the loss (a block's sum in float64) and g_L;
//  (c) per layer, last first: wide_tile_kernel, mode 1 (l >= 1): g_l =
//      (W_l g_{l+1}) act'(z_l) m, the tile's g_{l+1} in shared memory,
//      the input-gradient pack streamed as in (b); h_l, which dW needs,
//      written over z_l and g_l into the other of two G buffers; then
//      wide_dw_kernel: dW_l = h_l g_{l+1}^T and db_l, split over the
//      coordinates (layer 0: the coordinates' rows);
//  (d) reduce_wide_kernel: the splits' partial sums and the loss partials
//      added in a fixed order.  No float atomics: runs are bitwise equal.
// The scratch (device memory, rows of np = round128(N) floats) holds the
// coordinates, one z / h row set a hidden layer and the two G buffers:
// 1,149 rows at 3-191x4-1, where the old layout kept 1,532 (h and d of
// every layer).
// Why this way: the old wide layout ran its products as float32 FMAs on
// the CUDA cores (its float32 bound alone, 1.01 ms at 3-191x4-1, N =
// 100,000, is 2.5x the tensor-core bound) and each W slab served 32
// coordinates.  Here W is split once and read as ready fragments (one
// 16-byte load a lane), a slab serves 128 coordinates at 3-191x4-1, and
// the activation rows are paired (wat) so that an A fragment is two
// 8-byte loads a lane.
// What bounds it: the tensor cores (3 x 66 GFLOP at 3-191x4-1: 0.40 ms at
// 495 TFLOP/s, ~0.64 ms at the ~311 TFLOP/s mma.sync reached on the card,
// scripts/mma_tf32_rate.py) and the scratch traffic (~2 GB a call there,
// ~0.6 ms at 3.35 TB/s).  It runs at ~25% of mma.sync's rate, paced by
// latency at 16 warps an SM: without the W slabs' copies, the barriers
// or the sines it gains 3-11% (scripts/wide_variants.py, PERF.md).  It
// stays on mma.sync, not wgmma: wgmma's TF32 operands must both be
// K-major in shared memory, for which the packs and the input gradient's
// operand would have to be laid out anew, and mma.sync's fragments let
// an epilogue apply the activation where the sums are.
// ---------------------------------------------------------------------------
namespace wl = brief::wide;

constexpr int kWideThreads = wl::kThreads;   // 16 warps
constexpr int kDwI = 64;       // a dW block's rows (of fin)
constexpr int kDwChunk = 32;   // coordinates of a dW k-slab
constexpr int kDwStride = kDwChunk + 4;

// A dW block of kThreads threads: kO = kThreads / 4 columns (128 with 16
// warps, 4 x 4; 64 with 8, 4 x 2, for layers of at most 64 outputs), its
// stage and its shared memory.
template <int kThreads>
struct DwGeom {
  static constexpr int kO = kThreads / 4;
  static constexpr int kWN = kO / 32;
  static constexpr int kStage = (kDwI + kO) * kDwStride;
  static constexpr int kSmem = 4 * wl::kStages * kStage;
};

// A tile's slab: kKS k-blocks of a chunk's 8 fragments.
template <int kT>
struct WideSlab {
  static constexpr int kKS = kT == 128 ? 2 : 4;
  static constexpr int kFloats = kKS * 8 * wl::kFrag;
  static_assert(kFloats % (4 * kWideThreads) == 0, "whole 16-byte copies");
  static_assert(wl::kStages * kFloats >= 2 * kWideThreads,
                "the ring holds the loss reduction's doubles");
};

// The warps over a 64-column chunk of a tile of kT coordinates: kWM x kWN
// warps, each kMT m-tiles (16 coordinates) by kNT n-tiles (8 outputs).
template <int kT>
struct WideGeom {
  static constexpr int kWarps = kWideThreads / 32;
  static constexpr int kMTiles = kT / 16;
  static constexpr int kMT = kT == 128 ? 2 : 1;
  static constexpr int kWM = kMTiles / kMT;
  static constexpr int kWN = kWarps / kWM;
  static constexpr int kNT = 8 / kWN;
  static_assert(kNT >= 1 && kWM * kWN == kWarps, "the warps over a chunk");
};

// The call (ops/fused_train.py wide_plan): the caller's tensors, the
// table, the packs, the scratch and the partial sums.  blockIdx.y (the
// tile kernel) or blockIdx.z (dW) is the chain.
struct WideDesc {
  const float* coords;
  const float* values;
  const float* weights;
  const float* masks;
  const float* thres;
  const float* params;      // (B, n_params): the biases, read in place
  const wl::Layer* layer;   // n_layers rows, device memory (csrc/wide.cuh)
  const float* wp;
  float* scratch;
  float* partial;
  double* lossp;            // (B, grid): the blocks' loss partials
  int n, np, n_layers, c_in, c_out, n_params, mask_width, rows_total;
  int wp_total, part_total, rows_max, kp;   // kp: 8 WideSlab<kT>::kKS
};

// Row r (a feature), coordinate u of a tile's activation buffer: rows
// 8 kb + t and 8 kb + t + 4 side by side, a float2 a coordinate, in
// paired row 4 kb + t of kT float2, its coordinates XOR 4 t.  An A
// fragment's entries (rows 8 kb + t, t + 4 by coordinates g, g + 8 of an
// m-tile) are then two 8-byte reads a lane, and a half warp's reads hit
// 32 banks with no padding.
template <int kT>
__device__ __forceinline__ int wat(int r, int u) {
  return ((((r >> 3) << 2) | (r & 3)) * kT + (u ^ ((r & 3) << 2))) * 2 +
         ((r >> 2) & 1);
}

// One k-block (rows k0 .. k0 + 7 of X, fragments kbl * 8 .. of the
// stage st) of the warp's kMT x kNT tiles: each tile's three products
// summed from zero, then added to acc.  xo: this lane's offsets of its A
// entries' pairs (coordinates g and g + 8) in a k-block's rows (the
// layout depends on the row only through r & 7), bo: its offset of a
// stage's fragment.
// kFull: all kNT n-tiles hold outputs (no branch between the mma
// chains); else the first nj.
template <int kT, bool kFull>
__device__ __forceinline__ void wide_kblock(
    const float* Xk, const float4* st, const int (&xo)[WideGeom<kT>::kMT][2],
    int bo, int kbl, int nj,
    float (&acc)[WideGeom<kT>::kMT][WideGeom<kT>::kNT][4]) {
  using G = WideGeom<kT>;
  uint32_t bb[G::kNT][2], bs[G::kNT][2];
#pragma unroll
  for (int j = 0; j < G::kNT; ++j) {
    if (!kFull && j >= nj) continue;
    const float4 v = st[bo + (kbl * 8 + j) * 32];
    bb[j][0] = __float_as_uint(v.x);
    bb[j][1] = __float_as_uint(v.y);
    bs[j][0] = __float_as_uint(v.z);
    bs[j][1] = __float_as_uint(v.w);
  }
  uint32_t ab[G::kMT][4], as[G::kMT][4];
#pragma unroll
  for (int i = 0; i < G::kMT; ++i) {
    const float2 lo = *reinterpret_cast<const float2*>(Xk + xo[i][0]);
    const float2 hi = *reinterpret_cast<const float2*>(Xk + xo[i][1]);
    const float a[4] = {lo.x, hi.x, lo.y, hi.y};   // (g, t) (g+8, t) (g, t+4) ..
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[e], &ab[i][e], &as[i][e]);
  }
#pragma unroll
  for (int j = 0; j < G::kNT; ++j) {
    if (!kFull && j >= nj) continue;
#pragma unroll
    for (int i = 0; i < G::kMT; ++i) {
      float s4[4];
      brief::mma_tf32_zero(s4, as[i], bb[j][0], bb[j][1]);
      mma_tf32(s4, ab[i], bs[j][0], bs[j][1]);
      mma_tf32(s4, ab[i], bb[j][0], bb[j][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += s4[e];
    }
  }
}

// acc = X^T B over the k-blocks [0, kbs) of one chunk: X the tile's rows
// in shared memory (zero from the product's K on), B the chunk's packed
// fragments at src (its slabs in order, through the ring); n_valid:
// columns of the chunk that exist (n-tiles past them are skipped).
// Called by every thread; starts with a barrier.
template <int kT>
__device__ __forceinline__ void wide_product(
    const float* X, const float* __restrict__ src, int kbs, int n_valid,
    float* ring, float (&acc)[WideGeom<kT>::kMT][WideGeom<kT>::kNT][4]) {
  using G = WideGeom<kT>;
  using S = WideSlab<kT>;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / G::kWN, wn = warp % G::kWN;
  const int nj = min(G::kNT, max(0, (n_valid - 8 * G::kNT * wn + 7) / 8));
  int xo[G::kMT][2];   // wat<kT>(k0 + t, m (+ 8)) - k0 kT: rows t and t + 4
#pragma unroll
  for (int i = 0; i < G::kMT; ++i) {
    const int m = 16 * (G::kMT * wm + i) + g;
    xo[i][0] = wat<kT>(q, m);
    xo[i][1] = wat<kT>(q, m + 8);
  }
  const int bo = G::kNT * wn * 32 + lane;
#pragma unroll
  for (int i = 0; i < G::kMT; ++i)
#pragma unroll
    for (int j = 0; j < G::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int ns = kbs / S::kKS;
  auto load = [&](int s, int stage) {
    float* dst = ring + stage * S::kFloats;
    const float* from = src + (size_t)s * S::kFloats;
#pragma unroll
    for (int j = 0; j < S::kFloats / 4 / kWideThreads; ++j) {
      const int c = t + j * kWideThreads;
      wl::cp16(dst + 4 * c, from + 4 * c);
    }
  };
  __syncthreads();   // the ring's and the buffers' last readers are done
#pragma unroll
  for (int s = 0; s < wl::kStages - 1; ++s) {
    if (s < ns) load(s, s);
    wl::cp_commit();
  }
  for (int s = 0; s < ns; ++s) {
    wl::cp_wait<wl::kStages - 2>();
    __syncthreads();   // slab s is in; slab s - 1's stage is free
    if (s + wl::kStages - 1 < ns)
      load(s + wl::kStages - 1, (s + wl::kStages - 1) % wl::kStages);
    wl::cp_commit();
    const float4* st = reinterpret_cast<const float4*>(
        ring + (s % wl::kStages) * S::kFloats);
    const float* Xs = X + 8 * S::kKS * s * kT;
#pragma unroll
    for (int kbl = 0; kbl < S::kKS; ++kbl) {
      if (nj == G::kNT)
        wide_kblock<kT, true>(Xs + 8 * kbl * kT, st, xo, bo, kbl, nj, acc);
      else if (nj > 0)
        wide_kblock<kT, false>(Xs + 8 * kbl * kT, st, xo, bo, kbl, nj, acc);
    }
  }
}

// Where the tile kernel's per-tile values live
struct WideTile {
  float* scratch;       // this chain's rows
  const float* wp;      // this chain's packs
  const float* mk;      // this chain's unit masks, or null
  const float* values;  // this chain's values and weights
  const float* weights;
  int base;             // the tile's first coordinate
  bool thr_on;
  float thr;
};

// act(z) alone (a hidden layer's forward: its derivative is recomputed
// from z where the backward needs it)
template <int kAct>
__device__ __forceinline__ float act_h(float w0, float z) {
  if (kAct == brief::kActSine) return brief::fast_sin(w0 * z);
  float h, d;
  brief::act_fwd(kAct, w0, z, &h, &d);
  return h;
}

// Layer k's forward over columns [c0, c0 + 64) of the tile:
// the product, the bias; hidden layers store z to the scratch and h to
// Y, the last layer the loss and g_L.
template <int kT, int kAct>
__device__ __forceinline__ void wide_forward_chunk(
    const WideDesc& d, const WideTile& w, const wl::Layer& ly, bool last,
    const float* bias, const float* ml, int kbs, int c0, const float* X,
    float* Y, float* ring, int loss, float beta, float* loss_acc) {
  using G = WideGeom<kT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / G::kWN, wn = warp % G::kWN;
  const size_t np = d.np;
  float acc[G::kMT][G::kNT][4];
  wide_product<kT>(
      X, w.wp + ly.wf_off + (size_t)c0 / 64 * kbs * 8 * wl::kFrag, kbs,
      ly.fout - c0, ring, acc);
#pragma unroll
  for (int i = 0; i < G::kMT; ++i)
#pragma unroll
    for (int j = 0; j < G::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * (G::kMT * wm + i) + g + 8 * (e >> 1);
        const int o = c0 + 8 * (G::kNT * wn + j) + 2 * q + (e & 1);
        if (o >= ly.fout) continue;
        const float z = acc[i][j][e] + __ldg(bias + o);
        const float mv = ml == nullptr ? 1.f : __ldg(ml + o);
        const int idx = w.base + r;
        if (!last) {
          w.scratch[(size_t)(ly.out_row + o) * np + idx] = z;
          Y[wat<kT>(o, r)] = act_h<kAct>(ly.w0, z) * mv;
        } else {
          float h, dv;
          brief::act_fwd(kAct, ly.w0, z, &h, &dv);
          h *= mv;
          dv *= mv;
          const bool valid = idx < d.n;
          float y = 0.f, wv = 0.f;
          if (valid) {
            y = w.values[(size_t)o * d.n + idx];
            wv = w.weights[(size_t)o * d.n + idx];
          }
          w.scratch[(size_t)(ly.g_row + o) * np + idx] = loss_grad(
              loss, beta, w.thr_on, w.thr, h, y, wv, valid, dv, loss_acc);
        }
      }
}

// Layer ly's input gradient over columns [c0, c0 + 64) of the tile: the product of the tile's g_{l+1} (X) and W^T; h_l and d_l
// from z_l through activation kAct (`in`: layer l - 1's row); h_l
// written over z_l, g_l = (W g_{l+1}) d_l to the other G buffer.
template <int kT, int kAct>
__device__ __forceinline__ void wide_grad_chunk(
    const WideDesc& d, const WideTile& w, const wl::Layer& ly,
    const wl::Layer& in, const float* ml, int kbs, int c0, const float* X,
    float* ring) {
  using G = WideGeom<kT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / G::kWN, wn = warp % G::kWN;
  const size_t np = d.np;
  float zv[G::kMT][G::kNT][4];   // z_l, loading while the product runs
#pragma unroll
  for (int i = 0; i < G::kMT; ++i)
#pragma unroll
    for (int j = 0; j < G::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * (G::kMT * wm + i) + g + 8 * (e >> 1);
        const int o = c0 + 8 * (G::kNT * wn + j) + 2 * q + (e & 1);
        zv[i][j][e] =
            o < ly.fin ? w.scratch[(size_t)(ly.in_row + o) * np + w.base + r]
                       : 0.f;
      }
  float acc[G::kMT][G::kNT][4];
  wide_product<kT>(
      X, w.wp + ly.wb_off + (size_t)c0 / 64 * kbs * 8 * wl::kFrag, kbs,
      ly.fin - c0, ring, acc);
#pragma unroll
  for (int i = 0; i < G::kMT; ++i)
#pragma unroll
    for (int j = 0; j < G::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * (G::kMT * wm + i) + g + 8 * (e >> 1);
        const int o = c0 + 8 * (G::kNT * wn + j) + 2 * q + (e & 1);
        if (o >= ly.fin) continue;
        float h, dv;
        brief::act_fwd(kAct, in.w0, zv[i][j][e], &h, &dv);
        if (ml != nullptr) {
          const float mv = __ldg(ml + o);
          h *= mv;
          dv *= mv;
        }
        const size_t u = (size_t)w.base + r;
        w.scratch[(size_t)(ly.in_row + o) * np + u] = h;
        w.scratch[(size_t)(in.g_row + o) * np + u] = acc[i][j][e] * dv;
      }
}

// Dispatch on the activation: one copy of the chunk per activation, so
// that the epilogues do not branch on it a value
#define WIDE_BY_ACT(act, CALL)                        \
  switch (act) {                                      \
    case brief::kActSine: CALL(brief::kActSine); break;       \
    case brief::kActRelu: CALL(brief::kActRelu); break;       \
    case brief::kActSigmoid: CALL(brief::kActSigmoid); break; \
    default: CALL(brief::kActNone);                   \
  }

// (b) mode 0: the forward and the loss; mode 1: layer l's input
// gradient.  Grid (blocks, B), kWideThreads threads.  Shared memory: two
// buffers of rows_max rows of kT floats, the slab ring (at the end, the
// loss reduction's doubles).
template <int kT>
__global__ void __launch_bounds__(kWideThreads, 1)
    wide_tile_kernel(WideDesc d, int mode, int l, int loss, float beta) {
  extern __shared__ __align__(16) float sm[];
  float* buf0 = sm;
  float* buf1 = sm + d.rows_max * kT;
  float* ring = sm + 2 * d.rows_max * kT;
  const int t = threadIdx.x, fb = blockIdx.y;
  const size_t np = d.np;
  WideTile w;
  w.scratch = d.scratch + (size_t)fb * d.rows_total * np;
  w.wp = d.wp + (size_t)fb * d.wp_total;
  w.mk = d.masks == nullptr ? nullptr : d.masks + (size_t)fb * d.mask_width;
  w.values = d.values + (size_t)fb * d.c_out * d.n;
  w.weights = d.weights + (size_t)fb * d.c_out * d.n;
  w.thr_on = d.thres != nullptr;
  w.thr = w.thr_on ? d.thres[fb] : 0.f;
  const float* coords = d.coords + (size_t)fb * d.c_in * d.n;
  float loss_acc = 0.f;

  for (int tile = blockIdx.x; tile < d.np / kT; tile += gridDim.x) {
    w.base = tile * kT;
    __syncthreads();   // the last tile's readers of the buffers are done
    if (mode == 0) {
      // the coordinates (0 past n): to X, zeros to layer 0's K, and to the
      // scratch's rows 0 .. c_in - 1 (layer 0's dW reads them there)
      const int k_end = wl::round_up(d.c_in, d.kp);
      for (int e = t; e < k_end * kT; e += kWideThreads) {
        const int r = e / kT, u = e % kT, idx = w.base + u;
        const float v =
            r < d.c_in && idx < d.n ? coords[(size_t)r * d.n + idx] : 0.f;
        buf0[wat<kT>(r, u)] = v;
        if (r < d.c_in) w.scratch[(size_t)r * np + idx] = v;
      }
      float* X = buf0;
      float* Y = buf1;
      for (int k = 0; k < d.n_layers; ++k) {
        const wl::Layer ly = ld_row(d.layer + k);
        const bool last = k == d.n_layers - 1;
        const int kbs = wl::round_up(ly.fin, d.kp) / 8;
        const float* ml =
            w.mk == nullptr || ly.mask_off < 0 ? nullptr : w.mk + ly.mask_off;
        const float* bias = d.params + (size_t)fb * d.n_params + ly.p_off +
                            (size_t)ly.fin * ly.fout;
        for (int c0 = 0; c0 < ly.fout; c0 += 64) {
#define WIDE_FWD(A)                                                   \
  wide_forward_chunk<kT, A>(d, w, ly, last, bias, ml, kbs, c0, X, Y, ring, \
                            loss, beta, &loss_acc);
          WIDE_BY_ACT(ly.act, WIDE_FWD)
#undef WIDE_FWD
        }
        if (!last) {   // zeros from fout to the next product's K
          const int r0 = ly.fout, r1 = wl::round_up(ly.fout, d.kp);
          for (int e = t; e < (r1 - r0) * kT; e += kWideThreads)
            Y[wat<kT>(r0 + e / kT, e % kT)] = 0.f;
          float* sw = X;
          X = Y;
          Y = sw;
        }
      }
    } else {
      // g_{l+1} of the tile (zeros from fout to K), then h_l and g_l
      const wl::Layer ly = ld_row(d.layer + l);
      const wl::Layer in = ld_row(d.layer + l - 1);
      const int kbs = wl::round_up(ly.fout, d.kp) / 8;
      for (int e = t; e < kbs * 8 * (kT / 4); e += kWideThreads) {
        const int r = e / (kT / 4), u = 4 * (e % (kT / 4));
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < ly.fout)
          v = *reinterpret_cast<const float4*>(
              w.scratch + (size_t)(ly.g_row + r) * np + w.base + u);
        buf0[wat<kT>(r, u)] = v.x;
        buf0[wat<kT>(r, u + 1)] = v.y;
        buf0[wat<kT>(r, u + 2)] = v.z;
        buf0[wat<kT>(r, u + 3)] = v.w;
      }
      const float* ml =
          w.mk == nullptr || in.mask_off < 0 ? nullptr : w.mk + in.mask_off;
      for (int c0 = 0; c0 < ly.fin; c0 += 64) {
#define WIDE_GRAD(A) \
  wide_grad_chunk<kT, A>(d, w, ly, in, ml, kbs, c0, buf0, ring);
        WIDE_BY_ACT(in.act, WIDE_GRAD)
#undef WIDE_GRAD
      }
    }
  }
  if (mode != 0) return;
  // ---- this block's loss partial, its threads' sums added in float64 in
  // the ring, whose last readers are done after the barrier ----
  __syncthreads();
  double* red = reinterpret_cast<double*>(ring);
  red[t] = loss_acc;
  __syncthreads();
  for (int s = kWideThreads / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  if (t == 0) d.lossp[(size_t)fb * gridDim.x + blockIdx.x] = red[0];
}

// A dW block's products over one stage (32 coordinates): warp (wm, wn)'s
// m-tile and 4 n-tiles of H^T G, each k-block's three products from zero
// into the chunk's sums, which then go to acc.  kFull: all 4 tiles hold
// entries (no branch between the mma chains); else the first nj.
template <bool kFull>
__device__ __forceinline__ void dw_chunk(const float* sh, int wm, int wn,
                                         int nj, float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const float* sg = sh + kDwI * kDwStride;
  float cs[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cs[j][e] = 0.f;
#pragma unroll
  for (int kb = 0; kb < kDwChunk / 8; ++kb) {
    const int k0 = 8 * kb + q;
    uint32_t bb[4][2], bs[4][2], ab[4], as[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!kFull && j >= nj) continue;
      const float* p = sg + (32 * wn + 8 * j + g) * kDwStride + k0;
      split_tf32(p[0], &bb[j][0], &bs[j][0]);
      split_tf32(p[4], &bb[j][1], &bs[j][1]);
    }
    const float* p = sh + (16 * wm + g) * kDwStride + k0;
    const float a[4] = {p[0], p[8 * kDwStride], p[4], p[8 * kDwStride + 4]};
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[e], &ab[e], &as[e]);
    float s4[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kFull || j < nj) brief::mma_tf32_zero(s4[j], as, bb[j][0], bb[j][1]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kFull || j < nj) mma_tf32(s4[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kFull || j < nj) mma_tf32(s4[j], ab, bb[j][0], bb[j][1]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kFull || j < nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) cs[j][e] += s4[j][e];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += cs[j][e];
}

// (c) dW of layer l.  Grid (i-blocks x o-blocks, splits, B), kThreads
// threads, DwGeom::kSmem bytes.  Block (tile, split) sums entries (i0 + r,
// o0 + c) of the fin x fout gradient of W over coordinates [split *
// chunk, min(np, (split + 1) * chunk)), 32 at a time through a ring of
// kStages cp.async stages: H (64 rows of h_l, which the input gradient
// wrote over z_l; or the coordinates) and G (kO rows of g_{l+1}), rows of
// kDwStride floats, so that every fragment read of a warp hits 32 banks.
// Each warp takes 16 rows and 32 columns of the tile: 1 x 4 mma tiles,
// operands split as they are read; each k-block's
// three products summed from zero, a 32-coordinate chunk's four k-blocks
// summed apart and then added to the running sum (a run of thousands of
// terms in one register loses ~1e-4 of a sum of like signs).  The blocks
// of the first i-block also sum db = sum_u g_{l+1}: four threads a
// column, each 8 of the chunk's coordinates in order, the quarters added
// in pairs, (q0 + q1) + (q2 + q3), the chunk's sum added to the running
// one.  Rows and columns past
// the layer are neither loaded nor stored: they only reach outputs that
// are dropped.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 512 / kThreads) wide_dw_kernel(
    WideDesc d, int l) {
  using D = DwGeom<kThreads>;
  constexpr int kDwO = D::kO, kDwStage = D::kStage;
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3, wm = warp / D::kWN, wn = warp % D::kWN;
  const wl::Layer ly = ld_row(d.layer + l);
  const int fin = ly.fin, fout = ly.fout;
  const int n_ob = (fout + kDwO - 1) / kDwO;
  const int i0 = blockIdx.x / n_ob * kDwI, o0 = blockIdx.x % n_ob * kDwO;
  const int split = blockIdx.y, fb = blockIdx.z;
  const size_t np = d.np;
  const float* scratch = d.scratch + (size_t)fb * d.rows_total * np;
  const float* H = scratch + (size_t)ly.in_row * np;
  const float* Gr = scratch + (size_t)ly.g_row * np;
  const int lo = split * ly.chunk, hi = min(d.np, lo + ly.chunk);
  const int n_chunks = max(0, (hi - lo) / kDwChunk);
  // whether this warp's m-tile holds entries; its n-tiles that do
  const bool mi = i0 + 16 * wm < fin;
  const int nj = min(4, max(0, (fout - o0 - 32 * wn + 7) / 8));
  const int bc = o0 + (t >> 2);                 // this thread's db column
  const bool db = i0 == 0 && bc < fout;

  auto load = [&](int k, int stage) {
    const int u0 = lo + k * kDwChunk;
    float* sh = sm + stage * kDwStage;
    for (int j = t; j < (kDwI + kDwO) * (kDwChunk / 4); j += kThreads) {
      const int r = j / (kDwChunk / 4), c4 = 4 * (j % (kDwChunk / 4));
      if (r < kDwI) {
        if (i0 + r < fin)
          wl::cp16(sh + r * kDwStride + c4,
                   H + (size_t)(i0 + r) * np + u0 + c4);
      } else if (o0 + r - kDwI < fout) {
        wl::cp16(sh + r * kDwStride + c4,
                 Gr + (size_t)(o0 + r - kDwI) * np + u0 + c4);
      }
    }
  };

  float acc[4][4], bacc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < wl::kStages - 1; ++s) {
    if (s < n_chunks) load(s, s);
    wl::cp_commit();
  }
  for (int k = 0; k < n_chunks; ++k) {
    wl::cp_wait<wl::kStages - 2>();
    __syncthreads();   // chunk k is in; chunk k - 1's stage is free
    if (k + wl::kStages - 1 < n_chunks)
      load(k + wl::kStages - 1, (k + wl::kStages - 1) % wl::kStages);
    wl::cp_commit();
    const float* sh = sm + (k % wl::kStages) * kDwStage;
    float h = 0.f;   // this thread's quarter of its db column's chunk
    if (db) {
      const float* p = sh + (kDwI + (t >> 2)) * kDwStride + 8 * (t & 3);
#pragma unroll
      for (int u = 0; u < 8; ++u) h += p[u];
    }
    float o = __shfl_xor_sync(0xffffffffu, h, 1);
    h = (t & 1) ? o + h : h + o;   // quarters 0 + 1, 2 + 3
    o = __shfl_xor_sync(0xffffffffu, h, 2);
    h = (t & 2) ? o + h : h + o;   // then the two halves
    if (db) bacc += h;
    if (!mi || nj == 0) continue;
    if (nj == 4)
      dw_chunk<true>(sh, wm, wn, nj, acc);
    else
      dw_chunk<false>(sh, wm, wn, nj, acc);
  }
  float* out = d.partial + (size_t)fb * d.part_total + ly.part_off +
               (size_t)split * (fin + 1) * fout;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = i0 + 16 * wm + g + 8 * (e >> 1);
      const int c = o0 + 32 * wn + 8 * j + 2 * q + (e & 1);
      if (r < fin && c < fout) out[(size_t)r * fout + c] = acc[j][e];
    }
  if (db && !(t & 3)) out[(size_t)fin * fout + bc] = bacc;
}

// (d).  out[fb][p] = the sum over layer l's splits, in order, of its
// partial sums of p, / m, for p < n_params (l the layer whose parameters
// hold p); out[fb][n_params] = the blocks' loss partials, in order, in
// float64, / m.  fb = blockIdx.y.
__global__ void reduce_wide_kernel(WideDesc d, float* __restrict__ out,
                                   int n_grid, float m) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int fb = blockIdx.y;
  if (p > d.n_params) return;
  float s = 0.f;
  if (p < d.n_params) {
    int lo = 0, hi = d.n_layers - 1;   // the last layer starting at or before p
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (__ldg(&d.layer[mid].p_off) <= p) lo = mid;
      else hi = mid - 1;
    }
    const wl::Layer ly = ld_row(d.layer + lo);
    const size_t size = (size_t)(ly.fin + 1) * ly.fout;
    const float* src = d.partial + (size_t)fb * d.part_total + ly.part_off +
                       (p - ly.p_off);
    for (int k = 0; k < ly.splits; ++k) s += src[k * size];
    out[(size_t)fb * (d.n_params + 1) + p] = s / m;
  } else {
    const double* lp = d.lossp + (size_t)fb * n_grid;
    double sl = 0.0;
    for (int k = 0; k < n_grid; ++k) sl += lp[k];
    out[(size_t)fb * (d.n_params + 1) + p] = (float)(sl / m);
  }
}

template <int kT>
cudaError_t wide_occupancy(int smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      wide_tile_kernel<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, wide_tile_kernel<kT>, kWideThreads, smem_bytes);
}

template <int kT>
cudaError_t launch_wide_tile(dim3 grid, int smem_bytes, cudaStream_t s,
                             const WideDesc& d, int mode, int l, int loss,
                             float beta) {
  cudaError_t err = cudaFuncSetAttribute(
      wide_tile_kernel<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  wide_tile_kernel<kT><<<grid, kWideThreads, smem_bytes, s>>>(d, mode, l,
                                                              loss, beta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The narrow layout's blocks of `threads` threads using `smem_bytes` of
// dynamic shared memory that fit on one SM at once (the instance for
// `jobs` dW jobs per warp, small or not), and the device's SM count.
int brief_fused_train_occupancy(int threads, int jobs, int small,
                                int smem_bytes, int* blocks_per_sm,
                                int* sm_count) {
  decltype(&narrow_occupancy<1, false>) fn;
  switch (jobs * 2 + (small ? 1 : 0)) {
    case 2: fn = &narrow_occupancy<1, false>; break;
    case 4: fn = &narrow_occupancy<2, false>; break;
    case 8: fn = &narrow_occupancy<4, false>; break;
    case 3: fn = &narrow_occupancy<1, true>; break;
    case 5: fn = &narrow_occupancy<2, true>; break;
    case 9: fn = &narrow_occupancy<4, true>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = fn(threads, smem_bytes, blocks_per_sm);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// The narrow layout (ops/fused_train.py plan).  meta: n_layers, c_in,
// c_out, n_params, stride, act_off, red_off, jobs (per warp), groups,
// rows, yw_row, mask_sm, small (every layer one n-tile: the kSmall
// instance).  table: device memory, n_layers NarrowLayer rows (the
// layers' W (B, fin, fout), b (B, fout) and unit masks (B, fout) read in
// place) then kMaxJobs dW job codes per warp of a group (-1: none)
// (ops/fused_train.py narrow_table); head: its words in host memory.
// coords (B, c_in, n), values / weights (B, c_out, n); thres (B,) or null
// (no override); partial: (B, grid * groups, n_params + 1) scratch; out:
// (B, n_params + 1), the gradients in the packed parameter layout followed
// by the loss.
// `threads` = 32 x the warps per block.
int brief_fused_train(const float* coords, const float* values,
                      const float* weights, const void* table,
                      const void* head, const float* thres, float* partial,
                      float* out, int n,
                      int n_fleet, const int* meta, int loss, float beta,
                      int grid, int threads, int smem_bytes, void* stream) {
  NarrowDesc d;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || table == nullptr || n_fleet < 1 ||
      n_fleet > 65535 || threads < 32 || threads % 32 ||
      threads > 32 * kNarrowMaxWarps)
    return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.n_params = meta[3];
  d.stride = meta[4];
  d.act_off = meta[5];
  d.red_off = meta[6];
  const int jobs = meta[7];
  d.groups = meta[8];
  d.rows = meta[9];
  d.yw_row = meta[10];
  d.mask_sm = meta[11];
  const int small = meta[12];
  if (d.groups < 1 || (threads / 32) % d.groups || jobs > kMaxJobs)
    return (int)cudaErrorInvalidValue;
  if (head == nullptr) return (int)cudaErrorInvalidValue;
  d.layer = static_cast<const NarrowLayer*>(table);
  if (d.n_layers <= brief::kParamLayers)
    memcpy(d.head, head, d.n_layers * sizeof(NarrowLayer));
  memcpy(d.job, static_cast<const NarrowLayer*>(head) + d.n_layers,
         sizeof(d.job));
  decltype(&launch_narrow<1, false>) fn;
  switch (jobs * 2 + (small ? 1 : 0)) {
    case 2: fn = &launch_narrow<1, false>; break;
    case 4: fn = &launch_narrow<2, false>; break;
    case 8: fn = &launch_narrow<4, false>; break;
    case 3: fn = &launch_narrow<1, true>; break;
    case 5: fn = &launch_narrow<2, true>; break;
    case 9: fn = &launch_narrow<4, true>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = fn(dim3(grid, n_fleet), threads, smem_bytes, s, coords,
                       values, weights, partial, n, d, loss, beta, thres);
  if (err != cudaSuccess) return (int)err;
  const int width = d.n_params + 1, rows = grid * d.groups;
  const dim3 rgrid((width + 255) / 256, n_fleet);
  const float m = (float)((double)n * d.c_out);
  if (n_fleet > 1) {
    reduce_partials_kernel<true><<<rgrid, 256, 0, s>>>(partial, out, rows,
                                                       width, m);
  } else {
    reduce_partials_kernel<false><<<rgrid, 256, 0, s>>>(partial, out, rows,
                                                        width, m);
  }
  return (int)cudaGetLastError();
}

// The tiled layout's blocks per SM (kTiledThreads threads, `smem_bytes`)
// for `jobs` dW jobs a warp (the instance), and the device's SM count.
int brief_fused_train_tiled_occupancy(int jobs, int smem_bytes,
                                      int* blocks_per_sm, int* sm_count) {
  cudaError_t err;
  switch (jobs) {
    case 3: err = tiled_occupancy<3>(smem_bytes, blocks_per_sm); break;
    case 6: err = tiled_occupancy<6>(smem_bytes, blocks_per_sm); break;
    case 9: err = tiled_occupancy<9>(smem_bytes, blocks_per_sm); break;
    case 11: err = tiled_occupancy<11>(smem_bytes, blocks_per_sm); break;
    case 13: err = tiled_occupancy<13>(smem_bytes, blocks_per_sm); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// The tiled layout (ops/fused_train.py tiled_plan).  meta: n_layers, c_in,
// c_out, n_params, mask_width, mt, buf_rows, yw_row, w_floats, mask_sm,
// tab_sm, width_sm, desc_sm, red_off, jobs (dW jobs a warp: the
// instance).  table: device memory, n_layers TiledLayer rows, then the dW
// codes (ops/fused_train.py tiled_table); a layer's mask_off counts only
// when `masks` (B, mask_width) is given.  `grid` blocks in all, shared
// among the B chains by their work (tiled_share_kernel; span: 2 B ints
// of scratch); partial: (grid, n_params + 1) scratch.  The other
// arguments as for brief_fused_train.
int brief_fused_train_tiled(const float* coords, const float* values,
                            const float* weights, const float* params,
                            const float* masks, const float* thres,
                            const void* table, float* partial, int* span,
                            float* out, int n, int n_fleet, const int* meta,
                            int loss, float beta, int grid, int smem_bytes,
                            void* stream) {
  TiledDesc d;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || table == nullptr || span == nullptr || n < 1 ||
      n_fleet < 1 || n_fleet > 65535 || grid < n_fleet)
    return (int)cudaErrorInvalidValue;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.n_params = meta[3];
  d.mask_width = meta[4];
  d.mt = meta[5];
  d.buf_rows = meta[6];
  d.yw_row = meta[7];
  d.w_floats = meta[8];
  d.mask_sm = meta[9];
  d.tab_sm = meta[10];
  d.width_sm = meta[11];
  d.desc_sm = meta[12];
  d.red_off = meta[13];
  d.jobs = meta[14];
  d.n_fleet = n_fleet;
  d.n_tiles = (n + 16 * d.mt - 1) / (16 * d.mt);
  if (d.mt != 2 && d.mt != 4 && d.mt != 8) return (int)cudaErrorInvalidValue;
  d.layer = static_cast<const TiledLayer*>(table);
  decltype(&launch_tiled<3>) fn;
  switch (d.jobs) {
    case 3: fn = &launch_tiled<3>; break;
    case 6: fn = &launch_tiled<6>; break;
    case 9: fn = &launch_tiled<9>; break;
    case 11: fn = &launch_tiled<11>; break;
    case 13: fn = &launch_tiled<13>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  tiled_share_kernel<<<1, kTiledThreads, d.n_layers * sizeof(int), s>>>(
      d, masks, grid, span);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = fn(grid, smem_bytes, s, coords, values, weights, params, masks, thres,
           span, partial, n, d, loss, beta);
  if (err != cudaSuccess) return (int)err;
  const int width = d.n_params + 1;
  reduce_spans_kernel<<<dim3((width + 255) / 256, n_fleet), 256, 0, s>>>(
      partial, span, out, width, (float)((double)n * d.c_out));
  return (int)cudaGetLastError();
}


// The wide layout's blocks per SM (kWideThreads threads, `smem_bytes`)
// at `tile` coordinates a tile, and the device's SM count.
int brief_fused_train_wide_occupancy(int tile, int smem_bytes,
                                     int* blocks_per_sm, int* sm_count) {
  decltype(&wide_occupancy<128>) fn;
  switch (tile) {
    case 128: fn = &wide_occupancy<128>; break;
    case 64: fn = &wide_occupancy<64>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = fn(smem_bytes, blocks_per_sm);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// The wide layout (ops/fused_train.py wide_plan).  meta: n_layers, c_in,
// c_out, n_params, mask_width, np, rows_total, wp_total, part_total,
// rows_max, pack_blocks (blocks of 256 threads a layer for
// pack_weights_kernel).  table: device memory, n_layers wide::Layer rows
// (ops/fused_train.py wide_table); head: the same rows in host memory
// (the dW launches' grids); a layer's mask_off counts only when `masks`
// (B, mask_width) is given.  Scratch the caller allocates: wp (B,
// wp_total) for the packs, scratch (B, rows_total, np) for z / g,
// partial (B, part_total), lossp (B, grid) float64.  `tile` coordinates a tile
// (128 or 64), `grid` blocks a chain.  params (B, n_params); the
// other arguments as for brief_fused_train.
int brief_fused_train_wide(const float* coords, const float* values,
                           const float* weights, const float* params,
                           const float* masks, const float* thres,
                           const void* table, const void* head, float* wp,
                           float* scratch, float* partial, double* lossp,
                           float* out, int n, int n_fleet, const int* meta,
                           int loss, float beta, int grid, int tile,
                           int smem_bytes, void* stream) {
  WideDesc d;
  d.n_layers = meta[0];
  if (d.n_layers < 1 || table == nullptr || head == nullptr || n < 1 ||
      n_fleet < 1 || n_fleet > 65535 || grid < 1)
    return (int)cudaErrorInvalidValue;
  d.coords = coords;
  d.values = values;
  d.weights = weights;
  d.masks = masks;
  d.thres = thres;
  d.params = params;
  d.layer = static_cast<const wl::Layer*>(table);
  d.wp = wp;
  d.scratch = scratch;
  d.partial = partial;
  d.lossp = lossp;
  d.n = n;
  d.c_in = meta[1];
  d.c_out = meta[2];
  d.n_params = meta[3];
  d.mask_width = meta[4];
  d.np = meta[5];
  d.rows_total = meta[6];
  d.wp_total = meta[7];
  d.part_total = meta[8];
  d.rows_max = meta[9];
  const int pack_blocks = meta[10];
  d.kp = tile == 128 ? 8 * WideSlab<128>::kKS : 8 * WideSlab<64>::kKS;
  if (d.np % 128 || d.np < n) return (int)cudaErrorInvalidValue;
  decltype(&launch_wide_tile<128>) fn;
  switch (tile) {
    case 128: fn = &launch_wide_tile<128>; break;
    case 64: fn = &launch_wide_tile<64>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const wl::Layer* rows = static_cast<const wl::Layer*>(head);
  for (int l = 0; l < d.n_layers; ++l)
    if (rows[l].splits < 1 || rows[l].splits > 65535 ||
        rows[l].chunk % kDwChunk)
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  wl::pack_weights_kernel<<<dim3(pack_blocks, d.n_layers, n_fleet), 256, 0,
                            s>>>(params, wp, d.layer, d.n_params,
                                 d.wp_total, d.kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 tgrid(grid, n_fleet);
  err = fn(tgrid, smem_bytes, s, d, 0, 0, loss, beta);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wide_dw_kernel<512>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DwGeom<512>::kSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wide_dw_kernel<256>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DwGeom<256>::kSmem);
  if (err != cudaSuccess) return (int)err;
  for (int l = d.n_layers - 1; l >= 0; --l) {
    if (l > 0) {   // h_l over z_l and g_l first: dW_l reads h_l
      err = fn(tgrid, smem_bytes, s, d, 1, l, loss, beta);
      if (err != cudaSuccess) return (int)err;
    }
    // layers of at most 64 outputs: blocks of 64 columns, 8 warps
    const int i_blocks = (rows[l].fin + kDwI - 1) / kDwI;
    if (rows[l].fout <= 64)
      wide_dw_kernel<256><<<dim3(i_blocks, rows[l].splits, n_fleet), 256,
                             DwGeom<256>::kSmem, s>>>(d, l);
    else
      wide_dw_kernel<512><<<dim3(i_blocks * ((rows[l].fout + 127) / 128),
                                 rows[l].splits, n_fleet),
                            512, DwGeom<512>::kSmem, s>>>(d, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_wide_kernel<<<dim3((d.n_params + 256) / 256, n_fleet), 256, 0, s>>>(
      d, out, grid, (float)((double)n * d.c_out));
  return (int)cudaGetLastError();
}

}  // extern "C"
