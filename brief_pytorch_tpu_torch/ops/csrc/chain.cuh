// What the fused kernels share about an activation chain: the activation
// codes, an activation with its derivative, the reader of their per-layer
// tables, and the train kernels' loss (csrc/fused_train.cu,
// csrc/fused_train_stream.cu).
//
// Every kernel keeps its chain's per-layer values (widths, offsets,
// activations, w0, weight pointers) in a table in device memory, one
// 16-byte-aligned row a layer, that the wrapper builds once per chain
// (ops/chain.py layer_table) and passes by pointer: a chain may have any
// number of layers.  The kernels that run at their register limit in
// their hot loops (kernel 1's narrow layout, kernels 2 and 3) also take a
// copy of the first kParamLayers rows among their launch parameters, and
// are compiled twice: for chains of at most kParamLayers layers they read
// that copy (indexed constant loads, which the compiler schedules early
// and reloads rather than keeping live, as it did for the parameter arrays
// these tables replace), for deeper ones the table (layer_field).
#pragma once

#include <cuda_runtime.h>
#include <string.h>

#include "fast_math.cuh"

namespace brief {

constexpr int kParamLayers = 16;   // rows a launch's parameters also hold

enum Act { kActNone = 0, kActSine = 1, kActRelu = 2, kActSigmoid = 3 };

// A row of a per-layer table, read through the read-only cache in 16-byte
// words; the words of fields a caller leaves unused are never loaded.  A
// row is the same for every thread, so each load is one broadcast.
template <class T>
__device__ __forceinline__ T ld_row(const T* p) {
  static_assert(sizeof(T) % 16 == 0 && alignof(T) == 16,
                "a table row is a whole number of 16-byte words");
  int4 w[sizeof(T) / 16];
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 16); ++i)
    w[i] = __ldg(reinterpret_cast<const int4*>(p) + i);
  T r;
  memcpy(&r, w, sizeof(T));
  return r;
}

// One field of a table row, loaded where it is used, through the read-only
// cache.  The load is volatile, so the compiler neither hoists it out of a
// loop nor keeps its value live across one: it treats the field as it would
// an array in the launch's parameter space, which the kernels that run at
// their register limit need (a row held in registers through a layer made
// them spill).
__device__ __forceinline__ int ld_use(const int* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_use(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ const float* ld_use(const float* const* p) {
  unsigned long long v;
  asm volatile("ld.global.nc.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return reinterpret_cast<const float*>(v);
}

// Field f of layer l's row: from the launch parameters' copy `head` (kDeep
// false: a chain of at most kParamLayers layers) or from the table in
// device memory where it is used (kDeep true: any depth).
template <bool kDeep, class Row, class T>
__device__ __forceinline__ T layer_field(const Row* table,
                                         const Row (&head)[kParamLayers],
                                         int l, T Row::*f) {
  if constexpr (kDeep) {
    return ld_use(&(table[l].*f));
  } else {
    return head[l].*f;
  }
}

// Layer l's whole row, from the same place: for the set-up a block does
// once (its weights into shared memory, its dW jobs).
template <bool kDeep, class Row>
__device__ __forceinline__ Row layer_row(const Row* table,
                                         const Row (&head)[kParamLayers],
                                         int l) {
  if constexpr (kDeep) {
    return ld_row(table + l);
  } else {
    return head[l];
  }
}

// act(z) and d act/dz.  For sine one shared range reduction gives both.
__device__ __forceinline__ void act_fwd(int act, float w0, float z, float* h,
                                        float* d) {
  switch (act) {
    case kActSine: {
      float s, c;
      fast_sincos(w0 * z, &s, &c);
      *h = s;
      *d = w0 * c;
      break;
    }
    case kActRelu:
      *h = fmaxf(z, 0.f);
      *d = z > 0.f ? 1.f : 0.f;
      break;
    case kActSigmoid: {
      const float s = 1.f / (1.f + expf(-z));
      *h = s;
      *d = s * (1.f - s);
      break;
    }
    default:
      *h = z;
      *d = 1.f;
  }
}

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

}  // namespace brief
