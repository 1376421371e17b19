#!/usr/bin/env python3
"""Measure what mma.sync.m16n8k8 TF32 (the product the decode and train
kernels issue, csrc/tf32.cuh) delivers on the card: independent
accumulator chains per warp and warps per SM, each SM running one block.

    python3 scripts/mma_tf32_rate.py

Builds a small probe with nvcc into build/ and prints, per shape, the
TFLOP/s and mma a nanosecond per SM, then the card's name and power
limit.  One chain on one warp gives the instruction's latency; many
chains on many warps its peak rate (the data sheet's 495 TFLOP/s TF32 is
wgmma's).
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
template <int C>
__global__ void probe(float* out, int iters) {
  float c[C][4];
  for (int j = 0; j < C; ++j)
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < C; ++j)
    for (int e = 0; e < 4; ++e) s += c[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int C>
void run(int sms, int warps) {
  float* out;
  cudaMalloc(&out, sms * 32 * warps * sizeof(float));
  const int iters = 4096;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  probe<C><<<sms, 32 * warps>>>(out, 16);
  cudaEventRecord(a);
  probe<C><<<sms, 32 * warps>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double mma = (double)sms * warps * C * iters;
  printf("{\"chains\": %d, \"warps_per_sm\": %d, \"ms\": %.4f, "
         "\"tflops\": %.1f, \"mma_per_ns_per_sm\": %.3f}\n",
         C, warps, ms, mma * 2048 / ms / 1e9, mma / sms / (ms * 1e6));
  cudaFree(out);
}
int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  for (int w : {1, 2, 4, 8, 16, 32}) {
    run<1>(sms, w);
    run<8>(sms, w);
  }
  return cudaGetLastError() != cudaSuccess;
}
"""


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, "mma_tf32_rate.cu")
    exe = os.path.join(build, "mma_tf32_rate")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", exe, src], check=True)
    rc = subprocess.run([exe]).returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
