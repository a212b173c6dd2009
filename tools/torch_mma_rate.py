#!/usr/bin/env python3
"""The rate of ``mma.sync.aligned.m16n8k8`` TF32 on one card: the MMA that
K2a and K2b (the flash-attention backward) take every product with.

    python3 tools/torch_mma_rate.py

A throwaway kernel loops over MMAs and nothing else: each warp runs
``chains`` independent accumulator chains, and a launch puts ``blocks``
blocks of 4 warps on each SM. For each (blocks, chains) it prints the
device ms of a launch (CUDA events, the median of 5 after a warm-up), the
TF32 TFLOP/s (2 * 16 * 8 * 8 FLOPs an MMA) and the ns an MMA takes one of
an SM's four schedulers. One chain and one block an SM gives the latency
of a dependent MMA; many chains and blocks its throughput. Prints the
card's name and power limit. Needs a CUDA card and nvcc.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "paddle_tpu_torch", "kernels", "_build", "mma_rate")
ITERS = 8192
SHAPES = ((1, 1), (1, 4), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (8, 8))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int CHAINS>
__global__ void __launch_bounds__(128) mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x % 7 + i));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (threadIdx.x % 5 + i));
  float c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS>
float timed(int blocks, int iters) {
  float* out = nullptr;
  if (cudaMalloc(&out, sizeof(float) * blocks * 128)) return -1.f;
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  float ms[5];
  mma_loop<CHAINS><<<blocks, 128>>>(out, iters);
  for (int r = 0; r < 5; ++r) {
    cudaEventRecord(start);
    mma_loop<CHAINS><<<blocks, 128>>>(out, iters);
    cudaEventRecord(stop);
    cudaEventSynchronize(stop);
    cudaEventElapsedTime(&ms[r], start, stop);
  }
  const bool failed = cudaGetLastError() != cudaSuccess;
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  cudaFree(out);
  if (failed) return -1.f;
  for (int i = 0; i < 5; ++i)  // the median of 5
    for (int j = i + 1; j < 5; ++j)
      if (ms[j] < ms[i]) { const float x = ms[i]; ms[i] = ms[j]; ms[j] = x; }
  return ms[2];
}

extern "C" float mma_rate_ms(int chains, int blocks, int iters) {
  switch (chains) {
    case 1: return timed<1>(blocks, iters);
    case 2: return timed<2>(blocks, iters);
    case 4: return timed<4>(blocks, iters);
    case 8: return timed<8>(blocks, iters);
    default: return -1.f;
  }
}
"""


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_mma_rate: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    src, lib_path = os.path.join(OUT, "mma_rate.cu"), os.path.join(OUT, "libmma_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise SystemExit(f"torch_mma_rate: nvcc failed:\n{proc.stdout}")
    lib = ctypes.CDLL(lib_path)
    lib.mma_rate_ms.argtypes = [ctypes.c_int] * 3
    lib.mma_rate_ms.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for per_sm, chains in SHAPES:
        blocks = per_sm * sms
        ms = lib.mma_rate_ms(chains, blocks, ITERS)
        if ms <= 0:
            raise SystemExit(f"torch_mma_rate: launch failed ({per_sm}, {chains})")
        mmas = blocks * 4 * chains * ITERS
        # an SM's 4 schedulers each take per_sm warps' chains in turn
        ns = ms * 1e6 / (ITERS * per_sm * chains)
        print(f"[mma] {per_sm} block(s) of 4 warps an SM, {chains} chain(s) a "
              f"warp: {ms:.4f} ms, {mmas * 2048 / ms / 1e9:.1f} TFLOP/s of "
              f"TF32, {ns:.3f} ns a scheduler an MMA", flush=True)
    print(cs.card_line())


if __name__ == "__main__":
    main()
