#!/usr/bin/env python3
"""Measures the rate of ``mma.sync.aligned.m16n8k8`` TF32 on one card.

    python3 tools/mma_tf32_rate.py [--iters N]

K3's fp32 kernel (``flash_tf32x3_kernel``, brpc_tpu_torch/ops/csrc/
flash_attention.cu) takes its products as m16n8k8 ``mma.sync`` in TF32.
This tool builds a kernel that issues nothing else: every warp loops over
8 independent accumulators, one product each a round, at 1, 2, 4 and 8
warps per SM sub-partition (one block on each SM, 4 sub-partitions each).
It prints the card's name and power limit and one JSON line per setting
with the TF32 rate reached (2 * 16 * 8 * 8 FLOP a product), beside the
card's dense TF32 peak of 495 TFLOP/s (NVIDIA's data sheet, H100 SXM).
Needs a CUDA card and nvcc; builds into a temporary directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_loop(float* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (seed + threadIdx.x + i) & 0x3F800000u;
  for (int i = 0; i < 2; ++i) b[i] = (seed ^ threadIdx.x) & 0x3F800000u;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 12345.f) out[threadIdx.x] = s;  // keeps the products live
}

extern "C" int mma_rate_launch(float* out, int blocks, int threads,
                               int iters, cudaStream_t stream) {
  mma_loop<<<blocks, threads, 0, stream>>>(out, iters, 0x3F800000u);
  return static_cast<int>(cudaGetLastError());
}
"""

TF32_PEAK = 495e12  # dense, H100 SXM (NVIDIA's data sheet)


def _build(tmp: str) -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    src, lib = os.path.join(tmp, "mma_rate.cu"), os.path.join(tmp, "mma.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    fn = ctypes.CDLL(lib).mma_rate_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4096)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mma_tf32_rate: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1024, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        fn = _build(tmp)
        for per_sub in (1, 2, 4, 8):
            threads = 32 * 4 * per_sub  # one block a SM

            def run():
                rc = fn(out.data_ptr(), sms, threads, args.iters, stream)
                if rc:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            for _ in range(3):
                run()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(5):
                run()
            b.record()
            b.synchronize()
            s = a.elapsed_time(b) / 5 / 1e3
            flop = 2.0 * 16 * 8 * 8 * 8 * args.iters * (threads // 32) * sms
            print(json.dumps({
                "warps_per_subpartition": per_sub, "ms": s * 1e3,
                "tf32_tflops": flop / s / 1e12,
                "share_of_peak": flop / s / TF32_PEAK, "card": smi}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
