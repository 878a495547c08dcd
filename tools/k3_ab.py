#!/usr/bin/env python3
"""Times the port's flash carry kernel (K3) of several checkouts on one card.

    python3 tools/k3_ab.py TREE [TREE ...] [--rounds N] [--shapes NAME,...]

Each TREE is the root of a checkout holding ``brpc_tpu_torch/``. Every
round runs the trees in order and then in reverse (A B B A for two), each in
its own process, which builds that tree's kernels and times, with CUDA
events (median of 10 timings of 3 back-to-back calls):

- ``flash_attention_carry`` from a fresh carry at one Llama 3 8B attention
  layer (b1 h32 hkv8 s8192 d128 bf16 causal) and at bench.py's flash point
  (b8 h8 s4096 d128 bf16 non-causal), and SDPA on the same inputs;
- the same at two non-causal shapes with long (16384) and short (1024)
  rows, which separate the kernel's steady rate from its cost per block;
- the Llama layer in fp32 (the kernel's fp32 path; SDPA in fp32, TF32
  off);
- the 16 folds of a 4-shard ring replay of the Llama layer (device time of
  the whole replay, one event pair around it).

Prints the card's name and power limit, one JSON line per run, then the
medians per tree as the last line. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPES = {"llama3_8b_layer": (1, 32, 8, 8192, 128, True, "bfloat16"),
          "bench_flash_point": (8, 8, 8, 4096, 128, False, "bfloat16"),
          # Non-causal with long rows (128 k tiles a block) and short
          # ones (8): the kernel's steady rate and its cost per block.
          "long_rows_s16384": (1, 8, 8, 16384, 128, False, "bfloat16"),
          "short_rows_s1024": (32, 8, 8, 1024, 128, False, "bfloat16"),
          "llama3_8b_layer_fp32": (1, 32, 8, 8192, 128, True, "float32")}
RING_SHARDS = 4


def _cuda_ms(fn, reps=10, inner=3, warm=3):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def one(tree: str, shapes) -> dict:
    """Times one checkout's K3 at ``shapes`` (names of SHAPES) in this
    process."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F

    from brpc_tpu_torch.ops import flash_attention as fa
    from brpc_tpu_torch.ops.ring_attention import hop_offsets

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out = {"tree": tree}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in shapes:
        b, h, hkv, s, d, causal, dtype = SHAPES[name]
        mk = lambda n: torch.randn(b, n, s, d, generator=gen,  # noqa: E731
                                   device="cuda").to(getattr(torch, dtype))
        q, k, v = mk(h), mk(hkv), mk(hkv)
        m, l, acc = fa.flash_init(b, h, s, d, device="cuda")
        out[name] = _cuda_ms(lambda: fa.flash_attention_carry(
            q, k, v, m, l, acc, (0, 0), causal=causal))
        out[name + "_sdpa"] = _cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=hkv != h))
        if name == "llama3_8b_layer":
            n, sq = RING_SHARDS, s // RING_SHARDS
            shards = [(q[:, :, r * sq:(r + 1) * sq].contiguous(),
                       [(qo, ko, k[:, :, ko:ko + sq].contiguous(),
                         v[:, :, ko:ko + sq].contiguous())
                        for qo, ko in (hop_offsets(r, hop, n, sq)
                                       for hop in range(n))])
                      for r in range(n)]

            def ring():
                for qr, hops in shards:
                    carry = fa.flash_init(b, h, sq, d, device="cuda")
                    for qo, ko, kb, vb in hops:
                        carry = fa.flash_attention_carry(
                            qr, kb, vb, *carry, (qo, ko), causal=True)

            out["ring_replay_16_folds"] = _cuda_ms(ring, reps=5, inner=1)
        del q, k, v, m, l, acc
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated names of SHAPES (default: all)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    shapes = args.shapes.split(",")
    unknown = set(shapes) - set(SHAPES)
    if unknown:
        ap.error(f"unknown shapes {sorted(unknown)}; known: {list(SHAPES)}")
    if args.one:
        print(json.dumps(one(args.one, shapes)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k3_ab: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    order = list(args.trees)
    for _ in range(args.rounds):
        for tree in order + order[::-1]:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", tree, "--shapes", args.shapes],
                               capture_output=True, text=True)
            if r.returncode != 0:
                print(r.stdout + r.stderr, file=sys.stderr)
                return 1
            runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    keys = [k for k in runs[0] if k != "tree"]
    summary = {tree: {k: statistics.median(r[k] for r in runs
                                           if r["tree"] == tree)
                      for k in keys} for tree in order}
    print(json.dumps({"card": smi, "median_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
