#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (brpc_tpu_torch).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card, the CUDA toolkit (nvcc) and a C++ compiler; builds
the native library (if missing) and the port's CUDA kernels from the
checkout. Phases, each fatal on failure:

  1. set-up: the card's name and power limit, both builds and their times;
  2. kernels vs plain PyTorch, on the card: K1 and K2 at every distinct
     shape of the parameter-server path (GPT-2 small) plus a ragged and a
     1-D one, bit-identical; K3 (flash carry) at one Llama 3 8B attention
     layer (bf16, and fp32 on its tensor-core path) and at bench.py's
     flash point plus edge cases, and at the shapes it once refused (b*h
     65536 on each route; d 320 and 640, the latter in two launches over
     column chunks), within stated tolerances; times at the
     largest shapes beside the bound and a
     library call where one computes the same function (K2 int8's,
     ``codes.view(nb, block) * scale.view(nb, 1)``, held bit for bit);
     K1 in fp16 and bf16 at wte (and a ragged and an unaligned shape), bit
     for bit, timed beside ``torch._fused_sgd_`` on the same dtype; the
     MLA attention pair (the port's own fp32 forward and backward, query-
     key width 192, value 128, causal) against float64 plain attention at
     small ragged shapes and against its plain fp32 version at the MLA +
     MoE stack's layer (2 x 16 x 8192), both passes timed beside SDPA's
     memory-efficient fp32 pair and the 3xTF32 bound;
  3. the parameter-server path: a ParameterServer on the card holding the
     GPT-2 small parameter set (124,439,808 fp32 values, random from
     --seed) serves pulls and int8 pushes over tpu:// to clients in this
     process; the results are held against a plain-PyTorch replay on the
     card, and the kernels' launch counts show the path went through them;
  4. the TensorService paths: train_step at the GPT-2 small MLP width
     (3 steps, bit-identical to a plain replay, 2 K1 launches a step);
     a 4-shard ring replay of the Llama layer through K3 (16 launches),
     equal to one-shot flash attention; the port's ring_attention over 4
     spawned ranks sharing the card over gloo at the same layer, each
     rank's output equal to its replay bit for bit, 3 shifts a rank (each
     one send and one receive of the packed K|V block) and 16 K3
     launches over the ranks, with each rank's ring, its hops alone
     and its folds alone timed; dryrun_multichip(1) on a one-rank NCCL
     group;
  5. the parameter-server fleet at the same GPT-2 small parameter set,
     both shards on the card: install, a raw pull_all, an int8 push_all,
     a second shard joins and the Migrator (on the registry's watch edge)
     reshards 1 -> 2 while a thread keeps pulling (no torn or stale
     tensor), another int8 push_all, one-sided pull_alls on each shard
     against its RPC pulls; the state against a plain replay, placement
     against the ketama plan, launches against the plan's counts;
  6. the training plane at the GPT-2 small MLP stack (768 -> [3072 ->
     768] x 12, 24 layers, 56,623,104 fp32 weights, a batch of 8 x 1024
     tokens): the overlapped parameter-server driver, serial and
     overlapped against a ParameterServer in a process of its own with
     one-sided pulls (the JAX package's set-up; its state and its K1
     count shipped back from that process), int8 against a server in this
     process; the collective data-parallel driver over two CollectiveGroup
     members (raw, int8 with and without error feedback, tracked), a
     2-stage 1F1B pipeline over WirePipe and 2-way tensor parallelism
     (depth cut to 2 blocks); each against a plain replay, bit for bit
     where the arithmetic is the same, at the JAX package's pinned
     tolerance where the batch is split;
  7. single-node streaming serving: the decoder at OpenAI gpt2's
     embedding widths (n_embd 768, vocab 50257, n_ctx 1024 positions; one
     attention layer, as the JAX package's decoder; 41,743,104 fp32
     weights random from --seed) behind a ServingServer on the card
     (max_batch 8, max_len 1024); 16 sessions streamed over tpu:// by
     ServingClients on threads, a group of them sharing a block-aligned
     prompt prefix: monolithic, paged (block_rows 16), and speculative
     (spec_k 4, n-gram and model drafts). Every session's tokens equal
     decode_serial's on the card, the paged and speculative runs equal
     the monolithic one, and no kernel of K1-K3 launches on this path;
  8. the serving fleet at phase 7's decoder and sessions, every member a
     FleetServingServer on the card in this process over one registry
     hub: a traced session migrated A -> B assembled into one trace, a
     drain of A with 16 sessions open (each of A's moves to B and resumes,
     a new open at A answers E_DRAINING) observed by a FleetObserver, a
     one-sided drain with one forced miss taking the bytes path, the
     shared-prefix group migrated between paged members (fewer KV bytes
     than its full planes), and a prefill/decode split against a
     colocated pair. Every stream equals decode_serial's on the card, no
     session stays live on two members, and no kernel of K1-K3 launches;
  9. the parameter server's operator surface at the GPT-2 small
     parameter set on the card: (a) two tenants under a per-tenant quota
     of 2 with 20 ms injected per call — a greedy one pulls the whole set
     int8 with a window of 8 (shed, paced, and complete), a steady one
     pulls one name in a loop (never shed), tenantz accounts for every
     call, then both push int8 and the state equals a plain replay; (b) a
     server with codecs=() serves an int8 client raw; (c) the set in fp16
     takes two raw push_alls through K1's fp16 kernel, equal to the plain
     half replay; (d) a 2-shard fleet, one shard publishing raw and one
     int8, read with FleetClient(oneside=True) equals the RPC pull_alls;
     (e) host only: a gRPC echo and a tidl_gen stub call over the port;
 10. LayeredMLP over a mesh at phase 6's stack and batch: a 2 x 2 (client
     x shard) mesh of 4 spawned ranks sharing the card over gloo, two
     steps overlapped and two serial, and a 1-rank NCCL mesh in this
     process, each under an OverlappedStepDriver whose wire rank (rank
     0) alone reaches a ParameterServer in this process over tpu://;
     losses and final weights against the single-device harness on the
     same driver and server (rtol 2e-5, atol 1e-6), overlapped against
     serial (1e-6), versions == steps, and K1 launched on the server
     once per name per step and never in the ranks; logs each step's
     wall time and the time its collectives took.
 11. the MLA + MoE block stack (models/mla_moe.py) at Moonlight-16B-A3B's
     widths, the benchmark configuration's depth, experts held and
     vocabulary slice (1 dense + 4 MoE layers, experts 0-7 of 64, 20480
     ids) at 2 sequences of 512 positions: one overlapped step under an
     OverlappedStepDriver against a ParameterServer in this process over
     tpu://, its loss and the server's momenta (the step's gradient)
     held against the benchmark's plain reference
     (benchmark/harness/reference_mla_moe.py) dispatching with the
     step's recorded routes (loss within 1e-5, each tensor within 1e-4
     of its largest value), the routes against the reference's own
     choice outside near ties, and K1 launched once per tensor.

Every path runs with the launch counts set to 0 just before it and read
just after.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Deterministic cuBLAS reductions whatever the concurrency: phase 6's
# data-parallel members compute on two threads at once and are held bit
# for bit against a serial replay. Set before CUDA initializes.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# OpenAI's published gpt2 (124M) config.
GPT2_SMALL = {"n_layer": 12, "n_embd": 768, "n_ctx": 1024, "vocab": 50257}
LR, BETA = 0.01, 0.9
PUSHES = 3

# Published device-memory rates (NVIDIA data sheets), bytes/s: the PCIe
# part, else the SXM part ("NVIDIA H100 80GB HBM3").
_HBM_RATE = (("H100 PCIe", 2.0e12), ("H100", 3.35e12))
# Dense bf16 tensor-core peaks, FLOP/s (the same data sheets).
_BF16_RATE = (("H100 PCIe", 756e12), ("H100", 989e12))
# fp32 peaks outside the tensor cores, FLOP/s (the same data sheets): the
# rate K3's fp32 path had on the CUDA cores (flash_simt_kernel), logged as
# a second bound beside the first.
_F32_RATE = (("H100 PCIe", 51e12), ("H100", 67e12))
# Dense TF32 tensor-core peaks, FLOP/s (the same data sheets): K3's fp32
# path (flash_tf32x3_kernel) takes three TF32 products for each fp32 one.
_TF32_RATE = (("H100 PCIe", 378e12), ("H100", 495e12))
# Meta's Llama 3 8B (meta-llama/Meta-Llama-3-8B config.json): 32 attention
# heads, 8 kv heads, hidden 4096 (head dim 128), 8192 positions; one
# attention layer at full context, causal.
LLAMA3_8B_ATTN = {"b": 1, "h": 32, "hkv": 8, "s": 8192, "d": 128,
                  "causal": True}
# The flash point bench.py measured on the TPU (bench.py:3159), non-causal.
BENCH_FLASH = {"b": 8, "h": 8, "hkv": 8, "s": 4096, "d": 128,
               "causal": False}
# GPT-2 small's MLP block (the parameter set of phase 3): 768 -> 3072 ->
# 768, a batch of 8 x 1024 tokens.
TRAIN_STEP = {"batch": 8 * 1024, "din": 768, "dh": 3072, "dout": 768}
TRAIN_STEPS = 3
RING_SHARDS = 4
# Phase 6: GPT-2 small's MLP blocks stacked at full width and depth (n_embd
# 768, n_inner 4 x 768, n_layer 12), one batch of 8 x 1024 tokens.
PLANE = {"sizes": [768] + [3072, 768] * 12, "batch": 8 * 1024,
         "ps_steps": 3, "dp_steps": 2, "pp_steps": 2, "microbatches": 4,
         "tp_sizes": [768, 3072, 768, 3072, 768], "tp_steps": 2}
# Phase 11: the MLA + MoE stack at the benchmark configuration's widths,
# depth, experts held and vocabulary slice, at a short sequence.
# Arenas by the cell's rule (its mix): the server's default 256 MiB
# cannot stage a window of pulls of 92-185 MB tensors.
MLA_MOE = {"config": "benchmark/configs/moonlight-16b-a3b-ep8.json",
           "mix": "benchmark/traffic/mla-moe-own-process.json",
           "batch": 2, "seq": 512, "loss_rtol": 1e-5, "grad_rtol": 1e-4,
           "tie_width": 1e-4}
# Phase 7: the serving decoder at gpt2's embedding widths (n_embd,
# vocab_size, n_ctx as max_pos); 16 sessions, prompts 32-256 tokens,
# budgets 64-256; sessions 0-3 share a 64-token (4-block) prompt prefix.
SERVE = {"vocab": 50257, "dim": 768, "max_pos": 1024, "max_batch": 8,
         "max_len": 1024, "block_rows": 16, "sessions": 16, "spec_k": 4,
         "draft_dim": 64, "prefix": 64, "group": 4}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpt2_shapes(cfg=GPT2_SMALL) -> dict:
    """Hugging Face GPT2Model state-dict names and shapes (buffers
    excluded): 148 tensors."""
    d, v, c = cfg["n_embd"], cfg["vocab"], cfg["n_ctx"]
    shapes = {"wte.weight": (v, d), "wpe.weight": (c, d)}
    for i in range(cfg["n_layer"]):
        h = f"h.{i}."
        shapes.update({
            h + "ln_1.weight": (d,), h + "ln_1.bias": (d,),
            h + "attn.c_attn.weight": (d, 3 * d),
            h + "attn.c_attn.bias": (3 * d,),
            h + "attn.c_proj.weight": (d, d), h + "attn.c_proj.bias": (d,),
            h + "ln_2.weight": (d,), h + "ln_2.bias": (d,),
            h + "mlp.c_fc.weight": (d, 4 * d), h + "mlp.c_fc.bias": (4 * d,),
            h + "mlp.c_proj.weight": (4 * d, d),
            h + "mlp.c_proj.bias": (d,)})
    shapes.update({"ln_f.weight": (d,), "ln_f.bias": (d,)})
    return shapes


def make_params(shapes: dict, seed: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s, dtype=np.float32) * np.float32(0.02)
            for k, s in shapes.items()}


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def published_rate(name: str, table=_HBM_RATE) -> float:
    for key, rate in table:
        if key in name:
            return rate
    fail(f"no published rate for {name!r}")


def cuda_ms(fn, reps: int = 20, inner: int = 10, warm: int = 3) -> float:
    """Per-call device time: the median over ``reps`` CUDA-event timings of
    ``inner`` back-to-back calls, divided by ``inner`` (the host enqueues
    ahead of the card, so the wrapper's own host time stays out)."""
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


# ---------------------------------------------------------------- phase 1

def setup() -> dict:
    from brpc_tpu_torch.ops import _build
    from brpc_tpu_torch.runtime import native

    out, errs = {}, []

    def build_native():
        t0 = time.monotonic()
        try:
            native.lib()
        except Exception as e:  # noqa: BLE001 — reported as a phase fault
            errs.append(f"native build: {e}")
        out["native_build_s"] = time.monotonic() - t0

    def build_kernels():
        t0 = time.monotonic()
        try:
            _build.load()
        except Exception as e:  # noqa: BLE001 — reported as a phase fault
            errs.append(f"kernel build: {e}")
        out["kernel_build_s"] = time.monotonic() - t0

    threads = [threading.Thread(target=build_native),
               threading.Thread(target=build_kernels)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        fail("; ".join(errs))
    log(f"native library {native.library_path()} ready in "
        f"{out['native_build_s']:.1f} s "
        f"(built: {'yes' if out['native_build_s'] > 1 else 'cached'})")
    log(f"kernels built in {out['kernel_build_s']:.1f} s")
    ptxas = [ln.strip() for ln in str(_build.last_build.get("log", ""))
             .splitlines() if "registers" in ln or "Compiling" in ln]
    for ln in ptxas:
        log(f"  ptxas: {ln}")
    return out


# ---------------------------------------------------------------- phase 2

def kernels_vs_plain(seed: int, rate: float) -> list:
    import numpy as np
    import torch

    from brpc_tpu_torch.ops import fused_update as fu
    from brpc_tpu_torch.ops import quantize as qz
    from brpc_tpu_torch.runtime import codec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = sorted(set(gpt2_shapes().values()), key=lambda s: -np.prod(s))
    shapes += [(1000003,), (37, 300)]  # ragged: n % 256 != 0
    errs = {"brpc_fused_momentum": 0.0, "brpc_dequant_int8": 0.0,
            "brpc_dequant_fp8e4m3": 0.0}
    timing = {}
    for shape in shapes:
        n = int(np.prod(shape))
        p, m, g = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
        kp, km = fu.fused_momentum_update(p, m, g, lr=LR, beta=BETA)
        rp, rm = fu.momentum_update_reference(p, m, g, lr=LR, beta=BETA)
        torch.cuda.synchronize()
        err = max((kp - rp).abs().max().item(), (km - rm).abs().max().item())
        errs["brpc_fused_momentum"] = max(errs["brpc_fused_momentum"], err)
        if not (torch.equal(kp, rp) and torch.equal(km, rm)):
            fail(f"brpc_fused_momentum != plain at {shape}: max err {err}")
        if shape == shapes[0]:
            timing["brpc_fused_momentum"] = _time_momentum(p, m, g, n, rate)
        x = p.cpu().numpy()
        for cname, kname, qdtype in (
                ("int8", "brpc_dequant_int8", torch.int8),
                ("fp8e4m3", "brpc_dequant_fp8e4m3", torch.float8_e4m3fn)):
            enc = codec.encode(x, cname, min_bytes=0)
            meta = {"dtype": "<f4", "shape": list(shape), "codec": cname,
                    "block": enc.block}
            q_np, s_np = codec.split_wire(meta, enc.wire)
            q = torch.from_numpy(q_np.copy()).to(dev).view(qdtype)
            s = torch.from_numpy(s_np.copy()).to(dev)
            out = qz.dequantize_blocks(q, s, block=enc.block, n=n,
                                       shape=shape)
            ref = qz.dequantize_reference(q, s, block=enc.block, n=n,
                                          shape=shape)
            err = (out - ref).abs().max().item()
            errs[kname] = max(errs[kname], err)
            if not torch.equal(out, ref):
                fail(f"{kname} != plain at {shape}: max err {err}")
            # And both equal the host codec's decode (the wire's meaning).
            if not np.array_equal(out.cpu().numpy(),
                                  codec.decode(meta, enc.wire)):
                fail(f"{kname} != host decode at {shape}")
            if shape == shapes[0]:
                timing[kname] = _time_dequant(q, s, enc.block, n, shape,
                                              rate)
        log(f"kernels == plain (bit for bit) at {shape}")
    rows = []
    src = {"brpc_fused_momentum": ("brpc_tpu_torch/ops/csrc/fused_update.cu",
                                   "brpc_tpu/ops/fused_update.py:23",
                                   "float32"),
           "brpc_dequant_int8": ("brpc_tpu_torch/ops/csrc/quantize.cu",
                                 "brpc_tpu/ops/quantize.py:32", "int8"),
           "brpc_dequant_fp8e4m3": ("brpc_tpu_torch/ops/csrc/quantize.cu",
                                    "brpc_tpu/ops/quantize.py:32",
                                    "fp8e4m3")}
    for name, t in timing.items():
        log(f"{name} at wte {shapes[0]}: kernel_ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
            f"({t['bound_by']}) library_ms="
            + ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f}"))
        rows.append({"name": name, "ported": True, "route": "cuda",
                     "dtype": src[name][2],
                     "source": src[name][0],
                     "replaces": src[name][1], "launches": None,
                     "max_abs_err": errs[name], **t})
    rows += _half_momentum_rows(seed, rate, shapes[0])
    return rows


# K1 in half precision: the parameter server holds fp16 parameters in phase
# 9; bf16 crosses no wire (numpy has no bf16 dtype), so no path runs it and
# its row is checked here only.
HALF_K1 = (("float16", "brpc_fused_momentum_f16", True),
           ("bfloat16", "brpc_fused_momentum_bf16", False))


def _half_momentum_rows(seed: int, rate: float, wte: tuple) -> list:
    """K1 fp16 and bf16 against the plain version, bit for bit, at wte and
    at a ragged and an unaligned 1-D shape; times at wte beside the bound
    (10 bytes an element) and ``torch._fused_sgd_`` on the same dtype,
    whose difference from the plain version is recorded, not required."""
    import torch

    from brpc_tpu_torch.ops import fused_update as fu

    dev = torch.device("cuda")
    rows = []
    for dname, kname, on_path in HALF_K1:
        dtype = getattr(torch, dname)
        gen = torch.Generator(device=dev).manual_seed(seed * 31 + 7)
        err, timing = 0.0, None
        for shape in (wte, (1000003,), (37, 300)):
            p, m, g = (torch.randn(shape, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            for off in (0, 1):  # 1: an unaligned view, the scalar path
                args = [t.reshape(-1)[off:] if off else t for t in (p, m, g)]
                kp, km = fu.fused_momentum_update(*args, lr=LR, beta=BETA)
                rp, rm = fu.momentum_update_reference(*args, lr=LR,
                                                      beta=BETA)
                torch.cuda.synchronize()
                err = max(err, (kp.float() - rp.float()).abs().max().item(),
                          (km.float() - rm.float()).abs().max().item())
                if not (torch.equal(kp.view(torch.int16),
                                    rp.view(torch.int16))
                        and torch.equal(km.view(torch.int16),
                                        rm.view(torch.int16))):
                    fail(f"{kname} != plain at {shape} (offset {off}): "
                         f"max err {err}")
            if shape == wte:
                n = p.numel()
                timing = {
                    "ms": cuda_ms(lambda: fu.fused_momentum_update(
                        p, m, g, lr=LR, beta=BETA)),
                    "plain_ms": cuda_ms(lambda: fu.momentum_update_reference(
                        p, m, g, lr=LR, beta=BETA)),
                    "bound_ms": _bound(10.0 * n, rate), "bound_by": "bytes"}
                timing.update(_fused_sgd_half(p, m, g))
        log(f"{kname} == plain (bit for bit) at {wte}, (1000003,), "
            f"(37, 300), aligned and unaligned")
        log(f"{kname} at wte {wte}: kernel_ms={timing['ms']:.4f} "
            f"plain_ms={timing['plain_ms']:.4f} "
            f"bound_ms={timing['bound_ms']:.4f} (bytes) library_ms="
            + ("none" if timing["library_ms"] is None
               else f"{timing['library_ms']:.4f}")
            + f" (torch._fused_sgd_ differs from plain by at most "
            f"{timing['library_max_abs_diff']})")
        rows.append({"name": kname, "ported": True, "route": "cuda",
                     "dtype": dname, "on_path": on_path,
                     "source": "brpc_tpu_torch/ops/csrc/fused_update.cu",
                     "replaces": "brpc_tpu/ops/fused_update.py:23",
                     "launches": None, "max_abs_err": err, **timing})
    return rows


def _fused_sgd_half(p, m, g) -> dict:
    """``torch._fused_sgd_`` on the same half tensors: its time, and its
    largest difference from the plain version after one step (it keeps
    the sums in fp32 and rounds once, so it need not equal the plain
    version's rounded ops)."""
    import torch

    from brpc_tpu_torch.ops import fused_update as fu

    def step(pp, mm):
        torch._fused_sgd_(pp, [g], mm, weight_decay=0.0, momentum=BETA,
                          lr=LR, dampening=0.0, nesterov=False,
                          maximize=False, is_first_step=False)

    try:
        pp, mm = [p.clone()], [m.clone()]
        step(pp, mm)
        rp, rm = fu.momentum_update_reference(p, m, g, lr=LR, beta=BETA)
        torch.cuda.synchronize()
        diff = max((pp[0].float() - rp.float()).abs().max().item(),
                   (mm[0].float() - rm.float()).abs().max().item())
        return {"library_ms": cuda_ms(lambda: step(pp, mm)),
                "library_max_abs_diff": diff}
    except (RuntimeError, TypeError, NotImplementedError) as e:
        # No fused SGD for this dtype in this build: no library time.
        log(f"  torch._fused_sgd_ on {p.dtype}: {e}")
        return {"library_ms": None, "library_max_abs_diff": None}


def _bound(nbytes: float, rate: float) -> float:
    """Least ms to move ``nbytes`` through device memory. Both kernels do
    at most 3 fp32 operations per 20 bytes, so their operation time (at
    the card's 67 TFLOP/s fp32) is under 1% of this and never binds."""
    return nbytes / rate * 1e3


def _time_momentum(p, m, g, n, rate) -> dict:
    import torch

    from brpc_tpu_torch.ops import fused_update as fu

    ms = cuda_ms(lambda: fu.fused_momentum_update(p, m, g, lr=LR, beta=BETA))
    plain = cuda_ms(lambda: fu.momentum_update_reference(p, m, g, lr=LR,
                                                         beta=BETA))
    pp, mm = [p.clone()], [m.clone()]
    lib = cuda_ms(lambda: torch._fused_sgd_(
        pp, [g], mm, weight_decay=0.0, momentum=BETA, lr=LR, dampening=0.0,
        nesterov=False, maximize=False, is_first_step=False))
    return {"ms": ms, "plain_ms": plain, "bound_ms": _bound(20.0 * n, rate),
            "bound_by": "bytes",
            "library_ms": lib}


def _time_dequant(q, s, block, n, shape, rate) -> dict:
    """K2's times. For int8 codes one PyTorch call computes the same
    function, ``codes.view(nb, block) * scale.view(nb, 1)`` (int8 x fp32
    promotes to fp32: one exact widening and one multiply); it must equal
    the kernel bit for bit. fp8 has none: torch does not promote
    float8_e4m3fn with float32."""
    import torch

    from brpc_tpu_torch.ops import quantize as qz

    ms = cuda_ms(lambda: qz.dequantize_blocks(q, s, block=block, n=n,
                                              shape=shape))
    plain = cuda_ms(lambda: qz.dequantize_reference(q, s, block=block, n=n,
                                                    shape=shape))
    lib = None
    if q.dtype == torch.int8:
        if n % block:
            fail(f"K2's library call needs whole blocks: n={n} block={block}")
        nb = n // block

        def library():
            return q.view(nb, block) * s.view(nb, 1)

        got = library().view(tuple(shape))
        if got.dtype != torch.float32 or not torch.equal(
                got, qz.dequantize_blocks(q, s, block=block, n=n,
                                          shape=shape)):
            fail("codes.view(nb, block) * scale.view(nb, 1) != "
                 "brpc_dequant_int8")
        log(f"brpc_dequant_int8 == codes.view(nb, block) * "
            f"scale.view(nb, 1), bit for bit, at {tuple(shape)}")
        lib = cuda_ms(library)
    return {"ms": ms, "plain_ms": plain,
            "bound_ms": _bound(float(n + 4 * s.numel() + 4 * n), rate),
            "bound_by": "bytes",
            "library_ms": lib}


# ---------------------------------------------------------------- phase 2, K3

# K3 against its plain version run with the kernel's own k tile
# (flash_attention.kernel_tile_k) and the kernel's ragged last tile, so both
# step the running max and round p at the same places. Tolerances: m to 1e-4 (the same fp32 dot products
# summed in another order); l to 1e-4 relative; acc/l to 4e-3 for bf16
# inputs (a p whose bf16 rounding flips with that order moves one key's
# weight by one bf16 step, 2^-8) and 1e-4 for fp32; the finalized output in
# the input type to that plus one step of its own rounding.
FLASH_TOL = {"m": 1e-4, "l": 1e-4, "bf16": 4e-3, "f32": 1e-4}


def _qkv(b, h, hkv, sq, d, dtype, seed, sk=None):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    sk = sq if sk is None else sk
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(b, h, sq, d), mk(b, hkv, sk, d), mk(b, hkv, sk, d)


def _flash_case(label, q, k, v, carry, offsets, causal,
                kernel=None) -> float:
    """Kernel vs plain on one input; returns max |acc/l| error. ``kernel``:
    the kernel the dispatch must pick for these operands (else any)."""
    import torch

    from brpc_tpu_torch.ops import flash_attention as fa

    m, l, acc = carry
    name = fa.kernel_name(q, k, v, acc)
    if kernel is not None and name != kernel:
        fail(f"K3 {label}: dispatched to {name}, not {kernel}")
    off = torch.tensor(offsets, dtype=torch.int32, device=q.device)
    km, kl, ka = fa.flash_attention_carry(q, k, v, m, l, acc, off,
                                          causal=causal)
    rm, rl, ra = fa.flash_carry_reference(
        q, k, v, m, l, acc, offsets, causal=causal,
        block_k=fa.kernel_tile_k(q, k, v, acc), ragged_tail=True)
    torch.cuda.synchronize()
    for t in (km, kl, ka):
        if not bool(torch.isfinite(t).all()):
            fail(f"K3 {label}: non-finite carries")
    err_m = (km - rm).abs().max().item()
    err_l = ((kl - rl).abs() / rl.abs().clamp_min(1e-30)).max().item()
    ko, ro = (fa.flash_finalize(kl, ka, torch.float32),
              fa.flash_finalize(rl, ra, torch.float32))
    err_o = (ko - ro).abs().max().item()
    tol_o = FLASH_TOL["bf16" if q.dtype == torch.bfloat16 else "f32"]
    step = 2.0 ** -8 if q.dtype == torch.bfloat16 else 2.0 ** -23
    out_k = fa.flash_finalize(kl, ka, q.dtype).float()
    out_r = fa.flash_finalize(rl, ra, q.dtype).float()
    err_out = ((out_k - out_r).abs() - step * out_r.abs()).max().item()
    log(f"K3 {label} ({name}): q {tuple(q.shape)} kv {tuple(k.shape)} "
        f"{q.dtype} offsets {offsets} causal={causal}: max err m {err_m:.3g} "
        f"l(rel) {err_l:.3g} acc/l {err_o:.3g} out {err_out:.3g}")
    if (err_m > FLASH_TOL["m"] or err_l > FLASH_TOL["l"] or err_o > tol_o
            or err_out > tol_o):
        fail(f"K3 {label} disagrees with its plain version beyond "
             f"{FLASH_TOL}")
    return err_o


def _flash_timing(q, k, v, causal, rate, flops_rate, reps=10,
                  inner=3) -> dict:
    """kernel / plain / SDPA ms at a fresh-carry full pass, and the bound:
    4*d FLOP per (query, legal key) pair (q.k and p.v) at ``flops_rate``
    (the card's peak for the input type, per FLOP of the function), or the
    bytes (q, the k and v rows some query can see, and the carries in;
    carries out)."""
    import torch
    import torch.nn.functional as F

    from brpc_tpu_torch.ops import flash_attention as fa

    b, h, s, d = q.shape
    sk = k.shape[2]
    m, l, acc = fa.flash_init(b, h, s, d, device=q.device)
    ms = cuda_ms(lambda: fa.flash_attention_carry(q, k, v, m, l, acc, (0, 0),
                                                  causal=causal),
                 reps=reps, inner=inner)
    tile = fa.kernel_tile_k(q, k, v, acc)
    plain = cuda_ms(lambda: fa.flash_carry_reference(
        q, k, v, m, l, acc, (0, 0), causal=causal, block_k=tile,
        ragged_tail=True),
        reps=3, inner=1, warm=1)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=k.shape[1] != h),
        reps=reps, inner=inner)
    diag = min(s, sk)  # causal from (0, 0): row i attends keys 0..i
    pairs = (diag * (diag + 1) // 2 + max(0, s - sk) * sk if causal
             else s * sk)
    flops = 4.0 * b * h * d * pairs
    live = diag if causal else sk  # keys past the last row's are not read
    nbytes = (q.numel() * q.element_size()
              + sum(t[:, :, :live].numel() * t.element_size() for t in (k, v))
              + 2 * sum(t.numel() * 4 for t in (m, l, acc)))
    t_ops, t_bytes = flops / flops_rate * 1e3, nbytes / rate * 1e3
    return {"ms": ms, "plain_ms": plain, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib, "flop": flops, "bytes": nbytes,
            "tflops": flops / ms / 1e9}


def flash_vs_plain(seed: int, rate: float, flops_rate: float,
                   f32_rate: float, tf32_rate: float) -> dict:
    import torch

    from brpc_tpu_torch.ops import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    errs, timing = [], {}
    for label, cfg in (("Llama 3 8B layer", LLAMA3_8B_ATTN),
                       ("bench.py flash point", BENCH_FLASH)):
        b, h, hkv, s, d = (cfg[x] for x in ("b", "h", "hkv", "s", "d"))
        q, k, v = _qkv(b, h, hkv, s, d, bf16, seed)
        errs.append(_flash_case(label, q, k, v,
                                fa.flash_init(b, h, s, d, device="cuda"),
                                (0, 0), cfg["causal"]))
        timing[label] = _flash_timing(q, k, v, cfg["causal"], rate,
                                      flops_rate)
        del q, k, v
    # fp32 (flash_tf32x3_kernel, 3xTF32 on the tensor cores) at the Llama
    # layer: held against its plain version there, timed beside SDPA in
    # fp32; bound by three TF32 products for each fp32 one at the dense
    # TF32 peak, and, for comparison with the CUDA-core kernel it
    # replaced, by the fp32 FMA peak.
    c = LLAMA3_8B_ATTN
    tc = "flash_tf32x3_kernel"
    q, k, v = _qkv(c["b"], c["h"], c["hkv"], c["s"], c["d"], f32, seed)
    f32_err = _flash_case("Llama 3 8B layer, fp32", q, k, v,
                          fa.flash_init(c["b"], c["h"], c["s"], c["d"],
                                        device="cuda"), (0, 0), c["causal"],
                          kernel=tc)
    errs.append(f32_err)
    f32_t = _flash_timing(q, k, v, c["causal"], rate, tf32_rate / 3,
                          reps=5, inner=2)
    f32_t["fma_bound_ms"] = f32_t["flop"] / f32_rate * 1e3
    timing["Llama 3 8B layer, fp32"] = f32_t
    del q, k, v
    # fp32 on the tensor cores: first exactly the two calls
    # dryrun_multichip(1) makes (the single-head ring, non-causal, and the
    # GQA causal ring; sq and sk both under one tile, so keys past sk are
    # masked with causal off), then wider ones: d = 256 (32-key tiles, 64
    # rows a block), a ragged last tile of 40 keys under a diagonal that
    # crosses tiles mid-way.
    for label, shape, causal, offsets, sk in (
            ("dryrun single-head ring", (2, 1, 1, 4, 8), False, (0, 0),
             None),
            ("dryrun GQA causal ring", (2, 4, 2, 8, 8), True, (0, 0), None),
            ("f32 d=8 s=64", (2, 4, 2, 64, 8), True, (0, 0), None),
            ("f32 d=64 s=256", (2, 4, 4, 256, 64), False, (0, 0), None),
            ("f32 d=256", (1, 4, 2, 300, 256), True, (36, 0), 333),
            ("f32 ragged sk, diagonal mid-tile", (1, 8, 2, 1000, 128), True,
             (24, 0), 1000)):
        b, h, hkv, s, d = shape
        q, k, v = _qkv(b, h, hkv, s, d, f32, seed + 1, sk=sk)
        errs.append(_flash_case(label, q, k, v,
                                fa.flash_init(b, h, s, d, device="cuda"),
                                offsets, causal, kernel=tc))
    # Views the dispatch leaves on flash_simt_kernel<float>: d % 4 != 0
    # (rows that are not 16-byte multiples), and a view 4 bytes off.
    simt = "flash_simt_kernel"
    q, k, v = _qkv(1, 4, 2, 200, 6, f32, seed + 5, sk=300)
    errs.append(_flash_case("f32 d=6", q, k, v,
                            fa.flash_init(1, 4, 200, 6, device="cuda"),
                            (100, 0), True, kernel=simt))
    q, k, v = (_qkv(1, 4, 2, 200, 64, f32, seed + 6, sk=300)[i]
               for i in range(3))
    q, k, v = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
               for t in (q, k, v))
    errs.append(_flash_case("f32 misaligned view", q, k, v,
                            fa.flash_init(1, 4, 200, 64, device="cuda"),
                            (100, 0), True, kernel=simt))
    del q, k, v
    # One ring hop of the Llama layer over 4 shards, in bf16 and in fp32:
    # rank 1 folds its own (diagonal) block into a carry that already holds
    # rank 0's block — every q tile meets fully masked k tiles past the
    # diagonal; the offsets are read from the device.
    c = LLAMA3_8B_ATTN
    sq = c["s"] // RING_SHARDS
    for dtype, kernel in ((bf16, "flash_ws_kernel"), (f32, tc)):
        q, k, v = _qkv(c["b"], c["h"], c["hkv"], sq, c["d"], dtype, seed + 2)
        k0, v0 = _qkv(c["b"], c["hkv"], c["hkv"], sq, c["d"], dtype,
                      seed + 3)[1:]
        carry = fa.flash_carry_reference(
            q, k0, v0, *fa.flash_init(c["b"], c["h"], sq, c["d"],
                                      device="cuda"),
            (sq, 0), causal=True, block_k=64)
        errs.append(_flash_case(f"ring hop, diagonal, {dtype}", q, k, v,
                                carry, (sq, sq), True, kernel=kernel))
        # A hop wholly after the queries: nothing folds, the carry comes
        # back.
        got = fa.flash_attention_carry(q, k, v, *carry, (sq, 2 * sq),
                                       causal=True)
        if not all(torch.equal(a, b) for a, b in zip(got, carry)):
            fail(f"K3 {kernel}: a fully masked hop changed the carry")
        log(f"K3 fully masked hop ({kernel}): carry unchanged (bit for bit)")
        del q, k, v, k0, v0, carry, got
    # Ragged q rows (not a multiple of the 128-row tile), both paths.
    for label, shape, dtype in (("ragged bf16", (1, 8, 2, 1000, 128), bf16),
                                ("ragged f32 d=40", (1, 4, 2, 1000, 40),
                                 f32)):
        b, h, hkv, s, d = shape
        q, k, v = _qkv(b, h, hkv, s, d, dtype, seed + 4, sk=1024)
        errs.append(_flash_case(label, q, k, v,
                                fa.flash_init(b, h, s, d, device="cuda"),
                                (24, 0), True))
    # Shapes the reference folds that K3 once refused: b*h = 65536 (one
    # q tile a head; the grid is 1-D on every route) and d past 256 on
    # flash_simt_kernel (at 640 its tiles outgrow a block's shared
    # memory: two launches over column chunks of acc), each held against
    # its plain version and timed beside it and SDPA; bound as the rows
    # above (fp32 at three TF32 products a product).
    c4 = []
    for label, shape, sk, dtype, kernel, offsets in (
            ("b*h 65536", (2048, 32, 8, 64, 64), 128, bf16,
             "flash_ws_kernel", (64, 0)),
            ("b*h 65536", (2048, 32, 8, 64, 64), 128, f32, tc, (64, 0)),
            ("b*h 65536", (2048, 32, 8, 64, 48), 128, bf16, simt, (64, 0)),
            ("d=320", (1, 8, 2, 1024, 320), 1024, bf16, simt, (128, 0)),
            ("d=320", (1, 8, 2, 1024, 320), 1024, f32, simt, (128, 0)),
            ("d=640", (1, 8, 2, 1024, 640), 1024, bf16, simt, (128, 0)),
            ("d=640", (1, 8, 2, 1024, 640), 1024, f32, simt, (128, 0))):
        b, h, hkv, s, d = shape
        q, k, v = _qkv(b, h, hkv, s, d, dtype, seed + 7, sk=sk)
        err = _flash_case(f"{label} {dtype}", q, k, v,
                          fa.flash_init(b, h, s, d, device="cuda"), offsets,
                          True, kernel=kernel)
        errs.append(err)
        t = _flash_timing(q, k, v, True, rate, flops_rate if dtype == bf16
                          else tf32_rate / 3, reps=5, inner=2)
        chunks = fa.simt_launches(d) if kernel == simt else 1
        log(f"K3 {label} {dtype} ({kernel}, {chunks} launch(es) a fold): "
            f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) "
            f"library_ms(SDPA)={t['library_ms']:.4f}")
        c4.append({"shape": f"b{b} h{h} hkv{hkv} sq{s} sk{sk} d{d} "
                            f"{dtype} causal, offsets {offsets}",
                   "kernel": kernel, "launches_a_fold": chunks,
                   "max_abs_err": err,
                   **{key: t[key] for key in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}})
        del q, k, v
    main, second = timing["Llama 3 8B layer"], timing["bench.py flash point"]
    f32_t = timing["Llama 3 8B layer, fp32"]
    for label, t in timing.items():
        log(f"K3 {label}: kernel_ms={t['ms']:.4f} plain_ms="
            f"{t['plain_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
            f"({t['bound_by']}) library_ms(SDPA)={t['library_ms']:.4f}; "
            f"{t['tflops']:.1f} TFLOP/s")
    log(f"K3 Llama 3 8B layer, fp32: bound_ms={f32_t['bound_ms']:.4f} as "
        f"3xTF32 at {tf32_rate / 1e12:.0f} TFLOP/s dense TF32; "
        f"fma_bound_ms={f32_t['fma_bound_ms']:.4f} at the fp32 FMA peak "
        f"{f32_rate / 1e12:.0f} TFLOP/s; kernel at "
        f"{f32_t['bound_ms'] / f32_t['ms']:.1%} of the first, "
        f"{f32_t['fma_bound_ms'] / f32_t['ms']:.1%} of the second")
    log("K3 build: " + _flash_build_report())
    return {"name": "brpc_flash_carry", "ported": True, "route": "cuda",
            "source": "brpc_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "brpc_tpu/ops/flash_attention.py:47",
            "launches": None, "max_abs_err": max(errs),
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "shape": "Llama 3 8B attention layer, b1 h32 hkv8 s8192 d128 "
                     "bf16 causal",
            "second_shape": {"shape": "bench.py flash point, b8 h8 s4096 "
                                      "d128 bf16 non-causal",
                             **{key: second[key] for key in (
                                 "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}},
            "f32_shape": {"shape": "Llama 3 8B attention layer, b1 h32 hkv8 "
                                   "s8192 d128 fp32 causal "
                                   "(flash_tf32x3_kernel, 3xTF32 mma.sync); "
                                   "bound: 3 TF32 products a product at "
                                   f"{tf32_rate / 1e12:.0f} TFLOP/s dense "
                                   "TF32; fma_bound_ms: the fp32 FMA peak "
                                   f"{f32_rate / 1e12:.0f} TFLOP/s",
                          "kernel": tc, "launches": None,
                          "max_abs_err": f32_err,
                          **{key: f32_t[key] for key in (
                              "ms", "plain_ms", "bound_ms", "bound_by",
                              "fma_bound_ms", "library_ms")}},
            "c4_shapes": c4}


def _flash_build_report() -> str:
    """Registers and spills ptxas reported for each K3 kernel, and the
    dynamic shared memory a launch of each tensor-core kernel asks for."""
    import ctypes
    import re

    from brpc_tpu_torch.ops import _build

    log_text = str(_build.last_build.get("log", ""))
    found, kernel = [], None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S*flash_(ws|simt|tf32x3)"
                      r"_kernelI(Li(\d+)E|f|13__nv_bfloat16)\S*)'", ln)
        if m:
            kernel = (f"flash_{m.group(2)}_kernel<{m.group(4)}>"
                      if m.group(4) else "flash_simt_kernel<"
                      + ("float" if m.group(3) == "f" else "bf16") + ">")
        elif kernel and "spill" in ln:
            found.append(f"{kernel}: {ln.strip()}")
        elif kernel and "registers" in ln:
            found[-1] += "; " + ln.strip().replace("ptxas info    : ", "")
            kernel = None
    fn = _build.kernel("brpc_flash_ws_smem", [ctypes.c_int])
    smem = {d: int(fn(d)) for d in (64, 128)}
    fn = _build.kernel("brpc_flash_tf32x3_smem", [ctypes.c_int])
    smem_tc = {d: int(fn(d)) for d in (8, 16, 32, 64, 128, 256)}
    if not found:  # a cached library: this process did not build it
        found = ["ptxas report: not in this process (library cached)"]
    return ("; ".join(found) + f"; dynamic shared memory a block: "
            f"flash_ws_kernel d=64 {smem[64]} B, d=128 {smem[128]} B "
            "(setmaxnreg: producer 24, consumers 240 registers); "
            "flash_tf32x3_kernel " + ", ".join(
                f"d<={d} {b} B" for d, b in smem_tc.items()))


# ---------------------------------------------------------------- phase 2, MLA

# The MLA + MoE stack's attention layer (benchmark/configs/moonlight-16b-
# a3b-ep8.json: 16 heads, query-key width 128 + 64, value width 128) at the
# cell's batch and context: 2 sequences of 8192 positions, causal, fp32.
MLA_LAYER = {"b": 2, "h": 16, "s": 8192}
# The MLA pair against plain attention, each tensor's largest error over
# its largest reference value: 1e-5 against float64 at small ragged shapes
# (the CPU emulation of the kernels' arithmetic reads up to 5.5e-7, plain
# TF32 from 5.6e-5: tests/test_torch_mla_attn.py), 2e-5 against the plain
# fp32 version at the layer (both fp32 over 8192-key sums).
MLA_TOL = {"f64": 1e-5, "f32": 2e-5}


def _mla_inputs(b, h, s, seed):
    """q, k [b, h, s, 192], v [b, h, s, 128] as models/mla_moe.py lays
    them out (v a view of the latent up-projection's output), and do."""
    import torch

    from brpc_tpu_torch.ops import mla_attention as mla

    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *sh: torch.randn(*sh, generator=g, device="cuda")  # noqa: E731
    v = mk(b, s, h, 128 + mla.DV).transpose(1, 2).split([128, mla.DV],
                                                        dim=-1)[1]
    return mk(b, h, s, mla.DQK), mk(b, h, s, mla.DQK), v, mk(b, h, s, mla.DV)


def _mla_plain(q, k, v, do, scale, dtype, heads):
    """(o, lse, dq, dk, dv) of plain attention in ``dtype``, ``heads``
    heads at a time (the score matrix whole)."""
    import torch

    from brpc_tpu_torch.ops import mla_attention as mla

    parts = []
    for h0 in range(0, q.shape[1], heads):
        sl = slice(h0, h0 + heads)
        leaves = [t[:, sl].to(dtype).requires_grad_() for t in (q, k, v)]
        o, lse = mla.reference(*leaves, scale)
        parts.append((o.detach(), lse.detach(),
                      *torch.autograd.grad(o, leaves, do[:, sl].to(dtype))))
    return [torch.cat(ts, dim=1) for ts in zip(*parts)]


def _mla_errs(got, want) -> dict:
    return {n: ((a.double() - b.double()).abs().max()
                / b.double().abs().max()).item()
            for n, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want)}


def mla_vs_plain(seed: int, tf32_rate: float) -> list:
    """The MLA pair (brpc_mla_attn_fwd, brpc_mla_attn_bwd) against plain
    attention, and both passes timed at the stack's layer beside SDPA's
    memory-efficient fp32 pair, the plain version, and the bound: 640 FLOP
    a legal (query, key) pair and head forward, 1664 backward (q.k^T at
    192, p.v and do.v^T at 128 forward; q.k^T, do.v^T, p^T.do, ds^T.q and
    ds.k backward), three TF32 products for each at the dense TF32
    peak."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from brpc_tpu_torch.ops import mla_attention as mla

    scale = mla.DQK ** -0.5
    worst = {}
    for shape in ((1, 2, 200), (2, 3, 77), (1, 1, 129), (1, 2, 300)):
        q, k, v, do = _mla_inputs(*shape, seed + sum(shape))
        if not mla.takes(q, k, v):
            fail(f"MLA {shape}: the kernels do not take the model's layout")
        o, lse = mla.forward_kernel(q, k, v, scale)
        got = (o, lse, *mla.backward_kernel(q, k, v, o, lse, do, scale))
        err = _mla_errs(got, _mla_plain(q, k, v, do, scale, torch.float64,
                                        shape[1]))
        log(f"MLA b{shape[0]} h{shape[1]} s{shape[2]} vs float64: "
            + ", ".join(f"{n} {e:.3g}" for n, e in err.items()))
        if max(err.values()) > MLA_TOL["f64"]:
            fail(f"MLA {shape}: the kernels disagree with float64 beyond "
                 f"{MLA_TOL['f64']}")
        worst = {n: max(e, worst.get(n, 0.0)) for n, e in err.items()}
    b, h, s = (MLA_LAYER[x] for x in ("b", "h", "s"))
    q, k, v, do = _mla_inputs(b, h, s, seed)
    o, lse = mla.forward_kernel(q, k, v, scale)
    grads = mla.backward_kernel(q, k, v, o, lse, do, scale)
    want = _mla_plain(q, k, v, do, scale, torch.float32, 2)
    err = _mla_errs((o, lse, *grads), want)
    del want
    log("MLA layer vs its plain fp32 version: " + ", ".join(
        f"{n} {e:.3g}" for n, e in err.items()))
    if max(err.values()) > MLA_TOL["f32"]:
        fail(f"MLA layer: the kernels disagree with the plain version "
             f"beyond {MLA_TOL['f32']}")
    # Heads 0-1 of the first sequence against float64: the kernels, SDPA's
    # pair and the plain fp32 version, for the record.
    sl = (slice(0, 1), slice(0, 2))
    part = [t[sl] for t in (q, k, v, do)]
    f64 = _mla_plain(*part, scale, torch.float64, 2)
    leaves = [t.detach().clone().requires_grad_() for t in part[:3]]
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        so = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                            scale=scale)
    sdpa = (so.detach(), f64[1].float(),
            *torch.autograd.grad(so, leaves, part[3]))
    for label, got in (("kernels", (o[sl], lse[sl], *(g[sl] for g in grads))),
                       ("SDPA", sdpa),
                       ("plain fp32", _mla_plain(*part, scale, torch.float32,
                                                 2))):
        log(f"MLA layer heads 0-1 vs float64, {label}: " + ", ".join(
            f"{n} {e:.3g}" for n, e in _mla_errs(got, f64).items()
            if not (label == "SDPA" and n == "lse")))
    del f64, sdpa, so, leaves, part
    pairs = b * h * s * (s + 1) / 2
    bound = {"fwd": 640 * pairs / (tf32_rate / 3) * 1e3,
             "bwd": 1664 * pairs / (tf32_rate / 3) * 1e3}
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        so = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                            scale=scale)
        lib = {"fwd": cuda_ms(lambda: F.scaled_dot_product_attention(
                   qq, kk, vv, is_causal=True, scale=scale), reps=5, inner=2),
               "bwd": cuda_ms(lambda: torch.autograd.grad(
                   so, (qq, kk, vv), do, retain_graph=True), reps=5,
                   inner=2)}
    del so, qq, kk, vv
    ms = {"fwd": cuda_ms(lambda: mla.forward_kernel(q, k, v, scale), reps=5,
                         inner=2),
          "bwd": cuda_ms(lambda: mla.backward_kernel(q, k, v, o, lse, do,
                                                     scale), reps=5, inner=2)}

    def plain_fwd():
        for h0 in range(0, h, 2):
            mla.reference(q[:, h0:h0 + 2], k[:, h0:h0 + 2], v[:, h0:h0 + 2],
                          scale)

    plain = {"fwd": cuda_ms(plain_fwd, reps=3, inner=1, warm=1),
             "bwd": cuda_ms(lambda: _mla_plain(q, k, v, do, scale,
                                               torch.float32, 2),
                            reps=3, inner=1, warm=1)}
    plain["bwd"] = max(plain["bwd"] - plain["fwd"], 0.0)
    rows = []
    for kind, what in (("fwd", "forward: o and each row's log-sum-exp"),
                       ("bwd", "backward: D, then dq, dk, dv")):
        flop = (640 if kind == "fwd" else 1664) * pairs
        log(f"MLA {kind} at the layer: kernel_ms={ms[kind]:.4f} "
            f"plain_ms={plain[kind]:.4f} bound_ms={bound[kind]:.4f} "
            f"(operations, 3xTF32 at {tf32_rate / 1e12:.0f} TFLOP/s) "
            f"library_ms(SDPA efficient)={lib[kind]:.4f}; "
            f"{flop / ms[kind] / 1e9:.1f} TFLOP/s, "
            f"{bound[kind] / ms[kind]:.1%} of the bound")
        rows.append({"name": f"brpc_mla_attn_{kind}", "ported": False,
                     "route": "cuda",
                     "source": "brpc_tpu_torch/ops/csrc/mla_attention.cu",
                     "replaces": None, "what": what,
                     "library": "scaled_dot_product_attention, memory-"
                                "efficient backend, fp32",
                     "launches": None,
                     "max_abs_err": max(worst[n] for n in (
                         ("o", "lse") if kind == "fwd" else
                         ("dq", "dk", "dv"))),
                     "ms": ms[kind], "plain_ms": plain[kind],
                     "bound_ms": bound[kind], "bound_by": "operations",
                     "library_ms": lib[kind], "flop": flop,
                     "shape": f"b{b} h{h} s{s} qk 192 v 128 fp32 causal"})
    return rows


# ---------------------------------------------------------------- phase 3

def main_path(seed: int) -> dict:
    """Serve the parameter set over tpu:// and drive pulls and int8
    pushes through the public entry points; hold every result against a
    plain-PyTorch replay. Returns the launch counts of the run."""
    import numpy as np
    import torch

    from brpc_tpu_torch.ops import fused_update as fu
    from brpc_tpu_torch.observability import metrics
    from brpc_tpu_torch.ops import quantize as qz
    from brpc_tpu_torch.runtime import codec, native
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)
    from brpc_tpu_torch.runtime.tensor import TensorArena

    shapes = gpt2_shapes()
    names = sorted(shapes)
    dev = torch.device("cuda")
    total_bytes = 4 * sum(int(np.prod(s)) for s in shapes.values())
    n_elig = sum(1 for s in shapes.values()
                 if 4 * int(np.prod(s)) >= codec.MIN_QUANT_BYTES)
    largest = max(4 * int(np.prod(s)) for s in shapes.values())
    srv_arena_b = max(64 << 20, 2 * largest + (256 << 20))
    cli_arena_b = max(64 << 20, largest + (256 << 20))
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    need = srv_arena_b + 2 * cli_arena_b + (256 << 20)
    log(f"/dev/shm free {free / 2**30:.2f} GiB, arenas need "
        f"{need / 2**30:.2f} GiB")
    if free < need:
        fail(f"/dev/shm has {free} bytes free, the arenas need {need}")
    log(f"parameter set: {len(shapes)} tensors, "
        f"{total_bytes // 4} values, {total_bytes / 1e6:.1f} MB; "
        f"{n_elig} eligible for int8")

    t0 = time.monotonic()
    host = make_params(shapes, seed)
    ps = ParameterServer(host, lr=LR, momentum=BETA,
                         arena=TensorArena(srv_arena_b), device=dev)
    port = ps.start()
    addr = f"tpu://127.0.0.1:{port}"
    qcl = ParameterClient(addr, arena=TensorArena(cli_arena_b),
                          codec="int8", device=dev)
    rcl = ParameterClient(addr, arena=TensorArena(64 << 20), device=dev)
    fcl = ParameterClient(addr, arena=TensorArena(64 << 20),
                          codec="fp8e4m3", device=dev)
    for cl in (qcl, rcl, fcl):
        cl.meta()
    ici = native.dump_ici()
    if "active=1" not in ici or "active=0" in ici:
        fail(f"tpu:// did not upgrade to the shared-memory path:\n{ici}")
    log(f"set-up {time.monotonic() - t0:.2f} s; tpu:// endpoints active: "
        f"{ici.count('active=1')}")
    times = {}
    try:
        for c in _counts().values():
            c.reset()

        def phase(label, fn, nbytes):
            torch.cuda.synchronize()
            t = time.monotonic()
            r = fn()
            torch.cuda.synchronize()
            dt = time.monotonic() - t
            times[label] = dt
            log(f"{label}: {dt:.3f} s, {nbytes / dt / 1e9:.3f} GB/s "
                "effective (logical fp32 bytes)")
            return r

        pulled0 = phase("pull_all raw (v0)", rcl.pull_all, total_bytes)
        for k in names:
            v, t = pulled0[k]
            if v != 0 or not torch.equal(t.cpu(), torch.from_numpy(host[k])):
                fail(f"raw pull of {k} at v0 != the seeded tensor")

        gen = torch.Generator(device=dev)
        ref_p = {k: torch.from_numpy(host[k]).to(dev) for k in names}
        ref_m = {k: torch.zeros_like(v) for k, v in ref_p.items()}
        ef = codec.ErrorFeedback()
        for step in range(PUSHES):
            gen.manual_seed(seed * 1000 + step + 1)
            grads = {k: torch.randn(shapes[k], generator=gen, device=dev)
                     * 1e-3 for k in names}
            vers = phase(f"push_all int8 #{step + 1}",
                         lambda: qcl.push_all(grads), total_bytes)
            if vers != {k: step + 1 for k in names}:
                fail(f"push {step + 1} versions: {vers}")
            # Plain replay: the exact wire codes (same host bytes, same
            # error feedback), dequantize_reference, then the plain update.
            # Its host half is the client's own push work, timed as the
            # breakdown of the push phase.
            t_d2h = t_enc = 0.0
            for k in names:
                g = grads[k]
                if codec.eligible(g):
                    t = time.monotonic()
                    host_g = g.cpu().numpy()
                    t_d2h += time.monotonic() - t
                    t = time.monotonic()
                    x = ef.compensate(k, host_g)
                    e = codec.encode(x, "int8")
                    ef.settle(k, x, e.dequantized())
                    t_enc += time.monotonic() - t
                    meta = {"dtype": "<f4", "shape": list(shapes[k]),
                            "codec": "int8", "block": e.block}
                    q, s = codec.split_wire(meta, e.wire)
                    g = qz.dequantize_reference(
                        torch.from_numpy(q.copy()).to(dev),
                        torch.from_numpy(s.copy()).to(dev), block=e.block,
                        n=g.numel(), shape=shapes[k])
                ref_p[k], ref_m[k] = fu.momentum_update_reference(
                    ref_p[k], ref_m[k], g, lr=LR, beta=BETA)
            log(f"  host side of that push (replayed): D2H {t_d2h:.3f} s, "
                f"error feedback + int8 encode {t_enc:.3f} s")

        qpulled = phase("pull_all int8 (PullQ)", qcl.pull_all, total_bytes)
        rpulled = phase("pull_all raw (v3)", rcl.pull_all, total_bytes)
        fpulled = phase("pull_all fp8e4m3 (PullQ)", fcl.pull_all,
                        total_bytes)
        launches = {name: c.value for name, c in _counts().items()}

        state = ps.state()
        worst = {"int8": 0.0, "fp8e4m3": 0.0}
        for k in names:
            if state.versions[k] != PUSHES:
                fail(f"{k} at version {state.versions[k]}, not {PUSHES}")
            srv = state.params[k]
            if not (torch.equal(srv, ref_p[k])
                    and torch.equal(state.momenta[k], ref_m[k])):
                fail(f"{k}: server state != plain replay; max err "
                     f"{(srv - ref_p[k]).abs().max().item()}")
            v, t = rpulled[k]
            if v != PUSHES or not torch.equal(t, srv):
                fail(f"raw pull of {k} (v{v}) != the server tensor")
            for cname, pulled in (("int8", qpulled), ("fp8e4m3", fpulled)):
                v, t = pulled[k]
                if v != PUSHES or t.shape != srv.shape:
                    fail(f"{cname} pull of {k}: v{v}, {tuple(t.shape)}")
                if not bool(torch.isfinite(t).all()):
                    fail(f"{cname} pull of {k} is not finite")
                if not codec.eligible(srv):
                    if not torch.equal(t, srv):
                        fail(f"{cname} pull of ineligible {k} != server")
                    continue
                worst[cname] = max(worst[cname],
                                   _within_bound(srv, t, cname, codec))
        log("server state == plain replay (bit for bit); raw pulls == "
            "server tensors; quantized pulls within codec.error_bound "
            f"(worst error/bound int8 {worst['int8']:.3f}, fp8 "
            f"{worst['fp8e4m3']:.3f})")
        want = _full({"brpc_fused_momentum": PUSHES * len(names),
                      "brpc_dequant_int8": (PUSHES + 1) * n_elig,
                      "brpc_dequant_fp8e4m3": n_elig})
        log(f"launches on the main path: {launches} (expected {want})")
        # Also a check that the native library shares torch's libstdc++:
        # a dump formats every variable through iostreams.
        for line in metrics.dump_vars("").splitlines():
            name = line.split(" :")[0]
            if (name.startswith(("torch_", "tensor_arena_"))
                    and not name.endswith("max_latency")):
                log(f"  var {line.strip()}")
        if launches != want:
            fail(f"launch counts {launches} != expected {want}")
        return launches
    finally:
        for cl in (qcl, rcl, fcl):
            cl.close()
        ps.stop()
        ps.server.close()


def _within_bound(srv, got, cname: str, codec) -> float:
    """Max over blocks of (quantization error / codec.error_bound)."""
    import numpy as np

    a = srv.cpu().numpy().reshape(-1)
    b = got.cpu().numpy().reshape(-1)
    enc = codec.encode(a, cname)
    meta = {"dtype": "<f4", "shape": [a.size], "codec": cname,
            "block": enc.block}
    _q, scales = codec.split_wire(meta, enc.wire)
    # The slack of the JAX package's codec tests (float32 rounding).
    bound = codec.error_bound(meta, scales) * (1 + 1e-4) + 1e-6
    err = np.abs(a - b)
    nb = scales.size
    pad = np.zeros(nb * enc.block, np.float32)
    pad[:a.size] = err
    per_block = pad.reshape(nb, enc.block).max(axis=1)
    ratio = float((per_block / bound).max())
    if ratio > 1.0:
        fail(f"{cname} pull error exceeds codec.error_bound "
             f"(ratio {ratio:.4f})")
    return ratio


# ---------------------------------------------------------------- phase 4

def _replay_step(state, x, target):
    """train_step's arithmetic with the plain momentum update: the same
    autograd, then momentum_update_reference."""
    import torch

    from brpc_tpu_torch.models import tensor_service as ts
    from brpc_tpu_torch.ops.fused_update import momentum_update_reference

    leaves = [t.detach().requires_grad_() for t in
              (state.w1, state.b1, state.w2, state.b2)]
    with torch.enable_grad():
        loss = ts._loss(state._replace(w1=leaves[0], b1=leaves[1],
                                       w2=leaves[2], b2=leaves[3]),
                        x, target)
        g_w1, g_b1, g_w2, g_b2 = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        w1, m_w1 = momentum_update_reference(state.w1, state.m_w1, g_w1)
        w2, m_w2 = momentum_update_reference(state.w2, state.m_w2, g_w2)
        stats = 0.9 * state.stats + 0.1 * torch.mean(ts._forward(state, x),
                                                     dim=0)
        return ts.PSState(w1=w1, b1=state.b1 - 0.01 * g_b1, w2=w2,
                          b2=state.b2 - 0.01 * g_b2, m_w1=m_w1, m_w2=m_w2,
                          stats=stats), loss.detach()


def _counts() -> dict:
    from brpc_tpu_torch.ops import flash_attention as fa
    from brpc_tpu_torch.ops import fused_update as fu
    from brpc_tpu_torch.ops import mla_attention as mla
    from brpc_tpu_torch.ops import quantize as qz

    return {"brpc_fused_momentum": fu.LAUNCHES,
            "brpc_fused_momentum_f16": fu.LAUNCHES_F16,
            "brpc_fused_momentum_bf16": fu.LAUNCHES_BF16,
            "brpc_dequant_int8": qz.LAUNCHES_INT8,
            "brpc_dequant_fp8e4m3": qz.LAUNCHES_FP8,
            "brpc_flash_carry": fa.LAUNCHES,
            "brpc_flash_carry_tf32x3": fa.LAUNCHES_TF32X3,
            "brpc_mla_attn_fwd": mla.LAUNCHES_FWD,
            "brpc_mla_attn_bwd": mla.LAUNCHES_BWD}


def _full(want: dict) -> dict:
    """``want`` over every counted kernel (the ones it does not name: 0)."""
    return {name: want.get(name, 0) for name in _counts()}


def _counted(label: str, fn, want):
    """Run ``fn`` with every launch count set to 0 just before it; fail
    unless the counts read just after equal ``want`` (a dict, or a
    function of fn's result giving one; names not in it must stay 0).
    Returns (fn's result, the non-zero counts)."""
    import torch

    counters = _counts()
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    got = {name: c.value for name, c in counters.items()}
    want = want(out) if callable(want) else want
    expect = {name: want.get(name, 0) for name in counters}
    log(f"{label}: {dt:.3f} s; launches {got}")
    if got != expect:
        fail(f"{label}: launch counts {got} != expected {expect}")
    return out, {name: n for name, n in got.items() if n}


def _rank_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn`` on this rank, the ranks lined up
    by a barrier and the card idle before each run (one warm run)."""
    import torch
    import torch.distributed as dist

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _ring_rank(seed: int) -> dict:
    """A spawned rank of phase 4's shared-card ring: ``ring_attention``
    over its shard of the Llama layer (its K3 launches and shifts
    counted), then the ring, its n-1 hops alone and its n folds alone
    (``ring_replay`` on the blocks the hops deliver) timed."""
    import torch
    import torch.distributed as dist

    from brpc_tpu_torch.ops import flash_attention as fa
    from brpc_tpu_torch.ops import ring_attention as ra
    from brpc_tpu_torch.parallel import collectives as col
    from brpc_tpu_torch.parallel.mesh import make_mesh

    c, n = LLAMA3_8B_ATTN, RING_SHARDS
    rank, sq = dist.get_rank(), c["s"] // n
    q, k, v = (t[:, :, rank * sq:(rank + 1) * sq].contiguous() for t in
               _qkv(c["b"], c["h"], c["hkv"], c["s"], c["d"],
                    torch.bfloat16, seed))
    mesh = make_mesh(client=1, shard=n)
    group = mesh.get_group("shard")
    ring = ra.ring_attention(mesh, causal=True)
    k3, shifts = fa.LAUNCHES.value, col.SHIFTS.value
    batch, p2p = dist.batch_isend_irecv, []
    dist.batch_isend_irecv = lambda ops: p2p.append(len(ops)) or batch(ops)
    try:
        out = ring(q, k, v)
    finally:
        dist.batch_isend_irecv = batch
    torch.cuda.synchronize()
    k3, shifts = fa.LAUNCHES.value - k3, col.SHIFTS.value - shifts
    blocks = [(k, v)]
    for _ in range(n - 1):
        blocks.append(tuple(col.ring_shift(list(blocks[-1]), group)))

    def hops():
        kb, vb = k, v
        for _ in range(n - 1):
            kb, vb = col.ring_shift([kb, vb], group)

    return {"rank": rank, "out": out.cpu(), "k3": k3, "shifts": shifts,
            "p2p": p2p,
            "ring_ms": _rank_ms(lambda: ring(q, k, v)),
            "hops_ms": _rank_ms(hops), "folds_ms": _rank_ms(
                lambda: ra.ring_replay(q, blocks, rank, n, causal=True))}


def tensor_service_paths(seed: int, smi: str) -> dict:
    """train_step, the ring replay, the port's ring over ranks sharing the
    card and dryrun_multichip(1); returns each path's launch counts."""
    import torch

    from brpc_tpu_torch.models import tensor_service as ts
    from brpc_tpu_torch.ops import flash_attention as fa
    from brpc_tpu_torch.ops.ring_attention import hop_offsets
    from brpc_tpu_torch.parallel.launch import run_ranks

    launches = {}
    # -- train_step at the GPT-2 small MLP width
    fn, (state0, x, t) = ts.flagship_entry(device="cuda", **TRAIN_STEP)
    steps = []

    def train():
        state = state0
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t_step = time.monotonic()
            state, loss = fn(state, x, t)
            torch.cuda.synchronize()
            steps.append((time.monotonic() - t_step, float(loss)))
        steps.append(state)

    _, launches["train_step"] = _counted(
        f"train_step x{TRAIN_STEPS} {TRAIN_STEP}", train,
        {"brpc_fused_momentum": 2 * TRAIN_STEPS})
    state = steps.pop()
    log("  step wall s / loss: " + ", ".join(
        f"{dt:.4f} / {loss:.6f}" for dt, loss in steps))
    ref = state0
    for _ in range(TRAIN_STEPS):
        ref, _loss = _replay_step(ref, x, t)
    for f in ts.PSState._fields:
        if not torch.equal(getattr(state, f), getattr(ref, f)):
            fail(f"train_step {f} != the plain replay: max err "
                 f"{(getattr(state, f) - getattr(ref, f)).abs().max()}")
    log("  state after the steps == plain replay (bit for bit)")
    del state0, x, t, state, ref

    # -- ring replay of the Llama layer over RING_SHARDS sequence shards
    c = LLAMA3_8B_ATTN
    q, k, v = _qkv(c["b"], c["h"], c["hkv"], c["s"], c["d"],
                   torch.bfloat16, seed)
    n, sq = RING_SHARDS, c["s"] // RING_SHARDS
    outs, carries = [], []

    folds = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def ring():
        folds[0].record()
        for rank in range(n):
            qr = q[:, :, rank * sq:(rank + 1) * sq].contiguous()
            m, l, acc = fa.flash_init(c["b"], c["h"], sq, c["d"],
                                      device="cuda")
            for hop in range(n):
                q_off, kv_off = hop_offsets(rank, hop, n, sq)
                kb = k[:, :, kv_off:kv_off + sq].contiguous()
                vb = v[:, :, kv_off:kv_off + sq].contiguous()
                m, l, acc = fa.flash_attention_carry(
                    qr, kb, vb, m, l, acc, (q_off, kv_off), causal=True)
            outs.append(fa.flash_finalize(l, acc, torch.float32))
            carries.append((l, acc))
        folds[1].record()

    _, launches["ring_replay"] = _counted(
        f"ring replay, {n} shards x {n} hops", ring,
        {"brpc_flash_carry": n * n})
    log(f"  ring replay device time (CUDA events, {n * n} K3 folds with "
        f"their slicing and finalize): {folds[0].elapsed_time(folds[1]):.4f}"
        " ms")
    ring_out = torch.cat(outs, dim=2)
    m, l, acc = fa.flash_attention_carry(
        q, k, v, *fa.flash_init(c["b"], c["h"], c["s"], c["d"],
                                device="cuda"), (0, 0), causal=True)
    one_shot = fa.flash_finalize(l, acc, torch.float32)
    err = (ring_out - one_shot).abs().max().item()
    # The ring folds the kv blocks in another order (its own diagonal
    # first), so p is rounded to bf16 at other running maxima: acc/l to
    # the 4e-3 of phase 2.
    log(f"  ring == one-shot flash_attention: max err {err:.3g}")
    if not err <= FLASH_TOL["bf16"]:
        fail(f"ring replay != one-shot flash attention (max err {err})")

    # -- the port's ring_attention over n ranks sharing the card (gloo):
    # each rank's output is its replay's, finalized in the input type.
    replays = [fa.flash_finalize(l, acc, torch.bfloat16).cpu()
               for l, acc in carries]
    ranks, _ = _counted(
        f"ring_attention, {n} ranks sharing the card over gloo",
        lambda: run_ranks(n, _ring_rank, (seed,), device_type="cuda",
                          share_card=True, timeout_s=600), {})
    for r in ranks:
        if not torch.equal(r["out"], replays[r["rank"]]):
            diff = (r["out"].float() - replays[r["rank"]].float()).abs()
            fail(f"ring_attention rank {r['rank']} != its ring replay: max "
                 f"err {diff.max().item()}")
        if r["shifts"] != n - 1 or r["p2p"] != [2] * (n - 1):
            fail(f"ring_attention rank {r['rank']} made {r['shifts']} "
                 f"shifts of {r['p2p']} point-to-point ops, not {n - 1} "
                 "of 2 (one send, one receive of the packed K|V block)")
        log(f"  rank {r['rank']}: ring {r['ring_ms']:.4f} ms, its {n - 1} "
            f"hops alone {r['hops_ms']:.4f} ms, its {n} folds alone "
            f"{r['folds_ms']:.4f} ms (CUDA events, medians of 10; {smi})")
    k3 = sum(r["k3"] for r in ranks)
    if k3 != n * n:
        fail(f"ring_attention launched K3 {k3} times over the ranks, not "
             f"{n * n}")
    launches[f"ring_attention ({n} ranks, one card)"] = {
        "brpc_flash_carry": k3}
    whole = torch.cat([r["out"] for r in sorted(ranks,
                                                key=lambda r: r["rank"])],
                      dim=2).float()
    ref = one_shot.cpu()
    # FLASH_TOL on acc/l as above, plus the output's own bf16 rounding.
    excess = ((whole - ref).abs() - 2.0 ** -8 * ref.abs()).max().item()
    log(f"  ring_attention == its replay on every rank (bit for bit), "
        f"{n - 1} shifts a rank of one send and one receive each, K3 "
        f"{k3} over the ranks; == one-shot "
        f"flash_attention: max err beyond one bf16 step {excess:.3g}")
    if not excess <= FLASH_TOL["bf16"]:
        fail(f"ring_attention over {n} ranks != one-shot flash attention "
             f"({excess} beyond one bf16 step)")
    del q, k, v, outs, carries, replays, ranks, whole, ref, ring_out, \
        one_shot, m, l, acc

    # -- the dryrun entry point on a one-rank NCCL group
    _, launches["dryrun_multichip(1)"] = _counted(
        "dryrun_multichip(1), one-rank NCCL group",
        lambda: ts.dryrun_multichip(1),
        {"brpc_flash_carry": 2, "brpc_flash_carry_tf32x3": 2})
    return launches


# ---------------------------------------------------------------- phase 5

FLEET_TAG = "chip_smoke_fleet"
FLEET_TTL_S = 30  # heartbeats every 10 s: a busy host never drops a shard


def _fleet_arenas(shapes: dict, codec) -> dict:
    """Arena sizes for the fleet at this parameter set, from its largest
    tensor and its int8 publications (each server keeps two generations
    of those while displaced ones wait for reclamation)."""
    import numpy as np

    n_of = [int(np.prod(s)) for s in shapes.values()]
    largest = 4 * max(n_of)
    pub = sum((n + 4 * -(-n // codec.DEFAULT_BLOCK)
               if 4 * n >= codec.MIN_QUANT_BYTES else 4 * n) + 256
              for n in n_of)
    return {
        # publications x2, two stacked [p, m] handoffs and two raw pull
        # responses of the largest tensor in flight
        "server": 2 * pub + 6 * largest + (256 << 20),
        # an install stages the stacked pair; a PushQ window stays under it
        "client": 2 * largest + (256 << 20),
        "migrator": 2 * largest + (64 << 20),
        "small": 64 << 20,
    }


def fleet_path(seed: int, smi: str) -> dict:
    """Phase 5: the parameter-server fleet at the GPT-2 small parameter
    set. One card holds both shards. Returns the path's launch counts,
    which must equal the ones its own plan predicts."""
    import gc

    import numpy as np
    import torch

    from brpc_tpu_torch.fleet import (FleetClient, FleetServer, Migrator,
                                      RegistryHub, ShardMap, clear_registry,
                                      plan_reshard)
    from brpc_tpu_torch.fleet import gauges
    from brpc_tpu_torch.observability import metrics
    from brpc_tpu_torch.ops import fused_update as fu
    from brpc_tpu_torch.ops import quantize as qz
    from brpc_tpu_torch.runtime import codec
    from brpc_tpu_torch.runtime.param_server import ParameterClient
    from brpc_tpu_torch.runtime.tensor import TensorArena

    gc.collect()  # phase 3's arenas go back to /dev/shm first
    shapes = gpt2_shapes()
    names = sorted(shapes)
    dev = torch.device("cuda")
    total_bytes = 4 * sum(int(np.prod(s)) for s in shapes.values())
    elig = {k for k in names
            if 4 * int(np.prod(shapes[k])) >= codec.MIN_QUANT_BYTES}
    ar = _fleet_arenas(shapes, codec)
    # Two servers, the int8 fleet client's two shard clients, the
    # migrator's two; small ones: the raw fleet client's two, a Meta
    # client and three pulling clients per shard.
    need = (2 * ar["server"] + 2 * ar["client"] + 2 * ar["migrator"]
            + 9 * ar["small"])
    shm = os.statvfs("/dev/shm")
    free = shm.f_bavail * shm.f_frsize
    log(f"fleet: /dev/shm free {free / 2**30:.2f} GiB, arenas need "
        f"{need / 2**30:.2f} GiB (server {ar['server'] / 2**20:.0f} MiB, "
        f"client {ar['client'] / 2**20:.0f} MiB, migrator "
        f"{ar['migrator'] / 2**20:.0f} MiB)")
    if free < need:
        fail(f"/dev/shm has {free} bytes free, the fleet's arenas need "
             f"{need}")

    def gbps(nbytes, dt):
        return f"{dt:.3f} s, {nbytes / dt / 1e9:.3f} GB/s effective ({smi})"

    host = make_params(shapes, seed)
    hub = RegistryHub()
    hub.start()
    servers, clients = [], []
    mig = puller = None
    stop = threading.Event()

    def shard(i):
        s = FleetServer(hub.hostport, tag=FLEET_TAG, shard_name=f"gpt2_s{i}",
                        ttl_s=FLEET_TTL_S, device=dev, lr=LR, momentum=BETA,
                        oneside=True, oneside_codec="int8",
                        arena=TensorArena(ar["server"]))
        s.start()
        servers.append(s)
        return s

    def client(addr, **kw):
        c = ParameterClient(f"tpu://{addr}", arena=TensorArena(ar["small"]),
                            device=dev, **kw)
        clients.append(c)
        return c

    try:
        counters = _counts()
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t_path = time.monotonic()
        s1 = shard(0)
        fq = FleetClient(hub.hostport, tag=FLEET_TAG, codec="int8",
                         device=dev, arena_bytes=ar["client"],
                         op_deadline_s=300.0)
        fr = FleetClient(hub.hostport, tag=FLEET_TAG, device=dev,
                         arena_bytes=ar["small"], op_deadline_s=300.0)
        clients += [fq, fr]
        t = time.monotonic()
        for k in names:
            fq.install(k, host[k], refresh=False)
        log(f"fleet install of {len(names)} tensors on one shard: "
            + gbps(total_bytes, time.monotonic() - t))

        t = time.monotonic()
        got = fr.pull_all(names)
        torch.cuda.synchronize()
        log("fleet pull_all raw (v0): " + gbps(total_bytes,
                                               time.monotonic() - t))
        for k in names:
            v, x = got[k]
            if v != 0 or not torch.equal(x.cpu(), torch.from_numpy(host[k])):
                fail(f"fleet raw pull of {k} at v0 != the seeded tensor")
        del got

        # The plain replay on the card: the exact wire codes (the same
        # error feedback as the shard client that sent them), the plain
        # dequantize, the plain update.
        ref_p = {k: torch.from_numpy(host[k]).to(dev) for k in names}
        ref_m = {k: torch.zeros_like(v) for k, v in ref_p.items()}
        at_version = {0: dict(ref_p)}

        def replay(grads, ef_of):
            """Replays one push; returns the seconds its host half (error
            feedback and int8 encode, the client's own push work) took."""
            t_enc = 0.0
            for k in names:
                g = grads[k]
                if k in elig:
                    ef = ef_of(k)
                    host_g = g.cpu().numpy()
                    t0 = time.monotonic()
                    x = ef.compensate(k, host_g)
                    e = codec.encode(x, "int8")
                    ef.settle(k, x, e.dequantized())
                    t_enc += time.monotonic() - t0
                    meta = {"dtype": "<f4", "shape": list(shapes[k]),
                            "codec": "int8", "block": e.block}
                    q, s = codec.split_wire(meta, e.wire)
                    g = qz.dequantize_reference(
                        torch.from_numpy(q.copy()).to(dev),
                        torch.from_numpy(s.copy()).to(dev), block=e.block,
                        n=g.numel(), shape=shapes[k])
                ref_p[k], ref_m[k] = fu.momentum_update_reference(
                    ref_p[k], ref_m[k], g, lr=LR, beta=BETA)
            return t_enc

        gen = torch.Generator(device=dev)

        def grads_for(step):
            gen.manual_seed(seed * 7919 + step)
            return {k: torch.randn(shapes[k], generator=gen, device=dev)
                    * 1e-3 for k in names}

        ef1 = codec.ErrorFeedback()
        grads = grads_for(1)
        t = time.monotonic()
        vers = fq.push_all(grads)
        torch.cuda.synchronize()
        log("fleet push_all int8 #1: " + gbps(total_bytes,
                                              time.monotonic() - t))
        if vers != {k: 1 for k in names}:
            fail(f"fleet push 1 versions: {vers}")
        log(f"  host side of that push (replayed): error feedback + int8 "
            f"encode {replay(grads, lambda k: ef1):.3f} s")
        at_version[1] = dict(ref_p)

        passes = []  # (end time, tensors moved) of each migrator pass
        mig = Migrator(hub.hostport, tag=FLEET_TAG, window=4,
                       arena_bytes=ar["migrator"],
                       on_reshard=lambda _i, n: passes.append(
                           (time.monotonic(), n))).start()
        _wait_for(lambda: passes, 60, "the migrator's first pass")
        if passes[0][1] or mig.stuck_moves:
            fail(f"the one-shard pass moved {passes[0][1]} tensors")
        moved_c = gauges.counter("migration_moved_total")
        bytes_c = gauges.counter("migration_bytes_total")
        moved0, bytes0 = moved_c.value(), bytes_c.value()

        # One thread keeps pulling the whole set raw while the reshard
        # runs: every tensor must equal the replay at its version, and no
        # version may go backwards.
        pulls, errors, last_v = [], [], {}

        def pull_loop():
            while not stop.is_set():
                t0 = time.monotonic()
                try:
                    res = fr.pull_all(names)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(f"pull: {type(e).__name__}: {e}")
                    return
                for k, (v, x) in res.items():
                    want = at_version.get(v, {}).get(k)
                    if want is None or not torch.equal(x, want):
                        errors.append(f"{k} at v{v} != the replay at v{v}")
                        return
                    if v < last_v.get(k, 0):
                        errors.append(f"{k}: v{v} after v{last_v[k]}")
                        return
                    last_v[k] = v
                pulls.append((t0, time.monotonic()))

        puller = threading.Thread(target=pull_loop, daemon=True)
        puller.start()
        _wait_for(lambda: pulls or errors, 120, "a pull before the join")
        placement = {s1.addr: client(s1.addr).meta()}
        t_join = time.monotonic()
        s2 = shard(1)
        target = ShardMap([s1.addr, s2.addr])
        plan = plan_reshard(dict(placement, **{s2.addr: {}}), target)
        moved = {m.name for m in plan.moves}

        def moved_since_join():
            return sum(n for t_end, n in passes if t_end > t_join)

        # Passes without moves (a heartbeat may advance the registry
        # index) do not count: the one that moves the plan's tensors does.
        _wait_for(lambda: moved_since_join() >= len(plan.moves) or errors,
                  600, "the watch edge never triggered the 1 -> 2 reshard")
        t_done = max(t_end for t_end, n in passes if n)
        n_after = len(pulls)
        _wait_for(lambda: len(pulls) > n_after + 1 or errors, 120,
                  "pulls after the reshard")
        stop.set()
        puller.join(timeout=120)
        if puller.is_alive():
            fail("the pulling thread did not stop")
        if errors:
            fail("pull under the reshard: " + "; ".join(errors[:3]))
        during = sum(1 for a, b in pulls if a < t_done and b > t_join)
        log(f"fleet reshard 1 -> 2 shards: {t_done - t_join:.3f} s from "
            f"the join to the end of the pass; {len(plan.moves)} of "
            f"{len(names)} tensors moved, {plan.total_bytes / 1e9:.3f} GB "
            f"of parameters ({2 * plan.total_bytes / 1e9:.3f} GB with "
            f"momenta), {2 * plan.total_bytes / (t_done - t_join) / 1e9:.3f}"
            f" GB/s ({smi}); {during} raw pull_alls overlapped it, "
            f"{len(pulls)} in all, none torn or stale")
        if during < 1:
            fail("no pull_all ran during the reshard")
        if mig.stuck_moves or moved_since_join() != len(plan.moves):
            fail(f"the reshard moved {moved_since_join()} tensors, the "
                 f"plan {len(plan.moves)}; {mig.stuck_moves} stuck")
        if (moved_c.value() - moved0 != len(plan.moves)
                or bytes_c.value() - bytes0 != plan.total_bytes):
            fail(f"migrator moved {moved_c.value() - moved0} tensors / "
                 f"{bytes_c.value() - bytes0} B, the plan "
                 f"{len(plan.moves)} / {plan.total_bytes}")

        # The moved names' first push goes to the old owner, is refused
        # there (E_MOVED), and is re-sent by a fresh shard client: their
        # residual restarts at zero, as FleetClient.refresh pruned it.
        ef2 = codec.ErrorFeedback()
        grads = grads_for(2)
        t = time.monotonic()
        vers = fq.push_all(grads)
        torch.cuda.synchronize()
        log("fleet push_all int8 #2 (after the reshard): "
            + gbps(total_bytes, time.monotonic() - t))
        if vers != {k: 2 for k in names}:
            fail(f"fleet push 2 versions: {vers}")
        log(f"  host side of that push (replayed): error feedback + int8 "
            f"encode {replay(grads, lambda k: ef2 if k in moved else ef1):.3f}"
            f" s, once per name (the client encoded the {len(moved)} moved "
            "names twice: for the old owner, then the new)")
        del grads

        # The int8 fleet pull: each shard stream's PullQ codes cross to the
        # card and K2 widens them there.
        t = time.monotonic()
        fleet_q = fq.pull_all(names)
        torch.cuda.synchronize()
        log("fleet pull_all int8 (v2): " + gbps(total_bytes,
                                                time.monotonic() - t))

        # One-sided pulls, shard by shard, against the RPC pulls. The v2
        # publication filled each server's encode cache, so the PullQ
        # pulls below encode nothing either.
        hits = metrics.counter("torch_oneside_pull_hits")
        falls = metrics.counter("torch_oneside_pull_fallbacks")
        n_oneside = 0
        for s in servers:
            st = s.ps.state()
            own = sorted(st.params)
            oc = client(s.addr, oneside=True)
            qc = client(s.addr, codec="int8")
            rc = client(s.addr)
            h0, f0 = hits.value(), falls.value()
            shard_bytes = 4 * sum(int(np.prod(shapes[k])) for k in own)
            t = time.monotonic()
            one = oc.pull_all()
            torch.cuda.synchronize()
            t_one = time.monotonic() - t
            if hits.value() - h0 != len(own) or falls.value() != f0:
                fail(f"one-sided pull_all on {s.addr}: hits "
                     f"{hits.value() - h0} for {len(own)} names, fallbacks "
                     f"{falls.value() - f0}")
            n_oneside += sum(1 for k in own if k in elig)
            t = time.monotonic()
            pq = qc.pull_all()
            torch.cuda.synchronize()
            t_q = time.monotonic() - t
            t = time.monotonic()
            raw = rc.pull_all()
            torch.cuda.synchronize()
            t_raw = time.monotonic() - t
            log(f"fleet shard {s.addr} ({len(own)} tensors, "
                f"{shard_bytes / 1e6:.1f} MB): one-sided int8 pull_all "
                f"{t_one:.3f} s vs RPC PullQ int8 {t_q:.3f} s vs RPC raw "
                f"{t_raw:.3f} s, encode cache warm for both int8 pulls "
                f"({smi})")
            worst = 0.0
            for k in own:
                srv = st.params[k]
                v1, a = one[k]
                v2, b = pq[k]
                v3, c = raw[k]
                if not (v1 == v2 == v3 == 2):
                    fail(f"{k}: one-sided v{v1}, PullQ v{v2}, raw v{v3}")
                if not torch.equal(a, b):
                    fail(f"one-sided pull of {k} != its PullQ int8 pull")
                vf, f = fleet_q[k]
                if vf != 2 or not torch.equal(f, b):
                    fail(f"fleet int8 pull of {k} (v{vf}) != the shard's "
                         "PullQ int8 pull")
                if not torch.equal(c, srv):
                    fail(f"raw pull of {k} != the server tensor")
                if k in elig:
                    worst = max(worst, _within_bound(srv, a, "int8", codec))
                elif not torch.equal(a, srv):
                    fail(f"one-sided pull of ineligible {k} != server")
            log(f"  one-sided == fleet int8 pull == PullQ bit for bit; "
                f"worst error/bound {worst:.3f}")
            del one, pq, raw
        del fleet_q
        torch.cuda.synchronize()
        launches = {name: c.value for name, c in counters.items()}
        log(f"fleet path: {time.monotonic() - t_path:.3f} s; launches "
            f"{launches}")

        # Placement, versions and state against the plan and the replay.
        for s in servers:
            st = s.ps.state()
            want = sorted(k for k in names if target.owner(k) == s.addr)
            if sorted(st.params) != want:
                fail(f"{s.addr} holds {len(st.params)} names, its ketama "
                     f"share is {len(want)}")
            for k in want:
                if st.versions[k] != 2:
                    fail(f"{k} at version {st.versions[k]}, not 2")
                if not (torch.equal(st.params[k], ref_p[k])
                        and torch.equal(st.momenta[k], ref_m[k])):
                    fail(f"{k} on {s.addr}: state != plain replay; max err "
                         f"{(st.params[k] - ref_p[k]).abs().max().item()}")
        owned_by = {s.addr: len(s.ps.state().params) for s in servers}
        log(f"fleet state == plain replay (bit for bit, momenta "
            f"included) on both shards {owned_by}; every name on its "
            f"ketama owner; {len(moved)} moved == the plan's owner diff")
        want = _full({"brpc_fused_momentum": 2 * len(names),
                      "brpc_dequant_int8": 4 * len(elig) + n_oneside})
        log(f"launches on the fleet path: {launches} (expected {want}: "
            f"K1 one per name per push; K2 one per eligible name per push, "
            f"per fleet int8 pull, per one-sided read and per PullQ read)")
        if launches != want:
            fail(f"fleet launch counts {launches} != expected {want}")
        return {k: v for k, v in launches.items() if v}
    finally:
        stop.set()
        if puller is not None:
            puller.join(timeout=120)
        if mig is not None:
            mig.stop()
        for c in clients:
            c.close()
        for s in servers:
            s.stop()
            s.ps.server.close()
        clear_registry()
        hub.stop()


# ---------------------------------------------------------------- phase 6

PLANE_TAG = "chip_smoke_plane"


def _threads(n: int, fn) -> list:
    """``fn(r)`` on n threads -> results by r; a member's error fails the
    phase (on this thread: ``fail`` exits only from the main thread)."""
    out, errs = [None] * n, []

    def worker(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(f"member {r}: {type(e).__name__}: {e}")

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        fail("; ".join(errs))
    return out


def _step_line(i: int, dt: float, loss: float, st: dict) -> str:
    return (f"  step {i}: {dt * 1e3:.1f} ms wall, loss {loss:.6f}; "
            f"compute_ms {st['compute_ms']:.1f}, exposed_comm_ms "
            f"{st['exposed_comm_ms']:.1f}, overlapped_comm_ms "
            f"{st['overlapped_comm_ms']:.1f}")


def _equal_state(label: str, got: dict, want: dict) -> None:
    import torch

    for k, v in want.items():
        if not torch.equal(got[k], v):
            fail(f"{label}: {k} != the plain replay; max err "
                 f"{(got[k] - v).abs().max().item()}")


def _close_state(label: str, got: dict, want: dict, rtol: float = 2e-5,
                 atol: float = 1e-6) -> float:
    """The JAX package's pinned PP/TP tolerance; returns the worst
    |err| / (atol + rtol |want|)."""
    worst = 0.0
    for k, v in want.items():
        ratio = ((got[k] - v).abs() / (atol + rtol * v.abs())).max().item()
        worst = max(worst, ratio)
        if not ratio <= 1.0:
            fail(f"{label}: {k} outside rtol {rtol}, atol {atol} of the "
                 f"plain replay (ratio {ratio:.3f})")
    return worst


def _drift(got: dict, want: dict, rtol: float = 2e-5,
           atol_rms: float = 1e-3) -> tuple:
    """How far ``got`` lies from ``want``: the worst |err| / (atol +
    rtol |want|) with atol ``atol_rms`` times each tensor's RMS, the
    number of elements past 1, and the worst ||err|| / ||want||."""
    worst, over, rel = 0.0, 0, 0.0
    for k, v in want.items():
        err = (got[k] - v).abs()
        r = err / (atol_rms * v.square().mean().sqrt() + rtol * v.abs())
        worst = max(worst, r.max().item())
        over += int((r > 1.0).sum().item())
        rel = max(rel, (err.norm() / v.norm()).item())
    return worst, over, rel


def training_plane(seed: int, smi: str) -> dict:
    """Phase 6: the step drivers, the pipeline and tensor parallelism at
    the GPT-2 small MLP stack. Returns each run's launch counts."""
    import gc

    import numpy as np
    import torch

    from brpc_tpu_torch.collectives import ring as ring_sched
    from brpc_tpu_torch.collectives.group import CollectiveGroup
    from brpc_tpu_torch.fleet import RegistryHub, clear_registry
    from brpc_tpu_torch.models.pipeline import StagedMLP
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.models.tp_layers import LocalRing, TPShardedMLP
    from brpc_tpu_torch.ops import fused_update as fu
    from brpc_tpu_torch.ops import quantize as qz
    from brpc_tpu_torch.parallel.ps_process import ServerProcess
    from brpc_tpu_torch.runtime import codec
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)
    from brpc_tpu_torch.runtime.pp_sched import (PipelineStageDriver,
                                                 WirePipe, bubble_fraction)
    from brpc_tpu_torch.runtime.step_driver import (CollectiveStepDriver,
                                                    OverlappedStepDriver)
    from brpc_tpu_torch.runtime.tensor import TensorArena

    gc.collect()
    dev = torch.device("cuda")
    sizes, batch = PLANE["sizes"], PLANE["batch"]
    h = LayeredMLP(sizes, seed=seed, device=dev)
    names = h.names
    init = {k: v.cpu().numpy() for k, v in h.init_params().items()}
    n_w = sum(v.size for v in init.values())
    x, y = h.data(batch, seed=seed + 1)
    log(f"training plane: {len(names)} layers {sizes[:3]}..., {n_w} fp32 "
        f"weights ({4 * n_w / 1e6:.1f} MB), batch {batch}; "
        f"sys.setswitchinterval(0.0005) for this phase, so the wire "
        f"lanes' threads do not hold the GIL for whole scheduler quanta")
    launches = {}

    def wire_view(t):
        """A pulled tensor as the int8 wire delivers it: the server's
        encode, the plain dequantize."""
        e = codec.encode(t.cpu().numpy(), "int8")
        return _dequant_plain(e, t.shape)

    def _dequant_plain(e, shape):
        meta = {"dtype": "<f4", "shape": list(shape), "codec": "int8",
                "block": e.block}
        q, s = codec.split_wire(meta, e.wire)
        return qz.dequantize_reference(
            torch.from_numpy(q.copy()).to(dev),
            torch.from_numpy(s.copy()).to(dev), block=e.block,
            n=int(np.prod(shape)), shape=tuple(shape))

    def replay(steps, cname=None):
        """LayeredMLP.grads, then momentum_update_reference; with int8,
        the exact wire codes both ways. -> (losses, [(p, m) per step])."""
        p = {k: torch.from_numpy(init[k]).to(dev) for k in names}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        ef = codec.ErrorFeedback()
        losses, states = [], []
        for _ in range(steps):
            w = p if cname is None else {k: wire_view(p[k]) for k in names}
            gs, loss = h.grads(w, x, y)
            losses.append(loss)
            for k in names:
                g = gs[k]
                if cname is not None:
                    xq = ef.compensate(k, g.cpu().numpy())
                    e = codec.encode(xq, "int8")
                    ef.settle(k, xq, e.dequantized())
                    g = _dequant_plain(e, g.shape)
                p[k], m[k] = fu.momentum_update_reference(
                    p[k], m[k], g, lr=LR, beta=BETA)
            states.append((dict(p), dict(m)))
        return losses, states

    switch = sys.getswitchinterval()
    sys.setswitchinterval(0.0005)
    hub = None
    try:
        # -- 1. the overlapped parameter-server driver
        steps = PLANE["ps_steps"]

        def ps_run(label, overlap, cname, own):
            """One driver run of ``steps`` steps. ``own``: the server in a
            process of its own with one-sided pulls (the JAX package's
            set-up, bench.py's _STEP_CHILD); else in this process, pulls
            over RPC. -> (steps, the server's state, launches)."""
            if own:
                srv = ServerProcess(init, lr=LR, momentum=BETA, device=dev,
                                    arena_bytes=1 << 30, oneside=True,
                                    timeout_s=900)
                addr = srv.addr
            else:
                srv = ParameterServer(init, lr=LR, momentum=BETA,
                                      arena=TensorArena(256 << 20),
                                      device=dev)
                addr = f"tpu://127.0.0.1:{srv.start()}"
            cl = None
            try:
                cl = ParameterClient(addr, arena=TensorArena(256 << 20),
                                     codec=cname, device=dev, oneside=own)
                cl.meta()

                def run():
                    d = OverlappedStepDriver(cl, h, overlap=overlap,
                                             window=4)
                    d.prime()
                    out = []
                    for _ in range(steps):
                        torch.cuda.synchronize()
                        t = time.monotonic()
                        loss = d.step(x, y)
                        torch.cuda.synchronize()
                        out.append((time.monotonic() - t, loss,
                                    dict(d.last_stats)))
                    return out

                # K1 on the server; K2: the client's prime pulls, then per
                # step the server widens every int8 push and the client
                # every int8 pull.
                want = {"brpc_fused_momentum": len(names) * steps,
                        "brpc_dequant_int8": (len(names) * (1 + 2 * steps)
                                              if cname else 0)}
                if own:
                    # The server's launches are its process's own counts,
                    # set to 0 just before the run and read just after;
                    # this process launches none.
                    srv.reset_launches()
                    out, _ = _counted(label, run, {})
                    got = {k: n for k, n in srv.launches().items() if n}
                    log(f"  launches in the server process {got}")
                    if _full(got) != _full(want):
                        fail(f"{label}: the server process launched {got}, "
                             f"expected {want}")
                else:
                    out, got = _counted(label, run, want)
                for i, (dt, loss, st) in enumerate(out):
                    log(_step_line(i + 1, dt, loss, st) + f" ({smi})")
                state = srv.state()
                if set(state.versions.values()) != {steps}:
                    fail(f"{label}: versions {set(state.versions.values())}")
                return out, state, got
            finally:
                if cl is not None:
                    cl.close()
                if own:
                    srv.close()
                else:
                    srv.stop()
                    srv.server.close()

        ref_losses, ref_states = replay(steps)
        # Normal / sqrt(fan-in) weights keep a ReLU stack's second moment
        # only up to the halving each ReLU makes: 23 of them leave the
        # head little signal, and the loss moves below fp32's resolution.
        head_in = h.forward({k: torch.from_numpy(v).to(dev)
                             for k, v in init.items()}, x, y)["acts"][-2]
        log(f"  the head's input RMS at init: "
            f"{head_in.square().mean().sqrt().item():.3e} (x's: "
            f"{x.square().mean().sqrt().item():.3f}); the loss stays "
            "flat to fp32 at this depth, so the trajectories are held "
            "to their replays, not to a falling loss")
        del head_in
        for label, overlap in (("serial", False), ("overlapped", True)):
            out, state, got = ps_run(
                f"parameter-server driver, {label}, {steps} steps, server "
                "in a process of its own, one-sided pulls", overlap, None,
                True)
            launches[f"ps_driver_{label}"] = got
            _equal_state(f"ps driver {label} params",
                         {k: v.to(dev) for k, v in state.params.items()},
                         ref_states[-1][0])
            _equal_state(f"ps driver {label} momenta",
                         {k: v.to(dev) for k, v in state.momenta.items()},
                         ref_states[-1][1])
            losses = [loss for _dt, loss, _st in out]
            if losses != ref_losses:
                fail(f"ps driver {label}: losses {losses}, replay "
                     f"{ref_losses}")
            if overlap and not sum(st["overlapped_comm_ms"]
                                   for _d, _l, st in out) > 0.0:
                fail("the overlapped driver overlapped no communication")
        log("  both raw trajectories == the plain replay on the server "
            "(bit for bit, momenta included); losses "
            + ", ".join(f"{v:.6f}" for v in ref_losses))
        out, state, got = ps_run(f"parameter-server driver, int8, {steps} "
                                 "steps, server in this process", True,
                                 "int8", False)
        launches["ps_driver_int8"] = got
        q_losses, q_states = replay(steps, "int8")
        _equal_state("ps driver int8 params", state.params, q_states[-1][0])
        _equal_state("ps driver int8 momenta", state.momenta,
                     q_states[-1][1])
        losses = [loss for _dt, loss, _st in out]
        if losses != q_losses:
            fail(f"ps driver int8: losses {losses}, replay {q_losses}")
        log("  int8 trajectory == the replay of the exact wire codes (bit "
            "for bit); losses " + ", ".join(f"{v:.6f}" for v in q_losses))
        del state, q_states
        gc.collect()

        # -- 2. the collective data-parallel driver, two members
        hub = RegistryHub()
        hub.start()
        steps = PLANE["dp_steps"]
        batches = [h.data(batch, seed=seed + 2 + r) for r in range(2)]

        def dp_run(label, cname, ef, track):
            groups = [CollectiveGroup(hub.hostport, tag=f"{PLANE_TAG}_{label}",
                                      codec=cname, ef=ef, op_timeout_s=300.0,
                                      ttl_s=FLEET_TTL_S)
                      for _ in range(2)]
            try:
                _threads(2, lambda r: groups[r].sync(expect=2, timeout_s=60))
                groups.sort(key=lambda g: g.rank)
                ds = [CollectiveStepDriver(
                    g, LayeredMLP(sizes, seed=seed, device=dev), lr=LR,
                    momentum=BETA, track=track) for g in groups]
                for d in ds:
                    d.prime(init)
                # The spans each member's on_chunk finalizes per
                # allreduce, from the schedule: every non-empty ring
                # chunk, or the whole tensor once on the tree path.
                plan = {k: ([(0, (0, init[k].size))]
                            if 4 * init[k].size <= groups[0].tree_max_bytes
                            else [(i, sp) for i, sp in enumerate(
                                ring_sched.chunk_spans(init[k].size, 2))
                                if sp[1]])
                        for k in names}
                planned = sum(len(v) for v in plan.values())
                barrier = threading.Barrier(2, timeout=600)
                agree, logs_ok = [], []

                def member(r):
                    out = []
                    try:
                        for _ in range(steps):
                            torch.cuda.synchronize()
                            t = time.monotonic()
                            loss = ds[r].step(*batches[r])
                            torch.cuda.synchronize()
                            out.append((time.monotonic() - t, loss,
                                        dict(ds[r].last_stats)))
                            if track:
                                logs_ok.append(all(
                                    sorted(ds[r].last_chunk_log[k])
                                    == plan[k] for k in names))
                            barrier.wait()
                            if r == 0:
                                agree.append(all(torch.equal(
                                    ds[0].params()[k], ds[1].params()[k])
                                    for k in names))
                            barrier.wait()
                    except BaseException:
                        barrier.abort()
                        raise
                    return out

                # K1: one launch per layer per step per member, or
                # tracked, one per planned chunk.
                out, got = _counted(
                    f"collective driver, {label}, 2 members x {steps} "
                    "steps", lambda: _threads(2, member),
                    {"brpc_fused_momentum": 2 * steps * (
                        planned if track else len(names))})
                if agree != [True] * steps:
                    fail(f"dp {label}: members' weights differ after a "
                         f"step ({agree})")
                if logs_ok != [True] * (2 * steps if track else 0):
                    fail(f"dp {label}: on_chunk's spans != the ring's "
                         f"schedule ({logs_ok})")
                for r in range(2):
                    for i, (dt, loss, st) in enumerate(out[r]):
                        log(f"  member {r}" + _step_line(i + 1, dt, loss, st)
                            + f" ({smi})")
                if track:
                    log(f"  {2 * steps * planned} chunks landed and were "
                        f"applied one K1 launch each ({planned} a member a "
                        "step, the ring schedule's; every step's chunk log "
                        "== that plan)")
                return ({k: v.clone() for k, v in ds[0].params().items()},
                        {k: v.clone() for k, v in ds[0].momenta().items()},
                        got)
            finally:
                _threads(2, lambda r: groups[r].close())

        p_raw, m_raw, launches["dp_driver_raw"] = dp_run("raw", None, True,
                                                         False)
        p = {k: torch.from_numpy(init[k]).to(dev) for k in names}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        for _ in range(steps):
            g0, _l0 = h.grads(p, *batches[0])
            g1, _l1 = h.grads(p, *batches[1])
            for k in names:
                red = g0[k].cpu().numpy() + g1[k].cpu().numpy()
                red /= np.float32(2)
                p[k], m[k] = fu.momentum_update_reference(
                    p[k], m[k], torch.from_numpy(red).to(dev), lr=LR,
                    beta=BETA)
        _equal_state("dp raw params", p_raw, p)
        _equal_state("dp raw momenta", m_raw, m)
        log("  raw == the replay averaging both members' gradients (a + b"
            ", / 2) and applying the plain update (bit for bit); members "
            "equal after every step")
        del p, m, g0, g1
        p_ef, m_ef, launches["dp_driver_int8_ef"] = dp_run(
            "int8_ef", "int8", True, False)
        p_nv, m_nv, launches["dp_driver_int8_naive"] = dp_run(
            "int8_naive", "int8", False, False)

        def max_diff(a, b):
            return max((a[k] - b[k]).abs().max().item() for k in names)

        # The weights move by lr x momentum, ~1e-10 at this depth, under
        # one ulp of a weight (~4e-9): what quantization dropped shows in
        # the momenta, the optimizer state that sums the gradients.
        d_ef, d_nv = max_diff(m_ef, m_raw), max_diff(m_nv, m_raw)
        log(f"  int8 vs raw, max |diff| of the momenta: error feedback "
            f"{d_ef:.3e}, naive requantizer {d_nv:.3e}; of the weights: "
            f"{max_diff(p_ef, p_raw):.3e} and {max_diff(p_nv, p_raw):.3e}")
        if not 0.0 < d_ef < d_nv:
            fail(f"int8 with error feedback ({d_ef}) not closer to raw than "
                 f"the naive requantizer ({d_nv})")
        del p_ef, p_nv, m_ef, m_nv
        p_tr, m_tr, launches["dp_driver_tracked"] = dp_run("tracked", None,
                                                           True, True)
        _equal_state("dp tracked params", p_tr, p_raw)
        _equal_state("dp tracked momenta", m_tr, m_raw)
        log("  track=True == the untracked raw run (bit for bit)")
        del p_tr, m_tr, p_raw, m_raw, batches
        gc.collect()

        # -- 3. the 1F1B pipeline over WirePipe, 2 stages
        steps, mbs = PLANE["pp_steps"], PLANE["microbatches"]
        pipes = [WirePipe(hub.hostport, s, 2, tag=f"{PLANE_TAG}_pp",
                          arena_bytes=128 << 20,
                          client_arena_bytes=128 << 20, timeout_s=300.0,
                          ttl_s=FLEET_TTL_S, device=dev) for s in range(2)]
        try:
            _threads(2, lambda s: pipes[s].sync(timeout_s=60))
            drivers = [PipelineStageDriver(
                s, 2, StagedMLP(sizes, s, 2, params=init, device=dev),
                pipes[s], microbatches=mbs, lr=LR, momentum=BETA)
                for s in range(2)]

            def stage(s):
                out = []
                for _ in range(steps):
                    t = time.monotonic()
                    loss = drivers[s].step(x=x if s == 0 else None,
                                           y=y if s == 1 else None)
                    torch.cuda.synchronize()
                    out.append((time.monotonic() - t, loss,
                                dict(drivers[s].last_stats)))
                return out

            out, launches["pipeline"] = _counted(
                f"1F1B pipeline over WirePipe, 2 stages x {mbs} "
                f"microbatches, {steps} steps", lambda: _threads(2, stage),
                {"brpc_fused_momentum": len(names) * steps})
        finally:
            for pp in pipes:
                pp.close()
        for s in range(2):
            for i, (dt, _loss, st) in enumerate(out[s]):
                log(f"  stage {s} step {i + 1}: {dt * 1e3:.1f} ms wall, "
                    f"bubble {st['bubble_s'] * 1e3:.1f} ms "
                    f"({st['bubble_s'] / st['wall_s']:.3f} of the stage's "
                    f"wall; closed form bubble_fraction(2, {mbs}) = "
                    f"{bubble_fraction(2, mbs):.3f}) ({smi})")
        pp_losses = [loss for _dt, loss, _st in out[1]]
        if not np.allclose(pp_losses, ref_losses[:steps], rtol=2e-5,
                           atol=0.0):
            fail(f"pipeline losses {pp_losses} vs replay "
                 f"{ref_losses[:steps]} outside rtol 2e-5")
        merged, moms = {}, {}
        for d in drivers:
            merged.update(d.harness.params())
            moms.update(d.momenta())
        worst = _close_state("pipeline weights", merged,
                             ref_states[steps - 1][0])
        log(f"  pipeline == the full-batch replay within rtol 2e-5 (losses) "
            f"and rtol 2e-5, atol 1e-6 (weights; worst ratio {worst:.3e}: "
            "they move under one ulp a step at this depth)")

        # The plain per-microbatch replay: LayeredMLP.grads on each
        # microbatch in order, the sum scaled by 1/M, the plain update —
        # the pipeline's arithmetic without its schedule, stages or wire,
        # so the pipeline must equal it bit for bit, weights and momenta.
        def mb_replay(drop_last=False):
            xs, ys = x.chunk(mbs), y.chunk(mbs)
            used = mbs - 1 if drop_last else mbs
            p = {k: torch.from_numpy(init[k]).to(dev) for k in names}
            m = {k: torch.zeros_like(v) for k, v in p.items()}
            losses, states = [], []
            for _ in range(steps):
                gsum, lsum = {}, 0.0
                for i in range(used):
                    gs, loss = h.grads(p, xs[i].contiguous(),
                                       ys[i].contiguous())
                    lsum += loss
                    for k in names:
                        gsum[k] = gsum[k] + gs[k] if k in gsum else gs[k]
                for k in names:
                    p[k], m[k] = fu.momentum_update_reference(
                        p[k], m[k], gsum[k] * (1.0 / mbs), lr=LR,
                        beta=BETA)
                losses.append(lsum / mbs)
                states.append((dict(p), dict(m)))
            return losses, states

        mb_losses, mb_states = mb_replay()
        if pp_losses != mb_losses:
            fail(f"pipeline losses {pp_losses} != the per-microbatch "
                 f"replay's {mb_losses}")
        _equal_state("pipeline params", merged, mb_states[-1][0])
        _equal_state("pipeline momenta", moms, mb_states[-1][1])
        # What a faulty pipeline would hold must differ from the replay
        # on every tensor, so the check above can fail on each: no
        # update (or zero activation grads into stage 0), one step
        # fewer, the last microbatch dropped from every step.
        faults = {"zero momenta": {k: torch.zeros_like(v)
                                   for k, v in moms.items()},
                  "a dropped microbatch": mb_replay(True)[1][-1][1]}
        if steps > 1:
            faults["one step fewer"] = mb_states[-2][1]
        for what, state in faults.items():
            same = [k for k in names
                    if torch.equal(state[k], mb_states[-1][1][k])]
            if same:
                fail(f"pipeline momenta: {what} would pass on {same}")
        # Against the full-batch replay the momenta differ by how cuBLAS
        # orders one 8192-row GEMM against four 2048-row ones; a ReLU
        # whose input sits within that rounding of 0 flips its mask.
        w0 = torch.from_numpy(init[names[0]]).to(dev)
        z_full = torch.matmul(x, w0)
        z_mb = torch.cat([torch.matmul(c.contiguous(), w0)
                          for c in x.chunk(mbs)])
        d_worst, d_over, d_rel = _drift(moms, ref_states[steps - 1][1])
        log(f"  pipeline == the per-microbatch replay (bit for bit: losses, "
            f"weights, momenta; zero momenta, one step fewer and a dropped "
            f"microbatch each differ from it on every tensor); momenta vs "
            f"the full-batch replay: worst |err| / (1e-3 RMS + 2e-5 |m|) "
            f"{d_worst:.3e}, {d_over} elements past 1, worst "
            f"||err|| / ||m|| {d_rel:.3e}; the first layer's z, {batch} "
            f"rows at once vs {mbs} x {batch // mbs}: max |diff| "
            f"{(z_full - z_mb).abs().max().item():.3e}, "
            f"{int(((z_full > 0) != (z_mb > 0)).sum().item())} mask flips")
        del drivers, merged, moms, faults, mb_states, ref_states
        del w0, z_full, z_mb
        gc.collect()

        # -- 4. tensor parallelism, 2 members, depth cut to 2 blocks
        steps, tsizes = PLANE["tp_steps"], PLANE["tp_sizes"]
        ht = LayeredMLP(tsizes, seed=seed, device=dev)
        tinit = {k: v.cpu().numpy() for k, v in ht.init_params().items()}
        ring = LocalRing(2)

        def tp_member(r):
            tp = TPShardedMLP(tsizes, ring.member(r), tinit, lr=LR,
                              momentum=BETA, device=dev)
            out = []
            for _ in range(steps):
                torch.cuda.synchronize()
                t = time.monotonic()
                loss = tp.train_step(x, y)
                torch.cuda.synchronize()
                out.append((time.monotonic() - t, loss))
            return out, tp.gather_params()

        res, launches["tensor_parallel"] = _counted(
            f"tensor parallel, 2 members, {tsizes}, {steps} steps",
            lambda: _threads(2, tp_member),
            {"brpc_fused_momentum": 2 * (len(tsizes) - 1) * steps})
        (out0, g0), (out1, g1) = res
        for i, (dt, loss) in enumerate(out0):
            log(f"  step {i + 1}: {dt * 1e3:.1f} ms wall, loss {loss:.6f} "
                f"({smi})")
        tp_losses = [l for _d, l in out0]
        if tp_losses != [l for _d, l in out1]:
            fail("tensor parallel: the members' losses differ")
        if not tp_losses[-1] < tp_losses[0]:
            fail(f"tensor parallel: the loss did not fall ({tp_losses})")
        _equal_state("tp members' gathered weights", g1, g0)
        p = {k: torch.from_numpy(v).to(dev) for k, v in tinit.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        t_losses = []
        for _ in range(steps):
            gs, loss = ht.grads(p, x, y)
            t_losses.append(loss)
            for k in p:
                p[k], m[k] = fu.momentum_update_reference(
                    p[k], m[k], gs[k], lr=LR, beta=BETA)
        if not np.allclose(tp_losses, t_losses, rtol=2e-5, atol=0.0):
            fail(f"tensor parallel losses {tp_losses} vs replay "
                 f"{t_losses} outside rtol 2e-5")
        worst = _close_state("tensor parallel weights", g0, p)
        log(f"  tensor parallel == the full-batch replay within rtol 2e-5, "
            f"atol 1e-6 (worst ratio {worst:.3f}); members bit-identical")
        return launches
    finally:
        sys.setswitchinterval(switch)
        if hub is not None:
            clear_registry()
            hub.stop()


def _wait_for(cond, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            fail(f"timed out after {timeout_s} s: {what}")
        time.sleep(0.01)


# ---------------------------------------------------------------- phase 7

def _serve_values(seed: int, vocab: int, dim: int, max_pos: int) -> dict:
    """DecoderParams fields as numpy: normal embeddings and positions,
    normal / sqrt(dim) projections (the JAX package's init_decoder)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s = np.float32(1.0 / np.sqrt(dim))
    out = {"embed": rng.standard_normal((vocab, dim), dtype=np.float32),
           "pos": rng.standard_normal((max_pos, dim), dtype=np.float32)}
    for k in ("wq", "wk", "wv", "wo"):
        out[k] = rng.standard_normal((dim, dim), dtype=np.float32) * s
    return out


def _serve_sessions(seed: int) -> list:
    """(prompt, max_tokens) per session; the first ``group`` share a
    block-aligned prompt prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cfg = SERVE
    prefix = rng.integers(1, cfg["vocab"], cfg["prefix"]).tolist()
    out = []
    for i in range(cfg["sessions"]):
        n = int(rng.integers(32, 257))
        if i < cfg["group"]:
            n = max(n, cfg["prefix"] + 16)
            prompt = prefix + rng.integers(
                1, cfg["vocab"], n - cfg["prefix"]).tolist()
        else:
            prompt = rng.integers(1, cfg["vocab"], n).tolist()
        out.append((prompt, int(rng.integers(64, 257))))
    return out


def _top2_gap(params, seq: list) -> tuple:
    """(argmax, top-2 logit gap) of the step that consumes ``seq[-1]`` at
    row len(seq)-1, in plain torch at one lane (a mismatch's diagnosis)."""
    import torch

    from brpc_tpu_torch.models.decoder import decode_step

    dev, dim = params.embed.device, params.embed.shape[1]
    L = len(seq)
    kv_k = torch.zeros((1, L, dim), device=dev)
    kv_v = torch.zeros_like(kv_k)
    for p, tok in enumerate(seq[:-1]):
        _n, k, v = decode_step(params, kv_k, kv_v,
                               torch.tensor([p], device=dev),
                               torch.tensor([tok], device=dev))
        kv_k[0, p], kv_v[0, p] = k[0], v[0]
    p = L - 1
    x = params.embed[seq[-1]] + params.pos[p]
    kv_k[0, p], kv_v[0, p] = x @ params.wk, x @ params.wv
    attn = torch.softmax((kv_k[0] @ (x @ params.wq)) / dim ** 0.5, dim=0)
    logits = (attn @ kv_v[0]) @ params.wo + 0.5 * params.pos[p]
    top = torch.topk(logits @ params.embed.T, 2)
    return int(top.indices[0]), float(top.values[0] - top.values[1])


def _stream_sessions(port: int, specs: list) -> dict:
    """Every session over tpu:// on a thread of its own; the shared-prefix
    group's followers open once their leader's first token arrived (so
    its prompt blocks are cached). -> tokens, TTFTs and the wall time."""
    from brpc_tpu_torch.serving import ServingClient

    n = len(specs)
    tokens, ttft, errs = [None] * n, [None] * n, []
    leader_first = threading.Event()

    def one(i):
        prompt, max_tokens = specs[i]
        try:
            if 0 < i < SERVE["group"]:
                if not leader_first.wait(300):
                    raise TimeoutError("the prefix leader never streamed")
            with ServingClient(f"tpu://127.0.0.1:{port}", tenant=f"t{i % 4}",
                               timeout_ms=60000) as c:
                with c.open(prompt, max_tokens) as ts:
                    got = []
                    for tok in ts:
                        got.append(tok)
                        if i == 0:
                            leader_first.set()
                    tokens[i], ttft[i] = got, ts.ttft_s
        except Exception as e:  # noqa: BLE001 — surfaced by the caller
            errs.append(f"session {i}: {type(e).__name__}: {e}")
            leader_first.set()

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
        if t.is_alive():
            errs.append("a stream reader hung")
    wall = time.monotonic() - t0
    if errs:
        fail("serving: " + "; ".join(errs))
    return {"tokens": tokens, "ttft": ttft, "wall": wall}


_SERVE_CACHE: dict = {}


def serving_path(seed: int, smi: str) -> dict:
    """Phase 7: single-node streaming serving on the card. Returns each
    run's launch counts (all zero: the serving path has no kernel)."""
    import gc

    import numpy as np
    import torch

    from brpc_tpu_torch.models.decoder import decode_serial
    from brpc_tpu_torch.runtime.state import decoder_params_from_numpy
    from brpc_tpu_torch.serving import ServingServer

    gc.collect()
    cfg = SERVE
    dev = torch.device("cuda")
    B, L = cfg["max_batch"], cfg["max_len"]
    params = decoder_params_from_numpy(
        _serve_values(seed + 70, cfg["vocab"], cfg["dim"], cfg["max_pos"]),
        device=dev)
    draft = decoder_params_from_numpy(
        _serve_values(seed + 71, cfg["vocab"], cfg["draft_dim"],
                      cfg["max_pos"]), device=dev)
    n_w = sum(t.numel() for t in params)
    specs = _serve_sessions(seed + 72)
    per_session = 2 * L * cfg["dim"] * 4
    arena_bytes = cfg["sessions"] * per_session + (8 << 20)
    log(f"serving: decoder {n_w} fp32 weights ({4 * n_w / 1e6:.1f} MB), "
        f"{len(specs)} sessions, prompts "
        f"{min(len(p) for p, _ in specs)}-{max(len(p) for p, _ in specs)} "
        f"tokens, budgets {min(m for _, m in specs)}-"
        f"{max(m for _, m in specs)}; KV {per_session} bytes a session, "
        f"arena {arena_bytes} bytes")
    launches = {}

    def run(label, **kw):
        srv = ServingServer(params, max_batch=B, max_len=L, dim=cfg["dim"],
                            kv_arena_bytes=arena_bytes, stall_timeout_s=60.0,
                            ttl_s=600.0, device=dev, **kw)
        steps = []
        inner = srv.engine.step

        def timed_step():
            t = time.monotonic()
            progressed = inner()
            if progressed:
                steps.append((time.monotonic() - t,
                              srv.engine.last_h2d_bytes))
            return progressed

        srv.engine.step = timed_step
        port = srv.start()
        try:
            out, got = _counted(f"serving, {label}",
                                lambda: _stream_sessions(port, specs), {})
            doc = srv.manager.sessionz_doc()
        finally:
            srv.stop()
        n_tok = sum(len(t) for t in out["tokens"])
        ttft = np.array(out["ttft"]) * 1e3
        step_ms = np.array([d for d, _ in steps]) * 1e3
        h2d = np.array([b for _, b in steps])
        stats = {"tokens": n_tok, "wall_s": out["wall"],
                 "tokens_per_s": n_tok / out["wall"],
                 "ttft_p50_ms": float(np.percentile(ttft, 50)),
                 "ttft_p99_ms": float(np.percentile(ttft, 99)),
                 "steps": len(steps),
                 "step_ms_median": float(np.median(step_ms)),
                 "h2d_bytes_median": int(np.median(h2d)),
                 "h2d_bytes_max": int(h2d.max()),
                 "spec_accept_pct": doc["spec_accept_pct"],
                 "prefix_hits": doc["prefix_hits"]}
        log(f"  {label}: {n_tok} tokens in {out['wall']:.3f} s = "
            f"{stats['tokens_per_s']:.1f} tokens/s; TTFT p50 "
            f"{stats['ttft_p50_ms']:.1f} ms p99 {stats['ttft_p99_ms']:.1f} "
            f"ms; {len(steps)} steps, median {stats['step_ms_median']:.2f} "
            f"ms; host->card {stats['h2d_bytes_median']} bytes a step "
            f"(median, max {stats['h2d_bytes_max']}); spec accept "
            f"{stats['spec_accept_pct']}%; prefix hits "
            f"{stats['prefix_hits']} ({smi})")
        launches[f"serving_{label.split(',')[0].replace(' ', '_')}"] = got
        return out["tokens"], stats

    mono, _ = run("monolithic")
    # The reference: each session alone in lane 0 of the engine's lane
    # count, its cache on the card.
    t0 = time.monotonic()
    serial = [decode_serial(params, p, m, L, lanes=B) for p, m in specs]
    log(f"  decode_serial (lanes={B}) of {len(specs)} sessions: "
        f"{time.monotonic() - t0:.1f} s")
    for i, (got, want) in enumerate(zip(mono, serial)):
        if got != want:
            j = next((k for k, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
            prompt = specs[i][0]
            _tok, gap = _top2_gap(params, prompt + want[:j])
            fail(f"serving: session {i} differs from decode_serial at "
                 f"token {j} ({got[j:j + 3]} vs {want[j:j + 3]}); the "
                 f"serial step's top-2 logit gap there is {gap:.3e}")
    log(f"  every session == decode_serial(lanes={B}) on the card, "
        f"{sum(len(t) for t in serial)} tokens")
    # Diagnosis only: one lane runs other matmul shapes than eight.
    t0 = time.monotonic()
    diverged = []
    for i, (p, m) in enumerate(specs):
        one = decode_serial(params, p, m, L, lanes=1)
        if one != serial[i]:
            j = next((k for k, (a, b) in enumerate(zip(one, serial[i]))
                      if a != b), min(len(one), len(serial[i])))
            diverged.append((i, j, _top2_gap(params, p + serial[i][:j])[1]))
    log(f"  decode_serial at one lane ({time.monotonic() - t0:.1f} s): "
        f"{len(diverged)} of {len(specs)} sessions diverge from {B} lanes"
        + "".join(f"; session {i} at token {j}, top-2 gap {g:.3e}"
                  for i, j, g in diverged))
    paged, st = run("paged", paged=True, block_rows=cfg["block_rows"])
    if paged != mono:
        fail("serving: the paged server's tokens != the monolithic one's")
    if st["prefix_hits"] < 1:
        fail("serving: the shared prefix never hit the paged cache")
    log("  paged == monolithic, token for token")
    for label, kw in (("spec ngram", {"draft": "ngram"}),
                      ("spec model", {"draft": "model",
                                      "draft_params": draft})):
        toks, _st = run(f"{label}, spec_k={cfg['spec_k']}",
                        spec_k=cfg["spec_k"], **kw)
        if toks != mono:
            fail(f"serving: {label} tokens != spec_k=0")
        log(f"  {label} == spec_k=0, token for token")
    del draft
    # Phase 8 serves the same decoder and sessions: it takes the weights
    # and the serial references from here.
    _SERVE_CACHE.update(params=params, specs=specs, serial=serial)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 8

def _fleet_key(client, addr: str, prefix: str) -> str:
    """The first key "<prefix>-<j>" whose sticky owner is ``addr``."""
    for j in range(100000):
        key = f"{prefix}-{j}"
        if client.router.route(key) == addr:
            return key
    fail(f"serving fleet: no session key owned by {addr}")


def _fleet_streams(client, items, when=None, action=None) -> dict:
    """Open ``items`` ((key, prompt, max_tokens) each) through the fleet
    client, each read to its end on a thread of its own. Once
    ``when(streams)`` holds (polled), ``action()`` runs on this thread
    while the streams go on. -> the streams, the action's result and the
    wall time from the first open to the last token."""
    n = len(items)
    streams, errs = [None] * n, []
    opened = threading.Barrier(n + 1)

    def one(i):
        key, prompt, max_tokens = items[i]
        try:
            streams[i] = client.open(prompt, max_tokens, session_key=key)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(f"session {key}: open: {type(e).__name__}: {e}")
        opened.wait()
        try:
            if streams[i] is not None:
                for _tok in streams[i]:
                    pass
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(f"session {key}: {type(e).__name__}: {e}")

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    opened.wait()
    result = None
    if action is not None:
        deadline = time.monotonic() + 300
        while not when(streams):
            if errs or time.monotonic() > deadline:
                fail("serving fleet: the streams never reached the "
                     "action's point: " + "; ".join(errs))
            time.sleep(0.005)
        result = action()
    for t in threads:
        t.join(600)
        if t.is_alive():
            errs.append("a stream reader hung")
    wall = time.monotonic() - t0
    if errs:
        fail("serving fleet: " + "; ".join(errs))
    return {"streams": streams, "result": result, "wall": wall}


def _stream_stats(streams, wall) -> dict:
    import numpy as np

    ttft = np.array([ts.ttft_s for ts in streams]) * 1e3
    n_tok = sum(len(ts.tokens) for ts in streams)
    return {"tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p99_ms": float(np.percentile(ttft, 99))}


def serving_fleet_path(seed: int, smi: str) -> dict:
    """Phase 8: the serving fleet on the card, every member on the one
    card in this process over one registry hub, at phase 7's decoder and
    sessions: a drain (A -> B) with the FleetObserver and a trace across
    both members, a one-sided drain with a forced miss, a paged
    migration of the shared-prefix group, and a prefill/decode split
    against a colocated pair. Every stream equals decode_serial(lanes=8);
    returns the path's launch counts (all zero)."""
    import numpy as np
    import torch

    from brpc_tpu_torch.fleet import RegistryHub, clear_registry
    from brpc_tpu_torch.observability import tracing
    from brpc_tpu_torch.observability.fleet_view import FleetObserver
    from brpc_tpu_torch.runtime import native
    from brpc_tpu_torch.serving import (FleetServingServer, ServingClient,
                                        ServingFleetClient, serving_metrics)

    cfg = SERVE
    params, specs, serial = (_SERVE_CACHE["params"], _SERVE_CACHE["specs"],
                             _SERVE_CACHE["serial"])
    dev = torch.device("cuda")
    B, L, D = cfg["max_batch"], cfg["max_len"], cfg["dim"]
    per_session = 2 * L * D * 4
    kv_bytes = serving_metrics()["migrated_kv_bytes"]
    hub = RegistryHub()
    hub.start()
    live_members = []
    out = {}

    def member(tag, sessions, **kw):
        srv = FleetServingServer(
            hub.hostport, params, tag=tag, max_batch=B, max_len=L, dim=D,
            kv_arena_bytes=sessions * per_session + (8 << 20),
            stall_timeout_s=60.0, ttl_s=600.0, reg_ttl_s=FLEET_TTL_S,
            device=dev, **kw)
        srv.start()
        live_members.append(srv)
        return srv

    def client(tag):
        c = ServingFleetClient(hub.hostport, tag=tag, timeout_ms=60000,
                               op_deadline_s=120.0)
        c.router.refresh(force=True)
        return c

    def close(c, *servers):
        c.close()
        for srv in servers:
            srv.stop()
            live_members.remove(srv)

    def check_tokens(label, streams, idx):
        for ts, i in zip(streams, idx):
            if ts.tokens != serial[i]:
                j = next((k for k, (x, y) in enumerate(
                    zip(ts.tokens, serial[i])) if x != y),
                    min(len(ts.tokens), len(serial[i])))
                fail(f"serving fleet, {label}: session {i} != "
                     f"decode_serial(lanes={B}) at token {j} (resumes "
                     f"{ts.resumes})")

    def run():
        # -- 1. drain, observed -------------------------------------
        # One process: every member's /vars is the process's, so each
        # fleetz row reads the same series, and torch_serving_sessions
        # follows the newest manager. A is made last: its sessions are
        # the live ones when the observer looks.
        b = member("cs_drain", 16)
        a = member("cs_drain", 16)
        c = client("cs_drain")
        # Trace: rpcz on after the members started; one open on A, its
        # migration to B and the resume there, under one root span.
        tracing.rpcz_enable(True)
        tracing.rpcz_set_sample_1_in_n(1)
        ti = 4
        tkey = _fleet_key(c, a.addr, "trace")
        with tracing.trace_span("chip_smoke/fleet_session") as root:
            ts = c.open(specs[ti][0], specs[ti][1], session_key=tkey)
            while len(ts.tokens) < 3:
                ts.read_token(60000)
            if not a.migrate_session(a.manager.get(tkey), b.addr):
                fail("serving fleet: the traced session did not migrate")
            for _tok in ts:
                pass
        check_tokens("traced", [ts], [ti])
        ts.close()
        trace = FleetObserver(hub.hostport, tag="cs_drain").assemble(
            root.trace_id)
        tracing.rpcz_enable(False)
        servers = {m: [s for s in trace.spans if s["server_side"]
                       and s["service_method"] == m]
                   for m in ("Gen/Open", "Gen/Resume")}
        clients = {s["service_method"]: s.get("peer", "")
                   for s in trace.spans if not s["server_side"]}
        if trace.root is None or trace.root["service_method"] != \
                "chip_smoke/fleet_session" or not all(servers.values()):
            fail(f"serving fleet: the trace did not assemble: "
                 f"{trace.render()[:3000]}")
        log(f"  trace {trace.trace_id}: {len(trace.spans)} spans, one "
            f"root; Gen/Open served by A ({clients.get('Gen/Open')}), "
            f"Gen/Resume by B ({clients.get('Gen/Resume')}), "
            f"resumes {ts.resumes}")
        if ts.resumes != 1 or ts.addr != b.addr:
            fail("serving fleet: the traced stream did not follow its move")
        out["trace_spans"] = len(trace.spans)
        # The drain: A takes the eight longest trajectories (so they are
        # live when the last of them has streamed 3 tokens), B the rest.
        n = len(specs)
        longest = sorted(range(n), key=lambda i: -(len(specs[i][0])
                                                   + specs[i][1]))
        on_a = set(longest[:n // 2])
        keys = [_fleet_key(c, a.addr if i in on_a else b.addr, f"d{i}")
                for i in range(n)]
        items = [(keys[i], specs[i][0], specs[i][1]) for i in range(n)]
        obs = FleetObserver(hub.hostport, tag="cs_drain")
        seen = {}

        def ready(streams):
            return all(streams[i] is not None and len(streams[i].tokens) >= 3
                       for i in on_a)

        def drain():
            seen["fleetz"] = obs.fleetz()
            seen["prom"] = obs.fleet_prometheus()
            t = time.monotonic()
            moved = a.drain()
            return moved, time.monotonic() - t

        before = kv_bytes.value()
        r = _fleet_streams(c, items, ready, drain)
        moved, drain_s = r["result"]
        streams = r["streams"]
        check_tokens("drain", streams, range(n))
        shed, done = [], []
        for i in on_a:
            s = a.manager.get(keys[i])
            if s.state == "shed" and s.shed_reason == f"moved:{b.addr}":
                shed.append(i)
                if streams[i].resumes < 1:
                    fail(f"serving fleet: session {i} moved but its stream "
                         f"never resumed")
            elif s.state == "done" and streams[i].resumes == 0:
                done.append(i)  # finished before the drain
            else:
                fail(f"serving fleet: A's session {i} ended {s.state} "
                     f"({s.shed_reason!r})")
        if moved != len(shed) or moved < 1:
            fail(f"serving fleet: drain moved {moved}, A shed {len(shed)}")
        for i in range(n):
            live = [m.addr for m in (a, b) if m.manager.get(keys[i])
                    is not None and m.manager.get(keys[i]).state in
                    ("queued", "active", "frozen")]
            if live:
                fail(f"serving fleet: session {i} still live on {live}")
        with ServingClient(a.addr) as direct:
            try:
                direct.open([1], 2)
            except native.RpcError as e:
                if not e.draining:
                    fail(f"serving fleet: a drained member answered {e}")
            else:
                fail("serving fleet: a drained member admitted an open")
        rows = seen["fleetz"]["shards"]
        if sorted(r_["addr"] for r_ in rows) != sorted([a.addr, b.addr]) \
                or not all(r_["serving_sessions"] > 0
                           and r_["serving_tokens_s"] > 0 for r_ in rows):
            fail(f"serving fleet: fleetz rows {rows}")
        series = [ln for ln in seen["prom"].splitlines()
                  if ln and not ln.startswith("fleet_")]
        if not series or not all('shard="' in ln for ln in series):
            fail("serving fleet: a series without a shard label")
        gaps = np.array([streams[i].last_gap_s for i in shed]) * 1e3
        st = _stream_stats(streams, r["wall"])
        st.update(moved=moved, done_before=len(done), drain_s=drain_s,
                  bytes_path=kv_bytes.value() - before,
                  gap_p50_ms=float(np.percentile(gaps, 50)),
                  gap_max_ms=float(gaps.max()))
        out["drain"] = st
        log(f"  drain: {moved} of A's 8 sessions moved to B "
            f"({len(done)} had finished) in {drain_s * 1e3:.1f} ms; "
            f"{st['bytes_path']} KV bytes over the bytes path; resume gap "
            f"p50 {st['gap_p50_ms']:.1f} ms max {st['gap_max_ms']:.1f} ms; "
            f"{st['tokens']} tokens in {st['wall_s']:.3f} s = "
            f"{st['tokens_per_s']:.1f} tokens/s; TTFT p50 "
            f"{st['ttft_p50_ms']:.1f} ms p99 {st['ttft_p99_ms']:.1f} ms; "
            f"fleetz sessions/tokens_s "
            + ", ".join(f"{r_['serving_sessions']}/"
                        f"{r_['serving_tokens_s']:.0f}" for r_ in rows)
            + f"; E_DRAINING on a new open ({smi})")
        close(c, a, b)

        # -- 2. one-sided drain, one forced miss --------------------
        a, b = member("cs_oneside", 8, publish_kv=True), \
            member("cs_oneside", 8)
        c = client("cs_oneside")
        reads = []
        read_kv = b._read_kv_oneside

        def spy(manifest):
            kv = read_kv(manifest)
            reads.append(int(kv.nbytes))
            return kv

        b._read_kv_oneside = spy
        install = a._install_oneside
        missed = []

        def install_with_one_miss(manifest, dest):
            if not missed:
                # The slot vanishes between export and Install: the
                # destination's read misses and the bytes path serves.
                missed.append(manifest["session"])
                a.manager.oneside.unpublish(f"kv:{manifest['session']}:k")
            return install(manifest, dest)

        a._install_oneside = install_with_one_miss
        idx = sorted(on_a)
        items = [(_fleet_key(c, a.addr, f"o{i}"), specs[i][0], specs[i][1])
                 for i in idx]
        before = kv_bytes.value()
        r = _fleet_streams(c, items, lambda s: all(
            x is not None and len(x.tokens) >= 3 for x in s), a.drain)
        check_tokens("one-sided drain", r["streams"], idx)
        moved2 = r["result"]
        bytes2 = kv_bytes.value() - before
        if moved2 < 2 or len(reads) != moved2 - 1 or not missed:
            fail(f"serving fleet: one-sided drain moved {moved2}, "
                 f"{len(reads)} one-sided reads, miss {missed}")
        out["oneside"] = {"moved": moved2, "oneside_installs": len(reads),
                          "oneside_bytes": sum(reads),
                          "bytes_installs": moved2 - len(reads),
                          "bytes_path": bytes2}
        log(f"  one-sided drain: {moved2} moved, {len(reads)} read "
            f"one-sided ({sum(reads)} KV bytes), {moved2 - len(reads)} "
            f"over the bytes path after a forced miss ({bytes2} bytes) "
            f"({smi})")
        close(c, a, b)

        # -- 3. paged migration of the shared-prefix group ----------
        a, b = (member("cs_paged", 8, paged=True,
                       block_rows=cfg["block_rows"]),
                member("cs_paged", 8, paged=True,
                       block_rows=cfg["block_rows"]))
        c = client("cs_paged")
        group = list(range(cfg["group"]))
        keys = [_fleet_key(c, a.addr, f"p{i}") for i in group]
        poss = []
        export = a.manager.export_session

        def export_logged(sess):
            manifest, kv = export(sess)
            poss.append(int(manifest["pos"]))
            return manifest, kv

        a.manager.export_session = export_logged

        def migrate_group():
            for k in keys:
                if not a.migrate_session(a.manager.get(k), b.addr):
                    fail(f"serving fleet: paged session {k} did not move")

        before = kv_bytes.value()
        r = _fleet_streams(
            c, [(k, specs[i][0], specs[i][1]) for k, i in zip(keys, group)],
            lambda s: all(x is not None and len(x.tokens) >= 3 for x in s),
            migrate_group)
        check_tokens("paged", r["streams"], group)
        slim = kv_bytes.value() - before
        full = sum(2 * p * D * 4 for p in poss)
        if slim >= full:
            fail(f"serving fleet: paged migration shipped {slim} bytes, "
                 f"the full planes are {full}")
        out["paged"] = {"slim_bytes": slim, "full_bytes": full,
                        "sessions": len(poss)}
        log(f"  paged (block_rows {cfg['block_rows']}): {len(poss)} "
            f"prefix-group sessions moved, {slim} KV bytes shipped against "
            f"{full} in full planes ({smi})")
        close(c, a, b)

        # -- 4. prefill/decode split against colocated --------------
        idx = list(range(4, 12))
        for label, roles in (("split", ("prefill", "decode")),
                             ("colocated", ("both", "both"))):
            tag = f"cs_{label}"
            m1, m2 = member(tag, 8, role=roles[0]), \
                member(tag, 8, role=roles[1])
            c = client(tag)
            items = [(f"{label}-{i}", specs[i][0], specs[i][1]) for i in idx]
            r = _fleet_streams(c, items)
            check_tokens(label, r["streams"], idx)
            if label == "split":
                for (key, _p, _m), ts in zip(items, r["streams"]):
                    sp, sd = m1.manager.get(key), m2.manager.get(key)
                    if (ts.resumes != 1 or ts.addr != m2.addr
                            or sp.shed_reason != f"moved:{m2.addr}"
                            or sp.out_tokens != ts.tokens[:1]
                            or sd.state != "done"
                            or sd.out_tokens != ts.tokens):
                        fail(f"serving fleet: split session {key}: "
                             f"resumes {ts.resumes}, prefill "
                             f"{sp.state}/{sp.shed_reason}")
            st = _stream_stats(r["streams"], r["wall"])
            out[label] = st
            log(f"  {label} ({'/'.join(roles)}): {st['tokens']} tokens in "
                f"{st['wall_s']:.3f} s = {st['tokens_per_s']:.1f} tokens/s; "
                f"TTFT p50 {st['ttft_p50_ms']:.1f} ms p99 "
                f"{st['ttft_p99_ms']:.1f} ms ({smi})")
            close(c, m1, m2)

    try:
        _out, got = _counted("serving fleet", run, {})
    finally:
        for srv in live_members:
            srv.stop()
        clear_registry()
        hub.stop()
        _SERVE_CACHE.clear()
    log(f"  serving fleet: K1/K2/K3 launches {got or 0} on this path")
    return {"serving_fleet": got}


# ---------------------------------------------------------------- main

# ---------------------------------------------------------------- phase 9

PS_OP_TAG = "chip_smoke_ps_operator"
# Phase 9's operator settings: each tenant may hold 2 calls in flight; the
# parameter service holds every admitted call 20 ms first (inject_latency),
# so the greedy tenant's window of 8 overruns its quota; pushes ride a
# window of 2, inside the quota.
PS_OP = {"quota": 2, "latency_ms": 20, "greedy_window": 8, "push_window": 2,
         "steady_name": "ln_f.weight"}


class _TenantCalls:
    """Counts the calls the given clients issue, by the tenant stamped on
    the issuing thread ("" = unstamped, which the server keys by ip)."""

    def __init__(self, *clients):
        import collections
        import ctypes

        from brpc_tpu_torch.runtime import native

        self.calls = collections.Counter()
        self._mu = threading.Lock()
        L = native.lib()
        for cl in clients:
            for attr in ("call_raw", "call_async"):
                real = getattr(cl.channel, attr)

                def counted(*a, _real=real, **k):
                    prio = ctypes.c_int()
                    buf = ctypes.create_string_buffer(512)
                    L.tbrpc_qos_get(ctypes.byref(prio), buf, len(buf))
                    with self._mu:
                        self.calls[buf.value.decode()] += 1
                    return _real(*a, **k)

                setattr(cl.channel, attr, counted)


def _plain_int8(x, dev):
    """What an int8 wire carries for ``x`` (a card tensor), widened by the
    plain dequantize: the host codec's codes, then dequantize_reference."""
    import torch

    from brpc_tpu_torch.ops import quantize as qz
    from brpc_tpu_torch.runtime import codec

    host = x.cpu().numpy()
    e = codec.encode(host, "int8")
    meta = {"dtype": "<f4", "shape": list(host.shape), "codec": "int8",
            "block": e.block}
    q, s = codec.split_wire(meta, e.wire)
    return qz.dequantize_reference(
        torch.from_numpy(q.copy()).to(dev), torch.from_numpy(s.copy()).to(dev),
        block=e.block, n=host.size, shape=host.shape)


def _replay_push(ref_p, ref_m, grads, dev, ef=None):
    """The plain replay of one push of ``grads`` into (ref_p, ref_m): raw,
    or (``ef``, an ErrorFeedback) the exact int8 codes the client sent."""
    import torch

    from brpc_tpu_torch.ops import fused_update as fu
    from brpc_tpu_torch.ops import quantize as qz
    from brpc_tpu_torch.runtime import codec

    for k, g in grads.items():
        if ef is not None and codec.eligible(g):
            x = ef.compensate(k, g.cpu().numpy())
            e = codec.encode(x, "int8")
            ef.settle(k, x, e.dequantized())
            meta = {"dtype": "<f4", "shape": list(g.shape), "codec": "int8",
                    "block": e.block}
            q, s = codec.split_wire(meta, e.wire)
            g = qz.dequantize_reference(
                torch.from_numpy(q.copy()).to(dev),
                torch.from_numpy(s.copy()).to(dev), block=e.block,
                n=g.numel(), shape=tuple(g.shape))
        ref_p[k], ref_m[k] = fu.momentum_update_reference(
            ref_p[k], ref_m[k], g, lr=LR, beta=BETA)


def _same_bits(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in (torch.float16, torch.bfloat16):
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def ps_operator_path(seed: int, smi: str) -> dict:
    """Phase 9: the parameter server's operator surface at the GPT-2 small
    parameter set on the card. (a) Two tenants share a server with a
    per-tenant quota: the greedy one is shed and paced but completes, the
    steady one is never shed, tenantz accounts for every call, and both
    tenants' int8 pushes land as a plain replay. (b) A server with
    ``codecs=()`` serves an int8 client raw. (c) The set in fp16 takes two
    raw pushes through K1's fp16 kernel. (d) A 2-shard fleet, one shard
    publishing raw and one int8, read with ``FleetClient(oneside=True)``.
    (e) Host only: a gRPC echo and a tidl stub call over the port. Returns
    the path's launch counts, which must equal the plan's."""
    import gc
    import statistics
    import tempfile

    import numpy as np
    import torch

    from brpc_tpu_torch.fleet import (FleetClient, FleetServer, RegistryHub,
                                      clear_registry)
    from brpc_tpu_torch.observability import metrics
    from brpc_tpu_torch.runtime import codec, native, tidl
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer,
                                                     PartialPullError)
    from brpc_tpu_torch.runtime.tensor import TensorArena

    gc.collect()  # earlier phases' arenas go back to /dev/shm first
    shapes = gpt2_shapes()
    names = sorted(shapes)
    dev = torch.device("cuda")
    elig = sorted(k for k in names
                  if 4 * int(np.prod(shapes[k])) >= codec.MIN_QUANT_BYTES)
    largest = max(4 * int(np.prod(s)) for s in shapes.values())
    srv_b = 2 * largest + (256 << 20)
    cli_b = largest + (256 << 20)
    host = make_params(shapes, seed)
    gen = torch.Generator(device=dev)

    def grads_for(step, dtype=torch.float32):
        gen.manual_seed(seed * 104729 + step)
        return {k: (torch.randn(shapes[k], generator=gen, device=dev)
                    * 1e-3).to(dtype) for k in names}

    def fresh_state(values):
        p = {k: torch.from_numpy(v).to(dev) for k, v in values.items()}
        return p, {k: torch.zeros_like(v) for k, v in p.items()}

    counters = _counts()
    for c in counters.values():
        c.reset()

    def snap():
        torch.cuda.synchronize()
        return {name: c.value for name, c in counters.items()}

    def delta(before):
        now = snap()
        return {name: now[name] - before[name] for name in now}

    def check(label, got, want):
        want = _full(want)
        log(f"  {label} launches: {got}")
        if got != want:
            fail(f"{label}: launch counts {got} != expected {want}")

    t_path = time.monotonic()
    closers = []

    def close_all():
        while closers:
            closers.pop()()
        gc.collect()

    try:
        # ---- (a) tenants
        before = snap()
        ps = ParameterServer(host, lr=LR, momentum=BETA,
                             arena=TensorArena(srv_b), device=dev)
        port = ps.start()
        closers.append(lambda ps=ps: (ps.stop(), ps.server.close()))
        ps.server.set_tenant_quota(PS_OP["quota"])
        addr = f"tpu://127.0.0.1:{port}"
        greedy = ParameterClient(addr, arena=TensorArena(cli_b),
                                 codec="int8", tenant="greedy", device=dev)
        steady = ParameterClient(addr, arena=TensorArena(cli_b),
                                 codec="int8", tenant="steady", device=dev)
        closers += [greedy.close, steady.close]
        calls = _TenantCalls(greedy, steady)
        greedy.meta()
        steady.meta()
        done = threading.Event()
        steady_lat, steady_bad = [], []
        sname = PS_OP["steady_name"]

        def steady_loop():
            while not done.is_set() or len(steady_lat) < 3:
                t0 = time.monotonic()
                try:
                    v, t = steady.pull(sname)
                except Exception as e:  # noqa: BLE001 — reported below
                    steady_bad.append(f"{type(e).__name__}: {e}")
                    return
                steady_lat.append(time.monotonic() - t0)
                if v != 0 or not torch.equal(t.cpu(),
                                             torch.from_numpy(host[sname])):
                    steady_bad.append(f"steady pull of {sname} (v{v}) != "
                                      "the server tensor")
                    return

        native.inject_latency("ParamService", PS_OP["latency_ms"])
        th = threading.Thread(target=steady_loop)
        got, missing, rounds = {}, list(names), 0
        t0 = time.monotonic()
        th.start()
        try:
            while missing:
                rounds += 1
                if rounds > 2000:
                    fail("the greedy tenant's pull_all never completed")
                try:
                    got.update(greedy.pull_all(
                        missing, window=PS_OP["greedy_window"]))
                    missing = []
                except PartialPullError as e:
                    if not e.overloaded:
                        raise
                    got.update(e.partial)
                    missing = e.missing
                except native.RpcError as e:
                    if not e.overloaded:
                        raise
        finally:
            done.set()
            th.join()
            native.inject_latency("", 0)
        torch.cuda.synchronize()
        t_greedy = time.monotonic() - t0
        if steady_bad:
            fail("steady tenant: " + "; ".join(steady_bad))
        tz = {t["name"]: t for t in ps.server.tenantz()["tenants"]}
        g_calls, s_calls = calls.calls["greedy"], calls.calls["steady"]
        log(f"(a) tenants, quota {PS_OP['quota']}, {PS_OP['latency_ms']} ms "
            f"injected: greedy pull_all(window={PS_OP['greedy_window']}) of "
            f"{len(names)} names (int8) in {t_greedy:.3f} s over {rounds} "
            f"rounds; {g_calls} calls, tenantz admitted "
            f"{tz['greedy']['admitted']} shed {tz['greedy']['shed']}, pacer "
            f"sheds {greedy.pacer.sheds}; steady {len(steady_lat)} pulls of "
            f"{sname}, p50 {statistics.median(steady_lat) * 1e3:.2f} ms, max "
            f"{max(steady_lat) * 1e3:.2f} ms, tenantz admitted "
            f"{tz['steady']['admitted']} shed {tz['steady']['shed']} ({smi})")
        if not (tz["greedy"]["shed"] >= 1 and greedy.pacer.sheds >= 1):
            fail("the greedy tenant was never shed")
        if tz["steady"]["shed"] != 0 or steady.pacer.sheds != 0:
            fail(f"the steady tenant was shed: {tz['steady']}")
        for name, n in (("greedy", g_calls), ("steady", s_calls)):
            row = tz[name]
            if row["admitted"] + row["shed"] != n or row["inflight"] != 0:
                fail(f"tenantz {name} {row} does not account for its {n} "
                     "calls")
        if tz["steady"]["admitted"] != len(steady_lat):
            fail(f"steady: {tz['steady']['admitted']} admitted for "
                 f"{len(steady_lat)} pulls")
        state = ps.state()
        for k in names:
            v, t = got[k]
            want = (_plain_int8(state.params[k], dev) if k in elig
                    else state.params[k])
            if v != 0 or not torch.equal(t, want):
                fail(f"greedy pull of {k} (v{v}) != the server tensor's "
                     "int8 wire")
        log("  every pulled tensor == the server's (raw, or its int8 wire "
            "widened by the plain dequantize), bit for bit")
        pulls_a = delta(before)
        check("(a) greedy pulls", pulls_a,
              {"brpc_dequant_int8": len(elig)})

        before = snap()
        ref_p, ref_m = fresh_state(host)
        for label, cl, step in (("greedy", greedy, 1), ("steady", steady, 2)):
            grads = grads_for(step)
            t0 = time.monotonic()
            vers = cl.push_all(grads, window=PS_OP["push_window"])
            torch.cuda.synchronize()
            log(f"  {label} push_all int8 (window {PS_OP['push_window']}): "
                f"{time.monotonic() - t0:.3f} s")
            if vers != {k: step for k in names}:
                fail(f"{label} push versions: {vers}")
            _replay_push(ref_p, ref_m, grads, dev, codec.ErrorFeedback())
        state = ps.state()
        for k in names:
            if not (torch.equal(state.params[k], ref_p[k])
                    and torch.equal(state.momenta[k], ref_m[k])):
                fail(f"{k}: two tenants' int8 pushes != the plain replay")
        log("  state after both tenants' int8 push_alls == plain replay "
            "(bit for bit)")
        tz = {t["name"]: t for t in ps.server.tenantz()["tenants"]}
        for name in ("greedy", "steady"):
            if (tz[name]["admitted"] + tz[name]["shed"]
                    != calls.calls[name]):
                fail(f"tenantz {name} {tz[name]} after the pushes does not "
                     f"account for its {calls.calls[name]} calls")
        check("(a) pushes", delta(before),
              {"brpc_fused_momentum": 2 * len(names),
               "brpc_dequant_int8": 2 * len(elig)})
        close_all()
        del ps, greedy, steady, calls, got, state, ref_p, ref_m

        # ---- (b) a server with its codecs withdrawn
        before = snap()
        ps = ParameterServer(host, lr=LR, momentum=BETA, codecs=(),
                             arena=TensorArena(srv_b), device=dev)
        port = ps.start()
        closers.append(lambda ps=ps: (ps.stop(), ps.server.close()))
        cl = ParameterClient(f"tpu://127.0.0.1:{port}", codec="int8",
                             arena=TensorArena(cli_b), device=dev)
        closers.append(cl.close)
        if cl.negotiated_codec() is not None:
            fail("a codecs=() server negotiated a codec")
        pulled = cl.pull_all()
        for k in names:
            if not torch.equal(pulled[k][1].cpu(), torch.from_numpy(host[k])):
                fail(f"(b) raw pull of {k} != the seeded tensor")
        ref_p, ref_m = fresh_state(host)
        grads = grads_for(3)
        if cl.push_all(grads) != {k: 1 for k in names}:
            fail("(b) push versions")
        _replay_push(ref_p, ref_m, grads, dev)
        state = ps.state()
        pulled = cl.pull_all()
        for k in names:
            if not (torch.equal(state.params[k], ref_p[k])
                    and torch.equal(state.momenta[k], ref_m[k])
                    and torch.equal(pulled[k][1], ref_p[k])):
                fail(f"(b) {k}: state or pull != the raw plain replay")
        log("(b) codecs=() server: the int8 client negotiated None; raw "
            "pull_all == seeded set, raw push_all == plain replay, pull == "
            "state (bit for bit)")
        check("(b) codecs=()", delta(before),
              {"brpc_fused_momentum": len(names)})
        close_all()
        del ps, cl, pulled, state, ref_p, ref_m

        # ---- (c) fp16 parameters
        before = snap()
        host16 = {k: v.astype(np.float16) for k, v in host.items()}
        nbytes16 = sum(v.nbytes for v in host16.values())
        ps = ParameterServer(host16, lr=LR, momentum=BETA,
                             arena=TensorArena(srv_b), device=dev)
        port = ps.start()
        closers.append(lambda ps=ps: (ps.stop(), ps.server.close()))
        cl = ParameterClient(f"tpu://127.0.0.1:{port}",
                             arena=TensorArena(cli_b), device=dev)
        closers.append(cl.close)
        ref_p, ref_m = fresh_state(host16)
        for step in (4, 5):
            grads = grads_for(step, torch.float16)
            t0 = time.monotonic()
            if cl.push_all(grads) != {k: step - 3 for k in names}:
                fail(f"(c) fp16 push {step - 3} versions")
            torch.cuda.synchronize()
            log(f"(c) fp16 push_all #{step - 3} ({nbytes16 / 1e6:.1f} MB): "
                f"{time.monotonic() - t0:.3f} s")
            _replay_push(ref_p, ref_m, grads, dev)
        state = ps.state()
        for k in names:
            if not (_same_bits(state.params[k], ref_p[k])
                    and _same_bits(state.momenta[k], ref_m[k])):
                fail(f"(c) fp16 {k}: state != the plain half replay")
        v, t = cl.pull("wte.weight")
        if v != 2 or not _same_bits(t, state.params["wte.weight"]):
            fail("(c) fp16 pull of wte != the server tensor")
        log("  fp16 state == plain half-precision replay (bit for bit); "
            "fp16 pull == server")
        check("(c) fp16", delta(before),
              {"brpc_fused_momentum_f16": 2 * len(names)})
        close_all()
        del ps, cl, state, ref_p, ref_m, host16

        # ---- (d) one-sided fleet reads, one shard raw, one int8
        before = snap()
        ar = _fleet_arenas(shapes, codec)
        hub = RegistryHub()
        hub.start()
        closers.append(lambda: (clear_registry(), hub.stop()))
        shards = []
        for i, pub in enumerate((None, "int8")):
            s = FleetServer(hub.hostport, tag=PS_OP_TAG,
                            shard_name=f"ps_op_s{i}", ttl_s=FLEET_TTL_S,
                            device=dev, lr=LR, momentum=BETA, oneside=True,
                            oneside_codec=pub,
                            arena=TensorArena(ar["server"]))
            s.start()
            shards.append(s)
            closers.append(lambda s=s: (s.stop(), s.ps.server.close()))
        fq = FleetClient(hub.hostport, tag=PS_OP_TAG, codec="int8",
                         device=dev, arena_bytes=ar["client"],
                         op_deadline_s=300.0)
        fr = FleetClient(hub.hostport, tag=PS_OP_TAG, device=dev,
                         arena_bytes=ar["small"], op_deadline_s=300.0)
        fo = FleetClient(hub.hostport, tag=PS_OP_TAG, device=dev,
                         arena_bytes=ar["small"], op_deadline_s=300.0,
                         oneside=True)
        closers += [fq.close, fr.close, fo.close]
        for k in names:
            fq.install(k, host[k], refresh=False)
        owner = {k: s.addr for s in shards for k in s.ps.state().params}
        if sorted(owner) != names:
            fail("(d) the fleet does not hold every name once")
        int8_pub = [k for k in elig if owner[k] == shards[1].addr]
        t0 = time.monotonic()
        raw = fr.pull_all(names)
        torch.cuda.synchronize()
        t_raw = time.monotonic() - t0
        t0 = time.monotonic()
        q = fq.pull_all(names)
        torch.cuda.synchronize()
        t_q = time.monotonic() - t0
        hits = metrics.counter("torch_oneside_pull_hits")
        h0, k2 = hits.value(), counters["brpc_dequant_int8"].value
        t0 = time.monotonic()
        one = fo.pull_all(names)
        torch.cuda.synchronize()
        t_one = time.monotonic() - t0
        k2_one = counters["brpc_dequant_int8"].value - k2
        if hits.value() - h0 != len(names):
            fail(f"(d) one-sided hits {hits.value() - h0} for {len(names)} "
                 "names")
        for k in names:
            want = q[k] if k in int8_pub else raw[k]
            if one[k][0] != want[0] or not torch.equal(one[k][1], want[1]):
                fail(f"(d) one-sided pull of {k} != the RPC pull_all")
            if not torch.equal(raw[k][1].cpu(), torch.from_numpy(host[k])):
                fail(f"(d) raw fleet pull of {k} != the seeded tensor")
        n_raw = sum(1 for k in names if owner[k] == shards[0].addr)
        log(f"(d) 2-shard fleet ({n_raw} names published raw, "
            f"{len(names) - n_raw} int8): "
            f"FleetClient(oneside=True) pull_all {t_one:.3f} s, RPC raw "
            f"{t_raw:.3f} s, RPC int8 {t_q:.3f} s; one-sided == RPC "
            f"(raw names == raw pull, int8 names == PullQ) bit for bit; K2 "
            f"{k2_one} on the one-sided read for {len(int8_pub)} int8 "
            f"publications ({smi})")
        if k2_one != len(int8_pub):
            fail(f"(d) K2 launched {k2_one} times for {len(int8_pub)} int8 "
                 "publications")
        check("(d) one-sided fleet", delta(before),
              {"brpc_dequant_int8": len(elig) + len(int8_pub)})
        close_all()
        del shards, fq, fr, fo, raw, q, one

        # ---- (e) host only: gRPC and a generated tidl stub
        srv = native.Server()
        srv.add_echo_service()
        closers.append(srv.close)
        ch = native.Channel(f"127.0.0.1:{srv.start()}", timeout_ms=10000,
                            protocol="grpc")
        closers.append(ch.close)
        payload = os.urandom(1 << 16)
        if ch.call("EchoService/Echo", payload)[0] != payload:
            fail("(e) gRPC echo against the port's server")
        with tempfile.TemporaryDirectory() as out:
            stub = tidl.load_stub(tidl.generate(
                os.path.join(HERE, "examples", "echo.tidl"), out))

        class Impl:
            def Echo(self, request, attachment):
                return stub.EchoResponse(
                    message=request.message[::-1], serial=request.serial,
                    stats=stub.Stats(served=1, mean_len=2.5)), attachment

        tsrv = native.Server()
        stub.add_EchoService(tsrv, Impl())
        closers.append(tsrv.close)
        tch = native.Channel(f"127.0.0.1:{tsrv.start()}", timeout_ms=10000)
        closers.append(tch.close)
        resp, att = stub.EchoServiceStub(tch).Echo(
            stub.EchoRequest(message="tidl", serial=-7, history=[1, 2]),
            attachment=b"att")
        if (resp.message, resp.serial, resp.stats.mean_len, att) != (
                "ldit", -7, 2.5, b"att"):
            fail(f"(e) tidl stub call: {resp}, {att}")
        log("(e) host only: gRPC echo of 65536 bytes against the port's "
            "server, and a tools/tidl_gen.cpp stub (echo.tidl) over the "
            "port, both == expected")
        close_all()
        launches = delta({name: 0 for name in counters})
        log(f"ps_operator path: {time.monotonic() - t_path:.3f} s; launches "
            f"{launches}")
        return {k: v for k, v in launches.items() if v}
    finally:
        native.inject_latency("", 0)
        close_all()


# --------------------------------------------------------------- phase 10

# Phase 10: PLANE's stack and batch over a client x shard mesh of 2 x 2
# ranks sharing the card over gloo, two steps each way.
MESH = {"client": 2, "shard": 2, "steps": 2, "window": 4}


def _timed_verbs(sink: list):
    """Wraps the torch.distributed verbs the mesh harness calls so each
    call appends its seconds to ``sink``, the card idle on both sides of
    it (the compute before it is the step's, not the verb's); returns
    the function that restores them."""
    import torch
    import torch.distributed as dist

    saved = {n: getattr(dist, n) for n in ("all_reduce", "broadcast",
                                           "gather")}

    def wrap(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.monotonic()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            sink.append(time.monotonic() - t)
            return out
        return run

    for n, fn in saved.items():
        setattr(dist, n, wrap(fn))
    return lambda: [setattr(dist, n, fn) for n, fn in saved.items()]


def _mesh_drive(mesh, addr: str, overlap: bool, seed: int, dev) -> dict:
    """One rank of a mesh harness run: ``LayeredMLP(PLANE["sizes"],
    mesh=)`` under an ``OverlappedStepDriver`` — with a ParameterClient
    on the wire rank, ``client=None`` elsewhere — for MESH["steps"] steps
    of batch PLANE["batch"]; per step its loss, wall time and the time
    its collectives took."""
    import torch
    import torch.distributed as dist

    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.runtime.param_server import ParameterClient
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver
    from brpc_tpu_torch.runtime.tensor import TensorArena

    h = LayeredMLP(PLANE["sizes"], mesh=mesh, seed=seed, device=dev)
    cl = (ParameterClient(addr, arena=TensorArena(256 << 20), device=dev)
          if h.is_wire else None)
    verbs: list = []
    restore = _timed_verbs(verbs)
    try:
        d = OverlappedStepDriver(cl, h, overlap=overlap,
                                 window=MESH["window"])
        d.prime()
        steps = []
        for i in range(MESH["steps"]):
            x, y = h.data(PLANE["batch"], seed=seed + 100 + i)
            torch.cuda.synchronize()
            n0, t = len(verbs), time.monotonic()
            loss = d.step(x, y)
            torch.cuda.synchronize()
            steps.append({"loss": loss, "wall_s": time.monotonic() - t,
                          "verb_s": sum(verbs[n0:]),
                          "verbs": len(verbs) - n0})
    finally:
        restore()
        if cl is not None:
            cl.close()
    return {"rank": dist.get_rank(), "is_wire": h.is_wire, "steps": steps,
            "versions": dict(d.versions)}


def _mesh_rank(addr: str, overlap: bool, seed: int) -> dict:
    """A spawned rank of phase 10's shared-card mesh."""
    import torch

    from brpc_tpu_torch.ops import fused_update as fu
    from brpc_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out = _mesh_drive(make_mesh(MESH["client"], MESH["shard"]), addr,
                      overlap, seed, torch.device("cuda", 0))
    out["k1_in_rank"] = fu.LAUNCHES.value
    return out


def mesh_harness_path(seed: int, smi: str) -> dict:
    """Phase 10: LayeredMLP over a client x shard mesh, one wire rank,
    against the single-device harness on the same driver and server.
    Returns each run's launch counts."""
    import gc

    import torch

    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.parallel.launch import one_rank_group, run_ranks
    from brpc_tpu_torch.parallel.mesh import make_mesh
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver
    from brpc_tpu_torch.runtime.tensor import TensorArena

    gc.collect()
    dev = torch.device("cuda")
    sizes, batch, steps = PLANE["sizes"], PLANE["batch"], MESH["steps"]
    h = LayeredMLP(sizes, seed=seed, device=dev)
    init = {k: v.cpu().numpy() for k, v in h.init_params().items()}
    names = h.names
    want = {"brpc_fused_momentum": len(names) * steps}
    n = MESH["client"] * MESH["shard"]
    log(f"mesh harness: {len(names)} layers {sizes[:3]}..., batch {batch}, "
        f"{MESH['client']} x {MESH['shard']} mesh of {n} ranks sharing the "
        f"card over gloo, a 1-rank NCCL mesh and one device, {steps} steps "
        f"each; the ParameterServer in this process, rank 0 on the wire")
    launches, results = {}, {}

    def served(label, run):
        """``run(addr)`` against a fresh server seeded with ``init``,
        counted; -> (run's result, the server's final params)."""
        ps = ParameterServer(init, lr=LR, momentum=BETA,
                             arena=TensorArena(256 << 20), device=dev)
        try:
            out, launches[label] = _counted(
                f"mesh harness, {label}", lambda: run(
                    f"tpu://127.0.0.1:{ps.start()}"), want)
            state = ps.state()
            if state.versions != {k: steps for k in names}:
                fail(f"{label}: server versions {state.versions}")
            return out, state.params
        finally:
            ps.stop()
            ps.server.close()

    def single(addr):
        cl = ParameterClient(addr, arena=TensorArena(256 << 20), device=dev)
        try:
            d = OverlappedStepDriver(cl, h, overlap=True,
                                     window=MESH["window"])
            d.prime()
            out = []
            for i in range(steps):
                x, y = h.data(batch, seed=seed + 100 + i)
                torch.cuda.synchronize()
                t = time.monotonic()
                loss = d.step(x, y)
                torch.cuda.synchronize()
                out.append({"loss": loss, "wall_s": time.monotonic() - t,
                            "verb_s": 0.0, "verbs": 0})
            return [{"rank": 0, "is_wire": True, "steps": out,
                     "versions": dict(d.versions)}]
        finally:
            cl.close()

    def nccl_one(addr):
        with one_rank_group("cuda"):
            return [_mesh_drive(make_mesh(1, 1), addr, True, seed, dev)]

    runs = [("single_device", single),
            ("mesh_2x2_overlapped", lambda a: run_ranks(
                n, _mesh_rank, (a, True, seed), device_type="cuda",
                share_card=True, timeout_s=600)),
            ("mesh_2x2_serial", lambda a: run_ranks(
                n, _mesh_rank, (a, False, seed), device_type="cuda",
                share_card=True, timeout_s=600)),
            ("mesh_nccl_1rank", nccl_one)]
    for label, run in runs:
        ranks, params = served(label, run)
        results[label] = (ranks, params)
        wire = [r for r in ranks if r["is_wire"]]
        if [r["rank"] for r in wire] != [0] or wire[0]["versions"] != {
                k: steps for k in names}:
            fail(f"{label}: the wire rank is {[r['rank'] for r in wire]} "
                 f"with versions {wire[0]['versions'] if wire else None}")
        losses = [s["loss"] for s in wire[0]["steps"]]
        for r in ranks:
            if [s["loss"] for s in r["steps"]] != losses:
                fail(f"{label}: rank {r['rank']}'s losses differ from the "
                     "wire rank's")
            if r.get("k1_in_rank", 0):
                fail(f"{label}: rank {r['rank']} launched K1 "
                     f"{r['k1_in_rank']} times")
        for i in range(steps):
            wall = max(r["steps"][i]["wall_s"] for r in ranks)
            verb = max(r["steps"][i]["verb_s"] for r in ranks)
            calls = wire[0]["steps"][i]["verbs"]
            log(f"  {label} step {i + 1}: {wall * 1e3:.1f} ms wall (slowest "
                f"rank), collectives {verb * 1e3:.1f} ms ({calls} calls on "
                f"the wire rank), the rest {(wall - verb) * 1e3:.1f} ms; "
                f"loss {losses[i]:.6f} ({smi})")
        del ranks, params
        gc.collect()

    ref_losses = [s["loss"] for s in results["single_device"][0][0]["steps"]]
    ref_params = results["single_device"][1]
    for label in ("mesh_2x2_overlapped", "mesh_2x2_serial",
                  "mesh_nccl_1rank"):
        ranks, params = results[label]
        losses = [s["loss"] for s in ranks[0]["steps"]]
        if not all(abs(a - b) <= 1e-6 + 2e-5 * abs(b)
                   for a, b in zip(losses, ref_losses)):
            fail(f"{label}: losses {losses} vs one device {ref_losses} "
                 "outside rtol 2e-5, atol 1e-6")
        worst = _close_state(f"{label} weights vs one device", params,
                             ref_params)
        log(f"  {label} == one device within rtol 2e-5, atol 1e-6 (worst "
            f"ratio {worst:.3f}); K1 {want['brpc_fused_momentum']} on the "
            f"server, none in the ranks")
    (ov, pov), (se, pse) = (results["mesh_2x2_overlapped"],
                            results["mesh_2x2_serial"])
    lo = [s["loss"] for s in ov[0]["steps"]]
    ls = [s["loss"] for s in se[0]["steps"]]
    if not all(abs(a - b) <= 1e-8 + 1e-6 * abs(b) for a, b in zip(lo, ls)):
        fail(f"mesh overlapped losses {lo} vs serial {ls} outside 1e-6")
    worst = _close_state("mesh overlapped vs serial weights", pov, pse,
                         rtol=1e-6, atol=1e-8)
    log(f"  mesh overlapped == serial within rtol 1e-6, atol 1e-8 (worst "
        f"ratio {worst:.3f})")
    return launches


# --------------------------------------------------------------- phase 11

def mla_moe_path(seed: int, smi: str) -> dict:
    """Phase 11: one step of the MLA + MoE stack through the overlapped
    driver against a parameter server on the card, held against the
    benchmark's plain reference. Returns the launch counts."""
    import gc

    import torch

    sys.path.insert(0, os.path.join(HERE, "benchmark"))
    from harness import checks, reference_mla_moe, train_blocks

    from brpc_tpu_torch.models.mla_moe import MLAMoEStack
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver
    from brpc_tpu_torch.runtime.tensor import TensorArena

    gc.collect()
    dev = torch.device("cuda")
    with open(os.path.join(HERE, MLA_MOE["config"])) as f:
        doc = json.load(f)
    cfg, held = train_blocks.arch(doc["model"])
    model = doc["model"]
    w = train_blocks.weights(seed, cfg, held, model["initializer_range"],
                             dev)
    bias = train_blocks.correction_bias(seed, cfg,
                                        model["correction_bias_std"], dev)
    (x, y), = train_blocks.batches(seed, 1, MLA_MOE["batch"], MLA_MOE["seq"],
                                   cfg["vocab_size"], dev)
    n_w = sum(v.numel() for v in w.values())
    log(f"MLA + MoE stack: {len(w)} tensors, {n_w} fp32 weights "
        f"({4 * n_w / 1e9:.2f} GB), experts {held} of "
        f"{cfg['n_routed_experts']}, batch {tuple(x.shape)}")
    with open(os.path.join(HERE, MLA_MOE["mix"])) as f:
        srv_bytes, cl_bytes = train_blocks.arena_bytes(
            json.load(f), reference_mla_moe.shapes(cfg, held))
    h = MLAMoEStack(cfg, experts_held=held, correction_bias=bias,
                    device=dev)
    ps = ParameterServer({k: v.clone() for k, v in w.items()},
                         lr=LR, momentum=BETA, device=dev,
                         arena=TensorArena(srv_bytes))
    cl = ParameterClient(f"tpu://127.0.0.1:{ps.start()}", device=dev,
                         arena=TensorArena(cl_bytes))
    try:
        driver = OverlappedStepDriver(cl, h, overlap=True, window=4)
        driver.prime()
        loss, launches = _counted(
            "MLA + MoE overlapped step (the first: no warm-up)",
            lambda: driver.step(x, y),
            {"brpc_fused_momentum": len(w),
             "brpc_mla_attn_fwd": cfg["num_hidden_layers"],
             "brpc_mla_attn_bwd": cfg["num_hidden_layers"]})
        routes = dict(zip(h.moe_layers, h.last_routes))
        st = ps.state()
    finally:
        cl.close()
        ps.stop()
        ps.server.close()
    if set(driver.versions.values()) != {1}:
        fail(f"MLA + MoE: versions {set(driver.versions.values())} != {{1}}")
    want, ref_loss, own = reference_mla_moe.grads(w, bias, x, y, cfg, held,
                                                  routes)
    if not abs(loss - ref_loss) <= MLA_MOE["loss_rtol"] * abs(ref_loss):
        fail(f"MLA + MoE: loss {loss!r} vs the reference's {ref_loss!r}")
    worst = 0.0
    for k, g in want.items():
        err = checks.rel_max(st.momenta[k], g)
        worst = max(worst, err)
        if not err <= MLA_MOE["grad_rtol"]:
            fail(f"MLA + MoE: {k} gradient {err:.3g} of its largest value "
                 f"from the reference's")
    flips = reference_mla_moe.route_flips([routes], [own],
                                          MLA_MOE["tie_width"])
    if flips:
        fail(f"MLA + MoE: {flips} routes differ from the reference's own "
             f"choice outside near ties")
    log(f"  loss {loss:.6f} vs the reference's {ref_loss:.6f}, worst "
        f"gradient {worst:.3g} of its largest value, 0 route flips ({smi})")
    return {"mla_moe": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "brpc_tpu_torch")):
        fail("brpc_tpu_torch/ is not beside this script: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "a CUDA card")
    if shutil.which("nvidia-smi") is None:
        fail("nvidia-smi not found")
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    rate = published_rate(name)
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; bound uses "
        f"{rate / 1e12:.2f} TB/s device memory")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_all = time.monotonic()
    t0 = time.monotonic()
    setup()
    log(f"== phase 1 (set-up) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    rows = kernels_vs_plain(args.seed, rate)
    rows.append(flash_vs_plain(args.seed, rate,
                               published_rate(name, _BF16_RATE),
                               published_rate(name, _F32_RATE),
                               published_rate(name, _TF32_RATE)))
    rows += mla_vs_plain(args.seed, published_rate(name, _TF32_RATE))
    log(f"== phase 2 (kernels vs plain) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    by_path = {"param_server": main_path(args.seed)}
    log(f"== phase 3 (parameter-server path) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    by_path.update(tensor_service_paths(args.seed, smi))
    log(f"== phase 4 (TensorService paths) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    by_path["fleet"] = fleet_path(args.seed, smi)
    log(f"== phase 5 (parameter-server fleet) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    by_path.update(training_plane(args.seed, smi))
    log(f"== phase 6 (training plane) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    by_path.update(serving_path(args.seed, smi))
    log(f"== phase 7 (serving) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    by_path.update(serving_fleet_path(args.seed, smi))
    log(f"== phase 8 (serving fleet) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    by_path["ps_operator"] = ps_operator_path(args.seed, smi)
    log(f"== phase 9 (parameter-server operator surface) "
        f"{time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    by_path.update(mesh_harness_path(args.seed, smi))
    log(f"== phase 10 (mesh harness) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    by_path.update(mla_moe_path(args.seed, smi))
    log(f"== phase 11 (MLA + MoE stack) {time.monotonic() - t0:.1f} s")
    for r in rows:
        # Every path, zeros included: the serving runs list 0 for each.
        r["launches_by_path"] = {p: c.get(r["name"], 0)
                                 for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if not r["launches"] and r.get("on_path", True):
            fail(f"{r['name']} was launched on no path")
        f32 = r.get("f32_shape")
        if f32:  # K3's fp32 kernel, counted apart within brpc_flash_carry
            f32["launches_by_path"] = {
                p: c.get("brpc_flash_carry_tf32x3", 0)
                for p, c in by_path.items()}
            f32["launches"] = sum(f32["launches_by_path"].values())
            if not f32["launches"]:
                fail(f"{f32['kernel']} was launched on no path")
    log(f"== all phases {time.monotonic() - t_all:.1f} s")
    log(smi)
    print(json.dumps({"kernels": rows, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
