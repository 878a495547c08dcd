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
     layer and at bench.py's flash point plus edge cases, within stated
     tolerances; times at the largest shapes beside the bound and a
     library call where one computes the same function;
  3. the parameter-server path: a ParameterServer on the card holding the
     GPT-2 small parameter set (124,439,808 fp32 values, random from
     --seed) serves pulls and int8 pushes over tpu:// to clients in this
     process; the results are held against a plain-PyTorch replay on the
     card, and the kernels' launch counts show the path went through them;
  4. the TensorService paths: train_step at the GPT-2 small MLP width
     (3 steps, bit-identical to a plain replay, 2 K1 launches a step);
     a 4-shard ring replay of the Llama layer through K3 (16 launches),
     equal to one-shot flash attention; dryrun_multichip(1) on a one-rank
     NCCL group;
  5. the parameter-server fleet at the same GPT-2 small parameter set,
     both shards on the card: install, a raw pull_all, an int8 push_all,
     a second shard joins and the Migrator (on the registry's watch edge)
     reshards 1 -> 2 while a thread keeps pulling (no torn or stale
     tensor), another int8 push_all, one-sided pull_alls on each shard
     against its RPC pulls; the state against a plain replay, placement
     against the ketama plan, launches against the plan's counts.

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

# OpenAI's published gpt2 (124M) config.
GPT2_SMALL = {"n_layer": 12, "n_embd": 768, "n_ctx": 1024, "vocab": 50257}
LR, BETA = 0.01, 0.9
PUSHES = 3

# Published device-memory rates (NVIDIA data sheets), bytes/s: the PCIe
# part, else the SXM part ("NVIDIA H100 80GB HBM3").
_HBM_RATE = (("H100 PCIe", 2.0e12), ("H100", 3.35e12))
# Dense bf16 tensor-core peaks, FLOP/s (the same data sheets).
_BF16_RATE = (("H100 PCIe", 756e12), ("H100", 989e12))
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
                                   "brpc_tpu/ops/fused_update.py:23"),
           "brpc_dequant_int8": ("brpc_tpu_torch/ops/csrc/quantize.cu",
                                 "brpc_tpu/ops/quantize.py:32"),
           "brpc_dequant_fp8e4m3": ("brpc_tpu_torch/ops/csrc/quantize.cu",
                                    "brpc_tpu/ops/quantize.py:32")}
    for name, t in timing.items():
        log(f"{name} at wte {shapes[0]}: kernel_ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
            f"({t['bound_by']}) library_ms="
            + ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f}"))
        rows.append({"name": name, "ported": True, "route": "cuda",
                     "source": src[name][0],
                     "replaces": src[name][1], "launches": None,
                     "max_abs_err": errs[name], **t})
    return rows


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
    from brpc_tpu_torch.ops import quantize as qz

    ms = cuda_ms(lambda: qz.dequantize_blocks(q, s, block=block, n=n,
                                              shape=shape))
    plain = cuda_ms(lambda: qz.dequantize_reference(q, s, block=block, n=n,
                                                    shape=shape))
    return {"ms": ms, "plain_ms": plain,
            "bound_ms": _bound(float(n + 4 * s.numel() + 4 * n), rate),
            "bound_by": "bytes",
            "library_ms": None}


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


def _flash_case(label, q, k, v, carry, offsets, causal) -> float:
    """Kernel vs plain on one input; returns max |acc/l| error."""
    import torch

    from brpc_tpu_torch.ops import flash_attention as fa

    m, l, acc = carry
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
    log(f"K3 {label}: q {tuple(q.shape)} kv {tuple(k.shape)} {q.dtype} "
        f"offsets {offsets} causal={causal}: max err m {err_m:.3g} "
        f"l(rel) {err_l:.3g} acc/l {err_o:.3g} out {err_out:.3g}")
    if (err_m > FLASH_TOL["m"] or err_l > FLASH_TOL["l"] or err_o > tol_o
            or err_out > tol_o):
        fail(f"K3 {label} disagrees with its plain version beyond "
             f"{FLASH_TOL}")
    return err_o


def _flash_timing(q, k, v, causal, rate, flops_rate) -> dict:
    """kernel / plain / SDPA ms at a fresh-carry full pass, and the bound:
    4*d FLOP per (query, legal key) pair (q.k and p.v) at the card's dense
    bf16 peak, or the bytes (q, k, v and the carries in; carries out)."""
    import torch
    import torch.nn.functional as F

    from brpc_tpu_torch.ops import flash_attention as fa

    b, h, s, d = q.shape
    m, l, acc = fa.flash_init(b, h, s, d, device=q.device)
    ms = cuda_ms(lambda: fa.flash_attention_carry(q, k, v, m, l, acc, (0, 0),
                                                  causal=causal),
                 reps=10, inner=3)
    tile = fa.kernel_tile_k(q, k, v, acc)
    plain = cuda_ms(lambda: fa.flash_carry_reference(
        q, k, v, m, l, acc, (0, 0), causal=causal, block_k=tile,
        ragged_tail=True),
        reps=3, inner=1, warm=1)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=k.shape[1] != h),
        reps=10, inner=3)
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4.0 * b * h * d * pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) + 2 * sum(
        t.numel() * 4 for t in (m, l, acc))
    t_ops, t_bytes = flops / flops_rate * 1e3, nbytes / rate * 1e3
    return {"ms": ms, "plain_ms": plain, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib, "flop": flops, "bytes": nbytes,
            "tflops": flops / ms / 1e9}


def flash_vs_plain(seed: int, rate: float, flops_rate: float) -> dict:
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
    # fp32 on the SIMT path: first exactly the two calls dryrun_multichip(1)
    # makes (the single-head ring, non-causal, and the GQA causal ring; sq
    # and sk both under one tile, so keys past sk are masked with causal
    # off), then wider ones.
    for label, shape, causal in (
            ("dryrun single-head ring", (2, 1, 1, 4, 8), False),
            ("dryrun GQA causal ring", (2, 4, 2, 8, 8), True),
            ("f32 d=8 s=64", (2, 4, 2, 64, 8), True),
            ("f32 d=64 s=256", (2, 4, 4, 256, 64), False)):
        b, h, hkv, s, d = shape
        q, k, v = _qkv(b, h, hkv, s, d, f32, seed + 1)
        errs.append(_flash_case(label, q, k, v,
                                fa.flash_init(b, h, s, d, device="cuda"),
                                (0, 0), causal))
    # One ring hop of the Llama layer over 4 shards: rank 1 folds its own
    # (diagonal) block into a carry that already holds rank 0's block —
    # every q tile meets fully masked k tiles past the diagonal.
    c = LLAMA3_8B_ATTN
    sq = c["s"] // RING_SHARDS
    q, k, v = _qkv(c["b"], c["h"], c["hkv"], sq, c["d"], bf16, seed + 2)
    k0, v0 = _qkv(c["b"], c["hkv"], c["hkv"], sq, c["d"], bf16, seed + 3)[1:]
    carry = fa.flash_carry_reference(
        q, k0, v0, *fa.flash_init(c["b"], c["h"], sq, c["d"], device="cuda"),
        (sq, 0), causal=True, block_k=64)
    errs.append(_flash_case("ring hop, diagonal", q, k, v, carry, (sq, sq),
                            True))
    # A hop wholly after the queries: nothing folds, the carry comes back.
    got = fa.flash_attention_carry(q, k, v, *carry, (sq, 2 * sq),
                                   causal=True)
    if not all(torch.equal(a, b) for a, b in zip(got, carry)):
        fail("K3: a fully masked hop changed the carry")
    log("K3 fully masked hop: carry unchanged (bit for bit)")
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
    main, second = timing["Llama 3 8B layer"], timing["bench.py flash point"]
    for label, t in timing.items():
        log(f"K3 {label}: kernel_ms={t['ms']:.4f} plain_ms="
            f"{t['plain_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
            f"({t['bound_by']}) library_ms(SDPA)={t['library_ms']:.4f}; "
            f"{t['tflops']:.1f} TFLOP/s")
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
                                 "library_ms")}}}


def _flash_build_report() -> str:
    """Registers and spills ptxas reported for each K3 kernel, and the
    dynamic shared memory a launch of the tensor-core kernel asks for."""
    import ctypes
    import re

    from brpc_tpu_torch.ops import _build

    log_text = str(_build.last_build.get("log", ""))
    found, kernel = [], None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S*flash_(ws|simt)_kernel"
                      r"I(Li(\d+)E|f|13__nv_bfloat16)\S*)'", ln)
        if m:
            kernel = (f"flash_ws_kernel<{m.group(4)}>" if m.group(2) == "ws"
                      else "flash_simt_kernel<"
                      + ("float" if m.group(3) == "f" else "bf16") + ">")
        elif kernel and "spill" in ln:
            found.append(f"{kernel}: {ln.strip()}")
        elif kernel and "registers" in ln:
            found[-1] += "; " + ln.strip().replace("ptxas info    : ", "")
            kernel = None
    fn = _build.kernel("brpc_flash_ws_smem", [ctypes.c_int])
    smem = {d: int(fn(d)) for d in (64, 128)}
    if not found:  # a cached library: this process did not build it
        found = ["ptxas report: not in this process (library cached)"]
    return ("; ".join(found) + f"; dynamic shared memory a block: d=64 "
            f"{smem[64]} B, d=128 {smem[128]} B (setmaxnreg: producer 24, "
            "consumers 240 registers)")


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
        want = {"brpc_fused_momentum": PUSHES * len(names),
                "brpc_dequant_int8": (PUSHES + 1) * n_elig,
                "brpc_dequant_fp8e4m3": n_elig, "brpc_flash_carry": 0}
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
    from brpc_tpu_torch.ops import quantize as qz

    return {"brpc_fused_momentum": fu.LAUNCHES,
            "brpc_dequant_int8": qz.LAUNCHES_INT8,
            "brpc_dequant_fp8e4m3": qz.LAUNCHES_FP8,
            "brpc_flash_carry": fa.LAUNCHES}


def _drive(label: str, fn, want: dict) -> dict:
    """Run one path with every launch count set to 0 just before it; fail
    unless the counts read just after are ``want`` (names not in ``want``
    must stay 0)."""
    import torch

    counters = _counts()
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    got = {name: c.value for name, c in counters.items()}
    expect = {name: want.get(name, 0) for name in counters}
    log(f"{label}: {dt:.3f} s; launches {got}")
    if got != expect:
        fail(f"{label}: launch counts {got} != expected {expect}")
    return {name: n for name, n in got.items() if n}


def tensor_service_paths(seed: int) -> dict:
    """train_step, the ring replay and dryrun_multichip(1); returns each
    path's launch counts."""
    import torch

    from brpc_tpu_torch.models import tensor_service as ts
    from brpc_tpu_torch.ops import flash_attention as fa
    from brpc_tpu_torch.ops.ring_attention import hop_offsets

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

    launches["train_step"] = _drive(
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
    outs = []

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
        folds[1].record()

    launches["ring_replay"] = _drive(
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
    del q, k, v, outs, ring_out, one_shot, m, l, acc

    # -- the dryrun entry point on a one-rank NCCL group
    launches["dryrun_multichip(1)"] = _drive(
        "dryrun_multichip(1), one-rank NCCL group",
        lambda: ts.dryrun_multichip(1), {"brpc_flash_carry": 2})
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
        want = {"brpc_fused_momentum": 2 * len(names),
                "brpc_dequant_int8": 4 * len(elig) + n_oneside,
                "brpc_dequant_fp8e4m3": 0, "brpc_flash_carry": 0}
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


def _wait_for(cond, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            fail(f"timed out after {timeout_s} s: {what}")
        time.sleep(0.01)


# ---------------------------------------------------------------- main

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
                               published_rate(name, _BF16_RATE)))
    log(f"== phase 2 (kernels vs plain) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    by_path = {"param_server": main_path(args.seed)}
    log(f"== phase 3 (parameter-server path) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    by_path.update(tensor_service_paths(args.seed))
    log(f"== phase 4 (TensorService paths) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    by_path["fleet"] = fleet_path(args.seed, smi)
    log(f"== phase 5 (parameter-server fleet) {time.monotonic() - t0:.1f} s")
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()
                                 if c.get(r["name"])}
        r["launches"] = sum(r["launches_by_path"].values())
        if not r["launches"]:
            fail(f"{r['name']} was launched on no path")
    log(f"== all phases {time.monotonic() - t_all:.1f} s")
    log(smi)
    print(json.dumps({"kernels": rows, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
