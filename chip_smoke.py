#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (brpc_tpu_torch).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card, the CUDA toolkit (nvcc) and a C++ compiler; builds
native/build/libbrpc_tpu.so (if missing) and the port's CUDA kernels from
the checkout. Phases, each fatal on failure:

  1. set-up: the card's name and power limit, both builds and their times;
  2. kernels vs plain PyTorch, on the card, at every distinct shape of the
     main path (GPT-2 small) plus a ragged and a 1-D one: bit-identical;
     times at the largest shape (``wte``) beside the bound and a library
     call where one computes the same function;
  3. the main path: a ParameterServer on the card holding the GPT-2 small
     parameter set (124,439,808 fp32 values, random from --seed) serves
     pulls and int8 pushes over tpu:// to clients in this process; the
     results are held against a plain-PyTorch replay on the card, and the
     kernels' launch counts show the path went through them.

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


def hbm_rate(name: str) -> float:
    for key, rate in _HBM_RATE:
        if key in name:
            return rate
    fail(f"no published memory rate for {name!r}")


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
            if not os.path.exists(native._LIB_PATH):
                native.build_native()
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
    log(f"native library ready in {out['native_build_s']:.1f} s "
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
        for c in (fu.LAUNCHES, qz.LAUNCHES_INT8, qz.LAUNCHES_FP8):
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
        launches = {"brpc_fused_momentum": fu.LAUNCHES.value,
                    "brpc_dequant_int8": qz.LAUNCHES_INT8.value,
                    "brpc_dequant_fp8e4m3": qz.LAUNCHES_FP8.value}

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
                "brpc_dequant_fp8e4m3": n_elig}
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
    rate = hbm_rate(name)
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; bound uses "
        f"{rate / 1e12:.2f} TB/s device memory")
    t0 = time.monotonic()
    setup()
    log(f"== phase 1 (set-up) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    rows = kernels_vs_plain(args.seed, rate)
    log(f"== phase 2 (kernels vs plain) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    launches = main_path(args.seed)
    log(f"== phase 3 (main path) {time.monotonic() - t0:.1f} s")
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({
        "kernels": rows,
        "not_ported": [{"name": "_carry_kernel",
                        "replaces": "brpc_tpu/ops/flash_attention.py:47",
                        "ported": False}],
        "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
