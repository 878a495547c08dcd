"""Traffic ``train_blocks``: one trainer drives the port's
``OverlappedStepDriver`` over an ``MLAMoEStack`` (the MLA + MoE block
stack of a ``deepseek_v3`` configuration, this card's share of its
experts and vocabulary) against a ``ParameterServer`` in a process of its
own, closed loop, steps back to back.

Set-up builds the server, the client and the driver once and drives the
driver's first steps (``check_steps``) on distinct batches, recording the
experts each token chose in every MoE layer; the server's momenta after
the first step and its parameters after the last are read for the check.
The window then drives the same driver on and on, cycling through the
run's batches. With ``--trace 1`` the traced stretch (``trace_steps``,
both processes) is followed by one more step profiled in the trainer's
process alone, whose kernels are attributed to the program's stages
(``harness/stage_kernels.py``). The reference follows the check steps
alone, dispatching with the recorded routes; the routes themselves are
judged by ``route_flips``.

Inputs from the seed: weights normal(0, ``initializer_range``) in one
draw (norms 1), the fixed correction bias normal(0,
``correction_bias_std``), and ``batches`` batches of ``batch`` sequences
of ``seq_len + 1`` ids uniform over the vocabulary slice (inputs the
first ``seq_len``, targets the last).

Mix keys: ``oneside``, ``overlap``, ``window``,
``server_arena_published`` (the server's arena in units of the whole
parameter set), ``server_arena_largest`` and ``client_arena_largest``
(in units of the largest tensor), ``arena_extra_bytes``,
``batches``, ``check_steps``, ``warm_steps``, ``trace_steps``,
``switch_interval_s``, ``route_tie_width`` and ``limits``.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from harness import (checks, gen, mla_moe_flops, profiling, reference_mla_moe,
                     stage_kernels, wire_counters)
from harness.train_steps import _step

STAGES = ("mla_attn", "moe_route", "moe_experts")
# The native arena's largest size (native/ttpu/tensor_arena.cpp: 4 GiB
# less its 64-byte alignment).
ARENA_MAX = (1 << 32) - 64


def arch(model: dict) -> tuple:
    """The model block -> (the ``deepseek_v3`` keys ``MLAMoEStack`` and
    the reference read, the experts held as ``(first, count)``)."""
    cfg = dict(model, n_routed_experts=model["router_experts"])
    return cfg, tuple(model["experts_held"])


def weights(seed: int, cfg: dict, held: tuple, std: float, device) -> dict:
    shapes = reference_mla_moe.shapes(cfg, held)
    mats = {k: s for k, s in shapes.items() if len(s) > 1}
    flat = torch.randn(sum(math.prod(s) for s in mats.values()),
                       generator=gen.generator(device, seed, "mla_moe"),
                       device=device)
    flat.mul_(std)
    out, off = {}, 0
    for k, s in shapes.items():
        if len(s) == 1:
            out[k] = torch.ones(s, device=device)
        else:
            n = math.prod(s)
            out[k] = flat[off:off + n].view(s)
            off += n
    return out


def correction_bias(seed: int, cfg: dict, std: float, device):
    n = len(reference_mla_moe.moe_layers(cfg))
    return std * torch.randn(n, cfg["n_routed_experts"], device=device,
                             generator=gen.generator(device, seed, "bias"))


def batches(seed: int, count: int, rows: int, seq: int, vocab: int,
            device) -> list:
    ids = torch.randint(0, vocab, (count, rows, seq + 1), device=device,
                        generator=gen.generator(device, seed, "ids"))
    return [(ids[i, :, :-1], ids[i, :, 1:]) for i in range(count)]


def arena_bytes(mix: dict, shapes: dict) -> tuple:
    """(server, client) arena bytes: the server publishes every tensor
    one-sided, a new version in a fresh range before the old one is
    freed, and stages RPC replies; the client stages the window's
    pushes. The server's is capped at the native arena's largest."""
    sizes = [4 * math.prod(s) for s in shapes.values()]
    extra = mix["arena_extra_bytes"]
    return (min(mix["server_arena_published"] * sum(sizes)
                + mix["server_arena_largest"] * max(sizes) + extra,
                ARENA_MAX),
            mix["client_arena_largest"] * max(sizes) + extra)


def build_first() -> None:
    """Build the native library and the CUDA kernels in this process,
    under their build locks, before the server process starts. In a
    fresh checkout the server process would otherwise build the library
    before it reports its port (against ``ServerProcess``'s start
    timeout, with 2.27 GB to load besides) and the kernels at its first
    update (against the channel's deadline of the first push)."""
    from brpc_tpu_torch.ops import _build
    from brpc_tpu_torch.runtime import native

    native.lib()
    _build.load()


def _route_us():
    """The trainer's ``torch_stage_moe_route_us`` on /vars (None without
    it)."""
    return wire_counters.read_vars().get("torch_stage_moe_route_us")


def run(ctx) -> dict:
    from brpc_tpu_torch.models.mla_moe import MLAMoEStack
    from brpc_tpu_torch.parallel.ps_process import ServerProcess
    from brpc_tpu_torch.runtime.param_server import ParameterClient
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver
    from brpc_tpu_torch.runtime.tensor import TensorArena

    model, mix, dev, seed = ctx.model, ctx.mix, ctx.device, ctx.seed
    cfg, held = arch(model)
    rows, seq = model["batch"], model["seq_len"]
    lr, beta = ctx.optimizer["lr"], ctx.optimizer["momentum"]
    n_check = mix["check_steps"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(mix["switch_interval_s"])

    w0 = weights(seed, cfg, held, model["initializer_range"], dev)
    names = list(w0)
    bias = correction_bias(seed, cfg, model["correction_bias_std"], dev)
    data = batches(seed, mix["batches"], rows, seq, cfg["vocab_size"], dev)
    harness = MLAMoEStack(cfg, experts_held=held, correction_bias=bias,
                          device=dev)
    if harness.names != names:
        raise RuntimeError(f"MLAMoEStack names {harness.names[:2]}... are "
                           f"not the benchmark's {names[:2]}...")
    srv_bytes, cl_bytes = arena_bytes(mix, reference_mla_moe.shapes(cfg,
                                                                     held))
    if ctx.cuda:
        build_first()
    srv = cl = driver = None
    out = {"kind": "train"}
    try:
        srv = ServerProcess(w0, lr=lr, momentum=beta, device=dev,
                            arena_bytes=srv_bytes, oneside=mix["oneside"],
                            timeout_s=ctx.process_timeout_s)
        cl = ParameterClient(srv.addr, arena=TensorArena(cl_bytes),
                             device=dev, oneside=mix["oneside"])
        cl.meta()
        driver = OverlappedStepDriver(cl, harness, overlap=mix["overlap"],
                                      window=mix["window"])
        driver.prime()

        # The check steps and their routes, then the server's momenta
        # after the first (its gradients) and its parameters after the
        # last, by a one-sided pull of a client of the check's own (a
        # raw pull's replies need contiguous room in the server's arena,
        # which the published set fragments). The reads are the check's,
        # not set-up's.
        losses, routes = [], []
        for i in range(n_check):
            losses.append(_step(ctx, driver, data[i % len(data)])[0])
            routes.append(dict(zip(harness.moe_layers,
                                   harness.last_routes)))
            t = time.monotonic()
            if i == 0:
                st = srv.state()
                out["m1_norms"] = {k: checks.norm(st.momenta[k].to(dev))
                                   for k in names}
                del st
            if i == n_check - 1:
                probe = ParameterClient(srv.addr, arena=TensorArena(cl_bytes),
                                        device=dev, oneside=True)
                try:
                    got = probe.pull_all(names)
                finally:
                    probe.close()
                out["change_norms"] = {k: checks.norm(got[k][1] - w0[k])
                                       for k in names}
                out["versions"] = {k: v for k, (v, _t) in got.items()}
                del got
            ctx.exclude_from_setup(time.monotonic() - t)
        out["losses"], out["routes"] = losses, routes
        del w0
        gc.collect()
        i = n_check
        for _ in range(mix["warm_steps"]):
            _step(ctx, driver, data[i % len(data)])
            i += 1

        walls, stats = [], []
        edge = _route_us()
        t_open = ctx.open_window()
        deadline = t_open + ctx.seconds
        while True:
            _, t0, t1 = _step(ctx, driver, data[i % len(data)])
            i += 1
            walls.append(t1 - t0)
            stats.append(dict(driver.last_stats))
            if t1 >= deadline:
                break
        out.update(window_s=t1 - t_open, step_walls=walls, step_stats=stats,
                   attempted=len(walls), failed=0,
                   moe_route_us=(edge, _route_us()))
        if ctx.trace:
            def steps(n):
                def body():
                    nonlocal i
                    for _ in range(n):
                        _step(ctx, driver, data[i % len(data)])
                        i += 1
                return body

            out["traced"] = profiling.profiled(ctx, steps(mix["trace_steps"]),
                                               server=srv)
            if ctx.cuda:
                out["stage_kernel_s"] = stage_kernels.profiled_stages(
                    ctx, steps(1), STAGES)
        ctx.close_window()
    finally:
        sys.setswitchinterval(switch)
        if cl is not None:
            cl.close()
        if srv is not None:
            srv.close()
        cl = srv = driver = harness = data = None
        gc.collect()
        if ctx.cuda:
            torch.cuda.empty_cache()
    out["flops_per_step"] = mla_moe_flops.step_flops(cfg, held, rows, seq)
    out["verify"] = lambda variant=None: verify(ctx, out, variant)
    return out


def verify(ctx, out: dict, variant=None) -> dict:
    """The readings: the program's (``variant`` None) or, in the
    program's place, the reference computed with TF32 matmuls
    (``"tf32"``, the control) or over the first half of each batch's
    sequences (``"half_batch"``, a planted fault), each against the fp32
    reference of the check steps. Every reference dispatches with the
    program's recorded routes; ``route_flips`` holds the choice that
    stands in for the program's (its routes, or the variant's own) to the
    fp32 reference's own choice outside near ties."""
    model, mix, dev, seed = ctx.model, ctx.mix, ctx.device, ctx.seed
    cfg, held = arch(model)
    lr, beta = ctx.optimizer["lr"], ctx.optimizer["momentum"]
    n_check = mix["check_steps"]
    w = weights(seed, cfg, held, model["initializer_range"], dev)
    bias = correction_bias(seed, cfg, model["correction_bias_std"], dev)
    data = batches(seed, mix["batches"], model["batch"], model["seq_len"],
                   cfg["vocab_size"], dev)
    feed = [data[i % len(data)] for i in range(n_check)]

    def train(**kw):
        r = reference_mla_moe.train(w, bias, feed, lr, beta, cfg, held,
                                    out["routes"], **kw)
        r["norms"] = ({k: checks.norm(v) for k, v in r["m1"].items()},
                      {k: checks.norm(r["params"][k] - w[k]) for k in w})
        del r["m1"], r["params"], r["m"]
        return r

    ref = train()
    ref_g, ref_dp = ref["norms"]
    if variant is None:
        got_g, got_dp, got_loss = (out["m1_norms"], out["change_norms"],
                                   out["losses"])
        chose = out["routes"]
    else:
        if variant == "tf32":
            v = train(tf32=True)
        elif variant == "half_batch":
            v = train(rows=model["batch"] // 2)
        else:
            raise ValueError(f"unknown variant {variant!r}")
        (got_g, got_dp), got_loss = v["norms"], v["losses"]
        chose = [{i: idx for i, (idx, _m) in own.items()} for own in v["own"]]
    faults = (sum(1 for n in out["versions"].values() if n != n_check)
              if variant is None else 0)
    return {"loss_gap": checks.loss_gap(got_loss, ref["losses"]),
            "grad_gap": checks.norm_gap(got_g, ref_g),
            "version_faults": faults,
            "change_gap": checks.norm_gap(
                got_dp, ref_dp, keep=checks.moved_leaves(ref_g)),
            "route_flips": reference_mla_moe.route_flips(
                chose, ref["own"], mix["route_tie_width"])}
