"""Traffic ``train_steps``: one trainer drives the port's
``OverlappedStepDriver`` over a ``LayeredMLP`` against a
``ParameterServer``, closed loop, steps back to back.

Set-up builds the server, the client and the driver once, and drives the
driver's first steps (``check_steps``) through ``driver.step`` on
distinct batches; the server's state after the first step and after the
last of them is read for the check. The window then drives the same
driver on and on, cycling through the run's batches. The reference
follows the check steps alone.

Mix keys: ``server`` (``own_process``: a ``ServerProcess`` with
one-sided pulls; ``same_process``: in the trainer's process, RPC pulls),
``oneside``, ``overlap``, ``window``, ``server_arena_bytes``,
``client_arena_bytes``, ``batches``, ``check_steps``, ``warm_steps``,
``trace_steps``, ``switch_interval_s`` and ``limits``.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from harness import checks, gen, profiling, reference, roofline


def _step(ctx, driver, batch) -> tuple:
    ctx.sync()
    t = time.monotonic()
    loss = driver.step(*batch)
    ctx.sync()
    return loss, t, time.monotonic()


def run(ctx) -> dict:
    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.parallel.ps_process import ServerProcess
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver
    from brpc_tpu_torch.runtime.tensor import TensorArena

    model, mix, dev, seed = ctx.model, ctx.mix, ctx.device, ctx.seed
    sizes, rows = model["sizes"], model["batch"]
    lr, beta = ctx.optimizer["lr"], ctx.optimizer["momentum"]
    n_check = mix["check_steps"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(mix["switch_interval_s"])

    weights = gen.mlp_weights(seed, sizes, dev)
    names = list(weights)
    data = gen.batches(seed, mix["batches"], rows, sizes[0], sizes[-1], dev)
    harness = LayeredMLP(sizes, device=dev)
    if list(harness.names) != names:
        raise RuntimeError(f"LayeredMLP names {harness.names[:2]}... are "
                           f"not the benchmark's {names[:2]}...")
    own = mix["server"] == "own_process"
    srv = cl = None
    out = {"kind": "train"}
    try:
        if own:
            srv = ServerProcess(weights, lr=lr, momentum=beta, device=dev,
                                arena_bytes=mix["server_arena_bytes"],
                                oneside=mix["oneside"],
                                timeout_s=ctx.process_timeout_s)
            addr = srv.addr
        else:
            srv = ParameterServer(weights, lr=lr, momentum=beta,
                                  arena=TensorArena(
                                      mix["server_arena_bytes"]),
                                  device=dev)
            addr = f"tpu://127.0.0.1:{srv.start()}"
        cl = ParameterClient(addr, arena=TensorArena(
            mix["client_arena_bytes"]), device=dev, oneside=mix["oneside"])
        cl.meta()
        driver = OverlappedStepDriver(cl, harness, overlap=mix["overlap"],
                                      window=mix["window"])
        driver.prime()

        # The check steps, then the server's state after the first (its
        # momenta are its gradients) and its parameters after the last,
        # read by a raw pull of a client of the check's own (shipping the
        # state again would write it to disk). The reads are the check's,
        # not set-up's.
        losses = []
        for i in range(n_check):
            losses.append(_step(ctx, driver, data[i % len(data)])[0])
            t = time.monotonic()
            if i == 0:
                st = srv.state()
                out["m1_norms"] = {k: checks.norm(st.momenta[k].to(dev))
                                   for k in names}
                del st
            if i == n_check - 1:
                probe = ParameterClient(addr, arena=TensorArena(
                    mix["client_arena_bytes"]), device=dev)
                try:
                    got = probe.pull_all(names)
                finally:
                    probe.close()
                out["change_norms"] = {k: checks.norm(got[k][1] - weights[k])
                                       for k in names}
                out["versions"] = {k: v for k, (v, _t) in got.items()}
                del got
            ctx.exclude_from_setup(time.monotonic() - t)
        out["losses"] = losses
        del weights
        i = n_check
        for _ in range(mix["warm_steps"]):
            _step(ctx, driver, data[i % len(data)])
            i += 1

        walls, stats = [], []
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
                   attempted=len(walls), failed=0)
        if ctx.trace:
            n = mix["trace_steps"]

            def body():
                nonlocal i
                for _ in range(n):
                    _step(ctx, driver, data[i % len(data)])
                    i += 1

            out["traced"] = profiling.profiled(
                ctx, body, server=srv if own else None)
            out["traced"]["k1_elements"] = n * sum(
                a * b for a, b in zip(sizes[:-1], sizes[1:]))
        ctx.close_window()
    finally:
        sys.setswitchinterval(switch)
        if cl is not None:
            cl.close()
        if srv is not None:
            if own:
                srv.close()
            else:
                srv.stop()
                srv.server.close()
        cl = srv = driver = harness = data = None
        gc.collect()
        if ctx.cuda:
            torch.cuda.empty_cache()
    out["flops_per_step"] = roofline.mlp_step_flops(sizes, rows)
    out["verify"] = lambda variant=None: verify(ctx, out, variant)
    return out


def verify(ctx, out: dict, variant=None) -> dict:
    """The readings: the program's (``variant`` None) or, in the
    program's place, the reference computed with TF32 matmuls
    (``"tf32"``, the control) or over the first half of each batch
    (``"half_batch"``, a planted fault), each against the fp32 reference
    of the check steps."""
    model, mix, dev, seed = ctx.model, ctx.mix, ctx.device, ctx.seed
    lr, beta = ctx.optimizer["lr"], ctx.optimizer["momentum"]
    n_check = mix["check_steps"]
    w = gen.mlp_weights(seed, model["sizes"], dev)
    data = gen.batches(seed, mix["batches"], model["batch"],
                       model["sizes"][0], model["sizes"][-1], dev)
    feed = [data[i % len(data)] for i in range(n_check)]

    def norms(r):
        return ({k: checks.norm(v) for k, v in r["m1"].items()},
                {k: checks.norm(r["params"][k] - w[k]) for k in w},
                r["losses"])

    ref_g, ref_dp, ref_loss = norms(reference.mlp_train(w, feed, lr, beta))
    if variant is None:
        got_g, got_dp, got_loss = (out["m1_norms"], out["change_norms"],
                                   out["losses"])
    elif variant == "tf32":
        got_g, got_dp, got_loss = norms(
            reference.mlp_train(w, feed, lr, beta, tf32=True))
    elif variant == "half_batch":
        got_g, got_dp, got_loss = norms(reference.mlp_train(
            w, feed, lr, beta, rows=model["batch"] // 2))
    else:
        raise ValueError(f"unknown variant {variant!r}")
    faults = (sum(1 for v in out["versions"].values() if v != n_check)
              if variant is None else 0)
    return {"loss_gap": checks.loss_gap(got_loss, ref_loss),
            "grad_gap": checks.norm_gap(got_g, ref_g),
            "version_faults": faults,
            "change_gap": checks.norm_gap(
                got_dp, ref_dp, keep=checks.moved_leaves(ref_g))}
