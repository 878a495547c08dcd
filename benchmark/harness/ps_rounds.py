"""Traffic ``ps_rounds``: ``clients`` trainers, each a thread of the run
with a ``ParameterClient`` and an arena of its own, against one
``ParameterServer`` in a ``ServerProcess``. Each repeats, closed loop,
``pull_all`` and then ``push_all`` of a gradient set made on the card from
(seed, client, round).

Set-up starts the server and the clients, and every client runs its round
0. The window's rounds follow until the deadline; a round under way then
runs to its end, and its call under way at the deadline counts for the
part of it that lies inside the window. Each client keeps
its last pull and one more drawn from the seed among its rounds; they
and the server's final parameters are checked once the window has closed,
against the reference replaying every push in the order of the versions
the server returned.

Mix keys: ``clients``, ``codec`` (``int8`` or null for raw), ``window``,
``group``, ``grad_scale``, ``server_arena_largest`` /
``client_arena_largest`` (arena sizes in multiples of the largest tensor)
plus ``arena_extra_bytes``, and ``limits``.
"""

from __future__ import annotations

import gc
import math
import os
import random
import threading
import time

import torch

from harness import checks, gen, profiling, reference


def _calls(ctx, cl, c: int, r: int, names, shapes, mix) -> tuple:
    """One round of client ``c``: -> (pulled, versions, (start, end) of
    the pull_all, (start, end) of the push_all)."""
    with torch.profiler.record_function("client/pull_all"):
        t = time.monotonic()
        pulled = cl.pull_all(window=mix["window"], group=mix["group"])
        ctx.sync_stream()
        pull = (t, time.monotonic())
    with torch.profiler.record_function("client/grads"):
        grads = {n: gen.grad(ctx.seed, c, r, i, shapes[n], mix["grad_scale"],
                             ctx.device) for i, n in enumerate(names)}
    with torch.profiler.record_function("client/push_all"):
        t = time.monotonic()
        versions = cl.push_all(grads, window=mix["window"],
                               group=mix["group"])
        push = (t, time.monotonic())
    return pulled, versions, pull, push


def credited(calls, lo: float, hi: float) -> float:
    """The share of the calls' ``(start, end)`` spans that lies inside
    ``[lo, hi]``, summed: a call under way at the window's close counts
    for the part of it the window holds."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) / (b - a)
               for a, b in calls if b > a)


def run(ctx) -> dict:
    from brpc_tpu_torch.parallel.ps_process import ServerProcess
    from brpc_tpu_torch.runtime.param_server import ParameterClient
    from brpc_tpu_torch.runtime.tensor import TensorArena

    model, mix, dev, seed = ctx.model, ctx.mix, ctx.device, ctx.seed
    shapes = gen.gpt2_shapes(model["n_layer"], model["n_embd"],
                             model["n_ctx"], model["vocab_size"])
    names = list(shapes)
    n_cl = mix["clients"]
    largest = 4 * max(math.prod(s) for s in shapes.values())
    extra = mix["arena_extra_bytes"]
    srv_arena = mix["server_arena_largest"] * largest + extra
    cli_arena = mix["client_arena_largest"] * largest + extra
    st = os.statvfs("/dev/shm")
    need = srv_arena + n_cl * cli_arena + extra
    if st.f_bavail * st.f_frsize < need:
        raise RuntimeError(f"/dev/shm has {st.f_bavail * st.f_frsize} "
                           f"bytes free, the arenas need {need}")
    total = 4 * sum(math.prod(s) for s in shapes.values())
    elig = sum(math.prod(s) for s in shapes.values()
               if mix["codec"] and reference.eligible(s))

    params = gen.param_set(seed, shapes, model["initializer_range"], dev)
    srv = ServerProcess(params, lr=ctx.optimizer["lr"],
                        momentum=ctx.optimizer["momentum"], device=dev,
                        arena_bytes=srv_arena, oneside=False,
                        timeout_s=ctx.process_timeout_s)
    del params
    clients = []
    out = {"kind": "ps"}
    # Per client: its rounds' versions, its kept pulls, its calls' times.
    rounds = [dict() for _ in range(n_cl)]
    kept = [dict() for _ in range(n_cl)]
    pick = [random.Random(gen.subseed(seed, "sample", c)) for c in range(n_cl)]
    times = {"pull_all": [], "push_all": []}
    mu = threading.Lock()

    def do_round(c: int, r: int, timed: bool) -> None:
        pulled, versions, pull, push = _calls(
            ctx, clients[c], c, r, names, shapes, mix)
        rounds[c][r] = versions
        # Keep the last pull, and one more drawn from the client's rounds
        # (a reservoir of one).
        if pick[c].random() * len(rounds[c]) < 1.0:
            kept[c]["drawn"] = (r, pulled)
        kept[c]["last"] = (r, pulled)
        if timed:
            with mu:
                times["pull_all"].append(pull)
                times["push_all"].append(push)

    def threads(fn) -> None:
        errs = []

        def body(c):
            try:
                fn(c)
            except BaseException as e:  # noqa: BLE001 — raised below
                errs.append(e)

        ts = [threading.Thread(target=body, args=(c,)) for c in range(n_cl)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            raise errs[0]

    try:
        for _ in range(n_cl):
            clients.append(ParameterClient(
                srv.addr, arena=TensorArena(cli_arena), codec=mix["codec"],
                device=dev))
            clients[-1].meta()
        threads(lambda c: do_round(c, 0, False))

        nxt = [1] * n_cl
        t_open = ctx.open_window()
        deadline = t_open + ctx.seconds

        def loop(c):
            while time.monotonic() < deadline:
                do_round(c, nxt[c], True)
                nxt[c] += 1

        threads(loop)
        calls = times["pull_all"] + times["push_all"]
        out.update(window_s=ctx.seconds, call_times={
            k: [b - a for a, b in v] for k, v in times.items()},
            bytes=total * credited(calls, t_open, deadline),
            attempted=len(calls), failed=0)
        if ctx.trace:
            def body():
                threads(lambda c: do_round(c, nxt[c], False))

            out["traced"] = profiling.profiled(ctx, body, server=srv)
            out["traced"]["k1_elements"] = n_cl * total // 4
            # K2 widens every int8 code twice: the server the pushed
            # gradient's, the client the pulled tensor's.
            out["traced"]["k2_codes"] = 2 * n_cl * elig
        ctx.close_window()
        # The server's final parameters, read by a raw pull of their
        # committed versions (shipping its state would write it to disk).
        clients.append(ParameterClient(srv.addr, arena=TensorArena(
            cli_arena), device=dev))
        final = clients[-1].pull_all(window=mix["window"])
    finally:
        for cl in clients:
            cl.close()
        srv.close()
        gc.collect()
        if ctx.cuda:
            torch.cuda.empty_cache()
    out["pulls"] = [dict(k) for k in kept]
    out["rounds"] = rounds
    out["final"] = final
    out["verify"] = lambda variant=None: verify(ctx, out, shapes, variant)
    return out


def verify(ctx, out: dict, shapes: dict, variant=None) -> dict:
    """The readings: every tensor's trajectory replayed from the seed in
    the order of the versions the server returned, against the server's
    final parameters and against the kept pulls; with
    ``variant="bf16"`` (the control), a trajectory computed in bfloat16
    stands in the program's place."""
    model, mix, dev, seed = ctx.model, ctx.mix, ctx.device, ctx.seed
    lr, beta = ctx.optimizer["lr"], ctx.optimizer["momentum"]
    if variant not in (None, "bf16"):
        raise ValueError(f"unknown variant {variant!r}")
    p0 = gen.param_set(seed, shapes, model["initializer_range"], dev)
    rounds, final = out["rounds"], out["final"]
    pulls = [(c, r, pulled) for c, kept in enumerate(out["pulls"])
             for r, pulled in {r: p for r, p in kept.values()}.items()]
    faults, state_gap, pull_gap = 0, 0.0, 0.0
    for i, name in enumerate(shapes):
        shape = shapes[name]
        by_version = {}
        for c, rs in enumerate(rounds):
            for r, versions in rs.items():
                by_version.setdefault(versions[name], []).append((c, r))
        order = [by_version.get(v, [None])[0]
                 for v in range(1, len(by_version) + 1)]
        if (sorted(by_version) != list(range(1, len(by_version) + 1))
                or any(len(x) != 1 for x in by_version.values())
                or final[name][0] != len(order)):
            faults += 1
            continue
        int8 = mix["codec"] == "int8" and reference.eligible(shape)

        def raw(cr, i=i, shape=shape):
            return gen.grad(seed, cr[0], cr[1], i, shape, mix["grad_scale"],
                            dev)

        if int8:
            sent = {}
            for c, rs in enumerate(rounds):
                ef = reference.ErrorFeedback()
                for r in sorted(rs):
                    sent[(c, r)] = ef.push(raw((c, r)))
            pushes = [lambda cr=cr, shape=shape: reference.int8_widen(
                *sent[cr], shape) for cr in order]
        else:
            pushes = [lambda cr=cr: raw(cr) for cr in order]
        seen = {pulled[name][0] for _c, _r, pulled in pulls}
        view = reference.int8_roundtrip if int8 else None
        p, _m, views = reference.ps_tensor(p0[name], pushes, lr, beta,
                                           seen=seen, pull_view=view)
        if variant is None:
            got_p = final[name][1]
            got_views = {(c, r): pulled[name][1] for c, r, pulled in pulls}
        else:
            got_p, _m, low = reference.ps_tensor(
                p0[name], pushes, lr, beta, dtype=torch.bfloat16, seen=seen,
                pull_view=view)
            got_views = {(c, r): low[pulled[name][0]]
                         for c, r, pulled in pulls}
        state_gap = max(state_gap, checks.rel_max(got_p, p))
        for c, r, pulled in pulls:
            pull_gap = max(pull_gap, checks.rel_max(
                got_views[(c, r)], views[pulled[name][0]]))
    return {"version_faults": faults, "state_gap": state_gap,
            "pull_gap": pull_gap}
