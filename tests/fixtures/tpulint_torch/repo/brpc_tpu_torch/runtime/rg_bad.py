"""regime-graph-torch positive: device work in wire-lane nodes."""

import torch

from brpc_tpu_torch.ops.fused_update import fused_momentum_update
from brpc_tpu_torch.runtime.step_sched import COMPUTE, WIRE, StepGraph


def build(harness, params, momenta, grads, ctx):
    graph = StepGraph()

    def make_opt(name):
        def fn(done):
            params[name], momenta[name] = fused_momentum_update(
                params[name], momenta[name], grads[name])
        return fn

    def make_scale(name):
        def fn(done):
            grads[name] = torch.mul(grads[name], 0.5)
        return fn

    def make_bwd(name):
        def fn(done):
            grads[name] = harness.backward(ctx, name)
        return fn

    for name in params:
        graph.add(f"opt:{name}", make_opt(name), lane=WIRE)
        graph.add(f"scale:{name}", make_scale(name), lane="wire:s")
        graph.add(f"bwd:{name}", make_bwd(name), lane=f"wire:{name}")
    graph.add("fwd", lambda done: None, lane=COMPUTE)
    return graph


def build_looped(harness, params, ctx):
    """A wire node whose body a loop variable picks."""
    graph = StepGraph()

    def make_wait(name):
        def fn(done):
            return None
        return fn

    def make_grad(name):
        def fn(done):
            return harness.grads(params, *ctx)
        return fn

    for stage, make in (("wait", make_wait), ("grad", make_grad)):
        for name in params:
            graph.add(f"{stage}:{name}", make(name), lane=WIRE)
    return graph
