"""regime-graph-torch negative: the update on the compute lane, waits
and host copies on the wire lane."""

import torch

from brpc_tpu_torch.ops.fused_update import fused_momentum_update
from brpc_tpu_torch.runtime.step_sched import COMPUTE, WIRE, StepGraph


def build(client, params, momenta, grads):
    graph = StepGraph()

    def make_push(name):
        def fn(done):
            host = grads[name].cpu().numpy()
            client.push_grad(name, torch.from_numpy(host))
        return fn

    def make_opt(name):
        def fn(done):
            params[name], momenta[name] = fused_momentum_update(
                params[name], momenta[name], grads[name])
        return fn

    for name in params:
        graph.add(f"push:{name}", make_push(name), lane=WIRE)
        graph.add(f"opt:{name}", make_opt(name), deps=(f"push:{name}",),
                  lane=COMPUTE)
    return graph
