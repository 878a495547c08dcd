"""Planted faults come out as not correct. Each test skips the look for a
card (a CPU rehearsal at the configuration's tiny sizes), drives the rest
of a run with the timed path broken underneath, and reads ``correct``.
The faults a one-card cell can have: a step or push that leaves the state
unchanged, half of the batch left out (the mean taken over the rest), and
an answer altered where it is produced."""

import pytest
import torch
from conftest import INT8, bench_with

from harness import cell

SEED = 2**33 + 17


def run(workload):
    ctx = cell.Ctx(workload, SEED, 1.0, False, rehearse=True,
                   bench=bench_with(INT8))
    return cell.run(ctx)


def zero_grads(monkeypatch):
    from brpc_tpu_torch.models.tensor_service import LayeredMLP

    orig = LayeredMLP.backward

    def backward(self, ctx, name):
        return torch.zeros_like(orig(self, ctx, name))

    monkeypatch.setattr(LayeredMLP, "backward", backward)


def half_batch(monkeypatch):
    from brpc_tpu_torch.models.tensor_service import LayeredMLP

    orig = LayeredMLP.forward

    def forward(self, params, x, y):
        n = x.shape[0] // 2
        return orig(self, params, x[:n], y[:n])

    monkeypatch.setattr(LayeredMLP, "forward", forward)


def zero_pushes(monkeypatch):
    from brpc_tpu_torch.runtime.param_server import ParameterClient

    orig = ParameterClient.push_all

    def push_all(self, grads, **kw):
        return orig(self, {k: torch.zeros_like(g) for k, g in grads.items()},
                    **kw)

    monkeypatch.setattr(ParameterClient, "push_all", push_all)


def altered_pulls(monkeypatch):
    from brpc_tpu_torch.runtime.param_server import ParameterClient

    orig = ParameterClient.pull_all

    def pull_all(self, *a, **kw):
        out = orig(self, *a, **kw)
        name = sorted(out)[0]
        v, t = out[name]
        t = t.clone()
        t.view(-1)[0] += 1e-3
        out[name] = (v, t)
        return out

    monkeypatch.setattr(ParameterClient, "pull_all", pull_all)


@pytest.mark.parametrize("workload", ["mlp.ps-overlap", "mlp.colocated"])
@pytest.mark.parametrize("plant", [zero_grads, half_batch])
def test_training_faults_are_not_correct(workload, plant, monkeypatch):
    plant(monkeypatch)
    res = run(workload)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", ["ps.int8-rounds", "ps.raw-rounds"])
@pytest.mark.parametrize("plant", [zero_pushes, altered_pulls])
def test_parameter_server_faults_are_not_correct(workload, plant,
                                                 monkeypatch):
    plant(monkeypatch)
    res = run(workload)
    assert res["correct"] is False, res["checks"]


def test_a_sound_rehearsal_is_correct():
    res = run("ps.raw-rounds")
    assert res["correct"] is True, res["checks"]
