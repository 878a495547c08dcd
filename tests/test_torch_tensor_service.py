"""The port's TensorService against the JAX package's, on the CPU.

``train_step`` takes 3 steps from the same numpy state in both packages;
``LayeredMLP.grads`` runs on the same numpy parameters and data;
``flagship_entry`` and ``dryrun_multichip`` run as the driver would call
them.

Tolerances. ``train_step``: both packages multiply the same bf16-rounded
operands with fp32 sums (exact products, another summation order) and
round the weight gradients to bf16 and back; where the two orders put a
gradient on either side of a bf16 rounding boundary it moves by one bf16
step, 2^-8 relative, which the update scales by lr = 0.01. So the state is
held to 1e-6 absolute plus 1e-5 relative after 3 steps and the loss to
1e-5 relative. ``LayeredMLP``: fp32 throughout, 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brpc_tpu.models import tensor_service as jts
from brpc_tpu_torch.models import tensor_service as tts
from brpc_tpu_torch.ops import fused_update
from brpc_tpu_torch.runtime.state import (layered_params_from_numpy,
                                          psstate_from_numpy,
                                          psstate_to_numpy)

FIELDS = ("w1", "b1", "w2", "b2", "m_w1", "m_w2", "stats")
# (batch, din, dh, dout)
CONFIGS = {"small": (32, 64, 128, 32), "wide": (16, 48, 256, 24),
           "tall": (96, 32, 64, 16)}
STEPS = 3
_runs = {}


def _numpy_state(din, dh, dout, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w1": f32(din, dh) / np.float32(np.sqrt(din)),
            "b1": f32(dh) * np.float32(0.1),
            "w2": f32(dh, dout) / np.float32(np.sqrt(dh)),
            "b2": f32(dout) * np.float32(0.1),
            "m_w1": np.zeros((din, dh), np.float32),
            "m_w2": np.zeros((dh, dout), np.float32),
            "stats": np.zeros(dout, np.float32)}


def _three_steps(config):
    """(port states and losses, JAX states and losses), cached per config:
    each JAX shape is one jit compile."""
    if config not in _runs:
        batch, din, dh, dout = CONFIGS[config]
        seed = sum(CONFIGS[config])
        host = _numpy_state(din, dh, dout, seed)
        rng = np.random.default_rng(seed + 1)
        x = rng.standard_normal((batch, din)).astype(np.float32)
        t = rng.standard_normal((batch, dout)).astype(np.float32)
        state = psstate_from_numpy(host, device="cpu")
        tx, tt = torch.from_numpy(x), torch.from_numpy(t)
        jstate = jts.PSState(**{f: jnp.asarray(host[f]) for f in FIELDS})
        port, ref = [], []
        launches = fused_update.LAUNCHES.value
        for _ in range(STEPS):
            state, loss = tts.train_step(state, tx, tt)
            jstate, jloss = jts.train_step(jstate, jnp.asarray(x),
                                           jnp.asarray(t))
            port.append((psstate_to_numpy(state), float(loss)))
            ref.append(({f: np.asarray(getattr(jstate, f)) for f in FIELDS},
                        float(jloss)))
        # CPU tensors take the plain update: no kernel launched.
        assert fused_update.LAUNCHES.value == launches
        _runs[config] = (port, ref)
    return _runs[config]


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_train_step_state_matches_jax(config, field):
    port, ref = _three_steps(config)
    for step, ((got, _), (want, _)) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(got[field], want[field], atol=1e-6,
                                   rtol=1e-5, err_msg=f"step {step + 1}")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_train_step_loss_matches_jax_and_falls(config):
    port, ref = _three_steps(config)
    losses = [loss for _, loss in port]
    np.testing.assert_allclose(losses, [loss for _, loss in ref], rtol=1e-5)
    assert losses[-1] < losses[0], losses


def test_train_step_is_out_of_place():
    fn, (state, x, t) = tts.flagship_entry(batch=8, din=16, dh=32, dout=8,
                                           device="cpu")
    before = psstate_to_numpy(state)
    new, _ = fn(state, x, t)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(state, f).numpy(), before[f])
    assert not np.array_equal(new.w1.numpy(), before["w1"])


def test_flagship_entry_shapes_and_learning():
    fn, (state, x, t) = tts.flagship_entry(batch=32, din=64, dh=128,
                                           dout=32, device="cpu")
    assert fn is tts.train_step
    want = {"w1": (64, 128), "b1": (128,), "w2": (128, 32), "b2": (32,),
            "m_w1": (64, 128), "m_w2": (128, 32), "stats": (32,)}
    assert {f: tuple(getattr(state, f).shape) for f in FIELDS} == want
    assert tuple(x.shape) == (32, 64) and tuple(t.shape) == (32, 32)
    assert all(getattr(state, f).device.type == "cpu" for f in FIELDS)
    losses = []
    for _ in range(5):
        state, loss = fn(state, x, t)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert np.isfinite(psstate_to_numpy(state)["stats"]).all()


def test_flagship_entry_defaults_match_the_jax_entry():
    _fn, (state, x, t) = tts.flagship_entry(device="cpu")
    _jfn, (jstate, jx, jt) = jts.flagship_entry()
    for f in FIELDS:
        assert tuple(getattr(state, f).shape) == getattr(jstate, f).shape
    assert tuple(x.shape) == jx.shape and tuple(t.shape) == jt.shape


@pytest.mark.parametrize("sizes", [(16, 32, 8), (12, 24, 24, 6),
                                   (8, 16, 16, 16, 4)])
def test_layered_mlp_grads_match_jax(sizes):
    rng = np.random.default_rng(len(sizes))
    params = {f"layer{k:02d}": (rng.standard_normal((sizes[k], sizes[k + 1]))
                                / np.sqrt(sizes[k])).astype(np.float32)
              for k in range(len(sizes) - 1)}
    x = rng.standard_normal((10, sizes[0])).astype(np.float32)
    y = rng.standard_normal((10, sizes[-1])).astype(np.float32)
    model = tts.LayeredMLP(sizes, device="cpu")
    grads, loss = model.grads(layered_params_from_numpy(params, "cpu"),
                              torch.from_numpy(x), torch.from_numpy(y))
    jgrads, jloss = jts.LayeredMLP(sizes).grads(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(y))
    assert set(grads) == set(jgrads) == set(params)
    for k in params:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)


def test_layered_mlp_manual_backward_equals_autograd():
    model = tts.LayeredMLP((8, 12, 12, 4), seed=3, device="cpu")
    params = model.init_params()
    x, y = model.data(6, seed=4)
    grads, loss = model.grads(params, x, y)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    a = x
    for k, name in enumerate(model.names):
        z = a @ leaves[name]
        a = z if k == len(model.names) - 1 else torch.relu(z)
    auto_loss = torch.mean(torch.square(a - y))
    auto = torch.autograd.grad(auto_loss, list(leaves.values()))
    for name, g in zip(leaves, auto):
        torch.testing.assert_close(grads[name], g, atol=1e-6, rtol=1e-5)
    assert loss == pytest.approx(float(auto_loss.detach()), rel=1e-6)


def test_layered_mlp_data_and_params_from_numpy_seeds():
    model = tts.LayeredMLP((5, 7, 3), seed=9, device="cpu")
    p1, p2 = model.init_params(), model.init_params()
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert {k: tuple(v.shape) for k, v in p1.items()} == {
        "layer00": (5, 7), "layer01": (7, 3)}
    x, y = model.data(4, seed=2)
    rng = np.random.default_rng(2)
    np.testing.assert_array_equal(
        x.numpy(), rng.standard_normal((4, 5)).astype(np.float32))
    assert tuple(y.shape) == (4, 3)


def test_layered_mlp_refuses_a_mesh_and_bad_orders():
    with pytest.raises(TypeError, match="2-D DeviceMesh"):
        tts.LayeredMLP((4, 4), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="two sizes"):
        tts.LayeredMLP((4,), device="cpu")
    model = tts.LayeredMLP((4, 6, 2), device="cpu")
    ctx = model.forward(model.init_params(), *model.data(3))
    with pytest.raises(ValueError, match="top-down"):
        model.backward(ctx, "layer00")


def test_psstate_numpy_round_trip():
    host = _numpy_state(4, 8, 2, seed=0)
    state = psstate_from_numpy(host, device="cpu")
    assert isinstance(state, tts.PSState)
    back = psstate_to_numpy(state)
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], host[f])
    # Its own copy: writing the tensor leaves the numpy value alone.
    state.w1.add_(1.0)
    assert not np.array_equal(state.w1.numpy(), host["w1"])
    jstate = jts.PSState(**{f: jnp.asarray(v) for f, v in host.items()})
    again = psstate_from_numpy(jax.tree.map(np.asarray, jstate),
                               device="cpu")
    np.testing.assert_array_equal(again.b2.numpy(), host["b2"])


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_on_cpu_ranks(n):
    # n == 1 runs in this process (a gloo group of one); n == 2 spawns two
    # gloo ranks, as the JAX package fakes two devices.
    assert tts.dryrun_multichip(n, device="cpu") is None
