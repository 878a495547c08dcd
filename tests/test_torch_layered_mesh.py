"""``LayeredMLP(mesh=...)`` driven by one wire rank, on 4 gloo ranks, against
the JAX package's mesh harness on 4 virtual CPU devices.

One spawn of 4 ranks (``parallel.launch.run_ranks``; the ranks import
neither jax nor the suite's conftest: this module imports jax only inside
the functions that run the JAX side) drives every scenario below. Each
scenario's ``ParameterServer`` lives in this process, seeded with the same
numpy weights; rank 0 (the wire rank) reaches it over ``tpu://`` with an
``OverlappedStepDriver``, the other ranks run the same driver with
``client=None``. Meanwhile this process runs the JAX side
(``test_mesh_harness_drives_scheduled_step``'s scenario, tests/
test_step_overlap.py: sizes [16, 16, 16, 8] on a 2x2 mesh, batch 8,
window 4, two steps, both modes) from the same weights and batches, and
the port's single-device harness under the same driver.

Scenarios:
- ``jax``: the JAX test's stack, overlapped and serial; three layers, so
  the last one is column-sharded;
- ``uneven``: four layers (a row-sharded head) whose widths and batch do
  not divide by 2, so every shard and client block follows
  ``chunk_spans``'s uneven layout.

Tolerances: the mesh against the JAX package and against one device,
rtol 1e-5 / atol 1e-6 (the same fp32 values, summed in another order);
overlapped against serial, the JAX test's rtol 1e-6 / atol 1e-8.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from brpc_tpu_torch.parallel.launch import run_ranks

N = 4
STEPS = 2
WINDOW = 4
SEED = 5
# name: (sizes, batch, modes)
SCENARIOS = {
    "jax": ([16, 16, 16, 8], 8, (True, False)),
    "uneven": ([16, 11, 9, 7, 5], 7, (True,)),
}
RUNS = [(name, overlap) for name, (_s, _b, modes) in SCENARIOS.items()
        for overlap in modes]


def _single(sizes):
    from brpc_tpu_torch.models.tensor_service import LayeredMLP

    return LayeredMLP(sizes, seed=SEED, device="cpu")


def _inputs(name):
    """The scenario's numpy weights and per-step batches (the port's
    single-device ``init_params`` and ``data``)."""
    sizes, batch, _modes = SCENARIOS[name]
    h = _single(sizes)
    init = {k: v.numpy() for k, v in h.init_params().items()}
    batches = [tuple(t.numpy() for t in h.data(batch, seed=500 + i))
               for i in range(STEPS)]
    return init, batches


def _rank_body(addrs):
    """Runs on each of the 4 ranks: every run of RUNS against its server
    (``addrs[run]``); returns this rank's view of each."""
    import torch.distributed as dist

    from brpc_tpu_torch.models.tensor_service import LayeredMLP
    from brpc_tpu_torch.ops import fused_update as fu
    from brpc_tpu_torch.parallel.mesh import make_mesh
    from brpc_tpu_torch.runtime.param_server import ParameterClient
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver

    mesh = make_mesh()
    out = {"rank": dist.get_rank(),
           "mesh": (mesh["client"].size(), mesh["shard"].size())}
    for name, overlap in RUNS:
        sizes, batch, _modes = SCENARIOS[name]
        h = LayeredMLP(sizes, mesh=mesh, seed=SEED, device="cpu")
        client = (ParameterClient(addrs[(name, overlap)], device="cpu")
                  if h.is_wire else None)
        try:
            d = OverlappedStepDriver(client, h, overlap=overlap,
                                     window=WINDOW)
            d.prime()
            batches = [h.data(batch, seed=500 + i) for i in range(STEPS)]
            losses = [d.step(x, y) for x, y in batches]
        finally:
            if client is not None:
                client.close()
        out[(name, overlap)] = {
            "is_wire": h.is_wire, "losses": losses,
            "versions": dict(d.versions),
            "data": [tuple(t.numpy() for t in b) for b in batches],
            "init": {k: v.numpy() for k, v in h.init_params().items()}}
    # The serial reference of the harness itself: grads() over the mesh.
    sizes, batch, _modes = SCENARIOS["jax"]
    h = LayeredMLP(sizes, mesh=mesh, seed=SEED, device="cpu")
    grads, loss = h.grads(h.init_params(), *h.data(batch, seed=500))
    out["grads"] = ({k: v.numpy() for k, v in grads.items()}
                    if h.is_wire else grads, loss)
    out["launches"] = fu.LAUNCHES.value
    return out


def _port_server(init):
    from brpc_tpu_torch.runtime.param_server import ParameterServer

    ps = ParameterServer(init, device="cpu")
    pushes = []
    apply = ps._apply_update

    def counted(name, att):  # one call per Push the server takes
        pushes.append(name)
        return apply(name, att)

    ps._apply_update = counted
    ps.start()
    return ps, pushes


def _single_run(name):
    """The port's single-device harness under the same driver and a
    server of its own."""
    from brpc_tpu_torch.runtime.param_server import ParameterClient
    from brpc_tpu_torch.runtime.step_driver import OverlappedStepDriver

    init, batches = _inputs(name)
    ps, _pushes = _port_server(init)
    cl = ParameterClient(f"tpu://127.0.0.1:{ps.port}", device="cpu")
    try:
        d = OverlappedStepDriver(cl, _single(SCENARIOS[name][0]),
                                 overlap=True, window=WINDOW)
        d.prime()
        losses = [d.step(torch.from_numpy(x), torch.from_numpy(y))
                  for x, y in batches]
        return losses, {k: v.numpy() for k, v in ps.state().params.items()}
    finally:
        cl.close()
        ps.stop()


def _jax_side():
    """tests/test_step_overlap.py::test_mesh_harness_drives_scheduled_step
    from the port's numpy weights and batches."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from brpc_tpu.models.tensor_service import LayeredMLP
    from brpc_tpu.parallel.mesh import CLIENT_AXIS, make_mesh
    from brpc_tpu.runtime.param_server import (ParameterClient,
                                               ParameterServer)
    from brpc_tpu.runtime.step_driver import OverlappedStepDriver

    mesh = make_mesh(jax.devices()[:N])
    sizes, _batch, modes = SCENARIOS["jax"]
    init, batches = _inputs("jax")
    rows = NamedSharding(mesh, P(CLIENT_AXIS, None))
    out = {}
    for overlap in modes:
        h = LayeredMLP(sizes, mesh=mesh, seed=SEED)
        ps = ParameterServer({k: jnp.asarray(v) for k, v in init.items()})
        client = ParameterClient(f"tpu://127.0.0.1:{ps.start()}")
        try:
            d = OverlappedStepDriver(client, h, overlap=overlap,
                                     window=WINDOW)
            d.prime()
            losses = [d.step(jax.device_put(x, rows), jax.device_put(y, rows))
                      for x, y in batches]
            out[overlap] = (losses, {n: np.asarray(client.pull(n)[1])
                                     for n in h.names})
        finally:
            client.close()
            ps.stop()
    return out


@pytest.fixture(scope="module")
def runs():
    from conftest import require_native_lib
    require_native_lib()
    servers = {run: _port_server(_inputs(run[0])[0]) for run in RUNS}
    addrs = {run: f"tpu://127.0.0.1:{ps.port}"
             for run, (ps, _p) in servers.items()}
    try:
        # The ranks run in their own processes while this one runs the
        # JAX side and the single-device references.
        with ThreadPoolExecutor(max_workers=1) as pool:
            port = pool.submit(run_ranks, N, _rank_body, (addrs,),
                               device_type="cpu", timeout_s=240)
            jax_out = _jax_side()
            single = {name: _single_run(name) for name in SCENARIOS}
            ranks = port.result()
        finals = {run: ({k: v.numpy()
                         for k, v in ps.state().params.items()},
                        ps.state().versions, list(pushes))
                  for run, (ps, pushes) in servers.items()}
    finally:
        for ps, _p in servers.values():
            ps.stop()
    return {"ranks": ranks, "jax": jax_out, "single": single,
            "finals": finals}


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_ranks_form_a_two_by_two_mesh_with_one_wire_rank(runs):
    ranks = runs["ranks"]
    assert [r["rank"] for r in ranks] == list(range(N))
    assert all(r["mesh"] == (2, 2) for r in ranks)
    for run in RUNS:
        assert [r[run]["is_wire"] for r in ranks] == [True] + [False] * 3


def test_mesh_matches_the_jax_mesh_harness(runs):
    for overlap in SCENARIOS["jax"][2]:
        want_losses, want = runs["jax"][overlap]
        for r in runs["ranks"]:  # every rank sees the same loss
            _close(r[("jax", overlap)]["losses"], want_losses)
        params, _v, _p = runs["finals"][("jax", overlap)]
        assert set(params) == set(want)
        for n in want:
            _close(params[n], want[n])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_mesh_matches_one_device(runs, name):
    want_losses, want = runs["single"][name]
    for r in runs["ranks"]:
        _close(r[(name, True)]["losses"], want_losses)
    params, _v, _p = runs["finals"][(name, True)]
    for n in want:
        _close(params[n], want[n])


def test_overlapped_equals_serial(runs):
    lo = runs["ranks"][0][("jax", True)]["losses"]
    ls = runs["ranks"][0][("jax", False)]["losses"]
    _close(lo, ls, rtol=1e-6, atol=1e-8)
    po, _v, _p = runs["finals"][("jax", True)]
    ps, _v, _p = runs["finals"][("jax", False)]
    for n in po:
        _close(po[n], ps[n], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("run", RUNS, ids=[f"{n}-{'ov' if o else 'serial'}"
                                           for n, o in RUNS])
def test_one_push_per_name_per_step(runs, run):
    params, versions, pushes = runs["finals"][run]
    names = sorted(params)
    assert versions == {n: STEPS for n in names}
    assert len(pushes) == len(names) * STEPS
    assert sorted(set(pushes)) == names
    ranks = runs["ranks"]
    assert ranks[0][run]["versions"] == {n: STEPS for n in names}
    assert all(r[run]["versions"] == {} for r in ranks[1:])
    # On CPU tensors the update takes K1's plain version: no launches.
    assert all(r["launches"] == 0 for r in ranks)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_data_and_params_blocks_concatenate_to_one_device(runs, name):
    init, batches = _inputs(name)
    sizes = SCENARIOS[name][0]
    ranks = runs["ranks"]
    view = lambda r: ranks[r][(name, True)]  # noqa: E731
    # data: client blocks (ranks 0 and 2, shard 0) stack to the batch;
    # shard replicas hold the same rows.
    for i, (x, y) in enumerate(batches):
        for j, full in enumerate((x, y)):
            got = np.concatenate([view(r)["data"][i][j] for r in (0, 2)])
            assert got.tobytes() == full.tobytes()
            for r in (0, 2):
                assert (view(r)["data"][i][j].tobytes()
                        == view(r + 1)["data"][i][j].tobytes())
    # init_params: shard blocks (ranks 0 and 1) concatenate along the
    # layer's axis — columns for even layers, rows for odd ones.
    for k in range(len(sizes) - 1):
        n = f"layer{k:02d}"
        got = np.concatenate([view(r)["init"][n] for r in (0, 1)],
                             axis=1 if k % 2 == 0 else 0)
        assert got.tobytes() == init[n].tobytes()
        for r in (0, 1):
            assert (view(r)["init"][n].tobytes()
                    == view(r + 2)["init"][n].tobytes())


def test_grads_gives_the_full_dict_on_the_wire_rank_only(runs):
    sizes, batch, _modes = SCENARIOS["jax"]
    h = _single(sizes)
    want, want_loss = h.grads(h.init_params(), *h.data(batch, seed=500))
    got, loss = runs["ranks"][0]["grads"]
    assert list(got) == list(want)  # top layer first
    for n in want:
        assert got[n].shape == tuple(want[n].shape)
        _close(got[n], want[n].numpy())
    for r in runs["ranks"][1:]:
        grads, other_loss = r["grads"]
        assert grads == {n: None for n in want}
        assert other_loss == loss
    _close(loss, want_loss)


def test_odd_layer_count_shards_the_head_by_columns(runs):
    # Three layers: the head (layer02, 16 -> 8) is an even layer, so each
    # shard holds 4 of its 8 output columns.
    ranks = runs["ranks"]
    head = [ranks[r][("jax", True)]["init"]["layer02"] for r in range(N)]
    assert all(b.shape == (16, 4) for b in head)


def test_layered_mlp_mesh_refuses_a_wire_rank_without_client():
    from brpc_tpu_torch.runtime.step_driver import (CollectiveStepDriver,
                                                    OverlappedStepDriver)

    h = _single([4, 4])
    with pytest.raises(ValueError, match="client"):
        OverlappedStepDriver(None, h)

    class Mesh:  # a harness that says it is not the wire rank
        is_wire = False
        names = h.names
        mesh = object()

    with pytest.raises(ValueError, match="client"):
        OverlappedStepDriver(object(), Mesh())
    with pytest.raises(ValueError, match="full replicas"):
        CollectiveStepDriver(object(), Mesh())
