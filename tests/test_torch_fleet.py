"""The port's parameter-server fleet against the JAX package's.

Pure half: the port's ``ShardMap``, ``plan_reshard`` and
``regime_assignment`` give the JAX package's owners and plans.

Live half (native library, under an armed stall watchdog), tolerance 0
throughout — both packages apply the same float32 update with the same
roundings, so any difference is a fault:

  * a tensor migrated JAX shard -> port shard -> JAX shard, by each
    package's Migrator, keeps its params, momenta and version bit for
    bit, and pushes after each Commit end where an all-JAX run ends;
  * a mixed fleet (one shard of each package) under either package's
    FleetClient pulls and pushes exactly like one JAX server;
  * the handshake's error codes (E_MOVED "moved:<dest>", E_MIGRATING,
    E_EXISTS) are the same from either server;
  * the JAX package's fleet tests, on the port: the epoch-validated Meta
    cache, a live 1 -> 2 reshard under load, a shard killed mid-pull, and
    a live regime switch with momentum continuity.

Every live test uses its own registry tag and ephemeral ports, waits on
conditions under an explicit deadline, and stops what it started in
``finally``.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brpc_tpu.fleet import migrator as jmig
from brpc_tpu.fleet import shard_map as jsm
from brpc_tpu.runtime import param_server as jps
from brpc_tpu_torch.fleet import migrator as tmig
from brpc_tpu_torch.fleet import shard_map as tsm
from brpc_tpu_torch.runtime import param_server as tps
from brpc_tpu_torch.runtime.state import (fleet_state_to_numpy,
                                          state_from_numpy, state_to_numpy)

KEYS = [f"layer{i:03d}/w" for i in range(400)]
LR, BETA = 0.05, 0.8


def _addrs(n):
    return [f"10.0.0.{i + 1}:8000" for i in range(n)]


def _wait(cond, timeout_s, what):
    """Poll ``cond`` until it holds; fail with ``what`` at the deadline."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout_s} s: {what}")
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# Pure: placement and plans equal the JAX package's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_map_owner_matches_jax(n):
    addrs = _addrs(n)
    overrides = {KEYS[3]: addrs[-1], KEYS[7]: "10.9.9.9:8000"}
    jm = jsm.ShardMap(addrs, epoch=n, overrides=overrides)
    tm = tsm.ShardMap(addrs, epoch=n, overrides=overrides)
    assert [tm.owner(k) for k in KEYS] == [jm.owner(k) for k in KEYS]
    assert [tm.preference(k) for k in KEYS[:50]] == [
        jm.preference(k) for k in KEYS[:50]]
    assert [tsm.key_point(k) for k in KEYS] == [jsm.key_point(k)
                                               for k in KEYS]
    grown = _addrs(n + 1)
    assert tm.moved_keys(tm.with_shards(grown, n + 1), KEYS) == \
        jm.moved_keys(jm.with_shards(grown, n + 1), KEYS)


def _plan_fixture():
    """tests/test_fleet.py's planner fixture: everything on `a` (the
    1 -> 3 grow), one name stuck frozen where it belongs, one name on two
    shards mid-handoff."""
    a, b, c = _addrs(3)
    names = KEYS[:60]
    entry = {"shape": [256], "dtype": "float32", "version": 3}
    placement = {a: {n: dict(entry) for n in names}, b: {}, c: {}}
    target = jsm.ShardMap([a, b, c], epoch=5)
    stuck = next(n for n in names if target.owner(n) == a)
    placement[a][stuck]["state"] = "frozen"
    dup = next(n for n in names if target.owner(n) == b)
    placement[b][dup] = dict(entry, version=7)
    return placement, [a, b, c]


def _plan_tuple(plan):
    return (plan.target.epoch, plan.target.shards,
            {k: [(m.name, m.src, m.dst, m.nbytes) for m in v]
             for k, v in plan.links.items()},
            plan.repairs, plan.stale, plan.total_bytes)


def test_plan_reshard_matches_jax():
    placement, addrs = _plan_fixture()
    jp = jmig.plan_reshard(placement, jsm.ShardMap(addrs, epoch=5))
    tp = tmig.plan_reshard(placement, tsm.ShardMap(addrs, epoch=5))
    assert _plan_tuple(tp) == _plan_tuple(jp)
    assert tp.repairs and tp.stale and tp.moves


def test_regime_assignment_and_switch_plan_match_jax():
    addrs = _addrs(4)
    names = [f"layer{k:02d}" for k in range(12)]
    for stages in (1, 2, 3, 4):
        assert tmig.regime_assignment(names, addrs[:stages]) == \
            jmig.regime_assignment(names, addrs[:stages])
    ketama = jsm.ShardMap(addrs, epoch=3)
    entry = {"shape": [64], "dtype": "float32", "version": 1}
    placement = {a: {} for a in addrs}
    for n in names:
        placement[ketama.owner(n)][n] = dict(entry)
    asg = tmig.regime_assignment(names, addrs[:2])
    jp = jmig.plan_reshard(placement, jsm.ShardMap(addrs, 4, asg))
    tp = tmig.plan_reshard(placement, tsm.ShardMap(addrs, 4, asg))
    assert _plan_tuple(tp) == _plan_tuple(jp)
    assert tp.moves and not tp.repairs and not tp.stale


# ---------------------------------------------------------------------------
# Live fleets.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_env(tmp_path_factory):
    from conftest import require_native_lib
    require_native_lib()
    from brpc_tpu_torch.fleet import RegistryHub, clear_registry
    from brpc_tpu_torch.observability import health, metrics
    health.start_watchdog(str(tmp_path_factory.mktemp("torch_fleet_dumps")))
    hub = RegistryHub()
    hub.start()
    try:
        yield {"hub": hub, "health": health, "metrics": metrics}
    finally:
        clear_registry()
        hub.stop()
    _wait(lambda: health.state() != "stalled", 10,
          f"scheduler stalled after fleet tests; dump: "
          f"{health.last_dump_path()}")


def _shard(env, impl, tag, i, ttl_s=2, **kw):
    """One started FleetServer of package ``impl`` ("jax" or "torch")."""
    if impl == "jax":
        from brpc_tpu.fleet import FleetServer
        s = FleetServer(env["hub"].hostport, tag=tag,
                        shard_name=f"{tag}_j{i}", ttl_s=ttl_s, **kw)
    else:
        from brpc_tpu_torch.fleet import FleetServer
        s = FleetServer(env["hub"].hostport, tag=tag,
                        shard_name=f"{tag}_t{i}", ttl_s=ttl_s,
                        device="cpu", **kw)
    s.start()
    return s


def _fleet_client(env, impl, tag, **kw):
    if impl == "jax":
        from brpc_tpu.fleet import FleetClient
        return FleetClient(env["hub"].hostport, tag=tag, **kw)
    from brpc_tpu_torch.fleet import FleetClient
    return FleetClient(env["hub"].hostport, tag=tag, device="cpu", **kw)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stop_all(*things):
    for t in things:
        if t is None:
            continue
        try:
            (t.close if hasattr(t, "close") else t.stop)()
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass


def _server_state(srv):
    """(params, momenta, versions) of a JAX or port ParameterServer."""
    if isinstance(srv, tps.ParameterServer):
        return state_to_numpy(srv.state())
    return ({k: np.asarray(v) for k, v in srv._params.items()},
            {k: np.asarray(v) for k, v in srv._momenta.items()},
            dict(srv._version))


def _assert_states_equal(a, b):
    assert a[2] == b[2]
    assert a[0].keys() == b[0].keys()
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k])
        np.testing.assert_array_equal(a[1][k], b[1][k])


def _arrays(seed, names, size, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(size) * scale).astype(np.float32)
            for n in names}


def test_cross_package_migration_is_bit_exact(fleet_env):
    """JAX shard -> port shard by the JAX Migrator, then port shard ->
    JAX shard by the port's, with three pushes after each Commit: the
    state equals the all-JAX run at every step (tolerance 0)."""
    from brpc_tpu.fleet import Migrator as JMigrator
    from brpc_tpu_torch.fleet import Migrator as TMigrator

    tag = "xmig"
    names = [f"x{k}" for k in range(6)]
    params = _arrays(1, names, 1000)
    grads = [_arrays(10 + s, names, 1000, 0.1) for s in range(7)]
    js = _shard(fleet_env, "jax", tag, 0, lr=LR, momentum=BETA)
    ts = _shard(fleet_env, "torch", tag, 0, lr=LR, momentum=BETA)
    ref = jps.ParameterServer({n: jnp.asarray(v) for n, v in params.items()},
                              lr=LR, momentum=BETA)
    ref.start()
    rc = jps.ParameterClient(f"tpu://127.0.0.1:{ref.port}")
    jm = JMigrator(fleet_env["hub"].hostport, tag=tag)
    tm = TMigrator(fleet_env["hub"].hostport, tag=tag)
    clients = {}

    def client(srv):
        addr = srv.addr
        if addr not in clients:
            clients[addr] = tps.ParameterClient(f"tpu://{addr}",
                                                device="cpu")
        return clients[addr]

    def push(srv, step):
        for n in names:
            g = grads[step][n]
            assert client(srv).push_grad(n, torch.from_numpy(g.copy())) == \
                rc.push_grad(n, jnp.asarray(g))

    try:
        jc = jps.ParameterClient(f"tpu://{js.addr}")
        for n in names:
            jc.install(n, np.stack([params[n], np.zeros_like(params[n])]),
                       0, commit=True)
        jc.close()
        push(js, 0)
        before = _server_state(js.ps)
        assert jm.switch_regime({n: ts.addr for n in names}) == len(names)
        assert not _server_state(js.ps)[0]
        _assert_states_equal(_server_state(ts.ps), before)
        for step in (1, 2, 3):
            push(ts, step)
        _assert_states_equal(_server_state(ts.ps), _server_state(ref))
        before = _server_state(ts.ps)
        assert tm.switch_regime({n: js.addr for n in names}) == len(names)
        assert not _server_state(ts.ps)[0]
        _assert_states_equal(_server_state(js.ps), before)
        for step in (4, 5, 6):
            push(js, step)
        _assert_states_equal(_server_state(js.ps), _server_state(ref))
        assert _server_state(js.ps)[2] == {n: 7 for n in names}
    finally:
        _stop_all(jm, tm, rc, *clients.values(), js, ts)
        ref.stop()


@pytest.mark.parametrize("client_impl", ["jax", "torch"])
def test_mixed_fleet_matches_single_jax_server(fleet_env, client_impl):
    """One shard of each package under either package's FleetClient:
    pull_all and push_all equal one JAX server's, bit for bit."""
    tag = f"mixed_{client_impl}"
    shards = [_shard(fleet_env, "jax", tag, 0, lr=LR, momentum=BETA),
              _shard(fleet_env, "torch", tag, 0, lr=LR, momentum=BETA)]
    fc = _fleet_client(fleet_env, client_impl, tag, op_deadline_s=10.0)
    # Names until both shards own some: placement keys on the shards'
    # ephemeral ports.
    names, i = [], 0
    while i < 200 and (len(names) < 12 or len(
            {fc.map.owner(n) for n in names}) < 2):
        names.append(f"w{i:02d}")
        i += 1
    params = _arrays(3, names, 2048)
    single = jps.ParameterServer({n: jnp.asarray(v)
                                  for n, v in params.items()},
                                 lr=LR, momentum=BETA)
    single.start()
    spc = jps.ParameterClient(f"tpu://127.0.0.1:{single.port}")
    try:
        for n, v in params.items():
            fc.install(n, v)
        assert {m["shard"] for m in fc.meta().values()} == {
            s.addr for s in shards}
        for step in range(2):
            got, want = fc.pull_all(), spc.pull_all()
            assert sorted(got) == sorted(want) == sorted(params)
            for n in params:
                assert got[n][0] == want[n][0] == step
                np.testing.assert_array_equal(_host(got[n][1]),
                                              _host(want[n][1]))
            g = _arrays(20 + step, names, 2048, 0.1)
            fleet_g = {n: (jnp.asarray(v) if client_impl == "jax"
                           else torch.from_numpy(v)) for n, v in g.items()}
            assert fc.push_all(fleet_g) == spc.push_all(
                {n: jnp.asarray(v) for n, v in g.items()})
        merged = [{}, {}, {}]
        for s in shards:
            for part, d in zip(_server_state(s.ps), merged):
                d.update(part)
        _assert_states_equal(tuple(merged), _server_state(single))
    finally:
        _stop_all(fc, spc, *shards)
        single.stop()


@pytest.mark.parametrize("server_impl", ["jax", "torch"])
def test_handshake_error_codes_match(fleet_env, server_impl):
    """E_MOVED "moved:<dest>" for a frozen (push) or retired (pull and
    push) name, E_MIGRATING for a pending one, E_EXISTS for an install
    over a serving name — the same from either server, under the port's
    client."""
    p = {n: np.full((64,), float(k + 1), np.float32)
         for k, n in enumerate(("a", "c"))}
    if server_impl == "jax":
        srv = jps.ParameterServer({n: jnp.asarray(v) for n, v in p.items()})
    else:
        srv = tps.ParameterServer(state_from_numpy(p, device="cpu"))
    port = srv.start()
    cl = tps.ParameterClient(f"tpu://127.0.0.1:{port}", device="cpu")
    g = torch.full((64,), 0.5)
    dest = "10.1.2.3:4567"

    def code_of(fn):
        with pytest.raises(tps.native.RpcError) as ei:
            fn()
        return ei.value

    try:
        version, stacked = cl.handoff("a", dest=dest)
        assert version == 0 and stacked.shape == (2, 64)
        np.testing.assert_array_equal(stacked[0], p["a"])
        e = code_of(lambda: cl.push_grad("a", g))
        assert e.code == tps.E_MOVED and tps.moved_dest(e) == dest
        assert cl.pull("a")[0] == 0  # frozen names keep serving reads
        cl.install("b", np.stack([p["a"], p["a"] * 0]), 5)
        e = code_of(lambda: cl.push_grad("b", g))
        assert e.code == tps.E_MIGRATING
        v, t = cl.pull("b")
        assert v == 5 and np.array_equal(t.numpy(), p["a"])
        assert cl.meta()["b"]["state"] == "pending"
        e = code_of(lambda: cl.install("c", np.stack([p["c"], p["c"]]), 0))
        assert e.code == tps.E_EXISTS
        cl.retire("a", dest=dest)
        for op in (lambda: cl.pull("a"), lambda: cl.push_grad("a", g)):
            e = code_of(op)
            assert e.code == tps.E_MOVED and tps.moved_dest(e) == dest
        cl.commit("b")
        assert cl.push_grad("b", g) == 6
        e = code_of(lambda: cl.pull("nowhere"))
        assert e.code == tps.E_NO_SUCH
    finally:
        cl.close()
        srv.stop()


def test_meta_cache_validates_by_epoch(fleet_env):
    """The cache revalidates with one Epoch RPC and refetches Meta only
    on a schema change (Install), never on an ordinary push."""
    p = {f"w{i:02d}": np.full((256,), float(i + 1), np.float32)
         for i in range(4)}
    ps = tps.ParameterServer(state_from_numpy(p, device="cpu"))
    ps.start()
    pc = tps.ParameterClient(f"tpu://127.0.0.1:{ps.port}", device="cpu")
    try:
        first = pc.cached_meta()
        full_fetches = []
        orig_meta = pc.meta
        pc.meta = lambda: full_fetches.append(1) or orig_meta()
        assert pc.cached_meta() is first
        assert pc.pull_all() and not full_fetches
        pc.push_grad("w00", torch.full((256,), 1.0))
        assert pc.cached_meta() is first and not full_fetches
        arr = np.zeros((256,), np.float32)
        pc.install("fresh", np.stack([arr, arr]), version=0, commit=True)
        refreshed = pc.cached_meta()
        assert full_fetches and "fresh" in refreshed
    finally:
        pc.close()
        ps.stop()


def test_live_reshard_under_load(fleet_env):
    """A shard joins under concurrent pull and push load: the registry
    watch edge triggers the migration, no pull returns a torn tensor or a
    version that went backwards, and the fleet converges with both shards
    serving and every name on its ketama owner."""
    from brpc_tpu_torch.fleet import Migrator

    tag = "t_livemove"
    names = [f"w{i:02d}" for i in range(16)]
    params = {n: np.full((1024,), float(i + 1), np.float32)
              for i, n in enumerate(names)}
    s1 = _shard(fleet_env, "torch", tag, 0)
    s2 = None
    fc = _fleet_client(fleet_env, "torch", tag, op_deadline_s=20.0)
    mig = Migrator(fleet_env["hub"].hostport, tag=tag, window=4).start()
    stop = threading.Event()
    errors, last_version = [], {}
    pulls, pushes = [0], [0]

    def puller():
        while not stop.is_set():
            try:
                got = fc.pull_all(names)
            except Exception as e:  # noqa: BLE001 — collected for assert
                errors.append(f"pull: {type(e).__name__}: {e}")
                return
            for k, (version, t) in got.items():
                u = np.unique(t.numpy())
                if u.size != 1:
                    errors.append(f"TORN {k}@v{version}: {u[:4]}")
                    return
                if version < last_version.get(k, 0):
                    errors.append(f"STALE {k}: v{version} after "
                                  f"v{last_version[k]}")
                    return
                last_version[k] = version
            pulls[0] += 1

    def pusher():
        i = 0
        while not stop.is_set():
            name = names[i % len(names)]
            try:
                fc.push_grad(name, torch.full((1024,), 0.125))
            except Exception as e:  # noqa: BLE001
                errors.append(f"push {name}: {type(e).__name__}: {e}")
                return
            i += 1
            pushes[0] += 1

    threads = [threading.Thread(target=puller, daemon=True),
               threading.Thread(target=pusher, daemon=True)]
    try:
        for n, v in params.items():
            fc.install(n, v)
        _wait(lambda: mig.reshards >= 1, 10, "the migrator's first pass")
        base = mig.reshards
        for t in threads:
            t.start()
        _wait(lambda: pulls[0] >= 2 and pushes[0] >= 10 or errors, 20,
              "steady load on one shard")
        s2 = _shard(fleet_env, "torch", tag, 1)
        _wait(lambda: mig.reshards > base, 10,
              "the watch edge never triggered a reshard")
        after = pulls[0]
        _wait(lambda: pulls[0] >= after + 2 or errors, 20,
              "load across the tail of the move")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    try:
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:5]
        assert mig.stuck_moves == 0
        fc.refresh()
        final = fc.pull_all()
        assert sorted(final) == sorted(names)
        owner = {k: m["shard"] for k, m in fc.meta().items()}
        assert set(owner.values()) == {s1.addr, s2.addr}
        assert owner == {n: fc.map.owner(n) for n in names}
        p, _m, v = fleet_state_to_numpy([s1, s2])
        assert sum(v.values()) == pushes[0]
        for k, (version, t) in final.items():
            assert version == v[k]
            np.testing.assert_array_equal(t.numpy(), p[k])
            assert np.unique(p[k]).size == 1
        moved = fleet_env["metrics"].counter(
            "torch_fleet_migration_moved_total").value()
        assert moved >= 1
    finally:
        _stop_all(mig, fc, s1, s2)


def test_kill_shard_mid_pull_recovers(fleet_env):
    """Killing a shard mid-pull_all: the registry drops it at TTL, the
    surviving tensors keep pulling untorn, lost ones report missing fast,
    and install() reseeds them at the survivor."""
    from brpc_tpu_torch.fleet import Migrator

    tag = "t_killmove"
    names = [f"w{i:02d}" for i in range(12)]
    params = {n: np.full((256,), float(i + 1), np.float32)
              for i, n in enumerate(names)}
    shards = [_shard(fleet_env, "torch", tag, i) for i in range(2)]
    fc = _fleet_client(fleet_env, "torch", tag, op_deadline_s=10.0)
    mig = Migrator(fleet_env["hub"].hostport, tag=tag, window=4).start()
    victim, survivor = shards[1], shards[0]
    stop = threading.Event()
    errors, observed = [], []

    def puller():
        while not stop.is_set():
            try:
                got = fc.pull_all(names, on_missing="skip")
            except Exception as e:  # noqa: BLE001
                errors.append(f"pull: {type(e).__name__}: {e}")
                return
            for k, (version, t) in got.items():
                if np.unique(t.numpy()).size != 1:
                    errors.append(f"TORN {k}@v{version}")
                    return
            observed.append(set(got))

    t = threading.Thread(target=puller, daemon=True)
    try:
        owners = {n: fc.install(n, v) for n, v in params.items()}
        lost = {k for k, a in owners.items() if a == victim.addr}
        kept = set(params) - lost
        assert lost and kept, owners
        t.start()
        _wait(lambda: len(observed) >= 2 or errors, 20, "pulls before kill")
        # A crash, not a leave: no deregister is sent.
        victim._registration.stop(deregister_now=False)
        victim.ps.stop()
        _wait(lambda: errors or (observed and observed[-1] == kept), 20,
              "the fleet serving exactly the surviving set")
        stop.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert not errors, errors[:5]
        for k in sorted(lost):
            assert fc.install(k, params[k]) == survivor.addr
        full = fc.pull_all()
        assert sorted(full) == sorted(params)
        for k, (_v, tt) in full.items():
            np.testing.assert_array_equal(tt.numpy(), params[k])
        assert fleet_env["health"].state() != "stalled"
    finally:
        stop.set()
        _stop_all(mig, fc, *shards)


def test_switch_regime_live_momentum_continuity(fleet_env):
    """A live ownership switch over port shards: placement converges
    onto the stage assignment, a second pass moves nothing, and a push
    after the switch continues the pre-switch momentum (the Handoff
    shipped [param, momentum]) — equal to the formula bit for bit."""
    from brpc_tpu_torch.fleet import Migrator

    tag = "t_regime"
    lr, mu, size = 0.01, 0.9, 512
    names = [f"layer{k:02d}" for k in range(8)]
    shards = [_shard(fleet_env, "torch", tag, i) for i in range(2)]
    fc = _fleet_client(fleet_env, "torch", tag, op_deadline_s=20.0)
    mig = Migrator(fleet_env["hub"].hostport, tag=tag, window=4)
    try:
        rng = np.random.default_rng(7)
        p = {n: rng.standard_normal(size).astype(np.float32) for n in names}
        g1 = {n: rng.standard_normal(size).astype(np.float32) for n in names}
        g2 = {n: rng.standard_normal(size).astype(np.float32) for n in names}
        for n in names:
            fc.install(n, p[n])
            fc.push_grad(n, torch.from_numpy(g1[n]))
        m = {n: g1[n].copy() for n in names}  # momentum started at 0
        p = {n: p[n] - np.float32(lr) * m[n] for n in names}
        pre = {k: v["version"] for k, v in fc.meta().items()}
        asg = tmig.regime_assignment(names, [s.addr for s in shards])
        assert mig.switch_regime(asg) >= 1
        assert {k: v["shard"] for k, v in fc.meta().items()} == asg
        assert mig.switch_regime(asg) == 0
        for n in names:
            ver, t = fc.pull(n)
            assert ver >= pre[n]
            np.testing.assert_array_equal(t.numpy(), p[n])
            fc.push_grad(n, torch.from_numpy(g2[n]))
            m[n] = np.float32(mu) * m[n] + g2[n]
            p[n] = p[n] - np.float32(lr) * m[n]
            ver2, t2 = fc.pull(n)
            assert ver2 == ver + 1
            np.testing.assert_array_equal(t2.numpy(), p[n])
        _pp, mm, _vv = fleet_state_to_numpy(shards)
        for n in names:
            np.testing.assert_array_equal(mm[n], m[n])
    finally:
        _stop_all(mig, fc, *shards)


def test_push_all_across_a_reshard_applies_each_gradient_once(fleet_env):
    """An int8 push_all on a stale map after a 1 -> 2 reshard: the moved
    names are refused by the old owner and re-sent to the new one, every
    other push in the window completes (none is cancelled and re-sent),
    so each gradient lands once. The end state equals a replay through
    the JAX package's codec: error feedback carried on the shard that
    stayed, restarted at zero for the names that moved."""
    from brpc_tpu.runtime import codec as jcodec
    from brpc_tpu_torch.fleet import Migrator

    tag = "t_pushmove"
    names = [f"w{i:02d}" for i in range(10)] + [f"b{i:02d}" for i in range(6)]
    size = {n: 2048 if n[0] == "w" else 100 for n in names}  # b: raw
    p = {n: _arrays(30 + i, [n], size[n])[n] for i, n in enumerate(names)}
    g = [{n: _arrays(40 + 7 * s + i, [n], size[n], 0.1)[n]
          for i, n in enumerate(names)} for s in range(2)]
    s1 = _shard(fleet_env, "torch", tag, 0, lr=LR, momentum=BETA)
    s2 = None
    fc = _fleet_client(fleet_env, "torch", tag, codec="int8",
                       op_deadline_s=20.0)
    passes = []
    mig = Migrator(fleet_env["hub"].hostport, tag=tag,
                   on_reshard=lambda _i, n: passes.append(n)).start()
    try:
        for n in names:
            fc.install(n, p[n])
        assert fc.push_all({n: torch.from_numpy(g[0][n]) for n in names}) \
            == {n: 1 for n in names}
        _wait(lambda: passes, 10, "the migrator's first pass")
        s2 = _shard(fleet_env, "torch", tag, 1, lr=LR, momentum=BETA)
        target = tsm.ShardMap([s1.addr, s2.addr])
        moved = {n for n in names if target.owner(n) == s2.addr}
        assert moved and moved != set(names)
        _wait(lambda: sum(passes) == len(moved), 20, "the 1 -> 2 move")
        assert fc.push_all({n: torch.from_numpy(g[1][n]) for n in names}) \
            == {n: 2 for n in names}
        params, momenta, versions = fleet_state_to_numpy([s1, s2])
        assert versions == {n: 2 for n in names}
        ef = [jcodec.ErrorFeedback(), jcodec.ErrorFeedback()]
        for n in names:
            pp, mm = p[n], np.zeros_like(p[n])
            for step in range(2):
                x = g[step][n]
                if n[0] == "w":
                    acc = ef[1] if (step == 1 and n in moved) else ef[0]
                    x = acc.compensate(n, x)
                    e = jcodec.encode(x, "int8")
                    acc.settle(n, x, e.dequantized())
                    x = e.dequantized()
                mm = np.float32(BETA) * mm + x
                pp = pp - np.float32(LR) * mm
            np.testing.assert_array_equal(params[n], pp)
            np.testing.assert_array_equal(momenta[n], mm)
    finally:
        _stop_all(mig, fc, s1, s2)


def test_int8_fleet_pull_matches_each_shards_pullq(fleet_env):
    """An int8 FleetClient pull over two port shards: each shard stream
    widens its PullQ codes through the dequantize path on the client's
    device, and every tensor equals the JAX package's int8 pull from its
    owner bit for bit; ineligible tensors ride raw."""
    tag = "t_qpull"
    names = [f"w{i:02d}" for i in range(12)] + [f"b{i:02d}" for i in range(4)]
    size = {n: 2048 if n[0] == "w" else 100 for n in names}  # b: raw
    p = {n: _arrays(50 + i, [n], size[n])[n] for i, n in enumerate(names)}
    shards = [_shard(fleet_env, "torch", tag, i, lr=LR, momentum=BETA)
              for i in range(2)]
    fc = _fleet_client(fleet_env, "torch", tag, codec="int8",
                       op_deadline_s=10.0)
    jcs = []
    try:
        for n in names:
            fc.install(n, p[n])
        got = fc.pull_all()
        assert sorted(got) == sorted(names)
        owners = {s.addr for s in shards}
        assert {fc.map.owner(n) for n in names} == owners
        for s in shards:
            jc = jps.ParameterClient(f"tpu://{s.addr}", codec="int8")
            jcs.append(jc)
            want = jc.pull_all([n for n in names if fc.map.owner(n) == s.addr])
            for n, (v, x) in want.items():
                assert got[n][0] == v == 0
                assert got[n][1].device.type == "cpu"
                np.testing.assert_array_equal(_host(got[n][1]), _host(x))
        for n in names:
            same = np.array_equal(_host(got[n][1]), p[n])
            assert same == (n[0] == "b"), n  # quantized unless ineligible
    finally:
        _stop_all(fc, *jcs, *shards)


def test_version_lag_gauge_per_named_server(fleet_env):
    """A named server exposes its own version spread beside the
    process-wide one, as the JAX package's does (``torch_`` prefixed)."""
    obs = fleet_env["metrics"]
    from brpc_tpu.observability import metrics as jobs

    p = {n: np.full((256,), 1.0, np.float32) for n in ("a", "b", "c")}
    servers = [jps.ParameterServer({n: jnp.asarray(v) for n, v in p.items()},
                                   name="lagcheck_jax"),
               tps.ParameterServer(state_from_numpy(p, device="cpu"),
                                   name="lagcheck.torch")]
    clients = []
    try:
        for srv in servers:
            cl = tps.ParameterClient(f"tpu://127.0.0.1:{srv.start()}",
                                     device="cpu")
            clients.append(cl)
            for _ in range(3):
                cl.push_grad("b", torch.full((256,), 0.5))
            cl.push_grad("c", torch.full((256,), 0.5))

        def gauge(dump, name):
            for line in dump(name).splitlines():
                key, _, value = line.partition(" : ")
                if key.strip() == name:
                    return int(value)
            return None

        assert gauge(jobs.dump_vars, "param_server_version_lag_lagcheck_jax") \
            == gauge(obs.dump_vars,
                     "torch_param_server_version_lag_lagcheck_torch") == 3
    finally:
        for cl in clients:
            cl.close()
        for srv in servers:
            srv.stop()
