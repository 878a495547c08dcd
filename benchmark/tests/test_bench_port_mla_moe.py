"""The MLA + MoE cell (``mla-moe.ps-overlap``): the manifest holds its
configuration, its cell and the metrics it reports; a CPU rehearsal at
the configuration's tiny sizes is correct and each planted fault is not;
the FLOP count, the stage attribution and the readers on made-up
records."""

import importlib.util
import json
import os

import pytest
import torch

from harness import cell, checks, mla_moe_flops, stage_kernels, train_blocks

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELL, CONFIG = "mla-moe.ps-overlap", "moonlight-16b-a3b-ep8"
SEED = 2**33 + 29


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_holds_the_configuration_and_the_cell(bench):
    conf = {c["name"]: c for c in bench["configs"]}[CONFIG]
    assert conf["reduced"] == ["num_hidden_layers", "n_routed_experts",
                               "vocab_size"]
    with open(os.path.join(ROOT, conf["file"])) as f:
        doc = json.load(f)
    assert doc["published"]["num_hidden_layers"] == 27
    assert doc["published"]["n_routed_experts"] == 64
    assert doc["published"]["vocab_size"] == 163840
    assert (doc["num_hidden_layers"], doc["n_routed_experts"],
            doc["vocab_size"]) == (5, 8, 20480)
    assert doc["model"]["router_experts"] == 64
    assert "8 cards" in doc["deployment"]
    w = {c["name"]: c for c in bench["workloads"]}[CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (
        CONFIG, "mla-moe-own-process", 1)
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in ("step_ms", "model.step_mfu", "driver.exposed_comm_ms",
                 "wire.busy_ms"):
        assert metrics[name]["workloads"][-1] == CELL, name
    for name in ("attn.mla_ms", "moe.experts_ms", "moe.route_ms"):
        assert metrics[name]["workloads"] == [CELL]
        assert metrics[name]["moves"] == "step_ms"
    others = [m for m in metrics.values()
              if CELL in m.get("workloads", [])]
    assert len(others) == 7


def test_the_flop_count_at_the_configuration(bench):
    conf = {c["name"]: c for c in bench["configs"]}[CONFIG]
    with open(os.path.join(ROOT, conf["file"])) as f:
        model = json.load(f)["model"]
    cfg, held = train_blocks.arch(model)
    # 275.6M active weights a token (held experts at 6 x 8 / 64 of a
    # token), 16384 tokens, and 10.3 TFLOP of attention core.
    assert mla_moe_flops.active_weights(cfg, held) == pytest.approx(
        275_644_416)
    assert mla_moe_flops.attention_flops(cfg, 2, 8192) == pytest.approx(
        3 * 5 * 2 * 2 * 16 * (8192 * 8193 / 2) * 320)
    assert mla_moe_flops.step_flops(cfg, held, 2, 8192) / 1e12 == \
        pytest.approx(37.406, abs=1e-3)


def run(**kw):
    ctx = cell.Ctx(CELL, SEED, 1.0, False, rehearse=True)
    return ctx, cell.run(ctx, **kw)


def test_a_sound_rehearsal_is_correct_and_half_batch_is_not():
    ctx, res = run(variants=["half_batch"])
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["route_flips"]["value"] == 0
    ok, compared = checks.judge(res["variants"]["half_batch"],
                                ctx.mix["limits"])
    assert ok is False, compared


def shared_dropped(monkeypatch):
    from brpc_tpu_torch.models.mla_moe import MLAMoEStack

    orig = MLAMoEStack._moe_forward

    def forward(self, ctx, i, params, h):
        p = dict(params)
        name = f"layers.{i}.mlp.shared.down"
        p[name] = torch.zeros_like(p[name])
        return orig(self, ctx, i, p, h)

    monkeypatch.setattr(MLAMoEStack, "_moe_forward", forward)


def unbiased_choice(monkeypatch):
    from brpc_tpu_torch.models.mla_moe import MLAMoEStack

    orig = MLAMoEStack.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        self.correction_bias = torch.zeros_like(self.correction_bias)

    monkeypatch.setattr(MLAMoEStack, "__init__", init)


def half_batch(monkeypatch):
    from brpc_tpu_torch.models.mla_moe import MLAMoEStack

    orig = MLAMoEStack.forward

    def forward(self, params, x, y):
        n = x.shape[0] // 2
        return orig(self, params, x[:n], y[:n])

    monkeypatch.setattr(MLAMoEStack, "forward", forward)


@pytest.mark.parametrize("plant", [shared_dropped, unbiased_choice,
                                   half_batch])
def test_planted_faults_are_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    _ctx, res = run()
    assert res["correct"] is False, res["checks"]


def ev(cat, ts, dur, name="k", tid=1, **args):
    return {"cat": cat, "ts": ts, "dur": dur, "name": name, "tid": tid,
            "ph": "X", "args": args}


def test_kernels_count_for_the_stage_that_launched_them():
    evs = [ev("cpu_op", 0, 100, "stage/mla_attn", tid=1),
           ev("cpu_op", 200, 50, "stage/moe_experts", tid=1),
           ev("cpu_op", 5, 10, "autograd::engine::evaluate_function: X",
              tid=7),
           # launched inside mla_attn, on the range's thread and on the
           # autograd engine's
           ev("cuda_runtime", 10, 1, "cudaLaunchKernel", tid=1,
              correlation=1),
           ev("cuda_runtime", 20, 1, "cudaLaunchKernel", tid=7,
              correlation=2),
           # a wire lane's launch at the same time does not count
           ev("cuda_runtime", 30, 1, "cudaLaunchKernel", tid=3,
              correlation=3),
           # a copy launched inside the range does not count
           ev("cuda_runtime", 40, 1, "cudaMemcpyAsync", tid=1,
              correlation=4),
           ev("cuda_driver", 210, 1, "cuLaunchKernel", tid=1, correlation=5),
           ev("cuda_runtime", 300, 1, "cudaLaunchKernel", tid=1,
              correlation=6),
           ev("kernel", 50, 7, correlation=1), ev("kernel", 60, 11,
                                                  correlation=2),
           ev("kernel", 70, 13, correlation=3),
           ev("gpu_memcpy", 80, 17, correlation=4),
           ev("kernel", 220, 19, correlation=5),
           ev("kernel", 320, 23, correlation=6)]
    got = stage_kernels.stage_kernel_us(evs, ("mla_attn", "moe_experts",
                                              "moe_route"))
    assert got == {"mla_attn": 18, "moe_experts": 19, "moe_route": 0}


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"),
        os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers_on_made_up_records():
    rec = {"kind": "train", "peaks": {}, "step_walls": [1.0] * 4,
           "window_s": 4.0,
           "stage_kernel_s": {"mla_attn": 0.75, "moe_experts": 0.08},
           "moe_route_us": (1000, 81000)}
    assert reader("attn.mla_ms")(rec) == pytest.approx(750.0)
    assert reader("moe.experts_ms")(rec) == pytest.approx(80.0)
    assert reader("moe.route_ms")(rec) == pytest.approx(20.0)
    # No card, no stages (a parent without them), another kind of cell.
    for name in ("attn.mla_ms", "moe.experts_ms", "moe.route_ms"):
        assert reader(name)({"kind": "train"}) is None
    assert reader("moe.route_ms")(dict(rec, moe_route_us=(None, None))) \
        is None
    assert reader("moe.route_ms")(dict(rec, kind="ps")) is None


@pytest.mark.cuda
def test_tf32_control_fails_the_cell():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    ctx = cell.Ctx(CELL, SEED, 1.0, False)
    res = cell.run(ctx, variants=["tf32"])
    assert res["correct"] is True, res["checks"]
    ok, compared = checks.judge(res["variants"]["tf32"], ctx.mix["limits"])
    assert ok is False, compared
