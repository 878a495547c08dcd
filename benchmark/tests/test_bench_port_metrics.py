"""The metric arithmetic: interval union and idle share, the kernels'
byte bounds, the step's FLOP count, and the readers on a made-up
record."""

import importlib.util
import os

import pytest

from harness import readers, roofline, trace

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ev(cat, ts, dur, name="k"):
    return {"cat": cat, "ts": ts, "dur": dur, "name": name, "ph": "X"}


def test_union_merges_overlaps_and_touching_spans():
    assert trace.union([(5, 7), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 7]]
    assert trace.length([(0, 10), (2, 3), (9, 12)]) == 12
    assert trace.clip([(0, 10), (20, 30)], 5, 25) == [(5, 10), (20, 25)]


def test_busy_is_the_union_over_processes_inside_the_stretch():
    trainer = [ev("kernel", 0, 10), ev("gpu_memcpy", 5, 10),
               ev("cpu_op", 0, 100)]
    server = [ev("kernel", 12, 8), ev("kernel", 90, 20)]
    # [0, 20) busy, then [90, 100) inside the stretch [0, 100].
    assert trace.busy_us(trainer + server, 0, 100) == 30


def test_kernel_time_by_name_and_top_ops():
    evs = [ev("kernel", 0, 4, "void momentum_kernel<float>"),
           ev("kernel", 10, 6, "void momentum_kernel<float>"),
           ev("kernel", 20, 3, "void dequant_kernel<int>"),
           ev("gpu_memcpy", 30, 9, "Memcpy HtoD")]
    assert trace.kernel_us(evs, "momentum_kernel") == (10, 2)
    assert trace.kernel_us(evs, "dequant_kernel") == (3, 1)
    top = trace.top_device_ops(evs, 0, 100)
    assert [n for n, _s in top] == ["void momentum_kernel<float>",
                                    "Memcpy HtoD", "void dequant_kernel<int>"]
    assert [s for _n, s in top] == pytest.approx([10e-6, 9e-6, 3e-6])


def test_idle_gaps_are_named_after_the_innermost_host_event():
    evs = [ev("kernel", 10, 10),
           ev("user_annotation", 0, 10, "step/pull:layer03"),
           ev("cpu_op", 20, 80, "aten::copy_"),
           ev("user_annotation", 15, 100, "bench/stretch")]
    gaps = dict((k, v) for k, v in trace.idle_gaps(evs, 0, 100))
    assert gaps == pytest.approx({"step/pull": 10e-6, "aten::copy_": 80e-6})


def test_byte_bounds():
    assert roofline.k1_bytes(1000) == 20_000
    # 1 B read and 4 B written a code, one 4-byte scale a 256-code block.
    assert roofline.k2_bytes(512) == 5 * 512 + 8
    assert roofline.k2_bytes(257) == 5 * 257 + 8


def test_step_flops_at_the_stack():
    sizes = [768] + [3072, 768] * 12
    assert sum(a * b for a, b in zip(sizes[:-1], sizes[1:])) == 56_623_104
    flops = roofline.mlp_step_flops(sizes, 8192)
    assert flops == 6 * 56_623_104 * 8192
    assert flops == pytest.approx(2.783e12, rel=1e-3)


def test_peaks_take_the_pcie_part_before_the_sxm_part():
    assert roofline.peaks("NVIDIA H100 PCIe")["hbm_Bps"] == 2.0e12
    assert roofline.peaks("NVIDIA H100 80GB HBM3") == {
        "hbm_Bps": 3.35e12, "fp32_flops": 67e12}
    with pytest.raises(ValueError):
        roofline.peaks("NVIDIA A100")


def train_rec(**kw):
    rec = {"kind": "train", "setup_s": 20.0, "window_s": 1.0,
           "step_walls": [0.1] * 9 + [0.2], "flops_per_step": 6.7e12,
           "step_stats": [{"exposed_comm_ms": 2.0, "wire_busy_ms": 50.0},
                          {"exposed_comm_ms": 4.0, "wire_busy_ms": 70.0}],
           "peaks": {"hbm_Bps": 3.35e12, "fp32_flops": 67e12},
           "traced": {"stretch_s": 0.5, "busy_s": 0.4, "k1_s": 0.002,
                      "k1_launches": 24, "k1_elements": 3.35e8 / 20,
                      "k2_s": 0.0, "k2_launches": 0}}
    rec.update(kw)
    return rec


def test_readers_on_a_training_record():
    rec = train_rec()
    assert reader("step_ms")(rec) == pytest.approx(100.0)
    assert reader("driver.step_p95_ms")(rec) == pytest.approx(200.0)
    assert reader("setup_s")(rec) == 20.0
    assert reader("driver.exposed_comm_ms")(rec) == 3.0
    assert reader("wire.busy_ms")(rec) == 60.0
    # 6.7e12 FLOP in 0.1 s is 67 TFLOP/s: the whole peak.
    assert reader("model.step_mfu")(rec) == pytest.approx(100.0)
    # 3.35e8 bytes at 3.35e12 B/s is 0.1 ms; K1 took 2 ms.
    assert reader("kernel.k1_roofline.mlp")(rec) == pytest.approx(5.0)
    assert reader("device.idle_share.mlp")(rec) == pytest.approx(20.0)
    for name in ("ps_gbps", "kernel.k1_roofline.ps", "kernel.k2_roofline",
                 "device.idle_share.ps", "client.pull_all_ms"):
        assert reader(name)(rec) is None, name


def test_readers_find_nothing_without_a_card():
    rec = train_rec()
    del rec["peaks"]
    for name in ("model.step_mfu", "kernel.k1_roofline.mlp",
                 "device.idle_share.mlp"):
        assert reader(name)(rec) is None, name


def test_readers_on_a_ps_record():
    rec = {"kind": "ps", "window_s": 10.0, "bytes": 20e9,
           "call_times": {"pull_all": [1.0, 3.0, 2.0],
                          "push_all": [2.0, 4.0]},
           "peaks": {"hbm_Bps": 3.35e12, "fp32_flops": 67e12},
           "traced": {"stretch_s": 4.0, "busy_s": 0.2, "k1_s": 0.01,
                      "k1_launches": 592, "k1_elements": 1e9,
                      "k2_s": 0.0, "k2_launches": 0, "k2_codes": 0}}
    assert reader("ps_gbps")(rec) == pytest.approx(2.0)
    assert reader("client.pull_all_ms")(rec) == pytest.approx(2000.0)
    assert reader("client.push_all_ms")(rec) == pytest.approx(3000.0)
    assert reader("device.idle_share.ps")(rec) == pytest.approx(95.0)
    assert reader("kernel.k1_roofline.ps")(rec) == pytest.approx(
        100.0 * 20e9 / 3.35e12 / 0.01)
    # A raw cell launches no K2: its roofline has nothing to read.
    assert reader("kernel.k2_roofline")(rec) is None
    assert readers.k2_share(dict(rec, traced=dict(
        rec["traced"], k2_s=0.001, k2_launches=10, k2_codes=10**8)),
        "ps") == pytest.approx(
        100.0 * roofline.k2_bytes(10**8) / 3.35e12 / 0.001)
    assert reader("step_ms")(rec) is None


def test_calls_under_way_at_the_close_count_pro_rata():
    from harness.ps_rounds import credited

    calls = [(0.0, 2.0), (1.0, 3.0), (9.0, 13.0), (12.0, 14.0)]
    # Whole, whole, a quarter inside [0, 10], none.
    assert credited(calls, 0.0, 10.0) == pytest.approx(2.25)
