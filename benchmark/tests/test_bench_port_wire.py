"""The wire's copy-rate readers (``wire.<dir>_gbps.<kind>``): None on a
rehearsal, on the other kind of cell and where the program counts no
copy (a program without the counters); on planted counters, the bytes
over the host microseconds as GB/s."""

import importlib.util
import os

import pytest

from brpc_tpu_torch.observability import metrics
from harness import wire_counters

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")
READERS = {"wire.h2d_gbps.mlp": ("train", "h2d"),
           "wire.d2h_gbps.mlp": ("train", "d2h"),
           "wire.h2d_gbps.ps": ("ps", "h2d"),
           "wire.d2h_gbps.ps": ("ps", "d2h")}
PLANTED = {"torch_wire_h2d_bytes": 6_000_000_000,
           "torch_stage_h2d_us": 1_000_000,
           "torch_wire_d2h_bytes": 3_000_000_000,
           "torch_stage_d2h_us": 250_000,
           "torch_stage_h2d_calls": 7, "torch_tensor_pull_qps": 3}
CARD = {"peaks": {"hbm_Bps": 3.35e12}}


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def plant(monkeypatch, values):
    text = "".join(f"{k} : {v}\n" for k, v in values.items())
    monkeypatch.setattr(metrics, "dump_vars",
                        lambda prefix="": text if prefix == "torch_" else "")


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_on_a_rehearsal_and_on_the_other_kind(monkeypatch, name):
    plant(monkeypatch, PLANTED)
    kind, _d = READERS[name]
    other = "ps" if kind == "train" else "train"
    read = reader(name)
    assert read({"kind": kind}) is None  # a rehearsal has no peaks
    assert read(dict(CARD, kind=other)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_bytes_over_host_microseconds_as_gbps(monkeypatch, name):
    plant(monkeypatch, PLANTED)
    kind, d = READERS[name]
    got = reader(name)(dict(CARD, kind=kind))
    # 6e9 B in 1 s, 3e9 B in 0.25 s.
    assert got == pytest.approx({"h2d": 6.0, "d2h": 12.0}[d])


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_where_no_copy_was_counted(monkeypatch, name):
    kind, d = READERS[name]
    plant(monkeypatch, {"torch_tensor_pull_qps": 3})  # the parent program
    assert reader(name)(dict(CARD, kind=kind)) is None
    plant(monkeypatch, dict(PLANTED, **{f"torch_wire_{d}_bytes": 0}))
    assert reader(name)(dict(CARD, kind=kind)) is None


def test_vars_lines_that_are_not_counts_are_skipped(monkeypatch):
    monkeypatch.setattr(metrics, "dump_vars", lambda prefix="": (
        "torch_wire_h2d_bytes : 12\ntorch_x : [1, 2]\nnot a line\n"))
    assert wire_counters.read_vars() == {"torch_wire_h2d_bytes": 12}
