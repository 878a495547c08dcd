"""BENCHMARK.json against the benchmark's format: names, units and
texts in their alphabets and lengths, every metric and mix found by name,
every configuration used, every moved metric reported where its reader
is, and the run length that fits a full check."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def text_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert len(bench["command"]) <= 32 and all(map(text_ok,
                                                   bench["command"]))
    assert os.path.isfile(os.path.join(ROOT, bench["command"][1]))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_units_and_texts(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["why"]) and text_ok(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert text_ok(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
    for m in bench["per_layer"]:
        assert text_ok(m["layer"])


def test_every_configuration_file_and_cell(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            doc = json.load(f)
        assert doc["name"] == c["name"] and doc["source"] == c["source"]
        assert doc["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert k in doc, k
        assert {"model", "optimizer", "rehearse"} <= set(doc)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_mix_names_a_driver_and_its_limits(bench):
    for w in bench["workloads"]:
        with open(os.path.join(BENCH, "traffic",
                               w["traffic"] + ".json")) as f:
            mix = json.load(f)
        assert os.path.isfile(os.path.join(BENCH, "harness",
                                           mix["driver"] + ".py"))
        assert mix["limits"] and all(v >= 0 for v in mix["limits"].values())


def cells_of(metric, bench):
    return metric.get("workloads", [w["name"] for w in bench["workloads"]])


def test_metrics_have_readers_and_moves_are_reported(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py")), m["name"]
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = e2e[m["moves"]]
        for cell in cells_of(m, bench):
            assert cell in cells_of(moved, bench), (m["name"], cell)
    for w in bench["workloads"]:
        assert [m for m in bench["end_to_end"] if m["name"] != "setup_s"
                and w["name"] in cells_of(m, bench)], w["name"]
        assert [m for m in bench["per_layer"]
                if w["name"] in cells_of(m, bench)], w["name"]


def test_shares_name_their_kind(bench):
    for m in bench["per_layer"]:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["source"] == "device_trace"
    assert any("mfu" in m["name"] for m in bench["per_layer"])


def test_run_length_fits_a_full_check(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24  # the most cells a manifest may hold
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
    four = sum(1 for w in bench["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(bench["workloads"]) // 4)
