"""Nothing the benchmark runs imports JAX or the JAX package: no import
statement in its files names them, and a rehearsal of every cell ends
with none of them loaded (the run itself refuses to print a result
otherwise). Names are compared whole: ``brpc_tpu_torch`` is the port."""

import ast
import json
import os
import subprocess
import sys

import pytest

from harness import cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def sources():
    for d, _dirs, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "brpc_tpu_torch_x", sys)
    assert "brpc_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "brpc_tpu.fake", sys)
    assert "brpc_tpu" in cell.forbidden_modules()


def test_no_file_imports_jax_or_the_jax_package():
    for path in sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & set(cell.FORBIDDEN), (path, tops)


def rehearse(workload, trace):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         workload, "--seed", str(2**32 + 5), "--seconds", "1", "--trace",
         str(trace), "--rehearse"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["mlp.ps-overlap", "ps.raw-rounds",
                                      "mlp.colocated"])
def test_rehearsal_of_every_cell(workload):
    res = rehearse(workload, 1)
    assert res["rehearsal"] is True and res["device"]["platform"] == "cpu"
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"


def test_without_a_card_the_measuring_run_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "mlp.ps-overlap", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and not r.stdout.strip()


def test_without_the_program_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ps.raw-rounds",
         "--seed", "1", "--seconds", "1", "--trace", "0", "--rehearse"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and not r.stdout.strip()
