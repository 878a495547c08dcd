"""tools/tpulint_torch: tools/tpulint's Python rules over the port, the
port's metric namespace, and the torch twins of arena-alias and
regime-graph — one positive and one negative fixture per rule, and the
test that keeps the real port lint-clean. Pure CPython, no native build.
"""

import os
import subprocess
import sys

import pytest

from tools.tpulint_torch import run_lint
from tools.tpulint_torch.core import PortContext, port_context
from tools.tpulint_torch.rules import RULES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_REPO = os.path.join(ROOT, "tests", "fixtures", "tpulint_torch",
                            "repo")

# rule: (fixture stem, the messages its bad fixture must raise)
CASES = {
    "py-blocking": ("py", ["time.sleep", "subprocess.run"]),
    "negotiation": ("neg", ['"qos"', '"pushq"', '"codecs"']),
    "state-machine": ("sm", ["outside a `with ..._mu:`", "DONE -> ACTIVE",
                             "Retire after Commit"]),
    "block-account": ("blk", ["_free_blocks", "_block_refs",
                              "block_table"]),
    "error-code": ("ec", ["collides with E_FIXTURE_GONE",
                          "outside the reserved", "raw error code 2091"]),
    "metric-name": ("mn", ["violates the exposition charset",
                           "collides with the expose at "
                           "brpc_tpu/observability/jax_metrics.py"]),
    "metric-namespace-torch": ("ns", ['"fixture_unprefixed_depth"']),
    "arena-alias-torch": ("aa", [".to(non_blocking=True)",
                                 ".cuda(non_blocking=True)",
                                 "copy_(non_blocking=True)",
                                 "after the view's release()"]),
    "regime-graph-torch": ("rg", ["launches device work"] * 4),
}


@pytest.fixture(scope="module")
def fixture_findings():
    return run_lint(FIXTURE_REPO)


def _of(findings, rule, stem, kind):
    return [f for f in findings
            if f.rule == rule and os.path.basename(f.path) ==
            f"{stem}_{kind}.py"]


def test_every_rule_has_its_case():
    assert sorted(r.id for r in RULES) == sorted(CASES)


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_fires_on_its_bad_fixture(fixture_findings, rule):
    stem, wants = CASES[rule]
    hits = _of(fixture_findings, rule, stem, "bad")
    assert len(hits) >= len(wants), hits
    messages = [f.message for f in hits]
    for want in wants:
        assert any(want in m for m in messages), (want, messages)
    assert all(f.hint for f in hits)
    assert all(f.path.startswith("brpc_tpu_torch/") for f in hits)


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_is_silent_on_its_good_fixture(fixture_findings, rule):
    stem, _wants = CASES[rule]
    assert not [f for f in fixture_findings
                if os.path.basename(f.path) == f"{stem}_good.py"]


def test_the_jax_tree_is_read_but_never_reported(fixture_findings):
    # brpc_tpu/runtime/jax_side.py sleeps on the handler path: that is
    # tools/tpulint's to report. The JAX metric file is read (the
    # collision above names it) but yields no finding here.
    assert not [f for f in fixture_findings
                if not f.path.startswith("brpc_tpu_torch/")]


def test_port_context_reads_jax_selectors_as_the_port():
    ctx = port_context(FIXTURE_REPO)
    assert isinstance(ctx, PortContext)
    got = {f.path for f in ctx.select(under=("brpc_tpu/serving/",),
                                      ext={".py"})}
    assert got == {f"brpc_tpu_torch/serving/{n}.py" for n in
                   ("blk_bad", "blk_good", "sm_bad", "sm_good")}
    both = port_context(FIXTURE_REPO, keep_jax=True)
    paths = {f.path for f in both.select(under=("brpc_tpu/",))}
    assert "brpc_tpu/runtime/jax_side.py" in paths
    assert "brpc_tpu_torch/runtime/py_bad.py" in paths


def test_real_port_is_lint_clean():
    findings = run_lint(ROOT)
    assert not findings, "\n".join(
        f"{f.location()}: [{f.rule}] {f.message}" for f in findings)


def test_cli_exit_codes():
    env = dict(os.environ, PYTHONPATH=ROOT)
    clean = subprocess.run([sys.executable, "-m", "tools.tpulint_torch"],
                           cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=120)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    dirty = subprocess.run([sys.executable, "-m", "tools.tpulint_torch",
                            "--root", FIXTURE_REPO, "--format", "json"],
                           cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=120)
    assert dirty.returncode == 1
    assert '"regime-graph-torch"' in dirty.stdout
