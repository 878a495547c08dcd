"""The controls come out as not correct: the reference computed in the
nearest precision below the configuration's, put in the program's place.
For the parameter server, bfloat16 updates (on the CPU at the tiny
sizes); for the training step, TF32 matmuls, which only a card has (at
the cell's own size). A planted half batch is read beside it."""

import pytest
import torch
from conftest import INT8, bench_with

from harness import cell, checks

SEED = 2**34 + 3


@pytest.mark.parametrize("workload", ["ps.int8-rounds", "ps.raw-rounds"])
def test_bf16_control_fails_the_parameter_server_cells(workload):
    ctx = cell.Ctx(workload, SEED, 1.0, False, rehearse=True,
                   bench=bench_with(INT8))
    res = cell.run(ctx, variants=["bf16"])
    assert res["correct"] is True, res["checks"]
    ok, compared = checks.judge(res["variants"]["bf16"], ctx.mix["limits"])
    assert ok is False, compared


def test_half_batch_fails_the_training_cell():
    ctx = cell.Ctx("mlp.ps-overlap", SEED, 1.0, False, rehearse=True)
    res = cell.run(ctx, variants=["half_batch"])
    assert res["correct"] is True, res["checks"]
    ok, compared = checks.judge(res["variants"]["half_batch"],
                                ctx.mix["limits"])
    assert ok is False, compared


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mlp.ps-overlap", "mlp.colocated"])
def test_tf32_control_fails_the_training_cells(workload):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    ctx = cell.Ctx(workload, SEED, 1.0, False)
    res = cell.run(ctx, variants=["tf32"])
    assert res["correct"] is True, res["checks"]
    ok, compared = checks.judge(res["variants"]["tf32"], ctx.mix["limits"])
    assert ok is False, compared
