"""moe.experts_ms: device ms, in one step profiled in the trainer's
process after the traced stretch, of the kernels launched inside the
program's stage/moe_experts ranges (the held experts' dispatch, matmuls
and combine, forward and backward); copies left out
(harness/stage_kernels.py)."""


def read(rec):
    s = (rec.get("stage_kernel_s") or {}).get("moe_experts")
    return None if not s else 1e3 * s
