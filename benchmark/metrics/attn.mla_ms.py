"""attn.mla_ms: device ms, in one step profiled in the trainer's process
after the traced stretch, of the kernels launched inside the program's
stage/mla_attn ranges (the latent up-projection, RoPE and the attention
core, forward and backward); copies left out (harness/stage_kernels.py)."""


def read(rec):
    s = (rec.get("stage_kernel_s") or {}).get("mla_attn")
    return None if not s else 1e3 * s
