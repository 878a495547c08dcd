"""The card's published peaks and the work each measured kernel and step
needs, counted from the shapes.

Peaks are NVIDIA's data sheets for the H100 (dense, no sparsity): the SXM
part ("NVIDIA H100 80GB HBM3") and the PCIe part. Byte counts read each
input byte once and write each output byte once.
"""

from __future__ import annotations

# (name part, HBM bytes/s, fp32 FLOP/s outside the tensor cores). The
# PCIe part first: "H100" alone would match it too.
PEAKS = (("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))

# The int8 wire's block of codes per fp32 scale (the codec's stated
# format, brpc_tpu_torch/runtime/codec.py DEFAULT_BLOCK).
INT8_BLOCK = 256


def peaks(kind: str) -> dict:
    """``{"hbm_Bps", "fp32_flops"}`` for the card ``kind``
    (``torch.cuda.get_device_name()``); raises for a card not listed."""
    for part, hbm, f32 in PEAKS:
        if part in kind:
            return {"hbm_Bps": hbm, "fp32_flops": f32}
    raise ValueError(f"no published peaks for {kind!r}")


def k1_bytes(elements: int) -> int:
    """K1, fp32 SGD with momentum: reads p, m, g and writes p', m'."""
    return 20 * elements


def k2_bytes(codes: int, block: int = INT8_BLOCK) -> int:
    """K2, int8 dequantize: reads a code (1 B) and its block's fp32 scale
    once per block, writes one fp32 value (4 B)."""
    return codes + 4 * codes + 4 * (-(-codes // block))


def mlp_step_flops(sizes, tokens: int) -> float:
    """Model FLOPs of one training step of a bias-free MLP stack: 6 per
    weight per token (2 forward, 4 backward), the usual model-FLOPs
    count. The stack needs no input gradient of its first layer, so it
    computes 2 * sizes[0] * sizes[1] * tokens fewer (1.4% at GPT-2
    small's widths and depth)."""
    weights = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return 6.0 * weights * tokens
