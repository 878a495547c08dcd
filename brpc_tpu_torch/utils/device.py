"""Device resolution for every entry point of the port.

Replaces the JAX package's backend probe (``jax.default_backend() ==
"tpu"`` in brpc_tpu/runtime/param_server.py): the port places tensors on
CUDA unless the caller names the CPU, and it never carries on quietly on
the CPU when CUDA was asked for and is missing.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; ``"cpu"``/``"cuda[:i]"`` or a
    ``torch.device`` as given. Raises ``RuntimeError`` when a CUDA device
    is asked for (explicitly or by default) and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default) but CUDA is not "
            "available; pass device='cpu' to run on the host")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
