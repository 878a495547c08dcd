"""Parameter-server state carried across data planes.

The JAX package's server holds a ``{name: array}`` parameter dict, zero
momenta at start, and a version per name. ``state_from_numpy`` turns such
a dict (numpy arrays — ``np.asarray`` of the JAX arrays) into the port's
server state on a device; ``state_to_numpy`` is the reverse. Both servers
seeded from the same numpy values therefore start from identical bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from brpc_tpu_torch.utils.device import resolve_device


@dataclass
class PSState:
    """Parameters, momenta and versions of a ``ParameterServer``."""

    params: Dict[str, torch.Tensor]
    momenta: Dict[str, torch.Tensor]
    versions: Dict[str, int]


def to_tensor(value, device: torch.device) -> torch.Tensor:
    """A contiguous tensor on ``device`` holding its own copy of
    ``value`` (a tensor or anything ``np.asarray`` takes)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True).contiguous()
    return torch.from_numpy(np.array(value, copy=True)).to(device)


def state_from_numpy(params: Dict[str, object],
                     momenta: Optional[Dict[str, object]] = None,
                     versions: Optional[Dict[str, int]] = None,
                     device=None) -> PSState:
    """numpy (or tensor) params -> ``PSState`` on ``device`` (default
    CUDA). Momenta default to zeros, versions to 0, as a fresh server's."""
    dev = resolve_device(device)
    p = {k: to_tensor(v, dev) for k, v in params.items()}
    if momenta is None:
        m = {k: torch.zeros_like(v) for k, v in p.items()}
    else:
        m = {k: to_tensor(momenta[k], dev) for k in p}
    ver = {k: int((versions or {}).get(k, 0)) for k in p}
    return PSState(p, m, ver)


def state_to_numpy(state: PSState):
    """``PSState`` -> ``(params, momenta, versions)`` as host numpy dicts."""
    host = {k: v.detach().cpu().numpy() for k, v in state.params.items()}
    mom = {k: v.detach().cpu().numpy() for k, v in state.momenta.items()}
    return host, mom, dict(state.versions)
