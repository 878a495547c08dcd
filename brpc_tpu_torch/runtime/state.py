"""Parameter-server state carried across data planes.

The JAX package's server holds a ``{name: array}`` parameter dict, zero
momenta at start, and a version per name. ``state_from_numpy`` turns such
a dict (numpy arrays — ``np.asarray`` of the JAX arrays) into the port's
server state on a device; ``state_to_numpy`` is the reverse. Both servers
seeded from the same numpy values therefore start from identical bits.
``fleet_state_to_numpy`` merges a fleet's shards into one such triple.

``psstate_from_numpy``/``psstate_to_numpy`` do the same for the flagship
step's ``models.tensor_service.PSState`` (w1, b1, w2, b2, momenta, stats),
``layered_params_from_numpy`` for ``LayeredMLP``'s parameter dict, and
``decoder_params_from_numpy``/``decoder_params_to_numpy`` for the serving
decoder's ``DecoderParams`` (embed, pos, wq, wk, wv, wo).

The training plane's state, as numpy both ways: ``stage_params`` picks a
pipeline stage's layers out of a full ``LayeredMLP`` set, ``tp_shards``
cuts a rank's tensor-parallel shards by ``shard_span``, and
``driver_state_to_numpy`` reads a step driver's masters and momenta (which
``CollectiveStepDriver.prime(params, momenta)`` takes back), so a parity
test can start either package's driver mid-trajectory.
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


def fleet_state_to_numpy(servers):
    """The states of a fleet's shards (``ParameterServer``s or
    ``FleetServer``s), merged by name -> ``(params, momenta, versions)``
    as host numpy dicts, to hold a whole fleet against one server. A name
    held by two shards (a handoff not yet retired) raises ValueError."""
    params, momenta, versions = {}, {}, {}
    for srv in servers:
        p, m, v = state_to_numpy(getattr(srv, "ps", srv).state())
        twice = params.keys() & p.keys()
        if twice:
            raise ValueError(f"names on more than one shard: {sorted(twice)}")
        params.update(p)
        momenta.update(m)
        versions.update(v)
    return params, momenta, versions


_PSSTATE_FIELDS =("w1", "b1", "w2", "b2", "m_w1", "m_w2", "stats")


def psstate_from_numpy(values, device=None):
    """A mapping (or NamedTuple) of numpy arrays with the fields of
    ``tensor_service.PSState`` -> that PSState on ``device`` (default
    CUDA), each tensor its own copy."""
    from brpc_tpu_torch.models.tensor_service import PSState

    if not isinstance(values, dict):
        values = values._asdict()
    dev = resolve_device(device)
    return PSState(**{k: to_tensor(values[k], dev) for k in _PSSTATE_FIELDS})


def psstate_to_numpy(state) -> Dict[str, np.ndarray]:
    """``tensor_service.PSState`` -> ``{field: host numpy array}``."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in _PSSTATE_FIELDS}


_DECODER_FIELDS = ("embed", "pos", "wq", "wk", "wv", "wo")


def decoder_params_from_numpy(values, device=None):
    """A mapping (or NamedTuple, such as the JAX package's
    ``DecoderParams``) of arrays -> the port's ``DecoderParams`` on
    ``device`` (default CUDA), each tensor its own copy."""
    from brpc_tpu_torch.models.decoder import DecoderParams

    if not isinstance(values, dict):
        values = values._asdict()
    dev = resolve_device(device)
    return DecoderParams(**{k: to_tensor(values[k], dev)
                            for k in _DECODER_FIELDS})


def decoder_params_to_numpy(params) -> Dict[str, np.ndarray]:
    """``DecoderParams`` -> ``{field: host numpy array}``."""
    return {k: getattr(params, k).detach().cpu().numpy()
            for k in _DECODER_FIELDS}


def layered_params_from_numpy(params: Dict[str, object],
                              device=None) -> Dict[str, torch.Tensor]:
    """``{layer name: numpy weight}`` -> tensors on ``device`` (default
    CUDA), for ``tensor_service.LayeredMLP``."""
    dev = resolve_device(device)
    return {k: to_tensor(v, dev) for k, v in params.items()}


def tensors_to_numpy(tensors: Dict[str, object]) -> Dict[str, np.ndarray]:
    """``{name: tensor or array}`` -> ``{name: host numpy copy}``."""
    return {k: (v.detach().cpu().numpy().copy()
                if isinstance(v, torch.Tensor) else np.array(v))
            for k, v in tensors.items()}


def stage_params(params: Dict[str, object], sizes, stage: int,
                 stages: int) -> Dict[str, np.ndarray]:
    """The layers of pipeline stage ``stage`` (of ``stages``) out of a
    full ``LayeredMLP`` parameter set, as numpy."""
    from brpc_tpu_torch.runtime.pp_sched import stage_layers

    lo, hi = stage_layers(len(sizes) - 1, stages)[stage]
    names = [f"layer{k:02d}" for k in range(lo, hi)]
    return tensors_to_numpy({n: params[n] for n in names})


def tp_shards(params: Dict[str, object], rank: int,
              world: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s tensor-parallel shards of a full ``LayeredMLP``
    set, as numpy: layer k split on ``tp_layers.shard_axis(k)`` at
    ``shard_span``."""
    from brpc_tpu_torch.models.tp_layers import shard_axis, shard_span

    out = {}
    for k, (name, w) in enumerate(sorted(tensors_to_numpy(params).items())):
        axis = shard_axis(k)
        lo, ln = shard_span(w.shape[axis], rank, world)
        out[name] = np.ascontiguousarray(
            w[:, lo:lo + ln] if axis == 1 else w[lo:lo + ln, :])
    return out


def driver_state_to_numpy(driver):
    """A step driver's ``(masters, momenta)`` as numpy dicts (a
    ``CollectiveStepDriver``; a ``PipelineStageDriver``'s harness params
    and momenta)."""
    params = (driver.params() if hasattr(driver, "params")
              else driver.harness.params())
    return tensors_to_numpy(params), tensors_to_numpy(driver.momenta())
