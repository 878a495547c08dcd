"""Pipeline-stage harness: a contiguous slice of the LayeredMLP stack.

The port of brpc_tpu/models/pipeline.py. ``StagedMLP`` is the model half
of the pipeline regime: stage ``s`` owns layers ``stage_layers(L, S)[s]``
of the SAME stack ``LayeredMLP`` trains whole, through the same per-layer
functions (``_layer_fwd``, ``_grad_w``, ``_delta_prev``,
``_loss_and_head_delta``), on the device — so PP trajectory parity
against the single-process baseline is a statement about the schedule
and the wire, not about reimplemented math. The only new arithmetic is at
stage boundaries: the backward recurrence ``delta_prev = (delta @ W.T) *
(z_prev > 0)`` splits across the link — the upstream stage ships the
unmasked ``delta @ W.T`` (it does not hold ``z_prev``), and the
downstream stage applies its own relu mask.

Gradient scaling: each microbatch's loss is a mean over ITS rows, so
averaging the per-microbatch grads (the driver divides the accumulated
sum by M) equals the full-batch gradient in real arithmetic — in fp32
the partial-sum reassociation leaves ~1e-6-relative noise, the
documented parity tolerance.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from brpc_tpu_torch.models.tensor_service import (LayeredMLP, _delta_prev,
                                                  _grad_w, _layer_fwd,
                                                  _loss_and_head_delta)
from brpc_tpu_torch.runtime.pp_sched import stage_layers
from brpc_tpu_torch.runtime.state import to_tensor


def delta_in(delta: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The boundary ship: dL/d(a_in) WITHOUT the relu mask — the mask
    belongs to the downstream stage's own z (it holds z, we don't)."""
    return torch.matmul(delta, w.T)


def mask_delta(grad_in: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return grad_in * (z > 0)


class StagedMLP:
    """One stage's slice of ``LayeredMLP(sizes, seed=seed)`` on
    ``device`` (default CUDA).

    Implements the :class:`~brpc_tpu_torch.runtime.pp_sched.PipelineStageDriver`
    harness contract: ``names`` / ``device`` / ``params()`` / ``set_param``
    / ``set_batch`` / ``fwd`` / ``bwd`` / ``take_grads`` / ``take_loss``.
    ``params`` (a ``{name: array or tensor}`` dict holding at least this
    stage's layers — the whole stack's will do) overrides the seeded
    initialisation, e.g. to start from the JAX package's weights.
    """

    def __init__(self, sizes, stage: int, stages: int, seed: int = 0,
                 params: Optional[Dict[str, object]] = None, device=None):
        full = LayeredMLP(sizes, seed=seed, device=device)
        self.sizes = list(sizes)
        self.stage = stage
        self.stages = stages
        self.device = full.device
        lo, hi = stage_layers(len(full.names), stages)[stage]
        self._lo, self._hi = lo, hi
        self.names: List[str] = full.names[lo:hi]
        self._n_layers = len(full.names)
        src = params if params is not None else full.init_params()
        self._params: Dict[str, torch.Tensor] = {
            n: to_tensor(src[n], self.device).to(torch.float32)
            for n in self.names}
        self._ctx: Dict[int, dict] = {}
        self._x_mb: List[torch.Tensor] = []
        self._y_mb: List[torch.Tensor] = []
        self._gsum: Dict[str, torch.Tensor] = {}
        self._loss_sum = 0.0

    # -- driver contract: parameters --

    def params(self) -> Dict[str, torch.Tensor]:
        return self._params

    def set_param(self, name: str, t: torch.Tensor) -> None:
        self._params[name] = t

    # -- driver contract: data --

    def _split(self, batch, microbatches: int) -> List[torch.Tensor]:
        t = to_tensor(batch, self.device).to(torch.float32)
        if t.shape[0] % microbatches:
            raise ValueError(f"batch {t.shape[0]} not divisible by "
                             f"{microbatches} microbatches")
        return [c.contiguous() for c in torch.chunk(t, microbatches)]

    def set_batch(self, x=None, y=None, microbatches: int = 1) -> None:
        if x is not None:
            self._x_mb = self._split(x, microbatches)
        if y is not None:
            self._y_mb = self._split(y, microbatches)

    # -- driver contract: compute --

    def fwd(self, mb: int, a_in) -> Optional[torch.Tensor]:
        a = self._x_mb[mb] if self.stage == 0 else a_in
        acts, zs = [a], []
        for k, name in enumerate(self.names):
            a, z = _layer_fwd(a, self._params[name],
                              last=(self._lo + k == self._n_layers - 1))
            zs.append(z)
            acts.append(a)
        ctx = {"acts": acts, "zs": zs}
        out = None
        if self.stage == self.stages - 1:
            loss, ctx["delta"] = _loss_and_head_delta(a, self._y_mb[mb])
            self._loss_sum += float(loss)
        else:
            out = a
        self._ctx[mb] = ctx
        return out

    def bwd(self, mb: int, grad_in) -> Optional[torch.Tensor]:
        ctx = self._ctx.pop(mb)
        if self.stage == self.stages - 1:
            delta = ctx["delta"]
        else:
            # Our top layer is never the global head, so it carries a
            # relu whose mask we apply to the shipped boundary grad.
            delta = mask_delta(grad_in, ctx["zs"][-1])
        for k in range(len(self.names) - 1, -1, -1):
            name = self.names[k]
            g = _grad_w(ctx["acts"][k], delta)
            self._gsum[name] = (self._gsum[name] + g if name in self._gsum
                                else g)
            if k > 0:
                delta = _delta_prev(delta, self._params[name],
                                    ctx["zs"][k - 1])
        if self.stage > 0:
            return delta_in(delta, self._params[self.names[0]])
        return None

    # -- driver contract: step results --

    def take_grads(self) -> Dict[str, torch.Tensor]:
        out, self._gsum = self._gsum, {}
        return out

    def take_loss(self) -> float:
        out, self._loss_sum = self._loss_sum, 0.0
        return out
