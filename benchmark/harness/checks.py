"""The numbers that decide ``correct``: each is a gap between what the
program produced and what the plain reference works out, held to a limit
the traffic file states."""

from __future__ import annotations

import statistics

import torch


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (over 1 where want is all 0)."""
    got, want = got.to(want.device, torch.float32), want.float()
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float((got - want).abs().max()) / (scale if scale > 0 else 1.0)


def loss_gap(got: list, want: list) -> float:
    """The worst step's |loss - reference loss| / |reference loss|; a
    missing step reads 1."""
    if len(got) != len(want):
        return 1.0
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))


def norm_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's |norm - reference norm|, over the larger of that
    leaf's reference norm and the median leaf's. ``keep``: the leaves
    compared (default all)."""
    names = list(want) if keep is None else list(keep)
    med = statistics.median(want.values())
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in names)


def moved_leaves(ref_grad_norms: dict, share: float = 1e-3) -> list:
    """Leaves whose reference gradient is not nought to rounding: over
    ``share`` of the median leaf's."""
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= share * med]


def judge(readings: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}) with every reading beside
    its limit; a reading without a limit, or a limit without a reading,
    is not correct."""
    out = {k: {"value": readings.get(k), "limit": limits.get(k)}
           for k in sorted(set(readings) | set(limits))}
    ok = all(r["value"] is not None and r["limit"] is not None
             and r["value"] <= r["limit"] for r in out.values())
    return ok, out
