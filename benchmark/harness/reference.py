"""The plain reference: the same semantics as the program, in plain
PyTorch, written from the configuration's description and nothing of the
program's (this module imports no ``brpc_tpu_torch``).

* The MLP stack: ``z = a @ W``, ReLU between layers, none after the last;
  loss ``mean((out - y)^2)``; gradients by the chain rule.
* The optimizer: SGD with momentum, ``m' = beta m + g``,
  ``p' = p - lr m'``, each operation rounded to the parameter's dtype.
* The int8 wire: per block of 256 values one fp32 scale
  ``absmax / 127``; codes ``clip(rint(x * (127 / absmax)), -127, 127)``;
  the receiver widens ``code * scale``. A pushed gradient carries error
  feedback: ``x = g + e``, then ``e' = x - widen(encode(x))``. Tensors
  under 4096 bytes ride raw.

Every division is by a tensor, never by a Python number: CUDA divides by
a host scalar as a multiply by its reciprocal, which rounds differently.
"""

from __future__ import annotations

import contextlib
import math

import torch

BLOCK = 256
MIN_QUANT_BYTES = 4096


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """fp32 matmuls in full fp32 (``tf32=False``) or in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------- the MLP

def mlp_grads(weights: list, x: torch.Tensor, y: torch.Tensor) -> tuple:
    """One forward and backward pass -> (gradients by layer, loss as a
    Python float)."""
    last = len(weights) - 1
    acts, zs, a = [x], [], x
    for k, w in enumerate(weights):
        z = a @ w
        zs.append(z)
        a = z if k == last else torch.relu(z)
        acts.append(a)
    r = a - y
    loss = float(torch.mean(r * r))
    delta = (2.0 / r.numel()) * r
    grads = [None] * len(weights)
    for k in range(last, -1, -1):
        grads[k] = acts[k].T @ delta
        if k > 0:
            delta = (delta @ weights[k].T) * (zs[k - 1] > 0)
        acts.pop()
        zs.pop()
    return grads, loss


def momentum(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor, lr: float,
             beta: float) -> tuple:
    """One SGD-with-momentum update in ``p``'s dtype -> (p', m')."""
    g = g.to(p.dtype)
    m2 = beta * m + g
    return p - lr * m2, m2


def mlp_train(weights: dict, batches: list, lr: float, beta: float, *,
              tf32: bool = False, rows: int = None) -> dict:
    """``len(batches)`` training steps from ``weights`` (a ``{name:
    tensor}`` dict in forward order). ``rows`` keeps only the first rows
    of every batch (a planted fault). -> ``{"losses", "m1": the momenta
    after step 1 (its gradient), "params": after the last step}``."""
    names = list(weights)
    p = [weights[k].clone() for k in names]
    m = [torch.zeros_like(t) for t in p]
    losses, m1 = [], None
    with matmul_precision(tf32):
        for x, y in batches:
            if rows is not None:
                x, y = x[:rows], y[:rows]
            grads, loss = mlp_grads(p, x, y)
            losses.append(loss)
            for k, g in enumerate(grads):
                p[k], m[k] = momentum(p[k], m[k], g, lr, beta)
            del grads
            if m1 is None:
                m1 = dict(zip(names, m))
    return {"losses": losses, "m1": m1, "params": dict(zip(names, p))}


# ---------------------------------------------------------------- the wire

def eligible(shape) -> bool:
    """Whether an fp32 tensor of ``shape`` rides the int8 wire."""
    return 4 * math.prod(shape) >= MIN_QUANT_BYTES


def _blocks(flat: torch.Tensor) -> tuple:
    n = flat.numel()
    nfull = n // BLOCK
    return nfull, n - nfull * BLOCK


def int8_encode(x: torch.Tensor) -> tuple:
    """fp32 tensor -> (int8 codes, flat; fp32 scales, one per block)."""
    flat = x.reshape(-1)
    nfull, tail = _blocks(flat)
    parts = []
    if nfull:
        parts.append(flat[:nfull * BLOCK].view(nfull, BLOCK).abs().amax(1))
    if tail:
        parts.append(flat[nfull * BLOCK:].abs().amax().reshape(1))
    absmax = torch.cat(parts)
    target = torch.full_like(absmax, 127.0)
    inv = torch.where(absmax > 0, torch.div(target, absmax),
                      torch.zeros_like(absmax))
    y = torch.empty_like(flat)
    if nfull:
        torch.mul(flat[:nfull * BLOCK].view(nfull, BLOCK),
                  inv[:nfull, None], out=y[:nfull * BLOCK].view(nfull, BLOCK))
    if tail:
        torch.mul(flat[nfull * BLOCK:], inv[nfull:], out=y[nfull * BLOCK:])
    q = torch.round(y).clamp_(-127.0, 127.0).to(torch.int8)
    return q, torch.div(absmax, target)


def int8_widen(q: torch.Tensor, scales: torch.Tensor, shape) -> torch.Tensor:
    """Codes and scales -> the fp32 tensor the receiver reconstructs."""
    out = q.to(torch.float32)
    nfull, tail = _blocks(out)
    if nfull:
        out[:nfull * BLOCK].view(nfull, BLOCK).mul_(scales[:nfull, None])
    if tail:
        out[nfull * BLOCK:].mul_(scales[nfull:])
    return out.view(shape)


def int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """What an int8 pull of ``x`` delivers."""
    q, s = int8_encode(x)
    return int8_widen(q, s, x.shape)


class ErrorFeedback:
    """One trainer's int8 push of one tensor, round after round."""

    def __init__(self):
        self.residual = None

    def push(self, g: torch.Tensor) -> tuple:
        """-> (codes, scales) of this round's push."""
        x = g if self.residual is None else g + self.residual
        q, s = int8_encode(x)
        self.residual = x - int8_widen(q, s, x.shape)
        return q, s


def ps_tensor(p0: torch.Tensor, pushes: list, lr: float, beta: float, *,
              dtype=torch.float32, seen=(), pull_view=None) -> tuple:
    """One parameter's trajectory on the server: ``pushes`` are its
    gradients in the order the server applied them (version 1, 2, ...).
    ``seen`` lists versions whose value a pull returned; ``pull_view``
    maps a value to what such a pull delivers. -> (p, m, {version: pulled
    value}) with p and m in fp32."""
    p = p0.to(dtype)
    m = torch.zeros_like(p)
    want = set(seen)
    views = {}
    view = pull_view or (lambda t: t)
    if 0 in want:
        views[0] = view(p.float())
    for v, g in enumerate(pushes, start=1):
        p, m = momentum(p, m, g() if callable(g) else g, lr, beta)
        if v in want:
            views[v] = view(p.float())
    return p.float(), m.float(), views
