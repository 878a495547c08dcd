"""Inputs made from the run's seed, on the device, with a
``torch.Generator`` per draw in a few large calls: the same seed gives
the same weights, batches and gradients, to the program and to the
reference alike."""

from __future__ import annotations

import hashlib
import math

import torch


def subseed(seed: int, *tags) -> int:
    """A 63-bit generator seed for one draw of the run ``seed``."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, *tags))
    return g


def _split(flat: torch.Tensor, shapes: dict) -> dict:
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


# ---------------------------------------------------------------- the MLP

def mlp_shapes(sizes) -> dict:
    """``LayeredMLP``'s parameter names (``layerNN``, forward order) and
    their shapes."""
    return {f"layer{k:02d}": (sizes[k], sizes[k + 1])
            for k in range(len(sizes) - 1)}


def mlp_weights(seed: int, sizes, device) -> dict:
    """He-normal weights (std sqrt(2 / fan-in), the ReLU stack's scale-
    keeping init), one draw for the whole stack."""
    shapes = mlp_shapes(sizes)
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=generator(device, seed, "mlp_weights"),
                       device=device)
    out = _split(flat, shapes)
    for w in out.values():
        w.mul_(math.sqrt(2.0 / w.shape[0]))
    return out


def batches(seed: int, count: int, rows: int, din: int, dout: int,
            device) -> list:
    """``count`` distinct standard-normal ``(x, y)`` batches."""
    x = torch.randn(count, rows, din, device=device,
                    generator=generator(device, seed, "x"))
    y = torch.randn(count, rows, dout, device=device,
                    generator=generator(device, seed, "y"))
    return [(x[i], y[i]) for i in range(count)]


# ---------------------------------------------------------------- the PS

def gpt2_shapes(n_layer: int, n_embd: int, n_ctx: int, vocab: int) -> dict:
    """Hugging Face ``GPT2Model`` state-dict names and shapes (buffers
    excluded): 4 + 12 * n_layer tensors."""
    d = n_embd
    shapes = {"wte.weight": (vocab, d), "wpe.weight": (n_ctx, d)}
    for i in range(n_layer):
        h = f"h.{i}."
        shapes.update({
            h + "ln_1.weight": (d,), h + "ln_1.bias": (d,),
            h + "attn.c_attn.weight": (d, 3 * d),
            h + "attn.c_attn.bias": (3 * d,),
            h + "attn.c_proj.weight": (d, d), h + "attn.c_proj.bias": (d,),
            h + "ln_2.weight": (d,), h + "ln_2.bias": (d,),
            h + "mlp.c_fc.weight": (d, 4 * d), h + "mlp.c_fc.bias": (4 * d,),
            h + "mlp.c_proj.weight": (4 * d, d),
            h + "mlp.c_proj.bias": (d,)})
    shapes.update({"ln_f.weight": (d,), "ln_f.bias": (d,)})
    return shapes


def param_set(seed: int, shapes: dict, std: float, device) -> dict:
    """Normal(0, std) values for every tensor, one draw for the set."""
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=generator(device, seed, "params"),
                       device=device)
    flat.mul_(std)
    return _split(flat, shapes)


def grad(seed: int, client: int, rnd: int, index: int, shape,
         scale: float, device) -> torch.Tensor:
    """Trainer ``client``'s gradient of tensor ``index`` in its round
    ``rnd``: its own draw, so a reference rebuilds any one alone."""
    g = torch.randn(shape, device=device,
                    generator=generator(device, seed, "grad", client, rnd,
                                        index))
    return g.mul_(scale)
