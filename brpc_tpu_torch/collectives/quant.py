"""Per-chunk per-hop quantization for collectives — EQuARX's discipline
on the port's codec.

The port of brpc_tpu/collectives/quant.py. EQuARX (PAPERS.md) puts the
quantizer INSIDE the collective: every hop dequantizes what arrived,
reduces in full precision, and requantizes the partial sum for the next
hop with fresh per-block scales — so the wire moves ~1/4 the bytes while
the arithmetic stays fp32. Each (tensor, hop-role) position keeps an
error-feedback residual, so the SUM of what flows downstream tracks the
fp32 reduction to within one quant step however many collectives ran;
``ef=False`` is the naive requantizer, the pinned negative control.

Hop-role keys are stable by construction: under the ring schedule,
member ``r`` at reduce-scatter step ``s`` always handles chunk
``(r - s) % n``, so ``"<name>#rs<s>"`` names the same chunk position
every call; the single allgather quantization point is ``"<name>#ag"``,
and the tree's are ``"<name>#leaf"`` / ``"<name>#root"``.

The int8 encoder is one fused pass of plain torch ops over a CPU tensor
viewed from the fragment's numpy buffer (``torch.from_numpy``, no copy):
absmax, scale, round/clip/cast and the error-feedback residual. Its codes,
scales and residuals are bit-identical to the JAX package's fused encoder
(a jitted XLA program), so members of either package share a ring and
carry the same bytes: ``inv = 127/absmax`` is one fp32 division taken
before ``b * inv``; ``torch.round`` rounds half to even like
``jnp.round``; an all-zero block keeps scale 0 and codes 0; the scale is
``absmax * fp32(1/127)``, the product XLA makes of a division by a
constant; the residual ``x - q*scale`` is rounded once, as XLA's fused
multiply-add rounds it (computed in fp64, where it is exact); and
subnormal inputs and results are flushed to zero, as XLA flushes them.
The codes equal ``codec.encode``'s on normal inputs; a scale can differ
from its ``absmax / 127`` in the last bit. Decoding stays on the host through
``runtime.codec``: the collectives reduce host fp32 buffers (wire
staging, not device math).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from brpc_tpu_torch.collectives import ring as ring_mod
from brpc_tpu_torch.runtime import codec as codec_mod


def fused_int8(flat: np.ndarray, block: int):
    """int8-encode a flat fp32 array in one pass -> ``(codes int8,
    scales fp32, residual fp32)`` as numpy arrays, ``residual = x -
    dequantized``. The tail is zero-padded to a whole block: a pad never
    raises a block's absmax, and an all-zero pad block gets scale 0."""
    n = flat.size
    pad = (-n) % block
    xp = (np.concatenate([flat, np.zeros(pad, np.float32)]) if pad
          else np.ascontiguousarray(flat, np.float32))
    b = _flush_subnormal(torch.from_numpy(xp).view(-1, block))
    absmax = b.abs().amax(dim=1)
    inv = torch.where(absmax > 0, torch.tensor(127.0) / absmax,
                      torch.zeros_like(absmax))
    q = torch.clamp(torch.round(b * inv[:, None]), -127.0, 127.0).to(
        torch.int8)
    scales = _flush_subnormal(absmax * torch.tensor(np.float32(1 / 127)))
    # |b| and |q*scale| lie within 2^8 of each other (or q is 0), so the
    # fp64 difference of the exact fp64 product is exact: one rounding.
    res = _flush_subnormal((b.double() - q.double()
                            * scales.double()[:, None]).to(torch.float32))
    return (q.reshape(-1)[:n].numpy(), scales.numpy(),
            res.reshape(-1)[:n].numpy())


_TINY = float(np.finfo(np.float32).tiny)


def _flush_subnormal(t: torch.Tensor) -> torch.Tensor:
    """Subnormal values to zero, as XLA on the CPU treats them on the way
    in and out of every operation."""
    return torch.where((t != 0) & (t.abs() < _TINY), torch.zeros_like(t), t)


def _wire(scales: np.ndarray, q: np.ndarray) -> np.ndarray:
    wire = np.empty(scales.nbytes + q.nbytes, np.uint8)
    wire[:scales.nbytes] = scales.view(np.uint8)
    wire[scales.nbytes:] = q.view(np.uint8)
    return wire


class ChunkCodec:
    """Encode/decode one hop's chunk, raw or quantized-with-EF.

    ``encode(key, chunk, codec)`` -> ``(meta, blob_u8)``: the
    self-describing metadata entry (groupwire manifest keys) plus the
    wire bytes. ``codec=None`` — or an ineligible chunk (non-fp32, or
    below the size floor where scale overhead beats the savings) —
    rides raw, per chunk (decode always follows the metadata that
    ARRIVED, never what was requested). Thread-safe: concurrent
    collectives on different lanes share the residual table under one
    lock."""

    def __init__(self, ef: bool = True, block: int = codec_mod.DEFAULT_BLOCK,
                 min_bytes: int = codec_mod.MIN_QUANT_BYTES):
        self.ef = ef
        self.block = block
        self.min_bytes = min_bytes
        self._mu = threading.Lock()
        self._efacc = codec_mod.ErrorFeedback()

    def _fused(self, key: str, flat: np.ndarray):
        with self._mu:
            x = self._efacc.compensate(key, flat) if self.ef else flat
            q, scales, res = fused_int8(x, self.block)
            if self.ef:
                self._efacc.set_residual(key, res)
        return q, scales

    def encode(self, key: str, chunk: np.ndarray,
               codec: Optional[str]) -> Tuple[dict, np.ndarray]:
        flat = np.ascontiguousarray(chunk, dtype=np.float32).reshape(-1)
        if codec is not None and codec_mod.eligible(flat, self.min_bytes):
            if codec == "int8":
                q, scales = self._fused(key, flat)
                meta = {"dtype": flat.dtype.str, "shape": [int(flat.size)],
                        "codec": codec, "block": self.block}
                return meta, _wire(scales, q)
            with self._mu:
                x = self._efacc.compensate(key, flat) if self.ef else flat
                # `codec` is the group's negotiated choice, fixed at
                # construction (group._codec_for); the quantizer never
                # picks one.  tpulint: allow(negotiation)
                enc = codec_mod.encode(x, codec, block=self.block,
                                       min_bytes=self.min_bytes)
                if enc is not None:
                    if self.ef:
                        self._efacc.settle(key, x, enc.dequantized()
                                           .reshape(-1))
                    meta = {"dtype": flat.dtype.str,
                            "shape": [int(flat.size)],
                            "codec": codec, "block": enc.block}
                    return meta, enc.wire
                # Encode declined after the eligibility pre-check
                # (defensive): ride raw, and drop any residual — nothing
                # was lost on a raw hop.
                self._efacc.clear(key)
        elif self.ef:
            # Raw hop: the exact bytes fly, so nothing is owed at this
            # position; a stale residual from an earlier quantized call
            # (codec renegotiated away) must not strand.
            with self._mu:
                self._efacc.clear(key)
        meta = {"dtype": flat.dtype.str, "shape": [int(flat.size)]}
        return meta, flat.view(np.uint8)

    def encode_chunk(self, key: str, chunk: np.ndarray,
                     codec: Optional[str], frag_elems: int) -> list:
        """Encode one hop's whole chunk as its wire-fragment train ->
        ``[(meta, blob_u8), ...]`` in fragment order.

        int8 with fragments on block boundaries (``frag_elems % block ==
        0`` — true for every default): the WHOLE chunk quantizes in one
        fused pass (one EF position per hop) and the ``[scales][codes]``
        wire is sliced per fragment, each fragment still fully
        self-describing. Otherwise each fragment encodes independently
        (per-fragment EF keys ``<key>#f<i>``, stable per call)."""
        flat = np.ascontiguousarray(chunk, dtype=np.float32).reshape(-1)
        fs = ring_mod.fragment_spans(flat.size, frag_elems)
        whole = (codec == "int8" and frag_elems % self.block == 0
                 and codec_mod.eligible(flat, self.min_bytes))
        if not whole:
            return [self.encode(f"{key}#f{f}", flat[fo:fo + fl], codec)
                    for f, (fo, fl) in enumerate(fs)]
        q, scales = self._fused(key, flat)
        out = []
        block = self.block
        for fo, fl in fs:
            b0 = fo // block
            nb = -(-fl // block) if fl else 0
            out.append(({"dtype": flat.dtype.str, "shape": [int(fl)],
                         "codec": codec, "block": block},
                        _wire(scales[b0:b0 + nb], q[fo:fo + fl])))
        return out

    def decode(self, meta: dict, blob) -> np.ndarray:
        """Received metadata + bytes -> fresh fp32 1-D array (never
        aliases the input view — decoding IS the detach)."""
        buf = np.asarray(blob).reshape(-1).view(np.uint8)
        if "codec" in meta:
            return codec_mod.decode(meta, buf).reshape(-1)
        return np.array(np.frombuffer(buf, dtype=np.dtype(meta["dtype"])),
                        dtype=np.float32)

    def reduce_into(self, meta: dict, blob, out: np.ndarray) -> None:
        """``out += decode(meta, blob)`` without the intermediate copy on
        the raw path (the reduce-scatter hot loop adds straight from the
        received bytes; quantized payloads still materialize the
        dequantized temp — that pass IS the dequant)."""
        buf = np.asarray(blob).reshape(-1).view(np.uint8)
        if "codec" in meta:
            out += codec_mod.decode(meta, buf).reshape(-1)
        else:
            out += np.frombuffer(buf, dtype=np.dtype(meta["dtype"]))

    def prune(self, keep) -> int:
        """Drop residuals whose key fails ``keep(key)`` — the reshard
        hook: a ring rebuild after membership change shifts every hop
        role, and stale residuals would otherwise strand."""
        with self._mu:
            return self._efacc.prune(keep)

    def residual(self, key: str) -> Optional[np.ndarray]:
        with self._mu:
            return self._efacc.residual(key)
