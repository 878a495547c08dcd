"""Quantized tensor wire format — byte for byte the JAX package's codec.

Host-side codec stage of the effective-bandwidth lever (block-wise
quantization after EQuARX, PAPERS.md):

  * **block-wise int8**: each run of ``block`` consecutive elements gets
    one fp32 scale (absmax/127); values ride as one signed byte each.
  * **fp8 e4m3**: the same per-block scales mapping absmax to 448 (the
    e4m3 max), each value stored as an e4m3 byte. The conversion goes
    through ``torch.float8_e4m3fn`` (round to nearest even), so fp8 is
    always available — no dtype-extension package is needed.
  * **error feedback** for the gradient-push side: the quantization
    residual of push k is added to the gradient of push k+1.

Wire layout of one quantized tensor: ``[nblocks x fp32 scales][n x 1-byte
codes]`` behind a ``<u32 len><JSON>`` header carrying dtype/shape plus
codec/block. Negotiation: a server advertises its codecs in Meta; a pull
appends ``\\x00<codec>`` to the name; the decode side follows the header
the bytes arrived with, never what was requested.

Codes and scales stay numpy on the host: the device-side widen is the
dequantize kernel (brpc_tpu_torch/ops/quantize.py).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Wire codec ids — must match native/trpc/compress.h.
CODEC_RAW = 0
CODEC_INT8 = 1
CODEC_FP8E4M3 = 2

_NAME_TO_ID = {"int8": CODEC_INT8, "fp8e4m3": CODEC_FP8E4M3}
_ID_TO_NAME = {v: k for k, v in _NAME_TO_ID.items()}

DEFAULT_BLOCK = 256       # 4/256 = 1.56% scale overhead on the wire
MIN_QUANT_BYTES = 4096    # smaller tensors ride raw: savings < header noise
_E4M3_MAX = 448.0


def supported_codecs() -> Tuple[str, ...]:
    """Codecs this build can encode AND decode."""
    return ("int8", "fp8e4m3")


def codec_id(name: str) -> Optional[int]:
    return _NAME_TO_ID.get(name)


def codec_name(cid: int) -> Optional[str]:
    """The codec a wire id names (None for raw or an unknown id)."""
    return _ID_TO_NAME.get(cid)


def choose(requested: Optional[str], advertised) -> Optional[str]:
    """Per-peer negotiation: the requested codec only if the peer
    advertised it AND this build supports it; else raw (None)."""
    if requested is None or advertised is None:
        return None
    if requested in advertised and requested in supported_codecs():
        return requested
    return None


def eligible(host, min_bytes: int = MIN_QUANT_BYTES) -> bool:
    """Per-tensor eligibility: fp32 payloads above the size floor. Reads
    dtype and size only, so a device tensor is never copied to decide."""
    if isinstance(host, torch.Tensor):
        return host.dtype == torch.float32 and host.numel() * 4 >= min_bytes
    return host.dtype == np.float32 and host.nbytes >= min_bytes


def _f32_to_e4m3(y: np.ndarray) -> np.ndarray:
    """fp32 -> e4m3 codes as a uint8 array (round to nearest even)."""
    return torch.from_numpy(y).to(torch.float8_e4m3fn).view(
        torch.uint8).numpy()


def _widen(codec: str, q: np.ndarray) -> np.ndarray:
    """Codes -> fresh fp32 array (int8 codes, or e4m3 codes as uint8)."""
    if codec == "int8":
        return q.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(q)).view(
        torch.float8_e4m3fn).to(torch.float32).numpy()


class Encoded:
    """One quantized tensor ready for the wire: ``wire`` is the contiguous
    ``[scales][codes]`` uint8 array, ``header`` the metadata prefix."""

    __slots__ = ("wire", "header", "codec", "block", "logical_bytes",
                 "_scales", "_q", "_shape", "_dtype")

    def __init__(self, wire, header, codec, block, logical_bytes,
                 scales, q, shape, dtype):
        self.wire = wire
        self.header = header
        self.codec = codec
        self.block = block
        self.logical_bytes = logical_bytes
        self._scales = scales
        self._q = q
        self._shape = shape
        self._dtype = dtype

    @property
    def wire_bytes(self) -> int:
        return int(self.wire.nbytes)

    def dequantized(self) -> np.ndarray:
        """What the receiver will reconstruct (exact same math) — the
        error-feedback residual source."""
        flat = _dequant_flat(self.codec, self._q, self._scales, self.block)
        return flat.reshape(self._shape)


def pack_header(meta: dict) -> bytes:
    """The '<I length + JSON' framing of every tensor metadata header."""
    doc = json.dumps(meta)
    return struct.pack("<I", len(doc)) + doc.encode()


def _block_absmax(flat: np.ndarray, block: int) -> np.ndarray:
    n = flat.size
    nfull, tail = divmod(n, block)
    absmax = np.empty(nfull + (1 if tail else 0), np.float32)
    if nfull:
        np.abs(flat[:nfull * block].reshape(nfull, block)).max(
            axis=1, out=absmax[:nfull])
    if tail:
        absmax[nfull] = np.abs(flat[nfull * block:]).max()
    return absmax


def _scaled_codes(flat, absmax, block, target):
    """flat * (target/absmax) per block, tail-aware, one output pass."""
    n = flat.size
    nfull = n // block
    inv = np.zeros_like(absmax)  # all-zero blocks stay 0 -> exact codes
    np.divide(np.float32(target), absmax, out=inv, where=absmax > 0)
    y = np.empty(n, np.float32)
    if nfull:
        np.multiply(flat[:nfull * block].reshape(nfull, block),
                    inv[:nfull, None], out=y[:nfull * block].reshape(
                        nfull, block))
    if n % block:
        np.multiply(flat[nfull * block:], inv[nfull], out=y[nfull * block:])
    return y


def encode(host: np.ndarray, codec: str, block: int = DEFAULT_BLOCK,
           min_bytes: int = MIN_QUANT_BYTES) -> Optional[Encoded]:
    """Quantize ``host`` for the wire; None = this tensor rides raw
    (ineligible dtype/size or unknown codec)."""
    if codec not in supported_codecs() or not eligible(host, min_bytes):
        return None
    flat = np.ascontiguousarray(host).reshape(-1)
    absmax = _block_absmax(flat, block)
    if codec == "int8":
        y = _scaled_codes(flat, absmax, block, 127.0)
        np.rint(y, out=y)
        q = np.clip(y, -127.0, 127.0).astype(np.int8)
        scales = (absmax / np.float32(127.0)).astype(np.float32)
    else:  # fp8e4m3
        y = _scaled_codes(flat, absmax, block, _E4M3_MAX)
        q = _f32_to_e4m3(y)
        scales = (absmax / np.float32(_E4M3_MAX)).astype(np.float32)
    wire = np.empty(scales.nbytes + q.nbytes, np.uint8)
    wire[:scales.nbytes] = scales.view(np.uint8)
    wire[scales.nbytes:] = q.view(np.uint8)
    header = pack_header({"dtype": host.dtype.str,
                          "shape": list(host.shape),
                          "codec": codec, "block": block})
    return Encoded(wire, header, codec, block, int(host.nbytes),
                   scales, q, host.shape, host.dtype)


def _dequant_flat(codec: str, q, scales, block: int) -> np.ndarray:
    """codes + per-block scales -> fresh fp32 array (never aliases the
    input pages)."""
    n = q.size
    nfull = n // block
    out = _widen(codec, q)
    if nfull:
        view = out[:nfull * block].reshape(nfull, block)
        view *= scales[:nfull, None]
    if n % block:
        out[nfull * block:] *= scales[nfull]
    return out


def split_wire(meta: dict, payload: np.ndarray):
    """Slice a received ``[scales][codes]`` byte view into its typed parts
    (zero-copy views of the input): int8 codes as ``int8``, e4m3 codes as
    their raw ``uint8`` bytes."""
    n = int(np.prod(meta["shape"], dtype=np.int64)) if meta["shape"] else 1
    block = int(meta["block"])
    nblocks = max(1, -(-n // block))
    if payload.size != nblocks * 4 + n:
        # Exact, not >=: the receiver must answer E_UNDECODABLE for a
        # truncated payload instead of failing deep in the consumer.
        raise ValueError(
            f"quantized payload is {payload.size} bytes, header claims "
            f"{nblocks * 4 + n} ({nblocks} scales + {n} codes)")
    scales = payload[:nblocks * 4].view(np.float32)
    codes = payload[nblocks * 4:nblocks * 4 + n]
    if meta["codec"] == "int8":
        q = codes.view(np.int8)
    elif meta["codec"] == "fp8e4m3":
        q = codes.view(np.uint8)
    else:
        raise ValueError(f"unknown tensor codec: {meta['codec']!r}")
    return q, scales


def decode(meta: dict, payload: np.ndarray) -> np.ndarray:
    """Received ``[scales][codes]`` bytes -> fresh fp32 ndarray shaped per
    the header."""
    q, scales = split_wire(meta, payload)
    flat = _dequant_flat(meta["codec"], q, scales, int(meta["block"]))
    out = flat.reshape(tuple(meta["shape"]))
    want = np.dtype(meta["dtype"])
    return out if want == np.float32 else out.astype(want)


class QuantizedView:
    """A quantized tensor received in place: ``q``/``scales`` are zero-copy
    views of the sender's pages, valid only inside the handler."""

    __slots__ = ("meta", "q", "scales", "shape", "dtype", "codec", "block",
                 "n", "nbytes", "wire_nbytes")

    def __init__(self, meta: dict, payload_u8: np.ndarray):
        self.meta = meta
        self.q, self.scales = split_wire(meta, payload_u8)
        self.shape = tuple(meta["shape"])
        self.dtype = np.dtype(meta["dtype"])
        self.codec = meta["codec"]
        self.block = int(meta["block"])
        self.n = int(np.prod(self.shape, dtype=np.int64))
        self.nbytes = self.n * self.dtype.itemsize  # logical bytes
        self.wire_nbytes = int(self.q.nbytes + self.scales.nbytes)

    def dequantize(self) -> np.ndarray:
        """The plain host decode into a fresh array of the header's dtype
        (consuming it detaches from the sender's pages). The server widens
        on the device with the dequantize kernel instead."""
        flat = _dequant_flat(self.codec, self.q, self.scales, self.block)
        out = flat.reshape(self.shape)
        return out if self.dtype == np.float32 else out.astype(self.dtype)


def error_bound(meta: dict, scales: np.ndarray) -> np.ndarray:
    """Per-block worst-case absolute reconstruction error: scale/2 for
    int8, scale * E4M3_MAX / 16 for e4m3."""
    if meta["codec"] == "int8":
        return scales * 0.5
    return scales * np.float32(_E4M3_MAX / 16.0)


class ErrorFeedback:
    """Per-name error-feedback accumulators for the gradient-push side:
    ``compensate`` returns g + residual; ``settle`` stores x - dq."""

    def __init__(self):
        self._residual: Dict[str, np.ndarray] = {}

    def compensate(self, name: str, g: np.ndarray) -> np.ndarray:
        e = self._residual.get(name)
        if e is None or e.shape != g.shape:
            return np.ascontiguousarray(g, dtype=np.float32)
        return (g + e).astype(np.float32, copy=False)

    def settle(self, name: str, x: np.ndarray, dq: np.ndarray) -> None:
        self._residual[name] = x - dq

    def set_residual(self, name: str, res: np.ndarray) -> None:
        """``settle`` for an encoder that already produced ``x - dq`` in
        its own pass (the collectives' fused int8 encoder)."""
        self._residual[name] = res

    def clear(self, name: str) -> None:
        self._residual.pop(name, None)

    def residual(self, name: str) -> Optional[np.ndarray]:
        return self._residual.get(name)

    def prune(self, keep) -> int:
        """Drop every residual whose name fails ``keep(name)``; returns
        the count dropped (a fleet client's reshard hook: a name routed to
        another shard is never pushed through this accumulator again)."""
        dead = [n for n in list(self._residual) if not keep(n)]
        for n in dead:
            # pop: a concurrent clear() may have dropped it already.
            self._residual.pop(n, None)
        return len(dead)


def note(tensor: str, codec: str, logical_bytes: int, wire_bytes: int
         ) -> None:
    """Wire accounting (native tensor_codec_* counters + /tensorz), only
    when the native library is already loaded in this process."""
    from brpc_tpu_torch.runtime import native

    L = native._lib
    if L is not None:
        L.tbrpc_tensor_codec_note(tensor.encode(),
                                  codec_id(codec) or CODEC_RAW,
                                  logical_bytes, wire_bytes)
