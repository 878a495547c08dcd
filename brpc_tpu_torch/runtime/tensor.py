"""Tensor-on-the-wire: torch tensors riding the RPC framework.

The Python face of the native TensorArena bridge
(native/ttpu/tensor_arena.h): a shm-backed arena both ends of a
``tpu://`` connection map. The flow per tensor:

  device tensor --(one D2H copy straight into arena pages)--> arena
  --(by-reference doorbell)--> receiver reads the SAME physical pages in
  place --(one H2D copy)--> device tensor on the other side.

Typed tensors ride as: request/response payload = a small metadata header
(``<u32 len><JSON dtype/shape[, codec/block]>``), attachment = the raw
bytes in the arena. The wire is the JAX package's, byte for byte, so the
two data planes interoperate.

Device edges and their hazards:

  * ``torch.from_numpy`` over an arena view ALIASES the pages, which the
    release hands back for reuse: a CPU target detaches with ``.clone()``.
  * A CUDA target copies with a blocking ``.to(device)`` from pageable
    memory, which has finished reading the pages when it returns — so the
    view may be released right after (no ``non_blocking`` copies from
    arena views).
  * All launches and copies go on torch's current stream, the same one on
    every handler thread, so a pull's D2H is ordered after the push
    kernel that produced the tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import struct
import threading
import time
from collections import deque
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.runtime.native import RpcError, fill_err_text, lib
from brpc_tpu_torch.utils.device import resolve_device

# App-level error code (param_server.py holds E_NO_SUCH..E_EXISTS at
# 2040-2043): a typed tensor send whose decoded meta header cannot be
# applied to the payload. The client-side codec self-heal keys on it.
E_UNDECODABLE = 2044

_NP_DTYPES = {
    torch.float32: np.float32, torch.float64: np.float64,
    torch.float16: np.float16, torch.int8: np.int8, torch.uint8: np.uint8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.bool: np.bool_,
}


_TORCH_DTYPES = {np.dtype(v): k for k, v in _NP_DTYPES.items()}


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype whose bytes a torch dtype's tensor carries."""
    try:
        return np.dtype(_NP_DTYPES[dtype])
    except KeyError:
        raise TypeError(f"{dtype} has no numpy wire dtype") from None


def _bind_tensor_api(L: ctypes.CDLL) -> ctypes.CDLL:
    if getattr(L, "_tensor_api_bound", False):
        return L
    L.tbrpc_arena_create.restype = ctypes.c_void_p
    L.tbrpc_arena_create.argtypes = [ctypes.c_size_t]
    L.tbrpc_arena_destroy.argtypes = [ctypes.c_void_p]
    L.tbrpc_arena_base.restype = ctypes.c_void_p
    L.tbrpc_arena_base.argtypes = [ctypes.c_void_p]
    L.tbrpc_arena_alloc.restype = ctypes.c_int64
    L.tbrpc_arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    L.tbrpc_arena_free.restype = ctypes.c_int
    L.tbrpc_arena_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    L.tbrpc_arena_busy_bytes.restype = ctypes.c_int64
    L.tbrpc_arena_busy_bytes.argtypes = [ctypes.c_void_p]
    L.tbrpc_arena_wait_reusable.restype = ctypes.c_int
    L.tbrpc_arena_wait_reusable.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64]
    L.tbrpc_var_arena_gauges_create.argtypes = []
    L.tbrpc_call_tensor.restype = ctypes.c_int
    L.tbrpc_call_tensor.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_view_free.argtypes = [ctypes.c_void_p]
    L.tbrpc_server_add_tensor_service.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, _TENSOR_CB, ctypes.c_void_p]
    L.tbrpc_call_tensor_async.restype = ctypes.c_void_p
    L.tbrpc_call_tensor_async.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_size_t,
        _TENSOR_DONE_CB, ctypes.c_void_p]
    future_outs = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_future_wait.restype = ctypes.c_int
    L.tbrpc_future_wait.argtypes = [ctypes.c_void_p] + future_outs
    L.tbrpc_future_timed_wait.restype = ctypes.c_int
    L.tbrpc_future_timed_wait.argtypes = [
        ctypes.c_void_p, ctypes.c_int64] + future_outs
    L.tbrpc_future_cancel.restype = ctypes.c_int
    L.tbrpc_future_cancel.argtypes = [ctypes.c_void_p]
    L.tbrpc_future_destroy.argtypes = [ctypes.c_void_p]
    L.tbrpc_async_inflight.restype = ctypes.c_int64
    L.tbrpc_async_inflight.argtypes = []
    # ---- one-sided tensor reads (published arena windows) ----
    L.tbrpc_oneside_window_create.restype = ctypes.c_void_p
    L.tbrpc_oneside_window_create.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    L.tbrpc_oneside_window_destroy.argtypes = [ctypes.c_void_p]
    L.tbrpc_oneside_publish.restype = ctypes.c_int
    L.tbrpc_oneside_publish.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_int]
    L.tbrpc_oneside_begin_rewrite.restype = None
    L.tbrpc_oneside_begin_rewrite.argtypes = [ctypes.c_void_p,
                                              ctypes.c_char_p]
    L.tbrpc_oneside_unpublish.restype = ctypes.c_int
    L.tbrpc_oneside_unpublish.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    L.tbrpc_oneside_window_describe.restype = ctypes.c_int64
    L.tbrpc_oneside_window_describe.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_oneside_map.restype = ctypes.c_void_p
    L.tbrpc_oneside_map.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64]
    L.tbrpc_oneside_stat.restype = ctypes.c_int
    L.tbrpc_oneside_stat.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64)]
    L.tbrpc_oneside_read_into.restype = ctypes.c_int
    L.tbrpc_oneside_read_into.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    L.tbrpc_oneside_unmap.restype = ctypes.c_int
    L.tbrpc_oneside_unmap.argtypes = [ctypes.c_void_p]
    L.tbrpc_oneside_stats_json.restype = ctypes.c_int64
    L.tbrpc_oneside_stats_json.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    L._tensor_api_bound = True
    return L


# Completion notification of tbrpc_call_tensor_async: fired on a
# callback-pool pthread BEFORE the future becomes waitable, with the values
# a wait would return — ownership stays with the future (the callback frees
# nothing).
_TENSOR_DONE_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.c_void_p,                    # ctx
    ctypes.c_int,                       # status (0 = ok)
    ctypes.c_void_p, ctypes.c_size_t,   # resp
    ctypes.c_void_p,                    # view handle
    ctypes.c_void_p, ctypes.c_size_t,   # ratt ptr/len
    ctypes.c_int,                       # ratt_copied
    ctypes.c_char_p,                    # err_text
)

# The notification trampolines of calls in flight: each unanchors itself
# when it fires, so ctypes never frees one the native side may still call.
_live_done_cbs: list = []

_TENSOR_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.c_void_p,                    # ctx
    ctypes.c_char_p,                    # method
    ctypes.c_void_p, ctypes.c_size_t,   # req
    ctypes.c_void_p, ctypes.c_size_t,   # attachment, IN PLACE
    ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),  # resp
    ctypes.POINTER(ctypes.c_void_p),    # resp_arena
    ctypes.POINTER(ctypes.c_uint64),    # resp_att_off
    ctypes.POINTER(ctypes.c_size_t),    # resp_att_len
    ctypes.POINTER(ctypes.c_int),       # resp_att_autofree
    ctypes.POINTER(ctypes.c_int),       # error_code
    ctypes.c_void_p, ctypes.c_size_t,   # err_text buffer (C-owned)
)


# ---- data-plane metrics (created lazily: importing loads no library) ----

_metrics_cache = None
_metrics_mu = threading.Lock()


def _metrics():
    global _metrics_cache
    with _metrics_mu:
        if _metrics_cache is None:
            from brpc_tpu_torch.observability import metrics as obs

            L = _bind_tensor_api(lib())
            # Native arena occupancy gauges (tensor_arena_busy_bytes /
            # _total_bytes), shared with every data plane in the process.
            L.tbrpc_var_arena_gauges_create()
            _metrics_cache = {
                "pull": obs.latency("torch_tensor_pull"),
                "push": obs.latency("torch_tensor_push"),
                "pull_bytes": obs.counter("torch_tensor_pull_bytes"),
                "push_bytes": obs.counter("torch_tensor_push_bytes"),
                # Handler body PLUS response staging into the arena.
                "serve": obs.latency("torch_tensor_handler"),
                # One-sided pull routing, as the client decided it: hits
                # read the peer's published window (no RPC), fallbacks
                # took the RPC path (unmapped, unpublished, torn budget).
                "oneside_hits": obs.counter("torch_oneside_pull_hits"),
                "oneside_fallbacks": obs.counter(
                    "torch_oneside_pull_fallbacks"),
                # Waits that actually parked on a range still referenced
                # by the wire (the reference-drain backpressure signal).
                "wait_stalls": obs.counter("torch_tensor_arena_wait_stalls"),
            }
        return _metrics_cache


def _stage(name):
    from brpc_tpu_torch.observability import tracing

    return tracing.stage(name)


_pipeline_mu = threading.Lock()
_pipeline_inflight = 0


def _pipeline_inflight_add(delta: int) -> None:
    global _pipeline_inflight
    with _pipeline_mu:
        _pipeline_inflight += delta


def _pipeline_gauge() -> None:
    from brpc_tpu_torch.observability import metrics as obs

    obs.gauge("torch_tensor_pipeline_inflight", lambda: _pipeline_inflight)


def _encode_meta(arr: np.ndarray) -> bytes:
    """The raw tensor header (dtype/shape) of a host array."""
    from brpc_tpu_torch.runtime import codec as codec_mod

    return codec_mod.pack_header({"dtype": arr.dtype.str,
                                  "shape": list(arr.shape)})


def pad_header64(header: bytes) -> bytes:
    """Pad a ``[u32 n|JSON]`` header with trailing spaces until its total
    length is a multiple of 64, so the payload behind it in a one-sided
    publication starts 64-byte aligned. JSON parsers ignore the spaces."""
    pad = -len(header) % 64
    if pad == 0:
        return header
    body = header[4:] + b" " * pad
    return struct.pack("<I", len(body)) + body


def _decode_meta_ex(buf: bytes) -> Tuple[dict, bytes]:
    """Header -> (metadata dict, rest of payload)."""
    (n,) = struct.unpack_from("<I", buf)
    return json.loads(buf[4:4 + n].decode()), buf[4 + n:]


class WireTensor:
    """A response tensor already encoded for the wire: ``data`` (uint8,
    staged into the service arena as-is) plus its exact ``header``.
    ``placed`` is an ``(off, nbytes)`` range the handler already wrote into
    the service's own arena; the trampoline sends it as-is (autofree)."""

    __slots__ = ("data", "header", "placed")

    def __init__(self, data: Optional[np.ndarray], header: bytes,
                 placed: Optional[Tuple[int, int]] = None):
        self.data = data
        self.header = header
        self.placed = placed


def _as_host_array(x) -> np.ndarray:
    """torch tensor -> host ndarray (one D2H copy for a CUDA tensor, a
    shared view for a contiguous CPU one); ndarray passes through."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().cpu().numpy()
    return np.asarray(x)


def _device_put_from_view(arr: np.ndarray, device: torch.device
                          ) -> torch.Tensor:
    """A tensor on ``device`` holding a copy of ``arr``, which VIEWS
    arena/view pages — complete before return, so the caller may release
    the view. CPU: ``clone()`` (``from_numpy`` aliases the pages). CUDA:
    blocking H2D from pageable memory."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t.clone()
    return t.to(device)


def _detach_device_put_batch(parts, device: torch.device) -> list:
    """Every (codes, scales) pair of ``parts`` onto ``device``, complete
    before return (the views' pages may be reused right after). Returns
    the flat ``[q0, s0, q1, s1, ...]`` tensor list."""
    flat = []
    for q, s in parts:
        flat.append(_device_put_from_view(q, device))
        flat.append(_device_put_from_view(s, device))
    return flat


def _dequant_widen(q_dev: torch.Tensor, s_dev: torch.Tensor, codec: str,
                   block, n, shape, want=None) -> torch.Tensor:
    """Widen-and-scale detached codes/scales with the dequantize kernel
    (its plain version for CPU tensors). e4m3 codes arrive as raw bytes
    and are reinterpreted here; ``want`` restores a non-fp32 dtype."""
    from brpc_tpu_torch.ops.quantize import dequantize_blocks

    if codec == "fp8e4m3":
        q_dev = q_dev.view(torch.float8_e4m3fn)
    out = dequantize_blocks(q_dev, s_dev, block=int(block), n=int(n),
                            shape=tuple(shape))
    if want is not None and np.dtype(want) != np.float32:
        out = out.to(_TORCH_DTYPES[np.dtype(want)])
    return out


def _dequant_put_from_view(meta: dict, payload_u8: np.ndarray,
                           device: torch.device, codec_mod) -> torch.Tensor:
    """A received ``[scales][codes]`` view -> fp32 tensor on ``device``:
    the codes and scales cross (a quarter of the fp32 bytes), then the
    dequantize kernel widens them on the device."""
    q, scales = codec_mod.split_wire(meta, payload_u8)
    q_dev, s_dev = _detach_device_put_batch([(q, scales)], device)
    return _dequant_widen(q_dev, s_dev, meta["codec"], meta["block"],
                          int(np.prod(meta["shape"], dtype=np.int64)),
                          meta["shape"], want=meta["dtype"])


class TensorArena:
    """Registered transfer memory, exposed as numpy views."""

    def __init__(self, nbytes: int):
        self._L = _bind_tensor_api(lib())
        self._h = self._L.tbrpc_arena_create(nbytes)
        if not self._h:
            raise MemoryError(f"arena create({nbytes}) failed")
        self._base = self._L.tbrpc_arena_base(self._h)
        self.nbytes = nbytes
        _metrics()  # occupancy gauges cover this arena from now on

    @property
    def handle(self) -> int:
        return self._h

    def alloc(self, nbytes: int) -> int:
        if not self._h:
            raise RuntimeError("arena is closed")
        off = self._L.tbrpc_arena_alloc(self._h, nbytes)
        if off < 0:
            raise MemoryError(f"arena alloc({nbytes}) failed (fragmented?)")
        return off

    def free(self, off: int) -> None:
        self._L.tbrpc_arena_free(self._h, off)

    def view(self, off: int, nbytes: int) -> np.ndarray:
        """A uint8 view of arena pages — writes here ARE the staging."""
        buf = (ctypes.c_uint8 * nbytes).from_address(self._base + off)
        return np.ctypeslib.as_array(buf)

    def place(self, array) -> Tuple[int, int, np.ndarray]:
        """Stage a tensor's or array's bytes into the arena:
        ``(off, nbytes, host)``, where ``host`` is a typed view of the
        staged bytes (it carries dtype/shape for the header). A CUDA
        tensor is copied D2H straight into the arena pages."""
        if isinstance(array, torch.Tensor):
            t = array.detach().contiguous()
            dt = np_dtype(t.dtype)
            if t.numel() == 0:
                return 0, 0, np.empty(tuple(t.shape), dt)
            nbytes = t.numel() * t.element_size()
            off = self.alloc(nbytes)
            view = self.view(off, nbytes)
            torch.from_numpy(view).copy_(t.reshape(-1).view(torch.uint8))
            return off, nbytes, view.view(dt).reshape(tuple(t.shape))
        host = np.asarray(array)
        if host.nbytes == 0:
            return 0, 0, host  # empty tensors ride as metadata only
        off = self.alloc(host.nbytes)
        self.view(off, host.nbytes)[:] = np.ascontiguousarray(
            host).reshape(-1).view(np.uint8)
        return off, host.nbytes, host

    def busy_bytes(self) -> int:
        """Bytes allocated or still referenced by the wire (0 once
        closed)."""
        if not self._h:
            return 0
        return self._L.tbrpc_arena_busy_bytes(self._h)

    def wait_reusable(self, off: int, timeout_ms: int = -1) -> bool:
        """Wait until the range at ``off`` is no longer referenced by the
        wire (< 0: no bound, 0: probe). A wait that has to park counts in
        ``torch_tensor_arena_wait_stalls``."""
        if self._L.tbrpc_arena_wait_reusable(self._h, off, 0) == 0:
            return True
        if timeout_ms == 0:
            return False
        _metrics()["wait_stalls"].add(1)
        return self._L.tbrpc_arena_wait_reusable(self._h, off,
                                                 timeout_ms) == 0

    def close(self) -> None:
        if self._h:
            self._L.tbrpc_arena_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class OnesideMiss(Exception):
    """A one-sided read that must take the RPC path for this call: not
    published (status 1) or torn past the retry budget (status 2)."""

    def __init__(self, name: str, status: int):
        super().__init__(f"oneside read miss for {name!r} (status {status})")
        self.name = name
        self.status = status


class OnesideGone(OnesideMiss):
    """The mapped window is gone (destroyed window, swept reader claim):
    unmap and stop trying — the permanent-fallback signal."""


class OnesideWindow:
    """Publisher side of one-sided tensor reads: seqlock-stamped
    publication slots inside a :class:`TensorArena`, readable by any
    same-host process that mapped the arena's shm segment. ``publish``
    hands over a range the caller already wrote; the window frees the
    displaced range through epoch-based reclamation, never under a reader
    mid-copy. ``own=False`` publishes a range in place and never frees it
    (serving KV pages, whose ranges their session owns); such a range is
    rewritten between ``begin_rewrite`` and the next ``publish``."""

    def __init__(self, arena: TensorArena, n_slots: int = 256,
                 n_readers: int = 64):
        self._L = _bind_tensor_api(lib())
        self.arena = arena
        self._h = self._L.tbrpc_oneside_window_create(arena.handle, n_slots,
                                                      n_readers)
        if not self._h:
            raise MemoryError("oneside window create failed (arena full?)")

    def publish(self, name: str, off: int, nbytes: int, version: int,
                own: bool = True) -> None:
        if not self._h:
            raise RuntimeError("oneside window is closed")
        if self._L.tbrpc_oneside_publish(self._h, name.encode(), off,
                                         nbytes, version,
                                         1 if own else 0) != 0:
            raise ValueError(
                f"oneside publish({name!r}, off={off}, n={nbytes}) refused")

    def begin_rewrite(self, name: str) -> None:
        """Write-lock ``name`` (its seqlock goes odd, readers retry) while
        its payload is rewritten in place; the next ``publish`` commits."""
        if self._h:
            self._L.tbrpc_oneside_begin_rewrite(self._h, name.encode())

    def unpublish(self, name: str) -> bool:
        if not self._h:
            return False
        return self._L.tbrpc_oneside_unpublish(self._h, name.encode()) == 0

    def describe(self) -> dict:
        """The mapping-handshake descriptor (shm name, size, directory
        offset and the window token a reader validates after mapping)."""
        if not self._h:
            raise RuntimeError("oneside window is closed")
        n = self._L.tbrpc_oneside_window_describe(self._h, None, 0)
        buf = ctypes.create_string_buffer(n + 1)
        self._L.tbrpc_oneside_window_describe(self._h, buf, n + 1)
        doc = json.loads(buf.value.decode())
        doc["token"] = int(doc["token"])  # shipped as a decimal string
        return doc

    def close(self) -> None:
        if self._h:
            self._L.tbrpc_oneside_window_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def oneside_stats() -> dict:
    """Process-wide one-sided counters and per-window reclamation state."""
    L = _bind_tensor_api(lib())
    n = L.tbrpc_oneside_stats_json(None, 0)
    buf = ctypes.create_string_buffer(n + 1)
    L.tbrpc_oneside_stats_json(buf, n + 1)
    return json.loads(buf.value.decode())


class OnesideReader:
    """Reader side: a same-host mapping of a peer's published window.
    ``read_np`` copies one committed version out under the reader's epoch
    pin and raises :class:`OnesideMiss`/:class:`OnesideGone` when the
    caller should take the RPC path instead."""

    def __init__(self, handle):
        self._L = _bind_tensor_api(lib())
        self._h = handle

    @classmethod
    def map(cls, desc: dict) -> Optional["OnesideReader"]:
        """Map from a window descriptor; None means stay on the RPC path
        (off-host shm name, stale token, full reader table)."""
        L = _bind_tensor_api(lib())
        try:
            h = L.tbrpc_oneside_map(str(desc["shm"]).encode(),
                                    int(desc["bytes"]),
                                    int(desc["dir_off"]),
                                    int(desc["token"]))
        except (KeyError, TypeError, ValueError):
            return None
        return cls(h) if h else None

    def read(self, name: str) -> Tuple[int, bytes]:
        """-> (version, payload bytes) of the committed publication."""
        version, arr = self.read_np(name)
        return version, arr.tobytes()

    def read_np(self, name: str) -> Tuple[int, np.ndarray]:
        """-> (version, OWNED uint8 ndarray): stat for the size, then one
        native copy into a 64-byte-aligned buffer the caller owns (nothing
        ever rewrites it, so decode may view it in place)."""
        if not self._h:
            raise OnesideGone(name, 3)
        nbytes = ctypes.c_uint64()
        version = ctypes.c_uint64()
        rc = self._L.tbrpc_oneside_stat(self._h, name.encode(),
                                        ctypes.byref(nbytes),
                                        ctypes.byref(version))
        # A republish between stat and read_into may grow the payload:
        # read_into answers TOO_SMALL (4) with the size it needs — retry.
        for _ in range(8):
            if rc not in (0, 4):
                break
            need = nbytes.value
            backing = np.empty(need + 64, np.uint8)
            shift = (-backing.ctypes.data) % 64
            arr = backing[shift:shift + need]
            rc = self._L.tbrpc_oneside_read_into(
                self._h, name.encode(),
                ctypes.c_void_p(backing.ctypes.data + shift), need,
                ctypes.byref(nbytes), ctypes.byref(version))
            if rc == 0:
                return int(version.value), arr
        if rc == 3:
            raise OnesideGone(name, rc)
        raise OnesideMiss(name, rc)

    def close(self) -> None:
        if self._h:
            self._L.tbrpc_oneside_unmap(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def consume_oneside_payload(payload, device=None,
                            note_name: Optional[str] = None):
    """Decode one one-sided payload — the self-describing ``[u32
    meta-len|meta JSON|bytes]`` framing the Pull RPC ships, raw or
    quantized, so the two paths cannot return different values for one
    committed version. Returns a tensor on ``device`` (default CUDA). A
    quantized payload crosses as codes and scales and the dequantize
    kernel widens it on the device.

    ``payload`` is ``bytes`` (copied once) or an OWNED uint8 ndarray
    (:meth:`OnesideReader.read_np`), whose buffer nothing rewrites: the
    raw branch views it in place."""
    owned = isinstance(payload, np.ndarray)
    if owned:
        (n,) = struct.unpack("<I", payload[:4].tobytes())
        meta = json.loads(payload[4:4 + n].tobytes().decode())
        u8 = payload[4 + n:]
    else:
        meta, rest = _decode_meta_ex(payload)
        # bytes are read-only: one copy makes them a buffer of our own.
        u8 = np.frombuffer(rest, dtype=np.uint8).copy()
    if "codec" in meta:
        from brpc_tpu_torch.runtime import codec as codec_mod

        if note_name is not None:
            nbytes = int(np.prod(meta["shape"], dtype=np.int64)
                         ) * np.dtype(meta["dtype"]).itemsize
            codec_mod.note(note_name, meta["codec"], nbytes, int(u8.nbytes))
        with _stage("dequant"):
            return _dequant_put_from_view(meta, u8, resolve_device(device),
                                          codec_mod)
    arr = u8.view(np.dtype(meta["dtype"])).reshape(tuple(meta["shape"]))
    dev = resolve_device(device)
    with _stage("device_put"):
        t = torch.from_numpy(arr)
        # The owned buffer outlives the tensor and is never rewritten, so
        # a CPU target keeps it; a CUDA target copies (blocking H2D).
        return t if dev.type == "cpu" else t.to(dev)


class TensorView:
    """A zero-copy window onto a received tensor (the peer's arena pages
    or the connection's RX segment). ``release()`` lets the sender reuse
    the range — call it (or use as a context manager) once consumed."""

    def __init__(self, L, view_handle, ptr, nbytes, copied: bool):
        self._L = L
        self._view = view_handle
        self._ptr = ptr
        self._copied = copied
        self.nbytes = nbytes

    def ndarray(self) -> np.ndarray:
        if not self.nbytes or not self._ptr:
            return np.empty(0, dtype=np.uint8)
        buf = (ctypes.c_uint8 * self.nbytes).from_address(self._ptr)
        return np.ctypeslib.as_array(buf)

    @property
    def zero_copy(self) -> bool:
        """True when the bytes are the sender's pages, not a copy."""
        return not self._copied

    def release(self) -> None:
        if self._view:
            self._L.tbrpc_view_free(self._view)
            self._view = None
        elif self._copied and self._ptr:
            self._L.tbrpc_free(self._ptr)
        self._ptr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()

    def __del__(self):
        try:
            self.release()
        except Exception:  # noqa: BLE001
            pass


def consume_pull_reply(payload: bytes, view: TensorView,
                       device: torch.device,
                       note_name: Optional[str] = None):
    """Decode a pulled-tensor reply onto ``device`` straight from the
    zero-copy view, then release the view. Returns ``(rest_of_payload,
    tensor, logical_nbytes)``. A header with codec fields takes the
    dequantize path (the codes cross, the kernel widens)."""
    with view:
        meta, rest = _decode_meta_ex(payload)
        if "codec" in meta:
            from brpc_tpu_torch.runtime import codec as codec_mod

            nbytes = int(np.prod(meta["shape"], dtype=np.int64)
                         ) * np.dtype(meta["dtype"]).itemsize
            if note_name is not None:
                codec_mod.note(note_name, meta["codec"], nbytes,
                               int(view.nbytes))
            with _stage("dequant"):
                try:
                    dev = _dequant_put_from_view(meta, view.ndarray(),
                                                 device, codec_mod)
                except ValueError as ve:
                    # Corrupt/truncated quantized reply: the structural
                    # app code, so pull_all's partial salvage engages.
                    raise RpcError(
                        E_UNDECODABLE,
                        f"undecodable tensor payload: {ve}") from ve
        else:
            arr = view.ndarray().view(np.dtype(meta["dtype"])).reshape(
                tuple(meta["shape"]))
            nbytes = view.nbytes
            with _stage("device_put"):
                dev = _device_put_from_view(arr, device)
    return rest, dev, nbytes


class TensorFuture:
    """One in-flight async tensor RPC (``TensorChannel.call_async``).
    ``result()`` parks until the response arrives and returns ``(payload,
    TensorView)``; results are cached on first take, so repeated calls
    return the same objects, and the future outlives its channel.
    ``cancel()`` ends an in-flight RPC with ECANCELED; ``close()`` (or GC)
    on a never-waited future cancels it and lets the native side release
    the response exactly once."""

    def __init__(self, L, handle, service_method, done_cb=None):
        self._L = L
        self._h = handle
        self._method = service_method
        self._cb = done_cb  # the ctypes trampoline must outlive the RPC
        self._payload = None
        self._view: Optional[TensorView] = None
        self._error: Optional[RpcError] = None
        self._taken = False

    def done(self) -> bool:
        """Non-blocking completion probe (a ready result moves into the
        cache)."""
        return self._taken or self._poll(0)

    def result(self, timeout_ms: int = -1) -> Tuple[bytes, TensorView]:
        """Wait for completion -> (payload, view). ``timeout_ms >= 0``
        raises TimeoutError if the call is still in flight (nothing is
        consumed: retry later); an RPC failure raises RpcError."""
        if not self._taken and not self._poll(timeout_ms):
            raise TimeoutError(
                f"{self._method}: still in flight after {timeout_ms}ms")
        if self._error is not None:
            raise self._error
        return self._payload, self._view

    def _poll(self, timeout_ms: int) -> bool:
        if not self._h:
            raise RuntimeError("future is closed")
        L = self._L
        resp = ctypes.c_void_p()
        resp_len = ctypes.c_size_t()
        view = ctypes.c_void_p()
        ratt = ctypes.c_void_p()
        ratt_len = ctypes.c_size_t()
        copied = ctypes.c_int()
        errbuf = ctypes.create_string_buffer(256)
        outs = (ctypes.byref(resp), ctypes.byref(resp_len),
                ctypes.byref(view), ctypes.byref(ratt),
                ctypes.byref(ratt_len), ctypes.byref(copied),
                errbuf, len(errbuf))
        if timeout_ms < 0:
            rc = L.tbrpc_future_wait(self._h, *outs)
        else:
            rc = L.tbrpc_future_timed_wait(self._h, timeout_ms, *outs)
            if rc == -1:
                return False  # still in flight; nothing consumed
        self._taken = True
        if rc != 0:
            self._error = RpcError(rc, errbuf.value.decode(errors="replace"))
        else:
            try:
                self._payload = (ctypes.string_at(resp, resp_len.value)
                                 if resp_len.value else b"")
            finally:
                L.tbrpc_free(resp)
            self._view = TensorView(L, view.value, ratt.value,
                                    ratt_len.value, bool(copied.value))
        self.close()  # ownership is out; the native box is spent
        return True

    def cancel(self) -> None:
        """Cancel an in-flight RPC (a later ``result()`` raises ECANCELED);
        a completed but unconsumed response is released now, once."""
        if self._h and not self._taken:
            self._L.tbrpc_future_cancel(self._h)

    def close(self) -> None:
        """Release the native future (idempotent); in flight: cancels."""
        if self._h:
            self._L.tbrpc_future_destroy(self._h)
            self._h = None
            # The notification trampoline unanchors itself when it fires;
            # dropping this reference is enough.
            self._cb = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class PipelineWindow:
    """Bounded-window pipelining over one ``TensorChannel``: up to
    ``window`` tensor RPCs in flight, so staging of tensor k+1 overlaps
    the wire of tensor k. Submission order == delivery order; each arena
    range is freed as its RPC completes. Replies go to ``on_reply(tag,
    payload, view)`` on the submitting thread, or — without it — are
    collected by ``flush()``. A call's ``RpcError`` aborts the window
    (every call still in flight is cancelled) unless ``on_error(tag,
    err)`` is given: then it takes the error and the other calls go on —
    what a caller needs whose calls are not idempotent, since a cancelled
    call may have been applied."""

    def __init__(self, channel: "TensorChannel", window: int = 4,
                 on_reply: Optional[Callable] = None,
                 on_error: Optional[Callable] = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.channel = channel
        self.window = window
        self.on_reply = on_reply
        self.on_error = on_error
        self._q: deque = deque()  # (tag, future, arena_off, arena_len)
        # Guards taking the oldest call: a submitting thread and a
        # draining one may complete calls at once, each its own.
        self._mu = threading.Lock()
        self._results: list = []
        _pipeline_gauge()

    def inflight(self) -> int:
        return len(self._q)

    def complete_one(self) -> bool:
        """Drain the OLDEST in-flight call only (its reply goes through
        ``on_reply`` or to the collected results); False when nothing is
        in flight. The step driver's per-tensor confirm point: ``opt:k``
        drains exactly until push k's reply lands instead of flushing the
        whole window. A failure carries its call's tag as
        ``e.pipeline_tag``."""
        with self._mu:
            if not self._q:
                return False
            entry = self._q.popleft()
        self._complete(entry)
        return True

    def submit(self, service_method: str, array=None, request: bytes = b"",
               tag=None, encoder=None) -> None:
        """Stage ``array`` (optional) into the channel arena and start the
        RPC; blocks only while the window is full. ``encoder(host) ->
        (wire_uint8, header_bytes) | None`` quantizes at stage time; None
        rides raw."""
        while len(self._q) >= self.window:
            self.complete_one()
        off = length = 0
        if array is not None:
            with _stage("arena_stage"):
                enc = None
                if encoder is not None:
                    array = _as_host_array(array)
                    enc = encoder(array)
                if enc is None:
                    off, length, host = self.channel.arena.place(array)
                    request = _encode_meta(host) + request
                else:
                    wire, header = enc
                    off, length, _ = self.channel.arena.place(wire)
                    request = header + request
        try:
            fut = self.channel.call_async(service_method, request, off,
                                          length)
        except Exception:
            if length:
                self.channel.arena.free(off)
            raise
        _pipeline_inflight_add(1)
        self._q.append((tag, fut, off, length))

    def _complete(self, entry) -> None:
        # Failures carry the failed call's tag as ``e.pipeline_tag`` so
        # callers can attribute them per tensor.
        tag, fut, off, length = entry
        try:
            try:
                with _stage("wire_wait"):
                    payload, view = fut.result()
            except RpcError as e:
                if self.on_error is None:
                    raise
                self.on_error(tag, e)
                return
            finally:
                _pipeline_inflight_add(-1)
                if length:
                    self.channel.arena.free(off)  # freed as refs drain
            if self.on_reply is not None:
                try:
                    self.on_reply(tag, payload, view)
                except Exception:
                    view.release()  # else the PEER's range never drains
                    raise
            else:
                self._results.append((tag, payload, view))
        except Exception as e:  # noqa: BLE001 — annotate and re-raise
            e.pipeline_tag = tag
            raise

    def flush(self) -> list:
        while self.complete_one():
            pass
        out, self._results = self._results, []
        return out

    def abort(self) -> None:
        """Error-path teardown: cancel and release everything in flight."""
        while self._q:
            _tag, fut, off, length = self._q.popleft()
            _pipeline_inflight_add(-1)
            try:
                fut.cancel()
                fut.close()
            finally:
                if length:
                    self.channel.arena.free(off)
        for _tag, _payload, view in self._results:
            view.release()
        self._results = []

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *_exc):
        if exc_type is None:
            self.flush()
        else:
            self.abort()


class TensorChannel:
    """Client stub for tensor traffic: a ``tpu://`` channel plus a local
    arena the outbound tensors stage through."""

    def __init__(self, addr: str, arena: Optional[TensorArena] = None,
                 timeout_ms: int = 20000, max_retry: int = 0):
        self._L = _bind_tensor_api(lib())
        if "://" not in addr:
            addr = "tpu://" + addr
        self._h = self._L.tbrpc_channel_create(addr.encode(), timeout_ms,
                                               max_retry)
        if not self._h:
            raise RuntimeError(f"tensor channel init to {addr} failed")
        self.timeout_ms = timeout_ms  # each call's deadline, retries included
        native._LIVE_CHANNELS.add(self)
        self.arena = arena if arena is not None else TensorArena(256 << 20)

    def call_raw(self, service_method: str, request: bytes,
                 att_off: int = 0, att_len: int = 0
                 ) -> Tuple[bytes, TensorView]:
        """One RPC: request bytes + an arena range as the attachment."""
        if not self._h:
            raise RuntimeError("tensor channel is closed")
        L = self._L
        resp = ctypes.c_void_p()
        resp_len = ctypes.c_size_t()
        view = ctypes.c_void_p()
        ratt = ctypes.c_void_p()
        ratt_len = ctypes.c_size_t()
        copied = ctypes.c_int()
        errbuf = ctypes.create_string_buffer(256)
        rc = L.tbrpc_call_tensor(
            self._h, service_method.encode(), request, len(request),
            self.arena.handle if att_len else None, att_off, att_len,
            ctypes.byref(resp), ctypes.byref(resp_len), ctypes.byref(view),
            ctypes.byref(ratt), ctypes.byref(ratt_len), ctypes.byref(copied),
            errbuf, len(errbuf))
        if rc != 0:
            raise RpcError(rc, errbuf.value.decode(errors="replace"))
        try:
            payload = (ctypes.string_at(resp, resp_len.value)
                       if resp_len.value else b"")
        finally:
            L.tbrpc_free(resp)
        return payload, TensorView(L, view.value, ratt.value, ratt_len.value,
                                   bool(copied.value))

    def call_async(self, service_method: str, request: bytes = b"",
                   att_off: int = 0, att_len: int = 0,
                   on_done: Optional[Callable[[int], None]] = None
                   ) -> TensorFuture:
        """Submit one RPC without blocking. The arena range takes its local
        reference before this returns, so ``arena.free`` any time after
        submission is safe. ``on_done(status)`` (optional) fires on a
        callback-pool pthread before the future becomes waitable — a
        notification hook; take the result with ``future.result()``, never
        inside the hook."""
        if not self._h:
            raise RuntimeError("tensor channel is closed")
        cb = ctypes.cast(None, _TENSOR_DONE_CB)  # NULL: no hook
        if on_done is not None:
            def notify(_ctx, status, *_rest):
                try:
                    on_done(status)
                except Exception:  # noqa: BLE001 — a notification hook
                    pass           # must not unwind into the pool thread
                finally:
                    try:
                        _live_done_cbs.remove(cb)
                    except ValueError:
                        pass

            cb = _TENSOR_DONE_CB(notify)
            _live_done_cbs.append(cb)
        h = self._L.tbrpc_call_tensor_async(
            self._h, service_method.encode(), request, len(request),
            self.arena.handle if att_len else None, att_off, att_len,
            cb, None)
        if not h:
            raise RpcError(native.TRPC_EINTERNAL,
                           f"async submit of {service_method} failed")
        return TensorFuture(self._L, h, service_method, done_cb=cb)

    def call(self, service_method: str, array=None, request: bytes = b""
             ) -> Tuple[bytes, Optional[np.ndarray]]:
        """Send a tensor (or nothing), receive a detached host ndarray
        (or nothing)."""
        off = length = 0
        if array is not None:
            off, length, host = self.place_with_meta(array)
            request = _encode_meta(host) + request
        try:
            payload, view = self.call_raw(service_method, request, off,
                                          length)
        finally:
            if length:
                self.arena.free(off)  # deferred until releases drain
        with view:
            if view.nbytes == 0:
                return payload, None
            meta, rest = _decode_meta_ex(payload)
            if "codec" in meta:
                from brpc_tpu_torch.runtime import codec as codec_mod

                return rest, codec_mod.decode(meta, view.ndarray())
            arr = view.ndarray().view(np.dtype(meta["dtype"])).reshape(
                tuple(meta["shape"]))
            return rest, np.array(arr)  # detach before releasing the view

    def place_with_meta(self, array) -> Tuple[int, int, np.ndarray]:
        """Stage ``array`` into this channel's arena -> (offset, length,
        host array whose ``_encode_meta`` header describes the bytes)."""
        return self.arena.place(array)

    def pull_device(self, service_method: str, request: bytes,
                    device: torch.device, note_name: Optional[str] = None):
        """Fetch a tensor onto ``device`` STRAIGHT from the received view,
        then release the view. Returns (rest_of_payload, tensor)."""
        t0 = time.monotonic()
        with _stage("rpc"):
            payload, view = self.call_raw(service_method, request)
        rest, dev, nbytes = consume_pull_reply(payload, view, device,
                                               note_name=note_name)
        m = _metrics()
        m["pull"].record_s(time.monotonic() - t0)
        m["pull_bytes"].add(nbytes)
        return rest, dev

    def push_device(self, service_method: str, array,
                    request: bytes = b"", encoder=None) -> bytes:
        """Send a tensor (D2H into the arena, by reference on the wire) and
        wait for the reply. ``encoder`` is ``PipelineWindow.submit``'s
        per-tensor hook."""
        t0 = time.monotonic()
        with _stage("arena_stage"):
            enc = None
            if encoder is not None:
                array = _as_host_array(array)
                enc = encoder(array)
            if enc is None:
                off, length, host = self.arena.place(array)
                header = _encode_meta(host)
            else:
                wire, header = enc
                off, length, _ = self.arena.place(wire)
        try:
            with _stage("rpc"):
                payload, view = self.call_raw(
                    service_method, header + request, off, length)
            view.release()
            m = _metrics()
            m["push"].record_s(time.monotonic() - t0)
            m["push_bytes"].add(length)
            return payload
        finally:
            if length:
                self.arena.free(off)

    def close(self) -> None:
        if self._h:
            self._L.tbrpc_channel_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


# Handler: (method, request_bytes, attachment: ndarray view | QuantizedView
#   | None) -> (response_bytes, response tensor/array/WireTensor | None)
TensorHandler = Callable[[str, bytes, Optional[object]],
                         Tuple[bytes, Optional[object]]]


def add_tensor_service(server: native.Server, name: str,
                       handler: TensorHandler,
                       arena: Optional[TensorArena] = None,
                       device_ctx: Callable[[], object] = (
                           contextlib.nullcontext)) -> TensorArena:
    """Host a tensor service on a native Server: the handler reads request
    tensors IN PLACE (a numpy view of the sender's pages) and returns
    response tensors through the service's own arena (by reference on the
    wire). Returns that arena. ``device_ctx()`` is entered around the
    handler and the staging of its response (a server's CUDA stream), so
    every copy and kernel of one request runs inside it."""
    L = _bind_tensor_api(lib())
    srv_arena = arena if arena is not None else TensorArena(256 << 20)

    def trampoline(ctx, method, req, req_len, att, att_len,
                   resp, resp_len, resp_arena, resp_off, resp_att_len,
                   resp_autofree, error_code, err_text, err_text_cap):
        t0 = time.monotonic()
        try:
            request = ctypes.string_at(req, req_len) if req_len else b""
            att_view = None
            if att_len:
                buf = (ctypes.c_uint8 * att_len).from_address(att)
                att_view = np.ctypeslib.as_array(buf)
                if len(request) >= 4:
                    # Typed sends prefix the payload with their header.
                    meta = None
                    try:
                        meta, request = _decode_meta_ex(request)
                    except Exception:  # noqa: BLE001 — raw-byte sender
                        pass
                    # A decoded header that does not fit the payload is an
                    # undecodable typed send: answer a clean error, never
                    # hand the handler the flat wire bytes.
                    if meta is not None:
                        try:
                            if "codec" in meta:
                                from brpc_tpu_torch.runtime import (
                                    codec as codec_mod)

                                att_view = codec_mod.QuantizedView(
                                    meta, att_view)
                            else:
                                att_view = att_view.view(
                                    np.dtype(meta["dtype"])).reshape(
                                        tuple(meta["shape"]))
                        except Exception as e:  # noqa: BLE001
                            raise RpcError(
                                E_UNDECODABLE,
                                f"undecodable tensor payload "
                                f"(meta={meta!r}): {e}") from e
            with device_ctx():
                r, out_arr = handler(method.decode(), request, att_view)
                off = nbytes = 0
                if isinstance(out_arr, WireTensor):
                    # Pre-encoded response: stage the bytes, send its
                    # header.
                    if out_arr.placed is not None:
                        off, nbytes = out_arr.placed
                    else:
                        off, nbytes, _ = srv_arena.place(out_arr.data)
                    r = out_arr.header + r
                elif out_arr is not None:
                    off, nbytes, host = srv_arena.place(out_arr)
                    r = _encode_meta(host) + r
            if nbytes:
                resp_arena[0] = srv_arena.handle
                resp_off[0] = off
                resp_att_len[0] = nbytes
                # Autofree: the C side frees AFTER taking the response
                # ref, so the range returns once the client releases.
                resp_autofree[0] = 1
            if r:
                buf = L.tbrpc_alloc(len(r))
                ctypes.memmove(buf, r, len(r))
                resp[0] = buf
                resp_len[0] = len(r)
        except RpcError as e:
            error_code[0] = e.code if e.code != 0 \
                else native.TRPC_EINTERNAL
            fill_err_text(err_text, err_text_cap, e.text)
        except Exception as e:  # noqa: BLE001 — handler bug => EINTERNAL
            error_code[0] = native.TRPC_EINTERNAL
            fill_err_text(err_text, err_text_cap, f"{type(e).__name__}: {e}")
        finally:
            _metrics()["serve"].record_s(time.monotonic() - t0)

    cb = _TENSOR_CB(trampoline)
    server._cbs.append(cb)  # keep alive with the server
    if L.tbrpc_server_add_tensor_service(
            server._h, name.encode(), cb, None) != 0:
        raise RuntimeError(f"add_tensor_service({name}) failed")
    return srv_arena
