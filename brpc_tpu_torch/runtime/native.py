"""ctypes bindings over the native C API (native/capi/capi.h).

The port's own copy of the binding the parameter-server path uses: the
native ``Server``/``Channel`` objects, ``RpcError`` and the transport error
codes, the ambient QoS scope, and ``lib()``, which loads — building on
demand — a ``libbrpc_tpu.so`` that links libstdc++ dynamically, as torch
needs. Handlers run on the native side's dedicated callback pthreads, never
on a fiber (ctypes pairs its GIL state on one OS thread).

Which library, and the build rule (``library_path``):

- ``native/build/libbrpc_tpu.so``, the JAX package's, whenever it links
  libstdc++ dynamically: one copy of the runtime per process, shared with
  the JAX package in the parity tests. The port never overwrites it and
  never passes a compiler into its tree. Where that library is missing
  and cmake+ninja are present, the port configures the tree with exactly
  the JAX package's arguments (so a cache either package wrote stays as
  it is) and builds the library target, as a JAX-package process would.
- else ``native/build_torch/libbrpc_tpu.so``, built with ``g++`` (every
  ``native/{tbutil,tbthread,tbvar,trpc,ttpu,capi}`` source compiled in
  parallel, one process per core, then linked), for a tree whose library
  does not link libstdc++ dynamically (a toolchain that links its own
  libstdc++ statically yields iostreams that crash once torch is loaded)
  or for hosts without cmake+ninja. It is stamped with the hash of those
  sources and rebuilt when they change.

The port's configure, builds and install run under an inter-process lock
on ``native/build.lock``, and the ``g++`` copy is installed with
``os.replace``, so two port processes at first use never build at once
nor load a half-written file. The JAX package's processes do not take
that lock; against them the port is one more JAX-package process.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import glob
import os
import re
import shutil
import subprocess
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

from brpc_tpu_torch.utils.build import (file_lock, read_stamp, source_digest,
                                        write_stamp)

# Request priority lanes (native/trpc/qos.h): HIGH is the control plane,
# BULK is tensor pull/push, NORMAL the unmarked default.
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_BULK = 2

# Transport/framework error codes — mirror of native/trpc/errno.h.
TRPC_ENOSERVICE = 1001      # no such service
TRPC_ENOMETHOD = 1002       # no such method
TRPC_EREQUEST = 1003        # malformed request
TRPC_ERESPONSE = 1005       # malformed response
TRPC_ERPCTIMEDOUT = 1008    # RPC deadline exceeded
TRPC_ELIMIT = 1011          # concurrency limit rejected the request
TRPC_ECANCELED = 1012       # RPC canceled by caller
TRPC_EEOF = 2001            # peer closed the connection
TRPC_EFAILEDSOCKET = 2002   # the socket was SetFailed while in use
TRPC_EINTERNAL = 2004       # server internal error
TRPC_EOVERCROWDED = 2006    # write queue over the in-flight cap
TRPC_ECONNECT = 2007        # connect failed

# The connection-killed subset (the client's QoS self-heal keys on it).
TRANSPORT_DEAD = (TRPC_EEOF, TRPC_EFAILEDSOCKET, TRPC_ECONNECT)

_RETRY_AFTER_RE = re.compile(r"retry_after_ms=(\d+)")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# The JAX package's build tree and library (never overwritten here).
_BUILD_DIR = os.path.join(_REPO, "native", "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libbrpc_tpu.so")
# The port's own g++ copy, where the JAX package's cannot sit beside torch.
_TORCH_BUILD_DIR = os.path.join(_REPO, "native", "build_torch")
_TORCH_LIB_PATH = os.path.join(_TORCH_BUILD_DIR, "libbrpc_tpu.so")
_LOCK_PATH = os.path.join(_REPO, "native", "build.lock")
_NATIVE_DIRS = ("tbutil", "tbthread", "tbvar", "trpc", "ttpu", "capi")
_CXXFLAGS = ["-std=c++20", "-O2", "-fPIC", "-fno-omit-frame-pointer",
             "-DNDEBUG"]

# PassiveStatus gauge callback: ctx -> current int64 value.
_GAUGE_CB = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p)


def fill_err_text(err_text: int, err_text_cap: int, message: str) -> None:
    """Copy a handler failure message into the C-owned err_text buffer
    (NUL-terminated, truncated to cap-1); it rides back to the client's
    ``RpcError.text``."""
    if not err_text or err_text_cap <= 1 or not message:
        return
    data = message.encode("utf-8", errors="replace")[:err_text_cap - 1]
    ctypes.memmove(err_text, data, len(data))
    ctypes.memset(err_text + len(data), 0, 1)


_lib = None
_lib_mu = threading.Lock()

# Channels and servers still open at interpreter exit are closed by one
# atexit hook (channels first), before module teardown: destroying a
# channel to a live in-process server during finalization aborts in glibc.
_LIVE_CHANNELS: "weakref.WeakSet" = weakref.WeakSet()
_LIVE_SERVERS: "weakref.WeakSet" = weakref.WeakSet()


def _teardown_native_handles() -> None:
    for ch in list(_LIVE_CHANNELS):
        try:
            ch.close()
        except Exception:  # noqa: BLE001 — best-effort exit hygiene
            pass
    for srv in list(_LIVE_SERVERS):
        try:
            srv.close()
        except Exception:  # noqa: BLE001
            pass


def _zlib_link_args() -> list:
    """``-lz``, or the runtime ``libz.so.1`` by path on hosts that ship
    the library without its development symlink."""
    probe = subprocess.run(  # tpulint: allow(py-blocking)
        ["g++", "-shared", "-o", os.devnull, "-x", "c++", "-", "-lz"],
        input=b"", capture_output=True)
    if probe.returncode == 0:
        return ["-lz"]
    for cand in ("/lib/x86_64-linux-gnu/libz.so.1",
                 "/usr/lib/x86_64-linux-gnu/libz.so.1",
                 "/usr/lib64/libz.so.1", "/lib64/libz.so.1"):
        if os.path.exists(cand):
            return [cand]
    return ["-lz"]  # let the link report what is missing


def _native_sources() -> list:
    """Every source and header the ``g++`` copy is built from."""
    out = []
    for d in _NATIVE_DIRS:
        for ext in ("*.cpp", "*.S", "*.h"):
            out += glob.glob(os.path.join(_REPO, "native", d, ext))
    return sorted(out)


def _build_native_gxx() -> None:
    """Compile every native source with g++ in parallel, link, and install
    ``native/build_torch/libbrpc_tpu.so`` atomically."""
    obj_dir = os.path.join(_TORCH_BUILD_DIR, "obj")
    os.makedirs(obj_dir, exist_ok=True)
    srcs = [s for s in _native_sources() if not s.endswith(".h")]

    def compile_one(src: str) -> str:
        rel = os.path.relpath(src, os.path.join(_REPO, "native"))
        obj = os.path.join(obj_dir, rel.replace(os.sep, "_") + ".o")
        cmd = ["g++", *_CXXFLAGS, "-I" + os.path.join(_REPO, "native"),
               "-c", src, "-o", obj]
        r = subprocess.run(cmd, capture_output=True)  # tpulint: allow(py-blocking)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {rel}:\n"
                               + r.stderr.decode(errors="replace")[-4000:])
        return obj

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as pool:
        objs = list(pool.map(compile_one, srcs))
    tmp = _TORCH_LIB_PATH + f".tmp{os.getpid()}"
    cmd = ["g++", "-shared", "-o", tmp, *objs, "-lpthread", "-lrt",
           *_zlib_link_args(), "-ldl"]
    r = subprocess.run(cmd, capture_output=True)  # tpulint: allow(py-blocking)
    if r.returncode != 0:
        raise RuntimeError("linking libbrpc_tpu.so failed:\n"
                           + r.stderr.decode(errors="replace")[-4000:])
    os.replace(tmp, _TORCH_LIB_PATH)


def _gxx_copy() -> str:
    """``native/build_torch/libbrpc_tpu.so``, rebuilt when missing or when
    the native sources no longer match its stamp."""
    digest = source_digest(_REPO, _native_sources(), _CXXFLAGS)
    stamp = os.path.join(_TORCH_BUILD_DIR, "sources.sha256")
    if not os.path.exists(_TORCH_LIB_PATH) or read_stamp(stamp) != digest:
        _build_native_gxx()
        write_stamp(stamp, digest)
    return _TORCH_LIB_PATH


def configure_command(build_dir: str = _BUILD_DIR) -> list:
    """The cmake configure of ``build_dir``: the JAX package's arguments
    and no others. A compiler other than the one in an existing cache
    would make cmake delete that cache and regenerate the tree under the
    JAX package's processes."""
    return ["cmake", "-S", "native", "-B", build_dir, "-G", "Ninja",
            "-DCMAKE_BUILD_TYPE=RelWithDebInfo"]


def _have_cmake() -> bool:
    return bool(shutil.which("cmake") and shutil.which("ninja"))


def build_cmake_library() -> None:
    """Where ``native/build/libbrpc_tpu.so`` is missing and cmake+ninja
    are present, configure ``native/build/`` with the JAX package's
    arguments and build its ``brpc_tpu`` target. Call under the build lock
    (``native/build.lock``); raises ``subprocess.CalledProcessError``, with
    the build's output, when a step fails."""
    if os.path.exists(_LIB_PATH) or not _have_cmake():
        return
    subprocess.run(configure_command(_BUILD_DIR), cwd=_REPO,  # tpulint: allow(py-blocking)
                   check=True, capture_output=True)
    subprocess.run(  # tpulint: allow(py-blocking)
        ["cmake", "--build", _BUILD_DIR, "--target", "brpc_tpu"],
        cwd=_REPO, check=True, capture_output=True)


def _resolve_library() -> str:
    """The library to load (see the module docstring), building what is
    missing. Call under the build lock."""
    build_cmake_library()
    if os.path.exists(_LIB_PATH) and links_shared_libstdcxx(_LIB_PATH):
        return _LIB_PATH
    return _gxx_copy()


def library_path() -> str:
    """Path of the ``libbrpc_tpu.so`` the port loads, built first if
    needed. Runs at the first ``lib()`` call, before any server, channel
    or fiber exists."""
    with file_lock(_LOCK_PATH):
        return _resolve_library()


def lib() -> ctypes.CDLL:
    """Loads (building on demand) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_mu:
        if _lib is None:
            _lib = _load()
    return _lib


def links_shared_libstdcxx(path: str) -> bool:
    """True if ``path`` loads libstdc++ dynamically (a DT_NEEDED entry), so
    it shares torch's copy in one process."""
    r = subprocess.run(["readelf", "-d", path], capture_output=True,  # tpulint: allow(py-blocking)
                       text=True, check=True)
    return "[libstdc++.so.6]" in r.stdout


def refuse_second_copy(path: str, maps: str = "/proc/self/maps") -> None:
    """Raise if another file's ``libbrpc_tpu.so`` is already mapped into
    this process. Two copies of the runtime name their shared-memory
    segments alike (the pid and a counter of their own), so a tensor one
    copy sends by reference can be read from the other copy's segment."""
    mine = os.path.realpath(path)
    try:
        with open(maps) as f:
            mapped = {line.split()[-1] for line in f
                      if line.rstrip().endswith("/libbrpc_tpu.so")}
    except OSError:
        return  # no /proc: nothing to compare against
    others = sorted(p for p in mapped if os.path.realpath(p) != mine)
    if others:
        raise RuntimeError(
            f"{others[0]} is already loaded in this process; a second copy "
            f"({path}) would reuse its shared-memory segment names. Load "
            "the port in a process of its own.")


def _load() -> ctypes.CDLL:
    path = library_path()
    refuse_second_copy(path)
    L = ctypes.CDLL(path)
    if not hasattr(L, "tbrpc_registry_install"):
        raise RuntimeError(
            f"{path} predates the current C API; delete it and let "
            "the next process rebuild it")
    L.tbrpc_server_create.restype = ctypes.c_void_p
    L.tbrpc_server_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    L.tbrpc_server_stop.argtypes = [ctypes.c_void_p]
    L.tbrpc_server_destroy.argtypes = [ctypes.c_void_p]
    L.tbrpc_channel_create.restype = ctypes.c_void_p
    L.tbrpc_channel_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    L.tbrpc_channel_destroy.argtypes = [ctypes.c_void_p]
    L.tbrpc_call.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_alloc.restype = ctypes.c_void_p
    L.tbrpc_alloc.argtypes = [ctypes.c_size_t]
    L.tbrpc_free.argtypes = [ctypes.c_void_p]
    # ---- observability: metrics + tracing (capi.h) ----
    L.tbrpc_var_adder_create.restype = ctypes.c_void_p
    L.tbrpc_var_adder_create.argtypes = [ctypes.c_char_p]
    L.tbrpc_var_adder_add.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    L.tbrpc_var_adder_value.restype = ctypes.c_int64
    L.tbrpc_var_adder_value.argtypes = [ctypes.c_void_p]
    L.tbrpc_var_latency_create.restype = ctypes.c_void_p
    L.tbrpc_var_latency_create.argtypes = [ctypes.c_char_p]
    L.tbrpc_var_latency_record.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    L.tbrpc_var_gauge_create.restype = ctypes.c_void_p
    L.tbrpc_var_gauge_create.argtypes = [
        ctypes.c_char_p, _GAUGE_CB, ctypes.c_void_p]
    L.tbrpc_vars_dump.restype = ctypes.c_int64
    L.tbrpc_vars_dump.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_debug_dump_ici.restype = ctypes.c_int64
    L.tbrpc_debug_dump_ici.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_rpcz_enabled.restype = ctypes.c_int
    L.tbrpc_rpcz_set_enabled.argtypes = [ctypes.c_int]
    L.tbrpc_rpcz_sample_root.restype = ctypes.c_int
    L.tbrpc_rpcz_sample_root.argtypes = []
    L.tbrpc_trace_new_id.restype = ctypes.c_uint64
    L.tbrpc_trace_current.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    L.tbrpc_trace_set.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    L.tbrpc_span_annotate.argtypes = [ctypes.c_char_p]
    L.tbrpc_span_emit.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_char_p]
    L.tbrpc_now_us.restype = ctypes.c_int64
    # Flight recorder + stall watchdog: callable from any plain thread
    # while every fiber worker is parked (observability/health.py).
    L.tbrpc_flight_snapshot.restype = ctypes.c_int64
    L.tbrpc_flight_snapshot.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_flight_total_events.restype = ctypes.c_int64
    L.tbrpc_watchdog_start.restype = ctypes.c_int
    L.tbrpc_watchdog_start.argtypes = [ctypes.c_char_p]
    L.tbrpc_watchdog_stop.restype = ctypes.c_int
    L.tbrpc_health_state.restype = ctypes.c_int
    L.tbrpc_health_dump_json.restype = ctypes.c_int64
    L.tbrpc_health_dump_json.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_health_last_dump_path.restype = ctypes.c_int64
    L.tbrpc_health_last_dump_path.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_flag_set.restype = ctypes.c_int
    L.tbrpc_flag_set.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    # The process-global service registry the fleet rides over HTTP
    # (fleet/registry.py); clear is test isolation.
    L.tbrpc_registry_install.restype = ctypes.c_int
    L.tbrpc_registry_install.argtypes = []
    L.tbrpc_registry_clear.restype = ctypes.c_int
    L.tbrpc_registry_clear.argtypes = []
    L.tbrpc_tensor_codec_note.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64]
    L.tbrpc_tensor_codec_note.restype = None
    # Overload protection: the ambient QoS slot (priority lane + tenant).
    L.tbrpc_qos_set.restype = ctypes.c_int
    L.tbrpc_qos_set.argtypes = [ctypes.c_int, ctypes.c_char_p]
    L.tbrpc_qos_get.restype = ctypes.c_int64
    L.tbrpc_qos_get.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_size_t]
    atexit.register(_teardown_native_handles)
    return L


@contextlib.contextmanager
def qos(priority: int = PRIORITY_NORMAL, tenant: str = ""):
    """Ambient QoS for calls issued inside the scope on THIS thread:
    requests stamp ``priority`` and ``tenant`` onto the wire. Exit
    restores the surrounding values. Raises ValueError for tenants over
    the 256-byte wire cap."""
    L = lib()
    prev_prio = ctypes.c_int()
    prev_tenant = ctypes.create_string_buffer(512)  # cap is 256
    L.tbrpc_qos_get(ctypes.byref(prev_prio), prev_tenant, len(prev_tenant))
    if L.tbrpc_qos_set(priority,
                       tenant.encode() if tenant else b"") != 0:
        raise ValueError(f"tenant id too long ({len(tenant)} bytes > 256)")
    try:
        yield
    finally:
        L.tbrpc_qos_set(prev_prio.value, prev_tenant.value)


def dump_ici() -> str:
    """Sender/receiver state of every live ``tpu://`` endpoint, one
    ``ici sock=... active=0|1 ...`` entry each — ``active=1`` means the
    connection upgraded to the shared-memory path (no HELLO-NACK)."""
    L = lib()
    n = L.tbrpc_debug_dump_ici(None, 0)
    buf = ctypes.create_string_buffer(int(n) + 1)
    L.tbrpc_debug_dump_ici(buf, int(n) + 1)
    return buf.value.decode(errors="replace")


class RpcError(Exception):
    def __init__(self, code: int, text: str = ""):
        overloaded = code in (TRPC_ELIMIT, TRPC_EOVERCROWDED)
        super().__init__(
            f"rpc error {code}"
            + (" (server overloaded — back off)" if overloaded else "")
            + f": {text}")
        self.code = code
        self.text = text
        # Shed responses carry a drain-time hint (" (retry_after_ms=N)").
        m = _RETRY_AFTER_RE.search(text) if text else None
        self.retry_after_ms: Optional[int] = int(m.group(1)) if m else None

    @property
    def overloaded(self) -> bool:
        """True for the overload-shed codes (ELIMIT / EOVERCROWDED)."""
        return self.code in (TRPC_ELIMIT, TRPC_EOVERCROWDED)


class Server:
    """A native RPC server hosting Python services."""

    def __init__(self):
        self._L = lib()
        self._h = self._L.tbrpc_server_create()
        self._cbs = []  # keep CFUNCTYPE objects alive
        self.port: Optional[int] = None
        _LIVE_SERVERS.add(self)

    def start(self, addr: str = "127.0.0.1:0") -> int:
        if not self._h:
            raise RuntimeError("server is closed")
        port = self._L.tbrpc_server_start(self._h, addr.encode())
        if port < 0:
            raise RuntimeError(f"server start on {addr} failed")
        self.port = port
        return port

    def stop(self) -> None:
        if self._h:
            self._L.tbrpc_server_stop(self._h)

    def close(self) -> None:
        """Stop and release the native server (idempotent)."""
        if self._h:
            self._L.tbrpc_server_stop(self._h)
            self._L.tbrpc_server_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class Channel:
    """Client stub to one server ("ip:port") for byte RPCs."""

    def __init__(self, addr: str, timeout_ms: int = 1000, max_retry: int = 3):
        self._L = lib()
        self._h = self._L.tbrpc_channel_create(addr.encode(), timeout_ms,
                                               max_retry)
        if not self._h:
            raise RuntimeError(f"channel init to {addr} failed")
        _LIVE_CHANNELS.add(self)

    def call(self, service_method: str, request: bytes = b"",
             attachment: bytes = b"") -> Tuple[bytes, bytes]:
        if not self._h:
            raise RuntimeError("channel is closed")
        L = self._L
        resp = ctypes.c_void_p()
        resp_len = ctypes.c_size_t()
        resp_att = ctypes.c_void_p()
        resp_att_len = ctypes.c_size_t()
        errbuf = ctypes.create_string_buffer(256)
        rc = L.tbrpc_call(
            self._h, service_method.encode(),
            request, len(request), attachment, len(attachment),
            ctypes.byref(resp), ctypes.byref(resp_len),
            ctypes.byref(resp_att), ctypes.byref(resp_att_len),
            errbuf, len(errbuf))
        if rc != 0:
            raise RpcError(rc, errbuf.value.decode(errors="replace"))
        try:
            r = ctypes.string_at(resp, resp_len.value) if resp_len.value else b""
            ra = (ctypes.string_at(resp_att, resp_att_len.value)
                  if resp_att_len.value else b"")
        finally:
            L.tbrpc_free(resp)
            L.tbrpc_free(resp_att)
        return r, ra

    def close(self) -> None:
        if self._h:
            self._L.tbrpc_channel_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
