"""ctypes bindings over the native C API (native/capi/capi.h).

The port's own copy of the binding its planes use: the native
``Server``/``Channel`` objects (byte services, the echo service, admission
settings and the per-tenant table, TLS, the gRPC client protocol),
``inject_latency`` and the loopback echo benchmarks, ``RpcError`` and the
transport error codes, the ambient QoS scope and the request deadline, the
credit-windowed ``Stream`` the serving plane's token streams ride, the
``/sessionz`` provider slot, the HTTP progressive-response fallback, and
``lib()``, which loads — building on
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
import errno
import glob
import json
import os
import re
import shutil
import subprocess
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

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

# The serving fleet's structural codes (2040-2046 are the tensor plane's),
# classified on the code, never on message strings:
#   E_DRAINING      — the server refuses new sessions while it migrates
#                     its live ones out: retriable on another member, the
#                     text carries the retry_after_ms pacer hint;
#   E_SESSION_MOVED — the session now lives on another server, whose
#                     address the text carries as "moved:<addr>".
E_DRAINING = 2047
E_SESSION_MOVED = 2048

_RETRY_AFTER_RE = re.compile(r"retry_after_ms=(\d+)")
_MOVED_RE = re.compile(r"moved:([^\s;,]+)")


def parse_moved(text: str) -> Optional[str]:
    """The address in a "moved:<addr>" forwarding text (an error text, an
    E-frame, a shed reason), or None."""
    if not text:
        return None
    m = _MOVED_RE.search(text)
    return m.group(1) if m else None

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

# Byte-service handler: ctx, method, request, attachment, the response's
# two out-buffers, the error code and the C-owned error-text buffer.
_HANDLER_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.c_void_p,                    # ctx
    ctypes.c_char_p,                    # method
    ctypes.c_void_p, ctypes.c_size_t,   # req
    ctypes.c_void_p, ctypes.c_size_t,   # attach
    ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),  # resp
    ctypes.POINTER(ctypes.c_void_p),    # resp_attach
    ctypes.POINTER(ctypes.c_size_t),    # resp_attach length
    ctypes.POINTER(ctypes.c_int),       # error_code
    ctypes.c_void_p, ctypes.c_size_t,   # err_text buffer (C-owned)
)

# /sessionz provider: fill the JSON document into (buf, cap), returning
# its full length; runs on a callback-pool pthread at scrape time.
_SESSIONZ_CB = ctypes.CFUNCTYPE(
    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t)

# HTTP streaming handler: (ctx, path, query, progressive_id, body*,
# body_len*, use_progressive*, status*); use_progressive=1 keeps the
# response open as a chunked body fed by tbrpc_progressive_write.
_HTTP_STREAM_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
    ctypes.c_uint64, ctypes.POINTER(ctypes.c_void_p),
    ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_int))


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


def _gil_held(fn):
    """``fn`` (a bound function of the library, its types set) called
    without releasing the interpreter lock: for calls that never block."""
    proto = ctypes.PYFUNCTYPE(fn.restype, *(fn.argtypes or ()))
    return proto(ctypes.cast(fn, ctypes.c_void_p).value)


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
    L.tbrpc_server_start_tls.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
    L.tbrpc_server_stop.argtypes = [ctypes.c_void_p]
    L.tbrpc_server_destroy.argtypes = [ctypes.c_void_p]
    L.tbrpc_channel_create.restype = ctypes.c_void_p
    L.tbrpc_channel_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    L.tbrpc_channel_create_ex.restype = ctypes.c_void_p
    L.tbrpc_channel_create_ex.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
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
    # Loopback echo benchmarks (the native client and server, no Python
    # in the loop).
    L.tbrpc_bench_echo_throughput.restype = ctypes.c_double
    L.tbrpc_bench_echo_throughput.argtypes = [
        ctypes.c_size_t, ctypes.c_int, ctypes.c_int]
    L.tbrpc_bench_echo_qps.restype = ctypes.c_double
    L.tbrpc_bench_echo_qps.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
    L.tbrpc_bench_echo_ex.restype = ctypes.c_double
    L.tbrpc_bench_echo_ex.argtypes = [
        ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    # ---- observability: metrics + tracing (capi.h) ----
    L.tbrpc_var_adder_create.restype = ctypes.c_void_p
    L.tbrpc_var_adder_create.argtypes = [ctypes.c_char_p]
    L.tbrpc_var_adder_add.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    L.tbrpc_var_adder_value.restype = ctypes.c_int64
    L.tbrpc_var_adder_value.argtypes = [ctypes.c_void_p]
    L.tbrpc_var_latency_create.restype = ctypes.c_void_p
    L.tbrpc_var_latency_create.argtypes = [ctypes.c_char_p]
    L.tbrpc_var_latency_record.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    L.tbrpc_var_latency_value.restype = ctypes.c_int64
    L.tbrpc_var_latency_value.argtypes = [ctypes.c_void_p, ctypes.c_int]
    L.tbrpc_var_gauge_create.restype = ctypes.c_void_p
    L.tbrpc_var_gauge_create.argtypes = [
        ctypes.c_char_p, _GAUGE_CB, ctypes.c_void_p]
    L.tbrpc_vars_dump.restype = ctypes.c_int64
    L.tbrpc_vars_dump.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_vars_dump_prometheus.restype = ctypes.c_int64
    L.tbrpc_vars_dump_prometheus.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_rpcz_dump_json.restype = ctypes.c_int64
    L.tbrpc_rpcz_dump_json.argtypes = [
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_debug_dump_fibers.restype = ctypes.c_int64
    L.tbrpc_debug_dump_fibers.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_debug_dump_ici.restype = ctypes.c_int64
    L.tbrpc_debug_dump_ici.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_rpcz_enabled.restype = ctypes.c_int
    L.tbrpc_rpcz_set_enabled.argtypes = [ctypes.c_int]
    L.tbrpc_rpcz_sample_root.restype = ctypes.c_int
    L.tbrpc_rpcz_sample_root.argtypes = []
    L.tbrpc_rpcz_sample_1_in_n.restype = ctypes.c_int
    L.tbrpc_rpcz_sample_1_in_n.argtypes = []
    L.tbrpc_trace_new_id.restype = ctypes.c_uint64
    L.tbrpc_trace_current.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    L.tbrpc_trace_set.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    L.tbrpc_span_annotate.argtypes = [ctypes.c_char_p]
    L.tbrpc_span_emit.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_char_p]
    L.tbrpc_now_us.restype = ctypes.c_int64
    # The calls every stage exit makes keep the interpreter lock: an
    # Adder's add is a store into this thread's own cell, the rpcz switch
    # one atomic load, and neither waits on anything that waits on Python.
    # A call that released the lock would hand the interpreter to another
    # waiting thread each time (the server's handlers and a trainer's
    # lanes all wait for it).
    L.held_var_adder_add = _gil_held(L.tbrpc_var_adder_add)
    L.held_rpcz_enabled = _gil_held(L.tbrpc_rpcz_enabled)
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
    L.tbrpc_deadline_remaining_ms.restype = ctypes.c_int64
    L.tbrpc_deadline_remaining_ms.argtypes = []
    # Byte services and admission settings of a server.
    L.tbrpc_server_add_callback_service.restype = ctypes.c_int
    L.tbrpc_server_add_callback_service.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, _HANDLER_CB, ctypes.c_void_p]
    L.tbrpc_server_add_echo_service.restype = ctypes.c_int
    L.tbrpc_server_add_echo_service.argtypes = [ctypes.c_void_p]
    L.tbrpc_server_set_inline.restype = ctypes.c_int
    L.tbrpc_server_set_inline.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    L.tbrpc_server_set_max_concurrency.restype = ctypes.c_int
    L.tbrpc_server_set_max_concurrency.argtypes = [
        ctypes.c_void_p, ctypes.c_int32]
    L.tbrpc_server_set_tenant_quota.restype = ctypes.c_int
    L.tbrpc_server_set_tenant_quota.argtypes = [
        ctypes.c_void_p, ctypes.c_int32]
    L.tbrpc_server_tenantz_json.restype = ctypes.c_int64
    L.tbrpc_server_tenantz_json.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_debug_inject_latency.restype = ctypes.c_int
    L.tbrpc_debug_inject_latency.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    # Streaming RPC: credit-windowed message streams, tcp and tpu://.
    L.tbrpc_stream_accept.restype = ctypes.c_int64
    L.tbrpc_stream_accept.argtypes = [ctypes.c_int64]
    L.tbrpc_stream_create.restype = ctypes.c_int64
    L.tbrpc_stream_create.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_size_t]
    L.tbrpc_stream_write.restype = ctypes.c_int
    L.tbrpc_stream_write.argtypes = [
        ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64]
    L.tbrpc_stream_read.restype = ctypes.c_int
    L.tbrpc_stream_read.argtypes = [
        ctypes.c_uint64, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t)]
    L.tbrpc_stream_close.restype = ctypes.c_int
    L.tbrpc_stream_close.argtypes = [ctypes.c_uint64, ctypes.c_int]
    # /sessionz and the HTTP streaming fallback.
    L.tbrpc_sessionz_set_provider.restype = ctypes.c_int
    L.tbrpc_sessionz_set_provider.argtypes = [_SESSIONZ_CB, ctypes.c_void_p]
    L.tbrpc_http_stream_register.restype = ctypes.c_int
    L.tbrpc_http_stream_register.argtypes = [
        ctypes.c_char_p, _HTTP_STREAM_CB, ctypes.c_void_p]
    L.tbrpc_progressive_write.restype = ctypes.c_int
    L.tbrpc_progressive_write.argtypes = [
        ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t]
    L.tbrpc_progressive_close.restype = ctypes.c_int
    L.tbrpc_progressive_close.argtypes = [ctypes.c_uint64]
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


def deadline_remaining_ms() -> Optional[int]:
    """Remaining budget (ms) of the request this thread is handling: the
    client's propagated deadline less the time already spent. None when
    no deadline is in scope; 0 means expired."""
    left = lib().tbrpc_deadline_remaining_ms()
    return None if left < 0 else int(left)


def inject_latency(service: str, ms: int) -> None:
    """For tests: every admitted request to ``service`` holds its gate
    slot for ``ms`` before the handler runs (deterministic queueing for
    the overload tests). ``ms <= 0`` clears; ``service=""`` clears every
    injection."""
    lib().tbrpc_debug_inject_latency(service.encode(), ms)


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

    @property
    def draining(self) -> bool:
        """True when the server refused because it is draining
        (E_DRAINING): retriable on another member, paced by
        retry_after_ms, never counted as overload."""
        return self.code == E_DRAINING

    @property
    def moved_to(self) -> Optional[str]:
        """The forwarding address of an E_SESSION_MOVED redirect, or None
        (only a moved error is ever parsed for an address)."""
        if self.code != E_SESSION_MOVED:
            return None
        return parse_moved(self.text)


# Byte-service handler: (method, request, attachment) -> (response,
# response attachment); raise RpcError to fail the call.
Handler = Callable[[str, bytes, bytes], Tuple[bytes, bytes]]


class Server:
    """A native RPC server hosting Python services."""

    def __init__(self):
        self._L = lib()
        self._h = self._L.tbrpc_server_create()
        self._cbs = []  # keep CFUNCTYPE objects alive
        self.port: Optional[int] = None
        _LIVE_SERVERS.add(self)

    def add_echo_service(self) -> None:
        """The native ``EchoService/Echo`` (answers the request bytes)."""
        if self._L.tbrpc_server_add_echo_service(self._h) != 0:
            raise RuntimeError("add_echo_service failed")

    def set_inline(self, service: str, enabled: bool = True) -> None:
        """Run small requests to a native, non-blocking ``service`` on the
        input fiber. Python handler services are always refused: they park
        on the callback pool, which would block the connection."""
        if self._L.tbrpc_server_set_inline(
                self._h, service.encode(), 1 if enabled else 0) != 0:
            raise RuntimeError(
                f"set_inline({service!r}) refused: unknown service or not "
                "inline-safe (Python handlers always run on the callback "
                "pool)")

    def set_max_concurrency(self, max_inflight: int) -> None:
        """The concurrency gate applied at ``start()`` (0 = unlimited);
        requests over it shed with ELIMIT and a retry hint. Call before
        ``start()``."""
        if self._L.tbrpc_server_set_max_concurrency(
                self._h, max_inflight) != 0:
            raise RuntimeError(
                "set_max_concurrency must be called before start()")

    def set_tenant_quota(self, max_inflight: int) -> None:
        """Per-tenant in-flight quota under the global gate (0 = off)."""
        if self._L.tbrpc_server_set_tenant_quota(self._h, max_inflight) != 0:
            raise RuntimeError("set_tenant_quota failed")

    def tenantz(self) -> dict:
        """The per-tenant admission table, ``{"quota": N, "tenants":
        [{name, admitted, shed, inflight, quota}, ...]}`` — the document
        ``/tenantz?format=json`` serves."""
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            need = self._L.tbrpc_server_tenantz_json(self._h, buf, cap)
            if need < cap:
                return json.loads(buf.value.decode())
            cap = int(need) + 1

    def add_service(self, name: str, handler: Handler) -> None:
        """Host a byte service: ``handler(method, request, attachment)``
        runs on a callback-pool thread for every ``name/<method>`` call."""
        L = self._L

        def trampoline(ctx, method, req, req_len, att, att_len,
                       resp, resp_len, resp_att, resp_att_len, error_code,
                       err_text, err_text_cap):
            try:
                request = ctypes.string_at(req, req_len) if req_len else b""
                attachment = (ctypes.string_at(att, att_len) if att_len
                              else b"")
                r, ra = handler(method.decode(), request, attachment)
                for data, pp, pl in ((r, resp, resp_len),
                                     (ra, resp_att, resp_att_len)):
                    if data:
                        buf = L.tbrpc_alloc(len(data))
                        ctypes.memmove(buf, data, len(data))
                        pp[0] = buf
                        pl[0] = len(data)
            except RpcError as e:
                error_code[0] = e.code if e.code != 0 else TRPC_EINTERNAL
                fill_err_text(err_text, err_text_cap, e.text)
            except Exception as e:  # noqa: BLE001 — handler bug => EINTERNAL
                error_code[0] = TRPC_EINTERNAL
                fill_err_text(err_text, err_text_cap,
                              f"{type(e).__name__}: {e}")

        cb = _HANDLER_CB(trampoline)
        self._cbs.append(cb)
        if L.tbrpc_server_add_callback_service(
                self._h, name.encode(), cb, None) != 0:
            raise RuntimeError(f"add_service({name}) failed")

    def start(self, addr: str = "127.0.0.1:0", *, ssl_cert: str = "",
              ssl_key: str = "") -> int:
        """Listen on ``addr``; returns the port. ``ssl_cert`` and
        ``ssl_key`` (PEM files) make the port also accept TLS — sniffed,
        so plaintext clients keep working; ALPN offers h2 for gRPC over
        TLS."""
        if not self._h:
            raise RuntimeError("server is closed")
        if ssl_cert or ssl_key:
            port = self._L.tbrpc_server_start_tls(
                self._h, addr.encode(), ssl_cert.encode(), ssl_key.encode())
        else:
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


# Wire protocols a Channel speaks (native/trpc's protocol ids).
_PROTOCOLS = {"tstd": 0, "grpc": 5}


class Channel:
    """Client stub to one server ("ip:port", or "tls://ip:port") for byte
    RPCs. ``protocol`` is ``"tstd"`` (the native framing) or ``"grpc"``
    (gRPC over HTTP/2: dials any standard gRPC server)."""

    def __init__(self, addr: str, timeout_ms: int = 1000, max_retry: int = 3,
                 protocol: str = "tstd"):
        if protocol not in _PROTOCOLS:
            raise ValueError(f"unknown protocol {protocol!r}; choose from "
                             f"{sorted(_PROTOCOLS)}")
        self._L = lib()
        self._h = self._L.tbrpc_channel_create_ex(
            addr.encode(), timeout_ms, max_retry, _PROTOCOLS[protocol])
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


# ---------------------------------------------------------------------------
# Streaming RPC: the serving plane's transport.
# ---------------------------------------------------------------------------

class StreamClosed(Exception):
    """The peer closed the stream. ``error`` is the close code: 0 for a
    clean close, else the code an abnormal close (a shed) carried."""

    def __init__(self, error: int = 0):
        super().__init__("stream closed"
                         + (f" (error {error})" if error else ""))
        self.error = error


class Stream:
    """One half of a native credit-windowed message stream, on tcp or
    tpu://: ordered messages with per-stream flow control. A read or write
    blocks only the calling thread (ctypes releases the GIL), and a slow
    reader exhausts only its own peer's window. From :func:`open_stream`
    (client) or :func:`accept_stream` (inside a handler); :meth:`close`
    releases the native read buffer."""

    def __init__(self, stream_id: int):
        self._L = lib()
        self.id = int(stream_id)
        self._closed = False

    def write(self, data: bytes, timeout_ms: int = -1) -> bool:
        """Send one message: ``timeout_ms`` < 0 waits for credit, 0 probes,
        > 0 bounds the wait. False when the window stayed exhausted;
        raises StreamClosed once the stream is gone."""
        rc = self._L.tbrpc_stream_write(self.id, data, len(data),
                                        timeout_ms)
        if rc == 0:
            return True
        if rc == errno.EAGAIN:
            return False
        raise StreamClosed(rc)

    def read(self, timeout_ms: int = -1) -> Optional[bytes]:
        """The next message, or None on timeout. Raises StreamClosed at
        the end of the stream, after every queued message was read."""
        L = self._L
        data = ctypes.c_void_p()
        length = ctypes.c_size_t()
        rc = L.tbrpc_stream_read(self.id, timeout_ms, ctypes.byref(data),
                                 ctypes.byref(length))
        if rc == 0:
            try:
                return (ctypes.string_at(data, length.value)
                        if length.value else b"")
            finally:
                L.tbrpc_free(data)
        if rc == -1:
            return None
        if rc in (1, -2):
            raise StreamClosed(0)
        raise StreamClosed(rc)

    def close(self, error: int = 0) -> None:
        """Close this half. ``error`` > 0 rides the CLOSE frame outside the
        credit window, so the peer's reads end in StreamClosed(error) even
        when its window is full. Idempotent."""
        if not self._closed:
            self._closed = True
            self._L.tbrpc_stream_close(self.id, error)

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def open_stream(channel: Channel, service_method: str,
                request: bytes = b"", *,
                max_buf_size: int = 0) -> Tuple[Stream, bytes]:
    """Call ``service_method`` with a stream attached (the handler must
    :func:`accept_stream`). Returns the connected stream and the response
    body. ``max_buf_size`` (<= 0: the native default) is this side's
    receive window, the peer's write budget."""
    if not channel._h:
        raise RuntimeError("channel is closed")
    L = lib()
    resp = ctypes.c_void_p()
    resp_len = ctypes.c_size_t()
    errbuf = ctypes.create_string_buffer(256)
    sid = L.tbrpc_stream_create(
        channel._h, service_method.encode(), request, len(request),
        max_buf_size, ctypes.byref(resp), ctypes.byref(resp_len),
        errbuf, len(errbuf))
    if sid <= 0:
        raise RpcError(int(-sid) if sid < 0 else TRPC_EINTERNAL,
                       errbuf.value.decode(errors="replace"))
    try:
        body = (ctypes.string_at(resp, resp_len.value)
                if resp_len.value else b"")
    finally:
        L.tbrpc_free(resp)
    return Stream(sid), body


def accept_stream(max_buf_size: int = 0) -> Optional[Stream]:
    """Accept the caller's stream from inside a service handler, before
    it returns. None when the call carried no stream."""
    sid = lib().tbrpc_stream_accept(max_buf_size)
    return Stream(sid) if sid > 0 else None


# Trampolines in process-lifetime native slots (HTTP handlers) must never
# be collected.
_immortal_native_cbs: list = []

# The /sessionz slot holds one provider. The native side swaps and scrapes
# under one mutex, so a replaced trampoline is never called again and is
# released here.
_sessionz_holder: dict = {"fn": None, "cb": None}


def set_sessionz_provider(fn: Optional[Callable[[], str]]) -> None:
    """Point the /sessionz console page at ``fn`` (returning the JSON
    document); None clears it. The slot is one per process: the newest
    registration serves."""
    L = lib()
    if fn is None:
        L.tbrpc_sessionz_set_provider(ctypes.cast(None, _SESSIONZ_CB),
                                      None)
        _sessionz_holder["fn"] = _sessionz_holder["cb"] = None
        return

    def _cb(_ctx, buf, cap) -> int:
        try:
            doc = fn().encode()
        except Exception:  # noqa: BLE001 — a failing provider reads empty
            doc = b"{}"
        if buf and cap > 0:
            n = min(len(doc), cap - 1)
            ctypes.memmove(buf, doc, n)
            ctypes.memset(buf + n, 0, 1)
        return len(doc)

    cb = _SESSIONZ_CB(_cb)
    L.tbrpc_sessionz_set_provider(cb, None)
    _sessionz_holder["fn"] = fn
    _sessionz_holder["cb"] = cb


def clear_sessionz_provider(fn: Callable[[], str]) -> None:
    """Clear the /sessionz provider if ``fn`` is still the registered
    one (a shutdown never clears a newer manager's registration)."""
    if _sessionz_holder["fn"] is fn:
        set_sessionz_provider(None)


# HTTP streaming handler: (path, query, progressive_id) -> (status, body,
# progressive). progressive=True keeps the response open: feed it with
# progressive_write(progressive_id, ...), end it with progressive_close.
HttpStreamHandler = Callable[[str, str, int], Tuple[int, bytes, bool]]


def register_http_stream_handler(path: str, fn: HttpStreamHandler) -> None:
    """Serve ``path`` on every server's builtin HTTP port, optionally as a
    chunked progressive response. A path registers once per process;
    registering it again raises RuntimeError."""
    L = lib()

    def _cb(_ctx, cpath, cquery, pid, body, body_len, use_prog, status):
        try:
            st, payload, progressive = fn(
                cpath.decode() if cpath else "",
                cquery.decode() if cquery else "", int(pid))
        except Exception as e:  # noqa: BLE001 — handler bug => 500
            st, payload, progressive = (
                500, f"{type(e).__name__}: {e}\n".encode(), False)
        status[0] = int(st)
        use_prog[0] = 1 if progressive else 0
        if payload:
            buf = L.tbrpc_alloc(len(payload))
            ctypes.memmove(buf, payload, len(payload))
            body[0] = buf
            body_len[0] = len(payload)

    cb = _HTTP_STREAM_CB(_cb)
    _immortal_native_cbs.append(cb)
    if L.tbrpc_http_stream_register(path.encode(), cb, None) != 0:
        raise RuntimeError(f"http path already registered: {path!r}")


def progressive_write(progressive_id: int, data: bytes) -> bool:
    """Feed a progressive HTTP response; False once the peer is gone."""
    return lib().tbrpc_progressive_write(
        progressive_id, data, len(data)) == 0


def progressive_close(progressive_id: int) -> None:
    """Send the terminal chunk; the connection closes after it drains."""
    lib().tbrpc_progressive_close(progressive_id)


# ---------------------------------------------------------------------------
# Loopback echo benchmarks: a native echo server and native clients in this
# process, no Python in the loop.
# ---------------------------------------------------------------------------


def bench_echo_throughput(payload_size: int, seconds: int = 2,
                          concurrency: int = 4) -> float:
    """One-way payload bytes a second through a loopback echo server."""
    return lib().tbrpc_bench_echo_throughput(payload_size, seconds,
                                             concurrency)


def bench_echo_qps(seconds: int = 2, concurrency: int = 8):
    """(calls a second, p99 in us) of small-payload loopback echo."""
    p99 = ctypes.c_double()
    qps = lib().tbrpc_bench_echo_qps(seconds, concurrency, ctypes.byref(p99))
    return qps, p99.value


def bench_echo_ex(payload_size: int, seconds: int = 2, concurrency: int = 4,
                  transport: str = "tcp", conn_type: str = "single"):
    """One echo point -> (one-way bytes/s, calls/s, p50 us, p99 us).
    ``transport`` is "tcp" or "tpu" (the shared-memory transport over the
    loopback control channel); ``conn_type`` "single", "pooled" or
    "short"."""
    qps = ctypes.c_double()
    p50 = ctypes.c_double()
    p99 = ctypes.c_double()
    bps = lib().tbrpc_bench_echo_ex(
        payload_size, seconds, concurrency,
        {"tcp": 0, "tpu": 1}[transport],
        {"single": 0, "pooled": 1, "short": 2}[conn_type],
        ctypes.byref(qps), ctypes.byref(p50), ctypes.byref(p99))
    return bps, qps.value, p50.value, p99.value
