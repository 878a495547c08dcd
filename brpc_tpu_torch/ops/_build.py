"""Builds and binds the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
— one ``nvcc`` process per source, all started together — and linked into
``_build/libbrpc_tpu_torch_kernels.so``, a library with a plain C
interface loaded through ``ctypes``. The build happens at the first kernel
launch (never at import: hosts without ``nvcc`` import every module) and
again whenever the hash of the sources or flags changes.

Each launcher is ``extern "C"``, takes raw device pointers, the element
count, its scalars and a ``cudaStream_t``, and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.

The check of the hash and the build run under an inter-process file lock
on ``_build/build.lock`` (``utils.build.file_lock``), and the library is
installed with ``os.replace``: ranks started together on several cards
build once and never load a half-written library.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

from brpc_tpu_torch.utils.build import (file_lock, read_stamp, source_digest,
                                        write_stamp)

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libbrpc_tpu_torch_kernels.so")
_STAMP = os.path.join(BUILD_DIR, "sources.sha256")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_mu = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_bound: Dict[str, object] = {}
# What the last build in this process did: {"seconds", "log"} — empty when
# a cached library matched the sources' hash.
last_build: Dict[str, object] = {}


class LaunchCounter:
    """How many times a wrapper launched its kernel (launches made by
    handler threads concurrently are all counted)."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._mu = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._mu:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._mu:
            self._n = 0


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    return source_digest(CSRC, glob.glob(os.path.join(CSRC, "*.cu*")),
                         NVCC_FLAGS)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels of brpc_tpu_torch "
                       "build on a host with the CUDA toolkit")


def _build(digest: str) -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.monotonic()
    procs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR,
                           os.path.basename(src)[:-len(".cu")] + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    log = []
    failed = []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {os.path.basename(src)}\n"
                   + out.decode(errors="replace"))
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = LIB_PATH + f".tmp{os.getpid()}"
    r = subprocess.run(  # tpulint: allow(py-blocking)
        [nvcc, "-shared", "-o", tmp, *[o for _s, o, _p in procs]],
        capture_output=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + r.stderr.decode(errors="replace"))
    os.replace(tmp, LIB_PATH)
    write_stamp(_STAMP, digest)
    last_build["seconds"] = time.monotonic() - t0
    last_build["log"] = "\n".join(log)


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale."""
    global _lib
    with _mu:
        if _lib is None:
            digest = _digest()
            with file_lock(os.path.join(BUILD_DIR, "build.lock")):
                if (not os.path.exists(LIB_PATH)
                        or read_stamp(_STAMP) != digest):
                    _build(digest)
                _lib = ctypes.CDLL(LIB_PATH)
        return _lib


def kernel(name: str, argtypes: list):
    """The bound launcher ``name`` (argtypes set once, restype int)."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
