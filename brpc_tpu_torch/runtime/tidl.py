"""Wire-format runtime for tidl-generated Python messages — the port's own
copy of brpc_tpu/runtime/tidl.py, byte for byte the same encoding.

The protobuf wire format (varint tags; varint / fixed64 / length-delimited
/ fixed32 wire types), mirroring native/trpc/tidl_runtime.h, so C++ and
Python stubs generated by tools/tidl_gen.cpp interoperate — and both
interoperate with same-schema protobuf peers.

Generated stubs over the port: tools/tidl_gen.cpp writes Python stubs
whose two imports name the JAX package's runtime (``from brpc_tpu.runtime
import native as _native`` and ``... import tidl as _rt``). ``load_stub``
executes such a stub as a module whose ``__import__`` maps every
``brpc_tpu`` import to ``brpc_tpu_torch``, so those two lines bind this
package's ``native`` and ``tidl``: the stub runs over the port and
``brpc_tpu`` is never imported. The generated text is not edited.
``generate`` builds the generator from the checkout (one ``g++`` call,
cached by its source's hash in ``native/build_torch/``) and runs it on a
schema.
"""

from __future__ import annotations

import builtins
import os
import struct
import subprocess
import sys
import types
from typing import Optional

from brpc_tpu_torch.utils.build import (file_lock, read_stamp, source_digest,
                                        write_stamp)

VARINT, FIXED64, LEN, FIXED32 = 0, 1, 2, 5


def put_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def put_tag(out: bytearray, field: int, wt: int) -> None:
    put_varint(out, (field << 3) | wt)


def zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def to_int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def to_int64(v: int) -> int:
    v &= 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >= (1 << 63) else v


def put_uint(out: bytearray, f: int, v: int) -> None:
    put_tag(out, f, VARINT)
    put_varint(out, v & 0xFFFFFFFFFFFFFFFF)


def put_sint(out: bytearray, f: int, v: int) -> None:
    put_tag(out, f, VARINT)
    put_varint(out, zigzag(v))


def put_bytes(out: bytearray, f: int, v: bytes) -> None:
    put_tag(out, f, LEN)
    put_varint(out, len(v))
    out.extend(v)


def put_f64(out: bytearray, f: int, v: float) -> None:
    put_tag(out, f, FIXED64)
    out.extend(struct.pack("<d", v))


def put_f32(out: bytearray, f: int, v: float) -> None:
    put_tag(out, f, FIXED32)
    out.extend(struct.pack("<f", v))


class Reader:
    def __init__(self, data: bytes):
        self._d = data
        self._pos = 0

    def done(self) -> bool:
        return self._pos >= len(self._d)

    def varint(self) -> int:
        out = 0
        shift = 0
        while self._pos < len(self._d):
            b = self._d[self._pos]
            self._pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift >= 70:
                break
        raise ValueError("truncated varint")

    def tag(self) -> tuple[int, int]:
        t = self.varint()
        f, wt = t >> 3, t & 7
        if f == 0:
            raise ValueError("zero field number")
        return f, wt

    def bytes(self) -> bytes:
        n = self.varint()
        if self._pos + n > len(self._d):
            raise ValueError("truncated bytes")
        v = self._d[self._pos:self._pos + n]
        self._pos += n
        return v

    def f64(self) -> float:
        if self._pos + 8 > len(self._d):
            raise ValueError("truncated fixed64")
        (v,) = struct.unpack_from("<d", self._d, self._pos)
        self._pos += 8
        return v

    def f32(self) -> float:
        if self._pos + 4 > len(self._d):
            raise ValueError("truncated fixed32")
        (v,) = struct.unpack_from("<f", self._d, self._pos)
        self._pos += 4
        return v

    def skip(self, wt: int) -> None:
        if wt == VARINT:
            self.varint()
        elif wt == FIXED64:
            self.f64()
        elif wt == LEN:
            self.bytes()
        elif wt == FIXED32:
            self.f32()
        else:
            raise ValueError(f"bad wire type {wt}")


# ---- generated stubs over the port ----

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_GEN_SRC = os.path.join(_REPO, "tools", "tidl_gen.cpp")
_GEN_DIR = os.path.join(_REPO, "native", "build_torch")
_GEN_BIN = os.path.join(_GEN_DIR, "tidl_gen")
_GEN_FLAGS = ["-std=c++17", "-O1"]
_LOCK_PATH = os.path.join(_REPO, "native", "build.lock")


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` with the JAX package's name bound to the port's."""
    if level == 0 and (name == "brpc_tpu" or name.startswith("brpc_tpu.")):
        name = "brpc_tpu_torch" + name[len("brpc_tpu"):]
    return builtins.__import__(name, globals, locals, fromlist, level)


def load_stub(path: str, module_name: Optional[str] = None
              ) -> types.ModuleType:
    """Import the tidl_gen Python stub at ``path`` over the port (see the
    module docstring) as ``module_name`` (default: the file's stem)."""
    name = module_name or os.path.splitext(os.path.basename(path))[0]
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    mod = types.ModuleType(name)
    mod.__file__ = path
    mod.__builtins__ = dict(vars(builtins), __import__=_port_import)
    # Registered while it runs, as an import would: dataclasses resolve
    # the stub's string annotations through sys.modules.
    sys.modules[name] = mod
    try:
        exec(code, mod.__dict__)
    except BaseException:
        sys.modules.pop(name, None)
        raise
    return mod


def _generator() -> str:
    """The tidl_gen binary, built with g++ when missing or stale."""
    digest = source_digest(_REPO, [_GEN_SRC], _GEN_FLAGS)
    stamp = _GEN_BIN + ".sha256"
    with file_lock(_LOCK_PATH):
        if not os.path.exists(_GEN_BIN) or read_stamp(stamp) != digest:
            os.makedirs(_GEN_DIR, exist_ok=True)
            tmp = _GEN_BIN + f".tmp{os.getpid()}"
            r = subprocess.run(  # tpulint: allow(py-blocking)
                ["g++", *_GEN_FLAGS, _GEN_SRC, "-o", tmp],
                capture_output=True)
            if r.returncode != 0:
                raise RuntimeError("building tidl_gen failed:\n"
                                   + r.stderr.decode(errors="replace"))
            os.replace(tmp, _GEN_BIN)
            write_stamp(stamp, digest)
    return _GEN_BIN


def generate(schema: str, out_dir: str) -> str:
    """Run tidl_gen on ``schema`` (a ``.tidl`` file) into ``out_dir``;
    returns the path of the generated Python stub."""
    os.makedirs(out_dir, exist_ok=True)
    r = subprocess.run(  # tpulint: allow(py-blocking)
        [_generator(), schema, "--py_out", out_dir], capture_output=True)
    if r.returncode != 0:
        raise RuntimeError(f"tidl_gen {schema} failed:\n"
                           + r.stderr.decode(errors="replace"))
    stem = os.path.splitext(os.path.basename(schema))[0]
    return os.path.join(out_dir, f"{stem}_tidl.py")
