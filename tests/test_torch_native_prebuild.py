"""Builds the native library once, before any test starts.

Every pytest-xdist worker imports this module while it collects, before it
runs a test, so the first worker here builds ``native/build/
libbrpc_tpu.so`` (the port's ``build_cmake_library``: the JAX package's
configure and the ``brpc_tpu`` target) under ``native/build.lock`` while the
others wait on the lock and then find the library. The JAX package's
``lib()`` then finds it too and never builds from a fixture, where several
workers would run cmake over one fresh tree at once.

The import never raises: a failed build is recorded, and the test below
fails with its output.
"""

import os
import subprocess
import types

import pytest

from brpc_tpu_torch.runtime import native as tnative
from brpc_tpu_torch.utils.build import file_lock


def _prebuild():
    """None, or the failure of the build with its output."""
    try:
        with file_lock(tnative._LOCK_PATH):
            tnative.build_cmake_library()
    except subprocess.CalledProcessError as e:
        out = b"".join(x for x in (e.stdout, e.stderr) if x)
        return f"{e}\n{out.decode(errors='replace')[-8000:]}"
    except Exception as e:  # noqa: BLE001 — reported by the test below
        return repr(e)
    return None


_FAILURE = _prebuild()


def test_prebuild_left_the_library_in_place():
    if _FAILURE is not None:
        pytest.fail(f"building native/build/libbrpc_tpu.so failed:\n"
                    f"{_FAILURE}")
    assert os.path.exists(tnative._LIB_PATH) or not tnative._have_cmake()


@pytest.mark.parametrize("lib_exists,cmake,want", [
    (False, True, ["configure", "build"]),  # a fresh tree
    (True, True, []),                       # built already: nothing runs
    (False, False, []),                     # no toolchain: nothing runs
])
def test_build_cmake_library_runs_the_jax_packages_steps(
        tmp_path, monkeypatch, lib_exists, cmake, want):
    lib = tmp_path / "build" / "libbrpc_tpu.so"
    if lib_exists:
        lib.parent.mkdir()
        lib.write_bytes(b"lib")
    monkeypatch.setattr(tnative, "_LIB_PATH", str(lib))
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(lib.parent))
    monkeypatch.setattr(tnative, "_have_cmake", lambda: cmake)
    calls = []

    def run(cmd, **kw):
        assert kw.get("check") and kw.get("capture_output")
        calls.append(list(cmd))

    monkeypatch.setattr(tnative, "subprocess",
                        types.SimpleNamespace(run=run))
    tnative.build_cmake_library()
    got = ["build" if "--build" in c else "configure" for c in calls]
    assert got == want
    if want:
        assert calls[0] == tnative.configure_command(str(lib.parent))
        assert calls[1] == ["cmake", "--build", str(lib.parent), "--target",
                            "brpc_tpu"]
