"""The port's native build rule, checked without running a build.

The port shares ``native/build/`` with the JAX package: it must never
reconfigure that tree with another compiler (cmake would delete the cache
and regenerate the tree under the JAX package's processes) and never
overwrite its library. Its own g++ copy goes to ``native/build_torch/``,
stamped with the hash of the native sources.
Every scenario below swaps the build steps for recorders.
"""

import fcntl
import os
import types

import pytest

from brpc_tpu.runtime import native as jnative
from brpc_tpu_torch.runtime import native as tnative
from brpc_tpu_torch.utils.build import source_digest


def test_configure_of_an_existing_tree_is_the_jax_packages(tmp_path,
                                                           monkeypatch):
    build = tmp_path / "build"
    build.mkdir()
    (build / "CMakeCache.txt").write_text("CMAKE_CXX_COMPILER:FILEPATH=c++\n")
    seen = []
    monkeypatch.setattr(jnative, "subprocess", types.SimpleNamespace(
        run=lambda cmd, **kw: seen.append(list(cmd))))
    jnative._build_native()
    jax_configure = [str(build) if a == os.path.join(
        jnative._REPO, "native", "build") else a for a in seen[0]]
    assert tnative.configure_command(str(build)) == jax_configure
    assert not any(a.startswith("-DCMAKE_CXX_COMPILER")
                   for a in tnative.configure_command(str(build)))


@pytest.mark.parametrize("fresh", [True, False])
def test_configure_never_names_a_compiler(tmp_path, fresh):
    build = tmp_path / "build"
    if not fresh:
        build.mkdir()
        (build / "CMakeCache.txt").write_text("cache\n")
    cmd = tnative.configure_command(str(build))
    assert cmd[:5] == ["cmake", "-S", "native", "-B", str(build)]
    assert not any(a.startswith("-DCMAKE_CXX_COMPILER") for a in cmd)


class _Fake:
    """Recorders in place of cmake, g++ and readelf over a scratch tree."""

    def __init__(self, tmp_path, monkeypatch, *, jax_lib=None, cache=False,
                 torch_lib=None, cmake=True, cmake_links_dynamic=True):
        self.calls = []
        build = tmp_path / "native" / "build"
        torch_build = tmp_path / "native" / "build_torch"
        build.mkdir(parents=True)
        src = tmp_path / "native" / "tbutil" / "a.cpp"
        src.parent.mkdir()
        src.write_text("int a() { return 1; }\n")
        self.jax_lib = build / "libbrpc_tpu.so"
        self.torch_lib = torch_build / "libbrpc_tpu.so"
        self.dynamic = {}
        if jax_lib is not None:
            self.jax_lib.write_bytes(b"jax")
            self.dynamic[str(self.jax_lib)] = jax_lib == "dynamic"
        if cache:
            (build / "CMakeCache.txt").write_text("cache\n")
        for name, value in (("_REPO", tmp_path),
                            ("_BUILD_DIR", build),
                            ("_LIB_PATH", self.jax_lib),
                            ("_TORCH_BUILD_DIR", torch_build),
                            ("_TORCH_LIB_PATH", self.torch_lib),
                            ("_LOCK_PATH", tmp_path / "native" /
                             "build.lock")):
            monkeypatch.setattr(tnative, name, str(value))
        monkeypatch.setattr(tnative, "_native_sources", lambda: [str(src)])
        if torch_lib is not None:  # a g++ copy from an earlier process
            torch_build.mkdir()
            self.torch_lib.write_bytes(b"torch")
            digest = source_digest(str(tmp_path), [str(src)],
                                   tnative._CXXFLAGS)
            (torch_build / "sources.sha256").write_text(
                digest if torch_lib == "current" else "0" * 64)
        monkeypatch.setattr(tnative, "_have_cmake", lambda: cmake)
        monkeypatch.setattr(tnative, "links_shared_libstdcxx",
                            lambda p: self.dynamic[str(p)])

        def run(cmd, **kw):
            self.calls.append(("cmake", list(cmd)))
            if "--build" in cmd:
                self.jax_lib.write_bytes(b"cmake")
                self.dynamic[str(self.jax_lib)] = cmake_links_dynamic

        def gxx():
            self.calls.append(("g++", str(self.torch_lib)))
            self.torch_lib.parent.mkdir(parents=True, exist_ok=True)
            self.torch_lib.write_bytes(b"g++")

        monkeypatch.setattr(tnative, "subprocess",
                            types.SimpleNamespace(run=run))
        monkeypatch.setattr(tnative, "_build_native_gxx", gxx)


@pytest.mark.parametrize("scenario,want,builds", [
    # The JAX package's library links libstdc++ dynamically: shared.
    (dict(jax_lib="dynamic", cache=True), "jax", []),
    # It does not: the port's g++ copy, built once, the JAX one untouched.
    (dict(jax_lib="static", cache=True), "torch", ["g++"]),
    (dict(jax_lib="static", cache=True, torch_lib="current"), "torch", []),
    # No library yet: the JAX package's configure and the library target.
    (dict(), "jax", ["configure", "build"]),
    (dict(cache=True), "jax", ["configure", "build"]),
    (dict(cache=True, cmake_links_dynamic=False), "torch",
     ["configure", "build", "g++"]),
    # No cmake+ninja: the g++ copy.
    (dict(cmake=False), "torch", ["g++"]),
    # A g++ copy whose stamp no longer matches the sources is rebuilt.
    (dict(jax_lib="static", cache=True, torch_lib="stale"), "torch",
     ["g++"]),
    (dict(cmake=False, torch_lib="current"), "torch", []),
    (dict(cmake=False, torch_lib="stale"), "torch", ["g++"]),
])
def test_library_choice_and_builds(tmp_path, monkeypatch, scenario, want,
                                   builds):
    fake = _Fake(tmp_path, monkeypatch, **scenario)
    before = (fake.jax_lib.read_bytes() if fake.jax_lib.exists() else None)
    path = tnative.library_path()
    assert path == str(fake.jax_lib if want == "jax" else fake.torch_lib)
    got = []
    for kind, what in fake.calls:
        if kind == "g++":
            got.append("g++")
        elif "--build" in what:
            assert what[-2:] == ["--target", "brpc_tpu"]
            got.append("build")
        else:
            assert what == tnative.configure_command(tnative._BUILD_DIR)
            got.append("configure")
    assert got == builds
    if before is not None:  # an existing JAX library is never rewritten
        assert fake.jax_lib.read_bytes() == before
    if "g++" in builds:  # the fresh copy is stamped: the next call reuses it
        fake.calls.clear()
        assert tnative.library_path() == str(fake.torch_lib)
        assert fake.calls == []


def test_build_runs_under_an_exclusive_file_lock(tmp_path, monkeypatch):
    lock = tmp_path / "build.lock"
    monkeypatch.setattr(tnative, "_LOCK_PATH", str(lock))

    def resolve():  # another open file, as another process would hold
        with open(lock) as other:
            with pytest.raises(BlockingIOError):
                fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
        return "resolved"

    monkeypatch.setattr(tnative, "_resolve_library", resolve)
    assert tnative.library_path() == "resolved"
    with open(lock) as other:
        fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
        fcntl.flock(other, fcntl.LOCK_UN)


def test_lock_file_and_torch_tree_are_ignored_by_git():
    with open(os.path.join(tnative._REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert "native/build.lock" in ignored
    assert "native/build*/" in ignored  # covers native/build_torch/


def test_port_refuses_to_load_beside_another_copy(tmp_path):
    # Two copies of the runtime in one process name their shm segments
    # alike, so the port will not load a second one.
    mine = tmp_path / "a" / "libbrpc_tpu.so"
    other = tmp_path / "b" / "libbrpc_tpu.so"
    for p in (mine, other):
        p.parent.mkdir()
        p.write_bytes(b"")
    maps = tmp_path / "maps"
    maps.write_text(f"7f00-7f01 r-xp 0 08:01 1 {other}\n"
                    "7f02-7f03 r--p 0 08:01 2 /usr/lib/libc.so.6\n")
    with pytest.raises(RuntimeError, match="already loaded"):
        tnative.refuse_second_copy(str(mine), str(maps))
    maps.write_text(f"7f00-7f01 r-xp 0 08:01 1 {mine}\n")
    tnative.refuse_second_copy(str(mine), str(maps))
    tnative.refuse_second_copy(str(mine), str(tmp_path / "no_such_maps"))
    # This process maps the library the port loaded, and no other.
    tnative.lib()
    tnative.refuse_second_copy(tnative.library_path())
