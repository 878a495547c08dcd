"""A ParameterServer in a process of its own.

The deployment the JAX package's overlapped-step benchmark measures
(bench.py's ``_STEP_CHILD``): the trainer in one process, the parameter
server in another, the trainer reaching the server over ``tpu://``.
``ServerProcess(params, ...)`` starts a fresh Python process running this
file, which holds a
:class:`~brpc_tpu_torch.runtime.param_server.ParameterServer` over
``params`` on ``device`` (default CUDA) and serves it on 127.0.0.1; the
caller reaches it at ``addr``. On request the process ships back its
``state()`` (params, momenta and versions, as CPU tensors) and its own
kernel launch counts, and can profile itself with ``torch.profiler``.

The server process dies with its caller. It reads its commands from a
pipe and stops at the pipe's end, which comes however the caller ends; it
stops by itself ``timeout_s`` after it started; and ``close()`` (or
leaving the ``with`` block, also on an exception) stops it and waits for
it, killing it if it does not end in time.

Commands and replies are lines: a command word (and an argument) in, one
``ps_process: {json}`` line out. Nothing above the package is imported at
this module's top, so a tool may load this file by path and serve the
package of another checkout (``root=``).
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import torch

_MARK = "ps_process: "
# How long the caller waits for the process's port, for a reply to a
# command, and for the process to end once told to stop.
_START_TIMEOUT_S = 120.0
_REPLY_TIMEOUT_S = 300.0
_CLOSE_TIMEOUT_S = 30.0
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _host(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous()
    import numpy as np

    return torch.from_numpy(np.ascontiguousarray(value))


class ServerProcess:
    """A ``ParameterServer`` over ``params`` (``{name: array or
    tensor}``) in a process of its own. ``lr``, ``momentum``,
    ``arena_bytes`` (its service arena) and ``oneside`` are the server's;
    ``root`` is the checkout whose ``brpc_tpu_torch`` it runs (default:
    this one). Raises RuntimeError when the process does not report its
    port within ``_START_TIMEOUT_S``."""

    def __init__(self, params, *, lr: float = 0.01, momentum: float = 0.9,
                 device=None, arena_bytes: int = 256 << 20,
                 oneside: bool = False, timeout_s: float = 600.0,
                 root: str = _ROOT):
        self.proc = None
        self._mu = threading.Lock()
        self._lines: "queue.Queue[str | None]" = queue.Queue()
        self._work = tempfile.mkdtemp(prefix="brpc_tpu_torch_ps_")
        try:
            torch.save({k: _host(v) for k, v in params.items()},
                       os.path.join(self._work, "init.pt"))
            self.proc = subprocess.Popen(
                # -P: this file's directory does not lead sys.path.
                [sys.executable, "-P", os.path.abspath(__file__),
                 "--root", root, "--work", self._work, "--device",
                 str(device if device is not None else "cuda"),
                 "--lr", repr(float(lr)), "--momentum",
                 repr(float(momentum)), "--arena-bytes", str(arena_bytes),
                 "--oneside", str(int(bool(oneside))), "--timeout-s",
                 repr(float(timeout_s))],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                bufsize=1)
            threading.Thread(target=self._read, daemon=True).start()
            self.port = int(self._reply(_START_TIMEOUT_S)["port"])
        except BaseException:
            self.close()
            raise
        self.addr = f"tpu://127.0.0.1:{self.port}"

    @property
    def pid(self) -> int:
        return self.proc.pid

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.startswith(_MARK):
                self._lines.put(line[len(_MARK):])
            else:
                sys.stderr.write(line)
        self._lines.put(None)

    def _reply(self, timeout_s: float) -> dict:
        try:
            line = self._lines.get(timeout=timeout_s)
        except queue.Empty:
            raise RuntimeError(f"server process {self.proc.pid}: no reply "
                               f"within {timeout_s} s") from None
        if line is None:
            self._lines.put(None)  # every later call sees the end too
            raise RuntimeError(f"server process {self.proc.pid} exited "
                               f"(code {self.proc.wait(timeout=10)})")
        doc = json.loads(line)
        if "error" in doc:
            raise RuntimeError(f"server process: {doc['error']}")
        return doc

    def _call(self, cmd: str) -> dict:
        with self._mu:
            self.proc.stdin.write(cmd + "\n")
            self.proc.stdin.flush()
            return self._reply(_REPLY_TIMEOUT_S)

    def state(self):
        """The server's ``state()`` as a ``PSState`` of CPU tensors."""
        from brpc_tpu_torch.runtime.state import PSState

        path = self._call("state")["path"]
        doc = torch.load(path, weights_only=True)
        os.unlink(path)
        return PSState(doc["params"], doc["momenta"], doc["versions"])

    def launches(self) -> dict:
        """The server process's launch count of every kernel, by name."""
        return self._call("launches")["launches"]

    def reset_launches(self) -> None:
        self._call("reset")

    def profile_start(self) -> None:
        """Start ``torch.profiler`` (CPU and CUDA activities) over every
        thread of the server process, its handler threads included."""
        self._call("profile_start")

    def profile_stop(self, path: str) -> None:
        """Stop it and write its Chrome trace to ``path``."""
        self._call("profile_stop " + os.path.abspath(path))

    def close(self) -> None:
        """Stop the server and wait for its process (killed after
        ``_CLOSE_TIMEOUT_S``); idempotent."""
        p, self.proc = self.proc, None
        if p is not None:
            try:
                p.stdin.close()  # end of the pipe: the server stops
            except OSError:
                pass
            try:
                p.wait(timeout=_CLOSE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        shutil.rmtree(self._work, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "proc", None) is not None:
            self.proc.kill()


# ---------------------------------------------------------------- the process

def _say(**doc) -> None:
    sys.stdout.write(_MARK + json.dumps(doc) + "\n")
    sys.stdout.flush()


def _exit_after(seconds: float, why: str) -> None:
    def run():
        time.sleep(seconds)
        sys.stderr.write(f"ps_process: {why} ({seconds} s); exiting\n")
        os._exit(124)
    threading.Thread(target=run, daemon=True).start()


def _counters() -> list:
    from brpc_tpu_torch.ops import flash_attention as fa
    from brpc_tpu_torch.ops import fused_update as fu
    from brpc_tpu_torch.ops import quantize as qz

    return [fu.LAUNCHES, fu.LAUNCHES_F16, fu.LAUNCHES_BF16,
            qz.LAUNCHES_INT8, qz.LAUNCHES_FP8, fa.LAUNCHES]


def _profiler(cuda: bool):
    """A torch profiler over every thread of this process: the server's
    handlers run on the native callback pool's threads, which a profiler
    sees only with the all-threads config (where this torch has it)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        from torch._C._profiler import _ExperimentalConfig

        cfg = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return profile(activities=acts)
    return profile(activities=acts, experimental_config=cfg)


def _serve(args) -> None:
    from brpc_tpu_torch.runtime.param_server import ParameterServer
    from brpc_tpu_torch.runtime.tensor import TensorArena

    _exit_after(args.timeout_s, "time limit")
    params = torch.load(os.path.join(args.work, "init.pt"),
                        weights_only=True)
    ps = ParameterServer(params, lr=args.lr, momentum=args.momentum,
                         arena=TensorArena(args.arena_bytes),
                         device=args.device, oneside=bool(args.oneside))
    del params
    prof = None
    _say(port=ps.start())
    try:
        for line in sys.stdin:
            cmd, _, arg = line.strip().partition(" ")
            if cmd == "state":
                st = ps.state()
                path = os.path.join(args.work, "state.pt")
                torch.save({"params": {k: v.cpu() for k, v in
                                       st.params.items()},
                            "momenta": {k: v.cpu() for k, v in
                                        st.momenta.items()},
                            "versions": dict(st.versions)}, path)
                _say(path=path)
            elif cmd == "launches":
                _say(launches={c.name: c.value for c in _counters()})
            elif cmd == "reset":
                for c in _counters():
                    c.reset()
                _say(ok=True)
            elif cmd == "profile_start" and prof is None:
                prof = _profiler(ps.device.type == "cuda")
                prof.start()
                _say(ok=True)
            elif cmd == "profile_stop" and prof is not None:
                if ps.device.type == "cuda":
                    torch.cuda.synchronize(ps.device)
                prof.stop()
                prof.export_chrome_trace(arg)
                prof = None
                _say(ok=True)
            else:
                _say(error=f"unexpected command {line.strip()!r}")
    finally:
        _exit_after(30.0, "stop did not finish")
        ps.stop()
        ps.server.close()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="A ParameterServer process "
                                 "(started by ServerProcess).")
    ap.add_argument("--root", required=True)
    ap.add_argument("--work", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--arena-bytes", type=int, default=256 << 20)
    ap.add_argument("--oneside", type=int, default=0)
    ap.add_argument("--timeout-s", type=float, default=600.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    try:
        _serve(args)
    except Exception as e:  # noqa: BLE001 — reported to the caller
        _say(error=f"{type(e).__name__}: {e}")
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
