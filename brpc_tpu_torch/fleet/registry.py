"""Fleet membership over the native watch-mode service registry.

The registry IS the framework's (native/trpc/registry.{h,cpp}): a
process-global table served by every native server's builtin HTTP port
once installed (capi `tbrpc_registry_install`). This module is the Python
face — plain JSON-over-HTTP, no new wire surface:

  POST /registry/register    {"addr","tag","ttl_s"}   (heartbeat renews)
  POST /registry/deregister  {"addr"}
  GET  /registry/list?tag=t[&index=V&wait_ms=M]       (blocking watch)

Watch mode rides the registry's consul-style blocking query: a GET with
`index=V` parks its server FIBER until the membership version advances
past V, so joins/leaves reach every watcher at propagation speed
(sub-second) instead of poll cadence — the trigger edge the fleet's
resharding Migrator acts on.

All calls here run on plain Python threads (never inside RPC handlers),
so blocking urllib I/O is safe. The table belongs to the native library
the caller loaded; processes (and the two data planes) meet over HTTP.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from typing import Callable, List, Optional, Tuple

from brpc_tpu_torch.runtime import native


def install_registry() -> None:
    """Make every native server in this process answer /registry/* on its
    builtin HTTP port (idempotent, process-global table)."""
    native.lib().tbrpc_registry_install()


def clear_registry() -> None:
    """Drop every entry (test isolation — the table is process-global)."""
    native.lib().tbrpc_registry_clear()


class RegistryHub:
    """A minimal standalone registry endpoint: one native server whose
    only job is serving /registry/* (any RPC server of the fleet could
    play this role instead — the table is process-global)."""

    def __init__(self):
        install_registry()
        self.server = native.Server()
        self.port: Optional[int] = None

    def start(self, addr: str = "127.0.0.1:0") -> str:
        self.port = self.server.start(addr)
        return self.hostport

    @property
    def hostport(self) -> str:
        return f"127.0.0.1:{self.port}"

    def stop(self) -> None:
        self.server.stop()


def _post(hostport: str, path: str, doc: dict, timeout_s: float = 5.0) -> str:
    req = urllib.request.Request(
        f"http://{hostport}{path}", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return resp.read().decode()


def register(hostport: str, addr: str, tag: str = "",
             ttl_s: int = 10) -> None:
    _post(hostport, "/registry/register",
          {"addr": addr, "tag": tag, "ttl_s": ttl_s})


def deregister(hostport: str, addr: str) -> None:
    _post(hostport, "/registry/deregister", {"addr": addr})


def list_servers(hostport: str, tag: str = "", index: Optional[int] = None,
                 wait_ms: int = 0) -> Tuple[int, List[str]]:
    """-> (membership_index, [addr, ...]). With `index`, blocks server-side
    until membership changes past it (or wait_ms elapses) — watch mode."""
    q = []
    if tag:
        q.append(f"tag={tag}")
    if index is not None:
        q.append(f"index={index}")
        q.append(f"wait_ms={wait_ms}")
    url = f"http://{hostport}/registry/list"
    if q:
        url += "?" + "&".join(q)
    timeout_s = 5.0 + (wait_ms / 1000.0 if index is not None else 0.0)
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        doc = json.loads(resp.read().decode())
    return int(doc["index"]), sorted(s["addr"] for s in doc["servers"])


class Registration:
    """Keep one address registered: heartbeat at ttl/3 from a daemon
    thread (two lost beats still leave the entry alive — the native
    RegistryClient's cadence), deregister on stop()."""

    def __init__(self, hostport: str, addr: str, tag: str = "",
                 ttl_s: int = 10):
        self.hostport = hostport
        self.addr = addr
        self.tag = tag
        self.ttl_s = max(1, ttl_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beats = 0

    def start(self) -> "Registration":
        register(self.hostport, self.addr, self.tag, self.ttl_s)  # eager:
        self.beats = 1  # visible to watchers before start() returns
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"fleet-reg-{self.addr}")
        self._thread.start()
        return self

    def _run(self) -> None:
        interval = self.ttl_s / 3.0
        while not self._stop.wait(interval):
            try:
                register(self.hostport, self.addr, self.tag, self.ttl_s)
                self.beats += 1
            except (urllib.error.URLError, OSError):
                pass  # registry may be down/restarting; keep heartbeating

    def stop(self, deregister_now: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if deregister_now:
            try:
                deregister(self.hostport, self.addr)
            except (urllib.error.URLError, OSError):
                pass  # TTL expiry will prune us


class RegistryWatcher:
    """Long-poll the membership list and fire `on_change(index, addrs)`
    from a daemon thread on every membership-version advance — the
    sub-second join/leave edge the Migrator replans on. The callback also
    fires once with the initial list."""

    def __init__(self, hostport: str, tag: str,
                 on_change: Callable[[int, List[str]], None],
                 wait_ms: int = 2000):
        self.hostport = hostport
        self.tag = tag
        self.on_change = on_change
        self.wait_ms = wait_ms
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.index: Optional[int] = None
        self.addrs: List[str] = []

    def start(self) -> "RegistryWatcher":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-registry-watch")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                index, addrs = list_servers(self.hostport, self.tag,
                                            index=self.index,
                                            wait_ms=self.wait_ms)
            except (urllib.error.URLError, OSError):
                if self._stop.wait(0.2):  # registry unreachable: back off
                    return
                continue
            if self._stop.is_set():
                return
            if index != self.index or addrs != self.addrs:
                self.index, self.addrs = index, addrs
                try:
                    self.on_change(index, list(addrs))
                except Exception:  # noqa: BLE001 — a watcher callback bug
                    pass           # must not kill the watch loop

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # The in-flight long poll answers within wait_ms (TTL-capped
            # server-side), so a generous join covers it.
            self._thread.join(timeout=self.wait_ms / 1000.0 + 6)
