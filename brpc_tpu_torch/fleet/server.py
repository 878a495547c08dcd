"""FleetServer: one parameter-server shard of a fleet.

A thin composition — a shard-aware `ParameterServer` (which already
speaks the Handoff/Install/Retire/Commit resharding handshake) plus a
registry `Registration` heartbeating its address under the fleet's tag.
Starting the server IS joining the fleet: the registry watch edge reaches
the Migrator sub-second, which then streams this shard its ketama-owned
keys. Stopping deregisters (a crash reaches watchers at TTL expiry
instead).
"""

from __future__ import annotations

from typing import Dict, Optional

from brpc_tpu_torch.fleet.registry import Registration
from brpc_tpu_torch.runtime.param_server import ParameterServer
from brpc_tpu_torch.runtime.tensor import TensorArena


class FleetServer:
    """A registered parameter-server shard ("host:port" in the fleet).
    Its ``ParameterServer`` holds tensors on ``device`` (default CUDA);
    other keyword arguments (``lr``, ``momentum``, ``oneside``,
    ``oneside_codec``) go to it."""

    def __init__(self, registry_hostport: str,
                 params: Optional[Dict] = None, tag: str = "param",
                 shard_name: Optional[str] = None, ttl_s: int = 3,
                 host: str = "127.0.0.1",
                 arena: Optional[TensorArena] = None, device=None,
                 **ps_kwargs):
        self.registry_hostport = registry_hostport
        self.tag = tag
        self.host = host
        self.ttl_s = ttl_s
        self.ps = ParameterServer(params or {}, arena=arena, device=device,
                                  name=shard_name, **ps_kwargs)
        self._registration: Optional[Registration] = None
        self.addr: Optional[str] = None

    def start(self, addr: str = "") -> str:
        """Start serving and join the fleet; returns this shard's addr."""
        port = self.ps.start(addr or f"{self.host}:0")
        self.addr = f"{self.host}:{port}"
        self._registration = Registration(self.registry_hostport, self.addr,
                                          tag=self.tag,
                                          ttl_s=self.ttl_s).start()
        return self.addr

    def leave(self) -> None:
        """Deregister (graceful leave) while still serving — the reshard
        drains this shard's keys before it finally stops."""
        if self._registration is not None:
            self._registration.stop()
            self._registration = None

    def stop(self) -> None:
        self.leave()
        self.ps.stop()
