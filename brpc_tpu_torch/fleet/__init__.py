"""Sharded parameter-server fleet with live resharding.

Parameters shard across N servers by the ketama ring the native
``c_ketama`` balancer uses; membership rides the framework's watch-mode
registry; cross-shard ``pull_all``/``push_all`` scatter/gather over
per-shard ``PipelineWindow``s; and a ``Migrator`` keeps placement
converged through joins and leaves with a two-phase per-tensor handoff
that clients never observe as a torn or stale read. The JAX package's
fleet, on the port's servers and clients: both speak one wire, so a
fleet may mix shards, clients and migrators of the two packages.

  ShardMap      name -> shard placement (ketama ring / explicit overrides)
  registry      HTTP glue over native/trpc/registry.* (watch mode)
  FleetServer   one shard: ParameterServer + registry heartbeat
  FleetClient   scatter/gather client with mid-reshard routing
  Migrator      watch-triggered planner + bandwidth-bounded migrator
"""

from brpc_tpu_torch.fleet.fleet_client import FleetClient
from brpc_tpu_torch.fleet.migrator import (Migrator, Move, ReshardPlan,
                                           plan_reshard, regime_assignment)
from brpc_tpu_torch.fleet.registry import (Registration, RegistryHub,
                                           RegistryWatcher, clear_registry,
                                           deregister, install_registry,
                                           list_servers, register)
from brpc_tpu_torch.fleet.server import FleetServer
from brpc_tpu_torch.fleet.shard_map import ShardMap, key_point

__all__ = [
    "FleetClient", "FleetServer", "Migrator", "Move", "Registration",
    "RegistryHub", "RegistryWatcher", "ReshardPlan", "ShardMap",
    "clear_registry", "deregister", "install_registry", "key_point",
    "list_servers", "plan_reshard", "regime_assignment", "register",
]
