"""Fleet observability vars.

Gauges ride ``repointable_gauge`` because fleet roles restart within one
process (tests, reconnects) while tbvar registrations are immortal: the
newest publisher of a name wins. Counters are plain get-or-create. The
series carry the port's ``torch_`` prefix (one tbvar namespace per
process, which the JAX package's fleet may share):

  torch_fleet_shards                 live shards in the current map
  torch_fleet_map_epoch              registry index the map is built on
  torch_fleet_resharding             1 while a migration is executing
  torch_fleet_migration_moving       tensors still to move (nonzero after
                                     a reshard = it could not converge)
  torch_fleet_migration_moved_total  tensors handed off (counter)
  torch_fleet_migration_bytes_total  parameter bytes migrated (counter)
"""

from __future__ import annotations

from typing import Callable


def publish(name: str, fn: Callable[[], int]) -> None:
    """(Re)point gauge ``torch_fleet_<name>`` at ``fn``."""
    from brpc_tpu_torch.observability import metrics as obs

    # Names come from this package's fixed publish() sites.
    obs.repointable_gauge(f"torch_fleet_{name}", fn)  # tpulint: allow(metric-name)


def counter(name: str):
    from brpc_tpu_torch.observability import metrics as obs

    # Fixed call sites only (migration_moved_total / _bytes_total).
    return obs.counter(f"torch_fleet_{name}")  # tpulint: allow(metric-name)
