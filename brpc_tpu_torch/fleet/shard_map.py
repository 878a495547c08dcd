"""ShardMap: which parameter-server shard owns which tensor.

Pure Python, and the JAX package's placement exactly: the same ring
points, so a fleet mixing both packages agrees on every owner.

The default placement is the SAME ketama ring the native `c_ketama` load
balancer builds (load_balancer.cpp RingPolicy::kKetama — libketama
proper): md5("addr-rep") digests yield four 32-bit ring points each, 100
vnodes per weight unit, and a key routes to the first point clockwise of
the low-32 bits of md5(key). Reimplementing the layout here (instead of
binding the C++ ring) keeps the map computable by ANY fleet participant
from the registry's membership list alone — client, migrator and bench
all derive byte-identical ownership with no coordination RPC.

Ketama's zero-collateral property (pinned natively by test_lb.cpp
ketama_remap_fraction_on_removal, and at the fleet level by the fleet
tests): adding shard N+1 moves only ~1/(N+1) of the keys
and moves them ONLY onto the new shard — the minimal-key-movement
foundation the resharding planner builds its transfer schedule on.

Explicit per-tensor assignment (`overrides`) escapes the ring for pinned
placements (e.g. co-locating a layer's tensors). An override applies
only while its target is a live member — otherwise the key falls back to
the ring (and snaps back when the target rejoins); overridden keys never
move on unrelated membership changes.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

_VNODES = 100  # per weight unit — matches native ConsistentHashLB::kVNodes


def _ring_points(addr: str, weight: int = 1) -> List[Tuple[int, str]]:
    """libketama placement: 4 points per md5("addr-rep") digest,
    little-endian 32-bit words — byte-identical to the native kKetama ring
    for the same addr strings."""
    points = []
    for rep in range((min(weight, 100) * _VNODES + 3) // 4):
        d = hashlib.md5(f"{addr}-{rep}".encode()).digest()
        for j in range(4):
            h = (d[3 + j * 4] << 24 | d[2 + j * 4] << 16 |
                 d[1 + j * 4] << 8 | d[0 + j * 4])
            points.append((h, addr))
    return points


def key_point(name: str) -> int:
    """A key's position on the ring: low-32 bits of md5(name) — the
    request_code contract the native ring expects from its callers."""
    d = hashlib.md5(name.encode()).digest()
    return d[3] << 24 | d[2] << 16 | d[1] << 8 | d[0]


class ShardMap:
    """An immutable epoch-stamped assignment of parameter names to shard
    addresses ("host:port"). Equality of (epoch, shards, overrides) makes
    two maps interchangeable; `owner()` is pure."""

    def __init__(self, shards: Iterable[str], epoch: int = 0,
                 overrides: Optional[Dict[str, str]] = None):
        self.shards: Tuple[str, ...] = tuple(sorted(set(shards)))
        self.epoch = epoch
        self.overrides = dict(overrides or {})
        points: List[Tuple[int, str]] = []
        for addr in self.shards:
            points.extend(_ring_points(addr))
        points.sort()
        self._points = points
        self._keys = [p[0] for p in points]

    def __len__(self) -> int:
        return len(self.shards)

    def __contains__(self, addr: str) -> bool:
        return addr in self.shards

    def owner(self, name: str) -> str:
        """The shard serving `name` under this map."""
        ov = self.overrides.get(name)
        if ov is not None and ov in self.shards:  # dead target: ring rules
            return ov
        if not self._points:
            raise LookupError("shard map is empty (no live shards)")
        i = bisect.bisect_left(self._keys, key_point(name))
        if i == len(self._points):
            i = 0  # the ring wraps
        return self._points[i][1]

    def preference(self, name: str,
                   limit: Optional[int] = None) -> List[str]:
        """Distinct shards in RING ORDER from `name`'s point: element 0
        is ``owner()``; the rest are the deterministic spill order (a
        quota/drain answer at the owner walks clockwise to the next
        distinct shard — the ketama replica-choice rule, so every router
        instance derives the SAME fallback chain with no coordination).
        A live override leads the list like it leads ownership."""
        out: List[str] = []
        ov = self.overrides.get(name)
        if ov is not None and ov in self.shards:
            out.append(ov)
        if not self._points:
            if not out:
                raise LookupError("shard map is empty (no live shards)")
            return out
        if limit is not None and len(out) >= limit:
            return out  # the override head counts toward the limit
        i = bisect.bisect_left(self._keys, key_point(name))
        n = len(self._points)
        for j in range(n):
            addr = self._points[(i + j) % n][1]
            if addr not in out:
                out.append(addr)
                if limit is not None and len(out) >= limit:
                    break
        return out

    def assignment(self, names: Iterable[str]) -> Dict[str, List[str]]:
        """Group `names` by owning shard -> {addr: [names...]}, the
        scatter plan for a cross-shard pull_all/push_all."""
        groups: Dict[str, List[str]] = {}
        for name in names:
            groups.setdefault(self.owner(name), []).append(name)
        return groups

    def with_shards(self, shards: Iterable[str], epoch: int) -> "ShardMap":
        """The successor map for a new membership list. Overrides carry
        over in full — `owner()` applies them only while their target is a
        member, so a departed target falls back to the ring and snaps
        back if it rejoins."""
        return ShardMap(shards, epoch=epoch, overrides=self.overrides)

    def moved_keys(self, new_map: "ShardMap",
                   names: Iterable[str]) -> Dict[str, Tuple[str, str]]:
        """The minimal key-movement set between this map and `new_map`:
        {name: (old_owner, new_owner)} for exactly the names whose owner
        changes. With ketama placement this is ~|names|/(N+1) keys on a
        join and ~|names|/N on a leave — never a full reshuffle."""
        moves = {}
        for name in names:
            old = self.owner(name)
            new = new_map.owner(name)
            if old != new:
                moves[name] = (old, new)
        return moves

    def __repr__(self) -> str:  # /tensorz-adjacent debugging
        return (f"ShardMap(epoch={self.epoch}, shards={list(self.shards)}, "
                f"overrides={len(self.overrides)})")
