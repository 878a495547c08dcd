"""Ring & tree collective schedules — the pure topology math.

The port's own copy of brpc_tpu/collectives/ring.py (pure arithmetic, no
import of the JAX package): members of either package derive the same
spans and hops, so they can share one ring.

The chunk-schedule discipline follows "Memory-efficient array
redistribution" (PAPERS.md): a collective over an S-byte tensor never
materializes more than one chunk per peer in flight — the tensor splits
into ``n`` near-equal contiguous spans and every hop moves exactly one
span, so peak extra memory is O(S/n) per member and the wire pipeline
(PipelineWindow one level down) stays busy with bounded staging.

Ring allreduce is the classic two-phase schedule (reduce-scatter then
allgather, 2(n-1) hops moving 2S(n-1)/n bytes per member — bandwidth-
optimal); the tree schedule is the latency play for SMALL tensors where
2(n-1) serialized hops of a few KB are all fixed cost: leaves send to
the root, the root reduces and broadcasts (2 hops at any n).

Everything here is pure arithmetic on ``(rank, n)`` — no numpy, no
native, no transport — so the unit tests can pin the schedules
exhaustively.
"""

from __future__ import annotations

from typing import List, Tuple


def ring_order(members) -> List[str]:
    """The ring: members sorted — every participant derives the SAME
    order from the registry's membership list with no coordination (the
    ShardMap discipline: the list + a deterministic rule IS the map)."""
    return sorted(set(members))


def chunk_spans(n_elems: int, parts: int) -> List[Tuple[int, int]]:
    """Split ``n_elems`` into ``parts`` contiguous ``(offset, length)``
    spans, sizes differing by at most one (the first ``n % parts`` spans
    take the extra element). Zero-length spans are legal — a tensor
    smaller than the ring still reduces correctly, the empty hops just
    carry empty payloads."""
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    base, extra = divmod(n_elems, parts)
    spans, off = [], 0
    for i in range(parts):
        ln = base + (1 if i < extra else 0)
        spans.append((off, ln))
        off += ln
    return spans


def fragment_spans(n_elems: int, frag_elems: int) -> List[Tuple[int, int]]:
    """Split one hop's chunk into wire fragments of at most
    ``frag_elems`` elements — the PipelineWindow-level chunking: the
    sender stages/encodes fragment f+1 while fragment f flies, the
    receiver reduces fragments as they land, and peak staging stays
    O(window x frag) instead of O(chunk) (the array-redistribution
    memory discipline). Every member derives the SAME fragmentation
    from the globally-known span length, so no count needs negotiating.
    A zero-length chunk is one empty fragment (the lockstep must not
    skip a message slot)."""
    if frag_elems < 1:
        raise ValueError(f"frag_elems must be >= 1, got {frag_elems}")
    if n_elems == 0:
        return [(0, 0)]
    out, off = [], 0
    while off < n_elems:
        ln = min(frag_elems, n_elems - off)
        out.append((off, ln))
        off += ln
    return out


def reduce_scatter_steps(rank: int, n: int) -> List[Tuple[int, int]]:
    """The n-1 reduce-scatter hops for ``rank``: step ``s`` sends chunk
    ``(rank - s) % n`` to the successor and receives chunk
    ``(rank - s - 1) % n`` from the predecessor (added into the local
    accumulator). After the last step, ``rank`` holds the fully reduced
    chunk ``owned_chunk(rank, n)``."""
    return [((rank - s) % n, (rank - s - 1) % n) for s in range(n - 1)]


def owned_chunk(rank: int, n: int) -> int:
    """The chunk whose reduction completes at ``rank``."""
    return (rank + 1) % n


def allgather_steps(rank: int, n: int) -> List[Tuple[int, int]]:
    """The n-1 allgather hops: step ``s`` sends chunk
    ``(rank + 1 - s) % n`` (the owned chunk first, then each chunk as it
    arrives — a pure forward, no recompute) and receives chunk
    ``(rank - s) % n``."""
    return [((rank + 1 - s) % n, (rank - s) % n) for s in range(n - 1)]


def reduce_order(chunk_idx: int, n: int) -> List[int]:
    """The rank order in which contributions accumulate into chunk
    ``chunk_idx`` under the ring schedule — ``[chunk_idx, chunk_idx+1,
    ... mod n]``. This makes the raw (fp32) ring reduction BIT-exact
    reproducible: summing members' chunks left-to-right in this order
    yields the identical float result, the reference the byte-identity
    tests (and any debugging of a quantized drift) compare against."""
    return [(chunk_idx + i) % n for i in range(n)]


def tree_root(n: int) -> int:
    return 0


def tree_gather_srcs(n: int) -> List[int]:
    """The rank order the root reduces leaf contributions in
    (deterministic: ascending rank — the reference order)."""
    return list(range(1, n))
