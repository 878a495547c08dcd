"""Fleet-wide observability: one trace, one scrape, one pane of glass.

The JAX package's ``observability/fleet_view.py`` in the port (it touches
no device):

  * **Cross-process trace assembly**: trace_id/span_id propagate on the
    tstd wire, so every process that touched a sampled trace holds its
    legs in its own span ring. ``FleetObserver`` scrapes each member's
    ``/rpcz?format=json&trace=HEX`` plus the local ring and stitches ONE
    parentage-correct tree, with per-source clock skew estimated from
    matched client/server span pairs (intersected Cristian-style offset
    bounds, :func:`estimate_skew_us`) and corrected so a child span nests
    inside its parent whichever wall clock was ahead.
  * **Registry-driven metric/health aggregation**: every live member's
    /brpc_metrics + /healthz (+ the /vars and /flags detail the native
    /fleetz page folds) as one Prometheus exposition with a ``shard``
    label on every series, plus fleet rollups (sum qps, max p99, worst
    health, codec ratio, max version lag, the serving columns). The
    rollups repoint the ``torch_fleet_*`` gauges of the local registry
    (:meth:`FleetObserver.publish_rollup_gauges`).
  * **Honesty about disabled rpcz**: a member with span collection off
    is named (``RpczDisabled`` locally, ``enabled:false`` in the scrape
    envelope, ``rpcz_off`` on an assembled trace), never an empty list.

The fold reads each column under the port's ``torch_`` series name first
and under the plain name otherwise (``torch_serving_token_emit_qps``
before ``serving_token_emit_qps``, and so on): a process may hold both
packages, whose tbvar names share one namespace, so the port's series
carry the prefix, and a port observer reads a port fleet and a mixed one
alike. The native /fleetz page reads only the plain names.

The assembly/skew/relabel/fold core is PURE (plain dicts in, plain dicts
out); only the scraping methods touch HTTP and the native library.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.error
import urllib.request
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

ZERO_ID = "0" * 16

# The prefix of the port's tbvar series (one namespace per process).
PORT_PREFIX = "torch_"

# Severity order for the fleet health rollup (mirrors the native /fleetz).
HEALTH_RANK = {"ok": 0, "degraded": 1, "stalled": 2}
_RANK_NAMES = {0: "ok", 1: "degraded", 2: "stalled", 3: "unreachable"}


# ---------------------------------------------------------------------------
# Pure half: skew estimation + trace assembly (no native lib, no HTTP).
# ---------------------------------------------------------------------------

def estimate_skew_us(spans: List[dict]) -> Dict[str, float]:
    """Per-source clock offset (microseconds to ADD to a source's
    timestamps to land on the reference source's clock).

    Every cross-source parent/child pair (a client span in process A
    whose server span ran in process B) BOUNDS the offset: with
    non-negative transit delays both ways, the true offset lies in
    ``[P.start - S.start, P.end - S.end]`` (Cristian's algorithm).  The
    bounds intersect per source pair and the midpoint is the estimate —
    for a single link this degenerates to the classic NTP formula
    ``((P.start - S.start) + (P.end - S.end)) / 2``, and whenever the
    intersection is non-empty (no drift between samples) the estimate
    nests EVERY sampled child inside its parent after correction.
    Averaging samples instead is NOT safe: one asymmetric-delay link
    (e.g. a connection-setup RPC with a long request leg) drags the mean
    outside another link's bound and pushes that child before its
    parent.  Offsets then chain outward (BFS) from the reference source
    — the root span's process — so the assembled timeline reads in the
    CLIENT's clock.  Sources with no cross-source link to the reference
    keep offset 0.
    """
    by_id = {s["span_id"]: s for s in spans}
    # (parent_source, child_source) -> [lo, hi] offset bounds mapping
    # the child's clock onto the parent's.
    bounds: Dict[Tuple[str, str], List[float]] = {}
    for s in spans:
        p = by_id.get(s.get("parent_span_id", ZERO_ID))
        if p is None or p["source"] == s["source"]:
            continue
        lo = float(p["start_us"] - s["start_us"])
        hi = float(p["end_us"] - s["end_us"])
        cur = bounds.setdefault((p["source"], s["source"]), [lo, hi])
        cur[0] = max(cur[0], lo)
        cur[1] = min(cur[1], hi)
    # Midpoint of the intersection; an empty intersection (inter-sample
    # clock drift, or negative-delay measurement noise) still yields the
    # least-violating point.
    edges: Dict[Tuple[str, str], float] = {
        pair: (lo + hi) / 2.0 for pair, (lo, hi) in bounds.items()}
    # Reference: the root span's source. GENUINE roots (parent id zero)
    # outrank orphans (parent never scraped), and client-side spans
    # outrank server-side — otherwise a missing root process (local rpcz
    # off) would anchor the timeline on whichever shard's UNCORRECTED
    # clock happens to sort first, i.e. the shard running furthest
    # behind.
    ref = None
    candidates = [s for s in spans
                  if s.get("parent_span_id", ZERO_ID) == ZERO_ID or
                  s["parent_span_id"] not in by_id]
    if candidates:
        ref = min(candidates, key=lambda s: (
            s.get("parent_span_id", ZERO_ID) != ZERO_ID,
            bool(s.get("server_side")), s["start_us"]))["source"]
    if ref is None and spans:
        ref = spans[0]["source"]
    offsets: Dict[str, float] = {src: 0.0 for s in spans
                                 for src in (s["source"],)}
    if ref is None:
        return offsets
    offsets[ref] = 0.0
    resolved = {ref}
    queue = [ref]
    while queue:
        cur = queue.pop(0)
        for (psrc, csrc), off in edges.items():
            # Walk both directions: child-of-resolved and
            # parent-of-resolved (a shard could also parent a span that
            # ran back on the client — symmetric chains still resolve).
            if psrc == cur and csrc not in resolved:
                offsets[csrc] = offsets[cur] + off
                resolved.add(csrc)
                queue.append(csrc)
            elif csrc == cur and psrc not in resolved:
                offsets[psrc] = offsets[cur] - off
                resolved.add(psrc)
                queue.append(psrc)
    return offsets


@dataclass
class AssembledTrace:
    """One cross-process trace: skew-corrected spans linked into a tree."""

    trace_id: str
    spans: List[dict] = field(default_factory=list)  # corrected, by start
    roots: List[dict] = field(default_factory=list)  # parentless, by start
    children: Dict[str, List[dict]] = field(default_factory=dict)
    skew_us: Dict[str, int] = field(default_factory=dict)
    sources: List[str] = field(default_factory=list)
    rpcz_off: List[str] = field(default_factory=list)    # blind sources
    unreachable: List[str] = field(default_factory=list)
    unscraped: List[str] = field(default_factory=list)   # over MAX_SCRAPE

    @property
    def root(self) -> Optional[dict]:
        return self.roots[0] if self.roots else None

    def walk(self):
        """Yield (depth, span) depth-first from each root, children in
        corrected start order (cycle-safe: a span visits once)."""
        seen = set()

        def rec(span, depth):
            key = span["span_id"]
            if key in seen:
                return
            seen.add(key)
            yield depth, span
            for child in self.children.get(key, ()):
                yield from rec(child, depth + 1)

        for r in self.roots:
            yield from rec(r, 0)

    def render(self) -> str:
        """The fleet timeline as indented text (the /rpcz?trace= view,
        but across every process that touched the trace)."""
        lines = [f"trace {self.trace_id} — {len(self.spans)} span(s) from "
                 f"{len(self.sources)} source(s)"]
        for src in self.sources:
            lines.append(f"  clock {src}: {self.skew_us.get(src, 0):+d}us")
        for src in self.rpcz_off:
            lines.append(f"  WARNING {src}: rpcz disabled — its legs are "
                         "missing from this trace")
        for src in self.unreachable:
            lines.append(f"  WARNING {src}: unreachable during scrape")
        for src in self.unscraped:
            lines.append(f"  WARNING {src}: not scraped (membership over "
                         f"the {MAX_SCRAPE}-member scrape bound)")
        base = self.roots[0]["start_us"] if self.roots else 0
        for depth, s in self.walk():
            lines.append(
                "  " * (depth + 1) +
                f"[{'S' if s.get('server_side') else 'C'}] "
                f"{s.get('service_method', '?'):<32} "
                f"+{s['start_us'] - base}us "
                f"{s['end_us'] - s['start_us']}us "
                f"shard={s['source']}")
            for a in s.get("annotations", ()):
                lines.append("  " * (depth + 2) + f"@ {a}")
        return "\n".join(lines)


def assemble_trace(trace_id: str,
                   spans_by_source: Dict[str, List[dict]],
                   rpcz_off: Iterable[str] = (),
                   unreachable: Iterable[str] = (),
                   unscraped: Iterable[str] = ()) -> AssembledTrace:
    """Stitch every process's spans for one trace into a corrected tree.

    `spans_by_source`: {source_name: [span dicts as /rpcz?format=json
    emits them]} — the source name is typically the shard's registry
    address, plus "local" for the in-process dump. Spans from other
    traces are dropped; duplicate span_ids (one process scraped under two
    names) keep the first sighting. Timestamps come back SKEW-CORRECTED
    onto the root process's clock, so child spans nest inside their
    parents and sibling order is meaningful.
    """
    trace_id = trace_id if isinstance(trace_id, str) else f"{trace_id:016x}"
    spans: List[dict] = []
    seen_ids = set()
    for source, source_spans in spans_by_source.items():
        for s in source_spans:
            if s.get("trace_id") != trace_id:
                continue
            if s["span_id"] in seen_ids:
                continue
            seen_ids.add(s["span_id"])
            spans.append(dict(s, source=source))
    out = AssembledTrace(trace_id=trace_id,
                         rpcz_off=sorted(rpcz_off),
                         unreachable=sorted(unreachable),
                         unscraped=sorted(unscraped))
    if not spans:
        return out
    # Order before skew estimation so the reference-source pick (first
    # parentless span) is deterministic: oldest first.
    spans.sort(key=lambda s: (s["start_us"], s["span_id"]))
    skew = estimate_skew_us(spans)
    for s in spans:
        off = int(round(skew.get(s["source"], 0.0)))
        s["start_us"] += off
        s["end_us"] += off
        s["skew_applied_us"] = off
    spans.sort(key=lambda s: (s["start_us"], s["span_id"]))
    out.spans = spans
    out.skew_us = {src: int(round(v)) for src, v in skew.items()}
    out.sources = sorted({s["source"] for s in spans})
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        parent = s.get("parent_span_id", ZERO_ID)
        if parent != ZERO_ID and parent in by_id:
            out.children.setdefault(parent, []).append(s)
        else:
            out.roots.append(s)
    return out


# ---------------------------------------------------------------------------
# Pure half: Prometheus relabeling + scrape folding.
# ---------------------------------------------------------------------------

# One exposition series line: name, optional {labels}, value.
_SERIES_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)\s*$")


def relabel_exposition(text: str, shard: str) -> str:
    """Inject ``shard="<addr>"`` into every series of one shard's
    /brpc_metrics exposition (existing labels are preserved). Comment
    lines (# HELP/# TYPE) are DROPPED — in the merged fleet exposition
    they would repeat per shard, which the format forbids."""
    esc = shard.replace("\\", "\\\\").replace('"', '\\"')
    out = []
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if m is None:
            continue  # unparseable line: safer to drop than corrupt
        name, labels, value = m.groups()
        if labels:
            labels = labels[:-1] + f',shard="{esc}"}}'
        else:
            labels = f'{{shard="{esc}"}}'
        out.append(f"{name}{labels} {value}")
    return "\n".join(out)


def _fold_plain(pairs: Iterable[Tuple[str, str]]) -> Tuple[dict, set]:
    """One namespace's raw /fleetz columns over (name, value) pairs, and
    the set of columns some series fed."""
    out = {"qps": 0.0, "p99_us": 0, "codec_bytes_logical": 0,
           "codec_bytes_wire": 0, "version_lag_max": 0,
           "serving_tokens_s": 0.0, "serving_sessions": 0,
           "serving_ttft_p99_us": 0, "serving_spec_proposed": 0,
           "serving_spec_accepted": 0, "serving_prefix_hits": 0,
           "serving_prefix_misses": 0}
    seen = set()
    for name, value in pairs:
        try:
            if name.startswith("rpc_server_"):
                if name.endswith("_qps"):
                    out["qps"] += float(value)
                    seen.add("qps")
                elif name.endswith("_latency_99"):
                    out["p99_us"] = max(out["p99_us"], int(float(value)))
                    seen.add("p99_us")
            elif name == "tensor_codec_bytes_logical":
                out["codec_bytes_logical"] = int(float(value))
                seen.add("codec_bytes_logical")
            elif name == "tensor_codec_bytes_wire":
                out["codec_bytes_wire"] = int(float(value))
                seen.add("codec_bytes_wire")
            elif name.startswith("param_server_version_lag_"):
                out["version_lag_max"] = max(out["version_lag_max"],
                                             int(float(value)))
                seen.add("version_lag_max")
            elif name == "serving_token_emit_qps":
                # One recorder sample per emitted token: qps IS tokens/s.
                out["serving_tokens_s"] = float(value)
                seen.add("serving_tokens_s")
            elif name == "serving_ttft_latency_99":
                out["serving_ttft_p99_us"] = int(float(value))
                seen.add("serving_ttft_p99_us")
            elif name in _PLAIN_COUNTS:
                out[name] = int(float(value))
                seen.add(name)
        except ValueError:
            continue  # non-numeric var under a matched prefix
    return out, seen


# Columns read straight from the series of the same name.
_PLAIN_COUNTS = ("serving_sessions", "serving_spec_proposed",
                 "serving_spec_accepted", "serving_prefix_hits",
                 "serving_prefix_misses")


def _fold_series(pairs: Iterable[Tuple[str, str]]) -> dict:
    """The native /fleetz per-shard fold: sum qps / max p99 over the
    rpc_server_* recorders, the codec byte counters, the max
    param_server_version_lag_*, and the serving_* columns (tokens/s,
    live sessions, TTFT p99) — over (name, value) series pairs. A column
    fed by a ``torch_``-prefixed series takes that value; otherwise the
    plain series'."""
    plain, port = [], []
    for name, value in pairs:
        if name.startswith(PORT_PREFIX):
            port.append((name[len(PORT_PREFIX):], value))
        else:
            plain.append((name, value))
    out, _ = _fold_plain(plain)
    ported, seen = _fold_plain(port)
    out.update({k: ported[k] for k in seen})
    # The accept-rate column: cumulative accepted/proposed (0 when the
    # member never speculated — spec off reads as 0%, not a gap).
    prop = out["serving_spec_proposed"]
    out["serving_spec_accept_pct"] = (
        round(100.0 * out["serving_spec_accepted"] / prop, 1)
        if prop else 0.0)
    # Prefix-cache hit rate, same discipline: aggregate hits/lookups
    # (monolithic members never look up — 0%, not a gap).
    lookups = out["serving_prefix_hits"] + out["serving_prefix_misses"]
    out["serving_prefix_hit_pct"] = (
        round(100.0 * out["serving_prefix_hits"] / lookups, 1)
        if lookups else 0.0)
    return out


def fold_vars(text: str) -> dict:
    """:func:`_fold_series` from one shard's /vars dump
    ("name : value" lines)."""
    return _fold_series(
        (name.strip(), value.strip())
        for name, sep, value in (line.partition(" : ")
                                 for line in text.splitlines()) if sep)


def fold_exposition(text: str) -> dict:
    """:func:`_fold_series` from a Prometheus exposition — lets
    :meth:`FleetObserver.fleet_prometheus` derive its rollup numbers
    from the /brpc_metrics text it fetches anyway instead of paying an
    extra /vars GET per shard. Labels are ignored (a single process's
    exposition carries none)."""
    def pairs():
        for line in text.splitlines():
            if line.startswith("#"):
                continue
            m = _SERIES_RE.match(line)
            if m is not None:
                yield m.group(1), m.group(3)
    return _fold_series(pairs())


def fold_flags(text: str) -> dict:
    """rpcz collection state from one shard's /flags page."""
    out = {"rpcz_enabled": -1, "rpcz_sample_1_in_n": 0}
    for line in text.splitlines():
        for key in out:
            if line.startswith(key + " = "):
                try:
                    out[key] = int(line[len(key) + 3:].split()[0])
                except (ValueError, IndexError):
                    pass
    return out


def rollup(shards: List[dict]) -> dict:
    """Fleet rollup over per-shard scrape rows (the /fleetz rollup shape):
    sum qps, max p99, WORST health, aggregate codec ratio, max lag —
    plus the serving columns: aggregate tokens/s, live sessions, worst
    TTFT p99."""
    worst = 0
    logical = wire = 0
    roll = {"members": len(shards),
            "reachable": sum(1 for s in shards if s.get("reachable")),
            "qps_total": sum(s.get("qps", 0) for s in shards),
            "p99_max_us": max([s.get("p99_us", 0) for s in shards],
                              default=0),
            "version_lag_max": max([s.get("version_lag_max", 0)
                                    for s in shards], default=0),
            "serving_tokens_s_total": sum(s.get("serving_tokens_s", 0.0)
                                          for s in shards),
            "serving_sessions_total": sum(s.get("serving_sessions", 0)
                                          for s in shards),
            "serving_ttft_p99_max_us": max(
                [s.get("serving_ttft_p99_us", 0) for s in shards],
                default=0),
            "rpcz_off": sorted(s["addr"] for s in shards
                               if s.get("rpcz_enabled") == 0)}
    spec_prop = spec_acc = 0
    pfx_hits = pfx_misses = 0
    for s in shards:
        worst = max(worst, HEALTH_RANK.get(s.get("health"), 3))
        logical += s.get("codec_bytes_logical", 0)
        wire += s.get("codec_bytes_wire", 0)
        spec_prop += s.get("serving_spec_proposed", 0)
        spec_acc += s.get("serving_spec_accepted", 0)
        pfx_hits += s.get("serving_prefix_hits", 0)
        pfx_misses += s.get("serving_prefix_misses", 0)
    roll["health_worst"] = _RANK_NAMES[worst] if shards else "empty"
    roll["codec_ratio"] = (logical / wire) if wire > 0 else 0.0
    # Fleet accept rate = aggregate accepted/proposed, NOT a mean of
    # per-shard percentages (a near-idle shard must not swing it).
    roll["serving_spec_accept_pct"] = (
        round(100.0 * spec_acc / spec_prop, 1) if spec_prop else 0.0)
    # Fleet prefix-cache hit rate: aggregate hits/lookups, same rule.
    lookups = pfx_hits + pfx_misses
    roll["serving_prefix_hit_pct"] = (
        round(100.0 * pfx_hits / lookups, 1) if lookups else 0.0)
    return roll


# ---------------------------------------------------------------------------
# FleetObserver: the scraping half (HTTP + capi).
# ---------------------------------------------------------------------------

# Fan-out bound shared with the native /fleetz page: scrape at most this
# many members per call (thread count + document size), and REPORT the
# truncation — silent caps read as "covered everything".
MAX_SCRAPE = 64


class FleetObserver:
    """Registry-driven observer over a shard fleet.

    Scrapes run over plain HTTP against each member's builtin console
    (every shard's tstd port also speaks HTTP), from plain Python threads
    — never inside RPC handlers — CONCURRENTLY across members (like the
    native /fleetz fiber fan-out: one dead shard costs one timeout, not
    one timeout per dead shard serially). The native /fleetz page is the
    same machinery server-side; this class is for trainers/tools that
    want the assembled objects rather than a rendered page.
    """

    def __init__(self, registry_hostport: str, tag: str = "param",
                 timeout_s: float = 3.0, include_local: bool = True):
        self._registry = registry_hostport
        self._tag = tag
        self._timeout_s = timeout_s
        # Include this process's own span ring under source "local" —
        # the client root span of a scatter/gather lives HERE, not on any
        # shard, and without it the assembled trace has no root.
        self._include_local = include_local
        self._mu = threading.Lock()
        self._last_rollup: dict = {}
        self._gauges_published = False

    # ---- membership / plumbing ----

    def members(self) -> List[str]:
        from brpc_tpu_torch.fleet import registry

        _index, addrs = registry.list_servers(self._registry, self._tag)
        return addrs

    def _scrape_members(self, fn) -> Tuple[List, List[str]]:
        """Run fn(addr) over the live membership concurrently (bounded
        at MAX_SCRAPE), results in membership order; returns
        (results, dropped_addrs) — dropped = members over the bound,
        NOT scraped, reported by every caller."""
        addrs = self.members()
        dropped = addrs[MAX_SCRAPE:]
        addrs = addrs[:MAX_SCRAPE]
        if not addrs:
            return [], dropped
        with ThreadPoolExecutor(max_workers=min(16, len(addrs)),
                                thread_name_prefix="fleet-scrape") as pool:
            return list(pool.map(fn, addrs)), dropped

    def _get(self, addr: str, path: str) -> str:
        with urllib.request.urlopen(f"http://{addr}{path}",
                                    timeout=self._timeout_s) as resp:
            return resp.read().decode(errors="replace")

    # ---- cross-process trace assembly ----

    def scrape_rpcz(self, addr: str, trace_id: int = 0) -> dict:
        """One shard's span scrape: {"enabled", "sample_1_in_n", "spans"}.
        Raises urllib.error.URLError/OSError when the shard is down."""
        path = "/rpcz?format=json"
        if trace_id:
            path += f"&trace={trace_id:016x}"
        return json.loads(self._get(addr, path))

    def local_spans(self, trace_id: int = 0) -> List[dict]:
        from brpc_tpu_torch.observability import tracing

        return tracing.dump_rpcz(trace_id)  # raises RpczDisabled when off

    def assemble(self, trace_id,
                 extra_sources: Optional[Dict[str, List[dict]]] = None
                 ) -> AssembledTrace:
        """Assemble ONE cross-process trace from the live fleet (+ the
        local span ring): scrape every member's /rpcz for the trace, then
        stitch/skew-correct. `trace_id` is an int or 16-hex string.
        Shards with rpcz off land in `.rpcz_off`; down shards in
        `.unreachable` — missing legs are NAMED, never silent."""
        from brpc_tpu_torch.observability import tracing

        tid = int(trace_id, 16) if isinstance(trace_id, str) else trace_id
        by_source: Dict[str, List[dict]] = dict(extra_sources or {})
        rpcz_off: List[str] = []
        unreachable: List[str] = []
        if self._include_local:
            try:
                by_source.setdefault("local", self.local_spans(tid))
            except tracing.RpczDisabled:
                rpcz_off.append("local")

        def scrape(addr: str):
            if addr in by_source:
                return addr, None, None
            try:
                return addr, self.scrape_rpcz(addr, tid), None
            except (urllib.error.URLError, OSError, ValueError) as e:
                return addr, None, e

        results, dropped = self._scrape_members(scrape)
        for addr, doc, err in results:
            if doc is None:
                if err is not None:
                    unreachable.append(addr)
                continue
            if not doc.get("enabled", False):
                rpcz_off.append(addr)
            by_source[addr] = doc.get("spans", [])
        return assemble_trace(f"{tid:016x}", by_source,
                              rpcz_off=rpcz_off, unreachable=unreachable,
                              unscraped=dropped)

    # ---- metric / health aggregation ----

    def scrape_shard(self, addr: str, tag: str = "",
                     detail: bool = True) -> dict:
        """One /fleetz-shaped row for one shard (reachable=False rows
        carry only the address). detail=False stops after /healthz —
        for callers that derive the metric fold from a dump they fetch
        anyway (:meth:`fleet_prometheus`)."""
        row = {"addr": addr, "tag": tag, "reachable": False,
               "health": "unreachable"}
        try:
            health = json.loads(self._get(addr, "/healthz"))
        except (urllib.error.URLError, OSError, ValueError):
            return row
        row["reachable"] = True
        row["health"] = health.get("state", "unknown")
        if health.get("reason"):
            row["reason"] = health["reason"]
        if not detail:
            return row
        try:
            row.update(fold_vars(self._get(addr, "/vars")))
            row.update(fold_flags(self._get(addr, "/flags")))
        except (urllib.error.URLError, OSError):
            pass  # health answered but the detail scrape raced a restart
        return row

    def fleetz(self) -> dict:
        """The /fleetz document, computed in Python: per-shard rows +
        fleet rollup (+ "unscraped" when the membership exceeds the
        MAX_SCRAPE bound). Also refreshes the cached rollup the
        published fleet_* gauges read."""
        shards, dropped = self._scrape_members(self.scrape_shard)
        roll = rollup(shards)
        with self._mu:
            self._last_rollup = roll
        doc = {"shards": shards, "rollup": roll}
        if dropped:
            doc["unscraped"] = dropped
        return doc

    def fleet_health(self) -> Dict[str, str]:
        """{addr: health state} — min/worst is rollup()["health_worst"]."""
        return {row["addr"]: row["health"]
                for row in self.fleetz()["shards"]}

    def fleet_prometheus(self) -> str:
        """ONE Prometheus exposition for the whole fleet: every member's
        /brpc_metrics relabeled with shard="<addr>", plus the rollup
        series. Unreachable members contribute a
        fleet_shard_up{shard=...} 0 marker instead of vanishing. Two
        GETs per member (/healthz + /brpc_metrics): the rollup numbers
        fold straight from the exposition already in hand."""
        def scrape(addr: str):
            row = self.scrape_shard(addr, detail=False)
            exposition = None
            if row["reachable"]:
                try:
                    exposition = self._get(addr, "/brpc_metrics")
                    row.update(fold_exposition(exposition))
                except (urllib.error.URLError, OSError):
                    row["reachable"] = False
                    row["health"] = "unreachable"
            return row, exposition

        results, dropped = self._scrape_members(scrape)
        parts: List[str] = []
        rows: List[dict] = []
        for row, exposition in results:
            rows.append(row)
            esc = row["addr"].replace("\\", "\\\\").replace('"', '\\"')
            up = 1 if row["reachable"] else 0
            parts.append(f'fleet_shard_up{{shard="{esc}"}} {up}')
            if row["reachable"] and exposition is not None:
                parts.append(relabel_exposition(exposition, row["addr"]))
        for addr in dropped:  # over the bound: marked, not silent
            esc = addr.replace("\\", "\\\\").replace('"', '\\"')
            parts.append(f'fleet_shard_up{{shard="{esc}"}} 0')
        roll = rollup(rows)
        with self._mu:
            self._last_rollup = roll
        parts.append(self._rollup_exposition(roll))
        return "\n".join(p for p in parts if p) + "\n"

    @staticmethod
    def _rollup_exposition(roll: dict) -> str:
        worst_rank = {v: k for k, v in _RANK_NAMES.items()}.get(
            roll.get("health_worst"), 3)
        return "\n".join([
            f"fleet_qps_total {roll['qps_total']:.1f}",
            f"fleet_p99_max_us {roll['p99_max_us']}",
            f"fleet_health_worst {worst_rank}",
            f"fleet_codec_ratio_x1000 {int(roll['codec_ratio'] * 1000)}",
            f"fleet_version_lag_max {roll['version_lag_max']}",
            f"fleet_members_reachable {roll['reachable']}",
            f"fleet_serving_tokens_s_total "
            f"{roll['serving_tokens_s_total']:.1f}",
            f"fleet_serving_sessions_total "
            f"{roll['serving_sessions_total']}",
            f"fleet_serving_ttft_p99_max_us "
            f"{roll['serving_ttft_p99_max_us']}",
            f"fleet_serving_spec_accept_pct "
            f"{roll.get('serving_spec_accept_pct', 0.0):.1f}",
            f"fleet_serving_prefix_hit_pct "
            f"{roll.get('serving_prefix_hit_pct', 0.0):.1f}",
        ])

    def publish_rollup_gauges(self) -> None:
        """Repoint the ``torch_fleet_*`` rollup gauges in the LOCAL native
        registry at this observer's last fleetz()/fleet_prometheus()
        snapshot, so the observing process's own /vars + /brpc_metrics
        show the fleet numbers. The gauge callbacks read the CACHED snapshot (scrape-time
        callbacks must stay trivial — they run under the native registry
        lock; call fleetz() on your own cadence to refresh)."""
        from brpc_tpu_torch.observability import metrics as obs

        # Weakly bound like every other repointable fleet gauge: a closed
        # observer must not be pinned by the immortal holder table.
        ref = weakref.ref(self)

        def reader(key: str, scale: float = 1.0):
            def _read() -> int:
                o = ref()
                if o is None:
                    return 0
                with o._mu:
                    return int(o._last_rollup.get(key, 0) * scale)
            return _read

        def worst_reader() -> int:
            o = ref()
            if o is None:
                return 0
            with o._mu:
                name = o._last_rollup.get("health_worst", "empty")
            return {v: k for k, v in _RANK_NAMES.items()}.get(name, 0)

        for name, fn in (
                ("qps_total", reader("qps_total")),
                ("p99_max_us", reader("p99_max_us")),
                ("health_worst", worst_reader),
                ("codec_ratio_x1000", reader("codec_ratio", 1000.0)),
                ("version_lag_max", reader("version_lag_max")),
                ("members_reachable", reader("reachable")),
                ("serving_tokens_s_total", reader("serving_tokens_s_total")),
                ("serving_sessions_total", reader("serving_sessions_total")),
                ("serving_ttft_p99_max_us",
                 reader("serving_ttft_p99_max_us")),
                ("serving_spec_accept_pct",
                 reader("serving_spec_accept_pct")),
                ("serving_prefix_hit_pct",
                 reader("serving_prefix_hit_pct"))):
            # Fixed names from this table only, under PORT_PREFIX
            # ("torch_").  tpulint: allow(metric-namespace-torch)
            obs.repointable_gauge(f"{PORT_PREFIX}fleet_{name}", fn)  # tpulint: allow(metric-name)
        self._gauges_published = True
