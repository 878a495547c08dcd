"""Session routing for the serving fleet: sticky ketama placement with
quota/drain-aware spill, and the redirect-following fleet client.

The JAX package's ``serving/router.py`` in the port; host-only, it
touches no device.

:class:`ServingRouter` is pure placement: the registry's membership list
(or a static member list) through the same ketama
:class:`~brpc_tpu_torch.fleet.shard_map.ShardMap` the parameter fleet
routes by, keyed by SESSION ID. Every router instance (every client
process, every prefill server picking a handoff destination) derives
the same owner and the same clockwise spill chain from the membership
list alone, with no coordination RPC. Two local signals bias that walk:
the penalty box (an ELIMIT/E_DRAINING answer benches that member for the
server's retry_after hint, always the override) and, with
``load_aware=True``, a background scrape of each member's /vars through
the /fleetz fold (live sessions + tokens/s, bounded TTL, never on the
open path), which orders the SPILL half lightest-first. The sticky owner
stays first either way: load bias redirects overflow, not placement.

:class:`ServingFleetClient` is one client to the whole fleet: ``open``
routes sticky by session id with spill, prefers prefill members when the
fleet is disaggregated, and returns a :class:`FleetTokenStream` whose
reads FOLLOW ``moved:`` redirects: an E_SESSION_MOVED-coded close (or a
"moved:<addr>" E-frame) triggers a ``Gen/Resume`` at the destination
carrying ``have`` = tokens already received, so the stream stays
prefix-exact across live migrations and prefill/decode handoffs.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, Iterator, List, Optional

from brpc_tpu_torch.fleet.shard_map import ShardMap
from brpc_tpu_torch.runtime import native
from brpc_tpu_torch.runtime.param_server import (E_EXISTS, E_MIGRATING,
                                                 E_MOVED, E_NO_SUCH)
from brpc_tpu_torch.serving.client import (ServingClient, SessionShed,
                                           TokenStream)


class ServingRouter:
    """Sticky session placement over the fleet membership.

    ``members=`` pins a static list (pure mode: tier-1 determinism units
    and embedded rings); otherwise membership comes from the registry
    tag and ``refresh()`` re-derives the map. ``penalize()`` implements
    the load/quota awareness: a benched member drops to the BACK of the
    candidate walk until its penalty expires (it never disappears — with
    everyone benched, the walk still visits everyone)."""

    # A refresh() inside this window is a no-op: routing reads per-open
    # must not each pay a registry round trip (membership edges are
    # sub-second via the watch plane, and spill covers the lag).
    REFRESH_TTL_S = 0.5

    def __init__(self, registry_hostport: Optional[str] = None,
                 tag: str = "serving",
                 members: Optional[List[str]] = None,
                 load_aware: bool = False, load_ttl_s: float = 1.0):
        if registry_hostport is None and members is None:
            raise ValueError("need a registry hostport or a member list")
        self._registry = registry_hostport
        self._tag = tag
        self._mu = threading.Lock()
        self._penalty: Dict[str, float] = {}
        self._map: Optional[ShardMap] = None
        self._last_refresh = 0.0
        if members is not None:
            self._map = ShardMap(members)
        # Load-aware spill: a background scraper
        # folds each member's /vars through the /fleetz fold into
        # (live sessions, tokens/s) rollups with a bounded TTL. The open
        # path only ever READS the cache — routing never blocks on a
        # scrape, and a member that stops answering simply ages out to
        # "unknown" (ring order, like a fresh joiner).
        self.load_ttl_s = load_ttl_s
        self._load: Dict[str, tuple] = {}  # addr -> (sessions, tokens_s)
        self._load_at: Dict[str, float] = {}
        self._load_stop = threading.Event()
        self._load_thread: Optional[threading.Thread] = None
        if load_aware:
            self._load_thread = threading.Thread(
                target=self._load_loop, daemon=True, name="router-load")
            self._load_thread.start()

    def close(self) -> None:
        """Stop the load scraper (no-op without load_aware)."""
        self._load_stop.set()
        if self._load_thread is not None:
            self._load_thread.join(timeout=5)
            self._load_thread = None

    # ---- load scraping (reused /fleetz fold, background only) ----

    def _fetch_vars(self, addr: str) -> Optional[str]:
        """One member's /vars page (every member's tstd port also speaks
        HTTP — the FleetObserver scrape path); None on any failure."""
        import urllib.request
        try:
            with urllib.request.urlopen(f"http://{addr}/vars",
                                        timeout=1.0) as resp:
                return resp.read().decode(errors="replace")
        except Exception:  # noqa: BLE001 — dead member: no load data
            return None

    def ingest_load(self, addr: str, vars_text: str) -> None:
        """Fold one member's /vars dump into the load cache — the SAME
        generic fold /fleetz and the FleetObserver twin ride, so the
        router's view of "busy" is the observability plane's."""
        from brpc_tpu_torch.observability.fleet_view import fold_vars

        fold = fold_vars(vars_text)
        with self._mu:
            self._load[addr] = (fold["serving_sessions"],
                                fold["serving_tokens_s"])
            self._load_at[addr] = time.monotonic()

    def scrape_loads(self) -> None:
        """One scrape pass over members whose cached load is stale."""
        now = time.monotonic()
        with self._mu:
            members = list(self._map.shards) if self._map is not None \
                else []
            stale = [a for a in members
                     if now - self._load_at.get(a, 0.0) >= self.load_ttl_s]
        for addr in stale:
            text = self._fetch_vars(addr)
            if text is not None:
                self.ingest_load(addr, text)

    def _load_loop(self) -> None:
        while not self._load_stop.wait(self.load_ttl_s / 2):
            try:
                self.refresh()
                self.scrape_loads()
            except Exception:  # noqa: BLE001 — scrape must never die
                pass

    def _load_key(self, addr: str, ring_index: int, now: float):
        """Sort key for the spill half: (sessions, tokens/s) ascending —
        lightest member first — with the ring position as the stable tie
        break so routing stays deterministic for a given load snapshot.
        Expired/absent data reads as zero load (a fresh joiner SHOULD
        attract spill)."""
        if now - self._load_at.get(addr, -1e9) <= 3 * self.load_ttl_s:
            sessions, tokens_s = self._load.get(addr, (0, 0.0))
        else:
            sessions, tokens_s = 0, 0.0
        return (sessions, tokens_s, ring_index)

    def refresh(self, force: bool = False) -> None:
        if self._registry is None:
            return  # static membership: nothing to poll
        with self._mu:
            if not force and self._map is not None and \
                    time.monotonic() - self._last_refresh \
                    < self.REFRESH_TTL_S:
                return
        from brpc_tpu_torch.fleet import registry

        index, addrs = registry.list_servers(self._registry, self._tag)
        with self._mu:
            self._last_refresh = time.monotonic()
            if self._map is None or self._map.shards != tuple(
                    sorted(set(addrs))):
                self._map = ShardMap(addrs, epoch=index)

    def members(self) -> List[str]:
        with self._mu:
            return list(self._map.shards) if self._map is not None else []

    def route(self, session_id: str) -> str:
        """The sticky owner for ``session_id`` (ignores penalties —
        pure placement; ``candidates`` is the spill-aware walk)."""
        with self._mu:
            if self._map is None or not len(self._map):
                raise LookupError("no serving members")
            return self._map.owner(session_id)

    def candidates(self, session_id: str) -> List[str]:
        """The spill walk: the sticky owner first, then the ring
        clockwise with the SPILL half reordered lightest-first from the
        cached load rollups (no cache = pure ring order), and
        currently-penalized members moved to the back regardless of load
        (the penalty box stays the override). Deterministic given the
        same membership, penalty and load-snapshot state."""
        with self._mu:
            if self._map is None or not len(self._map):
                raise LookupError("no serving members")
            pref = self._map.preference(session_id)
            now = time.monotonic()
            for addr in [a for a in self._penalty
                         if self._penalty[a] <= now]:
                del self._penalty[addr]
            benched = self._penalty
            spill = sorted(
                ((a, i) for i, a in enumerate(pref[1:], 1)),
                key=lambda ai: self._load_key(ai[0], ai[1], now))
            walk = pref[:1] + [a for a, _ in spill]
            return ([a for a in walk if a not in benched]
                    + [a for a in walk if a in benched])

    def penalize(self, addr: str, for_s: float = 0.1) -> None:
        with self._mu:
            self._penalty[addr] = max(self._penalty.get(addr, 0.0),
                                      time.monotonic() + for_s)


class FleetTokenStream:
    """A TokenStream that survives migrations: reads follow
    E_SESSION_MOVED closes / "moved:" E-frames through ``Gen/Resume``
    transparently. ``tokens`` is the full prefix-exact list;
    ``resumes``/``last_gap_s`` expose the migration cost (the bench's
    stream-gap statistic)."""

    def __init__(self, client: "ServingFleetClient", session_id: str,
                 ts: TokenStream, addr: str):
        self._fc = client
        self.session_id = session_id
        self._ts = ts
        self.addr = addr          # member currently serving the stream
        self.tokens: List[int] = []
        self.opened_at = time.monotonic()
        self.ttft_s: Optional[float] = None
        self.resumes = 0
        self.last_gap_s: Optional[float] = None
        self._done = False
        self._failed: Optional[Exception] = None

    def read_token(self, timeout_ms: int = -1) -> Optional[int]:
        """Next token, None on timeout; StopIteration at clean EOF;
        SessionShed for a NON-migration shed. A migration shed resumes
        at the destination and keeps reading. A FAILED resume is sticky:
        later reads re-raise it — a truncated stream must never read as
        a clean EOF."""
        if self._failed is not None:
            raise self._failed
        if self._done:
            raise StopIteration
        while True:
            try:
                tok = self._ts.read_token(timeout_ms)
            except StopIteration:
                self._done = True
                raise
            except SessionShed as e:
                if e.code != native.E_SESSION_MOVED:
                    self._done = True
                    raise
                gap_t0 = time.monotonic()
                try:
                    self._follow(e.moved)
                except Exception as follow_err:
                    self._failed = follow_err
                    raise
                self.resumes += 1
                self.last_gap_s = time.monotonic() - gap_t0
                continue
            if tok is None:
                return None
            if self.ttft_s is None:
                self.ttft_s = time.monotonic() - self.opened_at
            self.tokens.append(tok)
            return tok

    def _follow(self, hint: Optional[str]) -> None:
        ts, addr = self._fc._resume(self.session_id, len(self.tokens),
                                    hint=hint, last_addr=self.addr)
        self._ts.stream.close()
        self._ts = ts
        self.addr = addr

    def __iter__(self) -> Iterator[int]:
        while True:
            try:
                tok = self.read_token()
            except StopIteration:
                return
            if tok is not None:
                yield tok

    def close(self) -> None:
        self._done = True
        self._failed = None  # an explicit close ends the error contract
        # TokenStream.close sends Gen/Close at the CURRENT owner when the
        # stream is still live, and just releases the stream otherwise.
        self._ts.close()

    def __enter__(self) -> "FleetTokenStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ServingFleetClient:
    """One client to a serving fleet: sticky routed opens with spill,
    prefill-preferring when the fleet is disaggregated, migration-
    transparent token streams."""

    def __init__(self, registry_hostport: str, *, tag: str = "serving",
                 tenant: str = "", timeout_ms: int = 5000,
                 prefer_prefill: bool = True,
                 op_deadline_s: float = 15.0,
                 load_aware: bool = False):
        self._registry = registry_hostport
        self.tag = tag
        self.tenant = tenant
        self._timeout_ms = timeout_ms
        self._prefer_prefill = prefer_prefill
        self._deadline_s = op_deadline_s
        self.router = ServingRouter(registry_hostport, tag=tag,
                                    load_aware=load_aware)
        # Disaggregated fleets register prefill-only members under
        # "<tag>-prefill": session opens go there (throughput plane) and
        # the decode ring serves the resumes.
        self.prefill_router = ServingRouter(registry_hostport,
                                            tag=f"{tag}-prefill")
        self._mu = threading.Lock()
        self._clients: Dict[str, ServingClient] = {}

    def _client(self, addr: str) -> ServingClient:
        with self._mu:
            c = self._clients.get(addr)
            if c is None:
                c = ServingClient(addr, tenant=self.tenant,
                                  timeout_ms=self._timeout_ms)
                self._clients[addr] = c
            return c

    # ---- open (routing + spill) ----

    def open(self, prompt: List[int], max_tokens: int = 16, *,
             session_key: Optional[str] = None,
             deadline_ms: Optional[int] = None,
             priority: Optional[int] = None,
             recv_window: int = 256 << 10) -> FleetTokenStream:
        """Route a session open: sticky by ``session_key`` (minted when
        omitted), spilling clockwise on quota/drain/transport answers,
        pacing on every server hint. Prefill members take the open when
        present (their engines run the prompt, then hand the session to
        a decode member — the stream follows automatically)."""
        sid = session_key if session_key is not None \
            else f"g{uuid.uuid4().hex[:16]}"
        deadline = time.monotonic() + self._deadline_s
        delay = 0.01
        last_err: Optional[Exception] = None
        while True:
            ring = self.router
            if self._prefer_prefill:
                try:
                    self.prefill_router.refresh()
                    if self.prefill_router.members():
                        ring = self.prefill_router
                except (OSError, native.RpcError):
                    pass
            if ring is self.router:
                self.router.refresh()
            hint_s = 0.0
            try:
                cands = ring.candidates(sid)
            except LookupError:
                cands = []
            for addr in cands:
                try:
                    ts = self._client(addr).open(
                        prompt, max_tokens, deadline_ms=deadline_ms,
                        priority=priority, recv_window=recv_window,
                        session=sid)
                    return FleetTokenStream(self, sid, ts, addr)
                except native.RpcError as e:
                    last_err = e
                    if e.code == E_EXISTS:
                        raise  # duplicate session key: caller's bug
                    if e.overloaded or e.draining:
                        ring.penalize(
                            addr, (e.retry_after_ms or 50) / 1000.0)
                        hint_s = max(hint_s,
                                     (e.retry_after_ms or 0) / 1000.0)
                        continue
                    continue  # transport-shaped: try the next candidate
            if time.monotonic() >= deadline:
                raise last_err if last_err is not None else LookupError(
                    "no serving members")
            time.sleep(max(delay, hint_s))
            delay = min(delay * 2, 0.25)

    def generate(self, prompt: List[int], max_tokens: int = 16,
                 **kw) -> List[int]:
        with self.open(prompt, max_tokens, **kw) as ts:
            return list(ts)

    # ---- resume (redirect following) ----

    def _resume(self, sid: str, have: int, *, hint: Optional[str],
                last_addr: Optional[str]):
        """Find the session's new home and re-attach: the E-frame's
        forwarding hint first, then the old server's Gen/Locate, then
        the sticky candidate walk — following E_SESSION_MOVED chains,
        backing off on E_MIGRATING, bounded by the op deadline. Returns
        (TokenStream, addr)."""
        deadline = time.monotonic() + self._deadline_s
        delay = 0.01
        last_err: Optional[Exception] = None
        probed_locate = False
        while True:
            queue: List[str] = []
            if hint:
                queue.append(hint)
            if not probed_locate and last_addr and last_addr != hint:
                probed_locate = True
                try:
                    dest = self._client(last_addr).locate(sid)
                    if dest:
                        queue.append(dest)
                except (native.RpcError, RuntimeError, OSError):
                    pass  # the old server may already be gone
            try:
                self.router.refresh()
                queue.extend(a for a in self.router.candidates(sid)
                             if a not in queue)
            except (LookupError, OSError, native.RpcError):
                pass
            tried = set()
            migrating = False
            hint_s = 0.0
            while queue:
                addr = queue.pop(0)
                if addr in tried:
                    continue
                tried.add(addr)
                try:
                    ts = self._client(addr).resume(sid, have)
                    return ts, addr
                except native.RpcError as e:
                    last_err = e
                    dest = e.moved_to
                    if dest and dest not in tried:
                        queue.insert(0, dest)  # follow the chain first
                        continue
                    if e.code in (E_MIGRATING, E_MOVED) or e.overloaded \
                            or e.draining:
                        migrating = True
                        hint_s = max(hint_s,
                                     (e.retry_after_ms or 0) / 1000.0)
                    continue  # E_NO_SUCH / transport: next candidate
            if time.monotonic() >= deadline:
                raise last_err if last_err is not None else native.RpcError(
                    E_NO_SUCH, f"session {sid} not found in the fleet")
            if not migrating and last_err is not None \
                    and getattr(last_err, "code", None) == E_NO_SUCH \
                    and hint is None:
                # Every member disowns it with stable membership: gone.
                raise last_err
            hint = None  # a stale hint must not pin the loop
            time.sleep(max(delay, hint_s))
            delay = min(delay * 2, 0.25)

    def close(self) -> None:
        self.router.close()
        self.prefill_router.close()
        with self._mu:
            clients, self._clients = self._clients, {}
        for c in clients.values():
            c.close()

    def __enter__(self) -> "ServingFleetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
