"""Adaptive scheduler: routes admission batches to engine replicas (port
of ``distributed_inference_server_tpu/serving/scheduler.py``, without the
fleet's learned wire rates and mesh routes). A fleet member's engines are
replicas too: ``RemoteRunner`` proxies (``serving/remote_runner.py``),
registered and unregistered by the registry host's ``FleetServer``.

- **round-robin**: rotate over healthy engines;
- **least-loaded**: fewest active + waiting requests;
- **memory-aware**: most effectively free KV pages;
- **cache-aware**: deepest matched prefix against each replica's published
  digest, and with a ``PrefixFetcher`` the three-way route / fetch /
  recompute cost model (``plan_route``);
- strategy switching at runtime (``set_strategy``), replicas registered
  and unregistered at runtime (``POST /admin/scale``);
- health checking: unhealthy replicas leave the routing set, and with
  ``auto_restart`` the health loop restarts them with a jittered
  exponential backoff after a failed restart.

The strategy core (``choose_engine``, ``plan_route``) is pure over
``EngineStatus`` vectors, so its choices are testable without engines and
comparable with the reference's on the same inputs.
"""

from __future__ import annotations

import enum
import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from distributed_inference_server_tpu_torch.engine.kv_cache import (
    DIGEST_DEPTH,
    chain_hashes,
)
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving.health import health_rank
from distributed_inference_server_tpu_torch.serving.metrics import (
    EngineStatus,
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    EngineRunner,
)

logger = logging.getLogger(__name__)


class SchedulingStrategy(str, enum.Enum):
    ROUND_ROBIN = "round_robin"
    LEAST_LOADED = "least_loaded"
    MEMORY_AWARE = "memory_aware"
    CACHE_AWARE = "cache_aware"

    @classmethod
    def parse(cls, value: str) -> "SchedulingStrategy":
        return cls(value.strip().lower())


def health_tier(statuses: Sequence[EngineStatus]) -> List[EngineStatus]:
    """Keep only the best health tier present: healthy replicas when any
    exist, else degraded, else ejected. A degraded replica takes no new
    traffic while a healthy one can serve, and when every admissible
    replica is ejected they are all admitted again (a possibly sick
    replica beats a certain 503)."""
    pool = list(statuses)
    if not pool:
        return pool
    best = min(health_rank(getattr(s, "health", "healthy")) for s in pool)
    if best == 0 and all(
            getattr(s, "health", "healthy") == "healthy" for s in pool):
        return pool  # nothing demoted: no filtering
    return [s for s in pool
            if health_rank(getattr(s, "health", "healthy")) == best]


def prefix_match_depth(status: EngineStatus,
                       prefix_hashes: Optional[Sequence[int]]) -> int:
    """Pages of ``prefix_hashes``, consecutive from the head, present in
    a replica's published digest. A chain is reusable only from its head,
    so the first miss ends the match."""
    digest = getattr(status, "prefix_digest", None)
    if not digest or not prefix_hashes:
        return 0
    depth = 0
    for h in prefix_hashes:
        if h not in digest:
            break
        depth += 1
    return depth


@dataclass(frozen=True)
class FetchCosts:
    """Weights of the cache_aware cost model (``plan_route``), in pages:
    one page of prefill recompute is the unit.

    With the defaults, fetch-to-cold beats route-to-warm exactly when
    ``load_cost_pages * (load_warm - load_cold) > page_cost *
    peer_depth``, and beats recompute whenever ``page_cost < 1``. The
    wire term charges the WHOLE chain (``peer_depth`` pages): the import
    needs a contiguous head-first tiling, so head pages the target
    already holds still cross the wire."""

    enabled: bool = True
    # least fetchable gain (pages) worth a wire transfer
    min_pages: int = 2
    # wire cost of one page, in recompute pages (< 1 or fetching never
    # pays)
    page_cost: float = 0.25
    # one active or waiting request on a replica costs this many pages of
    # queueing delay
    load_cost_pages: float = 4.0
    # wire cost of one page from a remote peer over the fleet's KV data
    # channel (``fleet.kv_page_cost``)
    remote_page_cost: float = 0.6
    # encoded bytes per page as a fraction of raw pool bytes for the
    # configured wire encoding (kv_cache.encoded_page_fraction): the wire
    # term charges what crosses the wire
    wire_frac: float = 1.0


@dataclass(frozen=True)
class PrefixRoutePlan:
    """One cache_aware routing decision (``plan_route``): where the
    request goes and whether the target peer-fetches the matched prefix
    first (``serving/disagg.py`` ``PrefixFetcher``)."""

    engine_id: str
    decision: str  # "warm" | "fetch" | "recompute"
    peer_id: Optional[str] = None  # fetch source (decision == "fetch")
    depth: int = 0  # target's own matched depth, pages
    peer_depth: int = 0  # deepest match among the replicas, pages
    page_size: int = 0  # page size the hashes were computed with
    prefix_hashes: Optional[Tuple[int, ...]] = None


def plan_route(
    statuses: Sequence[EngineStatus],
    prefix_hashes: Optional[Sequence[int]],
    roles: Optional[Sequence[str]] = None,
    costs: Optional[FetchCosts] = None,
    page_size: int = 0,
    wire_cost: Optional[Callable] = None,
    mesh_route: Optional[Callable] = None,
) -> Optional[PrefixRoutePlan]:
    """Three-way cache_aware routing, scored per admissible replica in
    pages::

        cost_route(e) = load_cost * load(e) + (pages - depth(e))
        cost_fetch(e) = load_cost * load(e) + (pages - peer_depth)
                        + page_cost * wire_frac * peer_depth

    where ``peer_depth`` is the deepest match among the healthy replicas
    (any role: the peer only exports, it never takes the request). The
    cheapest option wins; ties prefer route over fetch, then load, then
    engine id, so the plan is deterministic given its inputs. The
    ``sched.fetch_decision`` fault flag forces the cheapest fetch option
    when one exists. None when no healthy admissible replica exists.

    A fleet member's replica (``remote``) takes warm and recompute
    routes like any other (its heartbeated digest scores), but sources a
    fetch only with a KV data channel (``data_plane``, at
    ``remote_page_cost`` a page), and is a fetch target only through the
    mesh: ``mesh_route(target, peer)`` true for a remote peer and a
    target with a data channel (its member then pulls the chunks over
    its own wire, from a fetch hint).

    ``wire_cost(target, peer)``: the learned per-page cost of the wire a
    fetch would cross (``serving/fleet_mesh.py``); None for a cold wire,
    which is charged the constant (``page_cost`` or
    ``remote_page_cost``)."""
    costs = costs or FetchCosts()
    healthy = [s for s in statuses if s.healthy]
    admissible = (healthy if roles is None else
                  [s for s in healthy
                   if getattr(s, "role", "unified") in roles])
    if not admissible:
        return None
    admissible = health_tier(admissible)

    def load(s: EngineStatus) -> int:
        return s.active_requests + s.waiting_requests

    n_pages = len(prefix_hashes) if prefix_hashes else 0
    depths = {s.engine_id: prefix_match_depth(s, prefix_hashes)
              for s in healthy}
    # a fetch source serves an export: a local replica, or a remote one
    # with a data channel, and never an ejected one (its engine or wire
    # is what the scorer judged broken); deepest match wins, a local peer
    # before a remote one, then load, then id
    fetchable = [s for s in healthy
                 if (not getattr(s, "remote", False)
                     or getattr(s, "data_plane", False))
                 and health_rank(getattr(s, "health", "healthy")) < 2]
    peer = (min(fetchable,
                key=lambda s: (-depths[s.engine_id],
                               1 if getattr(s, "remote", False) else 0,
                               load(s), s.engine_id))
            if fetchable else None)
    peer_depth = depths[peer.engine_id] if peer is not None else 0
    peer_page_cost = (costs.remote_page_cost
                      if peer is not None and getattr(peer, "remote", False)
                      else costs.page_cost)
    best_depth = max((depths[s.engine_id] for s in admissible), default=0)
    if n_pages == 0 or (peer_depth == 0 and best_depth == 0):
        eng = min(admissible, key=lambda s: (load(s), s.engine_id))
        return PrefixRoutePlan(eng.engine_id, "recompute",
                               page_size=page_size)
    hashes = tuple(prefix_hashes)
    # (cost, route-first tie-break, load, engine_id, kind, status, depth)
    options: List[tuple] = []
    for s in admissible:
        d = depths[s.engine_id]
        base = costs.load_cost_pages * load(s)
        options.append((base + (n_pages - d), 0, load(s), s.engine_id,
                        "route", s, d))
        target_ok = (not getattr(s, "remote", False)
                     or (mesh_route is not None and peer is not None
                         and getattr(peer, "remote", False)
                         and getattr(s, "data_plane", False)
                         and mesh_route(s, peer)))
        if (costs.enabled and peer is not None
                and s.engine_id != peer.engine_id and target_ok
                and peer_depth - d >= costs.min_pages):
            # the fetch moves the whole chain (pages 0..peer_depth), priced
            # at the wire's learned rate when warm, else the constant, in
            # encoded bytes (wire_frac)
            per_page = wire_cost(s, peer) if wire_cost is not None else None
            if per_page is None:
                per_page = peer_page_cost
            per_page *= costs.wire_frac
            options.append((base + (n_pages - peer_depth)
                            + per_page * peer_depth,
                            1, load(s), s.engine_id, "fetch", s, d))
    if faults.flag("sched.fetch_decision"):
        forced = [o for o in options if o[4] == "fetch"]
        if forced:
            options = forced
    best = min(options, key=lambda o: o[:4])
    _, _, _, _, kind, s, d = best
    if kind == "fetch":
        return PrefixRoutePlan(s.engine_id, "fetch",
                               peer_id=peer.engine_id, depth=d,
                               peer_depth=peer_depth, page_size=page_size,
                               prefix_hashes=hashes)
    return PrefixRoutePlan(s.engine_id, "warm" if d > 0 else "recompute",
                           depth=d, peer_depth=peer_depth,
                           page_size=page_size, prefix_hashes=hashes)


def choose_engine(
    strategy: SchedulingStrategy,
    statuses: Sequence[EngineStatus],
    rr_counter: int,
    roles: Optional[Sequence[str]] = None,
    prefix_hashes: Optional[Sequence[int]] = None,
) -> Optional[str]:
    """Pure strategy core: an engine id among the healthy statuses
    (deterministic given its inputs). ``roles`` restricts the eligible
    set to replicas of those roles (None = all). ``prefix_hashes``
    (cache_aware) scores replicas by matched prefix depth, least-loaded
    breaking ties; with no match anywhere the strategy is least-loaded."""
    healthy = [s for s in statuses if s.healthy]
    if roles is not None:
        healthy = [s for s in healthy
                   if getattr(s, "role", "unified") in roles]
    if not healthy:
        return None
    healthy = health_tier(healthy)
    if strategy is SchedulingStrategy.ROUND_ROBIN:
        return healthy[rr_counter % len(healthy)].engine_id
    if strategy is SchedulingStrategy.CACHE_AWARE:
        depths = {s.engine_id: prefix_match_depth(s, prefix_hashes)
                  for s in healthy}
        if any(depths.values()):
            return min(healthy, key=lambda s: (
                -depths[s.engine_id],
                s.active_requests + s.waiting_requests,
                s.engine_id)).engine_id
        strategy = SchedulingStrategy.LEAST_LOADED  # no warm replica
    if strategy is SchedulingStrategy.LEAST_LOADED:
        return min(healthy, key=lambda s: (
            s.active_requests + s.waiting_requests, s.engine_id)).engine_id
    # memory-aware: most effectively free pages (cached prefix pages are
    # reclaimable on demand, so they count as free), then load, then id
    return min(healthy, key=lambda s: (
        -(s.memory_total_pages
          - (s.memory_used_pages - getattr(s, "pages_cached", 0))),
        s.active_requests + s.waiting_requests,
        s.engine_id)).engine_id


class AdaptiveScheduler:
    """Thread-safe scheduler over registered ``EngineRunner`` replicas."""

    def __init__(
        self,
        strategy: SchedulingStrategy = SchedulingStrategy.LEAST_LOADED,
        health_check_interval_s: float = 1.0,
        auto_restart: bool = False,
        metrics: Optional[MetricsCollector] = None,
        restart_backoff_s: float = 1.0,
        restart_backoff_max_s: float = 30.0,
        fetch_costs: Optional[FetchCosts] = None,
    ):
        """``restart_backoff_s`` / ``restart_backoff_max_s``: after a
        FAILED restart the next attempt waits ``backoff`` (doubling per
        consecutive failure, jittered, capped) instead of retrying every
        health sweep. ``fetch_costs``: the cache_aware cost model's
        weights (None = defaults)."""
        self._strategy = strategy
        self._fetch_costs = fetch_costs or FetchCosts()
        self._engines: Dict[str, EngineRunner] = {}
        self._lock = threading.Lock()
        self._rr = 0
        self._interval = health_check_interval_s
        self._auto_restart = auto_restart
        self.metrics = metrics
        self._backoff_base = restart_backoff_s
        self._backoff_cap = restart_backoff_max_s
        # engine_id -> (not_before monotonic time, last delay); guarded by
        # _lock (written by restart threads, read by the health loop)
        self._backoff: Dict[str, Tuple[float, float]] = {}
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        # replicas with a restart worker in flight; guarded by _lock
        self._restarting: set = set()
        # the gray-failure scorer (serving/health.py), wired by the
        # server; when set, statuses() stamps its verdicts
        self.health_scorer = None
        # the learned wire prices and the mesh gate (serving/fleet_mesh.py),
        # wired by a registry host's server: wire_cost prices the wire a
        # fetch or handoff would cross, mesh_route admits remote fetch
        # targets whose member has a direct wire to the peer
        self.wire_cost: Optional[Callable] = None
        self.mesh_route: Optional[Callable] = None

    # -- registration ------------------------------------------------------

    def register(self, runner: EngineRunner) -> None:
        with self._lock:
            self._engines[runner.engine_id] = runner

    def unregister(self, engine_id: str) -> Optional[EngineRunner]:
        with self._lock:
            return self._engines.pop(engine_id, None)

    def unregister_if(self, engine_id: str,
                      runner: EngineRunner) -> Optional[EngineRunner]:
        """Unregister ``engine_id`` only while it maps to ``runner``: a
        fleet session's late detach must not evict the fresh proxy a
        reconnect registered under the same id."""
        with self._lock:
            if self._engines.get(engine_id) is runner:
                return self._engines.pop(engine_id)
            return None

    def engines(self) -> List[EngineRunner]:
        with self._lock:
            return list(self._engines.values())

    def get(self, engine_id: str) -> Optional[EngineRunner]:
        with self._lock:
            return self._engines.get(engine_id)

    # -- strategy ----------------------------------------------------------

    def strategy(self) -> SchedulingStrategy:
        return self._strategy

    def set_strategy(self, strategy: SchedulingStrategy) -> None:
        self._strategy = strategy

    # -- routing -----------------------------------------------------------

    def statuses(self) -> List[EngineStatus]:
        out = [r.status() for r in self.engines()]
        if self.health_scorer is not None:
            out = self.health_scorer.stamp(out)
        return out

    def schedule(self, prompt_ids: Optional[Sequence[int]] = None
                 ) -> Optional[EngineRunner]:
        """The replica for the next admission batch, or None when no
        healthy replica exists. Decode-role replicas take no admissions
        while a prefill or unified replica is healthy (prompts reach them
        through the KV handoff); with only decode replicas healthy they
        take admissions anyway. ``prompt_ids`` (cache_aware): the
        request's tokens, whose hash chain is scored against each
        replica's digest."""
        return self.schedule_batch([prompt_ids])[0]

    def _admission_roles(self, statuses: Sequence[EngineStatus]
                         ) -> Optional[Tuple[str, ...]]:
        if any(getattr(s, "role", "unified") == "decode" and s.healthy
               for s in statuses):
            non_decode = ("prefill", "unified")
            if any(s.healthy and getattr(s, "role", "unified") in non_decode
                   for s in statuses):
                return non_decode
        return None

    @staticmethod
    def _hash_geometry(statuses: Sequence[EngineStatus]) -> Tuple[int, int]:
        """The page size and digest depth the replicas published (one
        engine config; a 0 page size means none has reported yet)."""
        page_size = next((s.page_size for s in statuses
                          if s.healthy and getattr(s, "page_size", 0) > 0),
                         0)
        depth = next((s.digest_depth for s in statuses
                      if s.healthy and getattr(s, "digest_depth", 0) > 0),
                     DIGEST_DEPTH)
        return page_size, depth

    def schedule_batch(self, prompts: Sequence[Optional[Sequence[int]]]
                       ) -> List[Optional[EngineRunner]]:
        """One pick per prompt against ONE snapshot of the replicas
        (``choose_engine`` is pure, so every request of a window scores
        against the same statuses)."""
        statuses = self.statuses()
        roles = self._admission_roles(statuses)
        hash_ps = digest_depth = 0
        if self._strategy is SchedulingStrategy.CACHE_AWARE:
            hash_ps, digest_depth = self._hash_geometry(statuses)
        out: List[Optional[EngineRunner]] = []
        with self._lock:
            for prompt_ids in prompts:
                prefix_hashes = None
                if hash_ps > 0 and prompt_ids:
                    prefix_hashes = chain_hashes(prompt_ids, hash_ps,
                                                 max_pages=digest_depth)
                engine_id = choose_engine(self._strategy, statuses,
                                          self._rr, roles=roles,
                                          prefix_hashes=prefix_hashes)
                if engine_id is None:
                    out.append(None)
                    continue
                self._rr += 1
                out.append(self._engines.get(engine_id))
        return out

    def schedule_batch_plans(
        self, prompts: Sequence[Optional[Sequence[int]]]
    ) -> List[Tuple[Optional[EngineRunner], Optional[PrefixRoutePlan]]]:
        """Cache-aware dispatch with the three-way cost model: one
        ``(runner, plan)`` per prompt against ONE snapshot. A "fetch"
        plan tells the dispatcher to peer-fetch the matched chain onto
        the chosen (cold) replica before submitting. Prompt hashing stops
        at the published digest depth and at the prompt's penultimate
        page (at least one token is always recomputed)."""
        statuses = self.statuses()
        roles = self._admission_roles(statuses)
        hash_ps, digest_depth = self._hash_geometry(statuses)
        out: List[Tuple[Optional[EngineRunner],
                        Optional[PrefixRoutePlan]]] = []
        with self._lock:
            for prompt_ids in prompts:
                prefix_hashes = None
                if hash_ps > 0 and prompt_ids:
                    cap = (len(prompt_ids) - 1) // hash_ps
                    prefix_hashes = chain_hashes(
                        prompt_ids, hash_ps,
                        max_pages=min(digest_depth, cap))
                plan = plan_route(statuses, prefix_hashes, roles=roles,
                                  costs=self._fetch_costs,
                                  page_size=hash_ps,
                                  wire_cost=self.wire_cost,
                                  mesh_route=self.mesh_route)
                if plan is None:
                    out.append((None, None))
                    continue
                out.append((self._engines.get(plan.engine_id), plan))
        return out

    def schedule_decode(self, exclude: Optional[str] = None,
                        pages: int = 0) -> Optional[EngineRunner]:
        """The migration target of a finished prefill: the least-loaded
        healthy decode-role replica (``exclude`` drops the source). None
        = no decode capacity; the caller decodes in place. A fleet
        member's replica qualifies only when it can import KV
        (``supports_kv_import``: a data channel whose breaker is not
        open).

        With ``wire_cost`` wired and ``pages`` known (the handoff's
        size), each remote candidate is also charged the learned cost of
        moving the pages over its wire, in ``plan_route``'s page units: a
        congested wire loses to a slightly busier local replica."""
        statuses = [r.status() for r in self.engines()
                    if r.engine_id != exclude
                    and (not getattr(r, "is_remote", False)
                         or getattr(r, "supports_kv_import", False))]
        if self.health_scorer is not None:
            statuses = self.health_scorer.stamp(statuses)
        if self.wire_cost is not None and pages > 0:
            decode = [s for s in statuses if s.healthy
                      and getattr(s, "role", "unified") == "decode"]
            if not decode:
                return None
            costs = self._fetch_costs

            def score(s: EngineStatus):
                wire_pages = 0.0
                if getattr(s, "remote", False):
                    # this host is the source: the (registry -> member)
                    # wire; a cold one is charged the constant
                    per_page = self.wire_cost(s, None)
                    if per_page is None:
                        per_page = costs.remote_page_cost
                    wire_pages = per_page * costs.wire_frac * pages
                return (health_rank(getattr(s, "health", "healthy")),
                        costs.load_cost_pages
                        * (s.active_requests + s.waiting_requests)
                        + wire_pages,
                        s.engine_id)

            engine_id = min(decode, key=score).engine_id
        else:
            engine_id = choose_engine(SchedulingStrategy.LEAST_LOADED,
                                      statuses, 0, roles=("decode",))
        if engine_id is None:
            return None
        with self._lock:
            return self._engines.get(engine_id)

    # -- health loop -------------------------------------------------------

    def start_health_loop(self) -> None:
        if self._health_thread is not None:
            return
        self._stop.clear()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="scheduler-health", daemon=True)
        self._health_thread.start()

    def stop_health_loop(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(5.0)
            self._health_thread = None

    def _health_loop(self) -> None:
        while not self._stop.wait(self._interval):
            for runner in self.engines():
                if not getattr(runner, "supports_restart", True):
                    # a fleet proxy: its member restarts the engine, the
                    # registry ages the proxy out
                    continue
                healthy = runner.is_healthy()
                if healthy and self._auto_restart and faults.flag(
                        "sched.health_flap"):
                    # injected flap: the loop sees a live replica as down
                    # for one sweep and restarts it
                    logger.warning("injected health flap: restarting "
                                   "healthy engine %s", runner.engine_id)
                    healthy = False
                if healthy or not self._auto_restart:
                    continue
                with self._lock:
                    # check and add under one hold: a restart worker's
                    # discard must not interleave
                    if runner.engine_id in self._restarting:
                        continue
                    not_before = self._backoff.get(
                        runner.engine_id, (0.0, 0.0))[0]
                    if time.monotonic() < not_before:
                        continue  # backing off after a failed restart
                    self._restarting.add(runner.engine_id)
                threading.Thread(target=self._restart_one, args=(runner,),
                                 daemon=True).start()

    def _restart_one(self, runner: EngineRunner) -> None:
        eid = runner.engine_id
        if self.metrics:
            self.metrics.record_engine_restart(eid)
        try:
            runner.restart(wait_ready=True)
        except Exception:  # noqa: BLE001 — retry after backoff
            with self._lock:
                last = self._backoff.get(eid, (0.0, 0.0))[1]
                delay = (self._backoff_base if last <= 0.0
                         else min(last * 2.0, self._backoff_cap))
                # jitter up to +25%: replicas that died together do not
                # retry (and fail again) in lockstep
                wake = delay * (1.0 + 0.25 * random.random())
                self._backoff[eid] = (time.monotonic() + wake, delay)
            logger.exception(
                "engine %s restart failed; next attempt in %.1fs "
                "(backoff %.1fs, cap %.1fs)", eid, wake, delay,
                self._backoff_cap)
        else:
            with self._lock:
                self._backoff.pop(eid, None)
        finally:
            with self._lock:
                self._restarting.discard(eid)
