"""Serving metrics: Prometheus text for ``GET /metrics`` and the JSON
snapshot of ``GET /server/stats`` (port of
``distributed_inference_server_tpu/serving/metrics.py``: ``EngineStatus``,
``MetricsSnapshot`` and the part of ``MetricsCollector`` that one
unified-role replica records).

The families, their types, label names and histogram buckets are the
reference collector's. The text exposition format (version 0.0.4) is
written here, as ``prometheus_client`` writes it: ``# HELP`` / ``# TYPE``
per family, a counter's samples under ``<name>_total``, a histogram's as
``_bucket{le=...}`` (cumulative, ``+Inf`` last), ``_sum`` and ``_count``,
labels sorted by name. A family with labels shows samples only for the
label values recorded so far; one without shows its zero from the start.

Not here (they come with their modules): the host tier, disaggregated
handoff, peer prefix fetch and routing, the fleet and its registry HA,
restarts and redispatch, admission shedding and gray-failure health, the
request-phase tracing and SLO accounting.

Requests, tokens, admission batches, the admission queue's depth by
priority and tenant, queue expiries, TTFT and step seconds are recorded as
they happen; the engine's own cumulative counters (cache, mixed step,
looped blocks, step clock) and its speculation gauges are set from its
totals when ``/metrics`` or ``/server/stats`` is read (``observe_engine``,
``set_speculation``), so the step loop does no metrics work for them.

Thread-safe: the engine thread, the HTTP handler threads and the
server all record into one collector.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

# rolling windows for the snapshot's derived values
_TOKEN_WINDOW_S = 10.0
_TTFT_WINDOW = 1024
_LATENCY_WINDOW_S = 60.0


@dataclass(frozen=True)
class EngineStatus:
    """Health and load of one engine replica (the reference's fields for
    a unified-role, in-process replica)."""

    engine_id: str
    healthy: bool
    active_requests: int
    waiting_requests: int
    total_processed: int
    # raw page occupancy (pages off the free list, cached prefix pages
    # included); live pressure is used - cached
    memory_used_pages: int = 0
    memory_total_pages: int = 0
    pages_cached: int = 0
    role: str = "unified"
    # engine.spec_stats() (None without a draft model) and
    # engine.mixed_stats() / engine.loop_stats() (None while off)
    speculation: Any = None
    mixed: Any = None
    loop: Any = None
    # engine.host_tier_stats() (None while the host tier is off) and
    # engine.latent_stats() (None without a latent codec)
    host_tier: Any = None
    latent: Any = None

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "engine_id": self.engine_id,
            "healthy": self.healthy,
            "active_requests": self.active_requests,
            "waiting_requests": self.waiting_requests,
            "total_processed": self.total_processed,
            "memory_used_pages": self.memory_used_pages,
            "memory_total_pages": self.memory_total_pages,
            "pages_cached": self.pages_cached,
            "role": self.role,
        }
        if self.speculation is not None:
            d["speculation"] = self.speculation
        if self.mixed is not None:
            d["mixed"] = self.mixed
        if self.loop is not None:
            d["loop"] = self.loop
        if self.host_tier is not None:
            d["host_tier"] = self.host_tier
        if self.latent is not None:
            d["latent"] = self.latent
        return d


@dataclass(frozen=True)
class MetricsSnapshot:
    """The JSON stats snapshot (``/server/stats``)."""

    total_requests: int
    active_requests: int
    tokens_per_second: float
    average_ttft_ms: float
    average_latency_ms: float
    p99_latency_ms: float
    average_batch_size: float
    cache_hit_rate: float
    queue_depth: int
    worker_statuses: Tuple[EngineStatus, ...] = ()
    uptime_seconds: float = 0.0
    # prefix-cache block: allocator hit / miss / eviction totals and the
    # page-granular prefix hits by tier
    cache: Optional[Dict[str, Any]] = None
    # the reference's resilience block; None until a queued request
    # expires (the port's only resilience counter so far)
    resilience: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "total_requests": self.total_requests,
            "active_requests": self.active_requests,
            "tokens_per_second": round(self.tokens_per_second, 3),
            "average_ttft_ms": round(self.average_ttft_ms, 3),
            "average_latency_ms": round(self.average_latency_ms, 3),
            "p99_latency_ms": round(self.p99_latency_ms, 3),
            "average_batch_size": round(self.average_batch_size, 3),
            "cache_hit_rate": round(self.cache_hit_rate, 4),
            "queue_depth": self.queue_depth,
            "worker_statuses": [w.to_dict() for w in self.worker_statuses],
            "uptime_seconds": round(self.uptime_seconds, 1),
        }
        if self.cache is not None:
            out["cache"] = self.cache
        if self.resilience is not None:
            out["resilience"] = self.resilience
        return out


# ---------------------------------------------------------------------------
# a minimal registry and the text exposition format
# ---------------------------------------------------------------------------


def _num(v: float) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(v)


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _labelstr(pairs: Sequence[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"'
                          for k, v in sorted(pairs)) + "}"


class _Child:
    """One labelled series: a value, or a histogram's bucket counts, sum
    and count."""

    __slots__ = ("_family", "value", "buckets", "sum", "count")

    def __init__(self, family: "_Family"):
        self._family = family
        self.value = 0.0
        self.buckets = [0] * len(family.buckets)
        self.sum = 0.0
        self.count = 0

    def inc(self, n: float = 1.0) -> None:
        if self._family.kind == "counter" and n < 0:
            raise ValueError("counters only go up")
        with self._family.lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._family.lock:
            self.value -= n

    def set(self, v: float) -> None:
        with self._family.lock:
            self.value = float(v)

    def observe(self, v: float) -> None:
        with self._family.lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self._family.buckets):
                if v <= b:
                    self.buckets[i] += 1
                    break


class _Family:
    """A metric family: counter, gauge or histogram, with label names."""

    def __init__(self, registry: List["_Family"], name: str, doc: str,
                 kind: str, labels: Sequence[str] = (),
                 buckets: Sequence[float] = ()):
        self.kind = kind
        # counters are named without their _total; samples carry it
        self.name = (name[:-len("_total")] if kind == "counter"
                     and name.endswith("_total") else name)
        self.doc = doc
        self.labelnames = tuple(labels)
        self.buckets = (tuple(float(b) for b in buckets) + (math.inf,)
                        if kind == "histogram" else ())
        self.lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = _Child(self)
        registry.append(self)

    def labels(self, **kw: Any) -> _Child:
        if set(kw) != set(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}, "
                             f"got {sorted(kw)}")
        key = tuple(str(kw[k]) for k in self.labelnames)
        with self.lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self)
        return child

    def remove(self, *values: str) -> None:
        """Drop the child of these label values (KeyError if absent)."""
        with self.lock:
            del self._children[tuple(str(v) for v in values)]

    # unlabelled families act as their one child
    def inc(self, n: float = 1.0) -> None:
        self._children[()].inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._children[()].dec(n)

    def set(self, v: float) -> None:
        self._children[()].set(v)

    def observe(self, v: float) -> None:
        self._children[()].observe(v)

    def render(self) -> List[str]:
        shown = self.name + ("_total" if self.kind == "counter" else "")
        doc = self.doc.replace("\\", r"\\").replace("\n", r"\n")
        out = [f"# HELP {shown} {doc}", f"# TYPE {shown} {self.kind}"]
        with self.lock:
            for key, c in self._children.items():
                pairs = list(zip(self.labelnames, key))
                if self.kind != "histogram":
                    out.append(f"{shown}{_labelstr(pairs)} {_num(c.value)}")
                    continue
                cum = 0
                for b, n in zip(self.buckets, c.buckets):
                    cum += n
                    out.append(f"{self.name}_bucket"
                               f"{_labelstr(pairs + [('le', _num(b))])} "
                               f"{_num(cum)}")
                out.append(f"{self.name}_count{_labelstr(pairs)} "
                           f"{_num(c.count)}")
                out.append(f"{self.name}_sum{_labelstr(pairs)} "
                           f"{_num(c.sum)}")
        return out


class MetricsCollector:
    """Records serving metrics; renders Prometheus text and JSON
    snapshots."""

    def __init__(self) -> None:
        self._families: List[_Family] = []
        self._lock = threading.Lock()
        self._started_at = time.monotonic()

        def fam(name, doc, kind, labels=(), buckets=()):
            return _Family(self._families, name, doc, kind, labels, buckets)

        self.request_latency = fam(
            "request_latency_seconds", "End-to-end request latency",
            "histogram", ["endpoint", "status"],
            (0.005, 0.02, 0.05, 0.1, 0.2, 0.5, 1, 2, 5, 10, 30))
        self.batch_size = fam(
            "batch_size", "Requests per dispatched admission batch",
            "histogram", (), (1, 2, 4, 8, 16, 32, 64))
        self.batch_padding_ratio = fam(
            "batch_padding_ratio",
            "Padding overhead per batch (padded/real - 1)", "histogram",
            (), (0.0, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0))
        self.tokens_generated = fam(
            "tokens_generated_total", "Output tokens generated", "counter")
        self.inference_seconds = fam(
            "inference_seconds_total",
            "Wall-clock seconds spent in engine steps", "counter")
        self.ttft = fam(
            "time_to_first_token_seconds",
            "Admission to first streamed token", "histogram", (),
            (0.01, 0.05, 0.1, 0.2, 0.5, 1, 2, 5))
        self.cache_hits = fam("kv_cache_hits_total",
                              "Prefix-cache page hits", "counter")
        self.cache_misses = fam("kv_cache_misses_total",
                                "Prefix-cache misses", "counter")
        self.cache_evictions = fam("kv_cache_evictions_total",
                                   "LRU page evictions", "counter")
        self.prefix_hits = fam(
            "kv_prefix_hits_total",
            "Prefix-cache page hits by tier (hbm = shared in place, "
            "host = re-seated from the host-RAM tier)", "counter", ["tier"])
        self.prefix_reload = fam(
            "kv_prefix_reload_seconds",
            "Host-side time to re-seat a host-tier prefix match into HBM "
            "(decode + batched scatter dispatch, per prefill)", "histogram",
            (), (0.0005, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1))
        self.host_tier_bytes_g = fam(
            "kv_host_tier_bytes",
            "Bytes resident in the host-RAM prefix-cache tier", "gauge",
            ["engine_id"])
        self.host_tier_pages_g = fam(
            "kv_host_tier_pages",
            "Pages resident in the host-RAM prefix-cache tier", "gauge",
            ["engine_id"])
        self.kv_payload_bytes = fam(
            "kv_payload_bytes_total",
            "Serialized KV payload bytes moved, by encoding kind (raw | "
            "int8 | qpool | latent | latent_int8), across handoff, "
            "host-tier offload, prefix fetch, and the fleet KV data plane",
            "counter", ["kind"])
        self.mixed_step_tokens = fam(
            "engine_mixed_step_tokens",
            "Tokens consumed by ragged mixed-step dispatches (prefill = "
            "packed prefill-chunk tokens, decode = advanced decode rows)",
            "counter", ["kind"])
        self.mixed_density = fam(
            "engine_mixed_batch_density",
            "Rolling mean of real packed tokens / mixed_step_tokens per "
            "mixed dispatch (1.0 = every MXU tile slot carried a real "
            "token)", "gauge", ["engine_id"])
        self.loop_steps_total = fam(
            "engine_loop_steps_total",
            "Device iterations executed inside run-to-completion looped "
            "decode blocks (each iteration advances every active row "
            "one token, or one speculative round, with no host sync)",
            "counter")
        self.loop_exit_total = fam(
            "engine_loop_exit_total",
            "Looped decode-block row exits by stop condition (eos | "
            "budget | pages = device free-list exhausted | cap = "
            "loop_max_steps iteration cap)", "counter", ["reason"])
        self.queue_depth_g = fam("queue_depth", "Queued requests by priority",
                                 "gauge", ["priority"])
        self.active_requests_g = fam(
            "active_requests", "Requests admitted and not yet finished",
            "gauge")
        self.spec_acceptance = fam(
            "speculation_acceptance_rate",
            "Rolling draft-token acceptance rate", "gauge", ["engine_id"])
        self.spec_speedup = fam(
            "speculation_estimated_speedup",
            "Tokens emitted per target forward (>= 1)", "gauge",
            ["engine_id"])
        self.spec_enabled = fam(
            "speculation_enabled",
            "1 while speculation is active (auto-disables below "
            "threshold)", "gauge", ["engine_id"])
        self.engine_up = fam("engine_up",
                             "1 if the engine replica is healthy", "gauge",
                             ["engine_id"])
        self.errors_total = fam(
            "errors_total", "Errors absorbed at isolation boundaries, by "
            "site", "counter", ["site"])
        self.step_seconds = fam(
            "engine_step_seconds_total",
            "Host wall-clock seconds attributed to engine dispatches by "
            "kind (prefill = chunk quantum, decode_block = K-step block "
            "launch + reconcile, mixed = ragged mixed dispatch)",
            "counter", ["engine_id", "kind"])
        self.step_dispatches = fam(
            "engine_step_dispatches_total",
            "Engine dispatches by kind (the step clock's denominator)",
            "counter", ["engine_id", "kind"])
        self.step_tokens = fam(
            "engine_step_tokens_total",
            "Tokens moved per dispatch kind (prefill = prompt tokens "
            "computed, decode_block/mixed = sampled tokens reconciled)",
            "counter", ["engine_id", "kind"])
        self.requests_expired = fam(
            "requests_expired_total",
            "Queued requests expired by the dispatcher sweep before "
            "dispatch (queue_timeout)", "counter")
        self.queue_tenant_depth = fam(
            "queue_tenant_depth",
            "Queued requests per tenant (per-tenant fair admission, "
            "queue.tenant_fairness)", "gauge", ["tenant"])
        self.step_events = fam(
            "engine_step_events_total",
            "Step-loop pressure events (cache_full = allocation failed "
            "and the step degraded, preempt = youngest sequence evicted, "
            "reclaim = sliding-window pages released, retrace = a new "
            "program geometry compiled mid-serving)", "counter",
            ["engine_id", "event"])

        # snapshot internals
        self._total_requests = 0
        self._active_requests = 0
        self._queue_depth = 0
        self._token_events: Deque[Tuple[float, int]] = deque()
        self._latencies: Deque[Tuple[float, float]] = deque()
        self._ttfts_ms: Deque[float] = deque(maxlen=_TTFT_WINDOW)
        self._batch_sizes: Deque[int] = deque(maxlen=_TTFT_WINDOW)
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_evictions = 0
        self._host_hit_pages = 0
        self._reload_sum = 0.0
        self._reload_count = 0
        self._payload_bytes: Dict[str, int] = {}
        self._latent: Dict[str, Dict[str, int]] = {}
        self._requests_expired = 0
        self._tenants_seen: set = set()

    # -- recording ---------------------------------------------------------

    def record_request(self, endpoint: str, status: int,
                       latency_s: float) -> None:
        self.request_latency.labels(endpoint=endpoint,
                                    status=str(status)).observe(latency_s)
        now = time.monotonic()
        with self._lock:
            self._total_requests += 1
            self._latencies.append((now, latency_s * 1000.0))
            self._trim_locked(now)

    def record_batch(self, size: int, padding_ratio: float = 0.0) -> None:
        """One dispatched admission batch of ``size`` requests and the
        padding it would carry if padded to its longest prompt (nothing is
        padded: the engine is paged)."""
        self.batch_size.observe(size)
        self.batch_padding_ratio.observe(padding_ratio)
        with self._lock:
            self._batch_sizes.append(size)

    def set_queue_depth(self, high: int, normal: int, low: int) -> None:
        """The admission queue's depth by priority."""
        for priority, depth in (("high", high), ("normal", normal),
                                ("low", low)):
            self.queue_depth_g.labels(priority=priority).set(depth)
        with self._lock:
            self._queue_depth = high + normal + low

    def set_tenant_depths(self, depths: Dict[str, int]) -> None:
        """Queued requests per tenant. A tenant that drained since the last
        call loses its series (tenant is a client-chosen string, so keeping
        every one ever seen would grow /metrics without bound)."""
        with self._lock:
            stale = self._tenants_seen - set(depths)
            self._tenants_seen = set(depths)
            for tenant in stale:
                try:
                    self.queue_tenant_depth.remove(tenant)
                except KeyError:
                    pass
            for tenant, depth in depths.items():
                self.queue_tenant_depth.labels(tenant=tenant).set(depth)

    def record_expired(self, n: int = 1) -> None:
        """``n`` queued requests expired by the dispatcher sweep (answered
        with the ``queue_timeout`` code)."""
        if n <= 0:
            return
        self.requests_expired.inc(n)
        with self._lock:
            self._requests_expired += n

    def set_speculation(self, engine_id: str, stats: Dict[str, Any]) -> None:
        """The speculation gauges from ``engine.spec_stats()``."""
        self.spec_acceptance.labels(engine_id=engine_id).set(
            stats.get("acceptance_rate", 0.0))
        self.spec_speedup.labels(engine_id=engine_id).set(
            stats.get("estimated_speedup", 1.0))
        self.spec_enabled.labels(engine_id=engine_id).set(
            1 if stats.get("enabled") else 0)

    def record_tokens(self, n: int) -> None:
        if n <= 0:
            return
        self.tokens_generated.inc(n)
        now = time.monotonic()
        with self._lock:
            self._token_events.append((now, n))
            self._trim_locked(now)

    def record_inference(self, duration_s: float) -> None:
        self.inference_seconds.inc(duration_s)

    def record_ttft(self, seconds: float) -> None:
        self.ttft.observe(seconds)
        with self._lock:
            self._ttfts_ms.append(seconds * 1000.0)

    def observe_engine(self, engine_id: str, cache: Any,
                       mixed: Optional[Dict[str, Any]],
                       loop: Optional[Dict[str, Any]],
                       step_clock: Dict[str, Dict[str, Any]],
                       host_tier: Optional[Dict[str, int]] = None,
                       payload: Optional[Dict[str, int]] = None,
                       reloads: Sequence[float] = (),
                       latent: Optional[Dict[str, int]] = None) -> None:
        """Take one engine's cumulative counters, read at scrape time
        (``EngineRunner.status``): the allocator's hits, misses and
        evictions (``cache``; a hit is a page shared in place, tier
        ``hbm``), ``mixed_stats()`` and ``loop_stats()`` (None while off),
        ``step_clock_stats()``, ``host_tier_stats()`` (pages re-seated
        from the host tier are tier ``host`` hits), the encoded payload
        bytes by kind, the host-tier reload seconds drained since the last
        read (each observed once) and ``latent_stats()``. The engine's
        totals only grow, so the counters are set to them; a labelled
        series appears once its total is above zero."""

        def total(family: _Family, value: float, **labels: str) -> None:
            if value > 0:
                (family.labels(**labels) if labels else family).set(value)

        total(self.cache_hits, cache.hits)
        total(self.cache_misses, cache.misses)
        total(self.cache_evictions, cache.evictions)
        total(self.prefix_hits, cache.hits, tier="hbm")
        if mixed is not None:
            for kind in ("prefill", "decode"):
                total(self.mixed_step_tokens, mixed[f"{kind}_tokens"],
                      kind=kind)
            self.mixed_density.labels(engine_id=engine_id).set(
                mixed["batch_density"])
        if loop is not None:
            total(self.loop_steps_total, loop["steps"])
            for reason, n in loop["exits"].items():
                total(self.loop_exit_total, n, reason=reason)
        for kind, c in step_clock["kinds"].items():
            total(self.step_dispatches, c["dispatches"],
                  engine_id=engine_id, kind=kind)
            total(self.step_seconds, c["wall_s"], engine_id=engine_id,
                  kind=kind)
            total(self.step_tokens, c["tokens"], engine_id=engine_id,
                  kind=kind)
        for event, n in step_clock["events"].items():
            total(self.step_events, n, engine_id=engine_id, event=event)
        if host_tier is not None:
            total(self.prefix_hits, host_tier["hit_pages"], tier="host")
            self.host_tier_bytes_g.labels(engine_id=engine_id).set(
                host_tier["bytes"])
            self.host_tier_pages_g.labels(engine_id=engine_id).set(
                host_tier["pages"])
        for kind, n in (payload or {}).items():
            total(self.kv_payload_bytes, n, kind=kind)
        for dur in reloads:
            self.prefix_reload.observe(dur)
        with self._lock:
            self._cache_hits = cache.hits
            self._cache_misses = cache.misses
            self._cache_evictions = cache.evictions
            if host_tier is not None:
                self._host_hit_pages = host_tier["hit_pages"]
            self._reload_sum += sum(reloads)
            self._reload_count += len(reloads)
            if payload:
                self._payload_bytes = {k: n for k, n in payload.items() if n}
            if latent is not None:
                self._latent[engine_id] = dict(latent)

    def request_started(self) -> None:
        with self._lock:
            self._active_requests += 1
        self.active_requests_g.inc()

    def request_finished(self) -> None:
        with self._lock:
            self._active_requests = max(0, self._active_requests - 1)
        self.active_requests_g.dec()

    def set_engine_up(self, engine_id: str, up: bool) -> None:
        self.engine_up.labels(engine_id=engine_id).set(1 if up else 0)

    def record_error(self, site: str) -> None:
        self.errors_total.labels(site=site).inc()

    # -- rendering ---------------------------------------------------------

    def prometheus_text(self) -> bytes:
        lines: List[str] = []
        for f in self._families:
            lines.extend(f.render())
        return ("\n".join(lines) + "\n").encode()

    def _cache_block_locked(self, engine_statuses) -> Dict[str, Any]:
        """The snapshot's prefix-cache block, in the JAX shape: allocator
        totals, page hits by tier, host-tier reloads, the host tiers'
        occupancy summed over ``engine_statuses``, and (once any moved)
        payload bytes by kind and the latent codec's."""
        tiers = [s.host_tier for s in engine_statuses if s.host_tier]
        cache: Dict[str, Any] = {
            "hits": self._cache_hits,
            "misses": self._cache_misses,
            "evictions": self._cache_evictions,
            "prefix_hits": {"hbm": self._cache_hits,
                            "host": self._host_hit_pages},
            "reload_count": self._reload_count,
            "reload_avg_ms": round(self._reload_sum
                                   / max(1, self._reload_count) * 1000.0, 3),
            "host_tier_bytes": sum(h["bytes"] for h in tiers),
            "host_tier_pages": sum(h["pages"] for h in tiers),
        }
        if self._payload_bytes:
            cache["payload_bytes"] = dict(self._payload_bytes)
        latents = list(self._latent.values())
        if latents:
            cache["latent"] = {
                "rank": latents[0]["rank"],
                "encoded_bytes": sum(b["encoded_bytes"] for b in latents),
                "saved_bytes": sum(b["saved_bytes"] for b in latents)}
        return cache

    def _trim_locked(self, now: float) -> None:
        while (self._token_events
               and self._token_events[0][0] < now - _TOKEN_WINDOW_S):
            self._token_events.popleft()
        while (self._latencies
               and self._latencies[0][0] < now - _LATENCY_WINDOW_S):
            self._latencies.popleft()

    def snapshot(self, engine_statuses: Tuple[EngineStatus, ...] = ()
                 ) -> MetricsSnapshot:
        """The rates and latencies over trailing windows: tokens per
        second over 10 s, the request latency's mean and p99 over 60 s
        (exact, nearest rank), the TTFT and batch-size means over the last
        1024."""
        now = time.monotonic()
        with self._lock:
            self._trim_locked(now)
            window_tokens = sum(n for _, n in self._token_events)
            span = (max(now - self._token_events[0][0], 1e-3)
                    if self._token_events else _TOKEN_WINDOW_S)
            lat = sorted(ms for _, ms in self._latencies)
            p99 = lat[max(0, math.ceil(0.99 * len(lat)) - 1)] if lat else 0.0
            total_cache = self._cache_hits + self._cache_misses
            return MetricsSnapshot(
                total_requests=self._total_requests,
                active_requests=self._active_requests,
                tokens_per_second=window_tokens / span,
                average_ttft_ms=(sum(self._ttfts_ms) / len(self._ttfts_ms)
                                 if self._ttfts_ms else 0.0),
                average_latency_ms=sum(lat) / len(lat) if lat else 0.0,
                p99_latency_ms=p99,
                average_batch_size=(
                    sum(self._batch_sizes) / len(self._batch_sizes)
                    if self._batch_sizes else 0.0),
                cache_hit_rate=(self._cache_hits / total_cache
                                if total_cache else 0.0),
                queue_depth=self._queue_depth,
                worker_statuses=tuple(engine_statuses),
                uptime_seconds=now - self._started_at,
                cache=self._cache_block_locked(engine_statuses),
                resilience=({"engine_restarts": {}, "redispatched": {},
                             "requests_expired": self._requests_expired}
                            if self._requests_expired else None),
            )
