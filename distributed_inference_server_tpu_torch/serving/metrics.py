"""Serving metrics: Prometheus text for ``GET /metrics`` and the JSON
snapshot of ``GET /server/stats`` (port of
``distributed_inference_server_tpu/serving/metrics.py``: ``EngineStatus``,
``MetricsSnapshot`` and the part of ``MetricsCollector`` that the port's
replicas record).

The families, their types, label names and histogram buckets are the
reference collector's. The text exposition format (version 0.0.4) is
written here, as ``prometheus_client`` writes it: ``# HELP`` / ``# TYPE``
per family, a counter's samples under ``<name>_total``, a histogram's as
``_bucket{le=...}`` (cumulative, ``+Inf`` last), ``_sum`` and ``_count``,
labels sorted by name. A family with labels shows samples only for the
label values recorded so far; one without shows its zero from the start.

With them: the perf store (``serving/teledigest.py`` ``PerfTelemetry``)
behind ``GET /server/perf``, fed the TTFT, request latency, queue-wait and
TBT digests, the engine step clock (``record_step_perf``, after each
engine step: the counters the health scorer's wedge signal reads, and the
per-dispatch ``step_ms.<kind>`` digests) and the SLO verdict counts; the
gray-failure families (admission sheds, health transitions, breaker flips,
retry-budget denials), the dropped spans and the request phases; the fleet
control plane's families (members by state, heartbeat outcomes, reroles,
telemetry frames and the per-member step tokens and TTFT p99). Not here:
the KV data plane's, the mesh's and registry HA's families.

The port's own series: ``engine_device_seconds_total{engine_id,kind}``
(the device clock's seconds per dispatch kind, ``engine/device_clock.py``),
``engine_device_idle_seconds_total{engine_id,cause}`` (the engine
stream's gaps between dispatches by what the engine thread was doing:
admit, schedule, walk, reap, runner, other), the flight recorder's port
phases ``ingress`` and ``engine_wait`` under ``request_phase_seconds``,
and ``request_first_frame_seconds`` (first token to the stream's first
written frame). The admission batch's ``batch.dispatch`` span is gone:
each request's ``dispatched`` span event carries its ``engine_id`` and
the batch's ``size``.

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

from distributed_inference_server_tpu_torch.serving.teledigest import (
    PerfTelemetry,
    window_stats,
)

# rolling windows for the snapshot's derived values
_TOKEN_WINDOW_S = 10.0
_TTFT_WINDOW = 1024
# tenant label values kept per family before new tenants fold into
# "other" (tenant is a client-chosen string; counter series stay forever)
_SLO_TENANT_CAP = 32


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
    # cache-aware routing: the engine's rolling digest of cached prefix
    # chains (first digest_depth page hashes of each, kv_cache.chain_hashes
    # key space) and the page size they were hashed with. In-process
    # routing state only, never serialized
    prefix_digest: Any = None
    page_size: int = 0
    digest_depth: int = 0
    # the fleet: True for a RemoteRunner proxy's status rebuilt from a
    # member's heartbeat (serving/fleet.py). data_plane: the member has a
    # KV data channel, which makes it a handoff target and a fetch
    # source; the port has none yet, so it stays False
    remote: bool = False
    data_plane: bool = False
    # gray-failure verdict ("healthy" | "degraded" | "ejected"), stamped
    # by the health scorer in AdaptiveScheduler.statuses()
    health: str = "healthy"

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
        if self.remote:
            d["remote"] = True
            if self.data_plane:
                d["data_plane"] = True
        if self.health != "healthy":
            d["health"] = self.health
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
    # disaggregated serving: handoff outcomes, bytes, chunks and stalls
    # (None while no handoff happened and every replica is unified)
    disagg: Optional[Dict[str, Any]] = None
    # prefix-cache block: allocator hit / miss / eviction totals, the
    # page-granular prefix hits by tier, peer fetches and route decisions
    cache: Optional[Dict[str, Any]] = None
    # restarts by replica, redispatch outcomes, queue expiries, admission
    # sheds, retry-budget denials and breaker flips (None until one of
    # them happened)
    resilience: Optional[Dict[str, Any]] = None
    # dropped spans and the flight recorder's phase sums (None until a
    # span dropped or a request finished)
    tracing: Optional[Dict[str, Any]] = None

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
        if self.disagg is not None:
            out["disagg"] = self.disagg
        if self.cache is not None:
            out["cache"] = self.cache
        if self.resilience is not None:
            out["resilience"] = self.resilience
        if self.tracing is not None:
            out["tracing"] = self.tracing
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
        self.device_seconds = fam(
            "engine_device_seconds_total",
            "Device seconds of engine dispatches by kind, between timing "
            "events around each dispatch (cuda only)", "counter",
            ["engine_id", "kind"])
        self.device_idle = fam(
            "engine_device_idle_seconds_total",
            "Idle seconds of the engine stream between dispatches, by "
            "what the engine thread was doing (admit | schedule | walk | "
            "reap | runner | other; cuda only)", "counter",
            ["engine_id", "cause"])
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
        # peer prefix fetch and the cache_aware route decisions behind it
        self.prefix_fetches = fam(
            "kv_prefix_fetch_total",
            "Peer-to-peer prefix fetches by outcome (ok = fetched pages "
            "seated on the cold replica, fallback = peer death / stale "
            "registry / torn stream degraded the request to recompute) "
            "and scope (local = in-process peer, remote = a fleet "
            "member over its KV data channel)", "counter",
            ["outcome", "scope"])
        self.prefix_fetch_bytes = fam(
            "kv_prefix_fetch_bytes_total",
            "Serialized KV bytes moved by peer prefix fetches "
            "(post wire-quantization), by peer scope (local | remote)",
            "counter", ["scope"])
        self.prefix_fetch_latency = fam(
            "kv_prefix_fetch_seconds",
            "Peer prefix fetch latency (route decision to request "
            "submission on the target replica)", "histogram", (),
            (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2))
        self.prefix_routes = fam(
            "kv_prefix_route_total",
            "cache_aware route decisions (warm = routed to a matched "
            "replica, fetch = peer-fetch onto a cold replica, recompute "
            "= no usable match)", "counter", ["decision"])
        # disaggregated prefill/decode serving (serving/disagg.py)
        self.handoff_latency = fam(
            "kv_handoff_latency_seconds",
            "Prefill->decode KV handoff latency (export to resume)",
            "histogram", (),
            (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2, 5))
        self.handoff_bytes = fam(
            "kv_handoff_bytes_total",
            "Serialized KV bytes moved over the handoff channel "
            "(post wire-quantization)", "counter")
        self.handoff_stall = fam(
            "kv_handoff_stall_seconds",
            "Decode pause observed by the migrated sequence", "histogram",
            (), (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2, 5))
        self.handoff_chunks = fam(
            "kv_handoff_chunks_total",
            "KvChunk frames moved over the handoff channel, by target "
            "scope (local = in-process decode replica, remote = a fleet "
            "member over its KV data channel)", "counter", ["scope"])
        self.handoffs = fam(
            "kv_handoff_total",
            "KV handoffs by outcome (ok | fallback | retry)", "counter",
            ["outcome"])
        self.engines_by_role = fam(
            "engines_by_role", "Engine replicas per disaggregation role",
            "gauge", ["role"])
        # restarts and crash-safe redispatch
        self.engine_restarts = fam(
            "engine_restarts_total",
            "Engine replica restart attempts by the health loop",
            "counter", ["engine_id"])
        self.redispatches = fam(
            "requests_redispatched_total",
            "Zero-token in-flight requests moved off a dead engine "
            "(ok = resubmitted to a healthy replica, exhausted = attempt "
            "budget or healthy capacity ran out)", "counter", ["outcome"])
        # gray-failure defense (serving/health.py)
        self.requests_shed = fam(
            "requests_shed_total",
            "Requests shed at admission by deadline-aware control "
            "(deadline = the windowed queue-wait estimate blows the "
            "tenant's SLO-derived deadline, brownout = a low-weight "
            "tenant shed early as the backlog grows); tenants beyond "
            "a bounded label set fold into \"other\"", "counter",
            ["tenant", "reason"])
        self.engine_health = fam(
            "engine_health_state",
            "Latency-scored health verdict per engine "
            "(0 healthy, 1 degraded, 2 ejected)", "gauge", ["engine_id"])
        self.health_transitions = fam(
            "health_transitions_total",
            "Health-state transitions applied by the scorer, by the "
            "state entered (healthy | degraded | ejected)", "counter",
            ["state"])
        self.breaker_transitions = fam(
            "fleet_breaker_transitions_total",
            "KV data-channel circuit-breaker transitions, by the state "
            "entered (closed | open | half_open)", "counter", ["state"])
        self.retry_denied = fam(
            "retry_budget_exhausted_total",
            "Retries declined by the shared windowed retry budget, by "
            "consumer site (redispatch | handoff_retry | kv_reconnect) "
            "— each denial degraded to its exactly-once fallback",
            "counter", ["site"])
        # tracing and the flight recorder (utils/tracing.py,
        # serving/flightrec.py)
        self.trace_drops = fam(
            "trace_spans_dropped_total",
            "Finished spans dropped before reaching an operator (ring = "
            "evicted from the bounded in-memory ring, exporter = an "
            "exporter failed or overflowed, wire = the fleet span buffer "
            "overflowed before shipping)", "counter", ["reason"])
        self.request_phases = fam(
            "request_phase_seconds",
            "Per-request wall-clock attributed to lifecycle phases by "
            "the flight recorder (serving/flightrec.py): queue_wait | "
            "prefill | peer_fetch | handoff_stall | decode | detok",
            "histogram", ["phase"],
            (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10,
             30))
        self.first_frame = fam(
            "request_first_frame_seconds",
            "Runner's first-token delivery to the stream's first written "
            "frame (serving/flightrec.py)", "histogram", (),
            (0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 1))
        # SLO / goodput accounting (fed by flightrec.finish)
        self.slo_requests = fam(
            "slo_requests_total",
            "Finished requests with an applicable SLO, by tenant and "
            "verdict (ok | violated); tenants beyond a bounded label "
            "set fold into \"other\"", "counter", ["tenant", "verdict"])
        self.slo_goodput = fam(
            "slo_goodput_tokens_total",
            "Output tokens of requests that MET their SLO (goodput; "
            "compare against tokens_generated_total for the waste share)",
            "counter", ["tenant"])
        # the fleet control plane (serving/fleet.py)
        self.fleet_members = fam(
            "fleet_members",
            "Fleet members by registry state (alive = beating, suspect "
            "= missed beats past fleet.suspect_after_s, dead = aged out "
            "or connection lost)", "gauge", ["state"])
        self.fleet_heartbeats = fam(
            "fleet_heartbeats_total",
            "Heartbeat ingest outcomes (ok = applied, rejoin = revived "
            "a suspect/dead member, dropped = lost before the registry "
            "— the fleet.heartbeat partition fault)", "counter",
            ["outcome"])
        self.fleet_reroles = fam(
            "fleet_reroles_total",
            "Dynamic role flips by the RoleBalancer (to_prefill = "
            "prompt-queue pressure crossed fleet.rerole_high_ratio, "
            "to_unified = it drained below fleet.rerole_low_ratio)",
            "counter", ["direction"])
        self.fleet_telemetry_frames = fam(
            "fleet_telemetry_frames_total",
            "FleetTelemetry frames by outcome (sent/failed on a worker, "
            "ingested on the registry host)", "counter", ["outcome"])
        self.fleet_member_step_tokens = fam(
            "fleet_member_step_tokens",
            "A member's cumulative step-clock tokens by dispatch kind "
            "(from its last FleetTelemetry frame)", "gauge",
            ["member", "kind"])
        self.fleet_member_ttft_p99 = fam(
            "fleet_member_ttft_p99_ms",
            "A member's windowed TTFT p99 (ms) from its last shipped "
            "digest (0 until it has a windowed sample)", "gauge",
            ["member"])
        # the KV mesh (serving/fleet_mesh.py): learned wire rates (src and
        # dst are member ids, "registry" for this host; a dead member's
        # series go) and the intro broker's sends
        self.kv_wire_rate = fam(
            "fleet_kv_wire_rate_bytes_per_s",
            "Learned KV wire transfer rate over the configured window "
            "(fleet.kv_rate_window_s); absent while the wire is cold "
            "(it then prices at the fleet.kv_rate_prior constant)",
            "gauge", ["src", "dst"])
        self.kv_intros = fam(
            "fleet_kv_intro_total",
            "KvIntro broker sends by outcome (sent | gone = retraction "
            "| dropped = injected fleet.kv_intro fault | failed = "
            "member session wire error)", "counter", ["outcome"])
        # registry HA (serving/fleet_ha.py): both role series are always
        # published, one of them 1; the epoch is the fencing token
        self.registry_role = fam(
            "fleet_registry_role",
            "This registry's HA role as a 0/1 gauge per role label "
            "(primary | standby); exactly one series is 1 at a time",
            "gauge", ["role"])
        self.registry_takeovers = fam(
            "fleet_registry_takeovers_total",
            "Registry HA role transitions by reason (lease_expired = "
            "standby promoted after the primary lease aged out | "
            "fenced = a primary demoted on seeing a higher-epoch or "
            "lower-index peer lease)", "counter", ["reason"])
        self.registry_epoch = fam(
            "fleet_registry_epoch",
            "This registry's current control epoch (the fencing token "
            "stamped on FleetSubmit/KvIntro frames; members reject "
            "control from lower epochs)", "gauge")

        # the windowed digests behind GET /server/perf
        self.perf = PerfTelemetry()

        # snapshot internals
        self._total_requests = 0
        self._active_requests = 0
        self._queue_depth = 0
        self._token_events: Deque[Tuple[float, int]] = deque()
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
        self._prefix_fetches: Dict[str, int] = {}
        self._prefix_fetch_bytes = 0
        self._fetch_sum = 0.0
        self._fetch_count = 0
        self._prefix_routes: Dict[str, int] = {}
        self._handoffs: Dict[str, int] = {}
        self._handoff_bytes = 0
        self._handoff_chunks = 0
        self._stall_sum = 0.0
        self._stall_count = 0
        self._engine_restarts: Dict[str, int] = {}
        self._redispatches: Dict[str, int] = {}
        self._requests_shed: Dict[Tuple[str, str], int] = {}
        self._shed_tenants: set = set()
        self._health_transitions: Dict[str, int] = {}
        self._breaker_transitions: Dict[str, int] = {}
        self._retry_denied: Dict[str, int] = {}
        self._trace_drops: Dict[str, int] = {}
        self._phase_sums: Dict[str, float] = {}
        self._phase_requests = 0
        self._slo_counts: Dict[str, Dict[str, int]] = {}
        self._slo_goodput: Dict[str, int] = {}
        self._fleet_heartbeats: Dict[str, int] = {}
        self._fleet_reroles: Dict[str, int] = {}
        self._kv_intros: Dict[str, int] = {}
        self._registry_takeovers: Dict[str, int] = {}
        # member -> the step-token kinds published for it, so a pruned
        # member's series can be removed
        self._member_kinds: Dict[str, set] = {}

    # -- recording ---------------------------------------------------------

    def record_request(self, endpoint: str, status: int,
                       latency_s: float) -> None:
        self.request_latency.labels(endpoint=endpoint,
                                    status=str(status)).observe(latency_s)
        # the windowed digest behind the snapshot's mean and p99
        self.perf.observe("latency_ms", latency_s * 1000.0)
        with self._lock:
            self._total_requests += 1

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

    def record_ttft(self, seconds: float, local: bool = True) -> None:
        """``local=False`` (a ``RemoteRunner`` proxy's request): the
        histogram and the snapshot's mean record it, the windowed
        ``ttft_ms`` digest does not. The member ships its own digest, so
        counting the request here too would weigh it twice in the fleet
        view and drag the host's series toward a slow member's, the
        comparison the health scorer demotes on."""
        self.ttft.observe(seconds)
        if local:
            self.perf.observe("ttft_ms", seconds * 1000.0)
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
            total(self.device_seconds, c.get("device_s", 0.0),
                  engine_id=engine_id, kind=kind)
        for cause, seconds in step_clock.get("idle", {}).items():
            total(self.device_idle, seconds, engine_id=engine_id,
                  cause=cause)
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

    def record_prefix_fetch(self, outcome: str,
                            seconds: Optional[float] = None,
                            nbytes: int = 0, scope: str = "local") -> None:
        """One peer prefix fetch (``disagg.PrefixFetcher``): ``outcome``
        "ok" (pages seated on the cold replica) or "fallback" (the
        request recomputed instead)."""
        self.prefix_fetches.labels(outcome=outcome, scope=scope).inc()
        if seconds is not None:
            self.prefix_fetch_latency.observe(seconds)
        if nbytes:
            self.prefix_fetch_bytes.labels(scope=scope).inc(nbytes)
        with self._lock:
            self._prefix_fetches[outcome] = (
                self._prefix_fetches.get(outcome, 0) + 1)
            self._prefix_fetch_bytes += nbytes
            if seconds is not None:
                self._fetch_sum += seconds
                self._fetch_count += 1

    def record_prefix_route(self, decision: str) -> None:
        """One cache_aware route decision: warm | fetch | recompute."""
        self.prefix_routes.labels(decision=decision).inc()
        with self._lock:
            self._prefix_routes[decision] = (
                self._prefix_routes.get(decision, 0) + 1)

    def record_handoff(self, outcome: str, latency_s: Optional[float] = None,
                       nbytes: int = 0, stall_s: Optional[float] = None,
                       chunks: int = 0, scope: str = "local") -> None:
        """One KV handoff event (``serving/disagg.py``): ``outcome`` "ok"
        (resumed on a decode replica), "fallback" (decoded in place on the
        source) or "retry" (a failed attempt that was retried);
        ``stall_s`` is the decode pause the migrated sequence saw,
        ``chunks`` its streamed KvChunk frames (0 = monolithic)."""
        self.handoffs.labels(outcome=outcome).inc()
        if latency_s is not None:
            self.handoff_latency.observe(latency_s)
        if stall_s is not None:
            self.handoff_stall.observe(stall_s)
        if nbytes:
            self.handoff_bytes.inc(nbytes)
        if chunks:
            self.handoff_chunks.labels(scope=scope).inc(chunks)
        with self._lock:
            self._handoffs[outcome] = self._handoffs.get(outcome, 0) + 1
            self._handoff_bytes += nbytes
            self._handoff_chunks += chunks
            if stall_s is not None:
                self._stall_sum += stall_s
                self._stall_count += 1

    def set_engines_by_role(self, counts: Dict[str, int]) -> None:
        """Replicas per role (prefill / decode / unified gauges)."""
        for role in ("prefill", "decode", "unified"):
            self.engines_by_role.labels(role=role).set(counts.get(role, 0))

    def record_engine_restart(self, engine_id: str) -> None:
        """One health-loop restart attempt of ``engine_id`` (counted when
        the attempt starts: a crash loop shows even while it fails)."""
        self.engine_restarts.labels(engine_id=engine_id).inc()
        with self._lock:
            self._engine_restarts[engine_id] = (
                self._engine_restarts.get(engine_id, 0) + 1)

    def record_redispatch(self, outcome: str) -> None:
        """One crash-safe redispatch decision: "ok" (resubmitted to a
        healthy replica) or "exhausted" (budget or capacity ran out and
        the request failed to its sink)."""
        self.redispatches.labels(outcome=outcome).inc()
        with self._lock:
            self._redispatches[outcome] = (
                self._redispatches.get(outcome, 0) + 1)

    def set_engine_up(self, engine_id: str, up: bool) -> None:
        self.engine_up.labels(engine_id=engine_id).set(1 if up else 0)

    def record_error(self, site: str) -> None:
        self.errors_total.labels(site=site).inc()

    # -- gray-failure defense ------------------------------------------------

    def record_shed(self, tenant: str, reason: str) -> None:
        """One request shed at admission (``health.AdmissionControl``):
        ``reason`` "deadline" or "brownout"."""
        with self._lock:
            if (tenant not in self._shed_tenants
                    and len(self._shed_tenants) >= _SLO_TENANT_CAP):
                tenant = "other"
            self._shed_tenants.add(tenant)
            key = (tenant, reason)
            self._requests_shed[key] = self._requests_shed.get(key, 0) + 1
        self.requests_shed.labels(tenant=tenant, reason=reason).inc()

    def record_health_transition(self, engine_id: str, state: str) -> None:
        """One transition of the health scorer: the replica's gauge
        follows the state entered (0/1/2), the counter counts it."""
        rank = {"healthy": 0, "degraded": 1, "ejected": 2}.get(state, 0)
        self.engine_health.labels(engine_id=engine_id).set(rank)
        self.health_transitions.labels(state=state).inc()
        with self._lock:
            self._health_transitions[state] = (
                self._health_transitions.get(state, 0) + 1)

    def remove_engine_health(self, engine_id: str) -> None:
        """Drop a retired replica's health gauge series."""
        try:
            self.engine_health.remove(engine_id)
        except KeyError:
            pass

    def record_breaker_transition(self, state: str) -> None:
        """One circuit-breaker transition, by state entered."""
        self.breaker_transitions.labels(state=state).inc()
        with self._lock:
            self._breaker_transitions[state] = (
                self._breaker_transitions.get(state, 0) + 1)

    def record_retry_denied(self, site: str) -> None:
        """One retry declined by the shared retry budget."""
        self.retry_denied.labels(site=site).inc()
        with self._lock:
            self._retry_denied[site] = self._retry_denied.get(site, 0) + 1

    # -- tracing, phases, SLOs -----------------------------------------------

    def record_trace_drops(self, reason: str, n: int = 1) -> None:
        """``n`` finished spans lost for ``reason`` (ring | exporter |
        wire): the tracer's ``on_drop``."""
        if n <= 0:
            return
        self.trace_drops.labels(reason=reason).inc(n)
        with self._lock:
            self._trace_drops[reason] = self._trace_drops.get(reason, 0) + n

    def record_request_phases(self, phases: Dict[str, float],
                              tbt_s: Optional[float] = None) -> None:
        """One finished request's phase attribution (seconds per phase);
        its queue wait and mean TBT also feed the windowed digests."""
        for phase, seconds in phases.items():
            self.request_phases.labels(phase=phase).observe(seconds)
        self.perf.observe("queue_wait_ms",
                          phases.get("queue_wait", 0.0) * 1000.0)
        if tbt_s is not None:
            self.perf.observe("tbt_ms", tbt_s * 1000.0)
        with self._lock:
            self._phase_requests += 1
            for phase, seconds in phases.items():
                self._phase_sums[phase] = (self._phase_sums.get(phase, 0.0)
                                           + seconds)

    def record_first_frame(self, seconds: float) -> None:
        self.first_frame.observe(seconds)

    def record_slo(self, tenant: str, verdict: str, tokens: int = 0) -> None:
        """One finished request's SLO verdict: counts, goodput tokens and
        the windowed burn-rate digests."""
        with self._lock:
            if (tenant not in self._slo_counts
                    and len(self._slo_counts) >= _SLO_TENANT_CAP):
                tenant = "other"
            per = self._slo_counts.setdefault(tenant, {})
            per[verdict] = per.get(verdict, 0) + 1
            if verdict == "ok" and tokens:
                self._slo_goodput[tenant] = (
                    self._slo_goodput.get(tenant, 0) + tokens)
        self.slo_requests.labels(tenant=tenant, verdict=verdict).inc()
        if verdict == "ok" and tokens:
            self.slo_goodput.labels(tenant=tenant).inc(tokens)
        self.perf.count("slo.violated" if verdict == "violated"
                        else "slo.ok")

    def slo_counts(self) -> Tuple[Dict[str, Dict[str, int]], Dict[str, int]]:
        """(per-tenant verdict counts, per-tenant goodput tokens)."""
        with self._lock:
            return ({t: dict(v) for t, v in self._slo_counts.items()},
                    dict(self._slo_goodput))

    # -- the perf store --------------------------------------------------------

    def record_step_perf(self, engine_id: str, kind: str,
                         dispatches: int = 0, wall_s: float = 0.0,
                         tokens: int = 0, rows: int = 0) -> None:
        """Step-clock deltas of one dispatch kind into the perf store's
        cumulative counters (the Prometheus step families are set from the
        engine's totals at scrape time instead)."""
        base = f"step.{engine_id}.{kind}"
        for field, value in (("dispatches", dispatches), ("wall_s", wall_s),
                             ("tokens", tokens), ("rows", rows)):
            if value:
                self.perf.add_counter(f"{base}.{field}", value)

    def record_step_events_perf(self, engine_id: str,
                                deltas: Dict[str, int]) -> None:
        """Step-loop pressure-event deltas into the perf store."""
        for event, n in deltas.items():
            if n > 0:
                self.perf.add_counter(f"events.{engine_id}.{event}", n)

    def observe_step(self, kind: str, seconds: float) -> None:
        """One dispatch's host wall time into the per-kind digest."""
        self.perf.observe(f"step_ms.{kind}", seconds * 1000.0)

    def configure_perf(self, epoch_s: float, window_s: float) -> None:
        """Boot-time digest geometry (``slo.epoch_s`` / ``slo.window_s``)."""
        self.perf.configure(epoch_s, window_s)

    def perf_store(self) -> PerfTelemetry:
        return self.perf

    def perf_wire(self) -> Dict[str, Any]:
        return self.perf.wire()

    def perf_window_s(self) -> float:
        return self.perf.window_s

    def perf_epoch_s(self) -> float:
        return self.perf.epoch_s

    # -- the fleet control plane (serving/fleet.py) ------------------------

    def record_telemetry_frame(self, outcome: str) -> None:
        """One FleetTelemetry frame: sent | failed (worker side),
        ingested | epoch_mismatch (registry host)."""
        self.fleet_telemetry_frames.labels(outcome=outcome).inc()

    def set_member_telemetry(self, member: str,
                             step_tokens: Dict[str, float],
                             ttft_p99_ms: Optional[float]) -> None:
        """The ``fleet_member_*{member}`` series from an ingested
        FleetTelemetry frame."""
        with self._lock:
            self._member_kinds.setdefault(member, set()).update(step_tokens)
            for kind, tokens in step_tokens.items():
                self.fleet_member_step_tokens.labels(
                    member=member, kind=kind).set(tokens)
            self.fleet_member_ttft_p99.labels(member=member).set(
                ttft_p99_ms or 0.0)

    def remove_member_telemetry(self, member: str) -> None:
        """Drop a pruned member's ``fleet_member_*`` series: its last
        values must stop reading as live."""
        with self._lock:
            for kind in self._member_kinds.pop(member, set()):
                try:
                    self.fleet_member_step_tokens.remove(member, kind)
                except KeyError:
                    pass
            try:
                self.fleet_member_ttft_p99.remove(member)
            except KeyError:
                pass

    def set_fleet_members(self, counts: Dict[str, int]) -> None:
        """Members per registry state; all three states are published, so
        a dead member reads ``fleet_members{state="dead"} 1.0``."""
        for state in ("alive", "suspect", "dead"):
            self.fleet_members.labels(state=state).set(counts.get(state, 0))

    def record_fleet_heartbeat(self, outcome: str) -> None:
        """One heartbeat ingest: ok | rejoin | dropped."""
        self.fleet_heartbeats.labels(outcome=outcome).inc()
        with self._lock:
            self._fleet_heartbeats[outcome] = (
                self._fleet_heartbeats.get(outcome, 0) + 1)

    def record_rerole(self, direction: str) -> None:
        """One role flip: to_prefill | to_unified."""
        self.fleet_reroles.labels(direction=direction).inc()
        with self._lock:
            self._fleet_reroles[direction] = (
                self._fleet_reroles.get(direction, 0) + 1)

    def record_kv_intro(self, outcome: str) -> None:
        """One KvIntro send: sent | gone | dropped | failed."""
        self.kv_intros.labels(outcome=outcome).inc()
        with self._lock:
            self._kv_intros[outcome] = self._kv_intros.get(outcome, 0) + 1

    def set_registry_role(self, role: str) -> None:
        """This registry's HA role: both series are written (the role 1,
        the other 0), so a flip never leaves two reading 1."""
        self.registry_role.labels(role="primary").set(
            1 if role == "primary" else 0)
        self.registry_role.labels(role="standby").set(
            1 if role == "standby" else 0)

    def record_registry_takeover(self, reason: str) -> None:
        """One HA role transition: lease_expired (a standby promoted) or
        fenced (a primary stepped down)."""
        self.registry_takeovers.labels(reason=reason).inc()
        with self._lock:
            self._registry_takeovers[reason] = (
                self._registry_takeovers.get(reason, 0) + 1)

    def set_registry_epoch(self, epoch: int) -> None:
        self.registry_epoch.set(epoch)

    def set_kv_wire_rate(self, src: str, dst: str, rate: float) -> None:
        """One wire's learned rate (``MeshWireRates`` is the only writer
        and drives the removals, so the label set follows live wires)."""
        with self._lock:
            self.kv_wire_rate.labels(src=src, dst=dst).set(rate)

    def remove_kv_wire_rate(self, src: str, dst: str) -> None:
        with self._lock:
            try:
                self.kv_wire_rate.remove(src, dst)
            except KeyError:
                pass

    def fleet_counters(self) -> Dict[str, Any]:
        """The heartbeat, rerole and intro counts of the ``/server/stats``
        fleet block."""
        with self._lock:
            return {"heartbeats": dict(self._fleet_heartbeats),
                    "reroles": dict(self._fleet_reroles),
                    "kv_intros": dict(self._kv_intros)}

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
        cache["peer_fetch"] = {
            **self._prefix_fetches,
            "bytes": self._prefix_fetch_bytes,
            "avg_ms": round(self._fetch_sum / max(1, self._fetch_count)
                            * 1000.0, 3)}
        cache["route_decisions"] = dict(self._prefix_routes)
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

    def snapshot(self, engine_statuses: Tuple[EngineStatus, ...] = ()
                 ) -> MetricsSnapshot:
        """The rates and latencies over trailing windows: tokens per
        second over 10 s, the request latency's mean and p99 over the perf
        store's window (``slo.window_s``, 60 s by default; the p99 a
        bucket's midpoint, as the reference reads it), the TTFT and
        batch-size means over the last 1024."""
        now = time.monotonic()
        lat = window_stats(self.perf.wire_digest("latency_ms"),
                           self.perf.window_s, self.perf.as_of_epoch())
        with self._lock:
            self._trim_locked(now)
            window_tokens = sum(n for _, n in self._token_events)
            span = (max(now - self._token_events[0][0], 1e-3)
                    if self._token_events else _TOKEN_WINDOW_S)
            total_cache = self._cache_hits + self._cache_misses
            return MetricsSnapshot(
                total_requests=self._total_requests,
                active_requests=self._active_requests,
                tokens_per_second=window_tokens / span,
                average_ttft_ms=(sum(self._ttfts_ms) / len(self._ttfts_ms)
                                 if self._ttfts_ms else 0.0),
                average_latency_ms=lat.get("mean", 0.0),
                p99_latency_ms=lat.get("p99", 0.0),
                average_batch_size=(
                    sum(self._batch_sizes) / len(self._batch_sizes)
                    if self._batch_sizes else 0.0),
                cache_hit_rate=(self._cache_hits / total_cache
                                if total_cache else 0.0),
                queue_depth=self._queue_depth,
                worker_statuses=tuple(engine_statuses),
                uptime_seconds=now - self._started_at,
                disagg=self._disagg_block_locked(engine_statuses),
                cache=self._cache_block_locked(engine_statuses),
                resilience=self._resilience_block_locked(),
                tracing=self._tracing_block_locked(),
            )

    def _disagg_block_locked(self, engine_statuses) -> Optional[Dict]:
        if not self._handoffs and all(s.role == "unified"
                                      for s in engine_statuses):
            return None
        return {
            "handoffs": dict(self._handoffs),
            "handoff_bytes": self._handoff_bytes,
            "handoff_chunks": self._handoff_chunks,
            "handoff_stall_count": self._stall_count,
            "handoff_stall_avg_ms": round(
                self._stall_sum / max(1, self._stall_count) * 1000.0, 3),
        }

    def _resilience_block_locked(self) -> Optional[Dict]:
        if not (self._engine_restarts or self._redispatches
                or self._requests_expired or self._requests_shed
                or self._retry_denied or self._breaker_transitions):
            return None
        out: Dict[str, Any] = {
            "engine_restarts": dict(self._engine_restarts),
            "redispatched": dict(self._redispatches),
            "requests_expired": self._requests_expired}
        if self._requests_shed:
            shed: Dict[str, Dict[str, int]] = {}
            for (tenant, reason), n in self._requests_shed.items():
                shed.setdefault(tenant, {})[reason] = n
            out["requests_shed"] = shed
        if self._retry_denied:
            out["retry_denied"] = dict(self._retry_denied)
        if self._breaker_transitions:
            out["breaker_transitions"] = dict(self._breaker_transitions)
        return out

    def _tracing_block_locked(self) -> Optional[Dict]:
        if not (self._trace_drops or self._phase_requests):
            return None
        return {"spans_dropped": dict(self._trace_drops),
                "phase_requests": self._phase_requests,
                "phase_seconds": {k: round(v, 6) for k, v in
                                  sorted(self._phase_sums.items())}}
