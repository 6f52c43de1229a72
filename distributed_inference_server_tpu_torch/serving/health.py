"""Gray-failure defense: latency-scored health, circuit breakers,
deadline-aware admission and the shared retry budget (the port's copy of
``distributed_inference_server_tpu/serving/health.py``).

- ``HealthScorer``: a periodic evaluator that demotes replicas
  healthy -> degraded -> ejected on evidence, with two-sided hysteresis
  (``health.demote_after`` bad evaluations down one level,
  ``health.recover_after`` clean ones up). Signals: **wedge** (the
  replica's step-clock dispatch count, fed after every engine step into
  the perf store, stops moving while work is queued for
  ``health.stall_s``, armed once it dispatched at least once), **latency**
  (a source's windowed TTFT / TBT p99 above ``health.latency_ratio`` x the
  median of the other sources'; one process is one source, so this needs
  the fleet's telemetry, not ported) and **wire** (consecutive wire
  failures; a local replica has none). ``stamp`` overlays the verdicts on
  ``AdaptiveScheduler.statuses()``; routing prefers healthy replicas.
- ``CircuitBreaker``: closed -> open after ``health.wire_failures``
  failures -> half-open (one probe) after ``health.breaker_open_s``. Its
  owner in the reference is the fleet's KV data channel, which comes with
  the fleet.
- ``AdmissionControl``: sheds a request at admission (503, ``Retry-After``,
  code ``admission_shed``) when the windowed queue-wait p90 already blows
  its deadline (``admission.deadline_ms``, or ``deadline_factor`` x its
  tenant's TTFT objective); a tenant of DRR weight ``w`` sheds at
  ``deadline x w / w_max`` (brownout: the lightest tenants first).
- ``RetryBudget``: redispatch and the handoff retry share one windowed
  budget (a fraction of recent admits, floored), so a sick server cannot
  amplify its own load.
"""

from __future__ import annotations

import logging
import math
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional, Tuple

from distributed_inference_server_tpu_torch.core.errors import QueueFull
from distributed_inference_server_tpu_torch.serving.teledigest import (
    SloSettings,
    window_stats,
)

logger = logging.getLogger(__name__)

HEALTH_HEALTHY = "healthy"
HEALTH_DEGRADED = "degraded"
HEALTH_EJECTED = "ejected"
HEALTH_STATES = (HEALTH_HEALTHY, HEALTH_DEGRADED, HEALTH_EJECTED)
_RANK = {HEALTH_HEALTHY: 0, HEALTH_DEGRADED: 1, HEALTH_EJECTED: 2}


def health_rank(state: str) -> int:
    """healthy=0 < degraded=1 < ejected=2 (routing sort key)."""
    return _RANK.get(state, 0)


@dataclass(frozen=True)
class HealthSettings:
    """Knobs of the gray-failure control plane (config section
    ``health``; docs/RESILIENCE.md "Gray failures and overload")."""

    enabled: bool = True
    interval_s: float = 1.0
    # wedge detection: no step-clock dispatch progress while work is
    # queued for this long (after at least one prior dispatch)
    stall_s: float = 5.0
    # latency demotion: a source's windowed p99 exceeds this multiple of
    # the median of the OTHER sources' p99s...
    latency_ratio: float = 3.0
    # ...and recovers below this multiple (two-sided hysteresis band)
    recover_ratio: float = 1.5
    # consecutive bad/clean evaluations to move one level down/up
    demote_after: int = 3
    recover_after: int = 3
    # minimum windowed samples before a latency comparison is trusted
    min_window_requests: int = 8
    # consecutive wire failures before a member's engines eject (also
    # the KV data channel's breaker close→open threshold)
    wire_failures: int = 3
    # breaker open → half-open probe delay
    breaker_open_s: float = 5.0
    # shared retry budget: retries allowed per window as a fraction of
    # admits, floored at retry_budget_min
    retry_budget_ratio: float = 0.1
    retry_budget_min: int = 3
    retry_window_s: float = 10.0
    # SLO burn-rate escalation input to the degradation ladder
    # (serving/degradation.py): burn >= slo_burn_high escalates to
    # REJECT_LOW_PRIORITY, >= slo_burn_high/2 to REDUCED_BATCH_SIZE,
    # once the window holds slo_burn_min_requests verdicts
    slo_burn_high: float = 0.5
    slo_burn_min_requests: int = 20


@dataclass(frozen=True)
class AdmissionSettings:
    """Knobs of deadline-aware admission (config section
    ``admission``)."""

    shed_enabled: bool = True
    # explicit deadline; 0 = derive from the applicable TTFT SLO
    deadline_ms: float = 0.0
    # deadline = factor × the (per-tenant) slo.ttft_ms objective
    deadline_factor: float = 1.0
    # weight-scaled early shed (lowest DRR weight sheds first)
    brownout: bool = True
    # don't trust a cold estimator: no shedding until the window holds
    # this many queue-wait samples
    min_window_requests: int = 8
    retry_after_cap_s: float = 30.0


class AdmissionShed(QueueFull):
    """Raised by ``Dispatcher.submit`` when deadline-aware admission
    sheds the request (serving/health.py AdmissionControl). A subclass
    of QueueFull so every existing backpressure handler keeps working;
    carries the shed reason and the Retry-After hint."""

    def __init__(self, reason: str, retry_after_s: float,
                 estimate_ms: float, deadline_ms: float):
        super().__init__()
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.estimate_ms = estimate_ms
        self.deadline_ms = deadline_ms


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


class CircuitBreaker:
    """closed → open (``threshold`` consecutive failures) → half-open
    (one probe after ``open_s``) → closed (probe succeeded) / open
    (probe failed). Thread-safe; ``on_transition(new_state)`` runs
    outside the lock (it counts metrics)."""

    def __init__(self, threshold: int = 3, open_s: float = 5.0,
                 on_transition: Optional[Callable[[str], None]] = None):
        self.threshold = max(1, threshold)
        self.open_s = open_s
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_at = 0.0
        self._transitions = 0
        # bounded transition timeline: the hysteresis PROPERTY (no
        # half-open probe before the cooldown elapsed) is asserted off
        # this by the breaker_flap chaos scenario
        self._history: Deque[Tuple[float, str]] = deque(maxlen=64)

    def state(self, now: Optional[float] = None) -> str:
        with self._lock:
            return self._state_locked(time.monotonic()
                                      if now is None else now)

    def _state_locked(self, now: float) -> str:
        if (self._state == BREAKER_OPEN
                and now - self._opened_at >= self.open_s):
            self._set_locked(BREAKER_HALF_OPEN)
        if (self._state == BREAKER_HALF_OPEN and self._probe_inflight
                and now - self._probe_at >= self.open_s):
            # the probe's stream was sent but NEVER answered — the
            # wedged-member gray failure itself. Without this bound the
            # breaker sits half-open forever with the probe consumed
            # (no failure, no success), keeping the member in election
            # while every stream fails fast. An unanswered probe IS a
            # failure: re-open with a fresh cooldown.
            self._probe_inflight = False
            self._opened_at = now
            self._set_locked(BREAKER_OPEN)
        return self._state

    def available(self, now: Optional[float] = None) -> bool:
        """Election gate (non-consuming): False only while OPEN inside
        the cooldown. Half-open reads available so the next attempt can
        be the probe — a member behind a broken wire leaves the
        handoff-target / fetch-source pool for exactly the cooldown."""
        return self.state(now) != BREAKER_OPEN

    def try_acquire(self, now: Optional[float] = None) -> bool:
        """Attempt gate (consuming): closed admits; half-open admits ONE
        probe (further attempts fail fast until it resolves); open
        inside the cooldown fails fast."""
        now = time.monotonic() if now is None else now
        with self._lock:
            state = self._state_locked(now)
            if state == BREAKER_CLOSED:
                return True
            if state == BREAKER_HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                self._probe_at = now
                return True
            return False

    def release(self) -> None:
        """Un-consume a ``try_acquire`` whose attempt never actually ran
        (e.g. the stream window rejected it after the probe was taken) —
        without this, an unused probe would wedge half-open forever."""
        with self._lock:
            self._probe_inflight = False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != BREAKER_CLOSED:
                self._set_locked(BREAKER_CLOSED)

    def record_failure(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            state = self._state_locked(now)
            self._failures += 1
            self._probe_inflight = False
            if state == BREAKER_HALF_OPEN or (
                    state == BREAKER_CLOSED
                    and self._failures >= self.threshold):
                self._opened_at = now
                self._set_locked(BREAKER_OPEN)

    def _set_locked(self, state: str) -> None:
        if state == self._state:
            return
        self._state = state
        self._transitions += 1
        self._history.append((time.monotonic(), state))
        cb = self.on_transition
        if cb is not None:
            # fire-and-forget outside the caller's critical section is
            # not possible without dropping the lock; the callback is a
            # counter bump (metrics), safe under it
            try:
                cb(state)
            except Exception:  # noqa: BLE001 — observability isolation
                logger.debug("breaker transition callback failed",
                             exc_info=True)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "transitions": self._transitions,
            }

    def history(self) -> List[Tuple[float, str]]:
        """(monotonic time, state entered) transition timeline (bounded
        at 64) — what the chaos harness asserts hysteresis against."""
        with self._lock:
            return list(self._history)


# ---------------------------------------------------------------------------
# Shared retry budget
# ---------------------------------------------------------------------------


class RetryBudget:
    """A windowed budget shared by every retry amplifier on the host:
    crash-safe redispatch, the disagg handoff retry loop, and KV
    data-channel reconnects. Allows at most
    ``max(min_retries, ratio × admits_in_window)`` retries per trailing
    window — a sick fleet serving N requests/s cannot generate more
    than ~ratio·N retries/s of extra load on top. Denial is not an
    error: every consumer falls back to its existing exactly-once
    degradation (sink failure / decode-in-place / recompute)."""

    def __init__(self, ratio: float = 0.1, min_retries: int = 3,
                 window_s: float = 10.0, metrics=None):
        self.ratio = ratio
        self.min_retries = min_retries
        self.window_s = window_s
        self.metrics = metrics
        self._lock = threading.Lock()
        self._admits: Deque[Tuple[float, int]] = deque()
        self._retries: Deque[float] = deque()
        self._denied = 0

    def note_admit(self, n: int = 1, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._admits.append((now, n))
            self._prune_locked(now)

    def acquire(self, site: str, now: Optional[float] = None) -> bool:
        """Take one retry from the budget; False = budget exhausted (the
        caller must degrade, not retry). Denials count into
        ``retry_budget_exhausted_total{site}``."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._prune_locked(now)
            admits = sum(n for _, n in self._admits)
            allowed = max(self.min_retries,
                          int(math.floor(self.ratio * admits)))
            if len(self._retries) >= allowed:
                self._denied += 1
                denied = True
            else:
                self._retries.append(now)
                denied = False
        if denied and self.metrics is not None:
            self.metrics.record_retry_denied(site)
        return not denied

    def _prune_locked(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._admits and self._admits[0][0] < cutoff:
            self._admits.popleft()
        while self._retries and self._retries[0] < cutoff:
            self._retries.popleft()

    def stats(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            self._prune_locked(now)
            admits = sum(n for _, n in self._admits)
            return {
                "window_admits": admits,
                "window_retries": len(self._retries),
                "allowed": max(self.min_retries,
                               int(math.floor(self.ratio * admits))),
                "denied_total": self._denied,
            }


# ---------------------------------------------------------------------------
# Deadline-aware admission
# ---------------------------------------------------------------------------


class AdmissionControl:
    """Shed-at-admission decision (docs/RESILIENCE.md "Gray failures
    and overload"): compare the windowed queue-wait estimate against
    the request's SLO-derived deadline, weight-scaled per tenant for
    brownout ordering. Called on the submit path, so the estimate is
    cached briefly — shedding must stay O(µs) under exactly the load
    that triggers it."""

    _CACHE_S = 0.25

    def __init__(self, settings: Optional[AdmissionSettings] = None,
                 slo: Optional[SloSettings] = None,
                 metrics=None,
                 tenant_weights: Optional[Mapping[str, float]] = None):
        self.settings = settings or AdmissionSettings()
        self.slo = slo
        self.metrics = metrics
        self.tenant_weights = dict(tenant_weights or {})
        self._w_max = max(self.tenant_weights.values(), default=1.0)
        self._w_max = max(self._w_max, 1.0)  # unlisted tenants weigh 1
        self._lock = threading.Lock()
        self._cached_at = 0.0
        self._cached_estimate: Optional[float] = None
        self._shed_total = 0

    # -- deadline ------------------------------------------------------------

    def deadline_ms(self, tenant: str) -> float:
        """The tenant's admission deadline; 0 = no deadline (shedding
        off for this tenant). Explicit ``admission.deadline_ms`` wins;
        otherwise the applicable TTFT objective × deadline_factor."""
        if self.settings.deadline_ms > 0:
            return self.settings.deadline_ms
        if self.slo is None:
            return 0.0
        ttft_ms, _ = self.slo.limits_for(tenant)
        return ttft_ms * self.settings.deadline_factor if ttft_ms else 0.0

    # -- estimator -----------------------------------------------------------

    def queue_wait_estimate_ms(self,
                               now: Optional[float] = None
                               ) -> Optional[float]:
        """Windowed queue-wait p90 (ms) from the ``queue_wait_ms``
        digest (serving/teledigest.py — the same series /server/perf
        serves), or None while the window holds fewer than
        ``admission.min_window_requests`` samples (a cold estimator
        never sheds). Cached ~250 ms: overload is exactly when this is
        called most."""
        if self.metrics is None:
            return None
        now = time.monotonic() if now is None else now
        with self._lock:
            if now - self._cached_at < self._CACHE_S:
                return self._cached_estimate
        perf = self.metrics.perf_store()
        stats = window_stats(perf.wire_digest("queue_wait_ms"),
                             perf.window_s, perf.as_of_epoch())
        estimate = None
        if stats.get("count", 0) >= self.settings.min_window_requests:
            estimate = stats.get("p90")
        with self._lock:
            self._cached_at = now
            self._cached_estimate = estimate
        return estimate

    # -- the decision ---------------------------------------------------------

    def check(self, tenant: str) -> Optional[AdmissionShed]:
        """Returns the AdmissionShed to raise, or None to admit.
        Brownout ordering: tenant weight ``w`` sheds at
        ``estimate > deadline × w / w_max`` — the lowest-weight tenants
        shed first as the backlog grows, the heaviest only when its own
        deadline is genuinely blown (reason "deadline" vs "brownout")."""
        if not self.settings.shed_enabled:
            return None
        deadline = self.deadline_ms(tenant)
        if deadline <= 0:
            return None
        estimate = self.queue_wait_estimate_ms()
        if estimate is None:
            return None
        threshold = deadline
        if self.settings.brownout:
            w = self.tenant_weights.get(tenant, 1.0)
            threshold = deadline * min(1.0, w / self._w_max)
        if estimate <= threshold:
            return None
        reason = "deadline" if estimate > deadline else "brownout"
        retry_after = min(self.settings.retry_after_cap_s,
                          max(1.0, math.ceil(estimate / 1000.0)))
        with self._lock:
            self._shed_total += 1
        return AdmissionShed(reason, retry_after, estimate, deadline)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            shed = self._shed_total
            estimate = self._cached_estimate
        return {
            "shed_total": shed,
            "queue_wait_estimate_ms": (round(estimate, 3)
                                       if estimate is not None else None),
        }


# ---------------------------------------------------------------------------
# Latency-scored health
# ---------------------------------------------------------------------------


class _EngineHealth:
    """Per-engine hysteresis state (scorer-thread-owned)."""

    __slots__ = ("state", "bad", "good", "reasons", "since",
                 "last_progress", "progress_t", "seen_progress",
                 "last_queued")

    def __init__(self) -> None:
        self.state = HEALTH_HEALTHY
        self.bad = 0
        self.good = 0
        self.reasons: Tuple[str, ...] = ()
        self.since = time.monotonic()
        # wedge tracking: last observed step-clock dispatch count and
        # when it last moved; seen_progress gates the detector until
        # the engine has dispatched at least once (a cold replica
        # mid-compile must never read as wedged); last_queued restarts
        # the stall clock on the idle→busy transition (idle time is not
        # stall time — a warm engine picking up work after a quiet hour
        # must get the full stall_s before it reads as wedged)
        self.last_progress = -1.0
        self.progress_t = time.monotonic()
        self.seen_progress = False
        self.last_queued = 0


class HealthScorer:
    """Demotes engines healthy → degraded → ejected on telemetry
    evidence, with two-sided hysteresis; routing consumes the verdicts
    via ``stamp()`` (serving/scheduler.py health tiering).

    Thread-shape: ``evaluate`` runs on the scorer thread (or a test); ``stamp``/``state`` are read from the dispatcher thread
    (one dict lookup per engine against a snapshot replaced atomically);
    wire-failure counters are read off the runners (GIL-atomic ints
    maintained by their own threads)."""

    def __init__(self, settings: Optional[HealthSettings] = None,
                 scheduler=None, metrics=None,
                 telemetry_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 recorder=None):
        """``telemetry_fn`` (registry hosts: the FleetServer's
        ``telemetry_snapshot``) supplies per-member digest frames for
        the latency comparison; None = local-only (wedge + wire signals
        still run). ``recorder`` (serving/flightrec.py): transitions
        land in the global fleet-event window, so a request's timeline
        shows "the replica was demoted mid-flight"."""
        self.settings = settings or HealthSettings()
        self.scheduler = scheduler
        self.metrics = metrics
        self.telemetry_fn = telemetry_fn
        self.recorder = recorder
        self._lock = threading.Lock()
        self._engines: Dict[str, _EngineHealth] = {}
        # engine_id -> state, replaced wholesale per evaluation; read
        # lock-free by stamp() (dict replace is GIL-atomic)
        self._snapshot: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- routing consumption (any thread) ------------------------------------

    def state(self, engine_id: str) -> str:
        return self._snapshot.get(engine_id, HEALTH_HEALTHY)

    def stamp(self, statuses: List) -> List:
        """Overlay health verdicts onto an EngineStatus snapshot
        (AdaptiveScheduler.statuses). Healthy engines pass through
        unchanged — the common case allocates nothing."""
        import dataclasses

        snap = self._snapshot
        if not snap:
            return statuses
        out = []
        for s in statuses:
            state = snap.get(s.engine_id, HEALTH_HEALTHY)
            out.append(s if state == HEALTH_HEALTHY
                       else dataclasses.replace(s, health=state))
        return out

    # -- evaluation (scorer thread) ------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[Tuple[str, str, str]]:
        """One scoring pass; returns the transitions applied as
        ``(engine_id, old, new)``."""
        now = time.monotonic() if now is None else now
        if self.scheduler is None:
            return []
        runners = self.scheduler.engines()
        latency_bad = self._latency_verdicts()
        transitions: List[Tuple[str, str, str]] = []
        live_ids = set()
        with self._lock:
            for runner in runners:
                eid = runner.engine_id
                live_ids.add(eid)
                eh = self._engines.get(eid)
                if eh is None:
                    eh = self._engines[eid] = _EngineHealth()
                reasons, hold = self._signals(runner, eh, latency_bad, now)
                transition = self._hysteresis_locked(eid, eh, reasons,
                                                     hold)
                if transition is not None:
                    transitions.append(transition)
            pruned = [eid for eid in self._engines if eid not in live_ids]
            for eid in pruned:
                del self._engines[eid]  # unregistered engine
            self._snapshot = {
                eid: eh.state for eid, eh in self._engines.items()
                if eh.state != HEALTH_HEALTHY
            }
        for eid, old, new in transitions:
            logger.warning("engine %s health: %s -> %s", eid, old, new)
            if self.metrics is not None:
                self.metrics.record_health_transition(eid, new)
            if self.recorder is not None:
                self.recorder.note_global("health_transition",
                                          engine=eid, old=old, new=new)
        if self.metrics is not None:
            for eid in pruned:
                # restarted fleet members mint fresh proxy ids — dead
                # engines must not grow the gauge label set forever
                self.metrics.remove_engine_health(eid)
        return transitions

    def _signals(self, runner, eh: _EngineHealth,
                 latency_bad: Dict[str, str],
                 now: float) -> Tuple[List[str], bool]:
        """The bad-evidence reasons for one engine this evaluation
        (empty = clean) plus a hold flag: True = the latency signal sits
        inside the hysteresis band (above recover_ratio, below
        latency_ratio), so NEITHER streak advances — that band is the
        two-sided hysteresis that keeps a borderline replica from
        flapping. Eject-class evidence is prefixed ``eject:``."""
        reasons: List[str] = []
        eid = runner.engine_id
        # wire: consecutive control-wire send failures (RemoteRunner
        # counts them; local runners have no wire) or the member's KV
        # data channel breaker being open
        wire_fails = getattr(runner, "consecutive_wire_failures", 0)
        if wire_fails >= self.settings.wire_failures:
            reasons.append("eject:wire_failures")
        channel = getattr(runner, "kv_channel", None)
        if channel is not None:
            breaker = getattr(channel, "breaker", None)
            if breaker is not None and breaker.state() == BREAKER_OPEN:
                reasons.append("kv_breaker_open")
        # wedge: the step clock stopped while work is queued. Remote
        # proxies have no local step clock — their wedge shows up as
        # latency through the telemetry comparison instead.
        if not getattr(runner, "is_remote", False):
            try:
                status = runner.status()
            except Exception:  # noqa: BLE001 — status must not kill scoring
                logger.debug("health: status() of %s failed", eid,
                             exc_info=True)
                status = None
            if status is not None:
                progress = self._progress(eid)
                if progress != eh.last_progress:
                    eh.last_progress = progress
                    eh.progress_t = now
                    eh.seen_progress = eh.seen_progress or progress > 0
                queued = status.active_requests + status.waiting_requests
                if queued > 0 and eh.last_queued == 0:
                    # idle→busy: the stall clock starts when work
                    # ARRIVES — counting the idle gap would eject a
                    # healthy warm engine the moment it picks up work
                    eh.progress_t = max(eh.progress_t, now)
                eh.last_queued = queued
                if (eh.seen_progress and queued > 0
                        and now - eh.progress_t > self.settings.stall_s):
                    reasons.append("eject:stalled")
        # latency: the member (or the local process) far above the
        # fleet median
        verdict = latency_bad.get(self._source_of(eid))
        if verdict == "bad":
            reasons.append("latency")
        return reasons, verdict == "band" and not reasons

    def _progress(self, engine_id: str) -> float:
        """Cumulative step-clock dispatch count for one local engine
        (the wedge detector's progress signal)."""
        if self.metrics is None:
            return 0.0
        prefix = f"step.{engine_id}."
        total = 0.0
        for name, value in self.metrics.perf_store().counters().items():
            if name.startswith(prefix) and name.endswith(".dispatches"):
                total += value
        return total

    @staticmethod
    def _source_of(engine_id: str) -> str:
        """Latency-comparison source key: remote proxies group by their
        member id (``<member>:<engine>``), local engines under
        ``local`` (one process = one ttft_ms digest)."""
        if ":" in engine_id:
            return engine_id.rsplit(":", 1)[0]
        return "local"

    def _latency_verdicts(self) -> Dict[str, str]:
        """source -> "bad" | "band" per evaluation, from the windowed
        TTFT/TBT p99s: a source is **bad** when its p99 exceeds
        ``latency_ratio`` × the median of the OTHER sources' p99s,
        clean only below ``recover_ratio`` × it, and **band** (neither
        streak advances) in between — the two-sided hysteresis."""
        p99s: Dict[str, Dict[str, float]] = {}
        min_n = self.settings.min_window_requests
        if self.metrics is not None:
            perf = self.metrics.perf_store()
            local = self._series_p99s(
                {"ttft_ms": perf.wire_digest("ttft_ms"),
                 "tbt_ms": perf.wire_digest("tbt_ms")},
                perf.window_s, min_n, perf.as_of_epoch())
            if local:
                p99s["local"] = local
        if self.telemetry_fn is not None:
            try:
                members = self.telemetry_fn()
            except Exception:  # noqa: BLE001 — telemetry is advisory
                logger.debug("health: telemetry snapshot failed",
                             exc_info=True)
                members = {}
            window_s = (self.metrics.perf_window_s()
                        if self.metrics is not None else 60.0)
            for member, frame in members.items():
                digests = frame.get("digests", {})
                vals = self._series_p99s(
                    {"ttft_ms": digests.get("ttft_ms", {}),
                     "tbt_ms": digests.get("tbt_ms", {})},
                    window_s, min_n)
                if vals:
                    p99s[member] = vals
        out: Dict[str, str] = {}
        if len(p99s) < 2:
            return out  # a median needs another source to compare to
        for source, vals in p99s.items():
            for series, p99 in vals.items():
                if series == "tbt_ms":
                    # tbt is member-vs-member only: the host's tbt_ms
                    # digest is CLIENT-observed — it includes
                    # remote-served streams' wire-bursty gaps, so using
                    # it as a source (or a baseline) would demote the
                    # host for a slow member's traffic. TTFT has no
                    # such bleed: each process digests only requests it
                    # served (metrics.record_ttft local=).
                    if source == "local":
                        continue
                    others = [v[series] for s, v in p99s.items()
                              if s not in (source, "local")
                              and series in v]
                else:
                    others = [v[series] for s, v in p99s.items()
                              if s != source and series in v]
                if not others:
                    continue
                baseline = statistics.median(others)
                if baseline <= 0:
                    continue
                if p99 > self.settings.latency_ratio * baseline:
                    out[source] = "bad"
                    break
                if p99 > self.settings.recover_ratio * baseline:
                    out.setdefault(source, "band")
        return out

    @staticmethod
    def _series_p99s(wires: Dict[str, Dict[str, Any]], window_s: float,
                     min_n: int, as_of_epoch: Optional[int] = None
                     ) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for series, wire in wires.items():
            if not wire:
                continue
            stats = window_stats(wire, window_s, as_of_epoch)
            if stats.get("count", 0) >= min_n and "p99" in stats:
                out[series] = stats["p99"]
        return out

    def _hysteresis_locked(self, eid: str, eh: _EngineHealth,
                           reasons: List[str], hold: bool
                           ) -> Optional[Tuple[str, str, str]]:
        """Two-sided hysteresis: ``demote_after`` consecutive bad
        evaluations move one level down (eject-class evidence targets
        EJECTED directly), ``recover_after`` clean ones move one level
        up, and a ``hold`` evaluation (latency in the band between
        recover_ratio and latency_ratio) advances neither streak.
        Returns the transition applied, if any."""
        if hold:
            return None
        if reasons:
            eh.bad += 1
            eh.good = 0
            eh.reasons = tuple(reasons)
        else:
            eh.good += 1
            eh.bad = 0
        old = eh.state
        new = old
        if eh.bad >= self.settings.demote_after:
            target = (HEALTH_EJECTED
                      if any(r.startswith("eject:") for r in reasons)
                      else HEALTH_DEGRADED)
            new = HEALTH_STATES[min(health_rank(target),
                                    health_rank(old) + 1)]
            if health_rank(target) > health_rank(new):
                # eject-class evidence steps through degraded first but
                # keeps the streak alive so the next bad evaluation
                # completes the ejection without a fresh demote_after
                eh.bad = self.settings.demote_after - 1
            else:
                eh.bad = 0
        elif eh.good >= self.settings.recover_after and old != HEALTH_HEALTHY:
            new = HEALTH_STATES[health_rank(old) - 1]
            eh.good = 0
        if new == old:
            return None
        eh.state = new
        eh.since = time.monotonic()
        if new == HEALTH_HEALTHY:
            eh.reasons = ()
        return (eid, old, new)

    # -- introspection (any thread) ------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The ``health`` block of ``/server/stats``."""
        now = time.monotonic()
        with self._lock:
            engines = {
                eid: {
                    "state": eh.state,
                    "reasons": list(eh.reasons),
                    "for_s": round(now - eh.since, 3),
                }
                for eid, eh in sorted(self._engines.items())
            }
        return {"engines": engines}

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        # lifecycle handle
        self._thread = threading.Thread(
            target=self._loop, name="health-scorer", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.settings.interval_s):
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 — scoring must stay alive
                logger.exception("health evaluation failed; retrying")
