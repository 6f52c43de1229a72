"""Per-request flight recorder: one queryable timeline per request with
phase-attributed latency (the port's copy of
``distributed_inference_server_tpu/serving/flightrec.py``).

The serving spine notes events into a bounded timeline as the request
moves (admit -> route_plan / schedule -> prefix_fetch / handoff phases ->
prefill_start -> first_token -> decode blocks -> terminal, redispatch hops
in between). At the terminal event ``finish`` partitions the request's
wall clock into ``ingress``, ``queue_wait``, ``engine_wait``,
``prefill``, ``peer_fetch``, ``handoff_stall``, ``decode`` and ``detok``:
each window is subtracted from the span that contains it, so the phases
sum to the wall clock exactly. They export as
``request_phase_seconds{phase}``, feed the ``queue_wait_ms`` / ``tbt_ms``
digests, and with ``slo`` set derive the request's SLO verdict. ``GET
/server/requests/<id>`` serves the timeline.

The port's phases beside the JAX package's: ``ingress`` runs from the
HTTP handler's receipt of the request (``admit(received_at=...)``) to its
admission, and the wall clock starts at the receipt (0 without one; the
SLO verdict's TTFT still starts at admission). ``engine_wait`` runs from
the dispatch to the engine's issue of the request's first prefill chunk
(the runner's ``prefill_start`` note, whose ``at`` is that instant), and
``prefill`` from there to the first token; a request with no
``prefill_start`` (a handoff import) keeps the whole dispatch -> first
token as ``prefill``, and ``engine_wait + prefill`` is always the JAX
package's ``prefill``. ``first_frame`` (the stream writer's first
written frame) exports the delay from the first token to that write as
``request_first_frame_seconds``: not a phase, as it overlaps decode.

Memory is bounded twice: ``max_requests`` timelines (oldest evicted) and
``max_events`` events each (the terminal event always lands). Token events
fold into one ``decode_block`` event per ``block_tokens`` tokens.
``note_global`` keeps server-level hops (health transitions, fault
arm / disarm) in one window shown in every timeline they overlap.
``clock`` is the injectable monotonic clock.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from distributed_inference_server_tpu_torch.serving.metrics import (
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.teledigest import (
    SloSettings,
    slo_verdict,
)

PHASES = ("ingress", "queue_wait", "engine_wait", "prefill", "peer_fetch",
          "handoff_stall", "decode", "detok")


class _Timeline:
    """One request's bounded event timeline (single-writer per field at
    any instant — the request has exactly one owner on the spine; the
    recorder's lock orders the rare ownership handoffs)."""

    __slots__ = (
        "request_id", "admitted_at", "events", "events_dropped", "tokens",
        "first_token_at", "last_token_at", "dispatch_at", "terminal_at",
        "status", "code", "peer_fetch_s", "handoff_stall_s", "trace_id",
        "attrs", "slo", "_block_anchor", "received_at", "prefill_start_at",
        "first_frame_at",
    )

    def __init__(self, request_id, now: float):
        self.request_id = request_id
        self.admitted_at = now
        # the HTTP receipt (the wall clock's start) and the engine's first
        # prefill chunk, when known; the first frame written to a stream
        self.received_at = now
        self.prefill_start_at: Optional[float] = None
        self.first_frame_at: Optional[float] = None
        self.events: List[Tuple[float, str, Dict[str, Any]]] = []
        self.events_dropped = 0
        self.tokens = 0
        self.first_token_at: Optional[float] = None
        self.last_token_at: Optional[float] = None
        self.dispatch_at: Optional[float] = None
        self.terminal_at: Optional[float] = None
        self.status = "live"
        self.code: Optional[str] = None
        self.peer_fetch_s = 0.0
        self.handoff_stall_s = 0.0
        self.trace_id: Optional[str] = None
        self.attrs: Dict[str, Any] = {}
        # SLO verdict block, derived once at finish() (None = no
        # applicable objective; docs/OBSERVABILITY.md)
        self.slo: Optional[Dict[str, Any]] = None
        self._block_anchor = 0  # tokens already folded into block events


class FlightRecorder:
    """Bounded per-request timelines + derived phase attribution."""

    def __init__(self, metrics: Optional[MetricsCollector] = None,
                 max_requests: int = 256, max_events: int = 96,
                 block_tokens: int = 16, max_global_events: int = 128,
                 slo: Optional[SloSettings] = None,
                 clock: Callable[[], float] = time.monotonic):
        """``slo`` (serving/teledigest.py SloSettings) arms SLO
        accounting: ``finish()`` derives an ok/violated verdict from
        the request's exact phase partition, stamps it on the timeline,
        and feeds ``slo_requests_total{tenant,verdict}`` + the goodput
        counters (docs/OBSERVABILITY.md "Performance telemetry")."""
        self.metrics = metrics
        self.slo = slo
        self.clock = clock
        self.max_requests = max_requests
        self.max_events = max_events
        self.block_tokens = max(1, block_tokens)
        self._lock = threading.Lock()
        self._timelines: "OrderedDict[Any, _Timeline]" = OrderedDict()
        self._evicted = 0
        # fleet-level hops (rerole, fault arm/disarm): one bounded
        # window shared by every timeline that overlaps it
        self._global: Deque[Tuple[float, str, Dict[str, Any]]] = deque(
            maxlen=max_global_events)

    # -- recording (any thread) --------------------------------------------

    def admit(self, request_id, received_at: Optional[float] = None,
              **attrs) -> None:
        """The request entered the spine (handler submit). ``trace_id``
        in ``attrs`` links the timeline to its stitched trace;
        ``received_at`` (this recorder's clock) is the HTTP receipt, the
        start of the ``ingress`` phase."""
        now = self.clock()
        with self._lock:
            tl = self._get_or_create_locked(request_id, now)
            if received_at is not None:
                tl.received_at = min(float(received_at), tl.admitted_at)
            tl.attrs.update(attrs)
            tid = attrs.get("trace_id")
            if tid:
                tl.trace_id = str(tid)
            self._append_locked(tl, now, "admit", attrs)

    def note(self, request_id, name: str, **attrs) -> None:
        """One structured lifecycle event. Recognized names feed the
        phase model: ``route_plan``/``schedule`` anchor the dispatch
        instant; a ``seconds`` attr on ``prefix_fetch`` accumulates the
        peer_fetch window; a ``stall_s`` attr (handoff events)
        accumulates the handoff_stall window; ``prefill_start`` with its
        ``at`` (this recorder's clock; the event lands at that instant)
        ends the engine_wait window."""
        now = self.clock()
        with self._lock:
            tl = self._get_or_create_locked(request_id, now)
            if name in ("route_plan", "schedule") and tl.dispatch_at is None:
                tl.dispatch_at = now
            if name == "prefill_start" and "at" in attrs:
                attrs = dict(attrs)
                now = tl.prefill_start_at = float(attrs.pop("at"))
            if name == "prefix_fetch" and "seconds" in attrs:
                try:
                    tl.peer_fetch_s += max(0.0, float(attrs["seconds"]))
                except (TypeError, ValueError):
                    pass
            if "stall_s" in attrs:
                try:
                    tl.handoff_stall_s += max(0.0, float(attrs["stall_s"]))
                except (TypeError, ValueError):
                    pass
            self._append_locked(tl, now, name, attrs)

    def token(self, request_id, n: int = 1) -> None:
        """The per-token hot path: counter bumps plus one aggregated
        ``decode_block`` event per ``block_tokens`` tokens."""
        now = self.clock()
        with self._lock:
            # auto-create: requests submitted straight to a runner
            # (chaos harness, tests) still get a usable timeline
            tl = self._get_or_create_locked(request_id, now)
            if tl.terminal_at is not None:
                return
            if tl.first_token_at is None:
                tl.first_token_at = now
                self._append_locked(tl, now, "first_token", {})
            tl.last_token_at = now
            tl.tokens += n
            if tl.tokens - tl._block_anchor >= self.block_tokens:
                count = tl.tokens - tl._block_anchor
                tl._block_anchor = tl.tokens
                self._append_locked(tl, now, "decode_block",
                                    {"tokens": count,
                                     "total": tl.tokens})

    def first_frame(self, request_id) -> None:
        """The stream writer wrote the request's first token frame:
        observes the delay from the first token as
        ``request_first_frame_seconds`` (once a request)."""
        now = self.clock()
        with self._lock:
            tl = self._timelines.get(request_id)
            if (tl is None or tl.first_token_at is None
                    or tl.first_frame_at is not None):
                return
            tl.first_frame_at = now
            delay = max(0.0, now - tl.first_token_at)
        if self.metrics is not None:
            self.metrics.record_first_frame(delay)

    def finish(self, request_id, status: str,
               code: Optional[str] = None) -> Optional[Dict[str, float]]:
        """The request terminated (done XOR error — first call wins,
        matching the sink contract). Derives and returns the phase
        attribution, and exports it as request_phase_seconds."""
        now = self.clock()
        with self._lock:
            tl = self._get_or_create_locked(request_id, now)
            if tl.terminal_at is not None:
                return None
            tl.terminal_at = now
            tl.status = status
            tl.code = code
            if tl.tokens > tl._block_anchor:
                self._append_locked(
                    tl, tl.last_token_at or now, "decode_block",
                    {"tokens": tl.tokens - tl._block_anchor,
                     "total": tl.tokens})
                tl._block_anchor = tl.tokens
            # the terminal event always lands, bounded or not
            tl.events.append(
                (now, "terminal",
                 {"status": status, **({"code": code} if code else {})}))
            phases = self._phases_locked(tl, now)
            # SLO inputs, exactly from the phase model: TTFT is the
            # admit->first-token span (queue_wait + prefill +
            # peer_fetch, exactly), TBT the mean first->last inter-token
            # gap (decode + handoff stalls — the client observes the
            # stall, so the objective charges it)
            ttft_s = (tl.first_token_at - tl.admitted_at
                      if tl.first_token_at is not None else None)
            tbt_s = None
            if (tl.tokens > 1 and tl.first_token_at is not None
                    and tl.last_token_at is not None):
                tbt_s = ((tl.last_token_at - tl.first_token_at)
                         / (tl.tokens - 1))
            tenant = str(tl.attrs.get("tenant") or "default")
            tokens = tl.tokens
        if code == "admission_shed":
            # the request was never ADMITTED (serving/health.py): its
            # timeline is the whole artifact. Exporting its ~0s
            # queue_wait would drag the very estimate that shed it back
            # under the deadline (admission oscillates open under a
            # standing backlog), and an SLO verdict would burn the
            # objective for work the fleet declined in microseconds —
            # both signals must track admitted traffic only.
            return phases
        verdict = None
        if self.slo is not None:
            verdict = slo_verdict(self.slo, tenant, ttft_s, tbt_s, status)
            if verdict is not None:
                # single assignment after the terminal landed: the
                # request has exactly one finisher (first call wins
                # above), so no second writer exists
                tl.slo = verdict
        if self.metrics is not None:
            self.metrics.record_request_phases(phases, tbt_s=tbt_s)
            if verdict is not None:
                self.metrics.record_slo(tenant, verdict["verdict"],
                                        tokens=tokens)
        return phases

    def note_global(self, name: str, **attrs) -> None:
        """A fleet-level hop (rerole, fault arm/disarm) — merged into
        every overlapping timeline at render time."""
        with self._lock:
            self._global.append((self.clock(), name, attrs))

    # -- internals (lock held) ---------------------------------------------

    def _get_or_create_locked(self, request_id, now: float) -> _Timeline:
        tl = self._timelines.get(request_id)
        if tl is not None:
            return tl
        tl = _Timeline(request_id, now)
        self._timelines[request_id] = tl
        while len(self._timelines) > self.max_requests:
            self._timelines.popitem(last=False)
            self._evicted += 1
        return tl

    def _append_locked(self, tl: _Timeline, now: float, name: str,
                       attrs: Dict[str, Any]) -> None:
        if len(tl.events) >= self.max_events:
            tl.events_dropped += 1
            return
        tl.events.append((now, name, dict(attrs)))

    def _phases_locked(self, tl: _Timeline,
                       now: float) -> Dict[str, float]:
        """Partition [receipt, terminal] into the eight phases. Windowed
        costs (peer fetch, handoff stall) are clamped to the span that
        contains them, and the prefill start to dispatch -> first token,
        so the partition stays exact. The peer fetch is taken from
        ``prefill`` first, then from ``engine_wait``."""
        t0 = tl.admitted_at
        tt = tl.terminal_at if tl.terminal_at is not None else now
        tf = tl.first_token_at
        tlast = tl.last_token_at
        if tl.dispatch_at is not None:
            td = tl.dispatch_at
        elif tf is not None:
            # dispatched without a schedule note (direct runner submit):
            # the timeline opened at the submit, so admit->token is real
            # engine time, not queueing
            td = t0
        else:
            # NEVER dispatched (queue_timeout / no_workers): the whole
            # window is queue_wait — calling it prefill would invert the
            # "where did the latency go" answer for exactly the requests
            # that starved in the queue
            td = tt
        queue_wait = max(0.0, td - t0)
        first = tf if tf is not None else tt
        span = max(0.0, first - td)
        fetch = min(tl.peer_fetch_s, span)
        ps = tl.prefill_start_at
        wait = 0.0 if ps is None else min(max(0.0, ps - td), span)
        prefill = span - wait
        taken = min(fetch, prefill)
        prefill -= taken
        wait -= fetch - taken
        if tf is not None and tlast is not None:
            stall = min(tl.handoff_stall_s, max(0.0, tlast - tf))
            decode = max(0.0, tlast - tf - stall)
            detok = max(0.0, tt - tlast)
        else:
            stall = decode = detok = 0.0
        return {
            "ingress": max(0.0, t0 - tl.received_at),
            "queue_wait": queue_wait,
            "engine_wait": max(0.0, wait),
            "prefill": max(0.0, prefill),
            "peer_fetch": fetch,
            "handoff_stall": stall,
            "decode": decode,
            "detok": detok,
        }

    # -- introspection (any thread) ----------------------------------------

    def timeline(self, request_id) -> Optional[Dict[str, Any]]:
        """The ``GET /server/requests/<id>`` JSON: the event timeline,
        derived phases (provisional while live), TTFT/TBT breakdown,
        and any overlapping fleet-level events."""
        now = self.clock()
        with self._lock:
            tl = self._timelines.get(request_id)
            if tl is None:
                # ids arrive as strings over HTTP; timelines may be
                # keyed by RequestId objects
                for key, cand in self._timelines.items():
                    if str(key) == str(request_id):
                        tl = cand
                        break
                if tl is None:
                    return None
            t0 = tl.admitted_at
            tt = tl.terminal_at if tl.terminal_at is not None else now
            phases = self._phases_locked(tl, now)
            events = [
                {"t_ms": round((t - t0) * 1000.0, 3), "name": n,
                 **({"attributes": a} if a else {})}
                for t, n, a in tl.events
            ]
            fleet_events = [
                {"t_ms": round((t - t0) * 1000.0, 3), "name": n,
                 **({"attributes": a} if a else {})}
                for t, n, a in self._global if t0 <= t <= tt
            ]
            ttft = (tl.first_token_at - t0
                    if tl.first_token_at is not None else None)
            tbt = None
            if (tl.tokens > 1 and tl.first_token_at is not None
                    and tl.last_token_at is not None):
                tbt = ((tl.last_token_at - tl.first_token_at)
                       / (tl.tokens - 1))
            out = {
                "request_id": str(tl.request_id),
                "status": tl.status,
                "tokens": tl.tokens,
                "wall_s": round(tt - tl.received_at, 6),
                "phases": {k: round(v, 6) for k, v in phases.items()},
                "events": events,
                "events_dropped": tl.events_dropped,
                "attributes": dict(tl.attrs),
            }
            if tl.code:
                out["code"] = tl.code
            if tl.trace_id:
                out["trace_id"] = tl.trace_id
            if tl.slo is not None:
                out["slo"] = dict(tl.slo)
            if ttft is not None:
                out["ttft_s"] = round(ttft, 6)
            if tbt is not None:
                out["tbt_avg_s"] = round(tbt, 6)
            if fleet_events:
                out["fleet_events"] = fleet_events
            return out

    def recent(self, n: int = 50,
               verdict: Optional[str] = None) -> List[Dict[str, Any]]:
        """Newest-first summaries for ``GET /server/requests``.
        ``verdict`` ("ok" | "violated") keeps only timelines whose SLO
        verdict matches — the operator's "show me what burned the SLO"
        query (docs/OBSERVABILITY.md)."""
        with self._lock:
            items = list(self._timelines.values())
            if verdict is not None:
                items = [tl for tl in items
                         if tl.slo is not None
                         and tl.slo.get("verdict") == verdict]
            items = items[-n:]
        return [
            {"request_id": str(tl.request_id), "status": tl.status,
             "tokens": tl.tokens,
             **({"trace_id": tl.trace_id} if tl.trace_id else {}),
             **({"verdict": tl.slo["verdict"]}
                if tl.slo is not None else {})}
            for tl in reversed(items)
        ]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            live = sum(1 for tl in self._timelines.values()
                       if tl.terminal_at is None)
            dropped = sum(tl.events_dropped
                          for tl in self._timelines.values())
            return {
                "tracked": len(self._timelines),
                "live": live,
                "evicted": self._evicted,
                "events_dropped": dropped,
            }
