"""Request-lifecycle tracing: OpenTelemetry-style spans on the standard
library (the port's copy of ``distributed_inference_server_tpu/utils/
tracing.py``).

A ``Span`` has trace / span / parent ids, monotonic start and end,
attributes and structured events. ``Tracer`` makes spans and keeps the
finished ones in a bounded ring (``/server/trace``); ``exporters`` are
extra sinks (the OTLP exporter, ``utils/otlp.py``). Context crosses
threads explicitly: the serving spine hands ``span.context()`` from the
HTTP thread to the dispatcher and the runner, because a request changes
threads.

No span is dropped silently: ring overflow and exporter failures count in
``dropped()`` and, once the server wires ``on_drop``, in
``trace_spans_dropped_total{reason=ring|exporter|wire}``.
"""

from __future__ import annotations

import contextlib
import logging
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (
    Callable,
    Deque,
    Dict,
    Iterator,
    List,
    Optional,
    Tuple,
)

log = logging.getLogger(__name__)

#: legal drop reasons (the metric's label set is closed on purpose —
#: a free-form reason string would grow the series set unboundedly)
DROP_REASONS = ("ring", "exporter", "wire")


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_ns: int
    end_ns: int = 0
    attributes: Dict[str, object] = field(default_factory=dict)
    #: (monotonic_ns, name, attrs) — attrs is {} for bare events, so the
    #: flight recorder and OTLP bridge can rely on the 3-tuple shape
    events: List[Tuple[int, str, Dict[str, object]]] = field(
        default_factory=list)
    status: str = "ok"

    @property
    def duration_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6 if self.end_ns else 0.0

    def set(self, **attrs) -> "Span":
        self.attributes.update(attrs)
        return self

    def event(self, name: str, at_ns: Optional[int] = None,
              **attrs) -> None:
        """Record a structured span event; ``attrs`` ride with the event
        (``span.event("redispatched", reason=...)``). ``at_ns``: the
        event's monotonic time when it happened earlier than now."""
        # a span is owned by one thread at a time — its context() hands
        # off with the request (module docstring); list.append is
        # GIL-atomic for the rare overlap
        self.events.append((time.monotonic_ns() if at_ns is None else at_ns,
                            name, attrs))

    def context(self) -> Tuple[str, str]:
        """(trace_id, span_id) to parent a child span on another thread."""
        return (self.trace_id, self.span_id)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ns": self.start_ns,
            "duration_ms": self.duration_ms,
            "attributes": self.attributes,
            "events": [
                {"offset_ms": (t - self.start_ns) / 1e6, "name": n,
                 **({"attributes": a} if a else {})}
                for t, n, a in self.events
            ],
            "status": self.status,
        }


class Tracer:
    """Span factory + bounded ring of finished spans."""

    def __init__(self, capacity: int = 2048, log_spans: bool = False):
        self._ring: Deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.exporters: List[Callable[[Span], None]] = [self._to_ring]
        if log_spans:
            self.exporters.append(self._to_log)
        # drop accounting (never silent, module docstring): reason ->
        # count, guarded by _lock; ``on_drop(reason, n)`` additionally
        # forwards to the metrics collector when the server wires it
        self._dropped: Dict[str, int] = {r: 0 for r in DROP_REASONS}
        self.on_drop: Optional[Callable[[str, int], None]] = None

    # -- span lifecycle ----------------------------------------------------

    def start(
        self,
        name: str,
        parent: Optional[Tuple[str, str]] = None,
        **attributes,
    ) -> Span:
        """Start a span; ``parent`` is a ``Span.context()`` tuple (or None
        to begin a new trace)."""
        trace_id = parent[0] if parent else secrets.token_hex(8)
        return Span(
            name=name,
            trace_id=trace_id,
            span_id=secrets.token_hex(8),
            parent_id=parent[1] if parent else None,
            start_ns=time.monotonic_ns(),
            attributes=dict(attributes),
        )

    def finish(self, span: Span, status: str = "ok") -> None:
        # finish is called exactly once by the span's current owner
        # (handler pops it from _spans_by_request first)
        span.end_ns = time.monotonic_ns()
        span.status = status
        self._export(span)

    def ingest(self, span: Span) -> None:
        """Merge an already-FINISHED span into this tracer's sinks — the
        registry host's entry point for remote members' spans arriving
        over ``FleetSpans`` frames (serving/fleet.py). The span keeps its
        own trace/span/parent ids, so the merged ring (and the OTLP
        exporter) renders one correctly-parented cross-process tree."""
        self._export(span)

    def _export(self, span: Span) -> None:
        for export in self.exporters:
            try:
                export(span)
            except Exception:  # noqa: BLE001 — tracing must never break serving
                log.debug("span exporter %r failed", export, exc_info=True)
                self.record_drop("exporter")

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        parent: Optional[Tuple[str, str]] = None,
        **attributes,
    ) -> Iterator[Span]:
        s = self.start(name, parent=parent, **attributes)
        try:
            yield s
        except BaseException:
            self.finish(s, status="error")
            raise
        self.finish(s)

    # -- drop accounting ---------------------------------------------------

    def record_drop(self, reason: str, n: int = 1) -> None:
        """Count ``n`` spans lost for ``reason`` ("ring" = evicted from
        the bounded ring unread, "exporter" = an exporter raised, "wire"
        = the fleet span buffer overflowed before shipping)."""
        if reason not in self._dropped:
            reason = "exporter"
        with self._lock:
            self._dropped[reason] += n
        hook = self.on_drop
        if hook is not None:
            try:
                hook(reason, n)
            except Exception:  # noqa: BLE001 — accounting must not raise
                log.debug("trace drop hook failed", exc_info=True)

    def dropped(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._dropped)

    # -- sinks -------------------------------------------------------------

    def _to_ring(self, span: Span) -> None:
        overflowed = False
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                overflowed = True  # the deque evicts the oldest span
            self._ring.append(span)
        if overflowed:
            self.record_drop("ring")

    @staticmethod
    def _to_log(span: Span) -> None:
        log.info(
            "span %s trace=%s %.2fms %s",
            span.name, span.trace_id, span.duration_ms, span.attributes,
        )

    # -- introspection -----------------------------------------------------

    def recent(self, n: int = 100,
               trace_id: Optional[str] = None,
               request_id: Optional[str] = None) -> List[Span]:
        """The last ``n`` finished spans, optionally filtered by trace id
        or by the ``request_id`` span attribute, sorted by start time —
        ingested remote spans arrive late (heartbeat cadence), so ring
        order is not start order for a stitched trace."""
        with self._lock:
            spans = list(self._ring)
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        if request_id is not None:
            spans = [s for s in spans
                     if str(s.attributes.get("request_id")) == request_id]
        spans.sort(key=lambda s: s.start_ns)
        return spans[-n:]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
