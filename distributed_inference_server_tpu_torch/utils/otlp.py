"""OTLP/HTTP trace exporter: the OpenTelemetry wire format on the
standard library (the port's copy of
``distributed_inference_server_tpu/utils/otlp.py``).

Finished spans (``utils/tracing.py``) are encoded as OTLP JSON
(``ExportTraceServiceRequest``) and POSTed with ``urllib`` to a
collector's ``/v1/traces`` from a background thread: batched, bounded and
fail-open (a dead collector drops spans and counts them; serving never
waits on telemetry). ``exporter.attach(tracer)`` adds it to a tracer; the
server does so when ``tracing.otlp_endpoint`` is set.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import deque
from typing import Deque, Dict, List, Optional

from distributed_inference_server_tpu_torch.utils.tracing import Span, Tracer


def _attr_value(v: object) -> Dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _attrs(d: Dict[str, object]) -> List[Dict]:
    return [{"key": k, "value": _attr_value(v)} for k, v in d.items()]


class OTLPExporter:
    """Batched OTLP/HTTP JSON trace exporter."""

    def __init__(
        self,
        endpoint: str,
        service_name: str = "distributed-inference-server-tpu",
        headers: Optional[Dict[str, str]] = None,
        batch_size: int = 128,
        flush_interval_s: float = 2.0,
        queue_capacity: int = 4096,
        timeout_s: float = 5.0,
    ):
        self.endpoint = endpoint
        self.service_name = service_name
        self.headers = dict(headers or {})
        self.batch_size = batch_size
        self.flush_interval_s = flush_interval_s
        self.timeout_s = timeout_s
        self._queue: Deque[Span] = deque(maxlen=queue_capacity)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # monotonic -> epoch conversion (span timestamps are monotonic)
        self._epoch_offset_ns = time.time_ns() - time.monotonic_ns()
        self.exported = 0
        self.dropped = 0
        # the tracer this exporter is attached to (drop accounting:
        # queue overflow and failed flushes count as "exporter" drops in
        # trace_spans_dropped_total instead of vanishing here)
        self._tracer: Optional[Tracer] = None

    # -- lifecycle ----------------------------------------------------------

    def attach(self, tracer: Tracer) -> "OTLPExporter":
        tracer.exporters.append(self.export)
        self._tracer = tracer
        self.start()
        return self

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="otlp-exporter", daemon=True
            )
            self._thread.start()

    def shutdown(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
        self._flush()  # final drain on the caller's thread

    # -- tracer sink --------------------------------------------------------

    def export(self, span: Span) -> None:
        overflowed = False
        with self._lock:
            if len(self._queue) == self._queue.maxlen:
                self.dropped += 1
                overflowed = True
            self._queue.append(span)
            n = len(self._queue)
        if overflowed and self._tracer is not None:
            self._tracer.record_drop("exporter")
        if n >= self.batch_size:
            self._wake.set()

    # -- background flush ---------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            self._flush()

    def _flush(self) -> None:
        with self._lock:
            if not self._queue:
                return
            spans = list(self._queue)
            self._queue.clear()
        try:
            body = json.dumps(self._encode(spans)).encode()
            req = urllib.request.Request(
                self.endpoint,
                data=body,
                headers={"Content-Type": "application/json", **self.headers},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
            with self._lock:
                self.exported += len(spans)
        except Exception:  # noqa: BLE001 — telemetry is fail-open
            # under the lock: the counter is read/written from the flush
            # thread and recorders concurrently
            with self._lock:
                self.dropped += len(spans)
            if self._tracer is not None:
                self._tracer.record_drop("exporter", len(spans))

    # -- OTLP encoding ------------------------------------------------------

    def _encode(self, spans: List[Span]) -> Dict:
        off = self._epoch_offset_ns
        out = []
        for s in spans:
            out.append({
                # OTLP ids: 16-byte trace, 8-byte span (hex); the tracer
                # mints 8-byte trace ids — zero-pad to the wire width
                "traceId": s.trace_id.rjust(32, "0"),
                "spanId": s.span_id[:16],
                "parentSpanId": (s.parent_id or "")[:16],
                "name": s.name,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(s.start_ns + off),
                "endTimeUnixNano": str((s.end_ns or s.start_ns) + off),
                "attributes": _attrs(s.attributes),
                "events": [
                    {"timeUnixNano": str(t + off), "name": n,
                     **({"attributes": _attrs(a)} if a else {})}
                    for t, n, a in s.events
                ],
                "status": {"code": 1 if s.status == "ok" else 2},
            })
        return {
            "resourceSpans": [{
                "resource": {"attributes": _attrs(
                    {"service.name": self.service_name}
                )},
                "scopeSpans": [{
                    "scope": {"name": "distributed_inference_server_tpu"},
                    "spans": out,
                }],
            }]
        }
