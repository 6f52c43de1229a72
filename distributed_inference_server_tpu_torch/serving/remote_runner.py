"""The fleet's two ends of a remote engine: the registry host's proxy and
the member's executor (the port of ``distributed_inference_server_tpu/
serving/remote_runner.py``, without the KV data plane's sequence moves and
the KV mesh's fetch hints).

``RemoteRunner`` has the ``EngineRunner`` surface the serving spine routes
on (submit, abort, status, active_count, audit, shutdown) and forwards it
over the ``FleetSubmit`` / ``FleetEvent`` pair of the fleet wire
(``serving/fleet.py``): one FleetSubmit frame per request on the member's
session, and the session's reader pumps FleetEvent frames back into the
request's sink. The scheduler cannot tell it from a local runner.

A member's death maps onto the crash-safe redispatch path: the proxy pops
each in-flight request first (exactly once by construction); zero-token
requests go to ``Dispatcher.redispatch``, mid-stream ones fail as
``engine_crashed``. A remote ``worker_failure`` for a zero-token request
is treated the same way: the member could not save it, this fleet still
can.

``FleetWorker`` is the member's end: it dials the registry host,
heartbeats its replicas' statuses (digests included), serves incoming
FleetSubmit frames on its local runners through a sink that writes
FleetEvent frames back, ships its finished spans and its telemetry after
each beat, and reconnects with backoff when the registry host bounces.
The ``fleet.submit`` fault fires on both ends: on the proxy the forwarded
submit dies on the wire, on the worker the member crashes on receipt.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

from distributed_inference_server_tpu_torch.core.models import (
    FinishReason,
    Usage,
)
from distributed_inference_server_tpu_torch.engine.engine import (
    SamplingParams,
)
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving.fleet import (
    MEMBER_ALIVE,
    MEMBER_DEAD,
    FleetSettings,
    close_socket,
    parse_connect,
    recv_frame,
    send_frame,
    span_to_wire,
    status_to_wire,
)
from distributed_inference_server_tpu_torch.serving.metrics import (
    EngineStatus,
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    ServerRequest,
)

logger = logging.getLogger(__name__)


class RemoteRunner:
    """The registry host's proxy for one engine of a fleet member.

    ``submit`` / ``abort`` arrive from the dispatcher and redispatch
    paths, ``on_event`` from the member session's reader, ``detach`` from
    the reader or the sweeper. Every terminal path pops the request from
    the in-flight map before resolving it, under ``_events_lock``."""

    #: a proxy is never restarted by the health loop (the member restarts
    #: its engine), never model-swapped and never a scale_to victim
    is_remote = True
    supports_restart = False

    def __init__(self, engine_id: str, local_engine_id: str,
                 send: Callable[[str, Dict[str, Any]], None],
                 metrics: Optional[MetricsCollector] = None,
                 recorder=None):
        """``engine_id``: the proxy's fleet id, ``<member>:<engine>``;
        ``local_engine_id``: the member's own name for the engine (what
        the frames carry); ``send(name, obj)`` writes one frame on the
        member's session and raises when the transport is gone.
        ``recorder``: the host's ``FlightRecorder``, which notes a remote
        request's tokens and end here."""
        self.engine_id = engine_id
        self.local_engine_id = local_engine_id
        self.metrics = metrics
        self.recorder = recorder
        self._send = send
        self.redispatch: Optional[Callable] = None  # the dispatcher's
        self._inflight: Dict[Any, ServerRequest] = {}
        # orders event delivery against failure: a partitioned member can
        # stream a late token while the sweeper redispatches the request
        self._events_lock = threading.Lock()
        self._status: Optional[EngineStatus] = None
        self._member_state = MEMBER_ALIVE
        self._detached = False
        self._last_error: Optional[str] = None
        # consecutive send failures on the control wire (reset on
        # success): the health scorer's eject evidence
        self.consecutive_wire_failures = 0

    @property
    def role(self) -> str:
        s = self._status
        return s.role if s is not None else "unified"

    @property
    def supports_kv_import(self) -> bool:
        """Whether the member can take a handoff or source a fetch: never
        without a KV data channel, which the port does not have yet."""
        return False

    # -- registry-side state (session reader / sweeper threads) ------------

    def update_status(self, status: EngineStatus) -> None:
        self._status = status

    def set_member_state(self, state: str) -> None:
        self._member_state = state

    def mark_detached(self, message: str) -> None:
        """Phase 1 of a member's death: leave the routing set without
        failing anything yet (the session marks every sibling first)."""
        self._detached = True
        self._member_state = MEMBER_DEAD
        self._last_error = message

    def fail_inflight(self, message: str) -> None:
        """Phase 2: fail every in-flight request onto the redispatch
        path, once each; a detached proxy fails later submits at once."""
        self._fail_all_of(list(self._inflight.values()), message)

    def detach(self, message: str) -> None:
        """Both phases, for a lone proxy."""
        self.mark_detached(message)
        self.fail_inflight(message)

    # -- the EngineRunner surface ------------------------------------------

    def is_healthy(self) -> bool:
        s = self._status
        return (not self._detached and self._member_state == MEMBER_ALIVE
                and s is not None and s.healthy)

    def status(self) -> EngineStatus:
        """The last heartbeat's status with this host's view on top: the
        liveness, and at least the requests this proxy has in flight (the
        beat is up to one interval old)."""
        s = self._status
        if s is None:
            return EngineStatus(
                engine_id=self.engine_id, healthy=False, active_requests=0,
                waiting_requests=0, total_processed=0, remote=True)
        return dataclasses.replace(
            s, healthy=self.is_healthy(),
            active_requests=max(s.active_requests, len(self._inflight)))

    def observe(self) -> EngineStatus:
        return self.status()

    def active_count(self) -> int:
        return len(self._inflight)

    def last_error(self) -> Optional[str]:
        return self._last_error

    def audit(self, timeout_s: float = 0.0) -> List[str]:
        """The member audits its own pools; the proxy has none."""
        return []

    def evict_cache(self, target_frac: float,
                    drop_host_tier: bool = False) -> None:
        """The member's own degradation ladder manages its memory."""

    def tokenizer(self):
        return None

    def shutdown(self, timeout: float = 0.0) -> None:
        self.detach("fleet detach: registry host shutting down")

    def submit(self, requests: Sequence[ServerRequest]) -> None:
        reqs = list(requests)
        with self._events_lock:
            for r in reqs:
                self._inflight[r.request_id] = r
        if not self.is_healthy():
            self._fail_all_of(
                reqs, self._last_error or "fleet member unavailable")
            return
        try:
            for r in reqs:
                # the forwarded submit dies on the wire
                faults.fire("fleet.submit")
                # a send on the control wire times out (health evidence)
                faults.fire("fleet.wire_timeout")
                frame = {
                    "request_id": str(r.request_id),
                    "engine_id": self.local_engine_id,
                    "prompt_ids": [int(t) for t in r.prompt_ids],
                    "max_tokens": r.params.max_tokens,
                    "temperature": r.params.temperature,
                    "top_p": r.params.top_p,
                    "stop_sequences": list(r.params.stop_sequences),
                    "tenant": getattr(r, "tenant", "") or "",
                }
                span = getattr(r, "span", None)
                if span is not None:
                    # the trace context rides the wire: the member parents
                    # its fleet.serve span on it and ships it back
                    frame["trace_id"], frame["parent_span_id"] = \
                        span.context()
                self._send("FleetSubmit", frame)
            self.consecutive_wire_failures = 0
        except Exception as e:  # noqa: BLE001 — the transport's fault domain
            self._last_error = f"fleet submit failed: {e}"
            self.consecutive_wire_failures += 1
            # fail only this batch; requests already sent are popped
            # first, so the member's later events for them are orphans
            self._fail_all_of(reqs, self._last_error)

    def abort(self, request_id) -> None:
        with self._events_lock:
            self._inflight.pop(request_id, None)
        try:
            self._send("FleetSubmit", {"request_id": str(request_id),
                                       "engine_id": self.local_engine_id,
                                       "abort": True})
        except Exception as e:  # noqa: BLE001 — the member is dying and
            # its requests with it
            self._absorbed("abort_send", e)

    # -- the event pump (member session reader thread) ---------------------

    def on_event(self, ev: Dict[str, Any]) -> None:
        rid = ev.get("request_id", "")
        kind = ev.get("kind")
        if kind == "error":
            # pop under the lock, resolve outside it: the resolution may
            # redispatch onto another runner
            with self._events_lock:
                req = (None if self._detached
                       else self._inflight.pop(rid, None))
            if req is not None:
                self._resolve_error(req, ev.get("message", "remote error"),
                                    ev.get("code") or "inference_failed")
            return
        with self._events_lock:
            req = self._inflight.get(rid)
            if req is None or self._detached:
                return  # aborted, redispatched or dead: an orphan event
            try:
                if kind == "token":
                    if req.first_token_at is None:
                        req.first_token_at = time.monotonic()
                        if self.metrics:
                            # not into the host's ttft_ms digest: the
                            # member's own telemetry carries it
                            self.metrics.record_ttft(
                                req.first_token_at - req.submitted_at,
                                local=False)
                    if ev.get("token_id") is not None:
                        if self.metrics:
                            self.metrics.record_tokens(1)
                        if self.recorder is not None:
                            self.recorder.token(rid)
                    req.sink.on_token(ev.get("token_id"), ev.get("text", ""),
                                      ev.get("token_index", 0),
                                      ev.get("logprob"))
                    # a streaming sink hands its tokens on at a flush (a
                    # local runner flushes once an engine step): each
                    # event is a step's token here
                    flush = getattr(req.sink, "flush", None)
                    if flush is not None:
                        flush()
                elif kind == "done":
                    if self._inflight.pop(rid, None) is None:
                        return
                    usage = Usage.of(ev.get("prompt_tokens", 0),
                                     ev.get("completion_tokens", 0))
                    try:
                        reason = FinishReason(
                            ev.get("finish_reason") or "stop")
                    except ValueError:
                        reason = FinishReason.STOP
                    if self.recorder is not None:
                        self.recorder.finish(rid, "ok")
                    req.sink.on_done(reason, usage)
            except Exception as e:  # noqa: BLE001 — sink isolation
                self._inflight.pop(rid, None)
                self._absorbed("sink_error", e)

    def _resolve_error(self, req: ServerRequest, message: str,
                       code: str) -> None:
        """A remote terminal error. A zero-token ``worker_failure`` takes
        the redispatch path before the client sees it."""
        if (req.first_token_at is None and code == "worker_failure"
                and self.redispatch is not None):
            try:
                if self.redispatch(req, self.engine_id, message):
                    return  # the new owner resolves the sink
            except Exception as e:  # noqa: BLE001 — hook isolation
                self._absorbed("redispatch", e)
        if self.recorder is not None:
            self.recorder.finish(req.request_id, "error", code=code)
        try:
            req.sink.on_error(message, code)
        except Exception as e:  # noqa: BLE001
            self._absorbed("sink_error", e)

    def _fail_all_of(self, reqs: Sequence[ServerRequest],
                     message: str) -> None:
        # ownership moves under the events lock: after the pop no late
        # event reaches the sink, so first_token_at is the truth the
        # redispatch decision needs. Resolution runs outside the lock.
        owned = []
        with self._events_lock:
            for req in reqs:
                if self._inflight.pop(req.request_id, None) is None:
                    continue  # another terminal path owns it
                owned.append((req, req.first_token_at is None))
        for req, zero_tokens in owned:
            if zero_tokens and self.redispatch is not None:
                try:
                    if self.redispatch(req, self.engine_id, message):
                        continue  # the new owner resolves the sink
                except Exception as e:  # noqa: BLE001 — hook isolation
                    self._absorbed("redispatch", e)
            code = "worker_failure" if zero_tokens else "engine_crashed"
            if self.recorder is not None:
                self.recorder.finish(req.request_id, "error", code=code)
            try:
                req.sink.on_error(message, code)
            except Exception as e:  # noqa: BLE001
                self._absorbed("sink_error", e)

    def _absorbed(self, site: str, exc: BaseException) -> None:
        logger.debug("%s: absorbed error at %s: %s: %s", self.engine_id,
                     site, type(exc).__name__, exc)
        if self.metrics:
            self.metrics.record_error(f"remote_runner.{site}")


# ---------------------------------------------------------------------------
# The member's end
# ---------------------------------------------------------------------------


class _RemoteSink:
    """A result sink writing FleetEvent frames back to the registry host,
    on the member's runner threads. Send failures are absorbed: with the
    connection gone the host has already failed the request over. It owns
    the member-side ``fleet.serve`` span and finishes it (a finished span
    is what ships back)."""

    def __init__(self, worker: "FleetWorker", request_id: str,
                 engine_id: str, span=None):
        self._worker = worker
        self._rid = request_id
        self._eid = engine_id
        self._span = span

    def _finish_span(self, status: str) -> None:
        span, self._span = self._span, None
        if span is not None and self._worker.tracer is not None:
            self._worker.tracer.finish(span, status=status)

    def _event(self, obj: Dict[str, Any]) -> None:
        obj["request_id"] = self._rid
        obj["engine_id"] = self._eid
        self._worker.send_event(obj)

    def on_token(self, token_id, text, token_index, logprob=None) -> None:
        ev = {"kind": "token", "text": text or "",
              "token_index": token_index or 0}
        if token_id is not None:
            ev["token_id"] = int(token_id)
        if logprob is not None:
            ev["logprob"] = float(logprob)
        self._event(ev)

    def on_done(self, finish_reason, usage) -> None:
        self._finish_span("ok")
        self._event({
            "kind": "done",
            "finish_reason": getattr(finish_reason, "value",
                                     str(finish_reason)),
            "prompt_tokens": getattr(usage, "prompt_tokens", 0),
            "completion_tokens": getattr(usage, "completion_tokens", 0),
        })

    def on_error(self, message, code) -> None:
        self._finish_span("error")
        self._event({"kind": "error", "message": message or "",
                     "code": code or "inference_failed"})


class FleetWorker:
    """Joins a fleet as a member: dials the registry host at
    ``settings.connect``, heartbeats the local replicas, and serves
    forwarded requests on them."""

    #: spans buffered between beats, and per FleetSpans frame: the trace
    #: channel must never grow into the data path
    SPAN_BUFFER = 512
    SPANS_PER_FRAME = 256

    def __init__(self, scheduler, settings: FleetSettings,
                 metrics: Optional[MetricsCollector] = None,
                 member_id: Optional[str] = None, tracer=None):
        """``scheduler``: the member's own ``AdaptiveScheduler`` (the local
        runners). ``tracer``: the member's ``Tracer``; a forwarded request
        gets a ``fleet.serve`` span parented on the wire's trace context,
        and every span this process finishes ships to the registry host
        after a beat."""
        self.scheduler = scheduler
        self.settings = settings
        self.metrics = metrics
        self.tracer = tracer
        self.member_id = (member_id or settings.member_id
                          or f"{socket.gethostname()}:{os.getpid()}")
        self._sock: Optional[socket.socket] = None
        # serializes frame writes: the beat loop and every local runner
        # thread's sink share the socket
        self._send_lock = threading.Lock()
        self._seq = 0
        self._span_buf: Deque = deque()
        self._span_lock = threading.Lock()
        self._span_dropped = 0
        self._stop = threading.Event()
        self._crashed = False  # the injected fleet.submit crash: stay down
        self._beat_thread: Optional[threading.Thread] = None
        self._reader: Optional[threading.Thread] = None
        self._epoch_offset_ns = time.time_ns() - time.monotonic_ns()
        if tracer is not None:
            tracer.exporters.append(self._buffer_span)

    # -- lifecycle ---------------------------------------------------------

    def start(self, connect_timeout_s: float = 10.0) -> None:
        """Dial the registry host and start the beat loop. A refused dial
        is retried with backoff until ``connect_timeout_s`` has passed (a
        host started beside its members listens only once its own engines
        are up); then, or on any other failure, the ``OSError`` is raised
        (``ConfigError`` for a bad endpoint)."""
        deadline = time.monotonic() + connect_timeout_s
        backoff = self.settings.heartbeat_interval_s
        while True:
            try:
                self._connect(max(0.1, deadline - time.monotonic()))
                break
            except ConnectionRefusedError:
                if time.monotonic() + backoff > deadline:
                    raise
                time.sleep(backoff)
                backoff = min(backoff * 2.0, 2.0)
        self._stop.clear()
        self._beat_thread = threading.Thread(
            target=self._beat_loop, name="fleet-worker-beat", daemon=True)
        self._beat_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._close()
        if self._beat_thread is not None:
            self._beat_thread.join(5.0)
            self._beat_thread = None
        # a restarted worker on the same tracer must not leave a dead
        # buffer behind
        if self.tracer is not None:
            try:
                self.tracer.exporters.remove(self._buffer_span)
            except ValueError:
                pass

    def is_connected(self) -> bool:
        return self._sock is not None

    def _connect(self, timeout_s: float) -> None:
        host, port = parse_connect(self.settings.connect)
        sock = socket.create_connection((host, port), timeout=timeout_s)
        try:
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            sock.close()
            raise
        with self._send_lock:
            self._sock = sock
        # a fresh reader per connection; the old one ended at its EOF
        self._reader = threading.Thread(
            target=self._read_loop, args=(sock,), name="fleet-worker-reader",
            daemon=True)
        self._reader.start()
        logger.info("fleet worker %s connected to %s:%d", self.member_id,
                    host, port)

    def _close(self) -> None:
        with self._send_lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            close_socket(sock)

    # -- sending (beat thread and local runner threads) ---------------------

    def _send(self, name: str, obj: Dict[str, Any]) -> None:
        with self._send_lock:
            if self._sock is None:
                raise OSError("fleet worker not connected")
            send_frame(self._sock, name, obj)

    def send_event(self, obj: Dict[str, Any]) -> None:
        try:
            self._send("FleetEvent", obj)
        except Exception as e:  # noqa: BLE001 — the host's death path
            # owns the request now
            logger.debug("fleet worker %s: event send failed: %s",
                         self.member_id, e)
            if self.metrics:
                self.metrics.record_error("fleet_worker.event_send")

    def _buffer_span(self, span) -> None:
        """Tracer exporter: queue a finished span for the next shipment
        (any thread, bounded, never blocks)."""
        overflowed = False
        with self._span_lock:
            if len(self._span_buf) >= self.SPAN_BUFFER:
                self._span_buf.popleft()
                self._span_dropped += 1
                overflowed = True
            self._span_buf.append(span)
        if overflowed and self.tracer is not None:
            self.tracer.record_drop("wire")

    def ship_spans_once(self) -> bool:
        """Send one FleetSpans frame with what is buffered (at most
        SPANS_PER_FRAME; the rest counts as dropped). False when the link
        is down; the spans then count as dropped, not retried."""
        if self.tracer is None:
            return True
        with self._span_lock:
            if not self._span_buf and not self._span_dropped:
                return True
            spans = list(self._span_buf)
            self._span_buf.clear()
            dropped, self._span_dropped = self._span_dropped, 0
        shipped = spans[:self.SPANS_PER_FRAME]
        dropped += len(spans) - len(shipped)
        try:
            self._send("FleetSpans", {
                "member_id": self.member_id,
                "spans": [span_to_wire(s, self._epoch_offset_ns)
                          for s in shipped],
                "dropped": dropped,
            })
            return True
        except Exception as e:  # noqa: BLE001 — the link's fault domain
            logger.debug("fleet worker %s: span ship failed: %s",
                         self.member_id, e)
            with self._span_lock:
                self._span_dropped += len(shipped) + dropped
            if self.tracer is not None:
                self.tracer.record_drop("wire", len(shipped))
            return False

    def ship_telemetry_once(self) -> bool:
        """Send one FleetTelemetry frame: the digests' current windows and
        the cumulative step-clock counters. Stateless: the next frame
        carries whatever a lost one did. False when the link is down."""
        if self.metrics is None:
            return True
        body = self.metrics.perf_wire()
        if not body["digests"] and not body["counters"]:
            return True
        try:
            self._send("FleetTelemetry", {"member_id": self.member_id,
                                          **body})
            self.metrics.record_telemetry_frame("sent")
            return True
        except Exception as e:  # noqa: BLE001 — the link's fault domain
            logger.debug("fleet worker %s: telemetry ship failed: %s",
                         self.member_id, e)
            self.metrics.record_telemetry_frame("failed")
            return False

    def heartbeat_once(self) -> bool:
        """Send one heartbeat; False when the link is down."""
        self._seq += 1
        try:
            self._send("FleetHeartbeat", {
                "member_id": self.member_id,
                "seq": self._seq,
                "engines": [status_to_wire(s)
                            for s in self.scheduler.statuses()],
                # no KV data listener: a control-plane-only member
                "data_port": 0,
            })
            return True
        except Exception as e:  # noqa: BLE001 — the link's fault domain
            logger.debug("fleet worker %s: heartbeat failed: %s",
                         self.member_id, e)
            return False

    def _beat_loop(self) -> None:
        backoff = self.settings.heartbeat_interval_s
        while not self._stop.wait(self.settings.heartbeat_interval_s):
            if self._crashed:
                return  # the injected crash: the process is "dead"
            if (self._sock is None or not self.heartbeat_once()
                    or not self.ship_spans_once()
                    or not self.ship_telemetry_once()):
                self._close()
                if self._stop.is_set() or self._crashed:
                    return
                try:
                    self._connect(timeout_s=5.0)
                    backoff = self.settings.heartbeat_interval_s
                except OSError as e:
                    logger.debug("fleet worker %s: reconnect failed: %s",
                                 self.member_id, e)
                    backoff = min(backoff * 2.0, 5.0)
                    if self._stop.wait(backoff):
                        return

    # -- serving (reader thread) -------------------------------------------

    def _read_loop(self, sock: socket.socket) -> None:
        """What the registry host sends: FleetSubmit frames (requests and
        aborts). The member-to-host kinds never come back on this wire."""
        try:
            while True:
                frame = recv_frame(sock)
                if frame is None:
                    return
                name, obj = frame
                if name == "FleetSubmit":
                    self._serve_submit(obj)
        except OSError:
            return  # the connection died; the beat loop reconnects
        except faults.InjectedFault:
            # fleet.submit armed on the member: it "crashes" on receipt,
            # drops the connection, serves nothing and stays down (the
            # host redispatches its zero-token requests)
            logger.warning("fleet worker %s: injected crash on submit",
                           self.member_id)
            self._crashed = True
            self._close()
        except Exception:  # noqa: BLE001 — the reader must not die quietly
            logger.exception("fleet worker %s reader failed", self.member_id)
            self._close()

    def _serve_submit(self, obj: Dict[str, Any]) -> None:
        rid = obj.get("request_id", "")
        engine_id = obj.get("engine_id", "")
        runner = self.scheduler.get(engine_id)
        if obj.get("abort"):
            if runner is not None:
                runner.abort(rid)
            return
        # the member crashing on receipt: raises through to the reader
        faults.fire("fleet.submit")
        span = None
        if self.tracer is not None and obj.get("trace_id"):
            # parented on the wire's trace context: this span and the
            # runner's engine.infer child ship back into the host's tree
            span = self.tracer.start(
                "fleet.serve",
                parent=(obj["trace_id"], obj.get("parent_span_id") or None),
                request_id=rid, engine_id=engine_id,
                member_id=self.member_id)
        sink = _RemoteSink(self, rid, engine_id, span=span)
        if runner is None or not runner.is_healthy():
            sink.on_error(f"remote engine {engine_id!r} unavailable",
                          "worker_failure")
            return
        req = ServerRequest(
            rid, [int(t) for t in obj.get("prompt_ids", [])],
            SamplingParams(
                max_tokens=obj.get("max_tokens", 0) or 16,
                temperature=obj.get("temperature", 0.0),
                top_p=obj.get("top_p", 1.0) or 1.0,
                stop_sequences=tuple(obj.get("stop_sequences", [])),
            ),
            sink, tenant=obj.get("tenant") or "default", span=span)
        # the gray-failure lever (delay-style): the member serves slowly
        # while it heartbeats healthily; the reader stalls, so everything
        # behind the slow request is slow too
        faults.fire("fleet.slow_member")
        runner.submit([req])
