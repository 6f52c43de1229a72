"""The fleet's two ends of a remote engine: the registry host's proxy and
the member's executor (the port of ``distributed_inference_server_tpu/
serving/remote_runner.py``).

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
can. With the member's KV data channel (``serving/fleet_kv.py``) the
proxy is also a handoff target and a fetch source: the import and export
calls the disagg controller and the prefix fetcher make go over that
channel.

``FleetWorker`` is the member's end: it dials every registry (one link
each: ``fleet.connect`` and ``fleet.registries``), heartbeats its
replicas' statuses (digests included) and its data listener's port to
all of them, serves incoming FleetSubmit frames on its local runners
through a sink that writes FleetEvent frames back on the link the submit
came in on, ships its finished spans and its telemetry after each beat,
and redials each link with backoff. Control frames from an epoch older
than the highest it has seen are fenced (registry HA). With the mesh on,
``KvIntro`` frames give it direct channels to other members, over which
it honours a submit's fetch hint. The ``fleet.submit`` fault fires on
both ends: on the proxy the forwarded submit dies on the wire, on the
worker the member crashes on receipt.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
import threading
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

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
        # the registry's control epoch (registry HA), stamped on every
        # submit and abort; None or 0 leaves the field off the wire
        self.epoch_fn: Optional[Callable[[], int]] = None
        # the member's data channel, set by the FleetServer when the
        # member advertises a data_port; None: no handoff target and no
        # fetch source
        self.kv_channel = None
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
        """Whether the member can take a handoff or source a fetch: it has
        a data channel whose circuit breaker is not open (an open breaker
        takes the member out of election)."""
        ch = self.kv_channel
        return ch is not None and ch.wire_available()

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
        liveness, at least the requests this proxy has in flight (the beat
        is up to one interval old), and ``data_plane`` (a usable data
        channel: ``plan_route`` fetches only from such members)."""
        s = self._status
        if s is None:
            return EngineStatus(
                engine_id=self.engine_id, healthy=False, active_requests=0,
                waiting_requests=0, total_processed=0, remote=True)
        return dataclasses.replace(
            s, healthy=self.is_healthy(),
            active_requests=max(s.active_requests, len(self._inflight)),
            data_plane=self.supports_kv_import)

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

    def submit(self, requests: Sequence[ServerRequest],
               fetch_hint: Optional[Dict[str, Any]] = None) -> None:
        """``fetch_hint``: the mesh's fetch fields (``fetch_member``,
        ``fetch_source_engine``, ``fetch_hashes``, ``fetch_chunk_pages``,
        ``fetch_wire_quant``) added to each FleetSubmit; the member pulls
        the prefix from that peer before computing, or recomputes."""
        reqs = list(requests)
        with self._events_lock:
            for r in reqs:
                self._inflight[r.request_id] = r
        if not self.is_healthy():
            self._fail_all_of(
                reqs, self._last_error or "fleet member unavailable")
            return
        epoch = self.epoch_fn() if self.epoch_fn is not None else 0
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
                if epoch:
                    frame["epoch"] = epoch
                if fetch_hint:
                    frame.update(fetch_hint)
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
        if self.kv_channel is not None:
            self.kv_channel.release_request(request_id)
        frame = {"request_id": str(request_id),
                 "engine_id": self.local_engine_id, "abort": True}
        epoch = self.epoch_fn() if self.epoch_fn is not None else 0
        if epoch:
            frame["epoch"] = epoch
        try:
            self._send("FleetSubmit", frame)
        except Exception as e:  # noqa: BLE001 — the member is dying and
            # its requests with it
            self._absorbed("abort_send", e)

    # -- the KV data plane (serving/fleet_kv.py) ---------------------------
    #
    # The runner's import and export calls, over the member's data
    # channel, with the local runner's contracts: each callback fires once,
    # from the channel's reader thread, or here at once when the channel
    # is missing, full or dead (the caller's fallback then runs).

    def submit_prefix_export(self, request_id, hashes, chunk_pages: int,
                             wire_quant: str, on_done: Callable,
                             trace=None) -> None:
        """A fetch sourced here: the member's engine serializes its cached
        chain and streams it back as KvChunks."""
        ch = self.kv_channel
        if ch is None:
            on_done(None, "member has no kv data channel")
            return
        ch.fetch_prefix(request_id, self.local_engine_id, hashes,
                        chunk_pages, wire_quant, trace, on_done)

    def submit_import_open(self, request_id, prefix_pages: int, chunks,
                           on_done: Callable, wire_quant: str = "none",
                           trace=None) -> None:
        """Phase 1 of a streamed handoff here: the prefix chunks ship
        while the source keeps decoding; the member reserves pages and
        checks each chunk."""
        ch = self.kv_channel
        if ch is None:
            on_done(False, "member has no kv data channel")
            return
        ch.import_open(request_id, self.local_engine_id, prefix_pages,
                       wire_quant, chunks, trace, on_done)

    def submit_import_commit(self, exp, req: ServerRequest,
                             on_done: Callable) -> None:
        """Phase 2: the tail and the host state cross; on ok the member's
        engine owns the sequence and its events ride the data channel
        back into this proxy."""
        self._submit_sequence("import_commit", exp, req, on_done)

    def submit_resume(self, exp, req: ServerRequest,
                      on_done: Callable) -> None:
        """A monolithic migration here (the commit's ownership contract)."""
        self._submit_sequence("resume", exp, req, on_done)

    def _submit_sequence(self, op: str, exp, req: ServerRequest,
                         on_done: Callable) -> None:
        """The request enters ``_inflight`` first (so a channel death
        between the stream's ok and its first event still fails it once)
        and leaves it again on any failure; ``on_done`` fires once."""
        ch = self.kv_channel
        with self._events_lock:
            self._inflight[req.request_id] = req
        if ch is None or not self.is_healthy():
            with self._events_lock:
                self._inflight.pop(req.request_id, None)
            on_done(False, self._last_error
                    or "member has no kv data channel")
            return

        def _done(ok: bool, err, _req=req) -> None:
            if not ok:
                with self._events_lock:
                    self._inflight.pop(_req.request_id, None)
            on_done(ok, err)

        span = getattr(req, "span", None)
        trace = span.context() if span is not None else None
        if op == "import_commit":
            ch.import_commit(exp, self.local_engine_id, trace, _done)
        else:
            ch.resume(exp, self.local_engine_id, trace, _done)

    def submit_import_abort(self, request_id) -> None:
        ch = self.kv_channel
        if ch is not None:
            ch.import_abort(request_id, self.local_engine_id)

    def fail_requests(self, request_ids, message: str) -> None:
        """Fail these in-flight requests (the data channel died under
        their events), popped first like every terminal path."""
        with self._events_lock:
            reqs = [self._inflight[rid] for rid in request_ids
                    if rid in self._inflight]
        self._fail_all_of(reqs, message)

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
    is what ships back). ``link``: the registry wire the submit came in
    on, which its events go back on (None: the first link)."""

    def __init__(self, worker: "FleetWorker", request_id: str,
                 engine_id: str, span=None, link=None):
        self._worker = worker
        self._rid = request_id
        self._eid = engine_id
        self._span = span
        self._link = link

    def _finish_span(self, status: str) -> None:
        span, self._span = self._span, None
        if span is not None and self._worker.tracer is not None:
            self._worker.tracer.finish(span, status=status)

    def _event(self, obj: Dict[str, Any]) -> None:
        obj["request_id"] = self._rid
        obj["engine_id"] = self._eid
        self._worker.send_event(obj, link=self._link)

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


class _RegistryLink:
    """A worker's connection to one registry: the socket and its send
    lock (the link loop and every runner thread's sink share it), the
    beat sequence, and a bounded span buffer of its own (each registry
    must see every span)."""

    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        self.sock: Optional[socket.socket] = None
        self.send_lock = threading.Lock()
        self.seq = 0
        self.span_buf: Deque = deque()
        self.span_lock = threading.Lock()
        self.span_dropped = 0
        self.thread: Optional[threading.Thread] = None


class FleetWorker:
    """Joins a fleet as a member: dials every registry endpoint
    (``settings.connect`` first, then ``settings.registries``), heartbeats
    the local replicas to each, and serves forwarded requests on them.
    Each link redials on its own, so every registry keeps a warm member
    table and a standby's takeover needs no rejoin."""

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
        and every span this process finishes ships to each registry
        after a beat."""
        self.scheduler = scheduler
        self.settings = settings
        self.metrics = metrics
        self.tracer = tracer
        self.member_id = (member_id or settings.member_id
                          or f"{socket.gethostname()}:{os.getpid()}")
        # the data listener (bound at start, advertised in every beat) and
        # the mesh's peer channels and their learned rates
        self.kv_server = None
        self.mesh_client = None
        self.mesh_rates = None
        endpoints: List[str] = []
        for ep in (settings.connect, *settings.registries):
            if ep and ep not in endpoints:
                endpoints.append(ep)
        # no endpoint: one empty link, so start() raises the ConfigError
        # of an unparsable endpoint
        self._links: List[_RegistryLink] = [
            _RegistryLink(ep) for ep in endpoints or [settings.connect]]
        self._stop = threading.Event()
        self._crashed = False  # the injected fleet.submit crash: stay down
        # the highest control epoch seen on any link (registry HA): older
        # submits and intros are fenced
        self._fleet_epoch = 0
        self._epoch_offset_ns = time.time_ns() - time.monotonic_ns()
        if tracer is not None:
            tracer.exporters.append(self._buffer_span)

    @property
    def endpoints(self) -> Tuple[str, ...]:
        """Every registry endpoint this worker heartbeats, first link
        first."""
        return tuple(link.endpoint for link in self._links)

    # -- lifecycle ---------------------------------------------------------

    def start(self, connect_timeout_s: float = 10.0) -> None:
        """Bind the data listener, dial every registry and start the link
        loops. While every dial is refused the dials are retried with
        backoff until ``connect_timeout_s`` has passed (a host started
        beside its members listens only once its own engines are up);
        then, or on any other failure of every link, the first
        ``OSError`` is raised (``ConfigError`` for a bad endpoint). A link
        that is down while another joined is redialed by its loop."""
        if self.settings.kv_enabled and self.kv_server is None:
            from distributed_inference_server_tpu_torch.serving.fleet_kv \
                import KvDataServer

            self.kv_server = KvDataServer(
                self.scheduler, port=self.settings.kv_data_port,
                metrics=self.metrics)
            self.kv_server.start()
        if (self.settings.kv_enabled and self.settings.mesh_enabled
                and self.mesh_client is None):
            from distributed_inference_server_tpu_torch.serving.fleet_mesh \
                import MeshClient, MeshWireRates

            self.mesh_rates = MeshWireRates(
                window_s=self.settings.kv_rate_window_s,
                prior_rate=self.settings.kv_rate_prior,
                perf=(self.metrics.perf_store()
                      if self.metrics is not None else None))
            self.mesh_client = MeshClient(
                self.member_id, self.mesh_rates, metrics=self.metrics,
                connect_timeout_s=self.settings.kv_connect_timeout_s)
        try:
            self._join(connect_timeout_s)
        except BaseException:
            self._stop_data_plane()
            raise
        self._stop.clear()
        for link in self._links:
            link.thread = threading.Thread(
                target=self._link_loop, args=(link,),
                name=f"fleet-worker-beat-{link.endpoint}", daemon=True)
            link.thread.start()

    def _join(self, connect_timeout_s: float) -> None:
        deadline = time.monotonic() + connect_timeout_s
        backoff = self.settings.heartbeat_interval_s
        while True:
            errors: List[OSError] = []
            for link in self._links:
                if link.sock is not None:
                    continue
                try:
                    self._connect_link(
                        link, max(0.1, deadline - time.monotonic()))
                except OSError as e:
                    errors.append(e)
                    logger.warning("fleet worker %s: dial of %s failed: %s",
                                   self.member_id, link.endpoint, e)
            if len(errors) < len(self._links):
                return  # at least one registry joined
            if (not all(isinstance(e, ConnectionRefusedError)
                        for e in errors)
                    or time.monotonic() + backoff > deadline):
                raise errors[0]
            time.sleep(backoff)
            backoff = min(backoff * 2.0, 2.0)

    def stop(self) -> None:
        self._stop.set()
        self._close_all()
        self._stop_data_plane()
        for link in self._links:
            if link.thread is not None:
                link.thread.join(5.0)
                link.thread = None
        # a restarted worker on the same tracer must not leave a dead
        # buffer behind
        if self.tracer is not None:
            try:
                self.tracer.exporters.remove(self._buffer_span)
            except ValueError:
                pass

    def _stop_data_plane(self) -> None:
        if self.kv_server is not None:
            self.kv_server.stop()
            self.kv_server = None
        if self.mesh_client is not None:
            self.mesh_client.close()
            self.mesh_client = None
            self.mesh_rates = None

    def is_connected(self) -> bool:
        return any(link.sock is not None for link in self._links)

    def _connect_link(self, link: _RegistryLink, timeout_s: float) -> None:
        host, port = parse_connect(link.endpoint)
        sock = socket.create_connection((host, port), timeout=timeout_s)
        try:
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            sock.close()  # a dialed socket that cannot be set up leaks
            raise
        with link.send_lock:
            link.sock = sock
        # a fresh reader per connection; the old one ended at its EOF
        threading.Thread(target=self._read_loop, args=(sock, link),
                         name=f"fleet-worker-reader-{link.endpoint}",
                         daemon=True).start()
        logger.info("fleet worker %s connected to %s:%d", self.member_id,
                    host, port)

    def _close(self) -> None:
        """Close the first link (the one a single-registry member has)."""
        self._close_link(self._links[0])

    def _close_all(self) -> None:
        for link in self._links:
            self._close_link(link)

    def _close_link(self, link: _RegistryLink) -> None:
        with link.send_lock:
            sock, link.sock = link.sock, None
        if sock is not None:
            close_socket(sock)

    # -- sending (link threads and local runner threads) --------------------

    def _send_link(self, link: Optional[_RegistryLink], name: str,
                   obj: Dict[str, Any]) -> None:
        link = self._links[0] if link is None else link
        with link.send_lock:
            if link.sock is None:
                raise OSError("fleet worker not connected")
            send_frame(link.sock, name, obj)

    def send_event(self, obj: Dict[str, Any], link=None) -> None:
        """``link``: the registry wire the request came in on."""
        try:
            self._send_link(link, "FleetEvent", obj)
        except Exception as e:  # noqa: BLE001 — the host's death path
            # owns the request now
            logger.debug("fleet worker %s: event send failed: %s",
                         self.member_id, e)
            if self.metrics:
                self.metrics.record_error("fleet_worker.event_send")

    def _buffer_span(self, span) -> None:
        """Tracer exporter: queue a finished span on every link for its
        next shipment (any thread, bounded, never blocks). The tracer's
        wire-drop count follows the first link."""
        for i, link in enumerate(self._links):
            overflowed = False
            with link.span_lock:
                if len(link.span_buf) >= self.SPAN_BUFFER:
                    link.span_buf.popleft()
                    link.span_dropped += 1
                    overflowed = True
                link.span_buf.append(span)
            if overflowed and i == 0 and self.tracer is not None:
                self.tracer.record_drop("wire")

    def ship_spans_once(self, link: Optional[_RegistryLink] = None) -> bool:
        """Send one FleetSpans frame with what ``link`` buffered (at most
        SPANS_PER_FRAME; the rest counts as dropped). False when the link
        is down; the spans then count as dropped, not retried."""
        if self.tracer is None:
            return True
        link = self._links[0] if link is None else link
        with link.span_lock:
            if not link.span_buf and not link.span_dropped:
                return True
            spans = list(link.span_buf)
            link.span_buf.clear()
            dropped, link.span_dropped = link.span_dropped, 0
        shipped = spans[:self.SPANS_PER_FRAME]
        dropped += len(spans) - len(shipped)
        try:
            self._send_link(link, "FleetSpans", {
                "member_id": self.member_id,
                "spans": [span_to_wire(s, self._epoch_offset_ns)
                          for s in shipped],
                "dropped": dropped,
            })
            return True
        except Exception as e:  # noqa: BLE001 — the link's fault domain
            logger.debug("fleet worker %s: span ship failed: %s",
                         self.member_id, e)
            with link.span_lock:
                link.span_dropped += len(shipped) + dropped
            if link is self._links[0] and self.tracer is not None:
                self.tracer.record_drop("wire", len(shipped))
            return False

    def ship_telemetry_once(self,
                            link: Optional[_RegistryLink] = None) -> bool:
        """Send one FleetTelemetry frame: the digests' current windows and
        the cumulative step-clock counters (and the mesh's kvwire
        counters). Stateless: the next frame carries whatever a lost one
        did. False when the link is down."""
        if self.metrics is None:
            return True
        body = self.metrics.perf_wire()
        if not body["digests"] and not body["counters"]:
            return True
        try:
            self._send_link(link, "FleetTelemetry",
                            {"member_id": self.member_id, **body})
            self.metrics.record_telemetry_frame("sent")
            return True
        except Exception as e:  # noqa: BLE001 — the link's fault domain
            logger.debug("fleet worker %s: telemetry ship failed: %s",
                         self.member_id, e)
            self.metrics.record_telemetry_frame("failed")
            return False

    def heartbeat_once(self, link: Optional[_RegistryLink] = None) -> bool:
        """Send one heartbeat on ``link`` (None: the first); False when it
        is down."""
        link = self._links[0] if link is None else link
        link.seq += 1
        try:
            self._send_link(link, "FleetHeartbeat", {
                "member_id": self.member_id,
                "seq": link.seq,
                "engines": [status_to_wire(s)
                            for s in self.scheduler.statuses()],
                "data_port": (self.kv_server.bound_port
                              if self.kv_server is not None else 0),
            })
            return True
        except Exception as e:  # noqa: BLE001 — the link's fault domain
            logger.debug("fleet worker %s: heartbeat failed: %s",
                         self.member_id, e)
            return False

    def _link_loop(self, link: _RegistryLink) -> None:
        """One link's beat and redial loop: a dead registry cannot slow
        another's heartbeat."""
        backoff = self.settings.heartbeat_interval_s
        while not self._stop.wait(self.settings.heartbeat_interval_s):
            if self._crashed:
                return  # the injected crash: the process is "dead"
            if (link.sock is None or not self.heartbeat_once(link)
                    or not self.ship_spans_once(link)
                    or not self.ship_telemetry_once(link)):
                self._close_link(link)
                if self._stop.is_set() or self._crashed:
                    return
                try:
                    self._connect_link(link, timeout_s=5.0)
                    backoff = self.settings.heartbeat_interval_s
                except OSError as e:
                    logger.debug("fleet worker %s: redial of %s failed: %s",
                                 self.member_id, link.endpoint, e)
                    backoff = min(backoff * 2.0, 5.0)
                    if self._stop.wait(backoff):
                        return

    # -- serving (reader threads) ------------------------------------------

    def _read_loop(self, sock: socket.socket, link: _RegistryLink) -> None:
        """What a registry sends: FleetSubmit frames (requests and aborts)
        and the mesh's KvIntro frames. The member-to-host kinds never come
        back on this wire, and lease frames only cross registry wires."""
        try:
            while True:
                frame = recv_frame(sock)
                if frame is None:
                    return
                name, obj = frame
                if name == "FleetSubmit":
                    self._serve_submit(obj, link)
                elif name == "KvIntro":
                    self._on_kv_intro(obj)
        except OSError:
            return  # the connection died; the link loop redials
        except faults.InjectedFault:
            # fleet.submit armed on the member: it "crashes" on receipt,
            # drops every connection, serves nothing and stays down (the
            # hosts redispatch its zero-token requests)
            logger.warning("fleet worker %s: injected crash on submit",
                           self.member_id)
            self._crashed = True
            self._close_all()
        except Exception:  # noqa: BLE001 — the reader must not die quietly
            logger.exception("fleet worker %s reader failed", self.member_id)
            self._close_link(link)

    def _on_kv_intro(self, obj: Dict[str, Any]) -> None:
        """A registry's introduction: learn (or, on ``gone``, forget) a
        peer member's data endpoint. Without the mesh the frame is
        ignored; a fetch hint it cannot honour recomputes."""
        epoch = int(obj.get("epoch") or 0)
        if epoch and epoch < self._fleet_epoch:
            return  # fenced: a partitioned old primary still brokering
        if epoch > self._fleet_epoch:
            self._fleet_epoch = epoch
        if self.mesh_client is not None:
            self.mesh_client.on_intro(obj)

    def _serve_submit(self, obj: Dict[str, Any],
                      link: Optional[_RegistryLink] = None) -> None:
        rid = obj.get("request_id", "")
        engine_id = obj.get("engine_id", "")
        runner = self.scheduler.get(engine_id)
        if obj.get("abort"):
            # aborts are not fenced: a demoted registry may still own
            # requests it routed, and its abort only frees local work
            if runner is not None:
                runner.abort(rid)
            return
        epoch = int(obj.get("epoch") or 0)
        if epoch and epoch < self._fleet_epoch:
            # registry HA: control from an epoch below the highest seen is
            # a partitioned old primary's. Refused as a zero-token
            # worker_failure on the wire it came in on; the sender's proxy
            # redispatches on its side.
            logger.warning("fleet worker %s: fenced submit %s (epoch %d "
                           "< %d)", self.member_id, rid, epoch,
                           self._fleet_epoch)
            self.send_event({
                "request_id": rid, "engine_id": engine_id,
                "kind": "error", "code": "worker_failure",
                "message": f"stale control epoch {epoch} (member has "
                           f"seen {self._fleet_epoch}): fenced",
            }, link=link)
            return
        if epoch > self._fleet_epoch:
            self._fleet_epoch = epoch
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
        sink = _RemoteSink(self, rid, engine_id, span=span, link=link)
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
        if self._mesh_prefetch(runner, req, obj, span):
            return
        runner.submit([req])

    def _mesh_prefetch(self, runner, req: ServerRequest,
                       obj: Dict[str, Any], span) -> bool:
        """Honour a submit's mesh fetch hint: pull the warm prefix from
        the hinted peer member over this member's own channel, seat it in
        the local engine's prefix cache, then submit the request. True
        when this path owns the submit (it happens in a callback); False
        hands the request to the plain submit.

        As ``disagg.PrefixFetcher``, the fetch speeds a request up and
        never gates it: no intro for the peer, a dead or breaker-open
        wire (``fleet.kv_peer_dial``), a stale or empty export or an
        import reject all recompute here, once (every stage's callback
        fires once and every failure ends in the same finisher)."""
        member = obj.get("fetch_member") or ""
        hashes = [int(h) for h in obj.get("fetch_hashes") or ()]
        if not member or not hashes or self.mesh_client is None:
            return False
        peer = self.mesh_client.peer(member,
                                     obj.get("fetch_source_engine") or "")
        if peer is None:
            # never introduced, or already retracted: recompute
            if self.metrics:
                self.metrics.record_prefix_fetch("fallback", scope="mesh")
            return False
        chunk_pages = int(obj.get("fetch_chunk_pages") or 0) or 1
        wire_quant = obj.get("fetch_wire_quant") or "none"
        t0 = time.monotonic()

        def _finish(outcome: str, nbytes: int = 0) -> None:
            if self.metrics:
                self.metrics.record_prefix_fetch(
                    outcome, seconds=time.monotonic() - t0, nbytes=nbytes,
                    scope="mesh")
            runner.submit([req])

        def _on_import(ok: bool, err, nbytes: int) -> None:
            if not ok:
                logger.debug("mesh prefetch for %s: import rejected (%s); "
                             "recomputing", req.request_id, err)
            _finish("ok" if ok else "fallback", nbytes)

        def _on_export(result, err) -> None:
            # the peer channel's reader thread (or this one, failing fast)
            if result is None:
                logger.debug("mesh prefetch for %s: peer %s export failed "
                             "(%s); recomputing", req.request_id, member,
                             err)
                _finish("fallback")
                return
            depth, chunks = result
            if depth <= 0 or not chunks:
                _finish("fallback")  # the peer evicted the chain
                return
            try:
                ps = max(1, getattr(runner.status(), "page_size", 0) or 1)
                tokens = list(req.prompt_ids[: depth * ps])
                nbytes = sum(len(c.payload) for c in chunks)
                runner.submit_prefix_import(
                    req.request_id, tokens, chunks,
                    lambda ok, ierr: _on_import(ok, ierr, nbytes))
            except Exception as e:  # noqa: BLE001 — a torn chunk set must
                # not kill the reader
                logger.debug("mesh prefetch for %s: import failed (%s); "
                             "recomputing", req.request_id, e)
                _finish("fallback")

        try:
            peer.submit_prefix_export(
                req.request_id, hashes, chunk_pages, wire_quant, _on_export,
                trace=(span.context() if span is not None else None))
        except Exception as e:  # noqa: BLE001 — the channel's fault domain
            logger.debug("mesh prefetch for %s: dispatch failed (%s); "
                         "recomputing", req.request_id, e)
            _finish("fallback")
        return True
