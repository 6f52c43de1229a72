"""The fleet's KV data plane: cross-process handoff and peer prefix fetch
over one data channel per member (the port of
``distributed_inference_server_tpu/serving/fleet_kv.py``).

The control plane (``serving/fleet.py``) routes requests to a member's
replicas; the KV byte paths (the prefill-to-decode handoff and the peer
prefix fetch) need a wire of their own:

- **KvDataChannel** (the registry host's end, one per member): a second
  TCP connection, dialed lazily at the ``data_port`` the member's
  heartbeat advertises, apart from the heartbeat wire so a chunk stream
  of many megabytes never blocks control frames. It carries
  ``KvHandoffHeader`` / ``KvChunk`` / ``KvHandoff`` / ``KvPrefixFetch``
  streams host to member, and chunks, ``KvStreamResult`` and
  ``FleetEvent`` frames back. At most ``fleet.kv_max_streams`` streams are
  in flight (one more fails at once to its local fallback), each stream
  resolves exactly once, and a dead connection is redialed with backoff.
- **KvDataServer** (the member's end): the listener a ``FleetWorker``
  binds at start and advertises in every heartbeat. Each connection has a
  reader thread (reassembly, then calls on the member's local runners)
  and a writer thread (a bounded queue to the socket), so a runner's
  callback only enqueues frames. A sequence that crossed decodes on the
  member with a sink that writes ``FleetEvent`` frames back over the
  channel; the host's ``RemoteRunner`` pumps them into the request's sink.

Frames are the JAX package's byte for byte (u32 length, u8 kind, the
protowire message), and the chunk payloads are the engines' KVP1 bytes.

Failures: every stream resolves once. A dial failure (``fleet.kv_connect``),
a frame lost mid-stream (``fleet.kv_chunk``, once per chunk), a torn
connection, or a member-side reject resolves the stream as failed on the
host, which decodes a handoff in place and recomputes a fetch. A member
crash resolves its pending runner callbacks through the runner's own
failure path, so the failure ships back as a ``KvStreamResult``. A channel
that dies after a commit fails the migrated requests at once
(``engine_crashed``: they streamed tokens) and the member aborts its
orphans.
"""

from __future__ import annotations

import logging
import queue
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from distributed_inference_server_tpu_torch.engine.engine import (
    SamplingParams,
    SequenceExport,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import KvChunk
from distributed_inference_server_tpu_torch.serving import faults, protowire
from distributed_inference_server_tpu_torch.serving.fleet import close_socket
from distributed_inference_server_tpu_torch.serving.metrics import (
    MetricsCollector,
)

logger = logging.getLogger(__name__)

#: the data channel's frame kinds: a table of its own, so the bulk wire is
#: never parsed as the heartbeat wire
KV_FRAME_KINDS: Dict[int, str] = {
    1: "KvHandoffHeader",
    2: "KvChunk",
    3: "KvHandoff",
    4: "KvPrefixFetch",
    5: "KvStreamResult",
    6: "FleetEvent",  # decode tokens of a migrated request, member to host
}
_KV_KIND_BY_NAME = {name: kind for kind, name in KV_FRAME_KINDS.items()}

#: a KvChunk carries chunk_pages full pages, tens of MB at large shapes;
#: anything bigger is a torn or foreign stream
MAX_KV_FRAME_BYTES = 256 * 1024 * 1024


class KvWireError(RuntimeError):
    """A malformed frame on a data channel: the connection dies and every
    stream in flight on it resolves as failed."""


def send_kv_frame(sock: socket.socket, name: str,
                  obj: Dict[str, Any]) -> int:
    """Encode and write one data-channel frame; returns the bytes written.
    Callers serialize sends per socket (one writer thread per side)."""
    payload = protowire.encode(name, obj)
    frame = struct.pack(">IB", len(payload), _KV_KIND_BY_NAME[name]) + payload
    sock.sendall(frame)
    return len(frame)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            return None  # orderly EOF
        buf += chunk
    return bytes(buf)


def recv_kv_frame(sock: socket.socket
                  ) -> Optional[Tuple[str, Dict[str, Any]]]:
    """Read one frame; None at EOF, ``KvWireError`` on a malformed one."""
    header = _recv_exact(sock, 5)
    if header is None:
        return None
    length, kind = struct.unpack(">IB", header)
    name = KV_FRAME_KINDS.get(kind)
    if name is None or length > MAX_KV_FRAME_BYTES:
        raise KvWireError(f"bad kv data frame (kind={kind}, len={length})")
    payload = _recv_exact(sock, length)
    if payload is None:
        return None
    try:
        return name, protowire.decode(name, payload)
    except Exception as e:  # noqa: BLE001 — the wire's fault domain
        raise KvWireError(f"undecodable {name} frame: {e}") from e


def chunk_to_wire(handoff_id: str, c: KvChunk) -> Dict[str, Any]:
    return {
        "handoff_id": handoff_id,
        "index": c.index,
        "total": c.total,
        "page_start": c.page_start,
        "page_count": c.page_count,
        "crc32": c.crc32,
        "payload": c.payload,
    }


def chunk_from_wire(d: Dict[str, Any]) -> KvChunk:
    return KvChunk(index=d["index"], total=d["total"],
                   page_start=d["page_start"], page_count=d["page_count"],
                   payload=d["payload"], crc32=d["crc32"])


def _export_state_to_wire(exp: SequenceExport) -> Dict[str, Any]:
    """A ``SequenceExport``'s host state as a KvHandoff dict. The chunks
    travel as frames of their own; ``kv`` carries the monolithic payload
    only when there are none."""
    obj: Dict[str, Any] = {
        "request_id": str(exp.request_id),
        "token_ids": [int(t) for t in exp.token_ids],
        "prompt_len": exp.prompt_len,
        "seq_len": exp.seq_len,
        "next_token": int(exp.next_token),
        "emitted_tokens": exp.emitted_tokens,
        "output_text": exp.output_text,
        "emitted_upto": exp.emitted_upto,
        "pending_ids": [int(t) for t in exp.pending_ids],
        "max_tokens": exp.params.max_tokens,
        "temperature": exp.params.temperature,
        "top_p": exp.params.top_p,
        "stop_sequences": list(exp.params.stop_sequences),
        "kv": exp.kv if exp.kv_chunks is None else b"",
        "source_engine": exp.source_engine,
    }
    if exp.draft_kv is not None:
        obj["draft_kv"] = exp.draft_kv
    return obj


def _export_state_from_wire(d: Dict[str, Any]) -> SequenceExport:
    return SequenceExport(
        request_id=d["request_id"],
        token_ids=list(d["token_ids"]),
        prompt_len=d["prompt_len"],
        seq_len=d["seq_len"],
        next_token=d["next_token"],
        params=SamplingParams(
            max_tokens=d["max_tokens"],
            temperature=d["temperature"],
            top_p=d["top_p"],
            stop_sequences=tuple(d["stop_sequences"]),
        ),
        output_text=d["output_text"],
        emitted_upto=d["emitted_upto"],
        emitted_tokens=d["emitted_tokens"],
        pending_ids=list(d["pending_ids"]),
        kv=d["kv"],
        draft_kv=d.get("draft_kv"),
        source_engine=d["source_engine"],
    )


# ---------------------------------------------------------------------------
# The host's end: one lazily dialed data channel per member
# ---------------------------------------------------------------------------


class _KvStream:
    """One stream in flight on the host: registered before its first frame
    goes out, resolved exactly once (by its KvStreamResult, a send or dial
    failure, or the connection dying under it)."""

    __slots__ = ("key", "op", "rid", "cb", "chunks", "started_at",
                 "result_depth", "wire_bytes", "wire_chunks")

    def __init__(self, op: str, rid: str, cb: Callable):
        self.key = f"{op}:{rid}"
        self.op = op
        self.rid = rid
        self.cb = cb
        self.chunks: List[KvChunk] = []  # a fetch response's reassembly
        self.started_at = time.monotonic()
        self.result_depth = 0  # fetch: the depth the member served
        # the bulk bytes and chunks the stream moved, either direction
        # (the learned wire rate's observation)
        self.wire_bytes = 0
        self.wire_chunks = 0


class KvDataChannel:
    """The registry host's end of one member's data channel.

    Public calls come from the disagg worker, the dispatcher's fetch path
    and runner callbacks: they register the stream and queue a send job.
    One wire thread owns the socket's sending half, the lazy dial included
    (a dial may block up to ``connect_timeout_s`` and must never run on a
    dispatch path); one reader thread per connection owns the receiving
    half. A stream resolves exactly once: whoever pops it from
    ``_streams`` under ``_lock`` resolves it."""

    def __init__(
        self,
        member_id: str,
        host: str,
        port: int,
        max_streams: int = 4,
        connect_timeout_s: float = 5.0,
        metrics: Optional[MetricsCollector] = None,
        on_event: Optional[Callable[[Dict[str, Any]], None]] = None,
        on_lost_requests: Optional[Callable[[List[str], str], None]] = None,
        breaker_threshold: int = 3,
        breaker_open_s: float = 5.0,
        retry_budget=None,
        rate_estimator=None,
        peer_wire: bool = False,
    ):
        """``on_event(obj)``: the FleetEvent frames of migrated requests,
        on the reader thread. ``on_lost_requests(rids, reason)``: the
        connection died with migrated requests still streaming; the caller
        fails them. ``breaker_threshold`` / ``breaker_open_s``: the
        channel's ``CircuitBreaker`` (``health.wire_failures`` /
        ``health.breaker_open_s``); while it is open new streams fail at
        once and the member leaves handoff and fetch election
        (``wire_available``). ``retry_budget``: a redial after a failure
        draws from it. ``rate_estimator``: each good stream's bytes and
        seconds feed the wire's learned rate (``serving/fleet_mesh.py``).
        ``peer_wire``: a member-to-member channel of the mesh, whose dial
        fault point is ``fleet.kv_peer_dial`` instead of
        ``fleet.kv_connect``."""
        from distributed_inference_server_tpu_torch.serving.health import (
            CircuitBreaker,
        )

        self.member_id = member_id
        self.address = (host, port)
        self.max_streams = max(1, max_streams)
        self.connect_timeout_s = connect_timeout_s
        self.metrics = metrics
        self.on_event = on_event
        self.on_lost_requests = on_lost_requests
        self.retry_budget = retry_budget
        self.rate_estimator = rate_estimator
        self.peer_wire = peer_wire
        self.breaker = CircuitBreaker(
            threshold=breaker_threshold, open_s=breaker_open_s,
            on_transition=(metrics.record_breaker_transition
                           if metrics is not None else None))
        # a dial or send failed since the last good connect: the next dial
        # is a retry (the wire thread's own flag)
        self._reconnecting = False
        self._lock = threading.Lock()
        self._streams: Dict[str, _KvStream] = {}
        # migrated requests whose decode events ride this connection;
        # failed at once if it dies under them
        self._event_rids: set = set()
        self._sock: Optional[socket.socket] = None
        self._jobs: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        # after a failed dial the next one waits until _not_before
        self._not_before = 0.0
        self._backoff_s = 0.25
        self._bytes_sent = 0
        self._bytes_received = 0

    # -- public calls (any thread) ------------------------------------------

    def fetch_prefix(self, rid, engine_id: str, hashes: Sequence[int],
                     chunk_pages: int, wire_quant: str,
                     trace: Optional[tuple],
                     cb: Callable[[Optional[tuple], Optional[str]], None]
                     ) -> None:
        """Ask the member's ``engine_id`` for its cached prefix chain:
        ``cb((depth, chunks), None)`` or ``cb(None, err)``, exactly once
        (``submit_prefix_export``'s contract)."""
        def _resolve(ok: bool, err: Optional[str], s: _KvStream) -> None:
            if not ok:
                cb(None, err or "fetch failed")
                return
            cb((s.result_depth, sorted(s.chunks, key=lambda c: c.index)),
               None)

        stream = _KvStream("fetch", str(rid), _resolve)
        msg = {
            "request_id": str(rid),
            "hashes": [int(h) for h in hashes],
            "chunk_pages": chunk_pages,
            "wire_quant": wire_quant,
            "engine_id": engine_id,
        }
        if trace:
            msg["trace_id"], msg["parent_span_id"] = trace
        self._start_stream(stream, [("KvPrefixFetch", msg)])

    def import_open(self, rid, engine_id: str, prefix_pages: int,
                    wire_quant: str, chunks: Sequence[KvChunk],
                    trace: Optional[tuple],
                    cb: Callable[[bool, Optional[str]], None]) -> None:
        """Phase 1 of a streamed handoff: ship the prefix chunks and open
        an import session on the member's engine."""
        stream = _KvStream("open", str(rid), lambda ok, err, s: cb(ok, err))
        frames = [("KvHandoffHeader", self._header(
            rid, "open", engine_id, wire_quant, trace,
            prefix_pages=prefix_pages, total_chunks=len(chunks)))]
        frames += [("KvChunk", chunk_to_wire(str(rid), c)) for c in chunks]
        self._start_stream(stream, frames)

    def import_commit(self, exp: SequenceExport, engine_id: str,
                      trace: Optional[tuple],
                      cb: Callable[[bool, Optional[str]], None]) -> None:
        """Phase 2: the switchover tail (``exp.kv_chunks``) and the host
        state. On ok the member's engine owns the sequence and its decode
        events ride this channel."""
        self._sequence_stream("commit", exp, engine_id, trace, cb)

    def resume(self, exp: SequenceExport, engine_id: str,
               trace: Optional[tuple],
               cb: Callable[[bool, Optional[str]], None]) -> None:
        """A monolithic migration: the chunks (a streamed export) or the
        single ``kv`` payload, and the host state."""
        self._sequence_stream("resume", exp, engine_id, trace, cb)

    def _sequence_stream(self, op: str, exp: SequenceExport,
                         engine_id: str, trace: Optional[tuple],
                         cb: Callable[[bool, Optional[str]], None]) -> None:
        """Commit and resume: header, chunks, the KvHandoff state frame;
        on ok the request's events ride this channel and are tracked, so
        a channel death fails the request."""
        rid = str(exp.request_id)
        chunks = list(exp.kv_chunks or [])

        def _resolve(ok: bool, err: Optional[str], s: _KvStream) -> None:
            if ok:
                with self._lock:
                    self._event_rids.add(rid)
            cb(ok, err)

        stream = _KvStream(op, rid, _resolve)
        frames = [("KvHandoffHeader", self._header(
            rid, op, engine_id, exp.wire_quant, trace,
            total_chunks=len(chunks)))]
        frames += [("KvChunk", chunk_to_wire(rid, c)) for c in chunks]
        frames.append(("KvHandoff", _export_state_to_wire(exp)))
        self._start_stream(stream, frames)

    def import_abort(self, rid, engine_id: str) -> None:
        """Drop an opened, uncommitted member import session (the stream
        was cancelled or the client left); no reply."""
        self._enqueue_frames(None, [("KvStreamResult", {
            "stream_id": str(rid), "op": "abort", "ok": True,
            "engine_id": engine_id,
        })])

    def release_request(self, rid) -> None:
        """The migrated request ended (done, error or abort seen by the
        proxy): stop tracking its events."""
        with self._lock:
            self._event_rids.discard(str(rid))

    def wire_available(self) -> bool:
        """The election gate: False while the breaker is open, so handoff
        targets and fetch sources skip this member."""
        return self.breaker.available()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "connected": self._sock is not None,
                "streams": len(self._streams),
                "event_requests": len(self._event_rids),
                "bytes_sent": self._bytes_sent,
                "bytes_received": self._bytes_received,
            }
        out["breaker"] = self.breaker.stats()
        if self.rate_estimator is not None:
            out["rate_bytes_per_s"] = self.rate_estimator.rate()
        return out

    def close(self, reason: str = "channel closed") -> None:
        with self._lock:
            self._closed = True
        self._drop_connection(reason, count_failure=False)
        self._jobs.put(None)  # the wire thread exits

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _header(rid, op: str, engine_id: str, wire_quant: str,
                trace: Optional[tuple], prefix_pages: int = 0,
                total_chunks: int = 0) -> Dict[str, Any]:
        h = {
            "handoff_id": str(rid), "request_id": str(rid),
            "wire_quant": wire_quant or "none", "op": op,
            "engine_id": engine_id, "prefix_pages": prefix_pages,
            "total_chunks": total_chunks,
        }
        if trace:
            h["trace_id"], h["parent_span_id"] = trace
        return h

    def _start_stream(self, stream: _KvStream,
                      frames: List[Tuple[str, Dict[str, Any]]]) -> None:
        if not self.breaker.try_acquire():
            # the breaker is open (or its half-open probe is out): the
            # member's wire is judged broken, fail to the local fallback
            stream.cb(False, "kv data channel circuit open "
                      f"(member {self.member_id} wire unhealthy)", stream)
            return
        with self._lock:
            if self._closed:
                reject = "kv data channel closed"
            elif len(self._streams) >= self.max_streams:
                reject = (f"kv data channel window full "
                          f"({self.max_streams} streams in flight)")
            else:
                reject = None
                self._streams[stream.key] = stream
        if reject is not None:
            # the attempt never ran: hand a half-open probe back, or the
            # breaker stays half-open for good
            self.breaker.release()
            stream.cb(False, reject, stream)
            return
        self._enqueue_frames(stream, frames)

    def _enqueue_frames(self, stream: Optional[_KvStream],
                        frames: List[Tuple[str, Dict[str, Any]]]) -> None:
        with self._lock:
            if self._closed:
                return  # sends after close are dropped
            if self._worker is None:
                # nothing is spawned or dialed before the first KV byte
                self._worker = threading.Thread(
                    target=self._run_worker,
                    name=f"kv-wire-{self.member_id}", daemon=True)
                self._worker.start()
        self._jobs.put((stream, frames))

    def _run_worker(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            stream, frames = job
            if stream is not None:
                with self._lock:
                    live = self._streams.get(stream.key) is stream
                if not live:
                    # already failed while queued (a connection drop): its
                    # frames would make the member do work the host gave
                    # up on (reserve pages, decode a ghost duplicate)
                    continue
            try:
                sock = self._ensure_connected()
                # the data wire times out mid-send: repeated hits walk the
                # breaker to open
                faults.fire("fleet.wire_timeout")
                for name, obj in frames:
                    if name == "KvChunk":
                        # nth=N tears the stream at its Nth chunk
                        faults.fire("fleet.kv_chunk")
                    n = send_kv_frame(sock, name, obj)
                    with self._lock:
                        self._bytes_sent += n
                        if stream is not None:
                            stream.wire_bytes += n
                            if name == "KvChunk":
                                stream.wire_chunks += 1
            except Exception as e:  # noqa: BLE001 — the transport's fault
                # domain: the stream fails and the connection goes (its
                # reader resolves every other stream in flight)
                logger.debug("kv channel %s: send failed: %s",
                             self.member_id, e)
                if self.metrics:
                    self.metrics.record_error("fleet_kv.send")
                self.breaker.record_failure()
                self._reconnecting = True
                self._resolve_stream(stream, False, str(e))
                # this failure is counted above; the drop must not count it
                # again
                self._drop_connection(f"send failed: {e}",
                                      count_failure=False)

    def _backoff(self, now: float) -> None:
        self._not_before = now + self._backoff_s
        self._backoff_s = min(self._backoff_s * 2.0, 5.0)
        self._reconnecting = True

    def _ensure_connected(self) -> socket.socket:
        with self._lock:
            sock = self._sock
        if sock is not None:
            return sock
        now = time.monotonic()
        if now < self._not_before:
            raise OSError(
                f"kv data channel to {self.member_id} backing off "
                f"({self._not_before - now:.2f}s left)")
        if (self._reconnecting and self.retry_budget is not None
                and not self.retry_budget.acquire("kv_reconnect")):
            # a redial after a failure is a retry, and the shared budget
            # is dry: the stream takes its local fallback
            raise OSError(f"kv data channel to {self.member_id}: retry "
                          "budget exhausted")
        # mesh wires and registry-to-member wires are separate fault
        # domains, each with its own point
        if self.peer_wire:
            faults.fire("fleet.kv_peer_dial")
        else:
            faults.fire("fleet.kv_connect")
        try:
            sock = socket.create_connection(self.address,
                                            timeout=self.connect_timeout_s)
        except OSError:
            self._backoff(now)
            raise
        try:
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            # dialed but not configurable: as dead as a failed dial (close
            # it, or the fd leaks)
            sock.close()
            self._backoff(now)
            raise
        self._backoff_s = 0.25
        self._reconnecting = False
        with self._lock:
            if self._closed:
                sock.close()
                raise OSError("kv data channel closed")
            self._sock = sock
        threading.Thread(target=self._read_loop, args=(sock,),
                         name=f"kv-read-{self.member_id}",
                         daemon=True).start()
        logger.info("kv data channel to %s dialed %s:%d", self.member_id,
                    *self.address)
        return sock

    def _read_loop(self, sock: socket.socket) -> None:
        """What the member sends back: fetch chunks, stream results and
        the events of migrated requests (the host only starts streams, so
        headers and states never arrive here)."""
        try:
            while True:
                frame = recv_kv_frame(sock)
                if frame is None:
                    break
                name, obj = frame
                if name == "KvChunk":
                    with self._lock:
                        payload_n = len(obj.get("payload", b""))
                        self._bytes_received += payload_n
                        stream = self._streams.get(
                            f"fetch:{obj.get('handoff_id', '')}")
                        if stream is not None:
                            stream.wire_bytes += payload_n
                            stream.wire_chunks += 1
                    if stream is not None:
                        stream.chunks.append(chunk_from_wire(obj))
                elif name == "KvStreamResult":
                    self._on_result(obj)
                elif name == "FleetEvent":
                    rid = obj.get("request_id", "")
                    if obj.get("kind") in ("done", "error"):
                        self.release_request(rid)
                    if self.on_event is not None:
                        self.on_event(obj)
        except (OSError, KvWireError) as e:
            logger.debug("kv channel %s reader ended: %s", self.member_id, e)
        finally:
            self._drop_connection("kv data connection lost")

    def _on_result(self, obj: Dict[str, Any]) -> None:
        key = f"{obj.get('op', '')}:{obj.get('stream_id', '')}"
        with self._lock:
            stream = self._streams.pop(key, None)
        if stream is None:
            return  # already resolved (send failure or channel death)
        # any result proves the wire round-tripped: a member-side reject
        # is no wire failure and must not open the breaker
        self.breaker.record_success()
        if (self.rate_estimator is not None and bool(obj.get("ok"))
                and stream.wire_bytes > 0):
            # only good streams with a bulk payload: a reject moved control
            # frames, not pages
            self.rate_estimator.observe(
                stream.wire_bytes,
                max(time.monotonic() - stream.started_at, 1e-6),
                chunks=stream.wire_chunks)
        stream.result_depth = obj.get("depth", 0)
        try:
            stream.cb(bool(obj.get("ok")), obj.get("error") or None, stream)
        except Exception as e:  # noqa: BLE001 — callback isolation
            self._absorbed("stream_callback", e)

    def _resolve_stream(self, stream: Optional[_KvStream], ok: bool,
                        err: Optional[str]) -> None:
        if stream is None:
            return
        with self._lock:
            if self._streams.pop(stream.key, None) is None:
                return  # the reader's result came first
        try:
            stream.cb(ok, err, stream)
        except Exception as e:  # noqa: BLE001 — callback isolation
            self._absorbed("stream_callback", e)

    def _drop_connection(self, reason: str,
                         count_failure: bool = True) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
            streams = list(self._streams.values())
            self._streams.clear()
            lost = sorted(self._event_rids)
            self._event_rids.clear()
        if count_failure and (streams or lost):
            # the connection died under work (an idle EOF is no evidence)
            self.breaker.record_failure()
            self._reconnecting = True
        if sock is not None:
            # shut down before closing: a close under a reader blocked in
            # recv defers the FIN, and the peer would never see the death
            close_socket(sock)
        for stream in streams:
            try:
                stream.cb(False, reason, stream)
            except Exception as e:  # noqa: BLE001 — callback isolation
                self._absorbed("stream_callback", e)
        if lost and self.on_lost_requests is not None:
            # migrated requests whose events rode this connection already
            # streamed tokens: they fail (engine_crashed), never rerun
            try:
                self.on_lost_requests(lost, reason)
            except Exception as e:  # noqa: BLE001 — callback isolation
                self._absorbed("lost_requests", e)

    def _absorbed(self, site: str, exc: BaseException) -> None:
        logger.debug("kv channel %s: absorbed error at %s: %s",
                     self.member_id, site, exc)
        if self.metrics:
            self.metrics.record_error(f"fleet_kv.{site}")


# ---------------------------------------------------------------------------
# The member's end: the data listener a FleetWorker advertises
# ---------------------------------------------------------------------------


class _DataEventSink:
    """The sink of a sequence that crossed to this member: each token and
    the end become FleetEvent frames on the connection's writer queue (on
    the member's runner threads; enqueue only)."""

    def __init__(self, conn: "_KvPeerConn", request_id: str,
                 engine_id: str):
        self._conn = conn
        self._rid = request_id
        self._eid = engine_id

    def _event(self, obj: Dict[str, Any]) -> None:
        obj["request_id"] = self._rid
        obj["engine_id"] = self._eid
        self._conn.enqueue("FleetEvent", obj)

    def on_token(self, token_id, text, token_index, logprob=None) -> None:
        ev = {"kind": "token", "text": text or "",
              "token_index": token_index or 0}
        if token_id is not None:
            ev["token_id"] = int(token_id)
        if logprob is not None:
            ev["logprob"] = float(logprob)
        self._event(ev)

    def on_done(self, finish_reason, usage) -> None:
        self._conn.release(self._rid)
        self._event({
            "kind": "done",
            "finish_reason": getattr(finish_reason, "value",
                                     str(finish_reason)),
            "prompt_tokens": getattr(usage, "prompt_tokens", 0),
            "completion_tokens": getattr(usage, "completion_tokens", 0),
        })

    def on_error(self, message, code) -> None:
        self._conn.release(self._rid)
        self._event({"kind": "error", "message": message or "",
                     "code": code or "inference_failed"})


class _Assembly:
    """An inbound stream being reassembled (owned by the reader)."""

    __slots__ = ("header", "chunks")

    def __init__(self, header: Dict[str, Any]):
        self.header = header
        self.chunks: List[KvChunk] = []


class _KvPeerConn:
    """One accepted connection on the member's data listener: a reader
    thread (frames, reassembly, local runner calls) and a writer thread (a
    bounded frame queue to the socket). Runner callbacks only enqueue; a
    full queue blocks the callback briefly rather than buffering without
    bound."""

    def __init__(self, server: "KvDataServer", sock: socket.socket,
                 peer: str):
        self.server = server
        self.sock = sock
        self.peer = peer
        # inbound streams by handoff id; only the reader touches this
        self._assemblies: Dict[str, _Assembly] = {}
        self._out: "queue.Queue" = queue.Queue(maxsize=256)
        self._lock = threading.Lock()
        # migrated requests decoding here whose events ride this
        # connection (rid -> engine id): aborted if the host goes away
        self._live: Dict[str, str] = {}
        self._closed = False
        self._writer = threading.Thread(
            target=self._write_loop, name=f"kv-peer-write-{peer}",
            daemon=True)
        self._writer.start()

    # -- outbound (runner threads enqueue, the writer sends) ----------------

    def enqueue(self, name: str, obj: Dict[str, Any]) -> None:
        with self._lock:
            if self._closed:
                return
        try:
            self._out.put((name, obj), timeout=5.0)
        except queue.Full:
            # the host stopped draining: the connection is dead, rather
            # than a runner callback stalled for good
            self.close("kv data writer queue wedged")

    def release(self, rid: str) -> None:
        with self._lock:
            self._live.pop(str(rid), None)

    def _write_loop(self) -> None:
        while True:
            item = self._out.get()
            if item is None:
                return
            name, obj = item
            try:
                if name == "KvChunk":
                    # a fetch response can tear mid-stream too
                    faults.fire("fleet.kv_chunk")
                send_kv_frame(self.sock, name, obj)
            except Exception as e:  # noqa: BLE001 — the transport's fault
                # domain
                logger.debug("kv peer %s: send failed: %s", self.peer, e)
                self.close(f"send failed: {e}")
                return

    # -- inbound (the reader thread) ----------------------------------------

    def run(self) -> None:
        """What the host sends: stream headers, chunks, states, fetch
        requests and aborts (FleetEvent frames only go the other way)."""
        try:
            while True:
                frame = recv_kv_frame(self.sock)
                if frame is None:
                    break
                name, obj = frame
                if name == "KvChunk":
                    asm = self._assemblies.get(obj.get("handoff_id", ""))
                    if asm is not None:
                        asm.chunks.append(chunk_from_wire(obj))
                        self._maybe_complete(obj.get("handoff_id", ""))
                elif name == "KvHandoffHeader":
                    hid = obj.get("handoff_id", "")
                    self._assemblies[hid] = _Assembly(obj)
                    self._maybe_complete(hid)
                elif name == "KvHandoff":
                    self._on_state(obj)
                elif name == "KvPrefixFetch":
                    self._on_fetch(obj)
                elif name == "KvStreamResult":
                    if obj.get("op") == "abort":
                        self._on_abort(obj)
        except (OSError, KvWireError) as e:
            logger.debug("kv peer %s reader ended: %s", self.peer, e)
        finally:
            self.close("kv data connection lost")

    def _runner(self, engine_id: str):
        return self.server.scheduler.get(engine_id)

    def _result(self, rid: str, op: str, ok: bool,
                error: Optional[str] = None, depth: int = 0) -> None:
        self.enqueue("KvStreamResult", {
            "stream_id": rid, "op": op, "ok": ok,
            "error": error or "", "depth": depth,
        })

    def _maybe_complete(self, hid: str) -> None:
        """An ``open`` stream acts once all its chunks arrived (commit and
        resume wait for their KvHandoff state frame)."""
        asm = self._assemblies.get(hid)
        if asm is None or asm.header.get("op") != "open":
            return
        if len(asm.chunks) < asm.header.get("total_chunks", 0):
            return
        self._assemblies.pop(hid, None)
        header = asm.header
        rid = header.get("request_id", "")
        runner = self._runner(header.get("engine_id", ""))
        if runner is None or not runner.is_healthy():
            self._result(rid, "open", False, "remote engine unavailable")
            return
        chunks = sorted(asm.chunks, key=lambda c: c.index)

        def _done(ok: bool, err: Optional[str]) -> None:
            self._result(rid, "open", ok, err)  # a runner thread: enqueue

        runner.submit_import_open(rid, header.get("prefix_pages", 0), chunks,
                                  _done)

    def _on_state(self, obj: Dict[str, Any]) -> None:
        """The KvHandoff frame that ends a commit or resume stream: rebuild
        the ``SequenceExport``, make a local request whose sink streams
        FleetEvents back, and hand both to the target runner."""
        from distributed_inference_server_tpu_torch.serving.runner import (
            ServerRequest,
        )

        rid = obj.get("request_id", "")
        # only this reader resolves assemblies: if the submit dies, the
        # wire dies with it and the host settles the stream through that
        asm = self._assemblies.pop(rid, None)
        if asm is None:
            return  # a state frame without a header: a torn stream
        header = asm.header
        op = header.get("op", "")
        engine_id = header.get("engine_id", "")
        runner = self._runner(engine_id)
        if runner is None or not runner.is_healthy():
            self._result(rid, op, False, "remote engine unavailable")
            return
        exp = _export_state_from_wire(obj)
        if asm.chunks:
            exp.kv_chunks = sorted(asm.chunks, key=lambda c: c.index)
            exp.wire_quant = header.get("wire_quant") or "none"
        sink = _DataEventSink(self, rid, engine_id)
        req = ServerRequest(rid,
                            [int(t) for t in exp.token_ids[:exp.prompt_len]],
                            exp.params, sink)
        # its first tokens streamed on the host: marking the first token
        # keeps the member's accounting from counting a second TTFT
        req.first_token_at = time.monotonic()

        def _done(ok: bool, err: Optional[str]) -> None:
            if ok and err != "aborted":
                with self._lock:
                    self._live[rid] = engine_id
            self._result(rid, op, ok, err if not ok else None)

        if op == "commit":
            runner.submit_import_commit(exp, req, _done)
        else:
            runner.submit_resume(exp, req, _done)

    def _on_fetch(self, obj: Dict[str, Any]) -> None:
        rid = obj.get("request_id", "")
        runner = self._runner(obj.get("engine_id", ""))
        if runner is None or not runner.is_healthy():
            self._result(rid, "fetch", False, "remote engine unavailable")
            return
        wire_quant = obj.get("wire_quant") or "none"

        def _done(result, err: Optional[str]) -> None:
            # the peer runner's thread: enqueue the response only
            if result is None:
                self._result(rid, "fetch", False, err)
                return
            depth, chunks = result
            self.enqueue("KvHandoffHeader", {
                "handoff_id": rid, "request_id": rid,
                "wire_quant": wire_quant, "op": "fetch",
                "total_chunks": len(chunks),
            })
            for c in chunks:
                self.enqueue("KvChunk", chunk_to_wire(rid, c))
            self._result(rid, "fetch", True, depth=depth)

        runner.submit_prefix_export(rid, list(obj.get("hashes", [])),
                                    obj.get("chunk_pages", 0) or 8,
                                    wire_quant, _done)

    def _on_abort(self, obj: Dict[str, Any]) -> None:
        rid = obj.get("stream_id", "")
        runner = self._runner(obj.get("engine_id", ""))
        if runner is not None:
            runner.submit_import_abort(rid)
        self._assemblies.pop(rid, None)

    def close(self, reason: str) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            live = dict(self._live)
            self._live.clear()
        # shut down first: our own reader blocked in recv would defer the
        # FIN of a bare close, and the host would never see the death
        close_socket(self.sock)
        # stop the writer without blocking: the queue may be full (a
        # wedged writer is one way here) and a plain put would deadlock
        # the runner thread whose enqueue closed us. Drop the stale frames
        # and offer the sentinel; if it does not fit, the writer is
        # mid-send and exits on the shutdown above.
        while True:
            try:
                self._out.get_nowait()
            except queue.Empty:
                break
        try:
            self._out.put_nowait(None)
        except queue.Full:
            pass
        # the host went away mid-decode: abort the orphans (nobody reads
        # their tokens; the host's channel death already failed them)
        for rid, engine_id in live.items():
            runner = self._runner(engine_id)
            if runner is not None:
                try:
                    runner.abort(rid)
                except Exception as e:  # noqa: BLE001 — cleanup isolation
                    logger.debug("kv peer %s: orphan abort failed: %s",
                                 self.peer, e)
        self.server._drop_conn(self)


class KvDataServer:
    """The member's KV data listener (started by the ``FleetWorker``; its
    bound port rides every heartbeat). Serves export and import streams
    on the member's local runners through its scheduler."""

    def __init__(self, scheduler, host: str = "0.0.0.0", port: int = 0,
                 metrics: Optional[MetricsCollector] = None):
        self.scheduler = scheduler
        self.metrics = metrics
        self._host = host
        self._port = port
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._conns: List[_KvPeerConn] = []
        self._lock = threading.Lock()
        self._stopping = False
        self.bound_port = 0

    def start(self) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self._host, self._port))
        sock.listen(8)
        self._sock = sock
        self.bound_port = sock.getsockname()[1]
        self._stopping = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="kv-data-accept", daemon=True)
        self._thread.start()
        logger.info("kv data listener on %s:%d", self._host, self.bound_port)

    def stop(self) -> None:
        self._stopping = True
        if self._sock is not None:
            close_socket(self._sock)  # wakes the accept
            self._sock = None
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.close("kv data server stopping")
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def _accept_loop(self) -> None:
        listener = self._sock
        while not self._stopping:
            try:
                sock, addr = listener.accept()
            except OSError:
                return  # the listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _KvPeerConn(self, sock, f"{addr[0]}:{addr[1]}")
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=conn.run,
                             name=f"kv-peer-read-{addr[0]}:{addr[1]}",
                             daemon=True).start()

    def _drop_conn(self, conn: _KvPeerConn) -> None:
        with self._lock:
            try:
                self._conns.remove(conn)
            except ValueError:
                pass
