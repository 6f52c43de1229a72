"""The fleet's control plane: the federated engine registry, the fleet wire
and role rebalancing (the port of ``distributed_inference_server_tpu/
serving/fleet.py``, without its KV data plane, KV mesh and registry HA).

- **The fleet wire**: one duplex TCP connection per member carrying
  length-delimited protowire frames (a u32 payload length, a u8 kind, the
  encoded message), byte for byte the JAX package's. ``FleetHeartbeat``,
  ``FleetEvent``, ``FleetSpans`` and ``FleetTelemetry`` flow member to
  registry host, ``FleetSubmit`` flows back. The kinds of the KV mesh and
  registry HA (``KvIntro``, ``RegistryLease``, ``RegistryState``) are not
  known here: a frame of theirs is a ``FleetWireError``, which ends the
  session.
- **FleetRegistry**: membership. A member joins by heartbeating its
  replicas' ``EngineStatus`` (digests included); missed beats age it
  ``alive -> suspect -> dead``, and a dead member is pruned after
  ``dead_retention_s``.
- **FleetServer**: the registry host's listener, one reader thread per
  member session. Each heartbeat registers or refreshes one
  ``RemoteRunner`` proxy per remote engine (``serving/remote_runner.py``)
  in the scheduler, so the dispatch spine routes remote replicas like
  local ones. Member spans merge into the host's tracer; member telemetry
  frames feed ``/server/perf`` and the health scorer's per-member latency
  comparison.
- **RoleBalancer**: flips a local ``unified`` engine to ``prefill`` when
  queued and waiting prompts per admission replica pass
  ``fleet.rerole_high_ratio``, and back below ``fleet.rerole_low_ratio``,
  at most one flip per ``fleet.rerole_cooldown_s``. It restores only the
  engines it flipped and never flips a remote proxy.

A dead member's proxies map its death onto the crash-safe redispatch
path: zero-token requests move to a healthy replica exactly once,
mid-stream ones fail as ``engine_crashed``. Fault points:
``fleet.heartbeat`` (the registry drops a beat: the partition model),
``fleet.submit`` (a forwarded submit dies on the wire, or the member
crashes on receipt), ``sched.rerole`` (flag: force the rebalance signal
high for one evaluation).
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from distributed_inference_server_tpu_torch.core.errors import ConfigError
from distributed_inference_server_tpu_torch.serving import faults, protowire
from distributed_inference_server_tpu_torch.serving.metrics import (
    EngineStatus,
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.utils.tracing import Span

logger = logging.getLogger(__name__)

MEMBER_ALIVE = "alive"
MEMBER_SUSPECT = "suspect"
MEMBER_DEAD = "dead"
MEMBER_STATES = (MEMBER_ALIVE, MEMBER_SUSPECT, MEMBER_DEAD)


@dataclass(frozen=True)
class FleetSettings:
    """The control plane's knobs (config section ``fleet``; the keys of
    the KV data plane, the mesh and registry HA are not ported)."""

    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = 0  # the registry listener; 0 = an ephemeral port
    connect: str = ""  # worker mode: "host:port" of the registry host
    member_id: str = ""  # "" = hostname:pid
    heartbeat_interval_s: float = 0.5
    suspect_after_s: float = 2.0
    dead_after_s: float = 5.0
    rerole: bool = False
    rerole_high_ratio: float = 4.0
    rerole_low_ratio: float = 1.0
    rerole_cooldown_s: float = 10.0
    rerole_interval_s: float = 0.5
    # dead members stay visible this long, then leave the table (every
    # restarted worker mints a new hostname:pid identity)
    dead_retention_s: float = 300.0


# ---------------------------------------------------------------------------
# The fleet wire
# ---------------------------------------------------------------------------

FRAME_KINDS: Dict[int, str] = {
    1: "FleetHeartbeat",
    2: "FleetSubmit",
    3: "FleetEvent",
    4: "FleetSpans",
    5: "FleetTelemetry",
}
_KIND_BY_NAME = {name: kind for kind, name in FRAME_KINDS.items()}

#: a control frame is small; anything bigger is a torn or foreign stream
MAX_FRAME_BYTES = 16 * 1024 * 1024


class FleetWireError(RuntimeError):
    """A malformed frame (foreign protocol, torn stream, oversized or
    unknown kind). The session treats it as the member's death."""


def send_frame(sock: socket.socket, name: str, obj: Dict[str, Any]) -> None:
    """Encode ``obj`` as message ``name`` and write one frame. Callers
    serialize sends per socket (one lock per session)."""
    payload = protowire.encode(name, obj)
    sock.sendall(struct.pack(">IB", len(payload), _KIND_BY_NAME[name])
                 + payload)


def close_socket(sock: socket.socket) -> None:
    """Shut a socket down, then close it. The shutdown wakes a thread
    blocked in its ``recv`` or ``accept`` (a bare ``close`` from another
    thread leaves it blocked, and the peer sees no EOF)."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None  # orderly EOF
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Optional[Tuple[str, Dict[str, Any]]]:
    """Read one frame: ``(message_name, decoded_dict)``, or None at EOF.
    Raises ``FleetWireError`` on a malformed frame."""
    header = _recv_exact(sock, 5)
    if header is None:
        return None
    length, kind = struct.unpack(">IB", header)
    name = FRAME_KINDS.get(kind)
    if name is None or length > MAX_FRAME_BYTES:
        raise FleetWireError(f"bad fleet frame (kind={kind}, len={length})")
    payload = _recv_exact(sock, length)
    if payload is None:
        return None
    try:
        return name, protowire.decode(name, payload)
    except Exception as e:  # noqa: BLE001 — the wire's fault domain
        raise FleetWireError(f"undecodable {name} frame: {e}") from e


def status_to_wire(s: EngineStatus) -> Dict[str, Any]:
    """EngineStatus -> its FleetHeartbeat dict (the digest travels, so the
    registry host scores remote prefix matches)."""
    host = s.host_tier or {}
    return {
        "engine_id": s.engine_id,
        "healthy": s.healthy,
        "active_requests": s.active_requests,
        "waiting_requests": s.waiting_requests,
        "total_processed": s.total_processed,
        "memory_used_pages": s.memory_used_pages,
        "memory_total_pages": s.memory_total_pages,
        "role": s.role or "unified",
        "pages_cached": s.pages_cached,
        "prefix_digest": sorted(int(h) for h in (s.prefix_digest or ())),
        "page_size": s.page_size,
        "digest_depth": s.digest_depth,
        "host_tier_bytes": host.get("bytes", 0),
        "host_tier_pages": host.get("pages", 0),
    }


def status_from_wire(d: Dict[str, Any], member_id: str) -> EngineStatus:
    """A heartbeat's engine dict -> EngineStatus under the proxy id the
    scheduler routes on, ``<member>:<engine>``."""
    host = None
    if d.get("host_tier_bytes") or d.get("host_tier_pages"):
        host = {"bytes": d.get("host_tier_bytes", 0),
                "pages": d.get("host_tier_pages", 0), "hit_pages": 0}
    return EngineStatus(
        engine_id=f"{member_id}:{d.get('engine_id', '')}",
        healthy=bool(d.get("healthy")),
        active_requests=d.get("active_requests", 0),
        waiting_requests=d.get("waiting_requests", 0),
        total_processed=d.get("total_processed", 0),
        memory_used_pages=d.get("memory_used_pages", 0),
        memory_total_pages=d.get("memory_total_pages", 0),
        pages_cached=d.get("pages_cached", 0),
        role=d.get("role") or "unified",
        prefix_digest=frozenset(d.get("prefix_digest") or ()),
        page_size=d.get("page_size", 0),
        digest_depth=d.get("digest_depth", 0),
        host_tier=host,
        remote=True,
    )


def _attrs_to_json(attrs: Dict[str, Any]) -> str:
    if not attrs:
        return ""
    try:
        return json.dumps(attrs, default=str)
    except (TypeError, ValueError):
        return json.dumps({k: str(v) for k, v in attrs.items()})


def _attrs_from_json(blob: str) -> Dict[str, Any]:
    if not blob:
        return {}
    try:
        obj = json.loads(blob)
        return obj if isinstance(obj, dict) else {}
    except ValueError:
        return {}


def span_to_wire(s: Span, epoch_offset_ns: int) -> Dict[str, Any]:
    """Span -> TraceSpan dict. Times go out as epoch ns
    (``epoch_offset_ns`` = the sender's ``time_ns() - monotonic_ns()``),
    so the receiver re-bases them into its own monotonic clock; what is
    left is the hosts' wall-clock skew."""
    start = s.start_ns + epoch_offset_ns
    return {
        "name": s.name,
        "trace_id": s.trace_id,
        "span_id": s.span_id,
        "parent_id": s.parent_id or "",
        "start_unix_ns": max(0, start),
        "duration_ns": max(0, (s.end_ns or s.start_ns) - s.start_ns),
        "status": s.status or "ok",
        "attrs_json": _attrs_to_json(s.attributes),
        "events": [
            {"offset_ns": max(0, t - s.start_ns), "name": n,
             "attrs_json": _attrs_to_json(a)}
            for t, n, a in s.events
        ],
    }


def span_from_wire(d: Dict[str, Any], epoch_offset_ns: int,
                   member_id: str = "") -> Span:
    """TraceSpan dict -> Span in the receiver's monotonic clock, with a
    ``member`` attribute naming the process it ran in."""
    start = max(0, d.get("start_unix_ns", 0) - epoch_offset_ns)
    duration = max(0, d.get("duration_ns", 0))
    attrs = _attrs_from_json(d.get("attrs_json", ""))
    if member_id:
        attrs.setdefault("member", member_id)
    return Span(
        name=d.get("name", ""),
        trace_id=d.get("trace_id", ""),
        span_id=d.get("span_id", ""),
        parent_id=d.get("parent_id") or None,
        start_ns=start,
        end_ns=start + duration,
        attributes=attrs,
        events=[
            (start + e.get("offset_ns", 0), e.get("name", ""),
             _attrs_from_json(e.get("attrs_json", "")))
            for e in d.get("events", [])
        ],
        status=d.get("status") or "ok",
    )


def parse_connect(connect: str) -> Tuple[str, int]:
    """Parse a ``host:port`` endpoint (``fleet.connect``)."""
    host, sep, port = connect.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ConfigError(
            f"fleet.connect must be host:port, got {connect!r}"
        )
    return host, int(port)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


@dataclass
class FleetMember:
    """One worker process as the registry sees it (mutated under the
    registry's lock; ``snapshot()`` hands out copies)."""

    member_id: str
    state: str = MEMBER_ALIVE
    last_beat: float = field(default_factory=time.monotonic)
    beats: int = 0
    engines: List[EngineStatus] = field(default_factory=list)

    def snapshot(self, now: float) -> Dict[str, Any]:
        return {
            "member_id": self.member_id,
            "state": self.state,
            "last_beat_age_s": round(now - self.last_beat, 3),
            "beats": self.beats,
            "engines": {s.engine_id: s.role for s in self.engines},
        }


class FleetRegistry:
    """Heartbeat ingest and the alive/suspect/dead state machine.
    Thread-safe: beats arrive on session reader threads, the sweeper ages
    members, routing reads from the dispatcher. State-change callbacks
    run outside the lock (they unregister runners and fail requests)."""

    def __init__(
        self,
        settings: Optional[FleetSettings] = None,
        metrics: Optional[MetricsCollector] = None,
        on_state_change: Optional[Callable[[str, str, str], None]] = None,
    ):
        self.settings = settings or FleetSettings()
        self.metrics = metrics
        self.on_state_change = on_state_change
        self._members: Dict[str, FleetMember] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def observe(self, member_id: str,
                engines: List[EngineStatus]) -> Optional[str]:
        """Ingest one heartbeat. Returns the member's previous state
        (``dead`` for a first join, which the session treats like a
        rejoin: fresh proxies), or None when the ``fleet.heartbeat`` fault
        dropped the beat (the wire delivered it, the registry never saw
        it)."""
        try:
            faults.fire("fleet.heartbeat")
        except faults.InjectedFault:
            if self.metrics:
                self.metrics.record_fleet_heartbeat("dropped")
            return None
        transition = None
        created = False
        with self._lock:
            member = self._members.get(member_id)
            if member is None:
                member = self._members[member_id] = FleetMember(member_id)
                created = True
                prev = MEMBER_DEAD
            else:
                prev = member.state
            member.last_beat = time.monotonic()
            member.beats += 1
            member.engines = list(engines)
            member.state = MEMBER_ALIVE
            # a first join revives nothing: no transition, counted "ok"
            if not created and prev != MEMBER_ALIVE:
                transition = (member_id, prev, MEMBER_ALIVE)
        if self.metrics:
            self.metrics.record_fleet_heartbeat(
                "rejoin" if transition else "ok")
            self._publish_gauge()
        if transition and self.on_state_change:
            self.on_state_change(*transition)
        return prev

    def disconnect(self, member_id: str) -> None:
        """The connection died: the member is dead now, without waiting
        out the suspect window (its requests must redispatch)."""
        self._transition(member_id, MEMBER_DEAD)

    def sweep(self, now: Optional[float] = None) -> List[Tuple[str, str, str]]:
        """Age members on missed beats (alive -> suspect after
        ``suspect_after_s``, suspect -> dead after ``dead_after_s``) and
        prune the dead past their retention. Returns the transitions."""
        now = time.monotonic() if now is None else now
        transitions: List[Tuple[str, str, str]] = []
        pruned = False
        with self._lock:
            for member in list(self._members.values()):
                age = now - member.last_beat
                if (member.state == MEMBER_ALIVE
                        and age > self.settings.suspect_after_s):
                    transitions.append(
                        (member.member_id, member.state, MEMBER_SUSPECT))
                    member.state = MEMBER_SUSPECT
                if (member.state == MEMBER_SUSPECT
                        and age > self.settings.dead_after_s):
                    transitions.append(
                        (member.member_id, member.state, MEMBER_DEAD))
                    member.state = MEMBER_DEAD
                if (member.state == MEMBER_DEAD
                        and age > (self.settings.dead_after_s
                                   + self.settings.dead_retention_s)):
                    del self._members[member.member_id]
                    pruned = True
        if (transitions or pruned) and self.metrics:
            self._publish_gauge()
        if self.on_state_change:
            for t in transitions:
                self.on_state_change(*t)
        return transitions

    def _transition(self, member_id: str, new_state: str) -> None:
        with self._lock:
            member = self._members.get(member_id)
            if member is None or member.state == new_state:
                return
            prev = member.state
            member.state = new_state
        if self.metrics:
            self._publish_gauge()
        if self.on_state_change:
            self.on_state_change(member_id, prev, new_state)

    def _publish_gauge(self) -> None:
        with self._lock:
            counts = {state: 0 for state in MEMBER_STATES}
            for member in self._members.values():
                counts[member.state] += 1
        self.metrics.set_fleet_members(counts)

    def member_state(self, member_id: str) -> Optional[str]:
        with self._lock:
            member = self._members.get(member_id)
            return member.state if member else None

    def members(self) -> List[Dict[str, Any]]:
        now = time.monotonic()
        with self._lock:
            return [m.snapshot(now) for m in self._members.values()]

    def stats(self) -> Dict[str, Any]:
        """The members (state, last-beat age, beats, engine roles) and the
        count per state, for the ``/server/stats`` fleet block."""
        members = self.members()
        counts = {state: 0 for state in MEMBER_STATES}
        for m in members:
            counts[m["state"]] += 1
        return {"members": members, "member_counts": counts}

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._sweep_loop, name="fleet-registry-sweep", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def _sweep_loop(self) -> None:
        # at heartbeat cadence: detection within one interval
        while not self._stop.wait(self.settings.heartbeat_interval_s):
            try:
                self.sweep()
            except Exception:  # noqa: BLE001 — the sweeper stays alive
                logger.exception("fleet registry sweep failed; retrying")


# ---------------------------------------------------------------------------
# The registry host's listener
# ---------------------------------------------------------------------------


class _MemberSession:
    """One accepted member connection. The reader thread owns the inbound
    half; sends (submits and aborts from the dispatcher and redispatch
    paths) are serialized by ``_send_lock``."""

    def __init__(self, server: "FleetServer", sock: socket.socket,
                 peer: str):
        self.server = server
        self.sock = sock
        self.peer = peer
        self.member_id: Optional[str] = None
        # member-local engine id -> RemoteRunner proxy; guarded by _lock
        self.runners: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._closed = False

    def send(self, name: str, obj: Dict[str, Any]) -> None:
        with self._send_lock:
            if self._closed:
                raise FleetWireError("member session closed")
            send_frame(self.sock, name, obj)

    def run(self) -> None:
        """The reader loop: what members send (heartbeats, events, spans,
        telemetry). A FleetSubmit only flows host to member; one arriving
        here is a confused peer and is ignored."""
        try:
            while True:
                frame = recv_frame(self.sock)
                if frame is None:
                    break
                name, obj = frame
                if name == "FleetHeartbeat":
                    self._on_heartbeat(obj)
                elif name == "FleetEvent":
                    self._on_event(obj)
                elif name == "FleetSpans":
                    # merged even from an aged-out member: a dying
                    # member's last spans are the ones a postmortem needs
                    self.server.ingest_spans(
                        obj, self.member_id or obj.get("member_id", ""))
                elif name == "FleetTelemetry":
                    self.server.ingest_telemetry(
                        obj, self.member_id or obj.get("member_id", ""))
        except (OSError, FleetWireError) as e:
            logger.debug("fleet session %s reader ended: %s", self.peer, e)
        finally:
            self.close("fleet member connection lost")

    def _on_heartbeat(self, obj: Dict[str, Any]) -> None:
        member_id = obj.get("member_id") or self.peer
        if self.member_id is None:
            self.member_id = member_id
            superseded = self.server._claim_member(member_id, self)
            if superseded is not None:
                # a reconnect replaced a half-dead session: its proxies'
                # requests can get no more events; fail them, keep the
                # member
                superseded.detach_runners(
                    f"fleet member {member_id} reconnected on a new "
                    "session")
            logger.info("fleet member %s joined from %s", member_id,
                        self.peer)
        statuses = [status_from_wire(d, member_id)
                    for d in obj.get("engines", [])]
        prev = self.server.registry.observe(member_id, statuses)
        if prev is None:
            return  # dropped by the fleet.heartbeat fault: no refresh
        self.server._refresh_runners(self, obj.get("engines", []), statuses,
                                     rejoined=prev == MEMBER_DEAD)

    def _on_event(self, obj: Dict[str, Any]) -> None:
        with self._lock:
            runner = self.runners.get(obj.get("engine_id", ""))
        if runner is not None:
            runner.on_event(obj)

    def detach_runners(self, message: str) -> None:
        """Unregister this member's proxies and fail their requests onto
        the redispatch path, in two phases: every proxy leaves the
        routing set before any request is failed, so a redispatch cannot
        land on a dead sibling of the same member."""
        with self._lock:
            runners = list(self.runners.values())
            self.runners.clear()
        for runner in runners:
            # identity-checked: a reconnect's fresh proxy under the same
            # id survives this session's late detach
            self.server.scheduler.unregister_if(runner.engine_id, runner)
            runner.mark_detached(message)
        for runner in runners:
            runner.fail_inflight(message)

    def close(self, reason: str) -> None:
        with self._send_lock:
            if self._closed:
                return
            self._closed = True
            close_socket(self.sock)
        member = self.member_id
        logger.info("fleet session %s (%s) closed: %s", self.peer,
                    member or "pre-join", reason)
        self.detach_runners(reason)
        if member is not None and self.server._is_current(member, self):
            # only the member's current session's death kills it
            self.server.registry.disconnect(member)
        self.server._drop_session(self)


class FleetServer:
    """The registry host's listener: accepts member connections, feeds
    their heartbeats to the registry, and keeps one ``RemoteRunner`` per
    remote engine registered in the scheduler."""

    def __init__(
        self,
        registry: FleetRegistry,
        scheduler,
        settings: Optional[FleetSettings] = None,
        metrics: Optional[MetricsCollector] = None,
        redispatch: Optional[Callable] = None,
        tracer=None,
        recorder=None,
    ):
        """``redispatch``: the dispatcher's, for the proxies' zero-token
        requests. ``tracer``: the host's ``Tracer``; member spans merge
        into it, one stitched trace per request. ``recorder``: the host's
        ``FlightRecorder``; the proxies note remote token and terminal
        events into its timelines."""
        self.registry = registry
        self.scheduler = scheduler
        self.settings = settings or FleetSettings()
        self.metrics = metrics
        self.redispatch = redispatch
        self.tracer = tracer
        self.recorder = recorder
        # re-bases ingested spans from epoch ns into this monotonic clock
        self._epoch_offset_ns = time.time_ns() - time.monotonic_ns()
        self._sessions: List[_MemberSession] = []
        # member id -> its current session: a superseded session's late
        # EOF neither kills the member nor detaches the new proxies
        self._by_member: Dict[str, _MemberSession] = {}
        # member id -> its last FleetTelemetry frame; guarded by _lock,
        # pruned by age
        self._telemetry: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self.bound_port: int = 0
        registry.on_state_change = self._on_member_state

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.settings.host, self.settings.port))
        sock.listen(16)
        self._sock = sock
        self.bound_port = sock.getsockname()[1]
        self._stopping = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="fleet-accept", daemon=True)
        self._thread.start()
        self.registry.start()
        logger.info("fleet registry listening on %s:%d", self.settings.host,
                    self.bound_port)

    def stop(self) -> None:
        self._stopping = True
        self.registry.stop()
        if self._sock is not None:
            close_socket(self._sock)
            self._sock = None
        with self._lock:
            sessions = list(self._sessions)
        for session in sessions:
            session.close("fleet server shutting down")
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return  # the listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            session = _MemberSession(self, conn, f"{addr[0]}:{addr[1]}")
            with self._lock:
                self._sessions.append(session)
            threading.Thread(
                target=session.run,
                name=f"fleet-session-{addr[0]}:{addr[1]}", daemon=True,
            ).start()

    def _claim_member(self, member_id: str,
                      session: _MemberSession) -> Optional[_MemberSession]:
        """Make ``session`` the member's current one; returns the session
        it superseded (a reconnect), if any."""
        with self._lock:
            prev = self._by_member.get(member_id)
            self._by_member[member_id] = session
            return prev if prev is not session else None

    def _is_current(self, member_id: str, session: _MemberSession) -> bool:
        with self._lock:
            return self._by_member.get(member_id) is session

    def _drop_session(self, session: _MemberSession) -> None:
        with self._lock:
            try:
                self._sessions.remove(session)
            except ValueError:
                pass
            if (session.member_id is not None
                    and self._by_member.get(session.member_id) is session):
                self._by_member.pop(session.member_id, None)

    # -- span ingest (session reader threads) ------------------------------

    def ingest_spans(self, obj: Dict[str, Any], member_id: str) -> None:
        """Merge one FleetSpans frame into the host's tracer: each span is
        re-based into this clock, stamped with its member and exported
        through every sink with its trace, span and parent ids intact.
        Spans the member shed before shipping count as wire drops."""
        if self.tracer is None:
            return
        member = member_id or obj.get("member_id", "")
        dropped = obj.get("dropped", 0)
        if dropped:
            self.tracer.record_drop("wire", int(dropped))
        for d in obj.get("spans", []):
            try:
                self.tracer.ingest(
                    span_from_wire(d, self._epoch_offset_ns, member))
            except Exception:  # noqa: BLE001 — one bad span must not
                # drop its batch
                logger.debug("undecodable remote span from %s", member,
                             exc_info=True)
                self.tracer.record_drop("wire")

    # -- telemetry ingest (session reader threads) --------------------------

    def ingest_telemetry(self, obj: Dict[str, Any], member_id: str) -> None:
        """Keep one FleetTelemetry frame per member (digests are
        cumulative windows, so the last frame is exact) and publish the
        ``fleet_member_*{member}`` series: step-clock tokens per dispatch
        kind and the windowed TTFT p99. Digests whose ``epoch_s`` differs
        from this host's are dropped with a warning: their epoch indices
        count another time unit."""
        from distributed_inference_server_tpu_torch.serving import teledigest

        member = member_id or obj.get("member_id", "")
        if not member:
            return
        digests = {d.get("name", ""): d for d in obj.get("digests", [])
                   if d.get("name")}
        foreign: List[str] = []
        if self.metrics is not None:
            local_epoch_s = self.metrics.perf_epoch_s()
            foreign = [n for n, d in digests.items()
                       if float(d.get("epoch_s", 0.0)) != local_epoch_s]
            if foreign:
                logger.warning(
                    "fleet telemetry from %s dropped %d digest(s) with "
                    "foreign epoch_s (member slo.epoch_s disagrees with "
                    "this host's %.3gs): %s", member, len(foreign),
                    local_epoch_s, sorted(foreign))
                for name in foreign:
                    del digests[name]
        counters = {c.get("name", ""): c.get("value", 0.0)
                    for c in obj.get("counters", []) if c.get("name")}
        now = time.monotonic()
        with self._lock:
            self._telemetry[member] = {"digests": digests,
                                       "counters": counters, "at": now}
            pruned = self._prune_telemetry_locked(now)
        self._drop_member_series(pruned)
        if self.metrics is None:
            return
        # one outcome per frame
        self.metrics.record_telemetry_frame(
            "epoch_mismatch" if foreign else "ingested")
        step_tokens: Dict[str, float] = {}
        for name, value in counters.items():
            parts = name.split(".")
            if parts[0] == "step" and len(parts) == 4 and parts[3] == "tokens":
                step_tokens[parts[2]] = step_tokens.get(parts[2], 0.0) + value
        ttft_p99 = None
        ttft = digests.get("ttft_ms")
        if ttft is not None:
            ttft_p99 = teledigest.window_stats(
                ttft, self.metrics.perf_window_s()).get("p99")
        self.metrics.set_member_telemetry(member, step_tokens, ttft_p99)

    def _prune_telemetry_locked(self, now: float) -> List[str]:
        """Drop members silent past the dead-retention window; returns
        them (the caller drops their series outside the lock)."""
        horizon = self.settings.dead_after_s + self.settings.dead_retention_s
        stale = [m for m, v in self._telemetry.items()
                 if now - v["at"] > horizon]
        for member in stale:
            del self._telemetry[member]
        return stale

    def _drop_member_series(self, members: List[str]) -> None:
        if self.metrics is not None:
            for member in members:
                self.metrics.remove_member_telemetry(member)

    def telemetry_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per member, its last telemetry frame and its age: the
        ``fleet_members`` input of ``/server/perf`` and the health
        scorer's ``telemetry_fn``."""
        now = time.monotonic()
        with self._lock:
            pruned = self._prune_telemetry_locked(now)
            out = {
                member: {"digests": dict(v["digests"]),
                         "counters": dict(v["counters"]),
                         "age_s": now - v["at"]}
                for member, v in self._telemetry.items()
            }
        self._drop_member_series(pruned)
        return out

    # -- runner materialization (session reader threads) -------------------

    def _refresh_runners(self, session: _MemberSession,
                         wire_engines: List[Dict[str, Any]],
                         statuses: List[EngineStatus],
                         rejoined: bool) -> None:
        from distributed_inference_server_tpu_torch.serving.remote_runner \
            import RemoteRunner

        by_local_id = {d.get("engine_id", ""): s
                       for d, s in zip(wire_engines, statuses)}
        with session._lock:
            if session._closed:
                return
            stale = set(session.runners) - set(by_local_id)
            if rejoined:
                # dead -> alive: the death path detached the old proxies;
                # fresh ones own a clean in-flight map
                stale |= set(session.runners)
            gone = [(eid, session.runners.pop(eid)) for eid in stale]
            for local_id, status in by_local_id.items():
                runner = session.runners.get(local_id)
                if runner is None:
                    runner = RemoteRunner(
                        engine_id=status.engine_id, local_engine_id=local_id,
                        send=session.send, metrics=self.metrics,
                        recorder=self.recorder)
                    runner.redispatch = self.redispatch
                    session.runners[local_id] = runner
                    self.scheduler.register(runner)
                    logger.info("fleet: registered remote engine %s "
                                "(role=%s)", status.engine_id, status.role)
                elif self.scheduler.get(runner.engine_id) is not runner:
                    # something evicted our registration (a superseded
                    # session's late detach): heal it, or the engine takes
                    # no traffic while alive
                    self.scheduler.register(runner)
                runner.update_status(status)
        for _eid, runner in gone:
            self.scheduler.unregister_if(runner.engine_id, runner)
            runner.detach("remote engine left the member's heartbeat")

    # -- member state transitions (sweeper / reader threads) ---------------

    def _on_member_state(self, member_id: str, old: str, new: str) -> None:
        logger.warning("fleet member %s: %s -> %s", member_id, old, new)
        with self._lock:
            session = self._by_member.get(member_id)
        if session is None:
            return
        if new == MEMBER_DEAD:
            # zero-token requests move to healthy replicas exactly once,
            # mid-stream ones fail fast
            session.detach_runners(
                f"fleet member {member_id} dead (missed heartbeats)")
        elif new == MEMBER_SUSPECT or old == MEMBER_SUSPECT:
            # suspect leaves routing, suspect -> alive returns; dead ->
            # alive is the heartbeat path's (fresh proxies)
            with session._lock:
                runners = list(session.runners.values())
            for runner in runners:
                runner.set_member_state(new)


# ---------------------------------------------------------------------------
# Role rebalancing
# ---------------------------------------------------------------------------


class RoleBalancer:
    """Flips ``unified`` engines to ``prefill`` when the fleet's prompt
    queue deepens and back when it drains, with a signal band and a flip
    cooldown so an oscillating queue cannot flap roles. Only engines it
    flipped are restored; operator-configured roles are never
    rewritten."""

    def __init__(self, scheduler, dispatcher,
                 settings: Optional[FleetSettings] = None,
                 metrics: Optional[MetricsCollector] = None,
                 recorder=None):
        """``recorder``: role flips land in the flight recorder's global
        window, so a request's timeline shows a rerole during it."""
        self.scheduler = scheduler
        self.dispatcher = dispatcher
        self.settings = settings or FleetSettings()
        self.metrics = metrics
        self.recorder = recorder
        self._lock = threading.Lock()
        self._flipped: Dict[str, float] = {}  # engine id -> flip time
        self._last_flip = 0.0
        self._last_signal = 0.0
        self._history: Deque[Dict[str, Any]] = deque(maxlen=64)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def signal(self) -> float:
        """Prompt pressure: queued and engine-waiting prompts per healthy
        admission (prefill or unified) replica."""
        admission = [s for s in self.scheduler.statuses() if s.healthy
                     and s.role in ("prefill", "unified")]
        waiting = sum(s.waiting_requests for s in admission)
        depth = self.dispatcher.queue.total_depth()
        return (depth + waiting) / max(1, len(admission))

    def evaluate(self, now: Optional[float] = None) -> Optional[str]:
        """One decision: the flip applied ("to_prefill" / "to_unified") or
        None. At most one engine flips per evaluation, never within
        ``rerole_cooldown_s`` of the last flip."""
        if not self.settings.rerole:
            return None
        now = time.monotonic() if now is None else now
        # gates only the to_prefill direction (a restore must run with
        # the decode fleet gone); local decode only, since a remote
        # replica is no handoff target
        has_decode = any(
            s.healthy and s.role == "decode"
            and not getattr(s, "remote", False)
            for s in self.scheduler.statuses())
        sig = self.signal()
        if faults.flag("sched.rerole"):
            # the chaos lever: force the desire; band and cooldown still
            # bound the flips
            sig = max(sig, self.settings.rerole_high_ratio)
        direction = None
        with self._lock:
            self._last_signal = sig
            if now - self._last_flip < self.settings.rerole_cooldown_s:
                return None
            if sig >= self.settings.rerole_high_ratio and has_decode:
                runner = self._pick_unified()
                if runner is not None:
                    runner.set_role("prefill")
                    self._flipped[runner.engine_id] = now
                    direction = "to_prefill"
            elif sig <= self.settings.rerole_low_ratio and self._flipped:
                runner = self._pick_flipped_locked()
                if runner is not None:
                    runner.set_role("unified")
                    self._flipped.pop(runner.engine_id, None)
                    direction = "to_unified"
            if direction:
                self._last_flip = now
                self._history.append({
                    "engine_id": runner.engine_id, "direction": direction,
                    "signal": round(sig, 3), "t": round(time.time(), 3)})
        if direction:
            logger.info("fleet rerole %s (signal %.2f)", direction, sig)
            if self.recorder is not None:
                self.recorder.note_global("rerole", direction=direction,
                                          signal=round(sig, 3))
            if self.metrics:
                self.metrics.record_rerole(direction)
                self.metrics.set_engines_by_role(self._role_counts())
        return direction

    def _pick_unified(self):
        candidates = [r for r in self.scheduler.engines()
                      if r.role == "unified" and r.is_healthy()
                      and not getattr(r, "is_remote", False)]
        return min(candidates, key=lambda r: r.engine_id, default=None)

    def _pick_flipped_locked(self):
        for engine_id in sorted(self._flipped):
            runner = self.scheduler.get(engine_id)
            if runner is not None and runner.role == "prefill":
                return runner
            self._flipped.pop(engine_id, None)  # unregistered or re-roled
        return None

    def _role_counts(self) -> Dict[str, int]:
        # local replicas only, as the server's boot-time publisher counts
        counts: Dict[str, int] = {}
        for r in self.scheduler.engines():
            if not getattr(r, "is_remote", False):
                counts[r.role] = counts.get(r.role, 0) + 1
        return counts

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"signal": round(self._last_signal, 3),
                    "flipped": sorted(self._flipped),
                    "history": list(self._history)}

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-rerole", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.settings.rerole_interval_s):
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 — the balancer stays alive
                logger.exception("role rebalance evaluation failed")
