"""Registry HA: a warm standby registry with lease-fenced failover (the
port of ``distributed_inference_server_tpu/serving/fleet_ha.py``).

``fleet.registries`` names an ordered list of registry endpoints. Every
member heartbeats all of them (``serving/remote_runner.py``), and the
registries beat each other over the same fleet wire to elect one primary:

**Dual heartbeat.** A member keeps one fleet connection per registry and
ships heartbeats, telemetry and spans to each, so every registry holds a
live member table, its ``RemoteRunner`` proxies and the learned wire
rates at all times. A standby's takeover re-arms nothing of the data
path: it never went cold.

**Lease and epoch.** The primary sends a ``RegistryLease`` beat (frame
kind 7) to every peer each tick; standbys answer with ``RegistryState``
(kind 8). A standby ages the primary's lease through the member-aging
machinery (an embedded ``FleetRegistry`` with ``lease_suspect_s`` and
``lease_s`` as its windows) and promotes itself when the lease dies, at
a bumped epoch. Every control frame a registry sends (submits, aborts,
intros) carries its epoch, and members accept control only from the
highest epoch they have seen: a partitioned old primary's submits bounce
as ``worker_failure`` (redispatched on its own side), and once it sees
the higher epoch it steps down. Ties at one epoch go to the lower list
index, and a standby promotes only when no fresh lower-index peer is
visible, so a cold-started cluster elects ``registries[0]``.

**Ingress.** Every registry serves HTTP on its own federated view, and
members serve submits from any registry wire, answering on the wire the
submit came in on. ``fleet.standby_http=false`` closes a standby's front
door (the dispatcher turns ingress away as ``QueueFull``) until it holds
the lease.

Fault points: ``fleet.lease_beat`` drops registry-to-registry lease beats
before the wire (the partition; ``prob=1.0`` makes a split brain without
killing anyone); ``fleet.takeover`` crashes a standby at the start of a
promotion, before any state changed, so the next tick retries it.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving.fleet import (
    MEMBER_DEAD,
    FleetRegistry,
    FleetSettings,
    FleetWireError,
    close_socket,
    parse_connect,
    send_frame,
)
from distributed_inference_server_tpu_torch.serving.metrics import (
    MetricsCollector,
)

logger = logging.getLogger(__name__)

ROLE_PRIMARY = "primary"
ROLE_STANDBY = "standby"


class _PeerLink:
    """One outbound registry->registry wire, send-only. The peer's
    member listener accepts it like any member connection; our lease /
    state frames route to its HA module via ``on_registry_frame`` (the
    session never claims a member id, so peer wires cannot fabricate
    fleet members). Send-only on purpose: the peer's frames to US
    arrive on OUR listener the same way, so neither side ever blocks a
    tick reading. Dials lazily with per-link backoff — a dead peer
    costs one failed send per tick, never a stall."""

    def __init__(self, endpoint: str, dial_timeout_s: float = 1.0):
        self.endpoint = endpoint
        self.host, self.port = parse_connect(endpoint)
        self.dial_timeout_s = dial_timeout_s
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._backoff_s = 0.25
        self._next_dial = 0.0

    def send(self, name: str, obj: Dict[str, Any]) -> bool:
        """Best-effort frame send; False = not delivered (dead peer in
        dial backoff, or the write failed and the wire was dropped).
        Only the HA tick thread calls this; ``close`` (stop path) joins
        that thread first, so the dial below never races a close."""
        with self._lock:
            sock = self._sock
            if sock is None and time.monotonic() < self._next_dial:
                return False
        if sock is None:
            try:
                # short-timeout dial on the HA tick thread, outside the
                # lock: bounded by dial_timeout_s, one peer set deep
                sock = socket.create_connection(
                    (self.host, self.port), timeout=self.dial_timeout_s)
            except OSError:
                with self._lock:
                    self._next_dial = time.monotonic() + self._backoff_s
                    self._backoff_s = min(self._backoff_s * 2, 2.0)
                return False
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                sock.close()
                return False
            with self._lock:
                self._backoff_s = 0.25
                self._sock = sock
        try:
            send_frame(sock, name, obj)
            return True
        except (OSError, FleetWireError):
            close_socket(sock)
            with self._lock:
                if self._sock is sock:
                    self._sock = None
            return False

    def connected(self) -> bool:
        with self._lock:
            return self._sock is not None

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                close_socket(self._sock)
                self._sock = None


class RegistryHA:
    """The per-registry HA state machine: role, epoch, the lease watch,
    and the registry<->registry beat loop. Owned by the server when
    ``fleet.registries`` is configured; the FleetServer routes inbound
    peer frames here (``on_peer_frame``) and reads ``epoch`` /
    ``is_primary`` for control-frame stamping and primary-only gates.

    Every registry BOOTS as standby — including a restarted old
    primary, which therefore rejoins fenced (epoch 0 < cluster epoch)
    and only ever re-promotes by winning a real election. ``start`` /
    ``stop`` are restartable and reset all election state, modeling a
    process restart."""

    def __init__(
        self,
        fleet_server,
        settings: Optional[FleetSettings] = None,
        metrics: Optional[MetricsCollector] = None,
        recorder=None,
    ):
        self.fleet_server = fleet_server
        self.settings = settings or FleetSettings()
        self.metrics = metrics
        self.recorder = recorder
        self.registry_id = ""
        self.role = ROLE_STANDBY
        self.epoch = 0
        self._index = len(self.settings.registries)
        self._endpoint_index: Dict[str, int] = {}
        self._seq = 0
        self._lease_holder: Optional[str] = None
        self._lease_rx_at = time.monotonic()
        self._peers: List[_PeerLink] = []
        # peer registry id -> {role, epoch, at, index}: the freshest
        # frame seen from each peer (any kind), for election deferral
        # and the /server/stats registry block
        self._peer_states: Dict[str, Dict[str, Any]] = {}
        self._takeovers: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the lease watch: the member-aging machinery applied to the
        # primary itself — a private FleetRegistry whose only
        # member is the current lease holder, aged alive -> suspect
        # (lease_suspect_s) -> dead (lease_s) by our own tick
        self._lease_watch = FleetRegistry(FleetSettings(
            heartbeat_interval_s=self.settings.heartbeat_interval_s,
            suspect_after_s=self.settings.lease_suspect_s,
            dead_after_s=self.settings.lease_s,
        ))

    # -- lifecycle ---------------------------------------------------------

    def start(self, self_endpoint: str) -> None:
        """Begin the beat loop. ``self_endpoint`` is this registry's
        fleet listener as "host:port" (the BOUND port — known only
        after FleetServer.start). Matched against fleet.registries to
        find our election priority; an endpoint not on the list still
        works, at the lowest priority."""
        if self._thread is not None:
            return
        me = parse_connect(self_endpoint)
        endpoints = list(self.settings.registries)
        with self._lock:
            # a (re)start models a process restart: all election state
            # resets, and the cluster epoch is re-learned from peers
            self.registry_id = self_endpoint
            self.role = ROLE_STANDBY
            self.epoch = 0
            self._seq = 0
            self._lease_holder = None
            self._lease_rx_at = time.monotonic()
            self._peer_states.clear()
            self._takeovers.clear()
            self._index = len(endpoints)
            self._endpoint_index = {ep: i for i, ep in enumerate(endpoints)}
            peers = []
            for i, ep in enumerate(endpoints):
                if parse_connect(ep) == me:
                    self._index = i
                    self.registry_id = ep  # canonical config-list form
                else:
                    peers.append(_PeerLink(ep))
            self._peers = peers
        self._lease_watch = FleetRegistry(FleetSettings(
            heartbeat_interval_s=self.settings.heartbeat_interval_s,
            suspect_after_s=self.settings.lease_suspect_s,
            dead_after_s=self.settings.lease_s,
        ))
        self._publish()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-ha", daemon=True
        )
        self._thread.start()
        logger.info("registry HA %s: standby (priority %d of %d)",
                    self.registry_id, self._index, len(endpoints))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        for link in self._peers:
            link.close()

    def _loop(self) -> None:
        while not self._stop.wait(self.settings.heartbeat_interval_s):
            try:
                self._tick()
            except faults.InjectedFault:
                # fleet.takeover: crashed mid-promotion. The fault
                # fires BEFORE any state changes, so nothing to unwind
                # — the standby simply retries next tick
                logger.warning("registry HA %s: injected takeover crash; "
                               "retrying", self.registry_id)
            except Exception:  # noqa: BLE001 — the beat loop must live
                logger.exception("registry HA tick failed; retrying")

    # -- the beat (tick thread) --------------------------------------------

    def _tick(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self.role == ROLE_PRIMARY:
            with self._lock:
                self._seq += 1
                frame = {"registry_id": self.registry_id,
                         "epoch": self.epoch, "seq": self._seq,
                         "role": ROLE_PRIMARY}
            for link in self._peers:
                try:
                    # the injected registry<->registry partition
                    # (fleet.lease_beat): the beat is dropped before the
                    # wire, per peer and per tick
                    faults.fire("fleet.lease_beat")
                except faults.InjectedFault:
                    continue
                link.send("RegistryLease", frame)
        else:
            with self._lock:
                frame = {"registry_id": self.registry_id,
                         "epoch": self.epoch, "role": ROLE_STANDBY}
            for link in self._peers:
                link.send("RegistryState", frame)
            self._lease_watch.sweep(now)
            self._maybe_promote(now)

    def _lease_expired(self, now: float) -> bool:
        with self._lock:
            holder = self._lease_holder
            rx_at = self._lease_rx_at
        if holder is None:
            # never held since (re)start: the boot grace is one full
            # lease window, so a healthy primary always beats first
            return now - rx_at > self.settings.lease_s
        state = self._lease_watch.member_state(holder)
        return state is None or state == MEMBER_DEAD

    def _maybe_promote(self, now: float) -> None:
        if not self._lease_expired(now):
            return
        with self._lock:
            # election deferral: a FRESH lower-index peer (frame seen
            # within one lease window) outranks us — it will promote;
            # if it's actually dead its frames age out and we stop
            # deferring. registries[0] defers to nobody.
            for st in self._peer_states.values():
                if (st["index"] < self._index
                        and now - st["at"] <= self.settings.lease_s):
                    return
        self._promote("lease_expired")

    def _promote(self, reason: str) -> None:
        # the injected mid-promotion crash (fleet.takeover) fires BEFORE
        # any state changes: promotion is atomic-or-absent, and the next
        # tick retries it
        faults.fire("fleet.takeover")
        with self._lock:
            peer_max = max(
                (st.get("epoch", 0) for st in self._peer_states.values()),
                default=0)
            self.epoch = max(self.epoch, peer_max) + 1
            self.role = ROLE_PRIMARY
            self._lease_holder = None
            self._seq = 0
            self._takeovers[reason] = self._takeovers.get(reason, 0) + 1
            epoch = self.epoch
        logger.warning("registry HA %s: PROMOTED to primary (epoch %d, "
                       "%s)", self.registry_id, epoch, reason)
        self._publish()
        if self.metrics is not None:
            self.metrics.record_registry_takeover(reason)
        if self.recorder is not None:
            self.recorder.note_global("registry_takeover", reason=reason,
                                      epoch=epoch)
        # re-arm the primary-only machinery from our already-warm
        # state: re-broker every known mesh endpoint at the NEW epoch
        # (admission, routing, and the event pump were never gated)
        self.fleet_server.on_ha_promote()

    def _demote_locked(self, peer_epoch: int, reason: str) -> int:
        """Fencing: a higher epoch (or a same-epoch, higher-priority
        primary) exists — step down. Caller holds ``_lock``; returns
        the new epoch (0 = no demotion happened)."""
        self.epoch = max(self.epoch, peer_epoch)
        self.role = ROLE_STANDBY
        self._takeovers[reason] = self._takeovers.get(reason, 0) + 1
        return self.epoch

    # -- inbound peer frames (member-session reader threads) ---------------

    def on_peer_frame(self, name: str, obj: Dict[str, Any]) -> None:
        """One RegistryLease / RegistryState frame from a peer registry
        (routed here by FleetServer.on_registry_frame)."""
        rid = obj.get("registry_id", "")
        if not rid or rid == self.registry_id:
            return
        epoch = int(obj.get("epoch") or 0)
        role = obj.get("role", "")
        now = time.monotonic()
        accepted = False
        demoted = 0
        with self._lock:
            idx = self._endpoint_index.get(rid, len(self._endpoint_index))
            self._peer_states[rid] = {"role": role, "epoch": epoch,
                                      "at": now, "index": idx}
            if name == "RegistryLease":
                if self.role == ROLE_PRIMARY and (
                        epoch > self.epoch
                        or (epoch == self.epoch and idx < self._index)):
                    # fenced: a newer (or same-epoch, higher-priority)
                    # primary exists — we were the partitioned one
                    demoted = self._demote_locked(epoch, "fenced")
                if self.role == ROLE_STANDBY and epoch >= self.epoch:
                    # accept the lease (possibly the one that just
                    # fenced us): refresh the watch and learn the epoch
                    self.epoch = epoch
                    self._lease_holder = rid
                    self._lease_rx_at = now
                    accepted = True
                # a STALE lease (epoch < ours) is ignored entirely: the
                # old primary demotes when our frames reach it
            else:  # RegistryState
                if epoch > self.epoch:
                    if self.role == ROLE_PRIMARY:
                        # a standby already saw a newer primary than us
                        demoted = self._demote_locked(epoch, "fenced")
                    else:
                        self.epoch = epoch
        if accepted:
            # the lease watch is the member-aging machinery verbatim:
            # each accepted beat is an observe(), our tick sweeps
            self._lease_watch.observe(rid, [])
        if demoted:
            logger.warning("registry HA %s: FENCED by %s — demoted to "
                           "standby (epoch %d)", self.registry_id, rid,
                           demoted)
            self._publish()
            if self.metrics is not None:
                self.metrics.record_registry_takeover("fenced")
            if self.recorder is not None:
                self.recorder.note_global("registry_fenced", peer=rid,
                                          epoch=demoted)

    # -- reads (any thread) ------------------------------------------------

    def is_primary(self) -> bool:
        return self.role == ROLE_PRIMARY

    def _publish(self) -> None:
        if self.metrics is not None:
            self.metrics.set_registry_role(self.role)
            self.metrics.set_registry_epoch(self.epoch)

    def stats(self) -> Dict[str, Any]:
        """The ``registry`` block of ``/server/stats``: role, epoch,
        lease age + holder state, peer-registry views, and takeover
        counts."""
        now = time.monotonic()
        with self._lock:
            holder = self._lease_holder
            peers = {
                rid: {"role": st["role"], "epoch": st["epoch"],
                      "age_s": round(now - st["at"], 3)}
                for rid, st in sorted(self._peer_states.items())
            }
            out = {
                "registry_id": self.registry_id,
                "role": self.role,
                "epoch": self.epoch,
                "lease": {
                    "holder": holder,
                    "age_s": round(now - self._lease_rx_at, 3),
                },
                "peers": peers,
                "takeovers": dict(self._takeovers),
            }
        out["lease"]["state"] = (
            self._lease_watch.member_state(holder) if holder else None)
        return out
