"""The member-to-member KV mesh and the learned wire prices (the port of
``distributed_inference_server_tpu/serving/fleet_mesh.py``).

**The mesh.** Without it every fleet KV byte passes through the registry
host, so a fetch between two members ends both bulk streams on one
machine. With ``fleet.mesh_enabled`` members dial each other's advertised
``data_port`` directly: the registry only introduces them, sending a
``KvIntro`` frame (member id, host, data port, stream grant) to every
member when an endpoint appears, changes or dies (``gone``).
``MeshClient`` (the member's side) turns intros into lazily dialed
``KvDataChannel`` peers, with the channel's stream window, backoff and
circuit breaker. The fetch instruction rides the control plane: the
registry adds a fetch hint to the ``FleetSubmit`` it sends anyway, and
the member pulls the prefix from its peer over its own channel.

**The prices.** ``WireRateEstimator`` learns a wire's transfer rate from
the bytes and seconds of its streams, in an epoch ring aligned to the
wall clock (the ``serving/teledigest.py`` windowing). ``MeshWireRates``
keys estimators by ``(src, dst)``: the registry's channels observe
locally, member-to-member wires reach the registry as cumulative
``kvwire|src|dst|{bytes,seconds,chunks}`` counters on the members'
telemetry frames. ``page_cost`` scales the configured
``fleet.kv_page_cost`` by ``prior_rate / learned_rate``: a cold wire
costs exactly the constant, a fast one less, a congested one more, so
``plan_route`` and the handoff election price the real wire. A wire
whose breaker is open never reaches pricing (``wire_available`` /
``EngineStatus.data_plane`` exclude it first).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: counter-name separator for the telemetry piggyback: member ids
#: contain "." and ":" (host:pid), so the kvwire counter names use "|"
#: — "kvwire|<src>|<dst>|bytes" splits unambiguously
WIRE_COUNTER_PREFIX = "kvwire|"

#: clamp band for a learned per-page cost: never free (a fetch always
#: beats recompute on a miraculously fast wire, but not infinitely so)
#: and never priced past certainly-lose (the option drops out anyway)
_MIN_PAGE_COST = 0.01
_MAX_PAGE_COST = 1000.0


class WireRateEstimator:
    """Windowed bytes-per-second estimator for one directed wire.

    A wall-clock-aligned epoch ring (the serving/teledigest.py
    windowing idiom): observations land in ``time // epoch_s`` buckets,
    buckets older than ``window_s`` are pruned, and the rate is the
    window's summed bytes over summed busy-seconds. ``rate()`` is None
    while the window is empty — the wire is COLD and the caller must
    fall back to its configured prior instead of trusting a stale or
    absent measurement. Thread-safe: observations arrive from channel
    reader threads, reads from the scheduler's routing path. ``now``
    is injectable so tests drive the window deterministically."""

    def __init__(self, window_s: float = 30.0, epochs: int = 8):
        self.window_s = max(float(window_s), 0.001)
        self.epoch_s = self.window_s / max(int(epochs), 1)
        self._lock = threading.Lock()
        # epoch index -> [bytes, seconds, chunks]
        self._buckets: Dict[int, List[float]] = {}
        self._total_bytes = 0
        self._total_chunks = 0

    def observe(self, nbytes: int, seconds: float, chunks: int = 0,
                now: Optional[float] = None) -> None:
        if nbytes <= 0 or seconds <= 0:
            return
        now = time.time() if now is None else now
        idx = int(now // self.epoch_s)
        with self._lock:
            b = self._buckets.setdefault(idx, [0, 0.0, 0])
            b[0] += int(nbytes)
            b[1] += float(seconds)
            b[2] += int(chunks)
            self._total_bytes += int(nbytes)
            self._total_chunks += int(chunks)
            self._prune_locked(idx)

    def _prune_locked(self, now_idx: int) -> None:
        horizon = now_idx - int(self.window_s // self.epoch_s)
        for idx in [i for i in self._buckets if i < horizon]:
            del self._buckets[idx]

    def rate(self, now: Optional[float] = None) -> Optional[float]:
        """Learned bytes/s over the live window, or None when cold
        (no observation young enough to trust)."""
        now = time.time() if now is None else now
        now_idx = int(now // self.epoch_s)
        with self._lock:
            self._prune_locked(now_idx)
            nbytes = sum(b[0] for b in self._buckets.values())
            seconds = sum(b[1] for b in self._buckets.values())
        if nbytes <= 0 or seconds <= 0:
            return None
        return nbytes / seconds

    def totals(self) -> Tuple[int, int]:
        """Lifetime (bytes, chunks) observed — window-independent, for
        the ``kv_wires`` stats table."""
        with self._lock:
            return self._total_bytes, self._total_chunks


class _WireHandle:
    """The per-wire estimator facade a ``KvDataChannel`` holds: same
    observe/rate surface as ``WireRateEstimator``, but observations
    route through the owning ``MeshWireRates`` so the gauge and the
    telemetry piggyback stay in step with every stream."""

    __slots__ = ("_rates", "src", "dst")

    def __init__(self, rates: "MeshWireRates", src: str, dst: str):
        self._rates = rates
        self.src = src
        self.dst = dst

    def observe(self, nbytes: int, seconds: float, chunks: int = 0,
                now: Optional[float] = None) -> None:
        self._rates.observe(self.src, self.dst, nbytes, seconds,
                            chunks=chunks, now=now)

    def rate(self, now: Optional[float] = None) -> Optional[float]:
        return self._rates.rate(self.src, self.dst, now=now)


class MeshWireRates:
    """Registry of learned transfer rates keyed by directed wire
    ``(src, dst)`` — member ids, or ``"registry"`` for the host's own
    channels. Owns the bounded metric label sets: every observation
    refreshes ``fleet_kv_wire_rate_bytes_per_s{src,dst}``, and
    ``drop_member`` removes a dead member's series (the tenant-gauge
    policy — dead identities must not pin label sets forever). When a
    ``perf`` telemetry sink is wired (worker processes), observations
    also bump cumulative ``kvwire|src|dst|*`` counters so the registry
    host learns member↔member rates from the existing telemetry
    piggyback — no new wire frames for the data."""

    def __init__(self, window_s: float = 30.0,
                 prior_rate: float = 125_000_000.0,
                 metrics=None, perf=None):
        """``prior_rate`` (config ``fleet.kv_rate_prior``, bytes/s) is
        the rate the configured ``fleet.kv_page_cost`` constant is
        assumed to price: a wire measured at exactly the prior costs
        exactly the constant. <= 0 disables learned pricing (every
        wire stays at the constant) while still collecting rates for
        observability."""
        self.window_s = float(window_s)
        self.prior_rate = float(prior_rate)
        self.metrics = metrics
        self.perf = perf
        self._lock = threading.Lock()
        self._est: Dict[Tuple[str, str], WireRateEstimator] = {}

    def estimator(self, src: str, dst: str) -> _WireHandle:
        """The handle a ``KvDataChannel`` feeds its stream
        observations into (``rate_estimator=`` ctor param)."""
        return _WireHandle(self, src, dst)

    def _estimator(self, src: str, dst: str) -> WireRateEstimator:
        key = (src, dst)
        with self._lock:
            est = self._est.get(key)
            if est is None:
                est = self._est[key] = WireRateEstimator(self.window_s)
            return est

    def observe(self, src: str, dst: str, nbytes: int, seconds: float,
                chunks: int = 0, now: Optional[float] = None) -> None:
        est = self._estimator(src, dst)
        est.observe(nbytes, seconds, chunks=chunks, now=now)
        if self.metrics is not None:
            r = est.rate(now=now)
            if r is not None:
                self.metrics.set_kv_wire_rate(src, dst, r)
        if self.perf is not None:
            base = f"{WIRE_COUNTER_PREFIX}{src}|{dst}|"
            self.perf.add_counter(base + "bytes", float(nbytes))
            self.perf.add_counter(base + "seconds", float(seconds))
            self.perf.add_counter(base + "chunks", float(chunks))

    def rate(self, src: str, dst: str,
             now: Optional[float] = None) -> Optional[float]:
        with self._lock:
            est = self._est.get((src, dst))
        return est.rate(now=now) if est is not None else None

    def page_cost(self, src: str, dst: str, base_cost: float,
                  now: Optional[float] = None) -> Optional[float]:
        """Learned per-page cost for the ``(src, dst)`` wire, or None
        when the wire is cold / learned pricing is disabled — the
        caller then charges the static constant (the prior). A wire
        measured at the prior rate costs exactly ``base_cost``; slower
        wires scale up, faster ones down, clamped to a sane band."""
        if self.prior_rate <= 0:
            return None
        learned = self.rate(src, dst, now=now)
        if learned is None or learned <= 0:
            return None
        cost = base_cost * (self.prior_rate / learned)
        return min(max(cost, _MIN_PAGE_COST), _MAX_PAGE_COST)

    def drop_member(self, member_id: str) -> None:
        """A member died: drop every wire touching it and retract its
        gauge series (bounded label sets — dead host:pid identities
        would otherwise grow the gauge forever)."""
        with self._lock:
            gone = [k for k in self._est
                    if member_id in (k[0], k[1])]
            for key in gone:
                del self._est[key]
        if self.metrics is not None:
            for src, dst in gone:
                self.metrics.remove_kv_wire_rate(src, dst)

    def snapshot(self, now: Optional[float] = None
                 ) -> List[Dict[str, Any]]:
        """The ``kv_wires`` stats rows: one per observed wire, sorted
        for a stable table."""
        with self._lock:
            items = sorted(self._est.items())
        out = []
        for (src, dst), est in items:
            nbytes, chunks = est.totals()
            out.append({
                "src": src, "dst": dst,
                "rate_bytes_per_s": est.rate(now=now),
                "bytes": nbytes, "chunks": chunks,
            })
        return out


class MeshPeer:
    """The fetch-source adapter a worker hands its PrefixFetcher: the
    ``submit_prefix_export`` surface (serving/disagg.py) satisfied over
    a mesh ``KvDataChannel`` to the peer member. Mirrors
    RemoteRunner.submit_prefix_export — same exactly-once callback
    contract, including the fail-fast arm when the wire is missing or
    its breaker is open."""

    is_remote = True

    def __init__(self, channel, engine_id: str):
        """``engine_id`` is the PEER's member-local engine id (what its
        KvDataServer resolves exports against)."""
        self.channel = channel
        self.engine_id = engine_id

    def submit_prefix_export(self, request_id, hashes, chunk_pages: int,
                             wire_quant: str,
                             on_done: Callable, trace=None) -> None:
        ch = self.channel
        if ch is None or not ch.wire_available():
            on_done(None, "mesh peer wire unavailable")
            return
        ch.fetch_prefix(request_id, self.engine_id, hashes,
                        chunk_pages, wire_quant, trace, on_done)


class MeshClient:
    """Worker-side registry of direct member↔member KV data channels,
    driven entirely by ``KvIntro`` frames from the registry broker.

    Channels are created on introduction but dial LAZILY on first use
    (the KvDataChannel contract) — an introduced-but-idle mesh costs no
    sockets. A re-intro with a changed endpoint replaces the channel; a
    ``gone`` retraction closes it and drops the wire's learned-rate
    series. Each channel feeds ``rates`` under the
    ``(this member, peer member)`` key, which the worker's telemetry
    piggyback ships to the registry as kvwire counters."""

    def __init__(self, member_id: str, rates: MeshWireRates,
                 metrics=None, connect_timeout_s: float = 5.0,
                 breaker_threshold: int = 3, breaker_open_s: float = 5.0,
                 retry_budget=None):
        self.member_id = member_id
        self.rates = rates
        self.metrics = metrics
        self.connect_timeout_s = connect_timeout_s
        self.breaker_threshold = breaker_threshold
        self.breaker_open_s = breaker_open_s
        self.retry_budget = retry_budget
        self._lock = threading.Lock()
        self._peers: Dict[str, Any] = {}  # peer member_id -> KvDataChannel
        self._closed = False

    def on_intro(self, obj: Dict[str, Any]) -> None:
        """Apply one KvIntro frame (worker reader thread)."""
        from distributed_inference_server_tpu_torch.serving.fleet_kv import (
            KvDataChannel,
        )

        peer = obj.get("member_id", "")
        if not peer or peer == self.member_id:
            return
        gone = bool(obj.get("gone"))
        host = obj.get("host", "")
        port = int(obj.get("data_port", 0) or 0)
        if gone or not host or port <= 0:
            self._drop(peer, "mesh peer retracted")
            return
        with self._lock:
            if self._closed:
                return
            old = self._peers.get(peer)
            if old is not None and old.address == (host, port):
                return  # unchanged re-intro (broker resends are cheap)
            self._peers[peer] = KvDataChannel(
                peer, host, port,
                max_streams=max(1, int(obj.get("max_streams", 0) or 1)),
                connect_timeout_s=self.connect_timeout_s,
                metrics=self.metrics,
                breaker_threshold=self.breaker_threshold,
                breaker_open_s=self.breaker_open_s,
                retry_budget=self.retry_budget,
                rate_estimator=self.rates.estimator(self.member_id, peer),
                peer_wire=True,
            )
        if old is not None:
            old.close("mesh peer endpoint changed")
        logger.info("mesh: %s introduced to %s at %s:%d",
                    self.member_id, peer, host, port)

    def _drop(self, peer: str, reason: str) -> None:
        with self._lock:
            ch = self._peers.pop(peer, None)
        if ch is not None:
            ch.close(reason)
        self.rates.drop_member(peer)

    def channel(self, peer: str):
        """The live channel to ``peer``, or None if never introduced
        (the caller degrades to plain recompute)."""
        with self._lock:
            return self._peers.get(peer)

    def peer(self, member_id: str, engine_id: str) -> Optional[MeshPeer]:
        """A MeshPeer fetch source over the channel to ``member_id``,
        or None when the mesh has no wire to it."""
        ch = self.channel(member_id)
        if ch is None:
            return None
        return MeshPeer(ch, engine_id)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            peers = dict(self._peers)
        return {pid: ch.stats() for pid, ch in sorted(peers.items())}

    def close(self) -> None:
        with self._lock:
            self._closed = True
            peers, self._peers = dict(self._peers), {}
        for ch in peers.values():
            ch.close("mesh client closed")
