"""Fault injection: a seeded, config/env-gated registry of named
failure points threaded through the serving stack (docs/RESILIENCE.md).
The port's own copy of ``distributed_inference_server_tpu/serving/
faults.py``, the same grammar, catalogue and seeded firing sequences.

The resilience machinery this repo promises — worker self-restart,
crash-safe redispatch, handoff fallback, import abort — only exists
where a fault can reach it. This module makes faults reachable on
purpose: code at a crash-relevant site calls ``fire("<point>")`` and,
when a rule for that point is armed, the call raises ``InjectedFault``
(or sleeps, or returns True for flag-style points). With nothing
installed — the production default — ``fire`` is one module-global load
and a ``None`` check; no rule matching, no RNG, no allocation.

Arming is explicit and double-gated:

- command line: ``--faults-spec`` / ``--faults-seed`` (``__main__.py``);
- programmatic: ``install(parse_spec(...))`` from the tests.

Spec grammar (semicolon-separated rules)::

    point:key=val[,key=val][;point2:...]

    runner.inbox:nth=1              crash on the 1st inbox command
    runner.step:prob=0.01           crash ~1% of engine steps (seeded)
    disagg.chunk:nth=3,times=2      chunk 3 and 4 error on the channel
    disagg.slow_peer:prob=0.5,delay_ms=20   slow-peer stall, no error

Keys: ``nth`` (fire on the Nth hit of the point, 1-based), ``prob``
(per-hit probability from the seeded RNG), ``times`` (max fires; default
1 for ``nth`` rules, unlimited for ``prob``), ``delay_ms`` (sleep
instead of raising — the slow-peer action).

Point catalog (the authoritative list lives in docs/RESILIENCE.md):

======================  ====================================================
``runner.step``         crash mid-step: after ``engine.step()`` computed
                        outputs, before any reached a sink
``runner.inbox``        crash between submit and inbox drain: requests
                        registered in ``_inflight``, engine never saw them
``disagg.transfer``     monolithic handoff channel error
``disagg.chunk``        streamed channel error (one hit per chunk — ``nth``
                        selects the Nth chunk)
``disagg.commit``       switchover commit dropped on the channel
``disagg.slow_peer``    channel stall (pair with ``delay_ms``)
``kv.host_copy``        host-tier demotion copy fails (page drops, never
                        corrupts)
``kv.import_chunk``     import-side chunk validation failure
``kv.peer_fetch``       peer-to-peer prefix fetch dies on the wire (one
                        hit per chunk — ``nth`` drops the Nth chunk);
                        the request falls back to recompute
``kv.latent_decode``    latent payload reconstruction fails on import
                        (kind-3 decode in ``kv_cache._decode_payload``)
                        — the session aborts like any validation
                        failure and the consumer degrades exactly once
                        (handoff to decode-in-place, fetch to
                        recompute), zero page leak
``sched.health_flap``   flag: the health loop sees a healthy engine as
                        down for one sweep (restart of a live replica)
``sched.fetch_decision``  flag: force the cache_aware cost model to pick
                        FETCH when a fetch option exists (drives the
                        peer-fetch path deterministically under chaos)
``fleet.heartbeat``     a member's heartbeat is dropped before the
                        registry applies it (the partition model: the
                        member ages alive -> suspect -> dead while its
                        process lives on)
``fleet.submit``        a forwarded FleetSubmit dies — on the registry
                        host's wire (hit 1 per request) or as a worker
                        crash on receipt (the member drops the
                        connection and serves nothing); either way the
                        request takes the crash-safe redispatch path
``sched.rerole``        flag: force the RoleBalancer's rebalance signal
                        high for one evaluation (drives role flips
                        deterministically; hysteresis still bounds the
                        actual flip rate)
``fleet.kv_connect``    the lazy dial of a member's KV data channel
                        fails (serving/fleet_kv.py) — the handoff
                        degrades to decode-in-place, the fetch to
                        recompute, exactly once
``fleet.kv_chunk``      per-chunk wire death on a KV data channel (one
                        hit per KvChunk frame either direction; ``nth``
                        tears the stream at its Nth chunk) — same
                        exactly-once degradation, zero page leak
``fleet.slow_member``   delay-style (pair with ``delay_ms``): a fleet
                        member serves SLOWLY while heartbeating
                        healthily — the gray-failure model. Fired on
                        the member's serve path after the request's
                        arrival clock starts, so the member's own TTFT
                        telemetry carries the slowness the host's
                        HealthScorer demotes it on
``fleet.wire_timeout``  a send on the fleet control wire
                        (RemoteRunner.submit) or the KV data wire
                        (KvDataChannel wire worker) wedges/times out —
                        repeated hits are the scorer's wire-failure
                        eject evidence and walk the data channel's
                        circuit breaker closed → open
``fleet.kv_intro``      a KvIntro introduction frame dies on the
                        registry's control wire (serving/fleet.py
                        ``_send_intro``) — the pair is never
                        introduced, mesh fetch hints for it degrade to
                        plain recompute on the member, and the intro
                        is re-brokered when the endpoint next changes
``fleet.kv_peer_dial``  the lazy dial of a MEMBER's peer data channel
                        fails (serving/fleet_mesh.py MeshClient wires;
                        the member->member analogue of
                        ``fleet.kv_connect``) — the hinted mesh fetch
                        degrades to recompute exactly once, zero page
                        leak, and the wire's breaker walks toward open
``fleet.lease_beat``    a primary registry's RegistryLease frame is
                        dropped before the send (serving/fleet_ha.py
                        ``_tick``; one hit per peer per tick — the
                        registry-partition model). Standbys age the
                        lease alive -> suspect -> expired while the
                        primary's process lives on, then promote at a
                        higher epoch and fence it
``fleet.takeover``      a standby crashes at the start of promotion
                        (serving/fleet_ha.py ``_promote``), BEFORE the
                        epoch bump or role flip published anything —
                        takeover must be atomic-or-absent: either the
                        fleet sees the full new-epoch primary or the
                        election simply re-runs on the next tick
======================  ====================================================
"""

from __future__ import annotations

import logging
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class FaultSpecError(ValueError):
    """Malformed fault spec string (config surfaces it as ConfigError)."""


class InjectedFault(RuntimeError):
    """Raised by an armed injection point; carries the point name so
    chaos invariant checks can tell injected failures from organic
    ones."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point}")
        self.point = point


@dataclass
class FaultRule:
    """One armed point. ``nth`` fires on the Nth hit (1-based); ``prob``
    fires per hit from the seeded RNG; ``times`` bounds total fires
    (``None`` = unlimited). ``delay_ms`` turns the action into a stall
    instead of a raise."""

    point: str
    nth: int = 0
    prob: float = 0.0
    times: Optional[int] = None
    delay_ms: float = 0.0

    def __post_init__(self) -> None:
        if self.nth < 0:
            raise FaultSpecError(f"{self.point}: nth must be >= 1")
        if not (0.0 <= self.prob <= 1.0):
            raise FaultSpecError(f"{self.point}: prob must be in [0, 1]")
        if self.nth == 0 and self.prob == 0.0:
            raise FaultSpecError(
                f"{self.point}: rule needs nth=N or prob=p to ever fire"
            )
        if self.times is None:
            # an nth rule is a one-shot by default; a prob rule recurs
            self.times = 1 if self.nth else None


class FaultSet:
    """Armed rules + seeded RNG + fire log. Thread-safe: injection
    points fire from the runner threads, the dispatcher, the disagg
    worker, and the health loop concurrently; hit counting and RNG draws
    happen under one lock (the armed path is diagnostic machinery — a
    lock there costs nothing real, and unseeded racing draws would make
    "same seed, same faults" a lie)."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.seed = seed
        self._rules: Dict[str, FaultRule] = {}
        for r in rules:
            if r.point in self._rules:
                raise FaultSpecError(f"duplicate rule for point {r.point}")
            self._rules[r.point] = r
        self._rng = random.Random(seed)
        self._hits: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._lock = threading.Lock()
        #: (point, hit_number) of every fire, for harness introspection
        self.log: List[Tuple[str, int]] = []

    def _trigger(self, point: str) -> Optional[FaultRule]:
        """One hit of ``point``; returns the rule when it triggers."""
        rule = self._rules.get(point)
        if rule is None:
            return None
        with self._lock:
            hits = self._hits.get(point, 0) + 1
            self._hits[point] = hits
            fired = self._fired.get(point, 0)
            if rule.times is not None and fired >= rule.times:
                return None
            trigger = (rule.nth and hits >= rule.nth) or (
                rule.prob and self._rng.random() < rule.prob
            )
            if not trigger:
                return None
            self._fired[point] = fired + 1
            self.log.append((point, hits))
        logger.debug("fault injected at %s (hit %d)", point, hits)
        return rule

    def fire(self, point: str) -> bool:
        """One hit of a raise-style point. Raises InjectedFault when an
        armed rule triggers; sleeps instead for a delay-rule (returning
        True); returns False when unarmed or not triggered."""
        rule = self._trigger(point)
        if rule is None:
            return False
        if rule.delay_ms > 0:
            # Event.wait, not time.sleep: the injected stall stays
            # interruptible-shaped like every other serving-spine wait
            # (distlint DL001)
            threading.Event().wait(rule.delay_ms / 1000.0)
            return True
        raise InjectedFault(point)

    def flag(self, point: str) -> bool:
        """One hit of a FLAG-style point (e.g. ``sched.health_flap``):
        never raises — the caller interprets True as "the condition
        fired" (a delay-rule still sleeps first)."""
        rule = self._trigger(point)
        if rule is None:
            return False
        if rule.delay_ms > 0:
            threading.Event().wait(rule.delay_ms / 1000.0)
        return True

    def fired_count(self, point: Optional[str] = None) -> int:
        with self._lock:
            if point is not None:
                return self._fired.get(point, 0)
            return sum(self._fired.values())


def parse_spec(spec: str, seed: int = 0) -> FaultSet:
    """Parse the spec grammar (module docstring) into a FaultSet.
    Raises FaultSpecError on malformed input."""
    rules: List[FaultRule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise FaultSpecError(
                f"rule {part!r} missing ':' (want point:key=val,...)"
            )
        point, _, kvs = part.partition(":")
        point = point.strip()
        if not point:
            raise FaultSpecError(f"rule {part!r} has an empty point name")
        kwargs: Dict[str, float] = {}
        for kv in kvs.split(","):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise FaultSpecError(f"{point}: {kv!r} is not key=val")
            key, _, val = kv.partition("=")
            key = key.strip()
            if key not in ("nth", "prob", "times", "delay_ms"):
                raise FaultSpecError(
                    f"{point}: unknown key {key!r} "
                    "(known: nth, prob, times, delay_ms)"
                )
            try:
                kwargs[key] = float(val)
            except ValueError:
                raise FaultSpecError(
                    f"{point}: {key}={val!r} is not a number"
                ) from None
        rules.append(FaultRule(
            point=point,
            nth=int(kwargs.get("nth", 0)),
            prob=kwargs.get("prob", 0.0),
            times=int(kwargs["times"]) if "times" in kwargs else None,
            delay_ms=kwargs.get("delay_ms", 0.0),
        ))
    if not rules:
        raise FaultSpecError(f"fault spec {spec!r} contains no rules")
    return FaultSet(rules, seed=seed)


# -- module-level registry (the injection points' view) ---------------------

_active: Optional[FaultSet] = None
# arm/disarm observers (serving/flightrec.py): flight recorders note
# fault-injection hops into their fleet-event windows so a postmortem
# timeline shows WHEN the chaos lever moved. A LIST, not a slot: the
# chaos fleet topology runs two InferenceServers (registry host +
# member) in one interpreter, and the host's recorder must not lose the
# events to the member's. Never on the fire() hot path — only
# install/clear transitions report.
_observers: List = []


def add_observer(cb) -> None:
    """Register ``cb(event, **attrs)``; called on install/clear only.
    Pair with ``remove_observer`` (server shutdown) or the registry
    grows across server lifetimes."""
    _observers.append(cb)


def remove_observer(cb) -> None:
    try:
        _observers.remove(cb)
    except ValueError:
        pass


def install(faults: Optional[FaultSet]) -> None:
    """Arm a FaultSet process-wide (None = disarm). The chaos harness
    installs a fresh seeded set per scenario iteration."""
    global _active
    _active = faults
    if faults is not None:
        logger.warning(
            "fault injection ARMED (seed=%d, points: %s) — never in "
            "production", faults.seed, ", ".join(sorted(faults._rules)),
        )
    for cb in list(_observers):
        try:
            if faults is not None:
                cb("faults_armed", seed=faults.seed,
                   points=sorted(faults._rules))
            else:
                cb("faults_cleared")
        except Exception:  # noqa: BLE001 — observability must not gate
            # the chaos lever
            logger.debug("fault observer failed", exc_info=True)


def clear() -> None:
    install(None)


def active() -> Optional[FaultSet]:
    return _active


def fire(point: str) -> bool:
    """A raise-style injection point: no-op (one global load + None
    check) unless a FaultSet is installed AND has a rule for ``point``.
    May raise InjectedFault, or sleep and return True for delay rules."""
    faults = _active
    if faults is None:
        return False
    return faults.fire(point)


def flag(point: str) -> bool:
    """A flag-style injection point (never raises): True when an armed
    rule triggered — the call site applies the condition itself (e.g.
    the health loop treating a live replica as down)."""
    faults = _active
    if faults is None:
        return False
    return faults.flag(point)
