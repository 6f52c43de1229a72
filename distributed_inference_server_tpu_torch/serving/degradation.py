"""Graceful degradation ladder driven by KV-page memory pressure and the
SLO burn rate (the port's copy of
``distributed_inference_server_tpu/serving/degradation.py``)::

    < 0.70  NORMAL                     full service
    < 0.80  REDUCED_BATCH_SIZE         admission batches halved
    < 0.90  AGGRESSIVE_CACHE_EVICTION  + cached (refcount-0) prefix pages
                                         evicted down to the low threshold
    < 0.95  REJECT_LOW_PRIORITY        + Priority.LOW requests get 503
    >=0.95  EMERGENCY                  + all new requests get 503

Pressure is the worst replica's live page share (cached prefix pages are
reclaimable, so they do not count). With ``metrics`` the windowed SLO burn
rate is a second input: at ``burn_high`` or above the ladder stands at
least at REJECT_LOW_PRIORITY, at half of it at least at
REDUCED_BATCH_SIZE. Each rung also shrinks the mixed step's prefill share
and the looped block's iteration cap on every replica. Restrictions lift
in reverse order as the signals fall.
"""

from __future__ import annotations

import enum
import logging
import threading
from typing import Optional

from distributed_inference_server_tpu_torch.serving.dispatcher import (
    Dispatcher,
)
from distributed_inference_server_tpu_torch.serving.scheduler import (
    AdaptiveScheduler,
)

logger = logging.getLogger(__name__)


class DegradationLevel(enum.IntEnum):
    NORMAL = 0
    REDUCED_BATCH_SIZE = 1
    AGGRESSIVE_CACHE_EVICTION = 2
    REJECT_LOW_PRIORITY = 3
    EMERGENCY = 4


#: (upper pressure bound, level) — design.md:934-941 [spec]
THRESHOLDS = (0.70, 0.80, 0.90, 0.95)


def level_for_pressure(pressure: float) -> DegradationLevel:
    for i, bound in enumerate(THRESHOLDS):
        if pressure < bound:
            return DegradationLevel(i)
    return DegradationLevel.EMERGENCY


class DegradationController:
    """Evaluates pressure and applies/lifts ladder actions."""

    def __init__(
        self,
        dispatcher: Dispatcher,
        scheduler: AdaptiveScheduler,
        check_interval_s: float = 0.5,
        evict_target_frac: float = 0.70,
        metrics=None,
        burn_high: float = 0.5,
        burn_min_requests: int = 20,
    ):
        """``metrics``/``burn_high``/``burn_min_requests`` arm the SLO
        burn rate as a second escalation input alongside memory
        pressure (serving/health.py settings ``health.slo_burn_high`` /
        ``health.slo_burn_min_requests``; docs/RESILIENCE.md "Gray
        failures and overload"): once the trailing window holds
        ``burn_min_requests`` SLO verdicts, a burn rate at or above
        ``burn_high`` escalates the ladder to at least
        REJECT_LOW_PRIORITY (at or above half of it, to at least
        REDUCED_BATCH_SIZE) — a fleet burning its latency objective
        sheds load even while memory looks fine. The rung lifts as the
        windowed verdicts decay. None = memory-only (the pre-gray
        behavior exactly)."""
        self.dispatcher = dispatcher
        self.scheduler = scheduler
        self.metrics = metrics
        self.burn_high = burn_high
        self.burn_min_requests = burn_min_requests
        self.level = DegradationLevel.NORMAL
        self._interval = check_interval_s
        self._evict_target = evict_target_frac
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- pressure ----------------------------------------------------------

    def memory_pressure(self) -> float:
        worst = 0.0
        for status in self.scheduler.statuses():
            if status.memory_total_pages:
                # live pressure: cached (refcount-0 prefix) pages are
                # reclaimable on demand, so a pool merely full of cache
                # must not climb the ladder (EngineStatus reports raw
                # occupancy with the cached share broken out)
                live = status.memory_used_pages - getattr(
                    status, "pages_cached", 0
                )
                worst = max(worst, live / status.memory_total_pages)
        return worst

    def slo_burn_rate(self) -> Optional[float]:
        """Windowed SLO burn rate (violated / total) from the slo.ok /
        slo.violated count digests (serving/teledigest.py), or None
        while the window holds fewer than ``burn_min_requests``
        verdicts — a handful of early violations must not slam the
        ladder."""
        if self.metrics is None:
            return None
        from distributed_inference_server_tpu_torch.serving.teledigest import (
            windowed_count,
        )

        perf = self.metrics.perf_store()
        as_of = perf.as_of_epoch()
        ok = windowed_count(perf.wire_digest("slo.ok"), perf.window_s,
                            as_of)
        bad = windowed_count(perf.wire_digest("slo.violated"),
                             perf.window_s, as_of)
        total = ok + bad
        if total < self.burn_min_requests:
            return None
        return bad / total

    def level_for_burn(self, burn: Optional[float]) -> DegradationLevel:
        """SLO-burn escalation floor: >= burn_high ->
        REJECT_LOW_PRIORITY, >= burn_high/2 -> REDUCED_BATCH_SIZE.
        Burn alone never reaches EMERGENCY — a latency fire sheds load,
        only a memory fire turns everyone away."""
        if burn is None:
            return DegradationLevel.NORMAL
        if burn >= self.burn_high:
            return DegradationLevel.REJECT_LOW_PRIORITY
        if burn >= self.burn_high / 2.0:
            return DegradationLevel.REDUCED_BATCH_SIZE
        return DegradationLevel.NORMAL

    # -- evaluation --------------------------------------------------------

    def evaluate(self, pressure: Optional[float] = None) -> DegradationLevel:
        """One ladder evaluation; applies side effects on level change.
        The level is the MAX of the memory rung and the SLO-burn rung
        (each lifts independently as its signal decays)."""
        pressure = self.memory_pressure() if pressure is None else pressure
        burn = self.slo_burn_rate()
        new = max(level_for_pressure(pressure), self.level_for_burn(burn))
        if new != self.level:
            logger.warning(
                "degradation level %s -> %s (memory pressure %.2f, "
                "slo burn %s)",
                self.level.name, new.name, pressure,
                f"{burn:.2f}" if burn is not None else "n/a",
            )
            self._apply(self.level, new)
            self.level = new
        elif new >= DegradationLevel.AGGRESSIVE_CACHE_EVICTION:
            self._evict(new)  # keep evicting while pressure stays high
        return self.level

    #: mixed-step prefill share per ladder level (engine/engine.py
    #: set_mixed_prefill_frac): under pressure, prompt loading slows
    #: instead of decode slots stalling — decode rows keep their one
    #: token per mixed dispatch at every rung
    MIXED_PREFILL_FRAC = {
        DegradationLevel.NORMAL: 1.0,
        DegradationLevel.REDUCED_BATCH_SIZE: 0.5,
        DegradationLevel.AGGRESSIVE_CACHE_EVICTION: 0.5,
        DegradationLevel.REJECT_LOW_PRIORITY: 0.25,
        DegradationLevel.EMERGENCY: 0.25,
    }

    #: looped-block iteration-cap share per ladder level (engine/engine.py
    #: set_loop_cap_frac): under pressure, run-to-completion blocks give
    #: the host back control sooner so admission and preemption can run —
    #: the same lever MIXED_PREFILL_FRAC pulls on prompt loading
    LOOP_CAP_FRAC = {
        DegradationLevel.NORMAL: 1.0,
        DegradationLevel.REDUCED_BATCH_SIZE: 0.5,
        DegradationLevel.AGGRESSIVE_CACHE_EVICTION: 0.5,
        DegradationLevel.REJECT_LOW_PRIORITY: 0.25,
        DegradationLevel.EMERGENCY: 0.25,
    }

    def _apply(self, old: DegradationLevel, new: DegradationLevel) -> None:
        # batch-size reduction: owns only the divisor — the config itself
        # stays owned by hot-reload, so the two compose
        self.dispatcher.batcher.size_divisor = (
            2 if new >= DegradationLevel.REDUCED_BATCH_SIZE else 1
        )
        # mixed-step prefill share (no-op on engines without the mixed
        # step); restored on the way back down the ladder
        frac = self.MIXED_PREFILL_FRAC[new]
        loop_frac = self.LOOP_CAP_FRAC[new]
        for runner in self.scheduler.engines():
            setter = getattr(runner, "set_mixed_prefill_frac", None)
            if setter is not None:
                setter(frac)
            # looped-block cap (no-op on engines without
            # loop_to_completion); restored on the way back down
            loop_setter = getattr(runner, "set_loop_cap_frac", None)
            if loop_setter is not None:
                loop_setter(loop_frac)
        # cache eviction
        if new >= DegradationLevel.AGGRESSIVE_CACHE_EVICTION > old or (
            new >= DegradationLevel.EMERGENCY > old
        ):
            self._evict(new)
        # admission gates
        self.dispatcher.reject_low_priority = (
            new >= DegradationLevel.REJECT_LOW_PRIORITY
        )
        self.dispatcher.reject_all = new >= DegradationLevel.EMERGENCY

    def _evict(self, level: DegradationLevel) -> None:
        """AGGRESSIVE_CACHE_EVICTION demotes HBM prefix pages to the
        host tier (the tier is exactly the pressure valve for this
        rung); only EMERGENCY — host RAM is the next thing to run out —
        drops the host tier as well."""
        drop_host = level >= DegradationLevel.EMERGENCY
        for runner in self.scheduler.engines():
            runner.evict_cache(self._evict_target,
                               drop_host_tier=drop_host)

    # -- background loop ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="degradation", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 — monitoring must not die
                logger.exception("degradation evaluation failed")
