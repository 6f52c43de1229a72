"""The port's gray-failure defense and degradation ladder against the JAX
package's (the cases of ``tests/test_health.py`` and
``tests/test_degradation.py``, each run on both packages with the same
synthetic inputs and expected outcomes): the circuit breaker, the retry
budget, admission shedding with brownout by DRR weight, the dispatcher's
shed path, the health scorer's states, routing tiering, the SLO-burn
escalation and the ladder's levels and gates. Clocks are injected or
passed in: nothing sleeps."""

from __future__ import annotations

import time
import types

import pytest

import distributed_inference_server_tpu.core.errors as jerr
import distributed_inference_server_tpu.core.types as jtypes
import distributed_inference_server_tpu.engine.engine as jeng
import distributed_inference_server_tpu.serving.batcher as jbat
import distributed_inference_server_tpu.serving.degradation as jdeg
import distributed_inference_server_tpu.serving.dispatcher as jdisp
import distributed_inference_server_tpu.serving.flightrec as jfr
import distributed_inference_server_tpu.serving.health as jh
import distributed_inference_server_tpu.serving.metrics as jmet
import distributed_inference_server_tpu.serving.runner as jrun
import distributed_inference_server_tpu.serving.scheduler as jsch
import distributed_inference_server_tpu.serving.teledigest as jtd
import distributed_inference_server_tpu_torch.core.errors as perr
import distributed_inference_server_tpu_torch.core.types as ptypes
import distributed_inference_server_tpu_torch.engine.engine as peng
import distributed_inference_server_tpu_torch.serving.batcher as pbat
import distributed_inference_server_tpu_torch.serving.degradation as pdeg
import distributed_inference_server_tpu_torch.serving.dispatcher as pdisp
import distributed_inference_server_tpu_torch.serving.flightrec as pfr
import distributed_inference_server_tpu_torch.serving.health as ph
import distributed_inference_server_tpu_torch.serving.metrics as pmet
import distributed_inference_server_tpu_torch.serving.runner as prun
import distributed_inference_server_tpu_torch.serving.scheduler as psch
import distributed_inference_server_tpu_torch.serving.teledigest as ptd


def _ns(err, types_, eng, bat, deg, disp, fr, h, met, run, sch, td):
    return types.SimpleNamespace(err=err, types=types_, eng=eng, bat=bat,
                                 deg=deg, disp=disp, fr=fr, h=h, met=met,
                                 run=run, sch=sch, td=td)


NS = {"jax": _ns(jerr, jtypes, jeng, jbat, jdeg, jdisp, jfr, jh, jmet, jrun,
                 jsch, jtd),
      "torch": _ns(perr, ptypes, peng, pbat, pdeg, pdisp, pfr, ph, pmet,
                   prun, psch, ptd)}


@pytest.fixture(params=sorted(NS))
def ns(request):
    return NS[request.param]


class _Sink:
    def on_token(self, *a, **k): ...

    def on_done(self, *a, **k): ...

    def on_error(self, *a, **k): ...


def _request(ns, rid="r", tenant="default"):
    return ns.run.ServerRequest(rid, [1, 2, 3],
                                ns.eng.SamplingParams(max_tokens=4), _Sink(),
                                tenant=tenant)


def _dispatcher(ns, **kw):
    d = ns.disp.Dispatcher(ns.sch.AdaptiveScheduler(), native_queue=False,
                           **kw)
    d._accepting = True  # no dispatch thread needed for submit
    return d


def _status(ns, eid, health="healthy", load=0, **kw):
    return ns.met.EngineStatus(engine_id=eid, healthy=True,
                               active_requests=load, waiting_requests=0,
                               total_processed=0, health=health, **kw)


# ---------------------------------------------------------------------------
# the circuit breaker
# ---------------------------------------------------------------------------


def _breaker_trace(ns, script):
    """Run ``script`` (a list of (op, arg) steps) on a breaker and return
    every step's result, the transitions and the stats."""
    seen = []
    b = ns.h.CircuitBreaker(threshold=2, open_s=1.0, on_transition=seen.append)
    out = []
    for op, t in script:
        if op == "fail":
            out.append(b.record_failure(now=t))
        elif op == "ok":
            out.append(b.record_success())
        elif op == "release":
            out.append(b.release())
        elif op == "acquire":
            out.append(b.try_acquire(now=t))
        elif op == "available":
            out.append(b.available(now=t))
        else:
            out.append(b.state(now=t))
    return out, seen, [s for _, s in b.history()], b.stats()


BREAKER_SCRIPTS = {
    "opens_after_threshold": [("fail", 0.0), ("state", 0.1), ("fail", 0.2),
                              ("state", 0.3), ("available", 0.3),
                              ("acquire", 0.3)],
    "success_resets_streak": [("fail", 0.0), ("ok", 0), ("fail", 0.1),
                              ("state", 0.2)],
    "half_open_probe_then_close": [("fail", 0.0), ("fail", 0.0),
                                   ("acquire", 0.5), ("state", 1.1),
                                   ("available", 1.1), ("acquire", 1.1),
                                   ("acquire", 1.2), ("ok", 0),
                                   ("state", 1.3)],
    "failed_probe_reopens": [("fail", 0.0), ("fail", 0.0), ("acquire", 1.1),
                             ("fail", 1.2), ("state", 1.3), ("acquire", 1.9),
                             ("acquire", 2.3)],
    "release_unwedges_probe": [("fail", 0.0), ("fail", 0.0),
                               ("acquire", 1.1), ("release", 0),
                               ("acquire", 1.2)],
    "closed_never_blocks": [("ok", 0), ("available", 0.0),
                            ("acquire", 0.1), ("fail", 0.2), ("ok", 0),
                            ("fail", 0.3), ("acquire", 0.4),
                            ("state", 5.0)],
    "unanswered_probe_times_out": [("fail", 0.0), ("fail", 0.0),
                                   ("acquire", 1.1), ("state", 1.5),
                                   ("state", 2.2), ("available", 2.2),
                                   ("acquire", 3.3), ("ok", 0),
                                   ("state", 3.4)],
}


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_breaker_sequences_equal(name):
    script = BREAKER_SCRIPTS[name]
    got = _breaker_trace(NS["torch"], script)
    assert got == _breaker_trace(NS["jax"], script)
    if name == "half_open_probe_then_close":
        assert got[1] == ["open", "half_open", "closed"]
        assert got[3]["transitions"] == 3


# ---------------------------------------------------------------------------
# the retry budget
# ---------------------------------------------------------------------------


def test_retry_budget_floor_ratio_decay(ns):
    rb = ns.h.RetryBudget(ratio=0.1, min_retries=2, window_s=10.0)
    assert [rb.acquire("r", now=t) for t in (0.0, 0.1, 0.2)] == [
        True, True, False]
    rb = ns.h.RetryBudget(ratio=0.5, min_retries=1, window_s=10.0)
    for i in range(10):
        rb.note_admit(now=i * 0.1)
    assert sum(rb.acquire("x", now=2.0) for _ in range(10)) == 5
    rb = ns.h.RetryBudget(ratio=0.0, min_retries=1, window_s=1.0)
    assert [rb.acquire("x", now=t) for t in (0.0, 0.5, 1.6)] == [
        True, False, True]


def test_retry_budget_denials_count_into_metrics(ns):
    mc = ns.met.MetricsCollector()
    rb = ns.h.RetryBudget(ratio=0.0, min_retries=1, window_s=10.0,
                          metrics=mc)
    rb.acquire("redispatch", now=0.0)
    rb.acquire("redispatch", now=0.1)
    assert mc.snapshot().to_dict()["resilience"]["retry_denied"] == {
        "redispatch": 1}
    assert rb.stats()["denied_total"] == 1


# ---------------------------------------------------------------------------
# deadline-aware admission
# ---------------------------------------------------------------------------


def _overloaded(ns, wait_ms=2000.0, n=12):
    mc = ns.met.MetricsCollector()
    mc.configure_perf(5.0, 60.0)
    for _ in range(n):
        mc.perf.observe("queue_wait_ms", wait_ms)
    return mc


ADMISSION_CASES = {
    # name: (AdmissionSettings kw, SloSettings kw, (wait_ms, n), weights,
    #        tenants to check)
    "no_deadline": ({}, None, (2000.0, 12), None, ["default"]),
    "cold_estimator": ({"min_window_requests": 8}, {"ttft_ms": 100.0},
                       (2000.0, 3), None, ["default"]),
    "blows_deadline": ({}, {"ttft_ms": 500.0}, (2000.0, 12), None,
                       ["default"]),
    "under_deadline": ({}, {"ttft_ms": 5000.0}, (100.0, 12), None,
                       ["default"]),
    "brownout": ({}, {"ttft_ms": 1000.0}, (600.0, 12),
                 {"gold": 4.0, "bronze": 1.0}, ["gold", "bronze", "other"]),
    "brownout_off": ({"brownout": False}, {"ttft_ms": 1000.0}, (600.0, 12),
                     {"gold": 4.0, "bronze": 1.0}, ["gold", "bronze"]),
    "retry_after_cap": ({"retry_after_cap_s": 5.0}, {"ttft_ms": 100.0},
                        (60000.0, 12), None, ["default"]),
    "explicit_deadline": ({"deadline_ms": 750.0}, {"ttft_ms": 5000.0},
                          (1000.0, 12), None, ["default"]),
    "cold_estimator_with_brownout": ({}, {"ttft_ms": 100.0}, (5000.0, 7),
                                     {"gold": 4.0, "bronze": 1.0},
                                     ["gold", "bronze"]),
    "tenant_slo_override": ({"deadline_factor": 2.0},
                            {"ttft_ms": 500.0,
                             "tenant_ttft_ms": {"vip": 2000.0}},
                            (1500.0, 12), None, ["default", "vip"]),
}


def _admission(ns, name):
    akw, skw, (wait, n), weights, tenants = ADMISSION_CASES[name]
    ac = ns.h.AdmissionControl(
        ns.h.AdmissionSettings(**akw),
        slo=ns.td.SloSettings(**skw) if skw is not None else None,
        metrics=_overloaded(ns, wait, n), tenant_weights=weights)
    out = []
    for t in tenants:
        shed = ac.check(t)
        out.append((t, ac.deadline_ms(t), None if shed is None else (
            shed.reason, shed.retry_after_s, shed.estimate_ms,
            shed.deadline_ms)))
    return out, ac.stats()


@pytest.mark.parametrize("name", sorted(ADMISSION_CASES))
def test_admission_decisions_equal(name):
    got = _admission(NS["torch"], name)
    assert got == _admission(NS["jax"], name)
    decisions = {t: d for t, _, d in got[0]}
    if name == "blows_deadline":
        assert decisions["default"][0] == "deadline"
    if name == "brownout":
        assert decisions["gold"] is None
        assert decisions["bronze"][0] == "brownout"
    if name in ("no_deadline", "cold_estimator", "under_deadline",
                "brownout_off"):
        assert all(d is None for d in decisions.values())
    if name == "retry_after_cap":
        assert decisions["default"][1] == 5.0


def test_shed_is_a_queue_full_and_maps_to_503_admission_shed():
    assert issubclass(ph.AdmissionShed, perr.QueueFull)
    err = perr.AdmissionShedApiError(retry_after_s=7.0)
    j = jerr.AdmissionShedApiError(retry_after_s=7.0)
    assert (err.status_code(), err.error_type(), err.code(), str(err),
            err.retry_after_s) == (j.status_code(), j.error_type(), j.code(),
                                   str(j), j.retry_after_s)


def test_dispatcher_sheds_with_terminal_and_metric(ns):
    ac = ns.h.AdmissionControl(ns.h.AdmissionSettings(),
                               slo=ns.td.SloSettings(ttft_ms=100.0),
                               metrics=_overloaded(ns))
    rec = ns.fr.FlightRecorder(metrics=ac.metrics)
    d = _dispatcher(ns, metrics=ac.metrics, recorder=rec, admission=ac,
                    retry_budget=ns.h.RetryBudget(metrics=ac.metrics))
    with pytest.raises(ns.h.AdmissionShed) as ei:
        d.submit(_request(ns, "shed-1"))
    assert ei.value.reason == "deadline"
    tl = rec.timeline("shed-1")
    assert (tl["code"], tl["status"]) == ("admission_shed", "error")
    assert [e["name"] for e in tl["events"]] == ["admission_shed", "terminal"]
    assert ac.metrics.snapshot().to_dict()["resilience"]["requests_shed"] == {
        "default": {"deadline": 1}}
    assert d.queue.is_empty()


def test_admitted_requests_feed_the_retry_budget(ns):
    mc = ns.met.MetricsCollector()
    d = _dispatcher(ns, metrics=mc,
                    admission=ns.h.AdmissionControl(metrics=mc),
                    retry_budget=ns.h.RetryBudget(metrics=mc))
    d.submit(_request(ns, "ok-1"))
    assert d.retry_budget.stats()["window_admits"] == 1


def test_shed_does_not_poison_estimator_or_slo(ns):
    mc = _overloaded(ns)
    rec = ns.fr.FlightRecorder(metrics=mc, slo=ns.td.SloSettings(ttft_ms=1.0))
    before = mc.perf_store().wire_digest("queue_wait_ms")
    rec.note("shed-p", "admission_shed", tenant="t", reason="deadline")
    rec.finish("shed-p", "error", code="admission_shed")
    assert mc.perf_store().wire_digest("queue_wait_ms") == before
    assert mc.slo_counts()[0] == {}
    assert "slo" not in rec.timeline("shed-p")


def test_dry_budget_declines_redispatch(ns):
    mc = ns.met.MetricsCollector()
    rb = ns.h.RetryBudget(ratio=0.0, min_retries=0, window_s=10.0,
                          metrics=mc)
    d = _dispatcher(ns, metrics=mc, retry_budget=rb)
    assert d.redispatch(_request(ns, "rb-1"), "engine-0", "crash") is False
    res = mc.snapshot().to_dict()["resilience"]
    assert res["redispatched"] == {"exhausted": 1}
    assert res["retry_denied"] == {"redispatch": 1}


# ---------------------------------------------------------------------------
# the health scorer
# ---------------------------------------------------------------------------


class _FakeRunner:
    def __init__(self, ns, eid, active=0, remote=False, wire_failures=0,
                 kv_channel=None):
        self.ns = ns
        self.engine_id = eid
        self.is_remote = remote
        self.consecutive_wire_failures = wire_failures
        self.kv_channel = kv_channel
        self._active = active

    def status(self):
        return self.ns.met.EngineStatus(
            engine_id=self.engine_id, healthy=True,
            active_requests=self._active, waiting_requests=0,
            total_processed=0)


class _FakeScheduler:
    def __init__(self, runners):
        self._runners = runners

    def engines(self):
        return list(self._runners)


def _ttft_wire(ns, values_ms):
    d = ns.td.WindowedDigest(5.0, 60.0)
    for v in values_ms:
        d.observe(v)
    return d.to_wire("ttft_ms")


def _scorer(ns, runners, telemetry=None, metrics=None, **kw):
    kw.setdefault("stall_s", 1.0)
    settings = ns.h.HealthSettings(demote_after=2, recover_after=2,
                                   min_window_requests=3, latency_ratio=3.0,
                                   recover_ratio=1.5, wire_failures=2, **kw)
    fn = None
    if telemetry is not None:
        fn = (telemetry if callable(telemetry) else (lambda: telemetry))
    return ns.h.HealthScorer(settings, _FakeScheduler(runners),
                             metrics=metrics, telemetry_fn=fn)


def test_latency_demotes_then_band_holds_then_recovers(ns):
    mc = ns.met.MetricsCollector()
    for _ in range(5):
        mc.perf.observe("ttft_ms", 100.0)
    state = {"t": {"m1": {"digests": {
        "ttft_ms": _ttft_wire(ns, [1000.0] * 5)}}}}
    s = _scorer(ns, [_FakeRunner(ns, "m1:engine-0", remote=True)],
                telemetry=lambda: state["t"], metrics=mc)
    assert s.evaluate() == []
    assert s.evaluate() == [("m1:engine-0", "healthy", "degraded")]
    assert s.stats()["engines"]["m1:engine-0"]["reasons"] == ["latency"]
    state["t"] = {"m1": {"digests": {"ttft_ms": _ttft_wire(ns,
                                                           [200.0] * 5)}}}
    for _ in range(5):
        s.evaluate()
    assert s.state("m1:engine-0") == "degraded"  # held in the band
    state["t"] = {"m1": {"digests": {"ttft_ms": _ttft_wire(ns,
                                                           [100.0] * 5)}}}
    s.evaluate()
    s.evaluate()
    assert s.state("m1:engine-0") == "healthy"


def test_single_source_never_compares(ns):
    mc = ns.met.MetricsCollector()
    for _ in range(5):
        mc.perf.observe("ttft_ms", 5000.0)
    s = _scorer(ns, [_FakeRunner(ns, "engine-0")], metrics=mc)
    s.evaluate()
    s.evaluate()
    assert s.state("engine-0") == "healthy"


def test_wire_failures_eject_then_walk_back(ns):
    runner = _FakeRunner(ns, "m1:engine-0", remote=True, wire_failures=2)
    s = _scorer(ns, [runner])
    states = []
    for _ in range(3):
        s.evaluate()
        states.append(s.state("m1:engine-0"))
    runner.consecutive_wire_failures = 0
    for _ in range(2):
        s.evaluate()
        states.append(s.state("m1:engine-0"))
    assert states == ["healthy", "degraded", "ejected", "ejected",
                      "degraded"]


def test_kv_breaker_open_degrades(ns):
    ch = types.SimpleNamespace(
        breaker=ns.h.CircuitBreaker(threshold=1, open_s=600.0))
    ch.breaker.record_failure()
    s = _scorer(ns, [_FakeRunner(ns, "m1:engine-0", remote=True,
                                 kv_channel=ch)])
    s.evaluate()
    s.evaluate()
    assert s.state("m1:engine-0") == "degraded"
    assert "kv_breaker_open" in s.stats()["engines"]["m1:engine-0"][
        "reasons"]


def test_wedge_ejects_only_after_progress_then_stall(ns):
    mc = ns.met.MetricsCollector()
    s = _scorer(ns, [_FakeRunner(ns, "engine-0", active=2)], metrics=mc,
                stall_s=0.05)
    t0 = time.monotonic()
    s.evaluate(now=t0 + 0.08)
    s.evaluate(now=t0 + 0.09)
    assert s.state("engine-0") == "healthy"  # never dispatched: not wedged
    mc.perf.add_counter("step.engine-0.decode_block.dispatches", 5)
    s.evaluate(now=t0 + 0.10)
    for dt in (0.2, 0.21, 0.22):
        s.evaluate(now=t0 + dt)
    assert s.state("engine-0") == "ejected"
    assert "eject:stalled" in s.stats()["engines"]["engine-0"]["reasons"]
    mc.perf.add_counter("step.engine-0.decode_block.dispatches", 1)
    for dt in (0.23, 0.24, 0.25, 0.26):
        s.evaluate(now=t0 + dt)
    assert s.state("engine-0") == "healthy"


def test_wedge_clock_restarts_when_work_arrives_after_idle(ns):
    mc = ns.met.MetricsCollector()
    runner = _FakeRunner(ns, "engine-0", active=0)
    s = _scorer(ns, [runner], metrics=mc, stall_s=0.2)
    t0 = time.monotonic()
    mc.perf.add_counter("step.engine-0.decode_block.dispatches", 3)
    s.evaluate(now=t0)
    s.evaluate(now=t0 + 0.3)  # idle past stall_s
    runner._active = 2
    for dt in (0.31, 0.32, 0.33):
        s.evaluate(now=t0 + dt)
    assert s.state("engine-0") == "healthy"


def test_stamp_overlays_counts_and_prunes(ns):
    mc = ns.met.MetricsCollector()
    sched_runner = _FakeRunner(ns, "m1:engine-0", remote=True,
                               wire_failures=5)
    s = _scorer(ns, [sched_runner], metrics=mc)
    s.evaluate()
    s.evaluate()
    stamped = s.stamp([_status(ns, "m1:engine-0"), _status(ns, "other")])
    assert [x.health for x in stamped] == ["degraded", "healthy"]
    assert 'engine_health_state{engine_id="m1:engine-0"} 1.0' in (
        mc.prometheus_text().decode())
    s.scheduler._runners = []
    s.evaluate()
    assert s.state("m1:engine-0") == "healthy"  # gone = default


def test_health_tiering_and_routing(ns):
    S = ns.sch
    pool = [_status(ns, "a", "degraded"), _status(ns, "b"),
            _status(ns, "c")]
    assert {x.engine_id for x in S.health_tier(pool)} == {"b", "c"}
    pool = [_status(ns, "a", "degraded"), _status(ns, "b", "ejected")]
    assert [x.engine_id for x in S.health_tier(pool)] == ["a"]
    LL = S.SchedulingStrategy.LEAST_LOADED
    assert S.choose_engine(LL, [_status(ns, "a", "degraded", 0),
                                _status(ns, "b", load=9)], 0) == "b"
    assert S.choose_engine(LL, [_status(ns, "a", "ejected"),
                                _status(ns, "b", "ejected")], 0) == "a"
    warm = _status(ns, "warm", "ejected", prefix_digest=frozenset(
        [11, 22, 33]), page_size=4)
    plan = S.plan_route([warm, _status(ns, "cold", page_size=4)],
                        [11, 22, 33])
    assert (plan.engine_id, plan.decision) == ("cold", "recompute")
    assert ns.h.health_rank("healthy") < ns.h.health_rank(
        "degraded") < ns.h.health_rank("ejected")


# ---------------------------------------------------------------------------
# the degradation ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pressure", [0.0, 0.69, 0.70, 0.79, 0.80, 0.89,
                                      0.90, 0.94, 0.95, 1.0, 1.5])
def test_level_for_pressure_equal(pressure):
    assert int(pdeg.level_for_pressure(pressure)) == int(
        jdeg.level_for_pressure(pressure))


class _LadderRunner:
    engine_id = "e0"

    def __init__(self):
        self.calls = []

    def set_loop_cap_frac(self, f):
        self.calls.append(("loop", f))

    def set_mixed_prefill_frac(self, f):
        self.calls.append(("mixed", f))

    def evict_cache(self, target, drop_host_tier=False):
        self.calls.append(("evict", target, drop_host_tier))


def _ladder_trace(ns, pressures):
    d = _dispatcher(ns)
    c = ns.deg.DegradationController(d, d.scheduler)
    r = _LadderRunner()
    d.scheduler.register(r)
    out = []
    for p in pressures:
        level = c.evaluate(pressure=p)
        gates = []
        for prio in ("LOW", "NORMAL", "HIGH"):
            try:
                d.submit(_request(ns, f"{p}-{prio}"),
                         getattr(ns.types.Priority, prio))
                gates.append("ok")
            except ns.err.QueueFull:
                gates.append("503")
        out.append((level.name, d.batcher.size_divisor,
                    d.batcher.effective_max_batch(), d.reject_low_priority,
                    d.reject_all, tuple(gates)))
    return out, r.calls


@pytest.mark.parametrize("seq", [
    (0.75, 0.85, 0.92, 0.97, 0.5),
    (0.99, 0.3, 0.85, 0.86, 0.1),
    (0.1, 0.92, 0.75, 0.96, 0.96, 0.2),
    (0.69, 0.70, 0.79, 0.80, 0.89, 0.90, 0.94, 0.95, 0.0),
    (0.5, 0.5, 0.81, 0.81, 0.71, 0.0),
])
def test_ladder_levels_and_gates_equal(seq):
    got = _ladder_trace(NS["torch"], seq)
    assert got == _ladder_trace(NS["jax"], seq)
    if seq[0] == 0.75:
        levels = [x[0] for x in got[0]]
        assert levels == ["REDUCED_BATCH_SIZE", "AGGRESSIVE_CACHE_EVICTION",
                          "REJECT_LOW_PRIORITY", "EMERGENCY", "NORMAL"]
        assert [x[5] for x in got[0]] == [
            ("ok",) * 3, ("ok",) * 3, ("503", "ok", "ok"), ("503",) * 3,
            ("ok",) * 3]
        assert [x[1] for x in got[0]] == [2, 2, 2, 2, 1]


def test_hot_reload_composes_with_the_divisor(ns):
    d = _dispatcher(ns)
    c = ns.deg.DegradationController(d, d.scheduler)
    c.evaluate(pressure=0.75)
    d.batcher.config = ns.bat.BatcherConfig(window_ms=50.0,
                                            max_batch_size=64)
    assert d.batcher.effective_max_batch() == 32
    c.evaluate(pressure=0.10)
    assert d.batcher.effective_max_batch() == 64


def test_memory_pressure_no_engines_is_zero(ns):
    d = _dispatcher(ns)
    assert ns.deg.DegradationController(d, d.scheduler).memory_pressure() == 0


def _burn_trace(ns, clock, verdicts, epoch_s, window_s, burn_min, steps):
    mc = ns.met.MetricsCollector()
    if hasattr(mc.perf, "clock"):
        mc.perf.clock = clock.time
    mc.configure_perf(epoch_s, window_s)
    d = _dispatcher(ns, metrics=mc)
    c = ns.deg.DegradationController(d, d.scheduler, metrics=mc,
                                     burn_high=0.5,
                                     burn_min_requests=burn_min)
    for v in verdicts:
        mc.record_slo("default", v)
    out = []
    for advance, pressure in steps:
        clock.t += advance
        out.append((c.slo_burn_rate(), c.evaluate(pressure=pressure).name,
                    d.reject_low_priority))
    return out


BURN_CASES = {
    "escalates_then_lifts": (["violated"] * 6, 0.05, 0.1, 5,
                             [(0.0, 0.1), (0.3, 0.1)]),
    "half_burn_reduces_batch": (["violated"] * 3 + ["ok"] * 7, 5.0, 60.0, 5,
                                [(0.0, 0.1)]),
    "below_min_never_escalates": (["violated"] * 6, 5.0, 60.0, 20,
                                  [(0.0, 0.1)]),
    "memory_still_wins": (["violated"] * 6, 5.0, 60.0, 5, [(0.0, 0.97)]),
}


@pytest.mark.parametrize("name", sorted(BURN_CASES))
def test_burn_escalation_equal(name, monkeypatch):
    from test_torch_telemetry import FakeClock

    clock = FakeClock()
    monkeypatch.setattr(jtd, "time", types.SimpleNamespace(time=clock.time))
    runs = []
    for which in ("jax", "torch"):
        clock.t = 1_000_000.0
        runs.append(_burn_trace(NS[which], clock, *BURN_CASES[name]))
    assert runs[0] == runs[1]
    got = runs[1]
    if name == "escalates_then_lifts":
        assert got == [(1.0, "REJECT_LOW_PRIORITY", True),
                       (None, "NORMAL", False)]
    if name == "half_burn_reduces_batch":
        assert got[0][0] == pytest.approx(0.3)
        assert got[0][1] == "REDUCED_BATCH_SIZE"
    if name == "memory_still_wins":
        assert got[0][1] == "EMERGENCY"


def test_settings_mapping_equal():
    env = {"DIS_TPU_HEALTH__STALL_S": "9.0",
           "DIS_TPU_HEALTH__WIRE_FAILURES": "5",
           "DIS_TPU_ADMISSION__DEADLINE_MS": "1234",
           "DIS_TPU_ADMISSION__BROWNOUT": "false"}
    import distributed_inference_server_tpu.serving.config as jcfg
    import distributed_inference_server_tpu_torch.serving.config as pcfg

    j, p = (m.ServerConfig.load(environ=env) for m in (jcfg, pcfg))
    assert vars(p.health_settings()) == vars(j.health_settings())
    assert vars(p.admission_settings()) == vars(j.admission_settings())
    assert p.health_settings().stall_s == 9.0
