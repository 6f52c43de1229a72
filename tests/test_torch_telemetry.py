"""The port's performance telemetry and flight recorder against the JAX
package's, on the same seeded latencies under one fake clock: the digests'
wire dicts, merges, window statistics and SLO verdicts are equal, the
``/server/perf`` payload is the same, and the recorder's timelines, phase
sums, listings and the metrics they feed are the same for the same
notes. The port's phases ``ingress`` and ``engine_wait`` fold back into
the JAX package's partition (``engine_wait + prefill`` is its
``prefill``; ``ingress`` is 0 without a receipt stamp) and are tested on
their own, with the first-frame histogram."""

from __future__ import annotations

import math
import types

import numpy as np
import pytest

import distributed_inference_server_tpu.serving.flightrec as jfr
import distributed_inference_server_tpu.serving.metrics as jmet
import distributed_inference_server_tpu.serving.teledigest as jtd
import distributed_inference_server_tpu_torch.serving.flightrec as pfr
import distributed_inference_server_tpu_torch.serving.metrics as pmet
import distributed_inference_server_tpu_torch.serving.teledigest as ptd


class FakeClock:
    """One settable clock for both packages: wall (``time``) and
    monotonic seconds."""

    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def time(self) -> float:
        return self.t

    monotonic = time

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    fake_time = types.SimpleNamespace(time=c.time, monotonic=c.monotonic)
    # the JAX modules read the module-level time; the port's take a clock
    monkeypatch.setattr(jtd, "time", fake_time)
    monkeypatch.setattr(jfr, "time", fake_time)
    return c


def _latencies(seed: int, n: int = 300) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(3.0, 1.0, n),
                           [0.0, -1.0, 1e-4, 1e7]])


# ---------------------------------------------------------------------------
# buckets and digests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_layout_equal(seed):
    vals = list(_latencies(seed)) + [float("nan")]
    assert [ptd.bucket_of(v) for v in vals] == [jtd.bucket_of(v)
                                                for v in vals]
    idx = range(0, ptd.MAX_BUCKET + 1, 7)
    assert [ptd.bucket_value_ms(i) for i in idx] == [
        jtd.bucket_value_ms(i) for i in idx]
    assert (ptd.BUCKETS_PER_OCTAVE, ptd.MIN_VALUE_MS, ptd.MAX_BUCKET) == (
        jtd.BUCKETS_PER_OCTAVE, jtd.MIN_VALUE_MS, jtd.MAX_BUCKET)


def test_bucket_monotonic_and_midpoint_error():
    prev = -1
    for v in np.geomspace(1.2e-3, 1e6, 500):
        b = ptd.bucket_of(float(v))
        assert b >= prev
        prev = b
        mid = ptd.bucket_value_ms(b)
        assert abs(mid - v) / v < 0.05
    assert ptd.bucket_of(0.0) == ptd.bucket_of(-3.0) == 0


def _digest(mod, vals, epoch_s=5.0, window_s=60.0, t0=1_000_000.0,
            step=0.5, counts=False):
    d = mod.WindowedDigest(epoch_s, window_s)
    for i, v in enumerate(vals):
        now = t0 + i * step
        if counts:
            d.count(int(abs(v)) % 3 + 1, now=now)
        else:
            d.observe(float(v), now=now)
    return d.to_wire("ttft_ms")


@pytest.mark.parametrize("seed,step,window", [(0, 0.5, 60.0), (1, 0.05, 10.0),
                                              (2, 2.0, 30.0), (3, 0.2, 5.0)])
def test_windowed_digest_wire_equal(seed, step, window):
    vals = _latencies(seed)
    j = _digest(jtd, vals, window_s=window, step=step)
    p = _digest(ptd, vals, window_s=window, step=step)
    assert j == p
    # the ring is bounded: at most ceil(window / epoch) + 1 epochs
    assert len(p["epochs"]) <= math.ceil(window / 5.0) + 1


@pytest.mark.parametrize("seed", [0, 1])
def test_count_only_digest_equal(seed):
    vals = _latencies(seed, 80)
    j = _digest(jtd, vals, counts=True)
    p = _digest(ptd, vals, counts=True)
    assert j == p
    last = int((1_000_000.0 + (len(vals) - 1) * 0.5) // 5.0)
    assert ptd.windowed_count(p, 60.0, last) == jtd.windowed_count(
        j, 60.0, last)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_equal_and_grouping_invariant(seed):
    rng = np.random.default_rng(seed)
    parts = [_digest(ptd, _latencies(seed * 10 + k, 50),
                     t0=1_000_000.0 + float(rng.integers(0, 20)))
             for k in range(4)]
    merged = ptd.merge_digests(parts)
    assert merged == jtd.merge_digests(parts)
    # any grouping yields the identical dict
    assert ptd.merge_digests([ptd.merge_digests(parts[:2]),
                              ptd.merge_digests(parts[2:])]) == merged
    assert ptd.merge_digests(parts[::-1]) == merged
    assert sum(e["n"] for e in merged["epochs"]) == sum(
        e["n"] for p in parts for e in p["epochs"])


def test_merge_excludes_foreign_epoch_geometry():
    a = _digest(ptd, [1.0, 2.0], epoch_s=5.0)
    b = _digest(ptd, [3.0], epoch_s=1.0)
    assert ptd.merge_digests([a, b]) == jtd.merge_digests([a, b])
    assert ptd.merge_digests([a, b])["epochs"] == a["epochs"]


@pytest.mark.parametrize("window", [5.0, 20.0, 60.0, 600.0])
def test_window_stats_equal(window):
    p = _digest(ptd, _latencies(5), step=0.25)
    last = int((1_000_000.0 + 304 * 0.25) // 5.0)
    for as_of in (last, last - 3, last + 50):
        assert ptd.window_stats(p, window, as_of) == jtd.window_stats(
            p, window, as_of)
    s = ptd.window_stats(p, window, last)
    assert s["p50"] <= s["p90"] <= s["p99"]


# ---------------------------------------------------------------------------
# the perf store and the /server/perf payload
# ---------------------------------------------------------------------------


def _feed(store, vals, clock, counters=True):
    for i, v in enumerate(vals):
        store.observe("ttft_ms", float(v))
        store.observe("step_ms.decode_block", float(v) / 10)
        if i % 4 == 0:
            store.count("slo.violated" if i % 8 else "slo.ok")
        if counters:
            store.add_counter("step.engine-0.decode_block.dispatches", 1)
            store.add_counter("step.engine-0.decode_block.wall_s", 0.001)
            store.add_counter("events.engine-0.preempt", 1 if i % 50 == 0
                              else 0)
        clock.advance(0.3)


@pytest.mark.parametrize("epoch_s,window_s", [(5.0, 60.0), (1.0, 10.0)])
def test_perf_store_and_payload_equal(clock, epoch_s, window_s):
    j = jtd.PerfTelemetry(epoch_s, window_s)
    p = ptd.PerfTelemetry(epoch_s, window_s, clock=clock.time)
    vals = _latencies(7, 120)
    start = clock.t
    _feed(j, vals, clock)
    clock.t = start
    _feed(p, vals, clock)
    assert p.wire() == j.wire()
    assert p.stats() == j.stats(as_of_epoch=j.as_of_epoch())
    slo = ptd.SloSettings(ttft_ms=50.0, tenant_ttft_ms={"gold": 10.0})
    jslo = jtd.SloSettings(ttft_ms=50.0, tenant_ttft_ms={"gold": 10.0})
    counts = {"default": {"ok": 3, "violated": 1}}
    pay_p = ptd.build_perf_payload(p, slo, counts, {"default": 40})
    pay_j = jtd.build_perf_payload(j, jslo, counts, {"default": 40})
    assert pay_p == pay_j
    assert set(pay_p) <= set(ptd.PERF_FIELDS)
    assert pay_p["slo"]["burn_rate"] == pytest.approx(
        pay_p["slo"]["window_requests"]["violated"]
        / sum(pay_p["slo"]["window_requests"].values()))


def test_configure_reshapes_rings(clock):
    p = ptd.PerfTelemetry(clock=clock.time)
    p.observe("ttft_ms", 3.0)
    p.configure(1.0, 4.0)
    assert p.wire_digests() == {}
    p.observe("ttft_ms", 3.0)
    assert p.wire_digest("ttft_ms")["epoch_s"] == 1.0


def test_catalogs_equal():
    assert ptd.PERF_FIELDS == jtd.PERF_FIELDS
    assert ptd.DIGEST_NAMES == jtd.DIGEST_NAMES
    assert ptd.TELEMETRY_METRICS == jtd.TELEMETRY_METRICS


# ---------------------------------------------------------------------------
# SLO verdicts
# ---------------------------------------------------------------------------

VERDICT_CASES = [
    # (settings, tenant, ttft_s, tbt_s, status)
    ({"ttft_ms": 500.0, "tbt_p99_ms": 50.0}, "default", 0.1, 0.01, "ok"),
    ({"ttft_ms": 500.0}, "default", 0.9, 0.01, "ok"),
    ({"tbt_p99_ms": 50.0}, "default", 0.1, 0.2, "ok"),
    ({"ttft_ms": 500.0, "tenant_ttft_ms": {"vip": 100.0}}, "vip", 0.2,
     None, "ok"),
    ({"ttft_ms": 500.0}, "default", 0.1, None, "error"),
    ({}, "default", 0.1, 0.01, "ok"),
    ({"ttft_ms": 500.0}, "default", None, None, "ok"),
    ({"ttft_ms": 500.0, "tenant_ttft_ms": {"free": 0.0}}, "free", 9.0,
     None, "ok"),
]


@pytest.mark.parametrize("case", VERDICT_CASES)
def test_slo_verdict_equal(case):
    kw, tenant, ttft, tbt, status = case
    got = ptd.slo_verdict(ptd.SloSettings(**kw), tenant, ttft, tbt, status)
    assert got == jtd.slo_verdict(jtd.SloSettings(**kw), tenant, ttft, tbt,
                                  status)
    assert ptd.SloSettings(**kw).enabled() == jtd.SloSettings(**kw).enabled()


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def _recorder(which, clock, slo=None, **kw):
    if which == "jax":
        m = jmet.MetricsCollector()
        settings = jtd.SloSettings(**slo) if slo is not None else None
        return jfr.FlightRecorder(metrics=m, slo=settings, **kw), m
    m = pmet.MetricsCollector()
    m.perf.clock = clock.time
    settings = ptd.SloSettings(**slo) if slo is not None else None
    return pfr.FlightRecorder(metrics=m, slo=settings, clock=clock.monotonic,
                              **kw), m


def _drive(rec, clock, rid="r1", tokens=20, fetch_s=0.0, stall_s=0.0,
           gap=0.01, tenant="default", status="ok", code=None):
    rec.admit(rid, endpoint="generate", prompt_tokens=8, tenant=tenant,
              trace_id="t" * 16)
    clock.advance(0.05)
    rec.note(rid, "schedule", engine="engine-0", strategy="least_loaded")
    clock.advance(0.03)
    if fetch_s:
        rec.note(rid, "prefix_fetch", outcome="ok", seconds=fetch_s)
    clock.advance(0.04)
    for i in range(tokens):
        rec.token(rid, 1 if i % 5 else 2)
        clock.advance(gap)
    if stall_s:
        rec.note(rid, "handoff_resume", target="engine-1", stall_s=stall_s)
    clock.advance(0.002)
    return rec.finish(rid, status, code=code)


SCENARIOS = {
    "plain": lambda rec, c: [_drive(rec, c)],
    "fetch_and_stall": lambda rec, c: [_drive(rec, c, fetch_s=0.02,
                                              stall_s=0.05)],
    "clamped_windows": lambda rec, c: [_drive(rec, c, fetch_s=99.0,
                                              stall_s=99.0)],
    "error_mid_decode": lambda rec, c: [_drive(rec, c, tokens=3,
                                               status="error",
                                               code="engine_crashed")],
    "never_dispatched": lambda rec, c: [
        rec.admit("q1"), c.advance(1.5),
        rec.finish("q1", "error", code="queue_timeout")],
    "shed": lambda rec, c: [
        rec.note("s1", "admission_shed", tenant="t", reason="deadline"),
        rec.finish("s1", "error", code="admission_shed")],
    "first_finish_wins": lambda rec, c: [
        _drive(rec, c, tokens=2), rec.finish("r1", "error", code="x"),
        rec.token("r1")],
    "global_events": lambda rec, c: [
        rec.admit("g1"), c.advance(0.1), rec.note_global("rerole", e="e0"),
        c.advance(0.1), rec.token("g1"), rec.finish("g1", "ok"),
        c.advance(0.5), rec.note_global("late")],
    "tenants": lambda rec, c: [
        _drive(rec, c, rid="a", tenant="gold"),
        _drive(rec, c, rid="b", tenant="silver", gap=0.2),
        _drive(rec, c, rid="c", tenant="gold", tokens=1)],
    "bounded": lambda rec, c: [_drive(rec, c, rid=f"x{i}", tokens=30)
                               for i in range(7)],
    "decode_blocks_not_per_token": lambda rec, c: [_drive(rec, c,
                                                          tokens=64)],
    "event_cap_terminal_lands": lambda rec, c: [
        rec.admit("e1"), [rec.note("e1", f"n{i}", i=i) for i in range(30)],
        rec.token("e1"), rec.finish("e1", "ok")],
    "redispatch_hops": lambda rec, c: [
        rec.admit("h1"), rec.note("h1", "schedule", engine="engine-0"),
        c.advance(0.2), rec.note("h1", "redispatch", from_engine="engine-0",
                                 to_engine="engine-1", attempt=1),
        rec.note("h1", "schedule", engine="engine-1"), c.advance(0.1),
        rec.token("h1"), c.advance(0.01), rec.token("h1"),
        rec.finish("h1", "ok")],
    "one_token": lambda rec, c: [_drive(rec, c, tokens=1)],
    "direct_submit_no_schedule": lambda rec, c: [
        c.advance(0.5), rec.token("d1"), c.advance(0.02), rec.token("d1"),
        rec.finish("d1", "ok")],
    "live_request_listing": lambda rec, c: [
        _drive(rec, c, rid="done"), rec.admit("live"), c.advance(0.3),
        rec.token("live")],
}


@pytest.mark.parametrize("slo", [None, {"ttft_ms": 150.0,
                                        "tbt_p99_ms": 15.0,
                                        "tenant_ttft_ms": {"gold": 1e-6}}],
                         ids=["no_slo", "slo"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_recorder_equal(name, slo, clock):
    outs = {}
    for which in ("jax", "torch"):
        clock.t = 1_000_000.0
        rec, m = _recorder(which, clock, slo=slo, max_requests=5,
                           max_events=12, block_tokens=4)
        ret = SCENARIOS[name](rec, clock)
        ids = list(dict.fromkeys(
            [str(x["request_id"]) for x in rec.recent(50)]))
        outs[which] = {
            "ret": ret,
            "timelines": {i: rec.timeline(i) for i in ids},
            "recent": rec.recent(50),
            "violated": rec.recent(50, verdict="violated"),
            "stats": rec.stats(),
            "slo": m.slo_counts(),
            "perf": {k: v for k, v in m.perf.wire_digests().items()
                     if k in ("queue_wait_ms", "tbt_ms", "slo.ok",
                              "slo.violated")},
        }
    for tl in outs["torch"]["timelines"].values():
        if tl["status"] != "live":
            # the phases partition the wall clock (clamped windows never
            # make them exceed it)
            assert sum(tl["phases"].values()) <= tl["wall_s"] + 1e-5
    assert _fold_port_phases(outs["torch"]) == outs["jax"]


def _fold_port_phases(obj):
    """The port's phase dicts in the JAX package's partition: its
    ``engine_wait`` added back into ``prefill`` and its ``ingress``
    (0 here: no receipt stamp is given) dropped."""
    if isinstance(obj, dict):
        out = {k: _fold_port_phases(v) for k, v in obj.items()}
        if "engine_wait" in out:
            assert out.pop("ingress") == 0.0
            wait = out.pop("engine_wait")
            out["prefill"] = round(out["prefill"] + wait, 6) if wait else (
                out["prefill"])
        return out
    if isinstance(obj, list):
        return [_fold_port_phases(v) for v in obj]
    return obj


def test_phase_metrics_and_prometheus_lines(clock):
    texts = {}
    port_only = set()
    for which in ("jax", "torch"):
        clock.t = 1_000_000.0
        rec, m = _recorder(which, clock, slo={"ttft_ms": 1e4})
        _drive(rec, clock, tokens=8)
        m.record_trace_drops("ring", 2)
        m.record_shed("gold", "brownout")
        m.record_health_transition("engine-0", "degraded")
        m.record_retry_denied("redispatch")
        m.record_breaker_transition("open")
        texts[which] = {
            ln for ln in m.prometheus_text().decode().splitlines()
            if ln.split("{")[0].split(" ")[0] in (
                "slo_requests_total", "slo_goodput_tokens_total",
                "trace_spans_dropped_total", "requests_shed_total",
                "engine_health_state", "health_transitions_total",
                "retry_budget_exhausted_total",
                "fleet_breaker_transitions_total",
                "request_phase_seconds_count")}
        if which == "torch":
            port_only = {ln for ln in texts[which]
                         if 'phase="ingress"' in ln
                         or 'phase="engine_wait"' in ln}
            texts[which] -= port_only
    assert texts["torch"] == texts["jax"]
    assert port_only == {'request_phase_seconds_count{phase="ingress"} 1.0',
                         'request_phase_seconds_count{phase="engine_wait"} '
                         '1.0'}
    # 8 token events, two of them carrying 2 tokens
    assert ('slo_goodput_tokens_total{tenant="default"} 10.0'
            in texts["torch"])
    snap = pmet.MetricsCollector()
    snap.record_request_phases({"queue_wait": 0.1, "decode": 0.2}, 0.01)
    assert snap.snapshot().to_dict()["tracing"]["phase_requests"] == 1


# ---------------------------------------------------------------------------
# the port's own phases: ingress, engine_wait and the narrowed prefill
# ---------------------------------------------------------------------------

# the engine's first prefill chunk, seconds after the dispatch (None: the
# runner noted no prefill_start, as for a handoff import); the first token
# comes 0.08 s after the dispatch
PREFILL_STARTS = {"absent": None, "early": -0.01, "at_dispatch": 0.0,
                  "inside": 0.03, "late": 0.5}


@pytest.mark.parametrize("fetch_s", [0.0, 0.02, 0.06, 99.0],
                         ids=["no_fetch", "fetch_in_prefill",
                              "fetch_past_prefill", "fetch_clamped"])
@pytest.mark.parametrize("start", sorted(PREFILL_STARTS))
def test_port_phases_partition_the_wall_clock(clock, start, fetch_s):
    rec, m = _recorder("torch", clock, slo={"ttft_ms": 1e4})
    received = clock.t
    clock.advance(0.004)
    rec.admit("p1", received_at=received, endpoint="generate")
    admitted = clock.t
    clock.advance(0.05)
    rec.note("p1", "schedule", engine="engine-0")
    dispatched = clock.t
    if fetch_s:
        rec.note("p1", "prefix_fetch", outcome="ok", seconds=fetch_s)
    clock.advance(0.08)
    offset = PREFILL_STARTS[start]
    if offset is not None:
        rec.note("p1", "prefill_start", at=dispatched + offset, chunks=2,
                 steps=2)
    rec.token("p1")
    first = clock.t
    clock.advance(0.002)
    rec.first_frame("p1")
    rec.first_frame("p1")  # once a request
    for _ in range(3):
        clock.advance(0.01)
        rec.token("p1")
    clock.advance(0.001)
    phases = rec.finish("p1", "ok")
    tl = rec.timeline("p1")

    span = first - dispatched
    fetch = min(fetch_s, span)
    wait = 0.0 if offset is None else min(max(offset, 0.0), span)
    taken = min(fetch, span - wait)
    want_wait = wait - (fetch - taken)
    want_prefill = span - wait - taken
    approx = dict(abs=1e-9)
    assert list(phases) == list(pfr.PHASES)
    assert phases["ingress"] == pytest.approx(0.004, **approx)
    assert phases["queue_wait"] == pytest.approx(0.05, **approx)
    assert phases["engine_wait"] == pytest.approx(want_wait, **approx)
    assert phases["prefill"] == pytest.approx(want_prefill, **approx)
    assert phases["peer_fetch"] == pytest.approx(fetch, **approx)
    # the JAX package's prefill, and TTFT from admission, exactly
    assert phases["engine_wait"] + phases["prefill"] == pytest.approx(
        span - fetch, **approx)
    assert (phases["queue_wait"] + phases["engine_wait"]
            + phases["prefill"] + phases["peer_fetch"]) == pytest.approx(
        first - admitted, **approx)
    assert tl["ttft_s"] == pytest.approx(first - admitted, abs=1e-6)
    # the partition of the wall clock from the receipt
    assert sum(phases.values()) == pytest.approx(clock.t - received,
                                                 **approx)
    assert tl["wall_s"] == pytest.approx(clock.t - received, abs=1e-6)
    events = {e["name"]: e for e in tl["events"]}
    if offset is None:
        assert "prefill_start" not in events
    else:
        assert events["prefill_start"]["t_ms"] == pytest.approx(
            (dispatched + offset - admitted) * 1e3, abs=1e-3)
        assert events["prefill_start"]["attributes"] == {"chunks": 2,
                                                         "steps": 2}
    text = m.prometheus_text().decode()
    for phase in ("ingress", "engine_wait"):
        assert f'request_phase_seconds_count{{phase="{phase}"}} 1.0' in text
    assert "request_first_frame_seconds_count 1.0" in text
    assert _sample(text, "request_first_frame_seconds_sum") == (
        pytest.approx(0.002, abs=1e-9))


def test_first_frame_needs_a_first_token(clock):
    rec, m = _recorder("torch", clock)
    rec.first_frame("unknown")
    rec.admit("q1")
    clock.advance(0.01)
    rec.first_frame("q1")  # no token yet: nothing observed
    rec.token("q1")
    clock.advance(0.003)
    rec.first_frame("q1")
    text = m.prometheus_text().decode()
    assert "request_first_frame_seconds_count 1.0" in text
    assert _sample(text, "request_first_frame_seconds_sum") == (
        pytest.approx(0.003, abs=1e-9))


def _sample(text: str, name: str) -> float:
    (line,) = [ln for ln in text.splitlines() if ln.startswith(name + " ")]
    return float(line.split()[1])
