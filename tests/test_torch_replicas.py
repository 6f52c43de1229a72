"""Several engine replicas in one port server, against the JAX package.

- Launch accounting: a CUDA graph capture on one engine thread counts only
  that thread's launches while another thread launches (the repair that
  two replicas on one card need), and the counters lose no increment
  under two threads.
- The scheduler's pure core (``choose_engine``, ``health_tier``,
  ``prefix_match_depth``, ``plan_route``) over hypothesis-drawn
  ``EngineStatus`` vectors, converted to the JAX class: the same engine
  ids and plans. The JAX cases of ``TestChooseEngine`` and
  ``TestAdaptiveScheduler`` (``tests/test_serving_units.py``) and
  ``TestRestartBackoff`` (``tests/test_chaos.py``) on the port.
- The replica metrics (restarts, redispatch, handoff, prefix fetch and
  route, roles) against the JAX collector after the same record calls.
- One module-scoped two-replica server (TINY f32, the JAX package's
  weights by conversion): round-robin and concurrent greedy requests give
  the JAX engine's tokens, text and usage; the ``TestRedispatch`` cases of
  ``tests/test_chaos.py``; a restart that releases the dead engine and
  serves the same text; the health loop's automatic restart; ``POST
  /admin/scale`` 2 -> 3 -> 2 with a request in flight; ``/health`` over
  the replicas.
- The command line's replica flags and their config errors.
"""

import dataclasses
import gc
import json
import sys
import threading
import time
import urllib.request
import weakref

import pytest
import torch

from _hypothesis_compat import given, settings, st
from distributed_inference_server_tpu.serving import metrics as jmetrics
from distributed_inference_server_tpu.serving import scheduler as jsched
from distributed_inference_server_tpu_torch import __main__ as cli
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PagedCacheConfig,
    chain_hashes,
)
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.ops import kernels
from distributed_inference_server_tpu_torch.ops.kernels import _launches
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving import metrics as pmetrics
from distributed_inference_server_tpu_torch.serving.batcher import (
    BatcherConfig,
)
from distributed_inference_server_tpu_torch.serving.faults import parse_spec
from distributed_inference_server_tpu_torch.serving.metrics import (
    EngineStatus,
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    ServerRequest,
)
from distributed_inference_server_tpu_torch.serving.scheduler import (
    AdaptiveScheduler,
    FetchCosts,
    SchedulingStrategy,
    choose_engine,
    health_tier,
    plan_route,
    prefix_match_depth,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)
from test_torch_handoff import BUCKETS, PAGED, TOK, _pp, j_engine

PROMPTS = ["hello replicas", "the quick brown fox", "paged attention",
           "four concurrent requests"]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()


def count_launch(name: str, n: int = 1) -> None:
    """What kernel ``name``'s wrapper records when it launches (on this
    thread)."""
    _launches.count(kernels.KERNELS[name], n)


# ---------------------------------------------------------------------------
# launch accounting under two engine threads
# ---------------------------------------------------------------------------


def test_capture_counts_only_its_own_threads_launches():
    """Thread A records (as a graph capture does) while thread B launches
    1000 times: A's record holds A's launches only, and the process total
    holds both."""
    kernels.reset_launch_counts()
    b_started, a_done = threading.Event(), threading.Event()

    def b():
        b_started.set()
        while not a_done.is_set():
            count_launch("rms_norm")
        for _ in range(1000):
            count_launch("rms_norm")

    t = threading.Thread(target=b)
    t.start()
    b_started.wait()
    with kernels.recording() as rec:
        for _ in range(3):
            count_launch("paged_decode")
            time.sleep(0.01)  # B launches meanwhile
        count_launch("rope", 2)
    a_done.set()
    t.join()
    assert rec == {"paged_decode": 3, "rope": 2}
    total = kernels.launch_counts()
    assert total["paged_decode"] == 3 and total["rope"] == 2
    assert total["rms_norm"] >= 1000
    mine = kernels.thread_launch_counts()
    assert mine["rms_norm"] == 0 and mine["paged_decode"] == 3
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts().values())
    assert not any(kernels.thread_launch_counts().values())


def test_engine_capture_is_charged_its_own_launches(monkeypatch):
    """``LLMEngine._capture`` with a stand-in graph, while a second engine
    thread launches: the captured graph's counts are the body's launches,
    and the capture takes back exactly those from the process total."""

    class FakeGraph:
        def capture_begin(self, **kw):
            pass

        def capture_end(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    eng = LLMEngine(_pp(), TINY, TOK,
                    EngineConfig(max_batch=4, prefill_buckets=BUCKETS,
                                 paged=PagedCacheConfig(*PAGED)),
                    dtype=torch.float32, device="cpu")
    kernels.reset_launch_counts()
    go, stop = threading.Event(), threading.Event()
    other = {"n": 0}

    def serve():
        go.set()
        while not stop.is_set():
            count_launch("paged_decode")
            other["n"] += 1

    def body():
        go.wait()
        for _ in range(4):
            count_launch("paged_prefill")
            count_launch("rms_norm", 2)
            time.sleep(0.005)

    t = threading.Thread(target=serve)
    t.start()
    eng._capture(("test", 0), body, None)
    stop.set()
    t.join()
    assert eng._graphs[("test", 0)].counts == {"paged_prefill": 4,
                                               "rms_norm": 8}
    total = kernels.launch_counts()
    assert total["paged_prefill"] == 0 and total["rms_norm"] == 0
    assert total["paged_decode"] == other["n"] > 0
    kernels.reset_launch_counts()


def test_counters_lose_no_increment_under_many_threads():
    """Eight threads, more than the cores, with a short switch interval:
    every increment of the process total survives."""
    kernels.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def spin():
            for _ in range(5000):
                count_launch("rope")

        ts = [threading.Thread(target=spin) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launch_counts()["rope"] == 40000
    kernels.reset_launch_counts()


# ---------------------------------------------------------------------------
# the scheduler's pure core against the JAX package's
# ---------------------------------------------------------------------------

PS = 4
HASH_PROMPT = list(range(41))
HASHES = chain_hashes(HASH_PROMPT, PS, max_pages=10)


def _status(eid, healthy=True, active=0, waiting=0, used=0, total=100,
            cached=0, role="unified", digest=None, health="healthy"):
    return EngineStatus(
        engine_id=eid, healthy=healthy, active_requests=active,
        waiting_requests=waiting, total_processed=0,
        memory_used_pages=used, memory_total_pages=total,
        pages_cached=cached, role=role, prefix_digest=digest,
        page_size=PS, digest_depth=8, health=health)


def _to_jax(s: EngineStatus) -> "jmetrics.EngineStatus":
    return jmetrics.EngineStatus(**dataclasses.asdict(s))


_statuses = st.lists(
    st.builds(
        _status,
        eid=st.sampled_from(["e0", "e1", "e2", "e3", "e4"]),
        healthy=st.booleans(),
        active=st.integers(0, 6),
        waiting=st.integers(0, 6),
        used=st.integers(0, 100),
        cached=st.integers(0, 20),
        role=st.sampled_from(["unified", "prefill", "decode"]),
        digest=st.one_of(st.none(), st.integers(0, len(HASHES)).map(
            lambda d: frozenset(HASHES[:d]))),
        health=st.sampled_from(["healthy", "healthy", "degraded",
                                "ejected"])),
    max_size=5, unique_by=lambda s: s.engine_id)
_roles = st.sampled_from([None, ("prefill", "unified"), ("decode",)])


@settings(max_examples=200, deadline=None)
@given(statuses=_statuses, rr=st.integers(0, 50), roles=_roles,
       depth=st.integers(0, len(HASHES)))
def test_choose_engine_matches_the_jax_package(statuses, rr, roles, depth):
    js = [_to_jax(s) for s in statuses]
    hashes = HASHES[:depth]
    for strat in SchedulingStrategy:
        jstrat = jsched.SchedulingStrategy(strat.value)
        assert (choose_engine(strat, statuses, rr, roles=roles,
                              prefix_hashes=hashes)
                == jsched.choose_engine(jstrat, js, rr, roles=roles,
                                        prefix_hashes=hashes))
    assert ([s.engine_id for s in health_tier(statuses)]
            == [s.engine_id for s in jsched.health_tier(js)])
    for s, j in zip(statuses, js):
        assert (prefix_match_depth(s, hashes)
                == jsched.prefix_match_depth(j, hashes))


@settings(max_examples=200, deadline=None)
@given(statuses=_statuses, roles=_roles,
       depth=st.integers(0, len(HASHES)),
       costs=st.builds(FetchCosts, enabled=st.booleans(),
                       min_pages=st.integers(1, 4),
                       page_cost=st.sampled_from([0.0, 0.25, 0.5, 1.5]),
                       load_cost_pages=st.sampled_from([0.0, 1.0, 4.0]),
                       wire_frac=st.sampled_from([1.0, 0.53125, 0.25])),
       forced=st.booleans())
def test_plan_route_matches_the_jax_package(statuses, roles, depth, costs,
                                            forced):
    from distributed_inference_server_tpu.serving import faults as jfaults

    js = [_to_jax(s) for s in statuses]
    jcosts = jsched.FetchCosts(**dataclasses.asdict(costs))
    hashes = HASHES[:depth]
    if forced:
        faults.install(parse_spec("sched.fetch_decision:nth=1", 1))
        jfaults.install(jfaults.parse_spec("sched.fetch_decision:nth=1", 1))
    try:
        got = plan_route(statuses, hashes, roles=roles, costs=costs,
                         page_size=PS)
        want = jsched.plan_route(js, hashes, roles=roles, costs=jcosts,
                                 page_size=PS)
    finally:
        faults.clear()
        jfaults.clear()
    assert (dataclasses.asdict(got) if got else None) == (
        dataclasses.asdict(want) if want else None)


class TestChooseEngine:
    def test_round_robin_rotates(self):
        statuses = [_status("e0"), _status("e1"), _status("e2")]
        picks = [choose_engine(SchedulingStrategy.ROUND_ROBIN, statuses, i)
                 for i in range(6)]
        assert picks == ["e0", "e1", "e2", "e0", "e1", "e2"]

    def test_memory_aware_prefers_free_pages(self):
        statuses = [_status("full", used=90), _status("empty", used=10)]
        assert choose_engine(SchedulingStrategy.MEMORY_AWARE, statuses,
                             0) == "empty"

    def test_property20_no_healthy_none(self):
        statuses = [_status("e0", healthy=False),
                    _status("e1", healthy=False)]
        for strat in SchedulingStrategy:
            assert choose_engine(strat, statuses, 0) is None


class _FakeRunner:
    def __init__(self, eid: str, role: str = "unified"):
        self.engine_id = eid
        self.role = role
        self.healthy = True
        self.restarts = 0

    def status(self):
        return _status(self.engine_id, healthy=self.healthy, role=self.role)

    def is_healthy(self):
        return self.healthy

    def restart(self, wait_ready=True):
        self.restarts += 1
        self.healthy = True


class TestAdaptiveScheduler:
    def test_property18_unhealthy_removed_from_routing(self):
        s = AdaptiveScheduler(SchedulingStrategy.ROUND_ROBIN)
        good, bad = _FakeRunner("good"), _FakeRunner("bad")
        s.register(good)
        s.register(bad)
        bad.healthy = False
        assert {s.schedule().engine_id for _ in range(8)} == {"good"}

    def test_property19_recovered_engine_reinstated(self):
        s = AdaptiveScheduler(SchedulingStrategy.ROUND_ROBIN,
                              health_check_interval_s=0.01,
                              auto_restart=True)
        r = _FakeRunner("solo")
        s.register(r)
        r.healthy = False
        assert s.schedule() is None
        s.start_health_loop()
        try:
            deadline = time.monotonic() + 5.0
            while r.restarts == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            s.stop_health_loop()
        assert r.restarts >= 1
        assert s.schedule().engine_id == "solo"

    def test_runtime_strategy_switch(self):
        s = AdaptiveScheduler(SchedulingStrategy.ROUND_ROBIN)
        s.set_strategy(SchedulingStrategy.MEMORY_AWARE)
        assert s.strategy() is SchedulingStrategy.MEMORY_AWARE

    def test_schedule_empty_returns_none(self):
        assert AdaptiveScheduler().schedule() is None

    def test_decode_replicas_take_no_admissions_while_prefill_lives(self):
        s = AdaptiveScheduler(SchedulingStrategy.ROUND_ROBIN)
        pre, dec = _FakeRunner("p", "prefill"), _FakeRunner("d", "decode")
        s.register(pre)
        s.register(dec)
        assert {s.schedule().engine_id for _ in range(4)} == {"p"}
        assert s.schedule_decode(exclude="p").engine_id == "d"
        pre.healthy = False  # a decode replica beats a 503
        assert s.schedule().engine_id == "d"
        assert s.schedule_decode(exclude="d") is None

    def test_health_flap_restarts_a_live_replica(self):
        s = AdaptiveScheduler(health_check_interval_s=0.01,
                              auto_restart=True)
        r = _FakeRunner("live")
        s.register(r)
        faults.install(parse_spec("sched.health_flap:nth=1", 3))
        s.start_health_loop()
        try:
            deadline = time.monotonic() + 5.0
            while r.restarts == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.1)
        finally:
            s.stop_health_loop()
        assert r.restarts == 1  # one-shot flag: one flap, one restart


class _FlakyRunner:
    def __init__(self, eid="engine-x", fail=True):
        self.engine_id = eid
        self.fail = fail
        self.restarts = 0

    def is_healthy(self):
        return False

    def restart(self, wait_ready=True):
        self.restarts += 1
        if self.fail:
            raise RuntimeError("boom")


class TestRestartBackoff:
    def test_failed_restart_backs_off_exponentially(self):
        m = MetricsCollector()
        s = AdaptiveScheduler(auto_restart=True, metrics=m,
                              restart_backoff_s=10.0,
                              restart_backoff_max_s=25.0)
        r = _FlakyRunner()
        delays = []
        for _ in range(4):
            s._restart_one(r)
            not_before, delay = s._backoff[r.engine_id]
            delays.append(delay)
            assert not_before > time.monotonic()
            assert not_before - time.monotonic() <= delay * 1.25 + 0.1
        assert delays == [10.0, 20.0, 25.0, 25.0]
        assert r.restarts == 4
        snap = m.snapshot().to_dict()
        assert snap["resilience"]["engine_restarts"] == {r.engine_id: 4}
        assert (b'engine_restarts_total{engine_id="engine-x"} 4.0'
                in m.prometheus_text())

    def test_successful_restart_resets_backoff(self):
        s = AdaptiveScheduler(auto_restart=True, restart_backoff_s=10.0)
        r = _FlakyRunner()
        s._restart_one(r)
        assert r.engine_id in s._backoff
        r.fail = False
        s._restart_one(r)
        assert r.engine_id not in s._backoff

    def test_health_loop_skips_engine_in_backoff(self):
        s = AdaptiveScheduler(auto_restart=True,
                              health_check_interval_s=0.01,
                              restart_backoff_s=30.0)
        r = _FlakyRunner()
        s.register(r)
        s.start_health_loop()
        try:
            deadline = time.monotonic() + 1.0
            while r.restarts == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.3)
            assert r.restarts == 1
        finally:
            s.stop_health_loop()


# ---------------------------------------------------------------------------
# replica metrics against the JAX collector
# ---------------------------------------------------------------------------


def _record_replicas(c):
    c.record_handoff("ok", latency_s=0.02, nbytes=4096, stall_s=0.003,
                     chunks=3)
    c.record_handoff("retry")
    c.record_handoff("fallback", stall_s=0.04)
    c.record_prefix_fetch("ok", seconds=0.007, nbytes=2048)
    c.record_prefix_fetch("fallback", seconds=0.001)
    c.record_prefix_route("fetch")
    c.record_prefix_route("warm")
    c.record_prefix_route("warm")
    c.set_engines_by_role({"prefill": 1, "decode": 1})
    c.record_engine_restart("engine-1")
    c.record_redispatch("ok")
    c.record_redispatch("exhausted")


def test_replica_metrics_match_the_jax_collector():
    from test_torch_serving_api import REPLICA_FAMILIES, _families

    j, p = jmetrics.MetricsCollector(), pmetrics.MetricsCollector()
    _record_replicas(j)
    _record_replicas(p)
    jf = _families(j.prometheus_text().decode())
    pf = _families(p.prometheus_text().decode())
    for name in REPLICA_FAMILIES:
        assert pf[name][:2] == jf[name][:2], name
        assert pf[name][2] == pytest.approx(jf[name][2]), name
    statuses = (_status("engine-0", role="prefill"),
                _status("engine-1", role="decode"))
    js = j.snapshot(tuple(_to_jax(s) for s in statuses)).to_dict()
    ps = p.snapshot(statuses).to_dict()
    assert ps["disagg"] == js["disagg"]
    assert ps["resilience"] == js["resilience"]
    for key in ("peer_fetch", "route_decisions"):
        assert ps["cache"][key] == js["cache"][key], key
    assert ([w["role"] for w in ps["worker_statuses"]]
            == [w["role"] for w in js["worker_statuses"]])


# ---------------------------------------------------------------------------
# a two-replica server
# ---------------------------------------------------------------------------


def engine_config(**kw) -> EngineConfig:
    return EngineConfig(max_batch=4, prefill_buckets=BUCKETS,
                        paged=PagedCacheConfig(*PAGED), **kw)


def p_factory(**kw):
    def factory():
        return LLMEngine(_pp(), TINY, TOK, engine_config(**kw),
                         dtype=torch.float32, device="cpu")
    return factory


class Sink:
    def __init__(self):
        self.toks, self.text = [], ""
        self.done = None
        self.errors = []
        self.terminals = 0
        self.first_token = threading.Event()
        self.ev = threading.Event()

    def on_token(self, token_id, text, token_index, logprob=None):
        if token_id is not None:
            self.toks.append(token_id)
            self.first_token.set()
        self.text += text

    def on_done(self, finish_reason, usage):
        self.done = (finish_reason, usage)
        self.terminals += 1
        self.ev.set()

    def on_error(self, message, code):
        self.errors.append((message, code))
        self.terminals += 1
        self.ev.set()

    def result(self):
        """(tokens, text, (prompt_tokens, completion_tokens))."""
        _, usage = self.done
        return (self.toks, self.text,
                (usage.prompt_tokens, usage.completion_tokens))


def submit(srv, rid, prompt, max_tokens=12):
    sink = Sink()
    srv.dispatcher.submit(ServerRequest(
        rid, TOK.encode(prompt),
        SamplingParams(max_tokens=max_tokens, temperature=0.0), sink))
    return sink


def run(srv, rid, prompt, max_tokens=12):
    sink = submit(srv, rid, prompt, max_tokens)
    assert sink.ev.wait(120), f"{rid} did not complete"
    assert not sink.errors, sink.errors
    assert sink.terminals == 1
    return sink.result()


_JAX_REFS = {}


def jax_ref(prompt, max_tokens=12):
    """The JAX engine's greedy (tokens, text, usage) from a cold cache."""
    key = (prompt, max_tokens)
    if key not in _JAX_REFS:
        from distributed_inference_server_tpu.engine import engine as jeng

        eng = _JAX_REFS.setdefault("engine", j_engine())
        eng.evict_cache(0.0)
        eng.add_request("ref", TOK.encode(prompt),
                        jeng.SamplingParams(max_tokens=max_tokens,
                                            temperature=0.0))
        toks, text, usage = [], "", None
        while eng.has_work():
            for o in eng.step():
                assert o.error is None, o.error
                if o.token_id is not None:
                    toks.append(o.token_id)
                text += o.text
                if o.finished:
                    usage = (o.usage.prompt_tokens,
                             o.usage.completion_tokens)
        _JAX_REFS[key] = (toks, text, usage)
    return _JAX_REFS[key]


def heal(srv):
    for r in srv.scheduler.engines():
        if not r.is_healthy():
            r.restart()


@pytest.fixture(scope="module")
def twin():
    srv = InferenceServer(
        p_factory(), TOK, "tiny", num_engines=2,
        strategy=SchedulingStrategy.ROUND_ROBIN, auto_restart=False,
        batcher_config=BatcherConfig(window_ms=0))
    srv.start()
    yield srv
    faults.clear()
    srv.shutdown(drain_timeout_s=5.0)


def test_round_robin_pair_matches_the_jax_engine(twin):
    before = {s.engine_id: s.total_processed
              for s in twin.scheduler.statuses()}
    for i, prompt in enumerate(PROMPTS):
        assert run(twin, f"rr-{i}", prompt) == jax_ref(prompt)
    after = {s.engine_id: s.total_processed
             for s in twin.scheduler.statuses()}
    assert sorted(after) == ["engine-0", "engine-1"]
    assert all(after[e] - before[e] == 2 for e in after)
    for r in twin.scheduler.engines():
        assert r.audit() == []


def test_concurrent_requests_match_the_jax_engine(twin):
    sinks = [submit(twin, f"cc-{i}", p) for i, p in enumerate(PROMPTS)]
    for sink, prompt in zip(sinks, PROMPTS):
        assert sink.ev.wait(120) and not sink.errors, sink.errors
        assert sink.result() == jax_ref(prompt)


class TestRedispatch:
    """``TestRedispatch`` of ``tests/test_chaos.py`` on the port."""

    def test_zero_token_inflight_completes_on_other_replica(self, twin):
        ref = jax_ref(PROMPTS[0])
        faults.install(parse_spec("runner.inbox:nth=1", seed=1))
        got = submit(twin, "chaos-redispatch", PROMPTS[0])
        assert got.ev.wait(120)
        faults.clear()
        assert not got.errors, got.errors
        assert got.terminals == 1
        assert got.result() == ref
        assert len([r for r in twin.scheduler.engines()
                    if r.is_healthy()]) == 1
        snap = twin.metrics.snapshot().to_dict()
        assert snap["resilience"]["redispatched"].get("ok", 0) >= 1
        assert ('requests_redispatched_total{outcome="ok"}'
                in twin.metrics.prometheus_text().decode())
        for r in twin.scheduler.engines():
            assert r.audit() == []
        heal(twin)

    def test_exhausted_attempts_fail_visibly_once(self, twin):
        faults.install(parse_spec("runner.inbox:nth=1,times=10", seed=2))
        got = submit(twin, "chaos-exhaust", PROMPTS[0])
        assert got.ev.wait(120)
        faults.clear()
        assert got.terminals == 1
        assert len(got.errors) == 1
        assert got.errors[0][1] == "worker_failure"
        snap = twin.metrics.snapshot().to_dict()
        assert snap["resilience"]["redispatched"].get("exhausted", 0) >= 1
        heal(twin)

    def test_token_emitting_request_fails_fast_engine_crashed(self, twin):
        sink = submit(twin, "chaos-midstream", PROMPTS[1], max_tokens=100)
        assert sink.first_token.wait(60), "no first token"
        faults.install(parse_spec("runner.step:nth=1", seed=3))
        assert sink.ev.wait(60), "no terminal event after injected crash"
        faults.clear()
        assert sink.terminals == 1
        assert len(sink.errors) == 1
        assert sink.errors[0][1] == "engine_crashed"
        heal(twin)


def test_restart_releases_the_dead_engine_and_serves_the_same_text(twin):
    r = twin.runner
    old = weakref.ref(r._engine)
    r.restart()
    gc.collect()
    assert old() is None  # the dead engine's pools and graphs are gone
    assert r.is_healthy() and r.restarts >= 1
    twin.scheduler.set_strategy(SchedulingStrategy.LEAST_LOADED)
    try:
        assert run(twin, "after-restart", PROMPTS[2]) == jax_ref(PROMPTS[2])
    finally:
        twin.scheduler.set_strategy(SchedulingStrategy.ROUND_ROBIN)


def test_scale_up_and_down_with_a_request_in_flight(twin):
    twin.scale_to(3)
    runners = twin.scheduler.engines()
    assert [r.engine_id for r in runners][-1] == "engine-2"
    third = runners[-1]
    assert third.is_healthy() and third.role == "unified"
    # pin the in-flight request to the replica that scale-down retires
    third.submit([ServerRequest(
        "scale-inflight", TOK.encode(PROMPTS[3]),
        SamplingParams(max_tokens=40, temperature=0.0), sink := Sink())])
    assert sink.first_token.wait(60)
    old = weakref.ref(third._engine)
    twin.scale_to(2)
    assert third not in twin.scheduler.engines()
    assert sink.ev.wait(60) and not sink.errors, sink.errors
    assert sink.result() == jax_ref(PROMPTS[3], 40)
    deadline = time.monotonic() + 10
    while old() is not None and time.monotonic() < deadline:
        time.sleep(0.05)
        gc.collect()
    assert old() is None and not third.is_healthy()
    assert len(twin.scheduler.engines()) == 2


def test_health_and_stats_over_the_replicas(twin):
    port = twin.serve("127.0.0.1", 0, block=False)
    base = f"http://127.0.0.1:{port}"
    with urllib.request.urlopen(base + "/health") as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok"
    assert [e["engine_id"] for e in health["engines"]] == [
        "engine-0", "engine-1"]
    with urllib.request.urlopen(base + "/server/stats") as resp:
        stats = json.loads(resp.read())
    assert [w["engine_id"] for w in stats["worker_statuses"]] == [
        "engine-0", "engine-1"]
    assert [r["engine_id"] for r in stats["replicas"]] == [
        "engine-0", "engine-1"]
    assert stats["strategy"] == "round_robin"
    assert stats["healthy"] and len(stats["replicas"][1]["kernel_launches"])
    req = urllib.request.Request(base + "/admin/scale",
                                 data=b'{"num_engines": 0}', method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400
    body = json.dumps({"prompt": PROMPTS[0], "max_tokens": 12,
                       "temperature": 0.0}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            base + "/generate", data=body, method="POST")) as resp:
        out = json.loads(resp.read())
    assert out["choices"][0]["text"] == jax_ref(PROMPTS[0])[1]


def test_health_loop_restarts_a_crashed_replica():
    srv = InferenceServer(
        p_factory(), TOK, "tiny", num_engines=2,
        strategy=SchedulingStrategy.ROUND_ROBIN, auto_restart=True,
        health_check_interval_s=0.05,
        batcher_config=BatcherConfig(window_ms=0))
    srv.start()
    try:
        faults.install(parse_spec("runner.step:nth=1", seed=4))
        got = submit(srv, "flap", PROMPTS[1])
        assert got.ev.wait(60)
        faults.clear()
        # the crash hit the first step: no token streamed, so the request
        # ran again on the other replica
        assert not got.errors and got.result() == jax_ref(PROMPTS[1])
        deadline = time.monotonic() + 30
        while (not all(r.is_healthy() for r in srv.scheduler.engines())
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert all(r.is_healthy() for r in srv.scheduler.engines())
        snap = srv.metrics.snapshot().to_dict()
        assert sum(snap["resilience"]["engine_restarts"].values()) == 1
        for i in range(2):  # both replicas serve the same text again
            assert run(srv, f"healed-{i}", PROMPTS[2]) == jax_ref(PROMPTS[2])
    finally:
        srv.shutdown(drain_timeout_s=5.0)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

_BASE = ["--model-model-name", "tiny", "--device", "cpu"]


@pytest.mark.parametrize("flags,message", [
    (["--server-num-engines", "2", "--server-engine-roles", "prefill"],
     "lists 1 roles but server.num_engines is 2"),
    (["--server-num-engines", "2", "--server-engine-roles",
      "decode,decode"], "decode engines without any prefill"),
    (["--server-num-engines", "2", "--server-engine-roles",
      "prefill,prefill"], "need at least one decode"),
    (["--server-engine-roles", "router"], "unknown role"),
    (["--server-strategy", "fastest"], "server.strategy"),
    (["--server-num-engines", "0"], "server.num_engines"),
    (["--server-max-redispatch", "-1"], "server.max_redispatch"),
    (["--server-restart-backoff-max-s", "0.5"], "restart_backoff_max_s"),
    (["--disagg-channel", "grpc"], "disagg.channel"),
    (["--disagg-wire-quant", "latent"], "needs cache.latent_rank"),
    (["--disagg-stream", "maybe"], "disagg.stream"),
    (["--cache-digest-depth", "0"], "cache.digest_depth"),
    (["--cache-fetch-page-cost", "-1"], "cache.fetch_page_cost"),
    (["--faults-spec", "runner.step:nth=x"], "faults.spec"),
])
def test_cli_config_errors(flags, message, capsys):
    assert cli.main(_BASE + flags) == 2
    err = capsys.readouterr().err
    assert "config error:" in err and message in err, err


def test_cli_builds_the_replica_settings():
    from distributed_inference_server_tpu_torch.serving.config import (
        ServerConfig,
    )

    cfg = ServerConfig.load(cli_args=[
        "--model-model-name", "tiny",
        "--server-num-engines", "2", "--server-engine-roles",
        "prefill,decode", "--server-strategy", "cache_aware",
        "--disagg-channel", "protowire", "--disagg-wire-quant", "int8",
        "--disagg-stream", "false", "--cache-digest-depth", "12",
        "--faults-spec", "runner.step:nth=3", "--faults-seed", "5"],
        environ={})
    got = cli._replica_settings(cfg, TINY, torch.float32)
    assert cli.engine_settings(cfg).digest_depth == 12
    assert got["engine_roles"] == ["prefill", "decode"]
    assert got["strategy"] is SchedulingStrategy.CACHE_AWARE
    assert got["disagg_settings"].channel == "protowire"
    assert got["disagg_settings"].stream is False
    # int8 over f32: (D + 4) / 4D of the raw bytes, the JAX config's
    # wire_frac
    from distributed_inference_server_tpu.engine.kv_cache import (
        encoded_page_fraction,
    )

    D = TINY.head_dim
    assert got["fetch_costs"].wire_frac == (D + 4) / (4 * D)
    assert got["fetch_costs"].wire_frac == encoded_page_fraction(
        "int8", 4, D, 0)
    assert got["faults"].fired_count("runner.step") == 0
