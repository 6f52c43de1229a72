"""The fleet's control plane served on the CPU: port processes' servers
joined over real localhost connections, TINY f32 engines with weights
shared with a JAX engine (the ``fleet_pair`` of ``tests/test_fleet.py``).

- A port registry host (one local engine, HTTP, round robin) and a port
  member (one engine): a request served through the ``RemoteRunner`` gives
  the JAX engine's greedy tokens and the host engine's; killing the member
  with a zero-token request in flight completes it exactly once by
  redispatch with the same tokens, the member reads ``dead`` in the
  registry and in ``/metrics``, the page audits are clean and no remote
  proxy is left in the routing set (``TestFleetServingE2E``).
- Interop both ways: a port ``FleetWorker`` joins a JAX ``FleetServer`` and
  a JAX ``FleetWorker`` joins a port ``FleetServer``; each serves a request
  with the JAX engine's greedy tokens.
- Stitched tracing and telemetry: a remote-served HTTP request's
  ``trace_id`` holds spans from both servers with intact parent links, and
  the host's ``/server/perf`` ``fleet`` block counts the member's digests.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.engine.engine import (
    EngineConfig as JEngineConfig,
)
from distributed_inference_server_tpu.engine.engine import LLMEngine as JEngine
from distributed_inference_server_tpu.engine.engine import (
    SamplingParams as JSamplingParams,
)
from distributed_inference_server_tpu.engine.kv_cache import (
    PagedCacheConfig as JPagedCacheConfig,
)
from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models import tokenizer as jtok
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu.serving import fleet as jfleet
from distributed_inference_server_tpu.serving import (
    remote_runner as jremote,
)
from distributed_inference_server_tpu.serving import runner as jrunner
from distributed_inference_server_tpu.serving import scheduler as jsched
from distributed_inference_server_tpu.serving.metrics import (
    MetricsCollector as JMetrics,
)
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PagedCacheConfig,
)
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving.fleet import (
    FleetRegistry,
    FleetServer,
    FleetSettings,
)
from distributed_inference_server_tpu_torch.serving.metrics import (
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.remote_runner import (
    FleetWorker,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    ServerRequest,
)
from distributed_inference_server_tpu_torch.serving.scheduler import (
    AdaptiveScheduler,
    SchedulingStrategy,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)

PAGED = (192, 8, 32)
BUCKETS = (16, 64)
PROMPT = "fleet e2e prompt"
MAX_TOKENS = 8
BEAT = dict(heartbeat_interval_s=0.1, suspect_after_s=0.4, dead_after_s=0.9)


def _tree():
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * 8.0
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * 8.0
    return tree


TREE = _tree()
J_PARAMS = jax.tree_util.tree_map(jnp.asarray, TREE)


def _port_factory():
    params = params_from_numpy(TREE, device="cpu", dtype=torch.float32)

    def make() -> LLMEngine:
        return LLMEngine(params, TINY, ByteTokenizer(),
                         EngineConfig(max_batch=4, prefill_buckets=BUCKETS,
                                      paged=PagedCacheConfig(*PAGED)),
                         dtype=torch.float32, device="cpu")

    return make


def _jax_engine() -> JEngine:
    return JEngine(J_PARAMS, J_TINY, jtok.ByteTokenizer(),
                   JEngineConfig(max_batch=4, prefill_buckets=BUCKETS,
                                 paged=JPagedCacheConfig(*PAGED),
                                 warmup_compile=False),
                   dtype=jnp.float32)


def _jax_greedy(prompt: str = PROMPT) -> list:
    eng = _jax_engine()
    eng.add_request("ref", list(prompt.encode()), JSamplingParams(
        max_tokens=MAX_TOKENS, temperature=0.0))
    toks = []
    while eng.has_work():
        for o in eng.step():
            if o.token_id is not None:
                toks.append(o.token_id)
    return toks


class _Sink:
    def __init__(self):
        self.toks, self.text = [], ""
        self.errors, self.dones = [], 0
        self.ev = threading.Event()

    def on_token(self, token_id, text, token_index, logprob=None):
        if token_id is not None:
            self.toks.append(token_id)
        self.text += text

    def on_done(self, reason, usage):
        self.dones += 1
        self.ev.set()

    def on_error(self, message, code):
        self.errors.append((message, code))
        self.ev.set()


def _serve(runner, rid, req_cls=ServerRequest, params_cls=SamplingParams):
    sink = _Sink()
    runner.submit([req_cls(rid, list(PROMPT.encode()),
                           params_cls(max_tokens=MAX_TOKENS,
                                      temperature=0.0), sink)])
    assert sink.ev.wait(90), f"{rid} never terminated"
    return sink


def _wait(pred, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    pytest.fail(f"timed out waiting for {what}")


def _remote_of(sched, prefix=""):
    return [r for r in sched.engines()
            if getattr(r, "is_remote", False)
            and r.engine_id.startswith(prefix)]


class Fleet:
    def __init__(self):
        self.host = InferenceServer(
            _port_factory(), ByteTokenizer(), "tiny", num_engines=1,
            auto_restart=False, strategy=SchedulingStrategy.ROUND_ROBIN,
            fleet_settings=FleetSettings(enabled=True, **BEAT))
        self.host.start()
        self.port = self.host.serve("127.0.0.1", 0, block=False)
        self.base = f"http://127.0.0.1:{self.port}"
        self.member = InferenceServer(_port_factory(), ByteTokenizer(),
                                      "tiny", num_engines=1,
                                      auto_restart=False)
        self.member.start()
        self.worker = FleetWorker(
            self.member.scheduler,
            FleetSettings(connect=f"127.0.0.1:"
                                  f"{self.host.fleet_server.bound_port}",
                          heartbeat_interval_s=0.1),
            metrics=self.member.metrics, member_id="t-w1",
            tracer=self.member.tracer)
        self.worker.start()
        _wait(lambda: any(r.is_healthy()
                          for r in _remote_of(self.host.scheduler)),
              what="the member to join")
        self.ref = _jax_greedy()

    def local(self):
        return self.host.local_runners()[0]

    def remote(self):
        return _remote_of(self.host.scheduler, "t-w1:")[0]

    def close(self):
        faults.clear()
        self.worker.stop()
        self.member.shutdown(drain_timeout_s=5.0)
        self.host.shutdown(drain_timeout_s=5.0)


@pytest.fixture(scope="module")
def fleet_pair():
    f = Fleet()
    yield f
    f.close()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# interop with the JAX package's fleet
# ---------------------------------------------------------------------------


def test_port_worker_joins_a_jax_registry_host(fleet_pair):
    """A JAX ``FleetServer`` routes a request to the port member through
    its own ``RemoteRunner``: the JAX engine's greedy tokens come back."""
    jsettings = jfleet.FleetSettings(enabled=True, **BEAT)
    jreg = jfleet.FleetRegistry(jsettings, metrics=JMetrics())
    jscheduler = jsched.AdaptiveScheduler()
    jserver = jfleet.FleetServer(jreg, jscheduler, jsettings)
    jserver.start()
    worker = FleetWorker(fleet_pair.member.scheduler, FleetSettings(
        connect=f"127.0.0.1:{jserver.bound_port}", heartbeat_interval_s=0.1),
        member_id="t-w2")
    try:
        worker.start()
        _wait(lambda: any(r.is_healthy() for r in _remote_of(jscheduler)),
              what="the port member to join the JAX host")
        (proxy,) = _remote_of(jscheduler)
        assert proxy.engine_id == "t-w2:engine-0"
        sink = _serve(proxy, "jh-1", jrunner.ServerRequest, JSamplingParams)
        assert sink.errors == [] and sink.dones == 1
        assert sink.toks == fleet_pair.ref
        assert jreg.stats()["member_counts"]["alive"] == 1
    finally:
        worker.stop()
        jserver.stop()


def test_jax_worker_joins_a_port_registry_host(fleet_pair):
    """A JAX member (its own ``EngineRunner`` and ``FleetWorker``) joins a
    port ``FleetServer``; the port proxy's request gets the JAX engine's
    greedy tokens."""
    settings = FleetSettings(enabled=True, **BEAT)
    metrics = MetricsCollector()
    reg = FleetRegistry(settings, metrics=metrics)
    scheduler = AdaptiveScheduler()
    server = FleetServer(reg, scheduler, settings, metrics=metrics)
    server.start()
    jscheduler = jsched.AdaptiveScheduler()
    jr = jrunner.EngineRunner("engine-0", _jax_engine, JMetrics())
    jr.start(wait_ready=True)
    jscheduler.register(jr)
    jworker = jremote.FleetWorker(jscheduler, jfleet.FleetSettings(
        connect=f"127.0.0.1:{server.bound_port}", heartbeat_interval_s=0.1,
        kv_enabled=False), member_id="j-w1")
    try:
        jworker.start()
        _wait(lambda: any(r.is_healthy() for r in _remote_of(scheduler)),
              what="the JAX member to join the port host")
        (proxy,) = _remote_of(scheduler)
        assert proxy.engine_id == "j-w1:engine-0"
        sink = _serve(proxy, "ph-1")
        assert sink.errors == [] and sink.dones == 1
        assert sink.toks == fleet_pair.ref
        stats = reg.stats()
        assert stats["members"][0]["engines"] == {
            "j-w1:engine-0": "unified"}
    finally:
        jworker.stop()
        server.stop()
        jr.shutdown()


# ---------------------------------------------------------------------------
# stitched tracing and telemetry
# ---------------------------------------------------------------------------


def test_remote_request_trace_and_member_telemetry(fleet_pair):
    """Two HTTP requests under round robin: one is served by the member,
    with the host engine's text. Its trace holds the host's root span and the member's ``fleet.serve``
    and ``engine.infer`` spans, parent-linked; the host's ``/server/perf``
    counts the member's TTFT digest."""
    f = fleet_pair
    remote_trees, texts = [], set()
    for _ in range(2):
        body = _post(f.base, "/generate", {"prompt": PROMPT,
                                           "max_tokens": MAX_TOKENS,
                                           "temperature": 0.0})
        texts.add(body["choices"][0]["text"])
        rid = body["id"][len("cmpl-"):]

        def member_spans(rid=rid):
            spans = _get(f.base, f"/server/trace?request_id={rid}")["spans"]
            return spans if any(s["attributes"].get("member") == "t-w1"
                                for s in spans) else None

        deadline = time.monotonic() + 5.0
        spans = None
        while spans is None and time.monotonic() < deadline:
            spans = member_spans()
            time.sleep(0.1)
        if spans is not None:
            remote_trees.append(spans)
    assert len(remote_trees) == 1, "round robin sent one request remote"
    assert len(texts) == 1  # the member's text is the host engine's
    spans = {s["name"]: s for s in remote_trees[0]}
    assert {"request.generate", "fleet.serve", "engine.infer"} <= set(spans)
    root, serve, infer = (spans["request.generate"], spans["fleet.serve"],
                          spans["engine.infer"])
    assert "member" not in root["attributes"]
    assert serve["attributes"]["member"] == "t-w1"
    assert infer["attributes"]["member"] == "t-w1"
    assert serve["parent_id"] == root["span_id"]
    assert infer["parent_id"] == serve["span_id"]
    assert len({root["trace_id"], serve["trace_id"],
                infer["trace_id"]}) == 1

    def member_ttft_n():
        perf = _get(f.base, "/server/perf")
        member = perf.get("fleet", {}).get("members", {}).get("t-w1")
        if not member or "ttft_ms" not in member["digests"]:
            return 0
        return sum(e.get("n", 0)
                   for e in member["digests"]["ttft_ms"].get("epochs", []))

    _wait(lambda: member_ttft_n() >= 1, 10.0, "the member's telemetry")
    stats = _get(f.base, "/server/stats")
    assert stats["fleet"]["member_counts"]["alive"] == 1
    assert stats["fleet"]["role_map"] == {"engine-0": "unified",
                                          "t-w1:engine-0": "unified"}
    assert stats["fleet"]["heartbeats"]["ok"] > 0
    assert [r["engine_id"] for r in stats["replicas"]] == ["engine-0"]
    prom = f.host.metrics_text().decode()
    assert 'fleet_telemetry_frames_total{outcome="ingested"}' in prom
    assert 'fleet_member_ttft_p99_ms{member="t-w1"}' in prom


# ---------------------------------------------------------------------------
# serving, death and redispatch (runs last: it kills the member)
# ---------------------------------------------------------------------------


class TestFleetServingE2E:
    def test_remote_serving_token_identical_then_death_redispatch(
            self, fleet_pair):
        f = fleet_pair
        ref = _serve(f.local(), "fe-ref")
        got = _serve(f.remote(), "fe-remote")
        assert ref.errors == [] and got.errors == []
        assert got.toks == ref.toks == f.ref
        assert got.text == ref.text

        remote = f.remote()
        kill = _Sink()
        remote.submit([ServerRequest("fe-kill", list(PROMPT.encode()),
                                     SamplingParams(max_tokens=MAX_TOKENS,
                                                    temperature=0.0), kill)])
        f.worker._crashed = True
        f.worker._close()
        assert kill.ev.wait(90), "the killed request never terminated"
        assert kill.errors == [] and kill.dones == 1
        assert kill.toks == f.ref  # redispatched, identical
        _wait(lambda: f.host.fleet_registry.member_state("t-w1") == "dead",
              15.0, "the member to read dead")
        prom = f.host.metrics_text().decode()
        assert 'fleet_members{state="dead"} 1.0' in prom
        snap = f.host.metrics.snapshot().to_dict()
        assert snap["resilience"]["redispatched"].get("ok", 0) >= 1
        assert f.local().audit() == []
        for r in f.member.local_runners():
            assert r.audit() == []
        assert _remote_of(f.host.scheduler) == []
        # exactly once: nothing more reaches the sink
        time.sleep(0.3)
        assert kill.dones == 1 and kill.errors == []
