"""The control and observability plane, served in process on the CPU: one
port server with two TINY f32 replicas (weights shared with JAX engines),
a model resolver, an SLO and the validator limit the entry point derives
from its config.

- Hot swap (the cases of ``tests/test_hot_swap.py``): new requests follow
  the swap, and their greedy texts equal the JAX engine's for model-a and
  model-b (model-a with a zero final norm) on either side of it; a broken
  factory keeps the old model; an unknown name is a 500 and an empty body
  a 400; a request in flight finishes on the old model; the runner drains
  and releases its old engine. A swap to another family's name retargets
  the chat template and the tokenizer.
- ``/server/trace``, ``/server/requests`` (and ``/<id>``), ``/server/perf``
  and ``/metrics`` answer in the JAX shapes; the span tree of a request has
  its parent links.
- An over-long prompt is a 400 at the validator (the entry point lowers
  the context limit to what the engine can seat), and a request shed by
  deadline-aware admission is a 503 ``admission_shed`` with
  ``Retry-After``.
- A traced request whose replica crashes before its first token is
  redispatched, and its span carries the hop
  (``tests/test_chaos.py::test_redispatch_with_traced_request``).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
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
from distributed_inference_server_tpu_torch.__main__ import (
    validator_settings,
)
from distributed_inference_server_tpu_torch.core.models import ChatMessage
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
from distributed_inference_server_tpu_torch.serving.config import (
    ServerConfig,
)
from distributed_inference_server_tpu_torch.serving.health import (
    AdmissionControl,
    AdmissionSettings,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    EngineRunner,
    ServerRequest,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)
from distributed_inference_server_tpu_torch.serving.teledigest import (
    SloSettings,
)

PAGED = (64, 8, 16)  # 128 tokens a sequence
BUCKETS = (16, 64)
PROMPT = "swap test"
LONG = "long one"


def _tree(zero_final_norm: bool = False):
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * 8.0
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * 8.0
    if zero_final_norm:
        # every logit 0: greedy emits token id 0, a model apart from a's
        tree["final_norm"] = tree["final_norm"] * 0.0
    return tree


TREES = {"model-a": _tree(), "model-b": _tree(zero_final_norm=True)}


def _factory(name: str, tokenizer=None):
    params = params_from_numpy(TREES[name], device="cpu",
                               dtype=torch.float32)

    def make() -> LLMEngine:
        return LLMEngine(params, TINY, tokenizer or ByteTokenizer(),
                         EngineConfig(max_batch=4, prefill_buckets=BUCKETS,
                                      paged=PagedCacheConfig(*PAGED)),
                         dtype=torch.float32, device="cpu")

    return make


QWEN_TOK = ByteTokenizer()


def _resolver(name: str):
    if name in TREES:
        return _factory(name)
    if name == "qwen-tiny":  # another chat family, model-a's weights
        return _factory("model-a", QWEN_TOK)
    if name == "model-broken":
        def broken():
            raise RuntimeError("weights corrupted")

        return broken
    raise KeyError(f"unknown model {name!r}")


class Stack:
    def __init__(self):
        cfg = ServerConfig.load(cli_args=[
            "--engine-page-size", str(PAGED[1]),
            "--engine-max-pages-per-seq", str(PAGED[2])], environ={})
        self.server = InferenceServer(
            _factory("model-a"), ByteTokenizer(), "model-a", num_engines=2,
            auto_restart=False, model_resolver=_resolver,
            validator_config=validator_settings(cfg),
            slo_settings=SloSettings(ttft_ms=60_000.0))
        self.server.start()
        self.port = self.server.serve("127.0.0.1", 0, block=False)
        self.base = f"http://127.0.0.1:{self.port}"
        # one JAX engine; its params are switched per model (they are
        # arguments of its compiled programs, so nothing recompiles)
        self.j_params = {name: jax.tree_util.tree_map(jnp.asarray, tree)
                         for name, tree in TREES.items()}
        self.j_engine = JEngine(
            self.j_params["model-a"], J_TINY, jtok.ByteTokenizer(),
            JEngineConfig(max_batch=4, prefill_buckets=BUCKETS,
                          paged=JPagedCacheConfig(*PAGED),
                          attention_impl="xla", native_allocator=False),
            dtype=jnp.float32)
        self._n = 0

    def jax_text(self, model: str, ids, max_tokens: int) -> str:
        eng = self.j_engine
        eng.params = self.j_params[model]
        self._n += 1
        eng.add_request(f"j{self._n}", list(ids), JSamplingParams(
            max_tokens=max_tokens, temperature=0.0))
        text = ""
        while eng.has_work():
            for o in eng.step():
                text += o.text
        return text


@pytest.fixture(scope="module")
def stack():
    s = Stack()
    yield s
    s.server.shutdown(drain_timeout_s=5.0)


def _post(base, path, body, timeout=120):
    data = json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _gen(stack, prompt=PROMPT, max_tokens=8):
    status, _, body = _post(stack.base, "/generate", {
        "prompt": prompt, "max_tokens": max_tokens, "temperature": 0.0})
    assert status == 200, body
    return body


def _swap(stack, name):
    return _post(stack.base, "/admin/model-swap", {"model": name})


# ---------------------------------------------------------------------------
# hot swap
# ---------------------------------------------------------------------------


def test_swap_switches_new_requests(stack):
    tok = ByteTokenizer()
    before = _gen(stack)
    assert before["choices"][0]["text"] == stack.jax_text(
        "model-a", tok.encode(PROMPT), 8)
    status, _, body = _swap(stack, "model-b")
    assert (status, body) == (200, {"status": "ok", "model": "model-b"})
    after = _gen(stack)
    assert after["model"] == "model-b"
    assert after["choices"][0]["text"] == stack.jax_text(
        "model-b", tok.encode(PROMPT), 8)
    assert after["choices"][0]["text"] != before["choices"][0]["text"]
    # the swap back gives model-a's cold texts again
    assert _swap(stack, "model-a")[0] == 200
    assert _gen(stack)["choices"][0]["text"] == before["choices"][0]["text"]


def test_swap_failure_keeps_old_model(stack):
    before = _gen(stack)
    status, _, body = _swap(stack, "model-broken")
    assert status == 500 and body["error"]["code"] == "swap_failed"
    assert "weights corrupted" in body["error"]["message"]
    after = _gen(stack)
    assert after["model"] == "model-a"
    assert after["choices"][0]["text"] == before["choices"][0]["text"]


def test_swap_unknown_model_rejected(stack):
    assert _swap(stack, "nope")[0] == 500
    status, _, body = _post(stack.base, "/admin/model-swap", {})
    assert status == 400 and body["error"]["code"] == "invalid_body"


def test_inflight_finishes_on_old_model(stack):
    want = stack.jax_text("model-a", ByteTokenizer().encode(LONG), 24)
    box = {}

    def run():
        box["body"] = _gen(stack, LONG, 24)

    t = threading.Thread(target=run)
    t.start()
    # past the admission window: on a replica (its admission queued in
    # the runner's inbox ahead of any swap install)
    deadline = time.monotonic() + 30
    while not any(r.active_count() for r in stack.server.scheduler.engines()):
        assert time.monotonic() < deadline
        time.sleep(0.002)
    assert _swap(stack, "model-b")[0] == 200
    t.join(120)
    got = box["body"]["choices"][0]
    assert got["text"] == want and got["finish_reason"] == "length"
    assert _swap(stack, "model-a")[0] == 200


def test_cross_family_swap_retargets_the_chat_template(stack):
    handler = stack.server.handler
    assert handler.chat_family == "llama3"
    assert _swap(stack, "qwen-tiny")[0] == 200
    try:
        assert handler.chat_family == "chatml"
        assert handler.tok is QWEN_TOK  # the new model's tokenizer
        msgs = [{"role": "user", "content": "hi there"}]
        status, _, body = _post(stack.base, "/chat", {
            "messages": msgs, "max_tokens": 6, "temperature": 0.0})
        assert status == 200
        jt = jtok.ByteTokenizer()
        from distributed_inference_server_tpu.core.models import (
            ChatMessage as JChatMessage,
        )

        ids = jt.encode(jtok.render_chat(
            [JChatMessage.from_dict(m) for m in msgs], jt, "qwen-tiny"),
            add_bos=False)
        assert body["choices"][0]["message"]["content"] == stack.jax_text(
            "model-a", ids, 6)
        assert body["model"] == "qwen-tiny"
    finally:
        assert _swap(stack, "model-a")[0] == 200
    assert handler.chat_family == "llama3"
    assert ChatMessage  # the port's schema is the one served


def test_runner_swap_drains_old_engine_directly():
    from distributed_inference_server_tpu_torch.serving.metrics import (
        MetricsCollector,
    )

    tokens_a, done = [], threading.Event()

    class Sink:
        def __init__(self, out, ev):
            self.out, self.ev = out, ev

        def on_token(self, token_id, text, token_index, logprob=None):
            self.out.append(token_id)

        def on_done(self, finish_reason, usage):
            self.ev.set()

        def on_error(self, message, code):
            self.ev.set()
            raise AssertionError(f"unexpected error: {message}")

    runner = EngineRunner("e0", _factory("model-a"), MetricsCollector())
    runner.start()
    try:
        tok = ByteTokenizer()
        runner.submit([ServerRequest(
            "r1", tok.encode("drain me please"),
            SamplingParams(max_tokens=32, temperature=0.0),
            Sink(tokens_a, done))])
        swapped = threading.Event()
        runner.swap_model(_factory("model-b"), lambda ok, err: swapped.set())
        assert swapped.wait(120) and done.wait(120)
        assert len(tokens_a) >= 31  # finished on the old model
        deadline = time.monotonic() + 10
        while runner._draining and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not runner._draining  # drained and released
        assert runner._engine.cache_stats().hits == 0  # fresh cache
        tokens_b, done_b = [], threading.Event()
        runner.submit([ServerRequest(
            "r2", tok.encode("hello"),
            SamplingParams(max_tokens=4, temperature=0.0),
            Sink(tokens_b, done_b))])
        assert done_b.wait(120) and tokens_b[:3] == [0, 0, 0]
    finally:
        runner.shutdown()


# ---------------------------------------------------------------------------
# observability routes
# ---------------------------------------------------------------------------


def test_trace_and_timeline_in_the_jax_shape(stack):
    body = _gen(stack, "trace me", 6)
    rid = body["id"][len("cmpl-"):]
    status, tr = _get(stack.base, f"/server/trace?request_id={rid}")
    assert status == 200
    spans = {s["name"]: s for s in tr["spans"]}
    assert {"request.generate", "engine.infer"} <= set(spans)
    root, eng = spans["request.generate"], spans["engine.infer"]
    assert eng["parent_id"] == root["span_id"]
    assert eng["trace_id"] == root["trace_id"]
    assert set(root) == {"name", "trace_id", "span_id", "parent_id",
                         "start_ns", "duration_ms", "attributes", "events",
                         "status"}
    assert [e["name"] for e in root["events"]][:2] == ["queued",
                                                       "dispatched"]
    # the admission batch's replica and size ride on the request's own
    # event; the batch has no span of its own
    dispatched = root["events"][1]["attributes"]
    assert dispatched["engine_id"] == eng["attributes"]["engine_id"]
    assert set(dispatched) == {"engine_id", "size"}
    assert dispatched["size"] >= 1
    status, every = _get(stack.base, "/server/trace?n=500")
    assert "batch.dispatch" not in {s["name"] for s in every["spans"]}
    assert [e["name"] for e in eng["events"]] == ["first_chunk",
                                                  "last_chunk",
                                                  "first_token"]
    status, tl = _get(stack.base, f"/server/requests/{rid}")
    assert status == 200 and tl["status"] == "ok" and tl["tokens"] == 6
    assert tl["trace_id"] == root["trace_id"]
    assert abs(sum(tl["phases"].values()) - tl["wall_s"]) < 1e-4
    assert "prefill_start" in {e["name"] for e in tl["events"]}
    assert tl["phases"]["ingress"] >= 0.0
    assert tl["slo"]["verdict"] == "ok"
    assert [e["name"] for e in tl["events"]][0] == "admit"
    status, listing = _get(stack.base, "/server/requests?n=5")
    assert status == 200 and set(listing) == {"requests", "stats"}
    assert _get(stack.base, "/server/trace?n=0")[0] == 400
    assert _get(stack.base, "/server/requests?verdict=maybe")[0] == 400
    status, err = _get(stack.base, "/server/requests/no-such-id")
    assert status == 404 and err["error"]["code"] == "unknown_request"


def test_perf_stats_and_metrics(stack):
    _gen(stack, "perf", 4)
    status, perf = _get(stack.base, "/server/perf")
    assert status == 200
    assert {"as_of_epoch", "epoch_s", "window_s", "engines", "windows",
            "digests", "slo"} <= set(perf)
    assert {"ttft_ms", "tbt_ms", "queue_wait_ms",
            "latency_ms"} <= set(perf["windows"])
    assert perf["slo"]["config"]["ttft_ms"] == 60_000.0
    kinds = perf["engines"]["engine-0"]["kinds"]
    assert kinds["prefill"]["dispatches"] >= 1
    status, health = _get(stack.base, "/health")
    assert status == 200 and health["status"] == "ok"
    status, stats = _get(stack.base, "/server/stats")
    assert set(stats["health"]) >= {"engines", "retry_budget", "admission"}
    assert set(stats["tracing"]) >= {"tracer_dropped", "flight_recorder",
                                     "phase_requests"}
    with urllib.request.urlopen(stack.base + "/metrics", timeout=60) as r:
        text = r.read().decode()
    for family in ("request_phase_seconds", "slo_requests_total",
                   "slo_goodput_tokens_total"):
        assert f"# TYPE {family.replace('_total', '')}" in text or (
            f"# TYPE {family}" in text), family


def test_over_long_prompt_is_a_400(stack):
    # 600 characters estimate 150 tokens, past the 127 the pool can seat
    status, _, body = _post(stack.base, "/generate", {
        "prompt": "x" * 600, "max_tokens": 4})
    assert status == 400, body
    assert body["error"]["error_type"] == "invalid_request_error"


def test_low_priority_reaches_the_ladder_gate(stack):
    """``"priority": "low"`` reaches admission as LOW (Priority.LOW is 0:
    an ``or`` default made it NORMAL), so the ladder's
    REJECT_LOW_PRIORITY rung answers it 503 while normal requests pass."""
    deg = stack.server.degradation
    deg.stop()
    try:
        deg.evaluate(pressure=0.92)
        low = _post(stack.base, "/generate", {"prompt": "low", "max_tokens":
                                              2, "priority": "low"})
        normal = _post(stack.base, "/generate", {"prompt": "normal",
                                                 "max_tokens": 2})
        deg.evaluate(pressure=0.1)
        again = _post(stack.base, "/generate", {"prompt": "low", "max_tokens":
                                                2, "priority": "low"})
    finally:
        deg.evaluate(pressure=0.1)
        deg.start()
    assert (low[0], low[2]["error"]["code"]) == (503, "queue_full")
    assert normal[0] == 200 and again[0] == 200


def test_shed_request_gets_503_admission_shed(stack):
    d = stack.server.dispatcher
    saved = d.admission
    for _ in range(3):  # the queue-wait digest holds samples now
        _gen(stack, "warm", 2)
    d.admission = AdmissionControl(
        AdmissionSettings(deadline_ms=1e-6, min_window_requests=1),
        metrics=stack.server.metrics)
    try:
        status, headers, body = _post(stack.base, "/generate", {
            "prompt": "shed me", "max_tokens": 2})
    finally:
        d.admission = saved
    assert status == 503
    assert body["error"]["code"] == "admission_shed"
    assert int(headers["Retry-After"]) >= 1
    res = stack.server.stats()["resilience"]
    assert res["requests_shed"] == {"default": {"deadline": 1}}


def test_redispatch_with_traced_request(stack):
    class Sink:
        def __init__(self):
            self.ev = threading.Event()
            self.errors, self.terminals = [], 0

        def on_token(self, *a, **k):
            pass

        def on_done(self, *a, **k):
            self.terminals += 1
            self.ev.set()

        def on_error(self, message, code):
            self.terminals += 1
            self.errors.append((message, code))
            self.ev.set()

    server = stack.server
    span = server.tracer.start("request", request_id="chaos-span")
    sink = Sink()
    faults.install(faults.parse_spec("runner.inbox:nth=1", seed=6))
    try:
        server.dispatcher.submit(ServerRequest(
            "chaos-span", ByteTokenizer().encode(PROMPT),
            SamplingParams(max_tokens=10, temperature=0.0), sink,
            span=span))
        assert sink.ev.wait(90), "traced request did not complete"
    finally:
        faults.clear()
    assert not sink.errors and sink.terminals == 1
    events = {n: a for _, n, a in span.events}
    assert events["redispatched"]["reason"]
    assert span.attributes["redispatch_to"]
    tl = server.recorder.timeline("chaos-span")
    assert any(e["name"] == "redispatch" for e in tl["events"])
    for r in server.scheduler.engines():
        if not r.is_healthy():
            r.restart()
    assert all(r.is_healthy() for r in server.scheduler.engines())
