"""The port's API surface, served in process on the CPU, against the JAX
package.

One server runs the port's engine on TINY weights shared with a JAX engine
(float32, every matrix scaled by 8 so greedy continuations vary), with the
paged geometry of ``tests/test_serving_e2e.py`` (256 tokens a sequence, so
an in-validator prompt can exceed it). The cases of
``tests/test_serving_e2e.py`` run against it over HTTP, and:

- every body parses in the JAX schemas (``GenerateResponse``,
  ``ChatResponse``, ``EmbeddingsResponse``, ``ErrorResponse``, and
  ``TokenEvent.from_dict`` for each SSE frame);
- greedy texts equal the JAX engine's for the same prompt ids (for the
  chat routes, the JAX renderer's prompt), and the streamed deltas join
  into the non-streamed text, byte for byte;
- embeddings equal the JAX engine's ``embed_ids`` within 1e-5;
- ``/metrics`` carries every single-replica family of the JAX
  ``MetricsCollector`` after the same record calls, with the same types
  and label names (both texts parsed by ``prometheus_client``'s parser,
  here in the test only);
- a client that closes its stream mid-generation leaves no request and
  no page held.

The cases of ``tests/test_streaming_detok.py`` run on the port's engine.
"""

import http.client
import json
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

from distributed_inference_server_tpu.core import models as jm
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
from distributed_inference_server_tpu.serving import metrics as jmetrics
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
    _Seq,
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
from distributed_inference_server_tpu_torch.serving import metrics as pmetrics
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)

PAGED = (192, 8, 32)  # 256 tokens a sequence
BUCKETS = (16, 64)
MODEL = "tiny-test"
GREEDY = {"temperature": 0.0}


def _tree():
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * 8.0
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * 8.0
    return tree


class Stack:
    """The port's server and a JAX engine on the same weights."""

    def __init__(self):
        tree = _tree()
        t_params = params_from_numpy(tree, device="cpu", dtype=torch.float32)

        def factory():
            return LLMEngine(t_params, TINY, ByteTokenizer(), EngineConfig(
                max_batch=4, prefill_buckets=BUCKETS,
                paged=PagedCacheConfig(*PAGED)), dtype=torch.float32,
                device="cpu")

        self.server = InferenceServer(factory, ByteTokenizer(), MODEL)
        self.server.start()
        port = self.server.serve("127.0.0.1", 0, block=False)
        self.host, self.port = "127.0.0.1", port
        self.base = f"http://127.0.0.1:{port}"
        self.j_engine = JEngine(
            jax.tree_util.tree_map(jnp.asarray, tree), J_TINY,
            jtok.ByteTokenizer(), JEngineConfig(
                max_batch=4, prefill_buckets=BUCKETS,
                paged=JPagedCacheConfig(*PAGED), attention_impl="xla",
                native_allocator=False), dtype=jnp.float32)
        self._lock = threading.Lock()
        self._n = 0

    def jax_text(self, ids, **kw):
        """(text, finish_reason, usage dict) of the JAX engine."""
        kw = {k: tuple(v) if k == "stop_sequences" else v
              for k, v in kw.items()}
        with self._lock:
            self._n += 1
            rid = f"j{self._n}"
            self.j_engine.add_request(rid, ids, JSamplingParams(**kw))
            text, finish, usage = "", None, None
            while self.j_engine.has_work():
                for o in self.j_engine.step():
                    text += o.text
                    if o.finished:
                        finish, usage = o.finish_reason.value, \
                            o.usage.to_dict()
        return text, finish, usage


@pytest.fixture(scope="module")
def stack():
    s = Stack()
    yield s
    s.server.shutdown()


def _post(base, path, body, timeout=120):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, r.headers, r.read()


def _stream(stack, path, body):
    """(status, content type, raw body, number of reads that returned
    data) of a streamed POST."""
    conn = http.client.HTTPConnection(stack.host, stack.port, timeout=120)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    chunks = []
    while True:
        piece = resp.read1(65536)
        if not piece:
            break
        chunks.append(piece)
    conn.close()
    return (resp.status, resp.getheader("Content-Type"), b"".join(chunks),
            len(chunks))


def _events(raw: bytes):
    """The SSE frames of a native stream as JAX ``TokenEvent``s; the last
    frame must be ``[DONE]``."""
    frames = [f for f in raw.decode("utf-8").split("\n\n") if f]
    assert frames[-1] == "data: [DONE]"
    return [jm.TokenEvent.from_dict(json.loads(f[len("data: "):]))
            for f in frames[:-1]]


def _chunks(raw: bytes):
    return [json.loads(line[6:]) for line in raw.decode().splitlines()
            if line.startswith("data: {")]


def _metrics(stack) -> dict:
    _, _, body = _get(stack.base, "/metrics")
    return {f.name: f for f in text_string_to_metric_families(body.decode())}


def _count(fams, family, sample, **labels) -> float:
    return sum(s.value for s in fams[family].samples if s.name == sample
               and all(s.labels.get(k) == v for k, v in labels.items()))


# ---------------------------------------------------------------------------
# /generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prompt,kw", [
    ("hello world", dict(max_tokens=8)),
    ("a longer prompt that spans the second bucket of sixty-four ids.",
     dict(max_tokens=6)),
    ("stop me", dict(max_tokens=12, stop_sequences=["never"])),
])
def test_generate_matches_jax_engine(stack, prompt, kw):
    status, body = _post(stack.base, "/generate",
                         {"prompt": prompt, **GREEDY, **kw})
    assert status == 200, body
    resp = jm.GenerateResponse.from_dict(body)
    assert resp.to_dict() == body
    assert resp.object == "text_completion" and resp.model == MODEL
    assert resp.id.startswith("cmpl-")
    text, finish, usage = stack.jax_text(ByteTokenizer().encode(prompt),
                                         temperature=0.0, **kw)
    assert body["choices"][0]["text"] == text
    assert body["choices"][0]["finish_reason"] == finish
    assert body["usage"] == usage
    assert usage["prompt_tokens"] == len(prompt) + 1  # + BOS


@pytest.mark.parametrize("prompt,max_tokens", [
    ("stream me", 6), ("héllo 🙂 中文", 24), ("a" * 40, 30)])
def test_stream_deltas_join_into_the_text(stack, prompt, max_tokens):
    """``"stream": true`` answers with SSE (it used to be ignored): every
    frame parses as a JAX ``TokenEvent``, the deltas join into the
    non-streamed text byte for byte, and the done event carries its usage
    and finish."""
    body = {"prompt": prompt, "max_tokens": max_tokens, **GREEDY}
    st, plain = _post(stack.base, "/generate", body)
    assert st == 200
    status, ctype, raw, _ = _stream(stack, "/generate",
                                    {**body, "stream": True})
    assert status == 200 and ctype.startswith("text/event-stream")
    raw.decode("utf-8", errors="strict")
    events = _events(raw)
    assert events[-1].type == "done"
    assert events[-1].usage.to_dict() == plain["usage"]
    assert events[-1].finish_reason.value == \
        plain["choices"][0]["finish_reason"]
    toks = [e for e in events[:-1] if e.type == "token"]
    assert len(toks) == len(events) - 1
    joined = "".join(e.token for e in toks)
    assert joined == plain["choices"][0]["text"]
    assert joined.encode() == plain["choices"][0]["text"].encode()
    text, _, _ = stack.jax_text(ByteTokenizer().encode(prompt),
                                temperature=0.0, max_tokens=max_tokens)
    assert joined == text
    with_lp = [e for e in toks if e.logprob is not None]
    assert with_lp and all(e.logprob <= 0.0 for e in with_lp)
    assert all(e.index is not None for e in toks)


def test_concurrent_streams_match_solo(stack):
    prompts = [f"concurrent stream {i}" for i in range(4)]
    solo = [_post(stack.base, "/generate", {"prompt": p, "max_tokens": 7,
                                            **GREEDY})[1]
            for p in prompts]
    out = [None] * 4

    def worker(i):
        out[i] = _stream(stack, "/generate", {"prompt": prompts[i],
                                              "max_tokens": 7, "stream": True,
                                              **GREEDY})[2]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for s, raw in zip(solo, out):
        events = _events(raw)
        assert "".join(e.token for e in events if e.type == "token") == \
            s["choices"][0]["text"]


def test_concurrent_mixed_requests(stack):
    bodies = [None] * 6

    def one(i):
        bodies[i] = _post(stack.base, "/generate", {
            "prompt": f"request number {i}", "max_tokens": 3 + i, **GREEDY})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for i, (status, body) in enumerate(bodies):
        assert status == 200
        assert body["usage"]["completion_tokens"] <= 3 + i


def test_oversized_prompt_fails_alone(stack):
    """A prompt the validator passes but the engine cannot seat (401 ids >
    256) fails alone with a 500; a concurrent request succeeds."""
    out = {}

    def go(name, body):
        out[name] = _post(stack.base, "/generate", body)

    threads = [threading.Thread(target=go, args=("ok", {
        "prompt": "fine", "max_tokens": 4, **GREEDY})),
        threading.Thread(target=go, args=("bad", {
            "prompt": "x" * 400, "max_tokens": 4}))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert out["ok"][0] == 200
    assert out["bad"][0] == 500
    err = jm.ErrorResponse.from_dict(out["bad"][1])
    assert err.error.error_type == "server_error"


@pytest.mark.parametrize("path,body,code", [
    ("/generate", {"prompt": "   "}, "empty_prompt"),
    ("/generate", {"max_tokens": 3}, "missing_field"),
    ("/generate", {"prompt": "x", "temperature": 9.0}, "invalid_parameter"),
    ("/generate", b"{not json", "invalid_json"),
    ("/chat", {"messages": []}, "missing_field"),
    ("/chat", {"messages": [{"role": "user", "content": "  "}]},
     "empty_prompt"),
    ("/chat", {"messages": [{"role": "robot", "content": "x"}]},
     "invalid_json"),
    ("/chat", {"messages": [{"role": "user", "content": "x"}],
               "top_p": 2.0}, "invalid_parameter"),
    ("/embeddings", {"input": ["ok", " "]}, "invalid_parameter"),
    ("/embeddings", {"input": 5}, "invalid_json"),
    ("/embeddings", {"input": []}, "missing_field"),
    ("/v1/completions", {"prompt": "x", "n": 0}, "invalid_json"),
])
def test_errors_use_the_jax_schema(stack, path, body, code):
    status, err = _post(stack.base, path, body)
    assert status == 400
    parsed = jm.ErrorResponse.from_dict(err)
    assert parsed.to_dict() == err
    assert parsed.error.code == code
    assert parsed.error.error_type == "invalid_request_error"


# ---------------------------------------------------------------------------
# /chat
# ---------------------------------------------------------------------------

MESSAGES = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"}]


def _chat_ids(messages):
    """The JAX renderer's prompt (the family table for tiny-test: llama3)
    as byte ids, no BOS id (the template writes its own)."""
    text = jtok.render_chat(
        [jm.ChatMessage.from_dict(m) for m in messages],
        jtok.ByteTokenizer(), MODEL)
    return jtok.ByteTokenizer().encode(text, add_bos=False)


def test_chat_matches_jax_rendering(stack):
    body = {"messages": MESSAGES, "max_tokens": 5, **GREEDY}
    status, resp = _post(stack.base, "/chat", body)
    assert status == 200, resp
    parsed = jm.ChatResponse.from_dict(resp)
    assert parsed.to_dict() == resp
    assert resp["object"] == "chat.completion"
    assert resp["id"].startswith("chatcmpl-")
    assert resp["choices"][0]["message"]["role"] == "assistant"
    text, finish, usage = stack.jax_text(_chat_ids(MESSAGES),
                                         temperature=0.0, max_tokens=5)
    assert resp["choices"][0]["message"]["content"] == text
    assert resp["choices"][0]["finish_reason"] == finish
    assert resp["usage"] == usage
    # streamed, the same text; and /v1/chat/completions, both ways
    _, _, raw, _ = _stream(stack, "/chat", {**body, "stream": True})
    assert "".join(e.token for e in _events(raw) if e.type == "token") == text
    st, v1 = _post(stack.base, "/v1/chat/completions", body)
    assert st == 200 and v1["choices"][0]["message"]["content"] == text
    _, _, raw, _ = _stream(stack, "/v1/chat/completions",
                           {**body, "stream": True})
    assert "".join(c["choices"][0]["delta"].get("content", "")
                   for c in _chunks(raw)) == text


# ---------------------------------------------------------------------------
# /embeddings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["/embeddings", "/v1/embeddings"])
def test_embeddings_match_jax_engine(stack, path):
    """Unit-norm vectors equal to the JAX engine's ``embed_ids`` within
    1e-5; the 150-byte input is longer than the largest bucket (64) and
    is pooled over its three chunks."""
    inputs = ["alpha", "beta gamma", "mean pooling " * 11 + "!!", "é🙂"]
    status, body = _post(stack.base, path, {"input": inputs})
    assert status == 200, body
    resp = jm.EmbeddingsResponse.from_dict(body)
    assert resp.to_dict() == body
    assert resp.object == "list" and resp.model == MODEL
    assert [d.index for d in resp.data] == list(range(len(inputs)))
    assert all(d.object == "embedding" for d in resp.data)
    got = np.array([d.embedding for d in resp.data])
    ids = [ByteTokenizer().encode(t) for t in inputs]
    assert resp.usage.prompt_tokens == sum(len(i) for i in ids)
    assert resp.usage.completion_tokens == 0
    want = stack.j_engine.embed_ids(ids)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_embeddings_single_string_and_model(stack):
    status, body = _post(stack.base, "/embeddings",
                         {"input": "just one", "model": "named"})
    assert status == 200
    assert len(body["data"]) == 1 and body["model"] == "named"


def test_generate_during_embeddings_job_gives_solo_text(stack):
    """A greedy request served while a many-batch embeddings job runs
    (one device batch per runner iteration) gives its solo text."""
    req = {"prompt": "while embedding", "max_tokens": 8, **GREEDY}
    _, solo = _post(stack.base, "/generate", req)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("emb", _post(
        stack.base, "/embeddings",
        {"input": [f"input {i} " * 9 for i in range(24)]})))
    t.start()
    _, during = _post(stack.base, "/generate", req)
    t.join(120)
    assert during["choices"] == solo["choices"]
    assert out["emb"][0] == 200 and len(out["emb"][1]["data"]) == 24


# ---------------------------------------------------------------------------
# /health, /server/stats, /metrics
# ---------------------------------------------------------------------------


def test_health_has_the_jax_shape(stack):
    status, _, raw = _get(stack.base, "/health")
    body = json.loads(raw)
    assert status == 200
    assert body["status"] == "ok" and body["accepting"] is True
    assert body["model"] == MODEL and body["device"] == "cpu"
    (eng,) = body["engines"]
    ref = jmetrics.EngineStatus(engine_id="e", healthy=True,
                                active_requests=0, waiting_requests=0,
                                total_processed=0).to_dict()
    assert set(ref) <= set(eng)
    assert eng["healthy"] is True and eng["role"] == "unified"
    assert eng["memory_total_pages"] == PAGED[0]


def test_stats_carry_the_snapshot_keys(stack):
    _post(stack.base, "/generate", {"prompt": "count me", "max_tokens": 3})
    _, _, raw = _get(stack.base, "/server/stats")
    stats = json.loads(raw)
    ref = jmetrics.MetricsSnapshot(
        total_requests=0, active_requests=0, tokens_per_second=0.0,
        average_ttft_ms=0.0, average_latency_ms=0.0, p99_latency_ms=0.0,
        average_batch_size=0.0, cache_hit_rate=0.0, queue_depth=0).to_dict()
    assert set(ref) <= set(stats)
    assert stats["total_requests"] >= 1
    assert stats["average_ttft_ms"] > 0 and stats["average_latency_ms"] > 0
    assert stats["p99_latency_ms"] > 0
    assert stats["average_batch_size"] >= 1
    (w,) = stats["worker_statuses"]
    assert w["healthy"] is True and w["engine_id"] == "engine-0"
    for key in ("hits", "misses", "evictions", "prefix_hits", "pages_total",
                "pages_free"):
        assert key in stats["cache"]
    for key in ("model", "device", "kernel_launches", "step_clock",
                "memory", "warmup_s", "requests_in_flight"):
        assert key in stats


def test_metrics_count_the_requests_sent(stack):
    """``request_latency_seconds_count`` per endpoint rises by the POSTs
    sent, ``time_to_first_token_seconds_count`` by the generation
    requests, ``tokens_generated_total`` by their completion tokens."""
    before = _metrics(stack)
    sent = {"/generate": 2, "/chat": 1, "/embeddings": 1}
    toks = 0
    for _ in range(2):
        toks += _post(stack.base, "/generate", {"prompt": "m", "max_tokens": 3,
                                                **GREEDY})[1]["usage"][
            "completion_tokens"]
    toks += _post(stack.base, "/chat", {"messages": MESSAGES,
                                        "max_tokens": 2})[1]["usage"][
        "completion_tokens"]
    _post(stack.base, "/embeddings", {"input": "e"})
    status, headers, _ = _get(stack.base, "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    after = _metrics(stack)
    for path, n in sent.items():
        key = ("request_latency_seconds", "request_latency_seconds_count")
        assert (_count(after, *key, endpoint=path, status="200")
                - _count(before, *key, endpoint=path, status="200")) == n
    ttft = ("time_to_first_token_seconds",
            "time_to_first_token_seconds_count")
    assert _count(after, *ttft) - _count(before, *ttft) == 3
    tg = ("tokens_generated", "tokens_generated_total")
    assert _count(after, *tg) - _count(before, *tg) == toks
    assert _count(after, "engine_up", "engine_up", engine_id="engine-0") == 1


def test_metrics_read_the_engine_totals_at_scrape(stack):
    """The engine's counters in ``/metrics`` are its cumulative totals
    as ``/server/stats`` reports them, with no traffic in between."""
    _post(stack.base, "/generate", {"prompt": "scrape", "max_tokens": 4,
                                    **GREEDY})
    fams = _metrics(stack)
    _, _, raw = _get(stack.base, "/server/stats")
    stats = json.loads(raw)
    for kind, c in stats["step_clock"]["kinds"].items():
        if c["dispatches"]:
            assert _count(fams, "engine_step_dispatches",
                          "engine_step_dispatches_total",
                          engine_id="engine-0", kind=kind) == c["dispatches"]
    assert _count(fams, "kv_cache_misses", "kv_cache_misses_total") == (
        stats["cache"]["misses"])
    assert _count(fams, "queue_depth", "queue_depth",
                  priority="normal") == 0


# the JAX collector's families that one unified replica records; the rest
# (host tier, handoff, prefix fetch and routing, fleet, registry HA,
# restarts, shedding, health scoring, tracing, SLO) come with their
# modules
SINGLE_REPLICA_FAMILIES = {
    "request_latency_seconds", "batch_size", "batch_padding_ratio",
    "tokens_generated", "inference_seconds", "time_to_first_token_seconds",
    "kv_cache_hits", "kv_cache_misses", "kv_cache_evictions",
    "kv_prefix_hits", "engine_mixed_step_tokens",
    "engine_mixed_batch_density", "engine_loop_steps", "engine_loop_exit",
    "queue_depth", "active_requests", "engine_up", "errors",
    "engine_step_seconds", "engine_step_dispatches", "engine_step_tokens",
    "engine_step_events", "requests_expired", "queue_tenant_depth",
    "speculation_acceptance_rate", "speculation_estimated_speedup",
    "speculation_enabled", "kv_prefix_reload_seconds", "kv_host_tier_bytes",
    "kv_host_tier_pages", "kv_payload_bytes",
}
REPLICA_FAMILIES = {
    "kv_prefix_fetch", "kv_prefix_fetch_bytes", "kv_prefix_fetch_seconds",
    "kv_prefix_route", "kv_handoff_latency_seconds", "kv_handoff_bytes",
    "kv_handoff_stall_seconds", "kv_handoff_chunks", "kv_handoff",
    "engines_by_role", "engine_restarts", "requests_redispatched",
}
# the tracing, SLO and gray-failure families (the control slice)
CONTROL_FAMILIES = {
    "trace_spans_dropped", "request_phase_seconds", "slo_requests",
    "slo_goodput_tokens", "requests_shed", "engine_health_state",
    "health_transitions", "retry_budget_exhausted",
    "fleet_breaker_transitions",
}
# the port's own: the device clock's counters and the first-frame delay
PORT_ONLY_FAMILIES = {"engine_device_seconds", "engine_device_idle_seconds",
                      "request_first_frame_seconds"}
# the fleet's families: the control plane's, the KV mesh's and registry
# HA's
FLEET_FAMILIES = {
    "fleet_members", "fleet_heartbeats", "fleet_reroles",
    "fleet_telemetry_frames", "fleet_member_step_tokens",
    "fleet_member_ttft_p99_ms", "fleet_kv_wire_rate_bytes_per_s",
    "fleet_kv_intro", "fleet_registry_role", "fleet_registry_takeovers",
    "fleet_registry_epoch",
}


def _record_common(c):
    c.set_fleet_members({"alive": 1, "dead": 2})
    c.record_fleet_heartbeat("ok")
    c.record_fleet_heartbeat("rejoin")
    c.record_rerole("to_prefill")
    c.record_telemetry_frame("ingested")
    c.set_member_telemetry("w1", {"prefill": 16.0, "decode_block": 7.0},
                           37.5)
    c.set_kv_wire_rate("w1", "w2", 2.5e8)
    c.set_kv_wire_rate("registry", "w1", 1.0e8)
    c.remove_kv_wire_rate("registry", "w1")
    c.record_kv_intro("sent")
    c.record_kv_intro("gone")
    c.set_registry_role("primary")
    c.set_registry_epoch(3)
    c.record_registry_takeover("lease_expired")
    c.record_trace_drops("ring", 2)
    c.record_shed("gold", "deadline")
    c.record_health_transition("engine-0", "degraded")
    c.record_retry_denied("redispatch")
    c.record_breaker_transition("open")
    c.record_request_phases({"queue_wait": 0.01, "prefill": 0.2,
                             "decode": 0.5}, tbt_s=0.02)
    c.record_slo("default", "ok", tokens=5)
    c.record_request("/generate", 200, 0.03)
    c.record_request("/chat", 400, 0.001)
    c.record_batch(3)
    c.record_tokens(7)
    c.record_inference(0.25)
    c.record_ttft(0.04)
    c.request_started()
    c.request_finished()
    c.set_engine_up("engine-0", True)
    c.record_error("runner.sink")
    c.set_queue_depth(0, 2, 0)
    c.set_tenant_depths({"a": 2})
    c.record_expired(1)
    c.set_speculation("engine-0", {"acceptance_rate": 0.75,
                                   "estimated_speedup": 2.5,
                                   "enabled": True})


# the engine's counters: deltas into the JAX collector, the same values
# as the engine's totals into the port's (which reads them at a scrape)
ENGINE_TOTALS = (
    "engine-0", types.SimpleNamespace(hits=2, misses=1, evictions=1),
    {"prefill_tokens": 5, "decode_tokens": 3, "batch_density": 0.5},
    {"steps": 4, "exits": {"eos": 1, "budget": 2}},
    {"kinds": {"prefill": {"dispatches": 2, "wall_s": 0.1, "tokens": 9}},
     "events": {"preempt": 1}})
# the host tier's and the byte paths' counters, the same way
HOST_TOTALS = dict(
    host_tier={"budget_bytes": 1 << 20, "bytes": 4096, "pages": 2,
               "hits": 3, "hit_pages": 3, "offloads": 5, "evictions": 0},
    payload={"raw": 100, "int8": 40, "qpool": 0, "latent": 0,
             "latent_int8": 0},
    reloads=[0.002])


def _record_jax(c):
    _record_common(c)
    c.record_cache(hits=2, misses=1, evictions=1)
    c.record_prefix_hits(hbm=2)
    c.record_mixed_step(prefill_tokens=5, decode_tokens=3)
    c.set_mixed_density("engine-0", 0.5)
    c.record_loop_block(steps=4, exits={"eos": 1, "budget": 2})
    c.record_step_clock("engine-0", "prefill", dispatches=2, wall_s=0.1,
                        tokens=9)
    c.record_step_events("engine-0", {"preempt": 1})
    c.record_prefix_hits(host=3)
    c.set_host_tier("engine-0", 4096, 2)
    c.record_prefix_reload(0.002)
    c.record_kv_payload({"raw": 100, "int8": 40})


def _record_port(c):
    _record_common(c)
    c.observe_engine(*ENGINE_TOTALS, **HOST_TOTALS)


def _families(text: str) -> dict:
    out = {}
    for f in text_string_to_metric_families(text):
        if f.name.endswith("_created"):
            continue  # prometheus_client's creation timestamps
        labels = {tuple(sorted(k for k in s.labels if k != "le"))
                  for s in f.samples if not s.name.endswith("_created")}
        out[f.name] = (f.type, labels,
                       sorted((s.name, tuple(sorted(s.labels.items())),
                               s.value) for s in f.samples
                              if not s.name.endswith("_created")))
    return out


def test_metrics_families_match_the_jax_collector():
    """After the same record calls (the engine's counters as totals on
    the port's side), the port's text holds each of the JAX collector's
    single-replica families with the same type, label names and sample
    values (buckets included)."""
    j, p = jmetrics.MetricsCollector(), pmetrics.MetricsCollector()
    _record_jax(j)
    _record_port(p)
    jf = _families(j.prometheus_text().decode())
    pf = _families(p.prometheus_text().decode())
    # and the replica families (restarts, redispatch, handoff, prefix
    # fetch and route, roles), which both declare from the start, the
    # control slice's and the fleet control plane's
    families = (SINGLE_REPLICA_FAMILIES | REPLICA_FAMILIES
                | CONTROL_FAMILIES | FLEET_FAMILIES)
    assert families <= set(jf)
    # beside them, the port's own device clock and first-frame families
    assert set(pf) == families | PORT_ONLY_FAMILIES
    for name in families:
        assert pf[name][:2] == jf[name][:2], name
        assert pf[name][2] == pytest.approx(jf[name][2]), name


def test_device_clock_series_read_the_engine_totals():
    """The device clock's totals (``step_clock_stats`` ``device_s`` per
    kind and ``idle`` per cause) become the port's own counters at a
    scrape; a step clock without them (a CPU engine reads zeros) adds no
    series."""
    p = pmetrics.MetricsCollector()
    eid, cache, mixed, loop, clock = ENGINE_TOTALS
    clock = {"kinds": {"prefill": {**clock["kinds"]["prefill"],
                                   "device_s": 0.25},
                       "decode_block": {"dispatches": 3, "wall_s": 0.2,
                                        "tokens": 24, "device_s": 0.0}},
             "events": clock["events"],
             "idle": {"walk": 0.125, "runner": 0.0, "other": 0.5}}
    p.observe_engine(eid, cache, mixed, loop, clock)
    fams = _families(p.prometheus_text().decode())
    assert fams["engine_device_seconds"][2] == [
        ("engine_device_seconds_total",
         (("engine_id", "engine-0"), ("kind", "prefill")), 0.25)]
    assert fams["engine_device_idle_seconds"][2] == [
        ("engine_device_idle_seconds_total",
         (("cause", "other"), ("engine_id", "engine-0")), 0.5),
        ("engine_device_idle_seconds_total",
         (("cause", "walk"), ("engine_id", "engine-0")), 0.125)]
    q = pmetrics.MetricsCollector()
    q.observe_engine(*ENGINE_TOTALS)
    fams = _families(q.prometheus_text().decode())
    assert fams["engine_device_seconds"][2] == []
    assert fams["engine_device_idle_seconds"][2] == []


def test_snapshot_matches_the_jax_collector():
    j, p = jmetrics.MetricsCollector(), pmetrics.MetricsCollector()
    _record_jax(j)
    _record_port(p)
    js, ps = j.snapshot().to_dict(), p.snapshot().to_dict()
    assert set(ps) == set(js)
    for key in ("total_requests", "active_requests", "average_ttft_ms",
                "average_batch_size", "cache_hit_rate", "queue_depth"):
        assert ps[key] == js[key], key
    for key in ("hits", "misses", "evictions", "prefix_hits",
                "reload_count", "reload_avg_ms", "host_tier_bytes",
                "host_tier_pages", "payload_bytes"):
        assert ps["cache"][key] == js["cache"][key], key


def test_engine_totals_are_set_not_added():
    """A second scrape of unchanged totals leaves the counters as they
    were; grown totals raise them to the new totals."""
    c = pmetrics.MetricsCollector()
    c.observe_engine(*ENGINE_TOTALS)
    once = _families(c.prometheus_text().decode())
    c.observe_engine(*ENGINE_TOTALS)
    assert _families(c.prometheus_text().decode()) == once
    eid, _, mixed, loop, clock = ENGINE_TOTALS
    c.observe_engine(eid, types.SimpleNamespace(hits=5, misses=1,
                                                evictions=1),
                     mixed, {**loop, "steps": 9}, clock)
    fams = _families(c.prometheus_text().decode())
    assert fams["kv_cache_hits"][2] == [("kv_cache_hits_total", (), 5.0)]
    assert fams["engine_loop_steps"][2] == [
        ("engine_loop_steps_total", (), 9.0)]
    assert c.snapshot().to_dict()["cache"]["hits"] == 5


# ---------------------------------------------------------------------------
# client disconnect
# ---------------------------------------------------------------------------


def _live_pages(stack):
    _, _, raw = _get(stack.base, "/server/stats")
    stats = json.loads(raw)
    (w,) = stats["worker_statuses"]
    return stats["requests_in_flight"], \
        w["memory_used_pages"] - w["pages_cached"]


@pytest.mark.parametrize("path,read_first", [
    ("/generate", True), ("/generate", False),
    ("/v1/completions", True)])
def test_disconnect_aborts_the_stream(stack, path, read_first):
    """A client that closes its stream, after the first frames or before
    reading any: the server aborts the request (no request in flight, the
    active-requests gauge back at 0) and its pages go back (the live pages
    return to their count before); the engine's page books stay clean."""
    before = _live_pages(stack)
    assert before[0] == 0
    conn = http.client.HTTPConnection(stack.host, stack.port, timeout=120)
    conn.request("POST", path, json.dumps({
        "prompt": "a long stream " * 4, "max_tokens": 180, "stream": True,
        **GREEDY}), {"Content-Type": "application/json"})
    if read_first:
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.read1(64)  # the first frames arrived
        in_flight = _live_pages(stack)
        assert in_flight[0] == 1 and in_flight[1] > before[1]
    conn.sock.close()
    conn.close()

    def active():
        return _count(_metrics(stack), "active_requests", "active_requests")

    # a request closed before reading may still sit in the admission
    # window, where neither the runner nor the pages see it: wait for the
    # gauge too
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (
            _live_pages(stack) != before or active() != 0):
        time.sleep(0.05)
    assert _live_pages(stack) == before
    assert stack.server.runner.call(lambda e: e.audit_pages()) == []
    assert active() == 0


# ---------------------------------------------------------------------------
# the OpenAI routes
# ---------------------------------------------------------------------------


def test_v1_completions_with_stop_string(stack):
    _, ref = _post(stack.base, "/generate", {"prompt": "hello world",
                                             "max_tokens": 8, **GREEDY})
    want = ref["choices"][0]["text"]
    stop = want[2:4]
    status, body = _post(stack.base, "/v1/completions", {
        "prompt": "hello world", "max_tokens": 8, **GREEDY, "stop": stop})
    assert status == 200
    assert body["object"] == "text_completion"
    assert body["choices"][0]["finish_reason"] == "stop"
    assert body["choices"][0]["text"] == want[:want.find(stop)]


def test_v1_bad_stop_type_names_the_client_field(stack):
    status, err = _post(stack.base, "/v1/completions", {"prompt": "x",
                                                         "stop": 5})
    assert status == 400
    assert '"stop"' in err["error"]["message"]
    assert "stop_sequences" not in err["error"]["message"]


def test_v1_streaming_is_openai_chunks(stack):
    _, _, comp, _ = _stream(stack, "/v1/completions", {
        "prompt": "abc", "max_tokens": 3, "stream": True, **GREEDY})
    _, _, chat, _ = _stream(stack, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
        "stream": True, **GREEDY})
    for body in (comp.decode(), chat.decode()):
        assert '"type": "token"' not in body
        assert body.strip().endswith("data: [DONE]")
    frames = _chunks(comp)
    assert all(f["object"] == "text_completion" for f in frames)
    assert "text" in frames[0]["choices"][0]
    assert frames[-1]["choices"][0]["finish_reason"] == "length"
    cframes = _chunks(chat)
    assert all(f["object"] == "chat.completion.chunk" for f in cframes)
    assert cframes[0]["choices"][0]["delta"]["role"] == "assistant"
    assert cframes[-1]["choices"][0]["delta"] == {}
    assert cframes[-1]["choices"][0]["finish_reason"] == "length"
    deltas = [f["choices"][0]["delta"] for f in cframes
              if f["choices"][0]["delta"].get("content") is not None]
    assert "role" in deltas[0]
    assert all("role" not in d for d in deltas[1:])


def test_v1_max_completion_tokens_empty_stop_and_bad_n(stack):
    status, body = _post(stack.base, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}],
        "max_completion_tokens": 3})
    assert status == 200 and body["usage"]["completion_tokens"] <= 3
    status, err = _post(stack.base, "/v1/completions", {"prompt": "x",
                                                         "stop": [""]})
    assert status == 400 and "non-empty" in err["error"]["message"]
    for bad_n in (True, 0, "2", 17, -1):
        status, err = _post(stack.base, "/v1/completions", {"prompt": "x",
                                                             "n": bad_n})
        assert status == 400, bad_n
        assert '"n"' in err["error"]["message"]
    status, _ = _post(stack.base, "/v1/completions", {"prompt": "x", "n": 1,
                                                      "max_tokens": 1})
    assert status == 200


def test_n2_completions_nonstream(stack):
    status, body = _post(stack.base, "/v1/completions", {
        "prompt": "fan out", "n": 2, "max_tokens": 4, **GREEDY})
    assert status == 200
    assert [c["index"] for c in body["choices"]] == [0, 1]
    for c in body["choices"]:
        assert c["finish_reason"] in ("stop", "length")
        assert c["logprobs"] is None
    u = body["usage"]
    assert u["prompt_tokens"] == len("fan out") + 1
    assert u["completion_tokens"] <= 8
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
    assert body["choices"][0]["text"] == body["choices"][1]["text"]
    text, _, _ = stack.jax_text(ByteTokenizer().encode("fan out"),
                                temperature=0.0, max_tokens=4)
    assert body["choices"][0]["text"] == text


def test_n2_chat_stream_interleaves_choices(stack):
    _, _, raw, _ = _stream(stack, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "n": 2,
        "max_tokens": 3, "stream": True})
    assert raw.decode().rstrip().endswith("data: [DONE]")
    by_idx = {0: [], 1: []}
    for ch in _chunks(raw):
        for c in ch["choices"]:
            by_idx[c["index"]].append(c)
    for idx in (0, 1):
        finishes = [c for c in by_idx[idx] if c["finish_reason"] is not None]
        assert len(finishes) == 1
        deltas = [c["delta"] for c in by_idx[idx]
                  if c["delta"].get("content") is not None]
        assert "role" in deltas[0]
        assert all("role" not in d for d in deltas[1:])


def test_completions_logprobs_nonstream(stack):
    status, body = _post(stack.base, "/v1/completions", {
        "prompt": "lp", "max_tokens": 4, "logprobs": 0, **GREEDY})
    assert status == 200
    lp = body["choices"][0]["logprobs"]
    k = len(lp["tokens"])
    assert k >= 1
    assert len(lp["token_logprobs"]) == k == len(lp["text_offset"])
    assert lp["top_logprobs"] is None
    assert all(v <= 0.0 for v in lp["token_logprobs"] if v is not None)
    assert lp["text_offset"][0] == 0
    assert lp["text_offset"] == sorted(lp["text_offset"])


def test_chat_logprobs_nonstream_and_stream(stack):
    body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
            "logprobs": True}
    status, resp = _post(stack.base, "/v1/chat/completions", body)
    assert status == 200
    content = resp["choices"][0]["logprobs"]["content"]
    assert content
    for entry in content:
        assert set(entry) == {"token", "logprob", "bytes", "top_logprobs"}
        assert entry["top_logprobs"] == []
        assert isinstance(entry["bytes"], list)
    _, _, raw, _ = _stream(stack, "/v1/chat/completions",
                           {**body, "stream": True})
    token_chunks = [c for ch in _chunks(raw) for c in ch["choices"]
                    if c.get("delta", {}).get("content") is not None]
    with_lp = [c for c in token_chunks if c["logprobs"] is not None]
    assert with_lp
    for c in with_lp:
        for entry in c["logprobs"]["content"]:
            assert "token" in entry and "logprob" in entry


def test_stream_include_usage(stack):
    _, _, raw, _ = _stream(stack, "/v1/completions", {
        "prompt": "use me", "max_tokens": 3, "stream": True,
        "stream_options": {"include_usage": True}})
    chunks = _chunks(raw)
    assert all("usage" in ch for ch in chunks)
    final = chunks[-1]
    assert final["choices"] == []
    u = final["usage"]
    assert u["prompt_tokens"] == len("use me") + 1
    assert 1 <= u["completion_tokens"] <= 3
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
    assert all(ch["usage"] is None for ch in chunks[:-1])


def test_stream_error_still_emits_usage_chunk(stack):
    _, _, raw, _ = _stream(stack, "/v1/completions", {
        "prompt": "x" * 400, "max_tokens": 3, "stream": True,
        "stream_options": {"include_usage": True}})
    assert raw.decode().rstrip().endswith("data: [DONE]")
    chunks = _chunks(raw)
    errors = [ch for ch in chunks if "error" in ch]
    assert errors and errors[0]["error"]["index"] == 0
    assert chunks[-1]["choices"] == [] and chunks[-1]["usage"] is not None


@pytest.mark.parametrize("path,payload", [
    ("/v1/completions", {"prompt": "x", "echo": True}),
    ("/v1/completions", {"prompt": "x", "best_of": 3}),
    ("/v1/completions", {"prompt": "x", "n": 4, "best_of": 1}),
    ("/v1/completions", {"prompt": "x", "suffix": "tail"}),
    ("/v1/completions", {"prompt": "x", "logprobs": 3}),
    ("/v1/completions", {"prompt": "x",
                         "stream_options": {"include_usage": True}}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}],
                              "logprobs": True, "top_logprobs": 2}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}],
                              "top_logprobs": 0}),
])
def test_unsupported_shape_fields_rejected(stack, path, payload):
    status, err = _post(stack.base, path, payload)
    assert status == 400
    assert err["error"]["message"]


def test_best_of_equal_to_n_is_allowed(stack):
    status, body = _post(stack.base, "/v1/completions", {
        "prompt": "x", "n": 2, "best_of": 2, "max_tokens": 1})
    assert status == 200 and len(body["choices"]) == 2


# ---------------------------------------------------------------------------
# incremental detokenization (the cases of tests/test_streaming_detok.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def detok_engine():
    return LLMEngine(params_from_numpy(_tree(), device="cpu",
                                       dtype=torch.float32), TINY,
                     ByteTokenizer(), EngineConfig(
                         max_batch=2, prefill_buckets=(16,),
                         paged=PagedCacheConfig(64, 8, 8)),
                     dtype=torch.float32, device="cpu")


def _seq():
    return _Seq("r", [1, 2, 3], SamplingParams(max_tokens=64))


def test_multibyte_char_held_then_completed(detok_engine):
    s = _seq()
    b = "中".encode("utf-8")
    assert detok_engine._decode_piece(s, b[0]) == ""
    assert detok_engine._decode_piece(s, b[1]) == ""
    assert detok_engine._decode_piece(s, b[2]) == "中"
    assert s.pending_ids == []


def test_ascii_fast_path_unbuffered(detok_engine):
    s = _seq()
    assert detok_engine._decode_piece(s, ord("h")) == "h"
    assert s.pending_ids == []


def test_garbage_run_flushes_after_cap(detok_engine):
    s = _seq()
    pieces = [detok_engine._decode_piece(s, 0xFF) for _ in range(8)]
    assert "".join(pieces).count("�") == 8
    assert s.pending_ids == []


def test_finish_flushes_trailing_fragment(detok_engine):
    s = _seq()
    assert detok_engine._decode_piece(s, "中".encode("utf-8")[0]) == ""
    detok_engine._flush_pending_text(s)
    assert s.output_text == "�" and s.pending_ids == []


@pytest.mark.parametrize("text", ["héllo 🙂 中文 done", "🙂!"])
def test_stream_deltas_reconstruct_valid_utf8_exactly(detok_engine, text):
    s = _seq()
    pieces = [detok_engine._decode_piece(s, b) for b in text.encode("utf-8")]
    assert "".join(pieces) == text
    assert all("�" not in p for p in pieces)


# ---------------------------------------------------------------------------
# shared state under thread stress
# ---------------------------------------------------------------------------


def test_collector_and_streams_under_thread_stress():
    """More producer threads than cores record into one collector and push
    into sinks sharing one channel, with a tiny switch interval: no count
    is lost, and each stream arrives whole and in order."""
    import os
    import queue
    import sys

    from distributed_inference_server_tpu_torch.core.models import (
        FinishReason,
        Usage,
    )
    from distributed_inference_server_tpu_torch.serving.streamer import (
        StreamingSink,
        drain,
    )

    n, per = (os.cpu_count() or 2) + 4, 300
    c = pmetrics.MetricsCollector()
    channel = queue.Queue()
    sinks = [StreamingSink(channel, i) for i in range(n)]

    def work(i):
        for k in range(per):
            c.record_tokens(1)
            c.request_started()
            c.request_finished()
            c.record_request("/generate", 200, 0.001)
            c.record_ttft(0.01)
            sinks[i].on_token(k, str(k), k, -0.5)
            if k % 8 == 7:
                sinks[i].flush()
        sinks[i].on_done(FinishReason.LENGTH, Usage.of(1, per))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        got = {i: [] for i in range(n)}
        for idx, ev in drain(channel, n, timeout=60):
            got[idx].append(ev)
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    for i in range(n):
        assert [e.token for e in got[i][:-1]] == [str(k) for k in range(per)]
        assert got[i][-1].type == "done"
    snap = c.snapshot().to_dict()
    assert snap["total_requests"] == n * per
    assert snap["active_requests"] == 0
    fams = {f.name: f for f in text_string_to_metric_families(
        c.prometheus_text().decode())}
    assert _count(fams, "tokens_generated", "tokens_generated_total") == \
        n * per
    assert _count(fams, "time_to_first_token_seconds",
                  "time_to_first_token_seconds_count") == n * per
    assert _count(fams, "active_requests", "active_requests") == 0
