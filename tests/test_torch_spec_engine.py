"""The port's speculative engine against the JAX package's, and served.

TINY weights in f32 are drawn by the JAX package (every matrix scaled by 8
so greedy continuations vary) and shared by conversion; the draft is the
same model (full acceptance) or another seed's (partial acceptance).
Greedy tokens must equal the JAX speculative engine's and the JAX plain
engine's exactly, with no page leaked (``audit_pages() == []``):

- the fixed path at pipeline depths 0 and 1, dense and int8 KV pools;
- speculation inside looped blocks (``test_spec_in_loop_identity`` of
  ``tests/test_engine_loop.py``);
- the mixed step under the loop (``test_spec_composes_with_mixed_under_
  loop``), and its exclusion without the loop;
- the cases of ``tests/test_spec_engine.py``: disabled patterns fall back
  or ride along masked, nucleus-aware top-p rows, stop sequences, the page
  bound with blocks in flight;
- the cases of ``tests/test_spec_serving.py`` on one served port engine:
  greedy texts equal the JAX plain engine's, the ``speculation`` stats
  and metrics, their absence without a draft, ``POST /admin/speculation``.
"""

import functools
import http.client
import json
import time

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
from distributed_inference_server_tpu.engine.speculative import (
    SpecConfig as JSpecConfig,
)
from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models import tokenizer as jtok
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu.ops import quant as jq
from distributed_inference_server_tpu_torch.core.models import FinishReason
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PagedCacheConfig,
)
from distributed_inference_server_tpu_torch.engine.speculative import (
    SpecConfig,
    spec_signature,
)
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)
from distributed_inference_server_tpu_torch.serving.batcher import (
    BatcherConfig,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)

TOK = ByteTokenizer()
GAMMA = 3
PAGED = (64, 4, 16)  # 64 tokens a sequence
BUCKETS = (8, 32)
GREEDY = dict(max_tokens=12, temperature=0.0)


def _tree(key):
    jp = j_llama.init_params(jax.random.PRNGKey(key), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * 8.0
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * 8.0
    return tree


@functools.lru_cache(maxsize=None)
def _trees():
    return _tree(0), _tree(7)


def _jp(i):
    return jax.tree_util.tree_map(jnp.asarray, _trees()[i])


def _pp(i):
    return params_from_numpy(_trees()[i], device="cpu", dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _j_int8():
    """The target's weights quantized to int8 codes (group 32) by the JAX
    package."""
    return jq.quantize_params(_jp(0), "int8", 32)


def _p_int8():
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, _j_int8()),
                             device="cpu", dtype=torch.float32)


def j_engine(draft=None, max_batch=3, target=None, **kw):
    """draft: None (plain), 0 (the target itself) or 1 (another seed);
    target: the JAX target params (the dense seed-0 tree when None)."""
    return JEngine(
        _jp(0) if target is None else target, J_TINY, jtok.ByteTokenizer(),
        JEngineConfig(
            max_batch=max_batch, prefill_buckets=BUCKETS,
            paged=JPagedCacheConfig(*PAGED), decode_block_size=3,
            attention_impl="xla", native_allocator=False, **kw),
        dtype=jnp.float32,
        draft_params=None if draft is None else _jp(draft),
        draft_cfg=None if draft is None else J_TINY,
        spec=None if draft is None else JSpecConfig(num_draft_tokens=GAMMA))


def p_engine(draft=None, max_batch=3, spec=None, **kw):
    return LLMEngine(
        _pp(0), TINY, TOK, EngineConfig(
            max_batch=max_batch, prefill_buckets=BUCKETS,
            paged=PagedCacheConfig(*PAGED), decode_block_size=3, **kw),
        dtype=torch.float32, device="cpu",
        draft_params=None if draft is None else _pp(draft),
        draft_cfg=None if draft is None else TINY,
        spec=spec or SpecConfig(num_draft_tokens=GAMMA))


def drain(eng, results=None, max_steps=2000):
    results = {} if results is None else results
    for _ in range(max_steps):
        if not eng.has_work():
            break
        for out in eng.step():
            r = results.setdefault(out.request_id, {
                "tokens": [], "text": "", "finish": None, "error": None})
            r["text"] += out.text
            if out.token_id is not None:
                r["tokens"].append(out.token_id)
            if out.finished:
                r["finish"] = out.finish_reason
                r["error"] = out.error
    assert not eng.has_work() or max_steps < 100, "engine did not drain"
    return results


PROMPTS = {f"r{i}": np.random.default_rng(41).integers(
    1, 200, size=n).tolist() for i, n in enumerate((5, 9, 13, 30))}


def run(eng, jax_side=False, prompts=PROMPTS, params=None):
    params = params or GREEDY
    cls = JSamplingParams if jax_side else SamplingParams
    for rid, ids in prompts.items():
        eng.add_request(rid, ids, cls(**params))
    out = drain(eng)
    assert all(r["error"] is None for r in out.values())
    if not jax_side:
        assert eng.audit_pages() == []
    return {rid: r["tokens"] for rid, r in out.items()}


@functools.lru_cache(maxsize=None)
def jax_tokens(draft=None, kv_quant="none", loop=False, mixed=0):
    return run(j_engine(draft, kv_quant=kv_quant, loop_to_completion=loop,
                        mixed_step_tokens=mixed), jax_side=True)


def _diff(got, want):
    return {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
            if got.get(k) != want.get(k)}


# ---------------------------------------------------------------------------
# greedy identity against the JAX engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", [0, 1])
@pytest.mark.parametrize("depth", [0, 1])
def test_spec_greedy_matches_jax(depth, draft):
    eng = p_engine(draft, pipeline_depth=depth)
    got = run(eng)
    assert got == jax_tokens(1), _diff(got, jax_tokens(1))
    assert got == jax_tokens(None), _diff(got, jax_tokens(None))
    stats = eng.spec_stats()
    assert stats["num_draft_tokens"] == GAMMA and stats["enabled"]
    if draft == 0:
        assert stats["acceptance_rate"] == 1.0
        assert stats["estimated_speedup"] > 2.0
    else:
        assert 0.0 <= stats["acceptance_rate"] < 1.0


@pytest.mark.parametrize("draft", [0, 1])
def test_spec_int8_kv_matches_jax(draft):
    """The draft pool is int8 too; the verify forward reads the target's
    int8 pool through the plain gather + dequantize path."""
    eng = p_engine(draft, kv_quant="int8")
    assert eng.draft_state.k.data.dtype == torch.int8
    got = run(eng)
    want = jax_tokens(None, "int8")
    assert got == want, _diff(got, want)
    assert got == jax_tokens(1, "int8")


@pytest.mark.parametrize("draft", ["int8", 1])
def test_spec_int8_weights_matches_jax(draft):
    """int8 weights over int8 KV, the pairing of the served 8B spec
    target: the verify forward's products run at M = max_batch * (gamma +
    1) rows (the port's prefill body on the card). The draft is the
    quantized target itself (every proposal accepted, so every verify row
    decides a token) or a dense draft of another seed; greedy tokens equal
    the JAX speculative and plain engines' on the same quantized weights."""
    p_draft = _p_int8() if draft == "int8" else _pp(draft)
    j_draft = _j_int8() if draft == "int8" else _jp(draft)
    eng = LLMEngine(
        _p_int8(), TINY, TOK, EngineConfig(
            max_batch=3, prefill_buckets=BUCKETS,
            paged=PagedCacheConfig(*PAGED), decode_block_size=3,
            kv_quant="int8"),
        dtype=torch.float32, device="cpu", draft_params=p_draft,
        draft_cfg=TINY, spec=SpecConfig(num_draft_tokens=GAMMA))
    got = run(eng)
    want = run(j_engine(None, target=_j_int8(), kv_quant="int8"),
               jax_side=True)
    assert got == want, _diff(got, want)
    jspec = JEngine(
        _j_int8(), J_TINY, jtok.ByteTokenizer(), JEngineConfig(
            max_batch=3, prefill_buckets=BUCKETS,
            paged=JPagedCacheConfig(*PAGED), decode_block_size=3,
            attention_impl="xla", native_allocator=False, kv_quant="int8"),
        dtype=jnp.float32, draft_params=j_draft, draft_cfg=J_TINY,
        spec=JSpecConfig(num_draft_tokens=GAMMA))
    jgot = run(jspec, jax_side=True)
    assert got == jgot, _diff(got, jgot)
    totals = eng.spec_stats()["totals"]
    assert totals["proposed"] > 0
    if draft == "int8":
        assert totals["accepted"] == totals["proposed"], totals


@pytest.mark.parametrize("draft", [0, 1])
def test_spec_in_loop_identity(draft):
    eng = p_engine(draft, loop_to_completion=True)
    got = run(eng)
    assert got == jax_tokens(1, loop=True)
    assert got == jax_tokens(None), _diff(got, jax_tokens(None))
    assert eng.loop_stats()["blocks"] >= 1
    if draft == 0:
        assert eng.spec_stats()["acceptance_rate"] == 1.0


def test_spec_composes_with_mixed_under_loop():
    rng = np.random.default_rng(43)
    chats = {f"c{i}": rng.integers(1, 200, size=6).tolist()
             for i in range(2)}
    long_prompt = rng.integers(1, 200, size=40).tolist()

    def go(eng, jax_side):
        cls = JSamplingParams if jax_side else SamplingParams
        toks: dict = {}
        for rid, ids in chats.items():
            eng.add_request(rid, ids, cls(**GREEDY))
        drain(eng, toks, max_steps=3)
        eng.add_request("long", long_prompt, cls(max_tokens=8,
                                                 temperature=0.0))
        drain(eng, toks)
        return {k: v["tokens"] for k, v in toks.items()}

    eng = p_engine(1, loop_to_completion=True, mixed_step_tokens=20)
    got = go(eng, False)
    assert eng.audit_pages() == []
    assert eng.mixed_stats()["steps"] >= 1
    want = go(j_engine(None), True)
    assert got == want, _diff(got, want)
    assert got == go(j_engine(1, loop_to_completion=True,
                              mixed_step_tokens=20), True)


def test_spec_mixed_still_excluded_without_loop():
    with pytest.raises(ValueError, match="loop_to_completion"):
        p_engine(1, mixed_step_tokens=20)
    big = TINY.with_overrides(vocab_size=TINY.vocab_size + 1)
    with pytest.raises(ValueError, match="vocabulary"):
        LLMEngine(_pp(0), TINY, TOK, EngineConfig(), dtype=torch.float32,
                  device="cpu", draft_params=_pp(1), draft_cfg=big)


# ---------------------------------------------------------------------------
# the cases of tests/test_spec_engine.py
# ---------------------------------------------------------------------------


def test_spec_auto_disable_falls_back():
    eng = p_engine(1)
    eng.spec_trackers.disable(spec_signature(SamplingParams(**GREEDY)))
    got = run(eng)
    assert got == jax_tokens(None)
    assert eng.spec_stats()["enabled"] is False


def test_spec_pattern_keyed_disable_and_topp_ride_along():
    """With the greedy pattern disabled, a top-p request keeps speculating
    (draft == target: full acceptance) while greedy rows ride the same
    launches masked; greedy output stays exact."""
    eng = p_engine(0, spec=SpecConfig(num_draft_tokens=GAMMA,
                                      reenable_after_s=1e9))
    greedy_sig = spec_signature(SamplingParams(**GREEDY))
    topp = SamplingParams(max_tokens=12, temperature=0.8, top_p=0.9)
    eng.spec_trackers.disable(greedy_sig)
    eng.add_request("g", PROMPTS["r0"], SamplingParams(**GREEDY))
    eng.add_request("t", PROMPTS["r1"], topp)
    out = drain(eng)
    assert out["g"]["error"] is None and out["t"]["error"] is None
    assert out["g"]["tokens"] == jax_tokens(None)["r0"]
    assert len(out["t"]["tokens"]) <= 12 and out["t"]["finish"] is not None
    pats = eng.spec_stats()["patterns"]
    t_sig = spec_signature(topp)
    t_key = f"temp_band={t_sig[0]},top_p_band={t_sig[1]}"
    g_key = f"temp_band={greedy_sig[0]},top_p_band={greedy_sig[1]}"
    assert pats[t_key]["acceptance_rate"] > 0.99
    assert pats[t_key]["estimated_speedup"] > 1.5
    assert g_key not in pats or pats[g_key]["estimated_speedup"] == 1.0
    assert eng.spec_stats()["enabled"] is False
    assert eng.audit_pages() == []


def test_spec_topp_full_acceptance_same_draft():
    eng = p_engine(0)
    eng.add_request("topp", PROMPTS["r2"],
                    SamplingParams(max_tokens=24, temperature=0.8,
                                   top_p=0.9))
    out = drain(eng)
    assert out["topp"]["error"] is None
    assert len(out["topp"]["tokens"]) == 24
    assert eng.spec_trackers.rate() > 0.99
    assert eng.spec_trackers.speedup() > 2.0
    assert eng.audit_pages() == []


def test_spec_stop_sequence_and_page_accounting():
    eng = p_engine(1)
    prompt = TOK.encode("hello")
    eng.add_request("probe", prompt, SamplingParams(**GREEDY))
    text = drain(eng)["probe"]["text"]
    assert len(text) >= 3
    stop = text[1:3]
    eng.add_request("s", prompt, SamplingParams(
        max_tokens=12, temperature=0.0, stop_sequences=(stop,)))
    r = drain(eng)["s"]
    assert r["finish"] == FinishReason.STOP_SEQUENCE
    assert stop not in r["text"]
    s = eng.allocator.stats()
    assert s.pages_free + s.pages_cached == s.pages_total
    assert eng.audit_pages() == []


def test_assumed_adv_covers_the_conserved_end_with_pending():
    eng = p_engine(1)

    class FakeSeq:
        dev_pos = 40
        dev_steps_left = -2  # after an assumed R * (gamma + 1) launch

    eng._pending.append(object())  # a block is in flight
    assert eng._assumed_adv(FakeSeq(), True) == 1  # 41 is still written
    eng._pending.clear()
    assert eng._assumed_adv(FakeSeq(), True) == 0  # host view exact


def test_partial_acceptance_near_capacity_under_pipelining():
    """A long run with partial acceptance and a block always in flight
    ends at the capacity (overshooting writes dropped); tokens equal the
    JAX plain engine's."""
    prompts = {"long": PROMPTS["r3"]}
    params = dict(max_tokens=40, temperature=0.0)
    got = run(p_engine(1, max_batch=1), prompts=prompts, params=params)
    want = run(j_engine(None, max_batch=1), jax_side=True, prompts=prompts,
               params=params)
    capacity = PAGED[1] * PAGED[2]
    assert got == want
    assert len(got["long"]) == capacity - len(PROMPTS["r3"])


# ---------------------------------------------------------------------------
# served (the cases of tests/test_spec_serving.py)
# ---------------------------------------------------------------------------


class Stack:
    def __init__(self):
        def factory():
            return p_engine(1, max_batch=4)

        self.server = InferenceServer(factory, TOK, "tiny-spec",
                                      batcher_config=BatcherConfig())
        self.server.start()
        self.port = self.server.serve("127.0.0.1", 0, block=False)

    def request(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=120)
        conn.request(method, path,
                     None if body is None else json.dumps(body))
        resp = conn.getresponse()
        raw = resp.read()
        conn.close()
        return resp.status, raw


@pytest.fixture(scope="module")
def stack():
    s = Stack()
    yield s
    s.server.shutdown(drain_timeout_s=5.0)


def test_served_spec_greedy_exact(stack):
    prompts = ("hello world", "speculate!")
    eng = j_engine(None)
    for i, prompt in enumerate(prompts):
        eng.add_request(f"p{i}", jtok.ByteTokenizer().encode(prompt),
                        JSamplingParams(**GREEDY))
    want = drain(eng)
    for i, prompt in enumerate(prompts):
        status, raw = stack.request("POST", "/generate",
                                    {"prompt": prompt, **GREEDY})
        assert status == 200
        assert json.loads(raw)["choices"][0]["text"] == want[f"p{i}"]["text"]


def test_served_spec_stats_metrics_and_admin_reset(stack):
    stack.request("POST", "/generate", {"prompt": "warm", **GREEDY})
    status, raw = stack.request("GET", "/server/stats")
    ws = json.loads(raw)["worker_statuses"]
    spec = ws[0]["speculation"]
    assert {"acceptance_rate", "estimated_speedup", "enabled",
            "num_draft_tokens"} <= set(spec)
    assert spec["num_draft_tokens"] == GAMMA
    _, text = stack.request("GET", "/metrics")
    assert b"speculation_acceptance_rate{" in text
    assert b"speculation_enabled{" in text
    eng = stack.server.runner._engine
    sig = spec_signature(SamplingParams(temperature=0.0))
    stack.server.runner.call(lambda e: e.spec_trackers.disable(sig))
    assert not eng.spec_trackers.all_enabled
    status, raw = stack.request("POST", "/admin/speculation",
                                {"action": "reset"})
    assert status == 200
    assert json.loads(raw) == {"status": "ok", "engines_reset": 1}
    deadline = time.monotonic() + 10
    while not stack.server.runner.call(
            lambda e: e.spec_trackers.all_enabled):
        assert time.monotonic() < deadline
    status, raw = stack.request("POST", "/admin/speculation",
                                {"action": "nope"})
    assert status == 400
    assert json.loads(raw)["error"]["code"] == "invalid_body"


def test_plain_server_has_no_speculation_fields():
    server = InferenceServer(lambda: p_engine(None), TOK, "tiny-plain")
    server.start()
    try:
        stats = server.stats()
        assert all("speculation" not in w
                   for w in stats["worker_statuses"])
        assert b"speculation_enabled{" not in server.metrics_text()
    finally:
        server.shutdown(drain_timeout_s=1.0)
