"""The port's engine against the JAX package's, greedy tokens identical.

Both engines get the same weights (JAX ``init_params`` -> numpy, every
matrix scaled by 8 so TINY's greedy continuations vary instead of
repeating one byte) and the same requests, and run in float32 on the CPU;
the JAX engine on its reference path (``attention_impl="xla"``,
``native_allocator=False``). Covered: prompts spanning the prefill buckets,
a prompt chunked over several quanta, prefix reuse, preemption on
``CacheFull`` with a small pool, and stop sequences; and the ragged mixed
step (``mixed_step_tokens``), whose tokens must equal both the JAX
engine's mixed step and the port's own quantum path, in the scenarios of
``tests/test_engine_mixed.py``; and quantized serving: int8 and int4
weights (``quantize_params``, group 32) and int8 KV pools
(``kv_quant="int8"``), alone and together, with prefix reuse and
preemption under int8 KV (the scenarios of ``tests/test_quant.py`` and
``tests/test_kv_quant.py``); and the mixed step over int8 pools, with
dense or int8 weights, in its K = 1 and K-block forms, against the JAX
mixed step (the scenarios of ``tests/test_engine_mixed.py``).

Before comparing tokens each test checks that the top-2 logit gap at every
generated step exceeds ``TIE_TOL`` (from an independent dense forward over
the JAX engine's output): a near-tie would let f32 summation order flip a
token, and it is then reported as a tie, not as a fault.
"""

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
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu.models.tokenizer import (
    ByteTokenizer as JByteTokenizer,
)
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
from distributed_inference_server_tpu_torch.models import llama as t_llama
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)
from distributed_inference_server_tpu_torch.ops.quant import QuantPool

SCALE = 8.0
TIE_TOL = 1e-3  # >> the ~1e-5 f32 logit difference between the packages
TOK = ByteTokenizer()


@pytest.fixture(scope="module")
def shared():
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * SCALE
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * SCALE
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    return j_params, params_from_numpy(tree, device="cpu",
                                       dtype=torch.float32)


def _drive(engine, requests, sp_cls):
    for rid, prompt, kw in requests:
        engine.add_request(rid, list(prompt), sp_cls(**kw))
    out = {}
    for _ in range(1000):
        if not engine.has_work():
            break
        for o in engine.step():
            r = out.setdefault(o.request_id, {"tokens": [], "text": "",
                                              "finish": None, "error": None,
                                              "usage": None})
            r["text"] += o.text
            if o.token_id is not None:
                r["tokens"].append(o.token_id)
            if o.finished:
                r["finish"] = getattr(o.finish_reason, "value", None)
                r["error"] = o.error
                r["usage"] = o.usage
    assert not engine.has_work(), "engine did not drain"
    return out


def _engines(shared, paged=(64, 4, 16), **kw):
    j_params, t_params = shared
    je = JEngine(j_params, J_TINY, JByteTokenizer(), JEngineConfig(
        paged=JPagedCacheConfig(*paged), attention_impl="xla",
        native_allocator=False, **kw), dtype=jnp.float32)
    te = LLMEngine(t_params, TINY, TOK, EngineConfig(
        paged=PagedCacheConfig(*paged), **kw), dtype=torch.float32,
        device="cpu")
    return je, te


def _dense_logits(t_params, ids, kv_quant="none"):
    """Reference logits [len(ids), V]: one plain forward over the whole
    sequence in a fresh pool (int8 pools with ``kv_quant="int8"``)."""
    n = len(ids)
    ps = 4
    pages = -(-n // ps)
    shape = (TINY.num_layers, pages * ps + 1, TINY.num_kv_heads,
             TINY.head_dim)
    if kv_quant == "int8":
        pool, pv = (QuantPool(torch.zeros(shape, dtype=torch.int8),
                              torch.zeros(shape[:-1])) for _ in range(2))
    else:
        pool, pv = torch.zeros(shape), torch.zeros(shape)
    tables = torch.arange(pages, dtype=torch.int32)[None]
    pos = torch.arange(n, dtype=torch.int32)[None]
    logits, _, _ = t_llama.paged_forward(
        t_params, TINY, torch.tensor([ids], dtype=torch.int32), pos, pool,
        pv, pos, tables, torch.tensor([n], dtype=torch.int32), impl="plain",
        page_size=ps)
    return logits[0]


def _assert_no_near_ties(t_params, prompt, tokens, kv_quant="none"):
    if not tokens:
        return
    logits = _dense_logits(t_params, list(prompt) + tokens[:-1], kv_quant)
    steps = logits[len(prompt) - 1:]
    top2 = torch.topk(steps, 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    for i, g in enumerate(gaps):
        assert g > TIE_TOL, (
            f"near-tie at generated step {i}: top-2 logit gap {g:.2e} <= "
            f"{TIE_TOL} — a tie, not a fault")


def _compare(shared, requests, jres, tres, kv_quant="none"):
    for rid, prompt, _ in requests:
        _assert_no_near_ties(shared[1], prompt, jres[rid]["tokens"],
                             kv_quant)
        assert tres[rid]["tokens"] == jres[rid]["tokens"], rid
        assert tres[rid]["text"] == jres[rid]["text"], rid
        assert tres[rid]["finish"] == jres[rid]["finish"], rid
        assert tres[rid]["error"] == jres[rid]["error"], rid
        if jres[rid]["usage"] is not None:
            assert (tres[rid]["usage"].to_dict()
                    == jres[rid]["usage"].to_dict()), rid


def _reqs(prompts, **kw):
    return [(f"r{i}", p, dict(temperature=0.0, **kw))
            for i, p in enumerate(prompts)]


def test_buckets_batches_and_chunked_prompt(shared):
    """Prompts of 4..46 ids over buckets (8, 32): short ones share a
    bucket-8 chunk, the 46-id prompt is chunked across quanta (budget 64
    padded tokens per step, so it also interleaves with decode blocks)."""
    prompts = [TOK.encode("hi!"), TOK.encode("bucket of thirty two?"),
               TOK.encode("a prompt that is chunked across two quanta.."),
               TOK.encode("x")]
    assert max(len(p) for p in prompts) > 32
    requests = _reqs(prompts, max_tokens=10)
    kw = dict(max_batch=4, prefill_buckets=(8, 32), prefill_batch=2,
              prefill_token_budget=64)
    je, te = _engines(shared, **kw)
    jres = _drive(je, requests, JSamplingParams)
    tres = _drive(te, requests, SamplingParams)
    _compare(shared, requests, jres, tres)
    assert te.audit_pages() == []
    assert all(r["finish"] == FinishReason.LENGTH.value
               for r in tres.values())


def test_prefix_reuse(shared):
    prompt = TOK.encode("shared prefix, reused twice")  # > 6 full pages
    kw = dict(max_batch=2, prefill_buckets=(8, 32))
    je, te = _engines(shared, **kw)
    for rid in ("first", "second"):
        requests = [(rid, prompt, dict(temperature=0.0, max_tokens=9))]
        jres = _drive(je, requests, JSamplingParams)
        tres = _drive(te, requests, SamplingParams)
        _compare(shared, requests, jres, tres)
    assert te.cache_stats().hits == je.allocator.stats().hits > 0
    assert te.audit_pages() == []


def test_preemption_on_cache_full(shared, monkeypatch):
    """A pool too small for both sequences at full length: the youngest is
    preempted, re-prefilled later, and still produces the same tokens."""
    preempted = []
    orig = LLMEngine._preempt

    def spy(self, seq, outputs):
        preempted.append(seq.request_id)
        return orig(self, seq, outputs)

    monkeypatch.setattr(LLMEngine, "_preempt", spy)
    prompts = [TOK.encode("abcdefgh"), TOK.encode("12345678")]
    requests = _reqs(prompts, max_tokens=10)
    je, te = _engines(shared, paged=(8, 4, 6), max_batch=2,
                      prefill_buckets=(8, 32))
    jres = _drive(je, requests, JSamplingParams)
    tres = _drive(te, requests, SamplingParams)
    assert preempted, "the small pool never forced a preemption"
    _compare(shared, requests, jres, tres)
    assert te.audit_pages() == []


def test_stop_sequences(shared):
    prompt = TOK.encode("stop here")
    je, te = _engines(shared, max_batch=2, prefill_buckets=(8, 32))
    free = _drive(je, [("probe", prompt, dict(temperature=0.0,
                                              max_tokens=12))],
                  JSamplingParams)["probe"]["text"]
    stop = free[4:6]
    assert stop and stop not in free[:5]
    requests = [("s", prompt, dict(temperature=0.0, max_tokens=12,
                                   stop_sequences=(stop, "never")))]
    jres = _drive(je, requests, JSamplingParams)
    tres = _drive(te, requests, SamplingParams)
    _compare(shared, requests, jres, tres)
    assert tres["s"]["finish"] == FinishReason.STOP_SEQUENCE.value
    assert tres["s"]["text"] == free[:4]


def test_abort_releases_pages(shared):
    _, te = _engines(shared, max_batch=2, prefill_buckets=(8, 32))
    te.add_request("a", TOK.encode("abort me soon"),
                   SamplingParams(max_tokens=50, temperature=0.0))
    te.step()
    assert te.num_active() == 1
    assert te.abort("a") and not te.abort("a")
    assert not te.has_work() and te.audit_pages() == []


def test_sampled_rows_run_and_stay_in_vocab(shared):
    _, te = _engines(shared, max_batch=4, prefill_buckets=(8, 32))
    requests = [("t", TOK.encode("sample"), dict(temperature=0.8,
                                                 top_p=0.9, max_tokens=8)),
                ("g", TOK.encode("greedy"), dict(temperature=0.0,
                                                 max_tokens=8))]
    res = _drive(te, requests, SamplingParams)
    assert len(res["t"]["tokens"]) == 8
    assert all(0 <= t < TINY.vocab_size for t in res["t"]["tokens"])


# ---------------------------------------------------------------------------
# the ragged mixed step
# ---------------------------------------------------------------------------

MIXED_KW = dict(max_batch=4, prefill_buckets=(8, 32), decode_block_size=4)


def _mixed_engines(shared, mixed, paged=(64, 4, 24), **kw):
    """(JAX mixed, port mixed, port quantum) on the same weights."""
    kw = {**MIXED_KW, **kw}
    je, tm = _engines(shared, paged=paged, mixed_step_tokens=mixed, **kw)
    _, tq = _engines(shared, paged=paged, **kw)
    return je, tm, tq


def _script(engine, sp_cls, actions):
    """Run ``actions`` — ("add", rid, prompt, kw), ("steps", n) or
    ("abort", rid) — then drain; returns {rid: tokens, text, finish,
    error, usage}."""
    out = {}

    def step():
        for o in engine.step():
            r = out.setdefault(o.request_id, {"tokens": [], "text": "",
                                              "finish": None, "error": None,
                                              "usage": None})
            r["text"] += o.text
            if o.token_id is not None:
                r["tokens"].append(o.token_id)
            if o.finished:
                r["finish"] = getattr(o.finish_reason, "value", None)
                r["error"] = o.error
                r["usage"] = o.usage

    for act in actions:
        if act[0] == "add":
            engine.add_request(act[1], list(act[2]), sp_cls(**act[3]))
        elif act[0] == "abort":
            assert engine.abort(act[1])
        else:
            for _ in range(act[1]):
                step()
    for _ in range(1000):
        if not engine.has_work():
            break
        step()
    assert not engine.has_work(), "engine did not drain"
    return out


def _mixed_compare(shared, actions, je, tm, tq):
    """The port's mixed step against the JAX mixed step and the port's
    quantum path: tokens, text, finish reason and usage."""
    requests = [(a[1], a[2], a[3]) for a in actions if a[0] == "add"]
    jres = _script(je, JSamplingParams, actions)
    mres = _script(tm, SamplingParams, actions)
    qres = _script(tq, SamplingParams, actions)
    _compare(shared, requests, jres, mres)
    _compare(shared, requests, qres, mres)
    assert tm.audit_pages() == []
    return mres


def _greedy(n):
    return dict(temperature=0.0, max_tokens=n)


def test_mixed_long_prompt_during_chats(shared):
    rng = np.random.default_rng(3)
    chats = [rng.integers(1, 200, size=6).tolist() for _ in range(2)]
    long_prompt = rng.integers(1, 200, size=60).tolist()
    actions = [("add", f"c{i}", c, _greedy(12)) for i, c in enumerate(chats)]
    actions += [("steps", 3), ("add", "long", long_prompt, _greedy(8))]
    je, tm, tq = _mixed_engines(shared, 20)
    _mixed_compare(shared, actions, je, tm, tq)
    stats = tm.mixed_stats()
    assert stats["steps"] > 0 and stats["decode_tokens"] > 0
    assert stats["prefill_tokens"] >= len(long_prompt) - 1
    assert 0.0 < stats["batch_density"] <= 1.0


def test_mixed_decodes_advance_every_step(shared):
    """While a long prompt loads, every mixed step advances the seated
    decode row by one token and loads more of the prompt."""
    rng = np.random.default_rng(5)
    chat = rng.integers(1, 200, size=6).tolist()
    long_prompt = rng.integers(1, 200, size=64).tolist()
    je, tm, tq = _mixed_engines(shared, 12)
    tm.add_request("chat", chat, SamplingParams(**_greedy(40)))
    for _ in range(3):
        tm.step()
    tm.add_request("long", long_prompt, SamplingParams(**_greedy(2)))
    tm.step()  # admit + first mixed dispatch
    before = tm.mixed_stats()
    tm.step()
    after = tm.mixed_stats()
    assert after["steps"] == before["steps"] + 1
    assert after["decode_tokens"] == before["decode_tokens"] + 1
    assert after["prefill_tokens"] > before["prefill_tokens"]
    _, tm, _ = _mixed_engines(shared, 12)
    actions = [("add", "chat", chat, _greedy(40)), ("steps", 3),
               ("add", "long", long_prompt, _greedy(2))]
    _mixed_compare(shared, actions, je, tm, tq)


def test_mixed_multi_prompt_batch_and_prefix_reuse(shared):
    """Several prompts share one packed budget, and prefix sharing still
    applies under the mixed step."""
    rng = np.random.default_rng(9)
    shared_ids = rng.integers(1, 200, size=16).tolist()
    prompts = [shared_ids + rng.integers(1, 200, size=4 + i).tolist()
               for i in range(3)]
    # p0 completes (and publishes its pages) before p1 and p2 arrive
    actions = [("add", "p0", prompts[0], _greedy(6)), ("steps", 20),
               ("add", "p1", prompts[1], _greedy(6)),
               ("add", "p2", prompts[2], _greedy(6))]
    je, tm, tq = _mixed_engines(shared, 24)
    _mixed_compare(shared, actions, je, tm, tq)
    assert tm.cache_stats().hits > 0


def test_mixed_prefill_frac_shrinks_share(shared):
    rng = np.random.default_rng(11)
    prompt = rng.integers(1, 200, size=64).tolist()

    def first_step_tokens(frac):
        _, tm, _ = _mixed_engines(shared, 20)
        tm.set_mixed_prefill_frac(frac)
        tm.add_request("p", prompt, SamplingParams(**_greedy(2)))
        tm.step()
        return tm.mixed_stats()["prefill_tokens"]

    full, half = first_step_tokens(1.0), first_step_tokens(0.5)
    assert 1 <= half < full
    _, tm, _ = _mixed_engines(shared, 20)
    tm.set_mixed_prefill_frac(0.0)  # floors at 0.05
    assert tm.mixed_stats()["prefill_frac"] == 0.05
    je, tm, tq = _mixed_engines(shared, 20)
    je.set_mixed_prefill_frac(0.5)
    tm.set_mixed_prefill_frac(0.5)
    _mixed_compare(shared, [("add", "p", prompt, _greedy(6))], je, tm, tq)


def test_mixed_preemption_under_page_pressure(shared, monkeypatch):
    preempted = []
    orig = LLMEngine._preempt

    def spy(self, seq, outputs):
        preempted.append(self)
        return orig(self, seq, outputs)

    monkeypatch.setattr(LLMEngine, "_preempt", spy)
    rng = np.random.default_rng(13)
    actions = [("add", f"r{i}", rng.integers(1, 200, size=10).tolist(),
                _greedy(10)) for i in range(3)]
    je, tm, tq = _mixed_engines(shared, 12, paged=(9, 4, 10), max_batch=2)
    res = _mixed_compare(shared, actions, je, tm, tq)
    assert tm in preempted, "the small pool never forced a preemption"
    assert all(len(r["tokens"]) == 10 for r in res.values())


def test_mixed_abort_mid_prefill(shared):
    rng = np.random.default_rng(17)
    gone = rng.integers(1, 200, size=40).tolist()
    stay = rng.integers(1, 200, size=8).tolist()
    _, tm, _ = _mixed_engines(shared, 12)
    tm.add_request("gone", gone, SamplingParams(**_greedy(4)))
    tm.add_request("stay", stay, SamplingParams(**_greedy(4)))
    tm.step()  # first mixed dispatch: "gone" is mid-prefill
    assert tm.abort("gone")
    res = _script(tm, SamplingParams, [])
    s = tm.cache_stats()
    assert s.pages_total - s.pages_free == s.pages_cached  # all released
    assert tm.audit_pages() == []
    je, _ = _engines(shared, paged=(64, 4, 24), mixed_step_tokens=12,
                     **MIXED_KW)
    want = _script(je, JSamplingParams, [("add", "stay", stay, _greedy(4))])
    assert "gone" not in res and len(res["stay"]["tokens"]) == 4
    assert res["stay"]["tokens"] == want["stay"]["tokens"]


def test_mixed_stats_none_when_off(shared):
    _, te = _engines(shared, max_batch=4, prefill_buckets=(8, 32))
    assert te.mixed_stats() is None


def test_mixed_step_tokens_must_exceed_max_batch(shared):
    with pytest.raises(ValueError, match="must exceed max_batch"):
        LLMEngine(shared[1], TINY, TOK, EngineConfig(
            max_batch=4, mixed_step_tokens=4), dtype=torch.float32,
            device="cpu")


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    gen = torch.Generator().manual_seed(0)
    params = t_llama.init_params(TINY, gen, dtype=torch.float32,
                                 device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(params, TINY, TOK)


# ---------------------------------------------------------------------------
# quantized serving: int8 / int4 weights, int8 KV pools
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quantized(shared):
    """{mode: (JAX params, port params)} for weights none / int8 / int4
    (the same scaled TINY weights, quantized by the JAX package with group
    32 and converted)."""
    out = {"none": shared}
    for mode in ("int8", "int4"):
        jp = jq.quantize_params(shared[0], mode, 32)
        out[mode] = (jp, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu",
            dtype=torch.float32))
    return out


QUANT_KW = dict(max_batch=4, prefill_buckets=(8, 32), prefill_batch=2,
                prefill_token_budget=64)


@pytest.mark.parametrize("weights,kv", [("int8", "none"), ("int4", "none"),
                                        ("none", "int8"), ("int8", "int8")])
def test_quantized_engine_matches_jax(quantized, weights, kv):
    """Prompts over both buckets, one chunked across quanta, under
    quantized weights and/or int8 KV: tokens, text, finish and usage equal
    the JAX engine's."""
    prompts = [TOK.encode("hi!"), TOK.encode("quantized bucket of 32?"),
               TOK.encode("a prompt that is chunked across two quanta.."),
               TOK.encode("x")]
    requests = _reqs(prompts, max_tokens=10)
    je, te = _engines(quantized[weights], kv_quant=kv, **QUANT_KW)
    jres = _drive(je, requests, JSamplingParams)
    tres = _drive(te, requests, SamplingParams)
    _compare(quantized[weights], requests, jres, tres, kv)
    assert te.audit_pages() == []
    assert isinstance(te.state.k, QuantPool) == (kv == "int8")


def test_int8_kv_prefix_reuse(quantized):
    prompt = TOK.encode("shared prefix, reused twice")
    je, te = _engines(quantized["int8"], kv_quant="int8", max_batch=2,
                      prefill_buckets=(8, 32))
    for rid in ("first", "second"):
        requests = [(rid, prompt, dict(temperature=0.0, max_tokens=9))]
        jres = _drive(je, requests, JSamplingParams)
        tres = _drive(te, requests, SamplingParams)
        _compare(quantized["int8"], requests, jres, tres, "int8")
    assert te.cache_stats().hits == je.allocator.stats().hits > 0
    assert te.audit_pages() == []


def test_int8_kv_preemption_on_cache_full(quantized, monkeypatch):
    preempted = []
    orig = LLMEngine._preempt

    def spy(self, seq, outputs):
        preempted.append(seq.request_id)
        return orig(self, seq, outputs)

    monkeypatch.setattr(LLMEngine, "_preempt", spy)
    requests = _reqs([TOK.encode("ABCDEFGH"), TOK.encode("87654321")],
                     max_tokens=10)
    je, te = _engines(quantized["none"], paged=(8, 4, 6), max_batch=2,
                      prefill_buckets=(8, 32), kv_quant="int8")
    jres = _drive(je, requests, JSamplingParams)
    tres = _drive(te, requests, SamplingParams)
    assert preempted, "the small pool never forced a preemption"
    _compare(quantized["none"], requests, jres, tres, "int8")
    assert te.audit_pages() == []


def test_kv_quant_config_errors(shared):
    with pytest.raises(ValueError, match="unknown kv_quant"):
        LLMEngine(shared[1], TINY, TOK, EngineConfig(kv_quant="fp8"),
                  dtype=torch.float32, device="cpu")
    # the mixed step over int8 pools is served (the reference's gather +
    # dequantize path), so the pair constructs
    eng = LLMEngine(shared[1], TINY, TOK, EngineConfig(
        max_batch=4, mixed_step_tokens=12, kv_quant="int8"),
        dtype=torch.float32, device="cpu")
    assert isinstance(eng.state.k, QuantPool) and eng.mixed_stats()


def _int8_mixed_scenario(name):
    """(actions, engine kwargs) of the mixed scenarios of
    ``tests/test_engine_mixed.py``."""
    rng = np.random.default_rng({"long": 3, "multi": 9, "preempt": 13,
                                 "abort": 17}[name])
    if name == "long":
        chats = [rng.integers(1, 200, size=6).tolist() for _ in range(2)]
        actions = [("add", f"c{i}", c, _greedy(12))
                   for i, c in enumerate(chats)]
        actions += [("steps", 3), ("add", "long",
                                   rng.integers(1, 200, size=60).tolist(),
                                   _greedy(8))]
        return actions, dict(mixed=20)
    if name == "multi":
        shared_ids = rng.integers(1, 200, size=16).tolist()
        prompts = [shared_ids + rng.integers(1, 200, size=4 + i).tolist()
                   for i in range(3)]
        return ([("add", "p0", prompts[0], _greedy(6)), ("steps", 20),
                 ("add", "p1", prompts[1], _greedy(6)),
                 ("add", "p2", prompts[2], _greedy(6))], dict(mixed=24))
    if name == "preempt":
        return ([("add", f"r{i}", rng.integers(1, 200, size=10).tolist(),
                  _greedy(10)) for i in range(3)],
                dict(mixed=12, paged=(9, 4, 10), max_batch=2))
    gone = rng.integers(1, 200, size=40).tolist()
    stay = rng.integers(1, 200, size=8).tolist()
    return ([("add", "gone", gone, _greedy(4)),
             ("add", "stay", stay, _greedy(4)), ("steps", 1),
             ("abort", "gone")], dict(mixed=12))


@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("weights", ["none", "int8"])
@pytest.mark.parametrize("scenario", ["long", "multi", "preempt", "abort"])
def test_int8_kv_mixed_matches_jax(quantized, scenario, weights, loop):
    """The mixed step over int8 pools (the port's gather + dequantize +
    ``ragged_gqa_attention``, as the JAX package serves it), dense or
    int8 weights, in its K = 1 form and under ``loop_to_completion`` in
    its K-block form: tokens, text, finish and usage equal the JAX mixed
    step's on the same engine config; every page balances."""
    actions, kw = _int8_mixed_scenario(scenario)
    mixed = kw.pop("mixed")
    kw = {**MIXED_KW, **kw, "kv_quant": "int8", "loop_to_completion": loop}
    je, tm = _engines(quantized[weights], mixed_step_tokens=mixed, **kw)
    jres = _script(je, JSamplingParams, actions)
    tres = _script(tm, SamplingParams, actions)
    # an aborted request may have emitted nothing
    requests = [(a[1], a[2], a[3]) for a in actions
                if a[0] == "add" and a[1] in jres]
    _compare(quantized[weights], requests, jres, tres, "int8")
    assert set(tres) == set(jres)
    assert tm.mixed_stats()["steps"] > 0
    assert tm.mixed_stats() == je.mixed_stats()
    assert tm.audit_pages() == []
