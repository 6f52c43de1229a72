"""The port's engine against the JAX package's, greedy tokens identical.

Both engines get the same weights (JAX ``init_params`` -> numpy, every
matrix scaled by 8 so TINY's greedy continuations vary instead of
repeating one byte) and the same requests, and run in float32 on the CPU;
the JAX engine on its reference path (``attention_impl="xla"``,
``native_allocator=False``). Covered: prompts spanning the prefill buckets,
a prompt chunked over several quanta, prefix reuse, preemption on
``CacheFull`` with a small pool, and stop sequences.

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


def _dense_logits(t_params, ids):
    """Reference logits [len(ids), V]: one plain forward over the whole
    sequence in a fresh pool."""
    n = len(ids)
    ps = 4
    pages = -(-n // ps)
    pool = torch.zeros(TINY.num_layers, pages * ps + 1, TINY.num_kv_heads,
                       TINY.head_dim)
    pv = torch.zeros_like(pool)
    tables = torch.arange(pages, dtype=torch.int32)[None]
    pos = torch.arange(n, dtype=torch.int32)[None]
    logits, _, _ = t_llama.paged_forward(
        t_params, TINY, torch.tensor([ids], dtype=torch.int32), pos, pool,
        pv, pos, tables, torch.tensor([n], dtype=torch.int32), impl="plain",
        page_size=ps)
    return logits[0]


def _assert_no_near_ties(t_params, prompt, tokens):
    if not tokens:
        return
    logits = _dense_logits(t_params, list(prompt) + tokens[:-1])
    steps = logits[len(prompt) - 1:]
    top2 = torch.topk(steps, 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    for i, g in enumerate(gaps):
        assert g > TIE_TOL, (
            f"near-tie at generated step {i}: top-2 logit gap {g:.2e} <= "
            f"{TIE_TOL} — a tie, not a fault")


def _compare(shared, requests, jres, tres):
    for rid, prompt, _ in requests:
        _assert_no_near_ties(shared[1], prompt, jres[rid]["tokens"])
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


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    gen = torch.Generator().manual_seed(0)
    params = t_llama.init_params(TINY, gen, dtype=torch.float32,
                                 device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(params, TINY, TOK)
