"""The port's engine against the JAX engine on the model families, step by
step: the quantum path at pipeline depths 0 and 1 and the ragged mixed
step (K = 1).

The JAX package's TINY family configs — ``TINY_MOE`` with dense, int8 and
int4 experts (quantized by the JAX package, group 32), ``TINY_BIAS``,
``TINY_GEMMA2`` and ``TINY_SWA`` (a window of 8 tokens over pages of 4,
so the trace's rows reclaim pages behind it) — with shared weights (JAX
``init_params`` -> numpy, every linear family scaled by 8), in float32 on
the CPU, the JAX engine on its reference path. Both engines run one script
of requests in lockstep; after every step the outputs (request, token,
text, finish, error), every live sequence's block table (reclaimed
entries hold the sentinel ``num_pages``), its reclaimed prefix and the
``reclaim`` event count must be equal, and the port's page books balance.
The looped blocks and the K-block mixed step, and the window reclaim on
its own, are in ``tests/test_torch_engine_families_loop.py``.
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
from distributed_inference_server_tpu.models import configs as j_configs
from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models.tokenizer import (
    ByteTokenizer as JByteTokenizer,
)
from distributed_inference_server_tpu.ops import quant as jq
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PagedCacheConfig,
)
from distributed_inference_server_tpu_torch.models import configs as t_configs
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)

SCALE = 8.0
LINEAR = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
TOK = ByteTokenizer()
# (config, weight quantization)
CASES = {
    "moe-dense": ("tiny-moe", "none"),
    "moe-int8": ("tiny-moe", "int8"),
    "moe-int4": ("tiny-moe", "int4"),
    "bias": ("tiny-bias", "none"),
    "gemma2": ("tiny-gemma2", "none"),
    "swa": ("tiny-swa", "none"),
}
# requests, then engine steps, then a late request: a prompt chunked over
# quanta (46 ids over buckets 8 / 32), short ones sharing a chunk, rows
# decoding past the 8-token window
SCRIPT = [
    ("add", "r0", "hello there", 12),
    ("add", "r1", "a longer prompt that is chunked across quanta..", 10),
    ("add", "r2", "x", 14),
    ("steps", 3),
    ("add", "r3", "late arrival", 8),
]


def shared_params(case):
    """(JAX config, port config, JAX params, port params) of ``case``."""
    name, quant = CASES[case]
    jcfg, tcfg = j_configs.get_config(name), t_configs.get_config(name)
    jp = j_llama.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * SCALE
    for k in LINEAR:
        tree["layers"][k] = tree["layers"][k] * SCALE
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    if quant != "none":
        jp = jq.quantize_params(jp, quant, 32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu", dtype=torch.float32)
    return jcfg, tcfg, jp, tp


def make_engines(case, paged=(64, 4, 24), **kw):
    jcfg, tcfg, jp, tp = shared_params(case)
    common = dict(max_batch=4, prefill_buckets=(8, 32), prefill_batch=2,
                  prefill_token_budget=64, **kw)
    je = JEngine(jp, jcfg, JByteTokenizer(), JEngineConfig(
        paged=JPagedCacheConfig(*paged), attention_impl="xla",
        native_allocator=False, **common), dtype=jnp.float32)
    te = LLMEngine(tp, tcfg, TOK, EngineConfig(
        paged=PagedCacheConfig(*paged), **common), dtype=torch.float32,
        device="cpu")
    return je, te


def _outs(engine):
    return [(o.request_id, o.token_id, o.text, o.finished,
             getattr(o.finish_reason, "value", None), o.error)
            for o in engine.step()]


def _tables(engine):
    return {rid: (list(s.block_table), s.freed_upto)
            for rid, s in engine._by_id.items()}


def lockstep(je, te, script=SCRIPT, max_steps=400):
    """Drive both engines through ``script`` step by step, holding every
    step's outputs, block tables, reclaimed prefixes and reclaim count
    equal. Returns ({rid: tokens}, reclaim events)."""
    toks = {}

    def step():
        jo, to = _outs(je), _outs(te)
        assert to == jo
        assert _tables(te) == _tables(je)
        assert te._sc_events["reclaim"] == je._sc_events["reclaim"]
        assert te.audit_pages() == []
        for rid, tok, *_ in to:
            if tok is not None:
                toks.setdefault(rid, []).append(tok)

    for act in script:
        if act[0] == "add":
            _, rid, text, n = act
            ids = TOK.encode(text)
            je.add_request(rid, list(ids), JSamplingParams(
                max_tokens=n, temperature=0.0))
            te.add_request(rid, list(ids), SamplingParams(
                max_tokens=n, temperature=0.0))
        else:
            for _ in range(act[1]):
                step()
    for _ in range(max_steps):
        if not (je.has_work() or te.has_work()):
            break
        step()
    assert not te.has_work() and not je.has_work(), "engines did not drain"
    return toks, te._sc_events["reclaim"]


MODES = {
    "depth0": dict(pipeline_depth=0),
    "depth1": dict(pipeline_depth=1),
    "mixed": dict(mixed_step_tokens=24),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_family_engine_matches_jax(case, mode):
    je, te = make_engines(case, **MODES[mode])
    toks, reclaimed = lockstep(je, te)
    assert set(toks) == {"r0", "r1", "r2", "r3"}
    assert all(len(t) > 1 for t in toks.values())
    # only a model whose every layer slides reclaims pages
    assert (reclaimed > 0) == (case == "swa")
    if mode == "mixed":
        assert te.mixed_stats()["steps"] > 0
