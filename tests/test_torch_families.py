"""The model families in the port: Mixtral (MoE), Gemma-2, Qwen2 and
Mistral, against HF's goldens and against the JAX package.

The port counterparts of ``tests/test_golden_hf.py``'s
``test_family_forward_matches_hf_logits`` and
``test_family_greedy_matches_hf`` on the four HF-written family fixtures
(logits within 2e-3 of HF's torch forward, argmax equal at more than 99 %
of positions, the greedy continuation identical through ``forward``,
``greedy_generate`` and the paged engine); then, on the JAX package's TINY
family configs (``TINY_MOE``, ``TINY_BIAS``, ``TINY_GEMMA2``, ``TINY_SWA``)
with shared weights: the parameter tree, the forward (logits within 1e-4
in float32), the MoE layer with dense, int8 and int4 experts, the top-k
tie rule, quantization over expert stacks (bit-identical codes and
scales), ``init_random_quantized``'s tree, ``hidden_states``, the presets,
and the bf16 rounding of the Gemma scalings. The engine's step modes
against the JAX engine are in ``tests/test_torch_engine_families.py``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.models import configs as j_configs
from distributed_inference_server_tpu.models import llama as j_llama
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
from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.generate import (
    greedy_generate,
)
from distributed_inference_server_tpu_torch.models.loader import (
    load_checkpoint,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    load_tokenizer,
)
from distributed_inference_server_tpu_torch.ops import quant as tq

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FAMILIES = ["tiny_mixtral_hf", "tiny_gemma2_hf", "tiny_qwen2_hf",
            "tiny_mistral_hf"]
TINY_FAMILIES = ["tiny-moe", "tiny-bias", "tiny-gemma2", "tiny-swa"]
SCALE = 8.0
LINEAR = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _load(family):
    return load_checkpoint(os.path.join(FIXTURES, family),
                           dtype=torch.float32, device="cpu")


def _golden(family):
    return np.load(os.path.join(FIXTURES, f"golden_{family}.npz"))


# ---------------------------------------------------------------------------
# the HF-written family fixtures and their HF-torch goldens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_family_forward_matches_hf_logits(family, impl):
    """Mixtral (expert naming and routing), Gemma-2 (unit-offset sandwich
    norms folded at load, soft-caps, query_pre_attn_scalar, alternating
    windows), Qwen2 (qkv bias), Mistral (a uniform window): prefill logits
    at every position against HF's forward."""
    params, cfg = _load(family)
    g = _golden(family)
    ids = g["input_ids"]
    B, T = ids.shape
    cache = llama.KVCache.create(cfg, B, T, dtype=torch.float32,
                                 device="cpu")
    pos = torch.arange(T).expand(B, T)
    logits, _ = llama.forward(params, cfg, torch.as_tensor(ids), pos, cache,
                              pos, torch.full((B,), T, dtype=torch.int32),
                              impl)
    got, want = logits.numpy(), g["logits"]
    diff = np.abs(got - want).max()
    assert diff < 2e-3, f"{family}: max |logit diff| {diff} vs HF"
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.99, family


@pytest.mark.parametrize("family", FAMILIES)
def test_family_greedy_matches_hf(family):
    """Each family's decode path (the dense cache, windows, soft-caps, MoE
    routing at T = 1) against HF's greedy continuation."""
    params, cfg = _load(family)
    g = _golden(family)
    prompt = g["input_ids"][0].tolist()
    want = g["greedy_out"].tolist()[len(prompt):]
    assert greedy_generate(params, cfg, prompt,
                           max_new_tokens=len(want)) == want


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mode", ["depth0", "depth1", "mixed"])
def test_family_engine_paged_greedy_matches_hf(family, mode):
    """The paged engine (page tables, pipelined blocks, or the ragged
    mixed step) reproduces HF's greedy continuation; the pool balances."""
    params, cfg = _load(family)
    g = _golden(family)
    prompt = g["input_ids"][0].tolist()
    want = g["greedy_out"].tolist()[len(prompt):]
    kw = ({"mixed_step_tokens": 12} if mode == "mixed"
          else {"pipeline_depth": int(mode[-1])})
    engine = LLMEngine(params, cfg, load_tokenizer(
        os.path.join(FIXTURES, "tiny_llama_hf")), EngineConfig(
        max_batch=2, prefill_buckets=(16,), paged=PagedCacheConfig(
            num_pages=32, page_size=4, max_pages_per_seq=16), **kw),
        dtype=torch.float32, device="cpu")
    engine.add_request("g", prompt, SamplingParams(max_tokens=len(want),
                                                   temperature=0.0))
    tokens = []
    for _ in range(200):
        if not engine.has_work():
            break
        for out in engine.step():
            assert out.error is None, out.error
            if out.token_id is not None:
                tokens.append(out.token_id)
    assert tokens == want
    assert engine.audit_pages() == []


# ---------------------------------------------------------------------------
# the TINY family configs on shared weights
# ---------------------------------------------------------------------------


def _cfgs(name):
    return j_configs.get_config(name), t_configs.get_config(name)


def _shared_tree(name, seed=0):
    """Numpy tree of the JAX ``init_params`` of config ``name``, every
    linear family (and the embedding) scaled by 8 so greedy continuations
    vary."""
    jcfg, _ = _cfgs(name)
    jp = j_llama.init_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * SCALE
    for k in LINEAR:
        tree["layers"][k] = tree["layers"][k] * SCALE
    return tree


def _both(tree, quant="none"):
    """(JAX params, port params) of a numpy tree; ``quant`` quantizes the
    linear families on the JAX side (group 32) and hands the codes over."""
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    if quant != "none":
        jp = jq.quantize_params(jp, quant, 32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu", dtype=torch.float32)


def test_presets_match_jax():
    """Every preset of the JAX package, field for field."""
    assert sorted(t_configs.PRESETS) == sorted(j_configs.PRESETS)
    for name, jcfg in j_configs.PRESETS.items():
        tcfg = t_configs.get_config(name)
        got = {f.name: getattr(tcfg, f.name)
               for f in dataclasses.fields(tcfg) if f.name != "rope_scaling"}
        want = {f.name: getattr(jcfg, f.name)
                for f in dataclasses.fields(jcfg) if f.name != "rope_scaling"}
        assert got == want, name
        assert (tcfg.rope_scaling is None) == (jcfg.rope_scaling is None)
        assert tcfg.layer_windows() == jcfg.layer_windows(), name


@pytest.mark.parametrize("name", TINY_FAMILIES)
def test_init_params_tree_matches_jax(name):
    """The same keys, shapes and dtype; norms are ones."""
    jcfg, tcfg = _cfgs(name)
    jp = j_llama.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = llama.init_params(tcfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
    j_flat = dict(jax.tree_util.tree_leaves_with_path(jp))
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for path, leaf in j_flat.items():
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert node.dtype == torch.float32
        if path[-1].key.endswith("norm"):
            assert bool((node == 1).all()), path


@pytest.mark.parametrize("name,quant", [
    ("tiny-moe", "none"), ("tiny-moe", "int8"), ("tiny-moe", "int4"),
    ("tiny-bias", "none"), ("tiny-gemma2", "none"), ("tiny-swa", "none")])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_forward_matches_jax(name, quant, impl):
    """A right-padded batch through the dense-cache forward: logits at
    valid positions within 1e-4, argmax equal, the cache equal where
    written (MoE with dense, int8 and int4 experts)."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _both(_shared_tree(name), quant)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 255, size=(3, 14)).astype(np.int32)
    valid = np.array([14, 9, 1], np.int32)
    B, T = ids.shape
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    write = np.where(pos < valid[:, None], pos, 16).astype(np.int32)
    j_cache = j_llama.KVCache.create(jcfg, B, 16, dtype=jnp.float32)
    j_logits, j_cache = j_llama.forward(
        jp, jcfg, jnp.asarray(ids), jnp.asarray(pos), j_cache,
        jnp.asarray(write), jnp.asarray(valid))
    t_cache = llama.KVCache.create(tcfg, B, 16, dtype=torch.float32,
                                   device="cpu")
    t_logits, t_cache = llama.forward(
        tp, tcfg, torch.as_tensor(ids), torch.as_tensor(pos), t_cache,
        torch.as_tensor(write), torch.as_tensor(valid), impl)
    sel = pos < valid[:, None]
    got, want = t_logits.numpy()[sel], np.asarray(j_logits)[sel]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    for t, j in ((t_cache.k, j_cache.k), (t_cache.v, j_cache.v)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("logits", [
    [[1.0, 1.0, 1.0, 1.0]],                    # every expert tied
    [[0.5, 2.0, 2.0, -1.0]],                   # a tie inside the top k
    [[3.0, 1.0, 1.0, 1.0]],                    # a tie across the k-th place
    [[0.0, -2.0, 0.0, 0.0], [7.0, 7.0, 7.0, 6.0]],
])
def test_moe_route_breaks_ties_as_lax_top_k(logits):
    """Equal router logits pick the lower expert id first, as
    ``lax.top_k`` does; the weights are the softmax over the chosen k."""
    x = np.asarray(logits, np.float32)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), 2)
    weights, idx = llama.moe_route(torch.as_tensor(x), 2)
    assert idx.tolist() == np.asarray(j_idx).tolist()
    np.testing.assert_allclose(weights.numpy(),
                               np.asarray(jax.nn.softmax(j_vals, -1)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_moe_mlp_matches_jax(quant, impl):
    """One MoE layer (``_moe_mlp``) on the same tokens: routing, every
    expert on every token, the weighted combine; quantized experts through
    the group-dequant matmul's wrapper (its plain version on the CPU)."""
    jcfg, tcfg = _cfgs("tiny-moe")
    jp, tp = _both(_shared_tree("tiny-moe"), quant)
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(
        np.float32)
    j_layer = jax.tree_util.tree_map(lambda a: a[1], jp["layers"])
    want = j_llama._moe_mlp(jnp.asarray(x), j_layer, jcfg)
    got = llama._moe_mlp(torch.as_tensor(x), tp["layers"], 1, tcfg, impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_over_expert_stacks_is_bit_identical(mode):
    """[L, E, in, out] expert stacks: codes and scales equal the JAX
    package's (groups along the input axis, layer by layer on the port's
    side, the whole stack at once on the JAX side)."""
    tree = _shared_tree("tiny-moe")
    jp = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree), mode)
    tp = tq.quantize_params(params_from_numpy(tree, device="cpu",
                                              dtype=torch.float32), mode)
    for k in LINEAR:
        jw, tw = jp["layers"][k], tp["layers"][k]
        assert type(tw).__name__ == type(jw).__name__, k
        np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
        np.testing.assert_array_equal(tw.s.numpy(), np.asarray(jw.s))
    assert not tq.is_quantized(tp["layers"]["router"])
    e = tq.expert_weight(tp["layers"]["w_gate"], 1, 3)
    assert e.q.is_contiguous() and tuple(e.q.shape) == tuple(
        np.asarray(jp["layers"]["w_gate"].q).shape[2:])
    jw = jp["layers"]["w_gate"]
    j_e = type(jw)(*(np.asarray(a)[1, 3] for a in jw))
    np.testing.assert_array_equal(tq.dense_view(e, torch.float32).numpy(),
                                  np.asarray(jq.dense_view(j_e, jnp.float32)))


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("name", ["tiny", "tiny-moe", "tiny-gemma2"])
def test_init_random_quantized_tree_matches_jax(mode, name):
    """The same keys, leaf kinds, shapes and dtypes as the JAX package's
    ``init_random_quantized``, scales equal to 1 / (qmax sqrt(d_in)), norms
    ones; the codes are random bits (the generators differ)."""
    jcfg, tcfg = _cfgs(name)
    jp = jq.init_random_quantized(jax.random.PRNGKey(0), jcfg, mode,
                                  dtype=jnp.float32)
    tp = tq.init_random_quantized(tcfg, mode, torch.Generator().manual_seed(
        0), dtype=torch.float32, device="cpu")
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for key in jp:
        pairs = ([(k, jp[key][k], tp[key][k]) for k in jp[key]]
                 if isinstance(jp[key], dict) else [(key, jp[key], tp[key])])
        for k, j, t in pairs:
            if jq.is_quantized(j):
                assert type(t).__name__ == type(j).__name__, k
                assert tuple(t.q.shape) == np.asarray(j.q).shape, k
                assert str(t.q.dtype).split(".")[-1] == str(
                    np.asarray(j.q).dtype), k
                np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s))
                assert len(torch.unique(t.q)) > 8, k  # random bits
            else:
                assert tuple(t.shape) == np.asarray(j).shape, k
                if k.endswith("norm"):
                    assert bool((t == 1).all()), k
    dense = tq.dequantize(tp["layers"]["w_up"], torch.float32)
    # |code| <= 128 (int8) or 8 (int4) times 1 / (qmax sqrt(64))
    qmax = 127 if mode == "int8" else 7
    assert 0.9 < float(dense.abs().max()) * 64 ** 0.5 <= (qmax + 1) / qmax + 1e-6


@pytest.mark.parametrize("name", TINY_FAMILIES + ["tiny"])
def test_hidden_states_matches_jax(name):
    """The embeddings routes' cache-less forward: final-norm hidden states
    [B, T, H] in f32, at every valid position of a right-padded batch."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _both(_shared_tree(name))
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 255, size=(2, 11)).astype(np.int32)
    valid = np.array([11, 6], np.int32)
    pos = np.broadcast_to(np.arange(11), (2, 11)).astype(np.int32)
    want = j_llama.hidden_states(jp, jcfg, jnp.asarray(ids),
                                 jnp.asarray(pos), jnp.asarray(valid))
    got = llama.hidden_states(tp, tcfg, torch.as_tensor(ids),
                              torch.as_tensor(pos), torch.as_tensor(valid))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 11, 64)
    sel = pos < valid[:, None]
    np.testing.assert_allclose(got.numpy()[sel], np.asarray(want)[sel],
                               atol=1e-4, rtol=1e-4)


def test_gemma_scalings_round_in_the_activation_dtype():
    """bf16: sqrt(3584) = 59.866 is taken as bf16 (59.75) before it
    multiplies, as the JAX package's ``jnp.asarray(x, h.dtype)``; the
    port's product equals the JAX product bit for bit (a product by the
    f32 factor would round otherwise)."""
    assert llama._in_dtype(3584 ** 0.5, torch.bfloat16) == 59.75 == float(
        jnp.asarray(3584 ** 0.5, jnp.bfloat16))
    x = np.random.default_rng(4).standard_normal(4096).astype(np.float32)
    for factor in (3584 ** 0.5, (16 / 24) ** 0.5, 1.0):
        want = jnp.asarray(x, jnp.bfloat16) * jnp.asarray(factor,
                                                          jnp.bfloat16)
        got = torch.as_tensor(x).bfloat16() * llama._in_dtype(
            factor, torch.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_final_softcap_bounds_the_logits():
    """Gemma-2's final-logit soft-cap: |logits| < cap, tanh(x / cap) * cap
    of the uncapped product."""
    _, tcfg = _cfgs("tiny-gemma2")
    _, tp = _both(_shared_tree("tiny-gemma2"))
    h = torch.randn(3, 64) * 40
    capped = llama._unembed(tp, tcfg, h)
    raw = llama._unembed(tp, tcfg.with_overrides(final_logit_softcap=None),
                         h)
    assert float(capped.abs().max()) < 30.0 < float(raw.abs().max())
    torch.testing.assert_close(capped, torch.tanh(raw / 30.0) * 30.0)
