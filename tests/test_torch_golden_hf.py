"""The port against HF's own goldens and against the JAX package.

The fixtures under ``tests/fixtures/`` were written by Hugging Face tooling
(``LlamaForCausalLM.save_pretrained``, the ``tokenizers`` library) and the
goldens come from the HF torch forward, an implementation independent of
both packages. These are the port's counterparts of
``tests/test_golden_hf.py``: the config, the prefill logits (< 1e-3, argmax
equal at every valid position), the greedy continuation through
``greedy_generate`` and through the paged engine (with the checkpoint's
own tokenizer), the tokenizer's encodings, and the tie reconciliation.
``tiny_mistral_hf`` (a sliding window only) gets the family gates too; the
other families' fixtures are held to their goldens in
``tests/test_torch_families.py``. Then ``forward``, ``greedy_generate`` and the sampled
``generate`` against the JAX package on shared TINY weights; sampling is
compared by the nucleus set, since the two packages' RNGs differ.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu.models.generate import (
    generate as j_generate,
)
from distributed_inference_server_tpu.models.generate import (
    greedy_generate as j_greedy_generate,
)
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PagedCacheConfig,
)
from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.generate import (
    generate,
    greedy_generate,
)
from distributed_inference_server_tpu_torch.models.loader import (
    load_checkpoint,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    load_tokenizer,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CKPT = os.path.join(FIXTURES, "tiny_llama_hf")
GOLDENS = {"tiny_llama_hf": "golden_tiny_llama.npz",
           "tiny_mistral_hf": "golden_tiny_mistral_hf.npz"}


def _load(family):
    return load_checkpoint(os.path.join(FIXTURES, family),
                           dtype=torch.float32, device="cpu")


def _golden(family):
    return np.load(os.path.join(FIXTURES, GOLDENS[family]))


def test_config_parses_hf_config_json():
    _, cfg = _load("tiny_llama_hf")
    assert cfg.vocab_size == 384
    assert cfg.hidden_size == 64
    assert cfg.num_layers == 2
    assert cfg.num_heads == 4
    assert cfg.num_kv_heads == 2
    assert cfg.head_dim == 16
    assert not cfg.tie_word_embeddings


@pytest.mark.parametrize("family", sorted(GOLDENS))
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_forward_matches_hf_logits(family, impl):
    """Prefill logits against the HF torch forward, every valid position
    of every prompt (the kernel path's RMSNorm and RoPE wrappers take
    their plain versions on CPU tensors)."""
    params, cfg = _load(family)
    g = _golden(family)
    ids = g["input_ids"]
    mask = (g["attention_mask"] if "attention_mask" in g
            else np.ones_like(ids))
    B, T = ids.shape
    cache = llama.KVCache.create(cfg, B, T, dtype=torch.float32,
                                 device="cpu")
    pos = torch.arange(T).expand(B, T)
    logits, _ = llama.forward(params, cfg, torch.as_tensor(ids), pos, cache,
                              pos, torch.as_tensor(mask.sum(axis=1),
                                                   dtype=torch.int32), impl)
    got, want, sel = logits.numpy(), g["logits"], mask.astype(bool)
    diff = np.abs(got[sel] - want[sel]).max()
    assert diff < 1e-3, f"{family}: max |logit diff| {diff} vs HF"
    assert (got[sel].argmax(-1) == want[sel].argmax(-1)).all()


@pytest.mark.parametrize("family", sorted(GOLDENS))
def test_greedy_generation_matches_hf(family):
    params, cfg = _load(family)
    g = _golden(family)
    prompt = (g["greedy_prompt"] if "greedy_prompt" in g
              else g["input_ids"][0]).tolist()
    want = g["greedy_out"].tolist()[len(prompt):]
    assert greedy_generate(params, cfg, prompt,
                           max_new_tokens=len(want)) == want


@pytest.mark.parametrize("family", sorted(GOLDENS))
@pytest.mark.parametrize("depth", [0, 1])
def test_engine_paged_greedy_matches_hf(family, depth):
    """The paged serving path (engine, page tables, pipelined blocks)
    reproduces the HF greedy continuation. The checkpoint's own tokenizer
    for the llama fixture: its EOS (<|end_of_text|> = 1) does not collide
    with generated ids as the byte tokenizer's 257 would."""
    params, cfg = _load(family)
    g = _golden(family)
    prompt = (g["greedy_prompt"] if "greedy_prompt" in g
              else g["input_ids"][0]).tolist()
    want = g["greedy_out"].tolist()[len(prompt):]
    tok = load_tokenizer(CKPT)
    engine = LLMEngine(params, cfg, tok, EngineConfig(
        max_batch=2, prefill_buckets=(16,), pipeline_depth=depth,
        paged=PagedCacheConfig(num_pages=32, page_size=4,
                               max_pages_per_seq=16)),
        dtype=torch.float32, device="cpu")
    engine.add_request("g", prompt, SamplingParams(max_tokens=len(want),
                                                   temperature=0.0))
    tokens = []
    for _ in range(200):
        if not engine.has_work():
            break
        for out in engine.step():
            if out.token_id is not None:
                tokens.append(out.token_id)
    assert tokens == want
    assert engine.audit_pages() == []


def test_tokenizer_parity_with_hf_tokenizers():
    """HFTokenizer over the committed tokenizer.json reproduces the
    ``tokenizers`` library's encodings and decodings exactly."""
    with open(os.path.join(FIXTURES, "golden_tok.json")) as f:
        g = json.load(f)
    tok = load_tokenizer(CKPT)
    assert tok.vocab_size == g["vocab_size"]
    assert tok.bos_id == g["bos_id"] and g["eos_id"] in tok.eos_ids
    for text, want_ids in g["encodings"].items():
        assert tok.encode(text, add_bos=False) == want_ids, text
        assert tok.encode(text) == [g["bos_id"]] + want_ids
    for text, want_text in g["decodings"].items():
        assert tok.decode(tok.encode(text, add_bos=False)) == want_text
    # the checkpoint's own chat template travels with the tokenizer
    assert getattr(tok, "chat_template", None)


def test_loader_reconciles_tie_with_checkpoint_contents(tmp_path):
    dst = tmp_path / "claims_tied"
    shutil.copytree(CKPT, dst)
    cfgp = dst / "config.json"
    obj = json.loads(cfgp.read_text())
    obj["tie_word_embeddings"] = True  # lie: shards carry lm_head.weight
    cfgp.write_text(json.dumps(obj))
    params, cfg = load_checkpoint(str(dst), dtype=torch.float32,
                                  device="cpu")
    assert not cfg.tie_word_embeddings  # checkpoint wins
    assert "lm_head" in params


def test_mistral_window_is_served():
    params, cfg = _load("tiny_mistral_hf")
    assert cfg.sliding_window and set(cfg.layer_windows()) == {
        cfg.sliding_window}
    LLMEngine(params, cfg, load_tokenizer(None), dtype=torch.float32,
              device="cpu")


# ---------------------------------------------------------------------------
# forward / greedy_generate / generate against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared():
    """TINY weights from the JAX init, every matrix scaled by 8 so greedy
    continuations vary."""
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * 8.0
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * 8.0
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu", dtype=torch.float32))


def test_forward_matches_jax_on_shared_weights(shared):
    """A right-padded batch: logits at valid positions within f32
    tolerance, argmax equal, and the dense cache equal where written."""
    j_params, t_params = shared
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 255, size=(3, 12)).astype(np.int32)
    valid = np.array([12, 7, 1], np.int32)
    B, T = ids.shape
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    write = np.where(pos < valid[:, None], pos, 16).astype(np.int32)
    j_cache = j_llama.KVCache.create(J_TINY, B, 16, dtype=jnp.float32)
    j_logits, j_cache = j_llama.forward(
        j_params, J_TINY, jnp.asarray(ids), jnp.asarray(pos), j_cache,
        jnp.asarray(write), jnp.asarray(valid))
    t_cache = llama.KVCache.create(TINY, B, 16, dtype=torch.float32,
                                   device="cpu")
    t_logits, t_cache = llama.forward(
        t_params, TINY, torch.as_tensor(ids), torch.as_tensor(pos), t_cache,
        torch.as_tensor(write), torch.as_tensor(valid))
    sel = pos < valid[:, None]
    got, want = t_logits.numpy()[sel], np.asarray(j_logits)[sel]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    for t, j in ((t_cache.k, j_cache.k), (t_cache.v, j_cache.v)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)
    assert not t_cache.k[:, :, 12:].any()  # padding writes were dropped


@pytest.mark.parametrize("prompt", [[256, 72, 105], list(range(1, 40))])
def test_greedy_generate_matches_jax(shared, prompt):
    j_params, t_params = shared
    want = j_greedy_generate(j_params, J_TINY, prompt, max_new_tokens=12,
                             max_seq=64, eos_ids=(257,))
    got = greedy_generate(t_params, TINY, prompt, max_new_tokens=12,
                          max_seq=64, eos_ids=(257,))
    assert got == want and len(got) == 12


def test_generate_stops_on_eos_per_row(shared):
    """A row whose greedy continuation reaches an EOS id stops there and
    does not emit it; its batch-mate runs to its budget."""
    _, t_params = shared
    prompt = [256, 72, 105]
    free = greedy_generate(t_params, TINY, prompt, max_new_tokens=8,
                           max_seq=64)
    eos = free[3]
    ids = torch.tensor([prompt + [0], [256, 1, 2, 3]], dtype=torch.int32)
    res = generate(t_params, TINY, ids, torch.tensor([3, 4]), None,
                   torch.zeros(2), torch.ones(2), 8, 64, eos_ids=(eos,))
    n = free.index(eos)
    assert res.lengths[0] == n and res.finished_eos[0]
    assert res.tokens[0, :n].tolist() == free[:n]


def _nucleus(logits, temperature, top_p):
    """The sorted-prefix nucleus of softmax(logits / temperature)."""
    p = np.exp((logits - logits.max()) / temperature)
    p /= p.sum()
    order = np.argsort(-p, kind="stable")
    cum = np.cumsum(p[order])
    k = int(np.searchsorted(cum, top_p)) + 1
    return set(order[:k].tolist())


def test_sampled_generate_stays_in_the_jax_nucleus(shared):
    """Temperature 0.7 / top-p 0.6 first tokens of 64 rows of one prompt,
    from both packages: every draw lies in the nucleus of the JAX
    package's logits, both packages draw more than one token of it, and a
    different generator seed gives different draws."""
    j_params, t_params = shared
    prompt = [256, 84, 104, 101, 32]
    B, temp, top_p = 64, 0.7, 0.6
    cache = j_llama.KVCache.create(J_TINY, 1, 8, dtype=jnp.float32)
    pos = jnp.arange(5)[None]
    j_logits, _ = j_llama.forward(j_params, J_TINY, jnp.asarray([prompt]),
                                  pos, cache, pos, jnp.asarray([5]))
    nucleus = _nucleus(np.asarray(j_logits)[0, -1], temp, top_p)
    assert 1 < len(nucleus) < 20
    ids = np.tile(np.asarray(prompt, np.int32), (B, 1))
    lens = np.full((B,), 5, np.int32)
    j_res = j_generate(j_params, J_TINY, jnp.asarray(ids), jnp.asarray(lens),
                       jax.random.PRNGKey(1), jnp.full((B,), temp),
                       jnp.full((B,), top_p), 1, 16)
    draws = {}
    for seed in (1, 2):
        gen = torch.Generator().manual_seed(seed)
        t_res = generate(t_params, TINY, torch.as_tensor(ids),
                         torch.as_tensor(lens), gen, torch.full((B,), temp),
                         torch.full((B,), top_p), 1, 16)
        draws[seed] = t_res.tokens[:, 0].tolist()
    j_draws = set(np.asarray(j_res.tokens)[:, 0].tolist())
    assert j_draws <= nucleus and len(j_draws) > 1
    for seed, d in draws.items():
        assert set(d) <= nucleus and len(set(d)) > 1, seed
    assert draws[1] != draws[2]
