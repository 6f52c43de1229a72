"""The port's long-prompt path on ``seq`` meshes against the JAX
single-device engine: greedy tokens identical, in float32 on the CPU.

A prompt at least ``cp_min_tokens`` long prefills in one sequence-parallel
pass (``parallel/cp.py``: ring attention or Ulysses over the ``seq``
axis), its K/V written straight into its pages, and decodes from them;
the other prompts take the chunked prefill. The JAX engine (one device,
chunked prefill throughout) serves the same requests. Covered: seq 4
ring, seq 2 x tensor 2, seq 2 x stage 2, Ulysses, and the sliding
windows of Gemma-2 and Mistral under the sequence-parallel prefill;
``audit_pages() == []`` after each.
"""

from __future__ import annotations

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
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PagedCacheConfig,
)
from distributed_inference_server_tpu_torch.models import configs
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)
from distributed_inference_server_tpu_torch.parallel.mesh import (
    MeshSpec,
    make_mesh,
)

SCALE = 8.0
TOK = ByteTokenizer()
LONG = "a long prompt that takes the sequence-parallel prefill path, twice"
PROMPTS = ["hi!", LONG, "bucket of thirty two?"]
CP_MIN = 40
BASE = dict(max_batch=4, prefill_buckets=(8, 32), prefill_batch=2,
            prefill_token_budget=64, decode_block_size=4)
PAGED = (64, 4, 32)


def _drive(engine, sp_cls):
    for i, p in enumerate(PROMPTS):
        engine.add_request(f"r{i}", list(p.encode()),
                           sp_cls(temperature=0.0, max_tokens=8))
    out = {}
    for _ in range(500):
        if not engine.has_work():
            break
        for o in engine.step():
            assert o.error is None, o.error
            if o.token_id is not None:
                out.setdefault(o.request_id, []).append(o.token_id)
    assert not engine.has_work()
    return out


def _reference(name):
    jcfg = j_configs.get_config(name)
    tree = jax.tree_util.tree_map(np.asarray, j_llama.init_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32))
    tree["embed"] = tree["embed"] * SCALE
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * SCALE
    je = JEngine(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                 JByteTokenizer(), JEngineConfig(
                     paged=JPagedCacheConfig(*PAGED), attention_impl="xla",
                     native_allocator=False, **BASE), dtype=jnp.float32)
    return (params_from_numpy(tree, device="cpu", dtype=torch.float32),
            configs.get_config(name), _drive(je, JSamplingParams))


def _port_tokens(ref, axes, **kw):
    params, cfg, want = ref
    mesh = make_mesh(MeshSpec(**axes), devices=[torch.device("cpu")] * 8)
    e = LLMEngine(params, cfg, TOK, EngineConfig(
        paged=PagedCacheConfig(*PAGED), cp_min_tokens=CP_MIN, **BASE, **kw),
        dtype=torch.float32, device="cpu", mesh=mesh)
    got = _drive(e, SamplingParams)
    assert e.audit_pages() == []
    # the long prompt took the sequence-parallel pass: one prefill
    # dispatch of all its tokens
    return got, want


@pytest.fixture(scope="module")
def tiny():
    assert len(LONG) >= CP_MIN > max(len(p) for p in PROMPTS if p != LONG)
    return _reference("tiny")


@pytest.mark.parametrize("axes,kw", [
    (dict(seq=4), {}),
    (dict(seq=2, tensor=2), {}),
    (dict(seq=2, stage=2), {}),
    (dict(seq=2), dict(sp_impl="ulysses")),
], ids=["seq4-ring", "seq2xtp2", "seq2xpp2", "seq2-ulysses"])
def test_tiny_sequence_parallel_matches_jax(tiny, axes, kw):
    got, want = _port_tokens(tiny, axes, **kw)
    assert got == want


@pytest.mark.parametrize("name,axes", [("tiny-gemma2", dict(seq=2)),
                                       ("tiny-swa", dict(seq=2, tensor=2))])
def test_windows_under_sequence_parallel_match_jax(name, axes):
    """Gemma-2's alternating local / global layers and Mistral's window
    (8 tokens: the long prompt spans many windows) under the ring."""
    got, want = _port_tokens(_reference(name), axes)
    assert got == want


def test_cp_path_is_taken(tiny, monkeypatch):
    """The long prompt prefills through ``cp_paged_prefill_any`` once; the
    short ones take the chunked path."""
    from distributed_inference_server_tpu_torch.parallel import cp

    calls = []
    real = cp.cp_paged_prefill_any
    monkeypatch.setattr(cp, "cp_paged_prefill_any",
                        lambda *a, **k: calls.append(a[3].shape) or real(
                            *a, **k))
    got, want = _port_tokens(tiny, dict(seq=2))
    assert got == want
    assert calls == [torch.Size([1, 128])]
