"""The port's engine over device meshes against the JAX single-device
engine: greedy tokens identical, in float32 on the CPU.

One JAX engine per configuration (TINY, a 4-layer TINY with 8 KV heads,
the TINY MoE) serves every request once; the port's engines on tensor,
stage and expert meshes, and on their compositions, serve the same
requests. (The JAX package's own tests hold its sharded engines to its
single-device one, so the slow-to-compile JAX mesh engines are not built
here.) Covered: tensor 2 (quantum path, looped blocks, the mixed step,
int8 KV, speculation), tensor 4 and 8, stage 2 and 4, stage 2 x tensor 2
in 2 microbatches, speculation under stage, expert 2 (the capacity-based
dispatch at the dropless factor); ``audit_pages() == []`` after each.
int8 KV at tensor 2 is held to the port's unsharded int8 engine.
Weights: JAX ``init_params`` scaled by 8 (as ``test_torch_engine.py``),
converted with ``models/convert.py``.
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
from distributed_inference_server_tpu_torch.models import llama
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
from distributed_inference_server_tpu_torch.parallel.tp import ShardedPool

SCALE = 8.0
TOK = ByteTokenizer()
PROMPTS = ["hi!", "bucket of thirty two?", "x",
           "a prompt long enough to span two prefill chunks, then decode"]
# the JAX engine's settings; the port's engines add their mesh options
BASE = dict(max_batch=4, prefill_buckets=(8, 32), prefill_batch=2,
            prefill_token_budget=64, decode_block_size=4)
PAGED = (64, 4, 32)
KV8 = dict(name="tiny-kv8", num_heads=8, num_kv_heads=8, head_dim=8,
           num_layers=4)


def _trees(name, over=None, seed=0):
    jcfg = j_configs.get_config(name).with_overrides(**(over or {}))
    tree = jax.tree_util.tree_map(
        np.asarray, j_llama.init_params(jax.random.PRNGKey(seed), jcfg,
                                        jnp.float32))
    tree["embed"] = tree["embed"] * SCALE
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * SCALE
    return jcfg, tree


def _drive(engine, sp_cls, max_tokens=8):
    for i, p in enumerate(PROMPTS):
        engine.add_request(f"r{i}", list(p.encode()),
                           sp_cls(temperature=0.0, max_tokens=max_tokens))
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


def _reference(name, over=None, **kw):
    """(port params, port config, the JAX single-device engine's tokens)."""
    jcfg, tree = _trees(name, over)
    je = JEngine(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                 JByteTokenizer(), JEngineConfig(
                     paged=JPagedCacheConfig(*PAGED), attention_impl="xla",
                     native_allocator=False, **BASE, **kw),
                 dtype=jnp.float32)
    want = _drive(je, JSamplingParams)
    cfg = configs.get_config(name).with_overrides(**(over or {}))
    return params_from_numpy(tree, device="cpu", dtype=torch.float32), \
        cfg, want


def _port(params, cfg, axes, draft=None, **kw):
    mesh = make_mesh(MeshSpec(**axes), devices=[torch.device("cpu")] * 8)
    ecfg = EngineConfig(paged=PagedCacheConfig(*PAGED), **{**BASE, **kw})
    extra = {}
    if draft is not None:
        extra = dict(draft_params=draft[0], draft_cfg=draft[1])
    return LLMEngine(params, cfg, TOK, ecfg, dtype=torch.float32,
                     device="cpu", mesh=mesh, **extra)


@pytest.fixture(scope="module")
def tiny():
    return _reference("tiny")


@pytest.fixture(scope="module")
def tiny_kv8():
    return _reference("tiny", KV8)


@pytest.fixture(scope="module")
def draft():
    _, tree = _trees("tiny", seed=7)
    return params_from_numpy(tree, device="cpu", dtype=torch.float32), \
        configs.TINY


@pytest.mark.parametrize("axes,kw", [
    (dict(tensor=2), {}),
    (dict(tensor=2), dict(loop_to_completion=True)),
    (dict(tensor=2), dict(mixed_step_tokens=12)),
    (dict(stage=2), {}),
    (dict(stage=2, tensor=2), dict(pp_microbatches=2)),
], ids=["tp2", "tp2-loop", "tp2-mixed", "pp2", "pp2xtp2-mb2"])
def test_tiny_meshes_match_jax(tiny, axes, kw):
    params, cfg, want = tiny
    e = _port(params, cfg, axes, **kw)
    assert isinstance(e.state.k, ShardedPool)
    assert _drive(e, SamplingParams) == want
    assert e.audit_pages() == []


@pytest.mark.parametrize("axes", [dict(tensor=2), dict(stage=2)],
                         ids=["tp2", "pp2"])
def test_speculation_under_mesh_matches_jax(tiny, draft, axes):
    """Greedy speculative decoding emits the target's greedy tokens; the
    draft is sharded like the target."""
    params, cfg, want = tiny
    e = _port(params, cfg, axes, draft=draft)
    assert isinstance(e.draft_state.k, ShardedPool)
    assert _drive(e, SamplingParams) == want
    assert e.spec_stats()["totals"]["blocks"] > 0
    assert e.audit_pages() == []


def test_int8_kv_under_tensor_matches_unsharded(tiny):
    """int8 KV pools (codes and scales split on KV heads) at tensor 2, the
    quantum path and the mixed step, against the port's unsharded int8
    engine (which ``test_torch_engine.py`` holds to the JAX int8 engine)."""
    params, cfg, _ = tiny
    e0 = LLMEngine(params, cfg, TOK, EngineConfig(
        paged=PagedCacheConfig(*PAGED), kv_quant="int8", **BASE),
        dtype=torch.float32, device="cpu")
    want = _drive(e0, SamplingParams)
    for kw in ({}, dict(mixed_step_tokens=12)):
        e = _port(params, cfg, dict(tensor=2), kv_quant="int8", **kw)
        assert isinstance(e.state.k.data, ShardedPool)
        assert _drive(e, SamplingParams) == want, kw
        assert e.audit_pages() == []


@pytest.mark.parametrize("axes", [dict(tensor=4), dict(tensor=8),
                                  dict(stage=4)],
                         ids=["tp4", "tp8", "pp4"])
def test_kv8_meshes_match_jax(tiny_kv8, axes):
    params, cfg, want = tiny_kv8
    e = _port(params, cfg, axes)
    assert _drive(e, SamplingParams) == want
    assert e.audit_pages() == []


def test_expert_parallel_moe_matches_jax():
    """Expert 2 on the TINY MoE: the capacity-based dispatch at the
    engine's dropless factor gives the JAX dense-MoE engine's tokens."""
    params, cfg, want = _reference("tiny-moe")
    e = _port(params, cfg, dict(expert=2))
    assert e.params.moe_impl == "ep"
    assert e.cfg.moe_capacity_factor == cfg.num_experts / \
        cfg.num_experts_per_tok
    assert _drive(e, SamplingParams) == want
    assert e.audit_pages() == []


def test_mesh_refusals():
    """The JAX engine's refusals: the mixed step off tensor-only meshes,
    ``sp_impl``, Ulysses' divisibility, a tensor size not dividing the
    heads, stages not dividing the layers or microbatches the batch."""
    params = llama.init_params(configs.TINY, torch.Generator(),
                               dtype=torch.float32, device="cpu")
    cases = [
        (dict(stage=2), dict(mixed_step_tokens=12), "tensor-axis meshes"),
        (dict(seq=2), dict(sp_impl="zigzag"), "sp_impl"),
        (dict(seq=4), dict(sp_impl="ulysses"), "Ulysses seq axis 4"),
        (dict(tensor=4), {}, "does not divide num_kv_heads"),
        (dict(stage=4), {}, "stages do not divide"),
        (dict(stage=2), dict(pp_microbatches=3), "microbatches"),
        (dict(data=3), {}, "data axis 3"),
    ]
    for axes, kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            _port(params, configs.TINY, axes, **kw)
