"""The port's paged forward pass against the JAX package's.

JAX ``init_params`` -> numpy -> ``params_from_numpy`` gives both packages
the same weights (TINY, float32). A batched prefill chunk (with bucket
padding and a padded row) and then a decode step run through both
``paged_forward``s on the same pools; the logits must agree within
atol 1e-4 (f32 on both sides, other summation orders over 2 layers) and
the pools must hold the same K/V. The JAX side runs its reference
``attention_impl="xla"``; the port runs both of its paths ("kernel", whose
wrappers take their plain versions for CPU tensors, and "plain").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu_torch.models import llama as t_llama
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)

ATOL = 1e-4
PS, P, NUM_PAGES = 4, 8, 24


def _configs(window):
    if not window:
        return J_TINY, TINY
    return (J_TINY.with_overrides(sliding_window=window),
            TINY.with_overrides(sliding_window=window))


@pytest.fixture(scope="module")
def shared_params():
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(tree, device="cpu", dtype=torch.float32)


def _slots(tables, positions, valid_lens):
    """Flat write slots ([B, T]; num_slots drops) for contiguous chunks."""
    B, T = positions.shape
    out = np.full((B, T), NUM_PAGES * PS, np.int32)
    for b in range(B):
        for t in range(valid_lens[b]):
            p = positions[b, t]
            out[b, t] = tables[b, p // PS] * PS + p % PS
    return out


def _gather(tables):
    offs = np.arange(PS)
    return (tables[:, :, None] * PS + offs).reshape(tables.shape[0], -1)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("window", [0, 5])
def test_paged_forward_matches_jax(shared_params, impl, window):
    j_cfg, t_cfg = _configs(window)
    jp, tp = shared_params
    rng = np.random.default_rng(window)
    tables = rng.permutation(NUM_PAGES)[: 3 * P].reshape(3, P)
    tables = tables.astype(np.int32)
    L, KV, D = J_TINY.num_layers, J_TINY.num_kv_heads, J_TINY.head_dim
    j_pk = jnp.zeros((L, NUM_PAGES * PS, KV, D), jnp.float32)
    j_pv = jnp.zeros_like(j_pk)
    t_pk = torch.zeros(L, NUM_PAGES * PS + 1, KV, D)
    t_pv = torch.zeros_like(t_pk)

    # batched prefill chunk: rows of 8, 5 and 0 (padding) tokens; row 1
    # starts past an earlier chunk
    T = 8
    starts = np.array([0, 3, 0], np.int32)
    lens = np.array([8, 5, 0], np.int32)
    ids = rng.integers(0, 256, size=(3, T)).astype(np.int32)
    positions = (starts[:, None] + np.arange(T)).astype(np.int32)
    ws = _slots(tables, positions, lens)
    valid = (starts + lens).astype(np.int32)
    last = np.maximum(lens - 1, 0).astype(np.int32)
    for full in (True, False):
        j_logits, j_pk2, j_pv2 = j_llama.paged_forward(
            jp, j_cfg, jnp.asarray(ids), jnp.asarray(positions), j_pk, j_pv,
            jnp.asarray(ws), jnp.asarray(_gather(tables)),
            jnp.asarray(valid), attention_impl="xla", page_size=PS,
            logits_idx=None if full else jnp.asarray(last))
        t_pk2, t_pv2 = t_pk.clone(), t_pv.clone()
        t_logits, _, _ = t_llama.paged_forward(
            tp, t_cfg, torch.from_numpy(ids), torch.from_numpy(positions),
            t_pk2, t_pv2, torch.from_numpy(ws), torch.from_numpy(tables),
            torch.from_numpy(valid), impl=impl, page_size=PS,
            logits_idx=None if full else torch.from_numpy(last))
        assert t_logits.dtype == torch.float32
        jl, tl = np.asarray(j_logits), t_logits.numpy()
        assert tl.shape == jl.shape
        real = [0, 1]  # row 2 is padding
        if full:
            for b in real:
                np.testing.assert_allclose(tl[b, : lens[b]],
                                           jl[b, : lens[b]], atol=ATOL)
        else:
            np.testing.assert_allclose(tl[real], jl[real], atol=ATOL)
    np.testing.assert_allclose(t_pk2[:, :-1].numpy(), np.asarray(j_pk2),
                               atol=ATOL)
    np.testing.assert_allclose(t_pv2[:, :-1].numpy(), np.asarray(j_pv2),
                               atol=ATOL)

    # one decode step on top: rows 0 and 1 active, row 2 inactive
    tok = rng.integers(0, 256, size=(3, 1)).astype(np.int32)
    pos = valid[:, None].astype(np.int32)
    ws1 = _slots(tables, pos, np.array([1, 1, 0]))
    valid1 = np.array([valid[0] + 1, valid[1] + 1, 0], np.int32)
    j_logits, _, _ = j_llama.paged_forward(
        jp, j_cfg, jnp.asarray(tok), jnp.asarray(pos), j_pk2, j_pv2,
        jnp.asarray(ws1), jnp.asarray(_gather(tables)), jnp.asarray(valid1),
        attention_impl="xla", page_size=PS)
    t_logits, _, _ = t_llama.paged_forward(
        tp, t_cfg, torch.from_numpy(tok), torch.from_numpy(pos), t_pk2,
        t_pv2, torch.from_numpy(ws1), torch.from_numpy(tables),
        torch.from_numpy(valid1), impl=impl, page_size=PS)
    np.testing.assert_allclose(t_logits.numpy()[:2],
                               np.asarray(j_logits)[:2], atol=ATOL)


def test_gather_kv_window_matches_jax():
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((NUM_PAGES * PS, 2, 16)).astype(np.float32)
    tables = rng.integers(0, NUM_PAGES + 3, size=(2, P)).astype(np.int32)
    tables[0, -1] = NUM_PAGES  # an out-of-range sentinel clamps
    jk, _ = j_llama.gather_kv_window(
        jnp.asarray(pool), jnp.asarray(pool),
        jnp.asarray(_gather(tables)), PS)
    tk, _ = t_llama.gather_kv_window(torch.from_numpy(pool),
                                     torch.from_numpy(pool),
                                     torch.from_numpy(tables), PS)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_paged_write_drops_out_of_range_slots_in_place():
    pool = torch.zeros(1, 9, 1, 2)  # 8 slots + the drop slot
    new = torch.arange(6, dtype=torch.float32).reshape(1, 3, 1, 2) + 1
    write = t_llama.make_paged_write_fn(torch.tensor([[2, 8, 50]]), 8)
    out = write(pool, 0, new)
    assert out is pool
    assert pool[0, 2].tolist() == [[1.0, 2.0]]
    assert pool[0, :8].sum() == 3.0  # only slot 2 of the readable slots


def test_init_params_shapes_match_jax():
    gen = torch.Generator().manual_seed(0)
    tp = t_llama.init_params(TINY, gen, dtype=torch.float32, device="cpu")
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert node.dtype == torch.float32
    std = tp["layers"]["wq"].std().item()
    assert 0.015 < std < 0.025


def test_unsupported_families_raise():
    with pytest.raises(NotImplementedError, match="num_experts"):
        t_llama.check_supported(TINY.with_overrides(num_experts=4))
