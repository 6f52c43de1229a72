"""The port's paged forward pass against the JAX package's.

JAX ``init_params`` -> numpy -> ``params_from_numpy`` gives both packages
the same weights (TINY, float32). A batched prefill chunk (with bucket
padding and a padded row) and then a decode step run through both
``paged_forward``s on the same pools; the logits must agree within
atol 1e-4 (f32 on both sides, other summation orders over 2 layers) and
the pools must hold the same K/V. The same holds for one packed mixed
step through both ``ragged_paged_forward``s, and for quantized weights
(int8, int4) and int8 ``QuantPool`` pools. The JAX side runs its
reference ``attention_impl="xla"``; the port runs both of its paths
("kernel", whose wrappers take their plain versions for CPU tensors, and
"plain").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu.ops import quant as jq
from distributed_inference_server_tpu_torch.models import llama as t_llama
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.ops import quant as tq

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


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("window", [0, 5])
def test_ragged_paged_forward_matches_jax(shared_params, impl, window):
    """One mixed step on random resident K/V: decode slots 0-3 (slot 0
    inactive, -1 in tok_row), prefill chunks of 7 and 4 tokens, an empty
    prefill row and a padding tail; logits at the decode slots and the
    chunk-final tokens, and the written pools, must match."""
    j_cfg, t_cfg = _configs(window)
    jp, tp = shared_params
    rng = np.random.default_rng(10 + window)
    L, KV, D = J_TINY.num_layers, J_TINY.num_kv_heads, J_TINY.head_dim
    pool_k = rng.standard_normal((L, NUM_PAGES * PS, KV, D)).astype(
        np.float32)
    pool_v = rng.standard_normal(pool_k.shape).astype(np.float32)
    Bm = 7
    # 3 distinct pages per row (the pool holds 24), repeated to P columns
    tables = rng.permutation(NUM_PAGES)[: Bm * 3].reshape(Bm, 3)
    tables = np.concatenate([tables] * 3, axis=1)[:, :P].astype(np.int32)
    history = np.array([0, 3, 9, 10, 0, 5, 0], np.int32)
    layout = [-1, 1, 2, 3] + [4] * 7 + [5] * 4 + [-1] * 3  # row 6 empty
    S = len(layout)
    tok_row = np.asarray(layout, np.int32)
    pos = np.zeros((S,), np.int32)
    counts = np.zeros((Bm,), np.int32)
    write = np.full((S,), NUM_PAGES * PS, np.int32)
    for i, r in enumerate(layout):
        if r >= 0:
            pos[i] = history[r] + counts[r]
            counts[r] += 1
            write[i] = tables[r, pos[i] // PS] * PS + pos[i] % PS
    valid = (history + counts).astype(np.int32)
    ids = rng.integers(0, 256, size=(1, S)).astype(np.int32)
    logits_idx = np.array([0, 1, 2, 3, 10, 14, 0], np.int32)
    j_logits, j_pk, j_pv = j_llama.ragged_paged_forward(
        jp, j_cfg, jnp.asarray(ids), jnp.asarray(pos[None]),
        jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(write[None]),
        jnp.asarray(tok_row), jnp.asarray(_gather(tables)),
        jnp.asarray(valid), attention_impl="xla", page_size=PS,
        logits_idx=jnp.asarray(logits_idx))
    drop = np.zeros((L, 1, KV, D), np.float32)
    t_pk = torch.from_numpy(np.concatenate([pool_k, drop], axis=1))
    t_pv = torch.from_numpy(np.concatenate([pool_v, drop], axis=1))
    t_logits, _, _ = t_llama.ragged_paged_forward(
        tp, t_cfg, torch.from_numpy(ids), torch.from_numpy(pos[None]), t_pk,
        t_pv, torch.from_numpy(write[None]), torch.from_numpy(tok_row),
        torch.from_numpy(tables), torch.from_numpy(valid),
        torch.from_numpy(logits_idx), impl=impl, page_size=PS)
    assert t_logits.dtype == torch.float32
    assert t_logits.shape == (len(logits_idx), J_TINY.vocab_size)
    real = [1, 2, 3, 4, 5]  # slot 0 is inactive, index 6 an empty row
    np.testing.assert_allclose(t_logits.numpy()[real],
                               np.asarray(j_logits)[real], atol=ATOL)
    np.testing.assert_allclose(t_pk[:, :-1].numpy(), np.asarray(j_pk),
                               atol=ATOL)
    np.testing.assert_allclose(t_pv[:, :-1].numpy(), np.asarray(j_pv),
                               atol=ATOL)


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


# ---------------------------------------------------------------------------
# quantized weights and int8 pools
# ---------------------------------------------------------------------------


def _pools(quant, L, KV, D, drop):
    """(JAX pools, port pools) of NUM_PAGES * PS slots (+1 drop slot on
    the port's side), dense f32 or int8 QuantPool pairs."""
    n = NUM_PAGES * PS
    if quant == "int8":
        j = [jq.QuantPool(jnp.zeros((L, n, KV, D), jnp.int8),
                          jnp.zeros((L, n, KV), jnp.float32))
             for _ in range(2)]
        t = [tq.QuantPool(torch.zeros(L, n + drop, KV, D, dtype=torch.int8),
                          torch.zeros(L, n + drop, KV)) for _ in range(2)]
        return j, t
    return ([jnp.zeros((L, n, KV, D), jnp.float32) for _ in range(2)],
            [torch.zeros(L, n + drop, KV, D) for _ in range(2)])


def _assert_pools_equal(t_pool, j_pool):
    """int8 pools: codes identical, scales within 1e-6 relative (both are
    absmax/127 of K/V that agree to f32 rounding); dense: within ATOL."""
    if isinstance(t_pool, tq.QuantPool):
        np.testing.assert_array_equal(t_pool.data[:, :-1].numpy(),
                                      np.asarray(j_pool.data))
        np.testing.assert_allclose(t_pool.scale[:, :-1].numpy(),
                                   np.asarray(j_pool.scale), rtol=1e-6,
                                   atol=0)
    else:
        np.testing.assert_allclose(t_pool[:, :-1].numpy(),
                                   np.asarray(j_pool), atol=ATOL)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("weights,kv", [("int8", "int8"), ("int4", "none"),
                                        ("int8", "none"), ("none", "int8")])
def test_quantized_paged_forward_matches_jax(shared_params, impl, weights, kv):
    """Quantized weights (group 32) and/or int8 pools: a batched prefill
    chunk, then a decode step (the int8 decode kernel's path on the port's
    kernel side), through both packages. Logits within ATOL, pools as
    ``_assert_pools_equal`` says."""
    jp = jq.quantize_params(shared_params[0], weights, 32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(21)
    tables = rng.permutation(NUM_PAGES)[: 3 * P].reshape(3, P).astype(
        np.int32)
    L, KV, D = J_TINY.num_layers, J_TINY.num_kv_heads, J_TINY.head_dim
    (j_pk, j_pv), (t_pk, t_pv) = _pools(kv, L, KV, D, drop=1)
    T = 8
    starts = np.array([0, 3, 0], np.int32)
    lens = np.array([8, 5, 0], np.int32)
    ids = rng.integers(0, 256, size=(3, T)).astype(np.int32)
    positions = (starts[:, None] + np.arange(T)).astype(np.int32)
    ws = _slots(tables, positions, lens)
    valid = (starts + lens).astype(np.int32)
    steps = [(ids, positions, ws, valid)]
    tok = rng.integers(0, 256, size=(3, 1)).astype(np.int32)
    pos = valid[:, None].astype(np.int32)
    steps.append((tok, pos, _slots(tables, pos, np.array([1, 1, 0])),
                  np.array([valid[0] + 1, valid[1] + 1, 0], np.int32)))
    for ids_, pos_, ws_, valid_ in steps:
        j_logits, j_pk, j_pv = j_llama.paged_forward(
            jp, J_TINY, jnp.asarray(ids_), jnp.asarray(pos_), j_pk, j_pv,
            jnp.asarray(ws_), jnp.asarray(_gather(tables)),
            jnp.asarray(valid_), attention_impl="xla", page_size=PS)
        t_logits, _, _ = t_llama.paged_forward(
            tp, TINY, torch.from_numpy(ids_), torch.from_numpy(pos_), t_pk,
            t_pv, torch.from_numpy(ws_), torch.from_numpy(tables),
            torch.from_numpy(valid_), impl=impl, page_size=PS)
        for b in (0, 1):  # row 2 is padding / inactive
            n = max(1, lens[b]) if ids_.shape[1] > 1 else 1
            np.testing.assert_allclose(t_logits.numpy()[b, :n],
                                       np.asarray(j_logits)[b, :n],
                                       atol=ATOL)
        _assert_pools_equal(t_pk, j_pk)
        _assert_pools_equal(t_pv, j_pv)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("weights", ["none", "int8"])
def test_ragged_forward_over_int8_pools_matches_jax(shared_params, impl,
                                                    weights):
    """One mixed step over int8 ``QuantPool`` pools holding random
    resident codes and scales (the same in both packages): decode slots
    (one inactive), two prefill chunks and padding. Both packages gather,
    dequantize and run ``ragged_gqa_attention`` (neither has an int8
    ragged kernel); logits within ATOL, the quantizing writes as
    ``_assert_pools_equal`` says."""
    jp = jq.quantize_params(shared_params[0], weights, 32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(31)
    L, KV, D = J_TINY.num_layers, J_TINY.num_kv_heads, J_TINY.head_dim
    n = NUM_PAGES * PS
    codes = [rng.integers(-127, 128, size=(L, n, KV, D)).astype(np.int8)
             for _ in range(2)]
    scales = [rng.uniform(0.001, 0.02, size=(L, n, KV)).astype(np.float32)
              for _ in range(2)]
    j_pk, j_pv = (jq.QuantPool(jnp.asarray(c), jnp.asarray(sc))
                  for c, sc in zip(codes, scales))
    t_pk, t_pv = (tq.QuantPool(
        torch.from_numpy(np.concatenate(
            [c, np.zeros((L, 1, KV, D), np.int8)], axis=1)),
        torch.from_numpy(np.concatenate(
            [sc, np.zeros((L, 1, KV), np.float32)], axis=1)))
        for c, sc in zip(codes, scales))
    Bm = 6
    tables = rng.permutation(NUM_PAGES)[: Bm * 3].reshape(Bm, 3)
    tables = np.concatenate([tables] * 3, axis=1)[:, :P].astype(np.int32)
    history = np.array([0, 6, 9, 0, 5, 0], np.int32)
    layout = [-1, 1, 2] + [3] * 6 + [4] * 3 + [-1] * 2  # row 5 empty
    S = len(layout)
    tok_row = np.asarray(layout, np.int32)
    pos = np.zeros((S,), np.int32)
    counts = np.zeros((Bm,), np.int32)
    write = np.full((S,), n, np.int32)
    for i, r in enumerate(layout):
        if r >= 0:
            pos[i] = history[r] + counts[r]
            counts[r] += 1
            write[i] = tables[r, pos[i] // PS] * PS + pos[i] % PS
    valid = (history + counts).astype(np.int32)
    ids = rng.integers(0, 256, size=(1, S)).astype(np.int32)
    logits_idx = np.array([0, 1, 2, 8, 11, 0], np.int32)
    j_logits, j_pk, j_pv = j_llama.ragged_paged_forward(
        jp, J_TINY, jnp.asarray(ids), jnp.asarray(pos[None]), j_pk, j_pv,
        jnp.asarray(write[None]), jnp.asarray(tok_row),
        jnp.asarray(_gather(tables)), jnp.asarray(valid),
        attention_impl="xla", page_size=PS,
        logits_idx=jnp.asarray(logits_idx))
    t_logits, _, _ = t_llama.ragged_paged_forward(
        tp, TINY, torch.from_numpy(ids), torch.from_numpy(pos[None]), t_pk,
        t_pv, torch.from_numpy(write[None]), torch.from_numpy(tok_row),
        torch.from_numpy(tables), torch.from_numpy(valid),
        torch.from_numpy(logits_idx), impl=impl, page_size=PS)
    real = [1, 2, 3, 4]  # slot 0 is inactive, index 5 an empty row
    np.testing.assert_allclose(t_logits.numpy()[real],
                               np.asarray(j_logits)[real], atol=ATOL)
    _assert_pools_equal(t_pk, j_pk)
    _assert_pools_equal(t_pv, j_pv)


def test_quantized_write_drops_out_of_range_slots():
    pool = tq.QuantPool(torch.zeros(1, 9, 1, 2, dtype=torch.int8),
                        torch.zeros(1, 9, 1))
    new = torch.tensor([[[[1.0, -2.0]], [[5.0, 6.0]], [[0.0, 0.0]]]])
    write = t_llama.make_paged_write_fn(torch.tensor([[2, 8, 50]]), 8,
                                        kv_quantized=True)
    assert write(pool, 0, new) is pool
    assert pool.data[0, 2].tolist() == [[64, -127]]
    assert pool.scale[0, 2, 0] == torch.tensor(2.0) / 127.0
    assert pool.data[0, :8].sum() == 64 - 127  # only slot 2 of the readable
    assert pool.scale[0, :8].sum() == pool.scale[0, 2].sum()
