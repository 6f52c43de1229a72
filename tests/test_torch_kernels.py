"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper in ``ops/kernels`` runs its plain PyTorch version;
here those are held against the Pallas kernels run with
``interpret=True`` (as tests/test_pallas_paged_attention.py runs them), on
the same numpy inputs, in float32: paged decode, chunked paged prefill,
the ragged mixed batch, RMSNorm and RoPE. Tolerance 2e-5 (absolute and
relative), the Pallas tests' own: both sides accumulate in f32 in another
order. The ragged kernel's padding outputs are garbage on the JAX side;
the port's contract makes them zeros, and the tests check that.

The kernels themselves run only on a card: ``tests/test_torch_gpu.py``
holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.ops.pallas.fused import (
    apply_rope_pallas,
    rms_norm_pallas,
)
from distributed_inference_server_tpu.ops.pallas.paged_attention import (
    paged_attention_decode,
    paged_attention_prefill,
    paged_attention_ragged,
)
from distributed_inference_server_tpu.ops.rotary import rope_frequencies
from distributed_inference_server_tpu_torch.ops import kernels
from distributed_inference_server_tpu_torch.ops.kernels import fused
from distributed_inference_server_tpu_torch.ops.kernels import (
    paged_attention as pa,
)

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, B, H, KV, D, page_size, P, num_pages, T=None):
    rng = np.random.default_rng(seed)
    slots = num_pages * page_size
    pool_k = rng.standard_normal((slots, KV, D)).astype(np.float32)
    pool_v = rng.standard_normal((slots, KV, D)).astype(np.float32)
    shape = (B, H, D) if T is None else (B, T, H, D)
    q = rng.standard_normal(shape).astype(np.float32)
    tables = rng.permutation(num_pages)[: B * P].reshape(B, P)
    return rng, q, pool_k, pool_v, tables.astype(np.int32)


DECODE_CASES = [
    # B, H, KV, D, page_size, P, window, softcap
    (4, 8, 4, 16, 8, 4, 0, 0.0),  # GQA, ragged
    (2, 4, 4, 32, 8, 3, 0, 0.0),  # MHA
    (3, 16, 2, 64, 16, 2, 0, 0.0),  # heavy grouping, 1B head_dim
    (4, 8, 2, 16, 4, 6, 5, 0.0),  # sliding window
    (3, 8, 4, 16, 8, 4, 0, 30.0),  # softcap
    (3, 8, 4, 16, 8, 4, 7, 20.0),  # both
]


@pytest.mark.parametrize("B,H,KV,D,ps,P,window,softcap", DECODE_CASES)
def test_paged_decode_matches_pallas(B, H, KV, D, ps, P, window, softcap):
    rng, q, pk, pv, tables = _case(B * 31 + D, B, H, KV, D, ps, P,
                                   num_pages=32)
    valid = rng.integers(1, P * ps + 1, size=B).astype(np.int32)
    valid[0] = 0  # an empty row gives zeros
    want = np.asarray(paged_attention_decode(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(valid), page_size=ps,
        pages_per_block=2, interpret=True, sliding_window=window,
        attn_softcap=softcap))
    got = pa.paged_decode(_t(q), _t(pk), _t(pv), _t(tables), _t(valid),
                          page_size=ps, sliding_window=window,
                          attn_softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert not got[0].any()


PREFILL_CASES = [
    # B, T, H, KV, D, page_size, P, window, softcap
    (3, 8, 8, 4, 16, 4, 8, 0, 0.0),
    (2, 16, 4, 2, 32, 8, 4, 0, 0.0),
    (2, 8, 16, 2, 64, 8, 4, 0, 0.0),
    (3, 8, 8, 2, 16, 4, 8, 5, 0.0),  # window
    (2, 8, 8, 4, 16, 4, 8, 0, 25.0),  # softcap
]


@pytest.mark.parametrize("B,T,H,KV,D,ps,P,window,softcap", PREFILL_CASES)
def test_paged_prefill_matches_pallas(B, T, H, KV, D, ps, P, window,
                                      softcap):
    rng, q, pk, pv, tables = _case(B * 17 + T + D, B, H, KV, D, ps, P,
                                   num_pages=32, T=T)
    cap = P * ps
    q_start = rng.integers(1, cap - T, size=B).astype(np.int32)  # > 0
    chunk = rng.integers(1, T + 1, size=B)
    valid = (q_start + chunk).astype(np.int32)  # padded queries past it
    q_start[-1], valid[-1] = 0, 0  # a padding row: everything masked
    want = np.asarray(paged_attention_prefill(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(q_start), jnp.asarray(valid),
        page_size=ps, q_block=8, pages_per_block=2, interpret=True,
        sliding_window=window, attn_softcap=softcap))
    got = pa.paged_prefill(_t(q), _t(pk), _t(pv), _t(tables), _t(q_start),
                           _t(valid), page_size=ps, sliding_window=window,
                           attn_softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert not got[-1].any()


RAGGED_PAGE = 8


def _ragged_case(seed, S, Bm, H, KV, D, P, q_lens, history=None, layout=None,
                 num_pages=64):
    """Random pool + packed ragged batch (as the JAX ragged tests make it):
    row b contributes q_lens[b] tokens on top of ``history[b]`` resident
    ones. ``layout`` (a per-token row list, -1 = padding) overrides the
    back-to-back packing."""
    rng = np.random.default_rng(seed)
    ps = RAGGED_PAGE
    pool_k = rng.standard_normal((num_pages * ps, KV, D)).astype(np.float32)
    pool_v = rng.standard_normal((num_pages * ps, KV, D)).astype(np.float32)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    tables = rng.permutation(num_pages)[: Bm * P].reshape(Bm, P)
    if history is None:
        history = [int(rng.integers(0, P * ps - ql + 1)) if ql else 0
                   for ql in q_lens]
    if layout is None:
        layout = [b for b, ql in enumerate(q_lens) for _ in range(ql)]
    layout = list(layout) + [-1] * (S - len(layout))
    tok_row = np.asarray(layout, np.int32)
    q_pos = np.zeros((S,), np.int32)
    seen = [0] * Bm
    for i, b in enumerate(layout):
        if b >= 0:
            q_pos[i] = history[b] + seen[b]
            seen[b] += 1
    valid = np.array([h + n for h, n in zip(history, seen)], np.int32)
    return q, pool_k, pool_v, tables.astype(np.int32), tok_row, q_pos, valid


def _ragged_pair(q, pk, pv, tables, tok_row, q_pos, valid, **kw):
    want = np.asarray(paged_attention_ragged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(tok_row), jnp.asarray(q_pos),
        jnp.asarray(valid), page_size=RAGGED_PAGE, q_block=8,
        pages_per_block=2, interpret=True, **kw))
    got = pa.paged_ragged(_t(q), _t(pk), _t(pv), _t(tables), _t(tok_row),
                          _t(q_pos), _t(valid), page_size=RAGGED_PAGE,
                          **kw).numpy()
    return got, want


def _assert_ragged(got, want, tok_row):
    real = tok_row >= 0  # JAX's padding outputs are garbage by contract
    np.testing.assert_allclose(got[real], want[real], atol=TOL, rtol=TOL)
    assert not got[~real].any()  # the port's are zeros


@pytest.mark.parametrize("S,Bm,H,KV,D,P,q_lens", [
    (16, 4, 8, 4, 16, 4, [1, 1, 1, 13]),  # decode rows + one chunk
    (16, 6, 4, 2, 32, 3, [1, 1, 1, 1, 1, 1]),  # all decode, padding tail
    (32, 3, 8, 4, 16, 4, [9, 17, 2]),  # chunks only, crossing windows
    (8, 2, 16, 2, 64, 2, [8, 0]),  # one row exactly fills the window
    (24, 5, 8, 8, 16, 3, [3, 1, 8, 1, 5]),  # KV = 8, mid-size chunks
    (12, 3, 8, 4, 16, 4, [1, 1, 7]),  # S = 12: no multiple of 8 or 16
    (20, 4, 8, 2, 16, 4, [1, 6, 0, 9]),  # S = 20, a zero-token row
])
def test_paged_ragged_matches_pallas(S, Bm, H, KV, D, P, q_lens):
    case = _ragged_case(S * 31 + Bm, S, Bm, H, KV, D, P, q_lens)
    got, want = _ragged_pair(*case)
    _assert_ragged(got, want, case[4])


@pytest.mark.parametrize("seed", range(6))
def test_paged_ragged_fuzzed_mixes(seed):
    """Random q_len mixes (decode-heavy, chunk-heavy, partial budgets)."""
    rng = np.random.default_rng(100 + seed)
    S, P = 24, 4
    q_lens, left = [], S
    while left > 0 and len(q_lens) < 8:
        ql = 1 if rng.random() < 0.5 else int(rng.integers(1, min(left, 9)
                                                           + 1))
        q_lens.append(min(ql, left))
        left -= q_lens[-1]
    case = _ragged_case(seed, S, len(q_lens), 8, 4, 16, P, q_lens)
    got, want = _ragged_pair(*case)
    _assert_ragged(got, want, case[4])


@pytest.mark.parametrize("hist", [[RAGGED_PAGE, 2 * RAGGED_PAGE],
                                  [RAGGED_PAGE - 1, 2 * RAGGED_PAGE + 1]])
def test_paged_ragged_page_boundary_history(hist):
    """Chunks starting at page boundaries and one token short of them."""
    case = _ragged_case(7, 16, 2, 8, 4, 16, 4, [6, 10], history=hist)
    got, want = _ragged_pair(*case)
    _assert_ragged(got, want, case[4])


def test_paged_ragged_window_and_softcap():
    case = _ragged_case(11, 16, 3, 8, 4, 16, 4, [1, 10, 4])
    got, want = _ragged_pair(*case, sliding_window=7, attn_softcap=30.0)
    _assert_ragged(got, want, case[4])


def test_paged_ragged_all_padding_gives_zeros():
    case = _ragged_case(17, 8, 2, 8, 4, 16, 2, [0, 0])
    got, want = _ragged_pair(*case)
    assert got.shape == want.shape == case[0].shape
    assert not got.any()


def test_paged_ragged_one_window():
    """num_win == 1 with more rows than segments: the JAX kernel's
    work-list padding case (its keys are padded before the sort)."""
    case = _ragged_case(23, 8, 5, 8, 4, 16, 3, [1, 2, 0, 3, 0])
    got, want = _ragged_pair(*case)
    _assert_ragged(got, want, case[4])


def test_paged_ragged_padding_between_decode_rows():
    """The engine's layout: inactive decode slots are -1 between active
    ones, prefill chunks follow, an empty prefill row adds no tokens."""
    layout = [-1, 1, -1, 3] + [4] * 9 + [6] * 3
    case = _ragged_case(29, 20, 7, 8, 4, 16, 4, [1, 1, 1, 1, 9, 0, 3],
                        layout=layout)
    got, want = _ragged_pair(*case)
    _assert_ragged(got, want, case[4])


def test_paged_ragged_all_decode_equals_paged_decode():
    """An all-decode packed batch is the decode kernel's contract."""
    q, pk, pv, tables, tok_row, q_pos, valid = _ragged_case(
        19, 8, 8, 8, 4, 16, 3, [1] * 8)
    got, want = _ragged_pair(q, pk, pv, tables, tok_row, q_pos, valid)
    _assert_ragged(got, want, tok_row)
    dec = pa.paged_decode(_t(q), _t(pk), _t(pv), _t(tables), _t(valid),
                          page_size=RAGGED_PAGE).numpy()
    np.testing.assert_allclose(got, dec, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", [(8, 128), (2, 3, 256), (5, 2048)])
def test_rms_norm_matches_pallas(shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = np.asarray(rms_norm_pallas(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                      interpret=True))
    got = fused.rms_norm(_t(x), _t(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", [(2, 8, 4, 16), (1, 4, 32, 64),
                                   (3, 2, 8, 128)])
def test_rope_matches_pallas(shape):
    rng = np.random.default_rng(shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 4096, size=shape[:2]).astype(np.int32)
    inv = np.asarray(rope_frequencies(shape[-1], 500000.0))
    want = np.asarray(apply_rope_pallas(jnp.asarray(x), jnp.asarray(pos),
                                        jnp.asarray(inv), interpret=True))
    got = fused.apply_rope(_t(x), _t(pos), _t(inv)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_cpu_calls_do_not_count_as_launches():
    kernels.reset_launch_counts()
    x = torch.ones(2, 8)
    fused.rms_norm(x, torch.ones(8), 1e-5)
    pa.paged_ragged(torch.ones(1, 2, 8), torch.ones(4, 1, 8),
                    torch.ones(4, 1, 8), torch.zeros(1, 1, dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int32),
                    torch.ones(1, dtype=torch.int32), page_size=4)
    assert kernels.launch_counts() == {
        "paged_decode": 0, "paged_decode_int8": 0, "paged_prefill": 0,
        "paged_ragged": 0, "rms_norm": 0, "rope": 0, "quant_matmul_q8": 0,
        "quant_matmul_q4": 0}


def test_other_devices_raise():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused.rms_norm(x, torch.empty(8, device="meta"), 1e-5)
