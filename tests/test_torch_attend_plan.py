"""The prefill / ragged tensor-core body's split plan, and the plain
versions of ``paged_prefill`` / ``paged_ragged`` on long histories, on the
CPU.

The plan (``paged_attention.attend_plan``) is plain Python: how many
splits each query tile's KV range takes and how many tokens each split
spans, from the table capacity, the grid's static size and the blocks one
SM holds (never the data). For the served geometries (llama-3.2-1b: H 32,
KV 8, D 64; llama-3-8b: D 128; tables of 128 pages of 16 tokens), the
model families' (gemma2-9b H 16 / KV 8, qwen2-7b G 7, a mistral-7b table
past its window) and edge shapes, the splits must cover [0, capacity) in whole 64-token stages, no
split empty, a split must span few enough pages for the block's page-id
list, a ragged split at most ``RAGGED_MAX_STAGES`` stages. A model of the
kernel's split rule (split z walks [z * chunk, (z + 1) * chunk) of the
tile's keys [lo, hi)) then checks, on the served layouts, that every key a
tile needs is walked by exactly one split and that the ragged launch's
longest split is a few stages.

The plain versions are held against the JAX package's Pallas kernels
(interpret mode, as tests/test_torch_kernels.py runs them) on the same
numpy inputs in float32, at small H and D, with histories of several
hundred tokens: the layouts whose KV ranges the kernel splits (G 7 with a
window and softcap 50 among them). Tolerance
2e-5, the Pallas tests' own.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.ops.pallas.paged_attention import (
    paged_attention_prefill,
    paged_attention_ragged,
)
from distributed_inference_server_tpu_torch.ops.kernels import (
    paged_attention as pa,
)

H100_SMS = 132
STAGE = 64  # tokens per ring stage (csrc kAttTK)
MAX_PAGES = 256  # page ids a block holds (csrc kAttMaxPages)
ROWS = 128  # (query, head) rows per block (csrc kAttRows)
TOL = 2e-5

# (label, H, KV, T (queries per row, or the packed length), B, page_size, P)
SHAPES = [
    ("1B prefill [4, 512]", 32, 8, 512, 4, 16, 128),
    ("1B prefill [1, 64]", 32, 8, 64, 1, 16, 128),
    ("1B ragged S512 Bm12", 32, 8, 512, 12, 16, 128),
    ("1B ragged S8 Bm8", 32, 8, 8, 8, 16, 128),
    ("8B prefill [4, 512]", 32, 8, 512, 4, 16, 128),
    ("G=1", 8, 8, 512, 4, 16, 128),
    ("G=8", 64, 8, 100, 2, 16, 128),
    ("G=64", 64, 1, 7, 1, 16, 128),
    ("below one stage", 32, 8, 16, 2, 16, 1),
    ("page 5", 16, 2, 40, 3, 5, 40),
    ("page 1, long", 32, 8, 64, 2, 1, 4096),
    ("capacity 32768", 32, 8, 128, 1, 16, 2048),
    ("gemma2-9b prefill [4, 512]", 16, 8, 512, 4, 16, 128),
    ("gemma2-9b ragged S512 Bm12", 16, 8, 512, 12, 16, 128),
    ("qwen2-7b prefill [4, 512] (G 7)", 28, 4, 512, 4, 16, 128),
    ("qwen2-7b ragged S512 Bm12 (G 7)", 28, 4, 512, 12, 16, 128),
    ("mistral-7b past the window", 32, 8, 512, 4, 16, 320),
]
PER_SM = (1, 2, 3)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("per_sm", PER_SM)
@pytest.mark.parametrize("label,H,KV,T,B,page_size,P", SHAPES)
def test_splits_cover_the_table_in_whole_stages(label, H, KV, T, B, page_size,
                                                P, per_sm, ragged):
    cap = P * page_size
    splits, chunk = pa.attend_plan(H, KV, T, B, cap, page_size, H100_SMS,
                                   per_sm, ragged)
    assert splits >= 1 and chunk >= STAGE and chunk % STAGE == 0
    # split z is [z * chunk, (z + 1) * chunk): together they reach the
    # capacity and the last one starts inside it (none empty)
    assert splits * chunk >= cap
    assert (splits - 1) * chunk < cap
    # a split spans few enough pages for the block's list (a window may
    # start it mid-page: one page more)
    assert -(-chunk // page_size) + 1 <= MAX_PAGES
    if ragged:
        assert chunk <= pa.RAGGED_MAX_STAGES * STAGE


@pytest.mark.parametrize("label,H,KV,T,B,page_size,P", SHAPES)
def test_query_tiles_hold_whole_queries(label, H, KV, T, B, page_size, P):
    """A block's 128 rows hold TQ queries of all G heads; the grid's
    static size counts B x ceil(T / TQ) prefill tiles or ceil(S / TQ) + B
    ragged segments."""
    G = H // KV
    tq = pa.attend_tq(H, KV)
    assert tq >= 1 and tq * G <= ROWS < (tq + 1) * G
    assert pa.attend_tiles(H, KV, T, B, False) == B * -(-T // tq)
    assert pa.attend_tiles(H, KV, T, B, True) == -(-T // tq) + B


def test_served_plans():
    """At the served shapes: the prefill grid fills the card, so it runs
    unsplit; the ragged launch splits a 2048-token table into splits of
    at most RAGGED_MAX_STAGES stages."""
    cap, cap_stages = 2048, pa.RAGGED_MAX_STAGES
    for per_sm in (1, 2):
        assert pa.attend_plan(32, 8, 512, 4, cap, 16, H100_SMS, per_sm,
                              False) == (1, cap)
        splits, chunk = pa.attend_plan(32, 8, 512, 12, cap, 16, H100_SMS,
                                       per_sm, True)
        assert chunk == cap_stages * STAGE and splits == cap // chunk
    # a small prefill grid (one row of 64 queries) splits to fill the card
    splits, chunk = pa.attend_plan(32, 8, 64, 1, cap, 16, H100_SMS, 2, False)
    assert splits > 1 and 2 * 8 * splits <= H100_SMS * 2


@pytest.mark.parametrize("label,H,KV,T,B,page_size,P", SHAPES)
def test_partial_buffers_hold_every_split(label, H, KV, T, B, page_size, P):
    for ragged in (False, True):
        tiles = pa.attend_tiles(H, KV, T, B, ragged)
        splits, _ = pa.attend_plan(H, KV, T, B, P * page_size, page_size,
                                   H100_SMS, 2, ragged)
        o_shape, ml_shape = pa.attend_partial_shapes(tiles, KV, 64, splits)
        assert o_shape == (tiles, KV, splits, ROWS, 64)
        assert ml_shape == (tiles, KV, splits, ROWS, 2)
        # the kernel writes row r of (tile, kvh, split z) at
        # ((tile * KV + kvh) * splits + z) * 128 + r
        last = ((tiles * KV - 1) * splits + splits - 1) * ROWS + ROWS - 1
        assert last == tiles * KV * splits * ROWS - 1


def _segments(tok_row, q_pos, valid, tq, window=0):
    """The kernel's segments (runs of one row inside a TQ-wide window of
    the packed axis) with their KV range [lo, hi), as csrc ragged_tile
    finds them."""
    segs, S = [], len(tok_row)
    for i, r in enumerate(tok_row):
        if r < 0 or (i % tq and tok_row[i - 1] == r):
            continue
        end = i + 1
        while end < min((i // tq + 1) * tq, S) and tok_row[end] == r:
            end += 1
        lo_pos, hi_pos = min(q_pos[i:end]), max(q_pos[i:end])
        lo = max(lo_pos - window + 1, 0) if window > 0 else 0
        segs.append((r, i, end, lo, min(valid[r], hi_pos + 1)))
    return segs


def _served_mix():
    """The mixed step's served layout (chip_smoke.py's S = 512 case)."""
    decode_valid = [0, 1, 16, 17, 300, 1000, 2047, 2048]
    chunks = [(200, 0), (250, 1500), (54, 100)]
    tok_row, q_pos, valid = [], [], []
    for b, v in enumerate(decode_valid):
        tok_row.append(b if v > 0 else -1)
        q_pos.append(max(v - 1, 0))
        valid.append(v)
    for j, (n, start) in enumerate(chunks):
        tok_row += [len(decode_valid) + j] * n
        q_pos += list(range(start, start + n))
        valid.append(start + n)
    valid += [0] * (12 - len(valid))
    return tok_row, q_pos, valid


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("window", [0, 300])
def test_ragged_splits_walk_every_key_once(per_sm, window):
    """On the served mix, the segment bound holds, every key of every
    segment falls in exactly one split with keys (the splits z0..z1 the
    kernel merges), and no split walks more than RAGGED_MAX_STAGES stages:
    the 2048-token decode row and the 1500-deep chunk no longer walk their
    histories in one block."""
    tok_row, q_pos, valid = _served_mix()
    tq = pa.attend_tq(32, 8)
    splits, chunk = pa.attend_plan(32, 8, len(tok_row), 12, 2048, 16,
                                   H100_SMS, per_sm, True)
    segs = _segments(tok_row, q_pos, valid, tq, window)
    assert len(segs) <= pa.attend_tiles(32, 8, len(tok_row), 12, True)
    longest = 0
    for _, _, _, lo, hi in segs:
        if hi <= lo:
            continue
        z0, z1 = lo // chunk, (hi - 1) // chunk
        assert 0 <= z0 <= z1 < splits
        walked = []
        for z in range(z0, z1 + 1):
            t0, t1 = max(lo, z * chunk), min(hi, (z + 1) * chunk)
            assert t1 > t0  # no split with keys is empty
            walked += range(t0, t1)
            longest = max(longest, -(-(t1 - t0) // STAGE))
        assert walked == list(range(lo, hi))
    assert longest <= pa.RAGGED_MAX_STAGES
    if window == 0:  # unsplit, the longest block walked the 2048-token row
        assert max(-(-(hi - lo) // STAGE) for *_, lo, hi in segs) == 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools(rng, num_pages, ps, KV, D):
    pk = rng.standard_normal((num_pages * ps, KV, D)).astype(np.float32)
    pv = rng.standard_normal((num_pages * ps, KV, D)).astype(np.float32)
    return pk, pv


# B, T, H, KV, D, page_size, P, q_start, window, softcap: histories of
# hundreds of tokens (the ranges the kernel splits), a chunk that ends at
# the table's end, window and softcap
LONG_PREFILL = [
    (2, 16, 4, 2, 16, 8, 48, [300, 360], 0, 0.0),
    (2, 24, 8, 2, 32, 8, 40, [296, 0], 0, 0.0),
    (3, 8, 4, 4, 16, 16, 24, [370, 200, 0], 100, 0.0),
    (2, 16, 4, 1, 16, 8, 48, [250, 368], 0, 30.0),
    (2, 20, 7, 1, 16, 8, 48, [300, 100], 64, 50.0),  # G 7, window, cap
]


@pytest.mark.parametrize("B,T,H,KV,D,ps,P,q_start,window,softcap",
                         LONG_PREFILL)
def test_plain_prefill_matches_pallas_on_long_histories(B, T, H, KV, D, ps, P,
                                                        q_start, window,
                                                        softcap):
    rng = np.random.default_rng(B * 7 + T + D + P)
    num_pages = B * P + 4
    pk, pv = _pools(rng, num_pages, ps, KV, D)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    tables = rng.permutation(num_pages)[: B * P].reshape(B, P).astype(
        np.int32)
    qs = np.asarray(q_start, np.int32)
    valid = np.minimum(qs + T - np.arange(B) % 2 * (T // 3), P * ps).astype(
        np.int32)  # every other row's chunk is padded past its length
    want = np.asarray(paged_attention_prefill(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(qs), jnp.asarray(valid),
        page_size=ps, q_block=8, pages_per_block=4, interpret=True,
        sliding_window=window, attn_softcap=softcap))
    got = pa.paged_prefill(_t(q), _t(pk), _t(pv), _t(tables), _t(qs),
                           _t(valid), page_size=ps, sliding_window=window,
                           attn_softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


# (decode rows' valid, chunks (length, q_start)), S, H, KV, D, P, window,
# softcap: long decode rows and deep chunks beside short ones, page 8
LONG_RAGGED = [
    ([380, 1, 0, 97], [(10, 300), (6, 0)], 24, 4, 2, 16, 48, 0, 0.0),
    ([383], [(13, 370), (9, 150)], 32, 8, 4, 16, 48, 0, 0.0),
    ([200, 350, 17], [(12, 330)], 16, 4, 1, 32, 48, 64, 25.0),
    ([310, 5], [(11, 290), (4, 0)], 20, 7, 1, 16, 48, 64, 50.0),  # G 7
]


@pytest.mark.parametrize("decode,chunks,S,H,KV,D,P,window,softcap",
                         LONG_RAGGED)
def test_plain_ragged_matches_pallas_on_long_histories(decode, chunks, S, H,
                                                       KV, D, P, window,
                                                       softcap):
    ps = 8
    rng = np.random.default_rng(S + H + D + len(decode))
    tok_row, q_pos, valid = [], [], []
    for b, v in enumerate(decode):
        tok_row.append(b if v > 0 else -1)
        q_pos.append(max(v - 1, 0))
        valid.append(v)
    for j, (n, start) in enumerate(chunks):
        tok_row += [len(decode) + j] * n
        q_pos += list(range(start, start + n))
        valid.append(start + n)
    tok_row += [-1] * (S - len(tok_row))
    q_pos += [0] * (S - len(q_pos))
    Bm = len(valid)
    num_pages = Bm * P + 4
    pk, pv = _pools(rng, num_pages, ps, KV, D)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    tables = rng.permutation(num_pages)[: Bm * P].reshape(Bm, P).astype(
        np.int32)
    tok_row = np.asarray(tok_row, np.int32)
    q_pos = np.asarray(q_pos, np.int32)
    valid = np.asarray(valid, np.int32)
    want = np.asarray(paged_attention_ragged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(tok_row), jnp.asarray(q_pos),
        jnp.asarray(valid), page_size=ps, q_block=8, pages_per_block=4,
        interpret=True, sliding_window=window, attn_softcap=softcap))
    got = pa.paged_ragged(_t(q), _t(pk), _t(pv), _t(tables), _t(tok_row),
                          _t(q_pos), _t(valid), page_size=ps,
                          sliding_window=window, attn_softcap=softcap).numpy()
    real = tok_row >= 0  # JAX's padding outputs are garbage by contract
    np.testing.assert_allclose(got[real], want[real], atol=TOL, rtol=TOL)
    assert not got[~real].any()
