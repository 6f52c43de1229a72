"""The tensor-core paged decode's split plan (``paged_attention.decode_plan``),
on the CPU.

The plan is plain Python: how many splits each row's KV range takes and how
many tokens each split spans, from the table capacity (never the data) and
the card's SM count times the decode blocks one SM holds. For the served
shapes (llama-3.2-1b: KV 8, D 64; llama-3-8b int8: KV 8, D 128; capacity
2048 = 128 pages of 16 tokens), the model families' (gemma2-9b: D 256,
one block per SM; qwen2-7b: KV 4, G 7; a mistral-7b table past its
4096-token window) and edge shapes (B = 1, a capacity below
one 64-token stage, G = 1 and G = 8, odd page sizes), the splits must
cover [0, capacity) in whole stages without overlap, no split empty, the
grid must fit one wave of resident blocks, and a split must span few
enough pages for the block's page-id list; the partial buffers must hold
one slot per (row, head, split).
"""

from __future__ import annotations

import pytest

from distributed_inference_server_tpu_torch.ops.kernels import (
    paged_attention as pa,
)

decode_plan, partial_shapes = pa.decode_plan, pa.partial_shapes

H100_SMS = 132
STAGE = 64  # tokens per ring stage (csrc kDecTK)
MAX_PAGES = 256  # page ids a decode block holds (csrc kDecMaxPages)
# decode blocks one SM holds (the kernel's occupancy query reports the
# card's own; an H100 holds 4 at D 64, 3 at D 128 and 1 at D 256) and
# other counts
PER_SM = (4, 3, 2, 1)

# (label, B, H, KV, D, page_size, P)
SHAPES = [
    ("1B B8", 8, 32, 8, 64, 16, 128),
    ("1B B4", 4, 32, 8, 64, 16, 128),
    ("1B B1", 1, 32, 8, 64, 16, 128),
    ("8B int8 B8", 8, 32, 8, 128, 16, 128),
    ("8B int8 B2", 2, 32, 8, 128, 16, 128),
    ("below one stage", 8, 32, 8, 64, 16, 1),
    ("one page of 8", 1, 8, 8, 64, 8, 1),
    ("G=1", 8, 8, 8, 64, 16, 128),
    ("G=8", 8, 64, 8, 128, 16, 128),
    ("page 4", 6, 32, 8, 64, 4, 16),
    ("page 5", 3, 16, 2, 64, 5, 40),
    ("page 1, long", 2, 32, 8, 64, 1, 4096),
    ("capacity 32768", 1, 32, 8, 128, 16, 2048),
    ("B64 more rows than slots", 64, 32, 8, 64, 16, 128),
    ("gemma2-9b B8 D256", 8, 16, 8, 256, 16, 128),
    ("qwen2-7b B8 G7", 8, 28, 4, 128, 16, 128),
    ("mistral-7b past the window", 8, 32, 8, 128, 16, 320),
    # per-shard head counts under tensor parallelism
    ("8B tp2 shard B8 (H16 KV4)", 8, 16, 4, 128, 16, 128),
    ("8B tp8 shard B8 (H4 KV1)", 8, 4, 1, 128, 16, 128),
    ("1B tp8 shard B8 (H4 KV1)", 8, 4, 1, 64, 16, 128),
    ("gemma2-9b tp8 shard (H2 KV1 D256)", 8, 2, 1, 256, 16, 128),
    ("KV1 G4 D64 B1", 1, 4, 1, 64, 16, 128),
    ("KV1 G4 D256", 8, 4, 1, 256, 16, 128),
    ("qwen2-7b tp4 shard (G7 KV1 D128)", 8, 7, 1, 128, 16, 128),
    ("KV1 G7 D64", 8, 7, 1, 64, 16, 128),
    ("KV1 G7 D256 B2", 2, 7, 1, 256, 16, 128),
]


@pytest.mark.parametrize("per_sm", PER_SM)
@pytest.mark.parametrize("label,B,H,KV,D,page_size,P", SHAPES)
def test_splits_cover_the_table_in_whole_stages(label, B, H, KV, D,
                                                page_size, P, per_sm):
    cap = P * page_size
    splits, chunk = decode_plan(B, KV, cap, page_size, H100_SMS, per_sm)
    assert splits >= 1 and chunk >= STAGE and chunk % STAGE == 0
    # split z is [z * chunk, (z + 1) * chunk): disjoint by construction;
    # together they reach the capacity and the last one starts inside it
    assert splits * chunk >= cap
    assert (splits - 1) * chunk < cap
    # a split spans few enough pages for the block's list (a window may
    # start it mid-page: one page more)
    assert -(-chunk // page_size) + 1 <= MAX_PAGES


@pytest.mark.parametrize("per_sm", PER_SM)
@pytest.mark.parametrize("label,B,H,KV,D,page_size,P", SHAPES)
def test_grid_fits_one_wave(label, B, H, KV, D, page_size, P, per_sm):
    cap = P * page_size
    splits, chunk = decode_plan(B, KV, cap, page_size, H100_SMS, per_sm)
    slots = H100_SMS * per_sm
    pages_cap = chunk == (MAX_PAGES - 2) * page_size // STAGE * STAGE
    if B * KV >= slots:
        assert splits == 1 or pages_cap  # more rows than slots: unsplit
    elif not pages_cap:
        assert B * KV * splits <= slots
        # and it uses the wave: with one stage fewer per split the grid
        # would not fit (or a split is one stage already)
        per, stages = chunk // STAGE, -(-cap // STAGE)
        assert per == 1 or B * KV * -(-stages // (per - 1)) > slots


def test_served_shapes_split_long_rows():
    """At the served shapes the split runs: several splits of a few
    stages each, so a 2048-token row's stages spread over several SMs."""
    # llama-3.2-1b (D 64, 4 blocks per SM): 8 splits of 4 stages
    assert decode_plan(8, 8, 2048, 16, H100_SMS, 4) == (8, 256)
    # llama-3-8b int8 (D 128, 3 blocks per SM): 6 splits of 6 stages
    assert decode_plan(8, 8, 2048, 16, H100_SMS, 3) == (6, 384)
    # one row alone takes one stage per split
    assert decode_plan(1, 8, 2048, 16, H100_SMS, 4) == (32, 64)


@pytest.mark.parametrize("label,B,H,KV,D,page_size,P", SHAPES)
def test_partial_buffers_hold_every_split(label, B, H, KV, D, page_size, P):
    splits, _ = decode_plan(B, KV, P * page_size, page_size, H100_SMS, 3)
    o_shape, ml_shape = partial_shapes(B, H, D, splits)
    assert o_shape == (B, H, splits, D)
    assert ml_shape == (B, H, splits, 2)
    # the kernel writes head h of row b, split z at ((b*H + h)*NS + z)*D
    last = ((B * H - 1) * splits + splits - 1) * D + D - 1
    assert last == B * H * splits * D - 1
