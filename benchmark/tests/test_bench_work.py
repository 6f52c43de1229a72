"""work.py's counts against counts made by hand at a tiny shape."""

from __future__ import annotations

from benchmark import work

TINY = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 2,
        "vocab_size": 10, "sliding_window": 3, "quantization": "none"}
MOE = dict(TINY, num_local_experts=4, num_experts_per_tok=2,
           sliding_window=None, quantization="int8", quant_group=4)


def test_dense_counts():
    d = work.dims(TINY)
    assert (d.q_size, d.kv_size) == (8, 4)
    assert work.attn_params(d) == 8 * 8 + 8 * 4 + 8 * 4 + 8 * 8  # 192
    assert work.expert_params(d) == 3 * 8 * 16  # 384
    assert work.active_params_per_token(d) == 2 * (192 + 384) + 8 * 10
    # bf16: 2 bytes a weight; norms 2 x 8 a layer; unembedding 80;
    # embedding rows (1 + rows) x 8
    assert work.weight_bytes(d, 3) == (2 * (2 * 192 + 2 * 384 + 2 * 16)
                                       + 2 * 80 + 2 * 8 * 4)
    assert work.kv_bytes_per_token(d) == 2 * 4 * 2 * 2  # K and V, 2 layers
    # window 3: positions 0..4 see 1, 2, 3, 3, 3 keys
    assert [work.visible(d, p) for p in range(5)] == [1, 2, 3, 3, 3]
    assert work.prompt_visible_sum(d, 5) == 12
    assert work.prompt_visible_sum(d, 2) == 3
    assert work.attn_flops(d, 12) == 4 * 8 * 12 * 2


def test_moe_counts():
    d = work.dims(MOE)
    assert d.experts == 4 and d.weight == "int8" and d.window == 0
    # top 2 experts and the router per token and layer
    assert work.active_params_per_token(d) == (
        2 * (192 + 2 * 384 + 8 * 4) + 80)
    assert work.experts_touched(d, 1) == 0.5
    assert work.experts_touched(d, 2) == 0.75
    # int8 [8, 8]: 64 codes + 4 bytes x (8 / 4 groups) x 8 columns
    assert work._linear_bytes(d, 64, 8) == 64 + 64
    rows = 1
    attn = 2 * (64 + 64) + 2 * (32 + 32)
    expert = 2 * (128 + 128) + (128 + 128)
    assert work.weight_bytes(d, rows) == (
        2 * (attn + expert * 4 * 0.5 + 2 * 8 * 4 + 2 * 2 * 8)
        + 2 * 80 + 2 * 8 * 2)


def test_bounds():
    assert work.bound_s(989e12, 0) == 1.0
    assert work.bound_s(0, 3.35e12) == 1.0
    assert work.share(1.0, 4.0) == 25.0
    assert work.share(1.0, 0.0) is None
    d = work.dims(TINY)
    one = work.forwards_bound_s(d, 1, 3, 6)
    assert one == work.bound_s(
        2.0 * work.active_params_per_token(d) * 3 + work.attn_flops(d, 6),
        work.weight_bytes(d, 3))
    assert work.forwards_bound_s(d, 0, 3, 6) == 0.0
