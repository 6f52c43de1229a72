"""Operations and bytes that a forward needs, from a configuration's
published shapes, and the H100's peaks.

The arithmetic follows the repository's ``chip_smoke.py`` (``bound()``:
the larger of the operations over the compute peak and the bytes over the
memory peak) and ``tools/torch_decode_bytes.py`` (every layer weight read
once a decode step, K/V read once per visible key); it is copied, not
imported, so that a later change to the program does not move the
yardstick. Counts are of what the tokens need: each input byte read once,
each output byte written once, the keys a query can see (its causal
window), and for a mixture of experts the experts that the tokens route
to, not the dense form's all.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s in bf16 (the q8
matmul multiplies in bf16 after dequantizing) and 3.35 TB/s of HBM3, at a
700 W power limit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


@dataclass(frozen=True)
class Dims:
    hidden: int
    inter: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    experts: int  # 0: dense MLP
    top_k: int
    window: int  # 0: full causal
    weight: str  # "bf16" or "int8"
    group: int  # int8 group rows along the input axis

    @property
    def q_size(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.kv_heads * self.head_dim


def dims(cfg: dict) -> Dims:
    """The shapes of a configuration file (published ``config.json``
    keys)."""
    heads = int(cfg["num_attention_heads"])
    hidden = int(cfg["hidden_size"])
    return Dims(
        hidden=hidden, inter=int(cfg["intermediate_size"]),
        layers=int(cfg["num_hidden_layers"]), heads=heads,
        kv_heads=int(cfg["num_key_value_heads"]),
        head_dim=int(cfg.get("head_dim") or hidden // heads),
        vocab=int(cfg["vocab_size"]),
        experts=int(cfg.get("num_local_experts") or 0),
        top_k=int(cfg.get("num_experts_per_tok") or 0),
        window=int(cfg.get("sliding_window") or 0),
        weight="int8" if cfg["quantization"] == "int8" else "bf16",
        group=int(cfg.get("quant_group", 128)))


# -- parameters --------------------------------------------------------------


def attn_params(d: Dims) -> int:
    """q, k, v and o projections of one layer."""
    return 2 * d.hidden * d.q_size + 2 * d.hidden * d.kv_size


def expert_params(d: Dims) -> int:
    """gate, up and down of one expert (or of the dense MLP)."""
    return 3 * d.hidden * d.inter


def active_params_per_token(d: Dims) -> int:
    """Multiply-accumulates per token: every layer's attention
    projections, its MLP (top-k experts and the router for a mixture) and
    the unembedding."""
    mlp = (d.top_k * expert_params(d) + d.hidden * d.experts
           if d.experts else expert_params(d))
    return d.layers * (attn_params(d) + mlp) + d.hidden * d.vocab


def _linear_bytes(d: Dims, n: int, d_in: int) -> float:
    """Bytes of an [d_in, n / d_in] linear weight as served: bf16, or
    int8 codes plus one f32 scale per group of ``d.group`` input rows."""
    if d.weight == "int8":
        return n + 4.0 * n / d.group
    return 2.0 * n


def experts_touched(d: Dims, rows: float) -> float:
    """Expected share of a layer's experts that ``rows`` tokens route to,
    with top-k choices spread evenly: 1 - (1 - k/E) ** rows. At 16 rows
    and top 2 of 8 a given expert is missed with probability 0.75 ** 16,
    about 1 %."""
    if not d.experts:
        return 1.0
    return 1.0 - (1.0 - d.top_k / d.experts) ** max(rows, 0.0)


def weight_bytes(d: Dims, rows: float) -> float:
    """Bytes of weights one forward over ``rows`` tokens reads: every
    layer's projections, the MLP (the experts those rows touch), the
    norms, the router, the bf16 unembedding, and the embedding rows."""
    attn = (_linear_bytes(d, d.hidden * d.q_size, d.hidden) * 2
            + _linear_bytes(d, d.hidden * d.kv_size, d.hidden) * 2)
    per_expert = (_linear_bytes(d, d.hidden * d.inter, d.hidden) * 2
                  + _linear_bytes(d, d.inter * d.hidden, d.inter))
    if d.experts:
        mlp = (per_expert * d.experts * experts_touched(d, rows)
               + 2.0 * d.hidden * d.experts)
    else:
        mlp = per_expert
    norms = 2.0 * 2 * d.hidden
    return (d.layers * (attn + mlp + norms) + 2.0 * d.hidden * d.vocab
            + 2.0 * d.hidden * (1 + rows))


# -- attention ----------------------------------------------------------------


def kv_bytes_per_token(d: Dims) -> int:
    """K and V of one token over every layer, bf16 pools."""
    return 2 * d.kv_size * 2 * d.layers


def visible(d: Dims, pos: int) -> int:
    """Keys the query at 0-based position ``pos`` sees: its causal window
    (the last ``window`` positions, itself included)."""
    return min(pos + 1, d.window) if d.window else pos + 1


def prompt_visible_sum(d: Dims, n: int) -> int:
    """Sum of ``visible`` over a prompt's positions 0 .. n - 1."""
    w = d.window
    if not w or n <= w:
        return n * (n + 1) // 2
    return w * (w + 1) // 2 + (n - w) * w


def attn_flops(d: Dims, keys: float) -> float:
    """QK^T and PV of one query over ``keys`` keys, every head and
    layer."""
    return 4.0 * d.q_size * keys * d.layers


def decode_attn_bytes(d: Dims, tokens: float, keys: float) -> float:
    """Paged decode of ``tokens`` queries that see ``keys`` keys in all:
    the visible K/V read once per query, each query read and its output
    written (bf16)."""
    return (keys * kv_bytes_per_token(d)
            + tokens * 2 * 2.0 * d.q_size * d.layers)


def prefill_attn_bytes(d: Dims, tokens: float) -> float:
    """Paged prefill of ``tokens`` prompt tokens: each one's query, key,
    value and output moved once (bf16)."""
    return tokens * (kv_bytes_per_token(d) + 2 * 2.0 * d.q_size * d.layers)


def bound_s(flops: float, nbytes: float,
            peak_flops: float = PEAK_BF16_FLOPS,
            peak_bytes: float = PEAK_HBM_BYTES) -> float:
    """The least time: the larger of the two bounds (``chip_smoke.py``'s
    ``bound()``)."""
    return max(flops / peak_flops, nbytes / peak_bytes)


# -- a sub-window's forwards --------------------------------------------------


def forwards_bound_s(d: Dims, forwards: float, tokens: float,
                     attn_keys: float, extra_bytes: float = 0.0,
                     ) -> float:
    """Least time of ``forwards`` forwards that together compute
    ``tokens`` tokens whose queries see ``attn_keys`` keys in all: each
    forward bound by the larger of its FLOPs and its bytes, with the
    tokens spread evenly over the forwards. Where a forward's weight bytes
    do not depend on its rows (a dense model; a mixture at 16 or more rows,
    where every expert is touched) this is a lower bound of the sum of each
    forward's own bound, since the larger of two is convex.
    ``extra_bytes``: K/V and other bytes beyond the weights."""
    if forwards <= 0:
        return 0.0
    rows = tokens / forwards
    flops = (2.0 * active_params_per_token(d) * tokens
             + attn_flops(d, attn_keys))
    nbytes = forwards * weight_bytes(d, rows) + extra_bytes
    return forwards * bound_s(flops / forwards, nbytes / forwards)


def q8_bound_s(d: Dims, forwards: float, tokens: float) -> float:
    """Least time of the int8 group-dequant products of ``forwards``
    forwards over ``tokens`` tokens: every quantized layer weight's codes
    and scales read once a forward (the experts the rows touch), the
    activations in and out once; the FLOPs of the attention projections
    and each token's top-k experts."""
    if forwards <= 0 or d.weight != "int8":
        return 0.0
    rows = tokens / forwards
    attn = (_linear_bytes(d, d.hidden * d.q_size, d.hidden) * 2
            + _linear_bytes(d, d.hidden * d.kv_size, d.hidden) * 2)
    per_expert = (_linear_bytes(d, d.hidden * d.inter, d.hidden) * 2
                  + _linear_bytes(d, d.inter * d.hidden, d.inter))
    n_exp = d.experts or 1
    w = d.layers * (attn + per_expert * n_exp * experts_touched(d, rows))
    k = d.top_k if d.experts else 1
    acts = 2.0 * tokens * d.layers * (
        2 * d.hidden + d.q_size + 2 * d.kv_size  # q/k/v in, outputs
        + d.q_size + d.hidden                    # o in and out
        + k * (d.hidden + 3 * d.inter + d.hidden))  # experts in and out
    flops = 2.0 * tokens * d.layers * (attn_params(d)
                                       + k * expert_params(d))
    return forwards * bound_s(flops / forwards, (forwards * w + acts)
                              / forwards)


def share(bound: float, measured: float) -> Optional[float]:
    """A bound's share of a measured time, in %, or None when nothing was
    measured."""
    if measured <= 0 or bound <= 0:
        return None
    return 100.0 * bound / measured
