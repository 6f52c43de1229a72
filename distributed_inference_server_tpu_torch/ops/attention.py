"""Plain grouped-query attention over contiguous KV windows (port of
``distributed_inference_server_tpu/ops/attention.py``: ``gqa_attention``
and ``ragged_gqa_attention``).

This is the numerics reference the paged-attention kernels' plain versions
(``ops/kernels/paged_attention.py``) are built on. The GQA group folds into
the einsum (no repeated KV heads), softmax runs in f32, and ragged batches
carry an explicit per-row valid length.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30  # large-negative instead of -inf so fully-masked rows stay finite


def gqa_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    q_positions: torch.Tensor,
    kv_valid_len: torch.Tensor,
    sliding_window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal GQA attention of new queries against a contiguous KV cache.

    q: [B, T, H, D]; k_cache, v_cache: [B, S, KV, D] (already holding the new
    tokens' K/V); q_positions: [B, T] absolute positions; kv_valid_len: [B].
    ``sliding_window``: attend only the last ``w`` positions (None or <= 0 =
    full causal). ``attn_softcap``: tanh(s/cap)*cap before masking.

    Returns [B, T, H, D] in q.dtype. A query with nothing visible gets the
    mean of V (as the reference does); callers that need zeros there
    mask it themselves.
    """
    B, T, H, D = q.shape
    S = k_cache.shape[1]
    KV = k_cache.shape[2]
    G = H // KV

    qg = q.reshape(B, T, KV, G, D).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k_cache.float())
    scores = scores * (1.0 / math.sqrt(D))
    if attn_softcap is not None:
        scores = torch.tanh(scores / attn_softcap) * attn_softcap

    kv_pos = torch.arange(S, device=q.device)
    causal = kv_pos[None, None, :] <= q_positions[:, :, None]  # [B, T, S]
    valid = kv_pos[None, None, :] < kv_valid_len[:, None, None]
    mask = causal & valid
    if sliding_window is not None and int(sliding_window) > 0:
        mask = mask & (kv_pos[None, None, :]
                       > q_positions[:, :, None] - int(sliding_window))
    scores = scores.masked_fill(~mask[:, None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v_cache.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def ragged_gqa_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    tok_row: torch.Tensor,
    q_positions: torch.Tensor,
    kv_valid_len: torch.Tensor,
    sliding_window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal GQA attention of a PACKED ragged batch against per-row caches
    (the engine's mixed step): each packed token attends its own row.

    q: [S, H, D] packed tokens; k_cache, v_cache: [Bm, S_max, KV, D]
    per-row windows (already holding the new tokens' K/V); tok_row: [S]
    row of each token (-1 = padding; rows clamp into [0, Bm)); q_positions:
    [S]; kv_valid_len: [Bm]. ``sliding_window`` and ``attn_softcap`` as in
    ``gqa_attention``.

    Returns [S, H, D] in q.dtype. Padding tokens and tokens with nothing
    visible get the mean of V (as the reference does); callers discard or
    mask them.
    """
    S, H, D = q.shape
    Bm, Smax, KV, _ = k_cache.shape
    G = H // KV

    row = tok_row.long().clamp(0, Bm - 1)
    k_tok = k_cache[row].float()  # [S, Smax, KV, D]
    v_tok = v_cache[row].float()
    qg = q.reshape(S, KV, G, D).float()
    scores = torch.einsum("tkgd,tskd->tkgs", qg, k_tok)
    scores = scores * (1.0 / math.sqrt(D))
    if attn_softcap is not None:
        scores = torch.tanh(scores / attn_softcap) * attn_softcap

    kv_pos = torch.arange(Smax, device=q.device)
    causal = kv_pos[None, :] <= q_positions[:, None]  # [S, Smax]
    valid = kv_pos[None, :] < kv_valid_len[row][:, None]
    mask = causal & valid & (tok_row >= 0)[:, None]
    if sliding_window is not None and int(sliding_window) > 0:
        mask = mask & (kv_pos[None, :]
                       > q_positions[:, None] - int(sliding_window))
    scores = scores.masked_fill(~mask[:, None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("tkgs,tskd->tkgd", probs, v_tok)
    return out.reshape(S, H, D).to(q.dtype)
