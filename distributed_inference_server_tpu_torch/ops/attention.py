"""Plain grouped-query attention over a contiguous KV window (port of
``distributed_inference_server_tpu/ops/attention.py:gqa_attention``).

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
