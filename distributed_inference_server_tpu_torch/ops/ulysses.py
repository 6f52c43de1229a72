"""Ulysses sequence parallelism: all-to-all head-scatter attention (port
of ``distributed_inference_server_tpu/ops/ulysses.py``; plain PyTorch).

Where ring attention keeps queries resident and rotates K/V chunks,
Ulysses re-shards: one all-to-all turns the sequence-split [B, T/s, H, D]
into head-split, sequence-complete [B, T, H/s, D]; each shard runs
ordinary full-sequence attention for its head group, and a second
all-to-all restores the sequence split. The axis size must divide both
the query- and the KV-head counts (GQA keeps its groups).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from distributed_inference_server_tpu_torch.ops.attention import gqa_attention
from distributed_inference_server_tpu_torch.ops.ring_attention import (
    shard_map_attention,
)
from distributed_inference_server_tpu_torch.parallel import comm


def ulysses_attention(
    q: Sequence[torch.Tensor],
    k: Sequence[torch.Tensor],
    v: Sequence[torch.Tensor],
    q_positions: Sequence[torch.Tensor],
    kv_valid_len: Sequence[torch.Tensor],
    sliding_window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
) -> List[torch.Tensor]:
    """Ulysses attention over one axis's chunks, in shard order.

    q[i]: [B, Tl, H, D] shard i's chunk with all heads; k[i], v[i]: [B,
    Tl, KV, D]; q_positions[i]: [B, Tl] absolute positions (contiguous
    chunks: shard i holds positions [i*Tl, (i+1)*Tl)); kv_valid_len[i]:
    [B] valid length per row (the same on every shard).

    Returns each shard's [B, Tl, H, D]: attention over the FULL sequence."""
    s = len(q)
    H, KV = q[0].shape[2], k[0].shape[2]
    if H % s or KV % s:
        raise ValueError(
            f"Ulysses axis size {s} must divide query heads {H} and KV "
            f"heads {KV}; use ring attention for larger axes")
    # scatter heads / gather sequence: [B, Tl, H, D] -> [B, T, H/s, D]
    qh = comm.all_to_all(q, split_axis=2, concat_axis=1)
    kh = comm.all_to_all(k, split_axis=2, concat_axis=1)
    vh = comm.all_to_all(v, split_axis=2, concat_axis=1)
    pos = comm.all_gather(q_positions, dim=1)  # [B, T]
    out = [gqa_attention(qh[i], kh[i], vh[i], comm.to(pos, qh[i].device),
                         comm.to(kv_valid_len[i], qh[i].device),
                         sliding_window, attn_softcap) for i in range(s)]
    # gather heads / scatter sequence back: [B, T, H/s, D] -> [B, Tl, H, D]
    return comm.all_to_all(out, split_axis=1, concat_axis=2)


def ulysses_attention_sharded(mesh, q, k, v, q_positions, kv_valid_len,
                              axis_name: str = "seq", sliding_window=None,
                              attn_softcap: Optional[float] = None
                              ) -> torch.Tensor:
    """Global [B, T, H, D] Ulysses attention over ``mesh``: sequence on
    ``axis_name``, heads on ``tensor`` (the all-to-all re-shards each
    tensor shard's own heads), rows on ``data``."""
    return shard_map_attention(
        mesh, lambda qc, kc, vc, pc, vl: ulysses_attention(
            qc, kc, vc, pc, vl, sliding_window, attn_softcap),
        q, k, v, q_positions, [kv_valid_len], axis_name)
