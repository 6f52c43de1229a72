"""Ring attention: context-parallel blockwise attention over the ``seq``
mesh axis (port of ``distributed_inference_server_tpu/ops/ring_attention.py``;
plain PyTorch, as the JAX functions are plain ``jnp``).

Every ``seq`` shard holds one chunk of queries, keys and values. The K/V
chunks rotate around the ring (``comm.ppermute``) while each shard
accumulates an online softmax of its queries over every chunk it sees —
flash attention's math with the outer loop over ring neighbours.
Causality rides on absolute positions, which rotate with their chunks, so
the mask is exact for any layout; negative positions mark padding
(padding keys are never attended, padding queries emit zeros).

``ring_attention`` is the per-shard body over the ring's chunks (lists in
ring order); ``ring_attention_sharded`` cuts global tensors over a mesh
(sequence on ``seq``, heads on ``tensor``, rows on ``data``) and joins the
result.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from distributed_inference_server_tpu_torch.parallel import comm

_NEG_INF = -1e30


def _accumulate(stats, qg, q_pos, k_blk, v_blk, pos_kv, scale,
                sliding_window, attn_softcap):
    """Online-softmax update of (m, l, acc) with one K/V chunk."""
    m, l, acc = stats
    s = torch.einsum("btkgd,bskd->bkgts", qg, k_blk.float()) * scale
    if attn_softcap is not None:
        s = torch.tanh(s / attn_softcap) * attn_softcap
    causal = pos_kv[:, None, :] <= q_pos[:, :, None]  # [B, Tl, S]
    if sliding_window is not None and int(sliding_window) > 0:
        causal = causal & (pos_kv[:, None, :]
                           > q_pos[:, :, None] - int(sliding_window))
    valid = (pos_kv >= 0)[:, None, :] & (q_pos >= 0)[:, :, None]
    mask = (causal & valid)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    # explicit zeros for masked entries: a query that has seen nothing yet
    # (m == -inf) would otherwise weigh them exp(0) = 1
    probs = torch.where(s > _NEG_INF * 0.5, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
    l_new = l * alpha + probs.sum(dim=-1)
    upd = torch.einsum("bkgts,bskd->btkgd", probs, v_blk.float())
    acc_new = acc * alpha.permute(0, 3, 1, 2)[..., None] + upd
    return m_new, l_new, acc_new


def ring_attention(
    q: Sequence[torch.Tensor],
    k: Sequence[torch.Tensor],
    v: Sequence[torch.Tensor],
    q_positions: Sequence[torch.Tensor],
    kv_positions: Sequence[torch.Tensor],
    sliding_window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
) -> List[torch.Tensor]:
    """Ring attention over the chunks of one ring, in ring order.

    q[i]: [B, Tl, H, D] shard i's queries; k[i], v[i]: [B, Tl, KV, D] its
    keys and values (GQA: H = G * KV); q_positions[i], kv_positions[i]:
    [B, Tl] absolute positions (negative = padding). ``sliding_window``:
    None or <= 0 = full causal. ``attn_softcap``: tanh(s/cap)*cap before
    masking.

    Returns each shard's [B, Tl, H, D] in q's dtype: attention over the
    FULL sequence."""
    R = len(q)
    B, Tl, H, D = q[0].shape
    KV = k[0].shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = [x.float().reshape(B, Tl, KV, G, D) for x in q]
    stats = [(torch.full((B, KV, G, Tl), _NEG_INF, device=x.device),
              torch.zeros((B, KV, G, Tl), device=x.device),
              torch.zeros((B, Tl, KV, G, D), device=x.device)) for x in q]
    perm = [(i, (i + 1) % R) for i in range(R)]
    kb, vb, pb = list(k), list(v), list(kv_positions)
    for step in range(R):
        stats = [_accumulate(stats[i], qg[i], q_positions[i], kb[i], vb[i],
                             pb[i], scale, sliding_window, attn_softcap)
                 for i in range(R)]
        if step < R - 1:  # the last rotation's result would be discarded
            kb, vb, pb = (comm.ppermute(kb, perm), comm.ppermute(vb, perm),
                          comm.ppermute(pb, perm))
    out = []
    for (m, l, acc), x in zip(stats, q):
        l = l.clamp(min=1e-30).permute(0, 3, 1, 2)[..., None]
        out.append((acc / l).reshape(B, Tl, H, D).to(x.dtype))
    return out


def _split(x: torch.Tensor, dim: int, n: int) -> List[torch.Tensor]:
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} ({x.shape[dim]}) not divisible "
                         f"by {n}")
    return list(x.chunk(n, dim=dim))


def shard_map_attention(mesh, body, q, k, v, q_positions, row_args,
                        axis_name: str = "seq") -> torch.Tensor:
    """Run ``body(q_chunks, k_chunks, v_chunks, qpos_chunks,
    *row_arg_chunks)`` per (data, tensor) group with the sequence split
    over ``axis_name``, then join the groups: rows on ``data``, heads on
    ``tensor`` (the JAX wrappers' specs). ``row_args``: [B, T] tensors cut
    like the positions, or [B] tensors (per-row, only split on data)."""
    R = mesh.shape[axis_name]
    dp, tp = mesh.shape["data"], mesh.shape["tensor"]
    rows = []
    for qd, kd, vd, pd, *ad in zip(
            _split(q, 0, dp), _split(k, 0, dp), _split(v, 0, dp),
            _split(q_positions, 0, dp), *[_split(a, 0, dp) for a in row_args]):
        heads = []
        for qt, kt, vt in zip(_split(qd, 2, tp), _split(kd, 2, tp),
                              _split(vd, 2, tp)):
            chunks = [_split(a, 1, R) if a.dim() == 2 else [a] * R
                      for a in ad]
            heads.append(torch.cat(body(
                _split(qt, 1, R), _split(kt, 1, R), _split(vt, 1, R),
                _split(pd, 1, R), *chunks), dim=1))
        rows.append(torch.cat(heads, dim=2))
    return torch.cat(rows, dim=0)


def ring_attention_sharded(mesh, q, k, v, q_positions, kv_positions,
                           axis_name: str = "seq", sliding_window=None,
                           attn_softcap: Optional[float] = None
                           ) -> torch.Tensor:
    """Global [B, T, H, D] ring attention over ``mesh``: sequence on
    ``axis_name``, heads on ``tensor`` (each tensor shard rings its own
    heads), rows on ``data``."""
    return shard_map_attention(
        mesh, lambda qc, kc, vc, pc, kpc: ring_attention(
            qc, kc, vc, pc, kpc, sliding_window, attn_softcap),
        q, k, v, q_positions, [kv_positions], axis_name)
