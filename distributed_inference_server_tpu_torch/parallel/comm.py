"""Collectives between the shards of one mesh, in one process.

The JAX engine's collectives are inserted by XLA (GSPMD) or issued inside
``shard_map``; the port's single controller calls these instead. Each
takes the shards' tensors as a list in shard order:

- ``all_reduce`` — the sum of partials (the row-parallel ``wo`` /
  ``w_down`` products), added in fixed shard order so every run sums
  alike;
- ``all_gather`` — concatenation in shard order (vocab-parallel logits);
- ``ppermute`` — each (source, destination) pair hands its tensor on;
  shards that receive nothing get zeros (``lax.ppermute``'s contract);
- ``all_to_all`` — shard ``j`` receives chunk ``j`` of every shard's
  tensor split along ``split_axis``, concatenated along ``concat_axis``
  in shard order (``lax.all_to_all(tiled=True)``).

Slots on one device, or on the CPU, make these plain tensor ops. Slots on
distinct cards move tensors by peer copies (``Tensor.to``), ordered on the
current streams of both cards.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device`` (itself when it is there already)."""
    return x if x.device == device else x.to(device, non_blocking=True)


def all_reduce(parts: Sequence[torch.Tensor],
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Sum of ``parts`` in shard order, on ``device`` (default the first
    part's)."""
    dev = parts[0].device if device is None else device
    out = to(parts[0], dev)
    for p in parts[1:]:
        out = out + to(p, dev)
    return out


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` in shard order, on ``device``
    (default the first part's)."""
    if len(parts) == 1:
        return parts[0] if device is None else to(parts[0], device)
    dev = parts[0].device if device is None else device
    return torch.cat([to(p, dev) for p in parts], dim=dim)


def ppermute(parts: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Shard ``dst`` receives ``parts[src]`` for each ``(src, dst)``, on its
    own device; a shard that receives nothing gets zeros."""
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for src, dst in perm:
        out[dst] = to(parts[src], parts[dst].device)
    return [torch.zeros_like(p) if o is None else o
            for o, p in zip(out, parts)]


def all_to_all(parts: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int) -> List[torch.Tensor]:
    """Tiled all-to-all: split every shard's tensor into ``len(parts)``
    chunks along ``split_axis``; shard ``j`` concatenates chunk ``j`` of
    each shard, in shard order, along ``concat_axis``."""
    n = len(parts)
    chunks = [p.chunk(n, dim=split_axis) for p in parts]
    for p in parts:
        if p.shape[split_axis] % n:
            raise ValueError(
                f"all_to_all: axis {split_axis} of size "
                f"{p.shape[split_axis]} does not split {n} ways")
    return [torch.cat([to(chunks[i][j], parts[j].device) for i in range(n)],
                      dim=concat_axis)
            for j in range(n)]
