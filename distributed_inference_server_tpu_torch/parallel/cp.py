"""Context-parallel prefill: long prompts split over the ``seq`` mesh axis
(port of ``distributed_inference_server_tpu/parallel/cp.py``; plain
PyTorch, as the JAX functions are plain ``jnp``).

A long prompt's attention runs sequence-parallel: each ``seq`` shard
holds one chunk of the prompt's queries, keys and values, and attention
is ring attention (``ops/ring_attention.py``: K/V chunks rotating around
the ring) or Ulysses (``ops/ulysses.py``: an all-to-all head scatter).
Composes with tensor parallelism (each tensor shard runs its own heads'
ring) and with pipeline stages (the stage loop of ``models/llama.py``,
the ring inside every stage's layers: the JAX package's ``cp_pp_prefill``
had to fuse both axes into one ``shard_map``; a single controller issues
them in order as they are).

The layers' projections and MLPs run over the whole prompt on each tensor
shard; the ``seq`` axis splits attention, the only part whose cost grows
with the square of the prompt. The paged form writes every position's
K/V straight into the pool pages (``write_slots``), so decode continues
from them like any other sequence, through the decode kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.configs import ModelConfig
from distributed_inference_server_tpu_torch.ops.ring_attention import (
    ring_attention,
)
from distributed_inference_server_tpu_torch.ops.ulysses import (
    ulysses_attention,
)
from distributed_inference_server_tpu_torch.parallel import comm
from distributed_inference_server_tpu_torch.parallel.mesh import Mesh
from distributed_inference_server_tpu_torch.parallel.tp import (
    ShardedParams,
    shard_params,
)

SP_IMPLS = ("ring", "ulysses")


def _sharded(params, cfg: ModelConfig, mesh: Mesh):
    """``params`` as the mesh's shards (a plain tree is cut here)."""
    if isinstance(params, ShardedParams):
        return params
    return shard_params(params, mesh, cfg)


def _prompt_positions(input_ids: torch.Tensor, valid_len: torch.Tensor,
                      seq: int) -> torch.Tensor:
    B, T = input_ids.shape
    if T % seq:
        raise ValueError(f"prompt buffer {T} not divisible by seq axis {seq}")
    pos = torch.arange(T, dtype=torch.int32,
                       device=input_ids.device)[None].expand(B, T)
    return torch.where(pos < valid_len[:, None].to(pos.device), pos,
                       torch.full_like(pos, -1))


def _sp_attend(mesh: Mesh, positions: torch.Tensor, valid_len: torch.Tensor,
               sp_impl: str, softcap):
    """The attend of one layer over this step's own q/k/v: the sequence
    cut into the ``seq`` axis's chunks, attended by ``sp_impl``."""
    if sp_impl not in SP_IMPLS:
        raise ValueError(f"sp_impl must be 'ring' or 'ulysses', got "
                         f"{sp_impl!r}")
    R = mesh.shape["seq"]

    def attend(q, k, v, window):
        w = window if window and window > 0 else None
        pos = comm.to(positions, q.device)
        qc, kc, vc = (list(x.chunk(R, dim=1)) for x in (q, k, v))
        pc = list(pos.chunk(R, dim=1))
        if sp_impl == "ring":
            out = ring_attention(qc, kc, vc, pc, pc, w, softcap)
        else:
            out = ulysses_attention(qc, kc, vc, pc,
                                    [comm.to(valid_len, q.device)] * R, w,
                                    softcap)
        return torch.cat(out, dim=1)

    return attend


def _last_logits(params, cfg, h, valid_len):
    rows = torch.arange(h.shape[0], device=h.device)
    last = h[rows, (comm.to(valid_len, h.device).long() - 1)][:, None]
    return llama._unembed(params, cfg, last)[:, 0]


def _gather_cache(parts) -> torch.Tensor:
    """A global [L, B, T, KV, D] cache from ``[stage][tensor]`` parts."""
    dev = parts[0][0].device
    return torch.cat([comm.all_gather(row, dim=3, device=dev)
                      for row in parts], dim=0)


def cp_prefill(params, cfg: ModelConfig, mesh: Mesh, input_ids: torch.Tensor,
               valid_len: torch.Tensor, sp_impl: str = "ring",
               impl: str = "plain", num_microbatches: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Context-parallel prefill of a right-padded batch of prompts.

    input_ids: [B, T] (T divisible by the ``seq`` axis); valid_len: [B].
    Returns (last_logits [B, V] f32, k, v) with k, v global [L, B, T, KV,
    D] caches, slot == position (padding slots zero). On a ``stage`` mesh
    the layers run stage by stage in ``num_microbatches`` microbatches of
    rows (the JAX package's ``cp_pp_prefill``)."""
    sp = _sharded(params, cfg, mesh)
    B, T = input_ids.shape
    if B % num_microbatches:
        raise ValueError(f"{num_microbatches} microbatches do not divide "
                         f"batch={B}")
    positions = _prompt_positions(input_ids, valid_len, mesh.shape["seq"])
    write_pos = torch.where(positions >= 0, positions,
                            torch.full_like(positions, T))
    cache = llama.dense_caches(sp, cfg, B, T, sp.dtype)
    n = B // num_microbatches
    logits = []
    for m in range(num_microbatches):
        r = slice(m * n, (m + 1) * n)
        ck = [[c[:, r] for c in row] for row in cache.k]
        cv = [[c[:, r] for c in row] for row in cache.v]

        def write_fn(pool, l, new, wp=write_pos[r]):
            return llama._write_kv(pool, l, new, comm.to(wp, pool.device))

        h = llama._run_layers(
            sp, cfg, input_ids[r], positions[r], ck, cv, write_pos[r],
            _sp_attend(mesh, positions[r], valid_len[r], sp_impl,
                       cfg.attn_logit_softcap),
            impl, write_fn=write_fn, attend_new=True,
            valid_tokens=positions[r] >= 0)
        logits.append(_last_logits(sp, cfg, h, valid_len[r]))
    return torch.cat(logits), _gather_cache(cache.k), _gather_cache(cache.v)


def cp_pp_prefill(params, cfg: ModelConfig, mesh: Mesh,
                  input_ids: torch.Tensor, valid_len: torch.Tensor,
                  num_microbatches: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ring-attention prefill on a ``seq`` x ``stage`` mesh: ``cp_prefill``
    with the ring inside every stage's layers."""
    if cfg.num_layers % mesh.shape["stage"]:
        raise ValueError(f"{mesh.shape['stage']} stages do not divide "
                         f"num_layers={cfg.num_layers}")
    return cp_prefill(params, cfg, mesh, input_ids, valid_len, "ring",
                      num_microbatches=num_microbatches)


def cp_paged_prefill(params, cfg: ModelConfig, mesh: Mesh,
                     input_ids: torch.Tensor, valid_len: torch.Tensor,
                     pool_k, pool_v, write_slots: torch.Tensor,
                     sp_impl: str = "ring", impl: str = "kernel"
                     ) -> Tuple[torch.Tensor, object, object]:
    """Sequence-parallel prefill that lands in the paged pool: every
    position's K/V is written into the pools at ``write_slots`` ([B, T]
    flat slots; >= num_slots drops: padding) as the layers run — int8
    ``QuantPool`` pools quantize at the write — and attention runs
    ``sp_impl`` over the ``seq`` axis. After it, the prompt decodes from
    its pages like any other sequence.

    Returns (last_logits [B, V] f32, pool_k, pool_v), pools updated IN
    PLACE."""
    sp = _sharded(params, cfg, mesh) if mesh.shape["tensor"] * \
        mesh.shape["stage"] * mesh.shape["expert"] > 1 else params
    positions = _prompt_positions(input_ids, valid_len, mesh.shape["seq"])
    h = llama._run_layers(
        sp, cfg, input_ids, positions, pool_k, pool_v, write_slots,
        _sp_attend(mesh, positions, valid_len, sp_impl,
                   cfg.attn_logit_softcap),
        impl, attend_new=True, valid_tokens=positions >= 0)
    return _last_logits(sp, cfg, h, valid_len), pool_k, pool_v


def cp_paged_prefill_any(params, cfg: ModelConfig, mesh: Mesh,
                         input_ids: torch.Tensor, valid_len: torch.Tensor,
                         pool_k, pool_v, write_slots: torch.Tensor,
                         sp_impl: str = "ring", impl: str = "kernel"
                         ) -> Tuple[torch.Tensor, object, object]:
    """``cp_paged_prefill`` on any mesh with a ``seq`` axis: on a ``stage``
    mesh only the ring composes with the stage loop (the JAX package's
    rule: Ulysses is seq-only)."""
    if mesh.shape["stage"] > 1 and sp_impl != "ring":
        raise ValueError(
            "sequence parallelism on a stage mesh supports sp_impl='ring' "
            "only (ulysses is seq-only)")
    return cp_paged_prefill(params, cfg, mesh, input_ids, valid_len, pool_k,
                            pool_v, write_slots, sp_impl, impl)


def cp_shardings(mesh: Mesh):
    """(ids, valid) layouts of ``cp_prefill``'s inputs: ids rows on
    ``data``, sequence on ``seq``; valid lengths rows on ``data``."""
    return ("data", "seq"), ("data",)
