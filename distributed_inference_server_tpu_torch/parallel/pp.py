"""Pipeline parallelism: contiguous layer stages over the ``stage`` mesh
axis (port of ``distributed_inference_server_tpu/parallel/pp.py``).

Stage s holds layers [s*L/S, (s+1)*L/S) and, in the paged form, those
layers' slice of every pool (``parallel/tp.py`` ``ShardedPool``). A
forward runs GPipe microbatches of rows: each microbatch's activations hop
from stage to stage (``comm.to`` onto the next stage's device, the JAX
``ppermute``), and every stage writes and reads only its own layers'
pages. The single controller issues microbatch-major, so on distinct
cards stage s works on microbatch m while stage s + 1 works on m - 1 (the
GPipe fill and drain; bubble fraction (S-1)/(M+S-1)). Tensor parallelism
composes inside each stage (``models/llama.py layer_block``).

The engine's serving path is ``llama.paged_forward`` with a
``ShardedParams`` whose ``microbatches`` is ``pp_microbatches``;
``pp_paged_forward`` is that call with the JAX signature's order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.configs import ModelConfig
from distributed_inference_server_tpu_torch.parallel.mesh import Mesh
from distributed_inference_server_tpu_torch.parallel.tp import (
    ShardedParams,
    shard_params,
    split_global,
)


def validate_pp(cfg: ModelConfig, stages: int, batch: int,
                num_microbatches: int) -> None:
    if cfg.num_layers % stages:
        raise ValueError(
            f"{stages} stages do not divide num_layers={cfg.num_layers}")
    if batch % num_microbatches:
        raise ValueError(
            f"{num_microbatches} microbatches do not divide batch={batch}")


def _staged(params, cfg: ModelConfig, mesh: Mesh, M: int) -> ShardedParams:
    sp = params if isinstance(params, ShardedParams) else \
        shard_params(params, mesh, cfg, stage_axis="stage")
    return sp.with_options(microbatches=M)


def pp_forward(mesh: Mesh, params, cfg: ModelConfig, input_ids: torch.Tensor,
               positions: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, write_pos: torch.Tensor,
               kv_valid_len: torch.Tensor, num_microbatches: int = 1,
               impl: str = "plain"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pipeline-parallel forward over a global dense KV cache ([L, B,
    Smax, KV, D], updated IN PLACE through per-stage views): the contract
    of ``llama.forward``. Returns (logits [B, T, V] f32, cache_k,
    cache_v)."""
    S, M = mesh.shape["stage"], num_microbatches
    B = input_ids.shape[0]
    validate_pp(cfg, S, B, M)
    sp = _staged(params, cfg, mesh, M)
    tp = sp.tp
    ks, vs = split_global(cache_k, S, tp, 3), split_global(cache_v, S, tp, 3)
    n = B // M
    outs = []
    for m in range(M):
        r = slice(m * n, (m + 1) * n)
        cache = llama.KVCache([[c[:, r] for c in row] for row in ks],
                              [[c[:, r] for c in row] for row in vs])
        outs.append(llama._dense_trunk(sp, cfg, input_ids[r], positions[r],
                                       cache, write_pos[r], kv_valid_len[r],
                                       impl))
    h = torch.cat(outs) if M > 1 else outs[0]
    return llama._unembed(sp, cfg, h), cache_k, cache_v


def pp_paged_forward(mesh: Mesh, params, cfg: ModelConfig,
                     input_ids: torch.Tensor, positions: torch.Tensor,
                     pool_k, pool_v, write_slots: torch.Tensor,
                     page_tables: torch.Tensor, kv_valid_len: torch.Tensor,
                     num_microbatches: int = 1, page_size: int = 16,
                     logits_idx: Optional[torch.Tensor] = None,
                     impl: str = "kernel"):
    """Pipeline-parallel forward over the paged pools (``ShardedPool``s of
    the mesh, or ``QuantPool`` pairs of them): ``llama.paged_forward``'s
    contract, the layers in ``num_microbatches`` GPipe microbatches.
    Returns (logits, pool_k, pool_v)."""
    validate_pp(cfg, mesh.shape["stage"], input_ids.shape[0],
                num_microbatches)
    sp = _staged(params, cfg, mesh, num_microbatches)
    return llama.paged_forward(sp, cfg, input_ids, positions, pool_k, pool_v,
                               write_slots, page_tables, kv_valid_len,
                               impl=impl, page_size=page_size,
                               logits_idx=logits_idx)


def pp_greedy_generate(mesh: Mesh, params, cfg: ModelConfig,
                       prompt_ids: torch.Tensor, max_new_tokens: int,
                       max_seq: int, num_microbatches: int = 1
                       ) -> torch.Tensor:
    """Greedy generation through the pipeline: prefill, then one decode
    step per token, all over the stage axis. prompt_ids: [B, T0] (no
    padding). Returns [B, max_new_tokens]."""
    B, T0 = prompt_ids.shape
    sp = _staged(params, cfg, mesh, num_microbatches)
    dev = prompt_ids.device
    cache = llama.KVCache.create(cfg, B, max_seq, dtype=sp.dtype, device=dev)
    positions = torch.arange(T0, device=dev)[None].expand(B, T0)
    logits, ck, cv = pp_forward(mesh, sp, cfg, prompt_ids, positions, cache.k,
                                cache.v, positions,
                                torch.full((B,), T0, dtype=torch.int32,
                                           device=dev), num_microbatches)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    outs = [tok]
    for i in range(1, max_new_tokens):
        pos = torch.full((B, 1), T0 + i - 1, dtype=torch.int32, device=dev)
        logits, ck, cv = pp_forward(
            mesh, sp, cfg, tok[:, None], pos, ck, cv, pos,
            torch.full((B,), T0 + i, dtype=torch.int32, device=dev),
            num_microbatches)
        tok = logits[:, 0].argmax(-1).to(torch.int32)
        outs.append(tok)
    return torch.stack(outs, dim=1)
