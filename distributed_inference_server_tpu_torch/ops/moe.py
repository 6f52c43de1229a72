"""Capacity-based MoE dispatch over the ``expert`` mesh axis (port of
``distributed_inference_server_tpu/ops/moe.py``), and the top-k routing
that every MoE path shares.

Tokens are routed into fixed-capacity per-expert buffers by one-hot
dispatch and combine tensors (GShard / Switch), so the layer's shapes are
static. Each expert shard computes its own experts' buffers (and under
tensor parallelism each tensor shard its slice of their intermediate,
the row-parallel ``w_down`` partials meeting in ``comm.all_reduce``); the
buffers reach the shards and come back through the all-to-all boundary
(``comm.to`` per shard, concatenated in shard order).

Capacity: each expert takes at most C tokens per step; assignments past C
are dropped (the token keeps its residual stream). Choice-major priority:
every token's first choice is buffered before any token's second choice,
FIFO within a choice — the JAX package's order, so both drop the same
assignments. The engine raises the capacity factor to E/k, which keeps
every assignment (serving is dropless).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from distributed_inference_server_tpu_torch.ops.kernels.quant_matmul import (
    quant_matmul,
    quant_matmul_plain,
)
from distributed_inference_server_tpu_torch.ops.quant import is_quantized
from distributed_inference_server_tpu_torch.parallel import comm


def moe_route(router_logits: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` routing of f32 logits [N, E]: (softmax weights over the k
    chosen experts [N, k], their ids [N, k]), largest first and, among
    equal logits, the lower expert id first — ``lax.top_k``'s order (a
    stable descending sort keeps equal logits in id order; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(router_logits, dim=-1, descending=True,
                           stable=True)
    return torch.softmax(vals[:, :k], dim=-1), idx[:, :k]


def expert_capacity(num_tokens: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
    """Static per-expert buffer size: ceil(tokens * k / E) * factor,
    floored at k so a single-token batch always fits."""
    base = -(-num_tokens * k // num_experts)
    return max(k, int(base * capacity_factor))


def dispatch_plan(router_logits: torch.Tensor, num_experts: int, k: int,
                  capacity: int, valid_tokens: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch [N, E, C] 0/1, combine [N, E, C] routing weights) of f32
    router logits [N, E]: choice-major queue positions, assignments at or
    past ``capacity`` dropped, rows with ``valid_tokens`` False routed
    nowhere."""
    N, E, C = router_logits.shape[0], num_experts, capacity
    gates, top_idx = moe_route(router_logits, k)  # [N, k]
    onehot = F.one_hot(top_idx, E).to(torch.int32)  # [N, k, E]
    if valid_tokens is not None:
        onehot = onehot * valid_tokens.reshape(N, 1, 1).to(torch.int32)
    flat = onehot.transpose(0, 1).reshape(k * N, E)  # [kN, E]
    pos = torch.cumsum(flat, dim=0) - flat  # rank within expert queue
    keep = (pos < C) & (flat > 0)
    slot = F.one_hot(pos.clamp(0, C - 1).long(), C).float()
    d_flat = keep[..., None].float() * slot  # [kN, E, C]
    dispatch = d_flat.reshape(k, N, E, C).sum(0)
    combine = (gates.t().reshape(k * N, 1, 1) * d_flat).reshape(
        k, N, E, C).sum(0)
    return dispatch, combine


def _expert_mm(x: torch.Tensor, w, impl: str) -> torch.Tensor:
    """[E, C, in] x [E, in, out] per expert: a quantized weight's experts
    through the group-dequant matmul one by one (``quant_matmul`` on the
    kernel path), a dense stack as one batched product."""
    if is_quantized(w):
        mm = quant_matmul if impl == "kernel" else quant_matmul_plain
        return torch.stack([mm(x[e], type(w)(w.q[e], w.s[e]))
                            for e in range(x.shape[0])])
    return torch.bmm(x, w)


def _experts(expert_in: torch.Tensor, layer: Dict[str, object],
             impl: str) -> torch.Tensor:
    """SwiGLU of each expert over its buffer [E, C, H]."""
    gate = F.silu(_expert_mm(expert_in, layer["w_gate"], impl))
    up = _expert_mm(expert_in, layer["w_up"], impl)
    return _expert_mm(gate * up, layer["w_down"], impl)


def moe_mlp_ep(
    x: torch.Tensor,
    layer: Dict[str, object],
    num_experts: int,
    num_experts_per_tok: int,
    *,
    capacity: int,
    valid_tokens: Optional[torch.Tensor] = None,
    expert_shards: Optional[Sequence[Sequence[Dict[str, object]]]] = None,
    impl: str = "plain",
) -> torch.Tensor:
    """Sparse-dispatch SwiGLU MoE.

    x: [B, T, H]. ``layer``: one layer's ``router`` [H, E] and, without
    ``expert_shards``, its expert stacks ``w_gate`` / ``w_up`` [E, H, I]
    and ``w_down`` [E, I, H] (dense, ``Q8Tensor`` or ``Q4Tensor``).
    ``expert_shards[e][t]``: the expert stacks of expert shard ``e`` and
    tensor shard ``t`` ([E/ep, H, I/tp], [E/ep, I/tp, H]), each on its
    shard's device. ``valid_tokens``: [B, T] bool; False rows consume no
    capacity and come out zero.

    Returns [B, T, H]: the dense path's math (softmax over the top-k
    logits) wherever nothing is dropped."""
    B, T, H = x.shape
    E, k, C = num_experts, num_experts_per_tok, capacity
    xf = x.reshape(B * T, H)
    logits = (xf @ layer["router"]).float()  # [N, E]
    dispatch, combine = dispatch_plan(logits, E, k, C, valid_tokens)
    expert_in = torch.einsum("nec,nh->ech", dispatch.to(x.dtype), xf)
    shards = expert_shards or [[layer]]
    per = E // len(shards)
    outs: List[torch.Tensor] = []
    for e, tensor_shards in enumerate(shards):
        part = expert_in[e * per:(e + 1) * per]
        partials = [
            _experts(comm.to(part, ts["w_up"].s.device
                             if is_quantized(ts["w_up"])
                             else ts["w_up"].device), ts, impl)
            for ts in tensor_shards]
        outs.append(comm.all_reduce(partials, x.device))
    expert_out = comm.all_gather(outs, dim=0)  # [E, C, H]
    out = torch.einsum("ech,nec->nh", expert_out,
                       combine.to(expert_out.dtype))
    return out.reshape(B, T, H)
