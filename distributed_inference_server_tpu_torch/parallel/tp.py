"""Tensor parallelism for the Llama family: the sharding rules, the
per-shard parameter trees and the per-shard KV pools (port of
``distributed_inference_server_tpu/parallel/tp.py``).

Megatron's layout, as the JAX package's ``llama_param_specs``:

- ``wq`` / ``wk`` / ``wv`` (and the ``bq`` / ``bk`` / ``bv`` biases),
  ``w_gate`` / ``w_up``: column-parallel — output features split on
  ``tensor``; each shard computes its own heads' q/k/v and its slice of
  the MLP intermediate.
- ``wo`` / ``w_down``: row-parallel — input features split; the shards'
  partial sums meet in ``comm.all_reduce``.
- Norms (Gemma-2's sandwich norms too): replicated, computed once.
- Unembedding: vocab-parallel — ``lm_head`` [H, V] split on V, or for
  tied models ``embed`` [V, H] split on V (the lookup is then masked per
  shard and the shards' rows meet in ``all_reduce``). Each shard projects
  its vocab slice; the logits are gathered in shard order.
- MoE experts [L, E, in, out]: E split on ``expert``, features on
  ``tensor`` as above; the router is replicated.
- The stacked layer axis splits on ``stage`` under pipeline parallelism.
- ``Q8Tensor`` / ``Q4Tensor`` codes and scales split with the same rule;
  a row-parallel weight's group size must divide its per-shard input
  rows (the shape gate the JAX engine's quantized TP layout needs).

The JAX package annotates one global array per leaf and lets XLA lay it
out; here ``shard_params`` cuts a port tree into per-shard trees, each
placed on its slot's device and made contiguous, so every shard's kernels
see plain tensors at its own shapes. ``ShardedPool`` is the paged KV pool
the same way: one contiguous ``[L/S, slots + 1, KV/tp, D]`` pool per
(stage, tensor) shard, and a global view (heads concatenated in shard
order, layers in stage order) for the byte paths.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

import torch

from distributed_inference_server_tpu_torch.models.configs import ModelConfig
from distributed_inference_server_tpu_torch.ops.quant import (
    Q4Tensor,
    QuantPool,
    is_quantized,
)
from distributed_inference_server_tpu_torch.parallel.mesh import Mesh

Spec = Tuple[Optional[str], ...]


def validate_tp(cfg: ModelConfig, tp: int) -> None:
    if tp <= 0:
        raise ValueError(f"tensor parallel size must be positive, got {tp}")
    for dim_name, dim in (
        ("num_kv_heads", cfg.num_kv_heads),
        ("num_heads", cfg.num_heads),
        ("intermediate_size", cfg.intermediate_size),
    ):
        if dim % tp:
            raise ValueError(
                f"tensor parallel size {tp} does not divide {dim_name}={dim}")


def llama_param_specs(cfg: ModelConfig,
                      stage_axis: Optional[str] = None) -> Dict[str, Any]:
    """The spec tree matching ``llama.param_shapes``: one axis name (or
    None) per dimension of each leaf, the JAX ``PartitionSpec``s as
    tuples."""
    st = stage_axis
    layers: Dict[str, Spec] = {
        "attn_norm": (st, None),
        "wq": (st, None, "tensor"),
        "wk": (st, None, "tensor"),
        "wv": (st, None, "tensor"),
        "wo": (st, "tensor", None),
        "mlp_norm": (st, None),
    }
    if cfg.sandwich_norms:
        layers.update(post_attn_norm=(st, None), post_mlp_norm=(st, None))
    if cfg.attention_bias:
        layers.update(bq=(st, "tensor"), bk=(st, "tensor"), bv=(st, "tensor"))
    if cfg.is_moe:
        layers.update(
            router=(st, None, None),
            w_gate=(st, "expert", None, "tensor"),
            w_up=(st, "expert", None, "tensor"),
            w_down=(st, "expert", "tensor", None),
        )
    else:
        layers.update(
            w_gate=(st, None, "tensor"),
            w_up=(st, None, "tensor"),
            w_down=(st, "tensor", None),
        )
    specs: Dict[str, Any] = {
        "embed": ("tensor", None) if cfg.tie_word_embeddings else (None, None),
        "layers": layers,
        "final_norm": (None,),
    }
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, "tensor")
    return specs


def kv_pool_spec(stage_axis: Optional[str] = None) -> Spec:
    """Paged KV pool [L, num_slots, KV, D]: KV heads on ``tensor``; layers
    on ``stage_axis`` under pipeline parallelism."""
    return (stage_axis, None, "tensor", None)


def _bounds(n: int, parts: int, i: int) -> Tuple[int, int]:
    """Piece ``i`` of ``n`` split ``parts`` ways (array_split's split:
    the first ``n % parts`` pieces one longer)."""
    base, rem = divmod(n, parts)
    lo = i * base + min(i, rem)
    return lo, lo + base + (1 if i < rem else 0)


def _cut(t: torch.Tensor, spec: Spec, coord: Dict[str, int],
         sizes: Dict[str, int], uneven: bool = False) -> torch.Tensor:
    """The piece of ``t`` at mesh coordinate ``coord`` under ``spec`` (a
    view). Only a vocabulary split (``uneven``) may leave pieces of
    different sizes."""
    for dim, ax in enumerate(spec):
        if ax is None or sizes[ax] == 1:
            continue
        n = t.shape[dim]
        if n % sizes[ax] and not uneven:
            raise ValueError(f"{ax} axis {sizes[ax]} does not divide "
                             f"dimension {dim} ({n})")
        lo, hi = _bounds(n, sizes[ax], coord[ax])
        t = t.narrow(dim, lo, hi - lo)
    return t


def _cut_leaf(name: str, leaf: Any, spec: Spec, coord: Dict[str, int],
              sizes: Dict[str, int]) -> Any:
    if not is_quantized(leaf):
        return _cut(leaf, spec, coord, sizes,
                    uneven=name in ("embed", "lm_head"))
    # codes [..., in(/2), out] and scales [..., in/G, out] share the spec;
    # a split input axis (row-parallel) needs whole groups per shard
    spec = tuple(spec) + (None,) * (leaf.q.ndim - len(spec))
    rows_ax = spec[-2]
    if rows_ax is not None and sizes[rows_ax] > 1:
        n_in = leaf.q.shape[-2] * (2 if isinstance(leaf, Q4Tensor) else 1)
        groups = leaf.s.shape[-2]
        g = n_in // groups
        per = n_in // sizes[rows_ax]
        if n_in % sizes[rows_ax] or per % g:
            raise ValueError(
                f"{name}: quantization group {g} does not divide the "
                f"per-shard input rows {n_in}/{sizes[rows_ax]}")
    return type(leaf)(_cut(leaf.q, spec, coord, sizes),
                      _cut(leaf.s, spec, coord, sizes))


def _place(x: Any, device: torch.device, cache: Dict[Tuple[int, str], Any]
           ) -> Any:
    """A contiguous copy of piece ``x`` on ``device``, made once: pieces
    that are the same view (a replicated leaf) on one device share it."""
    if is_quantized(x):
        return type(x)(_place(x.q, device, cache), _place(x.s, device, cache))
    key = (x.data_ptr(), x.storage_offset(), tuple(x.shape),
           tuple(x.stride()), x.dtype, str(device))
    got = cache.get(key)
    if got is None:
        got = cache[key] = x.to(device).contiguous()
    return got


@dataclass
class ShardedParams:
    """A port parameter tree cut for a mesh: ``trees[(stage, expert,
    tensor)]`` is the shard's own tree, on the device of mesh slot
    (data 0, tensor, expert, stage, seq 0), with the keys of
    ``llama.param_shapes`` plus ``unembed_f32`` (its vocab slice of the
    f32 unembedding, [V_t, H]) and ``vocab`` (that slice's (lo, hi)).

    ``microbatches`` (GPipe, stage meshes), ``moe_impl`` ("dense" or
    "ep", the capacity-based expert-parallel dispatch) and
    ``moe_capacity_factor`` are how the engine asks the forward to run."""

    mesh: Mesh
    cfg: ModelConfig
    trees: Dict[Tuple[int, int, int], Dict[str, Any]]
    microbatches: int = 1
    moe_impl: str = "dense"
    moe_capacity_factor: float = 1.25

    @property
    def tp(self) -> int:
        return self.mesh.shape["tensor"]

    @property
    def pp(self) -> int:
        return self.mesh.shape["stage"]

    @property
    def ep(self) -> int:
        return self.mesh.shape["expert"]

    def tree(self, stage: int = 0, expert: int = 0, tensor: int = 0
             ) -> Dict[str, Any]:
        return self.trees[(stage, expert, tensor)]

    def stage_trees(self, stage: int) -> List[Dict[str, Any]]:
        """The tensor shards of one stage (expert 0), in shard order."""
        return [self.trees[(stage, 0, t)] for t in range(self.tp)]

    @property
    def device(self) -> torch.device:
        return self.mesh.primary

    @property
    def dtype(self) -> torch.dtype:
        return self.tree()["embed"].dtype

    def with_options(self, **kw) -> "ShardedParams":
        return replace(self, **kw)


def shard_params(params: Dict[str, Any], mesh: Mesh, cfg: ModelConfig,
                 stage_axis: Optional[str] = None) -> ShardedParams:
    """Cut ``params`` (a ``llama.init_params`` / loader tree, dense or
    quantized) into per-shard trees on ``mesh`` per the TP layout (the
    layer axis on ``stage`` when ``stage_axis`` is given or the mesh has a
    stage axis). Pieces are contiguous copies on their slot's device; a
    replicated leaf is one tensor per device."""
    sizes = dict(mesh.shape)
    validate_tp(cfg, sizes["tensor"])
    if cfg.num_layers % sizes["stage"]:
        raise ValueError(f"{sizes['stage']} stages do not divide "
                         f"num_layers={cfg.num_layers}")
    if cfg.is_moe and cfg.num_experts % sizes["expert"]:
        raise ValueError(f"expert axis {sizes['expert']} does not divide "
                         f"num_experts={cfg.num_experts}")
    st = "stage" if (stage_axis or sizes["stage"] > 1) else None
    specs = llama_param_specs(cfg, stage_axis=st)
    unembed = (params["embed"] if cfg.tie_word_embeddings
               else params["lm_head"].t())
    u_spec: Spec = ("tensor", None)
    cache: Dict[Tuple, Any] = {}
    trees: Dict[Tuple[int, int, int], Dict[str, Any]] = {}
    V = cfg.vocab_size
    for s in range(sizes["stage"]):
        for e in range(sizes["expert"]):
            for t in range(sizes["tensor"]):
                coord = {"data": 0, "tensor": t, "expert": e, "stage": s,
                         "seq": 0}
                dev = mesh.device(tensor=t, expert=e, stage=s)

                def piece(name, leaf, spec):
                    return _place(_cut_leaf(name, leaf, spec, coord, sizes),
                                  dev, cache)

                tree: Dict[str, Any] = {
                    "layers": {n: piece(n, params["layers"][n], sp)
                               for n, sp in specs["layers"].items()},
                    "embed": piece("embed", params["embed"], specs["embed"]),
                    "final_norm": piece("final_norm", params["final_norm"],
                                        specs["final_norm"]),
                }
                if "lm_head" in specs:
                    tree["lm_head"] = piece("lm_head", params["lm_head"],
                                            specs["lm_head"])
                tree["vocab"] = _bounds(V, sizes["tensor"], t)
                u = _cut(unembed, u_spec, coord, sizes, uneven=True)
                tree["unembed_f32"] = _place(u.float(), dev, cache)
                trees[(s, e, t)] = tree
    return ShardedParams(mesh=mesh, cfg=cfg, trees=trees,
                         moe_capacity_factor=cfg.moe_capacity_factor)


# ---------------------------------------------------------------------------
# Per-shard KV pools
# ---------------------------------------------------------------------------


class ShardedPool:
    """One pool member (K or V codes, or their int8 scales) cut over the
    mesh: ``parts[stage][tensor]`` are contiguous ``[L/S, slots + 1,
    KV/tp, ...]`` tensors on their shard's device.

    The byte paths (handoff payloads, prefix export and import, the host
    tier, the latent calibration) see the GLOBAL pool through the few
    tensor methods they call — ``index_select`` / ``index_copy_`` on the
    slot axis, ``dtype``, ``shape``, ``device``, ``element_size``,
    ``zero_`` and slicing — with heads concatenated in shard order and
    layers in stage order, so a sharded engine moves the unsharded
    engine's bytes."""

    __slots__ = ("parts", "device")

    def __init__(self, parts: List[List[torch.Tensor]],
                 device: torch.device):
        self.parts = parts
        self.device = device

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0][0].dtype

    @property
    def shape(self) -> torch.Size:
        p = self.parts[0][0]
        return torch.Size((p.shape[0] * len(self.parts), p.shape[1],
                           p.shape[2] * len(self.parts[0]), *p.shape[3:]))

    @property
    def ndim(self) -> int:
        return self.parts[0][0].ndim

    def element_size(self) -> int:
        return self.parts[0][0].element_size()

    def stage(self, s: int) -> List[torch.Tensor]:
        return self.parts[s]

    def index_select(self, dim: int, index: torch.Tensor) -> torch.Tensor:
        if dim != 1:
            raise ValueError("a sharded pool selects on its slot axis only")
        return torch.cat([
            torch.cat([p.index_select(1, index.to(p.device)).to(self.device)
                       for p in row], dim=2)
            for row in self.parts], dim=0)

    def index_copy_(self, dim: int, index: torch.Tensor,
                    src: torch.Tensor) -> "ShardedPool":
        if dim != 1:
            raise ValueError("a sharded pool writes on its slot axis only")
        L = self.parts[0][0].shape[0]
        kv = self.parts[0][0].shape[2]
        for s, row in enumerate(self.parts):
            for t, p in enumerate(row):
                piece = src[s * L:(s + 1) * L, :, t * kv:(t + 1) * kv]
                p.index_copy_(1, index.to(p.device), piece.to(p.device))
        return self

    def full(self) -> torch.Tensor:
        """The global pool, materialized on ``device``."""
        return torch.cat([torch.cat([p.to(self.device) for p in row], dim=2)
                          for row in self.parts], dim=0)

    def __getitem__(self, idx) -> torch.Tensor:
        return self.full()[idx]

    def zero_(self) -> "ShardedPool":
        for row in self.parts:
            for p in row:
                p.zero_()
        return self


def pool_shards(pool: Any, stage: int) -> List[Any]:
    """One stage's per-tensor-shard pools: tensors, or ``QuantPool`` pairs
    of a sharded ``QuantPool``'s codes and scales."""
    if isinstance(pool, QuantPool):
        return [QuantPool(d, s) for d, s in zip(pool.data.stage(stage),
                                                 pool.scale.stage(stage))]
    return pool.stage(stage)


def make_sharded_pools(mesh: Mesh, cfg: ModelConfig, num_slots: int,
                       dtype: torch.dtype, kv_quant: str = "none"
                       ) -> Tuple[Any, Any]:
    """The (K, V) paged pools of one model on ``mesh``: per (stage, tensor)
    shard ``[L/S, num_slots + 1, KV/tp, D]`` (the drop slot included), or
    ``QuantPool`` pairs of sharded int8 codes and f32 scales."""
    S, tp = mesh.shape["stage"], mesh.shape["tensor"]
    L, kv = cfg.num_layers // S, cfg.num_kv_heads // tp

    def member(shape_tail, dt):
        return ShardedPool(
            [[torch.zeros((L, num_slots + 1, kv, *shape_tail), dtype=dt,
                          device=mesh.device(tensor=t, stage=s))
              for t in range(tp)] for s in range(S)], mesh.primary)

    def pool():
        if kv_quant == "int8":
            return QuantPool(member((cfg.head_dim,), torch.int8),
                             member((), torch.float32))
        if kv_quant != "none":
            raise ValueError(
                f"unknown kv_quant {kv_quant!r}; known: none|int8")
        return member((cfg.head_dim,), dtype)

    return pool(), pool()


def split_global(t: torch.Tensor, stages: int, tp: int,
                 head_axis: int = 2) -> List[List[torch.Tensor]]:
    """Views of a global [L, ..., KV, ...] cache per (stage, tensor) shard:
    layers split on axis 0, heads on ``head_axis`` (dense caches and
    tests; the engine's pools are ``ShardedPool``s)."""
    L, KV = t.shape[0], t.shape[head_axis]
    return [[t[s * L // stages:(s + 1) * L // stages].narrow(
        head_axis, i * KV // tp, KV // tp) for i in range(tp)]
        for s in range(stages)]
