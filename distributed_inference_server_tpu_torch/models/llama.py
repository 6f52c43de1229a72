"""Llama-family transformer over the paged KV pool, in PyTorch (port of
``distributed_inference_server_tpu/models/llama.py``: ``init_params``, the
paged write, the layer block, ``gather_kv_window``, ``paged_forward``,
``ragged_paged_forward``, ``_mlp``, ``_moe_mlp`` and ``_unembed``; the
unpaged ``forward`` over the dense ``KVCache`` that ``models/generate.py``
and the checkpoint parity tests call; and ``hidden_states``).

- Parameters are a dict of **stacked** per-layer tensors (leading axis =
  layer), linear weights stored [in, out] so the hot path is ``x @ W`` —
  the same tree as the JAX package, so conversion is one-to-one
  (``models/convert.py``).
- The forward pass is a Python loop over layers; each layer writes its new
  K/V into the pool first, then attends.
- ``impl="kernel"`` runs RMSNorm, RoPE and paged attention through the
  hand-written kernels' wrappers (``ops/kernels``; on a CPU tensor they run
  their plain versions). ``impl="plain"`` is the reference path: plain
  RMSNorm and RoPE, and attention over a dense window gathered from the
  pool (``gather_kv_window`` + ``ops/attention.gqa_attention``), as the JAX
  package's ``attention_impl="xla"``.
- Page tables replace the JAX signature's ``gather_slots``: every row of
  those is ``table[p] * page_size + offset`` by the engine's construction
  (the contract ``paged_forward`` documents there), so the [B, P] tables
  carry the same information without a [B, S_max] slot array.
- Quantized serving: linear weights may be ``Q8Tensor`` / ``Q4Tensor``
  (``ops/quant.py``); ``_mm`` runs them through the group-dequant matmul
  kernel (``impl="kernel"``) or its plain version. The pools may be int8
  ``QuantPool`` pairs: the write quantizes the new K/V, decode reads the
  codes through the int8 decode kernel, and a prefill chunk gathers,
  dequantizes and runs ``gqa_attention`` — the JAX package's own path for
  quantized prefill, which has no int8 prefill kernel. The ragged mixed
  step over int8 pools likewise gathers each row's window, dequantizes it
  and runs ``ragged_gqa_attention`` (the JAX package has no int8 ragged
  kernel either).

Every family the JAX package serves on one device: dense Llama, Mistral
(a sliding window), Qwen2 (q/k/v bias), Gemma-2 (GeGLU, sandwich norms,
the embedding and query scalings, attention and final-logit soft-caps,
alternating local / global layers; its unit-offset norms are folded at
load) and Mixtral (``_moe_mlp``: top-k routing, every expert computed on
every token, as the JAX engine's single-device ``moe_impl="dense"``). The
scalings round as the JAX package does: each factor is taken in the
activations' dtype before it multiplies them.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from distributed_inference_server_tpu_torch.models.configs import ModelConfig
from distributed_inference_server_tpu_torch.ops.attention import (
    gqa_attention,
    ragged_gqa_attention,
)
from distributed_inference_server_tpu_torch.ops.kernels.paged_attention import (
    paged_decode,
    paged_prefill,
    paged_ragged,
)
from distributed_inference_server_tpu_torch.ops.kernels.quant_matmul import (
    quant_matmul,
    quant_matmul_plain,
)
from distributed_inference_server_tpu_torch.ops.moe import (
    expert_capacity,
    moe_mlp_ep,
    moe_route,
)
from distributed_inference_server_tpu_torch.ops.norms import rms_norm
from distributed_inference_server_tpu_torch.ops.quant import (
    QuantPool,
    dequantize_kv,
    expert_weight,
    is_quantized,
    layer_weight,
    quantize_kv,
)
from distributed_inference_server_tpu_torch.ops.rotary import (
    apply_rope,
    rope_frequencies,
)
from distributed_inference_server_tpu_torch.parallel import comm
from distributed_inference_server_tpu_torch.parallel.tp import (
    ShardedParams,
    ShardedPool,
    pool_shards,
)

Params = Dict[str, object]
IMPLS = ("kernel", "plain")
# packed tokens per ragged_gqa_attention call over int8 pools: each token
# copies its row's whole dequantized window, so chunks bound that memory
_RAGGED_TOKEN_CHUNK = 128


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> Dict[str, object]:
    """The parameter tree's leaf shapes, keyed as the JAX package's
    ``init_params`` keys them: ``layers`` (stacked per layer: the q/k/v
    biases under ``attention_bias``, the post-attention and post-MLP norms
    under ``sandwich_norms``, the router [L, H, E] and expert stacks
    [L, E, in, out] under ``is_moe``), ``embed``, ``final_norm`` and, for
    an untied head, ``lm_head`` [H, V]."""
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    layers = {
        "attn_norm": (L, H),
        "wq": (L, H, cfg.q_size),
        "wk": (L, H, cfg.kv_size),
        "wv": (L, H, cfg.kv_size),
        "wo": (L, cfg.q_size, H),
        "mlp_norm": (L, H),
    }
    if cfg.sandwich_norms:
        layers.update(post_attn_norm=(L, H), post_mlp_norm=(L, H))
    if cfg.attention_bias:
        layers.update(bq=(L, cfg.q_size), bk=(L, cfg.kv_size),
                      bv=(L, cfg.kv_size))
    E = cfg.num_experts
    if cfg.is_moe:
        layers.update(router=(L, H, E), w_gate=(L, E, H, I),
                      w_up=(L, E, H, I), w_down=(L, E, I, H))
    else:
        layers.update(w_gate=(L, H, I), w_up=(L, H, I), w_down=(L, I, H))
    shapes: Dict[str, object] = {"layers": layers,
                                 "embed": (cfg.vocab_size, H),
                                 "final_norm": (H,)}
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (H, cfg.vocab_size)
    return shapes


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> Params:
    """Random parameters with HF-compatible shapes (``param_shapes``),
    drawn leaf by leaf in the tree's order by ``random_leaf``."""
    def leaf(name, shape):
        return random_leaf(name, shape, generator, dtype, device)

    return {k: ({n: leaf(n, sh) for n, sh in v.items()}
                if isinstance(v, dict) else leaf(k, v))
            for k, v in param_shapes(cfg).items()}


def random_leaf(name: str, shape, generator: torch.Generator,
                dtype: torch.dtype, device) -> torch.Tensor:
    """One random parameter: ones for a norm, else normal(0, 0.02) drawn
    in f32 from ``generator`` (which must live on ``device``) and cast to
    ``dtype``."""
    if name.endswith("norm"):
        return torch.ones(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * 0.02).to(dtype)


def unembed_weight_f32(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The unembedding as f32 [V, H]: the logits are an f32 product
    (``_unembed``), so a caller that unembeds every step keeps this copy
    under ``params["unembed_f32"]`` instead of upcasting per call."""
    w = params["embed"] if cfg.tie_word_embeddings else params["lm_head"].t()
    return w.float().contiguous()


# ---------------------------------------------------------------------------
# Paged pool access
# ---------------------------------------------------------------------------


def make_paged_write_fn(write_slots: torch.Tensor, num_slots: int,
                        kv_quantized: bool = False):
    """Write_fn for the paged pool: ``write_fn(pool, l, new)`` copies the
    new tokens' K or V ([B, T, KV, D]) into layer ``l`` at ``write_slots``
    ([B, T] flat slots), IN PLACE, and returns the pool.

    The pools are [L, num_slots + 1, KV, D]: slot ``num_slots`` is a drop
    slot that no reader ever sees. A write whose slot is >= ``num_slots``
    (bucket padding, inactive decode rows) lands there — the JAX package's
    ``mode="drop"``, realized with a clamp instead of a data-dependent
    mask so the write never synchronizes with the host. ``kv_quantized``:
    the pools are ``QuantPool`` pairs (codes [L, num_slots + 1, KV, D],
    scales [L, num_slots + 1, KV], both with the drop slot); the new K/V
    are quantized (``quantize_kv``) and codes and scales written."""
    idx = write_slots.reshape(-1).long().clamp(0, num_slots)

    def write_fn(pool, l: int, new: torch.Tensor):
        flat = new.reshape(-1, *new.shape[2:])
        if kv_quantized:
            codes, scale = quantize_kv(flat)
            i = comm.to(idx, codes.device)
            pool.data[l].index_copy_(0, i, codes)
            pool.scale[l].index_copy_(0, i, scale)
        else:
            pool[l].index_copy_(0, comm.to(idx, pool.device),
                                flat.to(pool.dtype))
        return pool

    return write_fn


def pool_at(pool, l: int):
    """Layer ``l``'s readable pool [num_slots, KV, D] (the drop slot cut
    off; still contiguous, so the kernels take it as is); a ``QuantPool``
    gives a ``QuantPool`` of that layer's codes and scales."""
    if isinstance(pool, QuantPool):
        return QuantPool(pool.data[l, :-1], pool.scale[l, :-1])
    return pool[l, :-1]


def gather_kv_window(k_layer: torch.Tensor, v_layer: torch.Tensor,
                     page_tables: torch.Tensor,
                     page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather each row's KV window from one layer's flat pool, page by page
    (the plain path only; the kernels read pages in place).

    k_layer, v_layer: [num_slots, KV, D]; page_tables: [B, P] page ids
    (entries past a row's last page are clamped into the pool and masked
    by ``kv_valid_len`` downstream, as the JAX gather clamps).
    Returns (k_seq, v_seq), each [B, P * page_size, KV, D]."""
    B, P = page_tables.shape
    num_pages = k_layer.shape[0] // page_size
    pt = page_tables.long().clamp(0, num_pages - 1)
    kp = k_layer.view(num_pages, page_size, *k_layer.shape[1:])
    vp = v_layer.view(num_pages, page_size, *v_layer.shape[1:])
    return (kp[pt].reshape(B, P * page_size, *k_layer.shape[1:]),
            vp[pt].reshape(B, P * page_size, *v_layer.shape[1:]))


# ---------------------------------------------------------------------------
# Dense contiguous KV cache (the unpaged path; the paged pool is engine/'s)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Contiguous per-layer KV cache: k, v are [L, B, S, KV, D]."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda") -> "KVCache":
        shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _write_kv(cache: torch.Tensor, l: int, new: torch.Tensor,
              write_pos: torch.Tensor) -> torch.Tensor:
    """Write new K or V ([B, T, KV, D]) into layer ``l`` of the stacked
    dense cache ([L, B, S, KV, D]) at per-row positions ([B, T]), IN PLACE;
    positions outside [0, S) are dropped (padding), as the JAX scatter's
    ``mode="drop"``. No host sync: each cache slot takes the token that
    targets it (an inverse map built by one scatter, dropped writes routed
    to a spare column), or keeps its value."""
    B, T = write_pos.shape
    S = cache.shape[2]
    pos = write_pos.long()
    pos = torch.where((pos >= 0) & (pos < S), pos, torch.full_like(pos, S))
    src = torch.full((B, S + 1), -1, dtype=torch.long, device=cache.device)
    src.scatter_(1, pos, torch.arange(T, device=cache.device).expand(B, T))
    src = src[:, :S]
    taken = new.gather(1, src.clamp(min=0)[:, :, None, None].expand(
        B, S, *new.shape[2:]))
    layer = cache[l]
    layer.copy_(torch.where((src >= 0)[:, :, None, None],
                            taken.to(cache.dtype), layer))
    return cache


# ---------------------------------------------------------------------------
# Transformer forward
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim, theta, scaling, device: str) -> torch.Tensor:
    return rope_frequencies(head_dim, theta, scaling, device=device)


def _mm(x: torch.Tensor, w, impl: str) -> torch.Tensor:
    """x @ w for a dense or quantized 2-D weight: a ``Q8Tensor`` /
    ``Q4Tensor`` goes through the group-dequant matmul kernel
    (``impl="kernel"``) or its plain version ``x @ dequantize(w)``."""
    if is_quantized(w):
        return quant_matmul(x, w) if impl == "kernel" else \
            quant_matmul_plain(x, w)
    return x @ w


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float: multiplying a tensor
    of ``dtype`` by it rounds as the JAX package's multiply by
    ``jnp.asarray(x, dtype)`` does (bf16: sqrt(3584) = 59.866 becomes
    59.75)."""
    return torch.tensor(x, dtype=dtype).item()


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu_tanh":  # Gemma GeGLU (HF gelu_pytorch_tanh)
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _mlp(h: torch.Tensor, layers: Dict[str, object], l: int, impl: str,
         activation: str = "silu") -> torch.Tensor:
    """Gated MLP: down(act(gate(x)) * up(x)), SwiGLU or GeGLU."""
    gate = _act(_mm(h, layer_weight(layers["w_gate"], l), impl), activation)
    up = _mm(h, layer_weight(layers["w_up"], l), impl)
    return _mm(gate * up, layer_weight(layers["w_down"], l), impl)


def _moe_mlp(h: torch.Tensor, layers: Dict[str, object], l: int,
             cfg: ModelConfig, impl: str) -> torch.Tensor:
    """Mixtral-style MoE in the dense-compute form the JAX engine runs on
    one device (``_moe_mlp``, ``moe_impl="dense"``): f32 router logits,
    softmax over the top k, and EVERY expert's SwiGLU on every token,
    combined by the [N, E] routing weights (zero off the top k). Static
    shapes only — no routing-dependent indexing, nothing read back — so it
    captures into the engine's CUDA graphs. A quantized expert's three
    products run through the group-dequant matmul (``_mm`` on its 2-D
    slice); dense experts are batched products, as the JAX einsums."""
    B, T, H = h.shape
    x = h.reshape(-1, H)  # [N, H]
    logits = (x @ layers["router"][l]).float()  # [N, E]
    weights, idx = moe_route(logits, cfg.num_experts_per_tok)
    combine = torch.zeros_like(logits).scatter(1, idx, weights)
    wg, wu, wd = (layers[k] for k in ("w_gate", "w_up", "w_down"))
    if is_quantized(wg):
        outs = []
        for e in range(cfg.num_experts):
            gate = F.silu(_mm(x, expert_weight(wg, l, e), impl))
            up = _mm(x, expert_weight(wu, l, e), impl)
            outs.append(_mm(gate * up, expert_weight(wd, l, e), impl))
        expert_out = torch.stack(outs)  # [E, N, H]
    else:
        gate = F.silu(torch.einsum("nh,ehi->eni", x, wg[l]))
        up = torch.einsum("nh,ehi->eni", x, wu[l])
        expert_out = torch.einsum("eni,eih->enh", gate * up, wd[l])
    out = torch.einsum("enh,ne->nh", expert_out,
                       combine.to(expert_out.dtype))
    return out.reshape(B, T, H)


def _moe_ep(x: torch.Tensor, layers: Dict[str, object],
            experts: List[List[Dict[str, object]]], l: int,
            cfg: ModelConfig, impl: str, capacity_factor: float,
            valid_tokens: Optional[torch.Tensor]) -> torch.Tensor:
    """Layer ``l``'s MoE through the capacity-based dispatch over the
    expert shards (``ops/moe.py moe_mlp_ep``); ``experts[e][t]`` are the
    layer trees of expert shard ``e``, tensor shard ``t``."""
    B, T, _ = x.shape
    cap = expert_capacity(B * T, cfg.num_experts, cfg.num_experts_per_tok,
                          capacity_factor)
    shards = [[{n: layer_weight(tree[n], l)
                for n in ("w_gate", "w_up", "w_down")} for tree in row]
              for row in experts]
    return moe_mlp_ep(x, {"router": layers["router"][l]}, cfg.num_experts,
                      cfg.num_experts_per_tok, capacity=cap,
                      valid_tokens=valid_tokens, expert_shards=shards,
                      impl=impl)


# ---------------------------------------------------------------------------
# Shards: the mesh's pieces as the layer loop walks them
# ---------------------------------------------------------------------------


class _Stage(NamedTuple):
    """One pipeline stage as the layer loop sees it: its tensor shards'
    layer trees (one tree when unsharded), the expert shards' trees
    ([expert][tensor]; the expert-parallel dispatch only), its pools per
    tensor shard, the global index of its first layer, and the device its
    residual stream runs on (None: wherever it is)."""

    layers: List[Dict[str, object]]
    experts: Optional[List[List[Dict[str, object]]]]
    pools_k: list
    pools_v: list
    first: int
    device: Optional[torch.device]


def _stage_pools(pool, s: int) -> list:
    """Stage ``s``'s per-tensor-shard pools: of a ``ShardedPool`` (or a
    ``QuantPool`` of them), of ``[stage][tensor]`` lists (dense caches),
    or the one pool of an unsharded model."""
    if isinstance(pool, list):
        return pool[s]
    if isinstance(pool, ShardedPool) or (
            isinstance(pool, QuantPool) and isinstance(pool.data, ShardedPool)):
        return pool_shards(pool, s)
    return [pool]


def _stages(params, cfg: ModelConfig, pool_k, pool_v) -> List[_Stage]:
    if not isinstance(params, ShardedParams):
        return [_Stage([params["layers"]], None, [pool_k], [pool_v], 0, None)]
    per = cfg.num_layers // params.pp
    out = []
    for s in range(params.pp):
        experts = None
        if params.moe_impl == "ep" and cfg.is_moe:
            experts = [[params.tree(s, e, t)["layers"]
                        for t in range(params.tp)] for e in range(params.ep)]
        out.append(_Stage([t["layers"] for t in params.stage_trees(s)],
                          experts, _stage_pools(pool_k, s),
                          _stage_pools(pool_v, s), s * per,
                          params.mesh.device(stage=s)))
    return out


def _embed(params, cfg: ModelConfig, input_ids: torch.Tensor
           ) -> torch.Tensor:
    """Token embeddings [B, T, hidden], Gemma's scaling applied. A tied
    table under tensor parallelism is vocab-split: each shard looks the
    ids up in its slice (others masked to zero) and the rows meet in
    ``comm.all_reduce``."""
    ids = input_ids.long().clamp(0, cfg.vocab_size - 1)
    if not isinstance(params, ShardedParams):
        h = params["embed"][ids]
    else:
        trees = params.stage_trees(0)
        if cfg.tie_word_embeddings and len(trees) > 1:
            parts = []
            for tree in trees:
                lo, hi = tree["vocab"]
                table = tree["embed"]
                local = comm.to(ids, table.device) - lo
                hit = (local >= 0) & (local < hi - lo)
                rows = table[local.clamp(0, hi - lo - 1)]
                parts.append(torch.where(hit[..., None], rows,
                                         rows.new_zeros(())))
            h = comm.all_reduce(parts, params.device)
        else:
            table = trees[0]["embed"]
            h = table[comm.to(ids, table.device)]
    if cfg.scale_embeddings:  # Gemma: sqrt(hidden), in h's dtype
        h = h * _in_dtype(cfg.hidden_size ** 0.5, h.dtype)
    return h


def _unembed(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """f32 logits [..., V]: the hidden state is upcast BEFORE the product
    (the JAX einsum's preferred_element_type=f32 on bf16 operands); then
    the final-logit soft-cap ``tanh(logits / cap) * cap`` where the model
    has one (Gemma-2). Sharded params are vocab-parallel: each tensor
    shard of the last stage projects its vocabulary slice and the logits
    are gathered in shard order onto the mesh's first device."""
    if isinstance(params, ShardedParams):
        parts = []
        for tree in params.stage_trees(params.pp - 1):
            w = tree["unembed_f32"]
            parts.append(F.linear(comm.to(h, w.device).float(), w))
        logits = comm.all_gather(parts, dim=-1, device=params.device)
    else:
        w = params.get("unembed_f32")
        if w is None:
            w = unembed_weight_f32(params, cfg)
        logits = F.linear(h.float(), w)
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits


def layer_block(
    cfg: ModelConfig,
    shards: List[Dict[str, object]],
    l: int,
    h: torch.Tensor,
    positions: torch.Tensor,
    pools_k: list,
    pools_v: list,
    write_fn,
    attend_fn,
    inv_freq: torch.Tensor,
    impl: str,
    window: int = 0,
    view=pool_at,
    experts=None,
    moe_kw: Optional[dict] = None,
    attend_new: bool = False,
) -> torch.Tensor:
    """One transformer block: write this step's K/V into layer ``l`` of the
    stacked pools, then attend against ``view(pool, l)`` (the paged pool's
    readable slots by default; with ``attend_new`` against this step's own
    K/V, the sequence-parallel prefill's form), then the MLP. Returns the
    new hidden state [B, T, hidden].

    ``shards`` are the tensor shards' layer trees (one tree unsharded) and
    ``pools_k`` / ``pools_v`` their pools: every shard runs its own q/k/v
    products (H/tp query and KV/tp KV heads), RoPE, pool writes, attention
    launch and row-parallel ``wo`` / ``w_down`` partials on its own device;
    the partials meet in ``comm.all_reduce`` in shard order (one shard:
    its partial as it is), and the norms run once on ``h``'s device. ``experts`` (with ``moe_kw``: the capacity
    factor and valid tokens): the expert shards' trees for the
    capacity-based expert-parallel MoE."""
    tp = len(shards)
    B, T, _ = h.shape
    eps, D = cfg.rms_norm_eps, cfg.head_dim
    nh, nkv = cfg.num_heads // tp, cfg.num_kv_heads // tp

    x = rms_norm(h, shards[0]["attn_norm"][l], eps, impl)
    parts = []
    for lay, pk, pv in zip(shards, pools_k, pools_v):
        def w(name):
            return layer_weight(lay[name], l)

        xs = comm.to(x, lay["attn_norm"].device)
        q, k, v = _mm(xs, w("wq"), impl), _mm(xs, w("wk"), impl), \
            _mm(xs, w("wv"), impl)
        if cfg.attention_bias:  # Qwen2
            q, k, v = q + w("bq"), k + w("bk"), v + w("bv")
        q = q.view(B, T, nh, D)
        k = k.view(B, T, nkv, D)
        v = v.view(B, T, nkv, D)
        pos, freq = comm.to(positions, xs.device), comm.to(inv_freq, xs.device)
        q = apply_rope(q, pos, freq, impl)
        k = apply_rope(k, pos, freq, impl)
        if cfg.query_pre_attn_scalar is not None:
            # Gemma: the kernels scale by 1/sqrt(D), so q times
            # sqrt(D / scalar) nets 1/sqrt(query_pre_attn_scalar)
            q = q * _in_dtype((D / cfg.query_pre_attn_scalar) ** 0.5,
                              q.dtype)
        write_fn(pk, l, k)
        write_fn(pv, l, v)
        attn = (attend_fn(q, k, v, window) if attend_new
                else attend_fn(q, view(pk, l), view(pv, l), window))
        parts.append(_mm(attn.reshape(B, T, nh * D), w("wo"), impl))
    attn_out = comm.all_reduce(parts, h.device)
    if cfg.sandwich_norms:  # Gemma-2 post-attention norm
        attn_out = rms_norm(attn_out, shards[0]["post_attn_norm"][l], eps,
                            impl)
    h = h + attn_out
    x = rms_norm(h, shards[0]["mlp_norm"][l], eps, impl)
    if experts is not None:
        mlp_out = _moe_ep(x, shards[0], experts, l, cfg, impl, **moe_kw)
    else:
        mlp_out = comm.all_reduce([
            _moe_mlp(comm.to(x, lay["mlp_norm"].device), lay, l, cfg, impl)
            if cfg.is_moe else
            _mlp(comm.to(x, lay["mlp_norm"].device), lay, l, impl,
                 cfg.activation)
            for lay in shards], h.device)
    if cfg.sandwich_norms:  # Gemma-2 post-MLP norm
        mlp_out = rms_norm(mlp_out, shards[0]["post_mlp_norm"][l], eps, impl)
    return h + mlp_out


def _final_norm(params) -> torch.Tensor:
    if isinstance(params, ShardedParams):
        return params.stage_trees(params.pp - 1)[0]["final_norm"]
    return params["final_norm"]


def _run_layers(params, cfg: ModelConfig, input_ids: torch.Tensor,
                positions: torch.Tensor, pool_k, pool_v,
                write_slots: Optional[torch.Tensor], attend_fn, impl: str,
                write_fn=None, view=pool_at, attend_new: bool = False,
                valid_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embed, run every layer block (each writes its new K/V at
    ``write_slots`` through the paged write, or through ``write_fn`` when
    given, then attends ``view(pool, l)`` through ``attend_fn``) and the
    final norm. Returns the hidden state [B, T, hidden] (on the last
    stage's device).

    Sharded params run stage by stage: the residual stream hops to each
    stage's device (the stages' ``ppermute``), and each stage's layers
    run over its tensor shards (``layer_block``). ``valid_tokens`` ([B,
    T] bool) keeps padding out of the expert-parallel MoE's capacity
    (default: the tokens whose paged write slot is in range)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    stages = _stages(params, cfg, pool_k, pool_v)
    pool0 = stages[0].pools_k[0]
    kv_quantized = isinstance(pool0, QuantPool)
    codes = pool0.data if kv_quantized else pool0
    inv_freq = _inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                         str(codes.device))
    if write_fn is None:
        write_fn = make_paged_write_fn(write_slots, codes.shape[1] - 1,
                                       kv_quantized)
    moe_kw = None
    if any(st.experts is not None for st in stages):
        if valid_tokens is None and write_slots is not None:
            valid_tokens = write_slots < codes.shape[1] - 1
        moe_kw = {"capacity_factor": params.moe_capacity_factor,
                  "valid_tokens": valid_tokens}
    h = _embed(params, cfg, input_ids)
    windows = cfg.layer_windows()
    for st in stages:
        if st.device is not None:
            h = comm.to(h, st.device)
        for l in range(st.layers[0]["attn_norm"].shape[0]):
            h = layer_block(cfg, st.layers, l, h, positions, st.pools_k,
                            st.pools_v, write_fn, attend_fn, inv_freq, impl,
                            windows[st.first + l], view, st.experts, moe_kw,
                            attend_new)
    return rms_norm(h, _final_norm(params), cfg.rms_norm_eps, impl)


def forward(
    params: Params,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache,
    write_pos: torch.Tensor,
    kv_valid_len: torch.Tensor,
    impl: str = "kernel",
) -> Tuple[torch.Tensor, KVCache]:
    """Run the transformer over new tokens, updating the dense KV cache.

    Args:
      input_ids: [B, T] new token ids (prefill: the prompt; decode: T=1).
      positions: [B, T] absolute positions of those tokens.
      cache: dense KV cache to read and write (updated IN PLACE); for
        sharded params, ``[stage][tensor]`` lists of per-shard caches
        (``dense_caches``) in ``cache.k`` / ``cache.v``.
      write_pos: [B, T] cache slot for each new token's K/V (>= max_seq
        drops it, e.g. padding).
      kv_valid_len: [B] valid cache length per row AFTER this write.
      impl: "kernel" runs RMSNorm and RoPE through the kernel wrappers
        (their plain versions for CPU tensors), "plain" their plain
        versions. Attention is the dense GQA of ``ops/attention.py`` on
        both, as the JAX ``forward`` runs XLA's, not a Pallas kernel.

    Returns: (logits [B, T, vocab] f32, cache).
    """
    h = _dense_trunk(params, cfg, input_ids, positions, cache, write_pos,
                     kv_valid_len, impl)
    return _unembed(params, cfg, h), cache


def dense_caches(params, cfg: ModelConfig, batch: int, max_seq: int,
                 dtype: torch.dtype) -> KVCache:
    """A dense KV cache for ``params``: one ``KVCache`` on the params'
    device, or for sharded params ``[stage][tensor]`` lists of per-shard
    [L/S, B, S, KV/tp, D] caches on their shards' devices."""
    if not isinstance(params, ShardedParams):
        return KVCache.create(cfg, batch, max_seq, dtype=dtype,
                              device=params["embed"].device)
    L, kv = cfg.num_layers // params.pp, cfg.num_kv_heads // params.tp

    def member():
        return [[torch.zeros((L, batch, max_seq, kv, cfg.head_dim),
                             dtype=dtype,
                             device=params.mesh.device(tensor=t, stage=s))
                 for t in range(params.tp)] for s in range(params.pp)]

    return KVCache(member(), member())


def _dense_trunk(params, cfg, input_ids, positions, cache: KVCache,
                 write_pos, kv_valid_len, impl) -> torch.Tensor:
    """``_run_layers`` over the dense cache: the writes at ``write_pos``,
    attention by ``gqa_attention``. Returns the normed hidden state."""
    def write_fn(pool, l, new):
        return _write_kv(pool, l, new, comm.to(write_pos, pool.device))

    def attend_fn(q, k, v, window):
        return gqa_attention(q, k, v, comm.to(positions, q.device),
                             comm.to(kv_valid_len, q.device), window,
                             cfg.attn_logit_softcap)

    valid = None
    if isinstance(params, ShardedParams) and params.moe_impl == "ep":
        S = (cache.k[0][0] if isinstance(cache.k, list) else cache.k).shape[2]
        valid = (write_pos >= 0) & (write_pos < S)
    return _run_layers(params, cfg, input_ids, positions, cache.k, cache.v,
                       write_pos, attend_fn, impl, write_fn=write_fn,
                       view=lambda pool, l: pool[l], valid_tokens=valid)


def hidden_states(params, cfg: ModelConfig, input_ids: torch.Tensor,
                  positions: torch.Tensor, kv_valid_len: torch.Tensor,
                  impl: str = "kernel") -> torch.Tensor:
    """Final-layer hidden states (after the final norm, before the
    unembedding) for the embeddings routes: a cache-less full forward over
    [B, T] ids, each token's K/V written at its position in a scratch
    dense cache of T slots. Returns [B, T, hidden] f32."""
    B, T = input_ids.shape
    if isinstance(params, ShardedParams):
        cache = dense_caches(params, cfg, B, T, params.dtype)
    else:
        cache = KVCache.create(cfg, B, T, dtype=params["embed"].dtype,
                               device=input_ids.device)
    h = _dense_trunk(params, cfg, input_ids, positions, cache, positions,
                     kv_valid_len, impl).float()
    return comm.to(h, input_ids.device)


def _paged_trunk(params, cfg: ModelConfig, input_ids, positions, pool_k,
                 pool_v, write_slots, page_tables, kv_valid_len, impl: str,
                 page_size: int, data: int) -> torch.Tensor:
    """``_run_layers`` over the paged pools for one group of rows (a GPipe
    microbatch, or the whole batch): the kernels (or the plain gathered
    window) read each shard's own pool; a ``data`` axis of ``data`` > 1
    splits every attention launch's rows that many ways."""
    softcap = cfg.attn_logit_softcap or 0.0
    page_tables = page_tables.to(torch.int32).contiguous()
    kv_valid_len = kv_valid_len.to(torch.int32).contiguous()
    decode_step = input_ids.shape[1] == 1
    kv_quantized = isinstance(pool_k, QuantPool)
    q_start = None
    if impl == "kernel" and not decode_step:
        q_start = positions[:, 0].to(torch.int32).contiguous()

    def attend_rows(q, k_layer, v_layer, window, r):
        dev = q.device
        tables = comm.to(page_tables, dev)[r]
        valid = comm.to(kv_valid_len, dev)[r]
        if kv_quantized and not (impl == "kernel" and decode_step):
            pos = comm.to(positions, dev)[r]
            kd, vd = gather_kv_window(k_layer.data, v_layer.data, tables,
                                      page_size)
            ks, vs = gather_kv_window(k_layer.scale, v_layer.scale, tables,
                                      page_size)
            return gqa_attention(q, dequantize_kv(kd, ks, q.dtype),
                                 dequantize_kv(vd, vs, q.dtype), pos, valid,
                                 window, cfg.attn_logit_softcap)
        if impl == "kernel":
            if decode_step:
                return paged_decode(
                    q[:, 0], k_layer, v_layer, tables, valid,
                    page_size=page_size, sliding_window=window,
                    attn_softcap=softcap)[:, None]
            return paged_prefill(
                q, k_layer, v_layer, tables, comm.to(q_start, dev)[r], valid,
                page_size=page_size, sliding_window=window,
                attn_softcap=softcap)
        k_seq, v_seq = gather_kv_window(k_layer, v_layer, tables, page_size)
        return gqa_attention(q, k_seq, v_seq, comm.to(positions, dev)[r],
                             valid, window, cfg.attn_logit_softcap)

    def attend_fn(q, k_layer, v_layer, window):
        B = q.shape[0]
        if data == 1:
            return attend_rows(q, k_layer, v_layer, window, slice(None))
        if B % data:
            raise ValueError(f"data axis {data} does not divide {B} rows")
        n = B // data
        return torch.cat([
            attend_rows(q[i * n:(i + 1) * n], k_layer, v_layer, window,
                        slice(i * n, (i + 1) * n)) for i in range(data)])

    return _run_layers(params, cfg, input_ids, positions, pool_k, pool_v,
                       write_slots, attend_fn, impl)


def paged_forward(
    params: Params,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    positions: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    write_slots: torch.Tensor,
    page_tables: torch.Tensor,
    kv_valid_len: torch.Tensor,
    impl: str = "kernel",
    page_size: int = 16,
    logits_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward pass over the paged KV pool (engine/kv_cache.py).

    Args:
      params: the parameter tree, or a ``ShardedParams`` (parallel/tp.py)
        with the pools ``ShardedPool``s (or ``QuantPool`` pairs of them):
        every tensor shard then launches its own kernels on its own heads
        and pool (``layer_block``), a ``stage`` axis runs the layers stage
        by stage in ``params.microbatches`` GPipe microbatches of rows
        (issued microbatch-major, so on distinct cards stage s works on
        one microbatch while stage s + 1 works on the one before), and a
        ``data`` axis splits each attention launch's rows.
      input_ids, positions: [B, T] new tokens and absolute positions (int).
      pool_k, pool_v: [L, num_slots + 1, KV, D] stacked pools (the last
        slot is the drop slot); updated IN PLACE. Or int8 ``QuantPool``
        pairs (codes [L, num_slots + 1, KV, D], scales [L, num_slots + 1,
        KV]): decode then runs the int8 decode kernel, and T > 1 the plain
        gather + dequantize + ``gqa_attention`` on both paths.
      write_slots: [B, T] flat slot per new token (>= num_slots drops).
      page_tables: [B, P] int32 page ids per row.
      kv_valid_len: [B] int32 tokens valid per row INCLUDING this step's.
      impl: "kernel" or "plain" (module docstring). On the kernel path,
        T == 1 runs the decode kernel; T > 1 the chunked-prefill kernel,
        which requires each row's positions to be one contiguous run
        starting at positions[:, 0] (the engine's prefill-chunk layout).
      logits_idx: [B] per-row index in T: only that position is
        unembedded and the logits are [B, 1, V] (prefill chunks want only
        their last position).

    Returns (logits [B, T or 1, V] f32, pool_k, pool_v).
    """
    sharded = isinstance(params, ShardedParams)
    M = params.microbatches if sharded else 1
    data = params.mesh.shape["data"] if sharded else 1
    B = input_ids.shape[0]
    if B % M:
        raise ValueError(f"{M} microbatches do not divide batch={B}")
    hs = []
    for m in range(M):
        r = slice(m * B // M, (m + 1) * B // M)
        hs.append(_paged_trunk(
            params, cfg, input_ids[r], positions[r], pool_k, pool_v,
            write_slots[r], page_tables[r], kv_valid_len[r], impl, page_size,
            data))
    h = hs[0] if M == 1 else torch.cat(hs)
    if logits_idx is not None:
        rows = torch.arange(h.shape[0], device=h.device)
        h = h[rows, comm.to(logits_idx, h.device).long()][:, None]
    return _unembed(params, cfg, h), pool_k, pool_v


def ragged_paged_forward(
    params: Params,
    cfg: ModelConfig,
    input_ids: torch.Tensor,
    positions: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    write_slots: torch.Tensor,
    tok_row: torch.Tensor,
    page_tables: torch.Tensor,
    kv_valid_len: torch.Tensor,
    logits_idx: torch.Tensor,
    impl: str = "kernel",
    page_size: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward pass over a PACKED ragged mixed batch (the engine's mixed
    step): one flat token axis carries decode rows (one token each) and
    prefill chunks back-to-back, each token attending its own row's pages.

    Args:
      params: the parameter tree, or a ``ShardedParams`` of a tensor-only
        mesh (each tensor shard attends its own heads; the engine refuses
        the mixed step on other meshes).
      input_ids, positions: [1, S] packed tokens and absolute positions.
      pool_k, pool_v: [L, num_slots + 1, KV, D] stacked pools (updated IN
        PLACE; the last slot is the drop slot), or int8 ``QuantPool``
        pairs: the write quantizes, and attention runs the plain gather +
        dequantize + ``ragged_gqa_attention`` on both paths.
      write_slots: [1, S] flat slot per packed token (>= num_slots drops:
        padding and inactive decode slots).
      tok_row: [S] owning row per token (-1 = padding); each row's tokens
        are one contiguous run.
      page_tables: [Bm, P] int32 page ids per row.
      kv_valid_len: [Bm] int32 tokens valid per row INCLUDING its new ones.
      logits_idx: [N] packed positions to unembed (decode slots and the
        chunk-final tokens).
      impl: "kernel" (``paged_ragged``) or "plain" (gathered windows +
        ``ragged_gqa_attention``).

    Returns (logits [N, V] f32, pool_k, pool_v).
    """
    kv_quantized = isinstance(pool_k, QuantPool)
    softcap = cfg.attn_logit_softcap or 0.0
    page_tables = page_tables.to(torch.int32).contiguous()
    kv_valid_len = kv_valid_len.to(torch.int32).contiguous()
    tok_row = tok_row.to(torch.int32).contiguous()
    flat_pos = positions[0].to(torch.int32).contiguous()

    def attend_fn(q, k_layer, v_layer, window):
        dev = q.device
        tables, valid = comm.to(page_tables, dev), comm.to(kv_valid_len, dev)
        rows, fpos = comm.to(tok_row, dev), comm.to(flat_pos, dev)
        if kv_quantized:
            kd, vd = gather_kv_window(k_layer.data, v_layer.data, tables,
                                      page_size)
            ks, vs = gather_kv_window(k_layer.scale, v_layer.scale, tables,
                                      page_size)
            k_seq = dequantize_kv(kd, ks, q.dtype)
            v_seq = dequantize_kv(vd, vs, q.dtype)
            # each packed token attends alone, so chunks of the token axis
            # give the whole call's result with a bounded window copy
            return torch.cat([
                ragged_gqa_attention(
                    q[0, c:c + _RAGGED_TOKEN_CHUNK], k_seq, v_seq,
                    rows[c:c + _RAGGED_TOKEN_CHUNK],
                    fpos[c:c + _RAGGED_TOKEN_CHUNK], valid,
                    window, cfg.attn_logit_softcap)
                for c in range(0, q.shape[1], _RAGGED_TOKEN_CHUNK)])[None]
        if impl == "kernel":
            return paged_ragged(
                q[0], k_layer, v_layer, tables, rows, fpos, valid,
                page_size=page_size, sliding_window=window,
                attn_softcap=softcap)[None]
        k_seq, v_seq = gather_kv_window(k_layer, v_layer, tables, page_size)
        return ragged_gqa_attention(
            q[0], k_seq, v_seq, rows, fpos, valid, window,
            cfg.attn_logit_softcap)[None]

    h = _run_layers(params, cfg, input_ids, positions, pool_k, pool_v,
                    write_slots, attend_fn, impl)
    # unembed only the sampled positions: [1, S, H] -> [N, V]
    idx = comm.to(logits_idx, h.device).long()
    return _unembed(params, cfg, h[0, idx]), pool_k, pool_v
