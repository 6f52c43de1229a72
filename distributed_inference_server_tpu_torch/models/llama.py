"""Llama-family transformer over the paged KV pool, in PyTorch (port of
``distributed_inference_server_tpu/models/llama.py``: ``init_params``, the
paged write, the layer block, ``gather_kv_window``, ``paged_forward``,
``_mlp`` and ``_unembed``).

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

This slice serves dense Llama models (Llama 3.x). MoE, attention biases,
sandwich norms and the Gemma scalings are rejected by ``check_supported``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from distributed_inference_server_tpu_torch.models.configs import ModelConfig
from distributed_inference_server_tpu_torch.ops.attention import gqa_attention
from distributed_inference_server_tpu_torch.ops.kernels.paged_attention import (
    paged_decode,
    paged_prefill,
)
from distributed_inference_server_tpu_torch.ops.norms import rms_norm
from distributed_inference_server_tpu_torch.ops.rotary import (
    apply_rope,
    rope_frequencies,
)

Params = Dict[str, object]
IMPLS = ("kernel", "plain")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for model features this slice does not port yet."""
    unsupported = {
        "num_experts": cfg.is_moe,
        "attention_bias": cfg.attention_bias,
        "sandwich_norms": cfg.sandwich_norms,
        "scale_embeddings": cfg.scale_embeddings,
        "query_pre_attn_scalar": cfg.query_pre_attn_scalar is not None,
        "final_logit_softcap": cfg.final_logit_softcap is not None,
        "activation": cfg.activation != "silu",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"model {cfg.name!r} uses {bad}, which the port does not serve "
            "yet (dense Llama only)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> Params:
    """Random parameters with HF-compatible shapes (stacked per layer):
    normal(0, 0.02) drawn in f32 from ``generator`` (which must live on
    ``device``) and cast to ``dtype``; norm weights are ones."""
    check_supported(cfg)
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    std = 0.02

    def w(*shape):
        x = torch.randn(*shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * std).to(dtype)

    def ones(*shape):
        return torch.ones(*shape, dtype=dtype, device=device)

    layers = {
        "attn_norm": ones(L, H),
        "wq": w(L, H, cfg.q_size),
        "wk": w(L, H, cfg.kv_size),
        "wv": w(L, H, cfg.kv_size),
        "wo": w(L, cfg.q_size, H),
        "mlp_norm": ones(L, H),
        "w_gate": w(L, H, I),
        "w_up": w(L, H, I),
        "w_down": w(L, I, H),
    }
    params: Params = {
        "embed": w(cfg.vocab_size, H),
        "layers": layers,
        "final_norm": ones(H),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(H, cfg.vocab_size)
    return params


def unembed_weight_f32(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The unembedding as f32 [V, H]: the logits are an f32 product
    (``_unembed``), so a caller that unembeds every step keeps this copy
    under ``params["unembed_f32"]`` instead of upcasting per call."""
    w = params["embed"] if cfg.tie_word_embeddings else params["lm_head"].t()
    return w.float().contiguous()


# ---------------------------------------------------------------------------
# Paged pool access
# ---------------------------------------------------------------------------


def make_paged_write_fn(write_slots: torch.Tensor, num_slots: int):
    """Write_fn for the paged pool: ``write_fn(pool, l, new)`` copies the
    new tokens' K or V ([B, T, KV, D]) into layer ``l`` at ``write_slots``
    ([B, T] flat slots), IN PLACE, and returns the pool.

    The pools are [L, num_slots + 1, KV, D]: slot ``num_slots`` is a drop
    slot that no reader ever sees. A write whose slot is >= ``num_slots``
    (bucket padding, inactive decode rows) lands there — the JAX package's
    ``mode="drop"``, realized with a clamp instead of a data-dependent
    mask so the write never synchronizes with the host."""
    idx = write_slots.reshape(-1).long().clamp(0, num_slots)

    def write_fn(pool: torch.Tensor, l: int, new: torch.Tensor) -> torch.Tensor:
        pool[l].index_copy_(0, idx, new.reshape(-1, *new.shape[2:])
                            .to(pool.dtype))
        return pool

    return write_fn


def pool_at(pool: torch.Tensor, l: int) -> torch.Tensor:
    """Layer ``l``'s readable pool [num_slots, KV, D] (the drop slot cut
    off; still contiguous, so the kernels take it as is)."""
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
# Transformer forward
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim, theta, scaling, device: str) -> torch.Tensor:
    return rope_frequencies(head_dim, theta, scaling, device=device)


def _mlp(h: torch.Tensor, layer: Dict[str, torch.Tensor], l: int
         ) -> torch.Tensor:
    """SwiGLU: down(silu(gate(x)) * up(x))."""
    gate = F.silu(h @ layer["w_gate"][l])
    up = h @ layer["w_up"][l]
    return (gate * up) @ layer["w_down"][l]


def _unembed(params: Params, cfg: ModelConfig, h: torch.Tensor
             ) -> torch.Tensor:
    """f32 logits [..., V]: the hidden state is upcast BEFORE the product
    (the JAX einsum's preferred_element_type=f32 on bf16 operands)."""
    w = params.get("unembed_f32")
    if w is None:
        w = unembed_weight_f32(params, cfg)
    return F.linear(h.float(), w)


def layer_block(
    cfg: ModelConfig,
    layers: Dict[str, torch.Tensor],
    l: int,
    h: torch.Tensor,
    positions: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    write_fn,
    attend_fn,
    inv_freq: torch.Tensor,
    impl: str,
    window: int = 0,
) -> torch.Tensor:
    """One transformer block: write this step's K/V into layer ``l`` of the
    stacked pools, then attend against the pool, then the MLP. Returns the
    new hidden state [B, T, hidden]."""
    B, T, _ = h.shape
    eps = cfg.rms_norm_eps
    x = rms_norm(h, layers["attn_norm"][l], eps, impl)
    q = (x @ layers["wq"][l]).view(B, T, cfg.num_heads, cfg.head_dim)
    k = (x @ layers["wk"][l]).view(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ layers["wv"][l]).view(B, T, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, inv_freq, impl)
    k = apply_rope(k, positions, inv_freq, impl)
    write_fn(pool_k, l, k)
    write_fn(pool_v, l, v)
    attn = attend_fn(q, pool_at(pool_k, l), pool_at(pool_v, l), window)
    h = h + attn.reshape(B, T, cfg.q_size) @ layers["wo"][l]
    x = rms_norm(h, layers["mlp_norm"][l], eps, impl)
    return h + _mlp(x, layers, l)


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
      input_ids, positions: [B, T] new tokens and absolute positions (int).
      pool_k, pool_v: [L, num_slots + 1, KV, D] stacked pools (the last
        slot is the drop slot); updated IN PLACE.
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
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    layers = params["layers"]
    num_slots = pool_k.shape[1] - 1
    device = pool_k.device
    inv_freq = _inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                         str(device))
    softcap = cfg.attn_logit_softcap or 0.0
    page_tables = page_tables.to(torch.int32).contiguous()
    kv_valid_len = kv_valid_len.to(torch.int32).contiguous()
    decode_step = input_ids.shape[1] == 1
    if impl == "kernel" and not decode_step:
        q_start = positions[:, 0].to(torch.int32).contiguous()

    def attend_fn(q, k_layer, v_layer, window):
        if impl == "kernel":
            if decode_step:
                return paged_decode(
                    q[:, 0], k_layer, v_layer, page_tables, kv_valid_len,
                    page_size=page_size, sliding_window=window,
                    attn_softcap=softcap)[:, None]
            return paged_prefill(
                q, k_layer, v_layer, page_tables, q_start, kv_valid_len,
                page_size=page_size, sliding_window=window,
                attn_softcap=softcap)
        k_seq, v_seq = gather_kv_window(k_layer, v_layer, page_tables,
                                        page_size)
        return gqa_attention(q, k_seq, v_seq, positions, kv_valid_len,
                             window, cfg.attn_logit_softcap)

    write_fn = make_paged_write_fn(write_slots, num_slots)
    vocab = params["embed"].shape[0]
    h = params["embed"][input_ids.long().clamp(0, vocab - 1)]  # [B, T, H]
    for l, window in enumerate(cfg.layer_windows()):
        h = layer_block(cfg, layers, l, h, positions, pool_k, pool_v,
                        write_fn, attend_fn, inv_freq, impl, window)
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps, impl)
    if logits_idx is not None:
        rows = torch.arange(h.shape[0], device=device)
        h = h[rows, logits_idx.long()][:, None]
    return _unembed(params, cfg, h), pool_k, pool_v
