"""Weight quantization (symmetric per-group int8, packed int4) and the int8
KV pool, in PyTorch (port of ``distributed_inference_server_tpu/ops/quant.py``;
``pool_num_slots`` is not ported: nothing here calls it).

- ``Q8Tensor``: int8 codes [..., in, out] + f32 scales [..., in/G, out].
- ``Q4Tensor``: uint8 [..., in/2, out], two int4 codes per byte along the
  input axis (low nibble = even input row, high nibble = odd), + f32
  scales [..., in/G, out].
- ``QuantPool``: int8 K/V codes [..., num_slots, KV, D] + one f32 scale per
  (slot, KV head), absmax / 127.

Codes and scales are bit-identical to the JAX package's on the same input:
the same f32 division order, the same ``1e-8`` / ``1e-30`` floors, and
round half to even on both sides (``torch.round``, ``jnp.round``).
``quantize_params`` quantizes the seven linear families of a stacked
Llama or Mixtral parameter tree ([L, in, out], or [L, E, in, out] for the
experts) layer by layer, so the f32 temporaries of only one layer's
matrices are alive at a time; embeddings, norms, biases, the router and
``lm_head`` stay dense. ``init_random_quantized`` builds a random tree
with those families already quantized, with no dense intermediate: how a
random-weight server of a model whose dense tree would not fit the card
(mixtral-8x7b: 93 GB in bf16) starts.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
MODES = ("none", "int8", "int4")


class Q8Tensor(NamedTuple):
    """int8 weight [..., in, out] + f32 scales [..., in/G, out]."""

    q: torch.Tensor
    s: torch.Tensor


class Q4Tensor(NamedTuple):
    """packed uint8 weight [..., in/2, out] (two int4 along the input
    axis) + f32 scales [..., in/G, out]."""

    q: torch.Tensor
    s: torch.Tensor


def _group_scales(w: torch.Tensor, group_size: int, qmax: int) -> torch.Tensor:
    *lead, d_in, d_out = w.shape
    g = w.reshape(*lead, d_in // group_size, group_size, d_out)
    absmax = g.float().abs().amax(dim=-2)
    return torch.clamp(absmax, min=1e-8) / qmax  # [..., G, out]


def _codes(w: torch.Tensor, group_size: int, qmax: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    *lead, d_in, d_out = w.shape
    s = _group_scales(w, group_size, qmax)
    g = w.float().reshape(*lead, d_in // group_size, group_size, d_out)
    q = torch.clamp(torch.round(g / s[..., None, :]), -qmax, qmax)
    return q.to(torch.int8).reshape(*lead, d_in, d_out), s


def quantize_int8(w: torch.Tensor, group_size: int = 128) -> Q8Tensor:
    """Symmetric int8 over input-axis groups. w: [..., in, out]."""
    d_in = w.shape[-2]
    gs = min(group_size, d_in)
    if d_in % gs:
        raise ValueError(f"group_size {gs} does not divide in-dim {d_in}")
    q, s = _codes(w, gs, 127)
    return Q8Tensor(q=q, s=s)


def quantize_int4(w: torch.Tensor, group_size: int = 64) -> Q4Tensor:
    """Symmetric int4 (range [-7, 7]) over input-axis groups, packed two
    values per byte along the input axis. w: [..., in, out], in even."""
    d_in = w.shape[-2]
    gs = min(group_size, d_in)
    if d_in % gs or d_in % 2:
        raise ValueError(
            f"int4 needs even in-dim divisible by group {gs}, got {d_in}")
    q, s = _codes(w, gs, 7)
    even = (q[..., 0::2, :] & 0xF).to(torch.uint8)
    odd = (q[..., 1::2, :] & 0xF).to(torch.uint8)
    return Q4Tensor(q=(odd << 4) | even, s=s)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., in/2, out] uint8 -> [..., in, out] int8 codes in [-8, 7]
    (sign-extended nibbles; row 2i is the low nibble of packed row i)."""
    low = (packed & 0xF).to(torch.int8)
    high = (packed >> 4).to(torch.int8)
    low = torch.where(low > 7, low - 16, low)
    high = torch.where(high > 7, high - 16, high)
    *lead, half, d_out = packed.shape
    return torch.stack([low, high], dim=-2).reshape(*lead, half * 2, d_out)


def dequantize(w: Any, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dense [..., in, out] weight: codes x scales in f32, cast to
    ``dtype`` (a plain tensor is only cast)."""
    if isinstance(w, Q4Tensor):
        q = unpack_int4(w.q)
    elif isinstance(w, Q8Tensor):
        q = w.q
    else:
        return w if w.dtype == dtype else w.to(dtype)
    *lead, d_in, d_out = q.shape
    groups = w.s.shape[-2]
    deq = (q.float().reshape(*lead, groups, d_in // groups, d_out)
           * w.s[..., None, :])
    return deq.reshape(*lead, d_in, d_out).to(dtype)


def is_quantized(w: Any) -> bool:
    return isinstance(w, (Q8Tensor, Q4Tensor))


def layer_weight(w: Any, l: int) -> Any:
    """Layer ``l`` of a stacked weight, quantized or not. (Indexing a
    NamedTuple would pick a field, not a layer.)"""
    if is_quantized(w):
        return type(w)(w.q[l], w.s[l])
    return w[l]


def expert_weight(w: Any, l: int, e: int) -> Any:
    """Expert ``e`` of layer ``l`` of a stacked expert weight ([L, E, in,
    out], quantized or not): the 2-D [in, out] slice, contiguous, that a
    product takes."""
    if is_quantized(w):
        return type(w)(w.q[l, e], w.s[l, e])
    return w[l, e]


def dense_view(w: Any, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dense tensor of a possibly-quantized weight (a plain tensor passes
    through as it is)."""
    return dequantize(w, dtype) if is_quantized(w) else w


def quantize_params(params: Dict[str, Any], mode: str) -> Dict[str, Any]:
    """Quantize a Llama or Mixtral parameter tree's seven stacked linear
    families ([L, in, out], experts [L, E, in, out]); mode "int8" (group
    128) | "int4" (group 64) | "none". Layer by layer: the result equals
    quantizing the stacked tensor at once (groups run along the input
    axis and never cross layers or experts)."""
    if mode == "none":
        return params
    if mode == "int8":
        fn, cls = quantize_int8, Q8Tensor
    elif mode == "int4":
        fn, cls = quantize_int4, Q4Tensor
    else:
        raise ValueError(f"unknown quantization mode {mode!r}")

    def stacked(w: torch.Tensor):
        out_q = out_s = None
        for l in range(w.shape[0]):
            part = fn(w[l])
            if out_q is None:
                out_q = part.q.new_empty((w.shape[0], *part.q.shape))
                out_s = part.s.new_empty((w.shape[0], *part.s.shape))
            out_q[l], out_s[l] = part.q, part.s
        return cls(out_q, out_s)

    out = dict(params)
    out["layers"] = {k: (stacked(v) if k in QUANT_KEYS else v)
                     for k, v in params["layers"].items()}
    return out


def init_random_quantized(cfg, mode: str, generator: torch.Generator,
                          dtype: torch.dtype = torch.bfloat16,
                          device="cuda") -> Dict[str, Any]:
    """A random parameter tree (``models/llama.py`` ``param_shapes``) whose
    seven linear families are created quantized, from random bits, with no
    dense intermediate (the JAX package's ``init_random_quantized``):
    int8 codes are uniform over [-128, 127], int4 bytes uniform over
    [0, 255]; every scale is ``1 / (qmax * sqrt(d_in))`` (qmax 127 or 7),
    so dequantized magnitudes stay near ``init_params``' normal(0, 0.02).
    Norms are ones; every other leaf (embeddings, biases, the router,
    ``lm_head``) is normal(0, 0.02) in ``dtype`` (``llama.random_leaf``).
    Groups run along the input axis: 128 (int8) or 64 (int4) rows, as
    ``quantize_params``'. The bits come from ``generator`` (on ``device``), so they
    differ from the JAX package's; the tree's keys, shapes, dtypes and
    scales do not. ``mode="none"`` is ``init_params``."""
    from distributed_inference_server_tpu_torch.models import llama

    if mode == "none":
        return llama.init_params(cfg, generator, dtype=dtype, device=device)
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    qmax, group = (127, 128) if mode == "int8" else (7, 64)

    def bits(*shape):
        return torch.empty(shape, dtype=torch.uint8, device=device).random_(
            0, 256, generator=generator)

    def leaf(name, shape):
        if name in QUANT_KEYS:
            *lead, d_in, d_out = shape
            gs = min(group, d_in)
            s = torch.full((*lead, d_in // gs, d_out),
                           1.0 / (qmax * d_in ** 0.5), dtype=torch.float32,
                           device=device)
            if mode == "int8":
                return Q8Tensor(bits(*shape).view(torch.int8), s)
            return Q4Tensor(bits(*lead, d_in // 2, d_out), s)
        return llama.random_leaf(name, shape, generator, dtype, device)

    shapes = llama.param_shapes(cfg)
    return {k: ({n: leaf(n, sh) for n, sh in v.items()}
                if isinstance(v, dict) else leaf(k, v))
            for k, v in shapes.items()}


# ---------------------------------------------------------------------------
# KV-cache quantization (per-vector absmax int8)
# ---------------------------------------------------------------------------


class QuantPool(NamedTuple):
    """Int8-quantized KV pool: per-(slot, head) absmax scaling.

    data:  [..., num_slots, KV, D] int8 codes
    scale: [..., num_slots, KV] f32 per-vector scales
    """

    data: torch.Tensor
    scale: torch.Tensor


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector absmax int8 quantization of new K/V tokens.

    x: [..., KV, D] -> (codes int8 same shape, scale f32 [..., KV]). Zero
    vectors get scale 0 and reconstruct exactly to zero."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.where(
        scale[..., None] > 0.0,
        torch.round(xf / torch.clamp(scale, min=1e-30)[..., None]),
        torch.zeros((), dtype=torch.float32, device=x.device),
    ).to(torch.int8)
    return q, scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Reconstruct K/V vectors: codes [..., KV, D] * scale [..., KV]."""
    return (codes.float() * scale[..., None]).to(dtype)
