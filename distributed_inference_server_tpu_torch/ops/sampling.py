"""On-device token sampling: greedy, temperature, top-p (port of
``distributed_inference_server_tpu/ops/sampling.py``).

Tokens, not logits, cross to the host. Temperature == 0 rows take the
argmax (the first maximum, as ``jnp.argmax`` does); the nucleus cutoff is
the reference's sort-free bisection over the probability threshold
(``_CUTOFF_ITERS`` masked sums over [B, V] instead of a vocabulary sort).
Random draws come from an explicit ``torch.Generator`` on the logits'
device (Gumbel-max, the form ``jax.random.categorical`` uses), or from
``counter_uniform``, a hash of a device counter, where one CUDA graph
launch samples many steps (the engine's looped blocks); the bits differ
from JAX's, so tests compare the greedy branch and the kept sets.
"""

from __future__ import annotations

from typing import Optional

import torch

# Bisection steps for the nucleus threshold: the kept set is exact up to a
# threshold resolution of 2**-26 (~1.5e-8), below f32's resolution near 1.
_CUTOFF_ITERS = 26


def nucleus_cutoff(probs: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row cutoff probability [B, 1] such that ``{i : probs[b, i] >=
    c[b]}`` is the sorted-prefix nucleus (smallest descending prefix whose
    mass reaches ``top_p[b]``, extended to ties). The row argmax always
    survives; ``top_p >= 1`` keeps every token.

    S(t) = mass of probabilities >= t decreases in t; the boundary is the
    largest t with S(t) >= top_p, bisected in [0, 1] from S(0) = 1."""
    tp = top_p[:, None].to(probs.dtype)
    pmax = probs.max(dim=-1, keepdim=True).values
    lo = torch.zeros_like(pmax)
    hi = torch.ones_like(pmax)
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    for _ in range(_CUTOFF_ITERS):
        mid = 0.5 * (lo + hi)
        s = torch.where(probs >= mid, probs, zero).sum(dim=-1, keepdim=True)
        ge = s >= tp
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return torch.where(tp >= 1.0, zero, torch.minimum(lo, pmax))


_MASK32 = 0xFFFFFFFF


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 lanes holding 32-bit values
    (a bijection with full avalanche; products wrap mod 2**64 and are
    masked back to 32 bits)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _MASK32
    return h ^ (h >> 16)


def counter_uniform(shape, key: torch.Tensor) -> torch.Tensor:
    """Uniform f32 numbers in (0, 1) of ``shape``: two hash rounds of each
    element's flat index under ``key`` (a one-element int64 tensor on the
    device). A pure function of ``key``, with no generator state, so a
    CUDA graph that updates ``key`` on the device (the looped block folds
    its step counter into it) draws new numbers at every step."""
    n = 1
    for d in shape:
        n *= d
    key = key.reshape(()).to(torch.int64)
    k1 = _fmix32((key & _MASK32) ^ _fmix32((key >> 32) & _MASK32))
    k2 = _fmix32(k1 ^ 0x9E3779B9)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    h = _fmix32(_fmix32(idx ^ k1) ^ k2)
    return (((h >> 8).to(torch.float32) + 0.5) * 2.0 ** -24).reshape(shape)


def _gumbel_argmax(logits: torch.Tensor,
                   generator: Optional[torch.Generator],
                   uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One categorical draw per row from (unnormalized) ``logits``, with
    ``uniform`` noise of the logits' shape when given, else drawn from
    ``generator``."""
    u = uniform if uniform is not None else torch.rand(
        logits.shape, generator=generator, device=logits.device,
        dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + g, dim=-1)


def sample_tokens(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    use_topp: bool = True,
    uniform: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Next tokens [B] int32 for f32 logits [B, V].

    temperature: [B] (0 => greedy); top_p: [B] (1 => off). ``use_topp``
    False skips the nucleus passes, for launches where no sampled row has
    top_p < 1 (the result is the same). ``uniform``: [B, V] noise in
    (0, 1) to use instead of drawing from ``generator``."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    safe_temp = torch.where(temperature > 0, temperature,
                            torch.ones_like(temperature))[:, None]
    scaled = logits / safe_temp
    if use_topp:
        probs = torch.softmax(scaled, dim=-1)
        cutoff = nucleus_cutoff(probs, top_p)
        filtered = torch.where(probs >= cutoff, scaled,
                               torch.full_like(scaled, float("-inf")))
    else:
        filtered = scaled
    sampled = _gumbel_argmax(filtered, generator, uniform).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


def top_p_filter_probs(probs: torch.Tensor, top_p: torch.Tensor
                       ) -> torch.Tensor:
    """Zero the probabilities outside each row's top-p nucleus (the row
    argmax always stays); unnormalized. probs [B, V], top_p [B] (1 keeps
    every token)."""
    cutoff = nucleus_cutoff(probs, top_p)
    return torch.where(probs >= cutoff, probs, torch.zeros_like(probs))


def nucleus_probs(probs: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """The NORMALIZED nucleus distribution: top-p filter, then renormalize.
    Speculative verification needs true distributions on both sides (the
    accept ratio and the residual max(p - q, 0)). probs [..., V] rows
    summing to 1; top_p broadcastable to probs.shape[:-1]."""
    lead = probs.shape[:-1]
    V = probs.shape[-1]
    f = top_p_filter_probs(
        probs.reshape(-1, V),
        torch.broadcast_to(top_p.to(probs.dtype), lead).reshape(-1))
    f = f / f.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return f.reshape(*lead, V)
