"""On-device token sampling: greedy, temperature, top-p (port of
``distributed_inference_server_tpu/ops/sampling.py``).

Tokens, not logits, cross to the host. Temperature == 0 rows take the
argmax (the first maximum, as ``jnp.argmax`` does); the nucleus cutoff is
the reference's sort-free bisection over the probability threshold
(``_CUTOFF_ITERS`` masked sums over [B, V] instead of a vocabulary sort).
Random draws come from an explicit ``torch.Generator`` on the logits'
device (Gumbel-max, the form ``jax.random.categorical`` uses); the bits
differ from JAX's, so tests compare the greedy branch and the kept sets.
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


def _gumbel_argmax(logits: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row from (unnormalized) ``logits``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
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
) -> torch.Tensor:
    """Next tokens [B] int32 for f32 logits [B, V].

    temperature: [B] (0 => greedy); top_p: [B] (1 => off). ``use_topp``
    False skips the nucleus passes, for launches where no sampled row has
    top_p < 1 (the result is the same)."""
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
    sampled = _gumbel_argmax(filtered, generator).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)
