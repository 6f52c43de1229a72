"""Rotary position embeddings, Llama-3 style (port of
``distributed_inference_server_tpu/ops/rotary.py``).

Frequencies are computed in f32 exactly as the reference writes them; the
rotation is the half-split form (not interleaved), matching HF Llama.
``apply_rope`` goes through the RoPE kernel's wrapper
(``ops/kernels/fused.py``: Triton on a CUDA tensor, the plain version on a
CPU tensor) unless ``impl="plain"``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distributed_inference_server_tpu_torch.models.configs import RopeScaling
from distributed_inference_server_tpu_torch.ops.kernels import fused
from distributed_inference_server_tpu_torch.ops.kernels.fused import (
    apply_rope_plain,
)

__all__ = ["rope_frequencies", "apply_rope", "apply_rope_plain"]


def rope_frequencies(
    head_dim: int,
    theta: float,
    scaling: Optional[RopeScaling] = None,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2] in f32, with optional Llama-3
    scaling: low-frequency components slow down by ``factor``,
    high-frequency ones stay, the band between interpolates smoothly."""
    f32 = torch.float32
    exponents = torch.arange(0, head_dim, 2, dtype=f32, device=device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=f32, device=device),
                               exponents)
    if scaling is None:
        return inv_freq

    low_wavelen = scaling.original_max_position / scaling.low_freq_factor
    high_wavelen = scaling.original_max_position / scaling.high_freq_factor
    wavelen = torch.tensor(2.0 * math.pi, dtype=f32, device=device) / inv_freq
    smooth = (scaling.original_max_position / wavelen
              - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor
    )
    smooth = torch.clamp(smooth, 0.0, 1.0)
    scaled = (1.0 - smooth) * inv_freq / scaling.factor + smooth * inv_freq
    return torch.where(
        wavelen > low_wavelen,
        inv_freq / scaling.factor,
        torch.where(wavelen < high_wavelen, inv_freq, scaled),
    )


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, impl: str = "kernel") -> torch.Tensor:
    """Rotate ``x`` [..., seq, heads, head_dim] by the angles
    ``positions [..., seq] * inv_freq``; (x1, x2) -> (x1*cos - x2*sin,
    x2*cos + x1*sin) with x1 the first half of head_dim."""
    if impl == "plain":
        return apply_rope_plain(x, positions, inv_freq)
    return fused.apply_rope(x, positions, inv_freq)
