"""Normalization ops (port of ``distributed_inference_server_tpu/ops/norms.py``).

RMSNorm computes the variance in f32 whatever the activation dtype, then
casts back. ``impl="kernel"`` (the default) goes through the RMSNorm
kernel's wrapper (``ops/kernels/fused.py``), which launches the Triton
kernel for a CUDA tensor and runs the plain version for a CPU tensor;
``impl="plain"`` runs the plain version on any device (the reference path
that ``chip_smoke.py`` holds the kernel path against).
"""

from __future__ import annotations

import torch

from distributed_inference_server_tpu_torch.ops.kernels import fused
from distributed_inference_server_tpu_torch.ops.kernels.fused import (
    rms_norm_plain,
)

__all__ = ["rms_norm", "rms_norm_plain"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             impl: str = "kernel") -> torch.Tensor:
    """y = x / rms(x) * weight, computed in f32. x: [..., H]; weight: [H]."""
    if impl == "plain":
        return rms_norm_plain(x, weight, eps)
    return fused.rms_norm(x, weight, eps)
