"""RMSNorm and RoPE kernels with their plain versions.

Counterpart of ``distributed_inference_server_tpu/ops/pallas/fused.py``
(``rms_norm_pallas``, ``apply_rope_pallas``; the group-dequant matmul is
not ported yet). The kernels are Triton (``_triton_fused.py``): RMSNorm is
a row reduction plus an elementwise scale, RoPE a pure elementwise pass
with sin and cos — neither needs tensor cores, and masked block loads give
coalesced access. ``triton`` is imported inside the launching function, so
the module imports on machines without it.

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. ``<wrapper>.launches`` counts
kernel launches.

Bound on the H100: bytes. RMSNorm reads x and w and writes y once (at a
decode step of 8 rows x 2048 bf16: ~70 KB); RoPE reads x, the positions
and inv_freq and writes the rotated x once. Neither keeps an intermediate
in device memory (the angle, sin and cos live in registers).
"""

from __future__ import annotations

import torch

_FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16)


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w, in f32, cast back to x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def apply_rope_plain(x: torch.Tensor, positions: torch.Tensor,
                     inv_freq: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE: x [..., T, nh, D], positions [..., T], inv_freq
    [D/2]; (x1, x2) -> (x1*cos - x2*sin, x2*cos + x1*sin), in f32."""
    angles = positions[..., None].float() * inv_freq.float()
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis: x [..., H], weight [H]."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cpu or cuda, not {x.device}")
    H = x.shape[-1]
    if x.dtype not in _FLOAT_TYPES or not x.is_contiguous():
        raise ValueError(f"rms_norm takes a contiguous float tensor, got "
                         f"{x.dtype} contiguous={x.is_contiguous()}")
    if (weight.device != x.device or tuple(weight.shape) != (H,)
            or not weight.is_contiguous()):
        raise ValueError(f"weight must be a contiguous [{H}] on {x.device}")
    out = torch.empty_like(x)
    M = x.numel() // H if H else 0
    if M == 0:
        return out
    from distributed_inference_server_tpu_torch.ops.kernels import _triton_fused

    _triton_fused.launch_rms_norm(x.view(M, H), weight, out.view(M, H),
                                  float(eps))
    rms_norm.launches += 1
    return out


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE; the angle positions * inv_freq is formed in f32
    inside the kernel."""
    if x.device.type == "cpu":
        return apply_rope_plain(x, positions, inv_freq)
    if x.device.type != "cuda":
        raise ValueError(f"apply_rope runs on cpu or cuda, not {x.device}")
    if x.dim() < 3 or x.shape[-1] % 2:
        raise ValueError(f"apply_rope takes x [..., T, nh, D] with even D, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in _FLOAT_TYPES or not x.is_contiguous():
        raise ValueError("x must be a contiguous float tensor")
    nh, D = x.shape[-2], x.shape[-1]
    if (positions.device != x.device or tuple(positions.shape) != tuple(x.shape[:-2])
            or positions.dtype not in (torch.int32, torch.int64)
            or not positions.is_contiguous()):
        raise ValueError(f"positions must be a contiguous int "
                         f"{tuple(x.shape[:-2])} on {x.device}")
    if (inv_freq.device != x.device or inv_freq.dtype != torch.float32
            or tuple(inv_freq.shape) != (D // 2,)):
        raise ValueError(f"inv_freq must be float32 [{D // 2}] on {x.device}")
    out = torch.empty_like(x)
    M = positions.numel()
    if M == 0:
        return out
    from distributed_inference_server_tpu_torch.ops.kernels import _triton_fused

    _triton_fused.launch_rope(x.view(M, nh, D), positions.view(M),
                              inv_freq.contiguous(), out.view(M, nh, D))
    apply_rope.launches += 1
    return out


rms_norm.launches = 0
apply_rope.launches = 0
