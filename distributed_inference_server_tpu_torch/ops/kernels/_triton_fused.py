"""Triton kernels for RMSNorm and RoPE (imported only by the launching
functions in ``ops/kernels/fused.py``, on a machine with a card).

Replaces ``distributed_inference_server_tpu/ops/pallas/fused.py``:
``rms_norm_pallas`` (``_rms_norm_kernel``) and ``apply_rope_pallas``
(``_rope_kernel``). Both are single passes over their input: one program
per row (RMSNorm: one hidden vector; RoPE: one token, all of its heads),
f32 arithmetic, one load of every input byte and one store of every output
byte — the whole of their bytes bound.
"""

from __future__ import annotations

import os

from distributed_inference_server_tpu_torch.ops.kernels._build import build_root

os.environ.setdefault("TRITON_CACHE_DIR", str(build_root() / "triton"))

import triton  # noqa: E402
import triton.language as tl  # noqa: E402

try:  # Triton >= 3.0
    from triton.language.extra import libdevice  # noqa: E402
except ImportError:  # pragma: no cover - older layouts
    from triton.language.extra.cuda import libdevice  # noqa: E402


@triton.jit
def rms_norm_kernel(x_ptr, w_ptr, o_ptr, H, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    offs = tl.arange(0, BLOCK)
    mask = offs < H
    x = tl.load(x_ptr + row * H + offs, mask=mask, other=0.0).to(tl.float32)
    ms = tl.sum(x * x, axis=0) / H
    inv = 1.0 / tl.sqrt(ms + eps)
    w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    y = x * inv * w
    tl.store(o_ptr + row * H + offs, y.to(o_ptr.dtype.element_ty), mask=mask)


@triton.jit
def rope_kernel(x_ptr, pos_ptr, inv_ptr, o_ptr, NH, HALF,
                BLOCK_H: tl.constexpr, BLOCK_D: tl.constexpr):
    tok = tl.program_id(0).to(tl.int64)
    hs = tl.arange(0, BLOCK_H)[:, None]
    ds = tl.arange(0, BLOCK_D)[None, :]
    dmask = ds < HALF
    mask = (hs < NH) & dmask
    pos = tl.load(pos_ptr + tok).to(tl.float32)
    inv = tl.load(inv_ptr + ds, mask=dmask, other=0.0).to(tl.float32)
    ang = pos * inv  # the angle is formed in f32 inside the kernel
    c = libdevice.cos(ang)
    s = libdevice.sin(ang)
    base = tok * NH * 2 * HALF + hs * (2 * HALF) + ds
    x1 = tl.load(x_ptr + base, mask=mask, other=0.0).to(tl.float32)
    x2 = tl.load(x_ptr + base + HALF, mask=mask, other=0.0).to(tl.float32)
    tl.store(o_ptr + base, (x1 * c - x2 * s).to(o_ptr.dtype.element_ty),
             mask=mask)
    tl.store(o_ptr + base + HALF, (x2 * c + x1 * s).to(o_ptr.dtype.element_ty),
             mask=mask)


def launch_rms_norm(x2d, w, out, eps: float) -> None:
    M, H = x2d.shape
    block = triton.next_power_of_2(H)
    num_warps = 8 if block >= 4096 else (4 if block >= 1024 else 1)
    rms_norm_kernel[(M,)](x2d, w, out, H, eps, BLOCK=block,
                          num_warps=num_warps)


def launch_rope(x3d, pos, inv_freq, out) -> None:
    M, NH, D = x3d.shape
    half = D // 2
    bh = triton.next_power_of_2(NH)
    bd = triton.next_power_of_2(half)
    num_warps = 4 if bh * bd >= 1024 else 1
    rope_kernel[(M,)](x3d, pos, inv_freq, out, NH, half, BLOCK_H=bh,
                      BLOCK_D=bd, num_warps=num_warps)
