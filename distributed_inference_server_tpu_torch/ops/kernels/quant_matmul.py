"""Group-dequant matmul ``x @ dequant(q, s)`` with its plain version.

Counterpart of ``quant_matmul_pallas`` in
``distributed_inference_server_tpu/ops/pallas/fused.py`` (bodies
``_q8_matmul_kernel`` and ``_q4_matmul_kernel``). The kernel is CUDA C++
for Hopper in ``csrc/quant_matmul.cu`` (design and bound notes there),
built by ``_build.py`` and bound with ctypes.

``quant_matmul(x, w)`` takes a ``Q8Tensor`` (int8 codes [K, N]) or a
``Q4Tensor`` (packed int4 [K/2, N]) and dispatches to ``quant_matmul_q8``
or ``quant_matmul_q4``; each counts its launches in ``<wrapper>.launches``
(a split-K call launches the product and its merge; it counts once). On
CPU tensors the wrappers run ``quant_matmul_plain`` — the JAX package's
default ``_mm``, ``x @ dequantize(w, x.dtype)`` — and never count; on CUDA
tensors they launch the kernel or raise. The JAX package's shape gate and
XLA fallback are not ported: the kernel takes any M, any N and any K that
its group size divides.

Bound on the H100: bytes at decode (M <= 8: every code is read once for
~2M flops per byte), operations at a prefill chunk (M = 2048).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributed_inference_server_tpu_torch.ops.kernels import _build
from distributed_inference_server_tpu_torch.ops.quant import (
    Q4Tensor,
    Q8Tensor,
    dequantize,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMALL_M = 16  # csrc: the decode tile (BM = 16, BK = 64) splits K
_SPLIT_ROWS = 64  # a split covers whole 64-row tiles
_MAX_SPLITS = 16


def quant_matmul_plain(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ dequantize(w, x.dtype) -> [..., N] in x.dtype."""
    return x @ dequantize(w, x.dtype)


def _lib():
    lib = _build.load("quant_matmul")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.quant_matmul.argtypes = [ci, ci, vp, vp, vp, vp, vp, ci, ci, ci,
                                     ci, ci, ci, ci, ci, vp]
        lib.quant_matmul.restype = ci
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=8)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(M: int, K: int, N: int, dtype: torch.dtype, device) -> tuple:
    """(splits, rows per split) of K for the bf16 decode tile: about four
    blocks per SM over (N / 128 column blocks) x splits, each split a
    whole number of 64-row tiles. Larger M (its own tile) and f32 run
    unsplit."""
    if dtype != torch.bfloat16 or M > _SMALL_M:
        return 1, K
    tiles = -(-K // _SPLIT_ROWS)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    want = -(-4 * _num_sms(index) // -(-N // 128))
    splits = max(1, min(tiles, want, _MAX_SPLITS))
    rows = -(-tiles // splits) * _SPLIT_ROWS
    return -(-K // rows), rows


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _launch(x: torch.Tensor, w, packed: bool) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"quant_matmul takes float32/bfloat16 x, got {x.dtype}")
    q, s = w.q, w.s
    code_dtype = torch.uint8 if packed else torch.int8
    for name, t, dt in (("codes", q, code_dtype), ("scales", s, torch.float32)):
        if t.device != x.device or t.dtype != dt or t.dim() != 2 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D {dt} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)}")
    K = q.shape[0] * (2 if packed else 1)
    N = q.shape[1]
    groups = s.shape[0]
    if s.shape[1] != N or groups == 0 or K % groups:
        raise ValueError(f"scales {tuple(s.shape)} do not fit codes "
                         f"{tuple(q.shape)}")
    G = K // groups
    if x.shape[-1] != K or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [..., {K}], got "
                         f"{tuple(x.shape)}")
    M = x.numel() // K
    out = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    splits, rows = _splits(M, K, N, x.dtype, x.device)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    vec_x = int(K % (16 // x.element_size()) == 0 and _aligned(x))
    vec_q = int(N % 16 == 0 and _aligned(q) and _aligned(s))
    err = _lib().quant_matmul(
        _DTYPE_CODES[x.dtype], int(packed), x.data_ptr(), q.data_ptr(),
        s.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, M, K, N, G, splits,
        rows, vec_x, vec_q,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(err, "quant_matmul launch")
    return out


def quant_matmul_q8(x: torch.Tensor, w: Q8Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(int8 codes [K, N], scales [K/G, N])."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cpu or cuda, not {x.device}")
    out = _launch(x, w, packed=False)
    quant_matmul_q8.launches += 1
    return out


def quant_matmul_q4(x: torch.Tensor, w: Q4Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(packed int4 codes [K/2, N], scales [K/G, N])."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cpu or cuda, not {x.device}")
    out = _launch(x, w, packed=True)
    quant_matmul_q4.launches += 1
    return out


def quant_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ dequant(w) in x.dtype, for a 2-D ``Q8Tensor`` or
    ``Q4Tensor`` weight."""
    if isinstance(w, Q8Tensor):
        return quant_matmul_q8(x, w)
    if isinstance(w, Q4Tensor):
        return quant_matmul_q4(x, w)
    raise TypeError(f"quant_matmul takes a Q8Tensor or Q4Tensor, got {type(w)}")


quant_matmul_q8.launches = 0
quant_matmul_q4.launches = 0
