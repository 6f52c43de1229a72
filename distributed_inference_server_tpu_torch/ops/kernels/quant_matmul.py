"""Group-dequant matmul ``x @ dequant(q, s)`` with its plain version.

Counterpart of ``quant_matmul_pallas`` in
``distributed_inference_server_tpu/ops/pallas/fused.py`` (bodies
``_q8_matmul_kernel`` and ``_q4_matmul_kernel``). The kernel is CUDA C++
for Hopper in ``csrc/quant_matmul.cu`` (design and bound notes there),
built by ``_build.py`` and bound with ctypes.

``quant_matmul(x, w)`` takes a ``Q8Tensor`` (int8 codes [K, N]) or a
``Q4Tensor`` (packed int4 [K/2, N]) and dispatches to ``quant_matmul_q8``
or ``quant_matmul_q4``; each counts its launches in ``<wrapper>.launches``
(one per call: a split-K call merges its partial sums in the same launch). On
CPU tensors the wrappers run ``quant_matmul_plain`` — the JAX package's
default ``_mm``, ``x @ dequantize(w, x.dtype)`` — and never count; on CUDA
tensors they launch the kernel or raise. The JAX package's shape gate and
XLA fallback are not ported: the kernel takes any M, any N and any K that
its group size divides.

Bound on the H100: bytes at decode (M <= 16: every code is read once for
~2M flops per byte), operations at a prefill chunk (M = 2048). ``plan``
picks the decode body's column block and K split from the shapes and the
card's SM count; it is plain Python, tested on the CPU.
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
_SMALL_M = 16  # csrc: M <= 16 runs the decode body (K split over blocks)
_TILE_K = 64  # csrc: k rows per tile; a split covers whole tiles
_DECODE_BN = (128, 64, 32)  # csrc: the decode body's column blocks
_MIN_PER_SM = 2  # the fewest decode blocks per SM before the block narrows
_MAX_SPLITS = 32  # the last block of a column adds this many partial tiles
# csrc: the prefill body's tiles (rows, columns), in order of preference:
# fewer dequantizations and shared-memory bytes per product first
_PREFILL_TILES = ((256, 128), (128, 128))


def quant_matmul_plain(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ dequantize(w, x.dtype) -> [..., N] in x.dtype."""
    return x @ dequantize(w, x.dtype)


def _lib():
    lib = _build.load("quant_matmul")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.quant_matmul.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, ci, ci,
                                     ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.quant_matmul.restype = ci
        lib.quant_matmul_decode_blocks_per_sm.argtypes = [
            ci, ci, ctypes.POINTER(ci)]
        lib.quant_matmul_decode_blocks_per_sm.restype = ci
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=8)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(M: int, K: int, N: int, dtype: torch.dtype, sms: int,
         resident=None) -> tuple:
    """(rows, columns of a block's tile, splits, rows of K per split) of a
    call on a card with ``sms`` SMs. bf16 with M <= 16 runs the decode body: the widest column
    block (128, 64, 32) whose grid, with K split into whole 64-row tiles
    (at most ``_MAX_SPLITS``, none empty), can reach ``_MIN_PER_SM`` blocks
    per SM; then the split count that finishes soonest, counting the waves
    of ``resident[bn]`` blocks per SM times the tiles of one block (fewer
    splits on a tie). bf16 with M > 16 runs the prefill body unsplit on
    the first tile (256 x 128, else 128 x 128) whose grid still gives
    every SM a block. float32 runs one unsplit launch (tile 0 x 0: the
    body's own)."""
    if dtype != torch.bfloat16:
        return 0, 0, 1, K
    if M > _SMALL_M:
        for bm, bn in _PREFILL_TILES:
            if -(-M // bm) * -(-N // bn) >= sms:
                break
        return bm, bn, 1, K
    units = -(-K // _TILE_K)
    top = min(units, _MAX_SPLITS)
    for bn in _DECODE_BN:
        cols = -(-N // bn)
        if cols * top >= _MIN_PER_SM * sms or bn == _DECODE_BN[-1]:
            break
    slots = resident[bn] * sms
    best = None
    for splits in range(1, top + 1):
        per = -(-units // splits)
        if -(-units // per) != splits:  # an empty split: take fewer
            continue
        fill = cols * splits >= min(_MIN_PER_SM * sms, cols * top)
        cost = -(-cols * splits // slots) * per
        key = (not fill, cost, splits)
        if best is None or key < best[0]:
            best = (key, splits, per * _TILE_K)
    return 16, bn, best[1], best[2]


@functools.lru_cache(maxsize=16)
def _resident(index: int, packed: bool) -> dict:
    """Decode blocks one SM holds, per column block (the kernel's own
    occupancy query)."""
    out = {}
    for bn in _DECODE_BN:
        n = ctypes.c_int(0)
        _build.check(_lib().quant_matmul_decode_blocks_per_sm(
            bn, int(packed), ctypes.byref(n)), "quant_matmul occupancy")
        out[bn] = n.value
    return out


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
    index = x.device.index if x.device.index is not None else \
        torch.cuda.current_device()
    resident = (_resident(index, packed)
                if x.dtype == torch.bfloat16 and M <= _SMALL_M else None)
    bm, bn, splits, rows = plan(M, K, N, x.dtype, _num_sms(index), resident)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part = ticket = None
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device)
        ticket = _build.ticket_buffer(x.device, stream, -(-N // bn))
    vec_x = int(K % (16 // x.element_size()) == 0 and _aligned(x))
    vec_q = int(N % 16 == 0 and _aligned(q) and _aligned(s))
    err = _lib().quant_matmul(
        _DTYPE_CODES[x.dtype], int(packed), x.data_ptr(), q.data_ptr(),
        s.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        ticket.data_ptr() if ticket is not None else None, M, K, N, G, bm,
        bn, splits, rows, vec_x, vec_q, ctypes.c_void_p(stream))
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
