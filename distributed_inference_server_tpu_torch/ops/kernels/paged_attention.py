"""Paged GQA attention over the flat KV page pool: decode and chunked prefill.

Counterpart of ``distributed_inference_server_tpu/ops/pallas/paged_attention.py``
(``paged_attention_decode`` and ``paged_attention_prefill``, dense pools).
The kernels are CUDA C++ for Hopper in ``csrc/paged_attention.cu`` (design
and bound notes there), built by ``_build.py`` and bound with ctypes.

Each wrapper takes its plain PyTorch version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. ``<wrapper>.launches``
counts wrapper calls that launched (a bf16 decode call launches the split
attention kernel and its merge; it counts once). Plain calls never count.

Bound on the H100 at the serving shapes (llama-3.2-1b: H=32, KV=8, D=64,
bf16, page_size 16): decode is bound by bytes — it reads ``4 * KV * D``
bytes of K/V per valid token and row (~2 KB) for ~4 flops per byte — so
the bf16 decode kernel splits each row's KV range over several blocks to
keep the card's memory system busy at max_batch 8; a 512-token prefill
chunk sits near the balance point and runs on tensor cores. ``PERF.md``
has the measured times beside their bounds.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributed_inference_server_tpu_torch.ops.attention import gqa_attention
from distributed_inference_server_tpu_torch.ops.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DECODE_MAX_GD = 128 * 8  # threads x register accumulators (csrc)
_PREFILL_MAX_GD = 256 * 32


def _tables_slots(page_tables: torch.Tensor, page_size: int,
                  num_pages: int) -> torch.Tensor:
    """[B, P] page ids (clamped to the pool) -> [B, P * page_size] slots."""
    B, P = page_tables.shape
    tables = page_tables.long().clamp(0, num_pages - 1)
    offs = torch.arange(page_size, device=page_tables.device)
    return (tables[:, :, None] * page_size + offs).reshape(B, P * page_size)


def _visible(q_pos: torch.Tensor, kv_valid_len: torch.Tensor,
             sliding_window: int) -> torch.Tensor:
    """[B, T] bool: does query position ``q_pos`` see any key?"""
    hi = torch.minimum(q_pos + 1, kv_valid_len[:, None])
    lo = (q_pos - sliding_window + 1).clamp(min=0) if sliding_window > 0 \
        else torch.zeros_like(q_pos)
    return hi > lo


def paged_prefill_plain(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_tables: torch.Tensor,
    q_start: torch.Tensor,
    kv_valid_len: torch.Tensor,
    *,
    page_size: int,
    sliding_window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Plain version of ``paged_prefill``: gather every row's pages, run
    ``gqa_attention``, and zero queries that see nothing (the kernel's
    contract for fully-masked rows)."""
    B, T, H, D = q.shape
    num_pages = pool_k.shape[0] // page_size
    slots = _tables_slots(page_tables, page_size, num_pages)
    k_seq, v_seq = pool_k[slots], pool_v[slots]
    q_pos = q_start.long()[:, None] + torch.arange(T, device=q.device)
    valid = kv_valid_len.long()
    out = gqa_attention(q, k_seq, v_seq, q_pos, valid, sliding_window,
                        attn_softcap or None)
    seen = _visible(q_pos, valid, int(sliding_window))
    return torch.where(seen[:, :, None, None], out, torch.zeros_like(out))


def paged_decode_plain(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_tables: torch.Tensor,
    kv_valid_len: torch.Tensor,
    *,
    page_size: int,
    sliding_window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Plain version of ``paged_decode``: the query of row b sits at
    position ``kv_valid_len[b] - 1``; rows with ``kv_valid_len == 0`` give
    zeros."""
    return paged_prefill_plain(
        q[:, None], pool_k, pool_v, page_tables, kv_valid_len.long() - 1,
        kv_valid_len, page_size=page_size, sliding_window=sliding_window,
        attn_softcap=attn_softcap,
    )[:, 0]


def _check(q, pool_k, pool_v, page_tables, rows, page_size, max_gd, ints):
    """``max_gd`` bounds G * D for the scalar body; the tensor-core body
    (bf16, D 64 or 128, G <= 64) has no such limit."""
    """Validate what the CUDA kernels take; raises ValueError otherwise."""
    dev = q.device
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged attention takes float32/bfloat16, got {q.dtype}")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {dev}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [num_slots, KV, D]")
    if pool_k.shape != pool_v.shape:
        raise ValueError("pool_k and pool_v shapes differ")
    num_slots, KV, D = pool_k.shape
    H = q.shape[-2]
    if q.shape[-1] != D or H % KV or num_slots % page_size:
        raise ValueError(
            f"bad geometry: q {tuple(q.shape)}, pool {tuple(pool_k.shape)}, "
            f"page_size {page_size}")
    if D % (16 // q.element_size()):
        raise ValueError(f"head_dim {D} must allow 16-byte loads")
    if (not _uses_mma(q.dtype, D, H // KV)) and (H // KV) * D > max_gd:
        raise ValueError(f"G*D = {(H // KV) * D} exceeds the kernel's {max_gd}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t, shape in ints:
        if (t.device != dev or t.dtype != torch.int32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous int32 {shape} on {dev}")
    if page_tables.dim() != 2 or page_tables.shape[0] != rows:
        raise ValueError("page_tables must be [B, P]")
    return num_slots, KV, D, H


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _lib():
    lib = _build.load("paged_attention")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                     ci, ci, ci, ci, ci, cf, vp, vp, ci, ci,
                                     vp]
        lib.paged_decode.restype = ci
        lib.paged_prefill.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                      ci, ci, ci, ci, ci, ci, ci, cf, vp]
        lib.paged_prefill.restype = ci
        lib.paged_attention_uses_mma.argtypes = [ci, ci, ci]
        lib.paged_attention_uses_mma.restype = ci
        lib._argtypes_set = True
    return lib


def _uses_mma(dtype: torch.dtype, D: int, G: int) -> bool:
    """Does the library take its tensor-core body for this geometry?"""
    return bool(_lib().paged_attention_uses_mma(_DTYPE_CODES[dtype], D, G))


@functools.lru_cache(maxsize=8)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_splits(B: int, KV: int, capacity: int, device) -> tuple:
    """(splits, tokens per split) for the tensor-core decode: enough
    (row, KV head, split) blocks for about four per SM, each split a whole
    number of 64-token tiles. Planned from the table capacity (P *
    page_size), never from the data, so nothing is read back."""
    tiles = -(-capacity // 64)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    want = -(-4 * _num_sms(index) // max(1, B * KV))
    splits = max(1, min(tiles, want))
    chunk = -(-tiles // splits) * 64
    return -(-capacity // chunk), chunk


def paged_decode(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_tables: torch.Tensor,
    kv_valid_len: torch.Tensor,
    *,
    page_size: int,
    sliding_window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Decode-step paged GQA attention: q [B, H, D] -> [B, H, D].

    pool_k/pool_v: one layer's [num_slots, KV, D] pool; page_tables [B, P]
    int32; kv_valid_len [B] int32 including the just-written token.
    ``sliding_window`` (0 = full) and ``attn_softcap`` (0 = off) are host
    scalars."""
    if q.device.type == "cpu":
        return paged_decode_plain(
            q, pool_k, pool_v, page_tables, kv_valid_len, page_size=page_size,
            sliding_window=sliding_window, attn_softcap=attn_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode runs on cpu or cuda, not {q.device}")
    B = q.shape[0]
    P = page_tables.shape[1] if page_tables.dim() == 2 else -1
    num_slots, KV, D, H = _check(
        q, pool_k, pool_v, page_tables, B, page_size, _DECODE_MAX_GD,
        [("page_tables", page_tables, (B, P)),
         ("kv_valid_len", kv_valid_len, (B,))])
    out = torch.empty_like(q)
    if B == 0:
        return out
    splits, chunk, part_o, part_ml = 1, P * page_size, None, None
    if _uses_mma(q.dtype, D, H // KV):
        splits, chunk = _decode_splits(B, KV, P * page_size, q.device)
    if splits > 1:
        part_o = torch.empty((B, H, splits, D), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((B, H, splits, 2), dtype=torch.float32,
                              device=q.device)
    err = _lib().paged_decode(
        _DTYPE_CODES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
        pool_v.data_ptr(), page_tables.data_ptr(), kv_valid_len.data_ptr(),
        out.data_ptr(), B, H, KV, D, page_size, P, num_slots // page_size,
        int(sliding_window), float(attn_softcap),
        part_o.data_ptr() if part_o is not None else None,
        part_ml.data_ptr() if part_ml is not None else None, splits, chunk,
        _stream(q))
    _build.check(err, "paged_decode launch")
    paged_decode.launches += 1
    return out


def paged_prefill(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_tables: torch.Tensor,
    q_start: torch.Tensor,
    kv_valid_len: torch.Tensor,
    *,
    page_size: int,
    sliding_window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Chunked-prefill paged GQA attention: q [B, T, H, D] -> [B, T, H, D].

    Query t of row b sits at position ``q_start[b] + t`` (each row's chunk
    is one contiguous run — the engine's layout); K/V of the chunk must
    already be in the pool. q_start/kv_valid_len: [B] int32."""
    if q.device.type == "cpu":
        return paged_prefill_plain(
            q, pool_k, pool_v, page_tables, q_start, kv_valid_len,
            page_size=page_size, sliding_window=sliding_window,
            attn_softcap=attn_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill runs on cpu or cuda, not {q.device}")
    B, T = q.shape[0], q.shape[1]
    P = page_tables.shape[1] if page_tables.dim() == 2 else -1
    num_slots, KV, D, H = _check(
        q, pool_k, pool_v, page_tables, B, page_size, _PREFILL_MAX_GD,
        [("page_tables", page_tables, (B, P)),
         ("q_start", q_start, (B,)),
         ("kv_valid_len", kv_valid_len, (B,))])
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    err = _lib().paged_prefill(
        _DTYPE_CODES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
        pool_v.data_ptr(), page_tables.data_ptr(), q_start.data_ptr(),
        kv_valid_len.data_ptr(), out.data_ptr(), B, T, H, KV, D, page_size,
        P, num_slots // page_size, int(sliding_window), float(attn_softcap),
        _stream(q))
    _build.check(err, "paged_prefill launch")
    paged_prefill.launches += 1
    return out


paged_decode.launches = 0
paged_prefill.launches = 0

