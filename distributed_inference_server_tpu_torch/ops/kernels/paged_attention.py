"""Paged GQA attention over the flat KV page pool: decode, chunked prefill
and the ragged mixed batch.

Counterpart of ``distributed_inference_server_tpu/ops/pallas/paged_attention.py``
(``paged_attention_decode``, ``paged_attention_prefill`` and
``paged_attention_ragged`` over dense pools, and ``paged_attention_decode``
over int8 ``QuantPool`` pools: ``paged_decode`` hands those to
``paged_decode_int8``, which has its own launch count).
The kernels are CUDA C++ for Hopper in ``csrc/paged_attention.cu`` (design
and bound notes there), built by ``_build.py`` and bound with ctypes.

Each wrapper takes its plain PyTorch version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. ``<wrapper>.launches``
counts wrapper calls that launched; every call is one launch (a split
launch merges its splits in the same launch). Plain calls never count.

Bound on the H100 at the serving shapes (llama-3.2-1b: H=32, KV=8, D=64,
bf16, page_size 16): decode is bound by bytes — it reads ``4 * KV * D``
bytes of K/V per valid token and row (~2 KB) for ~4 flops per byte — so
the bf16 decode splits each row's KV range over several blocks, planned by
``decode_plan`` (plain Python, tested on the CPU) from the table capacity
and the kernel's own count of resident blocks per SM, so that the blocks
fill the card in one wave. The int8 decode reads 2 D + 8 bytes per valid
token and KV head (codes and two f32 scales) instead of 4 D: about half
the bytes of the bf16 decode, whose body, split plan and merge it shares.

Chunked prefill (replacing ``paged_attention_prefill``) is bound by
operations: a [4, 512] chunk does ~4 flops per (query head, visible key,
dim) against a comparable number of bytes. The ragged kernel (replacing
``paged_attention_ragged``: the mixed step's packed axis of decode tokens
and prefill chunks, cut into per-row segments of the axis) is bound by
bytes at the served mix. Both run one Hopper body: 128 (query, head) rows
per block on two warpgroups, a ``cp.async`` ring of row-major K/V stages
read by ``wgmma`` for both products, the mask only on tiles that need it,
and a KV split merged in the same launch, planned by ``attend_plan`` from
the capacity, the grid's static size and the body's resident blocks per
SM. At D 256 (Gemma-2) the prefill / ragged body's ring holds 32-key
stages and the decode body reads its query fragments from shared memory
(``csrc`` header); the split plans count in 64-token units either way.
Prefill splits only where its grid leaves the card idle; ragged caps
a split at ``RAGGED_MAX_STAGES`` stages, so its longest block is a few
stages plus the merge rather than a 2048-token row's whole history. What
is left: each block's serial chain per stage (Q K^T, softmax, P V, with
the two warpgroups in step). ``PERF.md`` has the measured times beside
their bounds.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributed_inference_server_tpu_torch.ops.attention import (
    gqa_attention,
    ragged_gqa_attention,
)
from distributed_inference_server_tpu_torch.ops.kernels import _build, _launches
from distributed_inference_server_tpu_torch.ops.quant import (
    QuantPool,
    dequantize_kv,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DECODE_MAX_GD = 128 * 8  # threads x register accumulators (csrc)
_PREFILL_MAX_GD = 256 * 32
# packed tokens per ragged_gqa_attention call in the plain ragged version:
# each token gathers its row's whole window, so chunks bound the memory
_RAGGED_PLAIN_CHUNK = 128


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


def paged_decode_int8_plain(
    q: torch.Tensor,
    pool_k: QuantPool,
    pool_v: QuantPool,
    page_tables: torch.Tensor,
    kv_valid_len: torch.Tensor,
    *,
    page_size: int,
    sliding_window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Plain version of ``paged_decode_int8``: gather each row's codes and
    scales page by page, ``dequantize_kv`` them to q.dtype, run
    ``gqa_attention``; rows that see nothing give zeros."""
    num_pages = pool_k.data.shape[0] // page_size
    slots = _tables_slots(page_tables, page_size, num_pages)
    k_seq = dequantize_kv(pool_k.data[slots], pool_k.scale[slots], q.dtype)
    v_seq = dequantize_kv(pool_v.data[slots], pool_v.scale[slots], q.dtype)
    valid = kv_valid_len.long()
    q_pos = (valid - 1)[:, None]
    out = gqa_attention(q[:, None], k_seq, v_seq, q_pos, valid,
                        sliding_window, attn_softcap or None)
    seen = _visible(q_pos, valid, int(sliding_window))
    return torch.where(seen[:, :, None, None], out, torch.zeros_like(out))[:, 0]


def paged_ragged_plain(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_tables: torch.Tensor,
    tok_row: torch.Tensor,
    q_pos: torch.Tensor,
    kv_valid_len: torch.Tensor,
    *,
    page_size: int,
    sliding_window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Plain version of ``paged_ragged``: gather every row's pages, run
    ``ragged_gqa_attention`` over the packed tokens, and zero padding
    tokens and tokens that see no key (the kernel's contract)."""
    S = q.shape[0]
    Bm = page_tables.shape[0]
    if S == 0 or Bm == 0:
        return torch.zeros_like(q)
    num_pages = pool_k.shape[0] // page_size
    slots = _tables_slots(page_tables, page_size, num_pages)
    k_seq, v_seq = pool_k[slots], pool_v[slots]  # [Bm, P * page_size, KV, D]
    rows = tok_row.long()
    pos = q_pos.long()
    valid = kv_valid_len.long()
    out = torch.cat([
        ragged_gqa_attention(
            q[c:c + _RAGGED_PLAIN_CHUNK], k_seq, v_seq,
            rows[c:c + _RAGGED_PLAIN_CHUNK], pos[c:c + _RAGGED_PLAIN_CHUNK],
            valid, sliding_window, attn_softcap or None)
        for c in range(0, S, _RAGGED_PLAIN_CHUNK)])
    seen = _visible(pos[:, None], valid[rows.clamp(0, Bm - 1)],
                    int(sliding_window))[:, 0] & (rows >= 0)
    return torch.where(seen[:, None, None], out, torch.zeros_like(out))


def _check_pools(pools, dtype, dim, dev):
    """Each (name, tensor) must be a contiguous ``dtype`` tensor of ``dim``
    axes on ``dev``, all of one shape."""
    for name, t in pools:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous with {dim} axes")
    if len({tuple(t.shape) for _, t in pools}) != 1:
        raise ValueError(f"{' and '.join(n for n, _ in pools)} shapes differ")


def _check(q, pool_k, pool_v, page_tables, rows, page_size, max_gd, ints):
    """Validate what the CUDA kernels take; raises ValueError otherwise.
    ``max_gd`` bounds G * D for the scalar body; the tensor-core bodies
    (bf16, D 64, 128 or 256, G <= 64) have no such limit. Int8 pools
    (``QuantPool``) need int8 codes [num_slots, KV, D] with D a multiple
    of 16 and f32 scales [num_slots, KV]."""
    dev = q.device
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged attention takes float32/bfloat16, got {q.dtype}")
    if isinstance(pool_k, QuantPool):
        _check_pools((("pool_k codes", pool_k.data),
                      ("pool_v codes", pool_v.data)), torch.int8, 3, dev)
        _check_pools((("pool_k scales", pool_k.scale),
                      ("pool_v scales", pool_v.scale)), torch.float32, 2, dev)
        if tuple(pool_k.scale.shape) != tuple(pool_k.data.shape[:2]):
            raise ValueError("scales must be [num_slots, KV]")
        codes, load = pool_k.data, 16
    else:
        _check_pools((("pool_k", pool_k), ("pool_v", pool_v)), q.dtype, 3,
                     dev)
        codes, load = pool_k, 16 // q.element_size()
    num_slots, KV, D = codes.shape
    H = q.shape[-2]
    if q.shape[-1] != D or H % KV or num_slots % page_size:
        raise ValueError(
            f"bad geometry: q {tuple(q.shape)}, pool {tuple(codes.shape)}, "
            f"page_size {page_size}")
    if D % load:
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
                                     ci, ci, ci, ci, ci, cf, vp, vp, vp, ci,
                                     ci, vp]
        lib.paged_decode.restype = ci
        lib.paged_decode_int8.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp,
                                          ci, ci, ci, ci, ci, ci, ci, ci, cf,
                                          vp, vp, vp, ci, ci, vp]
        lib.paged_decode_int8.restype = ci
        lib.paged_prefill.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                      ci, ci, ci, ci, ci, ci, ci, cf, vp, vp,
                                      vp, ci, ci, vp]
        lib.paged_prefill.restype = ci
        lib.paged_ragged.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp, ci,
                                     ci, ci, ci, ci, ci, ci, ci, ci, cf, vp,
                                     vp, vp, ci, ci, vp]
        lib.paged_ragged.restype = ci
        lib.paged_attention_uses_mma.argtypes = [ci, ci, ci]
        lib.paged_attention_uses_mma.restype = ci
        lib.paged_decode_blocks_per_sm.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.paged_decode_blocks_per_sm.restype = ci
        lib.paged_attend_blocks_per_sm.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.paged_attend_blocks_per_sm.restype = ci
        lib._argtypes_set = True
    return lib


def _uses_mma(dtype: torch.dtype, D: int, G: int) -> bool:
    """Does the library take its tensor-core body for this geometry?"""
    return bool(_lib().paged_attention_uses_mma(_DTYPE_CODES[dtype], D, G))


@functools.lru_cache(maxsize=8)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_STAGE_TK = 64  # csrc kDecTK / kAttTK: tokens per split unit (a stage)
_MAX_PAGES = 256  # csrc kDecMaxPages / kAttMaxPages: page ids a block holds
_ATTEND_ROWS = 128  # csrc kAttRows: (query, head) rows of a prefill block
# the most stages one ragged split walks: the launch's longest chain is a
# few stages plus the merge, whatever the rows' lengths
RAGGED_MAX_STAGES = 8


def split_plan(blocks: int, capacity: int, page_size: int, sms: int,
               per_sm: int, max_stages: int = 0) -> tuple:
    """(splits, tokens per split) of a launch of ``blocks`` blocks before
    the split over tables of ``capacity`` tokens (P * page_size), on a
    card with ``sms`` SMs each holding ``per_sm`` of the kernel's blocks.
    As many splits as let the blocks fill the SMs in one wave, each split
    a whole number of 64-token stages, no split empty; a split spans few
    enough pages for the block's page-id list, and at most ``max_stages``
    stages when that is given (more splits, in more waves, when a split
    would not). Planned from the capacity, never from the data, so
    nothing is read back to the host."""
    tiles = max(1, -(-capacity // _STAGE_TK))
    splits = max(1, min(tiles, sms * per_sm // max(1, blocks)))
    per = min(-(-tiles // splits),
              max(1, (_MAX_PAGES - 2) * page_size // _STAGE_TK))
    if max_stages > 0:
        per = min(per, max_stages)
    chunk = per * _STAGE_TK
    return max(1, -(-capacity // chunk)), chunk


def decode_plan(B: int, KV: int, capacity: int, page_size: int, sms: int,
                per_sm: int) -> tuple:
    """(splits, tokens per split) of a tensor-core decode launch: one block
    per (row, KV head) before the split (``split_plan``)."""
    return split_plan(B * KV, capacity, page_size, sms, per_sm)


def attend_tq(H: int, KV: int) -> int:
    """Queries per block of the prefill / ragged tensor-core body: its 128
    (query, head) rows hold 128 // G queries of G = H / KV heads each. The
    ragged segments are runs of one row inside windows of this width."""
    return _ATTEND_ROWS // (H // KV)


def attend_tiles(H: int, KV: int, T: int, B: int, ragged: bool) -> int:
    """Query tiles of a prefill (B rows of T queries) or ragged (a packed
    axis of T tokens over B rows: its static bound of ceil(T / TQ) + B
    segments) launch, before the KV heads and the split."""
    tq = attend_tq(H, KV)
    return -(-T // tq) + B if ragged else B * -(-T // tq)


def attend_plan(H: int, KV: int, T: int, B: int, capacity: int,
                page_size: int, sms: int, per_sm: int, ragged: bool) -> tuple:
    """(splits, tokens per split) of a prefill or ragged launch of the
    tensor-core body. Prefill splits only where its grid leaves the card
    idle (one wave); ragged also caps a split at ``RAGGED_MAX_STAGES``
    stages, since its long decode rows and deep chunks would otherwise
    walk their whole history in one block."""
    blocks = attend_tiles(H, KV, T, B, ragged) * KV
    return split_plan(blocks, capacity, page_size, sms, per_sm,
                      RAGGED_MAX_STAGES if ragged else 0)


def attend_partial_shapes(tiles: int, KV: int, D: int, splits: int) -> tuple:
    """Shapes of a split prefill / ragged launch's f32 partial buffers:
    unnormalized outputs [tiles, KV, splits, 128, D] and (max, sum) pairs
    [tiles, KV, splits, 128, 2]."""
    return ((tiles, KV, splits, _ATTEND_ROWS, D),
            (tiles, KV, splits, _ATTEND_ROWS, 2))


def partial_shapes(B: int, H: int, D: int, splits: int) -> tuple:
    """Shapes of a split decode's f32 partial buffers: unnormalized outputs
    [B, H, splits, D] and (max, sum) pairs [B, H, splits, 2]."""
    return (B, H, splits, D), (B, H, splits, 2)


@functools.lru_cache(maxsize=16)
def _decode_per_sm(index: int, D: int, int8: bool) -> int:
    """Decode blocks one SM holds (the kernel's own occupancy query)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(_lib().paged_decode_blocks_per_sm(
            D, int(int8), ctypes.byref(n)), "paged_decode occupancy")
    if n.value < 1:
        raise RuntimeError(f"paged_decode: no block of D={D} fits an SM")
    return n.value


@functools.lru_cache(maxsize=16)
def _attend_per_sm(index: int, D: int, ragged: bool) -> int:
    """Prefill / ragged blocks one SM holds (the kernel's own occupancy
    query)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(_lib().paged_attend_blocks_per_sm(
            D, int(ragged), ctypes.byref(n)), "paged attention occupancy")
    if n.value < 1:
        raise RuntimeError(f"paged attention: no block of D={D} fits an SM")
    return n.value


def _attend_launch(q, T, B, H, KV, D, P, page_size, ragged: bool) -> tuple:
    """(splits, tokens per split, partial outputs, partial max/sum, ticket)
    of a prefill or ragged launch: the plan and buffers of the tensor-core
    body; one unsplit pass and no buffers for the scalar body."""
    if not _uses_mma(q.dtype, D, H // KV):
        return 1, max(1, P * page_size), None, None, None
    index = q.device.index
    splits, chunk = attend_plan(H, KV, T, B, P * page_size, page_size,
                                _num_sms(index),
                                _attend_per_sm(index, D, ragged), ragged)
    if splits == 1:
        return splits, chunk, None, None, None
    tiles = attend_tiles(H, KV, T, B, ragged)
    o_shape, ml_shape = attend_partial_shapes(tiles, KV, D, splits)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (splits, chunk,
            torch.empty(o_shape, dtype=torch.float32, device=q.device),
            torch.empty(ml_shape, dtype=torch.float32, device=q.device),
            _build.ticket_buffer(q.device, stream, tiles * KV))


def _split_launch(q, B, H, KV, D, P, page_size, int8: bool) -> tuple:
    """(splits, tokens per split, partial outputs, partial max/sum, ticket)
    of a decode launch: the plan and buffers of the tensor-core body; one
    unsplit pass and no buffers for the scalar body."""
    if not _uses_mma(q.dtype, D, H // KV):
        return 1, max(1, P * page_size), None, None, None
    index = q.device.index
    splits, chunk = decode_plan(B, KV, P * page_size, page_size,
                                _num_sms(index), _decode_per_sm(index, D,
                                                                int8))
    if splits == 1:
        return splits, chunk, None, None, None
    o_shape, ml_shape = partial_shapes(B, H, D, splits)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (splits, chunk,
            torch.empty(o_shape, dtype=torch.float32, device=q.device),
            torch.empty(ml_shape, dtype=torch.float32, device=q.device),
            _build.ticket_buffer(q.device, stream, B * KV))


def _ptr(t):
    return t.data_ptr() if t is not None else None


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

    pool_k/pool_v: one layer's [num_slots, KV, D] pool, or its int8
    ``QuantPool`` (then ``paged_decode_int8`` runs); page_tables [B, P]
    int32; kv_valid_len [B] int32 including the just-written token.
    ``sliding_window`` (0 = full) and ``attn_softcap`` (0 = off) are host
    scalars."""
    if isinstance(pool_k, QuantPool):
        return paged_decode_int8(
            q, pool_k, pool_v, page_tables, kv_valid_len, page_size=page_size,
            sliding_window=sliding_window, attn_softcap=attn_softcap)
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
    splits, chunk, part_o, part_ml, ticket = _split_launch(
        q, B, H, KV, D, P, page_size, int8=False)
    err = _lib().paged_decode(
        _DTYPE_CODES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
        pool_v.data_ptr(), page_tables.data_ptr(), kv_valid_len.data_ptr(),
        out.data_ptr(), B, H, KV, D, page_size, P, num_slots // page_size,
        int(sliding_window), float(attn_softcap), _ptr(part_o),
        _ptr(part_ml), _ptr(ticket), splits, chunk, _stream(q))
    _build.check(err, "paged_decode launch")
    _launches.count(paged_decode)
    return out


def paged_decode_int8(
    q: torch.Tensor,
    pool_k: QuantPool,
    pool_v: QuantPool,
    page_tables: torch.Tensor,
    kv_valid_len: torch.Tensor,
    *,
    page_size: int,
    sliding_window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """``paged_decode`` over int8 pools: pool_k/pool_v are one layer's
    ``QuantPool`` (int8 codes [num_slots, KV, D], f32 scales [num_slots,
    KV]); q [B, H, D] -> [B, H, D] in q.dtype."""
    if q.device.type == "cpu":
        return paged_decode_int8_plain(
            q, pool_k, pool_v, page_tables, kv_valid_len, page_size=page_size,
            sliding_window=sliding_window, attn_softcap=attn_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_int8 runs on cpu or cuda, not {q.device}")
    B = q.shape[0]
    P = page_tables.shape[1] if page_tables.dim() == 2 else -1
    num_slots, KV, D, H = _check(
        q, pool_k, pool_v, page_tables, B, page_size, _DECODE_MAX_GD,
        [("page_tables", page_tables, (B, P)),
         ("kv_valid_len", kv_valid_len, (B,))])
    out = torch.empty_like(q)
    if B == 0:
        return out
    splits, chunk, part_o, part_ml, ticket = _split_launch(
        q, B, H, KV, D, P, page_size, int8=True)
    err = _lib().paged_decode_int8(
        _DTYPE_CODES[q.dtype], q.data_ptr(), pool_k.data.data_ptr(),
        pool_v.data.data_ptr(), pool_k.scale.data_ptr(),
        pool_v.scale.data_ptr(), page_tables.data_ptr(),
        kv_valid_len.data_ptr(), out.data_ptr(), B, H, KV, D, page_size, P,
        num_slots // page_size, int(sliding_window), float(attn_softcap),
        _ptr(part_o), _ptr(part_ml), _ptr(ticket), splits, chunk, _stream(q))
    _build.check(err, "paged_decode_int8 launch")
    _launches.count(paged_decode_int8)
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
    splits, chunk, part_o, part_ml, ticket = _attend_launch(
        q, T, B, H, KV, D, P, page_size, ragged=False)
    err = _lib().paged_prefill(
        _DTYPE_CODES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
        pool_v.data_ptr(), page_tables.data_ptr(), q_start.data_ptr(),
        kv_valid_len.data_ptr(), out.data_ptr(), B, T, H, KV, D, page_size,
        P, num_slots // page_size, int(sliding_window), float(attn_softcap),
        _ptr(part_o), _ptr(part_ml), _ptr(ticket), splits, chunk, _stream(q))
    _build.check(err, "paged_prefill launch")
    _launches.count(paged_prefill)
    return out


def paged_ragged(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_tables: torch.Tensor,
    tok_row: torch.Tensor,
    q_pos: torch.Tensor,
    kv_valid_len: torch.Tensor,
    *,
    page_size: int,
    sliding_window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Ragged mixed-batch paged GQA attention: q [S, H, D] -> [S, H, D].

    One packed token axis carries decode rows (one token each) and prefill
    chunks; token i attends only row ``tok_row[i]``'s pages (-1 =
    padding) at position ``q_pos[i]``. Each row's tokens must be one
    contiguous run; runs and padding may alternate in any order (the
    engine marks inactive decode slots -1 between active ones).
    page_tables [Bm, P], tok_row / q_pos [S], kv_valid_len [Bm]: int32,
    kv_valid_len counting each row's new tokens. Padding tokens and tokens
    that see no key give zeros."""
    if q.device.type == "cpu":
        return paged_ragged_plain(
            q, pool_k, pool_v, page_tables, tok_row, q_pos, kv_valid_len,
            page_size=page_size, sliding_window=sliding_window,
            attn_softcap=attn_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_ragged runs on cpu or cuda, not {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be [S, H, D], got {tuple(q.shape)}")
    S = q.shape[0]
    Bm, P = page_tables.shape if page_tables.dim() == 2 else (-1, -1)
    num_slots, KV, D, H = _check(
        q, pool_k, pool_v, page_tables, Bm, page_size, _PREFILL_MAX_GD,
        [("page_tables", page_tables, (Bm, P)),
         ("tok_row", tok_row, (S,)),
         ("q_pos", q_pos, (S,)),
         ("kv_valid_len", kv_valid_len, (Bm,))])
    if S == 0 or Bm == 0:  # nothing but padding
        return torch.zeros_like(q)
    out = torch.empty_like(q)
    splits, chunk, part_o, part_ml, ticket = _attend_launch(
        q, S, Bm, H, KV, D, P, page_size, ragged=True)
    err = _lib().paged_ragged(
        _DTYPE_CODES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
        pool_v.data_ptr(), page_tables.data_ptr(), tok_row.data_ptr(),
        q_pos.data_ptr(), kv_valid_len.data_ptr(), out.data_ptr(), S, Bm, H,
        KV, D, page_size, P, num_slots // page_size, int(sliding_window),
        float(attn_softcap), _ptr(part_o), _ptr(part_ml), _ptr(ticket),
        splits, chunk, _stream(q))
    _build.check(err, "paged_ragged launch")
    _launches.count(paged_ragged)
    return out


_launches.register(paged_decode, "paged_decode")
_launches.register(paged_decode_int8, "paged_decode_int8")
_launches.register(paged_prefill, "paged_prefill")
_launches.register(paged_ragged, "paged_ragged")

