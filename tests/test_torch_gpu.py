"""The hand-written kernels on a card, held against their plain versions.

Every test here is marked ``gpu`` and skips without a CUDA card (the
kernels have no CPU mode; the CPU tests hold the plain versions against
the JAX package instead). The file imports nothing of JAX, so it also
runs where JAX is not installed. On a GPU machine, from the root of the
checkout::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest`` because the suite's conftest configures JAX.)
Tolerances: 1e-4 in float32 (summation order only), 2e-2 absolute plus
2^-7 relative in bfloat16 (about two bf16 ulps at the outputs' scale).
"""

import pytest
import torch

from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PagedCacheConfig,
)
from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)
from distributed_inference_server_tpu_torch.ops import kernels
from distributed_inference_server_tpu_torch.ops.kernels import fused
from distributed_inference_server_tpu_torch.ops.kernels import (
    paged_attention as pa,
)
from distributed_inference_server_tpu_torch.ops.kernels import (
    quant_matmul as qm,
)
from distributed_inference_server_tpu_torch.ops.quant import (
    QUANT_KEYS,
    QuantPool,
    quantize_int4,
    quantize_int8,
    quantize_kv,
)
from distributed_inference_server_tpu_torch.ops.rotary import (
    rope_frequencies,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (run with -m gpu on a GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the plain versions' bf16 products keep f32 sums throughout
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _tol(dtype):
    if dtype == torch.float32:
        return dict(atol=1e-4, rtol=1e-4)
    return dict(atol=2e-2, rtol=2.0 ** -7)


def _pool_case(dev, dtype, B, H, KV, D, ps, P, num_pages, T=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    pk = torch.randn(num_pages * ps, KV, D, generator=g, device=dev)
    pv = torch.randn(num_pages * ps, KV, D, generator=g, device=dev)
    shape = (B, H, D) if T is None else (B, T, H, D)
    q = torch.randn(*shape, generator=g, device=dev)
    perm = torch.randperm(num_pages, generator=g, device=dev)[: B * P]
    tables = perm.reshape(B, P).to(torch.int32).contiguous()
    return q.to(dtype), pk.to(dtype), pv.to(dtype), tables


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D,window,softcap", [
    (32, 8, 64, 0, 0.0), (32, 8, 128, 0, 0.0), (16, 2, 64, 0, 0.0),
    (8, 8, 64, 0, 0.0), (32, 8, 64, 37, 0.0), (32, 8, 64, 0, 30.0)])
def test_paged_decode_kernel(cuda, dtype, H, KV, D, window, softcap):
    q, pk, pv, tables = _pool_case(cuda, dtype, 6, H, KV, D, 16, 16, 128)
    valid = torch.tensor([0, 1, 16, 17, 200, 256], dtype=torch.int32,
                         device=cuda)
    kw = dict(page_size=16, sliding_window=window, attn_softcap=softcap)
    n = pa.paged_decode.launches
    got = pa.paged_decode(q, pk, pv, tables, valid, **kw)
    want = pa.paged_decode_plain(q, pk, pv, tables, valid, **kw)
    torch.cuda.synchronize()
    assert pa.paged_decode.launches == n + 1
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert not got[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,H,KV,D,window,softcap", [
    (32, 32, 8, 64, 0, 0.0), (128, 32, 8, 64, 0, 0.0),
    (64, 32, 8, 128, 0, 0.0), (16, 16, 2, 64, 0, 0.0),
    (64, 32, 8, 64, 20, 0.0), (32, 32, 8, 64, 0, 50.0), (1, 32, 8, 64, 0, 0.0)])
def test_paged_prefill_kernel(cuda, dtype, T, H, KV, D, window, softcap):
    q, pk, pv, tables = _pool_case(cuda, dtype, 4, H, KV, D, 16, 16, 128,
                                   T=T)
    q_start = torch.tensor([0, 5, 100, 0], dtype=torch.int32, device=cuda)
    valid = torch.tensor([T, 5 + max(1, T // 2), 100 + T, 0],
                         dtype=torch.int32, device=cuda)
    kw = dict(page_size=16, sliding_window=window, attn_softcap=softcap)
    got = pa.paged_prefill(q, pk, pv, tables, q_start, valid, **kw)
    want = pa.paged_prefill_plain(q, pk, pv, tables, q_start, valid, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert not got[3].any()


def _ragged_layout(rows_tokens, history):
    """Packed tok_row / q_pos from a per-token row list (-1 = padding):
    row b's k-th token sits at position history[b] + k."""
    seen = {}
    tok_row, q_pos = [], []
    for r in rows_tokens:
        tok_row.append(r)
        if r < 0:
            q_pos.append(0)
            continue
        q_pos.append(history[r] + seen.get(r, 0))
        seen[r] = seen.get(r, 0) + 1
    valid = [history[b] + seen.get(b, 0) for b in range(len(history))]
    return tok_row, q_pos, valid


# decode slots 0-5 (slot 0 inactive: -1 mid-axis), then prefill chunks of
# 37, 50 and 13 tokens, an empty fourth prefill row, a padding tail;
# S = 113 is no multiple of 16
_MIXED = ([-1, 1, 2, 3, 4, 5] + [6] * 37 + [7] * 50 + [8] * 13 + [-1] * 7,
          [0, 0, 15, 16, 200, 255, 0, 150, 40, 0])
RAGGED_CASES = {
    "mixed": _MIXED,
    "one window": ([0, 1, -1, 2, 3], [0, 16, 0, 100]),  # S 5 < TQ
    "all padding": ([-1] * 9, [0, 0]),
    "row sees nothing": ([0, 1, 1], [0, 3]),  # row 0: valid 1, pos 0 ok
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
@pytest.mark.parametrize("H,KV,D,window,softcap", [
    (32, 8, 64, 0, 0.0), (32, 8, 128, 0, 0.0), (16, 8, 64, 0, 0.0),
    (32, 8, 64, 37, 30.0)])
def test_paged_ragged_kernel(cuda, dtype, case, H, KV, D, window, softcap):
    layout, history = RAGGED_CASES[case]
    tok_row, q_pos, valid = _ragged_layout(layout, history)
    Bm = len(history)
    q, pk, pv, tables = _pool_case(cuda, dtype, Bm, H, KV, D, 16, 16, 256,
                                   T=len(tok_row), seed=3)
    q = q[0].contiguous()  # [S, H, D]
    i32 = dict(dtype=torch.int32, device=cuda)
    tok_row, q_pos = torch.tensor(tok_row, **i32), torch.tensor(q_pos, **i32)
    valid = torch.tensor(valid, **i32)
    if case == "row sees nothing":
        valid[0] = 0  # its token has no key to attend
    kw = dict(page_size=16, sliding_window=window, attn_softcap=softcap)
    n = pa.paged_ragged.launches
    got = pa.paged_ragged(q, pk, pv, tables, tok_row, q_pos, valid, **kw)
    want = pa.paged_ragged_plain(q, pk, pv, tables, tok_row, q_pos, valid,
                                 **kw)
    torch.cuda.synchronize()
    assert pa.paged_ragged.launches == n + 1
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert not got[tok_row < 0].any()
    if case == "row sees nothing":
        assert not got[0].any()


# The prefill / ragged tensor-core body at serving depth: tables of 128
# pages of 16 tokens (capacity 2048) over a 1024-page pool (2048 for the
# ragged cases' up to 12 rows), KV 4 heads.
# Prefill rows: (q_start, valid) per row; "deep" has a 1500-token history
# beside rows that start at 0 and 100 and an empty row; "one deep row" is a
# single row whose small grid the plan splits, so the merge runs.
DEEP_PREFILL = {
    "deep": ([0, 100, 1500, 0], lambda T: [T, 100 + max(1, T // 2),
                                           min(1500 + T, 2048), 0]),
    "one deep row": ([1900], lambda T: [min(1900 + T, 2048)]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", sorted(DEEP_PREFILL))
@pytest.mark.parametrize("T,window,softcap", [
    (512, 0, 0.0), (50, 0, 0.0), (77, 300, 30.0)])
def test_paged_prefill_deep_history(cuda, D, G, rows, T, window, softcap):
    """T 512 (whole query tiles at G 1, 2, 4, 8), T 50 and 77 (a partial
    last tile), with and without window and softcap."""
    q_start, valid = DEEP_PREFILL[rows]
    if q_start[0] + T > 2048:
        T = 2048 - q_start[0]
    B, KV = len(q_start), 4
    q, pk, pv, tables = _pool_case(cuda, torch.bfloat16, B, G * KV, KV, D,
                                   16, 128, 1024, T=T, seed=G + D)
    i32 = dict(dtype=torch.int32, device=cuda)
    qs = torch.tensor(q_start, **i32)
    vl = torch.tensor(valid(T), **i32)
    kw = dict(page_size=16, sliding_window=window, attn_softcap=softcap)
    n = pa.paged_prefill.launches
    got = pa.paged_prefill(q, pk, pv, tables, qs, vl, **kw)
    want = pa.paged_prefill_plain(q, pk, pv, tables, qs, vl, **kw)
    torch.cuda.synchronize()
    assert pa.paged_prefill.launches == n + 1
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))
    if B == 4:
        assert not got[3].any()


def _mixed_layout(decode_valid, chunks, S, Bm):
    """The mixed step's packed axis: decode slots first (valid 0: an
    inactive slot, -1), then prefill chunks (length, q_start) back to back,
    then padding up to S. Returns tok_row, q_pos, valid."""
    tok_row, q_pos, valid = [], [], []
    for b, v in enumerate(decode_valid):
        tok_row.append(b if v > 0 else -1)
        q_pos.append(max(v - 1, 0))
        valid.append(v)
    for j, (n, start) in enumerate(chunks):
        tok_row += [len(decode_valid) + j] * n
        q_pos += list(range(start, start + n))
        valid.append(start + n)
    valid += [0] * (Bm - len(valid))
    tok_row += [-1] * (S - len(tok_row))
    q_pos += [0] * (S - len(q_pos))
    return tok_row, q_pos, valid


# (decode valid, chunks (length, q_start), S, Bm): the served mix (a
# 2048-token decode row and a 1500-deep chunk among shorter rows), decode
# rows alone, and a chunk reaching the table's end
LONG_RAGGED = {
    "served mix": ([0, 1, 16, 17, 300, 1000, 2047, 2048],
                   [(200, 0), (250, 1500), (54, 100)], 512, 12),
    "decode rows": ([2048, 2047, 1, 64, 1000], [], 8, 5),
    "deep chunk": ([2048], [(300, 1748), (33, 0)], 400, 3),
}


def _long_ragged_inputs(dev, case, H, KV, D, seed=5):
    decode_valid, chunks, S, Bm = LONG_RAGGED[case]
    tok_row, q_pos, valid = _mixed_layout(decode_valid, chunks, S, Bm)
    q, pk, pv, tables = _pool_case(dev, torch.bfloat16, Bm, H, KV, D, 16,
                                   128, 2048, T=S, seed=seed)
    i32 = dict(dtype=torch.int32, device=dev)
    return (q[0].contiguous(), pk, pv, tables, torch.tensor(tok_row, **i32),
            torch.tensor(q_pos, **i32), torch.tensor(valid, **i32))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("case", sorted(LONG_RAGGED))
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (300, 30.0)])
def test_paged_ragged_long_rows_split_and_merge(cuda, D, G, case, window,
                                                softcap):
    args = _long_ragged_inputs(cuda, case, 4 * G, 4, D)
    splits, _ = pa.attend_plan(4 * G, 4, args[0].shape[0],
                               args[3].shape[0], 2048, 16, pa._num_sms(0),
                               pa._attend_per_sm(0, D, True), ragged=True)
    assert splits > 1  # the merge runs
    kw = dict(page_size=16, sliding_window=window, attn_softcap=softcap)
    n = pa.paged_ragged.launches
    got = pa.paged_ragged(*args, **kw)
    want = pa.paged_ragged_plain(*args, **kw)
    torch.cuda.synchronize()
    assert pa.paged_ragged.launches == n + 1  # one launch, merge included
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))
    assert not got[args[4] < 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kernel", ["prefill", "ragged"])
def test_attend_is_deterministic(cuda, D, kernel):
    """Two calls on the same inputs give the same bits: the splits are
    added in split order whichever block ends last."""
    if kernel == "ragged":
        args = _long_ragged_inputs(cuda, "served mix", 32, 8, D, seed=9)
        fn = pa.paged_ragged
    else:
        q, pk, pv, tables = _pool_case(cuda, torch.bfloat16, 1, 32, 8, D, 16,
                                       128, 1024, T=64, seed=9)
        i32 = dict(dtype=torch.int32, device=cuda)
        args = (q, pk, pv, tables, torch.tensor([1900], **i32),
                torch.tensor([1964], **i32))
        fn = pa.paged_prefill
    first = fn(*args, page_size=16)
    for _ in range(3):
        assert torch.equal(fn(*args, page_size=16), first)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["prefill", "ragged"])
def test_attend_graph_replays_reset_the_ticket(cuda, kernel):
    """A captured prefill (one deep row: split, merged) or ragged launch
    (the served mix) replayed four times, with new queries and pools
    before each replay and the output poisoned, gives the plain version's
    result every time: the last split of each tile puts its ticket back
    to zero."""
    if kernel == "ragged":
        args = list(_long_ragged_inputs(cuda, "served mix", 32, 8, 64,
                                        seed=13))
        fn, plain = pa.paged_ragged, pa.paged_ragged_plain
    else:
        q, pk, pv, tables = _pool_case(cuda, torch.bfloat16, 1, 32, 8, 64,
                                       16, 128, 1024, T=100, seed=13)
        i32 = dict(dtype=torch.int32, device=cuda)
        args = [q, pk, pv, tables, torch.tensor([1900], **i32),
                torch.tensor([2000], **i32)]
        fn, plain = pa.paged_prefill, pa.paged_prefill_plain
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # the ticket buffer of this stream
        fn(*args, page_size=16)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fn(*args, page_size=16)
    g = torch.Generator(device=cuda).manual_seed(17)
    for _ in range(4):
        for t in args[:3]:  # q, pool_k, pool_v
            t.copy_(torch.randn(t.shape, generator=g, device=cuda))
        out.fill_(float("nan"))
        graph.replay()
        want = plain(*args, page_size=16)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want.float(),
                                   **_tol(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64), (8, 1, 2048), (4, 33, 2048),
                                   (3, 5000)])
def test_rms_norm_kernel(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=g,
                               device=cuda)).to(dtype)
    got = fused.rms_norm(x, w, 1e-5)
    torch.testing.assert_close(got.float(),
                               fused.rms_norm_plain(x, w, 1e-5).float(),
                               **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 32, 64), (4, 50, 8, 64),
                                   (2, 7, 32, 128), (1, 3, 4, 16)])
def test_rope_kernel(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    pos = torch.randint(0, 4096, shape[:2], generator=g, device=cuda,
                        dtype=torch.int32)
    inv = rope_frequencies(shape[-1], 5e5, None, device=cuda)
    got = fused.apply_rope(x, pos, inv)
    torch.testing.assert_close(got.float(),
                               fused.apply_rope_plain(x, pos, inv).float(),
                               **_tol(dtype))


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, pk, pv, tables = _pool_case(cuda, torch.bfloat16, 2, 8, 4, 64, 16, 4,
                                   16)
    valid = torch.tensor([3, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pa.paged_decode(q, pk.float(), pv, tables, valid, page_size=16)
    with pytest.raises(ValueError):
        pa.paged_decode(q, pk, pv, tables, valid.long(), page_size=16)
    with pytest.raises(ValueError):
        fused.rms_norm(q.transpose(0, 1), torch.ones(64, device=cuda), 1e-5)
    tok = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # q_pos of the wrong length
        pa.paged_ragged(q, pk, pv, tables, tok, tok[:1], valid, page_size=16)


# M, K, N, group: llama shapes at decode and prefill, odd M, K of one
# group, N not a multiple of 16 or 128, M just past the decode tile; then
# the edges of the redesigned tiles: a llama-3-8b MLP product at a prefill
# chunk, M just past a 128-row prefill tile and just past the decode body,
# N off the 128 / 256 column blocks at both bodies, K = 192 (not a
# multiple of the 64-row tile) with group 32, and K = 160 (int4: 80 code
# rows, not a multiple of the 32-row code tile)
QMM_CASES = [(8, 4096, 1024, 128), (8, 2048, 8192, 64), (1, 128, 200, 128),
             (5, 512, 72, 64), (17, 256, 136, 32), (300, 1024, 384, 128),
             (64, 64, 256, 64), (2048, 4096, 14336, 128),
             (129, 1024, 256, 128), (8, 256, 136, 32), (40, 512, 8200, 64),
             (16, 512, 8200, 64), (8, 192, 256, 32), (100, 192, 256, 32),
             (8, 160, 128, 32), (20, 160, 128, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("M,K,N,group", QMM_CASES)
def test_quant_matmul_kernel(cuda, dtype, packed, M, K, N, group):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    w = torch.randn(K, N, generator=g, device=cuda) * 0.02
    w = quantize_int4(w, group) if packed else quantize_int8(w, group)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    fn = qm.quant_matmul_q4 if packed else qm.quant_matmul_q8
    n = fn.launches
    got = qm.quant_matmul(x, w)
    want = qm.quant_matmul_plain(x, w)
    torch.cuda.synchronize()
    assert fn.launches == n + 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("M,K,N", [(8, 4096, 1024), (2048, 1024, 1024)])
def test_quant_matmul_kernel_is_deterministic(cuda, packed, M, K, N):
    """Two calls on the same inputs give the same bits: at M = 8 the split
    K's partial sums are added in split order whichever block ends last."""
    g = torch.Generator(device=cuda).manual_seed(M + K)
    w = torch.randn(K, N, generator=g, device=cuda) * 0.02
    w = quantize_int4(w, 64) if packed else quantize_int8(w, 128)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    first = qm.quant_matmul(x, w)
    for _ in range(3):
        assert torch.equal(qm.quant_matmul(x, w), first)


def _int8_pools(dev, dtype, B, H, KV, D, ps, P, num_pages, seed=0):
    q, pk, pv, tables = _pool_case(dev, torch.float32, B, H, KV, D, ps, P,
                                   num_pages, seed=seed)
    pk[5] = 0.0  # zero vectors: scale 0
    kq, vq = quantize_kv(pk), quantize_kv(pv)
    return q.to(dtype), QuantPool(*kq), QuantPool(*vq), tables


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D,window,softcap", [
    (32, 8, 64, 0, 0.0), (32, 8, 128, 0, 0.0), (16, 2, 64, 0, 0.0),
    (8, 8, 16, 0, 0.0), (32, 8, 128, 64, 30.0), (32, 8, 64, 37, 0.0)])
def test_paged_decode_int8_kernel(cuda, dtype, H, KV, D, window, softcap):
    q, pk, pv, tables = _int8_pools(cuda, dtype, 8, H, KV, D, 16, 16, 128)
    valid = torch.tensor([0, 1, 15, 16, 17, 100, 200, 256],
                         dtype=torch.int32, device=cuda)
    kw = dict(page_size=16, sliding_window=window, attn_softcap=softcap)
    n, dense = pa.paged_decode_int8.launches, pa.paged_decode.launches
    got = pa.paged_decode(q, pk, pv, tables, valid, **kw)
    want = pa.paged_decode_int8_plain(q, pk, pv, tables, valid, **kw)
    torch.cuda.synchronize()
    assert pa.paged_decode_int8.launches == n + 1
    assert pa.paged_decode.launches == dense
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert not got[0].any()


# The tensor-core decode at serving depth: rows up to 2048 tokens in a
# 128-page table, so the split plan takes several splits and the merge runs
# in the launch. Row 1 sees nothing (valid 0); rows 64 and 17 have all
# their keys in the first split; 1000 and 2047 span several splits.
LONG_VALID = [2048, 0, 2047, 1000, 300, 17, 1, 64]


def _decode_inputs(dev, pools, D, seed=7):
    """bf16 q, the pools (dense bf16, or int8 ``QuantPool`` pairs) and
    tables of 8 rows x 128 pages of 16 tokens over a 1024-page pool."""
    if pools == "int8":
        return _int8_pools(dev, torch.bfloat16, 8, 32, 8, D, 16, 128, 1024,
                           seed=seed)
    return _pool_case(dev, torch.bfloat16, 8, 32, 8, D, 16, 128, 1024,
                      seed=seed)


def _decode_plain(pools):
    return pa.paged_decode_int8_plain if pools == "int8" else \
        pa.paged_decode_plain


@pytest.mark.gpu
@pytest.mark.parametrize("pools", ["dense", "int8"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 30.0),
                                            (1500, 0.0)])
def test_paged_decode_long_rows_split_and_merge(cuda, pools, D, window,
                                                softcap):
    q, pk, pv, tables = _decode_inputs(cuda, pools, D)
    valid = torch.tensor(LONG_VALID, dtype=torch.int32, device=cuda)
    kw = dict(page_size=16, sliding_window=window, attn_softcap=softcap)
    splits, _ = pa.decode_plan(8, 8, 128 * 16, 16, pa._num_sms(0),
                               pa._decode_per_sm(0, D, pools == "int8"))
    assert splits > 1  # the merge runs
    counter = pa.paged_decode_int8 if pools == "int8" else pa.paged_decode
    n = counter.launches
    got = pa.paged_decode(q, pk, pv, tables, valid, **kw)
    want = _decode_plain(pools)(q, pk, pv, tables, valid, **kw)
    torch.cuda.synchronize()
    assert counter.launches == n + 1  # one launch, merge included
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))
    assert not got[1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("pools", ["dense", "int8"])
@pytest.mark.parametrize("D", [64, 128])
def test_paged_decode_is_deterministic(cuda, pools, D):
    """Two calls on the same inputs give the same bits: the splits are
    added in split order whichever block ends last."""
    q, pk, pv, tables = _decode_inputs(cuda, pools, D, seed=11)
    valid = torch.tensor(LONG_VALID, dtype=torch.int32, device=cuda)
    first = pa.paged_decode(q, pk, pv, tables, valid, page_size=16)
    for _ in range(3):
        assert torch.equal(pa.paged_decode(q, pk, pv, tables, valid,
                                           page_size=16), first)


@pytest.mark.gpu
@pytest.mark.parametrize("pools", ["dense", "int8"])
def test_paged_decode_graph_replays_reset_the_ticket(cuda, pools):
    """A captured decode replayed several times, with new queries and
    lengths before each replay and the output poisoned, gives the plain
    version's result every time: the last split of each row puts its
    ticket back to zero."""
    q, pk, pv, tables = _decode_inputs(cuda, pools, 64, seed=13)
    valid = torch.tensor(LONG_VALID, dtype=torch.int32, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # the ticket buffer of this stream
        pa.paged_decode(q, pk, pv, tables, valid, page_size=16)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = pa.paged_decode(q, pk, pv, tables, valid, page_size=16)
    g = torch.Generator(device=cuda).manual_seed(17)
    for rep in range(4):
        q.copy_(torch.randn(q.shape, generator=g, device=cuda))
        valid.copy_(valid.roll(1))
        out.fill_(float("nan"))
        graph.replay()
        want = _decode_plain(pools)(q, pk, pv, tables, valid, page_size=16)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want.float(),
                                   **_tol(torch.bfloat16))


@pytest.mark.gpu
def test_quant_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(4, 64, device=cuda).bfloat16()
    w = quantize_int8(torch.randn(64, 32, device=cuda), 32)
    with pytest.raises(ValueError):  # codes of the wrong type
        qm.quant_matmul_q8(x, type(w)(w.q.view(torch.uint8), w.s))
    with pytest.raises(ValueError):  # scales that do not fit the codes
        qm.quant_matmul_q8(x, type(w)(w.q, w.s[:, :16].contiguous()))
    with pytest.raises(ValueError):  # x of the wrong width
        qm.quant_matmul_q8(x[:, :32].contiguous(), w)
    q, pk, pv, tables = _int8_pools(cuda, torch.bfloat16, 2, 8, 4, 8, 16, 4,
                                    16)
    valid = torch.tensor([3, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # head_dim 8: no 16-byte code loads
        pa.paged_decode(q, pk, pv, tables, valid, page_size=16)


def _drive_tiny(eng, tok, chats, long_prompt):
    """Two chats mid-decode, then a long prompt: greedy tokens per id."""
    toks = {}

    def step():
        for o in eng.step():
            if o.token_id is not None:
                toks.setdefault(o.request_id, []).append(o.token_id)

    for i, p in enumerate(chats):
        eng.add_request(f"c{i}", tok.encode(p),
                        SamplingParams(max_tokens=16, temperature=0.0))
    for _ in range(3):
        step()
    eng.add_request("long", tok.encode(long_prompt),
                    SamplingParams(max_tokens=8, temperature=0.0))
    while eng.has_work():
        step()
    return toks


@pytest.mark.gpu
def test_engine_kernel_path_matches_plain_path(cuda):
    """TINY in f32 on the card: greedy tokens through the kernels equal
    those through the plain versions, and every kernel launched."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = llama.init_params(TINY, gen, dtype=torch.float32, device=cuda)
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        params["layers"][k] *= 8.0
    params["embed"] *= 8.0
    tok = ByteTokenizer()
    outs = {}
    kernels.reset_launch_counts()
    for impl in ("kernel", "plain"):
        eng = LLMEngine(params, TINY, tok, EngineConfig(
            attention_impl=impl, max_batch=4, prefill_buckets=(8, 32),
            paged=PagedCacheConfig(64, 4, 16)), dtype=torch.float32,
            device=cuda)
        for i, p in enumerate(["gpu path", "a longer prompt " * 3, "z"]):
            eng.add_request(f"r{i}", tok.encode(p),
                            SamplingParams(max_tokens=12, temperature=0.0))
        toks = {}
        while eng.has_work():
            for o in eng.step():
                if o.token_id is not None:
                    toks.setdefault(o.request_id, []).append(o.token_id)
        outs[impl] = toks
        if impl == "kernel":
            counts = kernels.launch_counts()
    quantum = ("paged_decode", "paged_prefill", "rms_norm", "rope")
    assert all(counts[k] > 0 for k in quantum), counts
    assert outs["kernel"] == outs["plain"]


@pytest.mark.gpu
def test_mixed_engine_kernel_path_matches_plain_and_quantum(cuda):
    """TINY in f32 on the card: the mixed step's greedy tokens through the
    ragged kernel equal those through its plain version and the quantum
    path's, and the ragged kernel launched."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = llama.init_params(TINY, gen, dtype=torch.float32, device=cuda)
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        params["layers"][k] *= 8.0
    params["embed"] *= 8.0
    tok = ByteTokenizer()
    chats, long_prompt = ["chat one", "chat two!"], "a long prompt " * 5
    outs = {}
    for name, impl, mixed in (("mixed-kernel", "kernel", 20),
                              ("mixed-plain", "plain", 20),
                              ("quantum", "kernel", 0)):
        kernels.reset_launch_counts()
        eng = LLMEngine(params, TINY, tok, EngineConfig(
            attention_impl=impl, max_batch=4, prefill_buckets=(8, 32),
            paged=PagedCacheConfig(64, 4, 24), mixed_step_tokens=mixed),
            dtype=torch.float32, device=cuda)
        outs[name] = _drive_tiny(eng, tok, chats, long_prompt)
        if name == "mixed-kernel":
            assert kernels.launch_counts()["paged_ragged"] > 0
            assert eng.mixed_stats()["decode_tokens"] > 0
    assert outs["mixed-kernel"] == outs["mixed-plain"] == outs["quantum"]


@pytest.mark.gpu
@pytest.mark.parametrize("weights,kv", [("int8", "int8"), ("int4", "none")])
def test_quantized_engine_kernel_path_matches_plain_path(cuda, weights, kv):
    """TINY in f32 on the card with quantized weights (and int8 KV): greedy
    tokens through the kernels equal those through the plain versions,
    and the quantized kernels launched."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = llama.init_params(TINY, gen, dtype=torch.float32, device=cuda)
    params["embed"] *= 8.0
    # group 32: several groups per layer at TINY's in-dims (64, 128)
    quantize = quantize_int8 if weights == "int8" else quantize_int4
    for k in QUANT_KEYS:
        params["layers"][k] = quantize(params["layers"][k] * 8.0, 32)
    tok = ByteTokenizer()
    outs = {}
    for impl in ("kernel", "plain"):
        kernels.reset_launch_counts()
        eng = LLMEngine(params, TINY, tok, EngineConfig(
            attention_impl=impl, max_batch=4, prefill_buckets=(8, 32),
            paged=PagedCacheConfig(64, 4, 16), kv_quant=kv),
            dtype=torch.float32, device=cuda)
        for i, p in enumerate(["gpu path", "a longer prompt " * 3, "z"]):
            eng.add_request(f"r{i}", tok.encode(p),
                            SamplingParams(max_tokens=12, temperature=0.0))
        toks = {}
        while eng.has_work():
            for o in eng.step():
                if o.token_id is not None:
                    toks.setdefault(o.request_id, []).append(o.token_id)
        outs[impl] = toks
        counts = kernels.launch_counts()
        if impl == "kernel":
            mm = "quant_matmul_q8" if weights == "int8" else "quant_matmul_q4"
            dec = "paged_decode_int8" if kv == "int8" else "paged_decode"
            assert counts[mm] > 0 and counts[dec] > 0, counts
        else:
            assert not any(counts.values()), counts
    assert outs["kernel"] == outs["plain"]


# ---------------------------------------------------------------------------
# CUDA graphs on the quantum path, the checkpoint loader on the card
# ---------------------------------------------------------------------------


def _scaled_params(cfg, dev, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = llama.init_params(cfg, gen, dtype=torch.float32, device=dev)
    if cfg is TINY:  # varied greedy continuations at TINY's width
        for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            params["layers"][k] *= 8.0
        params["embed"] *= 8.0
    return {k: ({n: w.to(dtype) for n, w in v.items()} if isinstance(v, dict)
                else v.to(dtype)) for k, v in params.items()}


def _graph_trace(eng, tok, waves, first_wave=0):
    """Run ``waves`` of greedy prompts, each wave drained before the next
    (so later waves get other pages and block tables); returns the tokens
    per request (``w<wave>r<i>``, waves numbered from ``first_wave``) and
    the kernel launches."""
    kernels.reset_launch_counts()
    toks = {}
    for w, prompts in enumerate(waves, first_wave):
        for i, (p, n) in enumerate(prompts):
            eng.add_request(f"w{w}r{i}", tok.encode(p),
                            SamplingParams(max_tokens=n, temperature=0.0))
        while eng.has_work():
            for o in eng.step():
                if o.token_id is not None:
                    toks.setdefault(o.request_id, []).append(o.token_id)
    return toks, kernels.launch_counts()


GRAPH_WAVES = [
    [("graph path", 20), ("a longer prompt " * 3, 12), ("z", 30)],
    # after the first wave: freed and cached pages, other tables, a prefix
    # hit, rows crossing page boundaries mid-block
    [("a longer prompt " * 3 + "again", 25), ("fresh", 9)],
]


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["tiny-f32", "1b-width-2-layers-bf16"])
@pytest.mark.parametrize("depth", [0, 1])
def test_graph_path_matches_eager_path(cuda, model, depth):
    """The captured decode blocks and prefill chunks give the eager path's
    greedy tokens and the same kernel launches (so the same launches per
    decode step and per prefill chunk), pipelined and not."""
    from distributed_inference_server_tpu_torch.models.configs import (
        LLAMA_3_2_1B,
    )

    if model == "tiny-f32":
        cfg, dtype, paged = TINY, torch.float32, PagedCacheConfig(64, 4, 16)
        ecfg = dict(max_batch=4, prefill_buckets=(8, 32))
    else:
        cfg = LLAMA_3_2_1B.with_overrides(num_layers=2)
        dtype, paged, ecfg = torch.bfloat16, PagedCacheConfig(), {}
    params = _scaled_params(cfg, cuda, dtype)
    tok = ByteTokenizer()
    outs = {}
    for graphs in (True, False):
        eng = LLMEngine(params, cfg, tok, EngineConfig(
            paged=paged, pipeline_depth=depth, **ecfg), dtype=dtype,
            device=cuda, _graphs=graphs)
        outs[graphs] = _graph_trace(eng, tok, GRAPH_WAVES)
        assert bool(eng._graphs) == graphs
        if graphs:
            assert eng.step_clock_stats()["events"]["retrace"] == len(
                eng._graphs)
        del eng
    assert outs[True][0] == outs[False][0]
    assert outs[True][1] == outs[False][1]
    assert outs[True][1]["paged_decode"] > 0
    assert outs[True][1]["paged_prefill"] > 0


@pytest.mark.gpu
def test_graph_captured_before_a_table_change_replays_after_it(cuda):
    """The decode graph is captured on the first wave's block tables; the
    second wave's rows hold other pages (and grow their tables while they
    decode), and the replays still give the eager path's tokens, with no
    new capture."""
    params = _scaled_params(TINY, cuda, torch.float32)
    tok = ByteTokenizer()
    kw = dict(paged=PagedCacheConfig(64, 4, 16), max_batch=4,
              prefill_buckets=(8, 32))
    eng = LLMEngine(params, TINY, tok, EngineConfig(**kw),
                    dtype=torch.float32, device=cuda)
    ref = LLMEngine(params, TINY, tok, EngineConfig(**kw),
                    dtype=torch.float32, device=cuda, _graphs=False)
    first = _graph_trace(eng, tok, GRAPH_WAVES[:1])[0]
    captured = dict(eng._graphs)
    assert ("decode", 0) in captured
    tables_before = eng._bt.copy()
    second = _graph_trace(eng, tok, GRAPH_WAVES[1:], first_wave=1)[0]
    assert (eng._bt != tables_before).any()
    assert eng._graphs[("decode", 0)] is captured[("decode", 0)]
    want = _graph_trace(ref, tok, GRAPH_WAVES)[0]
    assert {**first, **second} == want


@pytest.mark.gpu
def test_sampled_graph_replays_draw_new_numbers(cuda):
    """A decode block replayed twice from the carry it was launched with
    (its pages are ensured, its inputs unchanged): the sampled block draws
    different tokens each time (the engine's generator is registered with
    the graph), the greedy block repeats its own tokens."""
    params = _scaled_params(TINY, cuda, torch.float32)
    tok = ByteTokenizer()
    eng = LLMEngine(params, TINY, tok, EngineConfig(
        paged=PagedCacheConfig(64, 4, 16), max_batch=4,
        prefill_buckets=(8, 32)), dtype=torch.float32, device=cuda)
    for rid, temp in (("hot", 5.0), ("cold", 0.0)):
        eng.add_request(rid, tok.encode("sampled " + rid),
                        SamplingParams(max_tokens=60, temperature=temp))
        eng.step()  # prefill; the first block runs eagerly, then captures
        eng.step()  # a replay
        mode = 1 if temp else 0
        assert ("decode", mode) in eng._graphs
        with torch.cuda.stream(eng._stream):
            torch.cuda.current_stream().synchronize()
            saved = [t.clone() for t in eng._carry]
        eng.step()  # the block replayed below: its pages are ensured
        with torch.cuda.stream(eng._stream):
            torch.cuda.current_stream().synchronize()
            draws = [eng._d_out[0].clone()]
            for _ in range(2):
                for buf, t in zip(eng._carry, saved):
                    buf.copy_(t)
                eng._graphs[("decode", mode)].graph.replay()
                draws.append(eng._d_out[0].clone())
            torch.cuda.current_stream().synchronize()
        live = draws[0] >= 0
        assert live.any() and all(torch.equal(d >= 0, live) for d in draws)
        if temp:
            assert not torch.equal(draws[1][live], draws[2][live])
        else:
            assert torch.equal(draws[0], draws[1])
            assert torch.equal(draws[1], draws[2])
        eng.abort(rid)
        with torch.cuda.stream(eng._stream):
            eng._drain_pending([])


@pytest.mark.gpu
def test_failed_capture_raises(cuda, monkeypatch):
    """A capture that fails raises out of step(); the engine does not run
    the eager path in its place."""
    params = _scaled_params(TINY, cuda, torch.float32)
    tok = ByteTokenizer()
    eng = LLMEngine(params, TINY, tok, EngineConfig(
        paged=PagedCacheConfig(64, 4, 16), max_batch=4,
        prefill_buckets=(8, 32)), dtype=torch.float32, device=cuda)

    def refuse(*a, **k):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", refuse)
    eng.add_request("r", tok.encode("no fallback"),
                    SamplingParams(max_tokens=4, temperature=0.0))
    with pytest.raises(RuntimeError, match="capture refused"):
        eng.step()


@pytest.mark.gpu
def test_warmup_captures_every_graph(cuda):
    params = _scaled_params(TINY, cuda, torch.float32)
    tok = ByteTokenizer()
    eng = LLMEngine(params, TINY, tok, EngineConfig(
        paged=PagedCacheConfig(64, 4, 16), max_batch=4,
        prefill_buckets=(8, 32)), dtype=torch.float32, device=cuda)
    eng.warmup()
    assert len(eng._graphs) == 3 + 2 * 3  # decode per mode, prefill per
    assert eng.audit_pages() == [] and not eng.has_work()
    mem = eng.memory_stats()
    assert mem["graphs"] == 9 and mem["graph_pool_bytes"] > 0
    kernels.reset_launch_counts()
    toks, counts = _graph_trace(eng, tok, GRAPH_WAVES[:1])
    assert eng.step_clock_stats()["events"]["retrace"] == 0
    ref = LLMEngine(params, TINY, tok, EngineConfig(
        paged=PagedCacheConfig(64, 4, 16), max_batch=4,
        prefill_buckets=(8, 32)), dtype=torch.float32, device=cuda,
        _graphs=False)
    assert (toks, counts) == _graph_trace(ref, tok, GRAPH_WAVES[:1])


@pytest.mark.gpu
def test_load_checkpoint_to_cuda_equals_cpu(cuda):
    import os

    from distributed_inference_server_tpu_torch.models.loader import (
        load_checkpoint,
    )

    ckpt = os.path.join(os.path.dirname(__file__), "fixtures",
                        "tiny_llama_hf")
    for dtype in (torch.float32, torch.bfloat16):
        on_card, cfg = load_checkpoint(ckpt, dtype=dtype, device=cuda)
        on_cpu, cfg2 = load_checkpoint(ckpt, dtype=dtype, device="cpu")
        assert cfg == cfg2

        def walk(a, b):
            assert set(a) == set(b)
            for k in a:
                if isinstance(a[k], dict):
                    walk(a[k], b[k])
                else:
                    assert a[k].device.type == "cuda"
                    assert torch.equal(a[k].cpu(), b[k]), k

        walk(on_card, on_cpu)


@pytest.mark.gpu
def test_profile_steps_traces_the_card(cuda):
    """A trace over engine steps, started and stopped by the engine between
    steps, sees the graph replays' kernels and a busy share in (0, 1]."""
    params = _scaled_params(TINY, cuda, torch.float32)
    tok = ByteTokenizer()
    eng = LLMEngine(params, TINY, tok, EngineConfig(
        paged=PagedCacheConfig(64, 4, 16), max_batch=4,
        prefill_buckets=(8, 32)), dtype=torch.float32, device=cuda)
    eng.add_request("r", tok.encode("trace me"),
                    SamplingParams(max_tokens=40, temperature=0.0))
    eng.step()
    ev, holder = eng.profile_steps(3)
    for _ in range(3):
        eng.step()
    assert ev.is_set() and "error" not in holder, holder
    assert holder["device_events"] > 0
    assert 0.0 < holder["busy_share"] <= 1.0 + 1e-6


# ---------------------------------------------------------------------------
# looped blocks (one WHILE-graph launch each) and the mixed step's graphs
# ---------------------------------------------------------------------------


def _loop_engine(cuda, cfg, params, dtype, graphs=True, **kw):
    paged = (PagedCacheConfig(64, 4, 24) if cfg is TINY
             else PagedCacheConfig())
    ecfg = dict(max_batch=4, prefill_buckets=(8, 32)) if cfg is TINY else {}
    return LLMEngine(params, cfg, ByteTokenizer(), EngineConfig(
        paged=paged, **{**ecfg, **kw}), dtype=dtype, device=cuda,
        _graphs=graphs)


def _loop_model(cuda, model):
    from distributed_inference_server_tpu_torch.models.configs import (
        LLAMA_3_2_1B,
    )

    if model == "tiny-f32":
        return TINY, torch.float32, _scaled_params(TINY, cuda, torch.float32)
    cfg = LLAMA_3_2_1B.with_overrides(num_layers=2)
    return cfg, torch.bfloat16, _scaled_params(cfg, cuda, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["tiny-f32", "1b-width-2-layers-bf16"])
@pytest.mark.parametrize("cap", [256, 3])
def test_loop_graph_matches_eager_loop_and_fixed_path(cuda, model, cap):
    """Looped blocks launched as WHILE graphs give the eager loop's greedy
    tokens, exits, iterations and kernel launches, and the fixed K-step
    path's tokens with the same launches per decode step (the iteration's
    recorded launches times the iterations the block ran)."""
    cfg, dtype, params = _loop_model(cuda, model)
    tok = ByteTokenizer()
    runs = {}
    for name, loop, graphs in (("graph", True, True), ("eager", True, False),
                               ("fixed", False, True)):
        eng = _loop_engine(cuda, cfg, params, dtype, graphs,
                           loop_to_completion=loop, loop_max_steps=cap)
        toks, counts = _graph_trace(eng, tok, GRAPH_WAVES)
        sc = eng.step_clock_stats()["kinds"]
        if loop:
            st = eng.loop_stats()
            steps = st["steps"]
            assert sc["decode_block"]["dispatches"] == 0
        else:
            st = None
            steps = sc["decode_block"]["dispatches"] * 8
        runs[name] = (toks, counts, st, steps, eng)
    (gt, gc, gst, gsteps, geng) = runs["graph"]
    (et, ec, est, _, _) = runs["eager"]
    (ft, fc, _, fsteps, _) = runs["fixed"]
    assert ("loop", 0) in geng._graphs
    assert gt == et == ft
    assert gst == est and gc == ec
    assert gsteps > 0 and gc["paged_decode"] > 0
    per_step = gc["paged_decode"] / gsteps
    assert per_step == fc["paged_decode"] / fsteps == cfg.num_layers
    assert gc["rms_norm"] - fc["rms_norm"] == (
        (gsteps - fsteps) * (2 * cfg.num_layers + 1))
    if cap == 3:
        assert gst["exits"]["cap"] >= 1
    # a block is one launch: one loop dispatch per block
    assert sc_dispatches(geng) == gst["blocks"]


def sc_dispatches(eng):
    return eng.step_clock_stats()["kinds"]["loop"]["dispatches"]


@pytest.mark.gpu
def test_loop_graph_pages_and_eos_match_eager(cuda):
    """A tight pool starves the device free-list mid-block (exit 'pages')
    and an EOS id fires inside a block: graph and eager loops agree on
    tokens, exits and iterations, and the page books balance."""
    params = _scaled_params(TINY, cuda, torch.float32)
    tok = ByteTokenizer()
    probe = _loop_engine(cuda, TINY, params, torch.float32,
                         loop_to_completion=True)
    stream = _graph_trace(probe, tok, [[("find eos", 12)]])[0]["w0r0"]
    firsts = {}
    for j, t in enumerate(stream):
        firsts.setdefault(t, j)
    eos = max(firsts, key=firsts.get)  # fires deepest into the stream
    assert firsts[eos] >= 1  # after the prefill-sampled token
    out = {}
    for graphs in (True, False):
        eos_tok = ByteTokenizer()
        eos_tok.eos_ids = (eos,)
        eng = LLMEngine(params, TINY, eos_tok, EngineConfig(
            paged=PagedCacheConfig(20, 4, 24), max_batch=4,
            prefill_buckets=(8, 32), loop_to_completion=True),
            dtype=torch.float32, device=cuda, _graphs=graphs)
        waves = [[("find eos", 12), ("a longer prompt " * 2, 20),
                  ("z", 20)]]
        toks, counts = _graph_trace(eng, tok, waves)
        assert eng.audit_pages() == [] and eng.allocator.device_held() == 0
        events = eng.step_clock_stats()["events"]
        events.pop("retrace")  # graphs captured (none when eager)
        out[graphs] = (toks, counts, eng.loop_stats(), events)
    assert out[True] == out[False]
    exits = out[True][2]["exits"]
    assert exits["eos"] >= 1
    # the 20-page pool runs short: rows starve on the device free-list or
    # the host preempts
    assert exits["pages"] >= 1 or out[True][3]["preempt"] >= 1


@pytest.mark.gpu
def test_sampled_loop_draws_new_noise_every_iteration(cuda):
    """One looped block of a row at temperature 1e4 (logits / temperature
    nearly flat, so the Gumbel noise picks each token): its iterations
    draw different tokens (the noise key folds in the step counter), and
    a second block draws another stream (a new key per launch)."""
    params = _scaled_params(TINY, cuda, torch.float32)
    tok = ByteTokenizer()
    eng = _loop_engine(cuda, TINY, params, torch.float32,
                       loop_to_completion=True)
    streams = []
    for i in range(2):
        eng.add_request(f"hot{i}", tok.encode("noise"),
                        SamplingParams(max_tokens=13, temperature=1e4))
        toks = []
        while eng.has_work():
            for o in eng.step():
                if o.token_id is not None:
                    toks.append(o.token_id)
        streams.append(toks[1:])  # the first token comes from prefill
    assert ("loop", 1) in eng._graphs
    for s in streams:
        assert len(s) == 12 and len(set(s)) >= 6, s
    assert streams[0] != streams[1]


@pytest.mark.gpu
def test_sampled_loop_tokens_stay_in_the_nucleus(cuda):
    """Top-p rows through looped graphs: every sampled token lies in the
    nucleus of the model's distribution at its step (computed from an
    independent dense forward over the emitted prefix)."""
    from distributed_inference_server_tpu_torch.ops.sampling import (
        nucleus_cutoff,
    )

    params = _scaled_params(TINY, cuda, torch.float32)
    tok = ByteTokenizer()
    eng = _loop_engine(cuda, TINY, params, torch.float32,
                       loop_to_completion=True)
    prompts = ["nucleus one", "nucleus two, longer"]
    for i, p in enumerate(prompts):
        eng.add_request(f"s{i}", tok.encode(p), SamplingParams(
            max_tokens=16, temperature=0.7, top_p=0.6))
    toks = {}
    while eng.has_work():
        for o in eng.step():
            if o.token_id is not None:
                toks.setdefault(o.request_id, []).append(o.token_id)
    assert ("loop", 2) in eng._graphs
    for i, p in enumerate(prompts):
        ids = tok.encode(p) + toks[f"s{i}"]
        n = len(ids) - 1
        pool = torch.zeros(TINY.num_layers, 4 * (n // 4 + 1) + 1,
                           TINY.num_kv_heads, TINY.head_dim, device=cuda)
        pos = torch.arange(n, dtype=torch.int32, device=cuda)[None]
        logits, _, _ = llama.paged_forward(
            params, TINY, torch.tensor([ids[:n]], dtype=torch.int32,
                                       device=cuda), pos, pool,
            pool.clone(), pos, torch.arange(
                n // 4 + 1, dtype=torch.int32, device=cuda)[None],
            torch.tensor([n], dtype=torch.int32, device=cuda),
            impl="plain", page_size=4)
        first = len(tok.encode(p)) - 1
        probs = torch.softmax(logits[0, first:] / 0.7, dim=-1)
        cut = nucleus_cutoff(probs, torch.full((probs.shape[0],), 0.6,
                                               device=cuda))
        chosen = torch.tensor(toks[f"s{i}"], device=cuda)
        p_chosen = probs.gather(1, chosen[:, None])
        # 1e-6: f32 rounding between the engine's and this forward
        assert bool((p_chosen >= cut - 1e-6).all()), (p_chosen, cut)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["none", "int8"])
@pytest.mark.parametrize("loop", [False, True])
def test_mixed_graph_matches_eager_mixed(cuda, kv, loop):
    """The mixed step captured per sampling mode (K = 1, or the K-block
    form under ``loop_to_completion``) gives the eager mixed step's greedy
    tokens and kernel launches, over dense and int8 pools."""
    params = _scaled_params(TINY, cuda, torch.float32)
    tok = ByteTokenizer()
    out = {}
    for graphs in (True, False):
        kernels.reset_launch_counts()
        eng = LLMEngine(params, TINY, tok, EngineConfig(
            max_batch=4, prefill_buckets=(8, 32),
            paged=PagedCacheConfig(64, 4, 24), mixed_step_tokens=20,
            kv_quant=kv, loop_to_completion=loop), dtype=torch.float32,
            device=cuda, _graphs=graphs)
        toks = _drive_tiny(eng, tok, ["chat one", "chat two!"],
                           "a long prompt " * 5)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        out[graphs] = (toks, counts, eng.mixed_stats(), eng.loop_stats())
        if graphs:
            K = eng.ecfg.decode_block_size if loop else 1
            assert ("mixed", K, 0) in eng._graphs
    assert out[True] == out[False]
    counts = out[True][1]
    if kv == "none":
        assert counts["paged_ragged"] > 0
    else:  # int8 pools: the plain ragged path, the int8 decode kernel
        assert "paged_ragged" not in counts
        assert counts["paged_decode_int8"] > 0
    assert out[True][2]["decode_tokens"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["loop", "mixed"])
def test_failed_loop_and_mixed_capture_raises(cuda, monkeypatch, path):
    """A refused WHILE-graph build of a looped block, or a refused capture
    of a mixed step, raises out of step(); the engine does not run the
    eager path in its place."""
    from distributed_inference_server_tpu_torch.engine import engine as em

    params = _scaled_params(TINY, cuda, torch.float32)
    tok = ByteTokenizer()
    kw = (dict(loop_to_completion=True) if path == "loop"
          else dict(mixed_step_tokens=20))
    eng = _loop_engine(cuda, TINY, params, torch.float32, **kw)

    def refuse(*a, **k):
        raise RuntimeError("capture refused")

    if path == "loop":  # the mixed step is off: prefill graphs capture
        monkeypatch.setattr(em, "LoopGraph", refuse)
    else:  # the mixed step is the first dispatch
        monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", refuse)
    eng.add_request("r", tok.encode("no fallback " * 3),
                    SamplingParams(max_tokens=6, temperature=0.0))
    with pytest.raises(RuntimeError, match="capture refused"):
        for _ in range(6):
            eng.step()
    if path == "loop":
        assert ("loop", 0) not in eng._graphs


@pytest.mark.gpu
def test_warmup_captures_loop_and_mixed_graphs(cuda):
    """With the loop and the mixed step on, warmup captures the decode,
    prefill, mixed (K-block form) and loop graphs per sampling mode;
    serving afterwards captures nothing and matches the eager engine."""
    params = _scaled_params(TINY, cuda, torch.float32)
    tok = ByteTokenizer()
    kw = dict(loop_to_completion=True, mixed_step_tokens=20)
    eng = _loop_engine(cuda, TINY, params, torch.float32, **kw)
    eng.warmup()
    keys = set(eng._graphs)
    K = eng.ecfg.decode_block_size
    for mode in (0, 1, 2):
        assert {("loop", mode), ("mixed", K, mode),
                ("decode", mode)} <= keys
    assert eng.audit_pages() == [] and not eng.has_work()
    toks = _drive_tiny(eng, tok, ["chat one", "chat two!"],
                       "a long prompt " * 5)
    assert eng.step_clock_stats()["events"]["retrace"] == 0
    ref = _loop_engine(cuda, TINY, params, torch.float32, graphs=False, **kw)
    assert toks == _drive_tiny(ref, tok, ["chat one", "chat two!"],
                               "a long prompt " * 5)


# ---------------------------------------------------------------------------
# the model families' shapes: Gemma-2 (H 16, KV 8, D 256, softcap 50, a
# 4096 window) and Qwen2 (H 28, KV 4: G 7, D 128)
# ---------------------------------------------------------------------------

# (H, KV, D, window, softcap): gemma2-9b's local and global layers, a
# window shorter than the rows, and qwen2-7b's full causal layers
FAMILY_SHAPES = [(16, 8, 256, 4096, 50.0), (16, 8, 256, 0, 50.0),
                 (16, 8, 256, 300, 0.0), (28, 4, 128, 0, 0.0),
                 (28, 4, 128, 300, 30.0)]


def _sentinel_below_window(tables, valid, window, ps, num_pages, lows):
    """Set every table entry whose page lies wholly below the lowest query's
    window edge to the engine's reclaim sentinel ``num_pages`` (what
    ``_reclaim_window_pages`` leaves there): the kernels walk from the
    window's edge and must read none of them. ``lows``: each row's lowest
    query position."""
    if window <= 0:
        return tables
    t = tables.clone()
    for b, q in enumerate(lows):
        dead = max(0, q - window + 1) // ps  # pages wholly below the edge
        t[b, :dead] = num_pages
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("pools", ["dense", "int8"])
@pytest.mark.parametrize("H,KV,D,window,softcap", FAMILY_SHAPES)
def test_family_decode_kernel(cuda, pools, H, KV, D, window, softcap):
    """Decode rows up to 2048 keys in a 128-page table (split, merged in
    the launch), with sentinel entries below each row's window."""
    if pools == "int8":
        q, pk, pv, tables = _int8_pools(cuda, torch.bfloat16, 8, H, KV, D,
                                        16, 128, 1024, seed=D + H)
    else:
        q, pk, pv, tables = _pool_case(cuda, torch.bfloat16, 8, H, KV, D, 16,
                                       128, 1024, seed=D + H)
    tables = _sentinel_below_window(tables, LONG_VALID, window, 16, 1024,
                                    [max(v - 1, 0) for v in LONG_VALID])
    valid = torch.tensor(LONG_VALID, dtype=torch.int32, device=cuda)
    kw = dict(page_size=16, sliding_window=window, attn_softcap=softcap)
    assert pa._uses_mma(torch.bfloat16, D, H // KV)
    counter = pa.paged_decode_int8 if pools == "int8" else pa.paged_decode
    n = counter.launches
    got = pa.paged_decode(q, pk, pv, tables, valid, **kw)
    want = _decode_plain(pools)(q, pk, pv, tables, valid, **kw)
    torch.cuda.synchronize()
    assert counter.launches == n + 1
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))
    assert not got[1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", sorted(DEEP_PREFILL))
@pytest.mark.parametrize("T", [512, 77])
@pytest.mark.parametrize("H,KV,D,window,softcap", FAMILY_SHAPES)
def test_family_prefill_kernel(cuda, rows, T, H, KV, D, window, softcap):
    """A [B, T] chunk over deep histories (whole and partial query tiles:
    TQ = 64 at G 2, 18 at G 7), sentinels below each row's window."""
    q_start, valid = DEEP_PREFILL[rows]
    if q_start[0] + T > 2048:
        T = 2048 - q_start[0]
    B = len(q_start)
    q, pk, pv, tables = _pool_case(cuda, torch.bfloat16, B, H, KV, D, 16,
                                   128, 1024, T=T, seed=D + T)
    tables = _sentinel_below_window(tables, None, window, 16, 1024, q_start)
    i32 = dict(dtype=torch.int32, device=cuda)
    qs, vl = torch.tensor(q_start, **i32), torch.tensor(valid(T), **i32)
    kw = dict(page_size=16, sliding_window=window, attn_softcap=softcap)
    n = pa.paged_prefill.launches
    got = pa.paged_prefill(q, pk, pv, tables, qs, vl, **kw)
    want = pa.paged_prefill_plain(q, pk, pv, tables, qs, vl, **kw)
    torch.cuda.synchronize()
    assert pa.paged_prefill.launches == n + 1
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))
    if B == 4:
        assert not got[3].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(LONG_RAGGED))
@pytest.mark.parametrize("H,KV,D,window,softcap", FAMILY_SHAPES)
def test_family_ragged_kernel(cuda, case, H, KV, D, window, softcap):
    args = list(_long_ragged_inputs(cuda, case, H, KV, D, seed=D + H))
    tok_row, q_pos = args[4].tolist(), args[5].tolist()
    lows = [min([p for r, p in zip(tok_row, q_pos) if r == b] or [0])
            for b in range(args[3].shape[0])]
    args[3] = _sentinel_below_window(args[3], None, window, 16, 2048, lows)
    kw = dict(page_size=16, sliding_window=window, attn_softcap=softcap)
    n = pa.paged_ragged.launches
    got = pa.paged_ragged(*args, **kw)
    want = pa.paged_ragged_plain(*args, **kw)
    torch.cuda.synchronize()
    assert pa.paged_ragged.launches == n + 1
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))
    assert not got[args[4] < 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["decode", "prefill", "ragged"])
def test_family_attention_is_deterministic(cuda, kernel):
    """D 256: two calls on the same split inputs give the same bits."""
    if kernel == "decode":
        q, pk, pv, tables = _pool_case(cuda, torch.bfloat16, 8, 16, 8, 256,
                                       16, 128, 1024, seed=21)
        args = (q, pk, pv, tables, torch.tensor(LONG_VALID,
                                                dtype=torch.int32,
                                                device=cuda))
        fn = pa.paged_decode
    elif kernel == "ragged":
        args = _long_ragged_inputs(cuda, "served mix", 16, 8, 256, seed=21)
        fn = pa.paged_ragged
    else:
        q, pk, pv, tables = _pool_case(cuda, torch.bfloat16, 1, 16, 8, 256,
                                       16, 128, 1024, T=64, seed=21)
        i32 = dict(dtype=torch.int32, device=cuda)
        args = (q, pk, pv, tables, torch.tensor([1900], **i32),
                torch.tensor([1964], **i32))
        fn = pa.paged_prefill
    first = fn(*args, page_size=16, attn_softcap=50.0)
    for _ in range(3):
        assert torch.equal(fn(*args, page_size=16, attn_softcap=50.0), first)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 512, 3584), (8, 1, 3584)])
def test_family_rms_norm_kernel(cuda, shape):
    """H 3584 (gemma2-9b, qwen2-7b): a 4096-wide masked block."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(*shape, generator=g, device=cuda).bfloat16()
    w = (1 + 0.1 * torch.randn(shape[-1], generator=g,
                               device=cuda)).bfloat16()
    got = fused.rms_norm(x, w, 1e-6)
    torch.testing.assert_close(got.float(),
                               fused.rms_norm_plain(x, w, 1e-6).float(),
                               **_tol(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 512, 16, 256), (8, 1, 8, 256)])
def test_family_rope_kernel(cuda, shape):
    """D 256 (gemma2-9b): half 128."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(*shape, generator=g, device=cuda).bfloat16()
    pos = torch.randint(0, 8192, shape[:2], generator=g, device=cuda,
                        dtype=torch.int32)
    inv = rope_frequencies(256, 1e4, None, device=cuda)
    got = fused.apply_rope(x, pos, inv)
    torch.testing.assert_close(got.float(),
                               fused.apply_rope_plain(x, pos, inv).float(),
                               **_tol(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 2048])
def test_mixtral_int8_moe_kernel_path_matches_plain(cuda, M):
    """2 Mixtral MoE layers at full width (8 experts of 4096 x 14336, top
    2) with int8 experts, at a decode step's and a [4, 512] chunk's token
    counts: each layer's 24 group-dequant launches give the plain path's
    output within bf16 tolerance."""
    from distributed_inference_server_tpu_torch.models.configs import (
        MIXTRAL_8X7B,
    )
    from distributed_inference_server_tpu_torch.ops.quant import (
        init_random_quantized,
    )

    cfg = MIXTRAL_8X7B.with_overrides(num_layers=2)
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = init_random_quantized(cfg, "int8", gen, device=cuda)
    x = torch.randn(1, M, cfg.hidden_size, generator=gen,
                    device=cuda).bfloat16()
    for layer in range(cfg.num_layers):
        n = qm.quant_matmul_q8.launches
        got = llama._moe_mlp(x, params["layers"], layer, cfg, "kernel")
        torch.cuda.synchronize()
        assert qm.quant_matmul_q8.launches == n + 3 * cfg.num_experts
        want = llama._moe_mlp(x, params["layers"], layer, cfg, "plain")
        assert qm.quant_matmul_q8.launches == n + 3 * cfg.num_experts
        torch.testing.assert_close(got.float(), want.float(),
                                   **_tol(torch.bfloat16))


FAMILY_MODELS = ["gemma2-9b", "qwen2-7b", "mistral-7b", "mixtral-8x7b"]


@pytest.mark.gpu
@pytest.mark.parametrize("model", FAMILY_MODELS)
def test_family_graph_path_matches_eager_path(cuda, model):
    """2 layers of each family's width in bf16 (Mixtral with int8
    experts): the captured decode blocks and prefill chunks give the eager
    path's greedy tokens and launches (the D 256 and G 7 bodies, the MoE's
    group-dequant products inside the captures)."""
    from distributed_inference_server_tpu_torch.models.configs import (
        get_config,
    )
    from distributed_inference_server_tpu_torch.ops.quant import (
        init_random_quantized,
    )

    cfg = get_config(model).with_overrides(num_layers=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_random_quantized(cfg, "int8" if cfg.is_moe else "none",
                                   gen, dtype=torch.bfloat16, device=cuda)
    tok = ByteTokenizer()
    outs = {}
    for graphs in (True, False):
        eng = LLMEngine(params, cfg, tok, EngineConfig(), device=cuda,
                        _graphs=graphs)
        outs[graphs] = _graph_trace(eng, tok, GRAPH_WAVES)
        del eng
    assert outs[True] == outs[False]
    counts = outs[True][1]
    assert counts["paged_decode"] > 0 and counts["paged_prefill"] > 0
    assert (counts["quant_matmul_q8"] > 0) == cfg.is_moe


@pytest.mark.gpu
def test_window_reclaim_kernel_path_matches_plain(cuda):
    """TINY with a 16-token window in f32 on the card, rows decoding far
    past it: the kernels (which walk from the window's edge and never read
    a sentinel page) give the plain path's tokens, pages are reclaimed and
    the books balance."""
    cfg = TINY.with_overrides(sliding_window=16)
    params = _scaled_params(TINY, cuda, torch.float32)
    tok = ByteTokenizer()
    outs = {}
    for impl in ("kernel", "plain"):
        eng = LLMEngine(params, cfg, tok, EngineConfig(
            attention_impl=impl, max_batch=4, prefill_buckets=(8, 32),
            paged=PagedCacheConfig(24, 4, 32)), dtype=torch.float32,
            device=cuda)
        outs[impl] = _graph_trace(eng, tok, [
            [("window " * 6, 90), ("b", 100), ("a third row", 80)]])[0]
        assert eng.step_clock_stats()["events"]["reclaim"] > 0
        assert eng.audit_pages() == []
        del eng
    assert outs["kernel"] == outs["plain"]


# ---------------------------------------------------------------------------
# the API surface: embeddings and streamed text on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["tiny-f32", "1b-width-2-layers-bf16"])
def test_embeddings_kernel_path_matches_plain_path(cuda, model):
    """The embeddings forward on the kernel path (Triton RMSNorm and RoPE,
    which launch) gives the plain path's vectors; queued on the engine
    stream behind a decode block in flight, its steps never wait on the
    device, and the decoding request keeps its solo tokens."""
    cfg, dtype, params = _loop_model(cuda, model)
    tok = ByteTokenizer()
    texts = ["alpha", "a longer input " * 40, "é🙂 mixed"]
    ids = [tok.encode(t) for t in texts]
    out = {}
    for impl in ("kernel", "plain"):
        eng = _loop_engine(cuda, cfg, params, dtype, attention_impl=impl)
        out[impl] = eng.embed_ids(ids)
    tol = _tol(dtype)
    torch.testing.assert_close(torch.from_numpy(out["kernel"]),
                               torch.from_numpy(out["plain"]),
                               atol=max(tol["atol"], 1e-4) / 4, rtol=0)

    eng = _loop_engine(cuda, cfg, params, dtype)
    solo = _graph_trace(eng, tok, [[("keep decoding", 24)]])[0]
    eng.add_request("w0r0", tok.encode("keep decoding"),
                    SamplingParams(max_tokens=24, temperature=0.0))
    got = {}
    for o in eng.step():  # prefill, and the first block in flight
        if o.token_id is not None:
            got.setdefault(o.request_id, []).append(o.token_id)
    kernels.reset_launch_counts()
    state = eng.embed_start(ids)
    torch.cuda.set_sync_debug_mode("error")
    try:
        while not eng.embed_step(state):
            pass
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = kernels.launch_counts()
    assert counts["rms_norm"] > 0 and counts["rope"] > 0
    torch.testing.assert_close(torch.from_numpy(eng.embed_finish(state)),
                               torch.from_numpy(out["kernel"]),
                               atol=1e-5, rtol=0)
    while eng.has_work():
        for o in eng.step():
            if o.token_id is not None:
                got.setdefault(o.request_id, []).append(o.token_id)
    assert got == solo


@pytest.mark.gpu
def test_streamed_text_matches_non_streamed_on_the_card(cuda):
    """The served ``/generate`` on the card: the SSE deltas of a greedy
    stream join into the non-streamed text, for a lone request and for
    four concurrent ones."""
    import concurrent.futures as cf
    import json
    import urllib.request

    from distributed_inference_server_tpu_torch.serving.server import (
        InferenceServer,
    )

    params = _scaled_params(TINY, cuda, torch.float32)

    def factory():
        return LLMEngine(params, TINY, ByteTokenizer(), EngineConfig(
            paged=PagedCacheConfig(64, 4, 16), max_batch=4,
            prefill_buckets=(8, 32)), dtype=torch.float32, device=cuda)

    server = InferenceServer(factory, ByteTokenizer(), "tiny")
    server.start()
    base = f"http://127.0.0.1:{server.serve('127.0.0.1', 0, block=False)}"

    def post(body):
        req = urllib.request.Request(base + "/generate",
                                     json.dumps(body).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read().decode()

    def streamed(prompt):
        raw = post({"prompt": prompt, "max_tokens": 30, "temperature": 0.0,
                    "stream": True})
        frames = [json.loads(f[6:]) for f in raw.split("\n\n")
                  if f.startswith("data: {")]
        assert frames[-1]["type"] == "done"
        return "".join(f["token"] for f in frames if f["type"] == "token")

    try:
        prompts = ["stream on the card", "a longer prompt " * 3, "z", "é🙂"]
        want = [json.loads(post({"prompt": p, "max_tokens": 30,
                                 "temperature": 0.0}))["choices"][0]["text"]
                for p in prompts]
        assert [streamed(p) for p in prompts] == want
        with cf.ThreadPoolExecutor(4) as ex:
            assert list(ex.map(streamed, prompts)) == want
    finally:
        server.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
def test_prefill_kernel_at_the_verify_shape(cuda, dtype, D):
    """The speculative verify forward: B 8 rows of T = gamma + 1 = 5
    queries from per-row q_start around a page edge, deep in the row and
    at the capacity (the last row's last two queries past it, kv_valid
    clamped to the capacity, as the engine's verify forward does)."""
    P, ps, T = 128, 16, 5
    q, pk, pv, tables = _pool_case(cuda, dtype, 8, 32, 8, D, ps, P, 1024,
                                   T=T, seed=3)
    starts = [0, 15, 16, 17, 300, 1000, 2043, 2045]
    q_start = torch.tensor(starts, dtype=torch.int32, device=cuda)
    valid = torch.tensor([min(s + T, P * ps) for s in starts],
                         dtype=torch.int32, device=cuda)
    got = pa.paged_prefill(q, pk, pv, tables, q_start, valid, page_size=ps)
    want = pa.paged_prefill_plain(q, pk, pv, tables, q_start, valid,
                                  page_size=ps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_spec_engine_graph_matches_eager_and_plain_decoding(cuda, kv_quant):
    """A speculative engine on the card (TINY, f32, a draft of another
    seed): greedy tokens equal the plain engine's on the fixed path, in
    looped blocks and in the mixed step under the loop; graph launches
    equal eager launches."""
    from distributed_inference_server_tpu_torch.engine.speculative import (
        SpecConfig,
    )

    params = _scaled_params(TINY, cuda, torch.float32)
    draft = _scaled_params(TINY, cuda, torch.float32, seed=7)
    tok = ByteTokenizer()
    prompts = ["speculate on the card", "a longer prompt " * 3, "z"]

    def run(draft_params, graphs=True, **kw):
        eng = LLMEngine(params, TINY, tok, EngineConfig(
            paged=PagedCacheConfig(64, 4, 16), max_batch=4,
            prefill_buckets=(8, 32), decode_block_size=3, kv_quant=kv_quant,
            **kw), dtype=torch.float32, device=cuda, _graphs=graphs,
            draft_params=draft_params,
            draft_cfg=TINY if draft_params is not None else None,
            spec=SpecConfig(num_draft_tokens=3))
        kernels.reset_launch_counts()
        for i, p in enumerate(prompts):
            eng.add_request(f"r{i}", tok.encode(p), SamplingParams(
                max_tokens=20, temperature=0.0))
        toks = {}
        while eng.has_work():
            for o in eng.step():
                assert o.error is None, o.error
                if o.token_id is not None:
                    toks.setdefault(o.request_id, []).append(o.token_id)
        assert eng.audit_pages() == []
        return toks, dict(kernels.launch_counts())

    want, _ = run(None)
    for kw in ({}, {"loop_to_completion": True},
               {"loop_to_completion": True, "mixed_step_tokens": 12,
                "loop_max_steps": 1}):
        got, counts = run(draft, **kw)
        eager, eager_counts = run(draft, graphs=False, **kw)
        assert got == eager == want, kw
        assert counts == eager_counts, kw


def _kv_engine(cuda, graphs=True, **kw):
    params = _scaled_params(TINY, cuda, torch.float32)
    return LLMEngine(params, TINY, ByteTokenizer(), EngineConfig(
        paged=PagedCacheConfig(32, 4, 16), max_batch=4,
        prefill_buckets=(8, 32), **kw), dtype=torch.float32, device=cuda,
        _graphs=graphs)


def _kv_drain(eng, toks):
    while eng.has_work() and not eng.handoff_ready_ids():
        for o in eng.step():
            assert o.error is None, o.error
            if o.token_id is not None:
                toks.append(o.token_id)
    return toks


@pytest.mark.gpu
@pytest.mark.parametrize("loop", [False, True])
def test_raw_handoff_over_graph_replays_token_identical(cuda, loop):
    """A raw handoff between two engines on the card, the target decoding
    through graph replays (fixed or looped blocks, captured by warmup
    before the import): the never-migrated engine's greedy tokens, the
    imported pages written in place so the replays read them."""
    tok = ByteTokenizer()
    prompt = tok.encode("migrate this prompt across engines, please")
    sp = SamplingParams(max_tokens=24, temperature=0.0)
    ref = _kv_engine(cuda, loop_to_completion=loop)
    ref.add_request("r", prompt, sp)
    want = _kv_drain(ref, [])
    src = _kv_engine(cuda, loop_to_completion=loop)
    dst = _kv_engine(cuda, loop_to_completion=loop)
    dst.warmup()  # every graph captured before the import
    pools = (dst.state.k.data_ptr(), dst.state.v.data_ptr())
    src.add_request("r", prompt, sp, prefill_only=True)
    got = _kv_drain(src, [])
    dst.import_sequence(src.export_handoff("r"))
    kernels.reset_launch_counts()
    _kv_drain(dst, got)
    assert got == want
    assert (dst.state.k.data_ptr(), dst.state.v.data_ptr()) == pools
    assert kernels.launch_counts()["paged_decode"] > 0
    assert src.audit_pages() == [] and dst.audit_pages() == []


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_host_tier_reload_over_graph_replays_token_identical(cuda, quant):
    """A prefix demoted to the host tier (gathered on the engine stream,
    copied into pinned memory behind an event) and reloaded by one
    in-place scatter: the prefill chunk and decode graphs replayed after
    it give a cold engine's greedy tokens (exactly, for the raw tier)."""
    tok = ByteTokenizer()
    prompt = list(range(40, 60)) + [7, 8]
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    cold = _kv_engine(cuda)
    cold.add_request("c", prompt, sp)
    want = _kv_drain(cold, [])
    eng = _kv_engine(cuda, host_tier_bytes=1 << 22, host_tier_quant=quant)
    eng.warmup()
    eng.add_request("w", prompt, sp)
    _kv_drain(eng, [])
    for i in range(8):  # cycle the pool: the prefix demotes
        eng.add_request(f"c{i}", tok.encode(f"churn {i} " * 6),
                        SamplingParams(max_tokens=2, temperature=0.0))
        _kv_drain(eng, [])
    eng.add_request("p", prompt, sp)
    got = _kv_drain(eng, [])
    assert eng.host_tier_stats()["hit_pages"] > 0
    if quant == "none":
        assert got == want
    else:
        assert len(got) == len(want)
    assert eng.audit_pages() == []


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_pinned_pulls_equal_synchronous_copies(cuda, kv_quant):
    """Payloads pulled through pinned memory behind an event carry the
    bytes a synchronous ``.cpu()`` of the same slots reads, while the
    engine stream is busy with other work."""
    from distributed_inference_server_tpu_torch.engine import kv_cache as kv

    eng = _kv_engine(cuda, kv_quant=kv_quant)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for pool in (eng.state.k, eng.state.v):
        for t in ((pool.data, pool.scale) if kv_quant == "int8"
                  else (pool,)):
            t.copy_(torch.randn(t.shape, generator=gen, device=cuda) * 40)
    pages = [5, 1, 9, 3, 30, 12]
    slots = torch.tensor(kv._page_slots(pages, 4), device=cuda)
    with torch.cuda.stream(eng._stream):
        busy = torch.randn(4096, 4096, device=cuda)
        for _ in range(8):
            busy = busy @ busy  # queued ahead of the pulls
        blob = kv.serialize_kv(eng.state, pages, 4, 24)
        chunks = list(kv.serialize_kv_chunks(eng.state, pages, 4,
                                             chunk_pages=2))
    torch.cuda.synchronize()

    def host(t):
        return t.index_select(1, slots).cpu()

    if kv_quant == "int8":
        parts = (host(eng.state.k.data), host(eng.state.v.data),
                 host(eng.state.k.scale), host(eng.state.v.scale))
        kind, name = kv._KIND_QPOOL, "int8"
    else:
        parts = (host(eng.state.k), host(eng.state.v))
        kind, name = kv._KIND_RAW, "float32"
    want = kv._encode_payload(kind, name, tuple(parts[0].shape), 24, parts)
    assert blob == want
    fresh = _kv_engine(cuda, kv_quant=kv_quant)
    sess = kv.KvImportSession(fresh.state, fresh.allocator, 4)
    sess.reserve(len(pages))
    for c in chunks:
        sess.add_chunk(c)
    _, got_pages = sess.finish(fresh.state, list(range(len(pages) * 4)))
    assert kv.serialize_kv(fresh.state, got_pages, 4, 24) == want


def _served_greedy(server, prompts, max_tokens=30):
    import concurrent.futures as cf
    import json
    import urllib.request

    base = f"http://127.0.0.1:{server.serve('127.0.0.1', 0, block=False)}"

    def post(prompt):
        body = {"prompt": prompt, "max_tokens": max_tokens,
                "temperature": 0.0}
        req = urllib.request.Request(base + "/generate",
                                     json.dumps(body).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["choices"][0]["text"]

    lone = [post(p) for p in prompts]
    with cf.ThreadPoolExecutor(len(prompts)) as ex:
        return lone, list(ex.map(post, prompts))


# each prompt and its 30 new tokens fit the 64-token capacity
REPLICA_PROMPTS = ["replicas on the card", "a longer prompt, pages", "z",
                   "hand the pages over"]


def _replica_servers(cuda, **kw):
    """A one-engine server and a two-replica one (``kw``) on the card,
    the same TINY f32 weights: their greedy texts, lone and concurrent."""
    from distributed_inference_server_tpu_torch.serving.server import (
        InferenceServer,
    )

    params = _scaled_params(TINY, cuda, torch.float32)

    def factory():
        return LLMEngine(params, TINY, ByteTokenizer(), EngineConfig(
            paged=PagedCacheConfig(64, 4, 16), max_batch=4,
            prefill_buckets=(8, 32)), dtype=torch.float32, device=cuda)

    out = []
    for extra in ({}, kw):
        server = InferenceServer(factory, ByteTokenizer(), "tiny", **extra)
        server.start()
        try:
            out.append(_served_greedy(server, REPLICA_PROMPTS))
            if extra:
                stats = server.stats()
                assert all(r["audit"] == [] for r in stats["replicas"])
                out.append(stats)
        finally:
            server.shutdown()
    return out


@pytest.mark.gpu
def test_two_replicas_match_one_engine_on_the_card(cuda):
    """Two unified replicas (round robin) on one card give one engine's
    greedy texts, lone and concurrent, and each replica served."""
    from distributed_inference_server_tpu_torch.serving.scheduler import (
        SchedulingStrategy,
    )

    one, two, stats = _replica_servers(
        cuda, num_engines=2, strategy=SchedulingStrategy.ROUND_ROBIN)
    assert two == one
    assert all(r["requests_finished"] for r in stats["replicas"])


@pytest.mark.gpu
@pytest.mark.parametrize("stream", [True, False])
def test_prefill_decode_pair_matches_one_engine_on_the_card(cuda, stream):
    """A prefill/decode pair on one card (streamed or monolithic handoff)
    gives one engine's greedy texts; every request decodes on the decode
    replica."""
    from distributed_inference_server_tpu_torch.serving.disagg import (
        DisaggSettings,
    )

    one, pair, stats = _replica_servers(
        cuda, num_engines=2, engine_roles="prefill,decode",
        disagg_settings=DisaggSettings(stream=stream, chunk_pages=2))
    assert pair == one
    n = 2 * len(REPLICA_PROMPTS)
    assert stats["disagg"]["handoffs"] == {"ok": n}
    assert [r["requests_finished"] for r in stats["replicas"]] == [0, n]
