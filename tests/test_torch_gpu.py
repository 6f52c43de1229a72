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
from distributed_inference_server_tpu_torch.ops.rotary import (
    rope_frequencies,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (run with -m gpu on a GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
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
    assert all(n > 0 for n in counts.values()), counts
    assert outs["kernel"] == outs["plain"]
