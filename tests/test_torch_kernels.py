"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper in ``ops/kernels`` runs its plain PyTorch version;
here those are held against the Pallas kernels run with
``interpret=True`` (as tests/test_pallas_paged_attention.py runs them), on
the same numpy inputs, in float32: paged decode, chunked paged prefill,
RMSNorm and RoPE. Tolerance 2e-5 (absolute and relative), the Pallas
tests' own: both sides accumulate in f32 in another order.

The kernels themselves run only on a card: ``tests/test_torch_gpu.py``
holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.ops.pallas.fused import (
    apply_rope_pallas,
    rms_norm_pallas,
)
from distributed_inference_server_tpu.ops.pallas.paged_attention import (
    paged_attention_decode,
    paged_attention_prefill,
)
from distributed_inference_server_tpu.ops.rotary import rope_frequencies
from distributed_inference_server_tpu_torch.ops import kernels
from distributed_inference_server_tpu_torch.ops.kernels import fused
from distributed_inference_server_tpu_torch.ops.kernels import (
    paged_attention as pa,
)

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, B, H, KV, D, page_size, P, num_pages, T=None):
    rng = np.random.default_rng(seed)
    slots = num_pages * page_size
    pool_k = rng.standard_normal((slots, KV, D)).astype(np.float32)
    pool_v = rng.standard_normal((slots, KV, D)).astype(np.float32)
    shape = (B, H, D) if T is None else (B, T, H, D)
    q = rng.standard_normal(shape).astype(np.float32)
    tables = rng.permutation(num_pages)[: B * P].reshape(B, P)
    return rng, q, pool_k, pool_v, tables.astype(np.int32)


DECODE_CASES = [
    # B, H, KV, D, page_size, P, window, softcap
    (4, 8, 4, 16, 8, 4, 0, 0.0),  # GQA, ragged
    (2, 4, 4, 32, 8, 3, 0, 0.0),  # MHA
    (3, 16, 2, 64, 16, 2, 0, 0.0),  # heavy grouping, 1B head_dim
    (4, 8, 2, 16, 4, 6, 5, 0.0),  # sliding window
    (3, 8, 4, 16, 8, 4, 0, 30.0),  # softcap
    (3, 8, 4, 16, 8, 4, 7, 20.0),  # both
]


@pytest.mark.parametrize("B,H,KV,D,ps,P,window,softcap", DECODE_CASES)
def test_paged_decode_matches_pallas(B, H, KV, D, ps, P, window, softcap):
    rng, q, pk, pv, tables = _case(B * 31 + D, B, H, KV, D, ps, P,
                                   num_pages=32)
    valid = rng.integers(1, P * ps + 1, size=B).astype(np.int32)
    valid[0] = 0  # an empty row gives zeros
    want = np.asarray(paged_attention_decode(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(valid), page_size=ps,
        pages_per_block=2, interpret=True, sliding_window=window,
        attn_softcap=softcap))
    got = pa.paged_decode(_t(q), _t(pk), _t(pv), _t(tables), _t(valid),
                          page_size=ps, sliding_window=window,
                          attn_softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert not got[0].any()


PREFILL_CASES = [
    # B, T, H, KV, D, page_size, P, window, softcap
    (3, 8, 8, 4, 16, 4, 8, 0, 0.0),
    (2, 16, 4, 2, 32, 8, 4, 0, 0.0),
    (2, 8, 16, 2, 64, 8, 4, 0, 0.0),
    (3, 8, 8, 2, 16, 4, 8, 5, 0.0),  # window
    (2, 8, 8, 4, 16, 4, 8, 0, 25.0),  # softcap
]


@pytest.mark.parametrize("B,T,H,KV,D,ps,P,window,softcap", PREFILL_CASES)
def test_paged_prefill_matches_pallas(B, T, H, KV, D, ps, P, window,
                                      softcap):
    rng, q, pk, pv, tables = _case(B * 17 + T + D, B, H, KV, D, ps, P,
                                   num_pages=32, T=T)
    cap = P * ps
    q_start = rng.integers(1, cap - T, size=B).astype(np.int32)  # > 0
    chunk = rng.integers(1, T + 1, size=B)
    valid = (q_start + chunk).astype(np.int32)  # padded queries past it
    q_start[-1], valid[-1] = 0, 0  # a padding row: everything masked
    want = np.asarray(paged_attention_prefill(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(q_start), jnp.asarray(valid),
        page_size=ps, q_block=8, pages_per_block=2, interpret=True,
        sliding_window=window, attn_softcap=softcap))
    got = pa.paged_prefill(_t(q), _t(pk), _t(pv), _t(tables), _t(q_start),
                           _t(valid), page_size=ps, sliding_window=window,
                           attn_softcap=softcap).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert not got[-1].any()


@pytest.mark.parametrize("shape", [(8, 128), (2, 3, 256), (5, 2048)])
def test_rms_norm_matches_pallas(shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = np.asarray(rms_norm_pallas(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                      interpret=True))
    got = fused.rms_norm(_t(x), _t(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", [(2, 8, 4, 16), (1, 4, 32, 64),
                                   (3, 2, 8, 128)])
def test_rope_matches_pallas(shape):
    rng = np.random.default_rng(shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 4096, size=shape[:2]).astype(np.int32)
    inv = np.asarray(rope_frequencies(shape[-1], 500000.0))
    want = np.asarray(apply_rope_pallas(jnp.asarray(x), jnp.asarray(pos),
                                        jnp.asarray(inv), interpret=True))
    got = fused.apply_rope(_t(x), _t(pos), _t(inv)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_cpu_calls_do_not_count_as_launches():
    kernels.reset_launch_counts()
    x = torch.ones(2, 8)
    fused.rms_norm(x, torch.ones(8), 1e-5)
    assert kernels.launch_counts() == {
        "paged_decode": 0, "paged_prefill": 0, "rms_norm": 0, "rope": 0}


def test_other_devices_raise():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused.rms_norm(x, torch.empty(8, device="meta"), 1e-5)
