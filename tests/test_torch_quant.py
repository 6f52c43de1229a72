"""The port's quantization ops and kernels' plain versions against the JAX
package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason:

- codes and scales (``quantize_int8``, ``quantize_int4``,
  ``quantize_kv``, ``quantize_params``): bit-identical — the same f32
  division order, the same floors, round half to even on both sides;
- ``dequantize`` / ``dequantize_kv``: within 1e-6 (they are one f32
  product each; in practice identical);
- ``quant_matmul_plain`` against ``quant_matmul_pallas(interpret=True)``
  in bf16: 2e-2 absolute plus 2^-6 relative, about two bf16 ulps of the
  outputs — both products take bf16 operands with f32 sums in another
  order and round once to bf16;
- ``quant_matmul_plain`` against JAX ``x @ dequantize(w)`` in f32: 1e-5
  (summation order only);
- ``paged_decode_int8_plain`` against the Pallas ``paged_attention_decode``
  over ``QuantPool`` pools (``interpret=True``) in f32: 2e-2, the JAX
  test's own — the TPU kernel casts q, the codes and the probabilities to
  bf16 for its matrix unit; and against the JAX package's XLA path for
  quantized pools (gather, ``dequantize_kv``, ``gqa_attention``): 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.ops import quant as jq
from distributed_inference_server_tpu.ops.attention import (
    gqa_attention as j_gqa_attention,
)
from distributed_inference_server_tpu.ops.pallas.fused import (
    quant_matmul_pallas,
)
from distributed_inference_server_tpu.ops.pallas.paged_attention import (
    paged_attention_decode,
)
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.ops import kernels
from distributed_inference_server_tpu_torch.ops import quant as tq
from distributed_inference_server_tpu_torch.ops.kernels import (
    paged_attention as pa,
)
from distributed_inference_server_tpu_torch.ops.kernels import (
    quant_matmul as qm,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(seed, shape, zero_cols=True):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    if zero_cols:
        w[..., 1] = 0.0  # an all-zero column: every group's scale floors
    return w


# stacked [L, in, out], several groups, in-dim below the group, one group
QUANT_CASES = [
    ((3, 256, 40), 128),
    ((2, 256, 24), 64),
    ((96, 48), 32),
    ((2, 32, 16), 64),  # in-dim 32 < group 64: one group of 32
    ((128, 8), 128),
]


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("shape,group", QUANT_CASES)
def test_quantize_bit_identical_to_jax(mode, shape, group):
    w = _weights(sum(shape) + group, shape)
    jfn = jq.quantize_int8 if mode == "int8" else jq.quantize_int4
    tfn = tq.quantize_int8 if mode == "int8" else tq.quantize_int4
    want = jfn(jnp.asarray(w), group)
    got = tfn(_t(w), group)
    assert type(got).__name__ == type(want).__name__
    assert got.q.dtype == (torch.int8 if mode == "int8" else torch.uint8)
    assert got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    np.testing.assert_allclose(
        tq.dequantize(got, torch.float32).numpy(),
        np.asarray(jq.dequantize(want, jnp.float32)), atol=1e-6, rtol=0)


def test_quantize_rejects_bad_groups():
    with pytest.raises(ValueError, match="does not divide"):
        tq.quantize_int8(torch.zeros(96, 4), 64)
    with pytest.raises(ValueError, match="int4 needs"):
        tq.quantize_int4(torch.zeros(3, 4), 64)


def test_int4_packing_low_nibble_is_even_row():
    w = torch.tensor([[-7.0], [3.0], [0.0], [7.0]])
    q4 = tq.quantize_int4(w, 4)
    assert q4.q.tolist() == [[(3 << 4) | (-7 & 0xF)], [(7 << 4) | 0]]
    assert tq.unpack_int4(q4.q).tolist() == [[-7], [3], [0], [7]]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_matches_jax(mode):
    # in-dims 256 and 384: several groups per layer at the modes' own
    # groups (int8 128, int4 64)
    L, H, I = 2, 256, 384
    names = {"wq": (H, H), "wk": (H, 64), "wv": (H, 64), "wo": (H, H),
             "w_gate": (H, I), "w_up": (H, I), "w_down": (I, H)}
    layers = {k: _weights(i, (L, *s), zero_cols=False)
              for i, (k, s) in enumerate(names.items())}
    layers["attn_norm"] = np.ones((L, H), np.float32)
    tree = {"embed": _weights(9, (128, H)), "layers": layers,
            "final_norm": np.ones((H,), np.float32)}
    jtree = {"embed": jnp.asarray(tree["embed"]),
             "final_norm": jnp.asarray(tree["final_norm"]),
             "layers": {k: jnp.asarray(v) for k, v in layers.items()}}
    ttree = {"embed": _t(tree["embed"]), "final_norm": _t(tree["final_norm"]),
             "layers": {k: _t(v) for k, v in layers.items()}}
    want = jq.quantize_params(jtree, mode)
    got = tq.quantize_params(ttree, mode)
    groups = 128 if mode == "int8" else 64
    assert got["layers"]["w_down"].s.shape == (L, I // groups, H)
    for k in names:
        np.testing.assert_array_equal(got["layers"][k].q.numpy(),
                                      np.asarray(want["layers"][k].q))
        np.testing.assert_array_equal(got["layers"][k].s.numpy(),
                                      np.asarray(want["layers"][k].s))
    assert got["layers"]["attn_norm"] is ttree["layers"]["attn_norm"]
    assert got["embed"] is ttree["embed"]
    assert tq.quantize_params(ttree, "none") is ttree
    with pytest.raises(ValueError, match="unknown quantization"):
        tq.quantize_params(ttree, "int2")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical_to_jax(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 1, 1] = 0.0  # a zero vector: scale 0, codes 0
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    jc, js = jq.quantize_kv(jx)
    tc, ts = tq.quantize_kv(tx)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 1, 1] == 0 and not tc[0, 1, 1].any()
    np.testing.assert_allclose(
        tq.dequantize_kv(tc, ts, torch.float32).numpy(),
        np.asarray(jq.dequantize_kv(jc, js, jnp.float32)), atol=1e-6, rtol=0)


def test_layer_weight():
    w = tq.quantize_int8(torch.randn(3, 64, 8), 32)
    w1 = tq.layer_weight(w, 1)
    assert isinstance(w1, tq.Q8Tensor)
    assert torch.equal(w1.q, w.q[1]) and torch.equal(w1.s, w.s[1])
    dense = torch.randn(3, 4, 4)
    assert torch.equal(tq.layer_weight(dense, 2), dense[2])


def test_params_from_numpy_carries_quantized_leaves():
    w = _weights(3, (2, 64, 16))
    tree = {"layers": {"wq": jq.quantize_int8(jnp.asarray(w), 32),
                       "w_up": jq.quantize_int4(jnp.asarray(w), 32),
                       "attn_norm": np.ones((2, 64), np.float32)}}
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    got = params_from_numpy(np_tree, device="cpu", dtype=torch.bfloat16)
    wq, wu = got["layers"]["wq"], got["layers"]["w_up"]
    assert isinstance(wq, tq.Q8Tensor) and isinstance(wu, tq.Q4Tensor)
    assert wq.q.dtype == torch.int8 and wu.q.dtype == torch.uint8
    assert wq.s.dtype == wu.s.dtype == torch.float32
    np.testing.assert_array_equal(wq.q.numpy(), np_tree["layers"]["wq"].q)
    np.testing.assert_array_equal(wu.s.numpy(), np_tree["layers"]["w_up"].s)
    assert got["layers"]["attn_norm"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# quant_matmul
# ---------------------------------------------------------------------------

MM_BF16_TOL = dict(atol=2e-2, rtol=2.0 ** -6)


@pytest.mark.parametrize("packed,M,K,N", [
    (False, 64, 512, 256), (False, 8, 1024, 128), (False, 128, 2048, 512),
    (True, 64, 512, 256), (True, 16, 1024, 512)])
def test_quant_matmul_plain_matches_pallas_bf16(packed, M, K, N):
    rng = np.random.default_rng(M + K + N + packed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    group = 64 if packed else 128
    jfn = jq.quantize_int4 if packed else jq.quantize_int8
    qt = jfn(jnp.asarray(w), group)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(quant_matmul_pallas(
        jx, qt.q, qt.s, group=group, packed=packed, interpret=True),
        np.float32)
    tw = (tq.Q4Tensor if packed else tq.Q8Tensor)(_t(qt.q), _t(qt.s))
    tx = _t(jx.astype(jnp.float32)).bfloat16()
    got = qm.quant_matmul_plain(tx, tw)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want, **MM_BF16_TOL)
    # the dispatching wrapper runs the plain version for CPU tensors
    assert torch.equal(qm.quant_matmul(tx, tw), got)


@pytest.mark.parametrize("packed,shape,K,N,group", [
    (False, (5,), 96, 40, 32), (True, (2, 3), 64, 24, 64),
    (False, (1,), 128, 8, 128), (True, (7,), 32, 16, 32)])
def test_quant_matmul_plain_matches_jax_f32(packed, shape, K, N, group):
    rng = np.random.default_rng(K + N)
    x = rng.standard_normal((*shape, K)).astype(np.float32)
    w = _weights(K, (K, N))
    jfn = jq.quantize_int4 if packed else jq.quantize_int8
    qt = jfn(jnp.asarray(w), group)
    want = np.asarray(jnp.asarray(x) @ jq.dequantize(qt, jnp.float32))
    tw = (tq.Q4Tensor if packed else tq.Q8Tensor)(_t(qt.q), _t(qt.s))
    got = qm.quant_matmul(_t(x), tw)
    assert got.shape == (*shape, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_quant_matmul_rejects_dense_weights():
    with pytest.raises(TypeError, match="Q8Tensor or Q4Tensor"):
        qm.quant_matmul(torch.ones(2, 4), torch.ones(4, 4))


# ---------------------------------------------------------------------------
# paged decode over int8 pools
# ---------------------------------------------------------------------------

INT8_DECODE_CASES = [
    # B, H, KV, D, page_size, P, window, softcap
    (4, 8, 4, 16, 8, 4, 0, 0.0),
    (3, 16, 2, 64, 16, 2, 0, 0.0),
    (4, 8, 2, 16, 4, 6, 5, 0.0),
    (3, 8, 4, 16, 8, 4, 7, 20.0),
]


def _int8_case(B, H, KV, D, ps, P, num_pages=32):
    rng = np.random.default_rng(B * 13 + D + P)
    slots = num_pages * ps
    k = rng.standard_normal((slots, KV, D)).astype(np.float32)
    v = rng.standard_normal((slots, KV, D)).astype(np.float32)
    k[3] = 0.0  # zero vectors: scale 0
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    tables = rng.permutation(num_pages)[: B * P].reshape(B, P)
    valid = rng.integers(1, P * ps + 1, size=B).astype(np.int32)
    valid[0] = 0  # an empty row gives zeros
    kc, ks = (np.asarray(a) for a in jq.quantize_kv(jnp.asarray(k)))
    vc, vs = (np.asarray(a) for a in jq.quantize_kv(jnp.asarray(v)))
    return q, (kc, ks), (vc, vs), tables.astype(np.int32), valid


@pytest.mark.parametrize("B,H,KV,D,ps,P,window,softcap", INT8_DECODE_CASES)
def test_paged_decode_int8_matches_jax(B, H, KV, D, ps, P, window, softcap):
    q, (kc, ks), (vc, vs), tables, valid = _int8_case(B, H, KV, D, ps, P)
    tk, tv = tq.QuantPool(_t(kc), _t(ks)), tq.QuantPool(_t(vc), _t(vs))
    kw = dict(page_size=ps, sliding_window=window, attn_softcap=softcap)
    got = pa.paged_decode(_t(q), tk, tv, _t(tables), _t(valid), **kw).numpy()
    assert np.array_equal(
        got, pa.paged_decode_int8_plain(_t(q), tk, tv, _t(tables),
                                        _t(valid), **kw).numpy())
    assert not got[0].any()

    # the TPU kernel (interpret mode): bf16 matrix-unit operands
    pallas = np.asarray(paged_attention_decode(
        jnp.asarray(q), jq.QuantPool(jnp.asarray(kc), jnp.asarray(ks)),
        jq.QuantPool(jnp.asarray(vc), jnp.asarray(vs)), jnp.asarray(tables),
        jnp.asarray(valid), page_size=ps, pages_per_block=2, interpret=True,
        sliding_window=window, attn_softcap=softcap))
    np.testing.assert_allclose(got[1:], pallas[1:], atol=2e-2, rtol=2e-2)

    # the JAX package's XLA path for quantized pools, in f32
    slots = (tables[:, :, None] * ps + np.arange(ps)).reshape(B, P * ps)
    k_seq = jq.dequantize_kv(jnp.asarray(kc[slots]), jnp.asarray(ks[slots]),
                             jnp.float32)
    v_seq = jq.dequantize_kv(jnp.asarray(vc[slots]), jnp.asarray(vs[slots]),
                             jnp.float32)
    pos = jnp.asarray(valid[:, None] - 1)
    xla = np.asarray(j_gqa_attention(
        jnp.asarray(q)[:, None], k_seq, v_seq, pos, jnp.asarray(valid),
        window or None, softcap or None))[:, 0]
    np.testing.assert_allclose(got[1:], xla[1:], atol=2e-5, rtol=2e-5)


def test_int8_decode_cpu_calls_do_not_count():
    kernels.reset_launch_counts()
    q, (kc, ks), (vc, vs), tables, valid = _int8_case(2, 4, 2, 16, 4, 2)
    pa.paged_decode(_t(q), tq.QuantPool(_t(kc), _t(ks)),
                    tq.QuantPool(_t(vc), _t(vs)), _t(tables), _t(valid),
                    page_size=4)
    w = tq.quantize_int4(torch.randn(32, 8), 32)
    qm.quant_matmul(torch.ones(3, 32), w)
    qm.quant_matmul(torch.ones(3, 32), tq.quantize_int8(torch.randn(32, 8)))
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_int8_wrappers_reject_other_devices():
    x = torch.empty(2, 32, device="meta")
    w = tq.Q8Tensor(torch.empty(32, 8, dtype=torch.int8, device="meta"),
                    torch.empty(1, 8, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        qm.quant_matmul(x, w)
    pool = tq.QuantPool(torch.empty(8, 1, 16, dtype=torch.int8,
                                    device="meta"),
                        torch.empty(8, 1, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        pa.paged_decode(torch.empty(1, 1, 16, device="meta"), pool, pool,
                        torch.empty(1, 2, dtype=torch.int32, device="meta"),
                        torch.empty(1, dtype=torch.int32, device="meta"),
                        page_size=4)
