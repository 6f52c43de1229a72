"""The port's plain ops against the JAX package's, on the same inputs.

Inputs are made with numpy from a seed and handed to both packages;
everything runs in float32 on the CPU. Tolerance 1e-5 (absolute) for the
elementwise and attention ops: both sides compute in f32 and differ only
in summation order. The nucleus kept sets must be identical, greedy
sampling must pick the same ids, and temperature/top-p draws are compared
by their distribution (the random bits differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.models.configs import (
    LLAMA_3_2_1B as J_1B,
)
from distributed_inference_server_tpu.ops import attention as j_attn
from distributed_inference_server_tpu.ops import norms as j_norms
from distributed_inference_server_tpu.ops import rotary as j_rotary
from distributed_inference_server_tpu.ops import sampling as j_sampling
from distributed_inference_server_tpu_torch.models.configs import (
    LLAMA_3_2_1B,
    RopeScaling,
)
from distributed_inference_server_tpu_torch.ops import attention as t_attn
from distributed_inference_server_tpu_torch.ops import norms as t_norms
from distributed_inference_server_tpu_torch.ops import rotary as t_rotary
from distributed_inference_server_tpu_torch.ops import sampling as t_sampling
from distributed_inference_server_tpu_torch.utils.device import resolve_device

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 128), (1, 1, 2048)])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_rms_norm_matches_jax(shape, impl):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = np.asarray(j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = t_norms.rms_norm(_t(x), _t(w), 1e-5, impl).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("head_dim,theta,scaled", [
    (64, 500000.0, True),  # llama-3.2-1b: Llama-3 scaling
    (64, 500000.0, False),
    (16, 10000.0, False),  # TINY
    (128, 500000.0, True),
])
def test_rope_frequencies_match_jax(head_dim, theta, scaled):
    j_scaling = J_1B.rope_scaling if scaled else None
    t_scaling = LLAMA_3_2_1B.rope_scaling if scaled else None
    want = np.asarray(j_rotary.rope_frequencies(head_dim, theta, j_scaling))
    got = t_rotary.rope_frequencies(head_dim, theta, t_scaling).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)


def test_rope_scaling_matches_jax_dataclass():
    assert LLAMA_3_2_1B.rope_scaling == RopeScaling(
        **J_1B.rope_scaling.__dict__)


@pytest.mark.parametrize("shape", [(2, 7, 4, 16), (1, 3, 32, 64)])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_apply_rope_matches_jax(shape, impl):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 2048, size=shape[:2]).astype(np.int32)
    inv = np.asarray(j_rotary.rope_frequencies(
        shape[-1], 500000.0, J_1B.rope_scaling))
    want = np.asarray(j_rotary.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          jnp.asarray(inv)))
    got = t_rotary.apply_rope(_t(x), _t(pos), _t(inv), impl).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,T,H,KV,D,S,window,softcap", [
    (2, 5, 4, 2, 16, 12, None, None),
    (3, 1, 8, 2, 16, 20, None, None),  # decode: one query per row
    (2, 4, 4, 4, 32, 16, 3, None),  # MHA with a sliding window
    (2, 6, 4, 1, 16, 10, None, 30.0),  # MQA with softcap
])
def test_gqa_attention_matches_jax(B, T, H, KV, D, S, window, softcap):
    rng = np.random.default_rng(B * 100 + T)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    valid = rng.integers(T, S + 1, size=B).astype(np.int32)
    pos = (valid[:, None] - T + np.arange(T)[None, :]).astype(np.int32)
    want = np.asarray(j_attn.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(valid), window, softcap))
    got = t_attn.gqa_attention(_t(q), _t(k), _t(v), _t(pos), _t(valid),
                               window, softcap).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("tok_row,KV,window,softcap", [
    ([0, 1, 1, 1, 2, 2, -1, -1], 2, None, None),  # decode + chunks + tail
    ([-1, 1, -1, 3, 4, 4, 4, 4, 4], 4, None, None),  # -1 between rows
    ([0, 0, 0, 2, 2, 2, 2, -1], 1, 3, None),  # MQA, window, empty row 1
    ([1, 0, 0, 0, 0, 2], 4, None, 30.0),  # softcap, rows out of order
    ([-1, -1, -1], 2, None, None),  # all padding
])
def test_ragged_gqa_attention_matches_jax(tok_row, KV, window, softcap):
    """Packed tokens against per-row windows, every token compared (JAX's
    padding outputs are the mean of V, and so are the port's)."""
    rng = np.random.default_rng(len(tok_row) * 10 + KV)
    S, H, D, Bm, Smax = len(tok_row), 4, 16, 5, 24
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    k = rng.standard_normal((Bm, Smax, KV, D)).astype(np.float32)
    v = rng.standard_normal((Bm, Smax, KV, D)).astype(np.float32)
    tok_row = np.asarray(tok_row, np.int32)
    hist = rng.integers(0, 12, size=Bm)
    pos = np.zeros((S,), np.int32)
    counts = np.zeros((Bm,), np.int32)
    for i, r in enumerate(tok_row):
        if r >= 0:
            pos[i] = hist[r] + counts[r]
            counts[r] += 1
    valid = (hist + counts).astype(np.int32)
    want = np.asarray(j_attn.ragged_gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tok_row),
        jnp.asarray(pos), jnp.asarray(valid), window, softcap))
    got = t_attn.ragged_gqa_attention(_t(q), _t(k), _t(v), _t(tok_row),
                                      _t(pos), _t(valid), window,
                                      softcap).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("top_p", [0.0, 0.3, 0.9, 0.999, 1.0])
def test_nucleus_cutoff_matches_jax_kept_sets(top_p):
    rng = np.random.default_rng(int(top_p * 1000))
    logits = (3 * rng.standard_normal((6, 300))).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    tp = np.full((6,), top_p, np.float32)
    tp[0] = 0.5  # mixed rows
    want = np.asarray(j_sampling.nucleus_cutoff(jnp.asarray(probs),
                                                jnp.asarray(tp)))
    got = t_sampling.nucleus_cutoff(_t(probs), _t(tp)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(probs >= got, probs >= want)
    # the row argmax always survives; top_p == 1 keeps everything
    assert (probs >= got)[np.arange(6), probs.argmax(-1)].all()
    if top_p >= 1.0:
        assert (probs[1:] >= got[1:]).all()


def test_cutoff_iterations_match_jax():
    assert t_sampling._CUTOFF_ITERS == j_sampling._CUTOFF_ITERS == 26


def test_sample_tokens_greedy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((5, 257)).astype(np.float32)
    logits[2, 10] = logits[2, 20] = logits[2].max() + 1  # first max wins
    temp = np.array([0.0, 0.0, 0.0, 0.7, 0.0], np.float32)
    top_p = np.array([1.0, 0.5, 1.0, 0.9, 0.1], np.float32)
    want = np.asarray(j_sampling.sample_tokens(
        jax.random.PRNGKey(0), jnp.asarray(logits), jnp.asarray(temp),
        jnp.asarray(top_p)))
    gen = torch.Generator().manual_seed(0)
    got = t_sampling.sample_tokens(_t(logits), _t(temp), _t(top_p),
                                   gen).numpy()
    greedy = temp == 0
    np.testing.assert_array_equal(got[greedy], want[greedy])
    assert got[2] == 10
    assert got.dtype == np.int32


def test_sample_tokens_respects_nucleus():
    """Sampled rows only ever draw from the nucleus: a row with one
    dominant token and top_p below its mass always returns it."""
    logits = torch.full((4, 50), -4.0)
    logits[:, 7] = 4.0
    temp = torch.full((4,), 1.0)
    top_p = torch.full((4,), 0.5)
    gen = torch.Generator().manual_seed(3)
    for _ in range(20):
        out = t_sampling.sample_tokens(logits, temp, top_p, gen)
        assert (out == 7).all()


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_sampled_distribution_matches_jax():
    """Temperature + top-p draws: the two packages use different random
    bits, so their empirical token frequencies are compared: 4000 draws
    each, 0.035 absolute (about three standard errors of the difference of
    two frequencies near 0.5; the seeds are fixed, so the outcome is too),
    and the port never draws outside the reference's support."""
    logits = np.array([[2.0, 1.6, 1.0, 0.2, -1.0, -3.0, 0.7, 1.9]],
                      np.float32)
    n = 4000
    temp = np.full((n,), 0.8, np.float32)
    top_p = np.full((n,), 0.9, np.float32)
    rows = np.repeat(logits, n, axis=0)
    want = np.asarray(j_sampling.sample_tokens(
        jax.random.PRNGKey(7), jnp.asarray(rows), jnp.asarray(temp),
        jnp.asarray(top_p)))
    gen = torch.Generator().manual_seed(7)
    got = t_sampling.sample_tokens(_t(rows), _t(temp), _t(top_p),
                                   gen).numpy()
    f_want = np.bincount(want, minlength=8) / n
    f_got = np.bincount(got, minlength=8) / n
    np.testing.assert_allclose(f_got, f_want, atol=0.035)
    assert set(np.unique(got)) <= set(np.flatnonzero(f_want > 0))
