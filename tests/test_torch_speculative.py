"""The port's speculative-decoding core against the JAX package's
(``engine/speculative.py`` and the two nucleus helpers of
``ops/sampling.py``).

- ``top_p_filter_probs`` / ``nucleus_probs`` and ``_probs``: the JAX
  functions' values on the same inputs, within 1e-6.
- ``accept_and_resample``: greedy rows (one-hot laws) are compared with
  the JAX function exactly, token by token, with and without ``spec_ok``
  masks and nucleus filtering; sampled rows by distribution (the two
  packages draw different random bits): the first emitted token follows
  the target's nucleus law, and the acceptance rate matches the JAX one
  on the same laws within sampling noise.
- ``AcceptanceTracker`` / ``PatternTrackers`` / ``spec_signature``: the
  same update sequences on a fake clock give the JAX stats exactly; the
  cases of ``tests/test_speculative.py``.
- ``spec_round`` / ``speculative_generate`` over the dense cache: greedy
  output equals plain greedy decoding and the JAX ``speculative_generate``
  on the same weights (f32, TINY), whatever the draft.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.engine import speculative as jspec
from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu.ops import sampling as jsampling
from distributed_inference_server_tpu_torch.engine import speculative as pspec
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.generate import generate
from distributed_inference_server_tpu_torch.ops import sampling as psampling


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _softmax(rng, shape, scale=1.5):
    x = rng.normal(size=shape).astype(np.float32) * scale
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# the nucleus helpers and the temperature law
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_p", [1.0, 0.95, 0.9, 0.5, 0.05])
def test_nucleus_helpers_match_jax(top_p):
    rng = np.random.default_rng(3)
    probs = _softmax(rng, (6, 64), scale=2.0)
    tp = np.full((6,), top_p, np.float32)
    tp[0] = 1.0  # one row unfiltered
    want = np.asarray(jsampling.top_p_filter_probs(jnp.asarray(probs),
                                                   jnp.asarray(tp)))
    got = psampling.top_p_filter_probs(_t(probs), _t(tp)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-6)
    p3 = probs.reshape(2, 3, 64)
    want = np.asarray(jsampling.nucleus_probs(jnp.asarray(p3),
                                              jnp.asarray(tp[:2, None])))
    got = psampling.nucleus_probs(_t(p3), _t(tp[:2, None])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_probs_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(4, 3, 32)).astype(np.float32) * 3
    temp = np.asarray([0.0, 0.5, 1.0, 1.7], np.float32)
    want = np.asarray(jspec._probs(jnp.asarray(logits),
                                   jnp.asarray(temp)[:, None]))
    got = pspec._probs(_t(logits), _t(temp)[:, None]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# accept_and_resample
# ---------------------------------------------------------------------------


def _greedy_case(seed, B=16, gamma=4, V=24):
    """One-hot target and draft laws (temperature 0) with proposals that
    match the target's argmax for a random prefix of each row."""
    rng = np.random.default_rng(seed)
    target_logits = rng.normal(size=(B, gamma + 1, V)).astype(np.float32)
    target_ps = np.asarray(pspec._probs(_t(target_logits),
                                        torch.zeros(B, 1)))
    arg = target_logits.argmax(-1)
    match = rng.integers(0, gamma + 1, size=B)
    draft = arg[:, :gamma].copy()
    for b in range(B):
        if match[b] < gamma:
            draft[b, match[b]] = (draft[b, match[b]] + 1 + rng.integers(
                0, V - 1)) % V
    draft_qs = np.eye(V, dtype=np.float32)[draft]
    return target_ps, draft.astype(np.int32), draft_qs, match


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("greedy_only", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_accept_and_resample_greedy_exact(seed, greedy_only, masked):
    target_ps, draft, draft_qs, match = _greedy_case(seed)
    B = draft.shape[0]
    ok = np.ones((B,), bool)
    if masked:
        ok[::3] = False
    top_p = np.full((B,), 0.9, np.float32) if seed == 2 else None
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    want_t, want_n = jspec.accept_and_resample(
        jnp.asarray(target_ps), jnp.asarray(draft), jnp.asarray(draft_qs),
        k1, k2, spec_ok=jnp.asarray(ok) if masked else None,
        top_p=None if top_p is None else jnp.asarray(top_p),
        greedy_only=jnp.asarray(greedy_only))
    got_t, got_n = pspec.accept_and_resample(
        _t(target_ps), _t(draft), _t(draft_qs),
        torch.Generator().manual_seed(seed),
        spec_ok=_t(ok) if masked else None,
        top_p=None if top_p is None else _t(top_p), greedy_only=greedy_only)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    expect = np.where(ok, match, 0) if masked else match
    np.testing.assert_array_equal(got_n.numpy(), expect)


def test_accept_and_resample_nucleus_law_and_acceptance():
    """Sampled rows: with proposals drawn from the draft's filtered q~,
    the first token of each round follows the target's nucleus law
    exactly (outside-nucleus tokens never appear), and the acceptance
    rate matches the JAX function's on the same laws."""
    V, gamma, N = 8, 2, 40_000
    rng = np.random.default_rng(3)
    # overlapping target and draft laws (the JAX case's softmax of
    # normal * 1.5 draws; here flatter, so the two nuclei overlap)
    p = _softmax(rng, (V,), scale=0.7)
    q = _softmax(rng, (V,), scale=0.7)
    q_f = np.asarray(jsampling.nucleus_probs(jnp.asarray(q[None]),
                                             jnp.asarray([0.9])))[0]
    p_f = np.asarray(jsampling.nucleus_probs(jnp.asarray(p[None]),
                                             jnp.asarray([0.9])))[0]
    draft_qs = np.broadcast_to(q_f, (N, gamma, V)).copy()
    draft = rng.choice(V, size=(N, gamma), p=q_f / q_f.sum()).astype(
        np.int32)
    target_ps = np.broadcast_to(p, (N, gamma + 1, V)).copy()
    topp = np.full((N,), 0.9, np.float32)
    got_t, got_n = pspec.accept_and_resample(
        _t(target_ps), _t(draft), _t(draft_qs),
        torch.Generator().manual_seed(0), top_p=_t(topp))
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    _, want_n = jspec.accept_and_resample(
        jnp.asarray(target_ps), jnp.asarray(draft), jnp.asarray(draft_qs),
        k1, k2, top_p=jnp.asarray(topp))
    hist = np.bincount(got_t[:, 0].numpy(), minlength=V) / N
    assert hist[p_f == 0].sum() == 0.0
    np.testing.assert_allclose(hist, p_f, atol=0.02)
    got_mean = got_n.numpy().mean()
    assert got_mean + 1 > 1.2
    assert abs(got_mean - float(np.asarray(want_n).mean())) < 0.03


# ---------------------------------------------------------------------------
# trackers
# ---------------------------------------------------------------------------


def test_spec_signature_matches_jax():
    from types import SimpleNamespace as P

    for t in (0.0, 0.3, 0.5, 0.7, 1.0, 1.5):
        for tp in (1.0, 0.95, 0.9, 0.5):
            params = P(temperature=t, top_p=tp)
            assert pspec.spec_signature(params) == jspec.spec_signature(
                params)


def test_pattern_trackers_match_jax():
    clock = {"t": 0.0}
    cfg_kw = dict(num_draft_tokens=3, window=6, disable_threshold=0.5,
                  reenable_after_s=10.0)
    ref = jspec.PatternTrackers(jspec.SpecConfig(**cfg_kw),
                                clock=lambda: clock["t"])
    got = pspec.PatternTrackers(pspec.SpecConfig(**cfg_kw),
                                clock=lambda: clock["t"])
    rng = np.random.default_rng(9)
    sigs = [(0, 0), (2, 1), (3, 2)]
    for step in range(200):
        sig = sigs[int(rng.integers(0, 3))]
        op = rng.choice(["update", "update", "probation", "tick", "disable"])
        if op == "update":
            rows = int(rng.integers(1, 4))
            acc = int(rng.integers(0, 3 * rows + 1))
            ref.update(sig, acc, 3 * rows, rows)
            got.update(sig, acc, 3 * rows, rows)
        elif op == "probation":
            assert got.consume_probation(sig) == ref.consume_probation(sig)
        elif op == "tick":
            clock["t"] += float(rng.uniform(0.0, 6.0))
        elif step % 50 == 0:
            ref.disable(sig)
            got.disable(sig)
        assert got.stats() == ref.stats()
        assert got.enabled(sig) == ref.enabled(sig)
        assert got.all_enabled == ref.all_enabled
    got.reset()
    assert got.all_enabled and got.stats()["patterns"] == {}


def test_tracker_auto_disable_and_probation():
    cfg = pspec.SpecConfig(num_draft_tokens=4, disable_threshold=0.5,
                           window=4)
    t = pspec.AcceptanceTracker(cfg)
    for _ in range(3):
        t.update(1, 4)
        assert t.enabled  # the window is not full yet
    t.update(1, 4)
    assert not t.enabled and t.rate() == 0.25
    t.reset()
    assert t.enabled
    clock = {"t": 0.0}
    t = pspec.AcceptanceTracker(
        pspec.SpecConfig(window=8, disable_threshold=0.5,
                         reenable_after_s=10.0), clock=lambda: clock["t"])
    for _ in range(8):
        t.update(0, 4)
    assert not t.enabled and not t.consume_probation()
    clock["t"] = 10.0
    assert t.enabled and t.rate() == 0.0  # the pure read resets nothing
    assert t.consume_probation() and t.rate() == 1.0
    t = pspec.AcceptanceTracker(
        pspec.SpecConfig(window=4, disable_threshold=0.5,
                         reenable_after_s=0.0), clock=lambda: clock["t"])
    for _ in range(4):
        t.update(0, 4)
    clock["t"] = 1e9
    assert not t.enabled
    t.reset()
    assert t.enabled


# ---------------------------------------------------------------------------
# rounds over the dense cache
# ---------------------------------------------------------------------------


def _tree(key):
    jp = j_llama.init_params(jax.random.PRNGKey(key), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * 8.0
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * 8.0
    return tree


@pytest.fixture(scope="module")
def trees():
    return _tree(0), _tree(7)


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu", dtype=torch.float32))


def test_speculative_generate_greedy_matches_jax_and_plain(trees):
    (jt, pt), (jd, pd) = _both(trees[0]), _both(trees[1])
    prompt = np.random.default_rng(1).integers(
        0, TINY.vocab_size, size=(2, 5)).astype(np.int32)
    want = generate(pt, TINY, _t(prompt), torch.full((2,), 5), None,
                    torch.zeros(2), torch.ones(2), 10, 64).tokens.numpy()
    for j_draft, p_draft in ((jt, pt), (jd, pd)):
        tracker = pspec.AcceptanceTracker(pspec.SpecConfig(
            num_draft_tokens=3))
        got = pspec.speculative_generate(
            p_draft, TINY, pt, TINY, _t(prompt), 10, 64,
            pspec.SpecConfig(num_draft_tokens=3), tracker=tracker)
        ref = jspec.speculative_generate(
            j_draft, J_TINY, jt, J_TINY, jnp.asarray(prompt), 10, 64,
            jspec.SpecConfig(num_draft_tokens=3))
        assert got.tolist() == want.tolist() == np.asarray(ref).tolist()
        if p_draft is pt:
            assert tracker.rate() == 1.0 and tracker.speedup() > 2.0


def test_disabled_tracker_and_sampled_support(trees):
    (_, pt), (_, pd) = _both(trees[0]), _both(trees[1])
    prompt = torch.ones((1, 4), dtype=torch.int32)
    cfg = pspec.SpecConfig(num_draft_tokens=4, disable_threshold=2.0,
                           window=1)
    tracker = pspec.AcceptanceTracker(cfg)
    tracker.update(0, 4)  # disabled at once: rounds of gamma 1
    assert not tracker.enabled
    want = generate(pt, TINY, prompt, torch.full((1,), 4), None,
                    torch.zeros(1), torch.ones(1), 8, 64).tokens.numpy()
    got = pspec.speculative_generate(pd, TINY, pt, TINY, prompt, 8, 64,
                                     cfg, tracker=tracker)
    assert got.tolist() == want.tolist()
    got = pspec.speculative_generate(
        pd, TINY, pt, TINY, torch.ones((2, 4), dtype=torch.int32), 12, 64,
        pspec.SpecConfig(num_draft_tokens=3), temperature=0.8,
        generator=torch.Generator().manual_seed(5), top_p=0.9)
    assert got.shape == (2, 12)
    assert (got >= 0).all() and (got < TINY.vocab_size).all()
    with pytest.raises(ValueError, match="too small"):
        pspec.speculative_generate(pd, TINY, pt, TINY, prompt, 60, 64)
