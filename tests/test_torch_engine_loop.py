"""The port's looped decode blocks (``loop_to_completion``) against the JAX
package's fixed-K path and its looped path, greedy tokens identical.

The port counterparts of the non-speculative cases of
``tests/test_engine_loop.py``: the greedy identity fuzz, the dispatch and
step collapse, ``loop_stats`` off, the ``loop_max_steps`` check, free-list
exhaustion, CacheFull drain-then-preempt, the cap exit, the cap fraction,
an abort between looped blocks, and the mixed step's K-block form. Every
case holds the port's loop against BOTH JAX engines on the same weights
(TINY in float32, JAX ``init_params`` scaled by 8, ``attention_impl=
"xla"``, the Python allocator): the same tokens, the same ``loop_stats``
exits as the JAX loop, and ``audit_pages() == []``. A mid-block EOS case
scans prompts until EOS first fires inside the loop (the reference's own
test never gets there, ``ROADMAP.md`` queue 3). The allocator's device
draw and reconcile are replayed against the JAX allocator.

Not here yet: speculation inside the loop and the streamed KV export
overlap (the reference's ``test_spec_*`` and ``test_streamed_export_*``
cases) wait for the port of speculation and of the KV byte paths
(``ROADMAP.md`` queue 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.engine import kv_cache as jkv
from distributed_inference_server_tpu.engine.engine import (
    EngineConfig as JEngineConfig,
)
from distributed_inference_server_tpu.engine.engine import LLMEngine as JEngine
from distributed_inference_server_tpu.engine.engine import (
    SamplingParams as JSamplingParams,
)
from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu.models.tokenizer import (
    ByteTokenizer as JByteTokenizer,
)
from distributed_inference_server_tpu_torch.engine import kv_cache as tkv
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)

SCALE = 8.0
TOK = ByteTokenizer()


@pytest.fixture(scope="module")
def shared():
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * SCALE
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * SCALE
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu", dtype=torch.float32))


def _config(cls, pcls, loop, loop_max_steps, num_pages, max_pages_per_seq,
            max_batch, **kw):
    return cls(max_batch=max_batch, prefill_buckets=(8, 32),
               paged=pcls(num_pages=num_pages, page_size=4,
                          max_pages_per_seq=max_pages_per_seq),
               decode_block_size=4, loop_to_completion=loop,
               loop_max_steps=loop_max_steps, **kw)


def _engines(shared, loop_max_steps=64, num_pages=64, max_pages_per_seq=24,
             max_batch=4, eos=None, **kw):
    """{"jax-fixed", "jax-loop", "port-loop"} engines on the same weights
    (``kw`` apply to all three; ``eos`` replaces the tokenizers' EOS)."""
    j_params, t_params = shared
    out = {}
    for name, loop in (("jax-fixed", False), ("jax-loop", True)):
        tok = JByteTokenizer()
        if eos is not None:
            tok.eos_ids = (eos,)
        out[name] = JEngine(j_params, J_TINY, tok, _config(
            JEngineConfig, jkv.PagedCacheConfig, loop, loop_max_steps,
            num_pages, max_pages_per_seq, max_batch, attention_impl="xla",
            native_allocator=False, **kw), dtype=jnp.float32)
    tok = ByteTokenizer()
    if eos is not None:
        tok.eos_ids = (eos,)
    out["port-loop"] = LLMEngine(t_params, TINY, tok, _config(
        EngineConfig, tkv.PagedCacheConfig, True, loop_max_steps, num_pages,
        max_pages_per_seq, max_batch, **kw), dtype=torch.float32,
        device="cpu")
    return out


def _sp(engine, **kw):
    cls = JSamplingParams if isinstance(engine, JEngine) else SamplingParams
    return cls(**kw)


def _run(engine, actions, max_steps=800):
    """Apply ``actions`` — ("add", rid, ids, max_tokens), ("steps", n),
    ("abort", rid) — then drain. Returns ({rid: tokens}, engine steps)."""
    toks, steps = {}, 0

    def step():
        nonlocal steps
        steps += 1
        assert steps < max_steps, "engine did not drain"
        for out in engine.step():
            assert out.error is None, (out.request_id, out.error)
            if out.token_id is not None:
                toks.setdefault(out.request_id, []).append(out.token_id)

    for act in actions:
        if act[0] == "add":
            engine.add_request(act[1], list(act[2]), _sp(
                engine, max_tokens=act[3], temperature=0.0))
        elif act[0] == "abort":
            assert engine.abort(act[1])
        else:
            for _ in range(act[1]):
                step()
    while engine.has_work():
        step()
    return toks, steps


def _diff(got, want):
    return {k: (got.get(k), want.get(k))
            for k in set(got) | set(want) if got.get(k) != want.get(k)}


def _hold(engines, actions, fixed_keys=None):
    """Run ``actions`` on the three engines: the port's tokens must equal
    the JAX loop's and the JAX fixed path's (for ``fixed_keys`` only,
    where given), its loop exits the JAX loop's, and every page book must
    balance. Returns {name: (tokens, steps)}."""
    res = {name: _run(eng, actions) for name, eng in engines.items()}
    got = res["port-loop"][0]
    want = res["jax-loop"][0]
    assert got == want, _diff(got, want)
    fixed = res["jax-fixed"][0]
    if fixed_keys is not None:
        fixed = {k: v for k, v in fixed.items() if k in fixed_keys}
        got = {k: v for k, v in got.items() if k in fixed_keys}
    assert got == fixed, _diff(got, fixed)
    port, jloop = engines["port-loop"], engines["jax-loop"]
    assert port.loop_stats()["exits"] == jloop.loop_stats()["exits"]
    assert port.loop_stats()["steps"] == jloop.loop_stats()["steps"]
    assert port.loop_stats()["blocks"] == jloop.loop_stats()["blocks"]
    for eng in engines.values():
        assert eng.audit_pages() == []
    assert port.allocator.device_held() == 0
    return res


def _adds(prompts, budgets):
    return [("add", f"r{i}", ids, mt)
            for i, (ids, mt) in enumerate(zip(prompts, budgets))]


# ---------------------------------------------------------------------------
# greedy identity: looped blocks vs the fixed-K path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_loop_greedy_identity_fuzz(shared, seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 200, size=int(n)).tolist()
               for n in rng.integers(3, 20, size=4)]
    budgets = [int(b) for b in rng.integers(2, 16, size=4)]
    engines = _engines(shared)
    res = _hold(engines, _adds(prompts, budgets))
    got = res["port-loop"][0]
    stats = engines["port-loop"].loop_stats()
    assert stats["blocks"] >= 1
    # each request's first token comes from prefill, the rest from blocks
    assert stats["decode_tokens"] == (sum(len(v) for v in got.values())
                                      - len(got))
    assert stats["exits"]["budget"] >= 1


def test_loop_collapses_dispatches_and_steps(shared):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 200, size=6).tolist() for _ in range(3)]
    engines = _engines(shared)
    res = _hold(engines, _adds(prompts, [24] * 3))
    assert res["port-loop"][1] == res["jax-loop"][1]
    assert res["port-loop"][1] < res["jax-fixed"][1]
    got = res["port-loop"][0]
    kinds = engines["port-loop"].step_clock_stats()["kinds"]
    assert kinds["loop"]["dispatches"] >= 1
    assert kinds["loop"]["tokens"] == (sum(len(v) for v in got.values())
                                       - len(got))
    assert kinds["decode_block"]["dispatches"] == 0


def test_loop_stats_none_when_off(shared):
    eng = LLMEngine(shared[1], TINY, TOK, EngineConfig(max_batch=4),
                    dtype=torch.float32, device="cpu")
    assert eng.loop_stats() is None


@pytest.mark.parametrize("bad", [0, -3])
def test_loop_max_steps_validated(shared, bad):
    with pytest.raises(ValueError, match="loop_max_steps"):
        LLMEngine(shared[1], TINY, TOK, EngineConfig(
            loop_to_completion=True, loop_max_steps=bad),
            dtype=torch.float32, device="cpu")
    # the check binds only with the loop on, as in the reference
    LLMEngine(shared[1], TINY, TOK, EngineConfig(loop_max_steps=bad),
              dtype=torch.float32, device="cpu")


# ---------------------------------------------------------------------------
# stop conditions: EOS, budget, pages, cap
# ---------------------------------------------------------------------------


def _eos_scenario(shared):
    """A prompt and an EOS id whose first occurrence in the greedy stream
    is at index 2 or later (so EOS fires inside a looped block, not at
    the prefill-sampled token), scanning seeded prompts in order."""
    for seed in range(64):
        rng = np.random.default_rng(1000 + seed)
        prompt = rng.integers(1, 200, size=int(rng.integers(3, 12))).tolist()
        eng = _engines(shared)["port-loop"]
        toks, _ = _run(eng, [("add", "p", prompt, 12)])
        firsts = {}
        for j, t in enumerate(toks["p"]):
            firsts.setdefault(t, j)
        eos = max(firsts, key=firsts.get)
        if firsts[eos] >= 2:
            return prompt, eos, firsts[eos]
    raise AssertionError("no scanned prompt puts EOS inside the loop")


def test_mid_block_eos_identity(shared):
    prompt, eos, first = _eos_scenario(shared)
    assert first >= 2  # EOS fires inside the decode loop
    engines = _engines(shared, eos=eos)
    # a second row keeps the block alive past the EOS row's freeze
    actions = [("add", "e", prompt, 12),
               ("add", "other", TOK.encode("keep going"), 12)]
    res = _hold(engines, actions)
    got = res["port-loop"][0]
    # the stream stops just before EOS (which is not emitted)
    assert len(got["e"]) == first < 12 and eos not in got["e"]
    assert engines["port-loop"].loop_stats()["exits"]["eos"] >= 1


def test_free_list_exhaustion_repages_and_stays_identical(shared):
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 200, size=n).tolist() for n in (5, 9, 13)]
    engines = _engines(shared, num_pages=18)
    _hold(engines, _adds(prompts, [20] * 3))
    assert engines["port-loop"].loop_stats()["exits"]["pages"] >= 1


def test_cache_full_drain_then_preempt_under_loop(shared):
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, 200, size=6).tolist() for _ in range(3)]
    engines = _engines(shared, num_pages=12, max_pages_per_seq=8)
    res = _hold(engines, _adds(prompts, [18] * 3))
    got = res["port-loop"][0]
    assert set(got) == {"r0", "r1", "r2"}
    assert all(len(v) == 18 for v in got.values())
    ev = engines["port-loop"].step_clock_stats()["events"]
    assert ev["cache_full"] >= 1 and ev["preempt"] >= 1


def test_cap_exit_resumes_next_step(shared):
    rng = np.random.default_rng(19)
    prompts = [rng.integers(1, 200, size=7).tolist() for _ in range(2)]
    engines = _engines(shared, loop_max_steps=3)
    _hold(engines, _adds(prompts, [14] * 2))
    stats = engines["port-loop"].loop_stats()
    assert stats["exits"]["cap"] >= 1 and stats["blocks"] >= 2


def test_set_loop_cap_frac_shrinks_cap(shared):
    engines = _engines(shared, loop_max_steps=40)
    port, jloop = engines["port-loop"], engines["jax-loop"]
    for frac in (1.0, 0.25, 0.0, 0.5, 1.0):
        port.set_loop_cap_frac(frac)
        jloop.set_loop_cap_frac(frac)
        assert port.loop_stats() == jloop.loop_stats()
    port.set_loop_cap_frac(0.25)
    assert port.loop_stats()["cap"] == 10
    assert port.loop_stats()["cap_frac"] == 0.25
    port.set_loop_cap_frac(0.0)  # floored, never zero
    assert port.loop_stats()["cap"] >= 1
    # a shrunken cap changes the blocks, not the tokens
    port.set_loop_cap_frac(0.1)
    jloop.set_loop_cap_frac(0.1)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 200, size=5).tolist() for _ in range(2)]
    _hold(engines, _adds(prompts, [12] * 2))
    assert port.loop_stats()["exits"]["cap"] >= 1


# ---------------------------------------------------------------------------
# aborts
# ---------------------------------------------------------------------------


def test_abort_mid_block_releases_everything(shared):
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 200, size=6).tolist() for _ in range(3)]
    engines = _engines(shared, loop_max_steps=2)
    # a couple of capped blocks, everyone mid-decode, then r1 goes
    actions = _adds(prompts, [16] * 3) + [("steps", 2), ("abort", "r1")]
    res = _hold(engines, actions, fixed_keys={"r0", "r2"})
    got = res["port-loop"][0]
    assert len(got["r0"]) == 16 and len(got["r2"]) == 16
    assert len(got.get("r1", [])) < 16
    port = engines["port-loop"]
    s = port.cache_stats()
    assert s.pages_total - s.pages_free == s.pages_cached


# ---------------------------------------------------------------------------
# the mixed step's K-block form
# ---------------------------------------------------------------------------


def test_mixed_burst_identity_and_k_fusion(shared):
    """A long prompt lands mid-decode: the K-block mixed step advances
    every decode row K tokens per dispatch with the fixed path's tokens."""
    rng = np.random.default_rng(31)
    chats = [rng.integers(1, 200, size=6).tolist() for _ in range(2)]
    long_prompt = rng.integers(1, 200, size=60).tolist()
    # loop cap 1 keeps the chats mid-decode when the prompt lands
    engines = _engines(shared, loop_max_steps=1, mixed_step_tokens=20)
    actions = [("add", f"c{i}", c, 30) for i, c in enumerate(chats)]
    actions += [("steps", 3), ("add", "long", long_prompt, 8)]
    _hold(engines, actions)
    port, jloop = engines["port-loop"], engines["jax-loop"]
    ms = port.mixed_stats()
    assert ms == jloop.mixed_stats()
    assert ms["decode_tokens"] > 0
    assert ms["decode_tokens"] / ms["steps"] > 1.0


def test_mixed_dispatch_count_collapses_k_fold(shared):
    rng = np.random.default_rng(37)
    chat = rng.integers(1, 200, size=6).tolist()
    long_prompt = rng.integers(1, 200, size=90).tolist()
    actions = [("add", "chat", chat, 40), ("steps", 2),
               ("add", "long", long_prompt, 2)]

    def per_decode_token(eng):
        ms = eng.mixed_stats()
        assert eng.step_clock_stats()["kinds"]["mixed"]["dispatches"] == (
            ms["steps"])
        return ms["steps"] / max(1, ms["decode_tokens"])

    engines = _engines(shared, loop_max_steps=1, mixed_step_tokens=20)
    _hold(engines, actions)
    base = _engines(shared, loop_max_steps=1, mixed_step_tokens=20)
    port_k1 = LLMEngine(shared[1], TINY, TOK, _config(
        EngineConfig, tkv.PagedCacheConfig, False, 1, 64, 24, 4,
        mixed_step_tokens=20), dtype=torch.float32, device="cpu")
    _run(port_k1, actions)
    _run(base["jax-fixed"], actions)
    fused = per_decode_token(engines["port-loop"])
    assert fused == per_decode_token(engines["jax-loop"])
    one = per_decode_token(port_k1)
    assert one == per_decode_token(base["jax-fixed"])
    assert one >= 0.99  # the K = 1 form: one dispatch per decode token
    assert fused <= one / 2


# ---------------------------------------------------------------------------
# the allocator's device-held state
# ---------------------------------------------------------------------------


def _alloc_pair(num_pages=12):
    return (jkv.PageAllocator(jkv.PagedCacheConfig(num_pages, 4, 8)),
            tkv.PageAllocator(tkv.PagedCacheConfig(num_pages, 4, 8)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_and_reconcile_trace_matches_jax(seed):
    """Allocations, publishes, releases (cached pages for the LRU), device
    draws past the free list (LRU reclaim) and partial draws, and
    reconciles that claim some pages and return the rest: both
    allocators hand out the same pages in the same order, keep the same
    counts, and audit clean against the same live pages."""
    rng = np.random.default_rng(seed)
    ja, ta = _alloc_pair()
    live = []
    for op in range(40):
        kind = rng.integers(0, 4)
        if kind == 0 and ja.num_free() >= 2:
            got = [a.allocate(2) for a in (ja, ta)]
            assert got[0] == got[1]
            toks = rng.integers(0, 50, size=8).tolist()
            live.append((toks, got[0]))
        elif kind == 1 and live:
            toks, pages = live.pop(int(rng.integers(0, len(live))))
            for a in (ja, ta):
                a.publish(toks, pages)
                a.release(pages)
        else:
            n = int(rng.integers(0, 16))
            drawn = [a.draw_device(n) for a in (ja, ta)]
            assert drawn[0] == drawn[1]
            assert ja.device_held() == ta.device_held() == len(drawn[0])
            for a in (ja, ta):
                assert a.audit([p for _, ps in live for p in ps]) == []
            k = int(rng.integers(0, len(drawn[0]) + 1))
            claimed, returned = drawn[0][:k], drawn[0][k:]
            for a in (ja, ta):
                a.reconcile_device(claimed, returned)
            if claimed:
                live.append(([], claimed))
        assert ja.device_held() == ta.device_held() == 0
        assert list(ja._free) == list(ta._free)
        assert list(ja._lru) == list(ta._lru)
        js, ts = ja.stats(), ta.stats()
        assert (js.hits, js.misses, js.evictions, js.pages_free,
                js.pages_cached) == (ts.hits, ts.misses, ts.evictions,
                                     ts.pages_free, ts.pages_cached)
        held = [p for _, ps in live for p in ps]
        assert ja.audit(held) == ta.audit(held) == []


def test_reconcile_rejects_double_claim_and_unknown_pages():
    ja, ta = _alloc_pair()
    for a in (ja, ta):
        drawn = a.draw_device(3)
        a.reconcile_device(drawn[:1], [])
        with pytest.raises(ValueError, match="claimed but not device-held"):
            a.reconcile_device(drawn[:1], [])  # claimed twice
        with pytest.raises(ValueError, match="returned but not device-held"):
            a.reconcile_device([], [999])  # never drawn
        a.reconcile_device([drawn[1]], [drawn[2]])
        assert a.device_held() == 0


def test_audit_counts_device_held_pages():
    """An unreconciled draw is conserved (device-held), and a live holder
    of a still device-held page is reported, in the reference's words."""
    ja, ta = _alloc_pair()
    for a in (ja, ta):
        drawn = a.draw_device(4)
        assert a.audit([]) == []
        issues = a.audit([drawn[0]])
        assert any("still device-held" in m for m in issues), issues
    assert ja.audit([]) == ta.audit([])


# ---------------------------------------------------------------------------
# the device page append and the looped block's sampling noise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_append_pages_matches_jax(seed):
    """One append round on random tables, counts, needs and free-lists
    (short lists that starve some rows, full rows at capacity): the
    port's in-place append gives the JAX function's tables, counts, list
    use and starved rows."""
    from distributed_inference_server_tpu.engine.engine import (
        _device_append_pages as j_append,
    )
    from distributed_inference_server_tpu_torch.engine.engine import (
        _device_append_pages as t_append,
    )

    rng = np.random.default_rng(seed)
    B, P, N = 6, 5, 10
    tables = rng.integers(0, N, size=(B, P)).astype(np.int32)
    counts = rng.integers(0, P + 1, size=B).astype(np.int32)
    needed = np.where(rng.random(B) < 0.8,
                      counts + rng.integers(0, 3, size=B), 0).astype(np.int32)
    n_free = int(rng.integers(0, 5))
    free = np.full((N,), N, np.int32)
    free[:n_free] = rng.permutation(N)[:n_free]
    used = int(rng.integers(0, n_free + 1))
    jt, jc, ju, js = j_append(
        jnp.asarray(tables), jnp.asarray(counts), jnp.asarray(free),
        jnp.asarray(n_free, jnp.int32), jnp.asarray(used, jnp.int32),
        jnp.asarray(needed), jnp.arange(B), 1)
    tt, tc = torch.from_numpy(tables.copy()), torch.from_numpy(counts.copy())
    tu = torch.tensor([used], dtype=torch.int32)
    ts = t_append(tt, tc, torch.from_numpy(free),
                  torch.tensor(n_free, dtype=torch.int32), tu,
                  torch.from_numpy(needed), torch.arange(B))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tu[0]) == int(ju)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_counter_uniform_is_uniform_and_keyed():
    """``counter_uniform``: values in (0, 1) with the uniform's mean and
    variance, the same numbers for the same key, uncorrelated numbers for
    neighbouring keys (the looped block's key + step)."""
    from distributed_inference_server_tpu_torch.ops.sampling import (
        counter_uniform,
    )

    n = 200_000
    a = counter_uniform((n,), torch.tensor([12345], dtype=torch.int64))
    b = counter_uniform((n,), torch.tensor([12346], dtype=torch.int64))
    again = counter_uniform((n,), torch.tensor([12345], dtype=torch.int64))
    assert torch.equal(a, again) and not torch.equal(a, b)
    assert 0.0 < float(a.min()) and float(a.max()) < 1.0
    # 6 sigma of the mean and variance of n uniforms
    assert abs(float(a.mean()) - 0.5) < 6 * (1 / 12 / n) ** 0.5
    assert abs(float(a.var()) - 1 / 12) < 6 * (1 / 180 / n) ** 0.5
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    assert abs(corr) < 6 / n ** 0.5


def test_counter_noise_samples_the_distribution():
    """Gumbel-max under ``counter_uniform`` noise draws each token with its
    softmax probability (and only nucleus tokens under top-p): 20000 keys
    on one row of logits, frequencies within 6 sigma."""
    from distributed_inference_server_tpu_torch.ops.sampling import (
        counter_uniform,
        sample_tokens,
    )

    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
    temp, n = 0.8, 20_000
    probs = torch.softmax(logits[0] / temp, dim=-1)
    for top_p, want in ((1.0, probs), (0.7, None)):
        draws = torch.stack([
            sample_tokens(logits, torch.tensor([temp]),
                          torch.tensor([top_p]), uniform=counter_uniform(
                              logits.shape,
                              torch.tensor([k], dtype=torch.int64)))[0]
            for k in range(n)])
        freq = torch.bincount(draws.long(), minlength=6).double() / n
        if want is None:  # the nucleus {0, 1} renormalized
            keep = probs[:2] / probs[:2].sum()
            want = torch.cat([keep, torch.zeros(4)])
            assert set(draws.tolist()) == {0, 1}
        sigma = (want.double() * (1 - want.double()) / n).sqrt()
        assert bool((freq - want.double()).abs().le(6 * sigma + 1e-12).all())


def test_sampled_loop_stays_in_the_jax_nucleus(shared):
    """Sampled rows (temperature 0.7, top-p 0.6) through the port's looped
    blocks: every token of every row lies in the nucleus of the JAX
    package's logits for that row's prefix, and rows of the same prompt
    draw different streams."""
    engines = _engines(shared)
    port = engines["port-loop"]
    prompt = TOK.encode("The")
    for i in range(4):
        port.add_request(f"s{i}", prompt, SamplingParams(
            max_tokens=10, temperature=0.7, top_p=0.6))
    toks = {}
    while port.has_work():
        for o in port.step():
            assert o.error is None
            if o.token_id is not None:
                toks.setdefault(o.request_id, []).append(o.token_id)
    assert port.loop_stats()["steps"] >= 9
    j_params = shared[0]
    nucleus_sizes = []
    for rid, row in toks.items():
        ids = prompt + row
        n = len(ids) - 1
        cache = j_llama.KVCache.create(J_TINY, 1, n, dtype=jnp.float32)
        pos = jnp.arange(n)[None]
        logits, _ = j_llama.forward(j_params, J_TINY, jnp.asarray([ids[:n]]),
                                    pos, cache, pos, jnp.asarray([n]))
        logits = np.asarray(logits)[0]
        for j, t in enumerate(row):
            nucleus = _nucleus(logits[len(prompt) - 1 + j], 0.7, 0.6)
            nucleus_sizes.append(len(nucleus))
            assert t in nucleus, (rid, j, t, nucleus)
    assert max(nucleus_sizes) > 1  # the draws were not forced
    assert len({tuple(v) for v in toks.values()}) > 1


def _nucleus(logits, temperature, top_p):
    """The sorted-prefix nucleus of softmax(logits / temperature)."""
    p = np.exp((logits - logits.max()) / temperature)
    p /= p.sum()
    order = np.argsort(-p, kind="stable")
    cum = np.cumsum(p[order])
    k = int(np.searchsorted(cum, top_p)) + 1
    return set(order[:k].tolist())
