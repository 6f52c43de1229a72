"""The port's host-RAM prefix tier against the JAX package's.

- ``HostTier`` policy: each case of ``tests/test_host_tier.py`` drives the
  port's tier and the JAX tier with the same offer / get / drain / evict
  sequence; both keep the same pages (same bytes) and the same stats.
- the allocator's demotion hook (one batched call per eviction burst,
  before the ids are reused; a failing hook degrades to a drop;
  ``evict_below(demote=False)``; the LRU clock on a match).
- engines (TINY f32 weights drawn by the JAX package, every matrix scaled
  by 8, shared by conversion): a prefix demoted to the host tier (raw,
  int8 or latent) and reloaded gives the JAX engine's cold greedy tokens;
  the port's host tier after a trace holds what the JAX engine's holds;
  a reload re-seats into HBM; an exact re-match counts only kept pages;
  aborts around the reload leak nothing; the degradation rungs demote or
  drop; a peer exports a prefix from its host tier.
"""

import functools

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
from distributed_inference_server_tpu.models import tokenizer as jtok
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    _KIND_RAW,
    HostTier,
    PageAllocator,
    PagedCacheConfig,
    chain_hashes,
)
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)

PS = 4
TOK = ByteTokenizer()


# ---------------------------------------------------------------------------
# HostTier policy, in lockstep with the JAX tier
# ---------------------------------------------------------------------------


def _page(val: float, nbytes: int = 64) -> tuple:
    """One fake demoted page: (k, v) of ``2 * nbytes`` bytes, slot axis 1
    (one slot: the policy cases use page_size 1)."""
    a = np.full((nbytes // 4, 1), val, np.float32)
    return (a, a * 2)


class Pair:
    """A JAX tier and a port tier driven by the same calls; ``check``
    holds them to the same resident pages, bytes and stats."""

    def __init__(self, **kw):
        self.j = jkv.HostTier(**kw)
        self.t = HostTier(**kw)

    def offer(self, entries, kind, arrs, page_size=1, new_burst=True):
        self.j.offer(entries, kind, arrs, page_size=page_size,
                     new_burst=new_burst)
        self.t.offer(entries, kind, tuple(torch.from_numpy(a) for a in arrs),
                     page_size=page_size, new_burst=new_burst)

    def one(self, h, depth, root, arrs, new_burst=True):
        self.offer([(h, depth, root)], _KIND_RAW, arrs, new_burst=new_burst)

    def get(self, h):
        a, b = self.j.get(h), self.t.get(h)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.kind, a.depth, a.root, a.nbytes) == (
                b.kind, b.depth, b.root, b.nbytes)
            for x, y in zip(a.parts, b.parts):
                np.testing.assert_array_equal(x, y.numpy())
        return b

    def has(self, h):
        assert self.j.has(h) == self.t.has(h)
        return self.t.has(h)

    def call(self, name):
        a, b = getattr(self.j, name)(), getattr(self.t, name)()
        assert a == b
        return b

    def check(self):
        assert vars(self.j.stats()) == vars(self.t.stats())
        assert sorted(self.j._pages) == sorted(self.t._pages)
        assert sorted(self.j.digest_hashes()) == sorted(
            self.t.digest_hashes())
        return self.t.stats()


def test_offer_get_roundtrip():
    t = Pair(budget_bytes=1 << 20)
    t.one(11, 0, 11, _page(1.0))
    e = t.get(11)
    assert e is not None and e.kind == _KIND_RAW
    assert t.get(99) is None
    s = t.check()
    assert (s.hits, s.misses, s.offloads) == (1, 1, 1)
    assert s.pages == 1 and s.bytes_used == sum(
        p.numel() * p.element_size() for p in e.parts)


def test_group_offer_slices_pages_ignores_padding():
    t = Pair(budget_bytes=1 << 20, inflight_window=0)
    ps = 2
    k = np.concatenate([np.full((4, ps), float(d), np.float32)
                        for d in (1, 2, 3, 3)], axis=1)
    t.offer([(1, 0, 1), (2, 1, 1), (3, 2, 1)], _KIND_RAW, (k, k * 2),
            page_size=ps)
    assert t.check().pages == 3
    for h in (1, 2, 3):
        t.get(h)
    t.check()


def test_default_window_holds_a_full_gather_bucket():
    cap = LLMEngine._OFFLOAD_GROUP
    assert cap == JEngine._OFFLOAD_BUCKETS[-1]
    t = Pair(budget_bytes=1 << 24)
    k = np.ones((2, cap), np.float32)
    t.offer([(100 + i, i, 100) for i in range(cap)], _KIND_RAW, (k, k * 2))
    assert t.check().pages == 0  # the whole burst still in flight
    assert t.has(100) and t.has(100 + cap - 1)
    assert t.get(100) is not None
    t.check()


def test_inflight_window_defers_materialization():
    t = Pair(budget_bytes=1 << 20, inflight_window=2)
    t.one(1, 0, 1, _page(1.0))
    t.one(2, 1, 1, _page(2.0))
    assert t.check().pages == 0 and t.has(1) and t.has(2)
    t.one(3, 2, 1, _page(3.0))
    assert t.check().pages == 1
    assert t.get(99) is None and t.check().pages == 1
    assert t.get(2) is not None and t.check().pages == 2
    assert t.get(3) is not None and t.check().pages == 3


def test_multi_group_burst_never_drains_itself():
    t = Pair(budget_bytes=1 << 20, inflight_window=2)
    t.one(1, 0, 1, _page(1.0))
    t.one(2, 1, 1, _page(2.0), new_burst=False)
    t.one(3, 2, 1, _page(3.0), new_burst=False)
    assert t.check().pages == 0 and t.has(1) and t.has(3)
    t.one(4, 0, 4, _page(4.0))
    assert t.check().pages == 2
    assert t.get(1) is not None and t.get(2) is not None
    t.check()


def test_all_duplicate_burst_still_drains_overshoot():
    t = Pair(budget_bytes=1 << 20, inflight_window=2)
    t.one(1, 0, 1, _page(1.0))
    for h in (2, 3, 4):
        t.one(h, h - 1, 1, _page(float(h)), new_burst=False)
    assert t.check().pages == 0
    t.one(1, 0, 1, _page(9.0))
    assert t.check().pages == 2
    np.testing.assert_array_equal(t.get(1).parts[0].numpy(), _page(1.0)[0])


def test_drain_to_window_materializes_ladder_overshoot():
    t = Pair(budget_bytes=1 << 20, inflight_window=2)
    t.one(1, 0, 1, _page(1.0))
    for h in (2, 3, 4, 5):
        t.one(h, h - 1, 1, _page(float(h)), new_burst=False)
    assert t.check().pages == 0
    t.call("drain_to_window")
    assert t.check().pages == 3
    t.call("flush")
    assert t.check().pages == 5


def test_duplicate_offer_keeps_first_copy():
    t = Pair(budget_bytes=1 << 20)
    t.one(7, 0, 7, _page(1.0))
    t.one(7, 0, 7, _page(9.0))
    np.testing.assert_array_equal(t.get(7).parts[0].numpy(), _page(1.0)[0])
    t.check()


def test_budget_eviction_is_front_biased():
    nb = 128
    t = Pair(budget_bytes=3 * 2 * nb, inflight_window=0)
    for d in range(5):
        t.one(100 + d, d, 100, _page(float(d), nb))
    assert t.check().pages == 3
    for d in range(3):
        assert t.get(100 + d) is not None
    for d in (3, 4):
        assert not t.has(100 + d)
    t.check()


def test_matched_chain_protected_from_churn():
    nb = 128
    t = Pair(budget_bytes=4 * 2 * nb, inflight_window=0)
    t.one(1, 0, 1, _page(1.0, nb))
    t.one(2, 1, 1, _page(2.0, nb))
    assert t.get(1) is not None
    for d in range(6):
        t.one(50 + d, 0, 50 + d, _page(float(d), nb))
    assert t.has(1) and t.has(2)
    assert t.check().pages == 4


def test_repeated_hits_keep_heaps_bounded():
    t = Pair(budget_bytes=1 << 20, inflight_window=0)
    for d in range(4):
        t.one(100 + d, d, 100, _page(float(d)))
    for _ in range(300):
        assert t.t.get(100) is not None and t.j.get(100) is not None
    t.check()
    assert (len(t.t._prob_heap) + len(t.t._prot_heap)
            <= 4 * t.t.stats().pages + 64)


def test_single_page_over_budget_dropped_and_clear():
    t = Pair(budget_bytes=16, inflight_window=0)
    t.one(1, 0, 1, _page(1.0, 64))
    assert t.check().pages == 0 and t.t.stats().evictions == 1
    t = Pair(budget_bytes=1 << 20, inflight_window=2)
    for h in (1, 2, 3):
        t.one(h, 0, h, _page(float(h)))
    assert t.call("clear") == 3
    s = t.check()
    assert s.pages == 0 and s.bytes_used == 0 and not t.has(1)


def test_rejects_unknown_quant_and_bad_budget():
    with pytest.raises(ValueError):
        HostTier(budget_bytes=1 << 20, quant="fp4")
    with pytest.raises(ValueError):
        HostTier(budget_bytes=0)


def test_random_trace_matches_jax():
    """A random mix of bursts, continuations, hits, misses, drains and
    clears: the two tiers never diverge."""
    rng = np.random.default_rng(5)
    t = Pair(budget_bytes=40 * 128, inflight_window=3)
    for step in range(400):
        op = rng.random()
        if op < 0.55:
            n = int(rng.integers(1, 5))
            root = int(rng.integers(0, 6)) * 100
            depth0 = int(rng.integers(0, 4))
            entries = [(root + depth0 + i, depth0 + i, root)
                       for i in range(n)]
            k = rng.standard_normal((8, n)).astype(np.float32)
            t.offer(entries, _KIND_RAW, (k, k + 1), page_size=1,
                    new_burst=bool(rng.random() < 0.7))
        elif op < 0.9:
            t.get(int(rng.integers(0, 6)) * 100 + int(rng.integers(0, 8)))
        elif op < 0.97:
            t.call("drain_to_window")
        else:
            t.call("clear")
        t.check()


# ---------------------------------------------------------------------------
# the allocator's demotion hook
# ---------------------------------------------------------------------------

PCFG = PagedCacheConfig(num_pages=8, page_size=4, max_pages_per_seq=4)


def _cache_one(a, tokens):
    p = a.allocate(-(-len(tokens) // 4))
    a.publish(tokens, p)
    a.release(p)
    return p


def test_offload_hook_fires_batched_before_reuse():
    a = PageAllocator(PCFG)
    calls = []
    a.offload_hook = lambda victims: calls.append(list(victims))
    pages = _cache_one(a, list(range(8)))
    a.allocate(6)
    got = a.allocate(2)
    assert sorted(got) == sorted(pages)
    hashes = chain_hashes(list(range(8)), 4)
    assert len(calls) == 1
    assert [(v.hash, v.depth) for v in calls[0]] == [(hashes[0], 0),
                                                     (hashes[1], 1)]
    assert [v.page_id for v in calls[0]] == pages
    assert all(v.root == hashes[0] for v in calls[0])
    # the JAX allocator hands over the same victims
    ja = jkv.PageAllocator(jkv.PagedCacheConfig(8, 4, 4))
    jcalls = []
    ja.offload_hook = lambda victims: jcalls.append(list(victims))
    _cache_one(ja, list(range(8)))
    ja.allocate(6)
    ja.allocate(2)
    assert [tuple(v) for v in jcalls[0]] == [tuple(v) for v in calls[0]]


def test_offload_hook_failure_degrades_to_drop():
    a = PageAllocator(PCFG)

    def boom(*args):
        raise RuntimeError("host OOM")

    a.offload_hook = boom
    _cache_one(a, [1] * 4)
    a.allocate(7)
    a.allocate(1)
    assert a.stats().evictions == 1


def test_evict_below_demote_flag():
    a = PageAllocator(PCFG)
    calls = []
    a.offload_hook = lambda *c: calls.append(c)
    _cache_one(a, [1] * 4)
    _cache_one(a, [2] * 4)
    a.evict_below(0.0, demote=False)
    assert calls == []
    _cache_one(a, [3] * 4)
    a.evict_below(0.0)
    assert len(calls) == 1


def test_matched_then_released_chain_outlives_older_one():
    a = PageAllocator(PCFG)
    p_old = _cache_one(a, [1] * 4)
    p_new = _cache_one(a, [2] * 4)
    shared, _ = a.match_prefix([2] * 4)
    assert shared == p_new
    a.release(shared)
    a.allocate(6)
    assert a.allocate(1) == p_old
    assert a.match_prefix([1] * 4) == ([], 0)
    assert a.match_prefix([2] * 4)[1] == 4


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tree(scale: float = 8.0):
    """TINY f32 weights of the JAX package's seed 0, every matrix times
    ``scale`` (8: varied greedy continuations; 1: the JAX package's own
    fixture, whose K/V a rank-4 latent keeps token-exact)."""
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * scale
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * scale
    return tree


def _jcfg(num_pages, **kw):
    return JEngineConfig(
        max_batch=2, prefill_buckets=(8, 32), attention_impl="xla",
        paged=jkv.PagedCacheConfig(num_pages=num_pages, page_size=PS,
                                   max_pages_per_seq=8),
        native_allocator=False, **kw)


@pytest.fixture(scope="module")
def jax_ref():
    """A cold JAX engine with room for every prompt: the reference."""
    return JEngine(jax.tree_util.tree_map(jnp.asarray, _tree()), J_TINY,
                   jtok.ByteTokenizer(), _jcfg(64), dtype=jnp.float32)


def make_engine(host_tier_bytes=0, host_tier_quant="none", num_pages=10,
                scale=8.0, **kw):
    return LLMEngine(
        params_from_numpy(_tree(scale), device="cpu", dtype=torch.float32),
        TINY,
        TOK, EngineConfig(
            max_batch=2, prefill_buckets=(8, 32),
            paged=PagedCacheConfig(num_pages=num_pages, page_size=PS,
                                   max_pages_per_seq=8),
            host_tier_bytes=host_tier_bytes,
            host_tier_quant=host_tier_quant, **kw),
        dtype=torch.float32, device="cpu")


def run_one(engine, rid, prompt, max_tokens=6):
    sp = (JSamplingParams if isinstance(engine, JEngine) else SamplingParams)
    engine.add_request(rid, prompt, sp(max_tokens=max_tokens,
                                       temperature=0.0))
    tokens = []
    for _ in range(500):
        if not engine.has_work():
            break
        for out in engine.step():
            assert out.error is None, out.error
            if out.token_id is not None:
                tokens.append(out.token_id)
    assert not engine.has_work()
    return tokens


PREFIX = list(range(40, 60))  # 5 full pages
PROMPT = PREFIX + [7, 8]
_RNG = np.random.default_rng(3)
CHURN = [_RNG.integers(100, 200, size=7).tolist() for _ in range(8)]


@pytest.fixture(scope="module")
def want(jax_ref):
    cache = {}

    def get(prompt, max_tokens=6):
        key = (tuple(prompt), max_tokens)
        if key not in cache:
            cache[key] = run_one(jax_ref, f"ref{len(cache)}", list(prompt),
                                 max_tokens)
        return cache[key]

    return get


def churn(engine, n=6):
    """Unique 2-page prompts that cycle the 10-page pool past PREFIX."""
    for i in range(n):
        run_one(engine, f"churn{i}", CHURN[i], max_tokens=2)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_offload_reload_token_identity(want, quant):
    eng = make_engine(host_tier_bytes=1 << 22, host_tier_quant=quant)
    assert eng.allocator_tier() == "python"  # the hook needs it
    run_one(eng, "warm", PROMPT)
    churn(eng)
    host0 = eng.host_tier_stats()
    assert host0["pages"] + len(eng.host_tier._inflight) > 0
    got = run_one(eng, "probe", PROMPT)
    assert eng.host_tier_stats()["hit_pages"] > 0
    assert eng.drain_reload_durations()
    assert got == want(PROMPT)
    assert eng.audit_pages() == []
    assert eng.payload_byte_counters()["int8" if quant == "int8"
                                       else "raw"] > 0


def test_host_tier_matches_jax_engine():
    """The same trace through a JAX engine and the port's, both with an
    int8 host tier: the same pages demoted (same hashes, same bytes) and
    the same reload counts."""
    kw = dict(host_tier_bytes=1 << 22, host_tier_quant="int8")
    je = JEngine(jax.tree_util.tree_map(jnp.asarray, _tree()), J_TINY,
                 jtok.ByteTokenizer(), _jcfg(10, **kw), dtype=jnp.float32)
    te = make_engine(**kw)
    for eng in (je, te):
        run_one(eng, "warm", PROMPT)
        churn(eng)
    assert je.host_tier_stats() == te.host_tier_stats()
    je.host_tier.flush()
    te.host_tier.flush()
    assert sorted(je.host_tier._pages) == sorted(te.host_tier._pages)
    for h, jp in je.host_tier._pages.items():
        tp = te.host_tier._pages[h]
        assert (jp.kind, jp.depth, jp.root) == (tp.kind, tp.depth, tp.root)
        # the two forwards' K/V differ in the last f32 bits, so a value
        # on a rounding edge may take the next code
        for a, b in zip(jp.parts, tp.parts):
            a, b = np.asarray(a).astype(np.float32), b.float().numpy()
            tol = 1.0 if jp.parts[0].dtype == np.int8 and a.ndim == 4 else 0
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=tol)
    assert run_one(je, "probe", PROMPT) == run_one(te, "probe", PROMPT)
    assert je.host_tier_stats() == te.host_tier_stats()
    assert vars(je.cache_stats()) == vars(te.cache_stats())


def test_latent_host_tier_reload_token_identity():
    """A rank-4 latent tier (lossy) on the JAX package's own fixture: the
    reload gives the JAX engine's cold tokens there, as in
    ``tests/test_latent_kv.py``."""
    ref = JEngine(jax.tree_util.tree_map(jnp.asarray, _tree(1.0)), J_TINY,
                  jtok.ByteTokenizer(), _jcfg(64), dtype=jnp.float32)
    want = run_one(ref, "cold", PROMPT)
    eng = make_engine(host_tier_bytes=1 << 22, host_tier_quant="latent",
                      latent_rank=4, scale=1.0)
    assert eng.latent_codec is not None
    run_one(eng, "warm", PROMPT)
    churn(eng, 8)
    eng.host_tier.flush()
    assert eng.host_tier_stats()["pages"] > 0
    assert run_one(eng, "probe", PROMPT) == want
    assert eng.host_tier_stats()["hit_pages"] > 0
    assert eng.audit_pages() == []
    assert eng.payload_byte_counters()["latent"] > 0
    assert eng.latent_stats()["saved_bytes"] > 0


def test_reload_reseats_into_hbm():
    eng = make_engine(host_tier_bytes=1 << 22)
    run_one(eng, "warm", PROMPT)
    churn(eng)
    run_one(eng, "p1", PROMPT)
    hit_pages = eng.host_tier_stats()["hit_pages"]
    assert hit_pages > 0
    s0 = eng.cache_stats()
    run_one(eng, "p2", PREFIX + [9, 10])
    assert eng.cache_stats().hits > s0.hits
    assert eng.host_tier_stats()["hit_pages"] == hit_pages


def test_exact_rematch_counts_only_kept_pages():
    eng = make_engine()
    run_one(eng, "a", PREFIX, max_tokens=2)
    s0 = eng.cache_stats()
    run_one(eng, "b", PREFIX, max_tokens=2)
    assert eng.cache_stats().hits - s0.hits == len(PREFIX) // PS - 1


def test_abort_races_reload(want):
    eng = make_engine(host_tier_bytes=1 << 22)
    run_one(eng, "warm", PROMPT)
    churn(eng)
    eng.add_request("a0", PROMPT, SamplingParams(max_tokens=4,
                                                 temperature=0.0))
    assert eng.abort("a0")
    assert not eng.has_work()
    eng.add_request("a1", PROMPT, SamplingParams(max_tokens=4,
                                                 temperature=0.0))
    eng.step()
    assert eng.abort("a1")
    assert not eng.has_work()
    s = eng.cache_stats()
    assert s.pages_free + s.pages_cached == s.pages_total
    assert eng.audit_pages() == []
    assert run_one(eng, "after", PROMPT) == want(PROMPT)


def test_degradation_rungs_demote_vs_drop():
    eng = make_engine(host_tier_bytes=1 << 22)
    run_one(eng, "warm", PROMPT)
    assert eng.cache_stats().pages_cached > 0
    eng.evict_cache(0.0)
    eng.host_tier.flush()
    assert eng.cache_stats().pages_cached == 0
    assert eng.host_tier_stats()["pages"] > 0
    eng.evict_cache(0.0, drop_host_tier=True)
    assert eng.host_tier_stats()["pages"] == 0
    assert eng.prefix_digest() == frozenset()


def test_peer_fetch_from_host_tier(want):
    warm = make_engine(host_tier_bytes=1 << 22, host_tier_quant="int8",
                       native_allocator=False)
    run_one(warm, "warm", PROMPT)
    churn(warm, 8)
    warm.host_tier.flush()
    hashes = chain_hashes(PROMPT, PS, max_pages=(len(PROMPT) - 1) // PS)
    depth, chunks = warm.export_prefix_chunks(hashes, chunk_pages=2)
    assert depth > 0
    target = make_engine(num_pages=32, native_allocator=False)
    target.import_prefix(PROMPT[: depth * PS], chunks)
    assert run_one(target, "probe", PROMPT) == want(PROMPT)
    assert target.audit_pages() == []


def test_speculative_engine_gets_no_host_tier():
    eng = LLMEngine(
        params_from_numpy(_tree(), device="cpu", dtype=torch.float32), TINY,
        TOK, EngineConfig(max_batch=2, prefill_buckets=(8, 32),
                          paged=PagedCacheConfig(10, PS, 8),
                          host_tier_bytes=1 << 20, latent_rank=4),
        dtype=torch.float32, device="cpu",
        draft_params=params_from_numpy(_tree(), device="cpu",
                                       dtype=torch.float32),
        draft_cfg=TINY)
    assert eng.host_tier is None and eng.latent_codec is None
    assert eng.host_tier_stats() is None and eng.latent_stats() is None
