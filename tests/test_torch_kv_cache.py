"""The port's page allocator against the JAX package's Python allocator.

One request trace — admissions with prefix matches, allocations, publishes,
releases, LRU evictions under pressure, retains, and a CacheFull — is
replayed against both allocators; every step must hand out the same block
tables, the chain hashes must be identical, the eviction order the same,
and ``audit()`` must agree (the JAX allocator is the Python tier, as an
engine with ``native_allocator=False`` uses).
"""

import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.core.errors import CacheFull as JCacheFull
from distributed_inference_server_tpu.engine import kv_cache as jkv
from distributed_inference_server_tpu_torch.core.errors import CacheFull
from distributed_inference_server_tpu_torch.engine import kv_cache as tkv

PS = 4


def _pair(num_pages=10):
    return (jkv.PageAllocator(jkv.PagedCacheConfig(num_pages, PS, 8)),
            tkv.PageAllocator(tkv.PagedCacheConfig(num_pages, PS, 8)))


def _stats(alloc):
    s = alloc.stats()
    return (s.hits, s.misses, s.evictions, s.pages_free, s.pages_cached)


def test_chain_hashes_match_jax():
    rng = np.random.default_rng(0)
    for n in (0, 3, 4, 9, 33):
        toks = rng.integers(0, 128256, size=n).tolist()
        assert tkv.chain_hashes(toks, PS) == jkv.chain_hashes(toks, PS)
        assert tkv.chain_hashes(toks, PS, 2) == jkv.chain_hashes(toks, PS, 2)
        assert list(tkv.iter_chain_hashes(toks, 16)) == list(
            jkv.iter_chain_hashes(toks, 16))


def test_request_trace_matches_jax():
    ja, ta = _pair()
    rng = np.random.default_rng(1)
    prompts = {
        "a": rng.integers(0, 50, 13).tolist(),
        "b": rng.integers(0, 50, 9).tolist(),
    }
    prompts["c"] = prompts["a"][:8] + [7, 7, 7]  # shares two pages with a
    prompts["d"] = rng.integers(0, 50, 17).tolist()
    live = {"jax": {}, "torch": {}}

    def both(fn):
        """Run ``fn(alloc)`` on both; return the results (or the
        CacheFull they both raise)."""
        out = []
        for alloc, exc in ((ja, JCacheFull), (ta, CacheFull)):
            try:
                out.append(fn(alloc))
            except exc:
                out.append("CacheFull")
        return out

    def admit(rid):
        toks = prompts[rid]
        res = both(lambda a: a.match_prefix(toks[:-1]))
        assert res[0] == res[1], rid
        for key, alloc, (shared, _) in (("jax", ja, res[0]),
                                        ("torch", ta, res[1])):
            need = -(-len(toks) // PS) - len(shared)
            live[key][rid] = list(shared) + alloc.allocate(need)
        assert live["jax"][rid] == live["torch"][rid], rid

    def finish(rid):
        toks = prompts[rid]
        for key, alloc in (("jax", ja), ("torch", ta)):
            table = live[key].pop(rid)
            alloc.publish(toks, table)
            alloc.release(table)

    def audit():
        for key, alloc in (("jax", ja), ("torch", ta)):
            pages = [p for t in live[key].values() for p in t]
            yield alloc.audit(pages)

    admit("a")
    admit("b")
    finish("a")  # a's pages: 3 full pages published, cached
    admit("c")  # prefix hit on a's first two pages
    assert _stats(ja) == _stats(ta)
    finish("b")
    admit("d")  # 5 pages: forces LRU eviction of cached pages
    assert _stats(ja) == _stats(ta)
    assert ja.stats().evictions > 0
    res = both(lambda a: a.allocate(8))  # more than the pool holds
    assert res == ["CacheFull", "CacheFull"]
    # retain / release round trip on a published page
    finish("c")
    held = [next(iter(ja._lru))]  # a cached (published, refcount-0) page
    assert held == [next(iter(ta._lru))]
    both(lambda a: a.retain(held))
    both(lambda a: a.release(held))
    j_issues, t_issues = audit()
    assert j_issues == t_issues == []
    assert _stats(ja) == _stats(ta)
    # draining the pool evicts the cached pages in the same LRU order
    finish("d")
    j_all, t_all = both(lambda a: a.allocate(a.num_free()))
    assert j_all == t_all
    assert _stats(ja) == _stats(ta)


def test_eviction_order_matches_jax():
    ja, ta = _pair(6)
    seqs = [[i * 10 + j for j in range(PS)] for i in range(5)]
    for alloc in (ja, ta):
        for s in seqs:
            (pid,) = alloc.allocate(1)
            alloc.publish(s, [pid])
            alloc.release([pid])  # cached, LRU order = publish order
        # touch the oldest so it becomes the youngest
        shared, _ = alloc.match_prefix(seqs[0])
        alloc.release(shared)
    assert ja.allocate(6) == ta.allocate(6)
    assert ja.stats().evictions == ta.stats().evictions == 5


def test_audit_reports_the_same_leak():
    ja, ta = _pair(4)
    for alloc in (ja, ta):
        alloc.allocate(2)
    assert ja.audit([]) and ja.audit([]) == ta.audit([])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_state_has_drop_slot(dtype):
    from distributed_inference_server_tpu_torch.models.configs import TINY

    st = tkv.PagedKVState.create(TINY, tkv.PagedCacheConfig(8, 4, 4),
                                 dtype=dtype, device="cpu")
    assert st.k.shape == (TINY.num_layers, 8 * 4 + 1, TINY.num_kv_heads,
                          TINY.head_dim)
    assert st.k.dtype == dtype


def test_flat_slots_match_jax():
    import jax.numpy as jnp

    tables = np.array([[3, 1, 2], [0, 4, 5]], np.int32)
    pos = np.array([[0, 5, 11], [3, 4, 8]], np.int32)
    want = np.asarray(jkv.flat_slots(jnp.asarray(tables), jnp.asarray(pos),
                                     4))
    got = tkv.flat_slots(torch.from_numpy(tables), torch.from_numpy(pos),
                         4).numpy()
    np.testing.assert_array_equal(got, want)
