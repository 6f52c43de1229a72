"""Cache-aware routing and the peer prefix fetch in the port, against the
JAX package.

- ``TestRoutingMatrix`` of ``tests/test_prefix_fetch.py`` on the port's
  ``plan_route``, each plan equal to the JAX package's;
- ``test_digest_depth_configurable`` with ``EngineConfig.digest_depth``;
- a two-replica ``cache_aware`` server (TINY f32, the JAX package's
  weights, the Python page allocator, which publishes the digest): a
  prompt warm on one replica and sent again with ``sched.fetch_decision``
  armed is fetched onto the cold replica over the protowire channel and
  answers with the JAX engine's tokens, text and usage; a peer death
  mid-fetch (``kv.peer_fetch``) falls back to recompute with the same
  text; ``audit_pages() == []`` on both; the ``TestServingFetch`` runner
  and fetcher cases;
- the JAX cases left for the fault registry: a ``kv.latent_decode``
  failure degrades an import exactly once (``tests/test_latent_kv.py``)
  and a ``kv.host_copy`` failure drops a demotion burst at the hook
  boundary (``tests/test_host_tier.py``).
"""

import dataclasses
import time

import pytest

from distributed_inference_server_tpu.serving import scheduler as jsched
from distributed_inference_server_tpu_torch.core.errors import (
    CacheDeserializationError,
)
from distributed_inference_server_tpu_torch.engine.engine import (
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    DIGEST_DEPTH,
    PageAllocator,
    PagedCacheConfig,
    chain_hashes,
)
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving.batcher import (
    BatcherConfig,
)
from distributed_inference_server_tpu_torch.serving.disagg import (
    DisaggSettings,
    PrefixFetcher,
)
from distributed_inference_server_tpu_torch.serving.faults import parse_spec
from distributed_inference_server_tpu_torch.serving.metrics import (
    EngineStatus,
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    EngineRunner,
)
from distributed_inference_server_tpu_torch.serving.scheduler import (
    FetchCosts,
    PrefixRoutePlan,
    SchedulingStrategy,
    plan_route,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)
from test_torch_handoff import PS, cold_run, drain, j_engine, p_engine
from test_torch_host_tier import _page
from test_torch_replicas import TOK, jax_ref, p_factory, run

RPROMPT = list(range(33))  # 8 full pages + 1
RHASHES = chain_hashes(RPROMPT, PS, max_pages=8)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()


def _status(eid, healthy=True, active=0, waiting=0, digest=None,
            role="unified"):
    return EngineStatus(
        engine_id=eid, healthy=healthy, active_requests=active,
        waiting_requests=waiting, total_processed=0, memory_used_pages=0,
        memory_total_pages=100, prefix_digest=digest, page_size=PS,
        role=role, digest_depth=8)


def _plan(statuses, hashes, **kw):
    """The port's plan, held to the JAX package's on the same inputs."""
    got = plan_route(statuses, hashes, page_size=PS, **kw)
    jkw = dict(kw)
    if "costs" in jkw:
        jkw["costs"] = jsched.FetchCosts(**dataclasses.asdict(kw["costs"]))
    from distributed_inference_server_tpu.serving.metrics import (
        EngineStatus as JStatus,
    )

    want = jsched.plan_route(
        [JStatus(**{k: v for k, v in dataclasses.asdict(s).items()})
         for s in statuses], hashes, page_size=PS, **jkw)
    assert (dataclasses.asdict(got) if got else None) == (
        dataclasses.asdict(want) if want else None)
    return got


class TestRoutingMatrix:
    def test_idle_warm_replica_routes_warm(self):
        plan = _plan([_status("warm", digest=frozenset(RHASHES)),
                      _status("cold")], RHASHES)
        assert (plan.engine_id, plan.decision) == ("warm", "warm")

    def test_saturated_warm_replica_fetches_to_cold(self):
        plan = _plan([_status("warm", active=6, waiting=4,
                              digest=frozenset(RHASHES)),
                      _status("cold")], RHASHES)
        assert plan.decision == "fetch"
        assert plan.engine_id == "cold" and plan.peer_id == "warm"
        assert plan.peer_depth == len(RHASHES) and plan.depth == 0
        assert plan.prefix_hashes == tuple(RHASHES)

    def test_fetch_threshold_is_the_load_differential(self):
        costs = FetchCosts(min_pages=2, page_cost=0.25, load_cost_pages=4.0)
        assert _plan([_status("warm", active=1, digest=frozenset(RHASHES)),
                      _status("cold")], RHASHES,
                     costs=costs).decision == "fetch"
        assert _plan([_status("warm", digest=frozenset(RHASHES)),
                      _status("cold")], RHASHES,
                     costs=costs).decision == "warm"

    def test_no_match_recomputes_least_loaded(self):
        plan = _plan([_status("busy", active=3), _status("idle")], RHASHES)
        assert (plan.engine_id, plan.decision) == ("idle", "recompute")

    def test_gain_below_min_pages_never_fetches(self):
        plan = _plan([_status("warm", active=9,
                              digest=frozenset(RHASHES[:1])),
                      _status("cold")], RHASHES, costs=FetchCosts(min_pages=2))
        assert plan.decision in ("warm", "recompute")
        assert plan.peer_id is None

    def test_peer_fetch_disabled_routes_warm(self):
        plan = _plan([_status("warm", active=9, waiting=9,
                              digest=frozenset(RHASHES)),
                      _status("cold")], RHASHES,
                     costs=FetchCosts(enabled=False))
        assert plan.decision != "fetch"

    def test_partial_local_match_still_fetches_whole_chain(self):
        plan = _plan([_status("warm", active=6, digest=frozenset(RHASHES)),
                      _status("cold", digest=frozenset(RHASHES[:3]))],
                     RHASHES)
        assert plan.decision == "fetch"
        assert plan.depth == 3 and plan.peer_depth == len(RHASHES)

    def test_decode_peer_can_source_but_not_take_the_request(self):
        plan = _plan([_status("dec", role="decode",
                              digest=frozenset(RHASHES)),
                      _status("pre", role="prefill")], RHASHES,
                     roles=("prefill", "unified"))
        assert plan.engine_id == "pre"
        assert plan.decision == "fetch" and plan.peer_id == "dec"

    def test_unhealthy_peer_is_invisible(self):
        plan = _plan([_status("dead", healthy=False,
                              digest=frozenset(RHASHES)),
                      _status("cold")], RHASHES)
        assert (plan.decision, plan.peer_id) == ("recompute", None)
        assert _plan([_status("dead", healthy=False)], RHASHES) is None

    def test_forced_fetch_flag(self):
        from distributed_inference_server_tpu.serving import (
            faults as jfaults,
        )

        statuses = [_status("warm", digest=frozenset(RHASHES)),
                    _status("cold")]
        faults.install(parse_spec("sched.fetch_decision:nth=1", 1))
        jfaults.install(jfaults.parse_spec("sched.fetch_decision:nth=1", 1))
        try:
            plan = _plan(statuses, RHASHES)
        finally:
            faults.clear()
            jfaults.clear()
        assert plan.decision == "fetch" and plan.engine_id == "cold"
        assert _plan(statuses, RHASHES).decision == "warm"

    def test_deterministic_given_inputs(self):
        statuses = [_status("a", active=2, digest=frozenset(RHASHES[:4])),
                    _status("b", active=1, digest=frozenset(RHASHES)),
                    _status("c")]
        plans = {(p.engine_id, p.decision, p.peer_id)
                 for p in (_plan(statuses, RHASHES) for _ in range(5))}
        assert len(plans) == 1


def test_digest_depth_configurable():
    """digest_depth widens the published digest: a 12-page chain is fully
    visible at 16 and flattens to 8 hashes at the default."""
    prompt = list(range(1, 49)) + [7, 8]  # 12 full pages
    shallow = p_engine(native_allocator=False)
    deep = p_engine(native_allocator=False, digest_depth=16)
    for eng in (shallow, deep):
        cold_run(eng, "r", prompt, 4)
    hashes = chain_hashes(prompt, PS, max_pages=12)
    assert sum(h in shallow.prefix_digest() for h in hashes) == 8
    assert sum(h in deep.prefix_digest() for h in hashes) == 12
    assert sum(h in deep.prefix_digest(4) for h in hashes) == 4


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

# a prompt of 11 full pages; each case puts its own head on it, so no case
# shares a page with another
WARM = "a shared system prompt, forty bytes long"


@pytest.fixture(scope="module")
def fleet():
    srv = InferenceServer(
        p_factory(native_allocator=False), TOK, "tiny", num_engines=2,
        strategy=SchedulingStrategy.CACHE_AWARE, auto_restart=False,
        disagg_settings=DisaggSettings(channel="protowire"),
        batcher_config=BatcherConfig(window_ms=0))
    srv.start()
    yield srv
    faults.clear()
    srv.shutdown(drain_timeout_s=5.0)


def _cache_block(srv):
    return srv.metrics.snapshot(tuple(srv.scheduler.statuses())).to_dict()[
        "cache"]


def _warm_then_probe(srv, prompt, spec, seed):
    """Warm ``prompt`` on one replica, arm ``spec``, send it again: returns
    (the warm result, the probe's, the replica that warmed)."""
    warm = run(srv, f"warm-{seed}", prompt, 10)
    time.sleep(0.3)  # past the digest's rate limit
    digests = {s.engine_id: len(s.prefix_digest or ())
               for s in srv.scheduler.statuses()}
    warm_id = max(digests, key=digests.get)
    faults.install(parse_spec(spec, seed))
    try:
        probe = run(srv, f"probe-{seed}", prompt, 10)
    finally:
        faults.clear()
    return warm, probe, warm_id


def test_forced_fetch_lands_on_the_cold_replica(fleet):
    prompt = "fetch: " + WARM
    before = {r.engine_id: r.requests_finished
              for r in fleet.scheduler.engines()}
    warm, probe, warm_id = _warm_then_probe(
        fleet, prompt, "sched.fetch_decision:nth=1", 1)
    assert warm == probe == jax_ref(prompt, 10)
    cache = _cache_block(fleet)
    assert cache["peer_fetch"].get("ok") == 1 and cache["peer_fetch"][
        "bytes"] > 0
    assert cache["route_decisions"].get("fetch") == 1
    text = fleet.metrics_text().decode()
    assert 'kv_prefix_fetch_total{outcome="ok",scope="local"} 1.0' in text
    cold = [r for r in fleet.scheduler.engines() if r.engine_id != warm_id]
    assert cold[0].requests_finished == before[cold[0].engine_id] + 1
    # the fetched chain (the digest's depth) served the probe's prefix on
    # the cold replica
    hits = cold[0].call(lambda e: e.cache_stats().hits)
    assert hits == min(DIGEST_DEPTH, (len(TOK.encode(prompt)) - 1) // PS)
    for r in fleet.scheduler.engines():
        assert r.audit() == []


def test_peer_death_mid_fetch_falls_back_to_recompute(fleet):
    prompt = "death: " + WARM
    fb0 = _cache_block(fleet)["peer_fetch"].get("fallback", 0)
    warm, probe, _ = _warm_then_probe(
        fleet, prompt, "sched.fetch_decision:nth=1;kv.peer_fetch:nth=1", 2)
    assert warm == probe == jax_ref(prompt, 10)
    assert _cache_block(fleet)["peer_fetch"].get("fallback", 0) == fb0 + 1
    for r in fleet.scheduler.engines():
        assert r.audit() == []


def test_export_on_dead_runner_resolves_callback():
    runner = EngineRunner("e0", lambda: p_engine(), MetricsCollector())
    got = []
    runner.submit_prefix_export("r", RHASHES, 8, "none",
                                lambda res, err: got.append((res, err)))
    assert got and got[0][0] is None and got[0][1]


def test_abort_mid_fetch_drops_the_request():
    class _Runner:
        engine_id = "x"

        def __init__(self):
            self.submitted = []
            self.export_cb = None

        def submit_prefix_export(self, rid, hashes, cp, wq, cb):
            self.export_cb = cb  # held: the fetch stays in flight

        def submit(self, reqs):
            self.submitted.extend(reqs)

    class _Req:
        request_id = "r1"
        prompt_ids = RPROMPT

    fetcher = PrefixFetcher()
    target, peer = _Runner(), _Runner()
    plan = PrefixRoutePlan("t", "fetch", peer_id="p", depth=0, peer_depth=5,
                           page_size=PS, prefix_hashes=tuple(RHASHES))
    fetcher.fetch_then_submit(target, peer, _Req(), plan)
    assert fetcher.pending_count() == 1
    assert fetcher.abort("r1") is True
    peer.export_cb(None, "peer gone")
    assert fetcher.pending_count() == 0
    assert target.submitted == []
    assert fetcher.abort("r1") is False


# ---------------------------------------------------------------------------
# the fault points of the byte paths
# ---------------------------------------------------------------------------


def test_decode_fault_degrades_exactly_once():
    """An armed ``kv.latent_decode:nth=1`` aborts the import like any
    chunk-validation failure (every reserved page released, audit clean),
    and the next import succeeds with the JAX engine's tokens."""
    prompt = list(range(1, 30))
    hashes = chain_hashes(prompt, PS, max_pages=8)
    want = cold_run(j_engine(scale=1.0, latent_rank=4), "cold", prompt, 8)
    warm = p_engine(scale=1.0, latent_rank=4, native_allocator=False)
    cold_run(warm, "warm", prompt, 8)
    depth, chunks = warm.export_prefix_chunks(hashes, chunk_pages=2,
                                              wire_quant="latent")
    assert depth == len(hashes)
    target = p_engine(scale=1.0, latent_rank=4, native_allocator=False)
    free0 = target.allocator.num_free()
    faults.install(parse_spec("kv.latent_decode:nth=1", seed=7))
    with pytest.raises(CacheDeserializationError):
        target.import_prefix(prompt[: depth * PS], chunks)
    assert target.allocator.num_free() == free0
    assert target.audit_pages() == []
    assert target.import_prefix(prompt[: depth * PS], chunks) == depth
    target.add_request("probe", prompt,
                       SamplingParams(max_tokens=8, temperature=0.0))
    assert drain(target, []) == want
    assert target.audit_pages() == []


def test_injected_host_copy_drops_burst_at_hook_boundary():
    """An armed ``kv.host_copy`` makes the demotion offer raise before it
    changes anything: the allocator's hook boundary absorbs it, the burst
    is dropped, and the next burst demotes once the fault is spent."""
    from distributed_inference_server_tpu_torch.engine.kv_cache import (
        _KIND_RAW,
        HostTier,
    )

    t = HostTier(budget_bytes=1 << 20)
    a = PageAllocator(PagedCacheConfig(num_pages=1, page_size=1,
                                       max_pages_per_seq=1))
    a.offload_hook = lambda victims: t.offer(
        [(v.hash, v.depth, v.root) for v in victims], _KIND_RAW, _page(1.0),
        page_size=1)
    p = a.allocate(1)
    a.publish([5], p)
    a.release(p)
    faults.install(parse_spec("kv.host_copy:nth=1", seed=2))
    try:
        p2 = a.allocate(1)
    finally:
        faults.clear()
    assert p2 == p
    assert t.empty and t.offloads == 0
    a.publish([7], p2)
    a.release(p2)
    assert a.allocate(1) == p
    assert t.offloads == 1
