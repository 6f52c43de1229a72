"""The KV mesh and the learned wire prices on the port against the JAX
package's (``serving/fleet_mesh.py``): every case of
``tests/test_fleet_mesh.py``, each run through both packages on the same
observations and clock, with the results compared.

- ``WireRateEstimator``: the cold wire, the window's rate, decay back to
  cold, lifetime totals, degenerate observations.
- ``MeshWireRates``: ``page_cost`` against the prior (cold, at the prior,
  slower and faster, the clamp band, pricing off), dropping a member's
  wires and gauge series, the stats rows, the telemetry counters, the
  channel's handle.
- ``MeshClient``: an intro makes a lazy channel, an unchanged re-intro
  keeps it, a changed endpoint replaces it, ``gone`` retracts it and its
  rates, self and invalid intros, ``close``.
- ``MeshPeer``'s fail-fast arm.
- ``plan_route`` with ``wire_cost`` and ``mesh_route``: the same decisions
  as the JAX function on the reference's pricing matrix, including a fetch
  target that flips when a wire's learned rate degrades.
- The registry host's side: kvwire counters on member telemetry become
  rates by delta (a restart's counters taken whole), the intro broker's
  frames on a join, a change, a death and a promotion, and ``mesh_route``.
"""

from __future__ import annotations

import pytest

from distributed_inference_server_tpu.engine.kv_cache import (
    chain_hashes as jchain_hashes,
)
from distributed_inference_server_tpu.serving import fleet as jfleet
from distributed_inference_server_tpu.serving import fleet_mesh as jmesh
from distributed_inference_server_tpu.serving import scheduler as jsched
from distributed_inference_server_tpu.serving.metrics import (
    EngineStatus as JEngineStatus,
)
from distributed_inference_server_tpu.serving.metrics import (
    MetricsCollector as JMetrics,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    chain_hashes,
)
from distributed_inference_server_tpu_torch.serving import fleet as pfleet
from distributed_inference_server_tpu_torch.serving import fleet_mesh as pmesh
from distributed_inference_server_tpu_torch.serving import scheduler as psched
from distributed_inference_server_tpu_torch.serving.metrics import (
    EngineStatus,
    MetricsCollector,
)

T0 = 1_000_000.0  # a fixed wall clock for ``now=``
MESH = {"port": pmesh, "jax": jmesh}
BOTH = ("port", "jax")


def _both(fn):
    """Run ``fn(mesh_module)`` on both packages; the results must agree."""
    port, jax = fn(pmesh), fn(jmesh)
    assert port == jax
    return port


# ---------------------------------------------------------------------------
# WireRateEstimator
# ---------------------------------------------------------------------------


class TestWireRateEstimator:
    def test_cold_wire_has_no_rate(self):
        assert _both(lambda m: m.WireRateEstimator(30.0).rate(now=T0)) is None

    def test_rate_is_window_bytes_over_seconds(self):
        def run(m):
            est = m.WireRateEstimator(window_s=30.0)
            est.observe(1000, 0.5, chunks=2, now=T0)
            est.observe(3000, 1.5, chunks=1, now=T0 + 1.0)
            return est.rate(now=T0 + 2.0), est.totals()

        assert _both(run) == (pytest.approx(2000.0), (4000, 3))

    def test_window_decay_returns_to_cold(self):
        def run(m):
            est = m.WireRateEstimator(window_s=10.0)
            est.observe(8192, 0.25, now=T0)
            return (est.rate(now=T0 + 5.0), est.rate(now=T0 + 60.0),
                    est.totals())

        warm, cold, totals = _both(run)
        assert warm == pytest.approx(8192 / 0.25)
        assert cold is None and totals == (8192, 0)

    def test_degenerate_observations_ignored(self):
        def run(m):
            est = m.WireRateEstimator(window_s=10.0)
            est.observe(0, 1.0, now=T0)
            est.observe(100, 0.0, now=T0)
            est.observe(-5, 1.0, now=T0)
            return est.rate(now=T0), est.totals()

        assert _both(run) == (None, (0, 0))

    @pytest.mark.parametrize("window,epochs", [(30.0, 8), (7.0, 3),
                                               (1.0, 1)])
    def test_window_geometry_matches(self, window, epochs):
        def run(m):
            est = m.WireRateEstimator(window, epochs)
            out = []
            for i in range(40):
                est.observe(1000 + 37 * i, 0.01 * (1 + i % 5), chunks=i % 3,
                            now=T0 + 0.37 * i)
                out.append(est.rate(now=T0 + 0.37 * i + 0.1))
            return out, est.totals()

        _both(run)


# ---------------------------------------------------------------------------
# MeshWireRates
# ---------------------------------------------------------------------------


class _FakeMetrics:
    def __init__(self):
        self.set_calls = []
        self.removed = []

    def set_kv_wire_rate(self, src, dst, rate):
        self.set_calls.append((src, dst, rate))

    def remove_kv_wire_rate(self, src, dst):
        self.removed.append((src, dst))


class _FakePerf:
    def __init__(self):
        self.counters = {}

    def add_counter(self, name, value):
        self.counters[name] = self.counters.get(name, 0.0) + value


class TestMeshWireRates:
    def test_constants_match(self):
        assert pmesh.WIRE_COUNTER_PREFIX == jmesh.WIRE_COUNTER_PREFIX
        assert pmesh._MIN_PAGE_COST == jmesh._MIN_PAGE_COST
        assert pmesh._MAX_PAGE_COST == jmesh._MAX_PAGE_COST

    def test_cold_wire_prices_at_the_prior(self):
        assert _both(lambda m: m.MeshWireRates(prior_rate=1000.0).page_cost(
            "a", "b", 0.6, now=T0)) is None

    def test_page_cost_matrix(self):
        """At the prior the constant, 10x slower ten times dearer, 10x
        faster ten times cheaper, and the clamp band at both ends."""
        def run(m):
            rates = m.MeshWireRates(window_s=30.0, prior_rate=1000.0)
            rates.observe("at", "b", 2000, 2.0, now=T0)
            rates.observe("slow", "b", 100, 1.0, now=T0)
            rates.observe("fast", "b", 10_000, 1.0, now=T0)
            rates.observe("crawl", "b", 1, 1e6, now=T0)
            rates.observe("warp", "b", 10**15, 0.001, now=T0)
            return [rates.page_cost(s, "b", 0.6, now=T0)
                    for s in ("at", "slow", "fast", "crawl", "warp")]

        costs = _both(run)
        assert costs[:3] == [pytest.approx(0.6), pytest.approx(6.0),
                             pytest.approx(0.06)]
        assert costs[3:] == [pmesh._MAX_PAGE_COST, pmesh._MIN_PAGE_COST]

    def test_prior_zero_disables_learned_pricing(self):
        def run(m):
            rates = m.MeshWireRates(window_s=30.0, prior_rate=0.0)
            rates.observe("a", "b", 5000, 1.0, now=T0)
            return (rates.page_cost("a", "b", 0.6, now=T0),
                    rates.rate("a", "b", now=T0))

        assert _both(run) == (None, pytest.approx(5000.0))

    def test_drop_member_clears_wires_and_gauge_series(self):
        def run(m):
            metrics = _FakeMetrics()
            rates = m.MeshWireRates(prior_rate=1000.0, metrics=metrics)
            rates.observe("m1", "m2", 100, 1.0, now=T0)
            rates.observe("m2", "m1", 200, 1.0, now=T0)
            rates.observe("registry", "m3", 300, 1.0, now=T0)
            rates.drop_member("m1")
            return (rates.rate("m1", "m2", now=T0),
                    rates.rate("m2", "m1", now=T0),
                    rates.rate("registry", "m3", now=T0),
                    sorted(metrics.removed), metrics.set_calls)

        got = _both(run)
        assert got[:3] == (None, None, pytest.approx(300))
        assert got[3] == [("m1", "m2"), ("m2", "m1")]

    def test_snapshot_rows_are_stable_and_total(self):
        def run(m):
            rates = m.MeshWireRates(window_s=10.0, prior_rate=1000.0)
            rates.observe("b", "a", 100, 1.0, chunks=1, now=T0)
            rates.observe("a", "b", 200, 1.0, chunks=2, now=T0)
            return rates.snapshot(now=T0 + 60.0)

        rows = _both(run)
        assert [(r["src"], r["dst"]) for r in rows] == [("a", "b"),
                                                        ("b", "a")]
        assert rows[0]["bytes"] == 200 and rows[0]["chunks"] == 2
        assert rows[0]["rate_bytes_per_s"] is None

    def test_observations_piggyback_on_perf_telemetry(self):
        def run(m):
            perf = _FakePerf()
            rates = m.MeshWireRates(prior_rate=1000.0, perf=perf)
            rates.observe("w2", "w1", 4096, 0.5, chunks=3, now=T0)
            rates.observe("w2", "w1", 4096, 0.5, chunks=1, now=T0 + 1)
            return perf.counters

        counters = _both(run)
        base = f"{pmesh.WIRE_COUNTER_PREFIX}w2|w1|"
        assert counters == {base + "bytes": 8192.0, base + "seconds": 1.0,
                            base + "chunks": 4.0}

    def test_channel_handle_feeds_the_keyed_estimator(self):
        def run(m):
            rates = m.MeshWireRates(window_s=30.0, prior_rate=1000.0)
            handle = rates.estimator("w2", "w1")
            handle.observe(500, 0.5, now=T0)
            return handle.rate(now=T0), rates.rate("w2", "w1", now=T0)

        assert _both(run) == (pytest.approx(1000.0), pytest.approx(1000.0))

    def test_metrics_collector_renders_the_gauge(self):
        """The gauge's name and labels are the reference's, and a dropped
        member's series leaves the exposition."""
        for rates, text in (
                (pmesh.MeshWireRates(prior_rate=1000.0,
                                     metrics=MetricsCollector()),
                 lambda r: r.metrics.prometheus_text().decode()),
                (jmesh.MeshWireRates(prior_rate=1000.0, metrics=JMetrics()),
                 lambda r: r.metrics.prometheus_text().decode())):
            rates.observe("w1", "w2", 1000, 0.5)
            line = 'fleet_kv_wire_rate_bytes_per_s{dst="w2",src="w1"} 2000.0'
            alt = 'fleet_kv_wire_rate_bytes_per_s{src="w1",dst="w2"} 2000.0'
            assert line in text(rates) or alt in text(rates)
            rates.drop_member("w1")
            assert 'src="w1"' not in text(rates)


# ---------------------------------------------------------------------------
# MeshClient and MeshPeer
# ---------------------------------------------------------------------------


def _client(m, member="w2"):
    return m.MeshClient(member, m.MeshWireRates(prior_rate=1000.0))


class TestMeshClientIntros:
    @pytest.mark.parametrize("pkg", BOTH)
    def test_intro_lifecycle(self, pkg):
        m = MESH[pkg]
        client = _client(m)
        try:
            intro = {"member_id": "w1", "host": "127.0.0.1",
                     "data_port": 19999, "max_streams": 4}
            client.on_intro(intro)
            first = client.channel("w1")
            assert first is not None
            assert first.address == ("127.0.0.1", 19999)
            assert first.max_streams == 4 and first.peer_wire
            assert client.channel("nobody") is None
            assert client.peer("nobody", "engine-0") is None
            peer = client.peer("w1", "engine-0")
            assert peer.channel is first and peer.engine_id == "engine-0"
            # an unchanged re-intro keeps the channel (its breaker and
            # backoff live there)
            client.on_intro(dict(intro))
            assert client.channel("w1") is first
            # a changed endpoint replaces it
            client.on_intro(dict(intro, data_port=20001))
            second = client.channel("w1")
            assert second is not first
            assert second.address == ("127.0.0.1", 20001)
            # gone retracts the channel and the wire's rates
            client.rates.observe("w2", "w1", 100, 1.0, now=T0)
            client.on_intro({"member_id": "w1", "gone": True})
            assert client.channel("w1") is None
            assert client.rates.rate("w2", "w1", now=T0) is None
        finally:
            client.close()

    @pytest.mark.parametrize("pkg", BOTH)
    def test_self_and_invalid_intros_ignored(self, pkg):
        client = _client(MESH[pkg])
        try:
            client.on_intro({"member_id": "w2", "host": "127.0.0.1",
                             "data_port": 19999})  # self
            client.on_intro({"member_id": "w1", "host": "",
                             "data_port": 19999})  # no host: retract
            client.on_intro({"member_id": "w1", "host": "127.0.0.1",
                             "data_port": 0})  # no port: retract
            assert client.stats() == {}
        finally:
            client.close()

    @pytest.mark.parametrize("pkg", BOTH)
    def test_close_drops_everything_and_refuses_new_intros(self, pkg):
        client = _client(MESH[pkg])
        client.on_intro({"member_id": "w1", "host": "127.0.0.1",
                         "data_port": 19999, "max_streams": 4})
        client.close()
        assert client.channel("w1") is None
        client.on_intro({"member_id": "w3", "host": "127.0.0.1",
                         "data_port": 20002, "max_streams": 4})
        assert client.channel("w3") is None

    def test_stats_match(self):
        def run(m):
            client = _client(m)
            try:
                client.on_intro({"member_id": "w1", "host": "127.0.0.1",
                                 "data_port": 19999, "max_streams": 2})
                st = client.stats()
                return {k: {f: v for f, v in d.items() if f != "breaker"}
                        for k, d in st.items()}
            finally:
                client.close()

        assert _both(run) == {"w1": {
            "connected": False, "streams": 0, "event_requests": 0,
            "bytes_sent": 0, "bytes_received": 0, "rate_bytes_per_s": None}}


class TestMeshPeerFailFast:
    @pytest.mark.parametrize("pkg", BOTH)
    def test_missing_or_breaker_open_wire_fails_at_once(self, pkg):
        class _OpenBreakerChannel:
            def wire_available(self):
                return False

        m = MESH[pkg]
        for channel in (None, _OpenBreakerChannel()):
            done = []
            m.MeshPeer(channel, "engine-0").submit_prefix_export(
                "r1", [1, 2], 2, "none", lambda c, e: done.append((c, e)))
            assert done == [(None, "mesh peer wire unavailable")]
        assert m.MeshPeer.is_remote is True


# ---------------------------------------------------------------------------
# plan_route with learned prices and the mesh gate
# ---------------------------------------------------------------------------

PS = 4
PROMPT = list(range(33))  # 8 full pages and one token
HASHES = chain_hashes(PROMPT, PS, max_pages=8)


def _costs(sched_mod):
    return sched_mod.FetchCosts(min_pages=2, page_cost=0.25,
                                load_cost_pages=4.0, remote_page_cost=0.6)


def _status(pkg, eid, active=0, waiting=0, digest=None, remote=False,
            data_plane=False):
    cls = EngineStatus if pkg == "port" else JEngineStatus
    return cls(engine_id=eid, healthy=True, active_requests=active,
               waiting_requests=waiting, total_processed=0,
               memory_used_pages=0, memory_total_pages=100,
               prefix_digest=digest, page_size=PS, role="unified",
               digest_depth=8, remote=remote, data_plane=data_plane)


def _wire_cost(rates):
    """The server's wiring: a status pair is a (src, dst) key, "registry"
    for the host; a cold wire returns None (charge the constant)."""
    def member_of(status):
        if status is None or not getattr(status, "remote", False):
            return "registry"
        return status.engine_id.rsplit(":", 1)[0]

    def cost(target, peer):
        src, dst = member_of(target), member_of(peer)
        if src == dst:
            return None
        if "registry" in (src, dst):
            member = dst if src == "registry" else src
            return rates.page_cost("registry", member, 0.6, now=T0)
        return rates.page_cost(src, dst, 0.6, now=T0)

    return cost


def _mesh_statuses(pkg, target_plane=True):
    """A saturated warm remote peer, a cold remote mesh target and a cold
    local engine."""
    return [
        _status(pkg, "engine-0"),
        _status(pkg, "w1:engine-0", active=6, waiting=4,
                digest=frozenset(HASHES), remote=True, data_plane=True),
        _status(pkg, "w2:engine-0", remote=True, data_plane=target_plane),
    ]


def _route(pkg, observations, mesh_ok=True, with_cost=True,
           target_plane=True):
    m, sched = (pmesh, psched) if pkg == "port" else (jmesh, jsched)
    rates = m.MeshWireRates(window_s=30.0, prior_rate=1000.0)
    for obs in observations:
        rates.observe(*obs)
    plan = sched.plan_route(
        _mesh_statuses(pkg, target_plane), HASHES, costs=_costs(sched),
        page_size=PS, wire_cost=_wire_cost(rates) if with_cost else None,
        mesh_route=lambda t, p: mesh_ok)
    return plan.engine_id, plan.decision, plan.peer_id


_MATRIX = {
    # every wire cold: both fetches charge the constant, the tie-break
    # picks the local relay; the same without wire_cost
    "cold": ([], True, True, True, ("engine-0", "fetch", "w1:engine-0")),
    "cold_no_cost": ([], True, False, True,
                     ("engine-0", "fetch", "w1:engine-0")),
    # a fast mesh wire beats the relay
    "fast_mesh": ([("w2", "w1", 100_000, 1.0, 0, T0)], True, True, True,
                  ("w2:engine-0", "fetch", "w1:engine-0")),
    # the same wire degraded: the target flips back onto the host
    "degraded": ([("w2", "w1", 100_000, 1.0, 0, T0),
                  ("w2", "w1", 100_000, 10_000.0, 0, T0 + 1)], True, True,
                 True, ("engine-0", "fetch", "w1:engine-0")),
    # no introduction: no remote target, however fast its wire
    "gate_closed": ([("w2", "w1", 100_000, 1.0, 0, T0)], False, True, True,
                    ("engine-0", "fetch", "w1:engine-0")),
    # a remote target without a data plane cannot seat pages
    "no_data_plane": ([("w2", "w1", 100_000, 1.0, 0, T0)], True, True, False,
                      ("engine-0", "fetch", "w1:engine-0")),
    # a slow registry wire prices the relay out: the mesh target wins
    "slow_registry": ([("registry", "w1", 10, 1.0, 0, T0)], True, True, True,
                      ("w2:engine-0", "fetch", "w1:engine-0")),
}


class TestMeshRoutingMatrix:
    @pytest.mark.parametrize("case", sorted(_MATRIX))
    def test_matches_jax_and_the_reference_pin(self, case):
        obs, mesh_ok, with_cost, plane, want = _MATRIX[case]
        obs = [(s, d, b, sec, {"chunks": c, "now": n}) for s, d, b, sec, c,
               n in obs]

        def run(pkg):
            m, sched = (pmesh, psched) if pkg == "port" else (jmesh, jsched)
            rates = m.MeshWireRates(window_s=30.0, prior_rate=1000.0)
            for s, d, b, sec, kw in obs:
                rates.observe(s, d, b, sec, **kw)
            plan = sched.plan_route(
                _mesh_statuses(pkg, plane), HASHES, costs=_costs(sched),
                page_size=PS,
                wire_cost=_wire_cost(rates) if with_cost else None,
                mesh_route=lambda t, p: mesh_ok)
            return plan.engine_id, plan.decision, plan.peer_id

        assert run("port") == run("jax") == want

    def test_chain_hashes_match(self):
        assert list(HASHES) == list(jchain_hashes(PROMPT, PS, max_pages=8))


# ---------------------------------------------------------------------------
# the registry host's side: telemetry-fed rates, the broker, the gate
# ---------------------------------------------------------------------------


class _Session:
    def __init__(self, member_id, peer="127.0.0.1:5000"):
        self.member_id = member_id
        self.peer = peer
        self.sent = []
        self.detached = []

    def send(self, name, obj):
        self.sent.append((name, dict(obj)))

    def detach_runners(self, message):
        self.detached.append(message)


def _fleet_server(pkg, mesh=True, ha=None):
    fleet, metrics = (pfleet, MetricsCollector()) if pkg == "port" else (
        jfleet, JMetrics())
    settings = fleet.FleetSettings(enabled=True, mesh_enabled=mesh)
    reg = fleet.FleetRegistry(settings)
    srv = fleet.FleetServer(reg, None, settings, metrics=metrics)
    srv.ha = ha
    return srv


class _Ha:
    def __init__(self, primary, epoch):
        self.primary = primary
        self.epoch = epoch

    def is_primary(self):
        return self.primary


def _kvwire(src, dst, nbytes, secs, chunks):
    base = f"{pmesh.WIRE_COUNTER_PREFIX}{src}|{dst}|"
    return {base + "bytes": nbytes, base + "seconds": secs,
            base + "chunks": chunks}


class TestRegistryWireSide:
    def test_telemetry_counters_become_rates_by_delta(self):
        def run(pkg):
            srv = _fleet_server(pkg)
            out = []
            for counters in (_kvwire("w2", "w1", 1000, 1.0, 1),
                             _kvwire("w2", "w1", 3000, 2.0, 3),
                             # the member restarted: counters from zero
                             _kvwire("w2", "w1", 500, 0.5, 1),
                             {"step.engine-0.decode.tokens": 5.0,
                              "kvwire|bad": 1.0}):
                srv._ingest_wire_counters("w2", counters)
                row = srv.mesh_rates.snapshot()
                out.append([(r["src"], r["dst"], r["bytes"], r["chunks"])
                            for r in row])
            rate = srv.mesh_rates.rate("w2", "w1")
            srv._forget_wires(["w1"])
            return out, rate, srv.mesh_rates.snapshot(), srv._kvwire_last

        got = run("port")
        assert got[:2] == run("jax")[:2]
        assert got[0][-1] == [("w2", "w1", 3500, 4)]
        assert got[1] == pytest.approx(3500 / 2.5)
        assert got[2] == [] and got[3] == {}

    def test_intro_broker_frames(self):
        """A join introduces both ways, an unchanged beat sends nothing, a
        changed port re-introduces, a dropped data plane and a death send
        ``gone``; a standby only tracks; a promotion publishes at its
        epoch."""
        def run(pkg):
            fleet = pfleet if pkg == "port" else jfleet
            srv = _fleet_server(pkg)
            s1, s2 = _Session("w1", "10.0.0.1:5000"), _Session(
                "w2", "10.0.0.2:5000")
            srv._by_member.update({"w1": s1, "w2": s2})
            srv._broker_intros(s1, "w1", 7001)
            srv._broker_intros(s2, "w2", 7002)
            srv._broker_intros(s2, "w2", 7002)  # unchanged
            srv._broker_intros(s2, "w2", 7003)  # a new port
            gate = (srv.mesh_route("w1", "w2"), srv.mesh_route("w1", "w1"))
            srv._broker_intros(s2, "w2", 0)  # the data plane went away
            srv._broker_intros(s2, "w2", 7004)
            srv._on_member_state("w2", fleet.MEMBER_ALIVE, fleet.MEMBER_DEAD)
            # a standby tracks endpoints and sends nothing; its promotion
            # publishes them at its epoch
            srv.ha = _Ha(False, 3)
            srv._broker_intros(s2, "w2", 7005)
            srv._by_member["w2"] = s2
            srv.ha.primary = True
            srv.on_ha_promote()
            counts = srv.metrics.fleet_counters()["kv_intros"]
            return s1.sent, s2.sent, gate, counts

        port, jax = run("port"), run("jax")
        assert port == jax
        s1_sent, s2_sent, gate, counts = port
        assert gate == (True, False)
        assert ("KvIntro", {"member_id": "w2", "gone": True}) in s1_sent
        assert s1_sent[-1] == ("KvIntro", {
            "member_id": "w2", "host": "10.0.0.2", "data_port": 7005,
            "max_streams": 4, "epoch": 3})
        assert counts["gone"] >= 2 and counts["sent"] >= 4

    def test_mesh_off_brokers_nothing(self):
        for pkg in BOTH:
            srv = _fleet_server(pkg, mesh=False)
            s1 = _Session("w1")
            srv._by_member["w1"] = s1
            srv._broker_intros(s1, "w1", 7001)
            assert s1.sent == [] and not srv.mesh_route("w1", "w2")
