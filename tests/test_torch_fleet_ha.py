"""Registry HA on the port against the JAX package's
(``serving/fleet_ha.py``): the cases of ``tests/test_fleet.py``
``TestRegistryHA``, each run through both packages' ``RegistryHA`` on the
same frame sequence and clock, with the traces (role, epoch, takeovers,
lease holder, the frames sent to the peers) compared.

- Election: every registry boots standby; the boot grace is one lease;
  ``registries[0]`` promotes after it, a later index defers to a fresh
  lower-index peer and stops deferring once its frames age out.
- The lease: an accepted beat is watched by the member-aging machinery; a
  lease that dies is taken over at the highest epoch seen plus one.
- Fencing: a primary steps down on a higher-epoch lease, on a same-epoch
  lease from a lower index, and on a standby's echo of a higher epoch; a
  stale lease changes nothing.
- A restart resets the election; ``fleet.takeover`` crashes a promotion
  before any state changes; ``stats()``'s shape.
- Random frame sequences on a shared clock give identical traces.
- The hooks around it: the lease and state frames route to the HA module
  and claim no member; members fence stale submits and intros (a JAX
  registry's epoch-stamped frames against a port worker and the other way
  round); a standby's dispatcher turns ingress away while
  ``fleet.standby_http`` is false; the balancer and the metrics follow the
  role.
"""

from __future__ import annotations

import random
import socket
import threading
import time

import pytest

from distributed_inference_server_tpu.serving import faults as jfaults
from distributed_inference_server_tpu.serving import fleet as jfleet
from distributed_inference_server_tpu.serving import fleet_ha as jha
from distributed_inference_server_tpu.serving.metrics import (
    MetricsCollector as JMetrics,
)
from distributed_inference_server_tpu_torch.core.errors import QueueFull
from distributed_inference_server_tpu_torch.engine.engine import (
    SamplingParams,
)
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving import fleet as pfleet
from distributed_inference_server_tpu_torch.serving import fleet_ha as pha
from distributed_inference_server_tpu_torch.serving import protowire as pw
from distributed_inference_server_tpu_torch.serving.metrics import (
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.remote_runner import (
    FleetWorker,
    RemoteRunner,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    ServerRequest,
)

PKGS = {"port": (pha, pfleet, faults, MetricsCollector),
        "jax": (jha, jfleet, jfaults, JMetrics)}
REGS = ("127.0.0.1:7101", "127.0.0.1:7102", "127.0.0.1:7103")


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    faults.clear()
    jfaults.clear()


class _StubFleetServer:
    def __init__(self):
        self.promotes = 0

    def on_ha_promote(self):
        self.promotes += 1


class _StubPeerLink:
    """Records frames instead of dialing; stands in for ``_PeerLink``."""

    def __init__(self, endpoint):
        self.endpoint = endpoint
        self.frames = []

    def send(self, name, obj):
        self.frames.append((name, dict(obj)))
        return True

    def connected(self):
        return True

    def close(self):
        pass


def _ha(pkg, me=0, lease_s=3.0, lease_suspect_s=1.5, metrics=False):
    """A RegistryHA with its beat thread parked (a 60 s interval) and its
    peer wires stubbed: tests drive ``_tick(now)`` and ``on_peer_frame``."""
    ha_mod, fleet_mod, _, metrics_cls = PKGS[pkg]
    settings = fleet_mod.FleetSettings(
        enabled=True, registries=REGS, lease_s=lease_s,
        lease_suspect_s=lease_suspect_s, heartbeat_interval_s=60.0)
    srv = _StubFleetServer()
    ha = ha_mod.RegistryHA(srv, settings,
                           metrics=metrics_cls() if metrics else None)
    ha.start(REGS[me])
    ha.stop()  # parks the thread; the state stays, ticks are manual
    ha._peers = [_StubPeerLink(ep) for i, ep in enumerate(REGS) if i != me]
    return ha, srv


def _trace(ha, srv):
    st = ha.stats()
    return (ha.role, ha.epoch, dict(st["takeovers"]), st["lease"]["holder"],
            st["lease"]["state"], srv.promotes,
            [link.frames[-1] if getattr(link, "frames", None) else None
             for link in ha._peers])


def _clean(frame):
    """A frame without its per-process sequence number."""
    if frame is None:
        return None
    name, obj = frame
    return name, {k: v for k, v in obj.items() if k != "seq"}


def _run_both(script, **kw):
    """``script(ha, srv, pkg)`` on both packages; returns the port's
    trace, asserting it equals the JAX package's."""
    traces = {}
    for pkg in ("port", "jax"):
        ha, srv = _ha(pkg, **kw)
        script(ha, srv, pkg)
        traces[pkg] = _trace(ha, srv)
    assert traces["port"] == traces["jax"]
    return traces["port"]


class TestRegistryHA:
    def test_boots_standby_and_respects_boot_grace(self):
        def script(ha, srv, pkg):
            assert ha.role == "standby" and ha.epoch == 0
            ha._tick(time.monotonic())  # inside the boot grace
            assert ha.role == "standby" and srv.promotes == 0
            assert all(link.frames[-1][0] == "RegistryState"
                       for link in ha._peers)

        _run_both(script, me=0)

    def test_lowest_index_promotes_after_grace(self):
        def script(ha, srv, pkg):
            now = time.monotonic()
            ha._tick(now + ha.settings.lease_s + 0.1)
            assert ha.is_primary() and ha.epoch == 1 and srv.promotes == 1
            assert ha.stats()["takeovers"] == {"lease_expired": 1}
            ha._tick(now + ha.settings.lease_s + 0.2)
            for link in ha._peers:
                name, frame = link.frames[-1]
                assert name == "RegistryLease"
                assert frame["epoch"] == 1 and frame["role"] == "primary"

        _run_both(script, me=0)

    def test_standby_defers_to_fresh_lower_index_peer(self):
        def script(ha, srv, pkg):
            now = time.monotonic()
            ha._lease_rx_at = now - ha.settings.lease_s - 0.1
            ha.on_peer_frame("RegistryState", {
                "registry_id": REGS[0], "epoch": 0, "role": "standby"})
            ha._tick(now)
            assert ha.role == "standby" and srv.promotes == 0
            ha._tick(now + ha.settings.lease_s + 0.2)
            assert ha.is_primary() and ha.epoch == 1

        _run_both(script, me=1)

    def test_lease_accept_then_expiry_promotes_above_learned_epoch(self):
        def script(ha, srv, pkg):
            ha.on_peer_frame("RegistryLease", {
                "registry_id": REGS[0], "epoch": 5, "role": "primary"})
            assert ha.epoch == 5 and ha.role == "standby"
            st = ha.stats()
            assert st["lease"]["holder"] == REGS[0]
            assert st["lease"]["state"] == "alive"
            now = time.monotonic()
            ha._tick(now)
            assert ha.role == "standby"
            ha._tick(now + ha.settings.lease_s + 0.1)
            assert ha.is_primary() and ha.epoch == 6 and srv.promotes == 1

        _run_both(script, me=1)

    def test_primary_fenced_by_higher_epoch_lease(self):
        def script(ha, srv, pkg):
            ha._tick(time.monotonic() + ha.settings.lease_s + 0.1)
            assert ha.is_primary() and ha.epoch == 1
            ha.on_peer_frame("RegistryLease", {
                "registry_id": REGS[1], "epoch": 3, "role": "primary"})
            assert ha.role == "standby" and ha.epoch == 3
            assert ha.stats()["takeovers"].get("fenced") == 1
            assert ha.stats()["lease"]["holder"] == REGS[1]

        _run_both(script, me=0)

    @pytest.mark.parametrize("me,want_primary", [(1, False), (0, True)])
    def test_same_epoch_tie_breaks_on_list_order(self, me, want_primary):
        other = REGS[0] if me == 1 else REGS[1]

        def script(ha, srv, pkg):
            ha._tick(time.monotonic() + 2 * ha.settings.lease_s + 0.2)
            assert ha.is_primary() and ha.epoch == 1
            ha.on_peer_frame("RegistryLease", {
                "registry_id": other, "epoch": 1, "role": "primary"})
            assert ha.is_primary() is want_primary and ha.epoch == 1

        _run_both(script, me=me)

    def test_stale_lease_ignored(self):
        def script(ha, srv, pkg):
            ha.on_peer_frame("RegistryLease", {
                "registry_id": REGS[0], "epoch": 5, "role": "primary"})
            ha.on_peer_frame("RegistryLease", {
                "registry_id": REGS[2], "epoch": 3, "role": "primary"})
            assert ha.epoch == 5
            assert ha.stats()["lease"]["holder"] == REGS[0]

        _run_both(script, me=1)

    def test_registry_state_echo_fences_primary(self):
        def script(ha, srv, pkg):
            ha._tick(time.monotonic() + ha.settings.lease_s + 0.1)
            assert ha.is_primary()
            ha.on_peer_frame("RegistryState", {
                "registry_id": REGS[2], "epoch": 4, "role": "standby"})
            assert ha.role == "standby" and ha.epoch == 4

        _run_both(script, me=0)

    def test_restart_resets_election_state(self):
        def script(ha, srv, pkg):
            ha._tick(time.monotonic() + ha.settings.lease_s + 0.1)
            assert ha.is_primary() and ha.epoch == 1
            ha.stop()
            ha.start(REGS[0])  # a process restart
            ha.stop()
            assert ha.role == "standby" and ha.epoch == 0
            assert ha.stats()["takeovers"] == {}

        _run_both(script, me=0)

    def test_injected_takeover_crash_is_atomic_or_absent(self):
        def script(ha, srv, pkg):
            f = PKGS[pkg][2]
            f.install(f.parse_spec("fleet.takeover:nth=1", seed=7))
            now = time.monotonic()
            with pytest.raises(f.InjectedFault):
                ha._tick(now + ha.settings.lease_s + 0.1)
            assert ha.role == "standby" and ha.epoch == 0
            assert ha.stats()["takeovers"] == {} and srv.promotes == 0
            ha._tick(now + ha.settings.lease_s + 0.2)
            assert ha.is_primary() and ha.epoch == 1
            f.clear()

        _run_both(script, me=0)

    def test_stats_shape(self):
        def script(ha, srv, pkg):
            ha.on_peer_frame("RegistryLease", {
                "registry_id": REGS[0], "epoch": 2, "role": "primary"})
            st = ha.stats()
            assert st["registry_id"] == REGS[2]
            assert st["role"] == "standby" and st["epoch"] == 2
            assert st["peers"][REGS[0]]["role"] == "primary"
            assert st["peers"][REGS[0]]["epoch"] == 2
            assert st["lease"]["age_s"] >= 0.0
            assert set(st) == {"registry_id", "role", "epoch", "lease",
                               "peers", "takeovers"}

        _run_both(script, me=2)

    def test_lease_beat_fault_drops_the_primary_beat(self):
        def script(ha, srv, pkg):
            now = time.monotonic()
            ha._tick(now + ha.settings.lease_s + 0.1)
            for link in ha._peers:
                link.frames.clear()
            f = PKGS[pkg][2]
            f.install(f.parse_spec("fleet.lease_beat:prob=1.0,times=2",
                                   seed=3))
            ha._tick(now + ha.settings.lease_s + 0.2)  # both peers dropped
            assert all(not link.frames for link in ha._peers)
            ha._tick(now + ha.settings.lease_s + 0.3)
            assert all(link.frames[-1][0] == "RegistryLease"
                       for link in ha._peers)
            f.clear()

        _run_both(script, me=0)

    @pytest.mark.parametrize("seed", range(6))
    def test_random_frame_sequences_trace_alike(self, seed):
        """Random leases, echoes and ticks from random peers on one shared
        clock: the two packages' traces agree step by step."""
        rng = random.Random(seed)
        steps = []
        t = 0.0
        for _ in range(40):
            t += rng.choice([0.1, 0.5, 1.0, 2.0, 3.5])
            kind = rng.random()
            if kind < 0.4:
                steps.append(("tick", t))
            else:
                steps.append((rng.choice(["RegistryLease",
                                          "RegistryState"]),
                              {"registry_id": rng.choice(REGS),
                               "epoch": rng.randint(0, 6),
                               "role": rng.choice(["primary", "standby"])}))
        me = seed % 3
        traces = {}
        for pkg in ("port", "jax"):
            ha, srv = _ha(pkg, me=me, metrics=True)
            base = time.monotonic()
            out = []
            for step in steps:
                if step[0] == "tick":
                    ha._tick(base + step[1])
                else:
                    ha.on_peer_frame(step[0], step[1])
                tr = _trace(ha, srv)
                out.append(tr[:6] + ([_clean(f) for f in tr[6]],))
            traces[pkg] = out
        assert traces["port"] == traces["jax"]

    def test_role_and_epoch_metrics(self):
        for pkg in ("port", "jax"):
            ha, _ = _ha(pkg, me=0, metrics=True)
            ha._tick(time.monotonic() + ha.settings.lease_s + 0.1)
            text = ha.metrics.prometheus_text().decode()
            assert 'fleet_registry_role{role="primary"} 1.0' in text
            assert 'fleet_registry_role{role="standby"} 0.0' in text
            assert "fleet_registry_epoch 1.0" in text
            assert ('fleet_registry_takeovers_total{reason="lease_expired"}'
                    ' 1.0') in text


# ---------------------------------------------------------------------------
# the hooks: the registry's listener, the members' fence, the front door
# ---------------------------------------------------------------------------


class _ServerStub:
    def __init__(self):
        self.frames = []

    def on_registry_frame(self, name, obj):
        self.frames.append((name, obj))


def test_peer_frames_route_to_ha_and_claim_no_member():
    """A registry's lease and state frames on a member listener go to its
    HA module; the session never becomes a member."""
    settings = pfleet.FleetSettings(enabled=True, heartbeat_interval_s=0.05)
    reg = pfleet.FleetRegistry(settings)

    class _Sched:
        def register(self, r):
            pass

        def unregister_if(self, eid, r):
            pass

        def get(self, eid):
            return None

    srv = pfleet.FleetServer(reg, _Sched(), settings)
    got = []

    class _Ha:
        epoch = 4

        def on_peer_frame(self, name, obj):
            got.append((name, obj))

        def is_primary(self):
            return True

    srv.ha = _Ha()
    srv.start()
    try:
        assert srv.control_epoch() == 4
        for mod in (pfleet, jfleet):  # either package's peer registry
            sock = socket.create_connection(("127.0.0.1", srv.bound_port))
            mod.send_frame(sock, "RegistryLease", {
                "registry_id": "r1", "epoch": 3, "seq": 7,
                "role": "primary"})
            mod.send_frame(sock, "RegistryState", {
                "registry_id": "r1", "epoch": 3, "role": "standby"})
            deadline = time.monotonic() + 5.0
            while len(got) < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            sock.close()
            assert [n for n, _ in got] == ["RegistryLease", "RegistryState"]
            assert got[0][1]["seq"] == 7
            got.clear()
        assert reg.members() == []
    finally:
        srv.stop()


class _Sink:
    def __init__(self):
        self.errors = []
        self.dones = 0
        self.ev = threading.Event()

    def on_token(self, *a, **k):
        pass

    def on_done(self, reason, usage):
        self.dones += 1
        self.ev.set()

    def on_error(self, message, code):
        self.errors.append((message, code))
        self.ev.set()


class _Runner:
    engine_id = "e0"

    def __init__(self):
        self.submitted = []
        self.aborted = []

    def is_healthy(self):
        return True

    def submit(self, reqs):
        for r in reqs:
            self.submitted.append(r.request_id)
            r.sink.on_done("stop", None)

    def abort(self, rid):
        self.aborted.append(rid)


class _OneRunner:
    def __init__(self, runner):
        self.runner = runner

    def get(self, eid):
        return self.runner if eid == self.runner.engine_id else None

    def statuses(self):
        return []


@pytest.mark.parametrize("registry_pkg", ["port", "jax"])
def test_members_fence_stale_epochs(registry_pkg):
    """A port member takes control only from the highest epoch it has seen:
    a stale submit comes back as ``worker_failure`` on the wire it came in
    on, an abort is honoured whatever its epoch, a stale intro is dropped.
    The submits are written by either package's ``send_frame``."""
    mod = pfleet if registry_pkg == "port" else jfleet
    runner = _Runner()
    worker = FleetWorker(_OneRunner(runner), pfleet.FleetSettings(
        connect="127.0.0.1:1", kv_enabled=False), member_id="w1")
    a, b = socket.socketpair()
    link = worker._links[0]
    link.sock = a
    reader = threading.Thread(target=worker._read_loop, args=(a, link),
                              daemon=True)
    reader.start()

    def submit(rid, epoch):
        frame = {"request_id": rid, "engine_id": "e0",
                 "prompt_ids": [1, 2, 3], "max_tokens": 2}
        if epoch:
            frame["epoch"] = epoch
        mod.send_frame(b, "FleetSubmit", frame)

    try:
        submit("r-new", 5)
        submit("r-stale", 4)
        submit("r-unfenced", 0)
        mod.send_frame(b, "FleetSubmit", {"request_id": "r-x",
                                          "engine_id": "e0", "abort": True,
                                          "epoch": 1})
        events = []
        deadline = time.monotonic() + 5.0
        while len(events) < 3 and time.monotonic() < deadline:
            name, obj = pfleet.recv_frame(b)
            if name == "FleetEvent":
                events.append(obj)
        assert worker._fleet_epoch == 5
        assert runner.submitted == ["r-new", "r-unfenced"]
        assert runner.aborted == ["r-x"]
        stale = [e for e in events if e["request_id"] == "r-stale"]
        assert stale and stale[0]["kind"] == "error"
        assert stale[0]["code"] == "worker_failure"
        assert "stale control epoch 4" in stale[0]["message"]
        # intros: an older epoch is ignored, a newer one raises the fence
        worker._on_kv_intro({"member_id": "w2", "host": "h",
                             "data_port": 9, "epoch": 3})
        assert worker._fleet_epoch == 5
        worker._on_kv_intro({"member_id": "w2", "host": "h",
                             "data_port": 9, "epoch": 6})
        assert worker._fleet_epoch == 6
    finally:
        a.close()
        b.close()
        reader.join(5.0)


def test_remote_runner_stamps_its_registry_epoch():
    """Submits and aborts carry the registry's control epoch (omitted at
    0), byte-equal to the JAX proxy's frames."""
    from distributed_inference_server_tpu.engine.engine import (
        SamplingParams as JSamplingParams,
    )
    from distributed_inference_server_tpu.serving import protowire as jpw
    from distributed_inference_server_tpu.serving import (
        remote_runner as jremote,
    )
    from distributed_inference_server_tpu.serving.metrics import (
        EngineStatus as JEngineStatus,
    )
    from distributed_inference_server_tpu.serving.runner import (
        ServerRequest as JServerRequest,
    )
    from distributed_inference_server_tpu_torch.serving.metrics import (
        EngineStatus,
    )

    out = {}
    for pkg, (remote_cls, req_cls, params_cls, status_cls, enc) in {
            "port": (RemoteRunner, ServerRequest, SamplingParams,
                     EngineStatus, pw.encode),
            "jax": (jremote.RemoteRunner, JServerRequest, JSamplingParams,
                    JEngineStatus, jpw.encode)}.items():
        frames = []
        r = remote_cls("w1:e0", "e0", lambda n, o: frames.append((n, o)))
        r.update_status(status_cls(engine_id="w1:e0", healthy=True,
                                   active_requests=0, waiting_requests=0,
                                   total_processed=0, remote=True))
        for epoch in (0, 7):
            r.epoch_fn = lambda e=epoch: e
            r.submit([req_cls(f"r{epoch}", [1, 2],
                              params_cls(max_tokens=4), _Sink())])
            r.abort(f"r{epoch}")
        out[pkg] = [(n, enc(n, o)) for n, o in frames]
    assert out["port"] == out["jax"]
    assert b"epoch" not in b"".join(v for _, v in out["port"][:2])


def test_standby_front_door_and_balancer_follow_the_lease():
    """With ``standby_http`` false a standby's dispatcher turns ingress
    away as ``QueueFull`` until it holds the lease; the role balancer
    evaluates only on the primary."""
    from distributed_inference_server_tpu_torch.serving.dispatcher import (
        Dispatcher,
    )
    from distributed_inference_server_tpu_torch.serving.fleet import (
        RoleBalancer,
    )
    from distributed_inference_server_tpu_torch.serving.scheduler import (
        AdaptiveScheduler,
    )

    primary = {"v": False}
    sched = AdaptiveScheduler()
    disp = Dispatcher(sched)
    disp.ingress_gate = lambda: primary["v"]
    disp.start()
    try:
        req = ServerRequest("r1", [1, 2], SamplingParams(max_tokens=2),
                            _Sink())
        with pytest.raises(QueueFull):
            disp.submit(req)
        primary["v"] = True
        disp.submit(req)  # queued: the gate is open
        assert not disp.queue.is_empty()
    finally:
        disp.shutdown(drain_timeout_s=0.1)
    bal = RoleBalancer(sched, disp, pfleet.FleetSettings(rerole=True))
    bal.active_fn = lambda: False
    faults.install(faults.parse_spec("sched.rerole:prob=1.0", 1))
    assert bal.evaluate() is None and bal.stats()["signal"] == 0.0
