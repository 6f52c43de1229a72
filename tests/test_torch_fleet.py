"""The fleet's control plane on the port against the JAX package's
(``serving/fleet.py``, ``serving/remote_runner.py``): the cases of
``tests/test_fleet.py`` that need no engine, each fed the same inputs
through both packages with the results compared.

- The fleet wire: every frame kind the port speaks is byte-equal to the
  JAX ``send_frame``'s, and each package decodes the other's frames; the
  status and span dicts are the JAX package's.
- ``FleetRegistry``: join, aging, rejoin, the partition fault, pruning and
  ``stats()`` give the same transitions and metric lines.
- ``RemoteRunner``: the frames it sends and the sinks' outcomes (tokens,
  dones, errors, redispatches) over the same event sequences.
- Remote-aware ``plan_route``, the ``RoleBalancer``'s decisions, the
  ``fleet`` config mapping and its validation, ``unregister_if``, and
  ``check_ported`` accepting registry HA and still refusing the gRPC
  port.
"""

from __future__ import annotations

import socket
import threading
import time

import pytest

from distributed_inference_server_tpu.core.errors import (
    ConfigError as JConfigError,
)
from distributed_inference_server_tpu.engine.engine import (
    SamplingParams as JSamplingParams,
)
from distributed_inference_server_tpu.serving import faults as jfaults
from distributed_inference_server_tpu.serving import fleet as jfleet
from distributed_inference_server_tpu.serving import protowire as jpw
from distributed_inference_server_tpu.serving import (
    remote_runner as jremote,
)
from distributed_inference_server_tpu.serving import scheduler as jsched
from distributed_inference_server_tpu.serving.config import (
    ServerConfig as JServerConfig,
)
from distributed_inference_server_tpu.serving.metrics import (
    EngineStatus as JEngineStatus,
)
from distributed_inference_server_tpu.serving.metrics import (
    MetricsCollector as JMetrics,
)
from distributed_inference_server_tpu.serving.runner import (
    ServerRequest as JServerRequest,
)
from distributed_inference_server_tpu.utils.tracing import Span as JSpan
from distributed_inference_server_tpu_torch.core.errors import ConfigError
from distributed_inference_server_tpu_torch.engine.engine import (
    SamplingParams,
)
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving import fleet
from distributed_inference_server_tpu_torch.serving import protowire as pw
from distributed_inference_server_tpu_torch.serving import remote_runner
from distributed_inference_server_tpu_torch.serving import scheduler
from distributed_inference_server_tpu_torch.serving.config import (
    ServerConfig,
)
from distributed_inference_server_tpu_torch.serving.metrics import (
    EngineStatus,
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    ServerRequest,
)
from distributed_inference_server_tpu_torch.utils.tracing import Span


class _Pkg:
    """One package's side of a comparison."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.fleet = jfleet if jax_side else fleet
        self.remote = jremote if jax_side else remote_runner
        self.sched = jsched if jax_side else scheduler
        self.faults = jfaults if jax_side else faults
        self.status_cls = JEngineStatus if jax_side else EngineStatus
        self.metrics_cls = JMetrics if jax_side else MetricsCollector
        self.req_cls = JServerRequest if jax_side else ServerRequest
        self.params_cls = JSamplingParams if jax_side else SamplingParams
        self.span_cls = JSpan if jax_side else Span

    def status(self, engine_id="e0", healthy=True, role="unified",
               waiting=0, active=0, remote=False, digest=(),
               data_plane=False):
        return self.status_cls(
            engine_id=engine_id, healthy=healthy, active_requests=active,
            waiting_requests=waiting, total_processed=0, role=role,
            prefix_digest=frozenset(digest), page_size=8, digest_depth=8,
            remote=remote, data_plane=data_plane)

    def arm(self, spec: str, seed: int = 1) -> None:
        self.faults.install(self.faults.parse_spec(spec, seed))


PORT, JAX = _Pkg(False), _Pkg(True)
BOTH = (PORT, JAX)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()
    jfaults.clear()


class _Sink:
    def __init__(self):
        self.toks, self.text = [], ""
        self.errors, self.dones = [], 0
        self.ev = threading.Event()

    def on_token(self, token_id, text, token_index, logprob=None):
        if token_id is not None:
            self.toks.append(token_id)
        self.text += text

    def on_done(self, reason, usage):
        self.dones += 1
        self.ev.set()

    def on_error(self, message, code):
        self.errors.append((message, code))
        self.ev.set()

    def outcome(self):
        return (self.toks, self.text, self.errors, self.dones)


def _req(pkg, rid="r1", first_token=False, prompt=(1, 2, 3)):
    sink = _Sink()
    req = pkg.req_cls(rid, list(prompt),
                      pkg.params_cls(max_tokens=8, temperature=0.0), sink)
    if first_token:
        req.first_token_at = time.monotonic()
    return req, sink


# the control plane's families (the JAX collector also writes the KV
# mesh's and registry HA's, and prometheus_client's _created samples)
_FLEET_FAMILIES = ("fleet_members", "fleet_heartbeats_total",
                   "fleet_reroles_total", "fleet_telemetry_frames_total",
                   "fleet_member_step_tokens", "fleet_member_ttft_p99_ms")


def _prom(m) -> list:
    text = m.prometheus_text().decode()
    return sorted(ln for ln in text.splitlines()
                  if ln.split("{")[0].split(" ")[0] in _FLEET_FAMILIES)


# ---------------------------------------------------------------------------
# the fleet wire
# ---------------------------------------------------------------------------

_FRAMES = {
    "FleetHeartbeat": lambda pkg: {
        "member_id": "w1", "seq": 7,
        "engines": [pkg.fleet.status_to_wire(pkg.status(
            engine_id="engine-0", role="decode", digest=(11, 12),
            waiting=3, active=2))]},
    "FleetSubmit": lambda pkg: {
        "request_id": "r1", "engine_id": "e0", "prompt_ids": [1, 2, 3],
        "max_tokens": 8, "temperature": 0.25, "top_p": 0.9,
        "stop_sequences": ["x"], "tenant": "acme",
        "trace_id": "ab" * 8, "parent_span_id": "cd" * 8},
    "FleetEvent": lambda pkg: {
        "request_id": "r1", "engine_id": "e0", "kind": "token",
        "token_id": 42, "text": "hi", "token_index": 3, "logprob": -0.5},
    "FleetSpans": lambda pkg: {
        "member_id": "w1", "dropped": 2, "spans": [pkg.fleet.span_to_wire(
            pkg.span_cls(name="fleet.serve", trace_id="ab" * 8,
                         span_id="ef" * 8, parent_id="cd" * 8,
                         start_ns=1000, end_ns=5000,
                         attributes={"request_id": "r1"},
                         events=[(2000, "dispatched", {"n": 1})]),
            10 ** 18)]},
    "FleetTelemetry": lambda pkg: {
        "member_id": "w1",
        "digests": [{"name": "ttft_ms", "epoch_s": 5.0, "epochs": [
            {"index": 7, "buckets": [3, 9], "counts": [1, 4], "n": 5,
             "sum_us": 12345}]}],
        "counters": [{"name": "step.engine-0.prefill.tokens",
                      "value": 16.0}]},
}


def _frame_bytes(pkg, name: str) -> bytes:
    a, b = socket.socketpair()
    try:
        pkg.fleet.send_frame(a, name, _FRAMES[name](pkg))
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


class TestFleetWire:
    @pytest.mark.parametrize("name", sorted(_FRAMES))
    def test_frames_byte_equal_and_cross_decode(self, name):
        port_bytes = _frame_bytes(PORT, name)
        assert port_bytes == _frame_bytes(JAX, name)
        assert port_bytes[4] == {v: k for k, v in
                                 fleet.FRAME_KINDS.items()}[name]
        for reader in BOTH:  # each package decodes the other's frame
            a, b = socket.socketpair()
            try:
                a.sendall(port_bytes)
                got = reader.fleet.recv_frame(b)
            finally:
                a.close()
                b.close()
            assert got == (name, pw.decode(name, port_bytes[5:]))
            assert got[1] == jpw.decode(name, port_bytes[5:])

    def test_frame_kinds_are_the_jax_control_plane_kinds(self):
        # all eight kinds, the KV mesh's and registry HA's included
        assert fleet.FRAME_KINDS == jfleet.FRAME_KINDS
        assert len(fleet.FRAME_KINDS) == 8
        # a KvIntro frame from a JAX host is decoded, not fatal
        intro = {"member_id": "w2", "host": "h", "data_port": 9}
        a, b = socket.socketpair()
        try:
            jfleet.send_frame(a, "KvIntro", intro)
            name, got = fleet.recv_frame(b)
        finally:
            a.close()
            b.close()
        assert name == "KvIntro"
        assert got == jpw.decode("KvIntro", jpw.encode("KvIntro", intro))

    def test_event_without_token_id_decodes_absent(self):
        a, b = socket.socketpair()
        try:
            fleet.send_frame(a, "FleetEvent", {
                "request_id": "r1", "engine_id": "e0", "kind": "token",
                "text": "tail", "token_index": 9})
            _, ev = fleet.recv_frame(b)
            assert "token_id" not in ev
        finally:
            a.close()
            b.close()

    def test_eof_and_malformed(self):
        for pkg in BOTH:
            a, b = socket.socketpair()
            a.close()
            assert pkg.fleet.recv_frame(b) is None
            b.close()
            a, b = socket.socketpair()
            try:
                a.sendall(b"\x00\x00\x00\x04\x99abcd")  # unknown kind
                with pytest.raises(pkg.fleet.FleetWireError):
                    pkg.fleet.recv_frame(b)
            finally:
                a.close()
                b.close()

    def test_status_wire_round_trip(self):
        got = {}
        for pkg in BOTH:
            s = pkg.status(engine_id="engine-0", role="decode",
                           digest=(5, 6, 7), waiting=3, active=2)
            d = pkg.fleet.status_to_wire(s)
            back = pkg.fleet.status_from_wire(
                pw.decode("EngineStatus", pw.encode("EngineStatus", d)),
                "w1")
            got[pkg.jax] = (d, back.to_dict(), back.prefix_digest,
                            back.page_size, back.digest_depth)
        assert got[False] == got[True]
        assert got[False][1]["engine_id"] == "w1:engine-0"
        assert got[False][1]["remote"] is True
        assert got[False][2] == frozenset((5, 6, 7))

    def test_span_wire_round_trip(self):
        d = _FRAMES["FleetSpans"](PORT)["spans"][0]
        assert d == _FRAMES["FleetSpans"](JAX)["spans"][0]
        p = fleet.span_from_wire(d, 10 ** 18, "w1")
        j = jfleet.span_from_wire(d, 10 ** 18, "w1")
        assert p.to_dict() == j.to_dict()
        assert (p.start_ns, p.end_ns, p.parent_id) == (1000, 5000, "cd" * 8)
        assert p.attributes == {"request_id": "r1", "member": "w1"}

    def test_parse_connect(self):
        assert fleet.parse_connect("10.0.0.2:9000") == ("10.0.0.2", 9000)
        for bad in ("nope", ":123", "h:", "h:x"):
            with pytest.raises(ConfigError):
                fleet.parse_connect(bad)
            with pytest.raises(JConfigError):
                jfleet.parse_connect(bad)


# ---------------------------------------------------------------------------
# FleetRegistry
# ---------------------------------------------------------------------------


def _registry(pkg, **kw):
    settings = pkg.fleet.FleetSettings(heartbeat_interval_s=0.05,
                                       suspect_after_s=0.2,
                                       dead_after_s=0.5, **kw)
    m = pkg.metrics_cls()
    transitions = []
    reg = pkg.fleet.FleetRegistry(
        settings, metrics=m, on_state_change=lambda *t: transitions.append(t))
    return reg, m, transitions


def _both(fn):
    """Run ``fn(pkg)`` on both packages; assert equal results."""
    port, jax = fn(PORT), fn(JAX)
    assert port == jax
    return port


class TestFleetRegistry:
    def test_join_then_age_out_then_rejoin(self):
        def run(pkg):
            reg, m, transitions = _registry(pkg)
            out = [reg.observe("w1", [pkg.status()]),
                   reg.member_state("w1")]
            now = time.monotonic()
            out += [reg.sweep(now + 0.3), reg.sweep(now + 0.6),
                    reg.member_state("w1"),
                    reg.observe("w1", [pkg.status()]),
                    reg.member_state("w1")]
            return out, transitions, _prom(m)

        out, transitions, prom = _both(run)
        assert out[0] == fleet.MEMBER_DEAD  # a first join
        assert out[2] == [("w1", "alive", "suspect")]
        assert out[3] == [("w1", "suspect", "dead")]
        assert ("w1", "dead", "alive") in transitions
        assert 'fleet_members{state="alive"} 1.0' in prom
        assert 'fleet_heartbeats_total{outcome="rejoin"} 1.0' in prom

    def test_one_missed_beat_and_first_join(self):
        def run(pkg):
            reg, m, transitions = _registry(pkg)
            reg.observe("w1", [pkg.status()])
            return (reg.sweep(time.monotonic() + 0.1),
                    reg.member_state("w1"), transitions, _prom(m))

        swept, state, transitions, prom = _both(run)
        assert (swept, state, transitions) == ([], "alive", [])
        assert 'fleet_heartbeats_total{outcome="ok"} 1.0' in prom
        assert not any("rejoin" in ln for ln in prom)

    def test_disconnect_is_immediately_dead(self):
        def run(pkg):
            reg, m, transitions = _registry(pkg)
            reg.observe("w1", [pkg.status()])
            reg.disconnect("w1")
            return reg.member_state("w1"), transitions, _prom(m)

        state, transitions, prom = _both(run)
        assert state == "dead" and ("w1", "alive", "dead") in transitions
        assert 'fleet_members{state="dead"} 1.0' in prom

    def test_heartbeat_fault_drops_the_beat(self):
        def run(pkg):
            reg, m, _ = _registry(pkg)
            reg.observe("w1", [pkg.status()])
            pkg.arm("fleet.heartbeat:nth=1,times=3")
            dropped = [reg.observe("w1", [pkg.status()]) for _ in range(3)]
            pkg.faults.clear()
            return dropped, bool(reg.sweep(time.monotonic() + 0.3)), \
                _prom(m)

        dropped, aged, prom = _both(run)
        assert dropped == [None] * 3 and aged
        assert 'fleet_heartbeats_total{outcome="dropped"} 3.0' in prom

    def test_dead_members_pruned_after_retention(self):
        def run(pkg):
            reg, m, _ = _registry(pkg)
            reg.observe("w1", [pkg.status()])
            reg.disconnect("w1")
            now = time.monotonic()
            reg.sweep(now + 1.0)
            kept = reg.member_state("w1")
            reg.sweep(now + reg.settings.dead_after_s
                      + reg.settings.dead_retention_s + 1.0)
            return kept, reg.member_state("w1"), _prom(m)

        kept, gone, prom = _both(run)
        assert (kept, gone) == ("dead", None)
        assert 'fleet_members{state="dead"} 0.0' in prom

    def test_stats_shape(self):
        def run(pkg):
            reg, _, _ = _registry(pkg)
            reg.observe("w1", [pkg.status(role="decode")])
            stats = reg.stats()
            for member in stats["members"]:
                assert member.pop("last_beat_age_s") >= 0
            return stats

        stats = _both(run)
        assert stats["member_counts"] == {"alive": 1, "suspect": 0,
                                          "dead": 0}
        assert stats["members"] == [{"member_id": "w1", "state": "alive",
                                     "beats": 1,
                                     "engines": {"e0": "decode"}}]


# ---------------------------------------------------------------------------
# RemoteRunner
# ---------------------------------------------------------------------------


class _WireLog:
    def __init__(self):
        self.frames = []
        self.dead = False

    def send(self, name, obj):
        if self.dead:
            raise OSError("wire down")
        self.frames.append((name, dict(obj)))


def _remote(pkg, wire=None):
    wire = wire or _WireLog()
    r = pkg.remote.RemoteRunner("w1:e0", "e0", wire.send)
    r.update_status(pkg.status(engine_id="w1:e0", remote=True))
    return r, wire


def _taker(taken, ok=True):
    return lambda req, eid, msg: taken.append(req.request_id) or ok


_EVENTS = [
    {"request_id": "r1", "kind": "token", "token_id": 9, "text": "a",
     "token_index": 0, "logprob": -0.25},
    {"request_id": "r1", "kind": "done", "finish_reason": "length",
     "prompt_tokens": 3, "completion_tokens": 1},
    # an orphan after the terminal: dropped
    {"request_id": "r1", "kind": "done", "finish_reason": "stop"},
]


class TestRemoteRunner:
    def test_submit_frames_and_events(self):
        def run(pkg):
            r, wire = _remote(pkg)
            req, sink = _req(pkg)
            r.submit([req])
            inflight = r.active_count()
            for ev in _EVENTS:
                r.on_event(dict(ev))
            return wire.frames, inflight, r.active_count(), sink.outcome()

        frames, inflight, after, outcome = _both(run)
        assert frames[0][0] == "FleetSubmit"
        assert frames[0][1]["engine_id"] == "e0"
        assert (inflight, after) == (1, 0)
        assert outcome == ([9], "a", [], 1)

    def test_traced_submit_carries_the_context(self):
        def run(pkg):
            r, wire = _remote(pkg)
            req, _ = _req(pkg)
            req.span = pkg.span_cls(name="request", trace_id="t" * 16,
                                    span_id="s" * 16, parent_id=None,
                                    start_ns=0)
            r.submit([req])
            return wire.frames

        frames = _both(run)
        assert frames[0][1]["trace_id"] == "t" * 16
        assert frames[0][1]["parent_span_id"] == "s" * 16

    def test_error_event_resolves_once(self):
        def run(pkg):
            r, _ = _remote(pkg)
            req, sink = _req(pkg, first_token=True)
            r.submit([req])
            r.on_event({"request_id": "r1", "kind": "error",
                        "message": "boom", "code": "inference_failed"})
            r.on_event({"request_id": "r1", "kind": "error",
                        "message": "again", "code": "inference_failed"})
            return sink.outcome(), r.active_count()

        outcome, n = _both(run)
        assert outcome[2] == [("boom", "inference_failed")] and n == 0

    def test_detach_redispatches_zero_token_and_fails_midstream(self):
        def run(pkg):
            r, _ = _remote(pkg)
            taken = []
            r.redispatch = _taker(taken)
            fresh, fresh_sink = _req(pkg, "fresh")
            mid, mid_sink = _req(pkg, "mid", first_token=True)
            r.submit([fresh, mid])
            r.detach("member dead")
            healthy = r.is_healthy()
            late, _ = _req(pkg, "late")
            r.submit([late])
            return taken, fresh_sink.outcome(), mid_sink.outcome(), healthy

        taken, fresh, mid, healthy = _both(run)
        assert taken == ["fresh", "late"] and not healthy
        assert fresh[2] == [] and mid[2] == [("member dead",
                                              "engine_crashed")]

    def test_send_failure_and_submit_fault_redispatch(self):
        def run(pkg):
            out = []
            for arm in (False, True):
                r, wire = _remote(pkg)
                wire.dead = not arm
                if arm:
                    pkg.arm("fleet.submit:nth=1")
                taken = []
                r.redispatch = _taker(taken)
                req, sink = _req(pkg)
                r.submit([req])
                pkg.faults.clear()
                out.append((taken, sink.outcome(), wire.frames,
                            r.consecutive_wire_failures))
            return out

        for taken, outcome, frames, fails in _both(run):
            assert taken == ["r1"] and outcome[2] == [] and frames == []
            assert fails == 1

    def test_remote_worker_failure_and_exhausted_redispatch(self):
        def run(pkg):
            r, _ = _remote(pkg)
            taken = []
            r.redispatch = _taker(taken)
            req, sink = _req(pkg)
            r.submit([req])
            r.on_event({"request_id": "r1", "kind": "error",
                        "message": "remote out of capacity",
                        "code": "worker_failure"})
            r2, _ = _remote(pkg)
            r2.redispatch = _taker([], ok=False)
            req2, sink2 = _req(pkg)
            r2.submit([req2])
            r2.detach("member dead")
            return taken, sink.outcome(), sink2.outcome()

        taken, first, second = _both(run)
        assert taken == ["r1"] and first[2] == []
        assert second[2] == [("member dead", "worker_failure")]

    def test_abort_sends_frame_and_pops(self):
        def run(pkg):
            r, wire = _remote(pkg)
            req, sink = _req(pkg)
            r.submit([req])
            r.abort("r1")
            r.on_event({"request_id": "r1", "kind": "done",
                        "finish_reason": "stop"})
            return wire.frames[-1], r.active_count(), sink.outcome()

        last, n, outcome = _both(run)
        assert last == ("FleetSubmit", {"request_id": "r1",
                                        "engine_id": "e0", "abort": True})
        assert n == 0 and outcome[3] == 0

    def test_status_overlays_liveness_and_inflight(self):
        def run(pkg):
            r, _ = _remote(pkg)
            req, _ = _req(pkg)
            r.submit([req])
            out = [r.status().active_requests]
            r.set_member_state(pkg.fleet.MEMBER_SUSPECT)
            out += [r.is_healthy(), r.status().healthy]
            r.set_member_state(pkg.fleet.MEMBER_ALIVE)
            out += [r.is_healthy(), r.audit(), r.status().to_dict()]
            return out

        out = _both(run)
        assert out[:5] == [1, False, False, True, []]
        assert out[5]["remote"] is True

    def test_two_phase_detach_keeps_siblings_out_of_redispatch(self):
        def run(pkg):
            a, _ = _remote(pkg)
            b, _ = _remote(pkg)
            seen = []
            a.redispatch = lambda req, eid, msg: (
                seen.append(b.is_healthy()) or True)
            req, _ = _req(pkg)
            a.submit([req])
            a.mark_detached("member dead")
            b.mark_detached("member dead")
            a.fail_inflight("member dead")
            return seen

        assert _both(run) == [False]

    def test_token_events_reach_a_streaming_sink_at_once(self):
        """A streaming sink hands tokens on at ``flush()`` (the port's
        runner flushes once an engine step); the proxy flushes each
        token event, so a remote stream's first token is not held back
        until its end."""
        import queue

        from distributed_inference_server_tpu_torch.serving.streamer import (
            StreamingSink,
        )

        r, _ = _remote(PORT)
        channel = queue.Queue()
        req = ServerRequest("r1", [1, 2, 3], SamplingParams(max_tokens=8),
                            StreamingSink(channel))
        r.submit([req])
        r.on_event(dict(_EVENTS[0]))
        ((idx, ev),) = channel.get_nowait()
        assert (idx, ev.token, ev.index) == (0, "a", 0)
        r.on_event(dict(_EVENTS[1]))
        items = channel.get_nowait()
        assert [e is None for _, e in items] == [False, True]

    def test_no_kv_import_without_a_data_channel(self):
        r, _ = _remote(PORT)
        jr, _ = _remote(JAX)
        assert r.kv_channel is None and jr.kv_channel is None
        assert r.supports_kv_import is False
        assert jr.supports_kv_import is False  # no data channel wired
        assert r.status().data_plane is False


# ---------------------------------------------------------------------------
# remote-aware routing
# ---------------------------------------------------------------------------


def _plan(pkg, statuses, hashes):
    p = pkg.sched.plan_route([pkg.status(**s) for s in statuses], hashes)
    return None if p is None else (p.engine_id, p.decision, p.peer_id,
                                   p.depth, p.peer_depth)


_HASHES = (11, 12, 13, 14)
_ROUTING_CASES = {
    # the remote's heartbeated digest wins warm routing
    "remote_warm": [dict(engine_id="w1:e0", remote=True, digest=_HASHES),
                    dict(engine_id="local")],
    # a control-plane-only remote never sources a fetch
    "busy_remote_warm": [dict(engine_id="w1:e0", remote=True,
                              digest=_HASHES, active=50, waiting=50),
                         dict(engine_id="local")],
    # a remote replica is never a fetch target
    "remote_cold": [dict(engine_id="warm", digest=_HASHES, active=50,
                         waiting=50),
                    dict(engine_id="w1:cold", remote=True)],
    # a data-plane remote peer sources a fetch onto a local target
    "data_plane_peer": [dict(engine_id="w1:warm", remote=True,
                             data_plane=True, digest=_HASHES, active=50,
                             waiting=50),
                        dict(engine_id="local")],
    # local peer before remote at equal depth
    "local_peer_first": [dict(engine_id="w1:warm", remote=True,
                              data_plane=True, digest=_HASHES),
                         dict(engine_id="warm", digest=_HASHES, active=9),
                         dict(engine_id="cold")],
}


class TestRemoteRouting:
    @pytest.mark.parametrize("case", sorted(_ROUTING_CASES))
    def test_plan_route_matches_jax(self, case):
        statuses = _ROUTING_CASES[case]
        plan = _both(lambda pkg: _plan(pkg, statuses, _HASHES))
        if case == "remote_warm":
            assert plan[:2] == ("w1:e0", "warm")
        if case == "busy_remote_warm":
            assert plan[1] in ("warm", "recompute")
        if case == "remote_cold" and plan[0] == "w1:cold":
            assert plan[1] != "fetch"
        if case == "data_plane_peer":
            assert plan[:3] == ("local", "fetch", "w1:warm")

    def test_schedule_decode_skips_control_plane_remotes(self):
        class _R:
            def __init__(self, pkg, eid, role, remote=False):
                self.engine_id, self.is_remote = eid, remote
                self._s = pkg.status(engine_id=eid, role=role, remote=remote)

            def status(self):
                return self._s

        def run(pkg):
            sched = pkg.sched.AdaptiveScheduler()
            sched.register(_R(pkg, "w1:d", "decode", remote=True))
            first = sched.schedule_decode()
            sched.register(_R(pkg, "d", "decode"))
            return first, sched.schedule_decode().engine_id

        assert _both(run) == (None, "d")


# ---------------------------------------------------------------------------
# RoleBalancer
# ---------------------------------------------------------------------------


class _FakeRunner:
    def __init__(self, pkg, engine_id, role, healthy=True, waiting=0,
                 remote=False):
        self.pkg, self.engine_id, self.role = pkg, engine_id, role
        self.healthy, self.waiting = healthy, waiting
        self.is_remote = remote

    def is_healthy(self):
        return self.healthy

    def set_role(self, role):
        self.role = role

    def status(self):
        return self.pkg.status(self.engine_id, healthy=self.healthy,
                               role=self.role, waiting=self.waiting,
                               remote=self.is_remote)


class _FakeScheduler:
    def __init__(self, runners):
        self._runners = runners

    def engines(self):
        return list(self._runners)

    def statuses(self):
        return [r.status() for r in self._runners]

    def get(self, engine_id):
        return next((r for r in self._runners if r.engine_id == engine_id),
                    None)


class _FakeDispatcher:
    def __init__(self, depth=0):
        self.depth = depth
        self.queue = self

    def total_depth(self):
        return self.depth


def _balancer(pkg, specs, depth=0, cooldown=0.0):
    runners = [_FakeRunner(pkg, *spec) for spec in specs]
    settings = pkg.fleet.FleetSettings(
        rerole=True, rerole_high_ratio=4.0, rerole_low_ratio=1.0,
        rerole_cooldown_s=cooldown)
    disp = _FakeDispatcher(depth)
    bal = pkg.fleet.RoleBalancer(_FakeScheduler(runners), disp, settings,
                                 metrics=pkg.metrics_cls())
    return bal, disp, runners


# each case: runner specs, then (queue depth, runner edits, flag) per step
_BALANCER_CASES = {
    "flip_and_back": ([("e0", "unified"), ("e1", "decode")],
                      [(10, {}, False), (0, {}, False)], 0.0),
    "hysteresis_band": ([("e0", "unified"), ("e1", "decode")],
                        [(10, {}, False), (3, {}, False)], 0.0),
    "cooldown": ([("e0", "unified"), ("e1", "decode")],
                 [(10, {}, False), (0, {}, False)], 60.0),
    "operator_roles": ([("e0", "prefill"), ("e1", "decode")],
                       [(0, {}, False)], 0.0),
    "no_decode": ([("e0", "unified")], [(100, {}, False)], 0.0),
    "flag_forces_signal": ([("e0", "unified"), ("e1", "decode")],
                           [(0, {}, True)], 0.0),
    "remote_decode_no_flip": ([("e0", "unified"),
                               ("w1:e1", "decode", True, 0, True)],
                              [(100, {}, False)], 0.0),
    "remote_never_flipped": ([("w1:e0", "unified", True, 0, True),
                              ("e1", "decode")], [(100, {}, False)], 0.0),
    "restore_without_decode": ([("e0", "unified"), ("e1", "decode")],
                               [(10, {}, False), (0, {1: False}, False)],
                               0.0),
}


class TestRoleBalancer:
    @pytest.mark.parametrize("case", sorted(_BALANCER_CASES))
    def test_decisions_match_jax(self, case):
        specs, steps, cooldown = _BALANCER_CASES[case]

        def run(pkg):
            bal, disp, runners = _balancer(pkg, specs, cooldown=cooldown)
            out = []
            for depth, edits, flag in steps:
                disp.depth = depth
                for idx, healthy in edits.items():
                    runners[idx].healthy = healthy
                if flag:
                    pkg.arm("sched.rerole:nth=1")
                out.append((bal.evaluate(), [r.role for r in runners]))
                pkg.faults.clear()
            stats = bal.stats()
            for h in stats["history"]:
                h.pop("t")
            return (out, stats, bal.metrics.fleet_counters()["reroles"],
                    bal._role_counts())

        out, stats, reroles, role_counts = _both(run)
        if case == "flip_and_back":
            assert [d for d, _ in out] == ["to_prefill", "to_unified"]
            assert reroles == {"to_prefill": 1, "to_unified": 1}
        if case in ("hysteresis_band", "cooldown"):
            assert out[1] == (None, ["prefill", "decode"])
        if case in ("operator_roles", "no_decode", "remote_decode_no_flip",
                    "remote_never_flipped"):
            assert out == [(None, [r[1] for r in specs])]
        if case == "restore_without_decode":
            assert out[1][0] == "to_unified"
        if case == "remote_decode_no_flip":
            assert role_counts == {"unified": 1}

    def test_stats_and_history(self):
        def run(pkg):
            bal, _, _ = _balancer(pkg, [("e0", "unified"), ("e1", "decode")],
                                  depth=10)
            bal.evaluate()
            stats = bal.stats()
            return stats["flipped"], [
                (h["engine_id"], h["direction"], h["signal"])
                for h in stats["history"]]

        assert _both(run) == (["e0"], [("e0", "to_prefill", 10.0)])


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

_FLEET_FIELDS = ("enabled", "host", "port", "connect", "member_id",
                 "heartbeat_interval_s", "suspect_after_s", "dead_after_s",
                 "rerole", "rerole_high_ratio", "rerole_low_ratio",
                 "rerole_cooldown_s", "rerole_interval_s")


class TestFleetConfig:
    @pytest.mark.parametrize("env", [
        {},
        {"DIS_TPU_FLEET__ENABLED": "true", "DIS_TPU_FLEET__PORT": "7001",
         "DIS_TPU_FLEET__REROLE": "true",
         "DIS_TPU_FLEET__REROLE_HIGH_RATIO": "8.0"},
        {"DIS_TPU_FLEET__CONNECT": "10.0.0.2:9000",
         "DIS_TPU_FLEET__MEMBER_ID": "w7",
         "DIS_TPU_FLEET__HEARTBEAT_INTERVAL_S": "0.2"},
    ])
    def test_fleet_settings_mapping(self, env):
        p = ServerConfig.load(environ=env).fleet_settings()
        j = JServerConfig.load(environ=env).fleet_settings()
        assert {f: getattr(p, f) for f in _FLEET_FIELDS} == {
            f: getattr(j, f) for f in _FLEET_FIELDS}
        ServerConfig.load(environ=env).check_ported()
        if env.get("DIS_TPU_FLEET__PORT"):
            assert p.enabled and p.port == 7001 and p.rerole
            assert p.rerole_high_ratio == 8.0

    @pytest.mark.parametrize("env", [
        {"DIS_TPU_FLEET__SUSPECT_AFTER_S": "0.1"},  # <= heartbeat
        {"DIS_TPU_FLEET__DEAD_AFTER_S": "1.0"},  # <= suspect
        {"DIS_TPU_FLEET__REROLE_LOW_RATIO": "9.0"},  # >= high
        {"DIS_TPU_FLEET__CONNECT": "nonsense"},
    ])
    def test_validation_rejects(self, env):
        with pytest.raises(ConfigError) as e:
            ServerConfig.load(environ=env)
        with pytest.raises(JConfigError) as je:
            JServerConfig.load(environ=env)
        assert str(e.value) == str(je.value)

    @pytest.mark.parametrize("env,key", [
        ({"DIS_TPU_FLEET__REGISTRIES": "127.0.0.1:7001,127.0.0.1:7002"},
         "fleet.registries"),
        ({"DIS_TPU_SERVER__GRPC_PORT": "50051"}, "server.grpc_port"),
    ])
    def test_check_ported_still_refuses(self, env, key):
        """Both keys are ported: registry HA's ``fleet.registries`` is
        accepted and maps to the JAX settings, and ``server.grpc_port``
        passes where ``grpc`` imports (the gRPC transport), with the JAX
        value."""
        if key == "server.grpc_port":
            pytest.importorskip("grpc")
        cfg = ServerConfig.load(environ=env)
        cfg.check_ported()
        if key == "fleet.registries":
            assert cfg.fleet_settings().registries == (
                JServerConfig.load(environ=env).fleet_settings().registries)
            return
        assert cfg.get("server", "grpc_port") == 50051 == (
            JServerConfig.load(environ=env).get("server", "grpc_port"))


class TestSchedulerUnregisterIf:
    def test_identity_checked_unregister_spares_the_new_proxy(self):
        def run(pkg):
            sched = pkg.sched.AdaptiveScheduler()
            old, _ = _remote(pkg)
            new, _ = _remote(pkg)
            sched.register(old)
            sched.register(new)
            return (sched.unregister_if(old.engine_id, old) is None,
                    sched.get(new.engine_id) is new,
                    sched.unregister_if(new.engine_id, new) is new,
                    sched.get(new.engine_id) is None)

        assert _both(run) == (True, True, True, True)
