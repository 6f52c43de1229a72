"""The fleet's KV data plane on the port against the JAX package's
(``serving/fleet_kv.py``): the port's counterparts of ``tests/test_fleet.py``
``TestKvDataPlaneRouting``, ``TestKvDataChannelWire``,
``TestCrossHostHandoffE2E``, ``TestRemoteFetchE2E``, ``TestKvFleetConfig``,
``TestKvIntroBrokerFault`` and ``TestDialConfigureFailure``.

- The data wire: every KV frame kind the port writes is byte-equal to the
  JAX ``send_kv_frame``'s for the same object, each package decodes the
  other's, and the chunk and export-state dicts are the JAX package's.
- The channel over real localhost TCP with a member-side runner double:
  port channel to port server, JAX channel to port server and port channel
  to JAX server, each with the reference's cases (fetch, open and commit
  with the event pump, the stream window, the dial and chunk faults, the
  channel's death, the abort).
- Remote-aware routing and the handoff election against the JAX functions.
- One TINY f32 fleet per topology (a port registry host and a port member
  joined over real TCP, control wire and data channel): a request that
  prefills on the host and decodes on the member, and one whose prefix the
  member serves over the wire, give the JAX engine's greedy tokens, on the
  ``none`` and ``int8`` wires; a torn stream decodes in place or
  recomputes, once, with clean page audits on both sides.
- Latent-wire chunks cross the data frames reordered and seat with the
  JAX engine's tokens (the mesh case of ``tests/test_latent_kv.py``).
"""

from __future__ import annotations

import dataclasses
import re
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.core.errors import (
    ConfigError as JConfigError,
)
from distributed_inference_server_tpu.engine import engine as jeng
from distributed_inference_server_tpu.engine import kv_cache as jkv
from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models import tokenizer as jtok
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu.serving import disagg as jdisagg
from distributed_inference_server_tpu.serving import faults as jfaults
from distributed_inference_server_tpu.serving import fleet as jfleet
from distributed_inference_server_tpu.serving import fleet_kv as jfkv
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
from distributed_inference_server_tpu_torch.core.errors import ConfigError
from distributed_inference_server_tpu_torch.engine import engine as peng
from distributed_inference_server_tpu_torch.engine import kv_cache as pkv
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
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
from distributed_inference_server_tpu_torch.serving import disagg as pdisagg
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving import fleet as pfleet
from distributed_inference_server_tpu_torch.serving import fleet_kv as pfkv
from distributed_inference_server_tpu_torch.serving import (
    remote_runner as premote,
)
from distributed_inference_server_tpu_torch.serving import scheduler as psched
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
from distributed_inference_server_tpu_torch.serving.scheduler import (
    SchedulingStrategy,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)

PKGS = {
    "port": dict(fkv=pfkv, faults=faults, eng=peng, kv=pkv),
    "jax": dict(fkv=jfkv, faults=jfaults, eng=jeng, kv=jkv),
}


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    faults.clear()
    jfaults.clear()


# ---------------------------------------------------------------------------
# the data wire
# ---------------------------------------------------------------------------


def _payload(n: int = 96, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _chunk(kv, i=0, total=2, payload=None):
    payload = _payload(seed=i) if payload is None else payload
    return kv.KvChunk(index=i, total=total, page_start=i, page_count=1,
                      payload=payload, crc32=kv.chunk_crc(payload))


def _export(eng, kv, chunks=True, draft=False):
    return eng.SequenceExport(
        request_id="r1", token_ids=[1, 2, 3, 4], prompt_len=3, seq_len=4,
        next_token=9,
        params=eng.SamplingParams(max_tokens=8, temperature=0.5, top_p=0.9,
                                  stop_sequences=("zz",)),
        output_text="abc", emitted_upto=3, emitted_tokens=1,
        pending_ids=[7], kv=b"" if chunks else _payload(40),
        draft_kv=_payload(16, 3) if draft else None, source_engine="e0",
        kv_chunks=[_chunk(kv, 0, 1)] if chunks else None)


_FRAMES = [
    ("KvHandoffHeader", {"handoff_id": "r1", "request_id": "r1",
                         "wire_quant": "int8", "op": "open",
                         "engine_id": "e0", "prefix_pages": 4,
                         "total_chunks": 2, "trace_id": "t" * 32,
                         "parent_span_id": "s" * 16}),
    ("KvPrefixFetch", {"request_id": "r2", "hashes": [11, 2**63 - 1, 7],
                       "chunk_pages": 8, "wire_quant": "none",
                       "engine_id": "engine-0"}),
    ("KvStreamResult", {"stream_id": "r3", "op": "fetch", "ok": True,
                        "error": "", "depth": 5}),
    ("KvStreamResult", {"stream_id": "r4", "op": "abort", "ok": True,
                        "engine_id": "e0"}),
    ("FleetEvent", {"request_id": "r5", "engine_id": "e0", "kind": "token",
                    "text": "hi", "token_index": 3, "token_id": 42,
                    "logprob": -0.5}),
    ("FleetEvent", {"request_id": "r5", "engine_id": "e0", "kind": "done",
                    "finish_reason": "length", "prompt_tokens": 3,
                    "completion_tokens": 8}),
]


def _frame_cases():
    cases = list(_FRAMES)
    cases.append(("KvChunk", pfkv.chunk_to_wire("r1", _chunk(pkv, 1))))
    for chunks in (True, False):
        for draft in (False, True):
            cases.append(("KvHandoff", pfkv._export_state_to_wire(
                _export(peng, pkv, chunks, draft))))
    return cases


def _sent(fkv, name, obj) -> bytes:
    a, b = socket.socketpair()
    try:
        n = fkv.send_kv_frame(a, name, obj)
        out = b.recv(1 << 20)
        while len(out) < n:
            out += b.recv(1 << 20)
        return out
    finally:
        a.close()
        b.close()


class TestKvWire:
    def test_kind_table_is_the_jax_table(self):
        assert pfkv.KV_FRAME_KINDS == jfkv.KV_FRAME_KINDS
        assert pfkv.MAX_KV_FRAME_BYTES == jfkv.MAX_KV_FRAME_BYTES

    @pytest.mark.parametrize("name,obj", _frame_cases(),
                             ids=lambda v: v if isinstance(v, str) else "")
    def test_frames_byte_equal_and_cross_decode(self, name, obj):
        port_bytes = _sent(pfkv, name, obj)
        assert port_bytes == _sent(jfkv, name, obj)
        for reader in (pfkv, jfkv):  # each package reads the other's
            a, b = socket.socketpair()
            try:
                a.sendall(port_bytes)
                got = reader.recv_kv_frame(b)
            finally:
                a.close()
                b.close()
            assert got == (name, jpw.decode(name, port_bytes[5:]))

    def test_chunk_and_export_state_dicts_are_the_jax_dicts(self):
        for i in range(2):
            assert (pfkv.chunk_to_wire("h", _chunk(pkv, i))
                    == jfkv.chunk_to_wire("h", _chunk(jkv, i)))
        for chunks in (True, False):
            for draft in (False, True):
                p = pfkv._export_state_to_wire(
                    _export(peng, pkv, chunks, draft))
                j = jfkv._export_state_to_wire(
                    _export(jeng, jkv, chunks, draft))
                assert p == j
                back = pfkv._export_state_from_wire(p)
                ref = jfkv._export_state_from_wire(j)
                for f in ("request_id", "token_ids", "prompt_len", "seq_len",
                          "next_token", "output_text", "emitted_upto",
                          "emitted_tokens", "pending_ids", "kv", "draft_kv",
                          "source_engine"):
                    assert getattr(back, f) == getattr(ref, f)
                assert (dataclasses.asdict(back.params)
                        == dataclasses.asdict(ref.params))
        c = pfkv.chunk_from_wire(pfkv.chunk_to_wire("h", _chunk(pkv, 1)))
        assert c == _chunk(pkv, 1)

    def test_malformed_frames_raise(self):
        import struct

        for header in (struct.pack(">IB", 4, 99),
                       struct.pack(">IB", pfkv.MAX_KV_FRAME_BYTES + 1, 2)):
            a, b = socket.socketpair()
            try:
                a.sendall(header)
                with pytest.raises(pfkv.KvWireError):
                    pfkv.recv_kv_frame(b)
            finally:
                a.close()
                b.close()


# ---------------------------------------------------------------------------
# the channel over localhost TCP, both packages on either end
# ---------------------------------------------------------------------------


class _FakeKvRunner:
    """Member-side runner double: serves the import and export calls
    synchronously (the real one posts to its inbox)."""

    def __init__(self, engine_id="e0"):
        self.engine_id = engine_id
        self.opened = {}
        self.committed = []
        self.aborted = []
        self.export_result = None  # (depth, chunks) | None
        self.export_error = None
        self.on_commit_req = None

    def is_healthy(self):
        return True

    def submit_prefix_export(self, rid, hashes, chunk_pages, wire_quant,
                             on_done, trace=None):
        if self.export_error is not None:
            on_done(None, self.export_error)
        else:
            on_done(self.export_result, None)

    def submit_import_open(self, rid, prefix_pages, chunks, on_done):
        self.opened[rid] = (prefix_pages, list(chunks))
        on_done(True, None)

    def submit_import_commit(self, exp, req, on_done):
        self.committed.append(exp)
        self.on_commit_req = req
        on_done(True, None)

    def submit_resume(self, exp, req, on_done):
        self.committed.append(exp)
        self.on_commit_req = req
        on_done(True, None)

    def submit_import_abort(self, rid):
        self.aborted.append(rid)

    def abort(self, rid):
        self.aborted.append(("abort", rid))


class _FakeKvScheduler:
    def __init__(self, runner):
        self._runner = runner

    def get(self, engine_id):
        return self._runner if engine_id == self._runner.engine_id else None


_ENDS = [("port", "port"), ("jax", "port"), ("port", "jax")]


@pytest.fixture(params=_ENDS, ids=lambda e: f"{e[0]}-channel-{e[1]}-server")
def kv_wire(request):
    chan_pkg, srv_pkg = (PKGS[p] for p in request.param)
    runner = _FakeKvRunner()
    server = srv_pkg["fkv"].KvDataServer(_FakeKvScheduler(runner),
                                         host="127.0.0.1")
    server.start()
    events, lost = [], []
    channel = chan_pkg["fkv"].KvDataChannel(
        "w1", "127.0.0.1", server.bound_port, max_streams=2,
        on_event=events.append,
        on_lost_requests=lambda rids, reason: lost.append((rids, reason)))
    yield dict(channel=channel, server=server, runner=runner, events=events,
               lost=lost, chan=chan_pkg, srv=srv_pkg)
    channel.close()
    server.stop()


def _cb_box():
    box = {"ev": threading.Event(), "args": None}

    def cb(*args):
        box["args"] = args
        box["ev"].set()

    return box, cb


def _wait(box, timeout=15.0):
    assert box["ev"].wait(timeout), "stream never resolved"
    return box["args"]


def _until(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        time.sleep(0.02)
    return pred()


class TestKvDataChannelWire:
    def test_fetch_round_trip(self, kv_wire):
        w = kv_wire
        chunks = [_chunk(w["srv"]["kv"], i, 3) for i in range(3)]
        w["runner"].export_result = (3, chunks)
        box, cb = _cb_box()
        w["channel"].fetch_prefix("r1", "e0", [1, 2, 3], 8, "none", None, cb)
        result, err = _wait(box)
        assert err is None
        depth, got = result
        assert depth == 3
        # the KVP1 payloads cross byte for byte, crc included
        assert [c.payload for c in got] == [c.payload for c in chunks]
        assert [c.crc32 for c in got] == [c.crc32 for c in chunks]

    def test_fetch_export_failure_resolves_stream(self, kv_wire):
        w = kv_wire
        w["runner"].export_error = "chain evicted"
        box, cb = _cb_box()
        w["channel"].fetch_prefix("r1", "e0", [1], 8, "none", None, cb)
        result, err = _wait(box)
        assert result is None and "chain evicted" in err

    def test_open_commit_and_event_pump(self, kv_wire):
        w = kv_wire
        kv, eng = w["chan"]["kv"], w["chan"]["eng"]
        prefix = [_chunk(kv, i) for i in range(2)]
        box, cb = _cb_box()
        w["channel"].import_open("r1", "e0", 4, "none", prefix, None, cb)
        assert _wait(box)[0] is True
        assert w["runner"].opened["r1"][0] == 4
        assert ([c.payload for c in w["runner"].opened["r1"][1]]
                == [c.payload for c in prefix])
        exp = _export(eng, kv)
        box2, cb2 = _cb_box()
        w["channel"].import_commit(exp, "e0", None, cb2)
        assert _wait(box2)[0] is True
        got = w["runner"].committed[0]
        assert got.token_ids == [1, 2, 3, 4] and got.next_token == 9
        assert [c.payload for c in got.kv_chunks] == [
            c.payload for c in exp.kv_chunks]
        # the member-side request streams its events back
        w["runner"].on_commit_req.sink.on_token(42, "hi", 4)
        w["runner"].on_commit_req.sink.on_done("stop", None)
        assert _until(lambda: len(w["events"]) >= 2)
        assert [e["kind"] for e in w["events"]] == ["token", "done"]
        assert w["events"][0]["token_id"] == 42
        assert w["channel"].stats()["event_requests"] == 0

    def test_window_full_fails_fast(self, kv_wire):
        w = kv_wire
        w["runner"].submit_prefix_export = lambda *a, **k: None  # stalls
        boxes = []
        for i in range(2):
            box, cb = _cb_box()
            boxes.append(box)
            w["channel"].fetch_prefix(f"r{i}", "e0", [1], 8, "none", None,
                                      cb)
        box3, cb3 = _cb_box()
        w["channel"].fetch_prefix("r2", "e0", [1], 8, "none", None, cb3)
        result, err = _wait(box3)
        assert result is None and "window full" in err
        assert not boxes[0]["ev"].is_set()

    def test_connect_fault_fails_stream(self, kv_wire):
        w = kv_wire
        f = w["chan"]["faults"]
        f.install(f.parse_spec("fleet.kv_connect:nth=1", 7))
        box, cb = _cb_box()
        w["channel"].fetch_prefix("r1", "e0", [1], 8, "none", None, cb)
        result, err = _wait(box)
        assert result is None and err

    def test_chunk_fault_tears_stream(self, kv_wire):
        w = kv_wire
        f = w["chan"]["faults"]
        f.install(f.parse_spec("fleet.kv_chunk:nth=1", 7))
        box, cb = _cb_box()
        w["channel"].import_open("r1", "e0", 2, "none",
                                 [_chunk(w["chan"]["kv"], i)
                                  for i in range(2)], None, cb)
        assert _wait(box)[0] is False
        assert "r1" not in w["runner"].opened

    def test_channel_death_fails_event_requests(self, kv_wire):
        w = kv_wire
        exp = dataclasses.replace(_export(w["chan"]["eng"], w["chan"]["kv"]),
                                  request_id="r9")
        box, cb = _cb_box()
        w["channel"].resume(exp, "e0", None, cb)
        assert _wait(box)[0] is True
        assert w["channel"].stats()["event_requests"] == 1
        w["server"].stop()  # the link dies under the decode
        assert _until(lambda: w["lost"])
        assert w["lost"][0][0] == ["r9"]
        assert ("abort", "r9") in w["runner"].aborted  # the orphan goes

    def test_import_abort_reaches_member(self, kv_wire):
        w = kv_wire
        box, cb = _cb_box()
        w["channel"].import_open("r1", "e0", 2, "none",
                                 [_chunk(w["chan"]["kv"], i)
                                  for i in range(2)], None, cb)
        _wait(box)
        w["channel"].import_abort("r1", "e0")
        assert _until(lambda: "r1" in w["runner"].aborted)

    def test_breaker_opens_and_stats_track_bytes(self, kv_wire):
        w = kv_wire
        ch = w["chan"]["fkv"].KvDataChannel(
            "dead", "127.0.0.1", 1, breaker_threshold=1, breaker_open_s=60.0)
        try:
            box, cb = _cb_box()
            ch.fetch_prefix("r1", "e0", [1], 8, "none", None, cb)
            assert _wait(box)[0] is None
            assert not ch.wire_available()  # election skips the member
            box2, cb2 = _cb_box()
            ch.fetch_prefix("r2", "e0", [1], 8, "none", None, cb2)
            assert "circuit open" in _wait(box2)[1]
        finally:
            ch.close()
        w["runner"].export_result = (1, [_chunk(w["srv"]["kv"], 0, 1)])
        box3, cb3 = _cb_box()
        w["channel"].fetch_prefix("r3", "e0", [1], 8, "none", None, cb3)
        _wait(box3)
        st = w["channel"].stats()
        assert st["connected"] and st["bytes_sent"] > 0
        assert st["bytes_received"] == 96 and st["breaker"]["state"] == (
            "closed")


# ---------------------------------------------------------------------------
# routing and the handoff election
# ---------------------------------------------------------------------------


def _status(pkg, eid, role="unified", remote=False, digest=None,
            data_plane=False, active=0):
    cls = EngineStatus if pkg == "port" else JEngineStatus
    return cls(engine_id=eid, healthy=True, active_requests=active,
               waiting_requests=0, total_processed=0, memory_used_pages=0,
               memory_total_pages=100, prefix_digest=digest, page_size=8,
               role=role, digest_depth=8, remote=remote,
               data_plane=data_plane)


def _plan(pkg, specs, hashes, **costs):
    mod = psched if pkg == "port" else jsched
    plan = mod.plan_route([_status(pkg, **s) for s in specs], hashes,
                          costs=mod.FetchCosts(**costs) if costs else None)
    return (plan.engine_id, plan.decision, plan.peer_id) if plan else None


_HASHES = (11, 12, 13, 14)
_ROUTES = [
    # a remote warm peer with a data channel sources a fetch onto the
    # local cold target
    ([dict(eid="w1:e0", remote=True, digest=_HASHES, data_plane=True,
           active=9), dict(eid="local")], {}),
    # without a data channel it never sources
    ([dict(eid="w1:e0", remote=True, digest=_HASHES, active=9),
      dict(eid="local")], {}),
    # a local peer before a remote one at equal depth
    ([dict(eid="w1:e0", remote=True, digest=_HASHES, data_plane=True),
      dict(eid="peer", digest=_HASHES, active=9), dict(eid="local")], {}),
    # fleet.kv_page_cost prices the wire: cheap fetches, dear recomputes
    ([dict(eid="w1:e0", remote=True, digest=_HASHES, data_plane=True,
           active=9), dict(eid="local")], {"remote_page_cost": 0.5}),
    ([dict(eid="w1:e0", remote=True, digest=_HASHES, data_plane=True,
           active=9), dict(eid="local")], {"remote_page_cost": 5.0}),
]


class TestKvDataPlaneRouting:
    @pytest.mark.parametrize("specs,costs", _ROUTES)
    def test_plan_route_matches_jax(self, specs, costs):
        assert (_plan("port", specs, _HASHES, **costs)
                == _plan("jax", specs, _HASHES, **costs))

    def test_reference_decisions(self):
        assert _plan("port", *_ROUTES[0][:1], _HASHES) == (
            "local", "fetch", "w1:e0")
        assert _plan("port", _ROUTES[1][0], _HASHES)[1] in ("warm",
                                                            "recompute")
        assert _plan("port", _ROUTES[3][0], _HASHES,
                     **_ROUTES[3][1])[1] == "fetch"
        assert _plan("port", _ROUTES[4][0], _HASHES,
                     **_ROUTES[4][1])[1] != "fetch"

    @pytest.mark.parametrize("pkg", ["port", "jax"])
    def test_schedule_decode_and_decode_targets(self, pkg):
        """A member's decode replica is a handoff target exactly while it
        has a data channel whose breaker is closed (both packages)."""
        sched_mod = psched if pkg == "port" else jsched
        remote_mod = premote if pkg == "port" else jremote
        disagg_mod = pdisagg if pkg == "port" else jdisagg
        sched = sched_mod.AdaptiveScheduler()
        ctrl = disagg_mod.DisaggController(sched)
        runner = remote_mod.RemoteRunner("w1:e0", "e0", lambda n, o: None)
        runner.update_status(_status(pkg, "w1:e0", role="decode",
                                     remote=True))
        sched.register(runner)
        assert sched.schedule_decode() is None
        assert not ctrl.has_decode_targets()

        class _Chan:
            available = True

            def wire_available(self):
                return self.available

        runner.kv_channel = _Chan()
        assert sched.schedule_decode() is runner
        assert ctrl.has_decode_targets()
        assert runner.status().data_plane is True
        runner.kv_channel.available = False  # an open breaker
        assert sched.schedule_decode() is None
        assert not ctrl.has_decode_targets()

    @pytest.mark.parametrize("remote_cost,local_load", [
        (None, 0), (None, 3), (0.01, 3), (50.0, 1)])
    def test_wire_priced_election_matches_jax(self, remote_cost, local_load):
        """With ``wire_cost`` and ``pages``, a remote decode candidate is
        charged its wire: the same pick as the JAX scheduler's."""
        picks = []
        for pkg in ("port", "jax"):
            sched_mod = psched if pkg == "port" else jsched
            sched = sched_mod.AdaptiveScheduler()

            class _R:
                is_remote = False
                supports_kv_import = True

                def __init__(self, status):
                    self.engine_id = status.engine_id
                    self._s = status
                    self.is_remote = status.remote

                def status(self):
                    return self._s

            sched.register(_R(_status(pkg, "local", role="decode",
                                      active=local_load)))
            sched.register(_R(_status(pkg, "w1:e0", role="decode",
                                      remote=True, data_plane=True)))
            sched.wire_cost = lambda t, p, c=remote_cost: c
            picks.append(sched.schedule_decode(pages=8).engine_id)
        assert picks[0] == picks[1]


# ---------------------------------------------------------------------------
# config, the intro broker's fault and the dial path
# ---------------------------------------------------------------------------

_KV_FIELDS = ("kv_enabled", "kv_data_port", "kv_max_streams",
              "kv_connect_timeout_s", "mesh_enabled", "kv_rate_window_s",
              "kv_rate_prior", "registries", "lease_s", "lease_suspect_s",
              "standby_http")


class TestKvFleetConfig:
    @pytest.mark.parametrize("env", [
        {},
        {"DIS_TPU_FLEET__KV_DATA_PORT": "40100",
         "DIS_TPU_FLEET__KV_PAGE_COST": "0.9",
         "DIS_TPU_FLEET__KV_MAX_STREAMS": "2",
         "DIS_TPU_FLEET__KV_CONNECT_TIMEOUT_S": "2.5",
         "DIS_TPU_FLEET__KV_ENABLED": "false"},
        {"DIS_TPU_FLEET__MESH_ENABLED": "true",
         "DIS_TPU_FLEET__KV_RATE_PRIOR": "1000",
         "DIS_TPU_FLEET__REGISTRIES": "127.0.0.1:7001,127.0.0.1:7002",
         "DIS_TPU_FLEET__LEASE_S": "2.0",
         "DIS_TPU_FLEET__STANDBY_HTTP": "false"},
    ])
    def test_kv_settings_mapping(self, env):
        p = ServerConfig.load(environ=env)
        j = JServerConfig.load(environ=env)
        assert ({f: getattr(p.fleet_settings(), f) for f in _KV_FIELDS}
                == {f: getattr(j.fleet_settings(), f) for f in _KV_FIELDS})
        assert (p.fetch_costs().remote_page_cost
                == j.fetch_costs().remote_page_cost)
        p.check_ported()

    @pytest.mark.parametrize("env", [
        {"DIS_TPU_FLEET__KV_DATA_PORT": "70000"},
        {"DIS_TPU_FLEET__KV_PAGE_COST": "-1"},
        {"DIS_TPU_FLEET__KV_MAX_STREAMS": "0"},
        {"DIS_TPU_FLEET__KV_CONNECT_TIMEOUT_S": "0"},
        {"DIS_TPU_FLEET__REGISTRIES": "nonsense"},
        {"DIS_TPU_FLEET__REGISTRIES": "127.0.0.1:7001",
         "DIS_TPU_FLEET__LEASE_SUSPECT_S": "0.1"},
    ])
    def test_kv_validation_rejects(self, env):
        with pytest.raises(ConfigError) as e:
            ServerConfig.load(environ=env)
        with pytest.raises(JConfigError) as je:
            JServerConfig.load(environ=env)
        assert str(e.value) == str(je.value)

    def test_fleet_relaxes_single_sided_role_topologies(self):
        for env in ({"DIS_TPU_SERVER__ENGINE_ROLES": "prefill"},
                    {"DIS_TPU_SERVER__ENGINE_ROLES": "decode"}):
            with pytest.raises(ConfigError):
                ServerConfig.load(environ=env)
        host = ServerConfig.load(environ={
            "DIS_TPU_SERVER__ENGINE_ROLES": "prefill",
            "DIS_TPU_FLEET__ENABLED": "true"})
        assert host.engine_roles() == ["prefill"]
        worker = ServerConfig.load(environ={
            "DIS_TPU_SERVER__ENGINE_ROLES": "decode",
            "DIS_TPU_FLEET__CONNECT": "127.0.0.1:9999"})
        assert worker.engine_roles() == ["decode"]

    def test_worker_mode(self):
        """A member joins with ``fleet.connect`` or with ``fleet.registries``
        alone; a registry given the list runs the election and does not
        join as its own member (the JAX entry point would start a worker
        there too: ``ROADMAP.md`` queue 3)."""
        from distributed_inference_server_tpu_torch.__main__ import (
            worker_mode,
        )

        regs = "127.0.0.1:7001,127.0.0.1:7002"
        cases = [
            ({}, False),
            ({"DIS_TPU_FLEET__CONNECT": "127.0.0.1:7001"}, True),
            ({"DIS_TPU_FLEET__REGISTRIES": regs}, True),
            ({"DIS_TPU_FLEET__REGISTRIES": regs,
              "DIS_TPU_FLEET__ENABLED": "true"}, False),
        ]
        for env, want in cases:
            cfg = ServerConfig.load(environ=env)
            assert worker_mode(cfg) is want
            # the JAX entry point's condition (__main__.py:292)
            jax_worker = bool(cfg.get("fleet", "connect")
                              or cfg.get("fleet", "registries"))
            assert jax_worker == (want or bool(env.get(
                "DIS_TPU_FLEET__REGISTRIES")))


class _IntroSession:
    member_id = "m-intro"

    def __init__(self):
        self.sent = []

    def send(self, name, obj):
        self.sent.append((name, obj))


class TestKvIntroBrokerFault:
    @pytest.mark.parametrize("pkg", ["port", "jax"])
    def test_injected_intro_drop_counts_dropped_and_recovers(self, pkg):
        fleet_mod, metrics_cls, f = (
            (pfleet, MetricsCollector, faults) if pkg == "port"
            else (jfleet, JMetrics, jfaults))

        class _Broker:
            metrics = metrics_cls()
            ha = None
            _send_intro = fleet_mod.FleetServer._send_intro

        broker = _Broker()
        session = _IntroSession()
        f.install(f.parse_spec("fleet.kv_intro:nth=1", seed=9))
        broker._send_intro(session, {"member_id": "m2"})
        broker._send_intro(session, {"member_id": "m2"})
        assert len(session.sent) == 1
        assert broker.metrics.fleet_counters()["kv_intros"] == {
            "dropped": 1, "sent": 1}


class _ConfigFailSock:
    """Dialed, then configuring it fails."""

    def __init__(self):
        self.closed = False

    def settimeout(self, t):
        raise OSError("bad fd")

    def setsockopt(self, *a):
        pass

    def close(self):
        self.closed = True


class TestDialConfigureFailure:
    def test_kv_channel_closes_sock_and_backs_off(self, monkeypatch):
        ch = pfkv.KvDataChannel("m-cfg", "127.0.0.1", 1)
        fake = _ConfigFailSock()
        monkeypatch.setattr(socket, "create_connection",
                            lambda *a, **k: fake)
        before = ch._backoff_s
        with pytest.raises(OSError):
            ch._ensure_connected()
        assert fake.closed
        assert ch._reconnecting
        assert ch._backoff_s == min(before * 2.0, 5.0)
        assert ch._not_before > time.monotonic() - 1.0
        assert ch._sock is None

    def test_fleet_worker_closes_sock_on_configure_failure(
            self, monkeypatch):
        worker = premote.FleetWorker(
            None, pfleet.FleetSettings(connect="127.0.0.1:9"),
            member_id="m-cfg")
        fake = _ConfigFailSock()
        monkeypatch.setattr(socket, "create_connection",
                            lambda *a, **k: fake)
        with pytest.raises(OSError):
            worker._connect_link(worker._links[0], 1.0)
        assert fake.closed and not worker.is_connected()


# ---------------------------------------------------------------------------
# two processes' servers, the data channel between them
# ---------------------------------------------------------------------------


def _tree():
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * 8.0
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * 8.0
    return tree


TREE = _tree()
PAGED = (192, 8, 32)
BUCKETS = (16, 64)
HANDOFF_PROMPT = "the kv bytes take the long way home"
FETCH_PROMPTS = ("warm chains cross the wire " * 2,
                 "int8 codes ride the member wire " * 2,
                 "the peer dies and the target recomputes " * 2)


_JAX_ENGINE = []


def _jax_engine():
    """The module's one JAX engine (its compiles are paid once), with an
    empty prefix cache: every run on it is cold."""
    if not _JAX_ENGINE:
        _JAX_ENGINE.append(jeng.LLMEngine(
            jax.tree_util.tree_map(jnp.asarray, TREE), J_TINY,
            jtok.ByteTokenizer(),
            jeng.EngineConfig(max_batch=4, prefill_buckets=BUCKETS,
                              paged=jkv.PagedCacheConfig(*PAGED),
                              warmup_compile=False),
            dtype=jnp.float32))
    eng = _JAX_ENGINE[0]
    assert not eng.has_work()
    eng.evict_cache(0.0)
    return eng


def _jax_drain(eng) -> list:
    toks = []
    while eng.has_work():
        toks += [o.token_id for o in eng.step() if o.token_id is not None]
    return toks


def _jax_greedy(prompt: str, max_tokens: int) -> list:
    eng = _jax_engine()
    eng.add_request("ref", list(prompt.encode()), jeng.SamplingParams(
        max_tokens=max_tokens, temperature=0.0))
    return _jax_drain(eng)


def _as_jax(exp):
    """A port SequenceExport (and its chunks) as the JAX package's."""
    d = {f.name: getattr(exp, f.name) for f in dataclasses.fields(exp)}
    d["params"] = jeng.SamplingParams(**dataclasses.asdict(exp.params))
    if exp.kv_chunks is not None:
        d["kv_chunks"] = [jkv.KvChunk(**dataclasses.asdict(c))
                          for c in exp.kv_chunks]
    return jeng.SequenceExport(**d)


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


def _request(rid, prompt, max_tokens, sink):
    return ServerRequest(rid, list(prompt.encode()),
                         SamplingParams(max_tokens=max_tokens,
                                        temperature=0.0), sink)


def _serve(runner, rid, prompt, max_tokens):
    sink = _Sink()
    runner.submit([_request(rid, prompt, max_tokens, sink)])
    assert sink.ev.wait(120), f"{rid} never terminated"
    return sink


def _dispatch(host, rid, prompt, max_tokens=16):
    sink = _Sink()
    host.dispatcher.submit(_request(rid, prompt, max_tokens, sink))
    assert sink.ev.wait(120), f"{rid} never terminated"
    return sink


class KvPair:
    """A port registry host and a port member joined over real TCP (the
    control wire and the data channel), roles and strategy as given."""

    def __init__(self, host_roles, member_roles, strategy="least_loaded",
                 native_allocator=None):
        params = params_from_numpy(TREE, device="cpu", dtype=torch.float32)

        def factory():
            return LLMEngine(params, TINY, ByteTokenizer(), EngineConfig(
                max_batch=4, prefill_buckets=BUCKETS,
                paged=PagedCacheConfig(*PAGED),
                native_allocator=native_allocator),
                dtype=torch.float32, device="cpu")

        self.host = InferenceServer(
            factory, ByteTokenizer(), "tiny", num_engines=len(host_roles),
            engine_roles=list(host_roles), auto_restart=False,
            strategy=SchedulingStrategy.parse(strategy),
            # wide aging: the module's JAX compiles can starve the beat
            # threads for a second
            fleet_settings=pfleet.FleetSettings(
                enabled=True, heartbeat_interval_s=0.1,
                suspect_after_s=3.0, dead_after_s=6.0))
        self.host.start()
        self.member = InferenceServer(
            factory, ByteTokenizer(), "tiny",
            num_engines=len(member_roles), engine_roles=list(member_roles),
            auto_restart=False)
        self.member.start()
        self.worker = premote.FleetWorker(
            self.member.scheduler, pfleet.FleetSettings(
                connect=f"127.0.0.1:{self.host.fleet_server.bound_port}",
                heartbeat_interval_s=0.1),
            metrics=self.member.metrics, member_id="kv-w1")
        self.worker.start()
        assert _until(lambda: self.remote() is not None
                      and self.remote().is_healthy()
                      and self.remote().supports_kv_import, 30.0), (
            "the member never joined with a data channel")

    def remote(self):
        return next((r for r in self.host.scheduler.engines()
                     if getattr(r, "is_remote", False)), None)

    def local(self):
        return self.host.local_runners()[0]

    def member_runner(self):
        return self.member.local_runners()[0]

    def close(self):
        faults.clear()
        self.worker.stop()
        self.member.shutdown(drain_timeout_s=5.0)
        self.host.shutdown(drain_timeout_s=5.0)


def _prom_value(server, pattern):
    m = re.search(pattern, server.metrics_text().decode())
    return float(m.group(1)) if m else 0.0


def _remote_handoff_chunks(host):
    return _prom_value(host,
                       r'kv_handoff_chunks_total\{scope="remote"\} ([0-9.]+)')


@pytest.fixture(scope="module")
def handoff_pair():
    """Host: one prefill engine. Member: one decode engine. Every request
    admitted on the host wants a migration over the data channel."""
    pair = KvPair(["prefill"], ["decode"])
    pair.ref = _jax_greedy(HANDOFF_PROMPT, 48)
    yield pair
    pair.close()


class TestCrossHostHandoffE2E:
    def _migrated_serve(self, pair, rid, attempts=4):
        """Serve on the host's prefill replica until a migration lands (a
        quick in-place finish inside the open window is a correct
        degradation; identity is checked either way)."""
        before = _remote_handoff_chunks(pair.host)
        for i in range(attempts):
            sink = _serve(pair.local(), f"{rid}-{i}", HANDOFF_PROMPT, 48)
            assert sink.errors == [], sink.errors
            assert sink.toks == pair.ref
            if _remote_handoff_chunks(pair.host) > before:
                return sink, f"{rid}-{i}"
        pytest.fail(f"no cross-process migration in {attempts} attempts")

    def test_remote_handoff_token_identity_f32(self, handoff_pair):
        pair = handoff_pair
        sink, rid = self._migrated_serve(pair, "kvho-f32")
        assert sink.dones == 1
        tl = pair.host.recorder.timeline(rid)
        assert tl is not None
        assert any(e["name"] == "handoff_resume" for e in tl["events"])
        snap = pair.host.metrics.snapshot().to_dict()
        assert snap["disagg"]["handoffs"].get("ok", 0) >= 1
        st = pair.host.fleet_stats()
        assert st["kv_channels"]["kv-w1"]["bytes_sent"] > 0
        assert any(r["src"] == "registry" and r["dst"] == "kv-w1"
                   and r["bytes"] > 0 for r in st["kv_wires"])

    def test_remote_handoff_token_identity_int8_wire(self, handoff_pair):
        """Over the int8 wire the member decodes from the int8 chunks it
        received: the JAX engine, importing those same wire bytes, decodes
        the same tokens, and the tokens before the move are the f32
        reference's."""
        pair = handoff_pair
        runner = pair.member_runner()
        captured = {}
        orig_open = runner.submit_import_open
        orig_commit = runner.submit_import_commit
        orig_resume = runner.submit_resume

        def open_(rid, prefix_pages, chunks, on_done):
            captured["open"] = (prefix_pages, list(chunks))
            return orig_open(rid, prefix_pages, chunks, on_done)

        def commit_(exp, req, on_done):
            captured["commit"] = exp
            return orig_commit(exp, req, on_done)

        def resume_(exp, req, on_done):
            captured["resume"] = exp
            return orig_resume(exp, req, on_done)

        runner.submit_import_open = open_
        runner.submit_import_commit = commit_
        runner.submit_resume = resume_
        old = pair.host.disagg.settings
        pair.host.disagg.settings = dataclasses.replace(old,
                                                        wire_quant="int8")
        before = _remote_handoff_chunks(pair.host)
        try:
            for i in range(4):
                captured.clear()
                sink = _serve(pair.local(), f"kvho-int8-{i}",
                              HANDOFF_PROMPT, 48)
                if _remote_handoff_chunks(pair.host) > before:
                    break
            else:
                pytest.fail("no cross-process migration in 4 attempts")
        finally:
            pair.host.disagg.settings = old
            del runner.submit_import_open, runner.submit_import_commit
            del runner.submit_resume
        assert sink.errors == [] and sink.dones == 1
        jx = _jax_engine()
        if "commit" in captured:
            exp = captured["commit"]
            prefix_pages, chunks = captured["open"]
            isess = jx.import_stream_open(exp.request_id, prefix_pages)
            jx.import_stream_add(isess, [jkv.KvChunk(**dataclasses.asdict(c))
                                         for c in chunks])
            jx.import_stream_commit(isess, _as_jax(exp))
        else:
            exp = captured["resume"]
            jx.import_sequence(_as_jax(exp))
        assert exp.wire_quant == "int8"
        tail = _jax_drain(jx)
        assert tail and sink.toks[len(sink.toks) - len(tail):] == tail
        head = sink.toks[:len(sink.toks) - len(tail)]
        assert head == pair.ref[:len(head)]
        assert jx.audit_pages() == []

    def test_peer_death_mid_stream_decodes_in_place(self, handoff_pair):
        pair = handoff_pair
        faults.install(faults.parse_spec("fleet.kv_chunk:nth=1", 5))
        try:
            sink = _serve(pair.local(), "kvho-dead", HANDOFF_PROMPT, 48)
        finally:
            faults.clear()
        assert sink.errors == [] and sink.dones == 1
        assert sink.toks == pair.ref
        assert _until(lambda: pair.local().active_count() == 0
                      and pair.member_runner().active_count() == 0)
        assert pair.local().audit() == []
        assert pair.member_runner().audit() == []


@pytest.fixture(scope="module")
def fetch_pair():
    """Host: one unified cache_aware engine (the fetch target). Member: one
    unified engine (the warm source). The Python allocator: digests need
    its export surface."""
    pair = KvPair(["unified"], ["unified"], strategy="cache_aware",
                  native_allocator=False)
    pair.refs = {p: _jax_greedy(p, 16) for p in FETCH_PROMPTS}
    yield pair
    pair.close()


def _warm_member(pair, prompt):
    """Warm the member's prefix cache over the control wire, then wait for
    this prompt's chain head in the heartbeated digest."""
    for i in range(2):
        sink = _serve(pair.remote(), f"warm-{abs(hash(prompt)) % 997}-{i}",
                      prompt, 8)
        assert sink.errors == []
    head = chain_hashes(list(prompt.encode()), 8, max_pages=1)[0]
    assert _until(lambda: (pair.remote().status().prefix_digest or ())
                  and head in pair.remote().status().prefix_digest
                  and pair.remote().status().data_plane), (
        "the member's digest never reached the routing snapshot")


def _fetch_counts(host):
    snap = host.metrics.snapshot().to_dict()
    return dict((snap.get("cache") or {}).get("peer_fetch") or {})


class TestRemoteFetchE2E:
    def test_remote_fetch_token_identity_f32(self, fetch_pair):
        pair = fetch_pair
        prompt = FETCH_PROMPTS[0]
        _warm_member(pair, prompt)
        before = _fetch_counts(pair.host).get("ok", 0)
        faults.install(faults.parse_spec("sched.fetch_decision:nth=1", 3))
        try:
            sink = _dispatch(pair.host, "kvpf-f32", prompt)
        finally:
            faults.clear()
        assert sink.errors == [] and sink.dones == 1
        assert _fetch_counts(pair.host).get("ok", 0) == before + 1
        assert sink.toks == pair.refs[prompt]
        tl = pair.host.recorder.timeline("kvpf-f32")
        assert tl is not None and tl["phases"]["peer_fetch"] > 0
        prom = pair.host.metrics_text().decode()
        assert 'kv_prefix_fetch_total{outcome="ok",scope="remote"}' in prom
        assert 'kv_prefix_fetch_bytes_total{scope="remote"}' in prom

    def test_remote_fetch_token_identity_int8_wire(self, fetch_pair):
        pair = fetch_pair
        prompt = FETCH_PROMPTS[1]
        _warm_member(pair, prompt)
        before = _fetch_counts(pair.host).get("ok", 0)
        fetcher = pair.host.prefix_fetcher
        old = fetcher.settings
        fetcher.settings = dataclasses.replace(old, wire_quant="int8")
        faults.install(faults.parse_spec("sched.fetch_decision:nth=1", 3))
        try:
            sink = _dispatch(pair.host, "kvpf-int8", prompt)
        finally:
            faults.clear()
            fetcher.settings = old
        assert sink.errors == [] and sink.dones == 1
        assert _fetch_counts(pair.host).get("ok", 0) == before + 1
        assert sink.toks == pair.refs[prompt]

    def test_remote_source_death_degrades_to_recompute(self, fetch_pair):
        pair = fetch_pair
        prompt = FETCH_PROMPTS[2]
        _warm_member(pair, prompt)
        before = _fetch_counts(pair.host).get("fallback", 0)
        faults.install(faults.parse_spec(
            "sched.fetch_decision:nth=1;fleet.kv_chunk:nth=1", 5))
        try:
            sink = _dispatch(pair.host, "kvpf-dead", prompt)
        finally:
            faults.clear()
        assert sink.errors == [] and sink.dones == 1
        assert _fetch_counts(pair.host).get("fallback", 0) == before + 1
        assert sink.toks == pair.refs[prompt]
        assert _until(lambda: pair.local().active_count() == 0
                      and pair.member_runner().active_count() == 0)
        assert pair.local().audit() == []
        assert pair.member_runner().audit() == []


def test_latent_chunks_cross_the_data_frames():
    """The mesh case of ``tests/test_latent_kv.py``: a prefix exported on
    the ``latent`` wire crosses the data channel's KvChunk frames (either
    package writing, the other reading), arrives reordered and seats
    token-exact: the JAX engine's cold tokens (the reference's unscaled
    weights, whose K/V a rank-4 latent keeps exact)."""
    import random

    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu", dtype=torch.float32)

    def engine():
        return LLMEngine(params, TINY, ByteTokenizer(), EngineConfig(
            max_batch=4, prefill_buckets=BUCKETS,
            paged=PagedCacheConfig(*PAGED), latent_rank=4,
            native_allocator=False), dtype=torch.float32, device="cpu")

    ids = list(b"latent pages on the mesh wire")
    jx = jeng.LLMEngine(jp, J_TINY, jtok.ByteTokenizer(), jeng.EngineConfig(
        max_batch=4, prefill_buckets=BUCKETS,
        paged=jkv.PagedCacheConfig(*PAGED), warmup_compile=False),
        dtype=jnp.float32)
    jx.add_request("ref", ids, jeng.SamplingParams(max_tokens=6,
                                                   temperature=0.0))
    want = _jax_drain(jx)
    hashes = chain_hashes(ids, PAGED[1], max_pages=(len(ids) - 1) // PAGED[1])
    warm = engine()
    warm.add_request("warm", ids, SamplingParams(max_tokens=6,
                                                 temperature=0.0))
    while warm.has_work():
        warm.step()
    depth, chunks = warm.export_prefix_chunks(hashes, chunk_pages=2,
                                              wire_quant="latent")
    assert depth == len(hashes) and len(chunks) > 1
    for writer, reader in ((pfkv, jfkv), (jfkv, pfkv)):
        a, b = socket.socketpair()
        try:
            for c in chunks:
                writer.send_kv_frame(a, "KvChunk",
                                     pfkv.chunk_to_wire("mesh", c))
            wired = [pfkv.chunk_from_wire(reader.recv_kv_frame(b)[1])
                     for _ in chunks]
        finally:
            a.close()
            b.close()
        assert [c.payload for c in wired] == [c.payload for c in chunks]
        random.Random(11).shuffle(wired)  # a transport may reorder
        target = engine()
        assert target.import_prefix(ids[: depth * PAGED[1]], wired) == depth
        target.add_request("probe", ids, SamplingParams(max_tokens=6,
                                                        temperature=0.0))
        got = []
        while target.has_work():
            got += [o.token_id for o in target.step()
                    if o.token_id is not None]
        assert got == want
        assert target.audit_pages() == []
