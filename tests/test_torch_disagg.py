"""Disaggregated prefill/decode serving in the port, against the JAX package.

TINY f32 weights drawn by the JAX package, shared by conversion
(``tests/test_torch_handoff.py``). The cases:

- ``TestRoles`` of ``tests/test_disagg.py`` on the port's ``parse_roles``
  and role-filtered ``choose_engine``;
- the wire: one ``SequenceExport`` of the port engine (monolithic and
  streamed) frames to the same bytes as the JAX package's
  ``export_to_wire`` / ``chunks_to_frames`` / ``stream_to_frames`` give
  for the same export, decodes back exactly, and the fetch request
  round-trips (``test_fetch_request_wire_roundtrip``);
- a prefill/decode server per handoff form (streamed or monolithic, over
  the ``inproc`` or ``protowire`` channel): greedy tokens, text and usage
  equal the JAX engine's cold run for a lone prompt that streams, one too
  short to stream and four concurrent prompts; every decoded request
  handed off and finished on the decode replica; ``audit_pages() == []``
  on both replicas;
- the injected faults of ``tests/test_chaos.py``: a ``disagg.transfer``
  channel error retries and lands, a dropped ``disagg.commit`` decodes in
  place, a ``kv.import_chunk`` failure aborts the import and releases
  every page; each still with the JAX engine's tokens.
"""

import dataclasses
import time

import pytest

from distributed_inference_server_tpu.core.errors import (
    ConfigError as JConfigError,
)
from distributed_inference_server_tpu.serving import disagg as jdisagg
from distributed_inference_server_tpu_torch.core.errors import ConfigError
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving.batcher import (
    BatcherConfig,
)
from distributed_inference_server_tpu_torch.serving.disagg import (
    DisaggSettings,
    InProcessChannel,
    ProtowireChannel,
    chunks_to_frames,
    export_from_wire,
    export_to_wire,
    frames_to_parts,
    make_channel,
    parse_roles,
    stream_from_frames,
    stream_to_frames,
)
from distributed_inference_server_tpu_torch.serving.faults import parse_spec
from distributed_inference_server_tpu_torch.serving.metrics import (
    EngineStatus,
)
from distributed_inference_server_tpu_torch.serving.scheduler import (
    SchedulingStrategy,
    choose_engine,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)
from test_torch_handoff import _prompt, convert, p_engine, prefill_ready
from test_torch_replicas import TOK, jax_ref, p_factory, run, submit

LONG = "a prompt long enough to stream its prefix pages"  # 48 tokens
SHORT = "tiny"
MIX = ["first of the mix", "second prompt of four", "third one",
       "and the fourth prompt here"]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()


# ---------------------------------------------------------------------------
# roles
# ---------------------------------------------------------------------------


class TestRoles:
    def test_parse_default_unified(self):
        assert parse_roles("", 3) == ["unified"] * 3

    def test_parse_mixed(self):
        assert parse_roles("Prefill, decode ,unified", 3) == [
            "prefill", "decode", "unified"]
        assert parse_roles("prefill,decode,unified", 3) == (
            jdisagg.parse_roles("prefill,decode,unified", 3))

    @pytest.mark.parametrize("spec,n", [
        ("prefill,decode", 3),
        ("prefill,warp-core", 2),
        ("decode,decode", 2),
        ("prefill,prefill", 2),
        ("decode,unified", 2),
    ])
    def test_parse_rejects(self, spec, n):
        with pytest.raises(ConfigError) as got:
            parse_roles(spec, n)
        with pytest.raises(JConfigError) as want:
            jdisagg.parse_roles(spec, n)
        assert str(got.value) == str(want.value)

    def test_choose_engine_role_filter(self):
        def st(eid, role, load):
            return EngineStatus(engine_id=eid, role=role, healthy=True,
                                active_requests=load, waiting_requests=0,
                                total_processed=0)

        statuses = [st("p0", "prefill", 5), st("d0", "decode", 0),
                    st("u0", "unified", 9)]
        assert choose_engine(SchedulingStrategy.LEAST_LOADED, statuses, 0,
                             roles=("prefill", "unified")) == "p0"
        assert choose_engine(SchedulingStrategy.LEAST_LOADED, statuses,
                             0) == "d0"


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exports():
    """A monolithic and a streamed export of the port engine."""
    eng = p_engine()
    prompt = _prompt(40)
    prefill_ready(eng, "mono", prompt, 10)
    mono = eng.export_handoff("mono", wire_quant="int8")
    prefill_ready(eng, "strm", prompt, 40)
    session = eng.export_handoff_begin("strm", chunk_pages=2)
    eng.step()
    eng.export_handoff_pump(session)
    strm, _ = eng.export_handoff_finish(session)
    strm.source_engine = "engine-0"
    strm.stalled_at = 12.5  # host-local: never on the wire
    assert strm.kv_chunks
    return mono, strm


def test_handoff_frames_are_the_jax_packages_bytes(exports):
    mono, strm = exports
    assert export_to_wire(mono) == jdisagg.export_to_wire(
        convert(mono, True))
    assert list(stream_to_frames(strm)) == list(
        jdisagg.stream_to_frames(convert(strm, True)))
    ctx = ("aaaabbbbccccdddd", "1111222233334444")
    assert list(chunks_to_frames("r9", "int8", strm.kv_chunks,
                                 trace=ctx)) == list(
        jdisagg.chunks_to_frames(
            "r9", "int8", convert(strm, True).kv_chunks, trace=ctx))


def test_handoff_frames_decode_back_exactly(exports):
    mono, strm = exports
    back = export_from_wire(export_to_wire(mono))
    for f in ("request_id", "token_ids", "prompt_len", "seq_len",
              "next_token", "params", "output_text", "emitted_upto",
              "emitted_tokens", "pending_ids", "kv", "draft_kv",
              "source_engine"):
        assert getattr(back, f) == getattr(mono, f), f
    assert back.params.temperature == 0.0
    got = stream_from_frames(stream_to_frames(strm))
    assert [dataclasses.asdict(c) for c in got.kv_chunks] == [
        dataclasses.asdict(c) for c in strm.kv_chunks]
    assert got.wire_quant == strm.wire_quant and got.stalled_at == 0.0
    frames = list(chunks_to_frames("r", "none", strm.kv_chunks))
    header, chunks, state = frames_to_parts(frames[:1] + frames[:0:-1])
    assert state is None and header["request_id"] == "r"
    assert [c.index for c in chunks] == sorted(c.index for c in chunks)


def test_channels(exports):
    mono, _ = exports
    assert InProcessChannel().transfer(mono) is mono
    got = ProtowireChannel().transfer(mono)
    assert got is not mono and got.kv == mono.kv
    assert make_channel("inproc").name == "inproc"
    assert make_channel("protowire").name == "protowire"
    with pytest.raises(ConfigError):
        make_channel("carrier-pigeon")


def test_fetch_request_wire_roundtrip():
    hashes = [11, 2**63 + 5, 7]
    inproc = InProcessChannel().transfer_fetch_request("r1", hashes, 8,
                                                       "int8")
    wired = ProtowireChannel().transfer_fetch_request("r1", hashes, 8,
                                                      "int8")
    assert wired == ("r1", list(hashes), 8, "int8", None)
    assert inproc == wired
    assert wired == jdisagg.ProtowireChannel().transfer_fetch_request(
        "r1", hashes, 8, "int8")
    assert ProtowireChannel().transfer_fetch_request(
        "r2", [], 4, "")[3] == "none"
    ctx = ("aaaabbbbccccdddd", "1111222233334444")
    assert tuple(ProtowireChannel().transfer_fetch_request(
        "r1", hashes, 8, "int8", trace=ctx)[4]) == ctx


# ---------------------------------------------------------------------------
# prefill/decode servers
# ---------------------------------------------------------------------------

FORMS = [(True, "inproc"), (True, "protowire"), (False, "inproc"),
         (False, "protowire")]


def pd_server(stream: bool, channel: str) -> InferenceServer:
    srv = InferenceServer(
        p_factory(), TOK, "tiny", num_engines=2, auto_restart=False,
        engine_roles="prefill,decode",
        disagg_settings=DisaggSettings(stream=stream, channel=channel,
                                       chunk_pages=2,
                                       handoff_timeout_s=30.0),
        batcher_config=BatcherConfig(window_ms=0))
    srv.start()
    return srv


@pytest.fixture(scope="module", params=FORMS,
                ids=[f"{'streamed' if s else 'monolithic'}-{c}"
                     for s, c in FORMS])
def pd(request):
    srv = pd_server(*request.param)
    srv.form = request.param
    yield srv
    faults.clear()
    srv.shutdown(drain_timeout_s=5.0)


def _statuses(srv):
    return {s.engine_id: s for s in srv.scheduler.statuses()}


def _handoffs(srv):
    snap = srv.metrics.snapshot(tuple(srv.scheduler.statuses())).to_dict()
    return dict(snap["disagg"]["handoffs"])


def _audit_clean(srv):
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if all(r.audit() == [] for r in srv.scheduler.engines()):
            break
        time.sleep(0.05)
    for r in srv.scheduler.engines():
        assert r.audit() == [], r.engine_id


def test_prefill_decode_pair_matches_the_jax_engine(pd):
    stream, _ = pd.form
    before = _statuses(pd)
    ok0 = _handoffs(pd).get("ok", 0)
    assert run(pd, "long", LONG, 40) == jax_ref(LONG, 40)
    assert run(pd, "short", SHORT, 12) == jax_ref(SHORT, 12)
    sinks = [submit(pd, f"mix-{i}", p, 24) for i, p in enumerate(MIX)]
    for sink, prompt in zip(sinks, MIX):
        assert sink.ev.wait(120) and not sink.errors, sink.errors
        assert sink.result() == jax_ref(prompt, 24)
    snap = pd.metrics.snapshot(tuple(pd.scheduler.statuses())).to_dict()
    d = snap["disagg"]
    assert d["handoffs"].get("ok", 0) - ok0 == 2 + len(MIX)
    assert "fallback" not in d["handoffs"] and "retry" not in d["handoffs"]
    assert d["handoff_bytes"] > 0
    assert (d["handoff_chunks"] > 0) == stream
    after = _statuses(pd)
    # the decode replica carries every decode
    assert (after["engine-1"].total_processed
            - before["engine-1"].total_processed) == 2 + len(MIX)
    assert (after["engine-0"].total_processed
            == before["engine-0"].total_processed)
    assert {w["engine_id"]: w["role"] for w in snap["worker_statuses"]} == {
        "engine-0": "prefill", "engine-1": "decode"}
    text = pd.metrics_text().decode()
    assert 'engines_by_role{role="prefill"} 1.0' in text
    assert 'kv_handoff_total{outcome="ok"}' in text
    _audit_clean(pd)


@pytest.fixture(scope="module")
def streamed():
    srv = pd_server(True, "inproc")
    yield srv
    faults.clear()
    srv.shutdown(drain_timeout_s=5.0)


@pytest.fixture(scope="module")
def monolithic():
    srv = pd_server(False, "inproc")
    yield srv
    faults.clear()
    srv.shutdown(drain_timeout_s=5.0)


def test_transfer_fault_retries_and_still_lands(monolithic):
    before = _handoffs(monolithic)
    faults.install(parse_spec("disagg.transfer:nth=1", seed=8))
    got = run(monolithic, "chaos-transfer", LONG, 40)
    faults.clear()
    assert got == jax_ref(LONG, 40)
    after = _handoffs(monolithic)
    assert after.get("retry", 0) - before.get("retry", 0) == 1
    assert after.get("ok", 0) - before.get("ok", 0) == 1
    _audit_clean(monolithic)


def test_commit_drop_decodes_in_place(streamed):
    before = _handoffs(streamed)
    processed = _statuses(streamed)["engine-0"].total_processed
    faults.install(parse_spec("disagg.commit:nth=1", seed=4))
    got = run(streamed, "chaos-commit", LONG, 40)
    faults.clear()
    assert got == jax_ref(LONG, 40)
    after = _handoffs(streamed)
    assert after.get("fallback", 0) - before.get("fallback", 0) == 1
    # the prefill replica finished it in place
    assert _statuses(streamed)["engine-0"].total_processed == processed + 1
    _audit_clean(streamed)


def test_import_abort_releases_every_page(streamed):
    before = _handoffs(streamed)
    faults.install(parse_spec("kv.import_chunk:nth=1", seed=5))
    got = run(streamed, "chaos-import", LONG, 40)
    faults.clear()
    assert got == jax_ref(LONG, 40)
    after = _handoffs(streamed)
    assert after.get("fallback", 0) - before.get("fallback", 0) == 1
    _audit_clean(streamed)


def test_decode_replica_gone_admits_unified(streamed):
    """With no decode replica registered the prefill replica admits
    unified (no export, no fallback) and gives the same tokens."""
    dec = streamed.scheduler.unregister("engine-1")
    try:
        before = _handoffs(streamed)
        assert run(streamed, "no-decode", SHORT, 12) == jax_ref(SHORT, 12)
        assert _handoffs(streamed) == before
    finally:
        streamed.scheduler.register(dec)
