"""The port's protowire codec and fault registry against the JAX package's.

``serving/protowire.py`` and ``serving/faults.py`` are pure Python, and the
port keeps its own copies. For every message of the schema, dicts drawn by
hypothesis from the message's field table encode to the same bytes in
both packages, and decoding round-trips exactly; the JAX package's golden
bytes hold on the port. The fault registry's cases (``TestFaultSet`` of
``tests/test_chaos.py``) pass on the port, and seeded ``prob`` rules fire
on the same hits as the JAX package's.
"""

import pathlib
import time

import pytest

from _hypothesis_compat import given, settings, st
from distributed_inference_server_tpu.serving import faults as jfaults
from distributed_inference_server_tpu.serving import protowire as jpw
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving import protowire as pw
from distributed_inference_server_tpu_torch.serving.faults import (
    FaultRule,
    FaultSet,
    FaultSpecError,
    InjectedFault,
    parse_spec,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()
    jfaults.clear()


# ---------------------------------------------------------------------------
# the schema
# ---------------------------------------------------------------------------


JAX_PROTO = ROOT / "distributed_inference_server_tpu/serving/inference.proto"
PORT_PROTO = (ROOT / "distributed_inference_server_tpu_torch/serving/"
              "inference.proto")

# The one place the port's contract differs from the JAX package's.
# ``TeleDigest.epochs`` collides with ``epoch_s`` under protoc's proto3
# rule (field names compared lowercased without underscores; a
# ``json_name`` alone does not lift it), so the port names the field
# ``epoch_ring`` and gives it back the JSON name ``epochs``. The field
# number and type, hence every byte on the wire, and the codec's
# tables (keyed ``epochs``) stay the JAX package's.
_JAX_EPOCHS = ("  repeated TeleEpoch epochs = 3;      "
               "// bounded: the sliding ring only")
_PORT_EPOCHS = ('  repeated TeleEpoch epoch_ring = 3 [json_name = "epochs"];'
                "  // bounded:\n"
                "                                      "
                "// the sliding ring only")


def test_schema_tables_and_contract_match_the_jax_package():
    assert pw.MESSAGES == jpw.MESSAGES
    assert pw.ENUMS == jpw.ENUMS
    j, p = JAX_PROTO.read_text(), PORT_PROTO.read_text()
    assert j.count(_JAX_EPOCHS) == 1 and p.count(_PORT_EPOCHS) == 1
    # any other difference from the JAX contract fails here
    assert p.replace(_PORT_EPOCHS, _JAX_EPOCHS) == j


def _compile_port_contract(tmp_path):
    import shutil
    import subprocess

    protoc = shutil.which("protoc")
    if protoc is None:
        pytest.skip("protoc is not installed")
    out = tmp_path / "inference.pb"
    subprocess.run([protoc, "--proto_path", str(PORT_PROTO.parent),
                    "--include_imports", "--descriptor_set_out", str(out),
                    PORT_PROTO.name], check=True, capture_output=True)
    return out.read_bytes()


def test_port_contract_is_protoc_valid(tmp_path):
    """protoc compiles the port's contract (the JAX package's own fails on
    the ``TeleDigest`` collision), and the renamed field keeps its number,
    type and JSON name."""
    from google.protobuf import descriptor_pb2

    fds = descriptor_pb2.FileDescriptorSet.FromString(
        _compile_port_contract(tmp_path))
    (f,) = [f for f in fds.file if f.name == PORT_PROTO.name]
    (tele,) = [m for m in f.message_type if m.name == "TeleDigest"]
    fields = {x.number: x for x in tele.field}
    assert fields[3].name == "epoch_ring"
    assert fields[3].json_name == "epochs"
    assert fields[3].type_name == ".dis.tpu.TeleEpoch"
    assert fields[2].name == "epoch_s"


def test_port_contract_encodes_the_codec_bytes(tmp_path):
    """The protobuf runtime, built from the compiled port contract, writes
    a ``FleetTelemetry`` frame to the bytes both codecs write."""
    from google.protobuf import descriptor_pb2, descriptor_pool
    from google.protobuf import message_factory

    fds = descriptor_pb2.FileDescriptorSet.FromString(
        _compile_port_contract(tmp_path))
    pool = descriptor_pool.DescriptorPool()
    for f in fds.file:
        pool.Add(f)
    cls = message_factory.GetMessageClass(
        pool.FindMessageTypeByName("dis.tpu.FleetTelemetry"))
    frame = {"member_id": "w1", "digests": [
        {"name": "ttft_ms", "epoch_s": 5.0, "epochs": [
            {"index": 7, "buckets": [3, 9], "counts": [1, 4], "n": 5,
             "sum_us": 12345}]}],
        "counters": [{"name": "step.engine-0.decode.tokens",
                      "value": 96.0}]}
    msg = cls(member_id="w1")
    d = msg.digests.add(name="ttft_ms", epoch_s=5.0)
    d.epoch_ring.add(index=7, buckets=[3, 9], counts=[1, 4], n=5,
                     sum_us=12345)
    msg.counters.add(name="step.engine-0.decode.tokens", value=96.0)
    want = msg.SerializeToString()
    assert pw.encode("FleetTelemetry", frame) == want
    assert jpw.encode("FleetTelemetry", frame) == want
    assert pw.decode("FleetTelemetry", want) == frame


_U32 = st.integers(0, 2**32 - 1)
_SCALARS = {
    "string": st.text(max_size=12),
    "bytes": st.binary(max_size=24),
    "uint32": _U32,
    "uint64": st.integers(0, 2**64 - 1),
    "int64": st.integers(-2**63, 2**63 - 1),
    "bool": st.booleans(),
    "float": st.floats(width=32, allow_nan=False),
    "double": st.floats(allow_nan=False),
}


def _value(ftype: str, depth: int):
    if ftype.startswith("enum:"):
        names = [v for v in pw.ENUMS[ftype[5:]].values() if v is not None]
        return st.sampled_from(names)
    if ftype.startswith("msg:"):
        return _message(ftype[4:], depth + 1)
    return _SCALARS[ftype]


def _message(name: str, depth: int = 0):
    """Dicts of message ``name``: each field present or absent, repeated
    fields 0-3 long, nesting cut after three levels."""
    fields = {}
    for _num, (fname, ftype, card) in pw.MESSAGES[name].items():
        if ftype.startswith("msg:") and depth >= 3:
            continue
        v = _value(ftype, depth)
        fields[fname] = st.lists(v, max_size=3) if card == "rep" else v
    return st.fixed_dictionaries({}, optional=fields)


PLAIN_MESSAGES = sorted(m for m in pw.MESSAGES if m != "TokenEvent")


@pytest.mark.parametrize("name", PLAIN_MESSAGES)
@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_every_message_encodes_like_the_jax_package(name, data):
    obj = data.draw(_message(name))
    got = pw.encode(name, obj)
    assert got == jpw.encode(name, obj)
    back = pw.decode(name, got)
    assert back == jpw.decode(name, got)
    assert pw.encode(name, back) == got


_TOKEN_EVENTS = st.one_of(
    st.fixed_dictionaries(
        {"type": st.just("token"), "token": st.text(max_size=8),
         "index": _U32},
        optional={"logprob": st.floats(width=32, allow_nan=False)}),
    st.fixed_dictionaries(
        {"type": st.just("done"),
         "finish_reason": st.sampled_from(["stop", "length", "error"]),
         "usage": _message("Usage")}),
    st.fixed_dictionaries(
        {"type": st.just("error"), "messages": st.text(max_size=8),
         "code": st.text(max_size=8)}),
)


@settings(max_examples=40, deadline=None)
@given(obj=_TOKEN_EVENTS)
def test_token_events_encode_like_the_jax_package(obj):
    got = pw.encode("TokenEvent", obj)
    assert got == jpw.encode("TokenEvent", obj)
    back = pw.decode("TokenEvent", got)
    assert back == jpw.decode("TokenEvent", got)
    assert pw.encode("TokenEvent", back) == got


class TestGoldenBytes:
    """The JAX package's golden cases (``tests/test_protowire.py``)."""

    def test_simple_request_bytes(self):
        data = pw.encode("GenerateRequest", {"prompt": "hi", "max_tokens": 4})
        assert data == b"\x0a\x02hi\x10\x04"

    def test_zero_scalars_stay_off_the_wire(self):
        assert pw.encode("GenerateChoice", {"text": "", "index": 0}) == b""
        assert pw.encode("HealthRequest", {}) == b""

    def test_explicit_zero_on_optional_fields_is_emitted(self):
        data = pw.encode("GenerateRequest", {"temperature": 0.0})
        assert data == b"\x1d\x00\x00\x00\x00"
        assert pw.decode("GenerateRequest", data)["temperature"] == 0.0
        assert "temperature" not in pw.decode("GenerateRequest", b"")

    def test_truncated_payload_raises(self):
        data = pw.encode("KvChunk", {"handoff_id": "h", "payload": b"abcd"})
        with pytest.raises(ValueError):
            pw.decode("KvChunk", data[:-2])
        with pytest.raises(ValueError):
            jpw.decode("KvChunk", data[:-2])


# ---------------------------------------------------------------------------
# the fault registry (TestFaultSet of tests/test_chaos.py)
# ---------------------------------------------------------------------------


class TestFaultSet:
    def test_disabled_fire_is_noop(self):
        faults.clear()
        assert faults.fire("runner.step") is False
        assert faults.flag("sched.health_flap") is False

    def test_nth_fires_once_on_nth_hit(self):
        fs = FaultSet([FaultRule(point="p", nth=3)])
        fs.fire("p")
        fs.fire("p")
        with pytest.raises(InjectedFault):
            fs.fire("p")
        for _ in range(5):
            fs.fire("p")
        assert fs.fired_count("p") == 1

    def test_times_bounds_recurrence(self):
        fs = FaultSet([FaultRule(point="p", nth=1, times=2)])
        for _ in range(2):
            with pytest.raises(InjectedFault):
                fs.fire("p")
        fs.fire("p")
        assert fs.fired_count("p") == 2

    def test_prob_is_seed_deterministic(self):
        assert _burn(faults, 7) == _burn(faults, 7)
        assert _burn(faults, 7) != _burn(faults, 8)
        assert sum(_burn(faults, 7)) > 0

    def test_delay_rule_sleeps_not_raises(self):
        fs = FaultSet([FaultRule(point="p", nth=1, delay_ms=10.0)])
        t0 = time.monotonic()
        assert fs.fire("p") is True
        assert time.monotonic() - t0 >= 0.009

    def test_flag_never_raises(self):
        fs = FaultSet([FaultRule(point="p", nth=1)])
        assert fs.flag("p") is True
        assert fs.flag("p") is False

    def test_parse_spec(self):
        fs = parse_spec(
            "runner.inbox:nth=1;disagg.chunk:prob=0.25,times=3;"
            "disagg.slow_peer:nth=2,delay_ms=5", seed=9)
        assert set(fs._rules) == {"runner.inbox", "disagg.chunk",
                                  "disagg.slow_peer"}
        assert fs._rules["disagg.chunk"].times == 3
        assert fs._rules["disagg.slow_peer"].delay_ms == 5.0

    @pytest.mark.parametrize("bad", [
        "", "pointonly", "p:nth=x", "p:unknown=1", "p:prob=2.0", "p:",
        "p:nth=1;p:nth=2",
    ])
    def test_parse_rejects(self, bad):
        with pytest.raises(FaultSpecError):
            parse_spec(bad)
        with pytest.raises(jfaults.FaultSpecError):
            jfaults.parse_spec(bad)


def _burn(mod, seed, spec=None, hits=64, point="p"):
    """The hits (1) and misses (0) of ``hits`` fires of a seeded rule."""
    fs = (mod.parse_spec(spec, seed) if spec else
          mod.FaultSet([mod.FaultRule(point=point, prob=0.5, times=None)],
                       seed=seed))
    out = []
    for _ in range(hits):
        try:
            fs.fire(point)
            out.append(0)
        except mod.InjectedFault:
            out.append(1)
    return out


@pytest.mark.parametrize("spec,point", [
    (None, "p"),
    ("runner.step:prob=0.1", "runner.step"),
    ("disagg.chunk:prob=0.25,times=3", "disagg.chunk"),
    ("kv.peer_fetch:nth=5,times=4", "kv.peer_fetch"),
])
@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_seeded_rules_fire_on_the_jax_package_hits(spec, point, seed):
    assert (_burn(faults, seed, spec, 200, point)
            == _burn(jfaults, seed, spec, 200, point))


def test_module_registry_matches_the_jax_package():
    """install / fire / flag / clear through the module registry, one
    seeded spec in both packages: the same hits, flags and counts."""
    spec = "runner.step:prob=0.3;sched.fetch_decision:nth=2,times=2"
    out = []
    for mod in (faults, jfaults):
        mod.install(mod.parse_spec(spec, 3))
        seq = []
        for _ in range(30):
            try:
                mod.fire("runner.step")
                seq.append(0)
            except mod.InjectedFault:
                seq.append(1)
            seq.append(int(mod.flag("sched.fetch_decision")))
        seq.append(mod.active().fired_count("runner.step"))
        mod.clear()
        assert mod.active() is None and mod.fire("runner.step") is False
        out.append(seq)
    assert out[0] == out[1]
