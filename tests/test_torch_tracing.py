"""The port's tracing and OTLP export against the JAX package's: the same
span trees (names, parent links, attributes, events, statuses, ring order,
drop accounting), the same OTLP JSON for the same spans with injected ids,
one export reaching a standard-library collector on localhost, a dead
collector failing open, and the runner's spine notes (tokens, terminal,
engine spans) off when no tracer or recorder is wired."""

from __future__ import annotations

import http.server
import json
import threading

import pytest

import distributed_inference_server_tpu.utils.otlp as jotlp
import distributed_inference_server_tpu.utils.tracing as jtr
import distributed_inference_server_tpu_torch.utils.otlp as potlp
import distributed_inference_server_tpu_torch.utils.tracing as ptr

MODS = {"jax": jtr, "torch": ptr}
IMPLS = sorted(MODS)


def _tree(spans):
    """A span list without ids and times: names, parent names, attributes,
    event names and attributes, statuses."""
    by_id = {s.span_id: s.name for s in spans}
    return [(s.name, by_id.get(s.parent_id), s.attributes,
             [(n, a) for _, n, a in s.events], s.status) for s in spans]


def _scenario(mod):
    t = mod.Tracer(capacity=8)
    with t.span("request", request_id="r1", prompt_tokens=5) as root:
        root.event("queued")
        with t.span("batch.dispatch", size=1):
            root.event("dispatched")
        child = t.start("engine.infer", parent=root.context(),
                        engine_id="engine-0", request_id="r1")
        child.event("first_token")
        child.set(completion_tokens=4)
        t.finish(child)
        root.event("redispatched", from_engine="e0", to_engine="e1",
                   reason="crash")
    with pytest.raises(ValueError):
        with t.span("boom"):
            raise ValueError("x")
    return t


@pytest.mark.parametrize("impl", IMPLS)
def test_span_parenting_and_ring(impl):
    t = _scenario(MODS[impl])
    spans = t.recent()
    names = [s.name for s in spans]
    assert names == ["request", "batch.dispatch", "engine.infer", "boom"]
    root, _, child, boom = spans
    assert child.trace_id == root.trace_id
    assert child.parent_id == root.span_id and root.parent_id is None
    assert boom.status == "error"
    d = root.to_dict()
    ev = {e["name"]: e for e in d["events"]}
    assert ev["redispatched"]["attributes"] == {
        "from_engine": "e0", "to_engine": "e1", "reason": "crash"}
    assert "attributes" not in ev["queued"]


def test_span_trees_equal():
    assert _tree(_scenario(ptr).recent()) == _tree(_scenario(jtr).recent())
    jd = [{k: v for k, v in s.to_dict().items()
           if k not in ("trace_id", "span_id", "parent_id", "start_ns",
                        "duration_ms", "events")}
          for s in _scenario(jtr).recent()]
    pd = [{k: v for k, v in s.to_dict().items()
           if k not in ("trace_id", "span_id", "parent_id", "start_ns",
                        "duration_ms", "events")}
          for s in _scenario(ptr).recent()]
    assert pd == jd


@pytest.mark.parametrize("impl", IMPLS)
def test_filters_and_start_order(impl):
    t = MODS[impl].Tracer()
    with t.span("late", request_id="r1") as late:
        pass
    with t.span("other", request_id="r2"):
        pass
    assert [s.name for s in t.recent(request_id="r1")] == ["late"]
    assert [s.name for s in t.recent(trace_id=late.trace_id)] == ["late"]
    early = t.start("early")
    early.start_ns, early.end_ns = 1, 2
    early.set(request_id="r1")
    t.ingest(early)
    assert [s.name for s in t.recent(request_id="r1")] == ["early", "late"]
    assert [s.name for s in t.recent(n=1)] == ["other"]


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_overflow_counts_and_hooks(impl):
    t = MODS[impl].Tracer(capacity=2)
    drops = []
    t.on_drop = lambda reason, n: drops.append((reason, n))
    for i in range(5):
        with t.span(f"s{i}"):
            pass
    assert t.dropped() == {"ring": 3, "exporter": 0, "wire": 0}
    assert drops == [("ring", 1)] * 3


@pytest.mark.parametrize("impl", IMPLS)
def test_exporter_failure_counts_and_hook_failure_never_raises(impl):
    t = MODS[impl].Tracer(capacity=1)

    def boom(span):
        raise RuntimeError("exporter down")

    t.exporters.append(boom)
    t.on_drop = lambda *a: (_ for _ in ()).throw(RuntimeError("x"))
    for i in range(3):
        with t.span(f"s{i}"):
            pass
    assert t.dropped() == {"ring": 2, "exporter": 3, "wire": 0}
    assert len(t.recent()) == 1


@pytest.mark.parametrize("impl", IMPLS)
def test_record_drop_unknown_reason_is_exporter(impl):
    t = MODS[impl].Tracer()
    t.record_drop("bogus", 4)
    t.record_drop("wire", 2)
    assert t.dropped() == {"ring": 0, "exporter": 4, "wire": 2}


# ---------------------------------------------------------------------------
# OTLP
# ---------------------------------------------------------------------------


def _fixed_spans(mod):
    """Spans with injected ids and times."""
    root = mod.Span("request", "a1b2c3d4e5f60718", "1111111111111111", None,
                    1_000, 9_000, {"request_id": "r1", "prompt_tokens": 5,
                                   "ratio": 0.5, "ok": True},
                    [(2_000, "queued", {}),
                     (3_000, "redispatched", {"from_engine": "e0",
                                              "attempt": 1})])
    child = mod.Span("engine.infer", "a1b2c3d4e5f60718", "2222222222222222",
                     "1111111111111111", 2_500, 8_000, {"engine_id": "e0"},
                     [], "error")
    open_span = mod.Span("open", "ffffffffffffffff", "3333333333333333",
                         None, 4_000)
    return [root, child, open_span]


@pytest.mark.parametrize("service", ["distributed-inference-server-tpu",
                                     "svc-x"])
def test_otlp_json_equal_for_injected_spans(service):
    j = jotlp.OTLPExporter("http://127.0.0.1:9/v1/traces",
                           service_name=service)
    p = potlp.OTLPExporter("http://127.0.0.1:9/v1/traces",
                           service_name=service)
    p._epoch_offset_ns = j._epoch_offset_ns = 1_700_000_000_000_000_000
    got = p._encode(_fixed_spans(ptr))
    assert got == j._encode(_fixed_spans(jtr))
    s = got["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert len(s[0]["traceId"]) == 32 and s[1]["parentSpanId"] == s[0][
        "spanId"]
    assert [x["status"]["code"] for x in s] == [1, 2, 1]
    assert json.dumps(got)  # serializable as sent


def _collector():
    received = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 — http.server API
            n = int(self.headers.get("Content-Length", 0))
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, received


def test_spans_reach_a_local_collector():
    srv, received = _collector()
    try:
        tracer = ptr.Tracer()
        exp = potlp.OTLPExporter(
            f"http://127.0.0.1:{srv.server_port}/v1/traces",
            service_name="test-svc", flush_interval_s=0.05).attach(tracer)
        with tracer.span("request", model="tiny") as root:
            root.event("queued")
            with tracer.span("inference", parent=root.context(), tokens=5):
                pass
        exp.shutdown()
    finally:
        srv.shutdown()
        srv.server_close()
    assert exp.exported == 2 and exp.dropped == 0
    spans = [s for body in received
             for s in body["resourceSpans"][0]["scopeSpans"][0]["spans"]]
    by_name = {s["name"]: s for s in spans}
    assert set(by_name) == {"request", "inference"}
    assert by_name["inference"]["parentSpanId"] == by_name["request"][
        "spanId"]
    assert by_name["inference"]["attributes"][0] == {
        "key": "tokens", "value": {"intValue": "5"}}
    svc = received[0]["resourceSpans"][0]["resource"]["attributes"][0]
    assert svc == {"key": "service.name",
                   "value": {"stringValue": "test-svc"}}


def test_dead_collector_is_fail_open():
    tracer = ptr.Tracer()
    exp = potlp.OTLPExporter("http://127.0.0.1:1/v1/traces",
                             flush_interval_s=0.05, timeout_s=0.2)
    exp.attach(tracer)
    for i in range(5):
        with tracer.span(f"s{i}"):
            pass
    exp.shutdown()
    assert exp.dropped == 5 and exp.exported == 0
    assert tracer.dropped()["exporter"] == 5
    assert len(tracer.recent(10)) == 5


def test_queue_overflow_counts_exporter_drops():
    tracer = ptr.Tracer()
    exp = potlp.OTLPExporter("http://127.0.0.1:1/v1/traces",
                             queue_capacity=2, batch_size=100)
    tracer.exporters.append(exp.export)
    exp._tracer = tracer
    for i in range(5):
        with tracer.span(f"s{i}"):
            pass
    assert exp.dropped == 3 and tracer.dropped()["exporter"] == 3


# ---------------------------------------------------------------------------
# the runner's spine notes
# ---------------------------------------------------------------------------


def _runner_and_request(tracer=None, recorder=None):
    from distributed_inference_server_tpu_torch.engine.engine import (
        SamplingParams,
    )
    from distributed_inference_server_tpu_torch.serving.metrics import (
        MetricsCollector,
    )
    from distributed_inference_server_tpu_torch.serving.runner import (
        EngineRunner,
        ServerRequest,
    )

    class Sink:
        def __init__(self):
            self.tokens, self.dones, self.errors = [], 0, []

        def on_token(self, token_id, text, token_index, logprob=None):
            self.tokens.append(token_id)

        def on_done(self, reason, usage):
            self.dones += 1

        def on_error(self, message, code):
            self.errors.append(code)

    r = EngineRunner("e0", engine_factory=None, metrics=MetricsCollector(),
                     tracer=tracer, recorder=recorder)
    sink = Sink()
    span = tracer.start("request.generate") if tracer is not None else None
    req = ServerRequest("r1", [1, 2, 3], SamplingParams(max_tokens=4), sink,
                        span=span)
    if tracer is not None:
        req.engine_span = tracer.start("engine.infer", parent=span.context())
    r._inflight[req.request_id] = req
    return r, req, sink


def _outputs(error=False):
    from distributed_inference_server_tpu_torch.core.models import (
        FinishReason,
        Usage,
    )
    from distributed_inference_server_tpu_torch.engine.engine import (
        StepOutput,
    )

    if error:
        return [[StepOutput("r1", error="boom", finished=True)]]
    return [[StepOutput("r1", token_id=7, text="x")],
            [StepOutput("r1", finished=True, finish_reason=FinishReason.STOP,
                        usage=Usage.of(3, 1))]]


def test_runner_disabled_path_touches_nothing():
    from distributed_inference_server_tpu_torch.serving.flightrec import (
        FlightRecorder,
    )

    recorder = FlightRecorder()
    r, _, sink = _runner_and_request()
    for outs in _outputs():
        r._dispatch(outs)
    assert sink.dones == 1 and sink.tokens == [7]
    assert recorder.stats()["tracked"] == 0


@pytest.mark.parametrize("error", [False, True], ids=["done", "error"])
def test_runner_records_tokens_terminal_and_engine_span(error):
    from distributed_inference_server_tpu_torch.serving.flightrec import (
        FlightRecorder,
    )

    tracer, recorder = ptr.Tracer(), FlightRecorder()
    r, req, sink = _runner_and_request(tracer, recorder)
    for outs in _outputs(error):
        r._dispatch(outs)
    tl = recorder.timeline("r1")
    (eng,) = tracer.recent()
    assert eng.name == "engine.infer" and eng.parent_id == req.span.span_id
    if error:
        assert tl["status"] == "error" and tl["code"] == "inference_failed"
        assert sink.errors == ["inference_failed"] and eng.status == "error"
    else:
        assert tl["tokens"] == 1 and tl["status"] == "ok"
        assert any(e["name"] == "first_token" for e in tl["events"])
        assert eng.attributes["completion_tokens"] == 1
        assert [n for _, n, _ in eng.events] == ["first_token"]


def test_fault_observer_registry_fans_out_and_unregisters():
    from distributed_inference_server_tpu_torch.serving import faults

    seen_a, seen_b = [], []

    def cb_a(name, **attrs):
        seen_a.append(name)

    def cb_b(name, **attrs):
        seen_b.append(name)

    faults.add_observer(cb_a)
    faults.add_observer(cb_b)
    try:
        faults.install(faults.parse_spec("runner.step:nth=1", seed=1))
        faults.clear()
        assert seen_a == seen_b == ["faults_armed", "faults_cleared"]
        faults.remove_observer(cb_b)
        faults.install(faults.parse_spec("runner.step:nth=1", seed=1))
        faults.clear()
        assert len(seen_a) == 4 and len(seen_b) == 2
    finally:
        faults.clear()
        faults.remove_observer(cb_a)
        faults.remove_observer(cb_b)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_span_dict_equal_for_injected_spans(i):
    assert _fixed_spans(ptr)[i].to_dict() == _fixed_spans(jtr)[i].to_dict()
