"""The port's gRPC transport (``serving/grpc_server.py``) against the JAX
package's.

One port server runs TINY on the CPU in float32, on weights converted from
the JAX ``init_params`` (every matrix scaled by 8 so greedy continuations
vary, as in ``tests/test_torch_serving_api.py``), with one gRPC server on
its handler. The cases of ``tests/test_grpc.py`` run against it on both
wires, and:

- greedy texts equal the JAX engine's for the same prompt ids, and a
  stream's frames join into the unary text;
- the JAX package's own ``GrpcClient`` (``grpc.aio``), on the JSON and the
  protobuf wire, gets from the port's server the same dicts as the port's
  client (less the per-request id and timestamp);
- a cancelled stream leaves no request in flight and no page held;
- every status of the mapping, and the JAX module's mapping, agree;
- the entry point serves the transport with ``--server-grpc-port``.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

grpc = pytest.importorskip("grpc")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_inference_server_tpu.engine.engine import (  # noqa: E402
    EngineConfig as JEngineConfig,
)
from distributed_inference_server_tpu.engine.engine import (  # noqa: E402
    LLMEngine as JEngine,
)
from distributed_inference_server_tpu.engine.engine import (  # noqa: E402
    SamplingParams as JSamplingParams,
)
from distributed_inference_server_tpu.engine.kv_cache import (  # noqa: E402
    PagedCacheConfig as JPagedCacheConfig,
)
from distributed_inference_server_tpu.models import llama as j_llama  # noqa: E402
from distributed_inference_server_tpu.models import tokenizer as jtok  # noqa: E402
from distributed_inference_server_tpu.models.configs import (  # noqa: E402
    TINY as J_TINY,
)
from distributed_inference_server_tpu.serving import (  # noqa: E402
    grpc_server as jgrpc,
)
from distributed_inference_server_tpu_torch.core import errors as perr  # noqa: E402
from distributed_inference_server_tpu_torch.engine.engine import (  # noqa: E402
    EngineConfig,
    LLMEngine,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (  # noqa: E402
    PagedCacheConfig,
)
from distributed_inference_server_tpu_torch.models.configs import TINY  # noqa: E402
from distributed_inference_server_tpu_torch.models.convert import (  # noqa: E402
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (  # noqa: E402
    ByteTokenizer,
)
from distributed_inference_server_tpu_torch.serving import (  # noqa: E402
    grpc_server as pgrpc,
)
from distributed_inference_server_tpu_torch.serving import (  # noqa: E402
    protowire,
)
from distributed_inference_server_tpu_torch.serving.server import (  # noqa: E402
    InferenceServer,
)

PAGED = (192, 8, 32)
BUCKETS = (16, 64)
GREEDY = {"temperature": 0.0}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * 8.0
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * 8.0
    return tree


class Stack:
    """The port's server with its gRPC transport, and a JAX engine on the
    same weights."""

    def __init__(self):
        tree = _tree()
        t_params = params_from_numpy(tree, device="cpu", dtype=torch.float32)

        def factory():
            return LLMEngine(t_params, TINY, ByteTokenizer(), EngineConfig(
                max_batch=4, prefill_buckets=BUCKETS,
                paged=PagedCacheConfig(*PAGED)), dtype=torch.float32,
                device="cpu")

        self.server = InferenceServer(factory, ByteTokenizer(), "tiny-grpc",
                                      auto_restart=False)
        self.server.start()
        self.grpc = pgrpc.build_grpc_server(self.server.handler)
        self.grpc.start()
        self.target = f"127.0.0.1:{self.grpc.bound_port}"
        self.j_engine = JEngine(
            jax.tree_util.tree_map(jnp.asarray, tree), J_TINY,
            jtok.ByteTokenizer(), JEngineConfig(
                max_batch=4, prefill_buckets=BUCKETS,
                paged=JPagedCacheConfig(*PAGED), attention_impl="xla",
                native_allocator=False), dtype=jnp.float32)
        self._n = 0
        self._lock = threading.Lock()

    def jax_text(self, prompt: str, max_tokens: int) -> str:
        ids = jtok.ByteTokenizer().encode(prompt)
        with self._lock:
            self._n += 1
            rid = f"j{self._n}"
            self.j_engine.add_request(rid, ids, JSamplingParams(
                temperature=0.0, max_tokens=max_tokens))
            text = ""
            while self.j_engine.has_work():
                for o in self.j_engine.step():
                    text += o.text
        return text

    def held(self):
        """(requests in flight, live pages: used less cached)."""
        stats = self.server.stats()
        (w,) = stats["worker_statuses"]
        return stats["requests_in_flight"], \
            w["memory_used_pages"] - w["pages_cached"]

    def active(self) -> int:
        """The active-requests gauge."""
        return self.server.metrics.snapshot().active_requests

    def close(self):
        pgrpc.stop_grpc(self.grpc, grace=1.0)
        self.server.shutdown(drain_timeout_s=5.0)


@pytest.fixture(scope="module")
def stack():
    s = Stack()
    yield s
    s.close()


@pytest.fixture(params=["json", "proto"])
def client(stack, request):
    with pgrpc.GrpcClient(stack.target, wire=request.param) as c:
        yield c


def _jax_client(stack, wire, fn):
    """``await fn(client)`` with the JAX package's ``GrpcClient``."""
    async def main():
        c = jgrpc.GrpcClient(stack.target, wire=wire)
        try:
            return await fn(c)
        finally:
            await c.close()

    return asyncio.run(main())


def _strip(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in ("id", "created")}


def _joined(events) -> str:
    return "".join(e.get("token", "") for e in events
                   if e["type"] == "token")


# -- the cases of tests/test_grpc.py, on both wires --------------------------


def test_generate_unary(stack, client):
    resp = client.generate({"prompt": "hello grpc", "max_tokens": 6,
                            **GREEDY})
    assert resp["object"] == "text_completion"
    assert resp["usage"]["completion_tokens"] == 6
    assert resp["choices"][0]["finish_reason"] == "length"
    assert resp["choices"][0]["text"] == stack.jax_text("hello grpc", 6)


def test_generate_stream(stack, client):
    req = {"prompt": "stream over grpc", "max_tokens": 5, **GREEDY}
    events = list(client.generate_stream(req))
    kinds = [e["type"] for e in events]
    assert kinds.count("token") >= 5
    assert kinds[-1] == "done"
    assert events[-1]["usage"]["completion_tokens"] == 5
    # sampled tokens carry logprobs on both wires (held-back-text flushes
    # ride without one)
    assert any(e.get("logprob") is not None for e in events
               if e["type"] == "token")
    want = stack.jax_text("stream over grpc", 5)
    assert _joined(events) == want
    assert client.generate(req)["choices"][0]["text"] == want


def test_chat_and_embeddings(client):
    chat = client.chat({"messages": [{"role": "user", "content": "hi"},
                                     {"role": "system", "content": "brief"}],
                        "max_tokens": 4, **GREEDY})
    assert chat["object"] == "chat.completion"
    assert chat["choices"][0]["message"]["role"] == "assistant"
    frames = list(client.chat_stream({
        "messages": [{"role": "user", "content": "hi"},
                     {"role": "system", "content": "brief"}],
        "max_tokens": 4, **GREEDY}))
    assert frames[-1]["type"] == "done"
    assert _joined(frames) == chat["choices"][0]["message"]["content"]
    emb = client.embeddings({"input": ["one", "two"]})
    assert len(emb["data"]) == 2
    assert len(emb["data"][0]["embedding"]) == TINY.hidden_size
    assert emb["model"] == "tiny-grpc"  # "" on the proto wire is absent


def test_health(stack, client):
    h = client.health()
    assert h["status"] == "ok"
    assert h["accepting"] is True
    assert h["engines"][0]["healthy"] is True
    want = pgrpc.health(stack.server.handler)
    if client._wire == "proto":  # the message's fields, defaults included
        want = protowire.decode("HealthResponse",
                                protowire.encode("HealthResponse", want))
    assert h == want


def test_validation_error_maps_to_invalid_argument(client):
    with pytest.raises(grpc.RpcError) as exc:
        client.generate({"max_tokens": 4})  # no prompt
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    body = json.loads(exc.value.details())
    assert body["error"]["error_type"] == "invalid_request_error"
    with pytest.raises(grpc.RpcError) as exc:
        list(client.generate_stream({"max_tokens": 4}))
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT


@pytest.mark.parametrize("method", ["Generate", "GenerateStream"])
@pytest.mark.parametrize("payload", [b"not json", b"{not json", b"{}"[:1],
                                     b'{"x": 1'])
def test_malformed_payload_rejected(stack, method, payload):
    with grpc.insecure_channel(stack.target) as ch:
        call = (ch.unary_unary if method == "Generate" else ch.unary_stream)(
            f"/{pgrpc.SERVICE}/{method}", request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        with pytest.raises(grpc.RpcError) as exc:
            out = call(payload)
            if method == "GenerateStream":
                list(out)
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_json_that_is_not_an_object_is_invalid_json(stack):
    with grpc.insecure_channel(stack.target) as ch:
        call = ch.unary_unary(f"/{pgrpc.SERVICE}/Generate",
                              request_serializer=lambda b: b,
                              response_deserializer=lambda b: b)
        # '{' first byte, then a body that is not one JSON object
        with pytest.raises(grpc.RpcError) as exc:
            call(b'{"a": 1} [2]')
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert json.loads(exc.value.details())["error"]["code"] == "invalid_json"


@pytest.mark.parametrize("wire", ["json", "proto"])
def test_stream_cancel_aborts_generation(stack, wire):
    """A cancelled stream: the request leaves the engine (no request in
    flight) and its pages go back; the page books stay clean."""
    before = stack.held()
    assert before[0] == 0
    with pgrpc.GrpcClient(stack.target, wire=wire) as c:
        call = c.generate_stream({"prompt": "cancel me " * 4,
                                  "max_tokens": 4000, **GREEDY})
        got = 0
        for _ in call:
            got += 1
            if got >= 2:
                assert stack.held()[0] == 1
                call.cancel()
                break
    # the stream's thread settles the active-requests gauge when its idle
    # check next sees the RPC gone: wait for the gauge too
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and (
            stack.held() != before or stack.active() != 0):
        time.sleep(0.05)
    assert stack.held() == before
    assert stack.server.runner.call(lambda e: e.audit_pages()) == []
    assert stack.active() == 0


def test_idle_stream_cancel_aborts_the_queued_request(stack):
    """A stream cancelled before its first event (its request still
    waiting, the engine busy with another): the idle check sees the RPC
    gone and the request never holds a page afterwards."""
    before = stack.held()
    with pgrpc.GrpcClient(stack.target) as c:
        busy = c.generate_stream({"prompt": "busy " * 4, "max_tokens": 400,
                                  **GREEDY})
        next(iter(busy))
        quiet = c.generate_stream({"prompt": "never read",
                                   "max_tokens": 4000, **GREEDY})
        quiet.cancel()
        busy.cancel()
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and (
            stack.held() != before or stack.active() != 0):
        time.sleep(0.05)
    assert stack.held() == before
    assert stack.server.runner.call(lambda e: e.audit_pages()) == []
    assert stack.active() == 0


class TestProtobufWire:
    def test_differential_json_vs_proto(self, stack):
        req = {"prompt": "differential", "max_tokens": 6, **GREEDY}
        with pgrpc.GrpcClient(stack.target, wire="json") as a, \
                pgrpc.GrpcClient(stack.target, wire="proto") as b:
            assert _strip(a.generate(dict(req))) == \
                _strip(b.generate(dict(req)))

    def test_proto_temperature_zero_distinct_from_absent(self, stack):
        with pgrpc.GrpcClient(stack.target, wire="proto") as c:
            g1 = c.generate({"prompt": "presence", "max_tokens": 5,
                             **GREEDY})
            g2 = c.generate({"prompt": "presence", "max_tokens": 5,
                             **GREEDY})
            assert g1["choices"][0]["text"] == g2["choices"][0]["text"]
            some = c.generate({"prompt": "presence", "max_tokens": 4})
            assert 1 <= some["usage"]["completion_tokens"] <= 4


# -- the JAX package's client against the port's server ----------------------

_CHAT = {"messages": [{"role": "user", "content": "hello there"}],
         "max_tokens": 5, **GREEDY}
_GEN = {"prompt": "same answer", "max_tokens": 6, **GREEDY}


@pytest.mark.parametrize("wire", ["json", "proto"])
@pytest.mark.parametrize("method", ["generate", "chat", "embeddings",
                                    "health", "generate_stream",
                                    "chat_stream"])
def test_jax_client_gets_the_port_clients_answers(stack, wire, method):
    obj = {"generate": _GEN, "generate_stream": _GEN, "chat": _CHAT,
           "chat_stream": _CHAT,
           "embeddings": {"input": ["one", "two words"]}}.get(method)
    streamed = method.endswith("_stream")

    async def jax_side(c):
        if streamed:
            return [e async for e in getattr(c, method)(dict(obj))]
        if method == "health":
            return await c.health()
        return await getattr(c, method)(dict(obj))

    got = _jax_client(stack, wire, jax_side)
    with pgrpc.GrpcClient(stack.target, wire=wire) as c:
        if streamed:
            want = list(getattr(c, method)(dict(obj)))
        elif method == "health":
            want = c.health()
        else:
            want = getattr(c, method)(dict(obj))
    if streamed:
        assert got == want
        assert got[-1]["type"] == "done"
    else:
        assert _strip(got) == _strip(want)
    if method == "generate":
        assert got["choices"][0]["text"] == stack.jax_text(_GEN["prompt"], 6)


def test_jax_client_status_over_the_port(stack):
    async def go(c):
        with pytest.raises(grpc.aio.AioRpcError) as exc:
            await c.generate({"max_tokens": 4})
        return exc.value.code(), exc.value.details()

    code, details = _jax_client(stack, "proto", go)
    assert code == grpc.StatusCode.INVALID_ARGUMENT
    assert "invalid_request_error" in details


# -- the status mapping -------------------------------------------------------


class _Raising:
    """A handler whose calls raise one ``ApiError``."""

    def __init__(self, err):
        self.err = err

    def generate(self, obj):
        raise self.err

    def generate_stream(self, obj, idle=None):
        raise self.err

    chat = embeddings = generate
    chat_stream = generate_stream


_ERRORS = [
    (perr.ValidationApiError(perr.ValidationError("bad")),
     "INVALID_ARGUMENT"),
    (perr.RequestTimeoutApiError(), "DEADLINE_EXCEEDED"),
    (perr.QueueFullApiError(), "UNAVAILABLE"),
    (perr.InternalApiError("boom"), "INTERNAL"),
]


def test_status_mapping_matches_the_jax_module():
    assert {k: v.name for k, v in pgrpc._STATUS.items()} == \
        {k: v.name for k, v in jgrpc._STATUS.items()}


@pytest.mark.parametrize("err,code", _ERRORS + [
    (type("TooMany", (perr.ApiError,), {
        "status_code": lambda self: 429, "error_type": lambda self: "x",
        "code": lambda self: "rate_limited"})("slow down"),
     "RESOURCE_EXHAUSTED")], ids=lambda x: x if isinstance(x, str) else "")
def test_status_mapping(err, code):
    gsrv = pgrpc.build_grpc_server(_Raising(err), max_workers=2)
    gsrv.start()
    try:
        with pgrpc.GrpcClient(f"127.0.0.1:{gsrv.bound_port}") as c:
            for call in (lambda: c.generate({"prompt": "x"}),
                         lambda: list(c.generate_stream({"prompt": "x"}))):
                with pytest.raises(grpc.RpcError) as exc:
                    call()
                assert exc.value.code().name == code
                body = json.loads(exc.value.details())["error"]
                assert body == {"message": str(err),
                                "error_type": err.error_type(),
                                "code": err.code()}
    finally:
        pgrpc.stop_grpc(gsrv, grace=0.5)


# -- the entry point ---------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_entry_point_serves_grpc():
    """``--server-grpc-port`` starts the transport beside HTTP, the
    startup line names it, and SIGTERM stops both."""
    http_port, grpc_port = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_inference_server_tpu_torch",
         "--model-model-name", "tiny", "--device", "cpu",
         "--model-dtype", "float32", "--engine-warmup-compile", "false",
         "--engine-num-pages", "64", "--engine-max-pages-per-seq", "16",
         "--engine-max-batch", "4", "--server-host", "127.0.0.1",
         "--server-port", str(http_port), "--server-grpc-port",
         str(grpc_port)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "serving" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "the server exited"
        assert line.rstrip().endswith(f"(grpc :{grpc_port})"), line
        with pgrpc.GrpcClient(f"127.0.0.1:{grpc_port}") as c:
            h = None
            while time.monotonic() < deadline:
                try:
                    h = c.health(timeout=5)
                    break
                except grpc.RpcError:
                    time.sleep(0.2)
            assert h is not None and h["status"] == "ok", h
            resp = c.generate({"prompt": "entry", "max_tokens": 3, **GREEDY},
                              timeout=60)
            assert resp["usage"]["completion_tokens"] == 3
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
