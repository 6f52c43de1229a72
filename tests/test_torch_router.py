"""The port's cross-host router (``serving/router.py``, on the standard
library) against the JAX package's (aiohttp).

Two port backends serve TINY on the CPU in float32 (module scope). The
cases of ``tests/test_distributed.py::TestRouter`` run against the port's
router in front of them, and:

- the JAX ``Router`` / ``build_router_app`` and the port's router, in front
  of the same two backends, give the same statuses and bodies (less ids
  and times) for every route, and the same ``/health`` and
  ``/server/stats`` keys;
- a streamed request passes through unbuffered, its frames joining into
  the non-streamed text;
- a client that closes its stream through the router leaves the backend
  with no request in flight and no page held;
- the counters stay exact under concurrent requests from more threads
  than cores;
- the entry point exits 2 with ``config error:`` on an empty
  ``--backends``, and the module imports no ``torch``.
"""

import asyncio
import concurrent.futures as cf
import http.client
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PagedCacheConfig,
)
from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)
from distributed_inference_server_tpu_torch.serving import router as prouter
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GREEDY = {"temperature": 0.0}


def _params():
    p = llama.init_params(TINY, torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu")
    # scaled so greedy continuations vary
    p["embed"] = p["embed"] * 8
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        p["layers"][k] = p["layers"][k] * 8
    return p


@pytest.fixture(scope="module")
def backends():
    params = _params()

    def factory():
        return LLMEngine(params, TINY, ByteTokenizer(), EngineConfig(
            max_batch=2, prefill_buckets=(16, 64),
            paged=PagedCacheConfig(64, 8, 32)), dtype=torch.float32,
            device="cpu")

    servers, urls = [], []
    for name in ("host-a", "host-b"):
        srv = InferenceServer(factory, ByteTokenizer(), name,
                              auto_restart=False)
        srv.start()
        port = srv.serve("127.0.0.1", 0, block=False)
        servers.append(srv)
        urls.append(f"http://127.0.0.1:{port}")
    yield servers, urls
    for srv in servers:
        srv.shutdown(drain_timeout_s=5.0)


class RouterUnderTest:
    """The port's router on an ephemeral port, serving on a thread."""

    def __init__(self, urls, **kw):
        kw.setdefault("health_check_interval_s", 0.2)
        self.router = prouter.Router(prouter.RouterConfig(backends=urls,
                                                          **kw))
        self.httpd = prouter.serve(self.router, "127.0.0.1", 0)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.router.close()
        self._thread.join(10)
        assert not self._thread.is_alive()


@pytest.fixture
def route(backends):
    made = []

    def make(**kw):
        r = RouterUnderTest(backends[1], **kw)
        made.append(r)
        return r

    yield make
    for r in made:
        r.close()


def _call(method, url, body=None, raw=None, timeout=120):
    """(status, content type, body bytes)."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get_content_type(), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get_content_type(), e.read()


def _post(url, body):
    status, _, raw = _call("POST", url, body)
    return status, json.loads(raw)


def _frames(raw: bytes):
    return [json.loads(line[6:]) for line in raw.decode().splitlines()
            if line.startswith("data: {")]


def _text(frames) -> str:
    return "".join(f.get("token", "") for f in frames if f["type"] == "token")


def _processed(backends):
    """Each backend's requests processed, by its own ``/server/stats``."""
    return [json.loads(_call("GET", url + "/server/stats")[2])
            ["worker_statuses"][0]["total_processed"]
            for url in backends[1]]


# -- the cases of tests/test_distributed.py::TestRouter -----------------------


def test_v1_alias_via_router(route):
    r = route()
    status, body = _post(r.base + "/v1/completions", {
        "prompt": "hello fleet", "max_tokens": 4, **GREEDY,
        "stop": ["zz_never"]})
    assert status == 200
    assert body["object"] == "text_completion"
    assert body["usage"]["completion_tokens"] == 4


def test_generate_via_router(route, backends):
    r = route()
    req = {"prompt": "hello fleet", "max_tokens": 6, **GREEDY}
    status, body = _post(r.base + "/generate", req)
    assert status == 200
    assert body["usage"]["completion_tokens"] == 6
    assert sum(b.total for b in r.router.backends) == 1
    # the routed text is the backend's own
    _, direct = _post(backends[1][0] + "/generate", req)
    assert body["choices"][0]["text"] == direct["choices"][0]["text"]


def test_round_robin_spreads_load(route, backends):
    r = route(strategy="round_robin")
    before = _processed(backends)
    for _ in range(4):
        status, _ = _post(r.base + "/generate", {
            "prompt": "spread", "max_tokens": 2, **GREEDY})
        assert status == 200
    assert sorted(b.total for b in r.router.backends) == [2, 2]
    after = _processed(backends)
    assert [a - b for a, b in zip(after, before)] == [2, 2]


def test_least_loaded_prefers_the_idle_backend(route):
    """A long stream holds one backend; the next request goes to the
    other."""
    r = route()
    conn = http.client.HTTPConnection("127.0.0.1",
                                      r.httpd.server_address[1], timeout=60)
    conn.request("POST", "/generate", json.dumps({
        "prompt": "hold on", "max_tokens": 120, "stream": True, **GREEDY}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.read1(64)
    busy = next(b for b in r.router.backends if b.active == 1)
    status, _ = _post(r.base + "/generate", {"prompt": "x", "max_tokens": 1})
    assert status == 200
    idle = next(b for b in r.router.backends if b is not busy)
    assert (busy.total, idle.total) == (1, 1)
    while resp.read1(65536):
        pass
    conn.close()


def test_sse_stream_passthrough(route):
    r = route()
    req = {"prompt": "stream me", "max_tokens": 24, **GREEDY}
    conn = http.client.HTTPConnection("127.0.0.1",
                                      r.httpd.server_address[1], timeout=60)
    conn.request("POST", "/generate", json.dumps({**req, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    assert resp.getheader("Cache-Control") == "no-cache"
    pieces = []
    while True:
        piece = resp.read1(65536)
        if not piece:
            break
        pieces.append(piece)
    conn.close()
    raw = b"".join(pieces)
    # unbuffered: the frames arrive in more than one piece
    assert len(pieces) > 1
    assert raw.rstrip().endswith(b"data: [DONE]")
    events = _frames(raw)
    kinds = [e["type"] for e in events]
    assert kinds.count("token") >= 24
    assert kinds[-1] == "done"
    assert events[-1]["usage"]["completion_tokens"] == 24
    _, body = _post(r.base + "/generate", req)
    assert _text(events) == body["choices"][0]["text"]


def _quiet(route):
    """A router whose health loop has run its first round and waits a
    minute for the next: a test's own marks are not overwritten."""
    r = route(health_check_interval_s=60.0)
    deadline = time.monotonic() + 30
    while not all(b.last_check for b in r.router.backends):
        assert time.monotonic() < deadline, "no health round"
        time.sleep(0.01)
    return r


def test_dead_backend_failover(route):
    r = _quiet(route)
    # poison one backend with an unreachable address
    r.router.backends[0].base_url = "http://127.0.0.1:1"
    status, _ = _post(r.base + "/generate", {
        "prompt": "failover", "max_tokens": 3, **GREEDY})
    assert status == 200  # retried on the healthy backend
    assert not r.router.backends[0].healthy
    assert r.router.backends[0].last_error
    status, _, raw = _call("GET", r.base + "/health")
    body = json.loads(raw)
    assert status == 200 and body["status"] == "ok"
    assert body["backends"][0]["healthy"] is False
    assert body["backends"][0]["last_error"]


def test_all_dead_returns_503(route):
    r = _quiet(route)
    for b in r.router.backends:
        b.healthy = False
    status, body = _post(r.base + "/generate", {"prompt": "nope",
                                                "max_tokens": 1})
    assert status == 503
    assert body["error"]["code"] == "no_backend"


def test_dead_urls_only_answer_503(backends):
    r = RouterUnderTest(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                        health_check_interval_s=60.0)
    try:
        status, body = _post(r.base + "/generate", {"prompt": "nope",
                                                    "max_tokens": 1})
        assert status == 503
        assert body["error"]["code"] == "no_backend"
        assert all(not b.healthy and b.last_error
                   for b in r.router.backends)
        assert _call("GET", r.base + "/health")[0] == 503
    finally:
        r.close()


def test_health_aggregation_and_recovery(route):
    r = route()
    status, _, raw = _call("GET", r.base + "/health")
    body = json.loads(raw)
    assert status == 200
    assert body["status"] == "ok"
    assert len(body["backends"]) == 2
    # mark one unhealthy; the health loop reinstates it
    r.router.backends[0].healthy = False
    deadline = time.monotonic() + 5.0
    while not r.router.backends[0].healthy and time.monotonic() < deadline:
        time.sleep(0.05)
    assert r.router.backends[0].healthy  # recovered by the loop


def test_stats_aggregation(route, backends):
    r = route()
    status, _, raw = _call("GET", r.base + "/server/stats")
    body = json.loads(raw)
    assert status == 200
    assert set(body["backends"]) == set(backends[1])
    assert len(body["router"]) == 2
    assert all("worker_statuses" in s for s in body["backends"].values())


def test_validation_errors_pass_through(route):
    r = route()
    status, body = _post(r.base + "/generate", {"max_tokens": 1})
    assert status == 400  # the backend's validator error, not retried
    assert body["error"]["error_type"] == "invalid_request_error"
    assert sum(b.total for b in r.router.backends) == 1


def test_router_config_validation():
    with pytest.raises(ValueError):
        prouter.Router(prouter.RouterConfig(backends=[]))
    with pytest.raises(ValueError):
        prouter.Router(prouter.RouterConfig(backends=["http://x"],
                                            strategy="nope"))


# -- the port's own cases -----------------------------------------------------


def test_client_close_mid_stream_aborts_on_the_backend(route, backends):
    """The client goes away mid-stream: the router closes its backend
    connection, and the backend aborts the request (none in flight, its
    pages back, the books clean)."""
    r = route()

    def held():
        out = []
        for srv in backends[0]:
            stats = srv.stats()
            (w,) = stats["worker_statuses"]
            out.append((stats["requests_in_flight"],
                        w["memory_used_pages"] - w["pages_cached"]))
        return out

    before = held()
    assert all(n == 0 for n, _ in before)
    conn = http.client.HTTPConnection("127.0.0.1",
                                      r.httpd.server_address[1], timeout=60)
    conn.request("POST", "/generate", json.dumps({
        "prompt": "a long stream " * 4, "max_tokens": 200, "stream": True,
        **GREEDY}), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200 and resp.read1(64)
    assert sum(n for n, _ in held()) == 1
    conn.sock.close()
    conn.close()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (
            held() != before
            or any(b.active for b in r.router.backends)):
        time.sleep(0.05)
    assert held() == before
    assert [b.active for b in r.router.backends] == [0, 0]
    for srv in backends[0]:
        assert srv.runner.call(lambda e: e.audit_pages()) == []


class _Stub(BaseHTTPRequestHandler):
    """A backend that answers at once: ``/health`` ok, any POST its
    server's port."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, obj):
        raw = json.dumps(obj).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def do_GET(self):  # noqa: N802
        self._send({"status": "ok"})

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self._send({"port": self.server.server_address[1]})


@pytest.mark.parametrize("strategy", ["round_robin", "least_loaded"])
def test_counters_are_exact_under_concurrency(strategy):
    """More client threads than cores, a short switch interval: every
    request is counted once on one backend, none stays in flight, and
    round robin splits them evenly."""
    stubs = [ThreadingHTTPServer(("127.0.0.1", 0), _Stub) for _ in range(3)]
    for s in stubs:
        s.daemon_threads = True
        threading.Thread(target=s.serve_forever, daemon=True).start()
    r = RouterUnderTest([f"http://127.0.0.1:{s.server_address[1]}"
                         for s in stubs], strategy=strategy,
                        health_check_interval_s=60.0)
    n_threads, per = (os.cpu_count() or 2) + 4, 30
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(_):
            got = []
            for _ in range(per):
                status, body = _post(r.base + "/generate", {})
                assert status == 200
                got.append(body["port"])
            return got

        with cf.ThreadPoolExecutor(n_threads) as ex:
            ports = [p for got in ex.map(work, range(n_threads))
                     for p in got]
    finally:
        sys.setswitchinterval(old)
        r.close()
        for s in stubs:
            s.shutdown()
            s.server_close()
    total = n_threads * per
    assert len(ports) == total
    counts = [b.total for b in r.router.backends]
    assert sum(counts) == total
    assert [b.active for b in r.router.backends] == [0, 0, 0]
    assert counts == [ports.count(s.server_address[1]) for s in stubs]
    if strategy == "round_robin":
        assert max(counts) - min(counts) <= 1


# -- the JAX router against the port's ---------------------------------------

_REQUESTS = [
    ("POST", "/generate", {"prompt": "same text", "max_tokens": 6, **GREEDY}),
    ("POST", "/chat", {"messages": [{"role": "user", "content": "hi"}],
                       "max_tokens": 5, **GREEDY}),
    ("POST", "/embeddings", {"input": ["one", "two words"]}),
    ("POST", "/v1/completions", {"prompt": "v1 text", "max_tokens": 4,
                                 **GREEDY}),
    ("POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hey"}], "max_tokens": 4,
        **GREEDY}),
    ("POST", "/v1/embeddings", {"input": "one"}),
    ("POST", "/generate", {"max_tokens": 1}),  # 400 from the backend
    ("POST", "/generate", b"{not json"),  # 400 invalid_json
    ("POST", "/generate", {"prompt": "streamed", "max_tokens": 8,
                           "stream": True, **GREEDY}),
    ("POST", "/nowhere", {}),
    ("GET", "/generate", None),
]


def _strip(obj):
    if isinstance(obj, dict):
        return {k: v for k, v in obj.items() if k not in ("id", "created")}
    return obj


def _drive(base: str) -> list:
    out = []
    for method, path, body in _REQUESTS:
        raw = body if isinstance(body, bytes) else None
        status, ctype, payload = _call(method, base + path,
                                       None if raw else body, raw=raw)
        if ctype == "application/json":
            payload = _strip(json.loads(payload))
        elif ctype == "text/event-stream":
            payload = _frames(payload)
        out.append((status, ctype, payload))
    for path in ("/health", "/server/stats"):
        status, ctype, payload = _call("GET", base + path)
        body = json.loads(payload)
        keys = (sorted(body), sorted(body["backends"][0])
                if path == "/health" else sorted(body["router"][0]))
        out.append((status, ctype, keys))
    return out


def _through_jax_router(urls) -> list:
    from aiohttp import web

    from distributed_inference_server_tpu.serving.router import (
        Router as JRouter,
    )
    from distributed_inference_server_tpu.serving.router import (
        RouterConfig as JRouterConfig,
    )
    from distributed_inference_server_tpu.serving.router import (
        build_router_app as j_build,
    )

    async def main():
        router = JRouter(JRouterConfig(backends=urls,
                                       strategy="round_robin",
                                       health_check_interval_s=0.2))
        runner = web.AppRunner(j_build(router))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, _drive, f"http://127.0.0.1:{port}")
        finally:
            await runner.cleanup()

    return asyncio.run(main())


def test_jax_router_and_port_router_agree(route, backends):
    got = _drive(route(strategy="round_robin").base)
    want = _through_jax_router(backends[1])
    assert len(got) == len(want)
    for (method, path, _), g, w in zip(
            _REQUESTS + [("GET", "/health", 0), ("GET", "/server/stats", 0)],
            got, want):
        assert g == w, (method, path)
    assert [g[0] for g in got[:len(_REQUESTS)]] == [
        200, 200, 200, 200, 200, 200, 400, 400, 200, 404, 405]


# -- the entry point ----------------------------------------------------------


def test_entry_point_exits_2_on_empty_backends(capsys):
    assert prouter.main(["--backends", ","]) == 2
    assert capsys.readouterr().err.startswith(
        "config error: router needs at least one backend")
    out = subprocess.run(
        [sys.executable, "-m",
         "distributed_inference_server_tpu_torch.serving.router",
         "--backends", ""], cwd=ROOT, capture_output=True, text=True,
        timeout=60)
    assert out.returncode == 2
    assert out.stderr.startswith("config error:")


def test_router_module_imports_no_torch():
    script = ("import sys; import distributed_inference_server_tpu_torch."
              "serving.router; print(sorted(k for k in sys.modules if "
              "k.split('.')[0] in ('torch', 'numpy', 'grpc', 'aiohttp')))")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
