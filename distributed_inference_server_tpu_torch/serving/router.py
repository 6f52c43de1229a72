"""Cross-host serving router (the port of
``distributed_inference_server_tpu/serving/router.py``, on the standard
library: the reference's aiohttp stack is not available where the port
runs).

One router process fronts N backend servers (each a normal ``python -m
distributed_inference_server_tpu_torch`` process on its own card or
host). The router:

- routes ``/generate``, ``/chat``, ``/embeddings`` and their ``/v1/*``
  aliases 1:1 to a backend, ``least_loaded`` (the fewest requests in flight
  through this router) or ``round_robin``, over the healthy backends not
  yet tried for the request;
- passes SSE streams through unbuffered: the request counts as streamed
  when its body has ``"stream": true``, and each piece of the backend's
  chunked body is written as a chunk of the router's own reply as soon as
  it arrives; a client that goes away mid-stream closes the backend
  connection, so the backend aborts the request;
- marks a backend it cannot reach unhealthy (``last_error``) and retries
  the request on the next one, answering 503 ``no_backend`` when none is
  left; an HTTP error status from a backend is passed through, not
  retried;
- checks every backend's ``/health`` every ``health_check_interval_s``
  (healthy: status 200 and ``"status": "ok"``), reinstating one that
  recovers;
- aggregates ``GET /health`` (200 while any backend is healthy) and ``GET
  /server/stats``.

Handler threads share the backends' counters and the round-robin counter,
so backend selection and the counters move under one lock.

Run: ``python -m distributed_inference_server_tpu_torch.serving.router
--backends http://host-a:8000,http://host-b:8000 --port 8080``. This module
imports the standard library only (no ``torch``), so the process starts
at once.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import http.client
import itertools
import json
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlsplit

_GONE = (BrokenPipeError, ConnectionResetError, ConnectionAbortedError)
# what a backend dial or exchange raises when the backend is unreachable,
# refuses, resets, times out or answers garbage
_BACKEND_ERRORS = (OSError, http.client.HTTPException)
STATS_TIMEOUT_S = 5.0
MAX_BODY_BYTES = 8 << 20


@dataclass
class BackendState:
    base_url: str
    healthy: bool = True
    active: int = 0  # in-flight requests routed through this router
    total: int = 0
    last_error: Optional[str] = None
    last_check: float = 0.0

    def to_dict(self) -> Dict:
        return {
            "backend": self.base_url,
            "healthy": self.healthy,
            "active_requests": self.active,
            "total_routed": self.total,
            "last_error": self.last_error,
        }


@dataclass
class RouterConfig:
    backends: List[str] = field(default_factory=list)
    strategy: str = "least_loaded"  # or "round_robin"
    health_check_interval_s: float = 1.0
    request_timeout_s: float = 300.0
    connect_timeout_s: float = 5.0


def _connect(base_url: str, connect_timeout_s: float,
             timeout_s: float) -> http.client.HTTPConnection:
    """A connection to ``base_url`` dialled within ``connect_timeout_s``,
    then reading with ``timeout_s`` per socket operation."""
    parts = urlsplit(base_url)
    conn = http.client.HTTPConnection(parts.hostname or "127.0.0.1",
                                      parts.port or 80,
                                      timeout=connect_timeout_s)
    conn.connect()
    conn.sock.settimeout(timeout_s)
    return conn


class Router:
    """Owns backend state, the health loop, and backend selection."""

    def __init__(self, cfg: RouterConfig):
        if not cfg.backends:
            raise ValueError("router needs at least one backend")
        if cfg.strategy not in ("least_loaded", "round_robin"):
            raise ValueError(
                f"strategy must be least_loaded/round_robin, "
                f"got {cfg.strategy!r}"
            )
        self.cfg = cfg
        self.backends = [
            BackendState(b.rstrip("/")) for b in cfg.backends
        ]
        self._rr = itertools.count()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._pool: Optional[cf.ThreadPoolExecutor] = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        # one worker per backend: a dead backend's dial never delays the
        # others' checks or stats
        self._stop.clear()
        self._pool = cf.ThreadPoolExecutor(len(self.backends),
                                           thread_name_prefix="router-io")
        self._health_thread = threading.Thread(
            target=self._health_loop, name="router-health", daemon=True)
        self._health_thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(self.cfg.connect_timeout_s + 5.0)
            self._health_thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def fan_out(self, fn) -> list:
        """``fn(backend)`` for every backend at once; the results in
        backend order."""
        assert self._pool is not None, "router not started"
        return list(self._pool.map(fn, self.backends))

    # -- health ---------------------------------------------------------

    def _health_loop(self) -> None:
        while not self._stop.is_set():
            self.fan_out(self._check)
            self._stop.wait(self.cfg.health_check_interval_s)

    def _check(self, b: BackendState) -> None:
        try:
            conn = _connect(b.base_url, self.cfg.connect_timeout_s,
                            self.cfg.connect_timeout_s)
            try:
                conn.request("GET", "/health")
                resp = conn.getresponse()
                body = json.loads(resp.read() or b"null")
            finally:
                conn.close()
            healthy = (resp.status == 200 and isinstance(body, dict)
                       and body.get("status") == "ok")
            error = None if healthy else f"status {resp.status}"
        except (*_BACKEND_ERRORS, ValueError) as e:  # unreachable = unhealthy
            healthy, error = False, str(e) or type(e).__name__
        with self._lock:
            b.healthy, b.last_error = healthy, error
            b.last_check = time.monotonic()

    # -- selection ------------------------------------------------------

    def _pick(self, exclude: Optional[set]) -> Optional[BackendState]:
        pool = [
            b for b in self.backends
            if b.healthy and (not exclude or b.base_url not in exclude)
        ]
        if not pool:
            return None
        if self.cfg.strategy == "round_robin":
            return pool[next(self._rr) % len(pool)]
        return min(pool, key=lambda b: b.active)

    def acquire(self, exclude: set) -> Optional[BackendState]:
        """Pick a backend not in ``exclude`` and count the request on it
        (in flight and routed), in one step."""
        with self._lock:
            b = self._pick(exclude)
            if b is not None:
                b.active += 1
                b.total += 1
            return b

    def release(self, b: BackendState, error: Optional[str] = None) -> None:
        """The request left ``b``; with ``error``, ``b`` could not be
        reached and is unhealthy until its health check passes."""
        with self._lock:
            b.active -= 1
            if error is not None:
                b.healthy = False
                b.last_error = error

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return [b.to_dict() for b in self.backends]


_UNAVAILABLE = {"error": {"message": "no healthy backend available",
                          "error_type": "service_unavailable_error",
                          "code": "no_backend"}}

PROXY_ROUTES = {
    "/generate": "/generate",
    "/chat": "/chat",
    "/embeddings": "/embeddings",
    # the OpenAI-compatible aliases proxy 1:1: the backend applies the
    # field and wire translation, the router stays dumb
    "/v1/completions": "/v1/completions",
    "/v1/chat/completions": "/v1/chat/completions",
    "/v1/embeddings": "/v1/embeddings",
}
GET_ROUTES = ("/health", "/server/stats")


def build_router_app(router: Router) -> type:
    """A ``BaseHTTPRequestHandler`` class bound to ``router`` (serve it
    with ``ThreadingHTTPServer``; ``router.start()`` first)."""
    cfg = router.cfg

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "dis-torch-router"

        def log_message(self, fmt, *args) -> None:  # quiet access log
            pass

        def _send(self, status: int, body: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, status: int, obj) -> None:
            self._send(status, json.dumps(obj).encode(), "application/json")

        def _plain(self, status: int, text: str) -> None:
            self._send(status, text.encode(), "text/plain")

        def _chunk(self, data: bytes) -> None:
            if data:  # an empty chunk would end the reply
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.flush()

        # -- proxying ----------------------------------------------------

        def _dispatch(self, b: BackendState, path: str, raw: bytes
                      ) -> Tuple[http.client.HTTPConnection,
                                 http.client.HTTPResponse]:
            conn = _connect(b.base_url, cfg.connect_timeout_s,
                            cfg.request_timeout_s)
            try:
                conn.request("POST", path, body=raw,
                             headers={"Content-Type": "application/json"})
                return conn, conn.getresponse()
            except BaseException:
                conn.close()
                raise

        def _relay_stream(self, resp: http.client.HTTPResponse) -> None:
            """The backend's SSE body, piece by piece, as chunks of this
            reply. A client that went away raises out of the write."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self.wfile.flush()
            while True:
                piece = resp.read1(65536)
                if not piece:
                    break
                self._chunk(piece)
            self.wfile.write(b"0\r\n\r\n")

        def _proxy(self, path: str) -> None:
            n = int(self.headers.get("Content-Length") or 0)
            if n > MAX_BODY_BYTES:
                self.close_connection = True
                self._plain(413, "413: Request Entity Too Large")
                return
            try:
                raw = self.rfile.read(n) if n else b""
            except OSError:  # the client went away early
                self.close_connection = True
                return
            streaming = False
            try:
                obj = json.loads(raw or b"{}")
                streaming = isinstance(obj, dict) and \
                    obj.get("stream") is True
            # the peek only decides buffering; the backend parses the
            # body itself and answers 400 to malformed JSON
            except ValueError:
                pass
            tried: set = set()
            while True:
                b = router.acquire(tried)
                if b is None:
                    self._send_json(503, _UNAVAILABLE)
                    return
                tried.add(b.base_url)
                try:
                    conn, resp = self._dispatch(b, path, raw)
                except _BACKEND_ERRORS as e:
                    router.release(b, str(e) or type(e).__name__)
                    continue  # retry on the next healthy backend
                try:
                    if streaming and resp.status == 200:
                        self._relay_stream(resp)
                    else:
                        body = resp.read()
                        self._send(resp.status, body,
                                   resp.headers.get_content_type())
                    return
                except _BACKEND_ERRORS:
                    # the client went away, or the backend broke off its
                    # reply: the reply is cut, and closing the backend
                    # connection makes the backend abort the request
                    self.close_connection = True
                    return
                finally:
                    conn.close()
                    router.release(b)

        # -- aggregation -------------------------------------------------

        def _health(self) -> None:
            backends = router.snapshot()
            healthy = any(b["healthy"] for b in backends)
            self._send_json(200 if healthy else 503, {
                "status": "ok" if healthy else "unhealthy",
                "backends": backends,
            })

        def _stats(self) -> None:
            def one(b: BackendState):
                try:
                    conn = _connect(b.base_url, STATS_TIMEOUT_S,
                                    STATS_TIMEOUT_S)
                    try:
                        conn.request("GET", "/server/stats")
                        return json.loads(conn.getresponse().read())
                    finally:
                        conn.close()
                except (*_BACKEND_ERRORS, ValueError) as e:
                    # a partial aggregation: the backend's error stands in
                    return {"error": str(e) or type(e).__name__}

            results = router.fan_out(one)
            self._send_json(200, {
                "router": router.snapshot(),
                "backends": {b.base_url: r
                             for b, r in zip(router.backends, results)},
            })

        def do_GET(self) -> None:  # noqa: N802 — http.server API
            path = urlsplit(self.path).path
            try:
                if path == "/health":
                    self._health()
                elif path == "/server/stats":
                    self._stats()
                elif path in PROXY_ROUTES:
                    self._plain(405, "405: Method Not Allowed")
                else:
                    self._plain(404, "404: Not Found")
            except _GONE:
                self.close_connection = True

        def do_POST(self) -> None:  # noqa: N802 — http.server API
            path = urlsplit(self.path).path
            try:
                if path in PROXY_ROUTES:
                    self._proxy(PROXY_ROUTES[path])
                elif path in GET_ROUTES:
                    self._plain(405, "405: Method Not Allowed")
                else:
                    self._plain(404, "404: Not Found")
            except _GONE:
                self.close_connection = True

    return Handler


class RouterServer(ThreadingHTTPServer):
    """The router's HTTP server: one thread per connection."""

    daemon_threads = True
    # the listen backlog of aiohttp, the reference's transport (the
    # standard library's 5 drops a burst's connection attempts)
    request_queue_size = 128


def serve(router: Router, host: str = "0.0.0.0", port: int = 8080
          ) -> RouterServer:
    """Start ``router`` and bind its HTTP server at ``host:port`` (0 = an
    ephemeral port: ``server_address[1]``); the caller runs
    ``serve_forever`` and, at the end, ``shutdown``, ``server_close`` and
    ``router.close()``."""
    router.start()
    try:
        return RouterServer((host, port), build_router_app(router))
    except OSError:
        router.close()
        raise


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="distributed-inference-server-tpu-torch-router",
        description="Cross-host request router for the serving fleet",
    )
    parser.add_argument(
        "--backends", required=True,
        help="comma-separated backend base URLs "
             "(http://host-a:8000,http://host-b:8000)",
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument(
        "--strategy", default="least_loaded",
        choices=("least_loaded", "round_robin"),
    )
    parser.add_argument("--health-interval", type=float, default=1.0)
    args = parser.parse_args(argv)

    try:
        router = Router(RouterConfig(
            backends=[b for b in args.backends.split(",") if b],
            strategy=args.strategy,
            health_check_interval_s=args.health_interval,
        ))
    except ValueError as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2
    httpd = serve(router, args.host, args.port)

    def _stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _stop)
    print(f"routing on {args.host}:{httpd.server_address[1]} over "
          f"{len(router.backends)} backends ({args.strategy})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        router.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
