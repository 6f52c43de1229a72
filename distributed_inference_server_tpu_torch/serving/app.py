"""HTTP transport on the standard library (the counterpart of
``distributed_inference_server_tpu/serving/app.py``, whose aiohttp stack is
not available where the port runs).

- ``POST /generate`` — non-streaming, the JAX package's request and
  response schema (``core/models.py``);
- ``GET /health`` — liveness of the engine;
- ``GET /server/stats`` — request, token and cache counters, the mixed
  step's traffic (``mixed``, null when it is off), the engine's step clock
  (``step_clock``), device memory (``memory``), the warmup's duration and
  each kernel's launch count;
- ``POST /server/kernel_counts/reset`` — zero the kernels' launch counts
  (a measurement run brackets the path it measures with it);
- ``POST /server/profile`` — body ``{"steps": N}`` (optional
  ``timeout_s``, default 30): trace the card over the next N engine steps
  with ``torch.profiler`` and return the window's device busy time and
  share (``utils/profiler.py``); 409 with an ``error`` when the trace
  could not run (no card, another trace, an idle engine).

Errors are ``ErrorResponse`` JSON with the reference's status mapping
(400 validation, 408 timeout, 500 engine failure).
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler
from typing import TYPE_CHECKING

from distributed_inference_server_tpu_torch.core.errors import ApiError
from distributed_inference_server_tpu_torch.core.models import ErrorResponse

if TYPE_CHECKING:
    from distributed_inference_server_tpu_torch.serving.server import (
        InferenceServer,
    )

MAX_BODY_BYTES = 8 << 20


class _InvalidBody(ApiError):
    def __init__(self, msg: str):
        super().__init__(f"Validation error: {msg}")

    def status_code(self) -> int:
        return 400

    def error_type(self) -> str:
        return "invalid_request_error"

    def code(self) -> str:
        return "invalid_json"


def make_handler(server: "InferenceServer") -> type:
    """A ``BaseHTTPRequestHandler`` class bound to ``server``."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "dis-torch"

        def log_message(self, fmt, *args) -> None:  # quiet access log
            pass

        def _send(self, status: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_error(self, err: ApiError) -> None:
            self._send(err.status_code(), ErrorResponse.of(
                str(err), err.error_type(), err.code()).to_dict())

        def _json_body(self) -> dict:
            n = int(self.headers.get("Content-Length") or 0)
            if n > MAX_BODY_BYTES:
                raise _InvalidBody("request body too large")
            raw = self.rfile.read(n) if n else b""
            try:
                obj = json.loads(raw.decode() or "null")
            except (UnicodeDecodeError, json.JSONDecodeError):
                raise _InvalidBody("request body is not valid JSON") from None
            if not isinstance(obj, dict):
                raise _InvalidBody("request body must be a JSON object")
            return obj

        def do_GET(self) -> None:  # noqa: N802 — http.server API
            if self.path == "/health":
                ok = server.runner.is_healthy()
                self._send(200 if ok else 503, {
                    "status": "ok" if ok else "unhealthy",
                    "model": server.model_name,
                    "device": server.device_name(),
                    "error": None if ok else server.runner.last_error(),
                })
            elif self.path == "/server/stats":
                self._send(200, server.stats())
            else:
                self._send(404, {"error": {"message": "not found",
                                           "error_type": "not_found",
                                           "code": "not_found"}})

        def do_POST(self) -> None:  # noqa: N802 — http.server API
            try:
                if self.path == "/generate":
                    resp = server.generate(self._json_body())
                    self._send(200, resp.to_dict())
                elif self.path == "/server/profile":
                    obj = self._json_body()
                    steps = obj.get("steps")
                    timeout_s = obj.get("timeout_s", 30.0)
                    if (not isinstance(steps, int) or isinstance(steps, bool)
                            or not 1 <= steps <= 1000):
                        raise _InvalidBody(
                            "'steps' must be an integer in [1, 1000]")
                    if (not isinstance(timeout_s, (int, float))
                            or not 0 < timeout_s <= 600):
                        raise _InvalidBody("'timeout_s' must be in (0, 600]")
                    result = server.runner.profile_steps(steps, timeout_s)
                    self._send(409 if "error" in result else 200, result)
                elif self.path == "/server/kernel_counts/reset":
                    server.reset_kernel_counts()
                    self._send(200, {"kernel_launches":
                                     server.kernel_counts()})
                else:
                    self._send(404, {"error": {"message": "not found",
                                               "error_type": "not_found",
                                               "code": "not_found"}})
            except ApiError as e:
                self._send_error(e)

    return Handler
