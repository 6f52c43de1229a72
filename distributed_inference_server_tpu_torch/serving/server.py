"""Inference server: one engine runner behind a standard-library HTTP
server (the counterpart of ``distributed_inference_server_tpu/serving/
server.py`` and ``handler.py`` for the ``/generate`` path).

``generate`` validates and tokenizes a ``GenerateRequest``, submits it to
the ``EngineRunner`` with a collecting sink, waits, and returns a
``GenerateResponse`` exactly as the JAX handler builds it. ``serve`` runs a
``ThreadingHTTPServer`` (one thread per connection) on the app in
``serving/app.py``. Not in this slice: the multi-replica scheduler, SSE
streaming, ``/chat``, ``/embeddings`` and Prometheus ``/metrics``.
"""

from __future__ import annotations

import threading
import time
from http.server import ThreadingHTTPServer
from typing import Callable, Dict, Optional

import torch

from distributed_inference_server_tpu_torch.core.errors import (
    InternalApiError,
    RequestTimeoutApiError,
    ValidationApiError,
    ValidationError,
)
from distributed_inference_server_tpu_torch.core.models import (
    GenerateChoice,
    GenerateRequest,
    GenerateResponse,
)
from distributed_inference_server_tpu_torch.core.types import new_request_id
from distributed_inference_server_tpu_torch.core.validator import (
    RequestValidator,
)
from distributed_inference_server_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.models.tokenizer import Tokenizer
from distributed_inference_server_tpu_torch.ops import kernels
from distributed_inference_server_tpu_torch.serving.app import make_handler
from distributed_inference_server_tpu_torch.serving.runner import (
    CollectingSink,
    EngineRunner,
    ServerRequest,
)

# a request still unanswered after this long is aborted and gets a 408
REQUEST_TIMEOUT_S = 600.0


class InferenceServer:
    """Serving spine for one engine replica."""

    def __init__(
        self,
        engine_factory: Callable[[], LLMEngine],
        tokenizer: Tokenizer,
        model_name: str,
    ):
        self.tok = tokenizer
        self.model_name = model_name
        self.validator = RequestValidator()
        self.runner = EngineRunner("engine-0", engine_factory)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self.started_at = time.time()

    # -- lifecycle ---------------------------------------------------------

    def start(self, wait_ready: bool = True) -> None:
        self.runner.start(wait_ready=wait_ready)

    def serve(self, host: str = "0.0.0.0", port: int = 8000,
              block: bool = True) -> int:
        """Serve HTTP on ``host:port`` (0 = an ephemeral port). Blocks
        unless ``block`` is False; returns the bound port."""
        self._httpd = ThreadingHTTPServer((host, port), make_handler(self))
        self._httpd.daemon_threads = True
        bound = self._httpd.server_address[1]
        if block:
            self._httpd.serve_forever()
        else:
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever, name="http", daemon=True)
            self._http_thread.start()
        return bound

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(10)
        self.runner.shutdown()

    # -- endpoints ---------------------------------------------------------

    def generate(self, obj: dict) -> GenerateResponse:
        try:
            req = GenerateRequest.from_dict(obj)
            self.validator.validate_generate(req)
        except ValidationError as e:
            raise ValidationApiError(e) from None
        ids = self.tok.encode(req.prompt)
        params = SamplingParams(
            max_tokens=req.max_tokens, temperature=req.temperature,
            top_p=req.top_p, stop_sequences=tuple(req.stop_sequences))
        sink = CollectingSink()
        request_id = new_request_id()
        self.runner.submit(ServerRequest(request_id, ids, params, sink))
        result = sink.wait(REQUEST_TIMEOUT_S)
        if result is None:
            self.runner.abort(request_id)
            raise RequestTimeoutApiError()
        text, reason, usage, err, _code = result
        if err is not None:
            raise InternalApiError(err)
        return GenerateResponse(
            id=f"cmpl-{request_id}",
            object="text_completion",
            created=int(time.time()),
            model=self.model_name,
            choices=(GenerateChoice(text=text, index=0,
                                    finish_reason=reason),),
            usage=usage,
        )

    def kernel_counts(self) -> Dict[str, int]:
        return kernels.launch_counts()

    def reset_kernel_counts(self) -> None:
        kernels.reset_launch_counts()

    def device_name(self) -> str:
        eng_dev = getattr(self.runner._engine, "device", None)
        if eng_dev is not None and eng_dev.type == "cuda":
            return torch.cuda.get_device_name(eng_dev)
        return str(eng_dev)

    def stats(self) -> dict:
        r = self.runner
        cache = None
        if r.is_healthy():
            try:
                cache = r.call(lambda e: e.cache_stats().to_dict())
            except (TimeoutError, RuntimeError):
                cache = None
        return {
            "model": self.model_name,
            "device": self.device_name(),
            "healthy": r.is_healthy(),
            "uptime_s": time.time() - self.started_at,
            "requests_in_flight": r.active_count(),
            "requests_finished": r.requests_finished,
            "tokens_generated": r.tokens_generated,
            "engine_steps": r.steps,
            "engine_step_seconds": r.step_seconds,
            "cache": cache,
            "kernel_launches": self.kernel_counts(),
        }
