"""Inference server: one engine runner behind a standard-library HTTP
server (the counterpart of ``distributed_inference_server_tpu/serving/
server.py`` for one replica).

It wires the ``MetricsCollector``, the ``EngineRunner`` (which records
into it) and the ``InferenceHandler`` (``serving/handler.py``: the
``/generate``, ``/chat``, ``/v1/*`` and ``/embeddings`` lifecycles), and
``serve`` runs a ``ThreadingHTTPServer`` (one thread per connection) on
the app in ``serving/app.py``. Not in this slice: the multi-replica
scheduler, its admission queue, and the fleet.
"""

from __future__ import annotations

import threading
import time
from http.server import ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

import torch

from distributed_inference_server_tpu_torch.engine.engine import LLMEngine
from distributed_inference_server_tpu_torch.models.tokenizer import Tokenizer
from distributed_inference_server_tpu_torch.ops import kernels
from distributed_inference_server_tpu_torch.serving.app import make_handler
from distributed_inference_server_tpu_torch.serving.handler import (
    InferenceHandler,
)
from distributed_inference_server_tpu_torch.serving.metrics import (
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    EngineRunner,
)


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
        self.metrics = MetricsCollector()
        self.runner = EngineRunner("engine-0", engine_factory, self.metrics)
        self.handler = InferenceHandler(self.runner, tokenizer, model_name,
                                        self.metrics)
        self._accepting = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self.started_at = time.time()

    # -- lifecycle ---------------------------------------------------------

    def start(self, wait_ready: bool = True) -> None:
        self.runner.start(wait_ready=wait_ready)
        self._accepting = True

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
        self._accepting = False
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(10)
        self.runner.shutdown()

    # -- endpoints ---------------------------------------------------------

    def kernel_counts(self) -> Dict[str, int]:
        return kernels.launch_counts()

    def reset_kernel_counts(self) -> None:
        kernels.reset_launch_counts()

    def device_name(self) -> str:
        eng_dev = getattr(self.runner._engine, "device", None)
        if eng_dev is not None and eng_dev.type == "cuda":
            return torch.cuda.get_device_name(eng_dev)
        return str(eng_dev)

    def health(self) -> Tuple[int, dict]:
        """``/health``: the reference's ``{status, accepting, engines}``
        and the port's ``model``, ``device`` and the runner's last error;
        503 while the engine is unhealthy."""
        status = self.runner.status()
        return (200 if status.healthy else 503), {
            "status": "ok" if status.healthy else "unhealthy",
            "accepting": self._accepting,
            "engines": [status.to_dict()],
            "model": self.model_name,
            "device": self.device_name(),
            "error": None if status.healthy else self.runner.last_error(),
        }

    def metrics_text(self) -> bytes:
        """``/metrics``: the collector's Prometheus text, with the
        engine's cumulative counters read at this scrape."""
        self.runner.status()
        return self.metrics.prometheus_text()

    def stats(self) -> dict:
        """``/server/stats``: the ``MetricsSnapshot`` (its ``cache`` block
        with the allocator's page counts added) and the port's blocks:
        ``mixed`` (the engine's ``mixed_stats()``, null while the mixed
        step is off), ``loop`` (``loop_stats()``, null while looped blocks
        are off), ``step_clock`` (host wall time, dispatches, tokens and
        rows per dispatch kind, and the pressure events), ``memory``
        (device memory, null on the CPU), the warmup's seconds, the
        runner's counters and each kernel's launch count."""
        r = self.runner
        status = r.status()
        out = self.metrics.snapshot((status,)).to_dict()
        cache = step_clock = memory = None
        if r.is_healthy():
            try:
                cache, step_clock, memory = r.call(lambda e: (
                    e.cache_stats().to_dict(), e.step_clock_stats(),
                    e.memory_stats()))
            except (TimeoutError, RuntimeError):
                pass
        out["cache"] = {**out["cache"], **(cache or {})}
        out.update({
            "model": self.model_name,
            "device": self.device_name(),
            "healthy": r.is_healthy(),
            "uptime_s": time.time() - self.started_at,
            "requests_in_flight": r.active_count(),
            "requests_finished": r.requests_finished,
            "tokens_generated": r.tokens_generated,
            "engine_steps": r.steps,
            "engine_step_seconds": r.step_seconds,
            "warmup_s": r.warmup_seconds,
            "mixed": status.mixed,
            "loop": status.loop,
            "step_clock": step_clock,
            "memory": memory,
            "kernel_launches": self.kernel_counts(),
        })
        return out
