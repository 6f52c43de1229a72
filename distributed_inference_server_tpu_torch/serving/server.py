"""Inference server: one engine runner behind a standard-library HTTP
server (the counterpart of ``distributed_inference_server_tpu/serving/
server.py`` for one replica).

It wires the ``MetricsCollector``, the ``EngineRunner`` (which records
into it), the ``Dispatcher`` in front of it (``serving/dispatcher.py``:
the priority queue with backpressure, the windowed admission batcher and
the timeout sweep; the server starts it after the runner and drains it on
shutdown) and the ``InferenceHandler`` (``serving/handler.py``: the
``/generate``, ``/chat``, ``/v1/*`` and ``/embeddings`` lifecycles), and
``serve`` runs a ``ThreadingHTTPServer`` (one thread per connection) on
the app in ``serving/app.py``. Not ported yet: several replicas behind a
scheduler, and the fleet.
"""

from __future__ import annotations

import threading
import time
from http.server import ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

import torch

from distributed_inference_server_tpu_torch.core.queue import QueueConfig
from distributed_inference_server_tpu_torch.engine.engine import LLMEngine
from distributed_inference_server_tpu_torch.models.tokenizer import Tokenizer
from distributed_inference_server_tpu_torch.ops import kernels
from distributed_inference_server_tpu_torch.serving.app import make_handler
from distributed_inference_server_tpu_torch.serving.batcher import (
    BatcherConfig,
)
from distributed_inference_server_tpu_torch.serving.dispatcher import (
    Dispatcher,
    SingleRunnerScheduler,
)
from distributed_inference_server_tpu_torch.serving.handler import (
    InferenceHandler,
)
from distributed_inference_server_tpu_torch.serving.metrics import (
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    EngineRunner,
)


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: the standard library's 5 drops the connection
    # attempts of a burst beyond it, which the client's TCP retries a
    # second later; 128 is aiohttp's default, the reference's transport
    request_queue_size = 128


class InferenceServer:
    """Serving spine for one engine replica."""

    def __init__(
        self,
        engine_factory: Callable[[], LLMEngine],
        tokenizer: Tokenizer,
        model_name: str,
        queue_config: Optional[QueueConfig] = None,
        batcher_config: Optional[BatcherConfig] = None,
    ):
        """``queue_config`` / ``batcher_config``: the admission queue's
        watermarks, timeout, cap and tenant lanes, and the batching window
        (the reference defaults when None). The queue takes the native C++
        tier when it builds and tenant lanes are off."""
        from distributed_inference_server_tpu_torch import native

        self.tok = tokenizer
        self.model_name = model_name
        self.metrics = MetricsCollector()
        self.runner = EngineRunner("engine-0", engine_factory, self.metrics)
        self.batcher_config = batcher_config or BatcherConfig()
        self.dispatcher = Dispatcher(
            SingleRunnerScheduler(self.runner), queue_config,
            self.batcher_config, self.metrics)
        # the validator's tier, as the reference picks it: native when the
        # library builds
        self.handler = InferenceHandler(self.dispatcher, tokenizer,
                                        model_name, self.metrics,
                                        native.make_validator())
        self._accepting = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self.started_at = time.time()

    # -- lifecycle ---------------------------------------------------------

    def start(self, wait_ready: bool = True) -> None:
        self.runner.start(wait_ready=wait_ready)
        self.dispatcher.start()
        self._accepting = True

    def serve(self, host: str = "0.0.0.0", port: int = 8000,
              block: bool = True) -> int:
        """Serve HTTP on ``host:port`` (0 = an ephemeral port). Blocks
        unless ``block`` is False; returns the bound port."""
        self._httpd = _HTTPServer((host, port), make_handler(self))
        self._httpd.daemon_threads = True
        bound = self._httpd.server_address[1]
        if block:
            self._httpd.serve_forever()
        else:
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever, name="http", daemon=True)
            self._http_thread.start()
        return bound

    def shutdown(self, drain_timeout_s: float = 30.0) -> None:
        """Stop accepting, drain the admission queue and the in-flight
        requests (up to ``drain_timeout_s``), then stop HTTP and the
        runner."""
        self._accepting = False
        self.dispatcher.shutdown(drain_timeout_s)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(10)
        self.runner.shutdown()

    # -- endpoints ---------------------------------------------------------

    def admission_stats(self) -> dict:
        d = self.dispatcher.queue.queue_depth()
        return {
            "tier": self.dispatcher.tier,
            "accepting": self.dispatcher.is_accepting(),
            "queue": {"high": d.high, "normal": d.normal, "low": d.low,
                      "total": d.total},
            "window_ms": self.batcher_config.window_ms,
            "max_batch_size": self.batcher_config.max_batch_size,
        }

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
            "accepting": self._accepting and self.dispatcher.is_accepting(),
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
        with the allocator's page counts and tier, native or python,
        added) and the port's blocks:
        ``mixed`` (the engine's ``mixed_stats()``, null while the mixed
        step is off), ``loop`` (``loop_stats()``, null while looped blocks
        are off), ``step_clock`` (host wall time, dispatches, tokens and
        rows per dispatch kind, and the pressure events), ``admission``
        (the queue tier, native or python, the queue's depth by priority,
        whether it accepts, the batching window and size), ``memory``
        (device memory, null on the CPU), the warmup's seconds, the
        runner's counters and each kernel's launch count."""
        r = self.runner
        status = r.status()
        out = self.metrics.snapshot((status,)).to_dict()
        cache = step_clock = memory = None
        if r.is_healthy():
            try:
                cache, step_clock, memory = r.call(lambda e: (
                    {**e.cache_stats().to_dict(),
                     "allocator_tier": e.allocator_tier()},
                    e.step_clock_stats(), e.memory_stats()))
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
            "admission": self.admission_stats(),
            "mixed": status.mixed,
            "loop": status.loop,
            "step_clock": step_clock,
            "memory": memory,
            "kernel_launches": self.kernel_counts(),
        })
        return out
