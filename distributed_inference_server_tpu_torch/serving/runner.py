"""Engine runner: a dedicated thread owning one ``LLMEngine`` (port of
``distributed_inference_server_tpu/serving/runner.py``: ``EngineRunner``,
its inbox, the per-request result sinks, the embeddings jobs and the
metrics hooks).

The engine is single-owner and synchronous; every interaction with it —
admission, aborts, embeddings jobs, counter reads that touch engine state —
goes through a thread-safe inbox drained on the runner thread between
steps. Step outputs fan out to per-request ``ResultSink``s
(``serving/streamer.py``); a sink with a ``flush`` method gets one call
per step in which it received events.

Embeddings (``submit_embed``) run as incremental jobs: one device batch
(``engine.embed_step``) per loop iteration, between engine steps, so a
large embeddings request never stalls the decoding requests.

Requests arrive as admission batches from the dispatcher
(``serving/dispatcher.py``), which has already recorded the batch.

Metrics (``serving/metrics.py``): each request's time to first token
(``submitted_at``, its arrival at the admission queue, to
``first_token_at``), tokens and engine-step seconds as they happen;
``status()`` hands the engine's cumulative counters (cache, mixed step,
looped blocks, step clock, waiting queue, speculation) to the collector
when it is read.

Failure semantics: a per-request failure arrives as ``StepOutput.error``
and fails only that request; an exception escaping the step loop marks the
runner unhealthy and fails every in-flight request and embeddings job.

With ``EngineConfig.warmup_compile`` set, the runner runs
``engine.warmup()`` (every serving program once; on ``cuda`` every CUDA
graph captured) before it reports ready, and keeps its duration in
``warmup_seconds``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import (Callable, Deque, Dict, List, Optional, Protocol,
                    Sequence)

import numpy as np

from distributed_inference_server_tpu_torch.core.models import (
    FinishReason,
    Usage,
)
from distributed_inference_server_tpu_torch.core.types import (
    DEFAULT_TENANT,
    RequestId,
)
from distributed_inference_server_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
    StepOutput,
)
from distributed_inference_server_tpu_torch.serving.metrics import (
    EngineStatus,
    MetricsCollector,
)

logger = logging.getLogger(__name__)

EmbedCallback = Callable[[Optional[np.ndarray], Optional[str]], None]


class ResultSink(Protocol):
    """Receives one request's outputs, on the runner thread; methods must
    not block or raise."""

    def on_token(self, token_id: Optional[int], text: str, token_index: int,
                 logprob: Optional[float] = None) -> None: ...

    def on_done(self, finish_reason: FinishReason, usage: Usage) -> None: ...

    def on_error(self, message: str, code: str) -> None: ...


class ServerRequest:
    """A validated, tokenized request on its way to the runner (through the
    admission queue); ``tenant`` is its fair-admission lane."""

    __slots__ = ("request_id", "prompt_ids", "params", "sink",
                 "submitted_at", "first_token_at", "tenant")

    def __init__(self, request_id: RequestId, prompt_ids: List[int],
                 params: SamplingParams, sink: ResultSink,
                 tenant: str = DEFAULT_TENANT):
        self.request_id = request_id
        self.prompt_ids = prompt_ids
        self.params = params
        self.sink = sink
        self.tenant = tenant
        self.submitted_at = time.monotonic()
        self.first_token_at: Optional[float] = None


class EngineRunner:
    """Runs one engine on a dedicated thread; thread-safe façade."""

    def __init__(self, engine_id: str,
                 engine_factory: Callable[[], LLMEngine],
                 metrics: MetricsCollector):
        self.engine_id = engine_id
        self._factory = engine_factory
        self.metrics = metrics
        self._inbox: Deque[Callable[[], None]] = deque()
        self._inbox_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._healthy = False
        self._last_error: Optional[str] = None
        self._inflight: Dict[RequestId, ServerRequest] = {}
        self._engine: Optional[LLMEngine] = None
        self._thread: Optional[threading.Thread] = None
        # embeddings: callbacks by job token (each called exactly once)
        # and the queued jobs, oldest first
        self._pending_embeds: Dict[int, EmbedCallback] = {}
        self._embed_seq = 0
        self._embed_lock = threading.Lock()
        self._embed_jobs: Deque[dict] = deque()
        # counters read from other threads (GIL-atomic int updates)
        self.requests_finished = 0
        self.tokens_generated = 0
        self.steps = 0
        self.step_seconds = 0.0
        self.warmup_seconds: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self, wait_ready: bool = True, timeout: float = 600.0) -> None:
        """Spawn the runner thread; optionally block until the engine is
        built and the runner reports ready."""
        ready = threading.Event()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, args=(ready,), name=f"engine-{self.engine_id}",
            daemon=True)
        self._thread.start()
        if wait_ready and not ready.wait(timeout):
            raise TimeoutError(
                f"engine {self.engine_id} failed to start in {timeout}s")
        if wait_ready and not self._healthy:
            raise RuntimeError(f"engine {self.engine_id} failed to "
                               f"initialize: {self._last_error}")

    def shutdown(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
        self._healthy = False
        self.metrics.set_engine_up(self.engine_id, False)
        self._fail_all("engine shut down before request completion")

    # -- submission (any thread) -------------------------------------------

    def submit(self, requests: Sequence[ServerRequest]) -> None:
        """Admit one admission batch: its requests reach the engine in the
        batch's order (strict priority, then FIFO)."""
        reqs = list(requests)
        # registered here, not on the runner thread: a crash before the
        # inbox drains still fails these sinks
        for r in reqs:
            self._inflight[r.request_id] = r
        if not self._healthy:
            for r in reqs:
                self._fail(r, self._last_error or "engine unavailable")
            return

        def _do() -> None:
            for r in reqs:
                if r.request_id in self._inflight:  # not aborted meanwhile
                    self._engine.add_request(r.request_id, r.prompt_ids,
                                             r.params)

        self._post(_do)

    def abort(self, request_id: RequestId) -> None:
        """Drop a request: its pages go back to the allocator; its sink
        gets no further callback."""
        self._inflight.pop(request_id, None)

        def _do() -> None:
            self._engine.abort(request_id)

        self._post(_do)

    def submit_embed(self, ids_list: List[List[int]],
                     on_result: EmbedCallback) -> None:
        """Queue an embeddings job; ``on_result(array, error)`` is called
        exactly once: on the runner thread, or here or at a crash when
        the engine is (or becomes) unavailable."""
        with self._embed_lock:
            # registered before the health check: a crash in between
            # still finds (and fails) the callback
            self._embed_seq += 1
            token = self._embed_seq
            self._pending_embeds[token] = on_result
        if not self._healthy:
            self._resolve_embed(token, None,
                                self._last_error or "engine unavailable")
            return

        def _enqueue() -> None:
            try:
                state = self._engine.embed_start(ids_list)
            except Exception as e:  # noqa: BLE001 — called exactly once
                self._resolve_embed(token, None, str(e))
                return
            self._embed_jobs.append({"token": token, "state": state})

        self._post(_enqueue)

    def call(self, fn: Callable[[LLMEngine], object],
             timeout: float = 30.0) -> object:
        """Run ``fn(engine)`` on the runner thread and return its result
        (engine state is single-owner)."""
        box: list = []
        done = threading.Event()

        def _do() -> None:
            try:
                box.append(fn(self._engine))
            finally:
                done.set()

        self._post(_do)
        if not done.wait(timeout):
            raise TimeoutError("engine thread did not answer")
        if not box:
            raise RuntimeError("engine call failed")
        return box[0]

    def profile_steps(self, n: int, timeout_s: float = 30.0) -> dict:
        """A device trace over the next ``n`` engine steps (the engine
        starts and stops it between steps, on its own thread). Blocks up
        to ``timeout_s`` for it to finish (an idle engine only traces once
        work arrives). Returns the summary, or a dict with ``error``."""
        if not self._healthy:
            return {"error": self._last_error or "engine unavailable"}
        box: dict = {}
        armed = threading.Event()

        def _do() -> None:
            box["ev"], box["holder"] = self._engine.profile_steps(n)
            armed.set()

        self._post(_do)
        if not armed.wait(timeout_s):
            return {"error": "engine thread did not arm the trace in time"}
        if not box["ev"].wait(timeout_s):
            self._post(lambda: self._engine.cancel_profile(box["holder"]))
            return {"error": f"trace did not complete within {timeout_s}s "
                             "(engine idle? send traffic while tracing)"}
        return dict(box["holder"])

    def reset_speculation(self) -> None:
        """Clear every request pattern's acceptance tracker, on the engine
        thread: speculation is enabled again with fresh windows (a no-op
        without a draft model)."""

        def _do() -> None:
            if self._engine.spec_trackers is not None:
                self._engine.spec_trackers.reset()

        self._post(_do)

    def set_mixed_prefill_frac(self, frac: float) -> None:
        """Shrink (or restore) the mixed step's prefill share, on the
        engine thread (a no-op while the mixed step is off)."""

        def _do() -> None:
            self._engine.set_mixed_prefill_frac(frac)

        self._post(_do)

    def _post(self, fn: Callable[[], None]) -> None:
        with self._inbox_lock:
            self._inbox.append(fn)
        self._wake.set()

    # -- status (any thread) -----------------------------------------------

    def is_healthy(self) -> bool:
        return self._healthy

    def last_error(self) -> Optional[str]:
        return self._last_error

    def active_count(self) -> int:
        return len(self._inflight)

    def status(self) -> EngineStatus:
        """This replica's ``EngineStatus``. The engine's page and queue
        counts and its cumulative counters are read on the runner thread
        and handed to the collector (zeros, and the collector untouched,
        when it cannot answer)."""
        used = total = cached = waiting = 0
        mixed = loop = speculation = host_tier = latent = None
        if self._healthy:
            try:
                (s, waiting, mixed, loop, clock, speculation, host_tier,
                 latent, payload, reloads) = self.call(
                    lambda e: (e.cache_stats(), e.num_waiting(),
                               e.mixed_stats(), e.loop_stats(),
                               e.step_clock_stats(), e.spec_stats(),
                               e.host_tier_stats(), e.latent_stats(),
                               e.payload_byte_counters(),
                               e.drain_reload_durations()))
                total, cached = s.pages_total, s.pages_cached
                used = total - s.pages_free
                self.metrics.observe_engine(
                    self.engine_id, s, mixed, loop, clock,
                    host_tier=host_tier, payload=payload, reloads=reloads,
                    latent=latent)
                if speculation is not None:
                    self.metrics.set_speculation(self.engine_id, speculation)
            except (TimeoutError, RuntimeError) as e:
                self._absorbed("status", e)
        return EngineStatus(
            engine_id=self.engine_id, healthy=self._healthy,
            active_requests=len(self._inflight), waiting_requests=waiting,
            total_processed=self.requests_finished,
            memory_used_pages=used, memory_total_pages=total,
            pages_cached=cached, speculation=speculation, mixed=mixed,
            loop=loop, host_tier=host_tier, latent=latent)

    # -- runner thread -----------------------------------------------------

    def _run(self, ready: threading.Event) -> None:
        try:
            self._engine = self._factory()
            if self._engine.ecfg.warmup_compile:
                # every serving program before reporting ready: the first
                # request must not pay graph capture in its latency
                t0 = time.monotonic()
                self._engine.warmup()
                self.warmup_seconds = time.monotonic() - t0
            self._healthy = True
        except Exception as e:  # noqa: BLE001 — startup failure isolation
            logger.exception("engine %s failed to start", self.engine_id)
            self._last_error = str(e)
            self._healthy = False
            ready.set()
            return
        finally:
            self.metrics.set_engine_up(self.engine_id, self._healthy)
        ready.set()
        try:
            while not self._stop.is_set():
                self._drain_inbox()
                worked = False
                if self._engine.has_work():
                    worked = True
                    t0 = time.monotonic()
                    outputs = self._engine.step()
                    dt = time.monotonic() - t0
                    self.step_seconds += dt
                    self.steps += 1
                    self.metrics.record_inference(dt)
                    self._dispatch(outputs)
                worked |= self._embed_quantum()
                if not worked:
                    self._wake.wait(0.005)
                    self._wake.clear()
        except Exception as e:  # noqa: BLE001 — engine-level crash
            logger.exception("engine %s crashed", self.engine_id)
            self._last_error = str(e)
            self._healthy = False
            self.metrics.set_engine_up(self.engine_id, False)
            self._fail_all(str(e))

    def _drain_inbox(self) -> None:
        while True:
            with self._inbox_lock:
                if not self._inbox:
                    break
                fn = self._inbox.popleft()
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — command isolation
                self._absorbed("inbox", e)

    def _embed_quantum(self) -> bool:
        """Advance the oldest embeddings job by one device batch. Returns
        True if it did work."""
        if not self._embed_jobs:
            return False
        job = self._embed_jobs[0]
        if job["token"] not in self._pending_embeds:
            self._embed_jobs.popleft()  # failed by a crash handler
            return True
        result = error = None
        try:
            if self._engine.embed_step(job["state"]):
                result = self._engine.embed_finish(job["state"])
        except Exception as e:  # noqa: BLE001 — isolation boundary
            error = str(e)
        if result is not None or error is not None:
            self._embed_jobs.popleft()
            self._resolve_embed(job["token"], result, error)
        return True

    def _resolve_embed(self, token: int, result, error) -> None:
        with self._embed_lock:
            cb = self._pending_embeds.pop(token, None)
        if cb is not None:
            try:
                cb(result, error)
            except Exception as e:  # noqa: BLE001 — callback isolation
                self._absorbed("embed_callback", e)

    def _dispatch(self, outputs: List[StepOutput]) -> None:
        tokens = 0
        touched = {}
        for out in outputs:
            req = self._inflight.get(out.request_id)
            if req is None:
                continue
            touched[out.request_id] = req.sink
            try:
                if out.error is not None:
                    req.sink.on_error(out.error, "inference_failed")
                elif out.token_id is not None or out.text:
                    if req.first_token_at is None:
                        req.first_token_at = time.monotonic()
                        self.metrics.record_ttft(
                            req.first_token_at - req.submitted_at)
                    if out.token_id is not None:
                        tokens += 1
                    if not out.finished:
                        req.sink.on_token(out.token_id, out.text,
                                          out.token_index, out.logprob)
                if out.finished:
                    if out.error is None:
                        if out.text:  # final delta rides the done event
                            req.sink.on_token(None, out.text,
                                              out.token_index)
                        req.sink.on_done(out.finish_reason
                                         or FinishReason.STOP,
                                         out.usage or Usage())
                    self._inflight.pop(out.request_id, None)
                    self.requests_finished += 1
            except Exception as e:  # noqa: BLE001 — sink isolation
                self._absorbed("sink", e)
                self._inflight.pop(out.request_id, None)
        for sink in touched.values():
            flush = getattr(sink, "flush", None)
            if flush is not None:
                flush()
        self.tokens_generated += tokens
        self.metrics.record_tokens(tokens)

    def _absorbed(self, site: str, exc: BaseException) -> None:
        """An exception eaten at an isolation boundary: logged, kept as
        the last error and counted in ``errors_total``."""
        logger.warning("runner %s: %s absorbed: %s", self.engine_id, site,
                       exc)
        self._last_error = f"{site}: {exc}"
        self.metrics.record_error(f"runner.{site}")

    def _fail(self, req: ServerRequest, message: str) -> None:
        self._inflight.pop(req.request_id, None)
        try:
            req.sink.on_error(message, "engine_unavailable")
        except Exception as e:  # noqa: BLE001 — sink isolation
            self._absorbed("sink", e)

    def _fail_all(self, message: str) -> None:
        for req in list(self._inflight.values()):
            self._fail(req, message)
        with self._embed_lock:
            tokens = list(self._pending_embeds)
        for token in tokens:
            self._resolve_embed(token, None, message)
