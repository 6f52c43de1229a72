"""Engine runner: a dedicated thread owning one ``LLMEngine`` (port of
``distributed_inference_server_tpu/serving/runner.py``: ``EngineRunner``,
its inbox and the per-request result sinks).

The engine is single-owner and synchronous; every interaction with it —
admission, aborts, counter reads that touch engine state — goes through a
thread-safe inbox drained on the runner thread between steps. Step outputs
fan out to per-request ``ResultSink``s.

Failure semantics: a per-request failure arrives as ``StepOutput.error``
and fails only that request; an exception escaping the step loop marks the
runner unhealthy and fails every in-flight request.

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
from typing import Callable, Deque, Dict, List, Optional, Protocol

from distributed_inference_server_tpu_torch.core.models import (
    FinishReason,
    Usage,
)
from distributed_inference_server_tpu_torch.core.types import RequestId
from distributed_inference_server_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
    StepOutput,
)

logger = logging.getLogger(__name__)


class ResultSink(Protocol):
    """Receives one request's outputs, on the runner thread; methods must
    not block or raise."""

    def on_token(self, token_id: Optional[int], text: str, token_index: int,
                 logprob: Optional[float] = None) -> None: ...

    def on_done(self, finish_reason: FinishReason, usage: Usage) -> None: ...

    def on_error(self, message: str, code: str) -> None: ...


class CollectingSink:
    """Sink for a non-streaming response: accumulates the text and
    resolves a ``threading.Event`` with ``(text, finish_reason, usage,
    error, code)``."""

    def __init__(self) -> None:
        self._parts: List[str] = []
        self.result = None
        self._done = threading.Event()

    def on_token(self, token_id, text, token_index, logprob=None) -> None:
        if text:
            self._parts.append(text)

    def on_done(self, finish_reason: FinishReason, usage: Usage) -> None:
        self.result = ("".join(self._parts), finish_reason, usage, None, None)
        self._done.set()

    def on_error(self, message: str, code: str) -> None:
        self.result = (None, None, None, message, code)
        self._done.set()

    def wait(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            return None
        return self.result


class ServerRequest:
    """A validated, tokenized request handed to the runner."""

    __slots__ = ("request_id", "prompt_ids", "params", "sink")

    def __init__(self, request_id: RequestId, prompt_ids: List[int],
                 params: SamplingParams, sink: ResultSink):
        self.request_id = request_id
        self.prompt_ids = prompt_ids
        self.params = params
        self.sink = sink


class EngineRunner:
    """Runs one engine on a dedicated thread; thread-safe façade."""

    def __init__(self, engine_id: str,
                 engine_factory: Callable[[], LLMEngine]):
        self.engine_id = engine_id
        self._factory = engine_factory
        self._inbox: Deque[Callable[[], None]] = deque()
        self._inbox_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._healthy = False
        self._last_error: Optional[str] = None
        self._inflight: Dict[RequestId, ServerRequest] = {}
        self._engine: Optional[LLMEngine] = None
        self._thread: Optional[threading.Thread] = None
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
        self._fail_all("engine shut down before request completion")

    # -- submission (any thread) -------------------------------------------

    def submit(self, req: ServerRequest) -> None:
        self._inflight[req.request_id] = req
        if not self._healthy:
            self._fail(req, self._last_error or "engine unavailable")
            return

        def _do() -> None:
            if req.request_id in self._inflight:  # not aborted meanwhile
                self._engine.add_request(req.request_id, req.prompt_ids,
                                         req.params)

        self._post(_do)

    def abort(self, request_id: RequestId) -> None:
        def _do() -> None:
            self._engine.abort(request_id)
            self._inflight.pop(request_id, None)

        self._post(_do)

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
        ready.set()
        try:
            while not self._stop.is_set():
                self._drain_inbox()
                if self._engine.has_work():
                    t0 = time.monotonic()
                    outputs = self._engine.step()
                    self.step_seconds += time.monotonic() - t0
                    self.steps += 1
                    self._dispatch(outputs)
                else:
                    self._wake.wait(0.005)
                    self._wake.clear()
        except Exception as e:  # noqa: BLE001 — engine-level crash
            logger.exception("engine %s crashed", self.engine_id)
            self._last_error = str(e)
            self._healthy = False
            self._fail_all(str(e))

    def _drain_inbox(self) -> None:
        while True:
            with self._inbox_lock:
                if not self._inbox:
                    return
                fn = self._inbox.popleft()
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — command isolation
                self._last_error = str(e)

    def _dispatch(self, outputs: List[StepOutput]) -> None:
        for out in outputs:
            req = self._inflight.get(out.request_id)
            if req is None:
                continue
            try:
                if out.error is not None:
                    req.sink.on_error(out.error, "inference_failed")
                elif out.token_id is not None or out.text:
                    if out.token_id is not None:
                        self.tokens_generated += 1
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
                self._last_error = f"sink error: {e}"
                self._inflight.pop(out.request_id, None)

    def _fail(self, req: ServerRequest, message: str) -> None:
        self._inflight.pop(req.request_id, None)
        try:
            req.sink.on_error(message, "engine_unavailable")
        except Exception:  # noqa: BLE001 — sink isolation
            pass

    def _fail_all(self, message: str) -> None:
        for req in list(self._inflight.values()):
            self._fail(req, message)
