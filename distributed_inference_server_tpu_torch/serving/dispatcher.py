"""Dispatcher: queue -> admission batcher -> scheduler -> engine runner,
plus the timeout sweep (port of the single-replica part of
``distributed_inference_server_tpu/serving/dispatcher.py``).

One dispatch thread runs::

    loop:
      sweep queued requests older than the timeout -> 408 queue_timeout
      poll the admission batcher (50 ms window / 32 requests)
      the scheduler picks a runner; the runner admits the batch in order
      idle (queue and window empty): sleep until submit() wakes it or the
      next sweep is due; else wait the poll interval (2 ms)

Backpressure surfaces at ``submit()`` as ``QueueFull`` (503 ``queue_full``)
from the queue's hysteresis, or while the server drains. ``abort`` reaches
a request wherever it is: queued, in the batching window, or in flight.
``shutdown`` stops accepting, drains, and dispatches whatever is still in
the window so no client hangs.

The queue and batcher tiers (``_make_queue`` / ``_make_batcher``): the
native C++ ones (``native/``) when the library builds, the Python ones
otherwise, and always the Python ones under ``tenant_fairness`` (the
native queue has no tenant lanes). The choice is logged and reported as
``tier``.

Not ported yet: redispatch off a dead replica, cache-aware routing and
peer prefix fetch, deadline-aware shedding (``AdmissionShed``), the
degradation ladder's gates. ``SingleRunnerScheduler`` stands in for the
reference's scheduler with its ``schedule()`` / ``engines()`` contract.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Sequence

from distributed_inference_server_tpu_torch.core.errors import QueueFull
from distributed_inference_server_tpu_torch.core.queue import (
    PriorityQueueManager,
    QueueConfig,
    QueuedRequest,
)
from distributed_inference_server_tpu_torch.core.types import (
    Priority,
    RequestId,
)
from distributed_inference_server_tpu_torch.serving.batcher import (
    AdmissionBatcher,
    BatcherConfig,
)
from distributed_inference_server_tpu_torch.serving.metrics import (
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    EngineRunner,
    ServerRequest,
)

logger = logging.getLogger(__name__)


class SingleRunnerScheduler:
    """The scheduler contract over one replica: ``schedule()`` returns the
    runner while it is healthy (None otherwise, which fails the batch with
    ``no_workers``), ``engines()`` lists it."""

    def __init__(self, runner: EngineRunner):
        self._runner = runner

    def schedule(self, prompt_ids: Optional[Sequence[int]] = None
                 ) -> Optional[EngineRunner]:
        return self._runner if self._runner.is_healthy() else None

    def engines(self) -> List[EngineRunner]:
        return [self._runner]


def _make_queue(queue_config: Optional[QueueConfig],
                force: Optional[bool] = None):
    """The queue tier. ``force``: None picks native when it builds, True
    requires native, False takes Python. Tenant fairness takes Python."""
    if queue_config is not None and queue_config.tenant_fairness:
        if force is True:
            raise RuntimeError(
                "native_queue=True is incompatible with "
                "queue.tenant_fairness (the native tier has no tenant "
                "lanes)")
        logger.info("request queue: Python tier (tenant fairness on)")
        return PriorityQueueManager(queue_config)
    if force is not False:
        from distributed_inference_server_tpu_torch import native

        if native.available():
            logger.info("request queue: native C++ tier")
            return native.NativePriorityQueue(queue_config)
        if force is True:
            raise RuntimeError(
                "native_queue=True but the native library is unavailable")
    logger.info("request queue: Python tier")
    return PriorityQueueManager(queue_config)


def _make_batcher(queue, batcher_config: Optional[BatcherConfig]):
    """The batcher tier follows the queue's: a native queue gets the native
    batcher (one native poll drains the queue), else the Python one."""
    from distributed_inference_server_tpu_torch import native

    if isinstance(queue, native.NativePriorityQueue):
        return native.NativeAdmissionBatcher(queue, batcher_config)
    return AdmissionBatcher(queue, batcher_config)


class Dispatcher:
    """Owns the queue, the batcher and the dispatch / sweep thread."""

    def __init__(self, scheduler: SingleRunnerScheduler,
                 queue_config: Optional[QueueConfig] = None,
                 batcher_config: Optional[BatcherConfig] = None,
                 metrics: Optional[MetricsCollector] = None,
                 poll_interval_s: float = 0.002,
                 native_queue: Optional[bool] = None):
        self.scheduler = scheduler
        self.queue = _make_queue(queue_config, native_queue)
        self.batcher = _make_batcher(self.queue, batcher_config)
        self.metrics = metrics
        self._poll_interval = poll_interval_s
        # monotonic lifecycle flag; readers tolerate one stale poll
        self._accepting = False
        self._stop = threading.Event()
        # set by submit() and shutdown(): ends an idle loop's sleep
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sweep_every_s = 1.0

    @property
    def tier(self) -> str:
        """``native`` or ``python``: the queue (and batcher) tier chosen."""
        from distributed_inference_server_tpu_torch import native

        return ("native" if isinstance(self.queue, native.NativePriorityQueue)
                else "python")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._accepting = True
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="dispatcher",
                                        daemon=True)
        self._thread.start()

    def shutdown(self, drain_timeout_s: float = 30.0) -> None:
        """Stop accepting, wait for the queue, the window and the runners'
        in-flight requests to drain, stop the thread, then dispatch
        whatever is still in the window (the runners keep running until the
        server stops them)."""
        self._accepting = False
        deadline = time.monotonic() + drain_timeout_s
        while time.monotonic() < deadline:
            if (self.queue.is_empty() and self.batcher.pending_count() == 0
                    and not any(r.active_count()
                                for r in self.scheduler.engines())):
                break
            if self._stop.wait(0.01):
                break
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(5.0)
        leftover = self.batcher.flush()
        if leftover is not None:
            self._dispatch(leftover.requests)

    def is_accepting(self) -> bool:
        return self._accepting and self.queue.is_accepting()

    # -- submission (any thread) -------------------------------------------

    def submit(self, request: ServerRequest,
               priority: Priority = Priority.NORMAL) -> None:
        """Enqueue; raises ``QueueFull`` while backpressure is active or the
        server is draining."""
        if not self._accepting:
            raise QueueFull()
        self.queue.enqueue(QueuedRequest(
            id=request.request_id, data=request, priority=priority,
            tenant=request.tenant))
        self._wake.set()
        self._publish_depths()

    def abort(self, request_id: RequestId) -> None:
        """Client went away: drop the request from the queue or the window
        if it was not dispatched yet, else tell the runners (only its
        owner finds it)."""
        if self.queue.cancel(request_id) is not None:
            return
        if self.batcher.cancel(request_id) is not None:
            return
        for runner in self.scheduler.engines():
            runner.abort(request_id)

    # -- dispatch thread ---------------------------------------------------

    def _loop(self) -> None:
        last_sweep = time.monotonic()
        while not self._stop.is_set():
            now = time.monotonic()
            if now - last_sweep >= self._sweep_every_s:
                self._sweep(now)
                last_sweep = now
            batch = self.batcher.poll(now)
            if batch is None and not self._accepting:
                batch = self.batcher.flush(now)
            if batch is not None:
                self._dispatch(batch.requests)
                continue
            # cleared before the emptiness check: a submit after it sets
            # the event again, so the sleep below cannot miss a request
            self._wake.clear()
            if (self._accepting and self.queue.is_empty()
                    and self.batcher.pending_count() == 0):
                # nothing queued and no window open: the poll would find
                # nothing until a submit, so sleep until one (or the sweep)
                self._wake.wait(max(0.0, self._sweep_every_s
                                    - (time.monotonic() - last_sweep)))
            else:
                self._stop.wait(self._poll_interval)

    def _dispatch(self, queued: List[QueuedRequest]) -> None:
        requests = [q.data for q in queued]
        if self.metrics:
            lens = [len(r.prompt_ids) for r in requests]
            pad = (max(lens) * len(lens) / max(sum(lens), 1) - 1.0
                   if lens else 0.0)
            self.metrics.record_batch(len(requests), max(0.0, pad))
        runner = self.scheduler.schedule()
        if runner is None:
            for r in requests:
                r.sink.on_error("no healthy inference engine available",
                                "no_workers")
        else:
            runner.submit(requests)
        self._publish_depths()

    def _publish_depths(self) -> None:
        if self.metrics:
            d = self.queue.queue_depth()
            self.metrics.set_queue_depth(d.high, d.normal, d.low)
            # the native tier has no tenant lanes
            if hasattr(self.queue, "tenant_depths"):
                self.metrics.set_tenant_depths(self.queue.tenant_depths())

    def _sweep(self, now: float) -> None:
        """Expire queued requests older than the timeout: 408 with the
        distinct ``queue_timeout`` code (no engine ever started them), each
        counted in ``requests_expired_total``."""
        expired = self.queue.remove_expired(now)
        for q in expired:
            q.data.sink.on_error("request expired in queue before dispatch",
                                 "queue_timeout")
        if expired and self.metrics:
            self.metrics.record_expired(len(expired))
        if expired:
            self._publish_depths()
