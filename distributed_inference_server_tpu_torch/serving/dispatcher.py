"""Dispatcher: queue -> admission batcher -> scheduler -> engine runners,
plus the timeout sweep and crash-safe redispatch (port of
``distributed_inference_server_tpu/serving/dispatcher.py``).

One dispatch thread runs::

    loop:
      sweep queued requests older than the timeout -> 408 queue_timeout
      poll the admission batcher (50 ms window / 32 requests)
      the scheduler picks a runner (cache_aware: one per request, a
        "fetch" plan handed to the PrefixFetcher); the runner admits its
        requests in order
      idle (queue and window empty): sleep until submit() wakes it or the
      next sweep is due; else wait the poll interval (2 ms)

Backpressure surfaces at ``submit()`` as ``QueueFull`` (503 ``queue_full``)
from the queue's hysteresis, or while the server drains. ``abort`` reaches
a request wherever it is: queued, in the batching window, in a peer
fetch, in the migration queue, or in flight. ``shutdown`` stops
accepting, drains (in-flight migrations and fetches included), and
dispatches whatever is still in the window so no client hangs.
``redispatch`` takes a zero-token request off a dead replica and runs it
on a healthy one, at most ``max_redispatch`` times.

The queue and batcher tiers (``_make_queue`` / ``_make_batcher``): the
native C++ ones (``native/``) when the library builds, the Python ones
otherwise, and always the Python ones under ``tenant_fairness`` (the
native queue has no tenant lanes). The choice is logged and reported as
``tier``.

Admission control at ``submit``: the degradation ladder's gates
(``reject_all``, ``reject_low_priority``: 503 ``queue_full``), then
deadline-aware shedding (``admission``, ``serving/health.py``
``AdmissionControl``: ``AdmissionShed``, answered 503 ``admission_shed``
with ``Retry-After``). Admits feed the shared ``retry_budget``, from which
redispatch draws. With a ``tracer`` each admission batch that reaches a
replica gets a ``batch.dispatch`` span and its requests' spans a
``dispatched`` event; with a ``recorder`` the schedule and route
decisions, sheds, expiries and redispatch hops land in the requests'
timelines.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

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
    ServerRequest,
)
from distributed_inference_server_tpu_torch.serving.scheduler import (
    AdaptiveScheduler,
    SchedulingStrategy,
)

logger = logging.getLogger(__name__)


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

    def __init__(self, scheduler: AdaptiveScheduler,
                 queue_config: Optional[QueueConfig] = None,
                 batcher_config: Optional[BatcherConfig] = None,
                 metrics: Optional[MetricsCollector] = None,
                 poll_interval_s: float = 0.002,
                 native_queue: Optional[bool] = None,
                 disagg=None, max_redispatch: int = 2,
                 prefix_fetcher=None, tracer=None, recorder=None,
                 admission=None, retry_budget=None):
        """``disagg``: the ``DisaggController`` of a disaggregated
        topology (its migrations count toward the drain, aborts reach
        requests parked there). ``max_redispatch``: moves off a dead
        replica per request before it fails to its client (0 = off).
        ``prefix_fetcher``: the ``PrefixFetcher`` that carries out the
        cache_aware "fetch" decisions (None: they degrade to plain
        submission). ``tracer`` / ``recorder``: the spans and the
        flight-recorder notes (None: off). ``admission``: the
        ``AdmissionControl`` that sheds at submit (None: no shedding).
        ``retry_budget``: the shared ``RetryBudget`` that admits feed and
        redispatch draws from (None: unbudgeted)."""
        self.scheduler = scheduler
        self.disagg = disagg
        self.prefix_fetcher = prefix_fetcher
        self.max_redispatch = max_redispatch
        self.tracer = tracer
        self.recorder = recorder
        self.admission = admission
        self.retry_budget = retry_budget
        # the degradation ladder's gates (serving/degradation.py)
        self.reject_low_priority = False
        self.reject_all = False
        # registry HA's front door (serving/fleet_ha.py): with
        # fleet.standby_http false the server sets RegistryHA.is_primary
        # here, and a standby turns ingress away (QueueFull) until it
        # holds the lease. Only submit() asks it: redispatch and the
        # fleet's own paths go straight to runners.
        self.ingress_gate: Optional[Callable[[], bool]] = None
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
                                for r in self.scheduler.engines())
                    and (self.disagg is None
                         or self.disagg.pending_count() == 0)
                    and (self.prefix_fetcher is None
                         or self.prefix_fetcher.pending_count() == 0)):
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
        """Enqueue; raises ``QueueFull`` while backpressure is active, the
        server is draining or a degradation gate is shut, and its
        ``AdmissionShed`` subclass when deadline-aware admission sheds the
        request."""
        if not self._accepting or self.reject_all:
            raise QueueFull()
        if self.ingress_gate is not None and not self.ingress_gate():
            raise QueueFull()
        if self.reject_low_priority and priority is Priority.LOW:
            raise QueueFull()
        tenant = request.tenant or "default"
        if self.admission is not None:
            shed = self.admission.check(tenant)
            if shed is not None:
                if self.metrics:
                    self.metrics.record_shed(tenant, shed.reason)
                if self.recorder is not None:
                    # the shed is the request's whole timeline
                    self.recorder.note(
                        request.request_id, "admission_shed",
                        tenant=tenant, reason=shed.reason,
                        estimate_ms=round(shed.estimate_ms, 3),
                        deadline_ms=round(shed.deadline_ms, 3),
                        retry_after_s=shed.retry_after_s)
                    self.recorder.finish(request.request_id, "error",
                                         code="admission_shed")
                raise shed
        if self.retry_budget is not None:
            self.retry_budget.note_admit()
        self.queue.enqueue(QueuedRequest(
            id=request.request_id, data=request, priority=priority,
            tenant=tenant))
        self._wake.set()
        self._publish_depths()

    def redispatch(self, request: ServerRequest, from_engine: str,
                   reason: str) -> bool:
        """A runner died with ``request`` in flight having streamed no
        token: run it from scratch on a healthy replica, unseen by the
        client. Called from the dead runner's ``_fail_all_of`` (any
        thread); True when this dispatcher took the request (it reaches
        exactly one terminal event on its new replica), False when the
        caller must fail it (draining, budget used up, or no healthy
        replica). The caller already removed the request from its own
        in-flight map, and ``runner.submit`` registers it with exactly
        one new owner; a submit racing the new replica's own crash comes
        back here with the count already raised, so ``max_redispatch``
        bounds the recursion."""
        if self.max_redispatch <= 0:
            return False  # off: not an "exhausted" budget
        if not self._accepting:
            return False  # draining: the crash error is the truth
        if request.redispatches >= self.max_redispatch:
            if self.metrics:
                self.metrics.record_redispatch("exhausted")
            return False
        if (self.retry_budget is not None
                and not self.retry_budget.acquire("redispatch")):
            if self.metrics:
                self.metrics.record_redispatch("exhausted")
            return False
        runner = self.scheduler.schedule(request.prompt_ids)
        if runner is None:
            if self.metrics:
                self.metrics.record_redispatch("exhausted")
            return False
        request.redispatches += 1
        logger.info("redispatching %s from %s to %s (%s)",
                    request.request_id, from_engine, runner.engine_id,
                    reason)
        if self.tracer is not None and request.span is not None:
            request.span.set(redispatch_from=from_engine,
                             redispatch_to=runner.engine_id,
                             redispatch_reason=reason)
            request.span.event("redispatched", from_engine=from_engine,
                               to_engine=runner.engine_id, reason=reason)
        if self.recorder is not None:
            self.recorder.note(request.request_id, "redispatch",
                               from_engine=from_engine,
                               to_engine=runner.engine_id, reason=reason,
                               attempt=request.redispatches)
        runner.submit([request])
        # counted after submit took the request
        if self.metrics:
            self.metrics.record_redispatch("ok")
        return True

    def abort(self, request_id: RequestId) -> None:
        """Client went away: drop the request from the queue or the window
        if it was not dispatched yet, flag it in a peer fetch or the
        migration queue, else tell the runners (only its owner finds
        it)."""
        if self.queue.cancel(request_id) is not None:
            return
        if self.batcher.cancel(request_id) is not None:
            return
        if (self.prefix_fetcher is not None
                and self.prefix_fetcher.abort(request_id)):
            return
        if self.disagg is not None and self.disagg.abort(request_id):
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
        for runner, reqs in self._route(requests):
            self._submit_group(runner, reqs)
        self._publish_depths()

    def _submit_group(self, runner, requests: List[ServerRequest]) -> None:
        if runner is None:
            # no healthy replica: fail the batch, gracefully
            for r in requests:
                if self.tracer is not None and r.span is not None:
                    r.span.set(dispatch_failed="no_workers")
                    r.span.event("dispatch_failed", reason="no_workers")
                if self.recorder is not None:
                    self.recorder.finish(r.request_id, "error",
                                         code="no_workers")
                r.sink.on_error("no healthy inference engine available",
                                "no_workers")
            return
        if self.recorder is not None:
            strategy = self.scheduler.strategy().value
            for r in requests:
                self.recorder.note(r.request_id, "schedule",
                                   engine=runner.engine_id,
                                   strategy=strategy)
        if self.tracer is not None:
            with self.tracer.span(
                    "batch.dispatch", size=len(requests),
                    engine_id=runner.engine_id,
                    request_ids=[str(r.request_id) for r in requests]):
                for r in requests:
                    if r.span is not None:
                        r.span.event("dispatched")
        runner.submit(requests)

    def _route(self, requests: List[ServerRequest]) -> list:
        """``(runner, requests)`` groups for one admission batch.
        cache_aware routes per request against one snapshot of the
        replicas (two requests of a window may be warm on different
        replicas): with a fetcher by the three-way cost model, whose
        "fetch" requests go to the ``PrefixFetcher`` (the warm peer's
        pages land on the cold replica before the request does), else by
        matched depth. Every other strategy sends the batch to one
        replica."""
        strategy = self.scheduler.strategy()
        if strategy is not SchedulingStrategy.CACHE_AWARE:
            return [(self.scheduler.schedule(), requests)]
        prompts = [r.prompt_ids for r in requests]
        if self.prefix_fetcher is None:
            picks = zip(requests, self.scheduler.schedule_batch(prompts))
        else:
            picks = []
            for r, (runner, plan) in zip(
                    requests, self.scheduler.schedule_batch_plans(prompts)):
                decision = plan.decision if plan is not None else "recompute"
                if self.recorder is not None and plan is not None:
                    # the decision with its cost terms: "why there"
                    self.recorder.note(
                        r.request_id, "route_plan", strategy="cache_aware",
                        decision=decision, engine=plan.engine_id,
                        depth=plan.depth, peer_depth=plan.peer_depth,
                        **({"peer": plan.peer_id} if plan.peer_id else {}))
                if decision == "fetch" and runner is not None:
                    peer = self.scheduler.get(plan.peer_id)
                    if peer is not None:
                        if self.metrics:
                            self.metrics.record_prefix_route("fetch")
                        if self.tracer is not None and r.span is not None:
                            r.span.set(prefix_fetch_from=peer.engine_id,
                                       prefix_fetch_to=runner.engine_id)
                            r.span.event("prefix_fetch")
                        self.prefix_fetcher.fetch_then_submit(
                            runner, peer, r, plan)
                        continue
                    # the peer left since the snapshot: serve without it
                    decision = "warm" if plan.depth else "recompute"
                if self.metrics and runner is not None:
                    self.metrics.record_prefix_route(decision)
                picks.append((r, runner))
        groups: dict = {}
        for r, runner in picks:
            key = runner.engine_id if runner is not None else None
            groups.setdefault(key, (runner, []))[1].append(r)
        return list(groups.values())

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
            if self.recorder is not None:
                self.recorder.finish(q.data.request_id, "error",
                                     code="queue_timeout")
            q.data.sink.on_error("request expired in queue before dispatch",
                                 "queue_timeout")
        if expired and self.metrics:
            self.metrics.record_expired(len(expired))
        if expired:
            self._publish_depths()
