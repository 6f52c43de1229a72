"""Windowed admission batcher (port of
``distributed_inference_server_tpu/serving/batcher.py``).

A batch is dispatched when the batching window expires (default 50 ms
after its first request) or it reaches ``max_batch_size`` (default 32),
whichever comes first; requests enter it in the strict priority order of
``PriorityQueueManager.dequeue_batch``. Every batch holds 1 to
``max_batch_size`` requests, and a request waits at most one window while
there is room.

The batch is an admission unit, not an execution shape: the runner hands
its requests to the engine in order, and each joins the continuous
decode pool on its own (prefill chunks and the mixed step shape the
device work). Deterministic for tests: ``poll(now)`` takes the clock.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Generic, List, Optional, TypeVar

from distributed_inference_server_tpu_torch.core.queue import (
    PriorityQueueManager,
    QueuedRequest,
)
from distributed_inference_server_tpu_torch.core.types import BatchId, new_batch_id

T = TypeVar("T")


@dataclass(frozen=True)
class BatcherConfig:
    """The reference defaults: a 50 ms window, at most 32 requests."""

    window_ms: float = 50.0
    max_batch_size: int = 32


@dataclass
class AdmissionBatch(Generic[T]):
    """One dispatched admission batch (no padded tensors: the engine is
    paged, so nothing is padded to the longest prompt here)."""

    batch_id: BatchId
    requests: List[QueuedRequest[T]]
    created_at: float

    def __len__(self) -> int:
        return len(self.requests)


class AdmissionBatcher(Generic[T]):
    """Collects queued requests into window/size-bounded batches."""

    def __init__(
        self,
        queue: PriorityQueueManager[T],
        config: Optional[BatcherConfig] = None,
    ):
        self.queue = queue
        self.config = config or BatcherConfig()
        # effective cap = max_batch_size // size_divisor (1 until a
        # degradation controller throttles admission)
        self.size_divisor = 1
        self._pending: List[QueuedRequest[T]] = []
        self._window_opened: Optional[float] = None
        # poll/flush run on the dispatch thread; cancel() arrives from the
        # event loop on client disconnect
        self._lock = threading.Lock()

    def pending_count(self) -> int:
        return len(self._pending)

    def cancel(self, request_id) -> Optional[QueuedRequest[T]]:
        """Remove a request still waiting in the batching window (client
        disconnected between dequeue and dispatch)."""
        with self._lock:
            for i, req in enumerate(self._pending):
                if req.id == request_id:
                    removed = self._pending.pop(i)
                    if not self._pending:
                        self._window_opened = None
                    return removed
        return None

    def effective_max_batch(self) -> int:
        return max(1, self.config.max_batch_size // max(1, self.size_divisor))

    def poll(self, now: Optional[float] = None) -> Optional[AdmissionBatch[T]]:
        """Pull from the queue; return a batch if the size cap is reached or
        the window has expired with at least one request."""
        now = time.monotonic() if now is None else now
        with self._lock:
            cap = self.effective_max_batch()
            room = cap - len(self._pending)
            if room > 0:
                pulled = self.queue.dequeue_batch(room)
                if pulled and self._window_opened is None:
                    self._window_opened = now
                self._pending.extend(pulled)

            if not self._pending:
                return None
            window_expired = (
                self._window_opened is not None
                and (now - self._window_opened) * 1000.0 >= self.config.window_ms
            )
            if len(self._pending) >= cap or window_expired:
                batch = AdmissionBatch(
                    batch_id=new_batch_id(),
                    requests=self._pending,
                    created_at=now,
                )
                self._pending = []
                self._window_opened = None
                return batch
            return None

    def flush(self, now: Optional[float] = None) -> Optional[AdmissionBatch[T]]:
        """Dispatch whatever is pending immediately (shutdown drain)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if not self._pending:
                return None
            batch = AdmissionBatch(new_batch_id(), self._pending, now)
            self._pending = []
            self._window_opened = None
            return batch
