"""Priority queue manager with backpressure hysteresis and optional
per-tenant fair admission (port of
``distributed_inference_server_tpu/core/queue.py``, the whole module).

- Three FIFO levels (High / Normal / Low) drained in strict priority order.
- Hysteresis backpressure: once more than ``high_watermark`` requests are
  queued every ``enqueue`` raises ``QueueFull`` (503 ``queue_full``) until
  the queue falls below ``low_watermark``; ``max_queue_size`` is an
  absolute cap. Re-evaluated under the lock on every mutation.
- ``remove_expired``: requests queued longer than ``request_timeout_s``
  leave in one O(n) rebuild per level (the dispatcher answers them 408
  ``queue_timeout``); ``cancel`` removes one queued request by id.
- Per-tenant fairness (``tenant_fairness``): each level holds one FIFO per
  tenant and dequeue runs deficit round robin across them, weighted by
  ``tenant_weights`` (missing tenants weigh 1.0). Strict priority across
  levels and FIFO within a tenant hold; with one tenant (or the flag off)
  the order is the single FIFO's.

The native C++ tier (``native/pqueue.cpp``) has the same contract without
tenant lanes; the dispatcher takes this Python tier whenever
``tenant_fairness`` is on. Thread-safe: one lock guards every method.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field as dc_field
from typing import Deque, Dict, Generic, List, Mapping, Optional, TypeVar

from distributed_inference_server_tpu_torch.core.errors import QueueFull
from distributed_inference_server_tpu_torch.core.types import (
    DEFAULT_TENANT,
    Priority,
    RequestId,
)

T = TypeVar("T")

#: weights below this are clamped up so DRR always makes progress (a
#: zero-weight tenant would starve forever inside its own priority level)
_MIN_WEIGHT = 0.01


@dataclass(frozen=True)
class QueueConfig:
    """Queue manager configuration.

    ``tenant_fairness`` switches dequeue within each priority level to
    deficit round robin across tenants; ``tenant_weights`` maps tenant
    name -> relative weight (missing tenants weigh 1.0)."""

    high_watermark: int = 1000
    low_watermark: int = 500
    request_timeout_s: float = 30.0
    max_queue_size: int = 2000
    tenant_fairness: bool = False
    tenant_weights: Mapping[str, float] = dc_field(default_factory=dict)


@dataclass(frozen=True)
class QueueDepth:
    """Queue depth statistics by priority."""

    high: int = 0
    normal: int = 0
    low: int = 0
    total: int = 0


@dataclass
class QueuedRequest(Generic[T]):
    """A queued request with metadata."""

    id: RequestId
    data: T
    priority: Priority = Priority.NORMAL
    enqueued_at: float = dc_field(default_factory=time.monotonic)
    tenant: str = DEFAULT_TENANT

    def is_expired(self, timeout_s: float, now: Optional[float] = None) -> bool:
        """True if the request has waited longer than ``timeout_s``."""
        now = time.monotonic() if now is None else now
        return (now - self.enqueued_at) > timeout_s


class _TenantLane(Generic[T]):
    """Per-tenant FIFOs + DRR state for ONE priority level. Not
    thread-safe on its own — every call happens under the manager's
    lock."""

    __slots__ = ("queues", "ring", "deficit")

    def __init__(self) -> None:
        self.queues: Dict[str, Deque[QueuedRequest[T]]] = {}
        # rotation order: tenants join at the tail on first enqueue and
        # leave (deficit reset) when their FIFO drains — standard DRR,
        # so an idle tenant cannot hoard credit
        self.ring: Deque[str] = deque()
        self.deficit: Dict[str, float] = {}

    def append(self, req: QueuedRequest[T]) -> None:
        q = self.queues.get(req.tenant)
        if q is None:
            q = self.queues[req.tenant] = deque()
            self.ring.append(req.tenant)
            self.deficit[req.tenant] = 0.0
        q.append(req)

    def total(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def _drop(self, tenant: str) -> None:
        self.queues.pop(tenant, None)
        self.deficit.pop(tenant, None)
        try:
            self.ring.remove(tenant)
        except ValueError:
            pass

    def drain(self, batch: List[QueuedRequest[T]], max_count: int,
              weight) -> None:
        """Deficit round robin: visit tenants in ring order; each visit
        tops the tenant's deficit up by its weight and dequeues one
        request per unit of deficit. Terminates: every full ring pass
        adds >= _MIN_WEIGHT to each visited deficit (so some tenant
        eventually crosses 1.0), and empty tenants leave the ring."""
        while len(batch) < max_count and self.ring:
            tenant = self.ring[0]
            q = self.queues.get(tenant)
            if not q:
                self._drop(tenant)
                continue
            d = self.deficit.get(tenant, 0.0)
            if d >= 1.0:
                batch.append(q.popleft())
                self.deficit[tenant] = d - 1.0
                if not q:
                    self._drop(tenant)
                elif self.deficit[tenant] < 1.0:
                    self.ring.rotate(-1)
                continue
            self.deficit[tenant] = d + max(_MIN_WEIGHT,
                                           float(weight(tenant)))
            if self.deficit[tenant] >= 1.0:
                continue  # pops on the next iteration
            self.ring.rotate(-1)


class PriorityQueueManager(Generic[T]):
    """Three-level priority queue with hysteresis backpressure and
    optional per-tenant DRR fairness within each level."""

    def __init__(self, config: Optional[QueueConfig] = None):
        self.config = config or QueueConfig()
        self._fair = bool(self.config.tenant_fairness)
        self._queues: Dict[Priority, Deque[QueuedRequest[T]]] = {
            Priority.HIGH: deque(),
            Priority.NORMAL: deque(),
            Priority.LOW: deque(),
        }
        self._lanes: Dict[Priority, _TenantLane[T]] = {
            Priority.HIGH: _TenantLane(),
            Priority.NORMAL: _TenantLane(),
            Priority.LOW: _TenantLane(),
        }
        self._backpressure_active = False
        self._lock = threading.Lock()

    def _weight(self, tenant: str) -> float:
        return float(self.config.tenant_weights.get(tenant, 1.0))

    # -- admission ---------------------------------------------------------

    def enqueue(self, request: QueuedRequest[T]) -> None:
        """Enqueue a request; raises ``QueueFull`` while backpressure is
        active or the absolute cap is reached."""
        with self._lock:
            if self._backpressure_active:
                raise QueueFull()
            if self._total() >= self.config.max_queue_size:
                raise QueueFull()
            if self._fair:
                self._lanes[request.priority].append(request)
            else:
                self._queues[request.priority].append(request)
            self._update_backpressure()

    # -- draining ----------------------------------------------------------

    def dequeue_batch(self, max_count: int) -> List[QueuedRequest[T]]:
        """Dequeue up to ``max_count`` requests: all available High first,
        then Normal, then Low.
        Within a level: FIFO, or — with tenant fairness on — deficit
        round robin across tenants, FIFO within each tenant."""
        batch: List[QueuedRequest[T]] = []
        with self._lock:
            for level in (Priority.HIGH, Priority.NORMAL, Priority.LOW):
                if self._fair:
                    self._lanes[level].drain(batch, max_count, self._weight)
                else:
                    q = self._queues[level]
                    while len(batch) < max_count and q:
                        batch.append(q.popleft())
            self._update_backpressure()
        return batch

    def dequeue_one(self) -> Optional[QueuedRequest[T]]:
        """Dequeue the single highest-priority request."""
        batch = self.dequeue_batch(1)
        return batch[0] if batch else None

    # -- introspection -----------------------------------------------------

    def queue_depth(self) -> QueueDepth:
        """Current depths by priority."""
        with self._lock:
            h = self._level_total(Priority.HIGH)
            n = self._level_total(Priority.NORMAL)
            l = self._level_total(Priority.LOW)
            return QueueDepth(high=h, normal=n, low=l, total=h + n + l)

    def tenant_depths(self) -> Dict[str, int]:
        """Queued requests per tenant across all priority levels (the
        ``queue_tenant_depth`` gauge; legacy mode reports everything
        under DEFAULT_TENANT)."""
        with self._lock:
            if not self._fair:
                total = self._total()
                return {DEFAULT_TENANT: total} if total else {}
            out: Dict[str, int] = {}
            for lane in self._lanes.values():
                for tenant, q in lane.queues.items():
                    out[tenant] = out.get(tenant, 0) + len(q)
            return out

    def is_accepting(self) -> bool:
        """False while backpressure is active."""
        with self._lock:
            return not self._backpressure_active

    def total_depth(self) -> int:
        with self._lock:
            return self._total()

    def is_empty(self) -> bool:
        with self._lock:
            return self._total() == 0

    # -- maintenance -------------------------------------------------------

    def remove_expired(self, now: Optional[float] = None) -> List[QueuedRequest[T]]:
        """Remove and return all requests older than the configured timeout,
        preserving FIFO order of survivors (one O(n) rebuild per level)."""
        timeout = self.config.request_timeout_s
        now = time.monotonic() if now is None else now
        expired: List[QueuedRequest[T]] = []

        def split(q: Deque[QueuedRequest[T]]) -> Deque[QueuedRequest[T]]:
            survivors: Deque[QueuedRequest[T]] = deque()
            while q:
                req = q.popleft()
                if req.is_expired(timeout, now):
                    expired.append(req)
                else:
                    survivors.append(req)
            return survivors

        with self._lock:
            for level in (Priority.HIGH, Priority.NORMAL, Priority.LOW):
                if self._fair:
                    lane = self._lanes[level]
                    for tenant in list(lane.queues):
                        lane.queues[tenant] = split(lane.queues[tenant])
                        if not lane.queues[tenant]:
                            lane._drop(tenant)
                else:
                    self._queues[level] = split(self._queues[level])
            self._update_backpressure()
        return expired

    def cancel(self, request_id: RequestId) -> Optional[QueuedRequest[T]]:
        """Remove a specific queued request by id (client disconnect before
        dispatch). Returns the removed request, or None if not queued."""
        with self._lock:
            for level in (Priority.HIGH, Priority.NORMAL, Priority.LOW):
                if self._fair:
                    lane = self._lanes[level]
                    for tenant, q in list(lane.queues.items()):
                        for i, req in enumerate(q):
                            if req.id == request_id:
                                del q[i]
                                if not q:
                                    lane._drop(tenant)
                                self._update_backpressure()
                                return req
                else:
                    q = self._queues[level]
                    for i, req in enumerate(q):
                        if req.id == request_id:
                            del q[i]
                            self._update_backpressure()
                            return req
            return None

    # -- internals ---------------------------------------------------------

    def _level_total(self, level: Priority) -> int:
        if self._fair:
            return self._lanes[level].total()
        return len(self._queues[level])

    def _total(self) -> int:
        return sum(self._level_total(level) for level in self._queues)

    def _update_backpressure(self) -> None:
        """Hysteresis: activate above the high watermark, release below
        the low watermark. Called under the lock by every mutating
        method."""
        total = self._total()
        if self._backpressure_active:
            if total < self.config.low_watermark:
                self._backpressure_active = False
        else:
            if total > self.config.high_watermark:
                self._backpressure_active = True


def parse_tenant_weights(spec: str, key: str = "queue.tenant_weights"
                         ) -> Dict[str, float]:
    """Parse a ``"tenantA=2,tenantB=1"`` DRR weight map (unlisted tenants
    weigh 1; "" = all equal). Raises ValueError, naming ``key``, on a
    malformed entry or a weight that is not positive."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, value = part.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ValueError(f"{key}: {part!r} is not tenant=value")
        try:
            weight = float(value)
        except ValueError:
            raise ValueError(f"{key}: value {value!r} for {name!r} is not "
                             "a number") from None
        if weight <= 0.0:
            raise ValueError(f"{key}: value for {name!r} must be positive")
        out[name] = weight
    return out
