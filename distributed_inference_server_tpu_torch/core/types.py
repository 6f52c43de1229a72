"""Core identifier types and priority levels (port of
``distributed_inference_server_tpu/core/types.py``: the request and batch
ids, the priority levels and the admission tenant key)."""

from __future__ import annotations

import enum
import uuid

# Unique identifier for an inference request.
RequestId = str
# An admission batch of requests (serving/batcher.py).
BatchId = str

#: the admission tenant of a request whose body names none; also the only
#: tenant while per-tenant fair admission is off
DEFAULT_TENANT = "default"


def new_request_id() -> RequestId:
    """Fresh UUID4 request id."""
    return str(uuid.uuid4())


def new_batch_id() -> BatchId:
    """Fresh UUID4 batch id."""
    return str(uuid.uuid4())


class Priority(enum.IntEnum):
    """Request scheduling priority; higher values are served first
    (Low=0, Normal=1, High=2; default Normal)."""

    LOW = 0
    NORMAL = 1
    HIGH = 2

    @classmethod
    def parse(cls, value: object) -> "Priority":
        """Parse a priority from JSON: "low"/"normal"/"high" in any case,
        or an integer level."""
        if isinstance(value, Priority):
            return value
        if isinstance(value, bool):
            raise ValueError(f"invalid priority: {value!r}")
        if isinstance(value, int):
            return cls(value)
        if isinstance(value, str):
            try:
                return cls[value.upper()]
            except KeyError:
                raise ValueError(f"invalid priority: {value!r}") from None
        raise ValueError(f"invalid priority: {value!r}")

    def to_json(self) -> str:
        return self.name.capitalize()
