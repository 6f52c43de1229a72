"""Gray-failure health states: only ``health_rank``, the routing sort key
that the scheduler's ``health_tier`` reads (the port's copy of the part of
``distributed_inference_server_tpu/serving/health.py`` this slice needs).

The health scorer, circuit breakers, ``RetryBudget`` and
``AdmissionControl`` are not ported: with no scorer every replica stays
``healthy``, and the scheduler's ``health_scorer`` hook stays None.
"""

from __future__ import annotations

_RANK = {"healthy": 0, "degraded": 1, "ejected": 2}


def health_rank(state: str) -> int:
    """healthy=0 < degraded=1 < ejected=2 (routing sort key)."""
    return _RANK.get(state, 0)
