"""Device traces on demand with ``torch.profiler`` (port of the step-scoped
capture of ``distributed_inference_server_tpu/utils/profiler.py``, behind
``POST /server/profile {"steps": N}``).

The engine starts a ``DeviceTrace`` at the top of a step and stops it at
the end of the N-th step after (``LLMEngine.profile_steps``), so the
profiler starts and stops on the engine thread, between steps, never
beside a launch from another thread. The trace covers every device
activity of the process (kernels, graph replays' kernels, copies and
fills) and is summarized instead of written out: the window's wall time,
the time the card was busy (the union of the traced device intervals)
and its share of the window, and the kernels that took the most device
time. Only one trace runs at a time.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

import torch


class ProfileInProgress(RuntimeError):
    """Only one device trace may be active per process."""


_LOCK = threading.Lock()


def _device_intervals(events) -> Tuple[List[Tuple[float, float]],
                                       Dict[str, List[float]]]:
    """(start, end) in us of every device event of the profiler's raw
    results, and per name the [total us, count]."""
    spans, by_name = [], {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            continue
        start, end = e.start_ns() / 1e3, e.end_ns() / 1e3
        spans.append((start, end))
        rec = by_name.setdefault(e.name(), [0.0, 0])
        rec[0] += end - start
        rec[1] += 1
    return spans, by_name


def _union_us(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class DeviceTrace:
    """One active capture of the card's activity; ``stop()`` ends it and
    returns the summary."""

    def __init__(self, top: int = 8):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device to trace")
        if not _LOCK.acquire(blocking=False):
            raise ProfileInProgress("a device trace is already active")
        try:
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()
        except BaseException:
            _LOCK.release()
            raise
        self._top = top
        self._t0 = time.perf_counter()

    def stop(self) -> Dict[str, object]:
        try:
            # the device work issued in the window has run before it ends
            torch.cuda.synchronize()
            wall = time.perf_counter() - self._t0
            self._prof.__exit__(None, None, None)
            # the raw results: building FunctionEvents (events()) takes
            # seconds for the ~1e5 kernels of a few served steps
            events = self._prof.profiler.kineto_results.events()
        finally:
            _LOCK.release()
        spans, by_name = _device_intervals(events)
        busy = _union_us(spans) / 1e6
        kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:self._top]
        return {
            "wall_s": wall,
            "device_busy_s": busy,
            "busy_share": busy / wall if wall > 0 else None,
            "device_events": len(spans),
            "top_device_ms": [{"name": n, "ms": us / 1e3, "count": c}
                              for n, (us, c) in kernels],
        }
