"""The benchmark's device trace of a steady sub-window of a run.

``torch.profiler`` (CUDA activity only) is started and stopped on the
engine's own thread, between two engine steps, through the runner's
public ``call``: so the profiler never starts beside a launch from
another thread, and the step clock is read at the same instants. Each
edge waits for the card (``torch.cuda.synchronize``), so the trace holds
exactly the device work dispatched between the two reads of the step
clock. The raw kineto events are reduced here (building the profiler's
own event objects takes seconds for the 1e5 kernels of a few served
seconds): every device interval, the time per name, their union (busy
seconds) and the gaps between them, each named by the operation that
ends it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch


def warm_profiler(runner, timeout: float = 120.0) -> None:
    """Start and stop one trace on the engine thread: the profiler's
    first start loads and initializes CUPTI, which takes seconds and must
    not fall inside the window."""
    def _on_engine(engine):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    runner.call(_on_engine, timeout)


class SubWindow:
    """One trace over a runner's engine."""

    def __init__(self, runner):
        self.runner = runner
        self.prof = None
        self.start: Dict[str, object] = {}

    def begin(self, timeout: float = 60.0) -> None:
        def _on_engine(engine):
            torch.cuda.synchronize()
            clock = engine.step_clock_stats()
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            return prof, clock, time.monotonic()

        self.prof, clock, t = self.runner.call(_on_engine, timeout)
        self.start = {"t": t, "clock": clock}

    def end(self, timeout: float = 60.0) -> dict:
        prof = self.prof

        def _on_engine(engine):
            torch.cuda.synchronize()
            t = time.monotonic()
            clock = engine.step_clock_stats()
            prof.__exit__(None, None, None)
            return clock, t

        clock, t = self.runner.call(_on_engine, timeout)
        events = prof.profiler.kineto_results.events()
        self.prof = None
        out = summarize(events)
        out["t0"], out["t1"] = self.start["t"], t
        out["window_s"] = t - self.start["t"]
        out["clock0"], out["clock1"] = self.start["clock"], clock
        return out


def summarize(events, top: int = 10) -> dict:
    """Busy seconds (the union of device intervals), seconds per
    operation name, and idle gaps grouped by the operation that ends
    them (the top ``top`` of each)."""
    spans: List[Tuple[float, float, str]] = []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            continue
        spans.append((e.start_ns() * 1e-9, e.end_ns() * 1e-9, e.name()))
    return reduce_spans(spans, top)


def reduce_spans(spans: List[Tuple[float, float, str]], top: int = 10
                 ) -> dict:
    by_name: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    busy, end = 0.0, None
    for s, e, name in sorted(spans):
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if end is None:
            busy += e - s
            end = e
            continue
        if s > end:
            label = f"before {short(name)}"
            gaps[label] = gaps.get(label, 0.0) + (s - end)
        if e > end:
            busy += e - max(s, end)
            end = e
    return {
        "busy_s": busy,
        "events": len(spans),
        "by_name": by_name,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
    }


def short(name: str, width: int = 80) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def seconds_of(by_name: Dict[str, float], *needles: str) -> float:
    """Device seconds of every operation whose name holds one of
    ``needles``."""
    return sum(v for k, v in by_name.items()
               if any(n in k for n in needles))
