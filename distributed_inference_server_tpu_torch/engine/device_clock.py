"""The engine's device clock (``cuda``): two timing events on the engine
stream around every dispatch, read where the engine already waits on the
device, and the device's idle gaps between dispatches put down to what
the engine thread was doing meanwhile.

A dispatch (a prefill chunk, a decode block with its speculative rounds,
a mixed step, a looped block) is bracketed by ``begin``, before its first
upload, and ``end``, after its result copy. The pairs wait in issue
order; ``poll`` resolves every pair whose end event has completed
(``Event.query``, which does not wait), so the engine calls it right
after a wait it does anyway (a block's result event, a prefill chunk's
first-token read) and when its counters are read. A resolved pair adds
its event-to-event seconds to its kind's ``device_s``; the time from the
previous pair's end to its start is an idle gap of the engine stream.

Idle gaps are charged on ``time.monotonic()``, the clock of the flight
recorder, the spans and the benchmark's stamps. Device times are chained
from elapsed times (each pair's start from the previous pair's end) and
mapped onto the host clock by an offset: once an event has completed,
the host's clock is at or after the event's device time, so every
``poll`` bounds host minus device from above, and the smallest bound of
the current and the previous second is the offset. ``anchor`` (one
synchronize, at the end of warmup) starts the chain and the offset. The
engine thread stamps what it is doing as named segments (``segment``):
``admit``, ``schedule`` (building a dispatch's inputs, up to its start
event), ``walk`` (a block's token walk and reconcile), ``reap`` (reading
prefill chunks' first tokens) and ``runner`` (between steps: the serving
runner's sink flushes, inbox and reports). A gap is charged to the
segments that overlap it; what none covers is ``other``.

No event is recorded inside a graph capture: a dispatch that captures a
graph (``taint`` while it is open) adds no device time, and device work
outside any dispatch (the KV byte paths, embeddings; ``taint`` while none
is open) keeps the next gap out of the idle count. Engine thread only.
"""

from __future__ import annotations

import functools
import math
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import torch

CAUSES = ("admit", "schedule", "walk", "reap", "runner", "other")

# gaps are charged in issue order, so host segments that end this long
# before a gap's start can overlap no later gap (the offset moves by
# microseconds between charges)
_SEGMENT_SLACK_S = 0.0005


class DeviceClock:
    """Timing-event pairs per dispatch kind on one stream, and the idle
    gaps between them by host cause."""

    def __init__(self, stream, event: Optional[Callable[[], object]] = None,
                 clock: Callable[[], float] = time.monotonic):
        """``event`` makes a timing event (``torch.cuda.Event`` with
        timing on unless given); ``clock`` is the host clock."""
        self.stream = stream
        self.clock = clock
        self._new_event = event or functools.partial(torch.cuda.Event,
                                                     enable_timing=True)
        self.device_s: Dict[str, float] = {}
        self.idle: Dict[str, float] = {c: 0.0 for c in CAUSES}
        # host minus device seconds (None before the first observation)
        self.offset_s: Optional[float] = None
        self.observations = 0
        self._pool: List[torch.cuda.Event] = []
        # issued pairs: (kind, start, end, timed, gap counted)
        self._pending: Deque[tuple] = deque()
        # the pair being issued: [start, timed, gap counted]
        self._open: Optional[list] = None
        self._taint_next = False
        # the last resolved end event and its chained device seconds
        self._last: Optional[Tuple[torch.cuda.Event, float]] = None
        self._seg: Optional[str] = None
        self._seg_t0 = 0.0
        self._segs: Deque[Tuple[str, float, float]] = deque(maxlen=8192)
        self._sec: Optional[int] = None
        self._sec_min = math.inf
        self._prev_min = math.inf

    def _event(self) -> torch.cuda.Event:
        return self._pool.pop() if self._pool else self._new_event()

    # -- what the engine thread does -----------------------------------

    def segment(self, name: Optional[str]) -> Optional[str]:
        """Close the current host segment and open ``name`` (None: no
        cause); returns the segment that was open."""
        now = self.clock()
        prev = self._seg
        if prev is not None and now > self._seg_t0:
            self._segs.append((prev, self._seg_t0, now))
        self._seg, self._seg_t0 = name, now
        return prev

    def begin(self) -> None:
        """A dispatch's first device operation comes next."""
        self.segment(None)
        ev = self._event()
        ev.record(self.stream)
        self._open = [ev, True, not self._taint_next]
        self._taint_next = False

    def end(self, kind: str) -> None:
        """The dispatch opened by ``begin`` issued its last device
        operation (no-op when none is open)."""
        if self._open is None:
            return
        start, timed, gap_ok = self._open
        self._open = None
        ev = self._event()
        ev.record(self.stream)
        self._pending.append((kind, start, ev, timed, gap_ok))

    def taint(self) -> None:
        """A graph capture inside the open dispatch, or device work
        outside any dispatch."""
        if self._open is not None:
            self._open[1] = False
        else:
            self._taint_next = True

    def anchor(self) -> None:
        """Wait for the stream once and start the chain and the offset
        there (the end of warmup)."""
        ev = self._event()
        ev.record(self.stream)
        ev.synchronize()
        self.poll()
        # everything issued before the anchor has run: the next gap is
        # clean
        self._taint_next = False
        t = 0.0
        if self._last is not None:
            prev, tp = self._last
            t = tp + prev.elapsed_time(ev) / 1e3
            self._pool.append(prev)
        self._last = (ev, t)
        self._observe(self.clock(), t)

    # -- resolution ------------------------------------------------------

    def poll(self) -> None:
        """Resolve every issued pair whose end event has completed."""
        done = []
        while self._pending and self._pending[0][2].query():
            done.append(self._pending.popleft())
        if not done:
            return
        now = self.clock()
        gaps = []
        for kind, start, end, timed, gap_ok in done:
            t0 = 0.0
            if self._last is not None:
                prev, tp = self._last
                gap = prev.elapsed_time(start) / 1e3
                t0 = tp + gap
                if gap_ok and gap > 0:
                    gaps.append((tp, t0))
                self._pool.append(prev)
            dur = start.elapsed_time(end) / 1e3
            if timed:
                self.device_s[kind] = self.device_s.get(kind, 0.0) + dur
            self._pool.append(start)
            self._last = (end, t0 + dur)
        self._observe(now, self._last[1])
        for g0, g1 in gaps:
            self._charge(g0 + self.offset_s, g1 + self.offset_s)

    def _observe(self, now: float, t_dev: float) -> None:
        """One upper bound on host minus device seconds; the offset is the
        smallest of the current and the previous second."""
        bound = now - t_dev
        sec = int(now)
        if sec != self._sec:
            self._prev_min = (self._sec_min if self._sec == sec - 1
                              else math.inf)
            self._sec, self._sec_min = sec, bound
        else:
            self._sec_min = min(self._sec_min, bound)
        self.offset_s = min(self._sec_min, self._prev_min)
        self.observations += 1

    def _charge(self, h0: float, h1: float) -> None:
        """Charge the idle gap [h0, h1] (host seconds) to the segments
        that overlap it, the rest to ``other``."""
        if h1 <= h0:
            return
        segs = self._segs
        floor = h0 - _SEGMENT_SLACK_S
        while segs and segs[0][2] <= floor:
            segs.popleft()
        idle = self.idle
        left = h1 - h0
        for name, a, b in segs:
            if a >= h1:
                break
            if b > h0:
                ov = min(b, h1) - max(a, h0)
                idle[name] += ov
                left -= ov
        if self._seg is not None and self._seg_t0 < h1:
            ov = h1 - max(self._seg_t0, h0)
            idle[self._seg] += ov
            left -= ov
        idle["other"] += max(0.0, left)
