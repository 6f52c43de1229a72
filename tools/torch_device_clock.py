"""Measure the engine's device clock (``engine/device_clock.py``) on a
card:

    python3 tools/torch_device_clock.py [--dispatches 3000] [--drift-s 51]

``cost``: the host time the clock adds to a dispatch. Small dispatches
are issued on one stream as the engine issues them (a ``schedule``
segment, the dispatch's kernels, a result event, a ``walk`` segment that
waits on it), in turns without and with the clock's calls (``begin``,
``end``, the segment switches and ``poll``); each turn's host µs per
dispatch, the median of each side and their difference are printed, and
the summed time inside the clock's own calls per dispatch, with the part
of it spent in the CUDA calls alone (two timing-event records, a
``query``, two ``elapsed_time`` reads) timed in a loop of their own.

``drift``: the clock's host-minus-device offset, read every second while
dispatches of about a millisecond run back to back with a wait on each,
for ``--drift-s`` seconds after a one-second start; prints the offset's
change over that span and the range of the per-second readings around
the straight line between its ends.

One JSON line per part, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from distributed_inference_server_tpu_torch.engine.device_clock import (  # noqa: E402,E501
    DeviceClock,
)


class _Timed:
    """A device clock whose calls add their host seconds to ``spent``."""

    def __init__(self, dc: DeviceClock):
        self.dc = dc
        self.spent = 0.0

    def __getattr__(self, name):
        fn = getattr(self.dc, name)

        def timed(*a):
            t = time.perf_counter()
            out = fn(*a)
            self.spent += time.perf_counter() - t
            return out

        return timed


def _turn(stream, x, n: int, dc) -> float:
    """Host µs per dispatch over ``n`` dispatches."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        if dc is not None:
            dc.segment("schedule")
            dc.begin()
        x.add_(1.0)
        x.mul_(0.5)
        if dc is not None:
            dc.end("decode_block")
        ev = torch.cuda.Event()
        ev.record(stream)
        if dc is not None:
            dc.segment("walk")
        ev.synchronize()
        if dc is not None:
            dc.poll()
            dc.segment(None)
    return (time.perf_counter() - t) / n * 1e6


def cuda_calls(stream, x, n: int) -> dict:
    """Host µs per dispatch of the clock's CUDA calls alone."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    rec = rd = 0.0
    for _ in range(n):
        t = time.perf_counter()
        a.record(stream)
        rec += time.perf_counter() - t
        x.add_(1.0)
        t = time.perf_counter()
        b.record(stream)
        rec += time.perf_counter() - t
        b.synchronize()
        t = time.perf_counter()
        b.query()
        a.elapsed_time(b)
        b.elapsed_time(a)
        rd += time.perf_counter() - t
    return {"record_us": rec / n * 1e6, "query_elapsed_us": rd / n * 1e6}


def cost(n: int, turns: int = 4) -> dict:
    dev = torch.device("cuda", 0)
    stream = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        x = torch.zeros(1 << 16, device=dev)
        dc = _Timed(DeviceClock(stream))
        dc.anchor()
        _turn(stream, x, n // 4, None)  # warm
        _turn(stream, x, n // 4, dc)
        dc.spent = 0.0
        off, on = [], []
        for i in range(turns):
            for side in ((None, dc) if i % 2 == 0 else (dc, None)):
                (off if side is None else on).append(
                    _turn(stream, x, n, side))
    return {"part": "cost", "dispatches_per_turn": n,
            "off_us": off, "on_us": on,
            "median_off_us": statistics.median(off),
            "median_on_us": statistics.median(on),
            "added_us": statistics.median(on) - statistics.median(off),
            "inside_calls_us": dc.spent / (n * turns) * 1e6,
            "cuda_calls": cuda_calls(stream, x, n),
            "idle_s": dc.dc.idle, "device_s": dc.dc.device_s}


def drift(seconds: float) -> dict:
    dev = torch.device("cuda", 0)
    stream = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        a = torch.randn(2048, 2048, device=dev, dtype=torch.bfloat16)
        dc = DeviceClock(stream)
        dc.anchor()
        t0 = time.monotonic()
        per_sec = {}
        while True:
            now = time.monotonic()
            if now - t0 > seconds + 1.5:
                break
            dc.segment("schedule")
            dc.begin()
            for _ in range(4):
                a.mul_(1.0)
                torch.mm(a, a)
            dc.end("decode_block")
            ev = torch.cuda.Event()
            ev.record(stream)
            dc.segment("walk")
            ev.synchronize()
            dc.poll()
            dc.segment(None)
            per_sec[int(time.monotonic() - t0)] = dc.offset_s
    first, last = 1, int(seconds) + 1
    a0, a1 = per_sec[first], per_sec[last]
    slope = (a1 - a0) / (last - first)
    resid = [per_sec[s] - (a0 + slope * (s - first))
             for s in range(first, last + 1) if s in per_sec]
    return {"part": "drift", "span_s": last - first,
            "offset_first_s": a0, "offset_last_s": a1,
            "drift_s": a1 - a0, "resid_min_s": min(resid),
            "resid_max_s": max(resid), "observations": dc.observations,
            "device_s": dc.device_s.get("decode_block", 0.0),
            "idle_s": sum(dc.idle.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dispatches", type=int, default=3000)
    ap.add_argument("--drift-s", type=float, default=51.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip()}))
    print(json.dumps(cost(args.dispatches)))
    print(json.dumps(drift(args.drift_s)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
