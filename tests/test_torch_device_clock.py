"""The engine's device clock (``engine/device_clock.py``) on a simulated
stream: timing events that complete when a fake device has run the work
issued before them, on a fake host clock. Device seconds per kind, the
idle gaps between dispatches charged to the host segments that overlap
them (what none covers to ``other``), the offset from host to device
time, and the taints (a capture inside a dispatch, device work outside
one). The card's own events are held in ``tests/test_torch_gpu.py``."""

from __future__ import annotations

import pytest

from distributed_inference_server_tpu_torch.engine.device_clock import (
    CAUSES,
    DeviceClock,
)


class FakeStream:
    """A device that runs issued work in order; device time = host time
    minus ``offset``."""

    def __init__(self, host, offset: float = 100.0):
        self.host = host
        self.offset = offset
        self.busy_until = -1e9

    def now(self) -> float:
        return self.host.t - self.offset

    def work(self, seconds: float) -> None:
        self.busy_until = max(self.now(), self.busy_until) + seconds


class FakeEvent:
    def __init__(self, stream: FakeStream):
        self.stream = stream
        self.t = None

    def record(self, stream) -> None:
        assert stream is self.stream
        self.t = max(stream.now(), stream.busy_until)

    def query(self) -> bool:
        return self.t <= self.stream.now()

    def synchronize(self) -> None:
        self.stream.host.t = max(self.stream.host.t,
                                 self.t + self.stream.offset)

    def elapsed_time(self, other: "FakeEvent") -> float:
        return (other.t - self.t) * 1e3


class Host:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def rig():
    host = Host()
    stream = FakeStream(host)
    made = []

    def event():
        made.append(FakeEvent(stream))
        return made[-1]

    return host, stream, DeviceClock(stream, event=event, clock=host), made


def _at(host, t, fn, *a):
    host.t = t
    return fn(*a)


def test_device_seconds_and_idle_causes_sum_to_the_gaps(rig):
    host, stream, dc, made = rig
    _at(host, 1000.0, dc.anchor)
    # step 1: admit, a gap with no segment, schedule, then a 25 ms chunk
    _at(host, 1000.000, dc.segment, "admit")
    _at(host, 1000.002, dc.segment, None)
    _at(host, 1000.003, dc.segment, "schedule")
    _at(host, 1000.005, dc.begin)
    stream.work(0.025)
    _at(host, 1000.006, dc.end, "prefill")
    _at(host, 1000.006, dc.segment, "reap")
    _at(host, 1000.031, dc.poll)  # the chunk has run
    # the host walks past the device's end, then the runner, then admits
    _at(host, 1000.031, dc.segment, "walk")
    _at(host, 1000.034, dc.segment, "runner")
    _at(host, 1000.050, dc.segment, "admit")
    _at(host, 1000.052, dc.begin)
    stream.work(0.040)
    _at(host, 1000.053, dc.end, "decode_block")
    _at(host, 1000.053, dc.segment, "walk")
    _at(host, 1000.060, dc.poll)  # still running: nothing resolves
    assert dc.device_s == {"prefill": pytest.approx(0.025)}
    _at(host, 1000.093, dc.poll)
    assert dc.device_s == {"prefill": pytest.approx(0.025),
                           "decode_block": pytest.approx(0.040)}
    want = {"admit": 0.002 + 0.002, "schedule": 0.002, "walk": 0.003,
            "reap": 0.001, "runner": 0.016, "other": 0.001}
    assert dc.idle == {c: pytest.approx(want.get(c, 0.0), abs=1e-9)
                       for c in CAUSES}
    gaps = 0.005 + (0.052 - 0.030)
    assert sum(dc.idle.values()) == pytest.approx(gaps, abs=1e-9)
    # host minus chained device seconds (0 at the anchor), from the waits
    # (the anchor's bound is exact here)
    assert dc.offset_s == pytest.approx(1000.0)
    assert not dc._pending
    # resolved events go back to the pool: four pairs made no more than
    # five events (the last end event is still the chain's head)
    _at(host, 1000.100, dc.begin)
    _at(host, 1000.101, dc.end, "prefill")
    assert len(made) <= 5


def test_taints_keep_captures_and_foreign_work_out(rig):
    host, stream, dc, _ = rig
    _at(host, 1000.0, dc.anchor)
    # a dispatch that captured a graph: its device time is not counted
    _at(host, 1000.010, dc.begin)
    dc.taint()
    stream.work(0.010)
    _at(host, 1000.011, dc.end, "decode_block")
    # device work outside any dispatch: the next gap is not idle
    _at(host, 1000.030, dc.taint)
    stream.work(0.005)
    _at(host, 1000.040, dc.begin)
    stream.work(0.010)
    _at(host, 1000.041, dc.end, "decode_block")
    _at(host, 1000.060, dc.poll)
    assert dc.device_s == {"decode_block": pytest.approx(0.010)}
    # only the first gap (anchor -> the captured dispatch) counts
    assert sum(dc.idle.values()) == pytest.approx(0.010, abs=1e-9)
    assert dc.idle["other"] == pytest.approx(0.010, abs=1e-9)


def test_offset_tracks_the_smallest_bound_per_second(rig):
    host, stream, dc, _ = rig
    _at(host, 1000.0, dc.anchor)
    # a late wake-up: this second's bound is 5 ms above the truth
    _at(host, 1000.500, dc.begin)
    stream.work(0.001)
    _at(host, 1000.500, dc.end, "prefill")
    _at(host, 1000.506, dc.poll)
    assert dc.offset_s == pytest.approx(1000.0)  # the anchor's second
    # two seconds on, only late wake-ups: the offset is their smallest
    for t in (1002.2, 1002.6):
        _at(host, t, dc.begin)
        stream.work(0.001)
        _at(host, t, dc.end, "prefill")
    _at(host, 1002.605, dc.poll)
    assert dc.offset_s == pytest.approx(1000.004)
    assert dc.observations == 3
