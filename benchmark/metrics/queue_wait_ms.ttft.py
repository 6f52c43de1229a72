"""queue_wait_ms.ttft: the mean time a request waited in admission
(serving/dispatcher.py, batcher.py, runner.py, core/queue.py) before the
engine took it: the flight recorder's request_phase_seconds for phase
queue_wait, sum over count, grown from the window's opening to the
counters' cut (the close, or the traced sub-window's start)."""

from benchmark import readings

LABEL = '{phase="queue_wait"}'


def read(run):
    n = readings.counter_delta(run, "request_phase_seconds_count", LABEL)
    s = readings.counter_delta(run, "request_phase_seconds_sum", LABEL)
    return s / n * 1e3 if n > 0 else None
