"""device_idle_share.tpot: the share of the traced sub-window's wall in
which no operation ran on the card (the union of the profiler's device
intervals, benchmark/devtrace.py), in %."""

from benchmark import readings


def read(run):
    tr = readings.trace_of(run)
    if tr is None:
        return None
    return 100.0 * max(0.0, 1.0 - tr["busy_s"] / tr["window_s"])
