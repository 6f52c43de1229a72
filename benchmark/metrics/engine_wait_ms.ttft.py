"""engine_wait_ms.ttft: the mean time a request waited inside the engine
for its first prefill chunk (engine/engine.py, admission into prefill):
the flight recorder's request_phase_seconds for phase engine_wait (from
the runner's dispatch to the engine's issue of the request's first
chunk), sum over count, grown from the window's opening to the counters'
cut (the close, or the traced sub-window's start). None where the
program has no such phase."""

LABEL = '{phase="engine_wait"}'


def _delta(run, name):
    a = run["metrics_open"].get((name, LABEL), 0.0)
    b = run["metrics_cut"].get((name, LABEL), 0.0)
    return b - a


def read(run):
    n = _delta(run, "request_phase_seconds_count")
    s = _delta(run, "request_phase_seconds_sum")
    return s / n * 1e3 if n > 0 else None
