"""prefill_span_ms.ttft: the mean time from the engine's issue of a
request's first prefill chunk to its first token (engine/engine.py, the
prefill quantum: the prompt's chunks spread over engine steps with decode
blocks between them): the flight recorder's request_phase_seconds for
phase prefill, sum over count, grown from the window's opening to the
counters' cut (the close, or the traced sub-window's start). Read only
where the program also has the engine_wait phase, which narrows prefill
to start at the first chunk; None elsewhere."""


def _delta(run, name, phase):
    label = '{phase="%s"}' % phase
    a = run["metrics_open"].get((name, label), 0.0)
    b = run["metrics_cut"].get((name, label), 0.0)
    return b - a


def read(run):
    if _delta(run, "request_phase_seconds_count", "engine_wait") <= 0:
        return None
    n = _delta(run, "request_phase_seconds_count", "prefill")
    s = _delta(run, "request_phase_seconds_sum", "prefill")
    return s / n * 1e3 if n > 0 else None
