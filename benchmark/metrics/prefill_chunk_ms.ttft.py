"""prefill_chunk_ms.ttft: host milliseconds per prefill chunk, from the
window's opening to the counters' cut (the close, or the traced
sub-window's start): the engine's step clock (engine/engine.py) for
prefill, wall seconds over dispatches."""

from benchmark import readings


def read(run):
    c = readings.window_clock(run, "prefill")
    return c["wall_s"] / c["dispatches"] * 1e3 if c["dispatches"] else None
