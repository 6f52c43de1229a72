"""prefill_chunk_device_ms.ttft: device milliseconds per prefill chunk,
from the window's opening to the counters' cut (the close, or the traced
sub-window's start): the engine's step clock (engine/engine.py, its
device clock in engine/device_clock.py) for prefill, the seconds between
the timing events around each chunk over the chunks. None where the step
clock has no device seconds."""


def _grown(run, kind, field):
    a = run["clock_open"]["kinds"].get(kind, {}).get(field)
    b = run["clock_cut"]["kinds"].get(kind, {}).get(field)
    if a is None or b is None:
        return None
    return float(b) - float(a)


def read(run):
    dev = _grown(run, "prefill", "device_s")
    n = _grown(run, "prefill", "dispatches")
    if dev is None or not n or dev <= 0:
        return None
    return dev / n * 1e3
