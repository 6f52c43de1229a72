"""decode_step_device_ms.batch: device milliseconds per decode forward,
from the window's opening to the counters' cut (the close, or the traced
sub-window's start): the engine's step clock (engine/engine.py, its
device clock in engine/device_clock.py) for decode blocks, the seconds
between the timing events around each block over the block's forwards
(K a block). None where the step clock has no device seconds or
forwards."""


def _grown(run, kind, field):
    a = run["clock_open"]["kinds"].get(kind, {}).get(field)
    b = run["clock_cut"]["kinds"].get(kind, {}).get(field)
    if a is None or b is None:
        return None
    return float(b) - float(a)


def read(run):
    dev = _grown(run, "decode_block", "device_s")
    fwd = _grown(run, "decode_block", "forwards")
    if dev is None or not fwd or dev <= 0:
        return None
    return dev / fwd * 1e3
