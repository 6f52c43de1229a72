"""decode_step_ms.tpot: host milliseconds per decode step, from the
window's opening to the counters' cut (the close, or the traced
sub-window's start): the engine's step clock (engine/engine.py) for
decode blocks, wall seconds over blocks times the block's steps. The
clock books the device time a block waits for to that block."""

from benchmark import readings


def read(run):
    return readings.decode_step_ms(run)
