"""step_mfu.batch: the whole step's share of the chip's peak over the
traced sub-window (models/llama.py and everything below it): the least
time the sub-window's forwards needed, each the larger of its FLOPs over
989 TFLOP/s and its bytes over 3.35 TB/s (benchmark/work.py), over the
sub-window's wall, in %. Forwards, prompt tokens and decode steps from the
engine's step clock; decode tokens and each token's visible keys from the
token log."""

from benchmark import readings, work


def read(run):
    sw = readings.subwindow_work(run)
    if sw is None or sw["bound_s"] <= 0:
        return None
    return work.share(sw["bound_s"], run["trace"]["window_s"])
