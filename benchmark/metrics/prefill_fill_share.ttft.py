"""prefill_fill_share.ttft: the share of the tokens the prefill chunks
computed that were prompt tokens, not padding (engine/engine.py: a chunk
computes prefill_batch x bucket tokens whatever its rows hold), from the
window's opening to the counters' cut (the close, or the traced
sub-window's start): the step clock's prefill tokens over its capacity,
in %. None where the step clock has no capacity."""


def _grown(run, kind, field):
    a = run["clock_open"]["kinds"].get(kind, {}).get(field)
    b = run["clock_cut"]["kinds"].get(kind, {}).get(field)
    if a is None or b is None:
        return None
    return float(b) - float(a)


def read(run):
    cap = _grown(run, "prefill", "capacity")
    tokens = _grown(run, "prefill", "tokens")
    if not cap or tokens is None:
        return None
    return 100.0 * tokens / cap
