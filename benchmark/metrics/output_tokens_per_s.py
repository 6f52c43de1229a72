"""output_tokens_per_s: every token streamed to a client inside the
window (its frame arrived between the window's opening and its close),
over the window's seconds."""


def read(run):
    t0, t1 = run["t0"], run["t1"]
    n = sum(1 for r in run["requests"] for t in r["times"] if t0 <= t <= t1)
    return n / run["seconds"]
