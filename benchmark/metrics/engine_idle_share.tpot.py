"""engine_idle_share.tpot: the share of the traced sub-window's wall in
which the engine's stream sat idle between dispatches, measured inside
the program (engine/device_clock.py: the gaps between one dispatch's end
event and the next one's start event, by host cause), grown from the
sub-window's first read of the step clock to its last, over the
sub-window's wall, in %. The profiler's device_idle_share.tpot reads the
same sub-window from outside the program. None without a trace or where
the step clock has no idle gaps."""


def read(run):
    tr = run.get("trace")
    if not tr or tr.get("window_s", 0) <= 0:
        return None
    a, b = tr["clock0"].get("idle"), tr["clock1"].get("idle")
    if a is None or b is None:
        return None
    idle = sum(float(b[c]) - float(a.get(c, 0.0)) for c in b)
    return 100.0 * idle / tr["window_s"]
