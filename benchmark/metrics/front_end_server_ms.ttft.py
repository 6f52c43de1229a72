"""front_end_server_ms.ttft: the HTTP front end's share of a first token,
measured inside the server (serving/app.py, handler.py, streamer.py): the
mean ingress phase of the flight recorder's request_phase_seconds (the
handler's receipt of the request to its admission) plus the mean of
request_first_frame_seconds (the runner's first-token delivery to the
stream's first written frame), each sum over count, grown from the
window's opening to the counters' cut (the close, or the traced
sub-window's start). None where the program has either series
missing."""

INGRESS = ("request_phase_seconds", '{phase="ingress"}')
FRAME = ("request_first_frame_seconds", "")


def _mean(run, series):
    name, label = series
    d = {}
    for part in ("sum", "count"):
        key = (f"{name}_{part}", label)
        d[part] = (run["metrics_cut"].get(key, 0.0)
                   - run["metrics_open"].get(key, 0.0))
    return d["sum"] / d["count"] if d["count"] > 0 else None


def read(run):
    ingress, frame = _mean(run, INGRESS), _mean(run, FRAME)
    if ingress is None or frame is None:
        return None
    return (ingress + frame) * 1e3
