"""front_end_ms.ttft: the HTTP front end's share of a first token (the
layer of serving/app.py, handler.py and streamer.py): the client's mean
time from sending a request to its first token, minus the server's mean
time to first token over the same requests: those whose first token
came between the window's opening and the counters' cut (the close, or
the traced sub-window's start), and the growth of /metrics'
time_to_first_token_seconds sum over its count between the same two
scrapes."""

from benchmark import readings, stats


def read(run):
    client = stats.mean([r["first"] - r["sent"]
                         for r in readings.first_tokens_before_cut(run)
                         if r["sent"] is not None])
    n = readings.counter_delta(run, "time_to_first_token_seconds_count")
    s = readings.counter_delta(run, "time_to_first_token_seconds_sum")
    if client is None or n <= 0:
        return None
    return (client - s / n) * 1e3
