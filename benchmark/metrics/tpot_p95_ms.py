"""tpot_p95_ms: the 95th percentile (nearest rank) over the window's
requests with at least two streamed tokens of (last token's arrival -
first token's arrival) / (tokens - 1), at the client."""

from benchmark import stats


def read(run):
    vals = [(r["last"] - r["first"]) * 1e3 / (len(r["times"]) - 1)
            for r in run["requests"] if len(r["times"]) >= 2]
    return stats.percentile(vals, 95)
