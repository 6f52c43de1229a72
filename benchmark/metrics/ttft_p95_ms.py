"""ttft_p95_ms: the 95th percentile (nearest rank) over every request
scheduled in the window of the time from its scheduled arrival to its
first streamed token at the client. A request that failed, or had no
first token by the drain limit, is a miss that ranks above every value;
when the percentile falls on a miss it reads the longest wait a request
could have had, the window plus the drain limit."""

from benchmark import stats


def read(run):
    if run["workload"]["loop"] != "open":
        return None
    vals, misses = [], 0
    for r in run["requests"]:
        if r["first"] is None or r["error"]:
            misses += 1
        else:
            vals.append((r["first"] - r["due"]) * 1e3)
    cap = (run["seconds"] + float(run["workload"]["drain_s"])) * 1e3
    return stats.percentile(vals, 95, misses, cap)
