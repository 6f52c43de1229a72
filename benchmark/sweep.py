"""The knee of an open-loop cell: one server, one window per offered rate.

    python3 -m benchmark.sweep --workload <cell> --seed <n> --seconds <s> --rates 1,2,3

For each rate (lowest first) it offers the cell's traffic at that rate
for ``--seconds``, follows the requests to their end, and prints one
JSON line: the rate offered and completed, TTFT p50 and p95 and TPOT p95
(ms), and the backlog's growth, the median TTFT of the window's last
quarter of arrivals over its first quarter's. The knee is the highest
rate whose requests complete as fast as they arrive with no growing
backlog. A tool for choosing a cell's rate once: the benchmark's runs
never search for one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from benchmark import loadgen, run, spec, stats


def summary(rate: float, rec: dict) -> dict:
    reqs = sorted(rec["requests"], key=lambda r: r["due"])
    served = [r for r in reqs if r["first"] is not None and not r["error"]]
    ttft = [(r["first"] - r["due"]) * 1e3 for r in served]
    misses = len(reqs) - len(served)
    q = max(1, len(reqs) // 4)

    def med(rs):
        v = [(r["first"] - r["due"]) * 1e3 for r in rs
             if r["first"] is not None]
        return statistics.median(v) if v else None

    head, tail = med(reqs[:q]), med(reqs[-q:])
    ends = [r["last"] for r in served if r["last"] is not None]
    span = max(ends) - rec["t0"] if ends else None
    tpot = [(r["last"] - r["first"]) * 1e3 / (len(r["times"]) - 1)
            for r in served if len(r["times"]) >= 2]
    return {
        "rate": rate, "requests": len(reqs), "misses": misses,
        "completed_per_s": len(served) / span if span else None,
        "ttft_p50_ms": stats.percentile(ttft, 50),
        "ttft_p95_ms": stats.percentile(ttft, 95, misses, float("inf")),
        "tpot_p95_ms": stats.percentile(tpot, 95),
        "backlog_growth": (tail / head) if head and tail else None,
        "drain_after_close_s": (max(ends) - rec["t1"]) if ends else None,
        "pages_peak": rec.get("pages"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    run.cache_dirs(spec.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    w = spec.workload(args.workload)
    if w["loop"] != "open":
        print("a sweep is for an open loop", file=sys.stderr)
        return 1
    cfg = spec.config(w["config"])
    h = run.Harness(w, cfg, args.seed, torch.device("cuda", 0))
    h.start()
    try:
        h.warm()
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            w["rate_per_s"] = rate
            reqs = loadgen.schedule(w, args.seed + k, args.seconds,
                                    h.dims.vocab)
            rec = h.window(reqs, args.seconds, False)
            print(json.dumps(summary(rate, rec)), flush=True)
    finally:
        h.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
