"""Traffic: the schedule a cell's file and ``--seed`` describe, and the
client that drives ``POST /generate`` with it.

``schedule`` (numpy) turns a workload file into requests. The sizes,
sampling modes and arrival instants are drawn from the file's
``base_seed``, so every seed offers the same work at the same instants;
``--seed`` deals the sizes to the instants in another order, within
blocks of ``SHUFFLE_BLOCK`` consecutive requests, so every stretch of the
window carries the same requests and only their order inside it changes;
it also draws the prompts' token ids. An open loop sends request i at its
scheduled offset whatever the server does (Poisson arrivals: exponential
gaps, scaled to fill the window); a closed loop keeps ``clients`` callers
that each send their next request when the last one ended, started one
after another over the file's ``ramp_s`` seconds before the window opens,
so that the window finds the engine full and its requests at every stage
of their lives, not one wave started together.

``main`` is the client: a process of its own (``python3 -m
benchmark.loadgen``), so its threads do not share the server's
interpreter lock. It reads the plan as JSON on stdin, streams every
request with ``"stream": true``, stamps each token frame on arrival, and
writes the records as JSON on stdout. It imports only the standard
library.
"""

from __future__ import annotations

import http.client
import json
import socket
import sys
import threading
import time
from typing import Dict, List, Optional

from benchmark.tokenizer import ids_of, text_of

# ids a prompt never holds: Mistral's <unk>, <s> and </s>
FIRST_ORDINARY_ID = 3
# consecutive requests whose sizes a seed deals among themselves
SHUFFLE_BLOCK = 8


def _lengths(rng, dist: dict, n: int):
    """``n`` lognormal lengths with the given median and sigma, clipped to
    [min, max]."""
    import numpy as np

    x = np.exp(rng.normal(np.log(dist["median"]), dist["sigma"], size=n))
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def _seeded(seed: int):
    import numpy as np

    # any whole number, negative or past 64 bits, names one stream
    return np.random.default_rng(abs(int(seed)) % (1 << 128))


def request_count(w: dict, seconds: float) -> int:
    """Requests a schedule holds: the open loop's arrivals in the window,
    or a closed loop's pool (each client can run through several)."""
    if w["loop"] == "open":
        return max(1, round(float(w["rate_per_s"]) * seconds))
    return int(w["clients"]) * int(w.get("pool_per_client", 16))


def schedule(w: dict, seed: int, seconds: float, vocab: int) -> List[dict]:
    """The cell's requests for one run: ``at`` (open loop: seconds after
    the window opens), ``prompt_ids`` (BOS first), ``max_tokens``,
    ``greedy``, ``temperature`` and ``top_p``."""
    import numpy as np

    n = request_count(w, seconds)
    base = _seeded(w.get("base_seed", 0))
    prompts = _lengths(base, w["prompt_tokens"], n)
    outputs = _lengths(base, w["output_tokens"], n)
    greedy = np.zeros(n, bool)
    greedy[:round(n * float(w.get("greedy_share", 1.0)))] = True
    gaps = base.exponential(1.0, size=n)
    gaps *= seconds / gaps.sum()
    at = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    rng = _seeded(seed)
    order = np.concatenate([b0 + rng.permutation(min(SHUFFLE_BLOCK, n - b0))
                            for b0 in range(0, n, SHUFFLE_BLOCK)])
    samp = w.get("sampling", {})
    out = []
    for i, j in enumerate(order):
        ids = rng.integers(FIRST_ORDINARY_ID, vocab, size=int(prompts[j]) - 1)
        g = bool(greedy[j])
        out.append({
            "i": i,
            "at": float(at[i]) if w["loop"] == "open" else None,
            "prompt_ids": [1] + ids.tolist(),
            "max_tokens": int(outputs[j]),
            "greedy": g,
            "temperature": 0.0 if g else float(samp.get("temperature", 1.0)),
            "top_p": 1.0 if g else float(samp.get("top_p", 1.0)),
        })
    return out


def body(req: dict) -> bytes:
    """The ``/generate`` JSON of a request (the BOS is the server's)."""
    return json.dumps({
        "prompt": text_of(req["prompt_ids"][1:]),
        "max_tokens": req["max_tokens"],
        "temperature": req["temperature"],
        "top_p": req["top_p"],
        "stream": True,
    }).encode()


# -- the client (standard library only) ---------------------------------------


def stream_one(host: str, port: int, payload: bytes, deadline: float,
               rec: Dict) -> None:
    """Send one streamed request and fill ``rec``: ``sent``, ``times``
    (each token frame's arrival), ``ids``, ``finish``, ``error``, ``cut``
    (still streaming at ``deadline``). Times are ``time.monotonic()``,
    which every process of the machine shares."""
    rec.update(sent=None, times=[], ids=[], finish=None, error=None,
               cut=False, status=None)
    seen: Dict[int, float] = {}
    parts: List[str] = []
    conn = None
    try:
        conn = http.client.HTTPConnection(
            host, port, timeout=max(0.05, deadline - time.monotonic()))
        rec["sent"] = time.monotonic()
        conn.request("POST", "/generate", body=payload,
                     headers={"Content-Type": "application/json",
                              "Connection": "close"})
        resp = conn.getresponse()
        rec["status"] = resp.status
        if resp.status != 200:
            rec["error"] = f"HTTP {resp.status}: {resp.read()[:200]!r}"
            return
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                rec["cut"] = True
                return
            conn.sock.settimeout(left)
            line = resp.readline()
            now = time.monotonic()
            if not line:
                if rec["finish"] is None and rec["error"] is None:
                    rec["error"] = "stream ended without a done event"
                return
            if not line.startswith(b"data: "):
                continue
            data = line[6:].strip()
            if data == b"[DONE]":
                return
            ev = json.loads(data)
            kind = ev.get("type")
            if kind == "token":
                # a token's frame carries its piece; the last token of a
                # length-capped request comes as an empty frame and its
                # piece rides a second frame of the same index
                k = int(ev.get("index", len(seen)))
                seen.setdefault(k, now)
                parts.append(ev.get("token") or "")
            elif kind == "done":
                rec["finish"] = ev.get("finish_reason")
            elif kind == "error":
                rec["error"] = f"{ev.get('code')}: {ev.get('messages')}"
    except (socket.timeout, TimeoutError):
        rec["cut"] = True
    except (OSError, http.client.HTTPException, ValueError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        if conn is not None:
            conn.close()
        rec["times"] = [seen[k] for k in sorted(seen)]
        try:
            rec["ids"] = ids_of("".join(parts))
        except ValueError as e:
            rec["error"] = rec["error"] or f"stream text: {e}"
        if len(rec["ids"]) != len(rec["times"]):
            if rec["cut"]:
                n = min(len(rec["ids"]), len(rec["times"]))
                rec["ids"], rec["times"] = rec["ids"][:n], rec["times"][:n]
            elif not rec["error"]:
                rec["error"] = (f"{len(rec['ids'])} pieces against "
                                f"{len(rec['times'])} token frames")


def run_plan(plan: dict) -> List[dict]:
    """Drive a plan: ``host``, ``port``, ``t0`` (monotonic instant the
    window opens), ``seconds``, ``drain_s``, ``loop``, ``clients``,
    ``ramp_s`` and ``requests`` (``i``, ``at``, ``body`` as text). An open
    loop follows every request to its end or to ``t0 + seconds +
    drain_s``; a closed loop's client k starts at ``t0 - ramp_s + k *
    ramp_s / clients``, and every client stops sending when the window
    closes and cuts what is still streaming then."""
    host, port = plan["host"], plan["port"]
    t0, seconds = plan["t0"], plan["seconds"]
    reqs = plan["requests"]
    recs: List[dict] = [{"i": r["i"]} for r in reqs]
    threads: List[threading.Thread] = []
    if plan["loop"] == "open":
        deadline = t0 + seconds + plan["drain_s"]
        for r, rec in zip(reqs, recs):
            due = t0 + r["at"]
            rec["due"] = due
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            t = threading.Thread(target=stream_one, daemon=True, args=(
                host, port, r["body"].encode(), deadline, rec))
            t.start()
            threads.append(t)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()) + 5.0)
        return recs

    end = t0 + seconds
    lock = threading.Lock()
    nxt = [0]
    done: List[dict] = []

    def client() -> None:
        while time.monotonic() < end:
            with lock:
                k = nxt[0] % len(reqs)
                nxt[0] += 1
            rec = {"i": reqs[k]["i"], "due": time.monotonic()}
            stream_one(host, port, reqs[k]["body"].encode(), end, rec)
            with lock:
                done.append(rec)

    n_clients = int(plan["clients"])
    ramp = float(plan.get("ramp_s", 0.0))
    for k in range(n_clients):
        delay = t0 - ramp + k * ramp / n_clients - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=client, daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(max(0.0, end - time.monotonic()) + 30.0)
    with lock:
        return list(done)


def main() -> int:
    plan = json.load(sys.stdin)
    recs = run_plan(plan)
    json.dump(recs, sys.stdout)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
