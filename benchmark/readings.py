"""What the metric readers share: the run record's accessors, the
Prometheus text parse, the step clock's deltas, and the work a traced
sub-window needed (``work.py``'s counts over the token log)."""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Tuple

from benchmark import work

_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$')


def parse_prometheus(text: str) -> Dict[Tuple[str, str], float]:
    """``(name, labels)`` -> value of every sample line (labels as
    written, ``""`` for none)."""
    out: Dict[Tuple[str, str], float] = {}
    for line in text.splitlines():
        m = _SAMPLE.match(line.strip())
        if m:
            try:
                out[(m.group(1), m.group(2) or "")] = float(m.group(3))
            except ValueError:
                continue
    return out


def counter_delta(run: dict, name: str, labels: str = "") -> float:
    """A /metrics sample's growth from the window's opening to its cut
    (the close, or the start of the traced sub-window)."""
    a = run["metrics_open"].get((name, labels), 0.0)
    b = run["metrics_cut"].get((name, labels), 0.0)
    return b - a


def clock_delta(c0: dict, c1: dict, kind: str) -> Dict[str, float]:
    """The step clock's growth of one dispatch kind between two reads."""
    k0 = c0["kinds"].get(kind, {})
    k1 = c1["kinds"].get(kind, {})
    return {f: float(k1.get(f, 0)) - float(k0.get(f, 0))
            for f in ("dispatches", "wall_s", "tokens", "rows")}


def window_clock(run: dict, kind: str) -> Dict[str, float]:
    """The step clock's growth from the window's opening to its cut."""
    return clock_delta(run["clock_open"], run["clock_cut"], kind)


def first_tokens_before_cut(run: dict) -> Iterator[dict]:
    """The window's requests whose first token reached the client before
    the counters' cut."""
    return (r for r in run["requests"]
            if r.get("first") is not None and r["first"] <= run["t_cut"])


def decode_tokens_in(run: dict, t0: float, t1: float
                     ) -> Tuple[int, float]:
    """Decode tokens (every served token after a request's first) that
    reached the client in [t0, t1], and the keys their queries saw in all
    (each token's causal window)."""
    d = run["dims"]
    n, keys = 0, 0.0
    for r in run["requests"]:
        plen = r["prompt_len"]
        for k, t in enumerate(r["times"]):
            if k == 0 or not t0 <= t <= t1:
                continue
            n += 1
            # token k came from the step that fed token k - 1 at position
            # plen + k - 1
            keys += work.visible(d, plen + k - 1)
    return n, keys


def prompts_done_in(run: dict, t0: float, t1: float) -> List[int]:
    """Prompt lengths of the requests whose first token reached the client
    in [t0, t1] (their prefill ended in the sub-window)."""
    return [r["prompt_len"] for r in run["requests"]
            if r.get("first") is not None and t0 <= r["first"] <= t1]


def trace_of(run: dict) -> Optional[dict]:
    tr = run.get("trace")
    return tr if tr and tr.get("window_s", 0) > 0 else None


def subwindow_work(run: dict) -> Optional[dict]:
    """The traced sub-window's forwards and the least time they needed:
    decode forwards (the step clock's blocks times their steps) over the
    decode tokens the log shows, prefill forwards over the step clock's
    prompt tokens, with the attention keys from the token log."""
    tr = trace_of(run)
    if tr is None:
        return None
    d = run["dims"]
    K = run["decode_block_size"]
    dec = clock_delta(tr["clock0"], tr["clock1"], "decode_block")
    pre = clock_delta(tr["clock0"], tr["clock1"], "prefill")
    n_dec, dec_keys = decode_tokens_in(run, tr["t0"], tr["t1"])
    fwd_dec = dec["dispatches"] * K
    prompts = prompts_done_in(run, tr["t0"], tr["t1"])
    pre_tokens = pre["tokens"]
    # attention keys per prefill token, from the prompts that finished
    keys_per = (sum(work.prompt_visible_sum(d, n) for n in prompts)
                / sum(prompts)) if prompts else 0.0
    pre_keys = keys_per * pre_tokens
    kvb = work.kv_bytes_per_token(d)
    t_dec = work.forwards_bound_s(
        d, fwd_dec, n_dec, dec_keys,
        extra_bytes=dec_keys * kvb + n_dec * kvb)
    t_pre = work.forwards_bound_s(
        d, pre["dispatches"], pre_tokens, pre_keys,
        extra_bytes=pre_tokens * kvb)
    return {"decode_forwards": fwd_dec, "decode_tokens": n_dec,
            "decode_keys": dec_keys, "prefill_forwards": pre["dispatches"],
            "prefill_tokens": pre_tokens, "prefill_keys": pre_keys,
            "prompts": prompts, "bound_s": t_dec + t_pre,
            "decode_bound_s": t_dec, "prefill_bound_s": t_pre}


def decode_step_ms(run: dict) -> Optional[float]:
    """The step clock's host ms per decode step over the window: decode
    blocks' wall seconds over blocks times their steps."""
    c = window_clock(run, "decode_block")
    steps = c["dispatches"] * run["decode_block_size"]
    return c["wall_s"] / steps * 1e3 if steps else None
