"""Time the port's prefill and ragged attention kernels on one CUDA card
across split plans and layouts, to see where their time goes.

Run from the root of a checkout on a machine with a card::

    python3 tools/torch_attend_sweep.py [--out attend_sweep.json]
        [--csrc DIR] [--dims 64,128]

``--csrc`` builds the kernels from another directory of sources with the
same C interface (a variant of ``csrc/paged_attention.cu``); ``--dims``
picks the head dims (default 64 and 128), ``--layouts`` a comma-separated
subset of the layouts below by name, and ``--own-only`` times only the
wrapper's own plan.

At the served shapes (H 32, KV 8, tables of 128 pages of 16 tokens) it
times, by CUDA graph replay of 20 calls between CUDA events (host launch
cost out):

- ragged, S = 512 over Bm = 12 rows: the served mix (decode slots with
  valid {0, 1, 16, 17, 300, 1000, 2047, 2048}, chunks 200 @ 0, 250 @ 1500,
  54 @ 100), its decode rows alone, its 1500-deep chunk alone, and an axis
  of padding only (every block searches for its segment and exits: the
  floor of a launch), each under the wrapper's plan and with splits capped
  at 1, 2, 4, 8 and 32 stages;
- prefill [4, 512], q_start {0, 100, 1500, 0}: the served layout, the
  deep row alone, and rows that see nothing (the floor), under the
  wrapper's plan and under forced plans of 1, 2, 4 and 8 splits;
- the kernel's device time of one call from ``torch.profiler``.

Every result is one JSON line on stdout, with the card's name and power
limit; ``--out`` also writes them to a file. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distributed_inference_server_tpu_torch.ops.kernels import (  # noqa: E402
    paged_attention as pa,
)

H, KV, PS, P, NUM_PAGES = 32, 8, 16, 128, 2048
DECODE = [0, 1, 16, 17, 300, 1000, 2047, 2048]
CHUNKS = [(200, 0), (250, 1500), (54, 100)]
RAGGED = {
    "served mix": (DECODE, CHUNKS),
    "decode rows alone": (DECODE, []),
    "deep chunk alone": ([0] * 8, [(0, 0), (250, 1500)]),
    "padding only": ([0] * 8, []),
}
PREFILL = {
    "served": ([0, 100, 1500, 0], [512, 400, 1537, 0]),
    "deep row alone": ([0, 0, 1500, 0], [0, 0, 1537, 0]),
    "nothing visible": ([0, 100, 1500, 0], [0, 0, 0, 0]),
}


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def device_us(fn, calls: int = 20) -> float:
    """Mean device time of the attention kernel per call, from the
    profiler (None when it records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, n = 0.0, 0
    for ev in prof.key_averages():
        if "attend_" in ev.key:
            total += ev.device_time_total
            n += ev.count
    return total / n if n else None


def pools(D: int, B: int, gen):
    dev = "cuda"
    pk = torch.randn(NUM_PAGES * PS, KV, D, generator=gen,
                     device=dev).bfloat16()
    pv = torch.randn(NUM_PAGES * PS, KV, D, generator=gen,
                     device=dev).bfloat16()
    perm = torch.randperm(NUM_PAGES, generator=gen, device=dev)
    tables = perm[: B * P].reshape(B, P).to(torch.int32).contiguous()
    return pk, pv, tables


def ragged_inputs(decode_valid, chunks, D, gen, S=512, Bm=12):
    tok_row, q_pos, valid = [], [], []
    for b, v in enumerate(decode_valid):
        tok_row.append(b if v > 0 else -1)
        q_pos.append(max(v - 1, 0))
        valid.append(v)
    for j, (n, start) in enumerate(chunks):
        tok_row += [len(decode_valid) + j] * n
        q_pos += list(range(start, start + n))
        valid.append(start + n)
    valid += [0] * (Bm - len(valid))
    tok_row += [-1] * (S - len(tok_row))
    q_pos += [0] * (S - len(q_pos))
    i32 = dict(dtype=torch.int32, device="cuda")
    pk, pv, tables = pools(D, Bm, gen)
    q = torch.randn(S, H, D, generator=gen, device="cuda").bfloat16()
    return (q, pk, pv, tables, torch.tensor(tok_row, **i32),
            torch.tensor(q_pos, **i32), torch.tensor(valid, **i32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--csrc", default=None)
    ap.add_argument("--dims", default="64,128")
    ap.add_argument("--layouts", default=None)
    ap.add_argument("--own-only", action="store_true")
    args = ap.parse_args(argv)
    keep = set(args.layouts.split(",")) if args.layouts else None
    if args.csrc:
        from pathlib import Path

        from distributed_inference_server_tpu_torch.ops.kernels import _build

        _build.CSRC_DIR = Path(args.csrc).resolve()
    if not torch.cuda.is_available():
        print("no CUDA device: the sweep needs one card", flush=True)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    rows = []

    def emit(rec):
        rec["card"] = card
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    cap_default = pa.RAGGED_MAX_STAGES
    plan = pa.attend_plan
    for D in (int(d) for d in args.dims.split(",")):
        for name, (dec, chunks) in RAGGED.items():
            if keep is not None and name not in keep:
                continue
            a = ragged_inputs(dec, chunks, D, gen)

            def call():
                return pa.paged_ragged(*a, page_size=PS)

            for cap in ((cap_default,) if args.own_only
                        else (cap_default, 1, 2, 4, 8, 32)):
                pa.RAGGED_MAX_STAGES = cap
                try:
                    splits, chunk = pa.attend_plan(
                        H, KV, 512, 12, P * PS, PS, pa._num_sms(0),
                        pa._attend_per_sm(0, D, True), True)
                    rec = {"kernel": "ragged", "D": D, "layout": name,
                           "max_stages": cap, "splits": splits,
                           "tokens_per_split": chunk, "ms": time_ms(call)}
                    if cap == cap_default:
                        rec["plan"] = "own"
                        rec["device_us"] = device_us(call)
                    emit(rec)
                finally:
                    pa.RAGGED_MAX_STAGES = cap_default
            del a
        for name, (q_start, valid) in PREFILL.items():
            if keep is not None and name not in keep:
                continue
            pk, pv, tables = pools(D, 4, gen)
            q = torch.randn(4, 512, H, D, generator=gen,
                            device="cuda").bfloat16()
            i32 = dict(dtype=torch.int32, device="cuda")
            qs = torch.tensor(q_start, **i32)
            vl = torch.tensor(valid, **i32)

            def call():
                return pa.paged_prefill(q, pk, pv, tables, qs, vl,
                                        page_size=PS)

            own = plan(H, KV, 512, 4, P * PS, PS, pa._num_sms(0),
                       pa._attend_per_sm(0, D, False), False)
            emit({"kernel": "prefill", "D": D, "layout": name, "plan": "own",
                  "splits": own[0], "tokens_per_split": own[1],
                  "ms": time_ms(call), "device_us": device_us(call)})
            for splits in (() if args.own_only else (1, 2, 4, 8)):
                chunk = 2048 // splits
                pa.attend_plan = lambda *a, _f=(splits, chunk): _f
                try:
                    emit({"kernel": "prefill", "D": D, "layout": name,
                          "plan": "forced", "splits": splits,
                          "tokens_per_split": chunk, "ms": time_ms(call)})
                finally:
                    pa.attend_plan = plan
            del q, pk, pv, tables
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
