"""Time the port's paged decode kernel on one CUDA card across split plans
and row lengths, to see where its time goes.

Run from the root of a checkout on a machine with a card::

    python3 tools/torch_decode_sweep.py [--out decode_sweep.json]
        [--csrc DIR] [--kinds bf16:64,...] [--served-only]

``--csrc`` builds the kernels from another directory of sources with the
same C interface (a variant of ``csrc/paged_attention.cu``); ``--kinds``
picks pool kinds and head dims (default: ``bf16:64,bf16:128,int8:64,
int8:128``) and ``--served-only`` times only the served lengths under the
wrapper's plan.

For each pool kind (bf16, int8) and head dim (64, 128) at the served shape
(B = 8, H 32, KV 8, tables of 128 pages of 16 tokens) it times, by CUDA
graph replay of 20 calls between CUDA events (host launch cost out):

- the served lengths {1, 15, 16, 17, 300, 1000, 2047, 2048} under the
  wrapper's own plan and under forced plans of 1 to 32 splits;
- rows with nothing visible (every block exits at once: the floor of a
  launch), rows of 64 tokens (one stage, no merge), one 2048-token row
  alone, and eight 2048-token rows;
- the kernel's device time of one call from ``torch.profiler`` (the graph
  replay also counts the gaps between launches).

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
from distributed_inference_server_tpu_torch.ops.quant import (  # noqa: E402
    QuantPool,
    quantize_kv,
)

SERVED = [1, 15, 16, 17, 300, 1000, 2047, 2048]
SHAPES = {
    "served": SERVED,
    "nothing visible": [0] * 8,
    "one stage each": [64] * 8,
    "one long row": [2048] + [0] * 7,
    "all long": [2048] * 8,
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
    """Mean device time of the decode kernel per call, from the profiler
    (None when the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, n = 0.0, 0
    for ev in prof.key_averages():
        if "decode_attend" in ev.key:
            total += ev.device_time_total
            n += ev.count
    return total / n if n else None


def inputs(D: int, int8: bool, gen):
    B, H, KV, ps, P, num_pages = 8, 32, 8, 16, 128, 1024
    dev = "cuda"
    pk = torch.randn(num_pages * ps, KV, D, generator=gen, device=dev)
    pv = torch.randn(num_pages * ps, KV, D, generator=gen, device=dev)
    if int8:
        pk, pv = QuantPool(*quantize_kv(pk)), QuantPool(*quantize_kv(pv))
    else:
        pk, pv = pk.bfloat16(), pv.bfloat16()
    perm = torch.randperm(num_pages, generator=gen, device=dev)
    tables = perm[: B * P].reshape(B, P).to(torch.int32).contiguous()
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    return q, pk, pv, tables


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--csrc", default=None)
    ap.add_argument("--kinds", default="bf16:64,bf16:128,int8:64,int8:128")
    ap.add_argument("--served-only", action="store_true")
    args = ap.parse_args(argv)
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

    plan = pa.decode_plan
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kind in args.kinds.split(","):
        pools, D = kind.split(":")
        D, int8 = int(D), pools == "int8"
        q, pk, pv, tables = inputs(D, int8, gen)
        label = f"{'int8' if int8 else 'bf16'} D{D}"
        for shape, lengths in SHAPES.items():
            if args.served_only and shape != "served":
                continue
            valid = torch.tensor(lengths, dtype=torch.int32, device="cuda")

            def call():
                return pa.paged_decode(q, pk, pv, tables, valid,
                                       page_size=16)

            own = plan(8, 8, 2048, 16, pa._num_sms(0),
                       pa._decode_per_sm(0, D, int8))
            emit({"pools": label, "rows": shape, "plan": "own",
                  "splits": own[0], "tokens_per_split": own[1],
                  "ms": time_ms(call), "device_us": device_us(call)})
            if shape != "served" or args.served_only:
                continue
            for splits in (1, 2, 3, 4, 6, 8, 12, 16, 32):
                chunk = -(-2048 // splits // 64) * 64
                forced = (-(-2048 // chunk), chunk)
                pa.decode_plan = lambda *a, _f=forced: _f
                try:
                    emit({"pools": label, "rows": shape, "plan": "forced",
                          "splits": forced[0], "tokens_per_split": chunk,
                          "ms": time_ms(call)})
                finally:
                    pa.decode_plan = plan
        del q, pk, pv, tables
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
