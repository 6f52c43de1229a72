"""One run of one benchmark cell:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In one process: read the cell's and its configuration's files; make the
weights on the card from ``--seed``; start the port's ``InferenceServer``
over an ``LLMEngine`` on those weights, serving HTTP on a free local port
(the engine's own warmup captures its graphs); send two requests of the
cell's shapes over HTTP; then start the load generator
(``benchmark/loadgen.py``) in a child process, measure for ``--seconds``,
follow the window's requests to their end, and print the result as the
last line of standard output. ``setup_s`` runs from the start of this
module to the window's first request. With ``--trace 1`` a steady
sub-window is traced (``benchmark/devtrace.py``) and the per-layer
metrics are printed instead of the end-to-end ones.

After the window the server is shut down and its engine freed, and a
sample of the finished requests, drawn from the seed with the longest
among them, is checked against the float32 reference
(``benchmark/reference``): for greedy requests the gaps by which the
served tokens' logits lie below the reference's best, for sampled ones
how well the served tokens fit the reference's distribution at their
temperature and top_p (``check``); each number must stay within the
cell's limit.

Exit codes: 0 with a result line; 3 without the cards the cell asks for;
4 when a JAX module was loaded; 1 on any other failure.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import urllib.request  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from benchmark import loadgen, readings, spec, work  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "distributed_inference_server_tpu")
HOST = "127.0.0.1"
# seconds between spawning the load generator and the window's opening
LEAD_S = 0.5


def cache_dirs(root: Path) -> None:
    """Every compile cache at a fixed path inside the checkout: the
    kernels' nvcc builds go to ``build/kernels`` (the port's own choice),
    Triton's to ``build/benchmark/triton``."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "benchmark"
                                         / "triton")


def forbidden_modules() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def engine_config(cfg: dict, seed: int):
    """The port's ``EngineConfig`` from the configuration's ``engine``
    block: ``num_pages``, ``page_size`` and ``max_pages_per_seq`` go to
    the paged cache, every other key to the field of its name."""
    from distributed_inference_server_tpu_torch.engine.engine import (
        EngineConfig,
    )
    from distributed_inference_server_tpu_torch.engine.kv_cache import (
        PagedCacheConfig,
    )

    eng = dict(cfg["engine"])
    paged = {k: eng.pop(k) for k in ("num_pages", "page_size",
                                     "max_pages_per_seq") if k in eng}
    for k in ("admission_window_ms", "admission_max_batch"):
        eng.pop(k, None)
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = set(eng) - fields
    if unknown:
        raise ValueError(f"config {cfg['name']}: unknown engine keys "
                         f"{sorted(unknown)}")
    if "prefill_buckets" in eng:
        eng["prefill_buckets"] = tuple(eng["prefill_buckets"])
    return EngineConfig(seed=abs(int(seed)) % (1 << 31),
                        paged=PagedCacheConfig(**paged), **eng)


def hf_keys(cfg: dict) -> dict:
    return {k: v for k, v in cfg.items()
            if k not in ("engine", "changed", "assumed", "reduced")}


class Harness:
    """The port's server on the cell's weights, and the window's
    instruments."""

    def __init__(self, w: dict, cfg: dict, seed: int, device):
        self.w, self.cfg, self.seed, self.device = w, cfg, seed, device
        self.dims = work.dims(cfg)
        self.server = None
        self.port = None
        self.tree = None

    # -- set-up ------------------------------------------------------------

    def start(self) -> None:
        import torch

        from benchmark import weights
        from benchmark.tokenizer import PieceTokenizer
        from distributed_inference_server_tpu_torch.core.validator import (
            ValidatorConfig,
        )
        from distributed_inference_server_tpu_torch.engine.engine import (
            LLMEngine,
        )
        from distributed_inference_server_tpu_torch.models.loader import (
            config_from_hf_json,
        )
        from distributed_inference_server_tpu_torch.serving.batcher import (
            BatcherConfig,
        )
        from distributed_inference_server_tpu_torch.serving.server import (
            InferenceServer,
        )

        dtype = getattr(torch, self.cfg["dtype"])
        self.tree = weights.make(self.dims, self.seed, self.device, dtype)
        port_tree = weights.as_port_tree(self.tree)
        mcfg = config_from_hf_json(hf_keys(self.cfg), name=self.cfg["name"])
        ecfg = engine_config(self.cfg, self.seed)
        self.ecfg = ecfg
        tok = PieceTokenizer(self.dims.vocab)
        cap = ecfg.paged.page_size * ecfg.paged.max_pages_per_seq - 1
        eng = self.cfg["engine"]
        device = self.device

        def factory():
            return LLMEngine(port_tree, mcfg, tok, ecfg, dtype=dtype,
                             device=device)

        self.server = InferenceServer(
            factory, tok, model_name=self.cfg["name"],
            batcher_config=BatcherConfig(
                window_ms=float(eng.get("admission_window_ms", 50.0)),
                max_batch_size=int(eng.get("admission_max_batch", 32))),
            validator_config=ValidatorConfig(max_context_tokens=cap,
                                             max_output_tokens=cap))
        self.server.start()
        if not self.server.runner.is_healthy():
            raise RuntimeError(f"engine failed to start: "
                               f"{self.server.runner.last_error()}")
        self.port = self.server.serve(HOST, 0, block=False)

    def warm(self) -> None:
        """Two requests of the cell's median shapes over HTTP, one in
        each sampling mode the cell uses: the HTTP path and the sampler's
        first calls before the window."""
        w = self.w
        modes = [True] + ([False] if w.get("greedy_share", 1.0) < 1 else [])
        for k, greedy in enumerate(modes):
            n = int(w["prompt_tokens"]["median"])
            ids = [1] + [loadgen.FIRST_ORDINARY_ID + (k * 7919 + j) % 1000
                         for j in range(n - 1)]
            samp = w.get("sampling", {})
            req = {"prompt_ids": ids,
                   "max_tokens": 2 * self.ecfg.decode_block_size + 1,
                   "temperature": 0.0 if greedy else samp["temperature"],
                   "top_p": 1.0 if greedy else samp["top_p"]}
            rec: dict = {}
            loadgen.stream_one(HOST, self.port, loadgen.body(req),
                               time.monotonic() + 300.0, rec)
            if rec.get("error") or rec.get("cut"):
                raise RuntimeError(f"warm request failed: {rec}")

    # -- instruments -----------------------------------------------------

    def scrape(self) -> Dict:
        with urllib.request.urlopen(f"http://{HOST}:{self.port}/metrics",
                                    timeout=30) as r:
            return readings.parse_prometheus(r.read().decode())

    def clock(self) -> dict:
        return self.server.runner.call(lambda e: e.step_clock_stats(), 60.0)

    # -- the window --------------------------------------------------------

    def window(self, reqs: List[dict], seconds: float, trace: bool,
               on_open=None) -> dict:
        """Offer ``reqs`` for ``seconds`` and follow them; returns the run
        record (requests with their timings, the snapshots, the trace)."""
        w = self.w
        ramp = float(w.get("ramp_s", 0.0)) if w["loop"] == "closed" else 0.0
        plan = {"host": HOST, "port": self.port, "seconds": seconds,
                "drain_s": float(w["drain_s"]), "loop": w["loop"],
                "clients": int(w.get("clients", 0)), "ramp_s": ramp,
                "requests": [{"i": r["i"], "at": r["at"],
                              "body": loadgen.body(r).decode()}
                             for r in reqs]}
        proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.loadgen"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            cwd=str(spec.ROOT))
        out_box: List[bytes] = []
        reader = threading.Thread(
            target=lambda: out_box.append(proc.stdout.read()), daemon=True)
        reader.start()
        pages = PagePeak(self.server.runner)
        try:
            t0 = time.monotonic() + LEAD_S + ramp
            plan["t0"] = t0
            proc.stdin.write(json.dumps(plan).encode())
            proc.stdin.close()
            if on_open is not None:
                on_open(t0)
            _sleep_until(t0)
            pages.start()
            rec = {"t0": t0, "t1": t0 + seconds, "seconds": seconds,
                   "clock_open": self.clock(),
                   "metrics_open": self.scrape(), "trace": None}
            tw = w.get("trace", {})
            # the counters' close for the per-layer metrics: the window's
            # close, or the traced sub-window's start, before the
            # profiler's load and its stop's stall
            span = (min(float(tw.get("seconds", 5.0)), 0.5 * seconds)
                    if trace else 0.0)
            _sleep_until(t0 + seconds - span)
            rec["t_cut"] = time.monotonic()
            rec["clock_cut"] = self.clock()
            rec["metrics_cut"] = self.scrape()
            if trace:
                from benchmark.devtrace import SubWindow

                # the window's last seconds: stopping the profiler stalls
                # the process while it collects the trace, and a stall at
                # the close delays no arrival of the window
                sub = SubWindow(self.server.runner)
                sub.begin()
                _sleep_until(t0 + seconds)
                rec["trace"] = sub.end()
            _sleep_until(t0 + seconds)
            proc.wait(timeout=seconds + float(w["drain_s"]) + 120.0)
        finally:
            rec_pages = pages.stop()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        reader.join(60.0)
        if proc.returncode != 0 or not out_box:
            raise RuntimeError(f"load generator exited {proc.returncode}")
        requests = []
        by_i = {r["i"]: r for r in reqs}
        for res in json.loads(out_box[0]):
            q = by_i[res["i"]]
            times = res.get("times") or []
            requests.append({
                "i": res["i"], "due": res.get("due"), "sent": res.get("sent"),
                "first": times[0] if times else None,
                "last": times[-1] if times else None,
                "times": times, "ids": res.get("ids") or [],
                "prompt_ids": q["prompt_ids"],
                "prompt_len": len(q["prompt_ids"]),
                "max_tokens": q["max_tokens"], "greedy": q["greedy"],
                "temperature": q["temperature"], "top_p": q["top_p"],
                "finish": res.get("finish"), "error": res.get("error"),
                "cut": bool(res.get("cut"))})
        rec["requests"] = requests
        rec["pages"] = rec_pages
        return rec

    def stop(self) -> None:
        """Shut the server down and free the engine (its pools and
        graphs); the weights stay for the reference."""
        import torch

        if self.server is not None:
            self.server.shutdown(drain_timeout_s=5.0)
            self.server = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


class PagePeak:
    """The most KV pages the engine held from the window's opening to the
    end of its requests, from the runner's own snapshot of the page
    counts (``runner.status()``, refreshed after every engine step and
    read without waiting for the engine): ``used`` counts every page off
    the free list, ``live`` leaves out the cached pages of finished
    requests, which the pool hands out again on demand."""

    PERIOD_S = 0.05

    def __init__(self, runner):
        self.runner = runner
        self.peak = {"used": 0, "live": 0, "total": 0, "page_size": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _poll(self) -> None:
        while not self._stop.is_set():
            s = self.runner.status()
            p = self.peak
            p["used"] = max(p["used"], s.memory_used_pages)
            p["live"] = max(p["live"], s.memory_used_pages - s.pages_cached)
            p["total"], p["page_size"] = s.memory_total_pages, s.page_size
            self._stop.wait(self.PERIOD_S)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> dict:
        if self._thread.is_alive():
            self._stop.set()
            self._thread.join()
        return dict(self.peak)


def _sleep_until(t: float) -> None:
    d = t - time.monotonic()
    if d > 0:
        time.sleep(d)


# -- the check ----------------------------------------------------------


# each number compared: the key it is read from in the check's readings
NUMBERS = {"logit_gap_max": "widest", "logit_gap_mean": "mean",
           "sampled_excess_nats": "sampled_excess",
           "sampled_outside_share": "sampled_outside"}
SAMPLED = ("sampled_excess_nats", "sampled_outside_share")


def sample(run: dict, w: dict, seed: int, greedy: bool = True
           ) -> List[dict]:
    """Finished requests of one sampling mode for the reference: the
    longest (prompt and served tokens), then others in an order drawn
    from the seed until ``check.served_tokens`` served tokens or
    ``check.max_requests`` (sampled requests: ``check.sampled_tokens``,
    ``check.sampled_max_requests``)."""
    import numpy as np

    pool = [r for r in run["requests"]
            if r["greedy"] == greedy and r["finish"] in ("length", "stop")
            and not r["error"] and not r["cut"] and r["ids"]]
    if not pool:
        return []
    pool.sort(key=lambda r: (-(r["prompt_len"] + len(r["ids"])), r["i"]))
    chosen = [pool[0]]
    rng = np.random.default_rng(abs(int(seed)) % (1 << 128)
                                + (1 if greedy else 2))
    rest = [pool[j] for j in rng.permutation(len(pool) - 1) + 1]
    c = w["check"]
    most = int(c["served_tokens"] if greedy else c["sampled_tokens"])
    count = int(c["max_requests"] if greedy else c["sampled_max_requests"])
    for r in rest:
        if (sum(len(x["ids"]) for x in chosen) >= most
                or len(chosen) >= count):
            break
        chosen.append(r)
    return chosen


def check(h: Harness, run: dict, control: bool) -> dict:
    """The reference's readings over the sample, against the cell's
    limits. Greedy requests: ``logit_gap_max``, the widest gap by which a
    served token's logit lies below the reference's best, and
    ``logit_gap_mean``, the mean gap over the sampled served tokens.
    Sampled requests, where the cell names their numbers:
    ``sampled_excess_nats``, the served tokens' mean excess surprise
    under the reference's distribution at each request's temperature and
    top_p, and ``sampled_outside_share``, the share of served tokens
    outside the reference's nucleus (``reference.model.sampled_fit``).
    With ``control`` the same numbers for the lower precision's tokens
    (its best, and draws from its nucleus), and, as a planted fault,
    draws from the reference's own nucleus at temperature 1."""
    import torch

    from benchmark.reference import model as ref

    limits = dict(h.w["check"]["limits"])
    chosen = sample(run, h.w, h.seed)
    sampled = (sample(run, h.w, h.seed, greedy=False)
               if SAMPLED[0] in limits or SAMPLED[1] in limits else [])
    out = {"requests": len(chosen),
           "served_tokens": sum(len(r["ids"]) for r in chosen),
           "sampled_requests": len(sampled),
           "sampled_served_tokens": sum(len(r["ids"]) for r in sampled),
           "limits": limits, "program": {}}
    if control:
        out["control"] = {"precision": h.cfg["control"]}
    t = time.monotonic()
    if chosen:
        seqs, score = ref.teacher_forced(chosen)
        probe: dict = {}
        logits = ref.forward_logits(h.cfg, h.tree, seqs, score, h.device,
                                    probe=probe)
        picks = [torch.tensor(r["ids"], device=h.device) for r in chosen]
        out["program"].update(ref.widest_gap(logits, picks, probe))
        if control:
            low = ref.forward_logits(h.cfg, h.tree, seqs, score, h.device,
                                     h.cfg["control"])
            out["control"].update(ref.widest_gap(
                logits, [lg.argmax(-1) for lg in low], probe))
        del logits
    if sampled:
        seqs, score = ref.teacher_forced(sampled)
        temps = [r["temperature"] for r in sampled]
        tops = [r["top_p"] for r in sampled]
        logits = ref.forward_logits(h.cfg, h.tree, seqs, score, h.device)
        picks = [torch.tensor(r["ids"], device=h.device) for r in sampled]
        out["program"].update(_prefixed(
            ref.sampled_fit(logits, picks, temps, tops)))
        if control:
            gen = torch.Generator(device=h.device)
            gen.manual_seed(abs(int(h.seed)) % (1 << 63))
            low = ref.forward_logits(h.cfg, h.tree, seqs, score, h.device,
                                     h.cfg["control"])
            draws = ref.nucleus_draw(low, temps, tops, gen)
            out["control"].update(_prefixed(
                ref.sampled_fit(logits, draws, temps, tops)))
            hot = ref.nucleus_draw(logits, [1.0] * len(sampled), tops, gen)
            out["fault_temperature"] = _prefixed(
                ref.sampled_fit(logits, hot, temps, tops))
        del logits
    out["reference_s"] = time.monotonic() - t
    return out


def _prefixed(fit: dict) -> dict:
    return {f"sampled_{k}": v for k, v in fit.items()}


def compared(chk: dict, side: str = "program") -> Dict[str, dict]:
    """Each number compared, beside its limit (None when the sample had
    nothing to read it from)."""
    got = chk.get(side) or {}
    return {name: {"value": got.get(NUMBERS[name]), "limit": limit}
            for name, limit in chk["limits"].items()}


def is_correct(numbers: Dict[str, dict]) -> bool:
    return bool(numbers) and all(
        n["value"] is not None and n["value"] <= n["limit"]
        for n in numbers.values())


# -- the result ---------------------------------------------------------


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ("unknown" where
    it cannot): the peaks in ``benchmark/work.py`` assume 700 W."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip() or "unknown"


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def counts(run: dict, w: dict) -> Dict[str, int]:
    reqs = run["requests"]
    attempted = sum(1 for r in reqs if r["sent"] is not None)
    failed = sum(1 for r in reqs if r["error"]
                 or (w["loop"] == "open" and r["cut"]))
    return {"attempted": attempted, "failed": failed}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, bench: Optional[dict] = None, base: Path = spec.HERE,
             control: bool = False, log=print) -> dict:
    """One run; returns the result object (and its ``run`` record under
    the key ``_run``, which is not printed)."""
    w = spec.workload(workload, base)
    cfg = spec.config(w["config"], base)
    bench = bench if bench is not None else spec.benchmark_json()
    h = Harness(w, cfg, seed, device)
    reqs = loadgen.schedule(w, seed, seconds, h.dims.vocab)
    h.start()
    try:
        h.warm()
        if trace:
            from benchmark.devtrace import warm_profiler

            warm_profiler(h.server.runner)
        opened = {}
        run = h.window(reqs, seconds, trace,
                       on_open=lambda t0: opened.setdefault("t0", t0))
        setup_s = opened["t0"] - T_START
        dev = device_info(device, spec.chips(bench, workload) or 1)
    finally:
        h.stop()
    run.update(workload=w, config=cfg, dims=h.dims, setup_s=setup_s,
               decode_block_size=h.ecfg.decode_block_size)
    chk = check(h, run, control)
    mine = spec.cell_metrics(bench, workload)
    metrics = {}
    for m in mine["per_layer" if trace else "end_to_end"]:
        v = spec.metric_reader(m["name"], base)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    late = [r["sent"] - r["due"] for r in run["requests"]
            if r["sent"] is not None and r.get("due") is not None]
    log(json.dumps({"lateness_s": {
        "max": max(late, default=0.0),
        "mean": sum(late) / len(late) if late else 0.0,
        "n": len(late)}, "reference_s": chk.get("reference_s"),
        "served_tokens_checked": chk["served_tokens"],
        "requests_checked": chk["requests"],
        "sampled_tokens_checked": chk["sampled_served_tokens"],
        "sampled_requests_checked": chk["sampled_requests"],
        "pages_peak": pages_report(run)}), file=sys.stderr)
    numbers = compared(chk)
    result = {"correct": is_correct(numbers),
              **counts(run, w), "metrics": metrics, "device": dev}
    if trace and run["trace"]:
        tr = run["trace"]
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["check"] = numbers
    if control:
        result["control"] = chk.get("control")
        result["control_correct"] = is_correct(compared(chk, "control"))
        if "fault_temperature" in chk:
            result["fault_temperature"] = chk["fault_temperature"]
    result["_run"] = run
    result["_check"] = chk
    return result


def pages_report(run: dict) -> dict:
    """The window's peak KV pages (``PagePeak``) and the bytes the live
    ones hold."""
    p = dict(run.get("pages") or {})
    if p:
        p["live_kv_bytes"] = (p["live"] * p["page_size"]
                              * work.kv_bytes_per_token(run["dims"]))
    return p


def write_record(root: Path, workload: str, seed: int, trace: bool,
                 result: dict) -> None:
    """The run's own file: each request's timings and counts (no token
    ids), the lateness of the generator, and the check."""
    run = result["_run"]
    out = root / "build" / "benchmark" / "runs"
    out.mkdir(parents=True, exist_ok=True)
    reqs = [{k: r[k] for k in ("i", "due", "sent", "first", "last",
                               "prompt_len", "max_tokens", "greedy",
                               "finish", "error", "cut")}
            | {"tokens": len(r["ids"])} for r in run["requests"]]
    body = {"workload": workload, "seed": seed, "trace": trace,
            "t0": run["t0"], "seconds": run["seconds"],
            "setup_s": run["setup_s"], "requests": reqs,
            "pages_peak": pages_report(run),
            "check": {k: v for k, v in result["_check"].items()},
            "trace_summary": ({k: v for k, v in run["trace"].items()
                               if k not in ("by_name",)}
                              if run["trace"] else None)}
    path = out / f"{workload}.seed{seed}.trace{int(trace)}.json"
    path.write_text(json.dumps(body, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the lower-precision control's gap")
    args = ap.parse_args(argv)
    cache_dirs(spec.ROOT)
    bench = spec.benchmark_json()
    import torch

    chips = spec.chips(bench, args.workload)
    if chips is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA device(s); torch sees {seen}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), bench,
                      control=bool(args.control))
    write_record(spec.ROOT, args.workload, args.seed, bool(args.trace),
                 result)
    print(f"peaks: {work.PEAK_BF16_FLOPS / 1e12:g} TFLOP/s bf16, "
          f"{work.PEAK_HBM_BYTES / 1e12:g} TB/s (data sheet, 700 W); card: "
          f"{power_limit()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"JAX modules loaded in this process: {bad}", file=sys.stderr)
        return 4
    chk = result["check"]
    for name, v in chk.items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    line = {k: v for k, v in result.items() if not k.startswith("_")}
    line["check"] = line.pop("check")  # last key
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
