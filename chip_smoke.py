"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``/usr/local/cuda``) and ``triton``; it imports
nothing of JAX. Phases, each of which must pass (any failure exits 1):

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA source of the port (one ``nvcc`` per source, all
   started together, ``-Xptxas -v`` printed);
3. holds each hand-written kernel (paged decode, paged prefill, RMSNorm,
   RoPE) against its plain PyTorch version on the card at the serving
   shapes of llama-3.2-1b, in bf16, and times kernel, plain version,
   one PyTorch library call where there is one, and the bytes/operations
   bound;
4. starts ``python -m distributed_inference_server_tpu_torch`` serving
   llama-3.2-1b (full width and depth, random weights from a seed) and
   sends concurrent ``POST /generate`` requests; the kernels' launch
   counts are zeroed just before and read just after, from
   ``/server/stats``, and every kernel must have launched;
5. runs the engine at 2 layers of the 1B width in f32 with the kernels and
   with the plain versions and requires identical greedy tokens.

Before the last line it prints one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Without a card it exits 2
and prints no result. ``--phases kernels,serve,engine`` selects phases
(default: all).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}  # dense, per the card's data sheet

# tolerance of every kernel-vs-plain comparison in bf16: |a - b| <=
# ATOL + RTOL * |b| (about two bf16 ulps; both versions accumulate in f32
# and differ only in summation order and the final rounding)
ATOL, RTOL = 1e-2, 2.0 ** -7


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi failed: {out.stderr.strip()}")


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()`` in ms: ``iters`` calls captured in a
    CUDA graph and replayed between CUDA events (so host launch cost is
    out of the number), after an eager warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def bound(nbytes: float, ops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of the type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes}


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"atol {ATOL} + rtol {RTOL}; max abs err {float(err.max())}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def _pool_case(B, H, KV, D, page_size, P, num_pages, dtype, gen):
    dev = "cuda"
    slots = num_pages * page_size
    pool_k = torch.randn(slots, KV, D, generator=gen, device=dev).to(dtype)
    pool_v = torch.randn(slots, KV, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(num_pages, generator=gen, device=dev)
    reps = -(-(B * P) // num_pages)
    tables = perm.repeat(reps)[: B * P].reshape(B, P).to(torch.int32)
    return pool_k, pool_v, tables.contiguous()


def _gathered(pool, tables, page_size):
    """[B, S, KV, D] -> [B, KV, S, D]: the dense window a library call
    needs (built outside the timed region)."""
    from distributed_inference_server_tpu_torch.models.llama import (
        gather_kv_window,
    )

    k, _ = gather_kv_window(pool, pool, tables, page_size)
    return k.transpose(1, 2).contiguous()


def _sdpa(q, k, v, mask):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


def check_decode(case, valid_list, window=0, softcap=0.0, H=32, KV=8, D=64,
                 page_size=16, P=128, num_pages=1024, time_it=True):
    from distributed_inference_server_tpu_torch.ops.kernels import (
        paged_attention as pa,
    )

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1000 + len(case))
    B = len(valid_list)
    pool_k, pool_v, tables = _pool_case(B, H, KV, D, page_size, P, num_pages,
                                        dt, gen)
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dt)
    valid = torch.tensor(valid_list, dtype=torch.int32, device="cuda")
    kw = dict(page_size=page_size, sliding_window=window, attn_softcap=softcap)
    got = pa.paged_decode(q, pool_k, pool_v, tables, valid, **kw)
    want = pa.paged_decode_plain(q, pool_k, pool_v, tables, valid, **kw)
    torch.cuda.synchronize()
    err = compare(f"paged_decode[{case}]", got, want)
    rec = {"case": case, "max_abs_err": err}
    if not time_it:
        return rec
    e = q.element_size()
    seen = [min(v, window) if window > 0 else v for v in valid_list]
    pages = sum(-(-v // page_size) for v in valid_list)
    nbytes = 2 * q.numel() * e + 2 * sum(seen) * KV * D * e + pages * 4 + B * 4
    ops = 4 * sum(seen) * H * D
    rec["ms"] = time_ms(lambda: pa.paged_decode(q, pool_k, pool_v, tables,
                                                valid, **kw))
    rec["plain_ms"] = time_ms(lambda: pa.paged_decode_plain(
        q, pool_k, pool_v, tables, valid, **kw))
    kg, vg = _gathered(pool_k, tables, page_size), _gathered(pool_v, tables,
                                                            page_size)
    S = kg.shape[2]
    kv_pos = torch.arange(S, device="cuda")
    mask = kv_pos[None, :] < valid[:, None]
    if window > 0:
        mask &= kv_pos[None, :] >= (valid[:, None] - window)
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    rec["library_ms"] = (time_ms(lambda: _sdpa(q4, kg, vg, mask))
                         if softcap == 0.0 else None)
    rec.update(bound(nbytes, ops, dt))
    return rec


def check_prefill(case, T, q_start, valid_list, window=0, softcap=0.0, H=32,
                  KV=8, D=64, page_size=16, P=128, num_pages=1024,
                  time_it=True):
    from distributed_inference_server_tpu_torch.ops.kernels import (
        paged_attention as pa,
    )

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(2000 + T + len(case))
    B = len(valid_list)
    pool_k, pool_v, tables = _pool_case(B, H, KV, D, page_size, P, num_pages,
                                        dt, gen)
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dt)
    qs = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    valid = torch.tensor(valid_list, dtype=torch.int32, device="cuda")
    kw = dict(page_size=page_size, sliding_window=window, attn_softcap=softcap)
    got = pa.paged_prefill(q, pool_k, pool_v, tables, qs, valid, **kw)
    want = pa.paged_prefill_plain(q, pool_k, pool_v, tables, qs, valid, **kw)
    torch.cuda.synchronize()
    err = compare(f"paged_prefill[{case}]", got, want)
    rec = {"case": case, "max_abs_err": err}
    if not time_it:
        return rec
    e = q.element_size()
    # what this data needs: each row's visible keys (read once) and, per
    # query, the keys it attends
    kv_tokens = 0
    pair_count = 0
    for b in range(B):
        lo_row = None
        for t in range(T):
            pos = q_start[b] + t
            hi = min(pos + 1, valid_list[b])
            lo = max(pos - window + 1, 0) if window > 0 else 0
            if hi > lo:
                pair_count += hi - lo
                lo_row = lo if lo_row is None else min(lo_row, lo)
        if lo_row is not None:
            kv_tokens += min(valid_list[b], q_start[b] + T) - lo_row
    nbytes = 2 * q.numel() * e + 2 * kv_tokens * KV * D * e + B * P * 4
    ops = 4 * pair_count * H * D
    rec["ms"] = time_ms(lambda: pa.paged_prefill(q, pool_k, pool_v, tables,
                                                 qs, valid, **kw))
    rec["plain_ms"] = time_ms(lambda: pa.paged_prefill_plain(
        q, pool_k, pool_v, tables, qs, valid, **kw))
    kg, vg = _gathered(pool_k, tables, page_size), _gathered(pool_v, tables,
                                                            page_size)
    S = kg.shape[2]
    kv_pos = torch.arange(S, device="cuda")
    q_pos = qs[:, None].long() + torch.arange(T, device="cuda")
    mask = (kv_pos[None, None, :] <= q_pos[:, :, None]) & (
        kv_pos[None, None, :] < valid[:, None, None])
    if window > 0:
        mask &= kv_pos[None, None, :] > q_pos[:, :, None] - window
    mask = mask[:, None]
    qt = q.transpose(1, 2).contiguous()
    rec["library_ms"] = (time_ms(lambda: _sdpa(qt, kg, vg, mask))
                         if softcap == 0.0 else None)
    rec.update(bound(nbytes, ops, dt))
    return rec


def check_rms_norm(case, shape, time_it=True):
    import torch.nn.functional as F

    from distributed_inference_server_tpu_torch.ops.kernels import fused

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3000 + len(shape))
    x = torch.randn(*shape, generator=gen, device="cuda").to(dt)
    w = (1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")).to(dt)
    eps = 1e-5
    got = fused.rms_norm(x, w, eps)
    want = fused.rms_norm_plain(x, w, eps)
    torch.cuda.synchronize()
    rec = {"case": case, "max_abs_err": compare(f"rms_norm[{case}]", got,
                                                want)}
    if not time_it:
        return rec
    e = x.element_size()
    rec["ms"] = time_ms(lambda: fused.rms_norm(x, w, eps))
    rec["plain_ms"] = time_ms(lambda: fused.rms_norm_plain(x, w, eps))
    rec["library_ms"] = time_ms(lambda: F.rms_norm(x, (shape[-1],), w, eps))
    rec.update(bound(
        2 * x.numel() * e + w.numel() * e, 4 * x.numel(), dt))
    return rec


def check_rope(case, shape, pos_start, time_it=True):
    from distributed_inference_server_tpu_torch.models.configs import (
        LLAMA_3_2_1B as C,
    )
    from distributed_inference_server_tpu_torch.ops.kernels import fused
    from distributed_inference_server_tpu_torch.ops.rotary import (
        rope_frequencies,
    )

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(4000 + len(shape))
    B, T, nh, D = shape
    x = torch.randn(*shape, generator=gen, device="cuda").to(dt)
    pos = (torch.arange(T, device="cuda", dtype=torch.int32)[None, :]
           + torch.tensor(pos_start, device="cuda",
                          dtype=torch.int32)[:, None]).contiguous()
    inv = rope_frequencies(D, C.rope_theta, C.rope_scaling, device="cuda")
    got = fused.apply_rope(x, pos, inv)
    want = fused.apply_rope_plain(x, pos, inv)
    torch.cuda.synchronize()
    rec = {"case": case, "max_abs_err": compare(f"rope[{case}]", got, want)}
    if not time_it:
        return rec
    e = x.element_size()
    rec["ms"] = time_ms(lambda: fused.apply_rope(x, pos, inv))
    rec["plain_ms"] = time_ms(lambda: fused.apply_rope_plain(x, pos, inv))
    rec["library_ms"] = None
    rec.update(bound(
        2 * x.numel() * e + pos.numel() * 4 + inv.numel() * 4,
        6 * x.numel(), dt))
    return rec


def phase_kernels(time_it=True) -> dict:
    """Returns {kernel: [records]}; the first record of each kernel is its
    main-path shape (the one the summary line reports)."""
    lengths = [1, 15, 16, 17, 300, 1000, 2047, 2048]
    out = {
        "paged_decode": [
            check_decode("B8 1B ragged", lengths, time_it=time_it),
            check_decode("B8 with valid=0", [0] + lengths[1:], time_it=False),
            check_decode("window64 softcap30", lengths, window=64,
                         softcap=30.0, time_it=False),
            check_decode("D128", lengths, D=128, time_it=False),
        ],
        "paged_prefill": [
            check_prefill("B4 T512 q_start>0", 512, [0, 100, 1500, 0],
                          [512, 400, 1537, 0], time_it=time_it),
            check_prefill("B4 T128 q_start>0", 128, [0, 16, 1000, 0],
                          [128, 100, 1128, 0], time_it=False),
            check_prefill("T128 window100 softcap50", 128, [0, 300, 900, 0],
                          [128, 428, 1000, 0], window=100, softcap=50.0,
                          time_it=False),
            check_prefill("D128 T128", 128, [0, 200, 1000, 0],
                          [128, 328, 1100, 0], D=128, time_it=False),
        ],
        "rms_norm": [
            check_rms_norm("prefill chunk [4,512,2048]", (4, 512, 2048),
                           time_it=time_it),
            check_rms_norm("decode step [8,1,2048]", (8, 1, 2048),
                           time_it=time_it),
        ],
        "rope": [
            check_rope("prefill q [4,512,32,64]", (4, 512, 32, 64),
                       [0, 100, 1500, 0], time_it=time_it),
            check_rope("decode q [8,1,32,64]", (8, 1, 32, 64),
                       [5, 17, 300, 2047, 0, 1, 15, 16], time_it=time_it),
            check_rope("D128 k [4,128,8,128]", (4, 128, 8, 128),
                       [0, 7, 900, 2000], time_it=False),
        ],
    }
    for name, recs in out.items():
        for r in recs:
            log(json.dumps({"kernel_check": name, **r}))
    return out


# ---------------------------------------------------------------------------
# phase 4: the served /generate path
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(method, url, body=None, timeout=600.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def _check_generate(status, body, max_tokens):
    assert status == 200, f"HTTP {status}: {body}"
    for key in ("id", "object", "created", "model", "choices", "usage"):
        assert key in body, f"response lacks {key!r}: {body}"
    assert body["object"] == "text_completion"
    ch = body["choices"][0]
    assert set(ch) == {"text", "index", "finish_reason"}, ch
    assert ch["finish_reason"] in ("stop", "length", "stop_sequence"), ch
    u = body["usage"]
    assert 1 <= u["completion_tokens"] <= max_tokens, u
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]


def phase_serve(card: str, seed: int = 0) -> dict:
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "distributed_inference_server_tpu_torch",
           "--model-model-name", "llama-3.2-1b", "--server-port", str(port),
           "--seed", str(seed)]
    log("[serve] " + " ".join(cmd))
    os.makedirs("chiprun_out", exist_ok=True)
    errlog = open(os.path.join("chiprun_out", "server.log"), "w")
    proc = subprocess.Popen(cmd, stdout=errlog, stderr=subprocess.STDOUT)
    try:
        t0 = time.monotonic()
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited with {proc.returncode} "
                                   "(chiprun_out/server.log)")
            try:
                st, health = _http("GET", base + "/health", timeout=5)
                if st == 200 and health.get("status") == "ok":
                    break
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            if time.monotonic() - t0 > 400:
                raise RuntimeError("server did not become healthy in 400 s")
            time.sleep(1.0)
        log(f"[serve] healthy after {time.monotonic() - t0:.1f} s")

        greedy = {"temperature": 0.0, "max_tokens": 24}
        prompts = {
            "p20": "The H100 serves this.",  # 21 ids with BOS
            "p100": ("Paged attention reads each row's pages straight from "
                     "the pool; the gather path copies them. ") * 1 + "x" * 4,
            "p600": ("Long prompt chunked past the 512 bucket. " * 15)[:600],
        }

        def gen(prompt, params):
            t = time.monotonic()
            st, body = _http("POST", base + "/generate",
                             {"prompt": prompt, **params})
            return st, body, time.monotonic() - t

        # warm pass (kernel builds and first launches), not counted
        st, body, _ = gen("warm up", {"temperature": 0.0, "max_tokens": 4})
        _check_generate(st, body, 4)
        st, solo, _ = gen(prompts["p20"], greedy)
        _check_generate(st, solo, greedy["max_tokens"])

        _http("POST", base + "/server/kernel_counts/reset", {})
        _, stats0 = _http("GET", base + "/server/stats")
        assert all(v == 0 for v in stats0["kernel_launches"].values()), stats0
        t_all = time.monotonic()
        jobs = [(prompts["p20"], greedy), (prompts["p100"], greedy),
                (prompts["p600"], greedy),
                (prompts["p100"], {"temperature": 0.8, "top_p": 0.9,
                                   "max_tokens": 24})]
        with cf.ThreadPoolExecutor(len(jobs)) as ex:
            results = list(ex.map(lambda j: gen(*j), jobs))
        wall = time.monotonic() - t_all
        st, again, dt_again = gen(prompts["p20"], greedy)
        _, stats = _http("GET", base + "/server/stats")
        launches = stats["kernel_launches"]
        log("[serve] launches on the served path: " + json.dumps(launches))

        for (prompt, params), (st, body, _) in zip(jobs, results):
            _check_generate(st, body, params["max_tokens"])
        _check_generate(st, again, greedy["max_tokens"])
        for name, n in launches.items():
            assert n > 0, f"kernel {name} never launched on the served path"
        assert again["choices"][0]["text"] == solo["choices"][0]["text"], (
            "greedy repeat differs", solo, again)
        hits = stats["cache"]["hits"]
        assert hits > 0, f"no prefix hit in /server/stats: {stats['cache']}"
        toks = sum(b["usage"]["completion_tokens"] for _, b, _ in results)
        log(json.dumps({
            "serve": "llama-3.2-1b bf16 random weights", "card": card,
            "concurrent_requests": len(jobs), "wall_s": wall,
            "completion_tokens": toks, "tokens_per_s": toks / wall,
            "request_latency_s": [r[2] for r in results],
            "repeat_latency_s": dt_again, "prefix_hits": hits,
            "concurrent_p20_matches_solo": (
                results[0][1]["choices"][0]["text"]
                == solo["choices"][0]["text"]),
            "note": "smoke numbers, not a benchmark",
        }))
        return launches
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        errlog.close()


# ---------------------------------------------------------------------------
# phase 5: kernel path == plain path, 2 layers of the 1B width in f32
# ---------------------------------------------------------------------------


def phase_engine_f32(seed: int = 0) -> dict:
    from distributed_inference_server_tpu_torch.engine.engine import (
        EngineConfig,
        LLMEngine,
        SamplingParams,
    )
    from distributed_inference_server_tpu_torch.models import llama
    from distributed_inference_server_tpu_torch.models.configs import (
        LLAMA_3_2_1B,
    )
    from distributed_inference_server_tpu_torch.models.tokenizer import (
        ByteTokenizer,
    )

    cfg = LLAMA_3_2_1B.with_overrides(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    tok = ByteTokenizer()
    prompts = ["f32 identity", "kernel path against plain path " * 3,
               "z" * 40]
    outs = {}
    for impl in ("kernel", "plain"):
        eng = LLMEngine(params, cfg, tok, EngineConfig(attention_impl=impl),
                        dtype=torch.float32, device="cuda")
        for i, p in enumerate(prompts):
            eng.add_request(f"r{i}", tok.encode(p),
                            SamplingParams(max_tokens=16, temperature=0.0))
        toks = {}
        while eng.has_work():
            for o in eng.step():
                if o.token_id is not None:
                    toks.setdefault(o.request_id, []).append(o.token_id)
        outs[impl] = toks
        del eng
    assert outs["kernel"] == outs["plain"], outs
    log(json.dumps({"engine_f32_2layer": "kernel == plain greedy tokens",
                    "tokens": outs["kernel"]}))
    return outs


# ---------------------------------------------------------------------------


KERNEL_META = {
    "paged_decode": ("cuda", "distributed_inference_server_tpu_torch/csrc/"
                     "paged_attention.cu",
                     "distributed_inference_server_tpu/ops/pallas/"
                     "paged_attention.py:546"),
    "paged_prefill": ("cuda", "distributed_inference_server_tpu_torch/csrc/"
                      "paged_attention.cu",
                      "distributed_inference_server_tpu/ops/pallas/"
                      "paged_attention.py:406"),
    "rms_norm": ("triton", "distributed_inference_server_tpu_torch/ops/"
                 "kernels/_triton_fused.py",
                 "distributed_inference_server_tpu/ops/pallas/fused.py:90"),
    "rope": ("triton", "distributed_inference_server_tpu_torch/ops/kernels/"
             "_triton_fused.py",
             "distributed_inference_server_tpu/ops/pallas/fused.py:132"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,serve,engine")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    card = card_line()
    log(card)
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke needs one card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from distributed_inference_server_tpu_torch.ops import kernels
    from distributed_inference_server_tpu_torch.ops.kernels import _build

    t0 = time.monotonic()
    built = _build.build_all(verbose=True)
    log(f"[build] {sorted(built)} in {time.monotonic() - t0:.1f} s")

    checks = phase_kernels() if "kernels" in phases else {}
    launches = phase_serve(card, args.seed) if "serve" in phases else {}
    if "engine" in phases:
        phase_engine_f32(args.seed)

    rows = []
    for name, (route, source, replaces) in KERNEL_META.items():
        rec = (checks.get(name) or [{}])[0]
        rows.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": launches.get(name),
            "max_abs_err": max((r["max_abs_err"] for r in checks.get(name, [])),
                               default=None),
            "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"), "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms"),
        })
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
