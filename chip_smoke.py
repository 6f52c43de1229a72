"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``/usr/local/cuda``) and ``triton``; it imports
nothing of JAX. Phases, each of which must pass (any failure exits 1):

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA source of the port (one ``nvcc`` per source, all
   started together, ``-Xptxas -v`` printed; ``graph_loop.cu`` is the
   looped block's WHILE graph, not a kernel), then prints the decode
   bodies' report (registers, shared memory, spills: ``decode_body``
   lines) and the decode split plan at the served shape (B = 8, KV 8,
   128 pages of 16 tokens: splits, tokens per split, blocks, blocks per
   SM; ``decode_plan`` lines), and the same for the prefill / ragged body
   (``attend_body``, ``attend_plan``: prefill [4, 512] and ragged S = 512,
   Bm 12, at D 64 and D 128);
3. holds each hand-written kernel (paged decode at D = 64 and D = 128,
   paged prefill and the ragged mixed batch at D = 64 and D = 128, deep
   histories and splits among their cases, RMSNorm, RoPE) against its
   plain PyTorch version on the card at the serving shapes of
   llama-3.2-1b, in bf16, and times kernel, plain version, one PyTorch
   library call where there is one, and the bytes/operations bound;
   then the quantized kernels the same
   way: the group-dequant matmul's int8 body at the seven products of a
   llama-3-8b layer and its int4 body at llama-3.2-1b's, each at M = 8
   (decode), M = 512 (one 512-bucket chunk) and M = 2048 (a [4, 512]
   prefill chunk), plus odd M, K of one group, K off the 64-row tile and
   N off the tiles; and the int8-pool paged decode at D = 128 and D = 64,
   plus window 64 + softcap 30;
4. starts ``python -m distributed_inference_server_tpu_torch`` serving
   llama-3.2-1b (full width and depth, random weights from a seed; the
   server's warmup runs every serving program and captures every CUDA
   graph before it reports ready), sends the mix's greedy prompts one at
   a time (their texts are kept for phase 6), then concurrent ``POST
   /generate`` requests; the kernels' launch counts are zeroed just
   before and read just after, from ``/server/stats``, and every kernel
   of that path must have launched. Then the same with
   ``--engine-loop-to-completion true`` (each looped block one WHILE-graph
   launch; its greedy texts must equal the first server's), and in
   process the device ms per decode step of looped and K-step blocks at
   full depth, read with CUDA events around each launch (the profiler
   does not see kernels inside a WHILE node's body). Then a server
   with ``--engine-mixed-step-tokens 512`` (each mixed step one graph
   replay): two chats, and while they decode a ~1500-byte and a 600-byte
   prompt, so the ragged mixed step runs; its counts are read the same
   way; then the same in the K-block form (``--engine-loop-to-completion
   true --engine-loop-max-steps 8``). Then the quantized servers with the
   first one's request mix: llama-3-8b (32 layers, 4096 wide) with
   ``--model-quantization int8 --engine-kv-quant int8``, and
   llama-3.2-1b with ``--model-quantization int4``; and llama-3-8b int8 +
   int8 KV with ``--engine-mixed-step-tokens 512`` (the mixed step over
   int8 pools) on the mixed server's traffic. For each server one
   ``server_timing`` line: the warmup's seconds, the mix's and a lone
   request's walls, the mean decode-step, prefill-chunk, mixed-step and
   looped-block ms of the engine's step clock over the mix (and ms per
   looped iteration), looped-block traffic, device memory (peak, graph
   pool) and the device busy share over 12 engine steps of the mix run
   again and again (``POST /server/profile``, ``torch.profiler``);
5. runs the engine at 2 layers of the 1B width in f32 with the kernels and
   with the plain versions and requires identical greedy tokens; then the
   mixed step (kernels, plain versions) and the quantum path on one trace
   (chats mid-decode, then a ~400-token prompt), tokens identical; then
   int8 weights over int8 KV, and int4 weights, kernels against plain
   versions, tokens identical; then the quantum path's CUDA graphs
   against its eager path (dense, and int8 weights over int8 KV; at
   pipeline depths 0 and 1): identical greedy tokens and kernel launches;
   then looped blocks (WHILE graphs) against the eager loop and the fixed
   path, and the mixed step's graphs against eager (K = 1 and the K-block
   form; dense, and int8 + int8 KV, whose kernel path must give the plain
   path's tokens): identical greedy tokens and launches;
6. (``ckpt``) writes the bf16 llama-3.2-1b weights of the seed with the
   port's ``save_checkpoint`` (bytes, save and load seconds printed),
   checks that ``load_checkpoint`` gives them back, serves them with
   ``--model-model-dir`` and requires phase 4's greedy texts;
7. (``families``) the model families. Phase 3's rows at their shapes:
   decode (bf16 and int8 pools), prefill [4, 512] and ragged S = 512 at
   gemma2-9b's (H 16, KV 8, D 256, softcap 50, a 4096-token window) and
   qwen2-7b's (H 28, KV 4: G 7, D 128), RMSNorm at [4, 512, 3584] and
   RoPE at D 256, each against its plain version and timed beside it,
   SDPA on the gathered window (without the softcap, which SDPA lacks:
   ``sdpa_nocap_ms``) and the bound. Phase 4's servers at full width and
   depth, random weights from the seed, the first mix and a lone
   request: gemma2-9b, qwen2-7b and mistral-7b in bf16, mixtral-8x7b with
   ``--model-quantization int8``; each prints a ``server_timing`` line
   whose ``launches_per_forward`` must show one paged decode a layer per
   decode step, one paged prefill a layer per chunk and, for Mixtral,
   32 x (4 + 8 x 3) = 896 ``quant_matmul_q8`` a forward. Phase 5 in
   process, 2 layers at each family's width: kernels against plain
   versions in f32 and graphs against eager in bf16, identical greedy
   tokens (and launches), for the quantum path, the mixed step and looped
   blocks (Mixtral with int8 experts); then mistral-7b's width with its
   4096-token window and a ~4400-token prompt: ``reclaim`` events > 0,
   ``audit_pages()`` clean after every step, kernel tokens == plain.

8. (``api``) the API surface, on the checkpoint server of item 6 (its
   directory also holds a ``tokenizer_config.json`` with this script's
   Llama-3-style Jinja ``chat_template``): the first mix's greedy prompts
   streamed over SSE (``/generate`` with ``"stream": true``: every frame a
   ``TokenEvent`` dict, in more than one read, the deltas joined == the
   non-streamed texts, the tokens' log-probabilities == those of
   ``/v1/completions`` with ``logprobs`` 0), then the four-request mix
   streamed (each greedy stream's text and log-probabilities == its lone
   run's); ``/chat`` and ``/v1/chat/completions``, streamed and not, ==
   each other and == the in-process engine on the template's rendering
   (the script renders it with jinja2); ``/v1/completions`` with ``n`` 2,
   ``logprobs`` 0, a stop string and ``include_usage`` (its OpenAI shape
   and usage); ``/embeddings`` and ``/v1/embeddings`` on 8 inputs of up
   to 512 tokens and one past the largest bucket (unit norm, equal across
   the two calls, == the in-process plain path within 1e-3 an element
   and a cosine of 0.9999 an input, RMSNorm and RoPE launches rising),
   and a greedy ``/v1/completions`` sent while a 64-input job runs gives
   its solo run's text and log-probabilities exactly; a
   client that closes its stream after three frames leaves no request in
   flight and the live and allocatable page counts as before; ``/metrics``
   parsed: ``request_latency_seconds_count`` per path == the POSTs sent,
   ``time_to_first_token_seconds_count`` == the generation sequences. The
   paged prefill, paged decode, RMSNorm and RoPE kernels must launch on
   the streamed routes (counts zeroed just before them, read just after).
   One ``api_timing`` line: client TTFT (first token-bearing frame) alone
   and under the mix, frame gaps, tokens per burst, the server's own TTFT
   over the same requests, embeddings latency and the ``/metrics``
   scrape's bytes and ms.

9. (``spec``) speculative decoding. Phase 3 adds the chunked-prefill
   kernel at the verify forward's shape (B 8, T = gamma + 1 = 5, D 64 and
   D 128, q_start {0, 15, 16, 17, 300, 1000, 2043, 2045}: the last row's
   last two queries lie past the 2048-token capacity, kv_valid clamped to
   it), against its plain version, timed beside it and SDPA, and (with
   ``quant``) ``quant_matmul_q8`` on one llama-3-8b layer's seven products
   at the verify forward's M = max_batch * (gamma + 1) = 40 rows, which
   take its prefill body. Phase 5 adds 2 layers of the 1B width in f32
   with a draft of the same weights and of another seed: speculative
   greedy tokens == plain ones on the fixed path (graphs, eager, plain
   versions), in looped blocks (WHILE graph, eager) and in the mixed step
   under the loop; graph launches == eager launches; and with int8 weights
   over int8 KV (the 8B spec server's pairing; a dense draft of another
   seed, and the quantized target as its own draft, each over an int8
   draft pool), speculative tokens on the kernels == on the plain
   versions == plain decoding, the kernel runs launching
   ``quant_matmul_q8`` and ``paged_decode_int8``. Served: item 6's
   checkpoint as target AND draft
   (``--model-draft-model-dir``), the first mix; then llama-3-8b with int8
   weights and int8 KV and a random llama-3.2-1b draft
   (``--model-draft-model-name``; the draft pool int8), the first mix.
   Each prints a ``spec_timing`` line (acceptance and tokens per round
   over the mix, the trackers, the spec block's step-clock ms, launches,
   and for the 1B one each greedy text's first character that differs
   from the plain checkpoint server's); speculation must have run, and
   ``POST /admin/speculation`` must reset one engine;
10. (``admission``) on item 6's running server: the admission queue's
   tier must be native, lone streamed TTFT at the reference's 50 ms
   batching window, a burst of 24 requests of mixed priorities all 200;
   then a server with ``--batcher-window-ms 0`` for the lone TTFT without
   the window, and one with ``--queue-tenant-fairness true``, which takes
   the Python queue and batcher tier, for the lone TTFT and the burst on
   that tier (``admission_timing`` line);
11. (``kvpaths``) the KV byte paths on llama-3.2-1b bf16 (``phase_kvpaths``):
   raw and streamed handoffs between two engines token-identical to plain
   decoding, the int8 and latent wires' agreement and bytes, a peer
   prefix fetch equal to a warm hit, three 1B servers with a host tier
   (``none`` / ``int8`` / ``latent``) reloading an evicted prompt (the
   ``none`` tier's text == a warm HBM hit), the native allocator tier at
   the defaults and its tokens == the Python tier's, and two latent
   codecs calibrated bit-identically (``kvpaths_timing`` line: payload
   bytes per kind, export / import ms per MB, the streamed stall,
   host-tier reload ms per page, PCIe rates).
12. (``replicas``) several llama-3.2-1b bf16 replicas in one server
   process on the card (``phase_replicas``): (a) two unified replicas,
   round robin: the first mix's greedy texts == phase 4's one-engine
   texts (or a one-engine server's started beside it), each replica
   served, launches per forward on each replica == one engine's, then
   ``POST /admin/scale`` 2 -> 3 -> 2 with a request in flight on the
   retired replica (its text unchanged, the process's allocated bytes
   back within 5 %); (b) a prefill/decode pair (streamed handoff): the
   same texts, every decoded request handed off and finished on the
   decode replica, both page audits clean; again with ``--disagg-stream
   false`` and with ``--disagg-channel protowire``; (c) a crash
   (``--faults-spec runner.step:nth=3``): a streamed request with tokens
   ends ``engine_crashed``, a zero-token one reruns on the other replica
   with (a)'s text, the health loop restarts the dead replica (one
   restart), which serves (a)'s text with one engine's launches per
   forward, allocated bytes back within 5 %; (d) ``cache_aware`` with
   ``sched.fetch_decision`` armed: the p600 prompt's cached pages are
   fetched to the cold replica, which prefills the tail, its text == the
   warm hit's, ``kv_prefix_fetch_total{outcome="ok"}`` 1
   (``replicas_timing`` line: warmups, walls, a cold 600-byte prompt's
   lone TTFT unified and disaggregated, handoff ms per request and
   bytes, crash to healthy seconds, memory, launches by role).
13. (``control``) configuration, control and observability
   (``phase_control``): (a) a llama-3.2-1b bf16 server started from a
   TOML file with one ``DIS_TPU_*`` env override and one CLI override, at
   the JAX schema's engine defaults (2048 pages, ``max_batch`` 64):
   ``/server/stats`` shows the precedence and the pool, the mix is
   served with one engine's launches per forward, its greedy texts are
   compared with phase 4's (reported, not required: a wider batch may
   round differently in bf16) and a 40,000-byte prompt is a 400; (b) the
   file rewritten (``batcher.window_ms`` 0, ``server.strategy``
   round_robin, and the non-hot ``queue.max_queue_size``): within 3 s the
   hot keys apply and the other does not; the lone TTFT before and after;
   (c) the mix's spans with their parent links, a timeline per request
   whose phases sum to no more than the client's wall, ``/server/perf``
   TTFT / TBT windows and SLO verdicts counted once per request, the new
   ``/metrics`` families, the script's own OTLP collector receiving the
   spans, and a second server with a 1 ms ``admission.deadline_ms``
   shedding with 503 ``admission_shed`` once its estimator is warm; (d) in
   process, a server with a resolver over {llama-3.2-1b bf16, llama-3.2-1b
   int4 with a zero final norm, a factory that raises}: the degradation
   ladder stepped through
   0.75 / 0.85 / 0.92 / 0.97 / 0.5 (batcher divisor, cached pages evicted
   to the target, 503 for low priority then for all, gates lifted), a
   swap to int4 while a streamed request runs (that request finishes with
   its pre-swap tokens; new requests launch the q4 matmul and give the new
   model's tokens: the int4 model's final norm is zero, so every logit is
   0 and its logprobs tell it apart; random weights emit ids past the byte
   range, so the streams' (text, logprob) pairs are compared), the broken
   swap
   keeping the model, the swap back giving the cold pre-swap tokens, and
   allocated bytes back within 1 % (``control_timing`` line). Every
   earlier phase's servers read ``build/chip_smoke_engine.toml``, which
   keeps the engine settings they ran before the port read the JAX
   config (``max_batch`` 8, 1024 pages, 128 a sequence).

14. (``parallel``) multi-device parallelism over meshes whose slots all
   name the one card (each shard its own weights, pool and launches; the
   collectives local copies): (a) phase 3's decode, prefill, int8-pool
   decode and q8 layer at the per-shard shapes of llama-3-8b under tensor
   2 (H 16, KV 4) and tensor 8 (H 4, KV 1); 2-layer engines at the 8B
   width in f32 on tensor 1, 2, 4 and 8, each with the kernels and with the
   plain versions (greedy tokens all equal; ``paged_decode``,
   ``paged_prefill`` and ``rope`` launched tp times the unsharded
   engine's, ``rms_norm`` as often), a looped block and the mixed step
   at tensor 2, and int8 weights + int8 KV at tensor 2 (the q8 bodies and
   the int8-pool decode at the shard shapes); (b) llama-3-8b int8 + int8
   KV at full depth served in process (``InferenceServer``) on tensor 2
   at ``build/chip_smoke_engine.toml``'s settings: the first mix, its
   texts against phase 4's 8B int8 server's (the first divergence
   reported, not required: bf16 partial sums add in another order),
   launches per forward, graphs, and a ``parallel_timing`` line; (c)
   stage 2 in 2 microbatches at 2 layers of the 1B width, seq 2 (ring and
   Ulysses) on a prompt past ``cp_min_tokens`` decoding from the pages
   the sequence-parallel pass wrote, and expert 2 on 2 layers of the
   mixtral-8x7b width with int8 experts, each with the unsharded engine's
   greedy tokens in f32; (d) ``--engine-tensor-parallel 2`` at the entry
   point: with one card it exits 2 with the device-count error (the line
   says the multi-card path did not run); with two or more it serves the
   first mix over two cards.
15. (``fleet``) the fleet's control plane across two entry-point
   processes on the card (``phase_fleet``), llama-3.2-1b bf16 at
   ``build/chip_smoke_engine.toml``'s settings and ``--batcher-window-ms
   0``, started at once: a registry host (one engine, ``--fleet-enabled
   true --server-strategy round_robin``) and a member (``--fleet-connect``
   to it). The member joins (start to ``alive`` seconds); the first mix's
   greedy prompts go once to each engine (round robin alternates them),
   the member's (text, sampled logprob) pairs equal the host engine's and
   the host launches nothing for the member's, which runs one engine's
   launches per forward on ``cuda``; lone streamed TTFT host engine
   against member (the fleet wire's share); a remote request's
   ``trace_id`` holds the host's root span and the member's
   ``fleet.serve`` and ``engine.infer`` spans, parent-linked; the member
   stopped (``SIGSTOP``) with a zero-token request in flight and then
   killed (``SIGKILL``): the request completes once, redispatched to the
   host's engine, with the member's cold pairs for its prompt, the member
   reads ``dead`` (kill to dead and to completed seconds); the member
   restarted under its id rejoins (one ``rejoin`` heartbeat) and serves
   the cold pairs again (``fleet_timing`` line). The role balancer has
   nothing on the device and is covered by the CPU tests.

Phase 4's four 1B servers start together, and so do phase 3's three
quantized servers (``_prestart``): only their startups overlap, each
server is measured alone while the others idle (``warmup_s`` is read
under that shared startup).

Each phase's first server (phase 4's 1B quantum server, the first
quantized server, the first family server, the first speculative server)
traces the card for its ``busy_share``; the servers after it in the same
phase print ``null`` there (one trace a phase keeps the script inside its
time limit; each trace took about 13 s).

It also prints whether ``safetensors`` and ``tokenizers`` import (for
information: the port reads safetensors itself).

Before the last line it prints one JSON object ``{"kernels": [...]}`` (the
quantized matmuls' rows add ``*_prefill`` keys: their M = 2048 layer, and
q8 ``*_verify`` keys: its M = 40 layer); the
last line is ``{"ok": true, "device": {...}}``. Without a card it exits 2
and prints no result. ``--phases
kernels,serve,quant,engine,ckpt,api,families,spec,admission,kvpaths,replicas,control,parallel,fleet``
selects
phases (default: all; ``quant`` is phase 3's quantized kernels and phase
4's quantized servers; ``families`` is item 7, ``api`` item 8, ``spec``
item 9 and ``admission`` item 10, which write and serve item 6's
checkpoint themselves when ``ckpt`` is not selected). ``--server-flags
'...'`` adds flags to every server the script starts (an A/B of one
server option within one tree, e.g. ``--batcher-window-ms 0`` with
``--phases serve``). The summary rows
carry the families' times under ``families``, each family server's
launches under ``launches_by_model``, the api phase's under
``launches_api``, the spec servers' under ``launches_spec (model)``, each
KV byte path's (phase 11's handoff decode, peer-prefix serve and each
host-tier server's repeat) under ``launches_kvpaths``, phase 12's by
replica role (``unified``, ``prefill``, ``decode``, ``fetch_target``)
under ``launches_replicas``, phase 13's (the defaults server's mix and
the int4 engine's requests after the swap) under ``launches_control``,
the verify shape's times under ``verify``, phase 14's per-shard shapes
under ``tp_shards``, phase 14's launches under ``launches_parallel`` and
phase 15's (the member's, over the remote-served greedy prompts) under
``launches_fleet``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import contextlib
import gc
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import http.client
import urllib.error
import urllib.parse
import urllib.request

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}  # dense, per the card's data sheet

# tolerance of every kernel-vs-plain comparison in bf16: |a - b| <=
# ATOL + RTOL * |b| (about two bf16 ulps; both versions accumulate in f32
# and differ only in summation order and the final rounding)
ATOL, RTOL = 1e-2, 2.0 ** -7
# the served embeddings against the plain path: unit vectors 2048 wide
# (a typical element 1/sqrt(2048) = 0.022), held per element to
# EMB_ATOL (about 0.05/sqrt(H)) and per input to a cosine of EMB_MIN_COS
EMB_ATOL, EMB_MIN_COS = 1e-3, 0.9999


T0 = time.monotonic()


def log(*a) -> None:
    print(*a, flush=True)


def phase_done(name: str) -> None:
    log(f"[phase] {name} done at {time.monotonic() - T0:.1f} s")


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


def _library(rec, softcap, fn) -> None:
    """SDPA's time as the library yardstick; SDPA has no softcap, so with
    one it computes another function: then ``library_ms`` is None and the
    time is kept as ``sdpa_nocap_ms`` (the same attention without it)."""
    ms = time_ms(fn)
    rec["library_ms"] = ms if softcap == 0.0 else None
    if softcap:
        rec["sdpa_nocap_ms"] = ms


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
    _library(rec, softcap, lambda: _sdpa(q4, kg, vg, mask))
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
    _library(rec, softcap, lambda: _sdpa(qt, kg, vg, mask))
    rec.update(bound(nbytes, ops, dt))
    return rec


def _ragged_inputs(decode_valid, chunks, Bm, S, H, KV, D, page_size, P,
                   num_pages, gen):
    """The mixed step's packed layout: decode slots first (valid 0 = an
    inactive slot, -1 in tok_row), then prefill chunks (length, q_start)
    back to back, then padding up to S. Returns tensors on the card and
    the host lists."""
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
    assert len(tok_row) <= S and len(valid) == Bm
    tok_row += [-1] * (S - len(tok_row))
    q_pos += [0] * (S - len(q_pos))
    i32 = dict(dtype=torch.int32, device="cuda")
    pool_k, pool_v, tables = _pool_case(Bm, H, KV, D, page_size, P,
                                        num_pages, torch.bfloat16, gen)
    q = torch.randn(S, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    return (q, pool_k, pool_v, tables, torch.tensor(tok_row, **i32),
            torch.tensor(q_pos, **i32), torch.tensor(valid, **i32),
            tok_row, q_pos, valid)


def _ragged_work(tok_row, q_pos, valid, window, TQ):
    """(visible keys summed over tokens, K/V tokens each row must read
    once, K/V tokens the kernel's segment loops read): what this data
    needs. A segment is a run of one row's tokens inside a TQ-wide window
    of the packed axis (csrc/paged_attention.cu)."""
    pairs, rows, segs, cur = 0, {}, {}, None
    for i, r in enumerate(tok_row):
        if r < 0:
            continue
        if i % TQ == 0 or tok_row[i - 1] != r:
            cur = i
        p = q_pos[i]
        lo = max(p - window + 1, 0) if window > 0 else 0
        hi = min(p + 1, valid[r])
        pairs += max(0, hi - lo)
        for book, key in ((rows, r), (segs, cur)):
            old = book.get(key, (lo, hi))
            book[key] = (min(old[0], lo), max(old[1], hi))
    def span(book):
        return sum(max(0, hi - lo) for lo, hi in book.values())

    return pairs, span(rows), span(segs)


def check_ragged(case, decode_valid, chunks, Bm=12, S=512, window=0,
                 softcap=0.0, H=32, KV=8, D=64, page_size=16, P=128,
                 num_pages=1024, time_it=True):
    from distributed_inference_server_tpu_torch.ops.kernels import (
        paged_attention as pa,
    )

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5000 + S + len(case))
    (q, pool_k, pool_v, tables, tok_row, q_pos, valid, rows_l, pos_l,
     valid_l) = _ragged_inputs(decode_valid, chunks, Bm, S, H, KV, D,
                               page_size, P, num_pages, gen)
    kw = dict(page_size=page_size, sliding_window=window,
              attn_softcap=softcap)
    args = (q, pool_k, pool_v, tables, tok_row, q_pos, valid)
    got = pa.paged_ragged(*args, **kw)
    want = pa.paged_ragged_plain(*args, **kw)
    torch.cuda.synchronize()
    err = compare(f"paged_ragged[{case}]", got, want)
    if got[tok_row < 0].any():
        raise AssertionError(f"paged_ragged[{case}]: padding not zero")
    rec = {"case": case, "max_abs_err": err}
    if not time_it:
        return rec
    e = q.element_size()
    pairs, row_tokens, seg_tokens = _ragged_work(
        rows_l, pos_l, valid_l, window, pa.attend_tq(H, KV))
    small = (tables.numel() + 2 * S + Bm) * 4
    nbytes = 2 * q.numel() * e + 2 * row_tokens * KV * D * e + small
    rec["ms"] = time_ms(lambda: pa.paged_ragged(*args, **kw))
    rec["plain_ms"] = time_ms(lambda: pa.paged_ragged_plain(*args, **kw),
                              iters=5)
    # library: one SDPA call over every row's visible window concatenated
    # on the key axis, with a packed boolean mask (gather excluded)
    kg, vg = _gathered(pool_k, tables, page_size), _gathered(pool_v, tables,
                                                            page_size)
    keep = [(b, n) for b, n in enumerate(valid_l) if n > 0]
    k_cat = torch.cat([kg[b, :, :n] for b, n in keep], dim=1)[None]
    v_cat = torch.cat([vg[b, :, :n] for b, n in keep], dim=1)[None]
    key_row = torch.cat([torch.full((n,), b, device="cuda")
                         for b, n in keep])
    key_pos = torch.cat([torch.arange(n, device="cuda") for _, n in keep])
    mask = (key_row[None, :] == tok_row[:, None].long()) & (
        key_pos[None, :] <= q_pos[:, None].long())
    if window > 0:
        mask &= key_pos[None, :] > q_pos[:, None].long() - window
    qt = q.transpose(0, 1)[None].contiguous()
    _library(rec, softcap, lambda: _sdpa(qt, k_cat, v_cat, mask[None, None]))
    rec.update(bound(nbytes, 4 * pairs * H * D, dt))
    # what the segment loops read (a prefill row's history once per
    # segment), beside the read-once bound
    rec["segment_bytes_bound_ms"] = (
        (2 * q.numel() * e + 2 * seg_tokens * KV * D * e + small)
        / HBM_BYTES_PER_S * 1e3)
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


def check_rope(case, shape, pos_start, time_it=True, model="llama-3.2-1b"):
    from distributed_inference_server_tpu_torch.models.configs import (
        get_config,
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
    C = get_config(model)
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


def ptxas_entries(report: str, needle: str) -> dict:
    """{kernel: its -Xptxas -v lines} for the entry functions of a build
    report whose (mangled) name contains ``needle``."""
    out, cur = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if needle in name else None
            if cur:
                out[cur] = []
        elif cur and ("Function properties" not in line):
            out[cur].append(line.split(":", 1)[-1].strip())
    return out


def decode_report() -> None:
    """The decode bodies' compiler report (registers, shared memory,
    spills) and the split plan at the served shapes (B = 8, KV 8, a table
    of 128 pages of 16 tokens)."""
    from distributed_inference_server_tpu_torch.ops.kernels import (
        _build,
    )
    from distributed_inference_server_tpu_torch.ops.kernels import (
        paged_attention as pa,
    )

    for name, lines in ptxas_entries(_build.reports.get("paged_attention",
                                                        ""),
                                     "decode_attend").items():
        log(json.dumps({"decode_body": name, "ptxas": lines}))
    sms = pa._num_sms(0)
    for D, int8 in ((64, False), (128, False), (64, True), (128, True)):
        per_sm = pa._decode_per_sm(0, D, int8)
        splits, chunk = pa.decode_plan(8, 8, 128 * 16, 16, sms, per_sm)
        log(json.dumps({"decode_plan": {
            "D": D, "pools": "int8" if int8 else "bf16", "B": 8, "KV": 8,
            "capacity": 2048, "splits": splits, "tokens_per_split": chunk,
            "blocks": 8 * 8 * splits, "blocks_per_sm": per_sm, "sms": sms}}))


def attend_report() -> None:
    """The prefill / ragged body's compiler report (registers, shared
    memory, spills) and its split plan at the served shapes: prefill
    [4, 512] and the ragged S = 512 over Bm = 12 rows, H 32, KV 8, tables
    of 128 pages of 16 tokens, at D 64 and D 128."""
    from distributed_inference_server_tpu_torch.ops.kernels import (
        _build,
    )
    from distributed_inference_server_tpu_torch.ops.kernels import (
        paged_attention as pa,
    )

    for name, lines in ptxas_entries(_build.reports.get("paged_attention",
                                                        ""),
                                     "attend_").items():
        if "decode" not in name:
            log(json.dumps({"attend_body": name, "ptxas": lines}))
    sms = pa._num_sms(0)
    for D in (64, 128):
        for kind, T, B in (("prefill", 512, 4), ("ragged", 512, 12)):
            ragged = kind == "ragged"
            per_sm = pa._attend_per_sm(0, D, ragged)
            splits, chunk = pa.attend_plan(32, 8, T, B, 128 * 16, 16, sms,
                                           per_sm, ragged)
            tiles = pa.attend_tiles(32, 8, T, B, ragged)
            log(json.dumps({"attend_plan": {
                "kernel": kind, "D": D, "T_or_S": T, "B": B, "KV": 8,
                "TQ": pa.attend_tq(32, 8), "capacity": 2048,
                "splits": splits, "tokens_per_split": chunk,
                "blocks": tiles * 8 * splits, "blocks_per_sm": per_sm,
                "sms": sms}}))


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
            check_decode("D128", lengths, D=128, time_it=time_it),
        ],
        "paged_ragged": [
            # the mixed step at 512 packed tokens: decode slots 0-7 (slot
            # 0 inactive), chunks of 200 @ 0, 250 @ 1500, 54 @ 100, and an
            # empty fourth prefill row
            check_ragged("S512 8 decode + 3 chunks",
                         [0, 1, 16, 17, 300, 1000, 2047, 2048],
                         [(200, 0), (250, 1500), (54, 100)],
                         time_it=time_it),
            check_ragged("S100 window64 softcap30", [0, 17, 300, 2048],
                         [(40, 0), (33, 900)], Bm=7, S=100, window=64,
                         softcap=30.0, time_it=False),
            check_ragged("D128 S200", [5, 0, 1000, 33], [(100, 50), (60, 0)],
                         Bm=7, S=200, D=128, time_it=False),
            check_ragged("D128 S512 8 decode + 3 chunks",
                         [0, 1, 16, 17, 300, 1000, 2047, 2048],
                         [(200, 0), (250, 1500), (54, 100)], D=128,
                         time_it=time_it),
            check_ragged("S400 deep chunk to the table's end", [2048],
                         [(300, 1748), (33, 0)], Bm=3, S=400,
                         time_it=False),
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
            check_prefill("D128 B4 T512 q_start>0", 512, [0, 100, 1500, 0],
                          [512, 400, 1537, 0], D=128, time_it=time_it),
            check_prefill("B1 T64 q_start 1900 (split)", 64, [1900], [1964],
                          time_it=False),
            check_prefill("B4 T77 window300 softcap30", 77,
                          [0, 100, 1500, 0], [77, 150, 1577, 0], window=300,
                          softcap=30.0, time_it=False),
            *verify_cases(time_it),
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


# the model families' attention shapes: (H, KV, D, window, softcap) of
# gemma2-9b (every layer soft-capped at 50; the local layers' 4096-token
# window) and qwen2-7b (G 7, full causal)
FAMILY_ATTN = {"gemma2-9b": (16, 8, 256, 4096, 50.0),
               "qwen2-7b": (28, 4, 128, 0, 0.0)}


def phase_family_kernels(time_it=True) -> dict:
    """The kernels at the model families' shapes, each against its plain
    version and timed beside it, SDPA on the gathered window and the
    bound: decode (B 8 rows up to 2048 keys), prefill ([4, 512] over
    histories up to 1537) and the ragged mixed step (S 512) at gemma2-9b's
    and qwen2-7b's attention shapes, with a sentinel-free table (the
    sentinel cases are the ``gpu`` tests'); RMSNorm at H 3584 and RoPE at
    D 256; the int8-pool decode at gemma2-9b's shape. Cases are named by
    model."""
    lengths = [1, 15, 16, 17, 300, 1000, 2047, 2048]
    out = {"paged_decode": [], "paged_prefill": [], "paged_ragged": []}
    for model, (H, KV, D, window, softcap) in FAMILY_ATTN.items():
        kw = dict(H=H, KV=KV, D=D, window=window, softcap=softcap,
                  time_it=time_it)
        out["paged_decode"].append(check_decode(
            f"{model} B8 decode", lengths, **kw))
        out["paged_prefill"].append(check_prefill(
            f"{model} B4 T512 q_start>0", 512, [0, 100, 1500, 0],
            [512, 400, 1537, 0], **kw))
        out["paged_ragged"].append(check_ragged(
            f"{model} S512 8 decode + 3 chunks",
            [0, 1, 16, 17, 300, 1000, 2047, 2048],
            [(200, 0), (250, 1500), (54, 100)], **kw))
    H, KV, D, window, softcap = FAMILY_ATTN["gemma2-9b"]
    out["paged_decode_int8"] = [check_decode_int8(
        "gemma2-9b B8 decode", lengths, window=window, softcap=softcap, H=H,
        KV=KV, D=D, time_it=time_it)]
    out["rms_norm"] = [check_rms_norm("gemma2-9b prefill chunk [4,512,3584]",
                                      (4, 512, 3584), time_it=time_it)]
    out["rope"] = [check_rope("gemma2-9b prefill q [4,512,16,256]",
                              (4, 512, 16, 256), [0, 100, 1500, 0],
                              time_it=time_it, model="gemma2-9b")]
    for name, recs in out.items():
        for r in recs:
            log(json.dumps({"kernel_check": name, **r}))
    return out


# the seven (K, N) of a layer's products: q, k, v, o, gate, up, down
LAYER_8B = [("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024),
            ("wo", 4096, 4096), ("w_gate", 4096, 14336),
            ("w_up", 4096, 14336), ("w_down", 14336, 4096)]
LAYER_1B = [("wq", 2048, 2048), ("wk", 2048, 512), ("wv", 2048, 512),
            ("wo", 2048, 2048), ("w_gate", 2048, 8192), ("w_up", 2048, 8192),
            ("w_down", 8192, 2048)]


def check_quant_matmul(case, M, K, N, packed, group=None, time_it=True):
    """One product x [M, K] @ dequant(w [K, N]): int8 codes with group 128
    or packed int4 with group 64 (the serving defaults) unless ``group``
    is given; weights 0.02 * N(0, 1) as init_params draws them."""
    from distributed_inference_server_tpu_torch.ops.kernels import (
        quant_matmul as qm,
    )
    from distributed_inference_server_tpu_torch.ops.quant import (
        dequantize,
        quantize_int4,
        quantize_int8,
    )

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(6000 + M + K + N)
    w = torch.randn(K, N, generator=gen, device="cuda") * 0.02
    w = (quantize_int4(w, group or 64) if packed
         else quantize_int8(w, group or 128))
    x = torch.randn(M, K, generator=gen, device="cuda").to(dt)
    fn = qm.quant_matmul_q4 if packed else qm.quant_matmul_q8
    got = fn(x, w)
    want = qm.quant_matmul_plain(x, w)
    torch.cuda.synchronize()
    name = "quant_matmul_q4" if packed else "quant_matmul_q8"
    rec = {"case": case, "max_abs_err": compare(f"{name}[{case}]", got, want)}
    if not time_it:
        return rec
    rec["ms"] = time_ms(lambda: fn(x, w))
    rec["plain_ms"] = time_ms(lambda: qm.quant_matmul_plain(x, w))
    w_dense = dequantize(w, dt)  # the library call's weight, built once
    rec["library_ms"] = time_ms(lambda: torch.matmul(x, w_dense))
    nbytes = (x.numel() * 2 + w.q.numel() + w.s.numel() * 4 + M * N * 2)
    rec.update(bound(nbytes, 2.0 * M * K * N, dt))
    return rec


def check_quant_layer(case, M, layer, packed):
    """The seven products of one layer at M rows, each checked and timed;
    returns their records and one record of their sums."""
    recs = [check_quant_matmul(f"{case} {name} [{M}x{K}]@[{K}x{N}]", M, K, N,
                               packed) for name, K, N in layer]
    total = {"case": f"{case}: the seven products of one layer at M={M}, "
                     "summed",
             "max_abs_err": max(r["max_abs_err"] for r in recs)}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_bound_ms"):
        total[key] = sum(r[key] for r in recs)
    kinds = {r["bound_by"] for r in recs}
    total["bound_by"] = kinds.pop() if len(kinds) == 1 else "operations"
    return [total] + recs


def check_decode_int8(case, valid_list, window=0, softcap=0.0, H=32, KV=8,
                      D=128, page_size=16, P=128, num_pages=1024,
                      time_it=True):
    """The int8-pool decode: pools drawn as N(0, 1) in bf16 and quantized
    with quantize_kv (codes int8, one f32 scale per slot and KV head)."""
    from distributed_inference_server_tpu_torch.ops.kernels import (
        paged_attention as pa,
    )
    from distributed_inference_server_tpu_torch.ops.quant import (
        QuantPool,
        dequantize_kv,
        quantize_kv,
    )

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(7000 + D + len(case))
    B = len(valid_list)
    pk, pv, tables = _pool_case(B, H, KV, D, page_size, P, num_pages, dt, gen)
    pool_k, pool_v = QuantPool(*quantize_kv(pk)), QuantPool(*quantize_kv(pv))
    del pk, pv
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dt)
    valid = torch.tensor(valid_list, dtype=torch.int32, device="cuda")
    kw = dict(page_size=page_size, sliding_window=window, attn_softcap=softcap)
    got = pa.paged_decode_int8(q, pool_k, pool_v, tables, valid, **kw)
    want = pa.paged_decode_int8_plain(q, pool_k, pool_v, tables, valid, **kw)
    torch.cuda.synchronize()
    rec = {"case": case,
           "max_abs_err": compare(f"paged_decode_int8[{case}]", got, want)}
    if not time_it:
        return rec
    e = q.element_size()
    seen = [min(v, window) if window > 0 else v for v in valid_list]
    pages = sum(-(-v // page_size) for v in valid_list)
    # codes of K and V (2 D bytes) and their two f32 scales per token and
    # KV head, q and out once, the table entries read
    nbytes = (2 * q.numel() * e + sum(seen) * KV * (2 * D + 8) + pages * 4
              + B * 4)
    ops = 4 * sum(seen) * H * D
    rec["ms"] = time_ms(lambda: pa.paged_decode_int8(q, pool_k, pool_v,
                                                     tables, valid, **kw))
    rec["plain_ms"] = time_ms(lambda: pa.paged_decode_int8_plain(
        q, pool_k, pool_v, tables, valid, **kw))
    # library: SDPA on the dequantized gathered window (gather and dequant
    # excluded), as for the bf16 decode
    kg = _gathered(dequantize_kv(pool_k.data, pool_k.scale, dt), tables,
                   page_size)
    vg = _gathered(dequantize_kv(pool_v.data, pool_v.scale, dt), tables,
                   page_size)
    kv_pos = torch.arange(kg.shape[2], device="cuda")
    mask = kv_pos[None, :] < valid[:, None]
    if window > 0:
        mask &= kv_pos[None, :] >= (valid[:, None] - window)
    q4 = q[:, :, None, :]
    _library(rec, softcap,
             lambda: _sdpa(q4, kg, vg, mask[:, None, None, :]))
    rec.update(bound(nbytes, ops, dt))
    return rec


def phase_quant_kernels() -> dict:
    """The quantized kernels against their plain versions; the first
    record of each kernel is its main-path shape (the served decode step
    of its model: one layer's seven products at M = 8, or the int8 decode
    over eight rows at llama-3-8b's D = 128)."""
    lengths = [1, 15, 16, 17, 300, 1000, 2047, 2048]
    out = {}
    for name, packed, layer, model in (
            ("quant_matmul_q8", False, LAYER_8B, "llama-3-8b int8"),
            ("quant_matmul_q4", True, LAYER_1B, "llama-3.2-1b int4")):
        # the speculative verify forward's products (q8 only: the 8B int8
        # spec server's target) take the prefill body at M = B * (gamma + 1)
        verify = (check_quant_layer(f"{model} verify", verify_rows(), layer,
                                    packed) if not packed else [])
        out[name] = (check_quant_layer(model, 8, layer, packed)
                     + check_quant_layer(model, 512, layer, packed)
                     + check_quant_layer(model, 2048, layer, packed)
                     + verify
                     + [check_quant_matmul(f"M={M} K={K} N={N} group={g}", M,
                                           K, N, packed, group=g,
                                           time_it=False)
                        for M, K, N, g in ((1, 4096, 1024, None),
                                           (5, 2048, 200, None),
                                           (3, 128, 8200, 128),
                                           (37, 512, 72, None),
                                           (129, 512, 136, 32),
                                           (16, 192, 8200, 32))])
        torch.cuda.empty_cache()
    out["paged_decode_int8"] = [
        check_decode_int8("B8 8B D128", lengths),
        check_decode_int8("B8 1B D64", lengths, D=64),
        check_decode_int8("D128 window64 softcap30", lengths, window=64,
                          softcap=30.0, time_it=False),
        check_decode_int8("D64 with valid=0", [0] + lengths[1:], D=64,
                          time_it=False),
    ]
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


# POSTs sent per (host:port, path): the api phase holds the server's
# request_latency_seconds counts against them
POSTS: "collections.Counter" = collections.Counter()


def _count_post(url: str) -> None:
    parts = urllib.parse.urlsplit(url)
    POSTS[(parts.netloc, parts.path)] += 1


def _http(method, url, body=None, timeout=600.0):
    if method == "POST":
        _count_post(url)
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:  # the server's error body, shown
        raise RuntimeError(f"{method} {url}: HTTP {e.code}: "
                           f"{e.read().decode(errors='replace')[:2000]}"
                           ) from None


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


# flags added to every server the script starts (``--server-flags``: an
# A/B of one server option within one tree)
SERVER_FLAGS: list = []

# the engine settings every server of phases 4-12 ran before the port read
# the JAX package's config (whose schema defaults are wider), kept so their
# records stay comparable; written by main()
ENGINE_TOML = os.path.join("build", "chip_smoke_engine.toml")
ENGINE_SETTINGS = """[engine]
max_batch = 8
num_pages = 1024
page_size = 16
max_pages_per_seq = 128
prefill_batch = 4
prefill_token_budget = 2048
"""


def write_engine_toml() -> None:
    os.makedirs(os.path.dirname(ENGINE_TOML), exist_ok=True)
    with open(ENGINE_TOML, "w") as f:
        f.write(ENGINE_SETTINGS)


def _launch(seed: int, extra, log_name: str, model: str,
            config: str = ENGINE_TOML, env=None):
    """Start ``python -m distributed_inference_server_tpu_torch`` serving
    ``model`` on a free port from the config file ``config`` (the flags
    override it): (process, base URL, its log file)."""
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "distributed_inference_server_tpu_torch",
           "--config", os.path.abspath(config),
           "--model-model-name", model, "--server-port", str(port),
           "--seed", str(seed), *extra, *SERVER_FLAGS]
    log("[serve] " + " ".join(cmd))
    os.makedirs("chiprun_out", exist_ok=True)
    errlog = open(os.path.join("chiprun_out", log_name), "w")
    proc = subprocess.Popen(cmd, stdout=errlog, stderr=subprocess.STDOUT,
                            env=None if env is None else {**os.environ,
                                                          **env})
    return proc, base, errlog


def _wait_healthy(proc, base: str, log_name: str, t0: float) -> None:
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"server exited with {proc.returncode} "
                               f"(chiprun_out/{log_name})")
        try:
            st, health = _http("GET", base + "/health", timeout=5)
            if st == 200 and health.get("status") == "ok":
                break
        except (urllib.error.URLError, ConnectionError, OSError,
                RuntimeError):
            pass
        if time.monotonic() - t0 > 400:
            raise RuntimeError("server did not become healthy in 400 s")
        time.sleep(1.0)
    log(f"[serve] {log_name} healthy after {time.monotonic() - t0:.1f} s")


@contextlib.contextmanager
def _servers(seed: int, specs):
    """Start one server per (extra flags, log name, model[, config file,
    env]) in ``specs``, all at once, and wait until each is healthy;
    yields their base URLs and stops every process on exit."""
    launched = []
    try:
        for extra, log_name, model, *more in specs:
            launched.append((*_launch(seed, extra, log_name, model, *more),
                             log_name))
        t0 = time.monotonic()
        for proc, base, _, log_name in launched:
            _wait_healthy(proc, base, log_name, t0)
        yield [base for _, base, _, _ in launched]
    finally:
        for proc, _, errlog, _ in launched:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            errlog.close()


# servers started ahead by ``_prestart``: log name -> (flags, model, base
# URL); ``_server`` hands such a server out instead of starting one
PRESTARTED: dict = {}


@contextlib.contextmanager
def _prestart(seed: int, specs):
    """Start the servers of ``specs`` ((extra flags, log name, model)) all
    at once and wait until each is healthy; the ``_server`` call of each
    (the same log name, flags and model) then gets its base URL. They are
    measured one after another, the others idle meanwhile: only their
    startups overlap."""
    with _servers(seed, specs) as bases:
        for (extra, log_name, model), base in zip(specs, bases):
            PRESTARTED[log_name] = (list(extra), model, base)
        try:
            yield
        finally:
            for _, log_name, _ in specs:
                PRESTARTED.pop(log_name, None)


@contextlib.contextmanager
def _server(seed: int, extra, log_name: str, model: str = "llama-3.2-1b"):
    """One server (``_servers``), or the one ``_prestart`` started under
    ``log_name``; yields its base URL."""
    pre = PRESTARTED.pop(log_name, None)
    if pre is not None:
        assert pre[:2] == (list(extra), model), (log_name, pre, extra)
        yield pre[2]
        return
    with _servers(seed, [(extra, log_name, model)]) as (base,):
        yield base


def _gen(base, prompt, params):
    t = time.monotonic()
    st, body = _http("POST", base + "/generate", {"prompt": prompt, **params})
    return st, body, time.monotonic() - t


def _reset_counts(base) -> dict:
    """Zero the launch counts; returns the stats just after."""
    _http("POST", base + "/server/kernel_counts/reset", {})
    _, stats = _http("GET", base + "/server/stats")
    assert all(v == 0 for v in stats["kernel_launches"].values()), stats
    return stats


def _clock_ms(before: dict, after: dict, kind: str, per: int = 1):
    """Mean host wall ms per dispatch of ``kind`` between two
    ``step_clock`` readings (divided by ``per``: the decode block's K
    steps), or None when none ran."""
    a, b = before["kinds"][kind], after["kinds"][kind]
    n = b["dispatches"] - a["dispatches"]
    return (b["wall_s"] - a["wall_s"]) * 1e3 / (n * per) if n else None


# the phases whose one device trace has been taken (_profiled)
_TRACED: set = set()
_UNTRACED = {"busy_share": None, "device_busy_s": None, "wall_s": None,
             "top_device_ms": [], "traced": "no: one trace a phase"}


def _profiled(base, run, steps: int = 12, phase: str = "") -> dict:
    """The device busy time and share of a trace of the card over
    ``steps`` engine steps (``POST /server/profile``) while ``run()`` (the
    server's request mix) runs again and again: the share under that
    mix's sustained load. A one-step trace first starts the profiler,
    whose first start is slow. Only the first server of each ``phase``
    is traced; the others get ``_UNTRACED``."""
    if phase in _TRACED:
        return dict(_UNTRACED)
    _TRACED.add(phase)
    prof = None
    for n in (1, steps):
        with cf.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(_http, "POST", base + "/server/profile",
                            {"steps": n, "timeout_s": 120}, 180.0)
            while not fut.done():
                run()
            st, prof = fut.result()
        assert st == 200, prof
    assert prof["device_events"] > 0, f"the trace saw no device work: {prof}"
    return prof


def _loop_delta(before: dict, after: dict):
    """Looped-block traffic between two ``/server/stats`` readings (None
    when the server runs no looped blocks)."""
    a, b = before.get("loop"), after.get("loop")
    if not a or not b:
        return None
    out = {k: b[k] - a[k] for k in ("blocks", "steps", "decode_tokens")}
    out["exits"] = {k: b["exits"][k] - a["exits"][k] for k in b["exits"]}
    return out


def _per_forward(before: dict, after: dict):
    """Kernel launches per model forward between two ``/server/stats``
    readings of a quantum-path server (None when mixed steps or looped
    blocks ran): the paged decode per decode step, the chunked prefill per
    prefill chunk, every other kernel per forward (a decode step or a
    prefill chunk, which launch it alike). Graph replays count the
    launches their capture recorded: K decode steps a block."""
    K = 8  # EngineConfig.decode_block_size
    sc0, sc1 = before["step_clock"]["kinds"], after["step_clock"]["kinds"]

    def n(kind):
        return sc1[kind]["dispatches"] - sc0[kind]["dispatches"]

    if n("mixed") or n("loop"):
        return None
    steps, chunks = K * n("decode_block"), n("prefill")
    out = {}
    for name, count in after["kernel_launches"].items():
        if not count:
            continue
        per = (steps if name.startswith("paged_decode")
               else chunks if name == "paged_prefill" else steps + chunks)
        out[name] = count / per if per else None
    return out


def _timing_line(label, card, stats0, before, after, mix_wall, lone_wall,
                 prof) -> None:
    """One line per server: warmup, walls, step-clock ms per dispatch kind
    (a decode step: the K-step block's wall over K, or a looped block's
    over its iterations), looped-block traffic, busy share and device
    memory; ``before`` and ``after`` are ``/server/stats`` readings around
    the mix and the lone request."""
    K = 8  # EngineConfig.decode_block_size
    sc0, sc1 = before["step_clock"], after["step_clock"]
    mem = after.get("memory") or {}
    loop = _loop_delta(before, after)
    loop_wall = (sc1["kinds"]["loop"]["wall_s"]
                 - sc0["kinds"]["loop"]["wall_s"])
    log(json.dumps({
        "server_timing": label, "card": card,
        "warmup_s": stats0["warmup_s"],
        "mix_wall_s": mix_wall, "lone_request_s": lone_wall,
        "decode_step_ms": _clock_ms(sc0, sc1, "decode_block", K),
        "prefill_chunk_ms": _clock_ms(sc0, sc1, "prefill"),
        "mixed_step_ms": _clock_ms(sc0, sc1, "mixed"),
        "loop_block_ms": _clock_ms(sc0, sc1, "loop"),
        "loop_step_ms": (loop_wall * 1e3 / loop["steps"]
                         if loop and loop["steps"] else None),
        "loop": loop,
        "busy_share": prof["busy_share"], "device_busy_s":
        prof["device_busy_s"], "profile_window_s": prof["wall_s"],
        "top_device_ms": prof["top_device_ms"][:4],
        "events": sc1["events"],
        # dispatches and host wall s per kind over the mix and the lone
        # request: a kind's ms moves when work is attributed differently
        "dispatches": {
            k: [v["dispatches"] - sc0["kinds"][k]["dispatches"],
                v["wall_s"] - sc0["kinds"][k]["wall_s"]]
            for k, v in sc1["kinds"].items()},
        "launches_per_forward": _per_forward(before, after),
        "max_allocated_bytes": mem.get("max_allocated_bytes"),
        "graph_pool_bytes": mem.get("graph_pool_bytes"),
        "graphs": mem.get("graphs"),
    }))


# the kernels each served path runs (the quantum server never launches
# the ragged kernel; the mixed server never the chunked-prefill one)
QUANTUM_KERNELS = ("paged_decode", "paged_prefill", "rms_norm", "rope")
MIXED_KERNELS = ("paged_ragged", "paged_decode", "rms_norm", "rope")
# the quantized servers: (label, model, flags, kernels that must launch,
# kernels that must not); int8 pools have no prefill kernel (the JAX
# package has none either), so a prefill chunk attends on the plain path
QUANT_SERVERS = (
    ("llama-3-8b int8 weights + int8 KV, random weights", "llama-3-8b",
     ["--model-quantization", "int8", "--engine-kv-quant", "int8"],
     ("quant_matmul_q8", "paged_decode_int8", "rms_norm", "rope"),
     ("paged_prefill", "paged_decode", "quant_matmul_q4")),
    ("llama-3.2-1b int4 weights, random weights", "llama-3.2-1b",
     ["--model-quantization", "int4"],
     ("quant_matmul_q4", "paged_decode", "paged_prefill", "rms_norm",
      "rope"),
     ("paged_decode_int8", "quant_matmul_q8")),
)

# phase 4's servers and phase 3's quantized servers, each group started
# together (``_prestart``): (flags, log name, model) as the phases start
# them
LOOPED_FLAGS = ["--engine-loop-to-completion", "true"]
K_BLOCK_FLAGS = ["--engine-loop-to-completion", "true",
                 "--engine-loop-max-steps", "8"]
MIXED_FLAGS = ["--engine-mixed-step-tokens", "512"]
QUANT_8B_FLAGS = ["--model-quantization", "int8", "--engine-kv-quant", "int8"]
SERVE_SERVERS = (
    ([], "server.log", "llama-3.2-1b"),
    (LOOPED_FLAGS, "server_loop.log", "llama-3.2-1b"),
    (MIXED_FLAGS, "server_mixed.log", "llama-3.2-1b"),
    (MIXED_FLAGS + K_BLOCK_FLAGS, "server_mixed_loop.log", "llama-3.2-1b"))
QUANT_SERVER_SPECS = tuple(
    (flags, f"server_{model}_{flags[1]}.log", model)
    for _, model, flags, _, _ in QUANT_SERVERS) + (
    (MIXED_FLAGS + QUANT_8B_FLAGS, "server_llama-3-8b_mixed.log",
     "llama-3-8b"),)

# the model families at full width and depth, random weights from the
# seed: (label, model, flags, kernels that must launch, kernels that must
# not, launches per forward: the attention kernels one a layer, Mixtral's
# 32 x (4 + 8 x 3) = 896 expert and attention products)
FAMILY_SERVERS = (
    ("gemma2-9b bf16, random weights", "gemma2-9b", [], QUANTUM_KERNELS,
     ("quant_matmul_q8", "paged_decode_int8"),
     {"paged_decode": 42, "paged_prefill": 42, "rms_norm": 4 * 42 + 1,
      "rope": 2 * 42}),
    ("qwen2-7b bf16, random weights", "qwen2-7b", [], QUANTUM_KERNELS,
     ("quant_matmul_q8", "paged_decode_int8"),
     {"paged_decode": 28, "paged_prefill": 28, "rms_norm": 2 * 28 + 1,
      "rope": 2 * 28}),
    ("mistral-7b bf16, random weights", "mistral-7b", [], QUANTUM_KERNELS,
     ("quant_matmul_q8", "paged_decode_int8"),
     {"paged_decode": 32, "paged_prefill": 32}),
    ("mixtral-8x7b int8 weights, random weights", "mixtral-8x7b",
     ["--model-quantization", "int8"],
     ("quant_matmul_q8", *QUANTUM_KERNELS),
     ("quant_matmul_q4", "paged_decode_int8"),
     {"quant_matmul_q8": 32 * (4 + 8 * 3), "paged_decode": 32,
      "paged_prefill": 32}),
)

# the first mix's prompts; its greedy requests, sent one at a time first
# thing after startup, give the texts the checkpoint phase compares
MIX_PROMPTS = {
    "p20": "The H100 serves this.",  # 21 ids with BOS
    "p100": ("Paged attention reads each row's pages straight from "
             "the pool; the gather path copies them. ") * 1 + "x" * 4,
    "p600": ("Long prompt chunked past the 512 bucket. " * 15)[:600],
}
GREEDY = {"temperature": 0.0, "max_tokens": 24}
# each phase 4 / 7 server's greedy texts by label, and the log-
# probabilities of phase 4's 8B int8 server (phase 14 compares)
SERVED_TEXTS: dict = {}
SERVED_LOGPROBS: dict = {}
PARALLEL_8B = "llama-3-8b int8 weights + int8 KV, random weights"


def greedy_texts(base) -> dict:
    """The first mix's greedy prompts, one at a time: {name: text}."""
    out = {}
    for name, prompt in MIX_PROMPTS.items():
        st, body, _ = _gen(base, prompt, GREEDY)
        _check_generate(st, body, GREEDY["max_tokens"])
        out[name] = body["choices"][0]["text"]
    return out


def phase_serve(card: str, seed: int = 0, model: str = "llama-3.2-1b",
                extra=(), log_name: str = "server.log",
                label: str = "llama-3.2-1b bf16 random weights",
                required=QUANTUM_KERNELS, absent=(), per_forward=None,
                trace_phase: str = "serve") -> tuple:
    """The first mix's greedy prompts one at a time, then four concurrent
    requests (greedy and sampled, ~20 to 600 bytes), then a lone greedy
    repeat; every kernel in ``required`` must launch and none in
    ``absent``, and each kernel in ``per_forward`` must launch exactly that
    many times a forward (``_per_forward``). Then the mix once more while
    the server traces the card. Returns (launches, greedy texts)."""
    with _server(seed, list(extra), log_name, model) as base:
        _, stats0 = _http("GET", base + "/server/stats")
        texts = greedy_texts(base)
        phase_done(f"{label}: startup and greedy texts")

        _reset_counts(base)
        _, before = _http("GET", base + "/server/stats")
        jobs = [(MIX_PROMPTS["p20"], GREEDY), (MIX_PROMPTS["p100"], GREEDY),
                (MIX_PROMPTS["p600"], GREEDY),
                (MIX_PROMPTS["p100"], {"temperature": 0.8, "top_p": 0.9,
                                       "max_tokens": 24})]

        def run_jobs():
            with cf.ThreadPoolExecutor(len(jobs)) as ex:
                return list(ex.map(lambda j: _gen(base, *j), jobs))

        t_all = time.monotonic()
        results = run_jobs()
        wall = time.monotonic() - t_all
        st, again, dt_again = _gen(base, MIX_PROMPTS["p20"], GREEDY)
        _, stats = _http("GET", base + "/server/stats")
        launches = stats["kernel_launches"]
        log("[serve] launches on the served path: " + json.dumps(launches))

        for (prompt, params), (st, body, _) in zip(jobs, results):
            _check_generate(st, body, params["max_tokens"])
        _check_generate(st, again, GREEDY["max_tokens"])
        for name in required:
            assert launches[name] > 0, (
                f"kernel {name} never launched on the served path ({label})")
        for name in absent:
            assert launches[name] == 0, (
                f"kernel {name} launched on the served path ({label})")
        assert again["choices"][0]["text"] == texts["p20"], (
            "greedy repeat differs", texts["p20"], again)
        got_per = _per_forward(before, stats)
        for name, want in (per_forward or {}).items():
            assert got_per[name] == want, (label, name, got_per)
        if model == REPLICA_MODEL and not extra:  # phase 12's one engine
            PER_FORWARD[label] = got_per
        hits = stats["cache"]["hits"]
        assert hits > 0, f"no prefix hit in /server/stats: {stats['cache']}"
        toks = sum(b["usage"]["completion_tokens"] for _, b, _ in results)
        loop = _loop_delta(before, stats)
        if "--engine-loop-to-completion" in extra:
            assert loop and loop["blocks"] > 0, (label, stats["loop"])
            assert stats["step_clock"]["kinds"]["decode_block"][
                "dispatches"] == before["step_clock"]["kinds"][
                "decode_block"]["dispatches"], "a fixed block ran"
        log(json.dumps({
            "serve": label, "card": card, "launches": launches,
            "loop": loop,
            "concurrent_requests": len(jobs), "wall_s": wall,
            "completion_tokens": toks, "tokens_per_s": toks / wall,
            "request_latency_s": [r[2] for r in results],
            "repeat_latency_s": dt_again, "prefix_hits": hits,
            "concurrent_p20_matches_solo": (
                results[0][1]["choices"][0]["text"] == texts["p20"]),
            "note": "smoke numbers, not a benchmark",
        }))
        phase_done(f"{label}: mix and lone request")
        prof = _profiled(base, run_jobs, phase=trace_phase)
        phase_done(f"{label}: profile")
        _timing_line(label, card, stats0, before, stats, wall, dt_again,
                     prof)
        SERVED_TEXTS[label] = texts
        if label == PARALLEL_8B:  # phase 14's reference log-probabilities
            SERVED_LOGPROBS[label] = {
                name: _v1_logprobs(base, p)[1]
                for name, p in MIX_PROMPTS.items()}
        return launches, texts


def phase_serve_mixed(card: str, seed: int = 0, extra=(),
                      label: str = "llama-3.2-1b bf16 random weights, "
                      "--engine-mixed-step-tokens 512",
                      log_name: str = "server_mixed.log",
                      model: str = "llama-3.2-1b",
                      required=MIXED_KERNELS,
                      absent=("paged_prefill",),
                      trace_phase: str = "serve") -> dict:
    """The ragged mixed step served (each mixed step one CUDA graph
    replay): two chats decode while a ~1500-byte and a 600-byte prompt
    load. ``extra`` adds server flags (the K-block form under
    ``--engine-loop-to-completion true``, the quantized servers); every
    kernel in ``required`` must launch and none in ``absent``."""
    with _server(seed, ["--engine-mixed-step-tokens", "512", *extra],
                 log_name, model) as base:
        _, boot = _http("GET", base + "/server/stats")
        st, body, _ = _gen(base, "warm up", {"temperature": 0.0,
                                             "max_tokens": 4})
        _check_generate(st, body, 4)
        chat = {"temperature": 0.0, "max_tokens": 48}
        longp = {"temperature": 0.0, "max_tokens": 24}
        jobs = [("Tell me about paged attention.", chat),
                ("Why does a mixed step help decode?", chat),
                (("A long prompt that loads while two chats decode. " * 31)
                 [:1500], longp),
                (("A shorter prompt packed into the same steps. " * 14)[:600],
                 longp)]

        def run_mix(stats0):
            t_all = time.monotonic()
            with cf.ThreadPoolExecutor(len(jobs)) as ex:
                chats = [ex.submit(_gen, base, *j) for j in jobs[:2]]
                while True:  # the chats have their first tokens: decoding
                    _, st_now = _http("GET", base + "/server/stats")
                    if (st_now["tokens_generated"]
                            >= stats0["tokens_generated"] + 2):
                        break
                    if time.monotonic() - t_all > 120:
                        raise RuntimeError("the chats never started decoding")
                    time.sleep(0.002)
                prompts = [ex.submit(_gen, base, *j) for j in jobs[2:]]
                results = [f.result() for f in chats + prompts]
            return results, time.monotonic() - t_all

        stats0 = _reset_counts(base)
        mixed0 = stats0["mixed"]
        results, wall = run_mix(stats0)
        st, lone, dt_lone = _gen(base, MIX_PROMPTS["p20"], GREEDY)
        _check_generate(st, lone, GREEDY["max_tokens"])
        _, stats = _http("GET", base + "/server/stats")
        launches = stats["kernel_launches"]
        mixed = {k: stats["mixed"][k] - mixed0[k]
                 for k in ("steps", "prefill_tokens", "decode_tokens")}
        log("[serve mixed] launches on the served path: "
            + json.dumps(launches) + " mixed: " + json.dumps(mixed))

        for (_, params), (st, body, _) in zip(jobs, results):
            _check_generate(st, body, params["max_tokens"])
        for name in required:
            assert launches[name] > 0, (
                f"kernel {name} never launched on the mixed served path "
                f"({label})")
        for name in absent:
            assert launches[name] == 0, (name, launches)
        mem = stats.get("memory") or {}
        assert mem.get("graphs"), f"no CUDA graph captured: {mem}"
        assert mixed["steps"] >= 3, mixed
        assert mixed["decode_tokens"] > 0, mixed
        assert mixed["prefill_tokens"] >= 1500, mixed
        toks = sum(b["usage"]["completion_tokens"] for _, b, _ in results)
        log(json.dumps({
            "serve_mixed": label, "card": card, "launches": launches,
            "loop": _loop_delta(stats0, stats),
            "requests": len(jobs), "wall_s": wall,
            "completion_tokens": toks, "tokens_per_s": toks / wall,
            "request_latency_s": [r[2] for r in results],
            "prompt_tokens": [b["usage"]["prompt_tokens"]
                              for _, b, _ in results],
            "mixed": mixed, "batch_density": stats["mixed"]["batch_density"],
            "note": "smoke numbers, not a benchmark",
        }))
        _, now = _http("GET", base + "/server/stats")
        prof = _profiled(base, lambda: run_mix(now), phase=trace_phase)
        _timing_line(label, card, boot, stats0, stats, wall, dt_lone, prof)
        return launches


def phase_loop_timing(card: str, seed: int = 0) -> dict:
    """llama-3.2-1b bf16 at full depth, in process: 8 greedy rows of 64 new
    tokens decoded by looped blocks (one WHILE-graph launch each) and by
    K = 8 blocks (graph replays), every block's device time read with CUDA
    events on the engine stream around its launch. Prints the device ms
    per decode step of both paths, the host wall per step (the step
    clock) and the looped path's device share of its blocks' wall: the
    busy share a ``torch.profiler`` trace cannot give for looped blocks,
    whose kernels inside the WHILE node's body do not appear in it. The
    two paths' tokens must be identical."""
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

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init_params(LLAMA_3_2_1B, gen, dtype=torch.bfloat16,
                               device="cuda")
    tok = ByteTokenizer()
    prompts = [f"row {i}: " + "timing the looped block " * (i + 1)
               for i in range(8)]
    out, toks = {}, {}
    for name, kw in (("loop", {"loop_to_completion": True}),
                     ("fixed", {})):
        eng = LLMEngine(params, LLAMA_3_2_1B, tok, EngineConfig(**kw),
                        dtype=torch.bfloat16, device="cuda")
        eng.warmup()
        timed = []

        def bracket(fn):
            def run(*a):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record(eng._stream)
                r = fn(*a)
                ev[1].record(eng._stream)
                timed.append(ev)
                return r
            return run

        run_loop, run = eng._run_loop, eng._run
        eng._run_loop = bracket(run_loop)
        eng._run = lambda key, body, g: (bracket(run) if key[0] == "decode"
                                         else run)(key, body, g)
        sc0 = eng.step_clock_stats()["kinds"]
        st0 = eng.loop_stats()
        for i, p in enumerate(prompts):
            eng.add_request(f"r{i}", tok.encode(p),
                            SamplingParams(max_tokens=64, temperature=0.0))
        got = {}
        while eng.has_work():
            for o in eng.step():
                if o.token_id is not None:
                    got.setdefault(o.request_id, []).append(o.token_id)
        torch.cuda.synchronize()
        device_ms = sum(a.elapsed_time(b) for a, b in timed)
        sc1 = eng.step_clock_stats()["kinds"]
        kind = "loop" if kw else "decode_block"
        wall_ms = (sc1[kind]["wall_s"] - sc0[kind]["wall_s"]) * 1e3
        blocks = sc1[kind]["dispatches"] - sc0[kind]["dispatches"]
        steps = (eng.loop_stats()["steps"] - st0["steps"] if kw
                 else blocks * 8)
        out[name] = {"blocks": blocks, "decode_steps": steps,
                     "device_ms_per_step": device_ms / steps,
                     "host_wall_ms_per_step": wall_ms / steps,
                     "device_share_of_block_wall": device_ms / wall_ms}
        toks[name] = got
        del eng
    assert toks["loop"] == toks["fixed"], "looped tokens differ from fixed"
    log(json.dumps({"loop_timing": "llama-3.2-1b bf16, 8 greedy rows x 64 "
                    "tokens, in process", "card": card, **out}))
    return out


def phase_checkpoint(card: str, seed: int, want, api: bool = False,
                     spec: bool = False, admission: bool = False) -> dict:
    """The port's saver writes the random llama-3.2-1b bf16 weights of
    ``seed`` (what the bf16 server draws) to a directory under the
    gitignored ``build/``, beside a ``tokenizer_config.json`` with this
    script's Llama-3-style chat template; the load is timed in process,
    then a server started with ``--model-model-dir`` on it must answer the
    first mix's greedy prompts with the random-weight server's texts
    (``want``, when given). With ``api`` the same server then runs the
    ``api`` phase, with ``admission`` the admission phase, and with ``spec``
    a second server serves the same directory as target and draft
    (phase 9). Returns {"api": the api phase's launches, "spec":
    {"llama-3.2-1b": the spec server's launches}} (empty without them)."""
    from distributed_inference_server_tpu_torch.models import llama
    from distributed_inference_server_tpu_torch.models.configs import (
        LLAMA_3_2_1B,
    )
    from distributed_inference_server_tpu_torch.models.loader import (
        load_checkpoint,
        save_checkpoint,
    )

    ckpt = os.path.join("build", "chip_smoke_ckpt", "llama-3.2-1b")
    shutil.rmtree(ckpt, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init_params(LLAMA_3_2_1B, gen, dtype=torch.bfloat16,
                               device="cuda")
    t0 = time.monotonic()
    save_checkpoint(params, LLAMA_3_2_1B, ckpt, dtype=None)
    save_s = time.monotonic() - t0
    nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                 for f in os.listdir(ckpt))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    loaded, cfg = load_checkpoint(ckpt, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0

    def same(a, b):
        return all(same(a[k], b[k]) if isinstance(a[k], dict)
                   else torch.equal(a[k], b[k]) for k in a)

    assert set(loaded) == set(params) and same(params, loaded)
    assert cfg.with_overrides(name=LLAMA_3_2_1B.name) == LLAMA_3_2_1B, cfg
    del params, loaded
    torch.cuda.empty_cache()
    with open(os.path.join(ckpt, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": CHAT_TEMPLATE,
                   "bos_token": "<|begin_of_text|>",
                   "eos_token": "<|eot_id|>"}, f)
    launches, spec_launches = {}, {}
    with _server(seed, ["--model-model-dir", ckpt], "server_ckpt.log") as base:
        _, stats = _http("GET", base + "/server/stats")
        got = greedy_texts(base)
        if want is not None:
            assert got == want, ("checkpoint server differs from the "
                                 "random-weight server", got, want)
        log(json.dumps({"checkpoint": "llama-3.2-1b bf16 random weights "
                        "from --seed, saved and served from "
                        "--model-model-dir", "card": card, "bytes": nbytes,
                        "save_s": save_s, "load_s": load_s,
                        "load_gb_per_s": nbytes / load_s / 1e9,
                        "server_warmup_s": stats["warmup_s"],
                        "texts_match_random_weight_server":
                        want is not None}))
        if api:
            phase_done("checkpoint")
            launches = phase_api(card, base, ckpt, got)
        if admission:
            phase_done("api")
            phase_admission(card, seed, base)
    if spec:
        phase_done("admission")
        spec_launches["llama-3.2-1b"] = phase_serve_spec(
            card, seed, ["--model-model-dir", ckpt,
                         "--model-draft-model-dir", ckpt],
            "llama-3.2-1b bf16 checkpoint, the same checkpoint as draft",
            "server_spec_1b.log", "llama-3.2-1b", want=got)["launches"]
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"api": launches, "spec": spec_launches}


# ---------------------------------------------------------------------------
# phase 8: the API surface (SSE, chat, /v1, embeddings, /metrics)
# ---------------------------------------------------------------------------

# the Llama-3 instruct format as a checkpoint's tokenizer_config.json
# carries it; the script renders it itself (jinja2) for its reference ids
CHAT_TEMPLATE = (
    "{{ bos_token }}{% for m in messages %}<|start_header_id|>"
    "{{ m['role'] }}<|end_header_id|>\n\n{{ m['content'] }}<|eot_id|>"
    "{% endfor %}{% if add_generation_prompt %}<|start_header_id|>"
    "assistant<|end_header_id|>\n\n{% endif %}")
CHAT_MESSAGES = [{"role": "system", "content": "You answer in one line."},
                 {"role": "user", "content": "Which prime follows 89?"}]
API_KERNELS = ("paged_prefill", "paged_decode", "rms_norm", "rope")


def _render_chat(messages) -> str:
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)
    return env.from_string(CHAT_TEMPLATE).render(
        messages=messages, add_generation_prompt=True,
        bos_token="<|begin_of_text|>", eos_token="<|eot_id|>")


def _sse(base, path, body, close_after=None):
    """POST ``body`` and read the SSE stream as it arrives: returns
    ``{"frames": [(arrival s since send, parsed JSON or "[DONE]")],
    "reads": reads that returned data}``. ``close_after``: close the
    socket once that many frames arrived (a client that goes away)."""
    _count_post(base + path)
    parts = urllib.parse.urlsplit(base)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=600)
    t0 = time.monotonic()
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, (resp.status, resp.read()[:500])
    ctype = resp.getheader("Content-Type") or ""
    assert ctype.startswith("text/event-stream"), ctype
    frames, buf, reads = [], b"", 0
    while True:
        piece = resp.read1(1 << 16)
        if not piece:
            break
        reads += 1
        now = time.monotonic() - t0
        buf += piece
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            text = frame.decode("utf-8")
            assert text.startswith("data: "), text
            payload = text[len("data: "):]
            frames.append((now, payload if payload == "[DONE]"
                           else json.loads(payload)))
        if close_after is not None and len(frames) >= close_after:
            conn.sock.close()
            break
    conn.close()
    assert not buf, buf
    return {"frames": frames, "reads": reads}


def _token_event_ok(d) -> None:
    """One native frame in the JAX package's ``TokenEvent`` wire shape."""
    kind = d.get("type")
    if kind == "token":
        assert isinstance(d["token"], str) and isinstance(d["index"], int), d
        assert set(d) <= {"type", "token", "index", "logprob"}, d
        assert d.get("logprob", 0.0) <= 0.0, d
    elif kind == "done":
        assert d["finish_reason"] in ("stop", "length", "stop_sequence"), d
        u = d["usage"]
        assert u["total_tokens"] == u["prompt_tokens"] + u[
            "completion_tokens"], d
    else:
        assert kind == "error" and "messages" in d and "code" in d, d


def _native_stream(base, path, body) -> dict:
    """A native stream (/generate, /chat) checked frame by frame: every
    frame a TokenEvent dict, token frames before one done frame, then
    ``[DONE]``. Adds ``text``, ``ttft_s`` (first token-bearing frame),
    ``gaps_s`` (between token frames) and ``bursts`` (token frames per
    burst: frames less than 1 ms apart)."""
    out = _sse(base, path, body)
    frames = out["frames"]
    assert frames[-1][1] == "[DONE]", frames[-3:]
    events = [f for f in frames[:-1]]
    for _, d in events:
        _token_event_ok(d)
    assert events[-1][1]["type"] == "done", events[-1]
    toks = [(t, d) for t, d in events[:-1]]
    assert all(d["type"] == "token" for _, d in toks), toks
    out["text"] = "".join(d["token"] for _, d in toks)
    out["logprobs"] = [d["logprob"] for _, d in toks if "logprob" in d]
    out["done"] = events[-1][1]
    out["done_s"] = events[-1][0]
    assert len(out["logprobs"]) == out["done"]["usage"]["completion_tokens"]
    # the time of a token-bearing frame: one per sampled token (with a
    # random-weight model most carry an id past the byte tokenizer's
    # range, whose text is empty)
    times = [t for t, d in toks if "logprob" in d]
    out["ttft_s"] = times[0] if times else None
    out["gaps_s"] = [b - a for a, b in zip(times, times[1:])]
    bursts, last = [], None
    for t in times:
        if last is not None and t - last < 1e-3:
            bursts[-1] += 1
        else:
            bursts.append(1)
        last = t
    out["bursts"] = bursts
    return out


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))] \
        if xs else None


def _parse_prom(text: str) -> dict:
    """The text exposition format: {family: {"type", "samples": [(name,
    {label: value}, value)]}}; every sample belongs to a declared
    family."""
    fams, typed = {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            typed[name] = kind
            fams[name] = {"type": kind, "samples": []}
            continue
        if line.startswith("#"):
            continue
        head, value = line.rsplit(" ", 1)
        labels = {}
        if "{" in head:
            name, rest = head.split("{", 1)
            for pair in rest.rstrip("}").split('",'):
                if pair:
                    k, v = pair.split("=", 1)
                    labels[k] = v.strip('"')
        else:
            name = head
        fam = next((f for f in (name, name.rsplit("_", 1)[0])
                    if f in typed), None)
        assert fam is not None, f"sample {name} of no declared family"
        fams[fam]["samples"].append((name, labels, float(value)))
    return fams


def _prom_sum(fams, family, sample, **labels) -> float:
    return sum(v for n, lab, v in fams[family]["samples"] if n == sample
               and all(lab.get(k) == x for k, x in labels.items()))


def phase_api(card: str, base: str, ckpt: str, texts: dict) -> dict:
    """The API surface on one llama-3.2-1b bf16 server (the checkpoint
    server, with its template): streamed /generate == the non-streamed
    texts; /chat and /v1/chat/completions (streamed and not) == the
    in-process engine on the template's rendering; /v1/completions with
    n 2, logprobs 0, a stop string and include_usage; /embeddings and
    /v1/embeddings against the in-process plain path, with a greedy
    /v1/completions during an embeddings job held to its solo run's
    log-probabilities; a client that goes away
    mid-stream; /metrics counts == the requests sent. Prints one
    ``api_timing`` line. Returns the kernels' launches on the streamed
    routes."""
    from distributed_inference_server_tpu_torch.engine.engine import (
        EngineConfig,
        LLMEngine,
        SamplingParams,
    )
    from distributed_inference_server_tpu_torch.models.loader import (
        load_checkpoint,
    )
    from distributed_inference_server_tpu_torch.models.tokenizer import (
        ByteTokenizer,
    )

    netloc = urllib.parse.urlsplit(base).netloc
    gen_sequences = 0  # engine sequences that will record a TTFT
    gen_sequences += len(MIX_PROMPTS)  # the checkpoint phase's texts
    _, m0 = _http("GET", base + "/server/stats")

    def server_ttft(run):
        """(the server's mean TTFT in ms over the requests of ``run()``,
        their count): ``time_to_first_token_seconds`` sum and count read
        from /metrics around it."""
        key = ("time_to_first_token_seconds",
               "time_to_first_token_seconds_")
        before = _parse_prom(_get_text(base + "/metrics")[0])
        out = run()
        after = _parse_prom(_get_text(base + "/metrics")[0])
        d = {x: _prom_sum(after, key[0], key[1] + x)
             - _prom_sum(before, key[0], key[1] + x)
             for x in ("sum", "count")}
        return out, d["sum"] / d["count"] * 1e3, d["count"]

    # -- streamed routes, counts zeroed just before and read just after
    _reset_counts(base)
    lone, lone_server_ms, n_lone = server_ttft(lambda: {
        name: _native_stream(base, "/generate", {
            "prompt": prompt, **GREEDY, "stream": True})
        for name, prompt in MIX_PROMPTS.items()})
    assert n_lone == len(MIX_PROMPTS), n_lone
    solo_v1 = {}  # each prompt's unstreamed (text, token_logprobs)
    for name, prompt in MIX_PROMPTS.items():
        s = lone[name]
        # the same request unstreamed, with its sampled tokens'
        # log-probabilities: the streamed tokens are the same tokens
        st, v1 = _http("POST", base + "/v1/completions", {
            "prompt": prompt, **GREEDY, "logprobs": 0})
        gen_sequences += 2
        assert st == 200, v1
        assert s["text"] == texts[name] == v1["choices"][0]["text"], (
            "streamed text differs from the non-streamed one", name,
            s["text"], texts[name])
        solo_v1[name] = (v1["choices"][0]["text"],
                         v1["choices"][0]["logprobs"]["token_logprobs"])
        assert s["logprobs"] == solo_v1[name][1], (name, s["logprobs"], v1)
        assert s["reads"] > 1 and s["ttft_s"] < s["done_s"], (
            "the stream arrived all at once", name, s["reads"])
    mix_jobs = [(MIX_PROMPTS["p20"], GREEDY), (MIX_PROMPTS["p100"], GREEDY),
                (MIX_PROMPTS["p600"], GREEDY),
                (MIX_PROMPTS["p100"], {"temperature": 0.8, "top_p": 0.9,
                                       "max_tokens": 24})]

    def run_mix():
        with cf.ThreadPoolExecutor(len(mix_jobs)) as ex:
            return list(ex.map(lambda j: _native_stream(
                base, "/generate", {"prompt": j[0], **j[1],
                                    "stream": True}), mix_jobs))

    mix, mix_server_ms, n_mix = server_ttft(run_mix)
    assert n_mix == len(mix_jobs), n_mix
    gen_sequences += len(mix_jobs)
    # the mix's greedy streams against their lone runs: the same text and
    # the same sampled tokens' log-probabilities, exactly
    for i, name in ((0, "p20"), (1, "p100"), (2, "p600")):
        assert (mix[i]["text"], mix[i]["logprobs"]) == (
            texts[name], lone[name]["logprobs"]), (
            "a greedy stream of the mix differs from its lone run", name,
            mix[i]["logprobs"], lone[name]["logprobs"])

    # the conversation's first request runs cold; the next ones find its
    # full pages in the prefix cache and prefill only the rest, a
    # different chunk shape whose bf16 rounding may differ: the warm
    # requests are held against each other, and each kind against the
    # engine run the same way (below)
    chat = {"messages": CHAT_MESSAGES, **GREEDY}
    st, cold = _http("POST", base + "/v1/chat/completions",
                     {**chat, "logprobs": True})
    assert st == 200 and cold["object"] == "chat.completion", cold
    st, chat_json = _http("POST", base + "/chat", chat)
    assert st == 200 and chat_json["object"] == "chat.completion", chat_json
    chat_text = chat_json["choices"][0]["message"]["content"]
    chat_sse = _native_stream(base, "/chat", {**chat, "stream": True})
    st, v1_json = _http("POST", base + "/v1/chat/completions",
                        {**chat, "logprobs": True})
    assert st == 200 and v1_json["object"] == "chat.completion", v1_json
    v1_sse = _sse(base, "/v1/chat/completions", {**chat, "logprobs": True,
                                                  "stream": True})
    gen_sequences += 5
    assert v1_sse["frames"][-1][1] == "[DONE]"
    v1_chunks = [d for _, d in v1_sse["frames"][:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in v1_chunks)
    assert v1_chunks[0]["choices"][0]["delta"].get("role") == "assistant"
    v1_text = "".join(c["choices"][0]["delta"].get("content", "")
                      for c in v1_chunks)
    assert (chat_sse["text"] == v1_json["choices"][0]["message"]["content"]
            == v1_text == chat_text), (chat_text, chat_sse["text"], v1_text)
    v1_lps = [e["logprob"] for c in v1_chunks
              if c["choices"][0]["logprobs"]
              for e in c["choices"][0]["logprobs"]["content"]]
    json_lps = [e["logprob"] for e in
                v1_json["choices"][0]["logprobs"]["content"]]
    assert chat_sse["logprobs"] == v1_lps == json_lps, (
        chat_sse["logprobs"], v1_lps, json_lps)
    _, after_streams = _http("GET", base + "/server/stats")
    launches = after_streams["kernel_launches"]
    for name in API_KERNELS:
        assert launches[name] > 0, (
            f"kernel {name} never launched on the streamed routes")
    phase_done("api: streamed routes")

    # -- /v1/completions: n 2, logprobs 0, a stop string, include_usage
    stop = texts["p20"][5:8] or "\n"
    comp = {"prompt": MIX_PROMPTS["p20"], "n": 2, "logprobs": 0,
            "stop": stop, **GREEDY}
    st, cj = _http("POST", base + "/v1/completions", comp)
    assert st == 200 and cj["object"] == "text_completion", cj
    assert [c["index"] for c in cj["choices"]] == [0, 1]
    for c in cj["choices"]:
        assert set(c) == {"text", "index", "logprobs", "finish_reason"}, c
        assert c["finish_reason"] in ("stop", "length"), c
        lp = c["logprobs"]
        assert set(lp) == {"tokens", "token_logprobs", "top_logprobs",
                           "text_offset"}, lp
        assert len(lp["tokens"]) == len(lp["token_logprobs"]) == len(
            lp["text_offset"]) and lp["top_logprobs"] is None
        assert stop not in c["text"], (stop, c)
    u = cj["usage"]
    assert u["prompt_tokens"] == len(MIX_PROMPTS["p20"].encode()) + 1, u
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
    cs = _sse(base, "/v1/completions", {
        **comp, "stream": True, "stream_options": {"include_usage": True}})
    gen_sequences += 4
    assert cs["frames"][-1][1] == "[DONE]"
    chunks = [d for _, d in cs["frames"][:-1]]
    assert all(c["object"] == "text_completion" and "usage" in c
               for c in chunks)
    finishes = collections.Counter(
        c["choices"][0]["index"] for c in chunks
        if c["choices"] and c["choices"][0]["finish_reason"] is not None)
    assert finishes == {0: 1, 1: 1}, finishes
    assert chunks[-1]["choices"] == [] and chunks[-1]["usage"] == u, (
        chunks[-1], u)
    assert all(c["usage"] is None for c in chunks[:-1])
    streamed = ["".join(c["choices"][0]["text"] for c in chunks[:-1]
                        if c["choices"][0]["index"] == i) for i in (0, 1)]
    assert streamed == [c["text"] for c in cj["choices"]], (streamed, cj)
    phase_done("api: /v1/completions")

    # -- the in-process references on the checkpoint's weights
    tok = ByteTokenizer()
    params, cfg = load_checkpoint(ckpt, dtype=torch.bfloat16, device="cuda")

    # -- embeddings: 8 inputs of up to 512 tokens and one past the bucket
    inputs = [("Embeddings pool the final hidden states. " * 13)[:n]
              for n in (5, 40, 90, 200, 300, 420, 480, 511)]
    inputs.append(("An input longer than the largest bucket. " * 40)[:1300])
    counts0 = _http("GET", base + "/server/stats")[1]["kernel_launches"]
    t = time.monotonic()
    st, emb = _http("POST", base + "/embeddings", {"input": inputs})
    emb_s = time.monotonic() - t
    assert st == 200 and emb["object"] == "list", emb
    counts1 = _http("GET", base + "/server/stats")[1]["kernel_launches"]
    for name in ("rms_norm", "rope"):
        assert counts1[name] > counts0[name], (name, counts0, counts1)
    t = time.monotonic()
    st, emb2 = _http("POST", base + "/v1/embeddings", {"input": inputs})
    emb2_s = time.monotonic() - t
    assert st == 200
    got = torch.tensor([d["embedding"] for d in emb["data"]])
    got2 = torch.tensor([d["embedding"] for d in emb2["data"]])
    assert torch.equal(got, got2), "two embeddings calls differ"
    norms = got.norm(dim=-1)
    assert ((norms - 1).abs() < 1e-4).all(), norms
    assert emb["usage"]["prompt_tokens"] == sum(
        len(s.encode()) + 1 for s in inputs)
    plain = LLMEngine(params, cfg, tok, EngineConfig(attention_impl="plain"),
                      dtype=torch.bfloat16, device="cuda", _graphs=False)
    want = torch.from_numpy(plain.embed_ids([tok.encode(s) for s in inputs]))
    emb_err = float((got - want).abs().max())
    emb_cos = float(torch.nn.functional.cosine_similarity(got, want).min())
    assert emb_err <= EMB_ATOL and emb_cos >= EMB_MIN_COS, (
        "embeddings differ from the plain path", emb_err, emb_cos)
    del plain
    # a greedy request while a large embeddings job runs: its text and
    # sampled tokens' log-probabilities are its solo run's, exactly
    big = [("Batch after batch of embeddings inputs. " * 13)[:511]
           for _ in range(64)]
    with cf.ThreadPoolExecutor(1) as ex:
        t_emb = time.monotonic()
        fut = ex.submit(_http, "POST", base + "/embeddings", {"input": big})
        time.sleep(0.02)
        t_sent = time.monotonic()
        st, during = _http("POST", base + "/v1/completions", {
            "prompt": MIX_PROMPTS["p20"], **GREEDY, "logprobs": 0})
        gen_sequences += 1
        st_big, big_body = fut.result()
        t_big = time.monotonic()
    assert st == 200 and st_big == 200 and len(big_body["data"]) == 64
    during = (during["choices"][0]["text"],
              during["choices"][0]["logprobs"]["token_logprobs"])
    assert during == solo_v1["p20"], (
        "a decode beside the embeddings job differs from its solo run",
        during, solo_v1["p20"])
    assert t_sent < t_big, "the /generate went out after the job ended"
    phase_done("api: embeddings")

    # -- a client that goes away mid-stream
    _, s0 = _http("GET", base + "/server/stats")

    def pages(stats):
        (w,) = stats["worker_statuses"]
        return (w["memory_used_pages"] - w["pages_cached"],
                stats["cache"]["pages_free"] + stats["cache"]["pages_cached"])

    gone = _sse(base, "/generate", {"prompt": MIX_PROMPTS["p100"],
                                    "max_tokens": 1500, **GREEDY,
                                    "stream": True}, close_after=3)
    gen_sequences += 1
    assert len(gone["frames"]) >= 3
    deadline = time.monotonic() + 30
    while True:
        _, s1 = _http("GET", base + "/server/stats")
        if s1["requests_in_flight"] == 0 and pages(s1) == pages(s0):
            break
        assert time.monotonic() < deadline, (
            "the abandoned stream still holds its request or pages",
            s1["requests_in_flight"], pages(s1), pages(s0))
        time.sleep(0.05)
    assert s1["tokens_generated"] - s0["tokens_generated"] < 1500
    phase_done("api: disconnect")

    # -- /metrics against what was sent
    t = time.monotonic()
    text, nbytes = _get_text(base + "/metrics")
    scrape_ms = (time.monotonic() - t) * 1e3
    prom = _parse_prom(text)
    sent = {path: n for (loc, path), n in POSTS.items() if loc == netloc}
    for path, n in sent.items():
        got_n = _prom_sum(prom, "request_latency_seconds",
                          "request_latency_seconds_count", endpoint=path)
        assert got_n == n, (path, got_n, n)
    ttft_n = _prom_sum(prom, "time_to_first_token_seconds",
                       "time_to_first_token_seconds_count")
    assert ttft_n == gen_sequences, (ttft_n, gen_sequences)
    for fam in ("request_latency_seconds", "tokens_generated_total",
                "engine_up", "engine_step_dispatches_total", "queue_depth"):
        assert fam in prom, fam
    _, s2 = _http("GET", base + "/server/stats")
    phase_done("api: /metrics")

    # -- /chat against the engine on the template's rendering: the byte
    # ids of the rendering, no BOS id (/generate would prepend one), so the
    # reference is the engine itself, run as the server runs it (warmup
    # first, so every dispatch is the same graph replay)
    ref = LLMEngine(params, cfg, tok, EngineConfig(),
                    dtype=torch.bfloat16, device="cuda")
    ref.warmup()
    chat_ids = tok.encode(_render_chat(CHAT_MESSAGES), add_bos=False)
    assert chat_json["usage"]["prompt_tokens"] == len(chat_ids), (
        chat_json["usage"], len(chat_ids))
    runs = []
    for run in ("cold", "warm"):
        ref.add_request(run, chat_ids, SamplingParams(**GREEDY))
        text, lps = "", []
        while ref.has_work():
            for o in ref.step():
                text += o.text
                if o.logprob is not None:
                    lps.append(o.logprob)
        runs.append((text, lps))
    # the embeddings forward alone, in process (no HTTP, no JSON): the
    # 9 inputs' device batches, once to warm and once timed
    emb_ids = [tok.encode(x) for x in inputs]
    ref.embed_ids(emb_ids)
    torch.cuda.synchronize()
    t = time.monotonic()
    ref.embed_ids(emb_ids)
    torch.cuda.synchronize()
    emb_engine_ms = (time.monotonic() - t) * 1e3
    cold_lps = [e["logprob"] for e in cold["choices"][0]["logprobs"]
                ["content"]]
    got = [(cold["choices"][0]["message"]["content"], cold_lps),
           (chat_text, chat_sse["logprobs"])]
    assert got == runs, ("chat differs from the engine on the template's "
                         "rendering", got, runs)
    del ref, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("api: chat against the engine")

    streams = list(lone.values()) + mix + [chat_sse]
    gaps = [g for s in streams for g in s["gaps_s"]]
    bursts = [b for s in streams for b in s["bursts"]]

    def mean_ms(xs):
        return sum(xs) / len(xs) * 1e3

    log(json.dumps({
        "api_timing": "llama-3.2-1b bf16 checkpoint server, max_batch 8, "
                      "K 8, pipeline depth 1, CUDA graphs", "card": card,
        "lone_ttft_ms": {k: v["ttft_s"] * 1e3 for k, v in lone.items()},
        "mix_ttft_ms_p50": _pct([s["ttft_s"] for s in mix], 0.5) * 1e3,
        "mix_ttft_ms_max": max(s["ttft_s"] for s in mix) * 1e3,
        "frame_gap_ms_p50": _pct(gaps, 0.5) * 1e3,
        "frame_gap_ms_p99": _pct(gaps, 0.99) * 1e3,
        "tokens_per_burst_mean": sum(bursts) / len(bursts),
        "tokens_per_burst_p50": _pct(bursts, 0.5),
        # the same requests' TTFT at the client and at the server (submit
        # to the first token's dispatch): the difference is the HTTP layer
        "lone_ttft_ms_mean": {"client": mean_ms(
            [s["ttft_s"] for s in lone.values()]),
            "server": lone_server_ms},
        "mix_ttft_ms_mean": {"client": mean_ms([s["ttft_s"] for s in mix]),
                             "server": mix_server_ms},
        "server_average_ttft_ms": s2["average_ttft_ms"],
        "embeddings_9_inputs_ms": [emb_s * 1e3, emb2_s * 1e3],
        "embeddings_9_inputs_engine_ms": emb_engine_ms,
        "embeddings_64x511_ms": (t_big - t_emb) * 1e3,
        "embeddings_max_abs_err_vs_plain": emb_err,
        "embeddings_min_cosine_vs_plain": emb_cos,
        "metrics_scrape_bytes": nbytes, "metrics_scrape_ms": scrape_ms,
        "requests_sent": sent, "ttft_count": ttft_n,
        "launches_streamed_routes": {k: launches[k] for k in API_KERNELS},
        "startup_total_requests": m0["total_requests"],
    }))
    return launches


def _get_text(url: str):
    with urllib.request.urlopen(url, timeout=60) as resp:
        ctype = resp.headers.get("Content-Type", "")
        assert ctype.startswith("text/plain"), ctype
        body = resp.read()
    return body.decode(), len(body)


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

    # the mixed step on one trace: two chats mid-decode, then a ~400-token
    # prompt; mixed (kernels), mixed (plain versions) and quantum (kernels)
    chats = ["first chat of the mixed trace", "second chat"]
    long_prompt = ("a ~400-token prompt loading while the chats decode. "
                   * 8)[:400]
    mixed = {}
    for name, impl, width in (("mixed-kernel", "kernel", 128),
                              ("mixed-plain", "plain", 128),
                              ("quantum-kernel", "kernel", 0)):
        eng = LLMEngine(params, cfg, tok, EngineConfig(
            attention_impl=impl, mixed_step_tokens=width),
            dtype=torch.float32, device="cuda")
        toks = {}

        def step():
            for o in eng.step():
                if o.token_id is not None:
                    toks.setdefault(o.request_id, []).append(o.token_id)

        for i, p in enumerate(chats):
            eng.add_request(f"c{i}", tok.encode(p),
                            SamplingParams(max_tokens=24, temperature=0.0))
        for _ in range(3):
            step()
        eng.add_request("long", tok.encode(long_prompt),
                        SamplingParams(max_tokens=8, temperature=0.0))
        while eng.has_work():
            step()
        mixed[name] = toks
        if width:
            stats = eng.mixed_stats()
            assert stats["decode_tokens"] > 0 and stats["steps"] >= 3, stats
        del eng
    assert (mixed["mixed-kernel"] == mixed["mixed-plain"]
            == mixed["quantum-kernel"]), mixed
    log(json.dumps({"engine_f32_2layer_mixed":
                    "mixed kernel == mixed plain == quantum greedy tokens",
                    "tokens": mixed["mixed-kernel"]}))
    return outs


def phase_engine_quant_f32(seed: int = 0) -> dict:
    """2 layers of the 1B width in f32: int8 weights over int8 KV, and int4
    weights; the kernels and the plain versions give identical greedy
    tokens, the kernel run launches the quantized kernels and the plain
    run none."""
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
    from distributed_inference_server_tpu_torch.ops import kernels
    from distributed_inference_server_tpu_torch.ops.quant import (
        quantize_params,
    )

    cfg = LLAMA_3_2_1B.with_overrides(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dense = llama.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    tok = ByteTokenizer()
    prompts = ["quantized f32 identity", "int8 codes, f32 scales " * 3,
               "q" * 40]
    outs = {}
    for weights, kv, need in (
            ("int8", "int8", ("quant_matmul_q8", "paged_decode_int8")),
            ("int4", "none", ("quant_matmul_q4", "paged_decode",
                              "paged_prefill"))):
        params = quantize_params(dense, weights)
        toks = {}
        for impl in ("kernel", "plain"):
            kernels.reset_launch_counts()
            eng = LLMEngine(params, cfg, tok, EngineConfig(
                attention_impl=impl, kv_quant=kv), dtype=torch.float32,
                device="cuda")
            for i, p in enumerate(prompts):
                eng.add_request(f"r{i}", tok.encode(p),
                                SamplingParams(max_tokens=16,
                                               temperature=0.0))
            run = {}
            while eng.has_work():
                for o in eng.step():
                    if o.token_id is not None:
                        run.setdefault(o.request_id, []).append(o.token_id)
            toks[impl] = run
            counts = kernels.launch_counts()
            if impl == "kernel":
                assert all(counts[k] > 0 for k in need), counts
            else:
                assert not any(counts.values()), counts
            del eng
        assert toks["kernel"] == toks["plain"], (weights, kv, toks)
        outs[f"{weights}+kv_{kv}"] = toks["kernel"]
        del params
    log(json.dumps({"engine_f32_2layer_quant":
                    "kernel == plain greedy tokens (int8 + int8 KV, int4)",
                    "tokens": outs}))
    return outs


def phase_engine_graphs(seed: int = 0) -> dict:
    """The quantum path's CUDA graphs against its eager path, 2 layers of
    the 1B width in f32, dense and int8 weights over int8 KV, at
    ``pipeline_depth`` 0 and 1: identical greedy tokens and identical
    kernel launches, and so identical launches per decode step and per
    prefill chunk."""
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
    from distributed_inference_server_tpu_torch.ops import kernels
    from distributed_inference_server_tpu_torch.ops.quant import (
        quantize_params,
    )

    cfg = LLAMA_3_2_1B.with_overrides(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dense = llama.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    tok = ByteTokenizer()
    waves = [["graph path against eager path", "g" * 300, "short"],
             ["graph path against eager path, again", "after a table change"]]
    out = {}
    for weights, kv in (("none", "none"), ("int8", "int8")):
        params = quantize_params(dense, weights)
        for depth in (0, 1):
            runs = {}
            for graphs in (True, False):
                kernels.reset_launch_counts()
                eng = LLMEngine(params, cfg, tok, EngineConfig(
                    kv_quant=kv, pipeline_depth=depth), dtype=torch.float32,
                    device="cuda", _graphs=graphs)
                toks = {}
                for w, prompts in enumerate(waves):
                    for i, p in enumerate(prompts):
                        eng.add_request(f"w{w}r{i}", tok.encode(p),
                                        SamplingParams(max_tokens=20,
                                                       temperature=0.0))
                    while eng.has_work():
                        for o in eng.step():
                            if o.token_id is not None:
                                toks.setdefault(o.request_id, []).append(
                                    o.token_id)
                sc = eng.step_clock_stats()["kinds"]
                counts = {k: v for k, v in kernels.launch_counts().items()
                          if v}
                runs[graphs] = (toks, counts, sc, len(eng._graphs))
                del eng
            (gt, gc, gsc, ng), (et, ec, esc, _) = runs[True], runs[False]
            assert ng > 0, "the graph path captured no graph"
            assert gt == et, (weights, kv, depth, gt, et)
            assert gc == ec, (weights, kv, depth, gc, ec)
            steps = gsc["decode_block"]["dispatches"] * 8
            chunks = gsc["prefill"]["dispatches"]
            dec = "paged_decode_int8" if kv == "int8" else "paged_decode"
            out[f"{weights}+kv_{kv} depth {depth}"] = {
                "graphs": ng, "launches": gc,
                f"{dec}_per_decode_step": gc[dec] / steps,
                "paged_prefill_per_chunk": (gc.get("paged_prefill", 0)
                                            / chunks if chunks else None),
                "decode_step_ms_graph": gsc["decode_block"]["wall_s"] * 1e3
                / steps,
                "decode_step_ms_eager": esc["decode_block"]["wall_s"] * 1e3
                / (esc["decode_block"]["dispatches"] * 8),
            }
        del params
    log(json.dumps({"engine_f32_2layer_graphs":
                    "graph == eager greedy tokens and launches (dense, "
                    "int8 + int8 KV; depth 0 and 1)", "runs": out}))
    return out


def phase_engine_loop_mixed(seed: int = 0) -> dict:
    """2 layers of the 1B width in f32, dense and int8 weights over int8
    KV, greedy: looped blocks (WHILE-graph launches) against the eager
    loop and the fixed K-step path, identical tokens, the graph and eager
    loops identical launches and the same launches per decode step as the
    fixed path; then the mixed step (two chats mid-decode, a ~400-token
    prompt) captured against eager, in its K = 1 form and its K-block form
    under the loop, identical tokens and launches, and over int8 pools the
    kernel path against the plain path."""
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
    from distributed_inference_server_tpu_torch.ops import kernels
    from distributed_inference_server_tpu_torch.ops.quant import (
        quantize_params,
    )

    cfg = LLAMA_3_2_1B.with_overrides(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dense = llama.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    tok = ByteTokenizer()
    prompts = [("looped blocks against fixed blocks", 40),
               ("l" * 300, 24), ("short", 64)]
    chats = ["first chat of the mixed trace", "second chat"]
    long_prompt = ("a ~400-token prompt loading while the chats decode. "
                   * 8)[:400]

    def run(eng, trace):
        kernels.reset_launch_counts()
        toks = {}

        def step():
            for o in eng.step():
                if o.token_id is not None:
                    toks.setdefault(o.request_id, []).append(o.token_id)

        if trace == "loop":
            for i, (p, n) in enumerate(prompts):
                eng.add_request(f"r{i}", tok.encode(p),
                                SamplingParams(max_tokens=n,
                                               temperature=0.0))
        else:
            for i, p in enumerate(chats):
                eng.add_request(f"c{i}", tok.encode(p),
                                SamplingParams(max_tokens=24,
                                               temperature=0.0))
            for _ in range(3):
                step()
            eng.add_request("long", tok.encode(long_prompt),
                            SamplingParams(max_tokens=8, temperature=0.0))
        while eng.has_work():
            step()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        return toks, counts

    out = {}
    for weights, kv in (("none", "none"), ("int8", "int8")):
        params = quantize_params(dense, weights)
        dec = "paged_decode_int8" if kv == "int8" else "paged_decode"
        runs = {}
        for name, kw, graphs in (
                ("fixed", {}, True),
                ("loop-graph", {"loop_to_completion": True}, True),
                ("loop-eager", {"loop_to_completion": True}, False)):
            eng = LLMEngine(params, cfg, tok, EngineConfig(kv_quant=kv, **kw),
                            dtype=torch.float32, device="cuda",
                            _graphs=graphs)
            toks, counts = run(eng, "loop")
            sc = eng.step_clock_stats()["kinds"]
            steps = (eng.loop_stats()["steps"] if kw
                     else sc["decode_block"]["dispatches"] * 8)
            runs[name] = (toks, counts, eng.loop_stats(), steps,
                          sc["loop"]["dispatches"], len(eng._graphs))
            del eng
        (ft, fc, _, fsteps, _, _) = runs["fixed"]
        (gt, gc, gst, gsteps, gdisp, ng) = runs["loop-graph"]
        (et, ec, est, _, _, _) = runs["loop-eager"]
        assert ng > 0, "the loop captured no graph"
        assert gt == et == ft, (weights, kv, gt, et, ft)
        assert gc == ec and gst == est, (weights, kv, gc, ec, gst, est)
        assert gdisp == gst["blocks"], (gdisp, gst)
        per_step = gc[dec] / gsteps
        assert per_step == fc[dec] / fsteps == cfg.num_layers, (
            gc, gsteps, fc, fsteps)
        out[f"loop {weights}+kv_{kv}"] = {
            "loop_stats": gst, f"{dec}_per_decode_step": per_step,
            "fixed_decode_steps": fsteps, "loop_launches": gc}
        # the K-block form: looped blocks capped at one iteration keep
        # the chats mid-decode when the prompt lands (as the reference's
        # test does)
        for K_form, kw in (("K=1", {}), ("K-block", {
                "loop_to_completion": True, "loop_max_steps": 1})):
            mruns = {}
            for name, impl, graphs in (("graph", "kernel", True),
                                       ("eager", "kernel", False),
                                       ("plain", "plain", False)):
                if name == "plain" and kv == "none":
                    continue  # phase_engine_f32 holds dense kernel/plain
                eng = LLMEngine(params, cfg, tok, EngineConfig(
                    kv_quant=kv, mixed_step_tokens=128, attention_impl=impl,
                    **kw), dtype=torch.float32, device="cuda",
                    _graphs=graphs)
                toks, counts = run(eng, "mixed")
                mruns[name] = (toks, counts, eng.mixed_stats())
                del eng
            (gt, gc, gms), (et, ec, ems) = mruns["graph"], mruns["eager"]
            assert gt == et and gc == ec and gms == ems, (
                weights, kv, K_form, gt, et, gc, ec)
            assert gms["decode_tokens"] > 0 and gms["steps"] >= 3, gms
            if "plain" in mruns:
                assert mruns["plain"][0] == gt, (weights, kv, K_form)
            out[f"mixed {K_form} {weights}+kv_{kv}"] = {
                "mixed": gms, "launches": gc}
        del params
    log(json.dumps({"engine_f32_2layer_loop_mixed":
                    "loop graph == loop eager == fixed greedy tokens; mixed "
                    "graph == eager tokens and launches (K = 1 and K-block; "
                    "dense, int8 + int8 KV, whose kernel path == plain)",
                    "runs": out}))
    return out


def phase_engine_families(seed: int = 0) -> dict:
    """Each model family at 2 layers of its preset's width (gemma2-9b,
    qwen2-7b, mistral-7b, and mixtral-8x7b with int8 experts), random
    weights from the seed, on one trace (two chats mid-decode, then a
    ~400-token prompt) in three step modes: the quantum path, the mixed
    step and looped blocks. In f32 the kernels against the plain versions
    (identical greedy tokens; the kernel run launches the path's kernels,
    the plain run none); in bf16 the CUDA graphs against the eager path
    (identical tokens and launches: the D 256 and G 7 tensor-core bodies
    inside the captures). Then the sliding-window reclaim at mistral-7b's
    width: a ~4400-token prompt past the 4096-token window, kernels against
    plain versions, ``reclaim`` events > 0 and the page books balanced
    after every step."""
    from distributed_inference_server_tpu_torch.engine.engine import (
        EngineConfig,
        LLMEngine,
        SamplingParams,
    )
    from distributed_inference_server_tpu_torch.engine.kv_cache import (
        PagedCacheConfig,
    )
    from distributed_inference_server_tpu_torch.models.configs import (
        get_config,
    )
    from distributed_inference_server_tpu_torch.models.tokenizer import (
        ByteTokenizer,
    )
    from distributed_inference_server_tpu_torch.ops import kernels
    from distributed_inference_server_tpu_torch.ops.quant import (
        init_random_quantized,
        is_quantized,
    )

    def weights(cfg, dtype):
        """Random weights of the seed; at normal(0, 0.02) a 2-layer model
        repeats one token a row (Gemma-2's scaled, tied embedding outweighs
        the layers), so the attention projections are scaled by 4 (a
        quantized one's scales) and a scaled embedding is shrunk by
        sqrt(hidden): greedy tokens then vary, and the identities below
        see them."""
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = init_random_quantized(
            cfg, "int8" if cfg.is_moe else "none", gen, dtype=dtype,
            device="cuda")
        for k in ("wq", "wk", "wv", "wo"):
            w = params["layers"][k]
            (w.s if is_quantized(w) else w).mul_(4.0)
        if cfg.scale_embeddings:
            params["embed"].div_(cfg.hidden_size ** 0.5)
        return params

    tok = ByteTokenizer()
    chats = ["first chat of the family trace", "second chat"]
    long_prompt = ("a ~400-token prompt loading while the chats decode. "
                   * 8)[:400]
    modes = {"quantum": {}, "mixed": {"mixed_step_tokens": 128},
             "loop": {"loop_to_completion": True}}

    def run(eng, script, audit=False):
        kernels.reset_launch_counts()
        toks = {}

        def step():
            for o in eng.step():
                assert o.error is None, o.error
                if o.token_id is not None:
                    toks.setdefault(o.request_id, []).append(o.token_id)
            if audit:
                assert eng.audit_pages() == [], eng.audit_pages()

        for rid, text, n, wait in script:
            eng.add_request(rid, tok.encode(text),
                            SamplingParams(max_tokens=n, temperature=0.0))
            for _ in range(wait):
                step()
        while eng.has_work():
            step()
        return toks, {k: v for k, v in kernels.launch_counts().items() if v}

    def release():
        # an engine's captured graphs (and their private memory pools)
        # go with the engine, which reference cycles keep alive until a
        # collection; the earlier phases' engines too
        gc.collect()
        torch.cuda.empty_cache()

    trace = [("c0", chats[0], 24, 0), ("c1", chats[1], 24, 3),
             ("long", long_prompt, 8, 0)]
    out = {}
    release()
    for name in ("gemma2-9b", "qwen2-7b", "mistral-7b", "mixtral-8x7b"):
        cfg = get_config(name).with_overrides(num_layers=2)
        for dtype, pair in ((torch.float32, "kernel/plain"),
                            (torch.bfloat16, "graph/eager")):
            params = weights(cfg, dtype)
            for mode, kw in modes.items():
                runs = {}
                for side in pair.split("/"):
                    eng = LLMEngine(params, cfg, tok, EngineConfig(
                        attention_impl="plain" if side == "plain"
                        else "kernel", **kw), dtype=dtype, device="cuda",
                        _graphs=side != "eager")
                    runs[side] = run(eng, trace)
                    del eng
                    release()
                (at, ac), (bt, bc) = runs.values()
                assert at == bt, (name, pair, mode, at, bt)
                assert all(len(set(t)) > 1 for t in at.values()), (
                    name, pair, mode, "a row repeats one token", at)
                if pair == "graph/eager":
                    assert ac == bc, (name, mode, ac, bc)
                else:
                    assert not bc, (name, mode, "plain launched", bc)
                need = ["rms_norm", "rope",
                        "paged_ragged" if mode == "mixed" else "paged_decode"]
                if cfg.is_moe:
                    need.append("quant_matmul_q8")
                assert all(ac.get(k, 0) > 0 for k in need), (name, mode, ac)
                out[f"{name} {pair} {mode}"] = {"tokens": at,
                                                "launches": ac}
            del params
            release()
    phase_done("engine families kernel == plain, graph == eager")

    # the window reclaim at mistral-7b's width: one ~4400-token prompt (9
    # prefill chunks, the last ones past the 4096-token window) and a chat
    cfg = get_config("mistral-7b").with_overrides(num_layers=2)
    params = weights(cfg, torch.float32)
    prompt = ("the window reclaims pages behind it. " * 130)[:4400]
    script = [("long", prompt, 24, 2), ("chat", chats[0], 32, 0)]
    runs = {}
    for impl in ("kernel", "plain"):
        eng = LLMEngine(params, cfg, tok, EngineConfig(
            attention_impl=impl, paged=PagedCacheConfig(
                num_pages=1024, page_size=16, max_pages_per_seq=320)),
            dtype=torch.float32, device="cuda")
        toks, counts = run(eng, script, audit=True)
        runs[impl] = (toks, counts, eng.step_clock_stats()["events"])
        del eng
        release()
    (kt, kc, ke), (pt, pc, pe) = runs["kernel"], runs["plain"]
    assert kt == pt, ("reclaim", kt, pt)
    assert ke["reclaim"] > 0 and ke == pe, (ke, pe)
    assert kc.get("paged_decode", 0) > 0 and not pc, (kc, pc)
    out["mistral-7b reclaim"] = {"tokens": kt, "events": ke,
                                 "launches": kc}
    del params
    release()
    log(json.dumps({"engine_families_2layer":
                    "kernel == plain (f32) and graph == eager (bf16) greedy "
                    "tokens and launches, quantum / mixed / looped, every "
                    "family; mistral-width window reclaim", "runs": out}))
    return out


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
    "paged_ragged": ("cuda", "distributed_inference_server_tpu_torch/csrc/"
                     "paged_attention.cu",
                     "distributed_inference_server_tpu/ops/pallas/"
                     "paged_attention.py:843"),
    "rms_norm": ("triton", "distributed_inference_server_tpu_torch/ops/"
                 "kernels/_triton_fused.py",
                 "distributed_inference_server_tpu/ops/pallas/fused.py:90"),
    "rope": ("triton", "distributed_inference_server_tpu_torch/ops/kernels/"
             "_triton_fused.py",
             "distributed_inference_server_tpu/ops/pallas/fused.py:132"),
    "quant_matmul_q8": ("cuda", "distributed_inference_server_tpu_torch/csrc/"
                        "quant_matmul.cu",
                        "distributed_inference_server_tpu/ops/pallas/"
                        "fused.py:260"),
    "quant_matmul_q4": ("cuda", "distributed_inference_server_tpu_torch/csrc/"
                        "quant_matmul.cu",
                        "distributed_inference_server_tpu/ops/pallas/"
                        "fused.py:260"),
    "paged_decode_int8": ("cuda", "distributed_inference_server_tpu_torch/"
                          "csrc/paged_attention.cu",
                          "distributed_inference_server_tpu/ops/pallas/"
                          "paged_attention.py:546"),
}


# ---------------------------------------------------------------------------
# speculative decoding (phase 9) and the admission layer (phase 10)
# ---------------------------------------------------------------------------

# the verify forward's shape: B 8 rows of T = gamma + 1 = 5 queries from
# per-row q_start anywhere in the row (around a 16-token page edge, deep,
# and at the 2048-token capacity: capacity - 5 is 2043, so the last row
# starts at capacity - 3 and its last two queries lie past it, with
# kv_valid clamped to the capacity as the engine's verify forward does)
VERIFY_Q_START = [0, 15, 16, 17, 300, 1000, 2043, 2045]
VERIFY_T = 5


def verify_rows() -> int:
    """The rows of the verify forward's products: every decode slot's
    gamma + 1 tokens, max_batch * (num_draft_tokens + 1) at the engine's
    defaults (40)."""
    from distributed_inference_server_tpu_torch.engine.engine import (
        EngineConfig,
    )
    from distributed_inference_server_tpu_torch.engine.speculative import (
        SpecConfig,
    )

    return EngineConfig().max_batch * (SpecConfig().num_draft_tokens + 1)


def verify_cases(time_it=True) -> list:
    valid = [min(q + VERIFY_T, 2048) for q in VERIFY_Q_START]
    return [check_prefill(f"verify D{D} B8 T5", VERIFY_T, VERIFY_Q_START,
                          valid, D=D, time_it=time_it) for D in (64, 128)]


def phase_engine_spec(seed: int = 0) -> dict:
    """2 layers of the 1B width in f32, greedy, a draft of the same weights
    and one of another seed: speculative tokens == plain tokens on the
    fixed path (graphs, eager, and the plain versions), in looped blocks
    (WHILE graph, eager loop) and in the mixed step under the loop (graph
    against eager); graph launches == eager launches."""
    from distributed_inference_server_tpu_torch.engine.engine import (
        EngineConfig,
        LLMEngine,
        SamplingParams,
    )
    from distributed_inference_server_tpu_torch.engine.speculative import (
        SpecConfig,
    )
    from distributed_inference_server_tpu_torch.models import llama
    from distributed_inference_server_tpu_torch.models.configs import (
        LLAMA_3_2_1B,
    )
    from distributed_inference_server_tpu_torch.models.tokenizer import (
        ByteTokenizer,
    )
    from distributed_inference_server_tpu_torch.ops import kernels
    from distributed_inference_server_tpu_torch.ops.quant import (
        quantize_params,
    )

    cfg = LLAMA_3_2_1B.with_overrides(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    target = llama.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    other = llama.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    tok = ByteTokenizer()
    prompts = [("speculation against plain decoding", 40),
               ("s" * 300, 24), ("short", 48)]
    chats = ["first chat of the mixed trace", "second chat"]
    long_prompt = ("a ~400-token prompt loading while the chats decode. "
                   * 8)[:400]

    def run(eng, trace):
        kernels.reset_launch_counts()
        toks = {}

        def step():
            for o in eng.step():
                assert o.error is None, o.error
                if o.token_id is not None:
                    toks.setdefault(o.request_id, []).append(o.token_id)

        if trace == "mixed":
            for i, p in enumerate(chats):
                eng.add_request(f"c{i}", tok.encode(p), SamplingParams(
                    max_tokens=24, temperature=0.0))
            for _ in range(3):
                step()
            eng.add_request("long", tok.encode(long_prompt),
                            SamplingParams(max_tokens=8, temperature=0.0))
        else:
            for i, (p, n) in enumerate(prompts):
                eng.add_request(f"r{i}", tok.encode(p), SamplingParams(
                    max_tokens=n, temperature=0.0))
        while eng.has_work():
            step()
        assert eng.audit_pages() == [], eng.audit_pages()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        return toks, counts, eng.spec_stats()

    def engine(draft, graphs=True, **kw):
        return LLMEngine(target, cfg, tok, EngineConfig(**kw),
                         dtype=torch.float32, device="cuda", _graphs=graphs,
                         draft_params=draft,
                         draft_cfg=cfg if draft is not None else None,
                         spec=SpecConfig())

    out = {}
    plain, _, _ = run(engine(None), "loop")
    plain_mixed, _, _ = run(engine(None, mixed_step_tokens=128), "mixed")
    for dname, draft in (("same", target), ("other", other)):
        runs = {}
        for name, graphs, kw in (
                ("fixed-graph", True, {}),
                ("fixed-eager", False, {}),
                ("fixed-plain", False, {"attention_impl": "plain"}),
                ("loop-graph", True, {"loop_to_completion": True}),
                ("loop-eager", False, {"loop_to_completion": True})):
            eng = engine(draft, graphs, **kw)
            runs[name] = run(eng, "loop")
            del eng
        for name, (toks, _, _) in runs.items():
            assert toks == plain, (dname, name, toks, plain)
        for a, b in (("fixed-graph", "fixed-eager"),
                     ("loop-graph", "loop-eager")):
            assert runs[a][1] == runs[b][1], (dname, a, runs[a][1],
                                              runs[b][1])
            assert runs[a][2]["totals"] == runs[b][2]["totals"]
        mruns = {}
        for name, graphs in (("graph", True), ("eager", False)):
            eng = engine(draft, graphs, loop_to_completion=True,
                         mixed_step_tokens=128, loop_max_steps=1)
            mruns[name] = run(eng, "mixed")
            del eng
        assert mruns["graph"][0] == mruns["eager"][0] == plain_mixed, (
            dname, mruns["graph"][0], plain_mixed)
        assert mruns["graph"][1] == mruns["eager"][1]
        t = runs["fixed-graph"][2]["totals"]
        assert t["row_rounds"] > 0 and t["proposed"] > 0
        if dname == "same":
            assert t["accepted"] == t["proposed"], t
        out[dname] = {name: {"launches": r[1], "totals": r[2]["totals"]}
                      for name, r in {**runs, **{
                          f"mixed-loop-{k}": v for k, v in mruns.items()
                      }}.items()}
        gc.collect()
        torch.cuda.empty_cache()
    # int8 weights over int8 KV, as the 8B spec server: the verify's
    # products take quant_matmul_q8's prefill body at M = 40
    qtarget = quantize_params(target, "int8")
    qruns = {}
    for name, draft, graphs, impl in (
            ("plain-decoding", None, True, "kernel"),
            ("spec-graph", other, True, "kernel"),
            ("spec-plain", other, False, "plain"),
            # the quantized target as its own draft: proposals accepted,
            # so every verify row decides a token
            ("self-spec-graph", qtarget, True, "kernel"),
            ("self-spec-plain", qtarget, False, "plain")):
        eng = LLMEngine(qtarget, cfg, tok, EngineConfig(
            attention_impl=impl, kv_quant="int8"), dtype=torch.float32,
            device="cuda", _graphs=graphs, draft_params=draft,
            draft_cfg=cfg if draft is not None else None, spec=SpecConfig())
        qruns[name] = run(eng, "loop")
        del eng
    for name in ("spec-graph", "spec-plain", "self-spec-graph",
                 "self-spec-plain"):
        assert qruns[name][0] == qruns["plain-decoding"][0], (name, qruns)
        kernel = name.endswith("graph")
        counts = qruns[name][1]
        if kernel:
            assert counts.get("quant_matmul_q8", 0) > 0, counts
            assert counts.get("paged_decode_int8", 0) > 0, counts
        else:
            assert not counts, (name, counts)
        t = qruns[name][2]["totals"]
        assert t["row_rounds"] > 0 and t["proposed"] > 0, (name, t)
    t = qruns["self-spec-graph"][2]["totals"]
    assert t["accepted"] > 0, t
    out["int8+kv_int8"] = {name: {"launches": r[1],
                                  "totals": (r[2] or {}).get("totals")}
                           for name, r in qruns.items()}
    del qtarget
    log(json.dumps({"engine_f32_2layer_spec":
                    "spec tokens == plain tokens (fixed graph / eager / "
                    "plain, loop graph / eager, mixed under the loop graph "
                    "/ eager); graph launches == eager launches; int8 "
                    "weights + int8 KV: spec kernels == spec plain == "
                    "plain decoding",
                    "runs": out}))
    return out


def _spec_delta(before: dict, after: dict) -> dict:
    """Speculation traffic between two /server/stats readings."""
    a = before["worker_statuses"][0]["speculation"]["totals"]
    b = after["worker_statuses"][0]["speculation"]["totals"]
    return {k: b[k] - a[k] for k in b}


def _first_divergence(a: str, b: str):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def phase_serve_spec(card: str, seed: int, extra, label: str,
                     log_name: str, model: str, want=None,
                     required=QUANTUM_KERNELS, need_accepted=True,
                     draft_pool=None) -> dict:
    """A speculative server (``extra`` names the draft): the first mix's
    greedy prompts one at a time, the four-request mix and a lone repeat,
    counts zeroed just before the mix and read just after. Speculation
    must have run (rounds and accepted tokens above zero unless the
    trackers disabled it: then the rounds of the first launches still
    count), every kernel in ``required`` must launch, and ``POST
    /admin/speculation`` must reset one engine. Prints a ``spec_timing``
    line: acceptance and tokens per round over the mix, the spec block's
    step-clock ms, launches per spec block and, against ``want`` (the
    plain server's greedy texts, when given), each greedy text's first
    differing character (bf16: the verify forward is another chunk shape,
    so equality is not required). Returns the mix's launches."""
    with _server(seed, list(extra), log_name, model) as base:
        _, stats0 = _http("GET", base + "/server/stats")
        texts = greedy_texts(base)
        phase_done(f"{label}: startup and greedy texts")
        _, after_texts = _http("GET", base + "/server/stats")
        _reset_counts(base)
        _, before = _http("GET", base + "/server/stats")
        jobs = [(MIX_PROMPTS["p20"], GREEDY), (MIX_PROMPTS["p100"], GREEDY),
                (MIX_PROMPTS["p600"], GREEDY),
                (MIX_PROMPTS["p100"], {"temperature": 0.8, "top_p": 0.9,
                                       "max_tokens": 24})]
        def run_jobs():
            with cf.ThreadPoolExecutor(len(jobs)) as ex:
                return list(ex.map(lambda j: _gen(base, *j), jobs))

        t0 = time.monotonic()
        results = run_jobs()
        wall = time.monotonic() - t0
        st, again, lone = _gen(base, MIX_PROMPTS["p20"], GREEDY)
        _, after = _http("GET", base + "/server/stats")
        for (_, params), (st_, body, _) in zip(jobs, results):
            _check_generate(st_, body, params["max_tokens"])
        _check_generate(st, again, GREEDY["max_tokens"])
        launches = after["kernel_launches"]
        for name in required:
            assert launches[name] > 0, (label, name, launches)
        spec = after["worker_statuses"][0]["speculation"]
        whole = _spec_delta(stats0, after)
        mix = _spec_delta(before, after)
        assert whole["row_rounds"] > 0 and whole["proposed"] > 0, spec
        assert whole["accepted"] > 0 or not need_accepted, spec
        assert draft_pool is None or spec["draft_pool"] == draft_pool, spec
        sc0, sc1 = before["step_clock"], after["step_clock"]
        blocks = (sc1["kinds"]["decode_block"]["dispatches"]
                  - sc0["kinds"]["decode_block"]["dispatches"])
        chunks = (sc1["kinds"]["prefill"]["dispatches"]
                  - sc0["kinds"]["prefill"]["dispatches"])
        # the device's share and top kernels over 8 engine steps of the mix
        # run again and again (a spec block is one graph replay: the
        # profiler sees its kernels)
        prof = _profiled(base, run_jobs, steps=8, phase="spec")
        st, reset = _http("POST", base + "/admin/speculation",
                          {"action": "reset"})
        assert st == 200 and reset == {"status": "ok", "engines_reset": 1}, \
            reset
        rec = {
            "spec_timing": label, "card": card,
            "warmup_s": stats0["warmup_s"], "mix_wall_s": wall,
            "lone_request_s": lone,
            "acceptance_rate_mix": (mix["accepted"] / mix["proposed"]
                                    if mix["proposed"] else None),
            "tokens_per_round_mix": (mix["emitted"] / mix["row_rounds"]
                                     if mix["row_rounds"] else None),
            "totals_startup_to_end": whole, "totals_mix": mix,
            "trackers": {k: spec[k] for k in ("acceptance_rate",
                                              "estimated_speedup",
                                              "enabled", "patterns")},
            "draft_pool": spec["draft_pool"],
            "spec_block_ms": _clock_ms(sc0, sc1, "decode_block"),
            "spec_blocks": blocks, "prefill_chunks": chunks,
            "prefill_chunk_ms": _clock_ms(sc0, sc1, "prefill"),
            "launches": launches,
            "events": sc1["events"],
            "busy_share": prof["busy_share"],
            "device_busy_s": prof["device_busy_s"],
            "profile_window_s": prof["wall_s"],
            "top_device_ms": prof["top_device_ms"][:10],
            "graphs": (after.get("memory") or {}).get("graphs"),
            "max_allocated_bytes": (after.get("memory") or {}).get(
                "max_allocated_bytes"),
        }
        if want is not None:
            rec["greedy_first_divergence_vs_plain"] = {
                k: _first_divergence(texts[k], want[k]) for k in want}
        log(json.dumps(rec))
        assert after_texts["worker_statuses"][0]["speculation"][
            "totals"]["row_rounds"] > 0
        return {"launches": launches, "record": rec, "texts": texts}


def _lone_ttfts(base, n: int = 6) -> list:
    """Client TTFT (s) of ``n`` lone streamed greedy requests, one after
    another (the first token-bearing frame)."""
    out = []
    for i in range(n):
        res = _sse(base, "/generate", {"prompt": MIX_PROMPTS["p20"],
                                       "stream": True, **GREEDY})
        first = next(t for t, f in res["frames"]
                     if isinstance(f, dict) and f.get("type") == "token")
        out.append(first)
    return out


def _burst(base, prios):
    """One concurrent greedy request per entry of ``prios`` (its
    priority); each must answer 200 with 8 tokens. Returns the answers
    and the burst's wall."""
    t0 = time.monotonic()
    with cf.ThreadPoolExecutor(len(prios)) as ex:
        burst = list(ex.map(lambda i: _gen(base, f"burst {i} " * 3, {
            "priority": prios[i], "temperature": 0.0, "max_tokens": 8}),
            range(len(prios))))
    wall = time.monotonic() - t0
    for st, body, _ in burst:
        _check_generate(st, body, 8)
    return burst, wall


def phase_admission(card: str, seed: int, base: str) -> dict:
    """On an already-running llama-3.2-1b server (the reference's
    admission defaults): the queue tier must be native; lone streamed TTFT
    at the 50 ms batching window; a burst of 24 requests of mixed
    priorities must all answer 200; then a second server with
    ``--batcher-window-ms 0`` gives the lone TTFT without the window, and
    a third with ``--queue-tenant-fairness true`` (the Python tier) the
    lone TTFT and the burst on that tier. Prints one ``admission_timing``
    line."""
    _, stats = _http("GET", base + "/server/stats")
    adm = stats["admission"]
    assert adm["tier"] == "native", adm
    assert adm["window_ms"] == 50.0 and adm["max_batch_size"] == 32, adm
    lone = _lone_ttfts(base)
    prios = ["high", "normal", "low"] * 8
    burst, burst_wall = _burst(base, prios)
    by_prio = {p: sorted(r[2] for r, q in zip(burst, prios) if q == p)
               for p in ("high", "normal", "low")}
    _, after = _http("GET", base + "/server/stats")
    with _server(seed, ["--batcher-window-ms", "0"],
                 "server_window0.log") as base0:
        _, s0 = _http("GET", base0 + "/server/stats")
        assert s0["admission"]["window_ms"] == 0.0, s0["admission"]
        lone0 = _lone_ttfts(base0)
    # the Python tier at the same defaults: tenant fairness forces it (one
    # tenant here, so its lanes order requests as the native queue does)
    with _server(seed, ["--queue-tenant-fairness", "true"],
                 "server_python_tier.log") as base_py:
        _, spy = _http("GET", base_py + "/server/stats")
        assert spy["admission"]["tier"] == "python", spy["admission"]
        lone_py = _lone_ttfts(base_py)
        burst_py, burst_wall_py = _burst(base_py, prios)
    rec = {"admission_timing": "llama-3.2-1b bf16", "card": card,
           "tier": adm["tier"],
           "lone_ttft_ms_window50": [round(t * 1e3, 3) for t in lone],
           "lone_ttft_ms_window0": [round(t * 1e3, 3) for t in lone0],
           "lone_ttft_ms_python_tier": [round(t * 1e3, 3) for t in lone_py],
           "burst_requests": len(prios), "burst_wall_s": burst_wall,
           "burst_wall_s_python_tier": burst_wall_py,
           "burst_latency_s_max_python_tier": max(r[2] for r in burst_py),
           "burst_latency_s_by_priority": by_prio,
           "average_batch_size": after["average_batch_size"],
           "queue_after": after["admission"]["queue"]}
    log(json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# the KV byte paths (handoff, peer prefix, host tier, allocator, codec)
# ---------------------------------------------------------------------------

KV_RANK = 16  # --cache-latent-rank of the kvpaths phase
# the kernels every part of the kvpaths phase must launch (a handoff's
# import decodes on without a prefill); no other kernel may launch there
KVPATH_KERNELS = ("paged_prefill", "paged_decode", "rms_norm", "rope")
# the host-tier servers' pool: 64 pages of 16 tokens, so two ~600-token
# prompts evict a third's pages
HOST_TIER_PAGES = 64
HOST_TIER_BYTES = 268435456
CHURN_PROMPTS = [(f"Churn {i}: another long prompt pushes pages out. " * 14)
                 [:600] for i in range(2)]
PCIE_LANE_GBPS = {3: 0.985, 4: 1.969, 5: 3.938}  # per lane, each direction
# the H100 SXM's host link per its data sheet (PCIe Gen5 x16), for when
# nvidia-smi does not report the link
PCIE_NOMINAL = {"gen": 5, "width": 16, "nominal_gb_s": 63.01}


def _pcie(card_smi: str) -> dict:
    """Pinned host<->device copy rates of 256 MB (CUDA events, median of
    5) against the link's nominal rate from ``nvidia-smi``."""
    n = 256 << 20
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    out = {}
    for name, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        times = []
        for _ in range(6):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            dst.copy_(src, non_blocking=True)
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        ms = sorted(times[1:])[2]
        out[f"{name}_gb_s"] = round(n / ms / 1e6, 2)
    exe = shutil.which("nvidia-smi")
    link = dict(PCIE_NOMINAL, source="data sheet")
    if exe is not None:
        res = subprocess.run(
            [exe, "--query-gpu=pcie.link.gen.current,pcie.link.width.current",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        try:
            gen, width = (int(x) for x in res.stdout.split(",")[:2])
            link = {"gen": gen, "width": width,
                    "nominal_gb_s": round(PCIE_LANE_GBPS.get(gen, 0.0)
                                          * width, 2),
                    "source": "nvidia-smi"}
        except ValueError:  # e.g. "[N/A], [N/A]": the data sheet's
            link["nvidia_smi"] = res.stdout.strip() or res.stderr.strip()
    out["link"] = link
    return out


def _v1_logprobs(base: str, prompt: str):
    """A greedy ``/v1/completions`` with ``logprobs`` 0: (text, the sampled
    tokens' log-probabilities), which tells tokens apart where a random
    model's byte texts are mostly empty."""
    st, v1 = _http("POST", base + "/v1/completions",
                   {"prompt": prompt, **GREEDY, "logprobs": 0})
    assert st == 200, v1
    ch = v1["choices"][0]
    assert len(ch["logprobs"]["token_logprobs"]) >= 1, v1
    return ch["text"], ch["logprobs"]["token_logprobs"]


def phase_kvpaths(card: str, seed: int = 0) -> dict:
    """The KV byte paths on llama-3.2-1b (16 layers, 2048 wide, bf16,
    random weights from ``seed``), checks first, numbers after:

    (a) handoff: engine A takes each of the first mix's greedy prompts
        with ``prefill_only``; its export (monolithic raw; streamed in
        8-page chunks while A keeps decoding; the int8 and latent wires)
        imports into engine B (warmed up: its decode blocks are graph
        replays), which decodes on. raw and streamed: tokens identical to
        B's own cold run of the prompt (prefilled whole, then decoded);
        int8 and latent: agreement printed, byte ratios asserted. The
        decode kernel must launch over the imported pages.
    (b) peer prefix: A holds a ~1200-token prompt's pages; B imports them
        (``import_prefix`` of A's ``export_prefix_chunks``) and serves the
        prompt: B's tokens == A serving it warm from its own cache; the
        prefill kernel must launch on the tail.
    (c) the host tier served through ``/generate``: three 1B servers with
        a 64-page pool and a 256 MB host tier (``none``, ``int8``,
        ``latent`` at rank 16) and one at the defaults, started together:
        a prompt, two prompts that evict it, the prompt again; host hits
        > 0, pages demoted, the ``python`` allocator tier; for ``none``
        the repeat's greedy text and its tokens' log-probabilities
        (``/v1/completions``) == the default server's warm HBM hit.
    (d) the allocator: the default server reports the ``native`` tier; in
        process A (``native_allocator=False``) gives B's (native) greedy
        tokens for the mix.
    (e) A's and B's latent codecs (rank 16, each calibrated at
        construction) are bit-identical.

    Prints payload bytes per kind, export / import ms per MB (monolithic
    and streamed), the streamed stall, host-tier reload ms per page and
    PCIe rates in one ``kvpaths_timing`` line beside the card. Returns
    that line's fields and each part's launches: (a) B's decodes of the
    imports (decode, RMSNorm and RoPE, no prefill), (b) B's serve of the
    fetched prefix and (c) each host-tier server's repeat (the prefill
    kernel too); no other kernel may launch in any part."""
    import dataclasses

    import numpy as np

    from distributed_inference_server_tpu_torch.engine import kv_cache as kv
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
    from distributed_inference_server_tpu_torch.ops import kernels

    t_phase = time.monotonic()
    cfg = LLAMA_3_2_1B
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    tok = ByteTokenizer()
    ps = EngineConfig().paged.page_size

    def engine(**kw):
        return LLMEngine(params, cfg, tok, EngineConfig(**kw),
                         dtype=torch.bfloat16, device="cuda")

    def drain(eng, toks):
        while eng.has_work() and not eng.handoff_ready_ids():
            for o in eng.step():
                assert o.error is None, o.error
                if o.token_id is not None:
                    toks.append(o.token_id)
        return toks

    def cold(eng, rid, ids, n, prefill_only=False):
        eng.evict_cache(0.0)
        eng.add_request(rid, ids, SamplingParams(max_tokens=n,
                                                 temperature=0.0),
                        prefill_only=prefill_only)
        toks = drain(eng, [])
        assert eng.handoff_ready_ids() == ([rid] if prefill_only else [])
        return toks

    def synced(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, (time.monotonic() - t0) * 1000.0

    def first_divergence(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    None if len(a) == len(b) else min(len(a), len(b)))

    # each part's own launches: the counts are zeroed just before the part
    # and added up just after it
    path_launches = {part: dict.fromkeys(kernels.KERNELS, 0)
                     for part in ("handoff", "peer_prefix")}

    def counted(part, fn, *a):
        kernels.reset_launch_counts()
        out = fn(*a)
        for name, n in kernels.launch_counts().items():
            path_launches[part][name] += n
        return out

    def b_decode(toks):  # B decodes an imported sequence to its end
        stall = None
        while b.has_work():
            for o in b.step():
                assert o.error is None, o.error
                if o.token_id is not None:
                    if stall is None:
                        stall = time.monotonic()
                    toks.append(o.token_id)
        return stall

    a = engine(native_allocator=False, latent_rank=KV_RANK)
    b = engine(latent_rank=KV_RANK)
    # (e) codec determinism, (d) the tiers
    assert a.latent_codec is not None and b.latent_codec is not None
    assert np.array_equal(a.latent_codec.k_proj, b.latent_codec.k_proj)
    assert np.array_equal(a.latent_codec.v_proj, b.latent_codec.v_proj)
    assert (a.allocator_tier(), b.allocator_tier()) == ("python", "native")
    b.warmup()  # B's decode blocks and prefill chunks: graph replays
    log(f"[kvpaths] engines calibrated, B warmed up at "
        f"{time.monotonic() - t_phase:.1f} s")

    want, nbytes, timing, agree = {}, {}, {}, {}
    for name, prompt in MIX_PROMPTS.items():
        ids = tok.encode(prompt)
        want[name] = cold(b, f"ref-{name}", ids, 40)
        got = cold(a, f"d-{name}", ids, 40)
        assert got == want[name], ("(d) python tier != native tier", name,
                                   first_divergence(got, want[name]))
        # (a) monolithic raw
        got = cold(a, f"m-{name}", ids, 24, prefill_only=True)
        exp, t_exp = synced(a.export_handoff, f"m-{name}")
        _, t_imp = synced(b.import_sequence, exp)
        counted("handoff", b_decode, got)
        assert got == want[name][:24], ("(a) raw handoff", name,
                                         first_divergence(got, want[name]))
        if name == "p600":
            mb = len(exp.kv) / 1e6
            nbytes["raw"] = len(exp.kv)
            timing["export_ms_per_mb"] = round(t_exp / mb, 3)
            timing["import_ms_per_mb"] = round(t_imp / mb, 3)
        # (a) streamed, 8-page chunks, A decoding meanwhile
        got = cold(a, f"s-{name}", ids, 40, prefill_only=True)
        sess = a.export_handoff_begin(f"s-{name}", chunk_pages=8)
        assert sess is not None, name
        got += [o.token_id for o in a.step() if o.token_id is not None]
        _, t_pump = synced(a.export_handoff_pump, sess)
        isess = b.import_stream_open(f"s-{name}", len(sess.prefix_pages))
        _, t_add = synced(b.import_stream_add, isess, sess.chunks)
        got += [o.token_id for o in a.step() if o.token_id is not None]
        (exp, outs), t_fin = synced(a.export_handoff_finish, sess)
        assert exp is not None, name
        got += [o.token_id for o in outs if o.token_id is not None]
        tail = exp.kv_chunks[len(sess.chunks):]
        _, t_commit = synced(b.import_stream_commit, isess,
                             dataclasses.replace(exp, kv_chunks=tail))
        stall = (counted("handoff", b_decode, got) - exp.stalled_at) * 1e3
        assert got == want[name], ("(a) streamed handoff", name,
                                   first_divergence(got, want[name]))
        if name == "p600":
            pre_mb = sum(len(c.payload) for c in sess.chunks) / 1e6
            tail_mb = sum(len(c.payload) for c in tail) / 1e6
            timing["streamed"] = {
                "prefix_mb": round(pre_mb, 3), "tail_mb": round(tail_mb, 3),
                "pump_ms_per_mb": round(t_pump / pre_mb, 3),
                "import_add_ms_per_mb": round(t_add / pre_mb, 3),
                "finish_ms": round(t_fin, 3), "commit_ms": round(t_commit, 3),
                "stall_ms": round(stall, 3)}
        # (a) the lossy wires: agreement printed, bytes asserted
        for wire in ("int8", "latent", "latent_int8"):
            got = cold(a, f"{wire}-{name}", ids, 24, prefill_only=True)
            exp = a.export_handoff(f"{wire}-{name}", wire_quant=wire)
            assert exp.wire_quant == wire
            b.import_sequence(exp)
            counted("handoff", b_decode, got)
            ref = want[name][:24]
            agree[f"{wire} {name}"] = {
                "agree": sum(x == y for x, y in zip(got, ref)),
                "of": len(ref), "first_divergence": first_divergence(got,
                                                                     ref)}
            if name == "p600":
                nbytes[wire] = len(exp.kv)
    # each wire's bytes: the raw payload's times its encoded fraction (at D
    # 64 in bf16: int8 68 / 128, latent 2r / 128, latent_int8 (r + 4) / 128)
    for wire in ("int8", "latent", "latent_int8"):
        frac = kv.encoded_page_fraction(wire, a.state.k.element_size(),
                                        cfg.head_dim, KV_RANK)
        assert nbytes[wire] <= nbytes["raw"] * frac + 64 < nbytes["raw"], (
            wire, frac, nbytes)
    assert a.audit_pages() == [] and b.audit_pages() == []
    log(f"[kvpaths] (a) handoffs checked at {time.monotonic() - t_phase:.1f}"
        " s")

    # (b) peer prefix: B's tokens == A serving the prompt warm
    long_ids = tok.encode(("Long prompt chunked past the 512 bucket. " * 30)
                          [:1200])
    cold(a, "pf-cold", long_ids, 1)
    a.add_request("pf-warm", long_ids, SamplingParams(max_tokens=24,
                                                      temperature=0.0))
    warm_a = drain(a, [])
    hashes = kv.chain_hashes(long_ids, ps,
                             max_pages=(len(long_ids) - 1) // ps)
    (depth, chunks), t_pf_exp = synced(a.export_prefix_chunks, hashes,
                                       chunk_pages=8)
    assert depth == len(hashes), (depth, len(hashes))
    b.evict_cache(0.0)
    seated, t_pf_imp = synced(b.import_prefix, long_ids[: depth * ps],
                              chunks)
    assert seated == depth
    b.add_request("pf-b", long_ids, SamplingParams(max_tokens=24,
                                                   temperature=0.0))
    got = counted("peer_prefix", drain, b, [])
    assert got == warm_a, ("(b) peer prefix", first_divergence(got, warm_a))
    pf_mb = sum(len(c.payload) for c in chunks) / 1e6
    timing["prefix_fetch"] = {
        "pages": depth, "mb": round(pf_mb, 3),
        "export_ms_per_mb": round(t_pf_exp / pf_mb, 3),
        "import_ms_per_mb": round(t_pf_imp / pf_mb, 3)}
    assert a.audit_pages() == [] and b.audit_pages() == []
    del a, b
    gc.collect()

    # qpool payload bytes: 2 layers of the 1B width over int8 pools
    cfg2 = cfg.with_overrides(num_layers=2)
    q = LLMEngine(llama.init_params(cfg2, gen, dtype=torch.bfloat16,
                                    device="cuda"), cfg2, tok,
                  EngineConfig(kv_quant="int8"), dtype=torch.bfloat16,
                  device="cuda")
    p600 = tok.encode(MIX_PROMPTS["p600"])
    cold(q, "q", p600, 2, prefill_only=True)
    qexp = q.export_handoff("q", wire_quant="latent")  # native codes
    nbytes["qpool (2 layers)"] = len(qexp.kv)
    q.import_sequence(qexp)
    drain(q, [])
    assert q.audit_pages() == []
    per_vec = {  # K and V of one token, one layer, one KV head
        k: round(v / ((2 if k.startswith("qpool") else cfg.num_layers)
                      * len(p600) * 2 * cfg.num_kv_heads), 2)
        for k, v in nbytes.items()}
    del q
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[kvpaths] (b) peer prefix checked at "
        f"{time.monotonic() - t_phase:.1f} s")

    # (c) host-tier servers and (d) a default server, started together
    host = ["--engine-warmup-compile", "false", "--engine-num-pages",
            str(HOST_TIER_PAGES), "--cache-host-tier-bytes",
            str(HOST_TIER_BYTES)]
    tiers = {"none": [], "int8": [],
             "latent": ["--cache-latent-rank", str(KV_RANK)]}
    specs = [([], "server_kv_default.log", "llama-3.2-1b")] + [
        (host + ["--cache-host-tier-quant", t] + extra,
         f"server_kv_host_{t}.log", "llama-3.2-1b")
        for t, extra in tiers.items()]
    served = {}
    prompt = MIX_PROMPTS["p600"]
    with _servers(seed, specs) as bases:
        default, host_bases = bases[0], dict(zip(tiers, bases[1:]))
        _, st = _http("GET", default + "/server/stats")
        assert st["cache"]["allocator_tier"] == "native", st["cache"]
        _v1_logprobs(default, prompt)  # cold
        warm_hbm = _v1_logprobs(default, prompt)  # the warm HBM hit
        for t, base in host_bases.items():
            _v1_logprobs(base, prompt)
            for c in CHURN_PROMPTS:
                code, body, _ = _gen(base, c, GREEDY)
                _check_generate(code, body, GREEDY["max_tokens"])
            _reset_counts(base)
            repeat = _v1_logprobs(base, prompt)
            _, st = _http("GET", base + "/server/stats")
            c = st["cache"]
            host_stats = st["worker_statuses"][0]["host_tier"]
            metrics, _ = _get_text(base + "/metrics")
            prom = _parse_prom(metrics)
            host_hits = _prom_sum(prom, "kv_prefix_hits_total",
                                  "kv_prefix_hits_total", tier="host")
            assert c["allocator_tier"] == "python", c
            assert host_stats["offloads"] > 0, ("(c) nothing demoted", t, c)
            assert c["prefix_hits"]["host"] > 0 and host_hits > 0, (
                "(c) no host-tier hit", t, c)
            path_launches[f"host_tier {t}"] = st["kernel_launches"]
            if t == "none":
                assert repeat == warm_hbm, ("(c) host-tier reload != warm "
                                            "HBM hit", repeat, warm_hbm)
            served[t] = {
                "host_hit_pages": c["prefix_hits"]["host"],
                "reloads": c["reload_count"],
                "reload_ms_per_page": round(
                    c["reload_avg_ms"] * c["reload_count"]
                    / c["prefix_hits"]["host"], 4),
                "tier_pages": c["host_tier_pages"],
                "tier_bytes": c["host_tier_bytes"],
                "payload_bytes": c.get("payload_bytes"),
                "equals_warm_hbm": repeat == warm_hbm,
                "first_logprob_divergence": next(
                    (i for i, (x, y) in enumerate(zip(repeat[1],
                                                      warm_hbm[1]))
                     if x != y), None)}
    log(f"[kvpaths] (c) host-tier servers checked at "
        f"{time.monotonic() - t_phase:.1f} s")
    # an imported sequence decodes on (no prefill); a fetched or reloaded
    # prefix's tail prefills, then decodes
    for part, got in path_launches.items():
        need = KVPATH_KERNELS if part != "handoff" else tuple(
            k for k in KVPATH_KERNELS if k != "paged_prefill")
        for name in need:
            assert got[name] > 0, (f"kernel {name} never launched on the "
                                   f"kvpaths part {part}", got)
        for name in set(got) - set(need):
            assert got[name] == 0, (f"kernel {name} launched on the kvpaths "
                                    f"part {part}", got)
    log("[kvpaths] launches per part: " + json.dumps(path_launches))

    line = {"kvpaths_timing": {
        "card": card, "model": "llama-3.2-1b bf16 random weights",
        "latent_rank": KV_RANK, "payload_bytes_p600": nbytes,
        "payload_bytes_per_kv_vector": per_vec, **timing,
        "lossy_wire_agreement": agree, "host_tier": served,
        "pcie": _pcie(card), "phase_s": round(time.monotonic() - t_phase, 1)}}
    log(json.dumps(line))
    return {"timing": line["kvpaths_timing"], "launches": path_launches}


# ---------------------------------------------------------------------------
# phase 12: several replicas on one card
# ---------------------------------------------------------------------------

REPLICA_MODEL = "llama-3.2-1b"
# one engine's launches per forward at llama-3.2-1b (16 layers): one paged
# decode a layer per decode step, one paged prefill a layer per chunk, two
# RMSNorms a layer and the final one, RoPE on q and k a layer
ONE_B_PER_FORWARD = {"paged_decode": 16, "paged_prefill": 16,
                     "rms_norm": 2 * 16 + 1, "rope": 2 * 16}
# phase 4's one-engine server's launches per forward, when it ran
PER_FORWARD: dict = {}
# a prompt of 1901 ids: four 512-token prefill chunks, one an engine step,
# so its first token comes at the fourth step of its replica
LONG_PROMPT = ("Four chunks of prefill before the first token. " * 40)[:1900]
GREEDY64 = {"temperature": 0.0, "max_tokens": 64}
GREEDY192 = {"temperature": 0.0, "max_tokens": 192}
# 16 ids with BOS: one full page, so a handoff of it streams, and never a
# prefix hit (a match leaves at least one token to compute), so every run
# of it is cold: in bf16 a warm run prefills another chunk shape and may
# round differently (ROADMAP queue 3)
PAGE_PROMPT = "One page, cold."
# a 600-byte prompt sent once per server, for a cold lone TTFT
TTFT_PROMPT = "Cold TTFT: " + MIX_PROMPTS["p600"][11:]
ROUND_ROBIN_2 = ["--server-num-engines", "2", "--server-strategy",
                 "round_robin"]
PREFILL_DECODE = ["--server-num-engines", "2", "--server-engine-roles",
                  "prefill,decode"]


def _stats(base) -> dict:
    return _http("GET", base + "/server/stats")[1]


def _replicas(stats) -> dict:
    return {r["engine_id"]: r for r in stats["replicas"]}


def _greedy(base, prompt, params=GREEDY) -> str:
    st, body, _ = _gen(base, prompt, params)
    _check_generate(st, body, params["max_tokens"])
    return body["choices"][0]["text"]


def _mix(base) -> float:
    """The first mix's four concurrent requests (phase 4's jobs), each
    checked; returns the wall."""
    jobs = [(MIX_PROMPTS["p20"], GREEDY), (MIX_PROMPTS["p100"], GREEDY),
            (MIX_PROMPTS["p600"], GREEDY),
            (MIX_PROMPTS["p100"], {"temperature": 0.8, "top_p": 0.9,
                                   "max_tokens": 24})]
    t0 = time.monotonic()
    with cf.ThreadPoolExecutor(len(jobs)) as ex:
        results = list(ex.map(lambda j: _gen(base, *j), jobs))
    wall = time.monotonic() - t0
    for (_, params), (st, body, _) in zip(jobs, results):
        _check_generate(st, body, params["max_tokens"])
    return wall


def _replica_launches(stats) -> dict:
    return {eid: r["kernel_launches"] for eid, r in _replicas(stats).items()}


def _check_per_forward(label, before, after) -> dict:
    """Each replica that ran a decode step: its launches per forward
    (``_per_forward`` over its own step clock and launch tally) equal one
    engine's."""
    out = {}
    b = _replicas(before)
    for eid, r in _replicas(after).items():
        got = _per_forward(b[eid], r)
        out[eid] = got
        if got is None or not got.get("paged_decode"):
            continue
        want = {k: v for k, v in ONE_B_PER_FORWARD.items()
                if r["kernel_launches"][k]}
        assert {k: got[k] for k in want} == want, (label, eid, got)
        for one in PER_FORWARD.values():  # phase 4's one-engine server
            assert {k: got[k] for k in want} == {k: one[k] for k in want}, (
                label, eid, got, one)
    return out


def _mem(stats) -> int:
    """Device bytes allocated by the whole server process."""
    return stats["memory"]["allocated_bytes"]


def _wait(cond, what: str, timeout: float = 60.0, every: float = 0.1):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise RuntimeError(f"timed out after {timeout} s: {what}")
        time.sleep(every)
    return time.monotonic() - t0


def _handoffs(stats) -> dict:
    return dict((stats.get("disagg") or {}).get("handoffs") or {})


def _replicas_unified(card, base, texts, timing) -> dict:
    """(a) two unified replicas, round robin: the first mix, launches per
    decode step, the references the other parts compare with, the lone
    p600 TTFT, then ``POST /admin/scale`` 2 -> 3 -> 2 with a request in
    flight on the retired replica."""
    stats0 = _stats(base)
    _reset_counts(base)
    before = _stats(base)
    got = {name: _greedy(base, p) for name, p in MIX_PROMPTS.items()}
    assert got == texts, ("two-replica greedy texts differ from the "
                          "one-engine server's", got, texts)
    wall = _mix(base)
    after = _stats(base)
    processed = {w["engine_id"]: w["total_processed"]
                 for w in after["worker_statuses"]}
    assert all(n >= 1 for n in processed.values()) and len(processed) == 2, (
        processed)
    per = _check_per_forward("round robin pair", before, after)
    refs = {"page64": _greedy(base, PAGE_PROMPT, GREEDY64),
            "long": _greedy(base, LONG_PROMPT),
            "page192": _greedy(base, PAGE_PROMPT, GREEDY192)}
    stream = _native_stream(base, "/generate", {
        "prompt": TTFT_PROMPT, "stream": True, **GREEDY})
    refs["ttft"] = stream["text"]
    phase_done("replicas (a): round robin pair")

    # scale 2 -> 3 -> 2 with a request in flight on the retired replica
    mem2 = _mem(_stats(base))
    t0 = time.monotonic()
    st, body = _http("POST", base + "/admin/scale", {"num_engines": 3})
    scale_up_s = time.monotonic() - t0
    assert st == 200 and body["num_engines"] == 3, body
    stats3 = _stats(base)
    mem3 = _mem(stats3)
    assert mem3 > mem2, (mem2, mem3)
    jobs = []
    with cf.ThreadPoolExecutor(3) as ex:
        for _ in range(3):  # one admission batch each: one per replica
            jobs.append(ex.submit(_gen, base, PAGE_PROMPT, GREEDY192))
            time.sleep(0.08)

        def third_busy():
            h = _http("GET", base + "/health")[1]
            return any(e["engine_id"] == "engine-2"
                       and e["active_requests"] for e in h["engines"])

        _wait(third_busy, "a request on engine-2", 30, 0.01)
        st, body = _http("POST", base + "/admin/scale", {"num_engines": 2})
        assert st == 200 and body["num_engines"] == 2, body
        for fut in jobs:
            st, out, _ = fut.result()
            _check_generate(st, out, GREEDY192["max_tokens"])
            assert out["choices"][0]["text"] == refs["page192"], out
    release_s = _wait(
        lambda: _mem(_stats(base)) <= mem2 * 1.05,
        "the retired replica's memory released", 60, 0.2)
    mem_down = _mem(_stats(base))
    assert len(_stats(base)["replicas"]) == 2
    phase_done("replicas (a): scale 2 -> 3 -> 2")
    timing["round_robin"] = {
        "warmup_s": {e: r["warmup_s"]
                     for e, r in _replicas(stats0).items()},
        "mix_wall_s": wall, "processed": processed,
        "launches_per_forward": per,
        "lone_cold_600_byte_ttft_s": stream["ttft_s"],
        "scale_up_s": scale_up_s,
        "warmup_s_engine_2": _replicas(stats3)["engine-2"]["warmup_s"],
        "allocated_bytes_2_3_2": [mem2, mem3, mem_down],
        "scale_down_release_s": release_s}
    return {"refs": refs, "launches": {
        "unified": _sum_launches(after["replicas"])}}


def _sum_launches(replicas) -> dict:
    out: dict = {}
    for r in replicas:
        for k, v in r["kernel_launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def _replicas_disagg(card, base, texts, refs, timing) -> dict:
    """(b) a prefill/decode pair, streamed handoff: the first mix and a
    64-token request that streams, every decoded request handed off and
    finished on the decode replica, both audits clean, a lone cold
    600-byte prompt's TTFT and text (== (a)'s)."""
    stats0 = _stats(base)
    _reset_counts(base)
    got = {name: _greedy(base, p) for name, p in MIX_PROMPTS.items()}
    assert got == texts, ("prefill/decode greedy texts differ from the "
                          "one-engine server's", got, texts)
    wall = _mix(base)
    assert _greedy(base, PAGE_PROMPT, GREEDY64) == refs["page64"]
    stream = _native_stream(base, "/generate", {
        "prompt": TTFT_PROMPT, "stream": True, **GREEDY})
    assert stream["text"] == refs["ttft"], stream["text"]
    after = _stats(base)
    decoded = 3 + 4 + 1 + 1
    assert _handoffs(after) == {"ok": decoded}, after["disagg"]
    assert after["disagg"]["handoff_chunks"] > 0, after["disagg"]
    processed = {w["engine_id"]: (w["role"], w["total_processed"])
                 for w in after["worker_statuses"]}
    assert processed == {"engine-0": ("prefill", 0),
                         "engine-1": ("decode", decoded)}, processed
    launches = _replica_launches(after)
    assert launches["engine-0"]["paged_prefill"] > 0, launches
    assert launches["engine-1"]["paged_decode"] > 0, launches
    assert launches["engine-1"]["paged_prefill"] == 0, launches
    for r in after["replicas"]:
        assert r["audit"] == [], (r["engine_id"], r["audit"])
    fams = _parse_prom(_get_text(base + "/metrics")[0])
    n = _prom_sum(fams, "kv_handoff_latency_seconds",
                  "kv_handoff_latency_seconds_count")
    lat = _prom_sum(fams, "kv_handoff_latency_seconds",
                    "kv_handoff_latency_seconds_sum")
    h = after["handoff_s"]
    timing["prefill_decode"] = {
        "warmup_s": {e: r["warmup_s"]
                     for e, r in _replicas(stats0).items()},
        "mix_wall_s": wall, "lone_cold_600_byte_ttft_s": stream["ttft_s"],
        "handoffs": after["disagg"],
        "handoff_ms_per_request": {
            "export": h["export"] * 1e3 / max(1, h["exports"]),
            "channel": h["channel"] * 1e3 / decoded,
            "import": h["import"] * 1e3 / max(1, h["imports"]),
            "stall": after["disagg"]["handoff_stall_avg_ms"],
            "latency": lat * 1e3 / n if n else None},
        "handoff_bytes_per_request": after["disagg"]["handoff_bytes"]
        / decoded}
    phase_done("replicas (b): prefill/decode pair")
    return {"prefill": launches["engine-0"], "decode": launches["engine-1"]}


def _replicas_variant(base, texts, refs, label) -> dict:
    """(b) again with one handoff flag changed: the lone greedy prompts
    and a 64-token request, every one handed off."""
    got = {name: _greedy(base, p) for name, p in MIX_PROMPTS.items()}
    assert got == texts, (label, got, texts)
    assert _greedy(base, PAGE_PROMPT, GREEDY64) == refs["page64"]
    stats = _stats(base)
    assert _handoffs(stats) == {"ok": 4}, (label, stats["disagg"])
    for r in stats["replicas"]:
        assert r["audit"] == [], (label, r["engine_id"], r["audit"])
    phase_done(f"replicas (b): {label}")
    return stats["disagg"]


def _replicas_crash(card, base, texts, refs, timing) -> None:
    """(c) two unified replicas with ``runner.step:nth=3`` armed: a
    streamed request and the long prompt arrive in one admission batch on
    one replica; its third engine step crashes it. The streamed request
    had tokens: it ends with ``engine_crashed``; the long prompt had none:
    it runs again on the other replica with (a)'s text. The health loop
    restarts the dead replica, which then serves (a)'s texts with one
    engine's launches per forward; device memory is back where it was."""
    mem0 = _mem(_stats(base))
    with cf.ThreadPoolExecutor(2) as ex:
        streamed = ex.submit(_sse, base, "/generate", {
            "prompt": MIX_PROMPTS["p20"], "stream": True, **GREEDY64})
        time.sleep(0.01)  # the same 50 ms admission window
        long_job = ex.submit(_gen, base, LONG_PROMPT, GREEDY)
        frames = streamed.result()["frames"]
        t_crash = time.monotonic()
        st, body, _ = long_job.result()
    events = [d for _, d in frames if d != "[DONE]"]
    assert frames[-1][1] == "[DONE]", frames[-3:]
    assert any(d["type"] == "token" for d in events[:-1]), events
    assert events[-1]["type"] == "error", events[-1]
    assert events[-1]["code"] == "engine_crashed", events[-1]
    _check_generate(st, body, GREEDY["max_tokens"])
    assert body["choices"][0]["text"] == refs["long"], body

    def all_healthy():
        h = _http("GET", base + "/health")[1]
        return (len(h["engines"]) == 2
                and all(e["healthy"] for e in h["engines"]))

    healthy_s = _wait(all_healthy, "the crashed replica's restart", 120)
    stats = _stats(base)
    res = stats["resilience"]
    assert sum(res["engine_restarts"].values()) == 1, res
    assert res["redispatched"] == {"ok": 1}, res
    _reset_counts(base)
    before = _stats(base)
    for _ in range(2):  # round robin: one on each replica
        assert _greedy(base, MIX_PROMPTS["p20"]) == texts["p20"]
    after = _stats(base)
    per = _check_per_forward("restarted pair", before, after)
    assert all(p is not None for p in per.values()), per
    mem1 = _mem(after)
    assert abs(mem1 - mem0) <= 0.05 * mem0, (mem0, mem1)
    restarted = next(r for r in after["replicas"] if r["restarts"])
    timing["crash"] = {
        "crash_to_healthy_s": healthy_s,
        "restart_warmup_s": restarted["warmup_s"],
        "restarted": restarted["engine_id"],
        "allocated_bytes_before_after": [mem0, mem1],
        "launches_per_forward_after": per,
        "resilience": res}
    phase_done("replicas (c): crash, redispatch and restart")


def _replicas_fetch(card, base, texts, timing) -> dict:
    """(d) two replicas, cache_aware, ``sched.fetch_decision:nth=1``: the
    p600 prompt cold on one replica (the one-engine text), then again:
    its 37 cached pages are fetched to the cold replica, which prefills
    the tail; then a third time, a warm hit. The fetched run's text ==
    the warm hit's."""
    cold = _greedy(base, MIX_PROMPTS["p600"])
    assert cold == texts["p600"], cold
    _reset_counts(base)
    before = _stats(base)
    fetched = _greedy(base, MIX_PROMPTS["p600"])
    after = _stats(base)
    warm = _greedy(base, MIX_PROMPTS["p600"])
    assert fetched == warm, ("the fetched prefix's text differs from the "
                             "warm hit's", fetched, warm)
    served = {e: after["replicas"][i]["requests_finished"]
              - before["replicas"][i]["requests_finished"]
              for i, e in enumerate(r["engine_id"]
                                    for r in after["replicas"])}
    target = next(e for e, n in served.items() if n == 1)
    launches = _replica_launches(after)[target]
    assert launches["paged_prefill"] > 0, launches  # the tail
    fams = _parse_prom(_get_text(base + "/metrics")[0])
    ok = _prom_sum(fams, "kv_prefix_fetch_total", "kv_prefix_fetch_total",
                   outcome="ok")
    assert ok == 1, fams["kv_prefix_fetch_total"]
    cache = after["cache"]
    assert cache["route_decisions"].get("fetch") == 1, cache
    for r in after["replicas"]:
        assert r["audit"] == [], (r["engine_id"], r["audit"])
    timing["fetch"] = {"target": target, "peer_fetch": cache["peer_fetch"],
                       "route_decisions": cache["route_decisions"]}
    phase_done("replicas (d): forced peer prefix fetch")
    return launches


def phase_replicas(card: str, seed: int = 0, texts=None) -> dict:
    """Several llama-3.2-1b bf16 replicas on the card (random weights from
    ``seed``, ``EngineConfig`` defaults), in two rounds of servers started
    together: (a) and (b) (and a one-engine server for the reference
    texts when phase 4 did not run), then (b)'s two handoff variants, (c)
    and (d), the last three with warmup off where the part does not need
    it. Returns the launches per replica role and the timing line."""
    t_phase = time.monotonic()
    timing: dict = {}
    specs = [(ROUND_ROBIN_2, "server_replicas_rr.log", REPLICA_MODEL),
             (PREFILL_DECODE, "server_replicas_pd.log", REPLICA_MODEL)]
    if texts is None:
        specs.append(([], "server_replicas_one.log", REPLICA_MODEL))
    with _servers(seed, specs) as bases:
        if texts is None:
            texts = greedy_texts(bases[2])
        got = _replicas_unified(card, bases[0], texts, timing)
        refs, launches = got["refs"], got["launches"]
        launches.update(_replicas_disagg(card, bases[1], texts, refs,
                                         timing))
    cold = ["--engine-warmup-compile", "false"]
    specs = [
        (PREFILL_DECODE + ["--disagg-stream", "false"] + cold,
         "server_replicas_pd_mono.log", REPLICA_MODEL),
        (PREFILL_DECODE + ["--disagg-channel", "protowire"] + cold,
         "server_replicas_pd_wire.log", REPLICA_MODEL),
        (ROUND_ROBIN_2 + ["--faults-spec", "runner.step:nth=3",
                          "--server-health-check-interval-s", "0.2",
                          "--server-restart-backoff-s", "0.5"],
         "server_replicas_crash.log", REPLICA_MODEL),
        # the digest lives on the Python page allocator, which a host
        # tier takes; its depth covers the p600 prompt's 37 pages
        (["--server-num-engines", "2", "--server-strategy", "cache_aware",
          "--faults-spec", "sched.fetch_decision:nth=1",
          "--cache-host-tier-bytes", str(HOST_TIER_BYTES),
          "--cache-digest-depth", "64"] + cold,
         "server_replicas_fetch.log", REPLICA_MODEL)]
    with _servers(seed, specs) as (mono, wire, crash, fetch):
        timing["monolithic"] = _replicas_variant(mono, texts, refs,
                                                 "--disagg-stream false")
        timing["protowire"] = _replicas_variant(
            wire, texts, refs, "--disagg-channel protowire")
        _replicas_crash(card, crash, texts, refs, timing)
        launches["fetch_target"] = _replicas_fetch(card, fetch, texts,
                                                   timing)
    line = {"replicas_timing": {
        "card": card, "model": "llama-3.2-1b bf16 random weights",
        **timing, "launches_replicas": launches,
        "phase_s": round(time.monotonic() - t_phase, 1)}}
    log(json.dumps(line))
    return {"timing": line["replicas_timing"], "launches": launches}


# ---------------------------------------------------------------------------
# phase 13: configuration, control and observability
# ---------------------------------------------------------------------------

CONTROL_TOML = os.path.join("build", "control.toml")
# the families of /metrics that phase 13 requires (the reference's names)
CONTROL_FAMILIES = (
    "trace_spans_dropped_total", "request_phase_seconds",
    "slo_requests_total", "slo_goodput_tokens_total", "requests_shed_total",
    "engine_health_state", "health_transitions_total",
    "retry_budget_exhausted_total", "fleet_breaker_transitions_total")
# prompts of at most 15 bytes (16 ids with BOS): never a prefix hit, so
# every run of them is cold
SWAP_PROMPTS = ("Swap one here.", "Second prompt!")
SWAP_MID = "Swap mid-flight"
# the in-process server's pool: small, so a few prompts fill it with
# cached pages for the ladder's eviction rung
CONTROL_POOL = (160, 16, 128)
FILL_PROMPTS = [(f"Fill {i}: cached prefix pages for the eviction rung. "
                 * 20)[:1000] for i in range(3)]


def _control_toml(otlp_port: int, window_ms: float, strategy: str,
                  max_queue: int) -> str:
    """Phase 13's config file: the JAX schema's engine defaults (no
    ``[engine]`` section), queue and batcher values that the env and the
    CLI override, an SLO and the script's OTLP collector."""
    return f"""[model]
model_name = "llama-3.2-1b"
[server]
strategy = "{strategy}"
[queue]
high_watermark = 800
max_queue_size = {max_queue}
[batcher]
window_ms = {window_ms}
max_batch_size = 16
[slo]
ttft_ms = 5000.0
[tracing]
otlp_endpoint = "http://127.0.0.1:{otlp_port}/v1/traces"
"""


def _write_control_toml(*args) -> None:
    os.makedirs(os.path.dirname(CONTROL_TOML), exist_ok=True)
    tmp = CONTROL_TOML + ".tmp"
    with open(tmp, "w") as f:
        f.write(_control_toml(*args))
    os.replace(tmp, CONTROL_TOML)  # the atomic writer's idiom


def _http_any(method, url, body=None, timeout=600.0):
    """(status, headers, JSON body), an HTTP error's included."""
    if method == "POST":
        _count_post(url)
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


class _OtlpCollector:
    """A standard-library OTLP/HTTP collector on localhost: counts the
    spans it receives by name."""

    def __init__(self):
        import http.server
        import threading

        self.names: "collections.Counter" = collections.Counter()
        self.posts = 0
        owner = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server API
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n))
                owner.posts += 1
                for rs in body["resourceSpans"]:
                    for ss in rs["scopeSpans"]:
                        for sp in ss["spans"]:
                            owner.names[sp["name"]] += 1
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.srv.server_port
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()


def _control_mix(base):
    """Phase 4's four concurrent requests: [(body, client wall s)]."""
    jobs = [(MIX_PROMPTS["p20"], GREEDY), (MIX_PROMPTS["p100"], GREEDY),
            (MIX_PROMPTS["p600"], GREEDY),
            (MIX_PROMPTS["p100"], {"temperature": 0.8, "top_p": 0.9,
                                   "max_tokens": 24})]
    with cf.ThreadPoolExecutor(len(jobs)) as ex:
        results = list(ex.map(lambda j: _gen(base, *j), jobs))
    for (_, params), (st, body, _) in zip(jobs, results):
        _check_generate(st, body, params["max_tokens"])
    return [(body, wall) for _, body, wall in results]


def _control_observe(base, mix) -> dict:
    """(c) on the mix's requests: each request's span tree (the root
    ``request.generate`` and its ``engine.infer`` child, parent-linked)
    and flight-recorder timeline (phases summing to no more than the
    client's wall)."""
    spans = 0
    slack = []
    for body, wall in mix:
        rid = body["id"][len("cmpl-"):]
        st, _, tr = _http_any("GET", f"{base}/server/trace?request_id={rid}")
        assert st == 200, tr
        by_name = {s["name"]: s for s in tr["spans"]}
        root, eng = by_name["request.generate"], by_name["engine.infer"]
        assert eng["parent_id"] == root["span_id"], (root, eng)
        assert eng["trace_id"] == root["trace_id"]
        assert root["parent_id"] is None and root["status"] == "ok"
        spans += len(tr["spans"])
        st, _, tl = _http_any("GET", f"{base}/server/requests/{rid}")
        assert st == 200 and tl["status"] == "ok", tl
        total = sum(tl["phases"].values())
        assert abs(total - tl["wall_s"]) < 1e-3, tl
        assert total <= wall + 1e-3, (total, wall, tl)
        assert tl["trace_id"] == root["trace_id"]
        assert "slo" in tl, tl
        slack.append(wall - total)
    return {"spans": spans, "phase_sum_under_wall_s": slack}


def _allocated() -> tuple:
    """(bytes allocated, the same after dropping cuBLAS's workspaces).
    PyTorch keeps one cuBLAS workspace per (handle, stream) until the
    process ends; every engine has its own stream, so each engine built
    adds one (32 MiB on this card) that outlives it. The engines' own
    bytes are the second number."""
    gc.collect()
    torch.cuda.synchronize()
    raw = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return raw, torch.cuda.memory_allocated()


def _fingerprint(frames) -> list:
    """A greedy stream's tokens as (text, sampled logprob) pairs: random
    weights emit ids past the byte range, which decode to no text, so the
    logprobs are what tells two continuations apart."""
    return [(f["token"], round(f["logprob"], 4)) for _, f in frames
            if isinstance(f, dict) and f.get("type") == "token"
            and "logprob" in f]


def _stream_fp(base, prompt, max_tokens: int = 24) -> list:
    return _fingerprint(_sse(base, "/generate", {
        "prompt": prompt, "stream": True, "temperature": 0.0,
        "max_tokens": max_tokens})["frames"])


def _control_inprocess(seed: int) -> dict:
    """(d): an in-process server with a model resolver. The degradation
    ladder stepped by hand (its loop stopped), then the hot swaps."""
    from distributed_inference_server_tpu_torch.engine.engine import (
        EngineConfig,
        LLMEngine,
    )
    from distributed_inference_server_tpu_torch.engine.kv_cache import (
        PagedCacheConfig,
    )
    from distributed_inference_server_tpu_torch.models.configs import (
        get_config,
    )
    from distributed_inference_server_tpu_torch.models.tokenizer import (
        ByteTokenizer,
    )
    from distributed_inference_server_tpu_torch.ops.quant import (
        init_random_quantized,
    )
    from distributed_inference_server_tpu_torch.serving.batcher import (
        BatcherConfig,
    )
    from distributed_inference_server_tpu_torch.serving.server import (
        InferenceServer,
    )

    cfg = get_config("llama-3.2-1b")
    pool = PagedCacheConfig(*CONTROL_POOL)
    box: dict = {}

    def factory(quant: str, stream_after_warmup: bool = False):
        def make() -> LLMEngine:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            params = init_random_quantized(cfg, quant, gen,
                                           dtype=torch.bfloat16,
                                           device="cuda")
            if stream_after_warmup:
                # a model apart from the bf16 one (every logit 0, greedy
                # emits id 0 at logprob -log V): a request served by the
                # new model shows in its tokens
                params["final_norm"].zero_()
            eng = LLMEngine(params, cfg, ByteTokenizer(), EngineConfig(
                seed=seed, paged=pool, warmup_compile=not
                stream_after_warmup), dtype=torch.bfloat16, device="cuda")
            if stream_after_warmup:
                # warm up here, then start the streamed request and hand
                # the engine over once it decodes: the swap installs with
                # that request mid-flight on the old model
                eng.warmup()
                runner = box["server"].runner
                tokens0 = runner.tokens_generated
                box["stream"] = box["pool"].submit(
                    _sse, box["base"], "/generate", {
                        "prompt": SWAP_MID, "stream": True,
                        "temperature": 0.0, "max_tokens": 256})
                _wait(lambda: runner.tokens_generated > tokens0 + 8,
                      "the streamed request decodes", timeout=30,
                      every=0.002)
            return eng

        return make

    def broken():
        raise RuntimeError("weights corrupted")

    models = {"llama-3.2-1b": factory("none"),
              "llama-3.2-1b-int4": factory("int4", stream_after_warmup=True),
              "broken": broken}
    t0 = time.monotonic()
    server = InferenceServer(factory("none"), ByteTokenizer(),
                             "llama-3.2-1b",
                             batcher_config=BatcherConfig(window_ms=0.0),
                             model_resolver=models.__getitem__)
    server.start()
    startup_s = time.monotonic() - t0
    base = f"http://127.0.0.1:{server.serve('127.0.0.1', 0, block=False)}"
    box.update(base=base, server=server, pool=cf.ThreadPoolExecutor(1))
    out: dict = {"startup_s": startup_s}
    try:
        server.degradation.stop()  # stepped by hand below
        pre = [_stream_fp(base, p) for p in SWAP_PROMPTS]
        mid_ref = _stream_fp(base, SWAP_MID, 256)
        raw0, mem0 = _allocated()

        # the ladder: fill the pool with cached prefix pages first
        for p in FILL_PROMPTS:
            _greedy(base, p, {"temperature": 0.0, "max_tokens": 2})
        target = int(0.70 * pool.num_pages)
        rungs = []
        for pressure in (0.75, 0.85, 0.92, 0.97, 0.5):
            level = server.degradation.evaluate(pressure=pressure)
            if pressure in (0.85, 0.97):
                _wait(lambda: server.runner.status().memory_used_pages
                      <= target, f"eviction to {target} pages", timeout=30)
            gates = {}
            for prio in ("low", "normal"):
                st, _, body = _http_any("POST", base + "/generate", {
                    "prompt": "gate probe.", "max_tokens": 2,
                    "temperature": 0.0, "priority": prio})
                gates[prio] = (st, (body.get("error") or {}).get("code"))
            rungs.append({
                "pressure": pressure, "level": level.name,
                "size_divisor": server.dispatcher.batcher.size_divisor,
                "pages_cached": server.runner.status().pages_cached,
                "gates": gates})
        log("[control] ladder: " + json.dumps(rungs))
        want = [("REDUCED_BATCH_SIZE", 2, 200, 200),
                ("AGGRESSIVE_CACHE_EVICTION", 2, 200, 200),
                ("REJECT_LOW_PRIORITY", 2, 503, 200),
                ("EMERGENCY", 2, 503, 503), ("NORMAL", 1, 200, 200)]
        got = [(r["level"], r["size_divisor"], r["gates"]["low"][0],
                r["gates"]["normal"][0]) for r in rungs]
        assert got == want, got
        assert rungs[0]["pages_cached"] > target, rungs  # the pool filled
        assert rungs[1]["pages_cached"] <= target, rungs  # evicted
        out["ladder"] = rungs

        # the swap to int4 with a streamed request in flight
        t = time.monotonic()
        ok, err = server.swap_model(models["llama-3.2-1b-int4"],
                                    model_name="llama-3.2-1b-int4")
        out["swap_to_int4_s"] = time.monotonic() - t
        assert ok, err
        frames = box.pop("stream").result(timeout=120)["frames"]
        mid = _fingerprint(frames)
        done = [f for _, f in frames if isinstance(f, dict)
                and f.get("type") == "done"]
        assert done and len(mid) == 256 and mid == mid_ref, (
            "the in-flight request left its old model's tokens")
        _wait(lambda: not server.runner._draining,
              "the old engine drained and released", timeout=60)
        server.reset_kernel_counts()
        int4 = [_stream_fp(base, p) for p in SWAP_PROMPTS]
        assert all(len(fp) == 24 for fp in pre + int4), (pre, int4)
        assert all(a != b for a, b in zip(int4, pre)), (
            "the new model's tokens", pre, int4)
        launches = server.kernel_counts()
        assert launches["quant_matmul_q4"] > 0, launches
        assert launches["quant_matmul_q8"] == 0, launches
        out["launches_int4"] = launches

        t = time.monotonic()
        ok, err = server.swap_by_name("broken")
        out["broken_swap_s"] = time.monotonic() - t
        assert not ok and "weights corrupted" in err, (ok, err)
        assert [_stream_fp(base, p) for p in SWAP_PROMPTS] == int4

        t = time.monotonic()
        ok, err = server.swap_model(models["llama-3.2-1b"],
                                    model_name="llama-3.2-1b")
        out["swap_back_s"] = time.monotonic() - t
        assert ok, err
        post = [_stream_fp(base, p) for p in SWAP_PROMPTS]
        assert post == pre, ("the swap back differs from the cold "
                             "pre-swap tokens", post, pre)
        _wait(lambda: not server.runner._draining, "drained", timeout=60)
        raw1, mem1 = _allocated()
        out.update(allocated_before=mem0, allocated_after=mem1,
                   allocated_change=(mem1 - mem0) / mem0,
                   allocated_with_cublas_workspaces=[raw0, raw1],
                   first_tokens={"bf16": [fp[:3] for fp in pre],
                                 "int4": [fp[:3] for fp in int4]})
        assert abs(mem1 - mem0) <= 0.01 * mem0, (mem0, mem1)
    finally:
        server.shutdown(drain_timeout_s=10.0)
        box["pool"].shutdown(wait=False)
        del server, box["server"]
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_control(card: str, seed: int = 0, texts=None) -> dict:
    """Phase 13 (see the module docstring). Returns the launches of the
    defaults server's mix and of the int4 engine's requests."""
    t_phase = time.monotonic()
    coll = _OtlpCollector()
    _write_control_toml(coll.port, 50.0, "least_loaded", 2000)
    env = {"DIS_TPU_QUEUE__HIGH_WATERMARK": "900"}
    specs = [(["--batcher-max-batch-size", "24"], "server_control.log",
              "llama-3.2-1b", CONTROL_TOML, env),
             (["--admission-deadline-ms", "1", "--engine-warmup-compile",
               "false"], "server_control_shed.log", "llama-3.2-1b")]
    timing: dict = {}
    try:
        with _servers(seed, specs) as (base, shed_base):
            timing["startup_s"] = time.monotonic() - t_phase
            # (a) precedence and the pool
            stats = _stats(base)
            adm, eng = stats["admission"], stats["engine"]
            assert adm["high_watermark"] == 900, adm  # env over the file
            assert adm["max_batch_size"] == 24, adm  # CLI over the file
            assert adm["window_ms"] == 50.0, adm  # the file
            assert (eng["max_batch"], eng["num_pages"],
                    eng["max_pages_per_seq"], eng["prefill_batch"],
                    eng["prefill_token_budget"]) == (64, 2048, 512, 16,
                                                     8192), eng
            assert stats["worker_statuses"][0]["memory_total_pages"] == 2048
            got_texts = greedy_texts(base)
            sent = len(got_texts)
            timing["texts_equal_phase4"] = (None if texts is None
                                            else got_texts == texts)
            if texts is not None and got_texts != texts:
                timing["texts_differing"] = sorted(
                    k for k in texts if got_texts[k] != texts[k])
            _reset_counts(base)
            before = _stats(base)
            t = time.monotonic()
            mix = _control_mix(base)
            timing["mix_wall_s"] = time.monotonic() - t
            sent += len(mix)
            after = _stats(base)
            launches = after["kernel_launches"]
            per = _per_forward(before, after)
            for k, v in ONE_B_PER_FORWARD.items():
                assert per[k] == v, ("launches per forward", k, per)
            timing["launches_per_forward"] = per
            st, _, body = _http_any("POST", base + "/generate", {
                "prompt": "x" * 40000, "max_tokens": 4})
            assert st == 400, (st, body)
            # (c) spans and timelines of the mix
            timing.update(_control_observe(base, mix))
            # (b) hot reload
            timing["lone_ttft_window_s"] = _lone_ttfts(base, 4)
            t = time.monotonic()
            _write_control_toml(coll.port, 0.0, "round_robin", 3000)
            _wait(lambda: _stats(base)["admission"]["window_ms"] == 0.0
                  and _stats(base)["strategy"] == "round_robin",
                  "the hot keys reloaded", timeout=3.0, every=0.05)
            timing["reload_s"] = time.monotonic() - t
            stats = _stats(base)
            assert stats["admission"]["max_queue_size"] == 2000, (
                "a non-hot key leaked into the running server",
                stats["admission"])
            assert stats["admission"]["high_watermark"] == 900
            timing["lone_ttft_no_window_s"] = _lone_ttfts(base, 4)
            sent += 8
            # (c) perf windows, SLO verdicts once per request, /metrics,
            # OTLP
            _, _, perf = _http_any("GET", base + "/server/perf")
            win = perf["windows"]
            assert win["ttft_ms"]["count"] == sent, (win, sent)
            assert win["tbt_ms"]["count"] >= sent - 1, win
            verdicts = sum(n for per_t in perf["slo"]["requests"].values()
                           for n in per_t.values())
            assert verdicts == sent, (perf["slo"], sent)
            timing["perf_windows"] = {k: win[k] for k in (
                "ttft_ms", "tbt_ms", "queue_wait_ms")}
            timing["slo"] = perf["slo"]["requests"]
            with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
                prom = r.read().decode()
            missing = [f for f in CONTROL_FAMILIES
                       if f"# TYPE {f} " not in prom]
            assert not missing, missing
            _wait(lambda: coll.names["request.generate"] >= sent,
                  "the mix's spans at the OTLP collector", timeout=15)
            timing["otlp_spans"] = dict(coll.names)
            timing["otlp_posts"] = coll.posts
            # the shedding server: 503 admission_shed once warm
            shed_at, shed = None, None
            for i in range(40):
                st, headers, body = _http_any("POST", shed_base + "/generate",
                                              {"prompt": f"shed {i}",
                                               "max_tokens": 2,
                                               "temperature": 0.0})
                if st == 503:
                    shed_at, shed = i, (headers, body)
                    break
                assert st == 200, (st, body)
            assert shed_at is not None and shed_at >= 8, shed_at
            assert shed[1]["error"]["code"] == "admission_shed", shed
            assert int(shed[0]["Retry-After"]) >= 1, shed[0]
            timing["shed_after_requests"] = shed_at
            timing["shed_stats"] = _stats(shed_base)["resilience"][
                "requests_shed"]
    finally:
        coll.close()
    phase_done("control (a)-(c)")
    timing["inprocess"] = _control_inprocess(seed)
    timing["phase_s"] = round(time.monotonic() - t_phase, 1)
    log(json.dumps({"control_timing": "llama-3.2-1b bf16 (and int4 after "
                    "the swap), random weights", "card": card, **timing}))
    return {"mix": launches, "int4": timing["inprocess"]["launches_int4"]}


# ---------------------------------------------------------------------------
# phase 14: multi-device parallelism over meshes on the one card
# ---------------------------------------------------------------------------

# llama-3-8b's per-shard attention heads under tensor 2 and 8: (tp, H, KV)
TP_SHARDS = ((2, 16, 4), (8, 4, 1))
PARALLEL_PROMPTS = ["tensor parallel identity",
                    "per-shard kernels against their plain versions " * 3,
                    "z" * 40]
# every kernel a tensor shard launches once per shard, and those launched
# once per forward whatever the shards (the replicated norms)
PER_SHARD = ("paged_decode", "paged_prefill", "paged_decode_int8", "rope",
             "quant_matmul_q8")
REPLICATED = ("rms_norm",)


def _tp_layer(tp: int) -> list:
    """One llama-3-8b layer's seven products on one of ``tp`` shards:
    column-parallel N / tp (wq, wk, wv, w_gate, w_up), row-parallel
    K / tp (wo, w_down)."""
    return [(name, K // tp if name in ("wo", "w_down") else K,
             N if name in ("wo", "w_down") else N // tp)
            for name, K, N in LAYER_8B]


def phase_parallel_kernels() -> dict:
    """Phase 3's attention kernels and the q8 layer at llama-3-8b's
    per-shard shapes (``tp_shards`` in the summary rows)."""
    lengths = [1, 15, 16, 17, 300, 1000, 2047, 2048]
    out = {"paged_decode": [], "paged_prefill": [], "paged_decode_int8": [],
           "quant_matmul_q8": []}
    for tp, H, KV in TP_SHARDS:
        tag = f"tp{tp} shard 8B H{H} KV{KV} D128"
        out["paged_decode"].append(
            check_decode(f"{tag} B8", lengths, H=H, KV=KV, D=128))
        out["paged_prefill"].append(check_prefill(
            f"{tag} B4 T512", 512, [0, 100, 1500, 0], [512, 400, 1537, 0],
            H=H, KV=KV, D=128))
    out["paged_decode_int8"].append(check_decode_int8(
        "tp2 shard 8B H16 KV4 D128 B8", lengths, H=16, KV=4, D=128))
    for M in (8, 2048):
        out["quant_matmul_q8"] += check_quant_layer(
            "tp2 shard llama-3-8b int8", M, _tp_layer(2), False)
    torch.cuda.empty_cache()
    for name, recs in out.items():
        for r in recs:
            log(json.dumps({"kernel_check": name, **r}))
    return out


def _drive_tokens(eng, prompts, max_tokens: int = 12) -> dict:
    """Greedy tokens of ``prompts`` through ``eng`` (all queued at once)."""
    from distributed_inference_server_tpu_torch.engine.engine import (
        SamplingParams,
    )

    for i, p in enumerate(prompts):
        eng.add_request(f"r{i}", list(p.encode()),
                        SamplingParams(max_tokens=max_tokens,
                                       temperature=0.0))
    toks: dict = {}
    for _ in range(4000):
        if not eng.has_work():
            break
        for o in eng.step():
            assert o.error is None, o.error
            if o.token_id is not None:
                toks.setdefault(o.request_id, []).append(o.token_id)
    assert not eng.has_work(), "the engine did not drain"
    return toks


def _mesh_run(params, cfg, axes: dict, prompts, max_tokens=12, **kw):
    """(greedy tokens, this thread's launches, engine) of an engine on a
    mesh of ``axes`` whose slots all name cuda:0 (no mesh for {}); the
    launch counts are zeroed just before the requests and read after."""
    from distributed_inference_server_tpu_torch.engine.engine import (
        EngineConfig,
        LLMEngine,
    )
    from distributed_inference_server_tpu_torch.models.tokenizer import (
        ByteTokenizer,
    )
    from distributed_inference_server_tpu_torch.ops import kernels
    from distributed_inference_server_tpu_torch.parallel.mesh import (
        MeshSpec,
        make_mesh,
    )

    mesh = None
    if axes:
        spec = MeshSpec(**axes)
        n = 1
        for size in spec.sizes():
            n *= size
        mesh = make_mesh(spec, devices=[torch.device("cuda", 0)] * n)
    eng = LLMEngine(params, cfg, ByteTokenizer(), EngineConfig(**kw),
                    dtype=torch.float32, device="cuda", mesh=mesh)
    kernels.reset_launch_counts()
    toks = _drive_tokens(eng, prompts, max_tokens)
    torch.cuda.synchronize()
    return toks, dict(kernels.thread_launch_counts()), eng


def _assert_shard_launches(label, tp: int, got: dict, base: dict) -> None:
    """The sharded engine launched each per-shard kernel tp times as often
    as the unsharded engine on the same requests, each replicated kernel
    as often."""
    for name in PER_SHARD + REPLICATED:
        want = base.get(name, 0) * (tp if name in PER_SHARD else 1)
        assert got.get(name, 0) == want, (label, name, got, base)


def phase_parallel_engines(seed: int = 0) -> dict:
    """Phase 14 (a) and (c): 2-layer engines on meshes over the one card
    against the unsharded engine, greedy tokens in f32."""
    from distributed_inference_server_tpu_torch.models import llama
    from distributed_inference_server_tpu_torch.models.configs import (
        LLAMA_3_2_1B,
        LLAMA_3_8B,
        MIXTRAL_8X7B,
    )
    from distributed_inference_server_tpu_torch.ops.quant import (
        init_random_quantized,
        quantize_params,
    )

    out: dict = {"launches": {}}
    cfg = LLAMA_3_8B.with_overrides(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    base = {}
    for tp in (1, 2, 4, 8):
        axes = {"tensor": tp} if tp > 1 else {}
        runs = {}
        for impl in ("kernel", "plain"):
            toks, counts, eng = _mesh_run(params, cfg, axes,
                                          PARALLEL_PROMPTS,
                                          attention_impl=impl)
            runs[impl] = (toks, counts)
            del eng
        assert runs["kernel"][0] == runs["plain"][0], (tp, runs)
        assert all(not v for v in runs["plain"][1].values()), runs["plain"]
        if tp == 1:
            base = runs["kernel"]
        else:
            assert runs["kernel"][0] == base[0], (tp, runs["kernel"][0],
                                                  base[0])
            _assert_shard_launches(f"tensor {tp}", tp, runs["kernel"][1],
                                   base[1])
        out["launches"][f"tensor {tp}"] = runs["kernel"][1]
        torch.cuda.empty_cache()
    for label, kw in (("tensor 2 looped", dict(loop_to_completion=True)),
                      ("tensor 2 mixed K=1", dict(mixed_step_tokens=128))):
        toks, counts, eng = _mesh_run(params, cfg, {"tensor": 2},
                                      PARALLEL_PROMPTS, **kw)
        assert toks == base[0], (label, toks, base[0])
        if "mixed_step_tokens" in kw:
            assert eng.mixed_stats()["steps"] > 0, eng.mixed_stats()
            assert counts.get("paged_ragged", 0) > 0, counts
        else:
            assert eng.loop_stats()["blocks"] > 0, eng.loop_stats()
        out["launches"][label] = counts
        del eng
    log(json.dumps({"parallel_f32_8b_width_2layer":
                    "tensor 1/2/4/8 kernel == plain == unsharded tokens; "
                    "looped and mixed at tensor 2 too",
                    "tokens": base[0]}))
    # int8 weights + int8 KV at tensor 2: the q8 bodies and the int8-pool
    # decode at the shard shapes
    qparams = quantize_params(params, "int8")
    del params
    q = {}
    for label, axes, impl in (("unsharded", {}, "kernel"),
                              ("tensor 2", {"tensor": 2}, "kernel"),
                              ("tensor 2 plain", {"tensor": 2}, "plain")):
        toks, counts, eng = _mesh_run(qparams, cfg, axes, PARALLEL_PROMPTS,
                                      attention_impl=impl, kv_quant="int8")
        q[label] = (toks, counts)
        del eng
    assert q["unsharded"][0] == q["tensor 2"][0] == q["tensor 2 plain"][0], q
    _assert_shard_launches("tensor 2 int8", 2, q["tensor 2"][1],
                           q["unsharded"][1])
    assert q["tensor 2"][1]["quant_matmul_q8"] > 0
    assert q["tensor 2"][1]["paged_decode_int8"] > 0
    out["launches"]["tensor 2 int8 + int8 KV"] = q["tensor 2"][1]
    del qparams
    torch.cuda.empty_cache()

    # (c) pipeline, sequence and expert parallelism
    cfg1 = LLAMA_3_2_1B.with_overrides(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    p1 = llama.init_params(cfg1, gen, dtype=torch.float32, device="cuda")
    long = ("a prompt past cp_min_tokens takes the sequence-parallel "
            "prefill, then decodes from its pages. " * 4)[:300]
    prompts = PARALLEL_PROMPTS + [long]
    ref, ref_counts, eng = _mesh_run(p1, cfg1, {}, prompts)
    del eng
    from distributed_inference_server_tpu_torch.parallel import cp

    real_cp = cp.cp_paged_prefill_any
    cp_calls = []

    def counted_cp(*a, **k):  # the engine imports it at each call
        cp_calls.append(tuple(a[3].shape))
        return real_cp(*a, **k)

    for label, axes, kw in (
            ("stage 2, 2 microbatches", {"stage": 2},
             dict(pp_microbatches=2)),
            ("seq 2 ring", {"seq": 2}, dict(cp_min_tokens=200)),
            ("seq 2 ulysses", {"seq": 2},
             dict(cp_min_tokens=200, sp_impl="ulysses"))):
        cp_calls.clear()
        cp.cp_paged_prefill_any = counted_cp
        try:
            toks, counts, eng = _mesh_run(p1, cfg1, axes, prompts, **kw)
        finally:
            cp.cp_paged_prefill_any = real_cp
        assert toks == ref, (label, toks, ref)
        assert eng.audit_pages() == []
        if "pp_microbatches" in kw:
            # every kernel once per microbatch of a forward
            for name in QUANTUM_KERNELS:
                assert counts[name] == 2 * ref_counts[name], (
                    label, name, counts, ref_counts)
        else:
            # the long prompt prefilled in one sequence-parallel pass (a
            # 512-token buffer), then decoded from the pages it wrote
            assert cp_calls == [(1, 512)], (label, cp_calls)
            assert counts["paged_decode"] > 0, (label, counts)
        out["launches"][label] = counts
        del eng
    del p1
    torch.cuda.empty_cache()
    cfgx = MIXTRAL_8X7B.with_overrides(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    px = init_random_quantized(cfgx, "int8", gen, dtype=torch.float32,
                               device="cuda")
    small = dict(max_batch=4, prefill_buckets=(64, 256), prefill_batch=2)
    ref, ref_counts, eng = _mesh_run(px, cfgx, {}, PARALLEL_PROMPTS, **small)
    del eng
    toks, counts, eng = _mesh_run(px, cfgx, {"expert": 2}, PARALLEL_PROMPTS,
                                  **small)
    assert eng.params.moe_impl == "ep"
    assert toks == ref, ("expert 2", toks, ref)
    assert counts["quant_matmul_q8"] > 0, counts
    out["launches"]["expert 2 (mixtral width, int8 experts)"] = counts
    del eng, px
    torch.cuda.empty_cache()
    log(json.dumps({"parallel_f32_2layer":
                    "stage 2 (2 microbatches), seq 2 ring and ulysses, "
                    "expert 2: unsharded tokens",
                    "launches": out["launches"]}))
    return out


def phase_parallel_served(card: str, seed: int = 0) -> dict:
    """Phase 14 (b): llama-3-8b int8 + int8 KV at full depth served in
    process over a tensor 2 mesh on the one card, at the other servers'
    engine settings."""
    from distributed_inference_server_tpu_torch.__main__ import (
        engine_settings,
        validator_settings,
    )
    from distributed_inference_server_tpu_torch.engine.engine import (
        LLMEngine,
    )
    from distributed_inference_server_tpu_torch.models.configs import (
        get_config,
    )
    from distributed_inference_server_tpu_torch.models.tokenizer import (
        load_tokenizer,
    )
    from distributed_inference_server_tpu_torch.ops.quant import (
        init_random_quantized,
    )
    from distributed_inference_server_tpu_torch.parallel.mesh import tp_mesh
    from distributed_inference_server_tpu_torch.serving.config import (
        ServerConfig,
    )
    from distributed_inference_server_tpu_torch.serving.server import (
        InferenceServer,
    )

    label = PARALLEL_8B
    cfg = ServerConfig.load(cli_args=[
        "--config", os.path.abspath(ENGINE_TOML), "--model-model-name",
        "llama-3-8b", "--model-quantization", "int8", "--engine-kv-quant",
        "int8"], environ={})
    ecfg = engine_settings(cfg, seed)
    mcfg = get_config("llama-3-8b")
    box: dict = {}

    def factory():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)  # the entry point's draw: phase 4's weights
        params = init_random_quantized(mcfg, "int8", gen,
                                       dtype=torch.bfloat16, device="cuda")
        eng = LLMEngine(params, mcfg, load_tokenizer(None), ecfg,
                        dtype=torch.bfloat16, device="cuda",
                        mesh=tp_mesh(2, devices=[torch.device("cuda", 0)]
                                     * 2))
        box["engine"] = eng
        return eng

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    server = InferenceServer(factory, load_tokenizer(None), "llama-3-8b",
                             queue_config=cfg.queue_config(),
                             batcher_config=cfg.batcher_config(),
                             validator_config=validator_settings(cfg))
    server.start()
    startup_s = time.monotonic() - t0
    base = f"http://127.0.0.1:{server.serve('127.0.0.1', 0, block=False)}"
    try:
        _, stats0 = _http("GET", base + "/server/stats")
        texts = greedy_texts(base)
        _reset_counts(base)
        _, before = _http("GET", base + "/server/stats")
        jobs = [(MIX_PROMPTS["p20"], GREEDY), (MIX_PROMPTS["p100"], GREEDY),
                (MIX_PROMPTS["p600"], GREEDY),
                (MIX_PROMPTS["p100"], {"temperature": 0.8, "top_p": 0.9,
                                       "max_tokens": 24})]
        t_all = time.monotonic()
        with cf.ThreadPoolExecutor(len(jobs)) as ex:
            results = list(ex.map(lambda j: _gen(base, *j), jobs))
        wall = time.monotonic() - t_all
        _, stats = _http("GET", base + "/server/stats")
        for (_, params), (st, body, _) in zip(jobs, results):
            _check_generate(st, body, params["max_tokens"])
        per = _per_forward(before, stats)
        # one engine's 32 layers, each shard its own launches
        want = {"paged_decode_int8": 2 * 32, "rope": 2 * 2 * 32,
                "rms_norm": 2 * 32 + 1, "quant_matmul_q8": 2 * 7 * 32}
        for name, n in want.items():
            assert per[name] == n, (name, per)
        assert not stats["kernel_launches"].get("paged_decode"), stats
        mem = stats.get("memory") or {}
        assert mem.get("graphs", 0) > 0, mem
        eng = box["engine"]
        pool_bytes = [
            sum(t.numel() * t.element_size()
                for t in (eng.state.k.data.parts[0][s],
                          eng.state.k.scale.parts[0][s],
                          eng.state.v.data.parts[0][s],
                          eng.state.v.scale.parts[0][s]))
            for s in range(2)]
        sc0, sc1 = before["step_clock"], stats["step_clock"]
        ref = SERVED_TEXTS.get(label)
        compare = {}
        if ref is not None:
            # texts (mostly empty for random weights: ids past the byte
            # range) and each greedy token's log-probability: the first
            # token whose log-probability moved by more than 1e-2, the gap
            # there and the largest gap (bf16 partials summed in shard
            # order)
            for name, prompt in MIX_PROMPTS.items():
                lps = _v1_logprobs(base, prompt)[1]
                want_lps = SERVED_LOGPROBS[label][name]
                gaps = [abs(a - b) for a, b in zip(lps, want_lps)]
                first = next((i for i, g in enumerate(gaps) if g > 1e-2),
                             None)
                compare[name] = {
                    "text_first_divergence": _first_divergence(
                        texts[name], ref[name]),
                    "logprob_first_divergence": first,
                    "logprob_gap_there": None if first is None
                    else gaps[first],
                    "max_logprob_gap": max(gaps, default=0.0),
                    "logprobs": [lps[:4], want_lps[:4]],
                }
        log(json.dumps({
            "parallel_timing": label + ", tensor 2 on [cuda:0] * 2 "
                                       "(in process)",
            "card": card, "startup_s": startup_s,
            "warmup_s": stats0["warmup_s"], "mix_wall_s": wall,
            "decode_step_ms": _clock_ms(sc0, sc1, "decode_block", 8),
            "prefill_chunk_ms": _clock_ms(sc0, sc1, "prefill"),
            "launches_per_forward": per, "graphs": mem.get("graphs"),
            "max_allocated_bytes": torch.cuda.max_memory_allocated(),
            "graph_pool_bytes": mem.get("graph_pool_bytes"),
            "pool_bytes_per_shard": pool_bytes,
            "texts_vs_phase4_8b_int8": compare or "phase 4 not run",
        }))
        return {"launches": stats["kernel_launches"], "texts": texts}
    finally:
        server.shutdown(drain_timeout_s=10.0)
        box.clear()
        gc.collect()
        torch.cuda.empty_cache()


def phase_parallel_entry(seed: int = 0) -> dict:
    """Phase 14 (d): ``--engine-tensor-parallel 2`` at the entry point.
    One card: exit 2 with the device-count error. Two or more: the first
    mix served over two cards."""
    n = torch.cuda.device_count()
    flags = ["--engine-tensor-parallel", "2"]
    if n >= 2:
        with _server(seed, flags, "server_tp2_two_cards.log") as base:
            texts = greedy_texts(base)
        log(json.dumps({"parallel_entry": "multi-card path ran: "
                        f"tensor 2 over two of {n} cards",
                        "texts": texts}))
        return {"ran": True}
    cmd = [sys.executable, "-m", "distributed_inference_server_tpu_torch",
           "--config", os.path.abspath(ENGINE_TOML), "--model-model-name",
           "llama-3.2-1b", "--server-port", str(_free_port()), *flags]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, (out.returncode, out.stderr[-2000:])
    assert "config error:" in out.stderr and \
        "needs 2 devices, have 1" in out.stderr, out.stderr[-2000:]
    log(json.dumps({"parallel_entry": "multi-card path did not run: one "
                    "card; --engine-tensor-parallel 2 exits 2 with "
                    + out.stderr.strip().splitlines()[-1]}))
    return {"ran": False}


# ---------------------------------------------------------------------------
# phase 15: the fleet's control plane across two processes
# ---------------------------------------------------------------------------

FLEET_MEMBER = "chip-member"
FLEET_FLAGS = ["--batcher-window-ms", "0", "--fleet-heartbeat-interval-s",
               "0.2"]
# a prompt no engine of the phase sees before the member's death: the
# member's cold pairs for it are what the redispatched request must give
KILL_PROMPT = "Zero tokens when the member dies."


def _pairs(base, prompt) -> list:
    """A greedy request's (text, sampled logprobs to 4 places)."""
    text, lps = _v1_logprobs(base, prompt)
    return [text, [round(x, 4) for x in lps]]


def _host_launches(host) -> int:
    return sum(_stats(host)["kernel_launches"].values())


def _routed(host, fn):
    """``fn()``'s result and whether the registry host sent it to the
    member: a request the host's own engine serves launches its kernels, a
    remote one launches none there."""
    n0 = _host_launches(host)
    out = fn()
    return out, _host_launches(host) == n0


def _until_routed(host, remote: bool, prompt=MIX_PROMPTS["p20"]) -> None:
    """Send greedy ``prompt`` until one lands where ``remote`` says, so
    that round robin sends the next request to the other engine."""
    for _ in range(2):
        if _routed(host, lambda: _greedy(host, prompt))[1] == remote:
            return
    raise AssertionError("round robin did not alternate host and member")


def _member_state(host):
    members = _stats(host)["fleet"]["members"]
    return next((m["state"] for m in members
                 if m["member_id"] == FLEET_MEMBER), None)


def _wait_member(host, proc, state: str, what: str) -> float:
    def ready():
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"the member exited with {proc.returncode}")
        return _member_state(host) == state
    return _wait(ready, what, 120.0, 0.02)


def _logged_at(log_name: str, needle: str) -> float:
    """The epoch seconds of the last line of a server's log (its
    ``%(asctime)s`` stamp, milliseconds) that holds ``needle``."""
    import datetime

    with open(os.path.join("chiprun_out", log_name)) as f:
        line = [ln for ln in f if needle in ln][-1]
    stamp = datetime.datetime.strptime(" ".join(line.split()[:2]),
                                       "%Y-%m-%d %H:%M:%S,%f")
    return stamp.timestamp()


def _stop_proc(proc, errlog) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    errlog.close()


def phase_fleet(card: str, seed: int = 0) -> dict:
    """Phase 15 (see the module docstring). Returns the member's launches
    over the remote-served greedy prompts and the timing line."""
    import signal

    t_phase = time.monotonic()
    timing: dict = {}
    fport = _free_port()
    host_flags = FLEET_FLAGS + ["--fleet-enabled", "true", "--fleet-port",
                                str(fport), "--server-strategy",
                                "round_robin"]
    member_flags = FLEET_FLAGS + ["--fleet-connect", f"127.0.0.1:{fport}",
                                  "--fleet-member-id", FLEET_MEMBER]
    remote_id = f"{FLEET_MEMBER}:engine-0"
    procs = []
    try:
        # 1. both processes started at once; the member redials until the
        # host listens
        t0 = time.monotonic()
        hproc, host, hlog = _launch(seed, host_flags, "server_fleet_host.log",
                                    REPLICA_MODEL)
        procs.append((hproc, hlog))
        mproc, member, mlog = _launch(seed, member_flags,
                                      "server_fleet_member.log",
                                      REPLICA_MODEL)
        procs.append((mproc, mlog))
        _wait_healthy(hproc, host, "server_fleet_host.log", t0)
        timing["host_healthy_s"] = time.monotonic() - t0
        _wait_healthy(mproc, member, "server_fleet_member.log", t0)
        _wait_member(host, mproc, "alive", "the member's join")
        timing["member_start_to_alive_s"] = time.monotonic() - t0
        phase_done("fleet: host and member up, member alive")

        # 2-3. the first mix's greedy prompts, one to each engine: the
        # member's pairs equal the host engine's, the host launches
        # nothing for the member's, the member one engine's launches
        _reset_counts(host)
        _reset_counts(member)
        m_before = _stats(member)
        pairs = {False: {}, True: {}}
        for name in ("p20", "p100", "p600"):
            for _ in range(2):
                got, remote = _routed(host,
                                      lambda: _pairs(host, MIX_PROMPTS[name]))
                assert name not in pairs[remote], (name, remote)
                pairs[remote][name] = got
        assert pairs[True] == pairs[False], pairs
        _wait(lambda: _stats(member)["requests_finished"]
              == m_before["requests_finished"] + 3,
              "the member's three requests", 10.0)
        m_after = _stats(member)
        launches = {k: v for k, v in m_after["kernel_launches"].items() if v}
        assert set(launches) == set(QUANTUM_KERNELS), launches
        per = _per_forward(m_before, m_after)
        assert {k: per[k] for k in ONE_B_PER_FORWARD} == ONE_B_PER_FORWARD, (
            per)
        assert m_after["device"] == torch.cuda.get_device_name(0), (
            m_after["device"])
        timing["remote_pairs_equal_local"] = True
        timing["member_launches"] = launches
        timing["member_launches_per_forward"] = per
        phase_done("fleet: remote serving and the member's kernels")

        # 4. lone streamed TTFT at the client, host engine against member
        ttft = {False: [], True: []}
        for _ in range(8):
            res, remote = _routed(host, lambda: _sse(host, "/generate", {
                "prompt": MIX_PROMPTS["p20"], "stream": True, **GREEDY}))
            ttft[remote].append(next(
                t for t, f in res["frames"]
                if isinstance(f, dict) and f.get("type") == "token"))
        assert len(ttft[True]) == len(ttft[False]) == 4, ttft
        local_ms = _pct(ttft[False], 0.5) * 1e3
        remote_ms = _pct(ttft[True], 0.5) * 1e3
        timing["lone_ttft_ms"] = {
            "local": [t * 1e3 for t in ttft[False]],
            "remote": [t * 1e3 for t in ttft[True]],
            "local_p50": local_ms, "remote_p50": remote_ms,
            "fleet_wire_share_p50": remote_ms - local_ms}

        # 5. one remote request's trace holds spans from both processes
        _until_routed(host, remote=False)
        body, remote = _routed(host, lambda: _gen(
            host, MIX_PROMPTS["p20"], GREEDY)[1])
        assert remote, "round robin did not send the request to the member"
        rid = body["id"][len("cmpl-"):]

        def tree():
            spans = _http("GET", host + f"/server/trace?request_id={rid}")[
                1]["spans"]
            by = {s["name"]: s for s in spans}
            return by if {"request.generate", "fleet.serve",
                          "engine.infer"} <= set(by) else None

        _wait(tree, "the member's spans at the host", 10.0)
        by = tree()
        root, serve, infer = (by["request.generate"], by["fleet.serve"],
                              by["engine.infer"])
        assert "member" not in root["attributes"], root
        assert serve["attributes"]["member"] == FLEET_MEMBER, serve
        assert infer["attributes"]["member"] == FLEET_MEMBER, infer
        assert serve["parent_id"] == root["span_id"], (root, serve)
        assert infer["parent_id"] == serve["span_id"], (serve, infer)
        assert len({root["trace_id"], serve["trace_id"],
                    infer["trace_id"]}) == 1
        timing["trace_spans"] = {
            name: {"member": s["attributes"].get("member"),
                   "duration_ms": s["duration_ms"]}
            for name, s in sorted(by.items())}
        phase_done("fleet: lone latency and the stitched trace")

        # 6. the member stopped with a zero-token request in flight, then
        # killed: the request completes once, on the host's engine
        _until_routed(host, remote=False)
        kill_ref, remote = _routed(host, lambda: _pairs(host, KILL_PROMPT))
        assert remote, "the kill prompt's reference did not run remote"
        _until_routed(host, remote=False)
        red0 = _stats(host).get("resilience") or {}
        ok0 = (red0.get("redispatched") or {}).get("ok", 0)
        os.kill(mproc.pid, signal.SIGSTOP)
        done = {}

        def kill_request():
            done["pairs"] = _pairs(host, KILL_PROMPT)
            done["t"] = time.monotonic()

        with cf.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(kill_request)

            def in_flight():
                st = next(s for s in _stats(host)["worker_statuses"]
                          if s["engine_id"] == remote_id)
                return st["active_requests"] >= 1

            _wait(in_flight, "the request at the stopped member", 10.0,
                  0.01)
            t_kill, t_kill_wall = time.monotonic(), time.time()
            os.kill(mproc.pid, signal.SIGKILL)
            mproc.wait()
            timing["kill_to_exited_s"] = time.monotonic() - t_kill
            _wait_member(host, None, "dead", "the member read dead")
            fut.result()
        # when the host logged the death: polling /server/stats would add
        # the wait for its engine, busy with the redispatched request
        timing["kill_to_dead_s"] = _logged_at(
            "server_fleet_host.log", "-> dead") - t_kill_wall
        timing["kill_to_completed_s"] = done["t"] - t_kill
        assert done["pairs"] == kill_ref, (done["pairs"], kill_ref)
        stats = _stats(host)
        redispatched = (stats.get("resilience") or {}).get("redispatched",
                                                            {})
        assert redispatched.get("ok", 0) == ok0 + 1, redispatched
        assert not any(s["engine_id"] == remote_id
                       for s in stats["worker_statuses"]), stats
        assert stats["replicas"][0]["audit"] == [], stats["replicas"]
        prom = _get_text(host + "/metrics")[0]
        assert 'fleet_members{state="dead"} 1.0' in prom
        phase_done("fleet: kill and redispatch")

        # 7. the member restarts under its id: a rejoin, and it serves
        t_restart = time.monotonic()
        mproc, member, mlog = _launch(seed, member_flags,
                                      "server_fleet_member_rejoin.log",
                                      REPLICA_MODEL)
        procs.append((mproc, mlog))
        _wait_member(host, mproc, "alive", "the member's rejoin")
        timing["restart_to_alive_s"] = time.monotonic() - t_restart
        stats = _stats(host)
        fleet = stats["fleet"]
        assert fleet["heartbeats"].get("rejoin", 0) == 1, fleet
        # the host's health scorer may have demoted its own engine by now
        # (the redispatched request's TTFT counts the member's stop), and
        # routing then prefers the member: send until one lands there
        timing["host_health_after_kill"] = {
            eid: [e.get("state"), e.get("reasons")] for eid, e in
            (stats["health"].get("engines") or {}).items()}
        for _ in range(2):
            again, remote = _routed(
                host, lambda: _pairs(host, MIX_PROMPTS["p20"]))
            if remote:
                break
        assert remote, "the rejoined member served nothing"
        assert again == pairs[False]["p20"], (again, pairs[False]["p20"])
        timing["heartbeats"] = fleet["heartbeats"]
        phase_done("fleet: rejoin")
    finally:
        for proc, errlog in procs:
            _stop_proc(proc, errlog)
    line = {"fleet_timing": {
        "card": card, "model": "llama-3.2-1b bf16 random weights, host and "
        "member processes on the one card", **timing,
        "role_balancer": "not driven here: host logic with nothing on the "
        "device, whose decode target needs the fleet's KV data plane "
        "(not ported); tests/test_torch_fleet.py and "
        "tests/test_torch_fleet_chaos.py (rerole_flap) cover it",
        "phase_s": round(time.monotonic() - t_phase, 1)}}
    log(json.dumps(line))
    return {"timing": line["fleet_timing"], "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="kernels,serve,quant,engine,ckpt,api,families,"
                            "spec,admission,kvpaths,replicas,control,"
                            "parallel,fleet")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--server-flags", default="",
                    help="flags added to every server started, split on "
                         "spaces (e.g. '--batcher-window-ms 0' with "
                         "--phases serve)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    SERVER_FLAGS[:] = args.server_flags.split()

    card = card_line()
    log(card)
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke needs one card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the plain versions' bf16 products keep f32 sums throughout
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    # informational: the port reads safetensors itself and needs
    # tokenizers only for a checkpoint that ships tokenizer.json
    log(json.dumps({"optional_packages": {
        name: importlib.util.find_spec(name) is not None
        for name in ("safetensors", "tokenizers")}}))

    from distributed_inference_server_tpu_torch.ops import kernels
    from distributed_inference_server_tpu_torch.ops.kernels import _build

    write_engine_toml()
    t0 = time.monotonic()
    built = _build.build_all(verbose=True)
    log(f"[build] {sorted(built)} in {time.monotonic() - t0:.1f} s")
    decode_report()
    attend_report()

    phase_done("build")
    checks = phase_kernels() if "kernels" in phases else {}
    phase_done("kernels")
    if "quant" in phases:
        checks.update(phase_quant_kernels())
        phase_done("quant kernels")
    if "families" in phases:
        for name, recs in phase_family_kernels().items():
            checks.setdefault(name, []).extend(recs)
        phase_done("family kernels")
    if "parallel" in phases:
        for name, recs in phase_parallel_kernels().items():
            checks.setdefault(name, []).extend(recs)
        phase_done("parallel kernels (per-shard shapes)")
    launches = {}
    texts = None
    serve_group = (_prestart(args.seed, SERVE_SERVERS) if "serve" in phases
                   else contextlib.nullcontext())
    with serve_group:
        if "serve" in phases:
            launches, texts = phase_serve(card, args.seed)
            # the ragged kernel's count is the mixed server's (the only
            # path that runs it)
            phase_done("serve")
            _, loop_texts = phase_serve(
                card, args.seed, extra=LOOPED_FLAGS,
                log_name="server_loop.log",
                label="llama-3.2-1b bf16 random weights, "
                      "--engine-loop-to-completion true")
            assert loop_texts == texts, ("looped server differs from the "
                                         "fixed server", loop_texts, texts)
            phase_done("serve looped")
            phase_loop_timing(card, args.seed)
            torch.cuda.empty_cache()
            phase_done("loop timing")
            launches["paged_ragged"] = phase_serve_mixed(
                card, args.seed)["paged_ragged"]
            phase_done("serve mixed")
            # looped blocks of at most 8 iterations keep the chats
            # decoding while the prompts load (uncapped, a chat's whole
            # budget is one block and the prompts find no decode row)
            phase_serve_mixed(
                card, args.seed, K_BLOCK_FLAGS,
                "llama-3.2-1b bf16 random weights, "
                "--engine-mixed-step-tokens 512 --engine-loop-to-completion "
                "true --engine-loop-max-steps 8 (K-block mixed step)",
                "server_mixed_loop.log")
            phase_done("serve mixed K-block")
    if "quant" in phases:
        # each quantized kernel's count is its server's
        torch.cuda.empty_cache()
        with _prestart(args.seed, QUANT_SERVER_SPECS):
            for label, model, flags, need, absent in QUANT_SERVERS:
                got, _ = phase_serve(card, args.seed, model, flags,
                                     f"server_{model}_{flags[1]}.log",
                                     label, need, absent,
                                     trace_phase="quant")
                for name in need:
                    if name.startswith(("quant_matmul",
                                        "paged_decode_int8")):
                        launches[name] = got[name]
                phase_done(f"serve {label}")
            phase_serve_mixed(
                card, args.seed, QUANT_8B_FLAGS,
                "llama-3-8b int8 weights + int8 KV, random weights, "
                "--engine-mixed-step-tokens 512",
                "server_llama-3-8b_mixed.log", "llama-3-8b",
                ("quant_matmul_q8", "paged_decode_int8", "rms_norm",
                 "rope"),
                ("paged_ragged", "paged_prefill", "paged_decode",
                 "quant_matmul_q4"), trace_phase="quant")
            phase_done("serve llama-3-8b int8 mixed")
    if "families" in phases:
        torch.cuda.empty_cache()
        for label, model, flags, need, absent, per in FAMILY_SERVERS:
            got, _ = phase_serve(card, args.seed, model, flags,
                                 f"server_{model}.log", label, need, absent,
                                 per, trace_phase="families")
            for name in need:  # each family server's own launches
                launches[f"{name} ({model})"] = got[name]
            phase_done(f"serve {label}")
    api_launches = {}
    spec_launches = {}
    kv_launches = {}
    if phases & {"ckpt", "api", "spec", "admission"}:
        if texts is None and "ckpt" in phases:
            # the random-weight server's texts to match
            with _server(args.seed, [], "server.log") as base:
                texts = greedy_texts(base)
        got = phase_checkpoint(card, args.seed, texts, api="api" in phases,
                               spec="spec" in phases,
                               admission="admission" in phases)
        api_launches, spec_launches = got["api"], got["spec"]
        phase_done("checkpoint, api, admission and spec 1B")
    if "spec" in phases:
        torch.cuda.empty_cache()
        spec_launches["llama-3-8b"] = phase_serve_spec(
            card, args.seed,
            ["--model-quantization", "int8", "--engine-kv-quant", "int8",
             "--model-draft-model-name", "llama-3.2-1b"],
            "llama-3-8b int8 weights + int8 KV, random llama-3.2-1b bf16 "
            "draft (int8 draft pool)", "server_spec_8b.log", "llama-3-8b",
            required=("quant_matmul_q8", "paged_decode_int8", "rms_norm",
                      "rope"), need_accepted=False,
            draft_pool="int8")["launches"]
        phase_done("serve spec llama-3-8b int8 + 1B draft")
    if "engine" in phases:
        phase_engine_f32(args.seed)
        phase_engine_quant_f32(args.seed)
        phase_done("engine kernel == plain")
        phase_engine_graphs(args.seed)
        phase_done("engine graph == eager")
        phase_engine_loop_mixed(args.seed)
        phase_done("engine loop and mixed graphs")
    if "spec" in phases:
        phase_engine_spec(args.seed)
        phase_done("engine spec == plain, graph == eager")
    if "families" in phases:
        phase_engine_families(args.seed)
        phase_done("engine families and window reclaim")
    if "kvpaths" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        kv_launches = phase_kvpaths(card, args.seed)["launches"]
        phase_done("kv byte paths")
    replica_launches = {}
    if "replicas" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        replica_launches = phase_replicas(card, args.seed, texts)[
            "launches"]
        phase_done("replicas")
    control_launches = {}
    if "control" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        control_launches = phase_control(card, args.seed, texts)
        phase_done("control")
    parallel_launches = {}
    if "parallel" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        parallel_launches = phase_parallel_engines(args.seed)["launches"]
        phase_done("parallel engines (tensor, stage, seq, expert)")
        parallel_launches["served llama-3-8b int8 tensor 2"] = \
            phase_parallel_served(card, args.seed)["launches"]
        phase_done("parallel served llama-3-8b int8 tensor 2")
        phase_parallel_entry(args.seed)
        phase_done("parallel entry point")
    fleet_launches = {}
    if "fleet" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        fleet_launches = phase_fleet(card, args.seed)["launches"]
        phase_done("fleet")

    rows = []
    for name, (route, source, replaces) in KERNEL_META.items():
        rec = (checks.get(name) or [{}])[0]
        row = {
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": launches.get(name),
            "max_abs_err": max((r["max_abs_err"] for r in checks.get(name, [])),
                               default=None),
            "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"), "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms"),
        }
        if api_launches:  # the streamed and OpenAI routes' own launches
            row["launches_api"] = api_launches.get(name)
        for model, got in spec_launches.items():  # the spec servers' mixes
            row[f"launches_spec ({model})"] = got.get(name)
        if kv_launches:  # each KV byte path's own launches
            row["launches_kvpaths"] = {part: got.get(name)
                                       for part, got in kv_launches.items()}
        if replica_launches:  # phase 12's launches by replica role
            row["launches_replicas"] = {
                role: got.get(name) for role, got in replica_launches.items()}
        if control_launches:  # phase 13's mix and int4 requests
            row["launches_control"] = {
                part: got.get(name) for part, got in control_launches.items()}
        if parallel_launches:  # phase 14's meshes
            row["launches_parallel"] = {
                part: got.get(name) for part, got in parallel_launches.items()}
        if fleet_launches:  # phase 15's member, remote-served prompts
            row["launches_fleet"] = fleet_launches.get(name)
        shards = {r["case"]: {k: r.get(k) for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")}
            for r in checks.get(name, []) if r["case"].startswith("tp")}
        if shards:  # phase 14's per-shard shapes
            row["tp_shards"] = shards
        verify = {r["case"]: {k: r.get(k) for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")}
            for r in checks.get(name, []) if r["case"].startswith("verify")}
        if verify:  # the speculative verify forward's shape
            row["verify"] = verify
        d128 = next((r for r in checks.get(name, [])
                     if r["case"].startswith("D128") and "ms" in r), None)
        if d128 is not None:  # the same work at llama-3-8b's head size
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by"):
                row[f"{key}_d128"] = d128.get(key)
        if name.startswith("quant_matmul"):
            # the prefill regime: one layer's seven products at M = 2048
            pre = next((r for r in checks.get(name, [])
                        if r["case"].endswith("at M=2048, summed")), {})
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by"):
                row[f"{key}_prefill"] = pre.get(key)
            ver = next((r for r in checks.get(name, []) if r["case"].endswith(
                f"verify: the seven products of one layer at M="
                f"{verify_rows()}, summed")), None)
            if ver is not None:  # the verify forward's products (q8)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_by"):
                    row[f"{key}_verify"] = ver.get(key)
        fam = {r["case"]: {k: r.get(k) for k in (
            "ms", "plain_ms", "library_ms", "sdpa_nocap_ms", "bound_ms",
            "bound_by", "max_abs_err")}
            for r in checks.get(name, [])
            if r["case"].split()[0] in FAMILY_ATTN}
        if fam:  # the model families' shapes (phase_family_kernels)
            row["families"] = fam
        by_model = {k.split("(")[1][:-1]: v for k, v in launches.items()
                    if k.startswith(f"{name} (")}
        if by_model:  # each family server's own launches
            row["launches_by_model"] = by_model
        rows.append(row)
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
