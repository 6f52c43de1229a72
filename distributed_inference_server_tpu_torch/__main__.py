"""Serve a model over HTTP: ``python -m distributed_inference_server_tpu_torch
--model-model-name llama-3.2-1b --server-port 8000 [--seed S]
[--model-model-dir DIR] [--device cuda|cpu] [--engine-mixed-step-tokens N]
[--model-quantization none|int8|int4] [--engine-kv-quant none|int8]
[--engine-pipeline-depth N] [--engine-warmup-compile true|false]
[--engine-loop-to-completion true|false] [--engine-loop-max-steps N]
[--model-draft-model-name NAME | --model-draft-model-dir DIR]
[--engine-num-draft-tokens G] [--queue-high-watermark N]
[--queue-low-watermark N] [--queue-request-timeout-s S]
[--queue-max-queue-size N] [--queue-tenant-fairness true|false]
[--queue-tenant-weights a=2,b=1] [--batcher-window-ms MS]
[--batcher-max-batch-size N] [--engine-num-pages N]
[--cache-host-tier-bytes B] [--cache-host-tier-quant
none|int8|latent|latent_int8] [--cache-latent-rank R]``.

With ``--model-model-dir`` the config and weights come from that HF
checkpoint directory (``models/loader.py load_checkpoint``) and the
tokenizer from its ``tokenizer.json`` (the byte tokenizer when it has
none), with the chat template of its ``tokenizer_config.json`` when it
has one; without it the weights are random, drawn from ``--seed``, for the
``--model-model-name`` preset (every family: llama-3.2-1b, llama-3-8b,
llama-3-70b, mistral-7b, qwen2-7b, gemma2-9b, mixtral-8x7b, and the tiny
test configs), with the byte tokenizer. The engine runs on ``cuda``
unless ``--device cpu`` is given; a missing card is an error.
``--model-quantization`` quantizes the seven linear families: a
checkpoint's after loading (``ops/quant.py quantize_params``, layer by
layer), a preset's as they are drawn (``init_random_quantized``: random
codes with no dense intermediate, so mixtral-8x7b's 93 GB bf16 tree never
exists); ``--engine-kv-quant int8`` keeps the KV pools as int8 codes +
scales. ``--engine-pipeline-depth`` (default 1) keeps that many decode
blocks in flight beyond the one being read; ``--engine-warmup-compile``
(default true) runs every serving program once, and on ``cuda`` captures
every CUDA graph, before the server reports ready.
``--engine-loop-to-completion`` (default false) runs pure-decode
iterations as run-to-completion looped blocks of at most
``--engine-loop-max-steps`` (default 256) iterations, one CUDA graph launch
each on ``cuda``, and the mixed step in its K-block form.

A draft model (``--model-draft-model-name`` for a random preset drawn from
its own generator, seeded ``--seed`` + 1, or ``--model-draft-model-dir``
for a checkpoint, loaded unquantized) turns on speculative decoding with
``--engine-num-draft-tokens`` (gamma, default 4) proposals a round; it
must share the target's vocabulary.

Requests pass the admission layer first (``serving/dispatcher.py``): a
priority queue with hysteresis backpressure (503 above
``--queue-high-watermark`` until below ``--queue-low-watermark``), a
``--queue-request-timeout-s`` expiry (408 ``queue_timeout``), optional
per-tenant fair lanes, and a batching window of ``--batcher-window-ms``
or ``--batcher-max-batch-size`` requests; the defaults are the
reference's. A bad value exits 2 with ``config error:``.

``--engine-num-pages`` sizes the KV page pool (default 1024 pages of 16
tokens). ``--cache-host-tier-bytes`` (default 0: off) keeps evicted prefix
pages in host RAM up to that many bytes, stored as
``--cache-host-tier-quant`` (latent encodings need ``--cache-latent-rank``
> 0, the rank of the latent page codec the engine calibrates at start);
the host tier runs on the Python page allocator (it needs the eviction
hook), otherwise the port's native C++ allocator is taken when it builds
(``/server/stats`` ``cache.allocator_tier``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys

import torch

from distributed_inference_server_tpu_torch.core.errors import ModelLoadError
from distributed_inference_server_tpu_torch.core.queue import (
    QueueConfig,
    parse_tenant_weights,
)
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    KV_QUANTS,
    LATENT_QUANTS,
    WIRE_QUANTS,
    PagedCacheConfig,
)
from distributed_inference_server_tpu_torch.engine.speculative import (
    SpecConfig,
)
from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.configs import (
    ModelConfig,
    get_config,
)
from distributed_inference_server_tpu_torch.models.loader import (
    config_from_hf_json,
    load_checkpoint,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    load_tokenizer,
)
from distributed_inference_server_tpu_torch.ops.quant import (
    MODES,
    init_random_quantized,
    quantize_params,
)
from distributed_inference_server_tpu_torch.serving.batcher import (
    BatcherConfig,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)
from distributed_inference_server_tpu_torch.utils.device import (
    dtype_from_name,
    resolve_device,
)


def _bool(text: str) -> bool:
    low = text.strip().lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def _dir_config(model_dir: str) -> ModelConfig:
    """The model config of an HF checkpoint directory's config.json."""
    with open(os.path.join(model_dir, "config.json")) as f:
        return config_from_hf_json(json.load(f))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_inference_server_tpu_torch",
        description="Serve /generate, /chat, /v1/*, /embeddings and "
                    "/metrics with the PyTorch/CUDA engine.")
    ap.add_argument("--model-model-name", default="llama-3.2-1b")
    ap.add_argument("--model-model-dir", default="",
                    help="HF checkpoint directory (config.json, "
                         "*.safetensors, optional tokenizer.json); empty = "
                         "random weights for --model-model-name")
    ap.add_argument("--model-dtype", default="bfloat16",
                    help="weights and KV pool dtype")
    ap.add_argument("--server-host", default="0.0.0.0")
    ap.add_argument("--server-port", type=int, default=8000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--engine-mixed-step-tokens", type=int, default=0,
                    help="packed width of the ragged mixed step (0 = off; "
                         "otherwise more than the engine's max_batch)")
    ap.add_argument("--model-quantization", default="none",
                    help="weight-only quantization: none | int8 | int4")
    ap.add_argument("--engine-kv-quant", default="none",
                    help="KV pool quantization: none | int8")
    ap.add_argument("--engine-pipeline-depth", type=int, default=1,
                    help="decode blocks in flight beyond the one being "
                         "read (0 = read each block right after launch)")
    ap.add_argument("--engine-warmup-compile", type=_bool, default=True,
                    help="run every serving program (and capture every "
                         "CUDA graph) before reporting ready")
    ap.add_argument("--engine-loop-to-completion", default="false",
                    help="run-to-completion looped decode blocks (one "
                         "dispatch per block; the mixed step advances "
                         "decode_block_size tokens per dispatch)")
    ap.add_argument("--engine-loop-max-steps", type=int, default=256,
                    help="iteration cap of one looped block (>= 1)")
    ap.add_argument("--model-draft-model-name", default="",
                    help="speculative decoding: a random draft model of "
                         "this preset (the target's vocabulary)")
    ap.add_argument("--model-draft-model-dir", default="",
                    help="speculative decoding: the draft model's HF "
                         "checkpoint directory")
    ap.add_argument("--engine-num-draft-tokens", type=int, default=4,
                    help="draft proposals per speculative round (gamma)")
    ap.add_argument("--queue-high-watermark", type=int, default=1000,
                    help="queued requests above which admission answers "
                         "503 queue_full")
    ap.add_argument("--queue-low-watermark", type=int, default=500,
                    help="queued requests below which admission resumes")
    ap.add_argument("--queue-request-timeout-s", type=float, default=30.0,
                    help="seconds a request may wait in the queue (then "
                         "408 queue_timeout)")
    ap.add_argument("--queue-max-queue-size", type=int, default=2000,
                    help="absolute cap on queued requests")
    ap.add_argument("--queue-tenant-fairness", default="false",
                    help="per-tenant fair admission lanes (deficit round "
                         "robin over the body's 'tenant'; Python queue "
                         "tier)")
    ap.add_argument("--queue-tenant-weights", default="",
                    help="DRR weights, 'tenantA=2,tenantB=1' (unlisted "
                         "tenants weigh 1)")
    ap.add_argument("--batcher-window-ms", type=float, default=50.0,
                    help="admission batching window after a batch's first "
                         "request")
    ap.add_argument("--engine-num-pages", type=int,
                    default=PagedCacheConfig().num_pages,
                    help="KV page pool size in pages")
    ap.add_argument("--cache-host-tier-bytes", type=int, default=0,
                    help="host-RAM prefix tier budget in bytes (0 = off)")
    ap.add_argument("--cache-host-tier-quant", default="none",
                    help="host-tier encoding: none|int8|latent|latent_int8")
    ap.add_argument("--cache-latent-rank", type=int, default=0,
                    help="latent page codec rank (0 = no codec)")
    ap.add_argument("--batcher-max-batch-size", type=int, default=32,
                    help="requests that close an admission batch early")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    try:
        loop = _bool(args.engine_loop_to_completion)
    except argparse.ArgumentTypeError as e:
        print(f"config error: engine.loop_to_completion: {e}",
              file=sys.stderr)
        return 2
    try:
        fair = _bool(args.queue_tenant_fairness)
    except argparse.ArgumentTypeError as e:
        print(f"config error: queue.tenant_fairness: {e}", file=sys.stderr)
        return 2
    ecfg = EngineConfig(seed=args.seed,
                        paged=PagedCacheConfig(
                            num_pages=args.engine_num_pages),
                        host_tier_bytes=args.cache_host_tier_bytes,
                        host_tier_quant=args.cache_host_tier_quant,
                        latent_rank=args.cache_latent_rank,
                        mixed_step_tokens=args.engine_mixed_step_tokens,
                        kv_quant=args.engine_kv_quant,
                        pipeline_depth=args.engine_pipeline_depth,
                        warmup_compile=args.engine_warmup_compile,
                        loop_to_completion=loop,
                        loop_max_steps=args.engine_loop_max_steps)
    model_dir = args.model_model_dir or None
    draft_dir = args.model_draft_model_dir or None
    draft_name = args.model_draft_model_name or None
    try:
        if draft_dir and draft_name:
            raise ValueError("set model.draft_model_name or "
                             "model.draft_model_dir, not both")
        if args.engine_num_draft_tokens < 1:
            raise ValueError("engine.num_draft_tokens must be >= 1")
        queue_cfg = QueueConfig(
            high_watermark=args.queue_high_watermark,
            low_watermark=args.queue_low_watermark,
            request_timeout_s=args.queue_request_timeout_s,
            max_queue_size=args.queue_max_queue_size,
            tenant_fairness=fair,
            tenant_weights=parse_tenant_weights(args.queue_tenant_weights))
        if not 0 <= queue_cfg.low_watermark <= queue_cfg.high_watermark:
            raise ValueError("queue watermarks need 0 <= low_watermark <= "
                             "high_watermark")
        if queue_cfg.max_queue_size < 1 or queue_cfg.request_timeout_s <= 0:
            raise ValueError("queue.max_queue_size must be >= 1 and "
                             "queue.request_timeout_s > 0")
        batcher_cfg = BatcherConfig(
            window_ms=args.batcher_window_ms,
            max_batch_size=args.batcher_max_batch_size)
        if batcher_cfg.window_ms < 0 or batcher_cfg.max_batch_size < 1:
            raise ValueError("batcher.window_ms must be >= 0 and "
                             "batcher.max_batch_size >= 1")
        if draft_dir and not os.path.isfile(
                os.path.join(draft_dir, "config.json")):
            raise ValueError(f"model.draft_model_dir {draft_dir!r} has no "
                             "config.json")
        if args.model_quantization not in MODES:
            raise ValueError(f"model.quantization must be none/int8/int4, "
                             f"got {args.model_quantization!r}")
        if ecfg.kv_quant not in KV_QUANTS:
            raise ValueError(f"engine.kv_quant must be none/int8, got "
                             f"{ecfg.kv_quant!r}")
        if ecfg.loop_max_steps < 1:
            raise ValueError("engine.loop_max_steps must be >= 1")
        if ecfg.mixed_step_tokens < 0:
            raise ValueError("engine.mixed_step_tokens must be >= 0")
        if ecfg.pipeline_depth < 0:
            raise ValueError("engine.pipeline_depth must be >= 0")
        if ecfg.paged.num_pages < 1:
            raise ValueError("engine.num_pages must be >= 1")
        if ecfg.host_tier_bytes < 0:
            raise ValueError("cache.host_tier_bytes must be >= 0")
        if ecfg.host_tier_quant not in WIRE_QUANTS:
            raise ValueError(
                f"cache.host_tier_quant must be none/int8/latent/"
                f"latent_int8, got {ecfg.host_tier_quant!r}")
        if ecfg.latent_rank < 0:
            raise ValueError("cache.latent_rank must be >= 0")
        if ecfg.latent_rank == 0 and ecfg.host_tier_quant in LATENT_QUANTS:
            raise ValueError(
                f"cache.host_tier_quant={ecfg.host_tier_quant!r} needs "
                "cache.latent_rank > 0 (the engine has no codec to encode "
                "with)")
        if model_dir and not os.path.isfile(
                os.path.join(model_dir, "config.json")):
            raise ValueError(f"model.model_dir {model_dir!r} has no "
                             "config.json")
        if 0 < ecfg.mixed_step_tokens <= ecfg.max_batch:
            raise ValueError(
                f"engine.mixed_step_tokens must exceed engine.max_batch "
                f"({ecfg.max_batch}): the packed width holds every decode "
                "slot plus at least one prefill token")
        device = resolve_device(args.device)
        cfg = (_dir_config(model_dir) if model_dir
               else get_config(args.model_model_name))
        draft_cfg = (_dir_config(draft_dir) if draft_dir
                     else get_config(draft_name) if draft_name else None)
        if draft_cfg is not None and draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"the draft model's vocabulary ({draft_cfg.vocab_size}) "
                f"differs from the target's ({cfg.vocab_size})")
        if draft_cfg is not None and (ecfg.mixed_step_tokens
                                      and not ecfg.loop_to_completion):
            raise ValueError(
                "engine.mixed_step_tokens with a draft model needs "
                "engine.loop_to_completion")
        dtype = dtype_from_name(args.model_dtype)
        tokenizer = load_tokenizer(model_dir)
    except (RuntimeError, KeyError, ValueError, ModelLoadError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2

    def engine_factory() -> LLMEngine:
        if model_dir:
            params, model_cfg = load_checkpoint(model_dir, dtype=dtype,
                                                device=device)
            params = quantize_params(params, args.model_quantization)
        else:
            model_cfg = cfg
            gen = torch.Generator(device=device)
            gen.manual_seed(args.seed)
            params = init_random_quantized(model_cfg,
                                           args.model_quantization, gen,
                                           dtype=dtype, device=device)
        draft_params = spec = None
        draft_model_cfg = draft_cfg
        if draft_dir:
            draft_params, draft_model_cfg = load_checkpoint(
                draft_dir, dtype=dtype, device=device)
        elif draft_name:
            # its own generator: the draft's draw differs from the target's
            dgen = torch.Generator(device=device)
            dgen.manual_seed(args.seed + 1)
            draft_params = llama.init_params(draft_cfg, dgen, dtype=dtype,
                                             device=device)
        if draft_params is not None:
            spec = SpecConfig(num_draft_tokens=args.engine_num_draft_tokens)
        return LLMEngine(params, model_cfg, tokenizer, ecfg, dtype=dtype,
                         device=device, draft_params=draft_params,
                         draft_cfg=draft_model_cfg, spec=spec)

    server = InferenceServer(engine_factory, tokenizer,
                             model_name=args.model_model_name,
                             queue_config=queue_cfg,
                             batcher_config=batcher_cfg)
    try:
        server.start()
    except (RuntimeError, TimeoutError) as e:
        print(f"startup error: {e}", file=sys.stderr)
        return 1

    def _stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _stop)
    print(f"serving {model_dir or args.model_model_name} on {device} at "
          f"{args.server_host}:{args.server_port}", flush=True)
    try:
        server.serve(args.server_host, args.server_port)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
