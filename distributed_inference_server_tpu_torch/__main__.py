"""Serve a model over HTTP: ``python -m distributed_inference_server_tpu_torch
--model-model-name llama-3.2-1b --server-port 8000 [--seed S]
[--model-model-dir DIR] [--device cuda|cpu] [--engine-mixed-step-tokens N]
[--model-quantization none|int8|int4] [--engine-kv-quant none|int8]
[--engine-pipeline-depth N] [--engine-warmup-compile true|false]
[--engine-loop-to-completion true|false] [--engine-loop-max-steps N]``.

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
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys

import torch

from distributed_inference_server_tpu_torch.core.errors import ModelLoadError
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import KV_QUANTS
from distributed_inference_server_tpu_torch.models.configs import get_config
from distributed_inference_server_tpu_torch.models.loader import (
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
    ecfg = EngineConfig(seed=args.seed,
                        mixed_step_tokens=args.engine_mixed_step_tokens,
                        kv_quant=args.engine_kv_quant,
                        pipeline_depth=args.engine_pipeline_depth,
                        warmup_compile=args.engine_warmup_compile,
                        loop_to_completion=loop,
                        loop_max_steps=args.engine_loop_max_steps)
    model_dir = args.model_model_dir or None
    try:
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
        cfg = None if model_dir else get_config(args.model_model_name)
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
        return LLMEngine(params, model_cfg, tokenizer, ecfg, dtype=dtype,
                         device=device)

    server = InferenceServer(engine_factory, tokenizer,
                             model_name=args.model_model_name)
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
