"""Serve a model over HTTP: ``python -m distributed_inference_server_tpu_torch
--model-model-name llama-3.2-1b --server-port 8000 [--seed S]
[--device cuda|cpu]``.

Weights are random, drawn from ``--seed`` (checkpoint loading is not
ported yet), and the tokenizer is the byte tokenizer. The engine runs on
``cuda`` unless ``--device cpu`` is given; a missing card is an error.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

import torch

from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
)
from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.configs import get_config
from distributed_inference_server_tpu_torch.models.tokenizer import (
    load_tokenizer,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)
from distributed_inference_server_tpu_torch.utils.device import (
    dtype_from_name,
    resolve_device,
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_inference_server_tpu_torch",
        description="Serve /generate with the PyTorch/CUDA engine.")
    ap.add_argument("--model-model-name", default="llama-3.2-1b")
    ap.add_argument("--model-dtype", default="bfloat16",
                    help="weights and KV pool dtype")
    ap.add_argument("--server-host", default="0.0.0.0")
    ap.add_argument("--server-port", type=int, default=8000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    try:
        device = resolve_device(args.device)
        cfg = get_config(args.model_model_name)
        dtype = dtype_from_name(args.model_dtype)
    except (RuntimeError, KeyError, ValueError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2
    tokenizer = load_tokenizer()
    ecfg = EngineConfig(seed=args.seed)

    def engine_factory() -> LLMEngine:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = llama.init_params(cfg, gen, dtype=dtype, device=device)
        return LLMEngine(params, cfg, tokenizer, ecfg, dtype=dtype,
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
    print(f"serving {args.model_model_name} on {device} at "
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
