"""The bytes one decode step of a served model must read, and the time
those bytes take at the H100's memory rate: the decode step's bytes bound.

Run from the root of a checkout (no card needed; it only counts)::

    python3 tools/torch_decode_bytes.py [--models gemma2-9b:none,...]

For each ``model:quantization`` (default: the model families' servers of
``chip_smoke.py`` and the llama servers) it counts, from the preset's
parameter shapes (``models/llama.py`` ``param_shapes``), what a decode
step of the port reads once: every layer's weights (bf16, or int8 /
packed int4 codes plus their f32 group scales for the seven linear
families, as ``quantize_params`` and ``init_random_quantized`` store
them; Mixtral's dense MoE reads every expert) and the f32 unembedding the
engine keeps (``unembed_weight_f32``). The embedding's gathered rows, the
KV cache and the activations are left out (a few MB at the served
batches). One JSON line per model on stdout.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
DEFAULT = ("gemma2-9b:none,qwen2-7b:none,mistral-7b:none,"
           "mixtral-8x7b:int8,llama-3-8b:int8,llama-3.2-1b:none,"
           "llama-3.2-1b:int4")


def decode_bytes(model: str, quant: str) -> dict:
    from distributed_inference_server_tpu_torch.models import llama
    from distributed_inference_server_tpu_torch.models.configs import (
        get_config,
    )
    from distributed_inference_server_tpu_torch.ops.quant import QUANT_KEYS

    cfg = get_config(model)
    group = {"int8": 128, "int4": 64}.get(quant)
    layers = 0
    for name, shape in llama.param_shapes(cfg)["layers"].items():
        n = math.prod(shape)
        if quant != "none" and name in QUANT_KEYS:
            d_in = shape[-2]
            codes = n if quant == "int8" else n // 2
            layers += codes + 4 * n // min(group, d_in)  # f32 group scales
        else:
            layers += 2 * n  # bf16
    unembed = 4 * cfg.vocab_size * cfg.hidden_size  # f32 [V, H]
    total = layers + unembed
    return {"model": model, "quantization": quant,
            "layer_weight_bytes": layers, "f32_unembedding_bytes": unembed,
            "decode_step_bytes": total,
            "bytes_bound_ms": total / HBM_BYTES_PER_S * 1e3,
            "rate": "3.35 TB/s (H100 SXM data sheet)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", default=DEFAULT)
    args = ap.parse_args(argv)
    for item in args.models.split(","):
        model, quant = item.split(":")
        print(json.dumps(decode_bytes(model, quant)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
