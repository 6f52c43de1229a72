"""Random weights made on the card from ``--seed``, in the form they are
served in: the stacked parameter tree the port's ``LLMEngine`` takes
(linear weights [L, in, out], experts [L, E, in, out]).

bf16 weights are normal(0, 0.02); norm weights are 1 + normal(0, 0.1), so
that a norm applied with the wrong weight shows. int8 weights are codes
uniform over [-128, 127] and one f32 scale per 128 input rows and output
column, 1 / (127 sqrt(in)) times a factor uniform over [0.5, 1.5], so that
a scale read from the wrong group shows; the port's ``Q8Tensor`` layout.
Each family of a layer stack is one draw (a handful of large calls), on
the card's own generator. Nothing is written to disk.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.work import Dims

LINEAR = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def shapes(d: Dims) -> Dict[str, Tuple[int, ...]]:
    """Leaf shapes of the stacked tree, ``layers/<name>`` for the
    per-layer stacks."""
    L, H, I = d.layers, d.hidden, d.inter
    s = {
        "layers/attn_norm": (L, H),
        "layers/wq": (L, H, d.q_size),
        "layers/wk": (L, H, d.kv_size),
        "layers/wv": (L, H, d.kv_size),
        "layers/wo": (L, d.q_size, H),
        "layers/mlp_norm": (L, H),
        "embed": (d.vocab, H),
        "final_norm": (H,),
        "lm_head": (H, d.vocab),
    }
    if d.experts:
        E = d.experts
        s.update({"layers/router": (L, H, E),
                  "layers/w_gate": (L, E, H, I),
                  "layers/w_up": (L, E, H, I),
                  "layers/w_down": (L, E, I, H)})
    else:
        s.update({"layers/w_gate": (L, H, I), "layers/w_up": (L, H, I),
                  "layers/w_down": (L, I, H)})
    return s


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(abs(int(seed)) % (1 << 63))
    return g


def make(d: Dims, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The tree for ``d`` from ``seed``: a dict with ``layers`` (a dict)
    and the top-level leaves. int8 leaves are ``(codes, scales)``
    pairs; ``as_port_tree`` wraps them in the port's ``Q8Tensor``."""
    g = generator(seed, device)
    tree: dict = {"layers": {}}
    for key, shape in shapes(d).items():
        name = key.split("/")[-1]
        if name.endswith("norm"):
            x = torch.randn(shape, generator=g, device=device, dtype=dtype)
            leaf = x.mul_(0.1).add_(1.0)
        elif d.weight == "int8" and name in LINEAR:
            *lead, d_in, d_out = shape
            codes = torch.empty(shape, dtype=torch.uint8, device=device)
            codes.random_(0, 256, generator=g)
            scales = torch.rand((*lead, d_in // d.group, d_out),
                                generator=g, device=device,
                                dtype=torch.float32)
            scales.add_(0.5).mul_(1.0 / (127.0 * d_in ** 0.5))
            leaf = (codes.view(torch.int8), scales)
        else:
            x = torch.randn(shape, generator=g, device=device, dtype=dtype)
            leaf = x.mul_(0.02)
        if key.startswith("layers/"):
            tree["layers"][name] = leaf
        else:
            tree[name] = leaf
    return tree


def as_port_tree(tree: dict) -> dict:
    """The same tensors as the port's parameter tree: int8 pairs as
    ``Q8Tensor``. No copy."""
    from distributed_inference_server_tpu_torch.ops.quant import Q8Tensor

    def wrap(v):
        return Q8Tensor(*v) if isinstance(v, tuple) else v

    out = {k: wrap(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: wrap(v) for k, v in tree["layers"].items()}
    return out

