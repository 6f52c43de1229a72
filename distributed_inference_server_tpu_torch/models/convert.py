"""Parameter conversion into the port's layout.

The port keeps the JAX package's parameter tree (``models/llama.py``:
stacked [L, in, out] layer weights, ``embed`` [V, H], ``final_norm`` [H]),
so converting is one tensor per leaf. ``params_from_numpy`` takes that tree
with numpy leaves — what ``np.asarray`` gives for each leaf of the JAX
params — which is how the tests hand both packages the same weights. A
quantized leaf (the JAX ``Q8Tensor`` / ``Q4Tensor``, a pair of arrays)
becomes the port's: codes stay int8 / uint8 and scales float32, whatever
``dtype`` is.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from distributed_inference_server_tpu_torch.ops.quant import (
    Q4Tensor,
    Q8Tensor,
)


def _leaf(arr: Any, device, dtype: torch.dtype) -> torch.Tensor:
    a = np.array(arr)  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes: no torch.from_numpy route
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _quant_leaf(leaf: Any, device):
    """A (codes, scales) pair -> Q8Tensor (int8 codes) or Q4Tensor (uint8
    packed codes), told apart by the codes' dtype."""
    q, s = (np.array(a) for a in leaf)
    cls = {np.dtype(np.int8): Q8Tensor, np.dtype(np.uint8): Q4Tensor}.get(
        q.dtype)
    if cls is None:
        raise ValueError(f"quantized codes must be int8 or uint8, got {q.dtype}")
    return cls(torch.from_numpy(q).to(device),
               torch.from_numpy(s.astype(np.float32)).to(device))


def params_from_numpy(tree: Mapping[str, Any], device="cuda",
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """Nested dict of numpy arrays -> the same dict of ``dtype`` tensors on
    ``device``; (codes, scales) pairs -> ``Q8Tensor`` / ``Q4Tensor``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = params_from_numpy(v, device, dtype)
        elif isinstance(v, tuple):
            out[k] = _quant_leaf(v, device)
        else:
            out[k] = _leaf(v, device, dtype)
    return out
