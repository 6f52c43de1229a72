"""Parameter conversion into the port's layout.

The port keeps the JAX package's parameter tree (``models/llama.py``:
stacked [L, in, out] layer weights, ``embed`` [V, H], ``final_norm`` [H]),
so converting is one tensor per leaf. ``params_from_numpy`` takes that tree
with numpy leaves — what ``np.asarray`` gives for each leaf of the JAX
params — which is how the tests hand both packages the same weights.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _leaf(arr: Any, device, dtype: torch.dtype) -> torch.Tensor:
    a = np.array(arr)  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes: no torch.from_numpy route
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def params_from_numpy(tree: Mapping[str, Any], device="cuda",
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """Nested dict of numpy arrays -> the same dict of ``dtype`` tensors on
    ``device``."""
    return {
        k: params_from_numpy(v, device, dtype) if isinstance(v, Mapping)
        else _leaf(v, device, dtype)
        for k, v in tree.items()
    }
