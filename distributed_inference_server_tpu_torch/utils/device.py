"""Device selection: ``cuda`` unless the caller asks for the CPU.

There is deliberately no silent fallback: a caller that does not name a
device gets the card, and a machine without one raises. Tests and CPU
drives pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the torch device to run on (default ``cuda``); raises
    ``RuntimeError`` when a CUDA device is requested but none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def dtype_from_name(name: Optional[str]) -> torch.dtype:
    """Map a config dtype name ("bfloat16", "float32", "float16")."""
    table = {
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float16": torch.float16,
    }
    key = name or "bfloat16"
    if key not in table:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(table)}")
    return table[key]
