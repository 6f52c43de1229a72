"""Hand-written Hopper kernels of the port and their launch counters.

| kernel          | route  | source                    | replaces (TPU kernel)                   |
|-----------------|--------|---------------------------|-----------------------------------------|
| paged_decode    | cuda   | csrc/paged_attention.cu   | ops/pallas/paged_attention.py:paged_attention_decode |
| paged_prefill   | cuda   | csrc/paged_attention.cu   | ops/pallas/paged_attention.py:paged_attention_prefill |
| rms_norm        | triton | ops/kernels/_triton_fused.py | ops/pallas/fused.py:rms_norm_pallas  |
| rope            | triton | ops/kernels/_triton_fused.py | ops/pallas/fused.py:apply_rope_pallas |
"""

from __future__ import annotations

from typing import Dict

from distributed_inference_server_tpu_torch.ops.kernels.fused import (
    apply_rope,
    rms_norm,
)
from distributed_inference_server_tpu_torch.ops.kernels.paged_attention import (
    paged_decode,
    paged_prefill,
)

KERNELS = {
    "paged_decode": paged_decode,
    "paged_prefill": paged_prefill,
    "rms_norm": rms_norm,
    "rope": apply_rope,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset (this process)."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
