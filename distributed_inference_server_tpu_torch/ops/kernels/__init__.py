"""Hand-written Hopper kernels of the port and their launch counters.

| kernel            | route  | source                       | replaces (TPU kernel)                                  |
|-------------------|--------|------------------------------|--------------------------------------------------------|
| paged_decode      | cuda   | csrc/paged_attention.cu      | ops/pallas/paged_attention.py:paged_attention_decode   |
| paged_decode_int8 | cuda   | csrc/paged_attention.cu      | the same, over int8 QuantPool pools                    |
| paged_prefill     | cuda   | csrc/paged_attention.cu      | ops/pallas/paged_attention.py:paged_attention_prefill  |
| paged_ragged      | cuda   | csrc/paged_attention.cu      | ops/pallas/paged_attention.py:paged_attention_ragged   |
| rms_norm          | triton | ops/kernels/_triton_fused.py | ops/pallas/fused.py:rms_norm_pallas                    |
| rope              | triton | ops/kernels/_triton_fused.py | ops/pallas/fused.py:apply_rope_pallas                  |
| quant_matmul_q8   | cuda   | csrc/quant_matmul.cu         | ops/pallas/fused.py:quant_matmul_pallas (int8 body)    |
| quant_matmul_q4   | cuda   | csrc/quant_matmul.cu         | ops/pallas/fused.py:quant_matmul_pallas (int4 body)    |
"""

from __future__ import annotations

from typing import Dict

from distributed_inference_server_tpu_torch.ops.kernels import _launches

from distributed_inference_server_tpu_torch.ops.kernels.fused import (
    apply_rope,
    rms_norm,
)
from distributed_inference_server_tpu_torch.ops.kernels.paged_attention import (
    paged_decode,
    paged_decode_int8,
    paged_prefill,
    paged_ragged,
)
from distributed_inference_server_tpu_torch.ops.kernels.quant_matmul import (
    quant_matmul_q4,
    quant_matmul_q8,
)

KERNELS = {
    "paged_decode": paged_decode,
    "paged_decode_int8": paged_decode_int8,
    "paged_prefill": paged_prefill,
    "paged_ragged": paged_ragged,
    "rms_norm": rms_norm,
    "rope": apply_rope,
    "quant_matmul_q8": quant_matmul_q8,
    "quant_matmul_q4": quant_matmul_q4,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset (this process)."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Zero the process totals and every thread's tally."""
    _launches.reset(KERNELS)


def add_launch_counts(counts: Dict[str, int], sign: int = 1) -> None:
    """Add ``sign * counts[name]`` to each wrapper's count and to the
    calling thread's tally: a CUDA graph replay launches the kernels its
    capture recorded without calling the wrappers, so the graph's owner
    adds the counts its capture made (and takes them back from the
    capture itself, which launched nothing)."""
    _launches.add(KERNELS, counts, sign)


#: the calling thread's launches inside a ``with`` block, by kernel name;
#: launches of other threads meanwhile are not in it (a capture's graph
#: counts only its own)
recording = _launches.recording


def thread_launch_counts() -> Dict[str, int]:
    """The calling thread's launches since the last reset: its engine
    replica's, as each engine runs on one thread."""
    return _launches.thread_counts()
