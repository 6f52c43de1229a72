"""PyTorch/CUDA port of ``distributed_inference_server_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here mirrors
its counterpart's name and contract, and the tests under
``tests/test_torch_*.py`` drive both packages on the same inputs. This
package imports ``torch``, numpy and the standard library only — never
``jax`` and nothing of the JAX package — and keeps its own copy of what it
needs.

Device rule: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; a missing card raises instead of falling back
(``utils/device.py``). On the card, RMSNorm, RoPE and paged attention run
hand-written kernels (``ops/kernels/``); on the CPU the same wrappers run
their plain PyTorch versions.
"""

__version__ = "0.1.0"
