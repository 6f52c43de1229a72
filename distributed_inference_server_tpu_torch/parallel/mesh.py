"""Device meshes for TP/DP/EP/PP/SP execution (port of
``distributed_inference_server_tpu/parallel/mesh.py``).

A ``Mesh`` is a grid of ``torch.device`` slots under the canonical axis
names ``("data", "tensor", "expert", "stage", "seq")``:

- ``data``   — batch rows split between slots inside one engine;
- ``tensor`` — attention heads and the MLP intermediate (TP);
- ``expert`` — MoE experts (EP);
- ``stage``  — pipeline stages (PP);
- ``seq``    — sequence / context parallelism (ring or Ulysses prefill).

The engine is one process that owns the whole mesh (a single controller,
as the JAX engine owns its ``jax.sharding.Mesh``): every shard keeps its
own weights and KV pool on its slot's device and launches its own
kernels, and the collectives between shards are ``parallel/comm.py``'s.

Devices: the cards by default (one slot per ``torch.cuda.device_count()``),
or on the CPU the ``--xla_force_host_platform_device_count`` of
``XLA_FLAGS`` (1 when unset) — the number that sets the JAX package's CPU
device count, so both packages see the same devices in one environment.
An explicit list may name one device several times (``[cuda:0] * 2``):
the shards are then distinct in weights, pools and launches, and their
collectives are local copies.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_inference_server_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)

AXES = ("data", "tensor", "expert", "stage", "seq")
_HOST_COUNT = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


@dataclass(frozen=True)
class MeshSpec:
    """Sizes per mesh axis; 1 = axis unused. One axis may be 0: it
    absorbs all remaining devices."""

    data: int = 1
    tensor: int = 1
    expert: int = 1
    stage: int = 1
    seq: int = 1

    def sizes(self) -> Tuple[int, ...]:
        return (self.data, self.tensor, self.expert, self.stage, self.seq)

    def resolve(self, n_devices: int) -> "MeshSpec":
        """Fill a single 0 axis with the remaining device count."""
        sizes = list(self.sizes())
        zeros = [i for i, s in enumerate(sizes) if s == 0]
        if len(zeros) > 1:
            raise ValueError("at most one mesh axis may be 0 (auto)")
        fixed = math.prod(s for s in sizes if s > 0)
        if zeros:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[zeros[0]] = n_devices // fixed
            return MeshSpec(*sizes)
        if fixed > n_devices:
            raise ValueError(
                f"mesh needs {fixed} devices, only {n_devices} available")
        return self


class Mesh:
    """A grid of device slots, shape ``MeshSpec.sizes()`` over ``AXES``.

    ``shape`` maps each axis name to its size (as ``jax.sharding.Mesh``
    does); ``device(tensor=t, stage=s, ...)`` is one slot's device."""

    def __init__(self, grid: np.ndarray):
        if grid.ndim != len(AXES):
            raise ValueError(f"a mesh grid has {len(AXES)} axes, got "
                             f"{grid.ndim}")
        self.devices = grid
        self.axis_names = AXES
        self.shape: Dict[str, int] = dict(zip(AXES, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, data: int = 0, tensor: int = 0, expert: int = 0,
               stage: int = 0, seq: int = 0) -> torch.device:
        return self.devices[data, tensor, expert, stage, seq]

    @property
    def primary(self) -> torch.device:
        """The first slot's device: where the engine's host-facing tensors
        (tokens, tables, the residual stream's entry) live."""
        return self.device()

    def distinct_devices(self) -> List[torch.device]:
        seen: List[torch.device] = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return seen

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items() if n > 1)
        return (f"Mesh({axes or 'single'}; "
                f"{', '.join(str(d) for d in self.distinct_devices())})")


def device_count(device: DeviceLike = None) -> int:
    """Real devices of a kind: the cards on ``cuda``; on the CPU the
    ``--xla_force_host_platform_device_count`` of ``XLA_FLAGS`` (else 1)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    m = _HOST_COUNT.search(os.environ.get("XLA_FLAGS", ""))
    return int(m.group(1)) if m else 1


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """One slot per real device of the kind (``device_count``)."""
    dev = resolve_device(device)
    n = device_count(dev)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")] * n


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[torch.device]] = None,
              device: DeviceLike = None) -> Mesh:
    """A mesh with the canonical axis names over ``devices`` (default:
    ``local_devices(device)``); axes of size 1 are kept, so shard rules
    read the same on every mesh shape."""
    devs = list(devices) if devices is not None else local_devices(device)
    devs = [torch.device(d) for d in devs]
    spec = (spec or MeshSpec()).resolve(len(devs))
    n = math.prod(spec.sizes())
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        grid[i] = d
    return Mesh(grid.reshape(spec.sizes()))


def tp_mesh(tensor: int, devices: Optional[Sequence[torch.device]] = None,
            device: DeviceLike = None) -> Mesh:
    """Tensor-parallel-only mesh (the engine's intra-replica layout)."""
    return make_mesh(MeshSpec(tensor=tensor), devices, device)


def largest_tp(n_devices: int, num_kv_heads: int) -> int:
    """Largest tensor-axis size dividing both the device count and the
    KV-head count (KV heads bind GQA tensor parallelism)."""
    return math.gcd(n_devices, num_kv_heads)
