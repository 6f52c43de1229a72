"""The multi-process runtime (port of
``distributed_inference_server_tpu/parallel/distributed.py``).

The JAX package connects its processes with ``jax.distributed.initialize``
and then sees one global device set. The port connects them with a
``torch.distributed`` process group over ``gloo`` at the coordinator's
address (``tcp://host:port``), and each process builds its meshes from its
OWN devices only: an engine's mesh never spans hosts, and requests move
between hosts at the HTTP boundary (the JAX package's control plane), so
the process group carries only coordination (``process_count``,
``is_coordinator``, ``global_batch_shard``), not activations.

Single-process configs (``num_processes == 1``) skip initialization: the
same entry point serves a CPU, one card or several.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import torch

from distributed_inference_server_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    local_devices as _all_local_devices,
    make_mesh,
)
from distributed_inference_server_tpu_torch.utils.device import DeviceLike

_initialized = False
_local_ids: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """One process of a multi-process deployment.

    coordinator_address: "host:port" of process 0 (every process passes
    the same value). num_processes: world size. process_id: this
    process's rank; -1 = the ``RANK`` environment variable.
    local_device_ids: the card ids this process owns (None = all)."""

    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = -1
    local_device_ids: Optional[Tuple[int, ...]] = None

    @property
    def enabled(self) -> bool:
        return self.num_processes > 1


def initialize(cfg: DistributedConfig, timeout_s: float = 300.0) -> bool:
    """Join the process group (idempotent). Returns True when the runtime
    is (or already was) live, False for single-process configs. Call it
    before any engine touches a device."""
    global _initialized, _local_ids
    if not cfg.enabled:
        return False
    if _initialized or torch.distributed.is_initialized():
        _initialized = True
        return True
    rank = cfg.process_id
    if rank < 0:
        if "RANK" not in os.environ:
            raise ValueError(
                "distributed.process_id is -1 and RANK is not set: give "
                "each process its rank")
        rank = int(os.environ["RANK"])
    if not cfg.coordinator_address:
        raise ValueError("distributed.coordinator_address is empty")
    import datetime

    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{cfg.coordinator_address}",
        world_size=cfg.num_processes, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    _local_ids = cfg.local_device_ids
    _initialized = True
    return True


def shutdown() -> None:
    """Leave the process group (tests and orderly exits)."""
    global _initialized, _local_ids
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    _initialized = False
    _local_ids = None


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """This process's devices: all of the kind, or on ``cuda`` the
    ``local_device_ids`` given to ``initialize``."""
    devs = _all_local_devices(device)
    if _local_ids is not None and devs and devs[0].type == "cuda":
        devs = [d for d in devs if d.index in _local_ids]
    return devs


def hybrid_mesh(spec: MeshSpec, dcn_spec: Optional[MeshSpec] = None,
                devices: Optional[Sequence[torch.device]] = None,
                device: DeviceLike = None) -> Mesh:
    """The mesh of one process: ``spec`` per host with each ``dcn_spec``
    extent folded in (the JAX package's single-slice collapse). A port
    mesh holds this process's devices only, so there is never a second
    slice to lay out across."""
    devs = list(devices) if devices is not None else local_devices(device)
    dcn = dcn_spec or MeshSpec()
    if 0 in dcn.sizes():
        dcn = dcn.resolve(1)
    ici = spec.resolve(len(devs) // max(1, _prod(dcn.sizes())))
    merged = MeshSpec(*[a * b for a, b in zip(ici.sizes(), dcn.sizes())])
    return make_mesh(merged, devs)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def process_count() -> int:
    if torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def process_index() -> int:
    if torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def is_coordinator() -> bool:
    return process_index() == 0


def global_batch_shard(batch: int) -> Tuple[int, int]:
    """(this process's shard size, offset) of a global batch laid out
    contiguously over processes."""
    n, i = process_count(), process_index()
    base, rem = divmod(batch, n)
    size = base + (1 if i < rem else 0)
    offset = i * base + min(i, rem)
    return size, offset
