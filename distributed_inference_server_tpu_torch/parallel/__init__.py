"""Parallel execution over a device mesh (port of
``distributed_inference_server_tpu/parallel``): ``mesh`` (axes, meshes,
device enumeration), ``comm`` (the collectives between shards), ``tp``
(sharding rules, per-shard trees and pools), ``pp`` (pipeline stages),
``cp`` (sequence-parallel prefill) and ``distributed`` (the multi-process
runtime). ``pp`` and ``cp`` import the model; import them by module."""

from distributed_inference_server_tpu_torch.parallel.distributed import (
    DistributedConfig,
    hybrid_mesh,
    initialize as initialize_distributed,
)
from distributed_inference_server_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshSpec,
    largest_tp,
    make_mesh,
    tp_mesh,
)
from distributed_inference_server_tpu_torch.parallel.tp import (
    ShardedParams,
    ShardedPool,
    kv_pool_spec,
    llama_param_specs,
    shard_params,
    validate_tp,
)

__all__ = [
    "AXES",
    "DistributedConfig",
    "Mesh",
    "MeshSpec",
    "ShardedParams",
    "ShardedPool",
    "hybrid_mesh",
    "initialize_distributed",
    "kv_pool_spec",
    "largest_tp",
    "llama_param_specs",
    "make_mesh",
    "shard_params",
    "tp_mesh",
    "validate_tp",
]
