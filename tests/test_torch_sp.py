"""The port's sequence- and pipeline-parallel functions against the JAX
package's, on the CPU (the JAX side on the suite's 8 virtual devices,
the port's meshes naming the CPU once per slot; float32, inputs from
numpy seeds, JAX parameters converted with ``models/convert.py``):
``ring_attention`` / ``ulysses_attention`` against the JAX ``*_sharded``
on 4 slots (ragged tails, tensor composition, a window and a soft-cap,
the rejection) and ``cp_prefill``; ``pp_forward`` and
``cp_pp_prefill`` are in ``test_torch_pp.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.models import configs as j_configs
from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.ops.ring_attention import (
    ring_attention_sharded as j_ring,
)
from distributed_inference_server_tpu.ops.ulysses import (
    ulysses_attention_sharded as j_ulysses,
)
from distributed_inference_server_tpu.parallel import cp as j_cp
from distributed_inference_server_tpu.parallel import mesh as j_mesh
from distributed_inference_server_tpu.parallel import tp as j_tp
from distributed_inference_server_tpu_torch.models import configs
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.ops.ring_attention import (
    ring_attention_sharded,
)
from distributed_inference_server_tpu_torch.ops.ulysses import (
    ulysses_attention_sharded,
)
from distributed_inference_server_tpu_torch.parallel import cp
from distributed_inference_server_tpu_torch.parallel.mesh import (
    MeshSpec,
    make_mesh,
)

CPU8 = [torch.device("cpu")] * 8


def _jmesh(**axes):
    return j_mesh.make_mesh(j_mesh.MeshSpec(**axes))


def _pmesh(**axes):
    return make_mesh(MeshSpec(**axes), devices=CPU8)


def _jparams(name, seed=0):
    jcfg = j_configs.get_config(name)
    jp = j_llama.init_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, jp, jax.tree_util.tree_map(np.asarray, jp)


# -- sequence parallelism -----------------------------------------------------


def _qkv(B, T, H, KV, D, seed=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, T, h, D)).astype(np.float32)
                 for h in (H, KV, KV))


@pytest.mark.parametrize("axes,window,softcap", [
    (dict(seq=2, tensor=2), 5, 20.0),
])
def test_ring_attention_matches_jax(axes, window, softcap):
    """A ragged tail (padding at -1) on 4 slots: the ring composed with
    tensor parallelism, with a window and a soft-cap."""
    B, T, H, KV, D = 2, 16, 4, 2, 8
    q, k, v = _qkv(B, T, H, KV, D)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos[1, 11:] = -1  # ragged tail
    jm = _jmesh(**axes)
    want = j_ring(jm, *(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                  sliding_window=window, attn_softcap=softcap)
    got = ring_attention_sharded(
        _pmesh(**axes), *(torch.as_tensor(a) for a in (q, k, v, pos, pos)),
        sliding_window=window, attn_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("axes", [dict(seq=2, tensor=2)])
def test_ulysses_attention_matches_jax(axes):
    B, T, H, KV, D = 2, 16, 8, 4, 8
    q, k, v = _qkv(B, T, H, KV, D, seed=3)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    valid = np.array([16, 11], np.int32)
    jm = _jmesh(**axes)
    want = j_ulysses(jm, *(jnp.asarray(a) for a in (q, k, v, pos, valid)))
    got = ulysses_attention_sharded(
        _pmesh(**axes), *(torch.as_tensor(a) for a in (q, k, v, pos, valid)))
    rows = [np.s_[0], np.s_[1, :11]]  # padding queries are discarded
    for r in rows:
        np.testing.assert_allclose(got.numpy()[r], np.asarray(want)[r],
                                   atol=1e-5)


def test_ulysses_rejects_indivisible_heads():
    q, k, v = _qkv(1, 8, 4, 2, 8)
    pos = np.arange(8, dtype=np.int32)[None]
    valid = np.array([8], np.int32)
    with pytest.raises(ValueError, match="Ulysses axis size 4"):
        j_ulysses(_jmesh(seq=4), *(jnp.asarray(a) for a in
                                   (q, k, v, pos, valid)))
    with pytest.raises(ValueError, match="Ulysses axis size 4"):
        ulysses_attention_sharded(_pmesh(seq=4), *(
            torch.as_tensor(a) for a in (q, k, v, pos, valid)))


# -- the context-parallel prefill ----------------------------------------


@pytest.mark.parametrize("axes,impl", [(dict(seq=2, tensor=2), "ring")])
def test_cp_prefill_matches_jax(axes, impl):
    jcfg, jp, tree = _jparams("tiny")
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, (2, 16)).astype(np.int32)
    valid = np.array([16, 9], np.int32)
    jm = _jmesh(**axes)
    jparams = j_tp.shard_params(jp, jm, jcfg) if "tensor" in axes else jp
    with jm:
        want, jk, _ = j_cp.cp_prefill(jparams, jcfg, jm, jnp.asarray(ids),
                                      jnp.asarray(valid), sp_impl=impl)
    got, k, _ = cp.cp_prefill(
        params_from_numpy(tree, device="cpu", dtype=torch.float32),
        configs.TINY, _pmesh(**axes), torch.as_tensor(ids),
        torch.as_tensor(valid), impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(k[:, 0].numpy(), np.asarray(jk)[:, 0],
                               atol=1e-5)
    np.testing.assert_allclose(k[:, 1, :9].numpy(),
                               np.asarray(jk)[:, 1, :9], atol=1e-5)
