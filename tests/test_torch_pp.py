"""The port's pipeline-parallel forward and the sequence x stage prefill
against the JAX package's, on the CPU (the JAX side on the suite's 8
virtual devices, the port's meshes naming the CPU once per slot; float32,
inputs from numpy seeds, JAX parameters converted with
``models/convert.py``): ``pp_forward`` at stage 2 in 2 microbatches
(Gemma-2's alternating windows across the stage boundary) and
``cp_pp_prefill`` on a seq 2 x stage 2 mesh (Mistral's window).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.models import configs as j_configs
from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.parallel import cp as j_cp
from distributed_inference_server_tpu.parallel import mesh as j_mesh
from distributed_inference_server_tpu.parallel import pp as j_pp
from distributed_inference_server_tpu_torch.models import configs
from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.parallel import cp, pp
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


def test_pp_forward_matches_jax():
    """Stage 2 x 2 microbatches over a dense cache: prefill then one
    decode step, logits and caches within 1e-5."""
    jcfg, jp, tree = _jparams("tiny-gemma2")
    cfg = configs.TINY_GEMMA2
    rng = np.random.default_rng(4)
    B, T, S = 2, 5, 8
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    kvv = np.full((B,), T, np.int32)
    jm = _jmesh(stage=2)
    jc = j_llama.KVCache.create(jcfg, B, S, dtype=jnp.float32)
    with jm:
        want, jk, jv = j_pp.pp_forward(jm, jp, jcfg, jnp.asarray(ids),
                                       jnp.asarray(pos), jc.k, jc.v,
                                       jnp.asarray(pos), jnp.asarray(kvv),
                                       num_microbatches=2)
    pc = llama.KVCache.create(cfg, B, S, dtype=torch.float32, device="cpu")
    got, pk, _ = pp.pp_forward(
        _pmesh(stage=2), params_from_numpy(tree, device="cpu",
                                           dtype=torch.float32), cfg,
        torch.as_tensor(ids), torch.as_tensor(pos), pc.k, pc.v,
        torch.as_tensor(pos), torch.as_tensor(kvv), num_microbatches=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=1e-5)
    with pytest.raises(ValueError, match="microbatches do not divide"):
        pp.validate_pp(cfg, 2, 3, 2)


def test_cp_pp_prefill_matches_jax():
    jcfg, jp, tree = _jparams("tiny-swa")
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 256, (2, 16)).astype(np.int32)
    valid = np.array([13, 16], np.int32)
    jm = _jmesh(seq=2, stage=2)
    with jm:
        want, jk, _ = j_cp.cp_pp_prefill(jp, jcfg, jm, jnp.asarray(ids),
                                         jnp.asarray(valid),
                                         num_microbatches=2)
    got, k, _ = cp.cp_pp_prefill(
        params_from_numpy(tree, device="cpu", dtype=torch.float32),
        configs.TINY_SWA, _pmesh(seq=2, stage=2), torch.as_tensor(ids),
        torch.as_tensor(valid), num_microbatches=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(k[:, 1].numpy(), np.asarray(jk)[:, 1],
                               atol=1e-5)
