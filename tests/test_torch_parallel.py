"""The port's parallel modules against the JAX package's, on the CPU.

The JAX side runs on the suite's 8 virtual CPU devices (conftest); the
port's meshes name the CPU once per slot. Inputs are made with numpy from
a seed, JAX parameters are converted with ``models/convert.py``, all in
float32. Covered: mesh construction, ``resolve`` errors and
``largest_tp`` (the cases of ``tests/test_parallel.py``); the shard rules
over every family's parameter tree against the JAX sharded arrays'
addressable shards (dense and int8); the tensor-parallel
``paged_forward`` at tp 2; ``moe_mlp_ep`` at ample and tight capacity;
and the multi-process runtime in two ``gloo`` processes. The sequence-
and pipeline-parallel functions are in ``test_torch_sp.py``.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models import configs as j_configs
from distributed_inference_server_tpu.ops import moe as j_moe
from distributed_inference_server_tpu.ops import quant as j_quant
from distributed_inference_server_tpu.parallel import distributed as j_dist
from distributed_inference_server_tpu.parallel import mesh as j_mesh
from distributed_inference_server_tpu.parallel import tp as j_tp
from distributed_inference_server_tpu_torch.models import configs
from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.ops import moe
from distributed_inference_server_tpu_torch.ops.quant import Q8Tensor
from distributed_inference_server_tpu_torch.parallel import tp
from distributed_inference_server_tpu_torch.parallel import distributed
from distributed_inference_server_tpu_torch.parallel.mesh import (
    MeshSpec,
    largest_tp,
    make_mesh,
    tp_mesh,
)

CPU8 = [torch.device("cpu")] * 8
FAMILIES = ["tiny", "tiny-moe", "tiny-bias", "tiny-gemma2"]


def _jmesh(**axes):
    return j_mesh.make_mesh(j_mesh.MeshSpec(**axes))


def _pmesh(**axes):
    return make_mesh(MeshSpec(**axes), devices=CPU8)


def _jparams(name, seed=0, **over):
    jcfg = j_configs.get_config(name).with_overrides(**over)
    jp = j_llama.init_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, tree


def _pcfg(name, **over):
    return configs.get_config(name).with_overrides(**over)


# -- meshes ----------------------------------------------------------------


def test_make_mesh_axes_and_auto_axis():
    mesh = make_mesh(MeshSpec(tensor=4, data=2), device="cpu")
    assert (mesh.shape["tensor"], mesh.shape["data"],
            mesh.shape["expert"]) == (4, 2, 1)
    assert make_mesh(MeshSpec(tensor=4, data=0),
                     device="cpu").shape["data"] == 2  # 8 devices / 4
    assert tp_mesh(2, device="cpu").shape["tensor"] == 2
    # an explicit list may name one device several times
    assert make_mesh(MeshSpec(tensor=3), devices=CPU8[:3]).size == 3


@pytest.mark.parametrize("spec", [MeshSpec(tensor=0, data=0),
                                  MeshSpec(tensor=16), MeshSpec(tensor=3,
                                                                data=0)])
def test_resolve_errors_match_jax(spec):
    with pytest.raises(ValueError) as theirs:
        j_mesh.MeshSpec(*spec.sizes()).resolve(8)
    with pytest.raises(ValueError) as ours:
        make_mesh(spec, device="cpu")
    assert str(ours.value) == str(theirs.value)


def test_largest_tp_and_validate_tp():
    for n, kv in ((8, 4), (8, 8), (4, 8), (3, 8)):
        assert largest_tp(n, kv) == j_mesh.largest_tp(n, kv)
    tp.validate_tp(configs.TINY, 2)
    for bad in (16, 0):
        with pytest.raises(ValueError):
            tp.validate_tp(configs.TINY, bad)


# -- shard rules -------------------------------------------------------------


def _addressable(arr, axis_dev):
    """JAX shard data by device id."""
    return {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}


@pytest.mark.parametrize("name,untied", [(f, False) for f in FAMILIES]
                         + [("tiny", True)])
def test_shard_rules_match_jax_shards(name, untied):
    over = {"tie_word_embeddings": False} if untied else {}
    jcfg, jp, tree = _jparams(name, **over)
    axes = dict(tensor=2, expert=2) if name == "tiny-moe" else dict(tensor=2)
    jm = _jmesh(**axes)
    js = j_tp.shard_params(jp, jm, jcfg)
    sp = tp.shard_params(params_from_numpy(tree, device="cpu",
                                           dtype=torch.float32),
                         _pmesh(**axes), _pcfg(name, **over))
    grid = np.asarray(jm.devices)
    for key, leaf in js["layers"].items():
        shards = _addressable(leaf, grid)
        for (s, e, t), ptree in sp.trees.items():
            dev = grid[0, t, e, s, 0].id
            np.testing.assert_array_equal(ptree["layers"][key].numpy(),
                                          shards[dev], err_msg=key)
    for key in ("embed", "final_norm", "lm_head"):
        if key not in js:
            continue
        shards = _addressable(js[key], grid)
        for (s, e, t), ptree in sp.trees.items():
            np.testing.assert_array_equal(ptree[key].numpy(),
                                          shards[grid[0, t, e, s, 0].id])


def test_int8_shard_rules_split_codes_and_scales():
    """Codes split as JAX splits them; scales (replicated on the group
    axis by JAX) split with their rows; a group that does not divide the
    per-shard rows is refused."""
    over = dict(num_heads=4, head_dim=64, hidden_size=256,
                intermediate_size=256)
    jcfg, jp, _ = _jparams("tiny", **over)
    jq_params = j_quant.quantize_params(jp, "int8")
    jm = _jmesh(tensor=2)
    js = j_tp.shard_params(jq_params, jm, jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jq_params)
    pq = params_from_numpy(
        {**tree, "layers": {k: ((v.q, v.s) if hasattr(v, "q") else v)
                            for k, v in tree["layers"].items()}},
        device="cpu", dtype=torch.float32)
    sp = tp.shard_params(pq, _pmesh(tensor=2), _pcfg("tiny", **over))
    grid = np.asarray(jm.devices)
    for key in ("wq", "wo", "w_down"):
        shards = _addressable(js["layers"][key].q, grid)
        full_s = np.asarray(jq_params["layers"][key].s)
        for t in range(2):
            leaf = sp.tree(tensor=t)["layers"][key]
            assert isinstance(leaf, Q8Tensor)
            np.testing.assert_array_equal(leaf.q.numpy(),
                                          shards[grid[0, t, 0, 0, 0].id])
            g = full_s.shape[-2] // 2
            want_s = (full_s[..., t * g:(t + 1) * g, :] if key != "wq"
                      else np.split(full_s, 2, axis=-1)[t])
            np.testing.assert_array_equal(leaf.s.numpy(), want_s)
    # TINY's wo has 64 input rows in one group of 64: 32 per shard refuses
    _, jp2, tree2 = _jparams("tiny")
    q2 = jax.tree_util.tree_map(np.asarray,
                                j_quant.quantize_params(jp2, "int8"))
    p2 = params_from_numpy(
        {**q2, "layers": {k: ((v.q, v.s) if hasattr(v, "q") else v)
                          for k, v in q2["layers"].items()}},
        device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="quantization group"):
        tp.shard_params(p2, _pmesh(tensor=2), configs.TINY)


# -- the tensor-parallel forward ----------------------------------------------


def test_tp2_paged_forward_matches_jax():
    """Prefill then one decode step at tp 2: logits within 1e-5 of the
    JAX forward on its tensor mesh (XLA path), pools equal."""
    jcfg, jp, tree = _jparams("tiny-bias")
    cfg = _pcfg("tiny-bias")
    rng = np.random.default_rng(0)
    B, T, ps, P = 2, 6, 4, 4
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    tables = np.arange(B * P, dtype=np.int32).reshape(B, P)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    ws = tables[np.arange(B)[:, None], pos // ps] * ps + pos % ps
    gs = (tables[:, :, None] * ps + np.arange(ps)).reshape(B, -1)
    slots = B * P * ps
    jm = _jmesh(tensor=2)
    js = j_tp.shard_params(jp, jm, jcfg)
    shape = (cfg.num_layers, slots, cfg.num_kv_heads, cfg.head_dim)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    mesh = _pmesh(tensor=2)
    sp = tp.shard_params(params_from_numpy(tree, device="cpu",
                                           dtype=torch.float32), mesh, cfg)
    pk, pv = tp.make_sharded_pools(mesh, cfg, slots, torch.float32)
    steps = [(ids, pos, ws, np.full((B,), T, np.int32)),
             (ids[:, :1], pos[:, :1] + T, ws[:, :1] + T,
              np.full((B,), T + 1, np.int32))]
    for i, (x, p_, w, kvv) in enumerate(steps):
        with jm:
            want, jk, jv = j_llama.paged_forward(
                js, jcfg, jnp.asarray(x), jnp.asarray(p_), jk, jv,
                jnp.asarray(w), jnp.asarray(gs), jnp.asarray(kvv),
                attention_impl="xla", page_size=ps, mesh=jm)
        got, _, _ = llama.paged_forward(
            sp, cfg, torch.as_tensor(x), torch.as_tensor(p_), pk, pv,
            torch.as_tensor(w), torch.as_tensor(tables),
            torch.as_tensor(kvv), impl="kernel", page_size=ps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   err_msg=f"step {i}")
    np.testing.assert_allclose(pk.full()[:, :-1].numpy(), np.asarray(jk),
                               atol=1e-6)


# -- expert parallelism -------------------------------------------------------


@pytest.mark.parametrize("factor", [2.0, 0.5])
def test_moe_mlp_ep_matches_jax(factor):
    """Ample and tight capacity: the same assignments dropped (outputs
    within 1e-5; at 0.5 some are dropped), padding rows routed nowhere;
    the port's expert shards (expert 2 x tensor 2) give the one-shard
    result."""
    jcfg, jp, tree = _jparams("tiny-moe")
    rng = np.random.default_rng(1)
    B, T, H = 2, 5, jcfg.hidden_size
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1, 3:] = False
    E, k = jcfg.num_experts, jcfg.num_experts_per_tok
    cap = j_moe.expert_capacity(B * T, E, k, factor)
    assert cap == moe.expert_capacity(B * T, E, k, factor)
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["layers"])
    want = j_moe.moe_mlp_ep(jnp.asarray(x), jl, E, k, capacity=cap,
                            valid_tokens=jnp.asarray(valid))
    layer = {n: torch.tensor(tree["layers"][n][1])
             for n in ("router", "w_gate", "w_up", "w_down")}
    xt, vt = torch.as_tensor(x), torch.as_tensor(valid)
    got = moe.moe_mlp_ep(xt, layer, E, k, capacity=cap, valid_tokens=vt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    logits = (xt.reshape(-1, H) @ layer["router"]).float()
    dispatch, _ = moe.dispatch_plan(logits, E, k, cap, vt.reshape(-1))
    kept = int(dispatch.sum())
    assert (kept < int(vt.sum()) * k) == (factor < 1)
    # expert 2 x tensor 2 shards of the same layer
    sp = tp.shard_params(params_from_numpy(tree, device="cpu",
                                           dtype=torch.float32),
                         _pmesh(expert=2, tensor=2), _pcfg("tiny-moe"))
    shards = [[{n: sp.tree(0, e, t)["layers"][n][1]
                for n in ("w_gate", "w_up", "w_down")} for t in range(2)]
              for e in range(2)]
    got2 = moe.moe_mlp_ep(xt, layer, E, k, capacity=cap, valid_tokens=vt,
                          expert_shards=shards)
    np.testing.assert_allclose(got2.numpy(), got.numpy(), atol=1e-5)


# -- the multi-process runtime -----------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = """
import json, sys
from distributed_inference_server_tpu_torch.parallel import distributed as d

rank, port = int(sys.argv[1]), int(sys.argv[2])
cfg = d.DistributedConfig(coordinator_address=f"127.0.0.1:{port}",
                          num_processes=2, process_id=rank)
first, again = d.initialize(cfg), d.initialize(cfg)  # idempotent
print(json.dumps([first, again, d.process_count(), d.is_coordinator(),
                  [list(d.global_batch_shard(b)) for b in (7, 8, 1)],
                  d.hybrid_mesh(d.MeshSpec(data=0), device="cpu").size]))
d.shutdown()
"""


def test_distributed_two_gloo_processes(monkeypatch):
    """``initialize`` in two processes over ``gloo`` (idempotent), their
    ``process_count`` / ``is_coordinator``, ``global_batch_shard`` equal to
    the JAX package's split, and each process's mesh of its own 8 CPU
    devices; one process needs no runtime."""
    assert distributed.initialize(distributed.DistributedConfig()) is False
    assert distributed.process_count() == 1 and distributed.is_coordinator()
    port = _free_port()
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r),
                               str(port)], cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    for rank, (out, _) in enumerate(outs):
        first, again, count, coord, shards, size = json.loads(
            out.strip().splitlines()[-1])
        assert (first, again, count, coord) == (True, True, 2, rank == 0)
        # the JAX package's split of a global batch over the processes
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        assert [tuple(x) for x in shards] == [
            j_dist.global_batch_shard(b) for b in (7, 8, 1)]
        assert size == 8  # this process's 8 CPU devices
