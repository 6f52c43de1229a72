"""The port's checkpoint loader and saver against the JAX package's.

On the five HF-written fixtures (``tests/fixtures/tiny_*_hf``: Llama,
Mistral, Qwen2, Gemma-2, Mixtral): ``config_from_hf_json`` gives the JAX
``ModelConfig`` field by field; ``params_from_hf_state_dict`` gives
``convert.params_from_numpy`` of the JAX loader's tree, leaf by leaf,
exactly, in float32; the port's own safetensors reader gives the
``safetensors`` package's bytes for every tensor. Checkpoints cross the
packages both ways (the port saves and the JAX package loads, and the
reverse), a bfloat16 tree included; the checkpoint decides head tying;
missing files and weights raise ``ModelLoadError``.
"""

import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open

from distributed_inference_server_tpu.core.errors import (
    ModelLoadError as JModelLoadError,
)
from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models import loader as j_loader
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu.ops import quant as jq
from distributed_inference_server_tpu_torch.core.errors import (
    ModelLoadError,
    ServerError,
)
from distributed_inference_server_tpu_torch.models import loader
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
    load_tokenizer,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FAMILIES = ["tiny_llama_hf", "tiny_mistral_hf", "tiny_qwen2_hf",
            "tiny_gemma2_hf", "tiny_mixtral_hf"]


def _ckpt(family):
    return os.path.join(FIXTURES, family)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want, path=""):
    """Same keys, dtypes, shapes and values, leaf by leaf."""
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_trees_equal(g, w, f"{path}/{k}")
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
        assert torch.equal(g, w), f"{path}/{k}"


def _cfg_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same_cfg(t_cfg, j_cfg):
    t, j = _cfg_fields(t_cfg), _cfg_fields(j_cfg)
    assert set(t) == set(j)
    for k in t:
        if k == "rope_scaling" and j[k] is not None:
            assert dataclasses.asdict(t[k]) == dataclasses.asdict(j[k])
        else:
            assert t[k] == j[k], k


@pytest.mark.parametrize("family", FAMILIES)
def test_config_from_hf_json_matches_jax(family):
    with open(os.path.join(_ckpt(family), "config.json")) as f:
        obj = json.load(f)
    _same_cfg(loader.config_from_hf_json(obj, name=family),
              j_loader.config_from_hf_json(obj, name=family))


def test_config_refuses_gemma1():
    obj = {"model_type": "gemma", "vocab_size": 8, "hidden_size": 8,
           "intermediate_size": 8, "num_hidden_layers": 1,
           "num_attention_heads": 1}
    with pytest.raises(ModelLoadError, match="Gemma-1"):
        loader.config_from_hf_json(obj)
    with pytest.raises(JModelLoadError, match="Gemma-1"):
        j_loader.config_from_hf_json(obj)


def test_model_load_error_matches_the_reference():
    e = ModelLoadError("x")
    assert isinstance(e, ServerError) and str(e) == str(JModelLoadError("x"))
    assert e.detail == "x"


@pytest.mark.parametrize("family", FAMILIES)
def test_reader_gives_the_safetensors_package_bytes(family):
    path = os.path.join(_ckpt(family), "model.safetensors")
    tensors, meta = loader.read_safetensors(path)
    assert meta == {"format": "pt"}
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(tensors)
        for k in f.keys():
            want = f.get_tensor(k)
            assert tensors[k].dtype == want.dtype, k
            assert tensors[k].shape == want.shape, k
            assert tensors[k].numpy().tobytes() == want.numpy().tobytes(), k


@pytest.mark.parametrize("family", FAMILIES)
def test_params_match_the_jax_loader_leaf_by_leaf(family):
    j_params, j_cfg = j_loader.load_checkpoint(_ckpt(family),
                                               dtype=jnp.float32)
    t_params, t_cfg = loader.load_checkpoint(_ckpt(family),
                                             dtype=torch.float32,
                                             device="cpu")
    _same_cfg(t_cfg, j_cfg)
    _assert_trees_equal(t_params, params_from_numpy(
        _np_tree(j_params), device="cpu", dtype=torch.float32))
    # the state-dict conversion alone, from numpy arrays
    state, _ = loader.read_safetensors(
        os.path.join(_ckpt(family), "model.safetensors"))
    direct = loader.params_from_hf_state_dict(
        {k: v.numpy() for k, v in state.items()}, t_cfg, torch.float32,
        "cpu")
    _assert_trees_equal(direct, t_params)


@pytest.mark.parametrize("family", FAMILIES)
def test_hf_state_dict_matches_jax(family):
    j_params, j_cfg = j_loader.load_checkpoint(_ckpt(family),
                                               dtype=jnp.float32)
    t_params, t_cfg = loader.load_checkpoint(_ckpt(family),
                                             dtype=torch.float32,
                                             device="cpu")
    want = j_loader.hf_state_dict_from_params(j_params, j_cfg)
    got = loader.hf_state_dict_from_params(t_params, t_cfg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert loader.config_to_hf_json(t_cfg) == j_loader.config_to_hf_json(
        j_cfg)


@pytest.mark.parametrize("family", FAMILIES)
def test_port_saves_jax_loads(family, tmp_path):
    t_params, t_cfg = loader.load_checkpoint(_ckpt(family),
                                             dtype=torch.float32,
                                             device="cpu")
    loader.save_checkpoint(t_params, t_cfg, str(tmp_path))
    j_params, j_cfg = j_loader.load_checkpoint(str(tmp_path),
                                               dtype=jnp.float32)
    _same_cfg(t_cfg.with_overrides(name=j_cfg.name), j_cfg)
    _assert_trees_equal(t_params, params_from_numpy(
        _np_tree(j_params), device="cpu", dtype=torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_saves_port_loads(dtype, tmp_path):
    """The JAX package writes float32 files (from a bf16 tree too); the
    port loads them back to the tree it was given."""
    jd = getattr(jnp, dtype)
    jp = j_llama.init_params(jax.random.PRNGKey(3), J_TINY, jd)
    j_loader.save_checkpoint(jp, J_TINY, str(tmp_path))
    t_params, t_cfg = loader.load_checkpoint(
        str(tmp_path), dtype=getattr(torch, dtype), device="cpu")
    _assert_trees_equal(t_params, params_from_numpy(
        _np_tree(jp), device="cpu", dtype=getattr(torch, dtype)))
    _same_cfg(t_cfg.with_overrides(name=J_TINY.name), J_TINY)


def test_bf16_checkpoint_round_trips_through_the_port(tmp_path):
    """A bf16 tree saved as bf16 (half the bytes) reloads bit for bit, and
    the safetensors package reads the same tensors (the JAX loader reads
    numpy, which has no bfloat16, so it takes float32 files only)."""
    jp = j_llama.init_params(jax.random.PRNGKey(4), J_TINY, jnp.bfloat16)
    tree = params_from_numpy(_np_tree(jp), device="cpu",
                             dtype=torch.bfloat16)
    cfg = loader.config_from_hf_json(j_loader.config_to_hf_json(J_TINY))
    loader.save_checkpoint(tree, cfg, str(tmp_path), dtype=None)
    back, _ = loader.load_checkpoint(str(tmp_path), dtype=torch.bfloat16,
                                     device="cpu")
    _assert_trees_equal(back, tree)
    path = str(tmp_path / "model.safetensors")
    ours, meta = loader.read_safetensors(path)
    assert meta == {"format": "pt"}
    with safe_open(path, framework="pt") as f:
        for k in f.keys():
            assert ours[k].dtype == torch.bfloat16
            assert torch.equal(f.get_tensor(k), ours[k]), k
    assert os.path.getsize(path) < sum(
        t.numel() * 4 for t in ours.values())


def test_quantized_tree_saves_dense_like_jax():
    """A quantized tree is written densified, per layer: the same state
    dict as the JAX package writes for the tree dequantized up front (its
    ``hf_state_dict_from_params`` indexes a stacked ``Q8Tensor`` by layer,
    which picks a field of the pair, so it is given the dense tree)."""
    j_params, j_cfg = j_loader.load_checkpoint(_ckpt("tiny_llama_hf"),
                                               dtype=jnp.float32)
    jqp = jq.quantize_params(j_params, "int8", 32)
    jdense = {**jqp, "layers": {k: jq.dense_view(v, jnp.float32)
                                for k, v in jqp["layers"].items()}}
    tqp = params_from_numpy(_np_tree(jqp), device="cpu",
                            dtype=torch.float32)
    want = j_loader.hf_state_dict_from_params(jdense, j_cfg)
    got = loader.hf_state_dict_from_params(
        tqp, loader.config_from_hf_json(j_loader.config_to_hf_json(j_cfg)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_sharded_checkpoint_loads_like_one_file(tmp_path):
    src = _ckpt("tiny_llama_hf")
    state, meta = loader.read_safetensors(
        os.path.join(src, "model.safetensors"))
    names = sorted(state)
    half = len(names) // 2
    shutil.copy(os.path.join(src, "config.json"), tmp_path)
    weight_map = {}
    for i, part in enumerate((names[:half], names[half:])):
        shard = f"model-{i + 1:05d}-of-00002.safetensors"
        loader.write_safetensors(str(tmp_path / shard),
                                 {k: state[k] for k in part}, meta)
        weight_map.update({k: shard for k in part})
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": weight_map}))
    got, _ = loader.load_checkpoint(str(tmp_path), dtype=torch.float32,
                                    device="cpu")
    want, _ = loader.load_checkpoint(src, dtype=torch.float32, device="cpu")
    _assert_trees_equal(got, want)
    # a shard the index names but the directory lacks
    os.remove(tmp_path / "model-00002-of-00002.safetensors")
    with pytest.raises(ModelLoadError, match="missing"):
        loader.load_checkpoint(str(tmp_path), device="cpu")


@pytest.mark.parametrize("claim_tied", [True, False])
def test_tie_reconciled_with_checkpoint_contents(claim_tied, tmp_path):
    """The checkpoint decides: a head in the shards means untied whatever
    config.json says, and no head means tied."""
    dst = tmp_path / "ckpt"
    shutil.copytree(_ckpt("tiny_llama_hf"), dst)
    if not claim_tied:  # drop the head, keep config.json's false
        state, meta = loader.read_safetensors(str(dst / "model.safetensors"))
        state = {k: v.clone() for k, v in state.items()
                 if k != "lm_head.weight"}
        loader.write_safetensors(str(dst / "model.safetensors"), state, meta)
    else:
        obj = json.loads((dst / "config.json").read_text())
        obj["tie_word_embeddings"] = True  # shards carry lm_head.weight
        (dst / "config.json").write_text(json.dumps(obj))
    params, cfg = loader.load_checkpoint(str(dst), dtype=torch.float32,
                                         device="cpu")
    j_params, j_cfg = j_loader.load_checkpoint(str(dst), dtype=jnp.float32)
    assert cfg.tie_word_embeddings == j_cfg.tie_word_embeddings == (
        not claim_tied)
    assert ("lm_head" in params) == claim_tied
    _assert_trees_equal(params, params_from_numpy(
        _np_tree(j_params), device="cpu", dtype=torch.float32))


def test_missing_files_and_weights_raise(tmp_path):
    with pytest.raises(ModelLoadError, match="config.json"):
        loader.load_checkpoint(str(tmp_path), device="cpu")
    shutil.copy(os.path.join(_ckpt("tiny_llama_hf"), "config.json"),
                tmp_path)
    with pytest.raises(ModelLoadError, match="safetensors"):
        loader.load_checkpoint(str(tmp_path), device="cpu")
    state, meta = loader.read_safetensors(
        os.path.join(_ckpt("tiny_llama_hf"), "model.safetensors"))
    state = {k: v for k, v in state.items()
             if k != "model.layers.1.mlp.up_proj.weight"}
    loader.write_safetensors(str(tmp_path / "model.safetensors"), state, meta)
    with pytest.raises(ModelLoadError, match="up_proj"):
        loader.load_checkpoint(str(tmp_path), device="cpu")
    (tmp_path / "model.safetensors").write_bytes(b"\x01")
    with pytest.raises(ModelLoadError, match="not a safetensors"):
        loader.load_checkpoint(str(tmp_path), device="cpu")


def test_tokenizer_choice(tmp_path, monkeypatch):
    """tokenizer.json -> HFTokenizer; none -> bytes; tokenizer.json without
    the tokenizers package -> ModelLoadError, never a quiet fall back."""
    assert isinstance(load_tokenizer(str(tmp_path)), ByteTokenizer)
    assert isinstance(load_tokenizer(None), ByteTokenizer)
    tok = load_tokenizer(_ckpt("tiny_llama_hf"))
    assert type(tok).__name__ == "HFTokenizer"
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ModelLoadError, match="tokenizers"):
        load_tokenizer(_ckpt("tiny_llama_hf"))
