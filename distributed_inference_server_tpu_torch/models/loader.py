"""Weight loading and saving: HF checkpoint directories (``config.json`` +
``*.safetensors``) <-> the port's stacked parameter tree (port of
``distributed_inference_server_tpu/models/loader.py``).

HF Llama naming maps to the stacked layout of ``models/llama.py``:
``model.layers.{i}.self_attn.q_proj.weight`` [out, in] becomes row ``i`` of
``layers.wq`` [L, in, out] (transposed so the hot path is ``x @ W``). Every
family's mapping is ported (qkv biases, Mixtral experts, Gemma-2 sandwich
norms with the unit offset folded in, untied heads), since it is pure data;
``models/llama.py`` decides which families it serves.

The safetensors format is read and written here, with no dependency: an
8-byte little-endian header length, a JSON header of ``dtype``, ``shape``
and ``data_offsets`` per tensor (plus ``__metadata__``), then the raw
little-endian bytes. A shard is memory-mapped and each tensor is a view
into it, so a load stacks and transposes one leaf at a time and moves it
to the device once: no second full host copy of the weights.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import torch

from distributed_inference_server_tpu_torch.core.errors import ModelLoadError
from distributed_inference_server_tpu_torch.models.configs import (
    ModelConfig,
    RopeScaling,
)
from distributed_inference_server_tpu_torch.ops.quant import (
    dequantize,
    is_quantized,
    layer_weight,
)
from distributed_inference_server_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)

# (our stacked name, HF per-layer suffix, transpose?)
_LAYER_MAP = [
    ("attn_norm", "input_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True),
    ("wo", "self_attn.o_proj.weight", True),
    ("mlp_norm", "post_attention_layernorm.weight", False),
    ("w_gate", "mlp.gate_proj.weight", True),
    ("w_up", "mlp.up_proj.weight", True),
    ("w_down", "mlp.down_proj.weight", True),
]

_MOE_LAYER_MAP = [
    ("attn_norm", "input_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True),
    ("wo", "self_attn.o_proj.weight", True),
    ("mlp_norm", "post_attention_layernorm.weight", False),
    ("router", "block_sparse_moe.gate.weight", True),
]

_BIAS_MAP = (("bq", "self_attn.q_proj.bias"), ("bk", "self_attn.k_proj.bias"),
             ("bv", "self_attn.v_proj.bias"))
_EXPERT_MAP = (("w_gate", "w1"), ("w_down", "w2"), ("w_up", "w3"))


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, str]]:
    """(tensors, ``__metadata__``) of one safetensors file. The tensors are
    CPU views into a private memory map of the file (pages are read on
    first touch; writing to a view never reaches the file)."""
    try:
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise ModelLoadError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            header = json.loads(f.read(n))
            size = os.fstat(f.fileno()).st_size
            mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                  if size > 8 + n else None)
    except (OSError, ValueError) as e:
        raise ModelLoadError(f"{path}: {e}") from None
    meta = header.pop("__metadata__", None) or {}
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ModelLoadError(
                f"{path}: tensor {name!r} has dtype {info['dtype']}, which "
                f"the loader does not read ({sorted(_ST_DTYPES)})")
        shape = tuple(int(d) for d in info["shape"])
        start, end = (int(o) for o in info["data_offsets"])
        count = 1
        for d in shape:
            count *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != count * itemsize or base + end > size:
            raise ModelLoadError(f"{path}: tensor {name!r} has bad offsets")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(mm, dtype=dtype, count=count,
                                     offset=base + start).view(shape)
    return out, dict(meta)


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device; each is copied to the host on its
    own while it is written) as one safetensors file with ``metadata``
    as its ``__metadata__``."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    # widest dtypes first, so every tensor's data stays aligned to its
    # element size (as the safetensors package lays them out)
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    off = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not "
                             "written")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = tensors[name].detach().contiguous().cpu()
            if t.numel():
                # numpy has no bfloat16: write the raw 16-bit words
                words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                f.write(memoryview(words.numpy()).cast("B"))


# ---------------------------------------------------------------------------
# HF state dict -> stacked tree
# ---------------------------------------------------------------------------


def params_from_hf_state_dict(
    state: Mapping[str, Any],
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """Convert an HF Llama / Mistral / Qwen2 / Gemma-2 / Mixtral state dict
    (torch tensors or numpy arrays) to the port's tree, each leaf built on
    the host and moved to ``device`` once as ``dtype``."""
    device = resolve_device(device)

    def get(name: str) -> torch.Tensor:
        if name not in state:
            raise ModelLoadError(f"missing weight {name!r}")
        return torch.as_tensor(state[name])

    def put(x: torch.Tensor) -> torch.Tensor:
        return x.to(device=device, dtype=dtype).contiguous()

    def stack(suffix: str, transpose: bool) -> torch.Tensor:
        rows = [get(f"model.layers.{i}.{suffix}") for i in range(cfg.num_layers)]
        return put(torch.stack([w.t() if transpose else w for w in rows]))

    # Gemma stores RMSNorm weights as offsets from 1 (applied as
    # x_norm * (1 + w)); our rms_norm multiplies by the weight directly,
    # so unit-offset checkpoints get +1 folded in at load time
    unit_offset = cfg.sandwich_norms

    layers: Dict[str, Any] = {}
    if cfg.attention_bias:  # Qwen2-style q/k/v bias
        for ours, suffix in _BIAS_MAP:
            layers[ours] = stack(suffix, False)
    if cfg.is_moe:
        for ours, suffix, t in _MOE_LAYER_MAP:
            layers[ours] = stack(suffix, t)
        for ours, part in _EXPERT_MAP:
            layers[ours] = put(torch.stack([
                torch.stack([get(f"model.layers.{i}.block_sparse_moe."
                                 f"experts.{e}.{part}.weight").t()
                             for e in range(cfg.num_experts)])
                for i in range(cfg.num_layers)]))
    else:
        for ours, suffix, t in _LAYER_MAP:
            layers[ours] = stack(suffix, t)
    if cfg.sandwich_norms:
        # HF Gemma-2: input_layernorm (pre-attention, attn_norm above),
        # post_attention_layernorm (the attention OUTPUT norm),
        # pre_feedforward_layernorm (pre-MLP), post_feedforward_layernorm
        layers["post_attn_norm"] = stack("post_attention_layernorm.weight",
                                         False)
        layers["mlp_norm"] = stack("pre_feedforward_layernorm.weight", False)
        layers["post_mlp_norm"] = stack("post_feedforward_layernorm.weight",
                                        False)
    if unit_offset:
        for k in ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm"):
            if k in layers:
                layers[k] = put(layers[k].float() + 1.0)

    final = get("model.norm.weight").float()
    params: Dict[str, Any] = {
        "embed": put(get("model.embed_tokens.weight")),
        "layers": layers,
        "final_norm": put(final + 1.0 if unit_offset else final),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = put(get("lm_head.weight").t())
    return params


def config_from_hf_json(obj: Mapping[str, Any], name: str = "hf"
                        ) -> ModelConfig:
    """Build a ModelConfig from an HF ``config.json`` dict."""
    if obj.get("model_type") == "gemma":
        # Gemma-1 stores unit-offset norm weights like Gemma-2, but the +1
        # fold keys on sandwich_norms (Gemma-2 only): refuse rather than
        # load silently wrong weights
        raise ModelLoadError(
            "Gemma-1 checkpoints are not supported (Gemma-2 is)")
    rope_scaling = None
    rs = obj.get("rope_scaling")
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        rope_scaling = RopeScaling(
            factor=float(rs.get("factor", 8.0)),
            low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            original_max_position=int(
                rs.get("original_max_position_embeddings", 8192)),
        )
    num_heads = int(obj["num_attention_heads"])
    hidden = int(obj["hidden_size"])
    model_type = obj.get("model_type")
    return ModelConfig(
        name=name,
        vocab_size=int(obj["vocab_size"]),
        hidden_size=hidden,
        intermediate_size=int(obj["intermediate_size"]),
        num_layers=int(obj["num_hidden_layers"]),
        num_heads=num_heads,
        num_kv_heads=int(obj.get("num_key_value_heads", num_heads)),
        # some configs carry an explicit head_dim: None (e.g. Mistral)
        head_dim=int(obj.get("head_dim") or hidden // num_heads),
        rms_norm_eps=float(obj.get("rms_norm_eps", 1e-5)),
        rope_theta=float(obj.get("rope_theta", 10000.0)),
        rope_scaling=rope_scaling,
        # HF defaults tie_word_embeddings to TRUE when the key is absent or
        # null (Gemma-2 ships null and ties; Llama ships an explicit false)
        tie_word_embeddings=(
            True if obj.get("tie_word_embeddings") is None
            else bool(obj["tie_word_embeddings"])),
        max_position_embeddings=int(obj.get("max_position_embeddings", 8192)),
        num_experts=int(obj.get("num_local_experts", 0)),
        num_experts_per_tok=int(obj.get("num_experts_per_tok", 2)),
        # Mistral-style window (qwen2 gates it behind use_sliding_window)
        sliding_window=(
            int(obj["sliding_window"])
            if obj.get("sliding_window")
            and obj.get("use_sliding_window", True) else None),
        # Qwen2 sets q/k/v bias (qkv_bias, or the architecture default)
        attention_bias=bool(obj.get("attention_bias", obj.get(
            "qkv_bias", model_type == "qwen2"))),
        # Gemma-2 architecture switches
        sliding_window_pattern=(
            2 if model_type == "gemma2" and obj.get("sliding_window")
            else None),
        activation=(
            "gelu_tanh"
            if obj.get("hidden_activation", obj.get("hidden_act"))
            in ("gelu_pytorch_tanh", "gelu_tanh") else "silu"),
        sandwich_norms=model_type == "gemma2",
        final_logit_softcap=(
            float(obj["final_logit_softcapping"])
            if obj.get("final_logit_softcapping") else None),
        attn_logit_softcap=(
            float(obj["attn_logit_softcapping"])
            if obj.get("attn_logit_softcapping") else None),
        query_pre_attn_scalar=(
            float(obj["query_pre_attn_scalar"])
            if obj.get("query_pre_attn_scalar") else None),
        scale_embeddings=model_type == "gemma2",
    )


def _shard_files(model_dir: str) -> Iterable[str]:
    """The checkpoint's shard paths: those the index names when there is
    one (each must exist), else every ``*.safetensors`` in the directory."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            names = sorted(set(json.load(f).get("weight_map", {}).values()))
        missing = [n for n in names
                   if not os.path.exists(os.path.join(model_dir, n))]
        if missing:
            raise ModelLoadError(f"shards named by the index are missing in "
                                 f"{model_dir}: {missing}")
    else:
        names = sorted(f for f in os.listdir(model_dir)
                       if f.endswith(".safetensors"))
    if not names:
        raise ModelLoadError(f"no *.safetensors files in {model_dir}")
    return [os.path.join(model_dir, n) for n in names]


def load_checkpoint(
    model_dir: str,
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = "cuda",
) -> Tuple[Dict[str, Any], ModelConfig]:
    """Load an HF-format checkpoint directory (config.json +
    *.safetensors) onto ``device`` as ``dtype``."""
    cfg_path = os.path.join(model_dir, "config.json")
    if not os.path.exists(cfg_path):
        raise ModelLoadError(f"no config.json in {model_dir}")
    with open(cfg_path) as f:
        cfg = config_from_hf_json(
            json.load(f), name=os.path.basename(os.path.normpath(model_dir)))
    state: Dict[str, torch.Tensor] = {}
    for path in _shard_files(model_dir):
        state.update(read_safetensors(path)[0])
    # the CHECKPOINT decides head tying, not config.json: HF writes tied
    # models WITHOUT lm_head.weight and untied ones WITH it, so a config
    # claiming tied while the shards carry a head would unembed with the
    # embedding matrix
    untied = "lm_head.weight" in state
    if untied == cfg.tie_word_embeddings:
        cfg = cfg.with_overrides(tie_word_embeddings=not untied)
    return params_from_hf_state_dict(state, cfg, dtype, device), cfg


# ---------------------------------------------------------------------------
# Save path: stacked tree -> HF-format checkpoint directory
# ---------------------------------------------------------------------------


def _model_type(cfg: ModelConfig) -> str:
    if cfg.sandwich_norms:
        return "gemma2"
    if cfg.is_moe:
        return "mixtral"
    if cfg.attention_bias:
        return "qwen2"
    if cfg.sliding_window:
        return "mistral"
    return "llama"


def config_to_hf_json(cfg: ModelConfig) -> Dict[str, Any]:
    """HF ``config.json`` dict for ``cfg``: the inverse of
    ``config_from_hf_json`` (round-trips through it)."""
    obj: Dict[str, Any] = {
        "model_type": _model_type(cfg),
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "max_position_embeddings": cfg.max_position_embeddings,
        "attention_bias": cfg.attention_bias,
    }
    if cfg.rope_scaling is not None:
        rs = cfg.rope_scaling
        obj["rope_scaling"] = {
            "rope_type": "llama3",
            "factor": rs.factor,
            "low_freq_factor": rs.low_freq_factor,
            "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings": rs.original_max_position,
        }
    if cfg.is_moe:
        obj["num_local_experts"] = cfg.num_experts
        obj["num_experts_per_tok"] = cfg.num_experts_per_tok
    if cfg.sliding_window:
        obj["sliding_window"] = cfg.sliding_window
    if cfg.activation == "gelu_tanh":
        obj["hidden_activation"] = "gelu_pytorch_tanh"
    if cfg.sandwich_norms:  # Gemma-2 block
        if cfg.final_logit_softcap:
            obj["final_logit_softcapping"] = cfg.final_logit_softcap
        if cfg.attn_logit_softcap:
            obj["attn_logit_softcapping"] = cfg.attn_logit_softcap
        if cfg.query_pre_attn_scalar:
            obj["query_pre_attn_scalar"] = cfg.query_pre_attn_scalar
    return obj


def hf_state_dict_from_params(
    params: Mapping[str, Any], cfg: ModelConfig,
    dtype: Optional[torch.dtype] = torch.float32,
) -> Dict[str, torch.Tensor]:
    """The stacked tree -> an HF-named per-layer state dict: the inverse of
    ``params_from_hf_state_dict``. Leaves stay on their device (views where
    no arithmetic is needed); ``dtype`` None keeps each leaf's dtype,
    otherwise every tensor is cast (the JAX package writes float32).
    Quantized weights are densified; Gemma-2 unit-offset norms get the -1
    fold so HF semantics (applied as 1 + w) hold for the written weights."""
    def dn(w) -> torch.Tensor:
        if is_quantized(w):
            return dequantize(w, dtype or torch.float32)
        return w if dtype is None else w.to(dtype)

    def norm_out(x: torch.Tensor) -> torch.Tensor:
        return (x.float() - 1.0).to(x.dtype) if cfg.sandwich_norms else x

    layers = params["layers"]
    state: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": dn(params["embed"]),
        "model.norm.weight": norm_out(dn(params["final_norm"])),
    }
    if not cfg.tie_word_embeddings:
        state["lm_head.weight"] = dn(params["lm_head"]).t()

    norm_map = [("attn_norm", "input_layernorm.weight")]
    if cfg.sandwich_norms:
        norm_map += [
            ("post_attn_norm", "post_attention_layernorm.weight"),
            ("mlp_norm", "pre_feedforward_layernorm.weight"),
            ("post_mlp_norm", "post_feedforward_layernorm.weight"),
        ]
    else:
        norm_map += [("mlp_norm", "post_attention_layernorm.weight")]
    # projections come from the same maps the load path uses, so the two
    # directions cannot drift
    proj_map = [(ours, suffix, t) for ours, suffix, t in
                (_MOE_LAYER_MAP if cfg.is_moe else _LAYER_MAP)
                if ours not in ("attn_norm", "mlp_norm")]
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        for ours, suffix in norm_map:
            state[pre + suffix] = norm_out(dn(layers[ours][i]))
        for ours, suffix, t in proj_map:
            w = dn(layer_weight(layers[ours], i))
            state[pre + suffix] = w.t() if t else w
        if cfg.attention_bias:
            for ours, suffix in _BIAS_MAP:
                state[pre + suffix] = dn(layers[ours][i])
        if cfg.is_moe:
            for ours, part in _EXPERT_MAP:
                for e in range(cfg.num_experts):
                    state[pre + f"block_sparse_moe.experts.{e}.{part}."
                          "weight"] = dn(layers[ours][i][e]).t()
    return state


def save_checkpoint(params: Mapping[str, Any], cfg: ModelConfig,
                    model_dir: str,
                    dtype: Optional[torch.dtype] = torch.float32) -> None:
    """Write an HF-format checkpoint directory (config.json + one
    safetensors shard with ``{"format": "pt"}`` metadata) that
    ``load_checkpoint``, the JAX package's loader (float32 files) or the
    ``safetensors`` package restores. ``dtype`` as in
    ``hf_state_dict_from_params``."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config_to_hf_json(cfg), f, indent=1)
    write_safetensors(os.path.join(model_dir, "model.safetensors"),
                      hf_state_dict_from_params(params, cfg, dtype),
                      {"format": "pt"})
