"""Model architecture configurations (port of
``distributed_inference_server_tpu/models/configs.py``: the dataclasses and
every preset, the test configs included).

``head_dim`` may differ from ``hidden_size // num_heads`` (e.g. Llama-3.2).
``num_kv_heads < num_heads`` gives grouped-query attention.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class RopeScaling:
    """Llama-3 style rope frequency scaling."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192


@dataclass(frozen=True)
class ModelConfig:
    """Llama-family transformer description: dense Llama and Mistral, and
    the fields of the other families the JAX package serves (Mixtral's
    experts, Qwen2's q/k/v bias, Gemma-2's sandwich norms, soft-caps,
    scalings and alternating windows)."""

    name: str = "unnamed"
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScaling] = None
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 131072
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    sliding_window: Optional[int] = None
    sliding_window_pattern: Optional[int] = None
    attention_bias: bool = False
    activation: str = "silu"
    sandwich_norms: bool = False
    final_logit_softcap: Optional[float] = None
    attn_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    scale_embeddings: bool = False

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer sliding windows (0 = full causal)."""
        if not self.sliding_window:
            return (0,) * self.num_layers
        if not self.sliding_window_pattern:
            return (self.sliding_window,) * self.num_layers
        p = self.sliding_window_pattern
        return tuple(
            self.sliding_window if i % p == 0 else 0
            for i in range(self.num_layers)
        )

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


LLAMA_3_2_1B = ModelConfig(
    name="llama-3.2-1b",
    vocab_size=128256,
    hidden_size=2048,
    intermediate_size=8192,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    rope_theta=500000.0,
    rope_scaling=RopeScaling(factor=32.0, low_freq_factor=1.0,
                             high_freq_factor=4.0, original_max_position=8192),
    tie_word_embeddings=True,
)

LLAMA_3_8B = ModelConfig(
    name="llama-3-8b",
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500000.0,
    tie_word_embeddings=False,
)

LLAMA_3_70B = ModelConfig(
    name="llama-3-70b",
    vocab_size=128256,
    hidden_size=8192,
    intermediate_size=28672,
    num_layers=80,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500000.0,
    tie_word_embeddings=False,
)

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=1e6,
    tie_word_embeddings=False,
    num_experts=8,
    num_experts_per_tok=2,
)

MISTRAL_7B = ModelConfig(
    name="mistral-7b",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rms_norm_eps=1e-5,
    rope_theta=10000.0,
    tie_word_embeddings=False,
    max_position_embeddings=32768,
    sliding_window=4096,
)

QWEN2_7B = ModelConfig(
    name="qwen2-7b",
    vocab_size=152064,
    hidden_size=3584,
    intermediate_size=18944,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    rms_norm_eps=1e-6,
    rope_theta=1e6,
    tie_word_embeddings=False,
    max_position_embeddings=131072,
    attention_bias=True,
)

GEMMA2_9B = ModelConfig(
    name="gemma2-9b",
    vocab_size=256000,
    hidden_size=3584,
    intermediate_size=14336,
    num_layers=42,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    rms_norm_eps=1e-6,
    rope_theta=10000.0,
    tie_word_embeddings=True,
    max_position_embeddings=8192,
    sliding_window=4096,
    sliding_window_pattern=2,
    activation="gelu_tanh",
    sandwich_norms=True,
    final_logit_softcap=30.0,
    attn_logit_softcap=50.0,
    query_pre_attn_scalar=256.0,
    scale_embeddings=True,
)

# Tiny configs for tests: small enough to run on the CPU in milliseconds.
TINY = ModelConfig(
    name="tiny",
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    rope_theta=10000.0,
    tie_word_embeddings=True,
    max_position_embeddings=512,
)

TINY_MOE = TINY.with_overrides(name="tiny-moe", num_experts=4,
                               num_experts_per_tok=2)
TINY_SWA = TINY.with_overrides(name="tiny-swa", sliding_window=8)
TINY_BIAS = TINY.with_overrides(name="tiny-bias", attention_bias=True)
TINY_GEMMA2 = TINY.with_overrides(
    name="tiny-gemma2",
    sliding_window=8,
    sliding_window_pattern=2,
    activation="gelu_tanh",
    sandwich_norms=True,
    final_logit_softcap=30.0,
    attn_logit_softcap=50.0,
    query_pre_attn_scalar=24.0,  # deliberately != head_dim
    scale_embeddings=True,
)

PRESETS = {
    c.name: c
    for c in (LLAMA_3_2_1B, LLAMA_3_8B, LLAMA_3_70B, MIXTRAL_8X7B,
              MISTRAL_7B, QWEN2_7B, GEMMA2_9B, TINY, TINY_MOE, TINY_SWA,
              TINY_BIAS, TINY_GEMMA2)
}


def get_config(name: str) -> ModelConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown model preset {name!r}; known: {sorted(PRESETS)}"
        ) from None
