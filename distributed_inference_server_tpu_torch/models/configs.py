"""Model architecture configurations (port of
``distributed_inference_server_tpu/models/configs.py``: the dataclasses and
the presets this slice serves).

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
    """Dense Llama-family transformer description. Fields the reference
    uses for other families (MoE, sandwich norms, Gemma scaling) are kept
    so configs convert one-to-one; this slice serves dense Llama only and
    ``models/llama.py`` rejects the others."""

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

# Tiny config for tests: small enough to run on the CPU in milliseconds.
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

PRESETS = {c.name: c for c in (LLAMA_3_2_1B, TINY)}


def get_config(name: str) -> ModelConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown model preset {name!r}; known: {sorted(PRESETS)}"
        ) from None
