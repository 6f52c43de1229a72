"""Request validation against configurable limits (port of
``distributed_inference_server_tpu/core/validator.py``, ``/generate`` only).

The chars/4 token estimate is the admission check; the engine re-counts with
the real tokenizer and rejects prompts it cannot seat.
"""

from __future__ import annotations

from dataclasses import dataclass

from distributed_inference_server_tpu_torch.core.errors import (
    EmptyPrompt,
    InvalidParameter,
    TokenLimitExceeded,
)
from distributed_inference_server_tpu_torch.core.models import GenerateRequest


@dataclass(frozen=True)
class ValidatorConfig:
    max_context_tokens: int = 8192
    max_output_tokens: int = 4096
    min_temperature: float = 0.0
    max_temperature: float = 2.0
    min_top_p: float = 0.0
    max_top_p: float = 1.0


class RequestValidator:
    def __init__(self, config: ValidatorConfig | None = None):
        self.config = config or ValidatorConfig()

    def token_count(self, text: str) -> int:
        """Admission-time token estimate: ceil(len/4), 0 for empty."""
        if not text:
            return 0
        return (len(text) + 3) // 4

    def validate_generate(self, request: GenerateRequest) -> GenerateRequest:
        cfg = self.config
        if not request.prompt.strip():
            raise EmptyPrompt()
        prompt_tokens = self.token_count(request.prompt)
        if prompt_tokens > cfg.max_context_tokens:
            raise TokenLimitExceeded(prompt_tokens, cfg.max_context_tokens)
        if request.max_tokens < 0 or request.max_tokens > cfg.max_output_tokens:
            raise InvalidParameter(
                "max_tokens",
                f"must be <= {cfg.max_output_tokens}, got {request.max_tokens}",
            )
        if not (cfg.min_temperature <= request.temperature <= cfg.max_temperature):
            raise InvalidParameter(
                "temperature",
                f"must be between {cfg.min_temperature} and "
                f"{cfg.max_temperature}, got {request.temperature}",
            )
        if not (cfg.min_top_p <= request.top_p <= cfg.max_top_p):
            raise InvalidParameter(
                "top_p",
                f"must be between {cfg.min_top_p} and {cfg.max_top_p}, "
                f"got {request.top_p}",
            )
        return request
