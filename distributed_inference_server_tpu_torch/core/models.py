"""Request/response wire models for ``/generate`` (port of
``distributed_inference_server_tpu/core/models.py``).

The JSON field names, defaults (max_tokens=256, temperature=1.0, top_p=1.0)
and snake_case finish reasons are identical to the reference's, so a client
cannot tell the two servers apart by their bodies.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from distributed_inference_server_tpu_torch.core.errors import (
    InvalidJson,
    MissingField,
)
from distributed_inference_server_tpu_torch.core.types import Priority

DEFAULT_MAX_TOKENS = 256
DEFAULT_TEMPERATURE = 1.0
DEFAULT_TOP_P = 1.0


def _require(obj: Dict[str, Any], key: str) -> Any:
    if key not in obj:
        raise MissingField(key)
    return obj[key]


def _expect_dict(value: Any, what: str) -> Dict[str, Any]:
    if not isinstance(value, dict):
        raise InvalidJson(f"expected object for {what}, got {type(value).__name__}")
    return value


def _as_int(value: Any, field_name: str) -> int:
    if isinstance(value, bool) or not isinstance(value, int):
        raise InvalidJson(f"{field_name} must be an integer")
    return value


def _as_float(value: Any, field_name: str) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise InvalidJson(f"{field_name} must be a number")
    return float(value)


def _as_bool(value: Any, field_name: str) -> bool:
    if not isinstance(value, bool):
        raise InvalidJson(f"{field_name} must be a boolean")
    return value


def _as_str_list(value: Any, field_name: str) -> List[str]:
    if value is None:
        return []
    if not isinstance(value, list) or not all(isinstance(x, str) for x in value):
        raise InvalidJson(f"{field_name} must be an array of strings")
    return list(value)


@dataclass(frozen=True)
class Usage:
    """Token usage statistics returned with every response."""

    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0

    @classmethod
    def of(cls, prompt_tokens: int, completion_tokens: int) -> "Usage":
        return cls(prompt_tokens, completion_tokens, prompt_tokens + completion_tokens)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "prompt_tokens": self.prompt_tokens,
            "completion_tokens": self.completion_tokens,
            "total_tokens": self.total_tokens,
        }

class FinishReason(str, enum.Enum):
    """Why generation stopped (snake_case wire values)."""

    STOP = "stop"  # model generated a stop/EOS token
    LENGTH = "length"  # reached max_tokens limit
    STOP_SEQUENCE = "stop_sequence"  # hit a user stop sequence


@dataclass
class GenerateRequest:
    """POST /generate body."""

    prompt: str = ""
    max_tokens: int = DEFAULT_MAX_TOKENS
    temperature: float = DEFAULT_TEMPERATURE
    top_p: float = DEFAULT_TOP_P
    stop_sequences: List[str] = field(default_factory=list)
    stream: bool = False
    priority: Optional[Priority] = None

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "GenerateRequest":
        obj = _expect_dict(obj, "request")
        prompt = _require(obj, "prompt")
        if not isinstance(prompt, str):
            raise InvalidJson("prompt must be a string")
        priority = obj.get("priority")
        try:
            parsed_priority = None if priority is None else Priority.parse(priority)
        except ValueError as e:
            raise InvalidJson(str(e)) from None
        return cls(
            prompt=prompt,
            max_tokens=_as_int(obj.get("max_tokens", DEFAULT_MAX_TOKENS), "max_tokens"),
            temperature=_as_float(
                obj.get("temperature", DEFAULT_TEMPERATURE), "temperature"
            ),
            top_p=_as_float(obj.get("top_p", DEFAULT_TOP_P), "top_p"),
            stop_sequences=_as_str_list(obj.get("stop_sequences"), "stop_sequences"),
            stream=_as_bool(obj.get("stream", False), "stream"),
            priority=parsed_priority,
        )

@dataclass(frozen=True)
class GenerateChoice:
    """A single completion choice."""

    text: str
    index: int
    finish_reason: FinishReason

    def to_dict(self) -> Dict[str, Any]:
        return {
            "text": self.text,
            "index": self.index,
            "finish_reason": self.finish_reason.value,
        }

@dataclass(frozen=True)
class GenerateResponse:
    """POST /generate response; object == "text_completion"."""

    id: str
    object: str
    created: int
    model: str
    choices: Sequence[GenerateChoice]
    usage: Usage

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "object": self.object,
            "created": self.created,
            "model": self.model,
            "choices": [c.to_dict() for c in self.choices],
            "usage": self.usage.to_dict(),
        }

@dataclass(frozen=True)
class ErrorDetail:
    """Error details: human message, error-type string, machine code."""

    message: str
    error_type: str
    code: str

    def to_dict(self) -> Dict[str, Any]:
        return {
            "message": self.message,
            "error_type": self.error_type,
            "code": self.code,
        }

@dataclass(frozen=True)
class ErrorResponse:
    """Error response body returned on any failure."""

    error: ErrorDetail

    @classmethod
    def of(cls, message: str, error_type: str, code: str) -> "ErrorResponse":
        return cls(ErrorDetail(message=message, error_type=error_type, code=code))

    def to_dict(self) -> Dict[str, Any]:
        return {"error": self.error.to_dict()}
