"""Request/response wire models for every endpoint (port of
``distributed_inference_server_tpu/core/models.py``).

The JSON field names, defaults (max_tokens=256, temperature=1.0,
top_p=1.0), the tagged-union SSE ``TokenEvent`` encoding, the untagged
single-or-array embeddings input and the snake_case finish reasons are
identical to the reference's, so a client cannot tell the two servers
apart by their bodies, and each package's ``from_dict`` parses the
other's JSON field for field.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

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
    """Strict JSON integer (bool is not an integer here)."""
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


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


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

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "Usage":
        obj = _expect_dict(obj, "usage")
        return cls(
            prompt_tokens=_as_int(_require(obj, "prompt_tokens"), "prompt_tokens"),
            completion_tokens=_as_int(
                _require(obj, "completion_tokens"), "completion_tokens"
            ),
            total_tokens=_as_int(_require(obj, "total_tokens"), "total_tokens"),
        )


class FinishReason(str, enum.Enum):
    """Why generation stopped."""

    STOP = "stop"  # model generated a stop/EOS token
    LENGTH = "length"  # reached max_tokens limit
    STOP_SEQUENCE = "stop_sequence"  # hit a user stop sequence

    @classmethod
    def parse(cls, value: Any) -> "FinishReason":
        try:
            return cls(value)
        except ValueError:
            raise InvalidJson(f"invalid finish_reason: {value!r}") from None


class Role(str, enum.Enum):
    """Chat message role."""

    SYSTEM = "system"
    USER = "user"
    ASSISTANT = "assistant"

    @classmethod
    def parse(cls, value: Any) -> "Role":
        try:
            return cls(value)
        except ValueError:
            raise InvalidJson(f"invalid role: {value!r}") from None


@dataclass(frozen=True)
class ChatMessage:
    """A single message in a chat conversation."""

    role: Role
    content: str

    def to_dict(self) -> Dict[str, Any]:
        return {"role": self.role.value, "content": self.content}

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "ChatMessage":
        obj = _expect_dict(obj, "message")
        return cls(
            role=Role.parse(_require(obj, "role")),
            content=str(_require(obj, "content")),
        )


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------


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

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "prompt": self.prompt,
            "max_tokens": self.max_tokens,
            "temperature": self.temperature,
            "top_p": self.top_p,
            "stop_sequences": list(self.stop_sequences),
            "stream": self.stream,
        }
        if self.priority is not None:
            out["priority"] = self.priority.to_json()
        return out


@dataclass
class ChatRequest:
    """POST /chat body."""

    messages: List[ChatMessage] = field(default_factory=list)
    max_tokens: int = DEFAULT_MAX_TOKENS
    temperature: float = DEFAULT_TEMPERATURE
    top_p: float = DEFAULT_TOP_P
    stop_sequences: List[str] = field(default_factory=list)
    stream: bool = False

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "ChatRequest":
        obj = _expect_dict(obj, "request")
        raw_messages = _require(obj, "messages")
        if not isinstance(raw_messages, list):
            raise InvalidJson("messages must be an array")
        return cls(
            messages=[ChatMessage.from_dict(m) for m in raw_messages],
            max_tokens=_as_int(obj.get("max_tokens", DEFAULT_MAX_TOKENS), "max_tokens"),
            temperature=_as_float(
                obj.get("temperature", DEFAULT_TEMPERATURE), "temperature"
            ),
            top_p=_as_float(obj.get("top_p", DEFAULT_TOP_P), "top_p"),
            stop_sequences=_as_str_list(obj.get("stop_sequences"), "stop_sequences"),
            stream=_as_bool(obj.get("stream", False), "stream"),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "messages": [m.to_dict() for m in self.messages],
            "max_tokens": self.max_tokens,
            "temperature": self.temperature,
            "top_p": self.top_p,
            "stop_sequences": list(self.stop_sequences),
            "stream": self.stream,
        }


@dataclass
class EmbeddingsRequest:
    """POST /embeddings body. ``input`` is a
    single string or an array of strings (an untagged union)."""

    input: Union[str, List[str]] = ""
    model: Optional[str] = None

    def input_list(self) -> List[str]:
        """All inputs as a list."""
        if isinstance(self.input, str):
            return [self.input]
        return list(self.input)

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "EmbeddingsRequest":
        obj = _expect_dict(obj, "request")
        raw = _require(obj, "input")
        if isinstance(raw, str):
            parsed: Union[str, List[str]] = raw
        elif isinstance(raw, list) and all(isinstance(x, str) for x in raw):
            parsed = list(raw)
        else:
            raise InvalidJson("input must be a string or array of strings")
        model = obj.get("model")
        return cls(input=parsed, model=None if model is None else str(model))

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"input": self.input}
        if self.model is not None:
            out["model"] = self.model
        return out


# ---------------------------------------------------------------------------
# Responses
# ---------------------------------------------------------------------------


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

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "GenerateChoice":
        obj = _expect_dict(obj, "choice")
        return cls(
            text=str(_require(obj, "text")),
            index=_as_int(_require(obj, "index"), "index"),
            finish_reason=FinishReason.parse(_require(obj, "finish_reason")),
        )


@dataclass(frozen=True)
class GenerateResponse:
    """POST /generate response;
    object == "text_completion"."""

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

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "GenerateResponse":
        obj = _expect_dict(obj, "response")
        return cls(
            id=str(_require(obj, "id")),
            object=str(_require(obj, "object")),
            created=_as_int(_require(obj, "created"), "created"),
            model=str(_require(obj, "model")),
            choices=tuple(
                GenerateChoice.from_dict(c) for c in _require(obj, "choices")
            ),
            usage=Usage.from_dict(_require(obj, "usage")),
        )


@dataclass(frozen=True)
class ChatChoice:
    """A single chat completion choice."""

    index: int
    message: ChatMessage
    finish_reason: FinishReason

    def to_dict(self) -> Dict[str, Any]:
        return {
            "index": self.index,
            "message": self.message.to_dict(),
            "finish_reason": self.finish_reason.value,
        }

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "ChatChoice":
        obj = _expect_dict(obj, "choice")
        return cls(
            index=_as_int(_require(obj, "index"), "index"),
            message=ChatMessage.from_dict(_require(obj, "message")),
            finish_reason=FinishReason.parse(_require(obj, "finish_reason")),
        )


@dataclass(frozen=True)
class ChatResponse:
    """POST /chat response;
    object == "chat.completion"."""

    id: str
    object: str
    created: int
    model: str
    choices: Sequence[ChatChoice]
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

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "ChatResponse":
        obj = _expect_dict(obj, "response")
        return cls(
            id=str(_require(obj, "id")),
            object=str(_require(obj, "object")),
            created=_as_int(_require(obj, "created"), "created"),
            model=str(_require(obj, "model")),
            choices=tuple(ChatChoice.from_dict(c) for c in _require(obj, "choices")),
            usage=Usage.from_dict(_require(obj, "usage")),
        )


@dataclass(frozen=True)
class EmbeddingData:
    """A single embedding result;
    object == "embedding"."""

    object: str
    embedding: Sequence[float]
    index: int

    def to_dict(self) -> Dict[str, Any]:
        return {
            "object": self.object,
            "embedding": list(self.embedding),
            "index": self.index,
        }

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "EmbeddingData":
        obj = _expect_dict(obj, "embedding data")
        return cls(
            object=str(_require(obj, "object")),
            embedding=tuple(
                _as_float(x, "embedding") for x in _require(obj, "embedding")
            ),
            index=_as_int(_require(obj, "index"), "index"),
        )


@dataclass(frozen=True)
class EmbeddingsResponse:
    """POST /embeddings response;
    object == "list"."""

    object: str
    data: Sequence[EmbeddingData]
    model: str
    usage: Usage

    def to_dict(self) -> Dict[str, Any]:
        return {
            "object": self.object,
            "data": [d.to_dict() for d in self.data],
            "model": self.model,
            "usage": self.usage.to_dict(),
        }

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "EmbeddingsResponse":
        obj = _expect_dict(obj, "response")
        return cls(
            object=str(_require(obj, "object")),
            data=tuple(EmbeddingData.from_dict(d) for d in _require(obj, "data")),
            model=str(_require(obj, "model")),
            usage=Usage.from_dict(_require(obj, "usage")),
        )


# ---------------------------------------------------------------------------
# Error response body
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ErrorDetail:
    """Error details: human message, error-type
    string (e.g. "invalid_request_error"), machine code (e.g. "invalid_json")."""

    message: str
    error_type: str
    code: str

    def to_dict(self) -> Dict[str, Any]:
        return {
            "message": self.message,
            "error_type": self.error_type,
            "code": self.code,
        }

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "ErrorDetail":
        obj = _expect_dict(obj, "error detail")
        return cls(
            message=str(_require(obj, "message")),
            error_type=str(_require(obj, "error_type")),
            code=str(_require(obj, "code")),
        )


@dataclass(frozen=True)
class ErrorResponse:
    """Error response body returned on any failure."""

    error: ErrorDetail

    @classmethod
    def of(cls, message: str, error_type: str, code: str) -> "ErrorResponse":
        return cls(ErrorDetail(message=message, error_type=error_type, code=code))

    def to_dict(self) -> Dict[str, Any]:
        return {"error": self.error.to_dict()}

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "ErrorResponse":
        obj = _expect_dict(obj, "error response")
        return cls(error=ErrorDetail.from_dict(_require(obj, "error")))


# ---------------------------------------------------------------------------
# Streaming events (SSE payloads)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TokenEvent:
    """Tagged-union SSE event.

    Wire format: ``{"type": "token", "token": ..., "index": ..., "logprob"?}``,
    ``{"type": "done", "finish_reason": ..., "usage": {...}}``,
    ``{"type": "error", "messages": ..., "code": ...}``.

    Note the "messages" (plural) field name on the error variant matches the
    reference's wire format verbatim. ``logprob`` is omitted when
    absent.
    """

    type: str
    # token variant
    token: Optional[str] = None
    index: Optional[int] = None
    logprob: Optional[float] = None
    # done variant
    finish_reason: Optional[FinishReason] = None
    usage: Optional[Usage] = None
    # error variant
    messages: Optional[str] = None
    code: Optional[str] = None

    @classmethod
    def token_event(
        cls, token: str, index: int, logprob: Optional[float] = None
    ) -> "TokenEvent":
        return cls(type="token", token=token, index=index, logprob=logprob)

    @classmethod
    def done_event(cls, finish_reason: FinishReason, usage: Usage) -> "TokenEvent":
        return cls(type="done", finish_reason=finish_reason, usage=usage)

    @classmethod
    def error_event(cls, messages: str, code: str) -> "TokenEvent":
        return cls(type="error", messages=messages, code=code)

    def to_dict(self) -> Dict[str, Any]:
        if self.type == "token":
            out: Dict[str, Any] = {
                "type": "token",
                "token": self.token,
                "index": self.index,
            }
            if self.logprob is not None:
                out["logprob"] = self.logprob
            return out
        if self.type == "done":
            assert self.finish_reason is not None and self.usage is not None
            return {
                "type": "done",
                "finish_reason": self.finish_reason.value,
                "usage": self.usage.to_dict(),
            }
        if self.type == "error":
            return {"type": "error", "messages": self.messages, "code": self.code}
        raise ValueError(f"unknown TokenEvent type: {self.type}")

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "TokenEvent":
        obj = _expect_dict(obj, "token event")
        kind = _require(obj, "type")
        if kind == "token":
            logprob = obj.get("logprob")
            return cls.token_event(
                token=str(_require(obj, "token")),
                index=_as_int(_require(obj, "index"), "index"),
                logprob=None if logprob is None else _as_float(logprob, "logprob"),
            )
        if kind == "done":
            return cls.done_event(
                finish_reason=FinishReason.parse(_require(obj, "finish_reason")),
                usage=Usage.from_dict(_require(obj, "usage")),
            )
        if kind == "error":
            return cls.error_event(
                messages=str(_require(obj, "messages")),
                code=str(_require(obj, "code")),
            )
        raise InvalidJson(f"unknown token event type: {kind!r}")


# ---------------------------------------------------------------------------
# JSON helpers
# ---------------------------------------------------------------------------


def dumps(model: Any) -> str:
    """Serialize any model above (or a plain dict) to a JSON string."""
    obj = model.to_dict() if hasattr(model, "to_dict") else model
    return json.dumps(obj, separators=(",", ":"))


def loads(cls: type, payload: Union[str, bytes]) -> Any:
    """Parse a JSON payload into the given model class, raising
    ``InvalidJson`` on malformed input."""
    try:
        obj = json.loads(payload)
    except json.JSONDecodeError as e:
        raise InvalidJson(str(e)) from None
    return cls.from_dict(obj)


__all__ = [
    "DEFAULT_MAX_TOKENS",
    "DEFAULT_TEMPERATURE",
    "DEFAULT_TOP_P",
    "Usage",
    "FinishReason",
    "Role",
    "ChatMessage",
    "GenerateRequest",
    "ChatRequest",
    "EmbeddingsRequest",
    "GenerateChoice",
    "GenerateResponse",
    "ChatChoice",
    "ChatResponse",
    "EmbeddingData",
    "EmbeddingsResponse",
    "ErrorDetail",
    "ErrorResponse",
    "TokenEvent",
    "dumps",
    "loads",
]
