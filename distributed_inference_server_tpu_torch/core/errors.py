"""Error taxonomy with HTTP status mapping (port of
``distributed_inference_server_tpu/core/errors.py``: the validation, API and
cache errors the ``/generate`` path raises). Codes, status codes and
error-type strings are identical to the reference's."""

from __future__ import annotations


# -- validation errors --------------------------------------------------------


class ValidationError(Exception):
    """Base class for request-validation failures. ``code`` is the stable
    machine-readable string placed in the JSON error body."""

    code = "validation_error"


class InvalidJson(ValidationError):
    code = "invalid_json"

    def __init__(self, detail: str):
        super().__init__(f"Invalid JSON: {detail}")
        self.detail = detail


class MissingField(ValidationError):
    code = "missing_field"

    def __init__(self, field: str):
        super().__init__(f"Missing required field: {field}")
        self.field = field


class TokenLimitExceeded(ValidationError):
    code = "token_limit_exceeded"

    def __init__(self, actual: int, limit: int):
        super().__init__(f"Token limit exceeded: {actual} tokens > {limit} max")
        self.actual = actual
        self.limit = limit


class InvalidParameter(ValidationError):
    code = "invalid_parameter"

    def __init__(self, field: str, reason: str):
        super().__init__(f"Invalid parameter '{field}': {reason}")
        self.field = field
        self.reason = reason


class EmptyPrompt(ValidationError):
    code = "empty_prompt"

    def __init__(self) -> None:
        super().__init__("Empty prompt not allowed")


# -- API-level errors -> HTTP responses --------------------------------------


class ApiError(Exception):
    """API-level error returned to the client as an HTTP response."""

    def status_code(self) -> int:
        raise NotImplementedError

    def error_type(self) -> str:
        raise NotImplementedError

    def code(self) -> str:
        return "api_error"


class ValidationApiError(ApiError):
    """Wraps a ValidationError; HTTP 400 / invalid_request_error."""

    def __init__(self, cause: ValidationError):
        super().__init__(f"Validation error: {cause}")
        self.cause = cause

    def status_code(self) -> int:
        return 400

    def error_type(self) -> str:
        return "invalid_request_error"

    def code(self) -> str:
        return self.cause.code


class RequestTimeoutApiError(ApiError):
    """HTTP 408 / timeout_error."""

    def __init__(self) -> None:
        super().__init__("Request timeout")

    def status_code(self) -> int:
        return 408

    def error_type(self) -> str:
        return "timeout_error"

    def code(self) -> str:
        return "request_timeout"


class InternalApiError(ApiError):
    """HTTP 500 / server_error."""

    def __init__(self, detail: str):
        super().__init__(f"Internal server error: {detail}")
        self.detail = detail

    def status_code(self) -> int:
        return 500

    def error_type(self) -> str:
        return "server_error"

    def code(self) -> str:
        return "internal_error"


# -- cache errors -------------------------------------------------------------


class CacheError(Exception):
    pass


class CacheFull(CacheError):
    def __init__(self) -> None:
        super().__init__("Cache full")
