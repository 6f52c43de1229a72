"""gRPC transport (the port of
``distributed_inference_server_tpu/serving/grpc_server.py``): the second
API surface beside HTTP, over the same ``InferenceHandler``.

The contract is ``serving/inference.proto``:

  dis.tpu.InferenceService/Generate        unary    (GenerateRequest)
  dis.tpu.InferenceService/GenerateStream  s-stream (TokenEvent frames)
  dis.tpu.InferenceService/Chat            unary
  dis.tpu.InferenceService/ChatStream      s-stream
  dis.tpu.InferenceService/Embeddings      unary
  dis.tpu.InferenceService/Health          unary    ({status, accepting,
                                                     engines})

Each method accepts both encodings and answers in kind, detected per
request: a payload whose first byte is ``{`` is JSON (the HTTP schema's
UTF-8 bytes); anything else is protobuf binary per the contract, through
``serving/protowire.py`` (an empty payload is an all-defaults message, and
an empty ``EmbeddingsRequest.model`` counts as absent).

Errors map to gRPC status codes: 400 -> INVALID_ARGUMENT, 408 ->
DEADLINE_EXCEEDED, 429 -> RESOURCE_EXHAUSTED, 503 -> UNAVAILABLE, anything
else -> INTERNAL; the details carry the ``ErrorResponse`` JSON on both
wires. A payload that is not a JSON object is INVALID_ARGUMENT
``invalid_json``.

The handler's calls block, so the server is the synchronous ``grpc.server``
over a thread pool: one worker per RPC in progress, as many workers as the
admission queue holds requests (``pool_size``). Beyond that many RPCs at
once the server answers RESOURCE_EXHAUSTED instead of queueing them behind
the pool unseen. A client that cancels a stream (or whose stream's RPC
ends otherwise) has its request aborted, whether the stream is waiting for
its next event (the handler's ``idle`` check reads ``context.is_active()``)
or writing one; its pages go back.

This is the only module of the port that imports ``grpc`` (``grpcio``);
the server imports it only when ``server.grpc_port`` is set.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
from typing import Callable, Optional

import grpc

from distributed_inference_server_tpu_torch.core.errors import ApiError
from distributed_inference_server_tpu_torch.core.models import ErrorResponse
from distributed_inference_server_tpu_torch.serving import protowire
from distributed_inference_server_tpu_torch.serving.handler import (
    InferenceHandler,
)

SERVICE = "dis.tpu.InferenceService"

_STATUS = {
    400: grpc.StatusCode.INVALID_ARGUMENT,
    408: grpc.StatusCode.DEADLINE_EXCEEDED,
    429: grpc.StatusCode.RESOURCE_EXHAUSTED,
    503: grpc.StatusCode.UNAVAILABLE,
}

JSON = "json"
PROTO = "proto"

# the grace ``stop_grpc`` gives RPCs in progress, as the reference's
# ``serve_forever`` does
STOP_GRACE_S = 5.0


def _json_out(obj) -> bytes:
    return json.dumps(obj).encode()


def _json_in(data: bytes):
    try:
        obj = json.loads(data or b"{}")
    except ValueError:  # the None return maps to INVALID_ARGUMENT
        return None
    return obj if isinstance(obj, dict) else None


def _decode_request(data: bytes, msg: str):
    """The wire and the payload: ``(mode, dict or None)``. JSON payloads
    start with '{'; anything else decodes as protobuf binary per
    inference.proto (empty bytes = the all-defaults message)."""
    if data[:1] == b"{":
        return JSON, _json_in(data)
    try:
        obj = protowire.decode(msg, bytes(data))
    except (ValueError, KeyError, IndexError):
        return PROTO, None  # INVALID_ARGUMENT to the client
    if msg == "EmbeddingsRequest" and not obj.get("model"):
        # an optional field: "" means absent on the proto wire
        obj.pop("model", None)
    return PROTO, obj


def _encode_response(mode: str, msg: str, obj: dict) -> bytes:
    return _json_out(obj) if mode == JSON else protowire.encode(msg, obj)


def _abort_api_error(context, err: ApiError) -> None:
    """End the RPC with ``err``'s status (``context.abort`` raises)."""
    body = ErrorResponse.of(str(err), err.error_type(), err.code())
    context.abort(_STATUS.get(err.status_code(), grpc.StatusCode.INTERNAL),
                  json.dumps(body.to_dict()))


def _abort_bad_json(context) -> None:
    context.abort(
        grpc.StatusCode.INVALID_ARGUMENT,
        json.dumps({"error": {
            "message": "request payload is not a JSON object",
            "error_type": "invalid_request_error",
            "code": "invalid_json",
        }}),
    )


class _RpcGone(Exception):
    """The stream's RPC ended (cancelled, timed out or closed) while the
    stream waited for its next event."""


def health(handler: InferenceHandler) -> dict:
    """The ``Health`` answer: the reference's ``{status, accepting,
    engines}``."""
    statuses = handler.dispatcher.scheduler.statuses()
    healthy = any(s.healthy for s in statuses)
    return {
        "status": "ok" if healthy else "unhealthy",
        "accepting": handler.dispatcher.is_accepting(),
        "engines": [s.to_dict() for s in statuses],
    }


def pool_size(handler: InferenceHandler) -> int:
    """Workers (and concurrent RPCs) for ``handler``: as many as its
    admission queue holds requests."""
    return max(1, int(handler.dispatcher.queue.config.max_queue_size))


def build_grpc_server(
    handler: InferenceHandler,
    address: str = "127.0.0.1:0",
    max_workers: Optional[int] = None,
) -> grpc.Server:
    """Build (not start) the server; ``address`` is already bound, and the
    chosen port is the returned server's ``bound_port`` attribute. Stop it
    with ``stop_grpc``, which also ends its worker pool."""

    def unary(fn: Callable[[dict], dict], req_msg: str, resp_msg: str):
        def method(request_bytes, context):
            mode, obj = _decode_request(request_bytes, req_msg)
            if obj is None:
                _abort_bad_json(context)
            try:
                result = fn(obj)
            except ApiError as e:
                _abort_api_error(context, e)
            return _encode_response(mode, resp_msg, result)

        return grpc.unary_unary_rpc_method_handler(
            method,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,  # the method encodes per wire
        )

    def stream(fn, req_msg: str):
        def method(request_bytes, context):
            mode, obj = _decode_request(request_bytes, req_msg)
            if obj is None:
                _abort_bad_json(context)

            def idle() -> None:
                if not context.is_active():
                    raise _RpcGone()

            try:
                request_id, events = fn(obj, idle=idle)
            except ApiError as e:
                _abort_api_error(context, e)
            consumed = []

            def on_end() -> None:
                # the RPC ended before the stream's last event (cancelled,
                # or its client went away while a frame was written): the
                # request leaves the engine and its pages go back
                if not consumed:
                    handler.abort([request_id])

            context.add_callback(on_end)
            try:
                for event in events:
                    yield _encode_response(mode, "TokenEvent",
                                           event.to_dict())
                consumed.append(True)
            except _RpcGone:
                handler.abort([request_id])
            finally:
                events.close()

        return grpc.unary_stream_rpc_method_handler(
            method,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )

    handlers = grpc.method_handlers_generic_handler(SERVICE, {
        "Generate": unary(lambda o: handler.generate(o).to_dict(),
                          "GenerateRequest", "GenerateResponse"),
        "Chat": unary(lambda o: handler.chat(o).to_dict(),
                      "ChatRequest", "ChatResponse"),
        "Embeddings": unary(lambda o: handler.embeddings(o).to_dict(),
                            "EmbeddingsRequest", "EmbeddingsResponse"),
        "Health": unary(lambda o: health(handler),
                        "HealthRequest", "HealthResponse"),
        "GenerateStream": stream(handler.generate_stream, "GenerateRequest"),
        "ChatStream": stream(handler.chat_stream, "ChatRequest"),
    })
    workers = max_workers or pool_size(handler)
    pool = cf.ThreadPoolExecutor(workers, thread_name_prefix="grpc")
    server = grpc.server(pool, maximum_concurrent_rpcs=workers)
    server.add_generic_rpc_handlers((handlers,))
    try:
        server.bound_port = server.add_insecure_port(address)
    except RuntimeError:  # the address is taken or cannot be bound
        pool.shutdown(wait=False)
        raise
    server.pool = pool
    return server


def serve_grpc(
    handler: InferenceHandler,
    host: str = "0.0.0.0",
    port: int = 50051,
) -> grpc.Server:
    """Start the gRPC transport next to the HTTP server (both share the
    handler, and so the queue, batcher, scheduler and engines)."""
    server = build_grpc_server(handler, f"{host}:{port}")
    server.start()
    return server


def stop_grpc(server: grpc.Server, grace: float = STOP_GRACE_S) -> None:
    """Stop accepting RPCs, give those in progress ``grace`` seconds, then
    cancel the rest and end the worker pool."""
    server.stop(grace).wait(grace + 5.0)
    server.pool.shutdown(wait=False, cancel_futures=True)


_METHOD_MSGS = {
    "Generate": ("GenerateRequest", "GenerateResponse"),
    "Chat": ("ChatRequest", "ChatResponse"),
    "Embeddings": ("EmbeddingsRequest", "EmbeddingsResponse"),
    "Health": ("HealthRequest", "HealthResponse"),
    "GenerateStream": ("GenerateRequest", "TokenEvent"),
    "ChatStream": ("ChatRequest", "TokenEvent"),
}


class GrpcClient:
    """A blocking client for the service above. ``wire="json"`` (the
    default) sends the HTTP schema's JSON; ``wire="proto"`` speaks protobuf
    binary per inference.proto; both return the same dicts. The streaming
    calls return grpc's iterator of TokenEvent dicts (``cancel()`` ends
    it)."""

    def __init__(self, target: str, wire: str = JSON):
        if wire not in (JSON, PROTO):
            raise ValueError(f"wire must be 'json' or 'proto': {wire!r}")
        self._channel = grpc.insecure_channel(target)
        self._wire = wire

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "GrpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _codecs(self, method: str):
        req_msg, resp_msg = _METHOD_MSGS[method]
        if self._wire == PROTO:
            return (
                lambda obj: protowire.encode(req_msg, obj),
                lambda b: protowire.decode(resp_msg, b),
            )
        return _json_out, json.loads

    def _unary(self, method: str):
        ser, de = self._codecs(method)
        return self._channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=ser,
            response_deserializer=de,
        )

    def _stream(self, method: str):
        ser, de = self._codecs(method)
        return self._channel.unary_stream(
            f"/{SERVICE}/{method}",
            request_serializer=ser,
            response_deserializer=de,
        )

    def generate(self, obj: dict, timeout: Optional[float] = None) -> dict:
        return self._unary("Generate")(obj, timeout=timeout)

    def chat(self, obj: dict, timeout: Optional[float] = None) -> dict:
        return self._unary("Chat")(obj, timeout=timeout)

    def embeddings(self, obj: dict, timeout: Optional[float] = None) -> dict:
        return self._unary("Embeddings")(obj, timeout=timeout)

    def health(self, timeout: Optional[float] = None) -> dict:
        return self._unary("Health")({}, timeout=timeout)

    def generate_stream(self, obj: dict, timeout: Optional[float] = None):
        return self._stream("GenerateStream")(obj, timeout=timeout)

    def chat_stream(self, obj: dict, timeout: Optional[float] = None):
        return self._stream("ChatStream")(obj, timeout=timeout)
