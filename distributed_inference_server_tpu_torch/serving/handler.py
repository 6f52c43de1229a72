"""Inference handler: the endpoint-facing request lifecycle (port of
``distributed_inference_server_tpu/serving/handler.py`` for one replica
behind the dispatcher and a threaded HTTP server).

    parse JSON -> validate (400) -> tokenize (chat: render the template)
    -> submit to the dispatcher (503 queue_full under backpressure) ->
    wait on the sink (408: queue_timeout when the request expired in the
    admission queue, request_timeout after REQUEST_TIMEOUT_S) -> build the
    response

The body's ``priority`` picks the admission queue's level and its
``tenant`` (``_tenant_of``) the fair-admission lane. A request shed by
deadline-aware admission is a 503 ``admission_shed`` with ``Retry-After``.

With a ``tracer`` each request gets a ``request.<endpoint>`` root span,
finished when its answer or stream ends; with a ``recorder`` its
flight-recorder timeline opens at admission (``serving/flightrec.py``).

Transport-agnostic: ``serving/app.py`` only frames HTTP and SSE around
these calls, which block the calling (handler) thread. The streaming calls
return the request ids and an ``EventStream``; the caller closes the
stream, and aborts the ids when its client went away.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from distributed_inference_server_tpu_torch.core.errors import (
    AdmissionShedApiError,
    ApiError,
    InternalApiError,
    QueueFull,
    QueueFullApiError,
    RequestTimeoutApiError,
    ValidationApiError,
    ValidationError,
)
from distributed_inference_server_tpu_torch.core.models import (
    ChatChoice,
    ChatMessage,
    ChatRequest,
    ChatResponse,
    EmbeddingData,
    EmbeddingsRequest,
    EmbeddingsResponse,
    GenerateChoice,
    GenerateRequest,
    GenerateResponse,
    Role,
    TokenEvent,
    Usage,
)
from distributed_inference_server_tpu_torch.core.types import (
    DEFAULT_TENANT,
    Priority,
    RequestId,
    new_request_id,
)
from distributed_inference_server_tpu_torch.core.validator import (
    RequestValidator,
)
from distributed_inference_server_tpu_torch.engine.engine import (
    SamplingParams,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    Tokenizer,
    chat_template_family,
    render_chat,
)
from distributed_inference_server_tpu_torch.serving.dispatcher import (
    Dispatcher,
)
from distributed_inference_server_tpu_torch.serving.health import (
    AdmissionShed,
)
from distributed_inference_server_tpu_torch.serving.metrics import (
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    ServerRequest,
)
from distributed_inference_server_tpu_torch.serving.streamer import (
    CollectingSink,
    StreamingSink,
    drain,
)

# a request still unanswered (or a stream silent) this long is aborted
REQUEST_TIMEOUT_S = 600.0


def _tenant_of(obj: dict) -> str:
    """The fair-admission tenant: the body's optional ``tenant`` field,
    ``default`` when absent or blank. A non-string value is coerced, and
    cut at 128 characters: admission must never 400 a request that
    validated."""
    tenant = obj.get("tenant") if isinstance(obj, dict) else None
    if not tenant:
        return DEFAULT_TENANT
    return str(tenant)[:128]


def _error_to_api(message: str, code: str) -> ApiError:
    if code in ("request_timeout", "queue_timeout"):
        return RequestTimeoutApiError(code)
    return InternalApiError(message)


class EventStream:
    """The merged events of a fan-out's sinks (one shared channel):
    ``(choice index, TokenEvent)`` pairs, or the events alone with
    ``indexed=False`` (one choice). A choice's bookkeeping (the active
    requests gauge) settles once, at its done or error event or at
    ``close()``, which the consumer calls whether or not it began reading:
    a client that went away never ends its choices. After
    ``REQUEST_TIMEOUT_S`` without an event the unfinished choices are
    aborted and end with a timeout error event."""

    def __init__(self, handler: "InferenceHandler", channel: queue.Queue,
                 rids: List[RequestId], idle, indexed: bool):
        self._handler = handler
        self._channel = channel
        self._rids = rids
        self._idle = idle
        self._indexed = indexed
        self._ended = [False] * len(rids)

    def _end(self, i: int, status: str = "ok") -> None:
        if not self._ended[i]:
            self._ended[i] = True
            self._handler._finished()
            self._handler._finish_span(self._rids[i], status)

    def _pairs(self) -> Iterator[Tuple[int, TokenEvent]]:
        try:
            for idx, ev in drain(self._channel, len(self._rids),
                                 REQUEST_TIMEOUT_S, idle=self._idle):
                if ev.type in ("done", "error"):
                    self._end(idx, "ok" if ev.type == "done" else "error")
                yield idx, ev
        except TimeoutError:
            for i, rid in enumerate(self._rids):
                if not self._ended[i]:
                    self._handler.dispatcher.abort(rid)
                    self._end(i, "timeout")
                    yield i, TokenEvent.error_event("request timed out",
                                                    "request_timeout")

    def __iter__(self):
        for idx, ev in self._pairs():
            yield (idx, ev) if self._indexed else ev

    def close(self) -> None:
        for i in range(len(self._rids)):
            self._end(i, "cancelled")


class InferenceHandler:
    """Endpoint logic shared by the HTTP layer and the tests."""

    def __init__(self, dispatcher: Dispatcher, tokenizer: Tokenizer,
                 model_name: str, metrics: MetricsCollector, validator=None,
                 tracer=None, recorder=None):
        self.dispatcher = dispatcher
        self.tok = tokenizer
        self.model_name = model_name
        self.validator = validator or RequestValidator()
        self.metrics = metrics
        self.tracer = tracer
        self.recorder = recorder
        # request id -> its root span, popped when the request ends
        self._spans: Dict[RequestId, object] = {}
        self._spans_lock = threading.Lock()

    @property
    def chat_family(self) -> str:
        """The family the fallback template would use for this model
        name (``render_chat`` prefers the checkpoint's own template)."""
        return chat_template_family(self.model_name)

    # -- shared internals --------------------------------------------------

    def _submit(self, prompt_ids: List[int], params: SamplingParams,
                sink, priority: Priority, tenant: str,
                endpoint: str = "generate",
                received_at: Optional[float] = None) -> RequestId:
        request_id = new_request_id()
        span = None
        if self.tracer is not None:
            span = self.tracer.start(
                f"request.{endpoint}", request_id=str(request_id),
                prompt_tokens=len(prompt_ids), priority=priority.name)
        self.metrics.request_started()
        try:
            self.dispatcher.submit(
                ServerRequest(request_id, prompt_ids, params, sink,
                              tenant=tenant, span=span), priority)
        except AdmissionShed as e:
            # the dispatcher recorded the shed and its timeline
            self.metrics.request_finished()
            if span is not None:
                self.tracer.finish(span, status="shed")
            raise AdmissionShedApiError(e.retry_after_s) from None
        except QueueFull:
            self.metrics.request_finished()
            if span is not None:
                self.tracer.finish(span, status="rejected")
            raise QueueFullApiError() from None
        if span is not None:
            span.event("queued")
            with self._spans_lock:
                self._spans[request_id] = span
        if self.recorder is not None:
            # the timeline opens at admission, its wall clock at the
            # receipt; trace_id links it to the span tree
            self.recorder.admit(
                request_id, received_at=received_at, endpoint=endpoint,
                prompt_tokens=len(prompt_ids), priority=priority.name,
                tenant=tenant,
                **({"trace_id": span.trace_id} if span is not None else {}))
        return request_id

    def _finished(self) -> None:
        self.metrics.request_finished()

    def _finish_span(self, request_id: RequestId, status: str) -> None:
        with self._spans_lock:
            span = self._spans.pop(request_id, None)
        if span is not None:
            self.tracer.finish(span, status=status)

    def _await_completion(self, sink: CollectingSink, request_id: RequestId):
        try:
            result = sink.wait(REQUEST_TIMEOUT_S)
        finally:
            self._finished()
        if result is None:
            self.dispatcher.abort(request_id)
            self._finish_span(request_id, "timeout")
            raise RequestTimeoutApiError()
        text, reason, usage, err, code = result
        self._finish_span(request_id, "ok" if err is None else "error")
        if err is not None:
            raise _error_to_api(err, code)
        return text, reason, usage

    def abort(self, request_ids: Sequence[RequestId]) -> None:
        """Abort requests whose client went away: out of the admission
        queue, or out of the engine (their pages go back)."""
        for rid in request_ids:
            self.dispatcher.abort(rid)

    # -- parsing -----------------------------------------------------------

    def parse_generate(self, obj: dict) -> GenerateRequest:
        try:
            req = GenerateRequest.from_dict(obj)
            self.validator.validate_generate(req)
            return req
        except ValidationError as e:
            raise ValidationApiError(e) from None

    def parse_chat(self, obj: dict) -> ChatRequest:
        try:
            req = ChatRequest.from_dict(obj)
            self.validator.validate_chat(req)
            return req
        except ValidationError as e:
            raise ValidationApiError(e) from None

    def _chat_ids(self, req: ChatRequest) -> List[int]:
        # the template writes its own BOS marker text, so no BOS id
        return self.tok.encode(
            render_chat(req.messages, self.tok, self.model_name),
            add_bos=False)

    def _parse_one(self, obj: dict, chat: bool
                   ) -> Tuple[List[int], SamplingParams, Priority]:
        """Validate once; the (prompt ids, params, priority) every
        fanned-out choice shares."""
        if chat:
            req = self.parse_chat(obj)
            ids = self._chat_ids(req)
            priority = Priority.NORMAL  # chat bodies carry none
        else:
            req = self.parse_generate(obj)
            ids = self.tok.encode(req.prompt)
            # not ``or``: Priority.LOW is 0, and falsy
            priority = (Priority.NORMAL if req.priority is None
                        else req.priority)
        return ids, SamplingParams(
            max_tokens=req.max_tokens, temperature=req.temperature,
            top_p=req.top_p, stop_sequences=tuple(req.stop_sequences)
        ), priority

    # -- /generate and /chat -----------------------------------------------

    # ``received_at``: the transport's monotonic receipt of the request
    # (the flight recorder's ingress phase; None where it has none)

    def generate(self, obj: dict, received_at: Optional[float] = None
                 ) -> GenerateResponse:
        rid, choices, usage = self.complete_many(obj, chat=False,
                                                 received_at=received_at)
        return GenerateResponse(
            id=f"cmpl-{rid}", object="text_completion",
            created=int(time.time()), model=self.model_name,
            choices=(GenerateChoice(text=choices[0]["text"], index=0,
                                    finish_reason=choices[0]
                                    ["finish_reason"]),),
            usage=usage)

    def chat(self, obj: dict, received_at: Optional[float] = None
             ) -> ChatResponse:
        rid, choices, usage = self.complete_many(obj, chat=True,
                                                 received_at=received_at)
        return ChatResponse(
            id=f"chatcmpl-{rid}", object="chat.completion",
            created=int(time.time()), model=self.model_name,
            choices=(ChatChoice(
                index=0, message=ChatMessage(role=Role.ASSISTANT,
                                             content=choices[0]["text"]),
                finish_reason=choices[0]["finish_reason"]),),
            usage=usage)

    def generate_stream(self, obj: dict, idle=None,
                        received_at: Optional[float] = None
                        ) -> Tuple[RequestId, Iterator[TokenEvent]]:
        """Validate and submit; returns (request id, TokenEvent
        iterator). ``idle`` as for ``stream_many``."""
        rids, events = self._stream(obj, False, 1, idle, indexed=False,
                                    received_at=received_at)
        return rids[0], events

    def chat_stream(self, obj: dict, idle=None,
                    received_at: Optional[float] = None
                    ) -> Tuple[RequestId, Iterator[TokenEvent]]:
        rids, events = self._stream(obj, True, 1, idle, indexed=False,
                                    received_at=received_at)
        return rids[0], events

    # -- n-choice fan-out (/v1) ---------------------------------------------

    def _submit_fanout(self, obj: dict, chat: bool, n: int, make_sink,
                       received_at: Optional[float] = None):
        ids, params, priority = self._parse_one(obj, chat)
        tenant = _tenant_of(obj)
        endpoint = "chat" if chat else "generate"
        sinks, rids = [], []
        try:
            for i in range(n):
                sink = make_sink(i)
                rids.append(self._submit(ids, params, sink, priority,
                                         tenant, endpoint, received_at))
                sinks.append(sink)
        except ApiError:
            # a refused choice takes its submitted siblings with it
            for rid in rids:
                self.dispatcher.abort(rid)
                self._finished()
                self._finish_span(rid, "aborted")
            raise
        return sinks, rids

    def complete_many(self, obj: dict, *, chat: bool, n: int = 1,
                      received_at: Optional[float] = None):
        """One validated request as ``n`` engine sequences sharing the
        prompt, each run to completion. Returns ``(request id, choices,
        usage)``: ``choices[i]`` has text / finish_reason / token_ids /
        token_logprobs; the usage counts the prompt once and sums the
        completions. The first choice's error is raised after all are
        done."""
        sinks, rids = self._submit_fanout(obj, chat, n,
                                          lambda i: CollectingSink(),
                                          received_at)
        results = []
        for sink, rid in zip(sinks, rids):
            try:
                results.append(self._await_completion(sink, rid))
            except ApiError as e:
                results.append(e)
        errs = [r for r in results if isinstance(r, ApiError)]
        if errs:
            raise errs[0]
        choices = [{"text": text, "finish_reason": reason,
                    "token_ids": list(sink.token_ids),
                    "token_logprobs": list(sink.token_logprobs)}
                   for sink, (text, reason, _) in zip(sinks, results)]
        completion = sum(r[2].completion_tokens for r in results)
        return rids[0], choices, Usage.of(results[0][2].prompt_tokens,
                                          completion)

    def stream_many(self, obj: dict, *, chat: bool, n: int = 1, idle=None,
                    received_at: Optional[float] = None
                    ) -> Tuple[List[RequestId], EventStream]:
        """Streaming: ``n`` sequences whose event streams merge into one
        ``EventStream`` of ``(choice index, TokenEvent)`` pairs. Returns
        ``(request ids, stream)``; the caller closes the stream when it
        is done with it, and aborts the ids if it stopped reading early.
        ``idle()`` runs while no event has come for ``IDLE_POLL_S`` (the
        HTTP layer checks its client there, and may raise to end the
        stream)."""
        return self._stream(obj, chat, n, idle, indexed=True,
                            received_at=received_at)

    def _stream(self, obj: dict, chat: bool, n: int, idle, indexed: bool,
                received_at: Optional[float] = None
                ) -> Tuple[List[RequestId], EventStream]:
        channel: queue.Queue = queue.Queue()
        _, rids = self._submit_fanout(
            obj, chat, n, lambda i: StreamingSink(channel, i), received_at)
        return rids, EventStream(self, channel, rids, idle, indexed)

    # -- /embeddings ---------------------------------------------------------

    def embeddings(self, obj: dict) -> EmbeddingsResponse:
        try:
            req = EmbeddingsRequest.from_dict(obj)
            self.validator.validate_embeddings(req)
        except ValidationError as e:
            raise ValidationApiError(e) from None
        ids_list = [self.tok.encode(text) for text in req.input_list()]
        box: list = []
        done = threading.Event()

        def on_result(array, error) -> None:
            box.append((array, error))
            done.set()

        # embeddings bypass the admission queue, as in the reference
        runner = self.dispatcher.scheduler.schedule()
        if runner is None:
            raise InternalApiError("no healthy inference engine available")
        self.metrics.request_started()
        try:
            runner.submit_embed(ids_list, on_result)
            if not done.wait(REQUEST_TIMEOUT_S):
                raise RequestTimeoutApiError()
        finally:
            self._finished()
        array, error = box[0]
        if error is not None:
            raise InternalApiError(error)
        return EmbeddingsResponse(
            object="list",
            data=tuple(EmbeddingData(object="embedding",
                                     embedding=row.tolist(), index=i)
                       for i, row in enumerate(array)),
            model=req.model or self.model_name,
            usage=Usage.of(sum(len(ids) for ids in ids_list), 0))
