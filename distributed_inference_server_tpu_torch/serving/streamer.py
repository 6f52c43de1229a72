"""Token streaming: the engine thread's result sinks and SSE encoding (port
of ``distributed_inference_server_tpu/serving/streamer.py`` for a
threaded HTTP server: the consumer of a stream is the handler thread
that writes it, so the channel is a ``queue.Queue``, not an asyncio
queue).

- ``sse_encode`` / ``SSE_DONE``: one ``data: {json}\\n\\n`` frame per
  ``TokenEvent``, and the closing ``data: [DONE]`` frame;
- ``StreamingSink``: the runner thread's callbacks buffer ``TokenEvent``s
  and ``flush()`` (called by the runner once per engine step) hands the
  whole burst to the channel in one ``put``: one wakeup of the handler
  thread per (request, decode block), not one per token. The done and
  error events flush at once, followed by the stream's end. Several sinks
  may share one channel (the ``n`` > 1 fan-out), each tagging its events
  with its choice index;
- ``CollectingSink``: accumulates a non-streamed completion (and the
  sampled tokens' ids and log-probabilities, for the ``/v1`` logprobs)
  and resolves a ``threading.Event``.
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Iterator, List, Optional, Tuple

from distributed_inference_server_tpu_torch.core.models import (
    FinishReason,
    TokenEvent,
    Usage,
)


def sse_encode(event: TokenEvent) -> bytes:
    """One SSE frame: ``data: {json}\\n\\n``."""
    return f"data: {json.dumps(event.to_dict())}\n\n".encode()


SSE_DONE = b"data: [DONE]\n\n"


class StreamingSink:
    """Result sink feeding ``(index, TokenEvent)`` pairs to ``channel``
    (a ``queue.Queue`` of lists); ``(index, None)`` ends the stream."""

    def __init__(self, channel: "queue.Queue[List[Tuple[int, Optional[TokenEvent]]]]",
                 index: int = 0):
        self.channel = channel
        self.index = index
        self._pending: List[Tuple[int, Optional[TokenEvent]]] = []
        self._lock = threading.Lock()

    def _put(self, event: Optional[TokenEvent]) -> None:
        with self._lock:
            self._pending.append((self.index, event))

    def flush(self) -> None:
        """Hand the buffered events to the channel in one put."""
        with self._lock:
            items, self._pending = self._pending, []
        if items:
            self.channel.put(items)

    # runner-thread callbacks ------------------------------------------------

    def on_token(self, token_id: Optional[int], text: str, token_index: int,
                 logprob: Optional[float] = None) -> None:
        self._put(TokenEvent.token_event(text, token_index, logprob))

    def on_done(self, finish_reason: FinishReason, usage: Usage) -> None:
        self._put(TokenEvent.done_event(finish_reason, usage))
        self._put(None)
        self.flush()

    def on_error(self, message: str, code: str) -> None:
        self._put(TokenEvent.error_event(message, code))
        self._put(None)
        self.flush()


# seconds without an event between two idle() calls of a stream
IDLE_POLL_S = 0.25


def drain(channel: "queue.Queue", n: int, timeout: float, idle=None
          ) -> Iterator[Tuple[int, TokenEvent]]:
    """The ``(index, event)`` pairs of ``n`` sinks sharing ``channel``,
    until every one has ended. ``idle()``, when given, is called after
    each ``IDLE_POLL_S`` without events (the HTTP layer checks its client
    there); ``TimeoutError`` after ``timeout`` seconds without one."""
    live = n
    waited = 0.0
    while live:
        try:
            items = channel.get(timeout=IDLE_POLL_S)
        except queue.Empty:
            waited += IDLE_POLL_S
            if waited >= timeout:
                raise TimeoutError(f"no event for {timeout} s") from None
            if idle is not None:
                idle()
            continue
        waited = 0.0
        for idx, ev in items:
            if ev is None:
                live -= 1
            else:
                yield idx, ev


class CollectingSink:
    """Result sink for a non-streamed response: accumulates the text and
    the sampled tokens' ``(token_id, logprob)`` trail, and resolves with
    ``(text, finish_reason, usage, error, code)``."""

    def __init__(self) -> None:
        self._parts: List[str] = []
        self.token_ids: List[int] = []
        self.token_logprobs: List[Optional[float]] = []
        self.result = None
        self._done = threading.Event()

    def on_token(self, token_id: Optional[int], text: str, token_index: int,
                 logprob: Optional[float] = None) -> None:
        if text:
            self._parts.append(text)
        # one record per sampled token; a held-back-text flush rides with
        # token_id None and no log-probability of its own
        if token_id is not None:
            self.token_ids.append(token_id)
            self.token_logprobs.append(logprob)

    def on_done(self, finish_reason: FinishReason, usage: Usage) -> None:
        self.result = ("".join(self._parts), finish_reason, usage, None, None)
        self._done.set()

    def on_error(self, message: str, code: str) -> None:
        self.result = (None, None, None, message, code)
        self._done.set()

    def wait(self, timeout: Optional[float] = None):
        """The result tuple, or None when ``timeout`` passed first."""
        if not self._done.wait(timeout):
            return None
        return self.result
