"""HTTP transport on the standard library (the counterpart of
``distributed_inference_server_tpu/serving/app.py``, whose aiohttp stack is
not available where the port runs). One thread per connection, HTTP/1.1.

- ``POST /generate`` and ``POST /chat``: JSON, or with ``"stream": true``
  an SSE stream of ``TokenEvent`` frames ending in ``data: [DONE]``;
- ``POST /embeddings`` (and ``/v1/embeddings``);
- ``POST /v1/completions`` and ``POST /v1/chat/completions``: the OpenAI
  spellings (``n`` <= 16, ``stop``, ``max_completion_tokens``, sampled-
  token ``logprobs``, ``stream_options.include_usage``) over the same
  handler, streamed as ``text_completion`` / ``chat.completion.chunk``
  objects;
- ``GET /metrics``: Prometheus text (``serving/metrics.py``);
- ``GET /health``: ``{status, accepting, engines: [EngineStatus]}`` (one
  per replica; 200 while any replica is healthy) plus ``model`` and
  ``device``;
- ``GET /server/stats``: the ``MetricsSnapshot`` plus the port's own
  blocks (``serving/server.py stats``);
- ``POST /admin/speculation``: body ``{"action": "reset"}`` clears every
  replica's speculation acceptance trackers and answers ``{"status":
  "ok", "engines_reset": n}`` (replicas without a draft count too, as in
  the reference); any other body is 400 ``invalid_body``;
- ``POST /admin/scale``: body ``{"num_engines": N}`` (1 to 64) adds or
  retires replicas (a retired one drains its requests first); answers
  ``{"status": "ok", "num_engines", "engines"}``, 400 ``invalid_body`` for a bad
  body, 500 ``scale_failed`` when a replica fails to start;
- ``GET /server/trace`` (``?n=``, 1 to 10000, ``trace_id=``,
  ``request_id=``): finished spans, sorted by start (``{"spans": [...]}``);
- ``GET /server/requests`` (``?n=``, 1 to 1000, ``verdict=ok|violated``):
  the flight recorder's newest timelines and its stats;
  ``GET /server/requests/<id>``: one request's timeline, phases and
  TTFT / TBT (404 ``unknown_request`` when it is not kept);
- ``GET /server/perf``: the windowed latency digests, per-engine step
  clock and SLO burn (``serving/teledigest.py build_perf_payload``);
- ``POST /admin/model-swap``: body ``{"model": NAME}`` swaps every replica
  to the model the server's resolver builds for NAME (501
  ``swap_unavailable`` without a resolver, as at the normal entry point;
  500 ``swap_failed`` when a replica's build fails: the old model stays);
- ``POST /server/kernel_counts/reset``: zero the kernels' launch counts
  (a measurement run brackets the path it measures with it);
- ``POST /server/profile``: body ``{"steps": N}`` (optional
  ``timeout_s``, default 30): trace the card over the next N engine steps
  with ``torch.profiler`` and return the window's device busy time and
  share (``utils/profiler.py``); 409 with an ``error`` when the trace
  could not run (no card, another trace, an idle engine).

A stream is written with ``Transfer-Encoding: chunked``, one chunk per
frame, each written straight to the socket. A write that fails (the client
went away) aborts every request of the stream, whose pages go back to the
allocator; so does a client that closes its socket while the stream waits
for its next event. Errors are ``ErrorResponse`` JSON with the reference's
status mapping (400 validation, 503 queue_full when the admission queue
pushes back or admission_shed with ``Retry-After`` when deadline-aware
admission sheds, 408 timeout or queue_timeout, 500 engine failure). Every
POST to a route is observed in ``request_latency_seconds`` by path and
status; as in the reference, a stream its client abandoned counts as 500.
"""

from __future__ import annotations

import json
import select
import socket
import time
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, unquote, urlsplit
from typing import TYPE_CHECKING, List, Optional

from distributed_inference_server_tpu_torch.core.errors import ApiError
from distributed_inference_server_tpu_torch.core.models import ErrorResponse
from distributed_inference_server_tpu_torch.serving.streamer import (
    SSE_DONE,
    sse_encode,
)

if TYPE_CHECKING:
    from distributed_inference_server_tpu_torch.serving.server import (
        InferenceServer,
    )

MAX_BODY_BYTES = 8 << 20
# fan-out bound of the /v1 routes' "n": each choice is a full engine
# sequence
MAX_N = 16
_GONE = (BrokenPipeError, ConnectionResetError, ConnectionAbortedError)
_TRACE_N_MAX = 10_000


class _InvalidBody(ApiError):
    def __init__(self, msg: str):
        super().__init__(f"Validation error: {msg}")

    def status_code(self) -> int:
        return 400

    def error_type(self) -> str:
        return "invalid_request_error"

    def code(self) -> str:
        return "invalid_json"


class _ClientGone(Exception):
    """The client closed its connection while its stream was idle."""


# ---------------------------------------------------------------------------
# the OpenAI translation (/v1/*)
# ---------------------------------------------------------------------------


class V1Opts:
    """OpenAI-only request options (what the native schema lacks)."""

    __slots__ = ("n", "include_usage", "logprobs")

    def __init__(self, n: int = 1, include_usage: bool = False,
                 logprobs: bool = False):
        self.n = n
        self.include_usage = include_usage
        self.logprobs = logprobs


def openai_fields(obj: dict, *, chat: bool):
    """Translate and check the OpenAI request spellings; returns ``(obj,
    V1Opts)``. Fields that would change the response's shape and are not
    implemented (``echo``, ``suffix``, ``best_of`` other than ``n``,
    alternative-token logprobs) are refused with a 400."""
    n = obj.get("n")
    if n is None:
        n = 1
    elif type(n) is not int or not 1 <= n <= MAX_N:
        raise _InvalidBody(f'"n" must be an integer in [1, {MAX_N}]')
    opts = V1Opts(n=n)
    so = obj.get("stream_options")
    if so is not None:
        if obj.get("stream") is not True:
            raise _InvalidBody('"stream_options" requires "stream": true')
        if not isinstance(so, dict):
            raise _InvalidBody('"stream_options" must be an object')
        iu = so.get("include_usage", False)
        if not isinstance(iu, bool):
            raise _InvalidBody(
                '"stream_options.include_usage" must be a boolean')
        opts.include_usage = iu
    lp = obj.get("logprobs")
    if chat:
        if lp is not None and not isinstance(lp, bool):
            raise _InvalidBody('"logprobs" must be a boolean')
        opts.logprobs = bool(lp)
        tlp = obj.get("top_logprobs")
        if tlp is not None:
            if type(tlp) is not int or not 0 <= tlp <= 20:
                raise _InvalidBody(
                    '"top_logprobs" must be an integer in [0, 20]')
            if not opts.logprobs:
                raise _InvalidBody('"logprobs" must be true when '
                                   '"top_logprobs" is used')
            if tlp > 0:
                raise _InvalidBody(
                    '"top_logprobs" > 0 (alternative-token logprobs) is '
                    "not supported; use 0 for sampled-token logprobs")
    else:
        # the completions spelling: the number of alternatives per
        # position; 0 = the sampled token's log-probability only
        if lp is not None:
            if type(lp) is not int or lp < 0:
                raise _InvalidBody('"logprobs" must be a non-negative '
                                   "integer")
            if lp > 0:
                raise _InvalidBody(
                    '"logprobs" > 0 (alternative-token logprobs) is not '
                    "supported; use 0 for sampled-token logprobs")
            opts.logprobs = True
        if obj.get("echo"):
            raise _InvalidBody('"echo" is not supported (the response would '
                               "have to prepend the prompt)")
        if obj.get("suffix") is not None:
            raise _InvalidBody('"suffix" is not supported')
        bo = obj.get("best_of")
        if bo is not None and (type(bo) is not int or bo != n):
            raise _InvalidBody(f'"best_of" must equal n (= {n}); server-side '
                               "candidate reranking is not supported")
    if "max_completion_tokens" in obj and "max_tokens" not in obj:
        obj["max_tokens"] = obj.pop("max_completion_tokens")
    if "stop" in obj and "stop_sequences" not in obj:
        stop = obj.pop("stop")
        if stop is None:
            stop = []
        elif isinstance(stop, str):
            stop = [stop]
        if not (isinstance(stop, list)
                and all(isinstance(s, str) for s in stop)):
            raise _InvalidBody('"stop" must be a string or an array of '
                               "strings")
        if any(s == "" for s in stop):
            raise _InvalidBody('"stop" strings must be non-empty')
        obj["stop_sequences"] = stop
    return obj, opts


def v1_finish(reason) -> Optional[str]:
    """OpenAI's finish vocabulary: ``stop_sequence`` is ``stop``."""
    fr = getattr(reason, "value", reason)
    return "stop" if fr == "stop_sequence" else fr


def lp_completions(token_texts: List[str], logprobs) -> dict:
    """The completions logprobs object (sampled tokens only); each
    offset is the cumulative length of the tokens' isolated decodes."""
    offsets, pos = [], 0
    for t in token_texts:
        offsets.append(pos)
        pos += len(t)
    return {"tokens": token_texts, "token_logprobs": logprobs,
            "top_logprobs": None, "text_offset": offsets}


def lp_chat(token_texts: List[str], logprobs) -> dict:
    """The chat logprobs object; entries without a log-probability (a
    held-back text flush) are left out, as the schema wants a float."""
    return {"content": [
        {"token": t, "logprob": lp, "bytes": list(t.encode("utf-8")),
         "top_logprobs": []}
        for t, lp in zip(token_texts, logprobs) if lp is not None]}


def v1_response(request_id, choices, usage, *, chat: bool, opts: V1Opts,
                model: str, tok) -> dict:
    """The non-streamed OpenAI envelope of ``complete_many``'s results."""
    out = []
    for i, c in enumerate(choices):
        lp_obj = None
        if opts.logprobs:
            texts = [tok.decode_token(t) for t in c["token_ids"]]
            lp_obj = (lp_chat(texts, c["token_logprobs"]) if chat
                      else lp_completions(texts, c["token_logprobs"]))
        fr = v1_finish(c["finish_reason"])
        if chat:
            out.append({"index": i, "message": {"role": "assistant",
                                                "content": c["text"]},
                        "logprobs": lp_obj, "finish_reason": fr})
        else:
            out.append({"text": c["text"], "index": i, "logprobs": lp_obj,
                        "finish_reason": fr})
    return {"id": ("chatcmpl-" if chat else "cmpl-") + str(request_id),
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()), "model": model, "choices": out,
            "usage": usage.to_dict()}


def v1_chunk_encoder(request_ids, *, chat: bool, opts: V1Opts, model: str):
    """The OpenAI chunk encoding of a merged ``(choice index, event)``
    stream: the role only in a choice's first delta, one finish chunk per
    choice, error frames that carry the choice index, and with
    ``include_usage`` a ``"usage": null`` on every chunk and one
    usage-only chunk (empty choices) after the last choice ends."""
    obj_name = "chat.completion.chunk" if chat else "text_completion"
    rid = ("chatcmpl-" if chat else "cmpl-") + str(request_ids[0])
    created = int(time.time())
    n = len(request_ids)
    first = [True] * n
    offset = [0] * n  # per-choice character offset (completions logprobs)
    observed = [0] * n  # sampled tokens per choice: an errored choice's
    # usage (its done event never comes)
    prompt_tokens = [0]
    completion_tokens = [0]
    remaining = [n]

    def frame(payload: dict) -> bytes:
        if opts.include_usage and "usage" not in payload:
            payload["usage"] = None
        return b"data: " + json.dumps(payload).encode() + b"\n\n"

    def envelope(choice: dict) -> bytes:
        return frame({"id": rid, "object": obj_name, "created": created,
                      "model": model, "choices": [choice]})

    def maybe_usage_chunk() -> bytes:
        remaining[0] -= 1
        if remaining[0] != 0 or not opts.include_usage:
            return b""
        return frame({"id": rid, "object": obj_name, "created": created,
                      "model": model, "choices": [], "usage": {
                          "prompt_tokens": prompt_tokens[0],
                          "completion_tokens": completion_tokens[0],
                          "total_tokens": (prompt_tokens[0]
                                           + completion_tokens[0])}})

    def encode(pair) -> bytes:
        idx, ev = pair
        if ev.type == "token":
            text = ev.token or ""
            if ev.logprob is not None:
                observed[idx] += 1
            lp_obj = None
            if opts.logprobs:
                if chat:
                    lp_obj = (lp_chat([text], [ev.logprob])
                              if ev.logprob is not None else None)
                else:
                    if ev.logprob is not None:
                        lp_obj = lp_completions([text], [ev.logprob])
                        lp_obj["text_offset"] = [offset[idx]]
                    offset[idx] += len(text)
            if chat:
                delta = {"content": text}
                if first[idx]:
                    delta = {"role": "assistant", **delta}
                    first[idx] = False
                return envelope({"index": idx, "delta": delta,
                                 "logprobs": lp_obj, "finish_reason": None})
            return envelope({"text": text, "index": idx, "logprobs": lp_obj,
                             "finish_reason": None})
        if ev.type == "done":
            if ev.usage is not None:
                prompt_tokens[0] = max(prompt_tokens[0],
                                       ev.usage.prompt_tokens)
                completion_tokens[0] += ev.usage.completion_tokens
            fr = v1_finish(ev.finish_reason)
            choice = ({"index": idx, "delta": {}, "logprobs": None,
                       "finish_reason": fr} if chat else
                      {"text": "", "index": idx, "logprobs": None,
                       "finish_reason": fr})
            return envelope(choice) + maybe_usage_chunk()
        # an error ends its choice like a done event
        completion_tokens[0] += observed[idx]
        return frame({"error": {"message": ev.messages or "",
                                "code": ev.code or "server_error",
                                "index": idx}}) + maybe_usage_chunk()

    return encode


# ---------------------------------------------------------------------------
# the request handler
# ---------------------------------------------------------------------------


def make_handler(server: "InferenceServer") -> type:
    """A ``BaseHTTPRequestHandler`` class bound to ``server``."""
    handler = server.handler
    metrics = server.metrics

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "dis-torch"

        def log_message(self, fmt, *args) -> None:  # quiet access log
            pass

        # -- plain responses -------------------------------------------

        def _send_bytes(self, status: int, body: bytes, ctype: str,
                        headers: Optional[dict] = None) -> None:
            self._status = status
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send(self, status: int, obj,
                  headers: Optional[dict] = None) -> None:
            self._send_bytes(status, json.dumps(obj).encode(),
                             "application/json", headers)

        def _send_error(self, err: ApiError) -> None:
            headers = None
            retry_after = getattr(err, "retry_after_s", None)
            if retry_after is not None:
                # an admission shed: the standard backoff hint
                headers = {"Retry-After":
                           str(int(max(1, round(retry_after))))}
            self._send(err.status_code(), ErrorResponse.of(
                str(err), err.error_type(), err.code()).to_dict(), headers)

        def _bad_param(self, message: str) -> None:
            self._send(400, ErrorResponse.of(
                message, "invalid_request_error",
                "invalid_parameter").to_dict())

        def _not_found(self) -> None:
            self._send(404, {"error": {"message": "not found",
                                       "error_type": "not_found",
                                       "code": "not_found"}})

        def _json_body(self) -> dict:
            n = int(self.headers.get("Content-Length") or 0)
            if n > MAX_BODY_BYTES:
                raise _InvalidBody("request body too large")
            raw = self.rfile.read(n) if n else b""
            try:
                obj = json.loads(raw.decode() or "null")
            except (UnicodeDecodeError, json.JSONDecodeError):
                raise _InvalidBody("request body is not valid JSON") from None
            if not isinstance(obj, dict):
                raise _InvalidBody("request body must be a JSON object")
            return obj

        # -- SSE ---------------------------------------------------------

        def _chunk(self, data: bytes) -> None:
            if data:  # an empty chunk would end the response
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.flush()

        def _idle_check(self) -> None:
            """Raise ``_ClientGone`` when the client closed its socket
            (readable with nothing to read)."""
            sock = self.connection
            readable, _, _ = select.select([sock], [], [], 0)
            if not readable:
                return
            try:
                gone = sock.recv(1, socket.MSG_PEEK) == b""
            except OSError:
                gone = True
            if gone:
                raise _ClientGone()

        def _stream(self, rids, events, encode) -> None:
            """Write ``events`` as SSE frames (``encode`` makes a frame's
            bytes), then ``[DONE]``; abort ``rids`` if the client goes
            away."""
            consumed = False
            try:
                self._status = 200
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for item in events:
                    self._chunk(encode(item))
                consumed = True
                self._chunk(SSE_DONE)
                self.wfile.write(b"0\r\n\r\n")
            except (_ClientGone, *_GONE):
                self.close_connection = True
                self._status = 500
            finally:
                if not consumed:  # no retry, no fallback: the work stops
                    handler.abort(rids)
                events.close()

        # -- routes ------------------------------------------------------

        def _completion(self, chat: bool, v1: bool) -> None:
            """The stream-or-JSON dispatch shared by /generate, /chat and
            their /v1 counterparts."""
            obj = self._json_body()
            opts = V1Opts()
            if v1:
                obj, opts = openai_fields(obj, chat=chat)
            if obj.get("stream") is True and v1:
                rids, events = handler.stream_many(
                    obj, chat=chat, n=opts.n, idle=self._idle_check)
                self._stream(rids, events, v1_chunk_encoder(
                    rids, chat=chat, opts=opts, model=handler.model_name))
            elif obj.get("stream") is True:
                stream = handler.chat_stream if chat else \
                    handler.generate_stream
                rid, events = stream(obj, idle=self._idle_check)
                self._stream([rid], events, sse_encode)
            elif v1:
                rid, choices, usage = handler.complete_many(obj, chat=chat,
                                                            n=opts.n)
                self._send(200, v1_response(rid, choices, usage, chat=chat,
                                            opts=opts,
                                            model=handler.model_name,
                                            tok=handler.tok))
            else:
                resp = (handler.chat if chat else handler.generate)(obj)
                self._send(200, resp.to_dict())

        def _embeddings(self) -> None:
            self._send(200, handler.embeddings(self._json_body()).to_dict())

        def _profile(self) -> None:
            obj = self._json_body()
            steps = obj.get("steps")
            timeout_s = obj.get("timeout_s", 30.0)
            if (not isinstance(steps, int) or isinstance(steps, bool)
                    or not 1 <= steps <= 1000):
                raise _InvalidBody("'steps' must be an integer in [1, 1000]")
            if (not isinstance(timeout_s, (int, float))
                    or not 0 < timeout_s <= 600):
                raise _InvalidBody("'timeout_s' must be in (0, 600]")
            result = server.runner.profile_steps(steps, timeout_s)
            self._send(409 if "error" in result else 200, result)

        def _speculation(self) -> None:
            obj = self._json_body()
            if obj.get("action") != "reset":
                self._send(400, ErrorResponse.of(
                    "'action' must be 'reset'", "invalid_request_error",
                    "invalid_body").to_dict())
                return
            n = 0
            for runner in server.dispatcher.scheduler.engines():
                runner.reset_speculation()
                n += 1
            self._send(200, {"status": "ok", "engines_reset": n})

        def _scale(self) -> None:
            n = self._json_body().get("num_engines")
            if (not isinstance(n, int) or isinstance(n, bool)
                    or not 1 <= n <= 64):
                raise _InvalidBody("'num_engines' must be an integer in "
                                   "[1, 64]")
            try:
                server.scale_to(n)
            except Exception as e:  # noqa: BLE001 — a replica's failure
                self._send(500, ErrorResponse.of(
                    str(e), "server_error", "scale_failed").to_dict())
                return
            statuses = server.dispatcher.scheduler.statuses()
            self._send(200, {"status": "ok", "num_engines": len(statuses),
                             "engines": [st.to_dict() for st in statuses]})

        def _model_swap(self) -> None:
            if server.model_resolver is None:
                self._send(501, ErrorResponse.of(
                    "model swap not configured", "invalid_request_error",
                    "swap_unavailable").to_dict())
                return
            name = self._json_body().get("model")
            if not isinstance(name, str) or not name:
                self._send(400, ErrorResponse.of(
                    "body must contain 'model'", "invalid_request_error",
                    "invalid_body").to_dict())
                return
            ok, err = server.swap_by_name(name)
            if not ok:
                self._send(500, ErrorResponse.of(
                    err, "server_error", "swap_failed").to_dict())
                return
            self._send(200, {"status": "ok", "model": name})

        def _trace(self, query: dict) -> None:
            try:
                n = int(query.get("n", "100"))
                if not 1 <= n <= _TRACE_N_MAX:
                    raise ValueError
            except ValueError:
                self._bad_param("query parameter 'n' must be an integer "
                                f"in [1, {_TRACE_N_MAX}]")
                return
            spans = server.tracer.recent(
                n, trace_id=query.get("trace_id"),
                request_id=query.get("request_id"))
            self._send(200, {"spans": [sp.to_dict() for sp in spans]})

        def _request_list(self, query: dict) -> None:
            try:
                n = int(query.get("n", "50"))
                if not 1 <= n <= 1000:
                    raise ValueError
            except ValueError:
                self._bad_param("query parameter 'n' must be an integer "
                                "in [1, 1000]")
                return
            verdict = query.get("verdict")
            if verdict is not None and verdict not in ("ok", "violated"):
                self._bad_param("query parameter 'verdict' must be 'ok' "
                                "or 'violated'")
                return
            rec = server.recorder
            self._send(200, {"requests": rec.recent(n, verdict=verdict),
                             "stats": rec.stats()})

        def _request_timeline(self, rid: str) -> None:
            tl = server.recorder.timeline(rid)
            if tl is None:
                self._send(404, ErrorResponse.of(
                    "no timeline for this request id (expired from the "
                    "bounded recorder, or never admitted)",
                    "invalid_request_error", "unknown_request").to_dict())
                return
            self._send(200, tl)

        def _reset_counts(self) -> None:
            server.reset_kernel_counts()
            self._send(200, {"kernel_launches": server.kernel_counts()})

        POST_ROUTES = {
            "/generate": lambda self: self._completion(False, False),
            "/chat": lambda self: self._completion(True, False),
            "/embeddings": _embeddings,
            "/v1/completions": lambda self: self._completion(False, True),
            "/v1/chat/completions": lambda self: self._completion(True,
                                                                  True),
            "/v1/embeddings": _embeddings,
            "/server/profile": _profile,
            "/admin/speculation": _speculation,
            "/admin/scale": _scale,
            "/admin/model-swap": _model_swap,
            "/server/kernel_counts/reset": _reset_counts,
        }

        def do_GET(self) -> None:  # noqa: N802 — http.server API
            url = urlsplit(self.path)
            path = url.path
            query = {k: v[-1] for k, v in parse_qs(url.query).items()}
            try:
                if path == "/health":
                    status, body = server.health()
                    self._send(status, body)
                elif path == "/server/stats":
                    self._send(200, server.stats())
                elif path == "/metrics":
                    self._send_bytes(200, server.metrics_text(),
                                     "text/plain; version=0.0.4; "
                                     "charset=utf-8")
                elif path == "/server/trace":
                    self._trace(query)
                elif path == "/server/perf":
                    self._send(200, server.perf_stats())
                elif path == "/server/requests":
                    self._request_list(query)
                elif path.startswith("/server/requests/"):
                    self._request_timeline(
                        unquote(path[len("/server/requests/"):]))
                else:
                    self._not_found()
            except _GONE:
                self.close_connection = True

        def do_POST(self) -> None:  # noqa: N802 — http.server API
            route = self.POST_ROUTES.get(self.path)
            if route is None:
                self._not_found()
                return
            t0 = time.monotonic()
            self._status = 500
            try:
                route(self)
            except ApiError as e:
                self._send_error(e)
            except _GONE:
                self.close_connection = True
                self._status = 500
            finally:
                metrics.record_request(self.path, self._status,
                                       time.monotonic() - t0)

    return Handler
