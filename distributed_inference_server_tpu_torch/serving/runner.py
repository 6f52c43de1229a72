"""Engine runner: a dedicated thread owning one ``LLMEngine`` replica (port
of ``distributed_inference_server_tpu/serving/runner.py``: ``EngineRunner``,
its inbox, the per-request result sinks, the embeddings jobs, the metrics
hooks, restarts, roles, and the replica's side of the KV handoff and the
peer prefix fetch).

The engine is single-owner and synchronous; every interaction with it —
admission, aborts, imports, exports, embeddings jobs, counter reads that
touch engine state — goes through a thread-safe inbox drained on the
runner thread between steps. Step outputs fan out to per-request
``ResultSink``s (``serving/streamer.py``); a sink with a ``flush`` method
gets one call per step in which it received events.

Embeddings (``submit_embed``) run as incremental jobs: one device batch
(``engine.embed_step``) per loop iteration, between engine steps, so a
large embeddings request never stalls the decoding requests.

Roles (``serving/disagg.py``): a ``prefill`` runner admits requests
prefill-only and hands each finished prefill to the ``DisaggController``
(streamed: the prefix pages serialize while the sequence decodes on; or
monolithic); a ``decode`` runner takes migrated sequences
(``submit_resume``, ``submit_import_open`` / ``_commit`` / ``_abort``).
Any runner serves a peer's prefix fetch (``submit_prefix_export``) or
takes one in (``submit_prefix_import``). Every such callback fires
exactly once: on the runner thread, or at once or at a crash when the
engine is (or becomes) unavailable.

Failure semantics: a per-request failure arrives as ``StepOutput.error``
and fails only that request; an exception escaping the step loop marks
the runner unhealthy and resolves everything in flight, exactly once
each: a request that streamed no token goes back to the dispatcher
(``redispatch``) to run on another replica, one that did ends with
``engine_crashed``. The scheduler's health loop then ``restart``s the
runner, which releases the dead engine's pools, CUDA graphs and graph
pool before the factory builds a new one.

Status: ``status()`` answers from snapshots the runner thread refreshes
after each step (load, page counts, the rate-limited prefix digest), so
the scheduler never waits for a replica; ``observe()`` reads the engine's
cumulative counters on the runner thread and hands them to the collector
(``/metrics``, ``/server/stats``, ``/health``).

With ``EngineConfig.warmup_compile`` set, the runner runs
``engine.warmup()`` (every serving program once; on ``cuda`` every CUDA
graph captured) before it reports ready, and keeps its duration in
``warmup_seconds``.

Observability: with a ``tracer`` each admitted request gets an
``engine.infer`` span parented on its request span; with a ``recorder``
(``serving/flightrec.py``) its tokens and terminal event land in its
timeline. After every engine step the step clock's deltas go to the perf
store (``record_step_perf``: the health scorer's wedge signal and the
``step_ms`` digests).

Hot swap (``swap_model``): the new engine is built and warmed up on a
background thread while the old one serves, installed at an inbox drain
(new requests go to it), and the old one finishes its in-flight requests
(stepped between the new engine's steps) and is then released, as a dead
engine is at a restart. A failed build keeps the old model.
"""

from __future__ import annotations

import gc
import logging
import threading
import time
from collections import deque
from typing import (Callable, Deque, Dict, List, Optional, Protocol,
                    Sequence)

import numpy as np
import torch

from distributed_inference_server_tpu_torch.core.models import (
    FinishReason,
    Usage,
)
from distributed_inference_server_tpu_torch.core.types import (
    DEFAULT_TENANT,
    RequestId,
)
from distributed_inference_server_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
    StepOutput,
)
from distributed_inference_server_tpu_torch.ops import kernels
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving.metrics import (
    EngineStatus,
    MetricsCollector,
)

logger = logging.getLogger(__name__)

EmbedCallback = Callable[[Optional[np.ndarray], Optional[str]], None]
DoneCallback = Callable[[bool, Optional[str]], None]


def _release(engines: List[LLMEngine]) -> None:
    """Release stopped or replaced engines: their pools, CUDA graphs and
    graph pools go back to the device. The list is emptied, so with the
    caller holding no other reference the engines are collected here."""
    for eng in engines:
        eng.release()
    engines.clear()
    gc.collect()  # the engine's hooks form reference cycles
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class ResultSink(Protocol):
    """Receives one request's outputs, on the runner thread; methods must
    not block or raise."""

    def on_token(self, token_id: Optional[int], text: str, token_index: int,
                 logprob: Optional[float] = None) -> None: ...

    def on_done(self, finish_reason: FinishReason, usage: Usage) -> None: ...

    def on_error(self, message: str, code: str) -> None: ...


class ServerRequest:
    """A validated, tokenized request on its way to a runner (through the
    admission queue); ``tenant`` is its fair-admission lane,
    ``redispatches`` the moves off dead replicas it has used (bounded by
    the dispatcher's ``max_redispatch``)."""

    __slots__ = ("request_id", "prompt_ids", "params", "sink",
                 "submitted_at", "first_token_at", "tenant", "redispatches",
                 "span", "engine_span")

    def __init__(self, request_id: RequestId, prompt_ids: List[int],
                 params: SamplingParams, sink: ResultSink,
                 tenant: str = DEFAULT_TENANT, span=None):
        self.request_id = request_id
        self.prompt_ids = prompt_ids
        self.params = params
        self.sink = sink
        self.tenant = tenant
        self.submitted_at = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.redispatches = 0
        # the request's root span (owned by the handler) and its
        # engine.infer child (owned by the runner that serves it)
        self.span = span
        self.engine_span = None


class EngineRunner:
    """Runs one engine on a dedicated thread; thread-safe façade."""

    def __init__(self, engine_id: str,
                 engine_factory: Callable[[], LLMEngine],
                 metrics: MetricsCollector, role: str = "unified",
                 disagg=None, tracer=None, recorder=None):
        """``role`` ("prefill" | "decode" | "unified") and ``disagg``
        (the ``DisaggController``) enable disaggregated serving; unified
        (the default) prefills and decodes in place. ``tracer`` /
        ``recorder``: the engine spans and the flight-recorder notes
        (None: off)."""
        self.engine_id = engine_id
        self.role = role
        self._disagg = disagg
        self.tracer = tracer
        self.recorder = recorder
        self._factory = engine_factory
        self.metrics = metrics
        # crash-safe redispatch hook (the server wires the dispatcher's
        # redispatch): called for an in-flight request that streamed no
        # token when this runner dies; True = it took the request
        self.redispatch: Optional[
            Callable[[ServerRequest, str, str], bool]] = None
        self._inbox: Deque[Callable[[], None]] = deque()
        self._inbox_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._healthy = False
        self._last_error: Optional[str] = None
        # per-request dict ops are GIL-atomic; every terminal path pops
        # the entry before resolving it, so each resolves exactly once
        self._inflight: Dict[RequestId, ServerRequest] = {}
        # exactly-once callbacks not yet run by the runner thread (a
        # crash or shutdown resolves them from _fail_all): resumes by
        # request id, import opens and prefix imports, peer exports
        self._pending_resumes: Dict[RequestId, DoneCallback] = {}
        self._pending_opens: Dict[str, DoneCallback] = {}
        self._pending_fetches: Dict[str, Callable] = {}
        # streamed exports in flight ([session, request, stream job]),
        # advanced between steps; owned by the runner thread
        self._export_jobs: Dict[RequestId, list] = {}
        # open import sessions awaiting their commit: id -> (session,
        # engine)
        self._import_sessions: Dict[RequestId, tuple] = {}
        self._engine: Optional[LLMEngine] = None
        self._thread: Optional[threading.Thread] = None
        # embeddings: callbacks by job token (each called exactly once)
        # and the queued jobs, oldest first
        self._pending_embeds: Dict[int, EmbedCallback] = {}
        self._embed_seq = 0
        self._embed_lock = threading.Lock()
        self._embed_jobs: Deque[dict] = deque()
        # snapshots the runner thread refreshes, read by status() from any
        # thread: (waiting, used, total, cached, page_size, digest_depth),
        # the prefix digest (rate-limited) and observe()'s last blocks
        self._load = (0, 0, 0, 0, 0, 0)
        self._prefix_digest: frozenset = frozenset()
        self._digest_ts = 0.0
        self._observed: dict = {}
        # each runner thread's kernel launch tally (one per start)
        self._tallies: List[Dict[str, int]] = []
        # counters read from other threads (GIL-atomic int updates)
        self.requests_finished = 0
        self.tokens_generated = 0
        self.steps = 0
        self.step_seconds = 0.0
        self.warmup_seconds: Optional[float] = None
        self.restarts = 0
        # old engines finishing their in-flight requests after a hot
        # swap (runner thread only)
        self._draining: List[LLMEngine] = []
        # step-clock totals already reported to the perf store
        self._sc_seen: Dict[str, Dict] = {"kinds": {}, "events": {}}
        # host seconds of the handoff's engine work on this replica:
        # exports (prefix pumps, switchover or monolithic export) and
        # imports (open + prefix chunks, commit, or monolithic import)
        self.handoff_s = {"export": 0.0, "import": 0.0, "exports": 0,
                          "imports": 0}

    # -- lifecycle ---------------------------------------------------------

    def start(self, wait_ready: bool = True, timeout: float = 600.0) -> None:
        """Spawn the runner thread; optionally block until the engine is
        built and the runner reports ready."""
        ready = threading.Event()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, args=(ready,), name=f"engine-{self.engine_id}",
            daemon=True)
        self._thread.start()
        if wait_ready and not ready.wait(timeout):
            raise TimeoutError(
                f"engine {self.engine_id} failed to start in {timeout}s")
        if wait_ready and not self._healthy:
            raise RuntimeError(f"engine {self.engine_id} failed to "
                               f"initialize: {self._last_error}")

    def shutdown(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
        self._healthy = False
        self.metrics.set_engine_up(self.engine_id, False)
        self._fail_all("engine shut down before request completion")

    def restart(self, wait_ready: bool = True,
                timeout: float = 600.0) -> None:
        """Tear the engine down, release its device memory, and bring a
        new one up from the factory."""
        self.shutdown()
        with self._inbox_lock:
            self._inbox.clear()
        self._inflight.clear()
        self._export_jobs.clear()
        self.release_engine()
        self.restarts += 1
        self.start(wait_ready=wait_ready, timeout=timeout)

    def release_engine(self) -> None:
        """Drop the (stopped) engine and any old engine still draining
        after a swap: their pools, CUDA graphs and graph pools go back to
        the device before anything new is built."""
        engines = [e for e in [self._engine] + self._draining
                   if e is not None]
        self._engine = None
        self._draining = []
        _release(engines)

    def set_role(self, role: str) -> None:
        """Re-role the runner: ``submit`` reads the role per batch, so
        the next admission batch follows it while in-flight requests
        finish under the old one."""
        self.role = role

    # -- submission (any thread) -------------------------------------------

    def submit(self, requests: Sequence[ServerRequest]) -> None:
        """Admit one admission batch: its requests reach the engine in the
        batch's order (strict priority, then FIFO)."""
        reqs = list(requests)
        # registered here, not on the runner thread: a crash before the
        # inbox drains still resolves these requests
        for r in reqs:
            self._inflight[r.request_id] = r
        if not self._healthy:
            self._fail_all_of(reqs, self._last_error or "engine unavailable")
            return
        # with no decode replica left (scaled away) a prefill replica
        # admits unified: prefill-only would export, retry and fall back
        # on every request
        prefill_only = (self.role == "prefill" and self._disagg is not None
                        and self._disagg.has_decode_targets())

        def _do() -> None:
            for r in reqs:
                if r.request_id in self._inflight:  # not aborted meanwhile
                    if self.tracer is not None and r.span is not None:
                        r.engine_span = self.tracer.start(
                            "engine.infer", parent=r.span.context(),
                            engine_id=self.engine_id,
                            request_id=str(r.request_id),
                            prompt_tokens=len(r.prompt_ids))
                    self._engine.add_request(r.request_id, r.prompt_ids,
                                             r.params,
                                             prefill_only=prefill_only)

        self._post(_do)

    def abort(self, request_id: RequestId) -> None:
        """Drop a request: its pages go back to the allocator; its sink
        gets no further callback."""
        self._inflight.pop(request_id, None)

        def _do() -> None:
            if not self._engine.abort(request_id):
                # still on an old engine draining after a swap
                for eng in self._draining:
                    eng.abort(request_id)

        self._post(_do)

    def submit_resume(self, exp, req: ServerRequest,
                      on_done: DoneCallback) -> None:
        """Resume a migrated sequence here (``engine.import_sequence``).
        ``on_done(ok, err)`` fires exactly once; on ok=False the request
        is deregistered again and the caller (the controller) owns it."""
        # the callback before the request: a concurrent _fail_all that saw
        # the request but not the callback would fail it AND let the
        # fallback resume it
        self._pending_resumes[req.request_id] = on_done
        self._inflight[req.request_id] = req
        if not self._healthy:
            self._inflight.pop(req.request_id, None)
            cb = self._pending_resumes.pop(req.request_id, None)
            if cb is not None:  # None: _fail_all resolved it
                cb(False, self._last_error or "engine unavailable")
            return

        def _do() -> None:
            cb = self._pending_resumes.pop(req.request_id, None)
            if cb is None:
                return  # resolved by _fail_all
            if req.request_id not in self._inflight:
                cb(True, "aborted")  # resolved, but not a transfer
                return
            t0 = time.monotonic()
            try:
                self._engine.import_sequence(exp)
            except Exception as e:  # noqa: BLE001 — import fault domain
                self._inflight.pop(req.request_id, None)
                cb(False, str(e))
                return
            self._handoff_clock("import", t0, count=True)
            cb(True, None)

        self._post(_do)

    def submit_import_open(self, request_id: RequestId, prefix_pages: int,
                           chunks, on_done: DoneCallback) -> None:
        """Phase 1 of a streamed handoff on the target: open an import
        session, reserve the prefix pages and absorb the prefix chunks
        while the source still decodes. ok=True: ready for the commit."""
        token = f"open:{request_id}"
        self._pending_opens[token] = on_done
        if not self._healthy:
            cb = self._pending_opens.pop(token, None)
            if cb is not None:
                cb(False, self._last_error or "engine unavailable")
            return

        def _do() -> None:
            cb = self._pending_opens.pop(token, None)
            if cb is None:
                return  # resolved by _fail_all
            engine = self._engine
            session = None
            t0 = time.monotonic()
            try:
                session = engine.import_stream_open(request_id, prefix_pages)
                engine.import_stream_add(session, chunks)
            except Exception as e:  # noqa: BLE001 — import fault domain
                if session is not None:
                    # the open reserved pages: a bad chunk hands them back
                    try:
                        engine.import_stream_abort(session)
                    except Exception as abort_exc:  # noqa: BLE001
                        self._absorbed("import_abort", abort_exc)
                cb(False, str(e))
                return
            self._import_sessions[request_id] = (session, engine)
            self._handoff_clock("import", t0)
            cb(True, None)

        self._post(_do)

    def submit_import_commit(self, exp, req: ServerRequest,
                             on_done: DoneCallback) -> None:
        """Phase 2: absorb the tail delta, validate, publish and seat (the
        part inside the migrated sequence's stall). Same contract as
        ``submit_resume``."""
        self._pending_resumes[req.request_id] = on_done
        self._inflight[req.request_id] = req
        if not self._healthy:
            self._inflight.pop(req.request_id, None)
            cb = self._pending_resumes.pop(req.request_id, None)
            self._drop_import_session(req.request_id)
            if cb is not None:
                cb(False, self._last_error or "engine unavailable")
            return

        def _do() -> None:
            cb = self._pending_resumes.pop(req.request_id, None)
            if cb is None:
                return  # resolved by _fail_all
            entry = self._import_sessions.pop(req.request_id, None)
            if req.request_id not in self._inflight:
                if entry is not None:  # aborted between open and commit
                    entry[1].import_stream_abort(entry[0])
                cb(True, "aborted")
                return
            if entry is None:
                self._inflight.pop(req.request_id, None)
                cb(False, "no open import session (engine restarted?)")
                return
            session, engine = entry
            if engine is not self._engine:
                # restarted since the open: the reserved pages belong to
                # the old pool
                self._inflight.pop(req.request_id, None)
                cb(False, "engine restarted mid-import")
                return
            t0 = time.monotonic()
            try:
                engine.import_stream_commit(session, exp)
            except Exception as e:  # noqa: BLE001 — import fault domain
                self._inflight.pop(req.request_id, None)
                cb(False, str(e))
                return
            self._handoff_clock("import", t0, count=True)
            cb(True, None)

        self._post(_do)

    def submit_import_abort(self, request_id: RequestId) -> None:
        """Drop an opened, uncommitted import (the source cancelled the
        stream): its reserved pages go back."""
        self._post(lambda: self._drop_import_session(request_id))

    def submit_prefix_export(self, request_id: RequestId,
                             hashes: Sequence[int], chunk_pages: int,
                             wire_quant: str,
                             on_done: Callable[[Optional[tuple],
                                                Optional[str]], None]
                             ) -> None:
        """Peer-fetch source: serialize this engine's cached chain for
        ``hashes`` (HBM and host tier, consecutive from the head).
        ``on_done((depth, chunks), None)`` or ``on_done(None, err)`` fires
        exactly once, so a peer that dies mid-fetch degrades the caller to
        recompute."""
        token = f"pfx:{request_id}"
        self._pending_fetches[token] = on_done
        if not self._healthy:
            cb = self._pending_fetches.pop(token, None)
            if cb is not None:
                cb(None, self._last_error or "engine unavailable")
            return

        def _do() -> None:
            cb = self._pending_fetches.pop(token, None)
            if cb is None:
                return  # resolved by _fail_all
            try:
                depth, chunks = self._engine.export_prefix_chunks(
                    hashes, chunk_pages=chunk_pages, wire_quant=wire_quant)
            except Exception as e:  # noqa: BLE001 — export fault domain
                cb(None, str(e))
                return
            cb((depth, chunks), None)

        self._post(_do)

    def submit_prefix_import(self, request_id: RequestId,
                             tokens: Sequence[int], chunks,
                             on_done: DoneCallback) -> None:
        """Peer-fetch target: validate and scatter the fetched chunks into
        this engine's prefix cache (``engine.import_prefix``), so the
        request submitted next matches them. ok=False: the fetcher falls
        back to recompute."""
        token = f"pfx-import:{request_id}"
        self._pending_opens[token] = on_done
        if not self._healthy:
            cb = self._pending_opens.pop(token, None)
            if cb is not None:
                cb(False, self._last_error or "engine unavailable")
            return

        def _do() -> None:
            cb = self._pending_opens.pop(token, None)
            if cb is None:
                return  # resolved by _fail_all
            try:
                self._engine.import_prefix(tokens, chunks)
            except Exception as e:  # noqa: BLE001 — import fault domain
                cb(False, str(e))
                return
            cb(True, None)

        self._post(_do)

    def _drop_import_session(self, request_id: RequestId) -> None:
        entry = self._import_sessions.pop(request_id, None)
        if entry is not None:
            try:
                entry[1].import_stream_abort(entry[0])
            except Exception as e:  # noqa: BLE001 — cleanup isolation
                self._absorbed("import_abort", e)

    def submit_embed(self, ids_list: List[List[int]],
                     on_result: EmbedCallback) -> None:
        """Queue an embeddings job; ``on_result(array, error)`` is called
        exactly once: on the runner thread, or here or at a crash when
        the engine is (or becomes) unavailable."""
        with self._embed_lock:
            # registered before the health check: a crash in between
            # still finds (and fails) the callback
            self._embed_seq += 1
            token = self._embed_seq
            self._pending_embeds[token] = on_result
        if not self._healthy:
            self._resolve_embed(token, None,
                                self._last_error or "engine unavailable")
            return

        def _enqueue() -> None:
            # the job keeps its engine: a swap mid-job must not mix two
            # models' hidden states
            engine = self._engine
            try:
                state = engine.embed_start(ids_list)
            except Exception as e:  # noqa: BLE001 — called exactly once
                self._resolve_embed(token, None, str(e))
                return
            self._embed_jobs.append({"token": token, "engine": engine,
                                     "state": state})

        self._post(_enqueue)

    def call(self, fn: Callable[[LLMEngine], object],
             timeout: float = 30.0) -> object:
        """Run ``fn(engine)`` on the runner thread and return its result
        (engine state is single-owner)."""
        box: list = []
        done = threading.Event()

        def _do() -> None:
            try:
                box.append(fn(self._engine))
            finally:
                done.set()

        self._post(_do)
        if not done.wait(timeout):
            raise TimeoutError("engine thread did not answer")
        if not box:
            raise RuntimeError("engine call failed")
        return box[0]

    def audit(self, timeout_s: float = 30.0) -> List[str]:
        """KV-page conservation audit on the runner thread, counting open
        import sessions' reserved pages as live holders. Empty = clean; an
        unhealthy runner audits clean (its pool died with it)."""
        if not self._healthy:
            return []
        try:
            return self.call(lambda e: e.audit_pages(
                [p for (session, _e) in self._import_sessions.values()
                 for p in session.pages]), timeout_s)
        except TimeoutError:
            return [f"{self.engine_id}: audit timed out after {timeout_s}s"]

    def profile_steps(self, n: int, timeout_s: float = 30.0) -> dict:
        """A device trace over the next ``n`` engine steps (the engine
        starts and stops it between steps, on its own thread). Blocks up
        to ``timeout_s`` for it to finish (an idle engine only traces once
        work arrives). Returns the summary, or a dict with ``error``."""
        if not self._healthy:
            return {"error": self._last_error or "engine unavailable"}
        box: dict = {}
        armed = threading.Event()

        def _do() -> None:
            box["ev"], box["holder"] = self._engine.profile_steps(n)
            armed.set()

        self._post(_do)
        if not armed.wait(timeout_s):
            return {"error": "engine thread did not arm the trace in time"}
        if not box["ev"].wait(timeout_s):
            self._post(lambda: self._engine.cancel_profile(box["holder"]))
            return {"error": f"trace did not complete within {timeout_s}s "
                             "(engine idle? send traffic while tracing)"}
        return dict(box["holder"])

    def reset_speculation(self) -> None:
        """Clear every request pattern's acceptance tracker, on the engine
        thread: speculation is enabled again with fresh windows (a no-op
        without a draft model)."""

        def _do() -> None:
            if self._engine.spec_trackers is not None:
                self._engine.spec_trackers.reset()

        self._post(_do)

    def set_mixed_prefill_frac(self, frac: float) -> None:
        """Shrink (or restore) the mixed step's prefill share, on the
        engine thread (a no-op while the mixed step is off)."""

        def _do() -> None:
            self._engine.set_mixed_prefill_frac(frac)

        self._post(_do)

    def set_loop_cap_frac(self, frac: float) -> None:
        """Shrink (or restore) the looped block's iteration cap, on the
        engine thread (a no-op while looped blocks are off)."""

        def _do() -> None:
            self._engine.set_loop_cap_frac(frac)

        self._post(_do)

    def evict_cache(self, target_frac: float,
                    drop_host_tier: bool = False) -> None:
        """Evict cached (refcount-0) prefix pages until used / total <=
        ``target_frac``, on the engine thread: they demote to the host
        tier when there is one; ``drop_host_tier`` drops them and clears
        the tier (the ladder's last rung)."""

        def _do() -> None:
            self._engine.evict_cache(target_frac,
                                     drop_host_tier=drop_host_tier)
            self._refresh_load()
            self._refresh_digest(force=True)

        self._post(_do)

    # -- model hot swap ------------------------------------------------------

    def swap_model(self, factory: Callable[[], LLMEngine],
                   on_done: Optional[DoneCallback] = None,
                   cancelled: Optional[threading.Event] = None) -> None:
        """Swap the model: build (and, with ``warmup_compile``, warm up)
        the new engine on a background thread while this one serves, then
        install it at an inbox drain. New requests go to the new engine;
        in-flight ones finish on the old, which is released once it has
        no work. A failed build keeps the old model (``on_done(False,
        err)``); ``cancelled``, checked at the install, abandons a swap
        that missed its deadline. The new engine starts with an empty
        cache and fresh counters; restarts come back on the new model."""

        def _build() -> None:
            self._tallies.append(kernels.thread_launch_counts())
            try:
                eng = factory()
                if eng.ecfg.warmup_compile:
                    eng.warmup()  # the new model must not serve cold
            except Exception as e:  # noqa: BLE001 — keep the old model
                logger.exception("engine %s: model swap failed",
                                 self.engine_id)
                self._last_error = f"model swap failed: {e}"
                gc.collect()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
                if on_done is not None:
                    on_done(False, str(e))
                return

            built = [eng]  # the one reference the install hands over
            del eng

            def _install() -> None:
                if cancelled is not None and cancelled.is_set():
                    _release([built.pop()])
                    if on_done is not None:
                        on_done(False, "swap cancelled")
                    return
                old = [self._engine]
                self._engine = built.pop()
                self._factory = factory
                self._sc_seen = {"kinds": {}, "events": {}}
                if old[0] is None:
                    old.clear()
                elif old[0].has_work():
                    self._draining.append(old.pop())
                if old:
                    _release(old)
                self._refresh_load()
                self._refresh_digest(force=True)
                if on_done is not None:
                    on_done(True, None)

            self._post(_install)
            if not self._healthy:
                # no runner thread drains the inbox: nothing to swap on
                with self._inbox_lock:
                    if _install in self._inbox:
                        self._inbox.remove(_install)
                        _release([built.pop()])
                        if on_done is not None:
                            on_done(False, "engine unavailable")

        threading.Thread(target=_build, name=f"swap-{self.engine_id}",
                         daemon=True).start()

    def tokenizer(self):
        """The installed engine's tokenizer (None before it is built):
        the server retargets the handler's tokenizer after a swap."""
        eng = self._engine
        return eng.tok if eng is not None else None

    def _step_draining(self) -> bool:
        """Step the old engines still finishing requests after a swap; a
        crash there fails only their requests. An engine with no work
        left is released."""
        worked = False
        i = 0
        while i < len(self._draining):
            # indexed, never bound to a local: a released engine must
            # have no reference left for the collector
            if not self._draining[i].has_work():
                _release([self._draining.pop(i)])
                continue
            worked = True
            try:
                self._dispatch(self._draining[i].step())
            except Exception as e:  # noqa: BLE001 — old-model isolation
                ids = set(self._draining[i]._by_id)
                _release([self._draining.pop(i)])
                self._fail_all_of(
                    [r for r in list(self._inflight.values())
                     if r.request_id in ids],
                    f"old model failed during drain: {e}")
                continue
            i += 1
        return worked

    def _post(self, fn: Callable[[], None]) -> None:
        with self._inbox_lock:
            self._inbox.append(fn)
        self._wake.set()

    # -- status (any thread) -----------------------------------------------

    def is_healthy(self) -> bool:
        return self._healthy

    def last_error(self) -> Optional[str]:
        return self._last_error

    def active_count(self) -> int:
        return len(self._inflight)

    def launch_counts(self) -> Dict[str, int]:
        """Kernel launches made on this runner's threads (its engines')
        since the last reset of the counters."""
        out: Dict[str, int] = {}
        for tally in list(self._tallies):
            for name, n in dict(tally).items():
                out[name] = out.get(name, 0) + n
        return out

    def status(self) -> EngineStatus:
        """This replica's ``EngineStatus`` from the runner thread's latest
        snapshots: it never waits for the replica (the scheduler reads it
        for every admission window)."""
        waiting, used, total, cached, page_size, depth = self._load
        o = self._observed
        return EngineStatus(
            engine_id=self.engine_id, healthy=self._healthy,
            active_requests=len(self._inflight), waiting_requests=waiting,
            total_processed=self.requests_finished,
            memory_used_pages=used, memory_total_pages=total,
            pages_cached=cached, role=self.role,
            speculation=o.get("speculation"), mixed=o.get("mixed"),
            loop=o.get("loop"), host_tier=o.get("host_tier"),
            latent=o.get("latent"), prefix_digest=self._prefix_digest,
            page_size=page_size, digest_depth=depth)

    def observe(self) -> EngineStatus:
        """Read the engine's page and queue counts and its cumulative
        counters on the runner thread, hand them to the collector, and
        return the status (the snapshot, collector untouched, when it
        cannot answer)."""
        if self._healthy:
            try:
                (s, waiting, mixed, loop, clock, speculation, host_tier,
                 latent, payload, reloads) = self.call(
                    lambda e: (e.cache_stats(), e.num_waiting(),
                               e.mixed_stats(), e.loop_stats(),
                               e.step_clock_stats(), e.spec_stats(),
                               e.host_tier_stats(), e.latent_stats(),
                               e.payload_byte_counters(),
                               e.drain_reload_durations()))
                _, _, _, _, ps, depth = self._load
                self._load = (waiting, s.pages_total - s.pages_free,
                              s.pages_total, s.pages_cached, ps, depth)
                self._observed = {"mixed": mixed, "loop": loop,
                                  "speculation": speculation,
                                  "host_tier": host_tier, "latent": latent}
                self.metrics.observe_engine(
                    self.engine_id, s, mixed, loop, clock,
                    host_tier=host_tier, payload=payload, reloads=reloads,
                    latent=latent)
                if speculation is not None:
                    self.metrics.set_speculation(self.engine_id, speculation)
            except (TimeoutError, RuntimeError) as e:
                self._absorbed("status", e)
        return self.status()

    # -- runner thread -----------------------------------------------------

    def _run(self, ready: threading.Event) -> None:
        self._tallies.append(kernels.thread_launch_counts())
        try:
            self._engine = self._factory()
            self._sc_seen = {"kinds": {}, "events": {}}
            if self._engine.ecfg.warmup_compile:
                # every serving program before reporting ready: the first
                # request must not pay graph capture in its latency
                t0 = time.monotonic()
                self._engine.warmup()
                self.warmup_seconds = time.monotonic() - t0
            self._refresh_load()
            self._refresh_digest(force=True)
            self._healthy = True
        except Exception as e:  # noqa: BLE001 — startup failure isolation
            logger.exception("engine %s failed to start", self.engine_id)
            self._last_error = str(e)
            self._healthy = False
            ready.set()
            return
        finally:
            self.metrics.set_engine_up(self.engine_id, self._healthy)
        ready.set()
        try:
            while not self._stop.is_set():
                self._drain_inbox()
                worked = False
                if self._engine.has_work():
                    worked = True
                    t0 = time.monotonic()
                    outputs = self._engine.step()
                    # crash mid-step: outputs computed, none delivered
                    faults.fire("runner.step")
                    dt = time.monotonic() - t0
                    self.step_seconds += dt
                    self.steps += 1
                    self.metrics.record_inference(dt)
                    self._dispatch(outputs)
                    self._report_step_clock()
                    self._refresh_load()
                    # forced on the busy-to-idle edge: a request's last
                    # step publishes its prefix chain, and with no later
                    # step the rate-limited refresh would never see it
                    self._refresh_digest(force=not self._engine.has_work())
                if self._drain_handoffs():
                    worked = True
                if self._draining:
                    worked |= self._step_draining()
                worked |= self._embed_quantum()
                if not worked:
                    self._wake.wait(0.005)
                    self._wake.clear()
        except Exception as e:  # noqa: BLE001 — engine-level crash
            logger.exception("engine %s crashed", self.engine_id)
            self._last_error = str(e)
            self._healthy = False
            self.metrics.set_engine_up(self.engine_id, False)
            self._fail_all(str(e))

    def _report_step_clock(self) -> None:
        """The step clock's deltas since the last report into the perf
        store, and each segment's wall time into its ``step_ms`` digest
        (runner thread, after a step)."""
        e = self._engine
        clock = e.step_clock_stats()
        seen = self._sc_seen["kinds"]
        for kind, cur in clock["kinds"].items():
            prev = seen.get(kind, {})
            d = {f: cur[f] - prev.get(f, 0)
                 for f in ("dispatches", "wall_s", "tokens", "rows")}
            if d["dispatches"] > 0 or d["wall_s"] > 0 or d["tokens"] > 0:
                self.metrics.record_step_perf(
                    self.engine_id, kind,
                    dispatches=max(0, int(d["dispatches"])),
                    wall_s=max(0.0, d["wall_s"]),
                    tokens=max(0, int(d["tokens"])),
                    rows=max(0, int(d["rows"])))
        prev_events = self._sc_seen["events"]
        self.metrics.record_step_events_perf(self.engine_id, {
            ev: int(n - prev_events.get(ev, 0))
            for ev, n in clock["events"].items()})
        self._sc_seen = clock
        for kind, wall_s in e.drain_step_samples():
            self.metrics.observe_step(kind, wall_s)

    def _refresh_load(self) -> None:
        e = self._engine
        s = e.cache_stats()
        self._load = (e.num_waiting(), s.pages_total - s.pages_free,
                      s.pages_total, s.pages_cached, e.pcfg.page_size,
                      e.ecfg.digest_depth)

    def _refresh_digest(self, force: bool = False,
                        min_interval_s: float = 0.25) -> None:
        """Snapshot the engine's prefix digest for cache-aware routing
        (runner thread only; rate-limited: the digest is advisory)."""
        now = time.monotonic()
        if not force and now - self._digest_ts < min_interval_s:
            return
        try:
            self._prefix_digest = self._engine.prefix_digest()
            self._digest_ts = now
        except Exception as e:  # noqa: BLE001 — the digest is best-effort
            self._absorbed("prefix_digest", e)

    def _drain_inbox(self) -> None:
        while True:
            with self._inbox_lock:
                if not self._inbox:
                    break
                fn = self._inbox.popleft()
            # crash between submit and drain: requests registered, the
            # engine never saw them (zero tokens: redispatchable). Outside
            # the per-command try: it kills the runner
            faults.fire("runner.inbox")
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — command isolation
                self._absorbed("inbox", e)

    # -- handoff exports (prefill role; runner thread) -----------------------

    def _drain_handoffs(self) -> bool:
        """Export the prefills the engine parked and queue their
        migration. Streamed (the default): the sequence decodes on while
        its prefix pages serialize; a loop iteration later the switchover
        exports only the tail. Draft-model engines and short completions
        take the monolithic export. True if it moved anything."""
        if self._disagg is None or self._engine is None:
            return False
        worked = self._pump_export_jobs()
        ids = self._engine.handoff_ready_ids()
        if not ids:
            return worked
        settings = self._disagg.settings
        stream = settings.stream and self._engine.draft_state is None
        for rid in ids:
            req = self._inflight.get(rid)
            if req is None:  # aborted after readiness
                self._engine.abort(rid)
                continue
            t0 = time.monotonic()
            try:
                if stream:
                    session = self._engine.export_handoff_begin(
                        rid, chunk_pages=settings.chunk_pages,
                        wire_quant=settings.wire_quant)
                    if session is not None:
                        entry = [session, req, None]
                        self._export_jobs[rid] = entry
                        # serialize and open the target now: the pulls
                        # overlap the decode pipeline in flight
                        self._advance_export_job(rid, entry)
                        self._advance_export_job(rid, entry)
                        continue
                    # not worth streaming (tiny prefix or short budget)
                stalled_at = time.monotonic()
                exp = self._engine.export_handoff(
                    rid, wire_quant=settings.wire_quant)
                self._handoff_clock("export", t0, count=True)
            except Exception as e:  # noqa: BLE001 — per-request isolation
                # the engine may still hold the sequence and its pages
                self._engine.abort(rid)
                self._inflight.pop(rid, None)
                self._sink_error(req, f"KV export failed: {e}",
                                 "handoff_failed")
                continue
            if exp is None:
                continue
            exp.source_engine = self.engine_id
            exp.stalled_at = stalled_at
            self._inflight.pop(rid, None)
            self._disagg.enqueue(exp, req, self)
        return True

    def _pump_export_jobs(self) -> bool:
        """Advance each streamed export one stage per loop iteration (the
        sequence decodes a block between stages: the overlap window)."""
        if not self._export_jobs:
            return False
        for rid, entry in list(self._export_jobs.items()):
            self._advance_export_job(rid, entry)
        return True

    def _advance_export_job(self, rid, entry) -> None:
        """One stage of one streamed export: serialize the prefix, open
        the target (phase 1), wait for it, then switch over (export the
        tail and commit, phase 2). A failure before the switchover costs
        nothing: the sequence keeps decoding here."""
        session, req, job = entry
        try:
            if session.dead:
                self._drop_export_job(rid, job, record=False)
                return
            if not session.prefix_done:
                t0 = time.monotonic()
                self._engine.export_handoff_pump(session)
                self._handoff_clock("export", t0)
                return  # the target opens while the next block decodes
            if job is None:
                job = self._disagg.open_stream(
                    rid, session.chunks, len(session.prefix_pages),
                    session.wire_quant, req, self)
                if job is None:  # controller not accepting
                    self._cancel_export(rid, session, None, record=False)
                    return
                entry[2] = job
                return
            if job.status == "opening":
                if time.monotonic() > job.deadline:
                    self._cancel_export(rid, session, job, record=True)
                return
            if job.status in ("failed", "cancelled"):
                self._cancel_export(rid, session, job,
                                    record=job.status == "failed")
                return
            # target ready: switch over
            t0 = time.monotonic()
            exp, outputs = self._engine.export_handoff_finish(session)
            self._handoff_clock("export", t0, count=True)
            self._dispatch(outputs)
            self._export_jobs.pop(rid, None)
            if exp is None or rid not in self._inflight:
                # finished, aborted or preempted in place meanwhile
                self._disagg.cancel_stream(job, record=False)
                return
            exp.source_engine = self.engine_id
            self._inflight.pop(rid, None)
            self._disagg.commit_stream(job, exp)
        except Exception as e:  # noqa: BLE001 — per-request isolation
            self._drop_export_job(rid, job, record=False)
            self._engine.abort(rid)
            self._inflight.pop(rid, None)
            self._sink_error(req, f"KV export failed: {e}", "handoff_failed")

    def _handoff_clock(self, kind: str, t0: float,
                       count: bool = False) -> None:
        self.handoff_s[kind] += time.monotonic() - t0
        if count:
            self.handoff_s[kind + "s"] += 1

    def _cancel_export(self, rid, session, job, record: bool) -> None:
        """Abandon a streamed export before the switchover: the sequence
        keeps decoding here; the target's reserved pages are released."""
        self._engine.export_handoff_cancel(session)
        self._drop_export_job(rid, job, record=record)

    def _drop_export_job(self, rid, job, record: bool) -> None:
        self._export_jobs.pop(rid, None)
        if job is not None and self._disagg is not None:
            self._disagg.cancel_stream(job, record=record)

    # -- step outputs (runner thread) ----------------------------------------

    def _embed_quantum(self) -> bool:
        """Advance the oldest embeddings job by one device batch. Returns
        True if it did work."""
        if not self._embed_jobs:
            return False
        job = self._embed_jobs[0]
        if job["token"] not in self._pending_embeds:
            self._embed_jobs.popleft()  # failed by a crash handler
            return True
        result = error = None
        try:
            if job["engine"].embed_step(job["state"]):
                result = job["engine"].embed_finish(job["state"])
        except Exception as e:  # noqa: BLE001 — isolation boundary
            error = str(e)
        if result is not None or error is not None:
            self._embed_jobs.popleft()
            self._resolve_embed(job["token"], result, error)
        return True

    def _resolve_embed(self, token: int, result, error) -> None:
        with self._embed_lock:
            cb = self._pending_embeds.pop(token, None)
        if cb is not None:
            try:
                cb(result, error)
            except Exception as e:  # noqa: BLE001 — callback isolation
                self._absorbed("embed_callback", e)

    def _dispatch(self, outputs: List[StepOutput]) -> None:
        tokens = 0
        touched = {}
        for out in outputs:
            req = self._inflight.get(out.request_id)
            if req is None:
                continue
            touched[out.request_id] = req.sink
            try:
                if out.error is not None:
                    if self.recorder is not None:
                        self.recorder.finish(out.request_id, "error",
                                             code="inference_failed")
                    req.sink.on_error(out.error, "inference_failed")
                elif out.token_id is not None or out.text:
                    if req.first_token_at is None:
                        req.first_token_at = time.monotonic()
                        self.metrics.record_ttft(
                            req.first_token_at - req.submitted_at)
                        if req.engine_span is not None:
                            req.engine_span.event("first_token")
                    if out.token_id is not None:
                        tokens += 1
                        if self.recorder is not None:
                            self.recorder.token(out.request_id)
                    if not out.finished:
                        req.sink.on_token(out.token_id, out.text,
                                          out.token_index, out.logprob)
                if out.finished:
                    # the span and the timeline end before the client
                    # hears of it: a client that reads /server/trace or
                    # /server/requests/<id> right after its answer finds
                    # them finished
                    self._finish_engine_span(
                        req, "ok" if out.error is None else "error",
                        out.usage)
                    if out.error is None:
                        if self.recorder is not None:
                            self.recorder.finish(out.request_id, "ok")
                        if out.text:  # final delta rides the done event
                            req.sink.on_token(None, out.text,
                                              out.token_index)
                        req.sink.on_done(out.finish_reason
                                         or FinishReason.STOP,
                                         out.usage or Usage())
                    self._inflight.pop(out.request_id, None)
                    self.requests_finished += 1
            except Exception as e:  # noqa: BLE001 — sink isolation
                self._absorbed("sink", e)
                self._inflight.pop(out.request_id, None)
        for sink in touched.values():
            flush = getattr(sink, "flush", None)
            if flush is not None:
                flush()
        self.tokens_generated += tokens
        self.metrics.record_tokens(tokens)

    def _finish_engine_span(self, req: ServerRequest, status: str,
                            usage: Optional[Usage] = None) -> None:
        span, req.engine_span = req.engine_span, None
        if span is not None and self.tracer is not None:
            if usage is not None:
                span.set(completion_tokens=usage.completion_tokens)
            self.tracer.finish(span, status=status)

    def _absorbed(self, site: str, exc: BaseException) -> None:
        """An exception eaten at an isolation boundary: logged, kept as
        the last error and counted in ``errors_total``."""
        logger.warning("runner %s: %s absorbed: %s", self.engine_id, site,
                       exc)
        self._last_error = f"{site}: {exc}"
        self.metrics.record_error(f"runner.{site}")

    def _sink_error(self, req: ServerRequest, message: str,
                    code: str) -> None:
        self._finish_engine_span(req, "error")
        if self.recorder is not None:
            self.recorder.finish(req.request_id, "error", code=code)
        try:
            req.sink.on_error(message, code)
        except Exception as e:  # noqa: BLE001 — sink isolation
            self._absorbed("sink", e)

    def _fail_all(self, message: str) -> None:
        """Resolve everything in flight, exactly once each, when the
        engine dies or stops."""
        # streamed exports die with the engine: cancel their stream jobs
        # so the targets' reserved pages are released
        for rid, entry in list(self._export_jobs.items()):
            self._drop_export_job(rid, entry[2], record=False)
        self._export_jobs.clear()
        # un-run resumes first, out of _inflight: on_done(False) hands the
        # request back to the controller's fallback, which owns it
        for rid in list(self._pending_resumes):
            cb = self._pending_resumes.pop(rid, None)
            if cb is None:
                continue
            self._inflight.pop(rid, None)
            try:
                cb(False, message)
            except Exception as e:  # noqa: BLE001 — callback isolation
                self._absorbed("resume_callback", e)
        # un-run opens and prefix imports (the stream falls back to
        # decoding on its source, the fetch to recompute), then peer
        # exports (the fetcher recomputes on its target)
        for token in list(self._pending_opens):
            cb = self._pending_opens.pop(token, None)
            if cb is not None:
                try:
                    cb(False, message)
                except Exception as e:  # noqa: BLE001 — callback isolation
                    self._absorbed("open_callback", e)
        for token in list(self._pending_fetches):
            cb = self._pending_fetches.pop(token, None)
            if cb is not None:
                try:
                    cb(None, message)
                except Exception as e:  # noqa: BLE001 — callback isolation
                    self._absorbed("fetch_callback", e)
        for rid in list(self._import_sessions):
            self._drop_import_session(rid)
        self._fail_all_of(list(self._inflight.values()), message)
        self._inflight.clear()
        with self._embed_lock:
            tokens = list(self._pending_embeds)
        for token in tokens:
            self._resolve_embed(token, None, message)

    def _fail_all_of(self, reqs: Sequence[ServerRequest],
                     message: str) -> None:
        """Resolve dead in-flight requests, exactly once each: each is
        popped from ``_inflight`` first, then takes one terminal path —
        redispatch (no token streamed yet: the dispatcher runs it on
        another replica), or a sink error: ``worker_failure`` for a
        zero-token request the dispatcher declined, ``engine_crashed``
        for one that streamed tokens (a re-run could continue the stream
        differently)."""
        for req in reqs:
            if self._inflight.pop(req.request_id, None) is None:
                continue  # another failure path owns it
            if req.first_token_at is None and self.redispatch is not None:
                # the dead replica's engine span ends here; the new
                # replica opens its own under the same request span
                self._finish_engine_span(req, "error")
                try:
                    if self.redispatch(req, self.engine_id, message):
                        continue  # the new owner resolves the sink
                except Exception as e:  # noqa: BLE001 — hook isolation
                    self._absorbed("redispatch", e)
            code = ("worker_failure" if req.first_token_at is None
                    else "engine_crashed")
            self._sink_error(req, message, code)
