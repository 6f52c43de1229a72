"""Disaggregated prefill/decode serving: engine roles, the KV handoff
channel, the migration controller and the peer prefix fetcher (port of
``distributed_inference_server_tpu/serving/disagg.py`` for replicas in
one process: the fleet's remote replicas and KV data channels are not
ported).

The serving spine (queue → batcher → scheduler → engine runners) treats
every engine as a monolith that prefills and decodes in place, which
couples long-prompt prefill latency to the decode TBT of every other
request on that replica. This subsystem splits the pipeline:

- every engine runner carries a **role** — ``prefill``, ``decode``, or
  ``unified`` (the default; preserves the monolithic behavior exactly);
- the scheduler routes **admission batches to prefill engines** (least-
  load among non-decode replicas) and, after a request's first token,
  the runner parks the sequence for **migration**: the engine exports
  its paged K/V + host state (``LLMEngine.export_handoff``), a
  **KVTransferChannel** moves the payload, and a decode engine imports
  it (``LLMEngine.import_sequence``) and resumes decoding at the exact
  same position — token-identical under greedy sampling;
- the **DisaggController** owns the migration queue and a worker thread
  with timeout/retry; any failure (channel error, no healthy decode
  engine, import CacheFull, dtype mismatch) **falls back to decoding in
  place** on the source engine, so a handoff can degrade the topology
  but never drop a request. Fallbacks are visible in metrics
  (``kv_handoff_total{outcome="fallback"}``).

Channel backends: ``InProcessChannel`` hands the payload object over
zero-copy (the single-process deployment); ``ProtowireChannel`` frames
it through the ``KvHandoff`` protobuf message (serving/protowire.py,
contract in serving/inference.proto) — the cross-process wire format a
gRPC transport will carry, exercised end-to-end in-process so the
framing cannot rot before the multi-host deployment lands.

Shutdown drains: the controller stops accepting migrations and resumes
every queued job in place, so graceful shutdown (Req 9.5) holds across
the disaggregated topology.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

from distributed_inference_server_tpu_torch.core.errors import ConfigError
from distributed_inference_server_tpu_torch.engine.engine import (
    SamplingParams,
    SequenceExport,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import KvChunk
from distributed_inference_server_tpu_torch.serving import faults, protowire
from distributed_inference_server_tpu_torch.serving.metrics import (
    MetricsCollector,
)

logger = logging.getLogger(__name__)

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_UNIFIED = "unified"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_UNIFIED)


class HandoffError(RuntimeError):
    """A KV handoff attempt failed (channel or import); the controller
    retries and ultimately falls back to in-place decode."""


@dataclass(frozen=True)
class DisaggSettings:
    """Knobs for the migration controller (serving config section
    ``disagg``, CLI ``--disagg-*``)."""

    handoff_timeout_s: float = 5.0
    handoff_retries: int = 1  # attempts beyond the first
    channel: str = "inproc"  # inproc | protowire
    # streamed handoff (docs/DISAGG.md "Streaming handoff"): serialize
    # page-group chunks while the sequence keeps decoding on the source,
    # sending only the overlap-window tail at switchover. stream=False
    # forces the monolithic stop-the-world export everywhere (the
    # pre-streaming behavior, kept for A/B benching).
    stream: bool = True
    chunk_pages: int = 8  # pages per KvChunk
    # per-chunk wire encoding of float pools: "int8" halves-plus the
    # bytes moved (per-vector absmax codes + f32 scales) at a bounded
    # accuracy cost; "latent"/"latent_int8" project pages into a rank-r
    # latent (docs/CACHING.md "Latent KV pages") for a further shrink,
    # degrading to "none" on engines without a codec; natively quantized
    # pools pass through unchanged
    wire_quant: str = "none"  # none | int8 | latent | latent_int8


def parse_roles(spec: str, num_engines: int,
                fleet: bool = False) -> List[str]:
    """Parse/validate ``server.engine_roles`` ("prefill,decode", ...).

    Empty spec = every engine ``unified`` (today's behavior). Raises
    ConfigError for unknown roles, a count mismatch with
    ``server.num_engines``, and nonsensical topologies: decode engines
    with no prefill engine would never receive work, and prefill engines
    with no decode engine would have nowhere to hand off (the messages
    are the reference's). ``fleet`` relaxes the two topology checks, as
    in the reference, where the counterpart role may live on another
    fleet member; the port refuses the fleet settings themselves
    (``ServerConfig.check_ported``).
    """
    if not spec.strip():
        return [ROLE_UNIFIED] * num_engines
    roles = [r.strip().lower() for r in spec.split(",") if r.strip()]
    for r in roles:
        if r not in ROLES:
            raise ConfigError(
                f"server.engine_roles: unknown role {r!r} "
                f"(known: {', '.join(ROLES)})"
            )
    if len(roles) != num_engines:
        raise ConfigError(
            f"server.engine_roles lists {len(roles)} roles but "
            f"server.num_engines is {num_engines}"
        )
    n_prefill = roles.count(ROLE_PREFILL)
    n_decode = roles.count(ROLE_DECODE)
    if n_decode and not n_prefill and not fleet:
        raise ConfigError(
            "server.engine_roles: decode engines without any prefill "
            "engine would sit idle — prompts are only admitted to "
            "prefill/unified replicas and only prefill replicas "
            "migrate (a decode-only topology is legal in fleet worker "
            "mode, where the prefill fleet lives on other members)"
        )
    if n_prefill and not n_decode and not fleet:
        raise ConfigError(
            "server.engine_roles: prefill engines need at least one "
            "decode engine to hand off to (a prefill-only topology is "
            "legal with fleet.enabled, where decode members join over "
            "the KV data plane)"
        )
    return roles


# ---------------------------------------------------------------------------
# Transfer channels
# ---------------------------------------------------------------------------


class KVTransferChannel:
    """Moves a SequenceExport from a prefill engine toward a decode
    engine. ``transfer`` returns the payload as the receiver will see it
    and raises on failure (the controller retries / falls back).

    Streamed (two-phase) handoffs use the chunk-iterator API instead:
    ``transfer_chunks`` moves the immutable-prefix KvChunks while the
    source sequence is still decoding, and ``transfer_commit`` moves the
    switchover delta (tail chunks + host state). The defaults pass
    objects by reference (the in-process deployment)."""

    name = "null"

    def transfer(self, exp: SequenceExport) -> SequenceExport:
        raise NotImplementedError

    def transfer_chunks(self, request_id, wire_quant: str,
                        chunks: List[KvChunk],
                        trace: Optional[tuple] = None) -> List[KvChunk]:
        """``trace`` is the request's ``Span.context()`` tuple (or
        None): it rides the KvHandoffHeader so the receiving side can
        parent its import span on the request's trace
        (docs/OBSERVABILITY.md)."""
        return chunks

    def transfer_commit(self, exp: SequenceExport,
                        tail: List[KvChunk]) -> SequenceExport:
        """The commit payload carries ONLY the tail chunks — the target
        session already holds the prefix."""
        return dataclasses.replace(exp, kv_chunks=list(tail))

    def transfer_fetch_request(self, request_id, hashes: Sequence[int],
                               chunk_pages: int, wire_quant: str,
                               trace: Optional[tuple] = None) -> tuple:
        """Move the fetch_prefix REQUEST half toward the peer (fleet
        prefix sharing, PrefixFetcher): returns ``(request_id, hashes,
        chunk_pages, wire_quant, trace)`` as the peer will see them —
        ``trace`` is the (trace_id, parent_span_id) context the fetch
        span parents on, round-tripped through the KvPrefixFetch wire
        fields under protowire. The response travels back as KvChunks
        via ``transfer_chunks``."""
        return (request_id, list(hashes), chunk_pages, wire_quant,
                tuple(trace) if trace else None)


class InProcessChannel(KVTransferChannel):
    """Zero-copy in-process handoff: both engines live in this process,
    so the export object moves by reference — the page bytes are not
    copied again beyond the device→host pull serialize_kv already did."""

    name = "inproc"

    def transfer(self, exp: SequenceExport) -> SequenceExport:
        return exp


def export_to_wire(exp: SequenceExport) -> bytes:
    """Encode a SequenceExport as a length-delimited ``KvHandoff``
    protobuf message (serving/inference.proto)."""
    obj: Dict[str, Any] = {
        "request_id": str(exp.request_id),
        "token_ids": [int(t) for t in exp.token_ids],
        "prompt_len": exp.prompt_len,
        "seq_len": exp.seq_len,
        "next_token": int(exp.next_token),
        "emitted_tokens": exp.emitted_tokens,
        "output_text": exp.output_text,
        "emitted_upto": exp.emitted_upto,
        "pending_ids": [int(t) for t in exp.pending_ids],
        "max_tokens": exp.params.max_tokens,
        "temperature": exp.params.temperature,
        "top_p": exp.params.top_p,
        "stop_sequences": list(exp.params.stop_sequences),
        "kv": exp.kv,
        "source_engine": exp.source_engine,
    }
    if exp.draft_kv is not None:
        obj["draft_kv"] = exp.draft_kv
    return protowire.encode("KvHandoff", obj)


def export_from_wire(data: bytes) -> SequenceExport:
    """Decode a ``KvHandoff`` frame back into a SequenceExport."""
    d = protowire.decode("KvHandoff", data)
    return SequenceExport(
        request_id=d["request_id"],
        token_ids=list(d["token_ids"]),
        prompt_len=d["prompt_len"],
        seq_len=d["seq_len"],
        next_token=d["next_token"],
        params=SamplingParams(
            max_tokens=d["max_tokens"],
            temperature=d["temperature"],
            top_p=d["top_p"],
            stop_sequences=tuple(d["stop_sequences"]),
        ),
        output_text=d["output_text"],
        emitted_upto=d["emitted_upto"],
        emitted_tokens=d["emitted_tokens"],
        pending_ids=list(d["pending_ids"]),
        kv=d["kv"],
        draft_kv=d.get("draft_kv"),
        source_engine=d["source_engine"],
    )


# -- streamed framing (chunk-iterator wire API) -----------------------------
#
# A streamed handoff crosses the wire as a frame sequence:
#   1 x KvHandoffHeader  (handoff id, request id, wire_quant)
#   N x KvChunk          (index/total, page range, crc32, payload)
#   1 x KvHandoff        (the host state; kv bytes empty — pages moved
#                         in the chunks)
# A real transport (gRPC streaming) maps the (message, bytes) pairs onto
# its own envelope; the in-process ProtowireChannel round-trips the same
# frames so the format is differentially tested on every migration.


def chunks_to_frames(request_id, wire_quant: str, chunks: List[KvChunk],
                     trace: Optional[tuple] = None):
    """Frame a chunk batch as ``(message_name, frame_bytes)`` pairs:
    one KvHandoffHeader, then one KvChunk per chunk — the sender half of
    the chunk-iterator channel API, framed lazily so a transport can put
    each frame on the wire while the next serializes. ``trace`` is the
    request's (trace_id, parent_span_id) context; it rides the header
    so the receiver's spans stitch into the request's trace."""
    hid = str(request_id)
    header = {
        "handoff_id": hid,
        "request_id": str(request_id),
        "wire_quant": wire_quant,
    }
    if trace:
        header["trace_id"], header["parent_span_id"] = trace
    yield "KvHandoffHeader", protowire.encode("KvHandoffHeader", header)
    for c in chunks:
        yield "KvChunk", protowire.encode("KvChunk", {
            "handoff_id": hid,
            "index": c.index,
            "total": c.total,
            "page_start": c.page_start,
            "page_count": c.page_count,
            "crc32": c.crc32,
            "payload": c.payload,
        })


def stream_to_frames(exp: SequenceExport, trace: Optional[tuple] = None):
    """Frame a chunked SequenceExport: header, its chunks, then the
    terminal KvHandoff frame carrying the host state (kv bytes empty —
    the pages moved in the chunks)."""
    yield from chunks_to_frames(exp.request_id, exp.wire_quant,
                                exp.kv_chunks or [], trace=trace)
    yield "KvHandoff", export_to_wire(exp)


def frames_to_parts(frames):
    """Decode a frame sequence into ``(header, chunks, state)`` — state
    is None for a prefix-only (phase 1) batch. Chunk frames may arrive
    in any order. Raises HandoffError on a malformed stream."""
    header: Optional[Dict[str, Any]] = None
    chunks: List[KvChunk] = []
    state: Optional[SequenceExport] = None
    for kind, data in frames:
        if kind == "KvHandoffHeader":
            header = protowire.decode("KvHandoffHeader", data)
        elif kind == "KvChunk":
            d = protowire.decode("KvChunk", data)
            if header is None or d["handoff_id"] != header["handoff_id"]:
                raise HandoffError(
                    "KvChunk before header or with a foreign handoff_id"
                )
            chunks.append(KvChunk(
                index=d["index"], total=d["total"],
                page_start=d["page_start"], page_count=d["page_count"],
                payload=d["payload"], crc32=d["crc32"],
            ))
        elif kind == "KvHandoff":
            state = export_from_wire(data)
        else:
            raise HandoffError(f"unknown stream frame {kind!r}")
    if header is None:
        raise HandoffError("truncated handoff stream (header missing)")
    return header, sorted(chunks, key=lambda c: c.index), state


def stream_from_frames(frames) -> SequenceExport:
    """Reassemble a full SequenceExport (chunks + host state) from
    streamed frames — the one-shot receiver used by
    ProtowireChannel.transfer."""
    header, chunks, state = frames_to_parts(frames)
    if state is None:
        raise HandoffError("truncated handoff stream (state missing)")
    state.kv_chunks = chunks
    state.wire_quant = header["wire_quant"] or "none"
    return state


class ProtowireChannel(KVTransferChannel):
    """Cross-process framing exercised in-process: every handoff
    round-trips through the ``KvHandoff`` protobuf encoding — or, for
    streamed exports, the KvHandoffHeader/KvChunk/KvHandoff frame
    sequence — so the wire format the future gRPC transport will carry
    is differentially tested on every migration instead of rotting in a
    docstring."""

    name = "protowire"

    def transfer(self, exp: SequenceExport) -> SequenceExport:
        if exp.kv_chunks is not None:
            return stream_from_frames(stream_to_frames(exp))
        return export_from_wire(export_to_wire(exp))

    def transfer_chunks(self, request_id, wire_quant: str,
                        chunks: List[KvChunk],
                        trace: Optional[tuple] = None) -> List[KvChunk]:
        _header, wired, _state = frames_to_parts(
            chunks_to_frames(request_id, wire_quant, chunks, trace=trace)
        )
        return wired

    def transfer_commit(self, exp: SequenceExport,
                        tail: List[KvChunk]) -> SequenceExport:
        return stream_from_frames(stream_to_frames(
            dataclasses.replace(exp, kv_chunks=list(tail))
        ))

    def transfer_fetch_request(self, request_id, hashes: Sequence[int],
                               chunk_pages: int, wire_quant: str,
                               trace: Optional[tuple] = None) -> tuple:
        obj = {
            "request_id": str(request_id),
            "hashes": [int(h) for h in hashes],
            "chunk_pages": chunk_pages,
            "wire_quant": wire_quant,
        }
        if trace:
            obj["trace_id"], obj["parent_span_id"] = trace
        d = protowire.decode("KvPrefixFetch", protowire.encode(
            "KvPrefixFetch", obj))
        wire_trace = ((d.get("trace_id"), d.get("parent_span_id"))
                      if d.get("trace_id") else None)
        return (d["request_id"], d["hashes"], d["chunk_pages"],
                d["wire_quant"] or "none", wire_trace)


def make_channel(name: str) -> KVTransferChannel:
    if name == "inproc":
        return InProcessChannel()
    if name == "protowire":
        return ProtowireChannel()
    raise ConfigError(
        f"disagg.channel must be inproc/protowire, got {name!r}"
    )


# ---------------------------------------------------------------------------
# Migration controller
# ---------------------------------------------------------------------------


@dataclass
class _StreamJob:
    """Phase-1 state of a two-phase streamed migration: the immutable
    prefix is transferred and OPENED on a decode engine while the source
    sequence is still decoding in place. The source runner polls
    ``status`` between steps and switches over on "ready"; "failed" /
    "cancelled" cost nothing — the sequence simply keeps decoding where
    it is. Transitions happen under the controller's ``_cv``."""

    request_id: Any
    chunks: List[KvChunk]  # prefix chunks (source-side objects)
    n_prefix_pages: int
    wire_quant: str
    req: Any
    source: Any
    enqueued_at: float = field(default_factory=time.monotonic)
    deadline: float = 0.0
    target: Any = None  # decode EngineRunner, set when opened
    status: str = "opening"  # opening | ready | failed | cancelled
    error: str = ""
    # kv.handoff span (docs/OBSERVABILITY.md), parented on the request's
    # trace context — the same context the KvHandoffHeader carries
    span: Any = None


@dataclass
class _MigrationJob:
    exp: SequenceExport
    req: Any  # ServerRequest (typed loosely to avoid an import cycle)
    source: Any  # EngineRunner that prefilled (the in-place fallback)
    enqueued_at: float = field(default_factory=time.monotonic)
    deadline: float = 0.0
    attempts: int = 0
    # set on a phase-2 (switchover commit) job: the opened stream whose
    # target already holds the prefix
    stream: Optional[_StreamJob] = None
    # kv.handoff span for MONOLITHIC migrations (streamed jobs carry it
    # on their _StreamJob)
    span: Any = None


class DisaggController:
    """Owns the migration queue between prefill and decode engines.

    Prefill runners enqueue ``(export, request, source_runner)`` after
    the first token; the worker thread moves each payload through the
    channel, picks the least-loaded healthy decode engine
    (``scheduler.schedule_decode``), and resumes the request there. Any
    failure — channel error, no decode engine, import rejection — is
    retried up to ``handoff_retries`` times within ``handoff_timeout_s``,
    then falls back to resuming on the SOURCE engine, so the request
    completes (merely un-disaggregated) instead of dropping. Shutdown
    drains the queue the same way.
    """

    def __init__(
        self,
        scheduler,
        metrics: Optional[MetricsCollector] = None,
        channel: Optional[KVTransferChannel] = None,
        settings: Optional[DisaggSettings] = None,
        tracer=None,
        recorder=None,
    ):
        """``tracer``/``recorder`` (docs/OBSERVABILITY.md): migrations
        get a ``kv.handoff`` span parented on the request's trace
        context (the same context the KvHandoffHeader carries across
        the channel) and note handoff phases into the request's
        flight-recorder timeline — the stall windows feed the
        ``handoff_stall`` phase attribution."""
        self.scheduler = scheduler
        self.metrics = metrics
        self.tracer = tracer
        self.recorder = recorder
        self.channel = channel or InProcessChannel()
        self.settings = settings or DisaggSettings()
        # shared retry budget (serving/health.py RetryBudget), wired by
        # the server: retry attempts beyond the first draw from it, so
        # a sick decode fleet cannot turn every migration into retry
        # amplification (exhaustion = straight to the in-place
        # fallback). Single-writer at boot  # distlint: ignore[DL008]
        self.retry_budget = None
        self._jobs: Deque[_MigrationJob] = deque()
        self._cv = threading.Condition()
        # requests between dequeue and resume-submit: counted by
        # pending_count() so the dispatcher's drain loop cannot miss a
        # request that is in neither a queue nor a runner's inflight map
        self._migrating: Dict[Any, _MigrationJob] = {}
        # client disconnects that raced an in-flight migration: checked
        # right before the resume submit so a dead request is dropped
        # instead of decoding to completion into a closed sink
        self._aborted: set = set()
        self._stop = threading.Event()
        self._accepting = False
        self._thread: Optional[threading.Thread] = None
        # host seconds the worker spent in the channel (every transfer,
        # failed attempts included); written by the worker thread only
        self.channel_s = 0.0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._cv:
            self._accepting = True
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._worker, name="disagg-migrator", daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        """Stop accepting migrations and drain: every queued job resumes
        in place on its source engine (drain-on-shutdown semantics — a
        graceful shutdown may lose disaggregation, never requests)."""
        self._stop.set()
        with self._cv:
            # _accepting flips under _cv: enqueue re-checks it under the
            # same lock, so a job can land in _jobs concurrently with
            # shutdown only BEFORE this block — where the drain below
            # still sees it — never after (distlint DL002-adjacent race:
            # an orphaned job would hang its client forever)
            self._accepting = False
            leftovers = list(self._jobs)
            self._jobs.clear()
            for job in leftovers:
                if isinstance(job, _StreamJob):
                    # phase-1 streams: the sequence is still decoding on
                    # its source — flipping to cancelled makes the source
                    # keep it in place, which IS the drain semantics
                    job.status = "cancelled"
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        for job in leftovers:
            if isinstance(job, _StreamJob):
                if job.target is not None:
                    job.target.submit_import_abort(job.request_id)
                continue
            if job.stream is not None and job.stream.target is not None:
                job.stream.target.submit_import_abort(
                    job.stream.request_id)
            self._fallback(job, "controller shutdown")

    # -- observability helpers ---------------------------------------------

    def _trace_ctx(self, req) -> Optional[tuple]:
        span = getattr(req, "span", None)
        return span.context() if span is not None else None

    def _start_handoff_span(self, req, source, streamed: bool):
        """A ``kv.handoff`` span parented on the request's trace — the
        SAME context the KvHandoffHeader carries, so a cross-process
        receiver would stitch identically (docs/OBSERVABILITY.md)."""
        if self.tracer is None:
            return None
        ctx = self._trace_ctx(req)
        if ctx is None:
            return None
        return self.tracer.start(
            "kv.handoff", parent=ctx, request_id=str(req.request_id),
            source=source.engine_id, streamed=streamed,
        )

    @staticmethod
    def _span_holder(mjob: _MigrationJob):
        return mjob.stream if mjob.stream is not None else mjob

    def _finish_handoff_span(self, holder, outcome: str, **attrs) -> None:
        span, holder.span = getattr(holder, "span", None), None
        if span is not None and self.tracer is not None:
            span.set(outcome=outcome, **attrs)
            self.tracer.finish(span)

    def _note(self, req, name: str, **attrs) -> None:
        if self.recorder is not None:
            self.recorder.note(req.request_id, name, **attrs)

    # -- submission (runner threads) ---------------------------------------

    def enqueue(self, exp: SequenceExport, req, source) -> None:
        """Queue a migration. Called on the source runner's thread right
        after export; if the controller is not accepting (shutdown race),
        the request resumes in place immediately."""
        job = _MigrationJob(
            exp=exp, req=req, source=source,
            deadline=time.monotonic() + self.settings.handoff_timeout_s,
            span=self._start_handoff_span(req, source, streamed=False),
        )
        self._note(req, "handoff_export", source=source.engine_id)
        with self._cv:
            if self._accepting:
                self._jobs.append(job)
                self._cv.notify()
                return
        # checked under _cv: a shutdown racing this enqueue either sees
        # the job in _jobs (and drains it) or we see _accepting False
        # here and resume in place — the job can never be orphaned
        self._fallback(job, "controller not accepting")

    def abort(self, request_id) -> bool:
        """Client disconnect while the request sat in the migration
        queue (drop the job — pages already released by the export) or
        mid-migration (flag it so the worker drops it before the resume
        submit instead of decoding into a closed sink).

        Mid-migration returns False on purpose: the caller
        (Dispatcher.abort) then also sweeps every runner, covering the
        window where the resume was already submitted to a target; the
        flag covers the window where it was not. Phase-1 stream jobs
        also return False: the sequence is still DECODING on its source
        runner, so the runner sweep must reach it — here they are only
        flipped to cancelled (the source's pump then releases the
        target's reserved pages via cancel_stream)."""
        cleanup = None
        removed = False
        with self._cv:
            for job in self._jobs:
                if job.req.request_id != request_id:
                    continue
                if isinstance(job, _StreamJob):
                    job.status = "cancelled"
                    break
                self._jobs.remove(job)
                if job.stream is not None:
                    # commit job: the target session holds reserved pages
                    job.stream.status = "cancelled"
                    cleanup = job.stream.target
                removed = True
                break
            else:
                if request_id in self._migrating:
                    self._aborted.add(request_id)
        if cleanup is not None:
            cleanup.submit_import_abort(request_id)
        return removed

    def _consume_abort(self, job: _MigrationJob) -> bool:
        with self._cv:
            if job.req.request_id in self._aborted:
                self._aborted.discard(job.req.request_id)
                self._migrating.pop(job.req.request_id, None)
                return True
        return False

    def _consume_abort_flag(self, request_id) -> bool:
        """Pop just the abort flag (the _migrating entry is handled by
        the caller's own finish path)."""
        with self._cv:
            if request_id in self._aborted:
                self._aborted.discard(request_id)
                return True
        return False

    def pending_count(self) -> int:
        with self._cv:
            return len(self._jobs) + len(self._migrating)

    # -- worker ------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._jobs and not self._stop.is_set():
                    self._cv.wait(0.1)
                if self._stop.is_set():
                    return
                job = self._jobs.popleft()
                if isinstance(job, _StreamJob):
                    # phase 1: the request is still LIVE (and decoding)
                    # on the source runner — visible to the drain loop
                    # via its active_count, so no _migrating entry
                    if job.status == "cancelled":
                        continue
                else:
                    self._migrating[job.req.request_id] = job
            if isinstance(job, _StreamJob):
                try:
                    self._open_stream(job)
                except Exception as e:  # noqa: BLE001 — worker survives
                    logger.exception("unexpected stream-open failure")
                    with self._cv:
                        if job.status == "opening":
                            job.error = str(e)
                            job.status = "failed"
                continue
            try:
                if job.stream is not None:
                    self._commit_stream_job(job)
                else:
                    self._migrate(job)
            except Exception as e:  # noqa: BLE001 — worker must survive
                logger.exception("unexpected migration failure")
                self._fallback(job, str(e))

    # -- streamed (two-phase) migration ------------------------------------

    def open_stream(self, request_id, chunks: List[KvChunk],
                    n_prefix_pages: int, wire_quant: str, req,
                    source) -> Optional[_StreamJob]:
        """Queue phase 1 of a streamed migration (called on the source
        runner's thread once the prefix is serialized). Returns None
        when the controller is not accepting — the sequence then simply
        keeps decoding in place."""
        job = _StreamJob(
            request_id=request_id, chunks=chunks,
            n_prefix_pages=n_prefix_pages, wire_quant=wire_quant,
            req=req, source=source,
            deadline=time.monotonic() + self.settings.handoff_timeout_s,
            span=self._start_handoff_span(req, source, streamed=True),
        )
        with self._cv:
            if self._accepting:
                self._note(req, "handoff_export",
                           source=source.engine_id, streamed=True)
                self._jobs.append(job)
                self._cv.notify()
                return job
        self._finish_handoff_span(job, "not_accepting")
        return None

    def _open_stream(self, job: _StreamJob) -> None:
        """Worker half of phase 1: move the prefix chunks through the
        channel, pick a decode target, and open an import session there.
        Failure just flips the job to "failed" — the source
        sequence never stopped decoding, so there is nothing to fall
        back FROM."""
        try:
            # injection points (docs/RESILIENCE.md): disagg.chunk hits
            # once per chunk, so nth=N fails the transfer at its Nth
            # chunk — the channel API is batch-synchronous (the target
            # opens with the COMPLETE prefix or not at all), so this
            # models "the stream died partway" from the fleet's view;
            # target-side partial-import abort is kv.import_chunk's
            # domain. disagg.slow_peer stalls (delay_ms rule).
            faults.fire("disagg.slow_peer")
            for _ in job.chunks:
                faults.fire("disagg.chunk")
            target = self.scheduler.schedule_decode(
                exclude=job.source.engine_id)
            if target is None:
                raise HandoffError("no healthy decode engine")
            t0 = time.monotonic()
            try:
                wired = self.channel.transfer_chunks(
                    job.request_id, job.wire_quant, job.chunks,
                    trace=self._trace_ctx(job.req),
                )
            finally:
                self.channel_s += time.monotonic() - t0
        except Exception as e:  # noqa: BLE001 — channel/sched fault domain
            with self._cv:
                if job.status == "opening":
                    job.error = str(e)
                    job.status = "failed"
            if self.metrics:
                self.metrics.record_handoff("retry")
            return

        def _opened(ok: bool, err: Optional[str],
                    job=job, target=target) -> None:
            # runs on the target runner's thread
            cancelled = False
            with self._cv:
                if job.status == "cancelled":
                    cancelled = True  # raced an abort: undo the open
                elif ok:
                    job.target = target
                    job.status = "ready"
                else:
                    job.error = err or "import open failed"
                    job.status = "failed"
            if cancelled and ok:
                target.submit_import_abort(job.request_id)

        target.submit_import_open(
            job.request_id, job.n_prefix_pages, wired, _opened
        )

    def commit_stream(self, job: _StreamJob, exp: SequenceExport) -> None:
        """Queue phase 2 (called on the source runner's thread right
        after the switchover export): move the tail delta + host state
        to the opened target and resume there. The request has left the
        source runner, so from here the job follows the migration
        bookkeeping (pending_count / fallback semantics)."""
        mjob = _MigrationJob(
            exp=exp, req=job.req, source=job.source, stream=job,
            enqueued_at=job.enqueued_at,
            deadline=time.monotonic() + self.settings.handoff_timeout_s,
        )
        with self._cv:
            if self._accepting:
                self._jobs.append(mjob)
                self._cv.notify()
                return
        # controller shutting down: the state is already lifted off the
        # engine — resume in place on the source, drop the target session
        if job.target is not None:
            job.target.submit_import_abort(job.request_id)
        self._fallback(mjob, "controller not accepting")

    def cancel_stream(self, job: _StreamJob, record: bool = True) -> None:
        """Drop phase 1 (source cancelled: session died, open failed, or
        deadline passed). The sequence keeps decoding in place on the
        source; the target's reserved pages (if the open landed) are
        released. ``record=False`` for cancels that are not fallbacks
        (request finished in place / client abort)."""
        with self._cv:
            try:
                self._jobs.remove(job)
            except ValueError:
                pass
            target = job.target
            job.status = "cancelled"
        self._finish_handoff_span(job,
                                  "fallback" if record else "cancelled")
        if target is not None:
            target.submit_import_abort(job.request_id)
        if record:
            if self.metrics:
                self.metrics.record_handoff("fallback")
            self._note(job.req, "handoff_fallback",
                       reason=job.error or "cancelled")

    def _commit_stream_job(self, mjob: _MigrationJob) -> None:
        """Phase 2 on the worker: tail + host state through the channel,
        commit on the already-opened target. Single attempt — the prefix
        lives in exactly one target session, so retrying elsewhere is
        meaningless; failure falls back to an in-place resume on the
        source (mjob.exp carries the FULL chunk set for that)."""
        job = mjob.stream
        if self._consume_abort(mjob):
            if job.target is not None:
                job.target.submit_import_abort(job.request_id)
            return
        n_prefix = len(job.chunks)
        try:
            tail = (mjob.exp.kv_chunks or [])[n_prefix:]
            # commit dropped on the channel (docs/RESILIENCE.md): the
            # target holds the prefix but the switchover delta never
            # lands — the source must resume in place from the full
            # export it still carries
            faults.fire("disagg.commit")
            for _ in tail:
                faults.fire("disagg.chunk")
            t0 = time.monotonic()
            try:
                wired = self.channel.transfer_commit(mjob.exp, tail)
            finally:
                self.channel_s += time.monotonic() - t0
        except Exception as e:  # noqa: BLE001 — channel fault domain
            if job.target is not None:
                job.target.submit_import_abort(job.request_id)
            self._fallback(mjob, f"channel {self.channel.name}: {e}")
            return

        def _done(ok: bool, err: Optional[str],
                  mjob=mjob, target=job.target) -> None:
            # runs on the target runner's thread
            if ok:
                self._finish_migration(mjob)
                if self._consume_abort_flag(mjob.req.request_id):
                    target.abort(mjob.req.request_id)
                    return
                if err == "aborted":
                    return
                now = time.monotonic()
                stall = (now - mjob.exp.stalled_at
                         if mjob.exp.stalled_at else None)
                self._finish_handoff_span(
                    self._span_holder(mjob), "ok",
                    target=target.engine_id,
                    chunks=len(mjob.exp.kv_chunks or []),
                )
                self._note(mjob.req, "handoff_resume",
                           target=target.engine_id,
                           chunks=len(mjob.exp.kv_chunks or []),
                           **({"stall_s": stall}
                              if stall is not None else {}))
                if self.metrics:
                    self.metrics.record_handoff(
                        "ok",
                        latency_s=now - mjob.enqueued_at,
                        nbytes=mjob.exp.kv_bytes(),
                        stall_s=stall,
                        chunks=len(mjob.exp.kv_chunks or []),
                    )
            else:
                logger.warning(
                    "streamed KV commit rejected by %s (%s); decoding "
                    "in place on %s",
                    target.engine_id, err, mjob.source.engine_id,
                )
                self._fallback(mjob, err or "import commit failed")

        job.target.submit_import_commit(wired, mjob.req, _done)

    def _migrate(self, job: _MigrationJob) -> None:
        """One migration: channel transfer + decode-engine selection,
        retried within the deadline; the import itself resolves
        asynchronously on the target runner's thread and falls back on
        rejection."""
        last_err = "handoff timeout"
        max_attempts = 1 + max(0, self.settings.handoff_retries)
        while job.attempts < max_attempts and time.monotonic() < job.deadline:
            if job.attempts:
                if (self.retry_budget is not None
                        and not self.retry_budget.acquire("handoff_retry")):
                    # the shared retry budget is dry (serving/health.py):
                    # skip the retry and fall back to decoding in place
                    # now — exactly-once either way
                    last_err = "handoff retry budget exhausted"
                    break
                # exponential backoff between attempts, bounded by the
                # deadline: a decode replica mid-restart gets a real
                # chance to come back before the in-place fallback
                # (back-to-back retries would burn the whole budget in
                # microseconds); _stop short-circuits for shutdown
                delay = min(0.1 * (2 ** (job.attempts - 1)),
                            job.deadline - time.monotonic())
                if delay > 0 and self._stop.wait(delay):
                    break
            if self._consume_abort(job):
                return
            job.attempts += 1
            target = self.scheduler.schedule_decode(
                exclude=job.source.engine_id)
            if target is None:
                last_err = "no healthy decode engine"
                if self.metrics:
                    self.metrics.record_handoff("retry")
                continue
            try:
                faults.fire("disagg.slow_peer")
                faults.fire("disagg.transfer")
                for _ in job.exp.kv_chunks or ():
                    faults.fire("disagg.chunk")
                t0 = time.monotonic()
                try:
                    wired = self.channel.transfer(job.exp)
                finally:
                    self.channel_s += time.monotonic() - t0
            except Exception as e:  # noqa: BLE001 — channel fault domain
                last_err = f"channel {self.channel.name}: {e}"
                if self.metrics:
                    self.metrics.record_handoff("retry")
                continue
            if self._consume_abort(job):
                return

            def _done(ok: bool, err: Optional[str],
                      job=job, target=target) -> None:
                # runs on the target runner's thread
                if ok:
                    # the request is (and stays) in the target's
                    # inflight map — safe to leave the migrating set
                    self._finish_migration(job)
                    if self._consume_abort_flag(job.req.request_id):
                        # client disconnected while the resume was in
                        # flight and the dispatcher's runner sweep ran
                        # before the target registered it — apply the
                        # abort now instead of decoding into a dead sink
                        target.abort(job.req.request_id)
                        return
                    if err == "aborted":
                        return  # resolved by an abort, not a transfer
                    now = time.monotonic()
                    # decode pause the migrated sequence actually
                    # observed: switchover (streamed) or export start
                    # (monolithic) until the resume landed
                    stall = (now - job.exp.stalled_at
                             if job.exp.stalled_at else None)
                    self._finish_handoff_span(
                        self._span_holder(job), "ok",
                        target=target.engine_id,
                        chunks=len(job.exp.kv_chunks or []),
                    )
                    self._note(job.req, "handoff_resume",
                               target=target.engine_id,
                               chunks=len(job.exp.kv_chunks or []),
                               **({"stall_s": stall}
                                  if stall is not None else {}))
                    if self.metrics:
                        self.metrics.record_handoff(
                            "ok",
                            latency_s=now - job.enqueued_at,
                            nbytes=job.exp.kv_bytes(),
                            stall_s=stall,
                            chunks=len(job.exp.kv_chunks or []),
                        )
                else:
                    logger.warning(
                        "KV handoff import rejected by %s (%s); decoding "
                        "in place on %s",
                        target.engine_id, err, job.source.engine_id,
                    )
                    self._fallback(job, err or "import failed")

            target.submit_resume(wired, job.req, _done)
            return
        self._fallback(job, last_err)

    def _finish_migration(self, job: _MigrationJob) -> None:
        with self._cv:
            self._migrating.pop(job.req.request_id, None)

    def _fallback(self, job: _MigrationJob, err: str) -> None:
        """Resume the request on its SOURCE engine (in-place decode). If
        even that fails, the request errors out — visibly, never
        silently dropped.

        Drain-coverage invariant: the job leaves the migrating set only
        AFTER submit_resume has registered the request with the source
        runner (registration is synchronous), so at every instant the
        request is visible to the dispatcher's drain loop through either
        ``pending_count()`` or some runner's ``active_count()``."""
        if self._consume_abort(job):
            return
        stall = (time.monotonic() - job.exp.stalled_at
                 if job.exp.stalled_at else None)
        self._finish_handoff_span(self._span_holder(job), "fallback",
                                  reason=err)
        self._note(job.req, "handoff_fallback", reason=err,
                   **({"stall_s": stall} if stall is not None else {}))
        if self.metrics:
            self.metrics.record_handoff("fallback", stall_s=stall)

        def _done(ok: bool, import_err: Optional[str]) -> None:
            if not ok:
                try:
                    job.req.sink.on_error(
                        f"KV handoff failed ({err}) and in-place resume "
                        f"failed ({import_err})",
                        "handoff_failed",
                    )
                except Exception as sink_exc:  # noqa: BLE001 — sink isolation
                    logger.debug("fallback sink.on_error for %s raised: %s",
                                 job.req.request_id, sink_exc)
                    if self.metrics:
                        self.metrics.record_error("disagg.sink_error")

        # the original (pre-channel) export resumes in place: the source
        # engine's own dtype/topology always matches itself
        job.source.submit_resume(job.exp, job.req, _done)
        self._finish_migration(job)

    # -- introspection -----------------------------------------------------

    def has_decode_targets(self) -> bool:
        """True while at least one decode-role replica is REGISTERED
        (health is deliberately ignored: a transiently unhealthy decode
        engine is worth the retry/fallback path, a topology with no
        decode replicas at all is not — prefill runners then admit
        unified and skip the per-request serialize/fallback churn). A
        fleet member's decode replica counts only when it can import KV
        (``supports_kv_import``)."""
        return any(getattr(r, "role", "unified") == "decode"
                   and (not getattr(r, "is_remote", False)
                        or getattr(r, "supports_kv_import", False))
                   for r in self.scheduler.engines())

    @staticmethod
    def role_counts(roles: Sequence[str]) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in roles:
            out[r] = out.get(r, 0) + 1
        return out


# ---------------------------------------------------------------------------
# Fleet-wide prefix sharing: the fetch_prefix RPC driver
# ---------------------------------------------------------------------------


class PrefixFetcher:
    """Drives one peer-to-peer prefix fetch per routed-``fetch`` request
    (docs/CACHING.md "Fleet-wide prefix sharing"): the scheduler's cost
    model (scheduler.plan_route) picked a cold replica and a warm peer;
    this moves the matched KV pages before the request is submitted —

    1. the request half crosses the channel (``KvPrefixFetch`` framing,
       differentially wire-tested per fetch under protowire);
    2. the peer's engine thread serializes the chain — HBM and host
       tier, consecutive from the head — as crc-guarded KvChunks
       (``EngineRunner.submit_prefix_export``);
    3. the chunks cross the channel (``KvHandoffHeader``/``KvChunk``
       framing; ``kv.peer_fetch`` fires per chunk);
    4. the target's engine thread validate-and-scatters them into its
       prefix cache (``submit_prefix_import`` → engine.import_prefix);
    5. the request is submitted to the target — ALWAYS, on every
       outcome. The fetch is an accelerator, never a gate: a dead peer,
       a stale digest (chain evicted between score and fetch), a torn
       stream, or an import rejection all degrade the request to plain
       recompute on its chosen replica, exactly once.

    Thread-safe: fetches start on the dispatcher thread and settle on
    runner threads; the in-flight map is the drain/abort surface
    (``pending_count`` counts toward dispatcher shutdown, ``abort``
    drops a disconnected client's request instead of submitting it into
    a closed sink)."""

    def __init__(self, channel: Optional[KVTransferChannel] = None,
                 settings: Optional[DisaggSettings] = None,
                 metrics: Optional[MetricsCollector] = None,
                 tracer=None, recorder=None):
        """``tracer``/``recorder``: a ``kv.prefix_fetch`` span parented on
        the trace context that round-tripped the KvPrefixFetch wire
        fields, and a ``prefix_fetch`` timeline event (None: neither)."""
        self.channel = channel or InProcessChannel()
        self.settings = settings or DisaggSettings()
        self.metrics = metrics
        self.tracer = tracer
        self.recorder = recorder
        self._lock = threading.Lock()
        # request_id -> aborted? for fetches in flight (score→submit)
        self._fetching: Dict[Any, bool] = {}
        # ONE wire worker (started lazily): the protowire round trip per
        # fetch is GIL-bound byte work, and a thread per fetch would turn
        # a burst of fetch decisions into a burst of OS threads
        self._wire_q: "queue.Queue" = queue.Queue()
        self._wire_thread: Optional[threading.Thread] = None

    def pending_count(self) -> int:
        with self._lock:
            return len(self._fetching)

    def abort(self, request_id) -> bool:
        """Client disconnect while the prefix fetch is in flight: flag
        it — the settle path then drops the request instead of
        submitting it into a closed sink. Returns True when the flag
        landed on an in-flight fetch."""
        with self._lock:
            if request_id in self._fetching:
                self._fetching[request_id] = True
                return True
        return False

    def fetch_then_submit(self, target, peer, req, plan) -> None:
        """Run the fetch for ``req`` per ``plan`` (a PrefixRoutePlan
        with decision "fetch"), then submit the request to ``target``.
        Called on the dispatcher thread; returns immediately — the
        pipeline advances on the peer's and target's runner threads."""
        rid = req.request_id
        ps = max(1, plan.page_size)
        t0 = time.monotonic()
        fetch_span = [None]  # set after the request half round-trips
        with self._lock:
            self._fetching[rid] = False

        def _settle(outcome: str, nbytes: int = 0) -> None:
            # exactly once by construction (each stage's callback fires
            # once and every failure arm returns after calling _settle).
            # The in-flight entry is popped only AFTER the submit: pop-
            # first would open a window where pending_count() reads 0
            # while the request is registered nowhere yet
            with self._lock:
                aborted = self._fetching.get(rid, False)
            seconds = time.monotonic() - t0
            span, fetch_span[0] = fetch_span[0], None
            if span is not None and self.tracer is not None:
                span.set(outcome=outcome, bytes=nbytes)
                self.tracer.finish(span)
            if self.recorder is not None:
                self.recorder.note(rid, "prefix_fetch", outcome=outcome,
                                   seconds=seconds, bytes=nbytes,
                                   peer=peer.engine_id,
                                   target=target.engine_id)
            if self.metrics:
                self.metrics.record_prefix_fetch(
                    outcome, seconds=seconds, nbytes=nbytes)
            try:
                if not aborted:
                    target.submit([req])
            finally:
                with self._lock:
                    late_abort = self._fetching.pop(rid, False)
                if late_abort and not aborted:
                    # disconnected between the flag read and the submit:
                    # the dispatcher skipped its runner sweep
                    target.abort(rid)

        def _on_import(ok: bool, err: Optional[str],
                       nbytes: int = 0) -> None:
            if not ok:
                logger.debug("prefix fetch for %s: import rejected by "
                             "%s (%s); recomputing", rid,
                             target.engine_id, err)
            _settle("ok" if ok else "fallback", nbytes)

        def _wire(depth: int, chunks) -> None:
            # on the wire worker: the protowire round trip (encode,
            # decode, crc over the chain) stalls neither engine thread —
            # least of all the warm peer's, picked for being busy
            try:
                # peer death mid-fetch: one hit per chunk, so nth=N drops
                # the Nth chunk
                for _ in chunks:
                    faults.fire("kv.peer_fetch")
                wired = self.channel.transfer_chunks(
                    rid, self.settings.wire_quant, chunks,
                    trace=self._trace(req))
            except Exception as e:  # noqa: BLE001 — channel fault domain
                logger.debug("prefix fetch for %s: channel %s failed "
                             "(%s); recomputing", rid, self.channel.name, e)
                _settle("fallback")
                return
            nbytes = sum(len(c.payload) for c in wired)
            tokens = list(req.prompt_ids[: depth * ps])
            target.submit_prefix_import(
                rid, tokens, wired,
                lambda ok, ierr: _on_import(ok, ierr, nbytes))

        def _on_export(result, err: Optional[str]) -> None:
            # the peer runner's thread (or the caller's, peer already
            # down): only hand the chunks off, no wire work here
            if result is None:
                logger.debug("prefix fetch for %s: peer %s export failed "
                             "(%s); recomputing", rid, peer.engine_id, err)
                _settle("fallback")
                return
            depth, chunks = result
            if depth <= plan.depth or not chunks:
                # stale digest: the peer evicted the chain (or holds no
                # more of it than the target) since the routing score
                _settle("fallback")
                return
            self._submit_wire(lambda: _wire(depth, chunks))

        try:
            # the request half crosses the channel too, so the
            # KvPrefixFetch wire format is exercised on every fetch
            rid_w, hashes_w, chunk_pages, wire_quant, trace_w = (
                self.channel.transfer_fetch_request(
                    rid, plan.prefix_hashes or (),
                    self.settings.chunk_pages, self.settings.wire_quant,
                    trace=self._trace(req)))
        except Exception as e:  # noqa: BLE001 — channel fault domain
            logger.debug("prefix fetch for %s: request framing failed "
                         "(%s); recomputing", rid, e)
            _settle("fallback")
            return
        if self.tracer is not None and trace_w:
            fetch_span[0] = self.tracer.start(
                "kv.prefix_fetch", parent=tuple(trace_w),
                request_id=str(rid), peer=peer.engine_id,
                target=target.engine_id)
        peer.submit_prefix_export(rid_w, hashes_w, chunk_pages, wire_quant,
                                  _on_export)

    @staticmethod
    def _trace(req) -> Optional[tuple]:
        span = getattr(req, "span", None)
        return span.context() if span is not None else None

    def _submit_wire(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if self._wire_thread is None:
                self._wire_thread = threading.Thread(
                    target=self._wire_worker, name="peerfetch-wire",
                    daemon=True)
                self._wire_thread.start()
        self._wire_q.put(fn)

    def _wire_worker(self) -> None:
        while True:
            fn = self._wire_q.get()
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — job isolation (the
                # job's own failure arms settle the request; this only
                # keeps the worker alive)
                logger.exception("peer-fetch wire job failed: %s", e)
                if self.metrics:
                    self.metrics.record_error("disagg.peer_fetch_wire")
