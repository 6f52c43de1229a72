"""Continuous-batching inference engine over the paged KV cache (port of
``distributed_inference_server_tpu/engine/engine.py``: the quantum path
with every ``EngineConfig`` default, and the ragged mixed step).

- **Continuous batching** over a fixed pool of ``max_batch`` decode slots;
  requests join and leave between steps. Inactive slots run masked: their
  pool writes land in the drop slot and their attention sees nothing.
- **Bucketed, batched, budgeted prefill**: up to ``prefill_batch`` seated
  prompts share one chunk forward per length bucket; at most
  ``prefill_token_budget`` padded tokens run per engine step, so a long
  prompt loads in quanta between decode blocks.
- **K-step decode blocks with on-device sampling**: a block is a loop of
  ``decode_block_size`` model steps issued back to back on the device,
  with sampling, EOS masking and per-row budgets on the device too; the
  host reads the block's tokens (and their log-probabilities) once per
  block, not once per token.
- **Prefix reuse + LRU** through the ``PageAllocator``, on-demand page
  allocation before each block, and preemption (the youngest sequence
  goes back to the queue, its pages released) when the pool runs dry.
- **Per-request failure isolation**: host-side processing of each request
  is fenced; a failing request errors out alone.
- **Ragged mixed step** (``mixed_step_tokens > 0``): while a seated
  prompt is loading, one packed dispatch replaces the prefill quantum and
  the decode block: every seated decode row advances one token (K tokens
  under ``loop_to_completion``: the K-block form, whose K - 1 extra steps
  are the decode block's step math) and prompt chunks fill the rest of the
  token budget, attended by the ragged paged kernel (over int8 pools: the
  rows' windows gathered and dequantized, then ``ragged_gqa_attention``,
  the reference's own path). Its decode ids, their log-probabilities and
  the first-token candidates come back in one host read.
- **Looped blocks** (``loop_to_completion``): a pure-decode iteration runs
  one run-to-completion block instead of a K-step block: the device steps
  every row until EOS, its budget, an empty device page free-list or the
  iteration cap (``loop_max_steps``), growing the rows' block tables from
  pages the allocator drew onto that free-list (``draw_device``); the host
  reconciles the draw (``reconcile_device``) and walks the tokens right
  after the block. Greedy tokens equal the fixed path's: each iteration is
  the decode block's step math. On ``cuda`` a block is ONE graph launch: a
  conditional WHILE node around a captured iteration (``graph_loop.py``).

- **Quantized serving**: the params may carry ``Q8Tensor`` /
  ``Q4Tensor`` weights (``ops/quant.py quantize_params``), which the
  engine passes through to the model as they are; ``kv_quant="int8"``
  keeps the pools as int8 ``QuantPool`` pairs (half the KV bytes per
  decode step).
- **Pipelined blocks** (``pipeline_depth``, default 1): launched blocks
  wait in ``_pending`` and the oldest is read once more than
  ``pipeline_depth`` are in flight (or nothing new was launched), so the
  host walks block N-1's tokens while the device runs block N. Each
  block's result is copied into pinned host memory behind an event right
  after its launch, and every host input reaches the device through a
  pinned, non-blocking copy: nothing but that event waits on the device.
- **CUDA graphs** (on ``cuda``): each K-step decode block is captured once
  per sampling mode (greedy, temperature, top-p) and each prefill chunk
  once per (bucket, sampling mode), on the engine's own stream, and
  replayed; their inputs are static device buffers filled by one copy per
  launch. The GPU counterpart of the reference's fixed-shape programs: a
  replay costs one launch from Python instead of hundreds. The mixed step
  is captured per sampling mode (its packed width and row count are
  fixed), and a looped block per sampling mode as a prologue and one
  iteration inside a WHILE node. ``warmup`` captures every graph before
  traffic arrives. A failed capture, instantiate or launch raises. On the
  CPU everything runs eagerly.
- **Step clock** (``step_clock_stats``): host wall time, dispatches,
  tokens and rows per dispatch kind, and the pressure events, under the
  JAX engine's kinds and names.

- **Sliding-window page reclaim** (``_reclaim_window_pages``): for a model
  whose every layer slides (Mistral), pages wholly behind every future
  query's window go back to the allocator before each dispatch and their
  table entries become the sentinel ``num_pages``; per-sequence KV is
  O(window), not O(length). The kernels walk each row from its window's
  lower edge and never read them; the plain path clamps and masks them.

- **Embeddings** (``embed_start`` / ``embed_step`` / ``embed_finish``):
  mean-pooled, L2-normalised final hidden states, one batch of at most
  ``max_batch`` bucket-sized chunks per step, so the serving runner can
  interleave an embeddings job with decode.

- **Speculative decoding** (``draft_params`` / ``draft_cfg`` / ``spec``):
  the draft model gets its own page pool (the target's page geometry and
  ``kv_quant``, the target's block tables and write slots) and prefills
  beside the target in every prefill chunk (its logits unembedded at
  ``last_idx`` only, never read). A decode block becomes R =
  ``decode_block_size`` speculative rounds: gamma draft decodes over the
  draft pool, then ONE target verify forward over [last, d_1..d_gamma]
  (T = gamma + 1: the chunked-prefill kernel), then acceptance and
  resampling on the device (``speculative.accept_and_resample``); a row
  emits 1..gamma + 1 tokens a round, EOS freezes it, writes past capacity
  drop. On ``cuda`` the block is a CUDA graph per sampling mode. Rows on
  request patterns whose tracker is disabled ride along with ``spec_ok``
  False (one target token a round); a launch where every row is disabled
  takes the plain decode block. Under ``loop_to_completion`` the rounds
  run inside the looped block's WHILE graph with its device page
  free-list, and the mixed step (plain decode rows, as in the reference:
  it writes no draft KV) composes with them. Greedy tokens equal plain
  decoding's, whatever the draft.

- **KV handoff** (the JAX package's disaggregated prefill/decode byte
  paths): ``add_request(..., prefill_only=True)`` parks a sequence after
  its first token (``handoff_ready_ids``); ``export_handoff`` lifts it
  off as a ``SequenceExport`` (a KVP1 payload, raw, ``int8`` or latent on
  the wire), ``export_handoff_begin`` / ``_pump`` / ``_finish`` stream its
  immutable full-page prefix in chunks while it keeps decoding here, and
  ``import_sequence`` / ``import_stream_*`` seat an export into a decode
  slot straight away (no prefill). ``export_prefix_chunks`` /
  ``import_prefix`` move a cached prefix between engines (a peer fetch).
  Payloads are the JAX package's bytes, so either package imports the
  other's.
- **Host tier** (``host_tier_bytes > 0``): LRU-evicted prefix pages are
  demoted to host RAM (``HostTier``; raw, int8 or latent) by the
  allocator's offload hook, gathered on the engine stream before their
  ids are recycled and copied into pinned memory behind an event; a
  prompt's prefix match falls through HBM into the tier and reloads its
  pages with one in-place scatter.
- **Latent codec** (``latent_rank > 0``): per-(layer, KV head)
  projections calibrated at construction from two seeded prompts run
  through the engine (which is then reset in place), used by the latent
  wire and host-tier encodings.
- **Allocator tier**: the port's native C++ allocator
  (``native/allocator.cpp``) when it builds, as the JAX engine chooses;
  the Python one when the host tier needs the offload hook or the
  library is missing (``native_allocator`` forces either). The choice is
  logged.

- **Device meshes** (``mesh=``, ``parallel/mesh.py``): one engine over a
  mesh with ``tensor``, ``stage``, ``seq``, ``expert`` and ``data`` axes,
  as the JAX engine over a ``jax.sharding.Mesh``. The params are cut per
  shard (``parallel/tp.py shard_params``) and every (stage, tensor) shard
  keeps its own ``[L/S, slots + 1, KV/tp, D]`` pool on its slot's device
  (``ShardedPool``, for the draft too); each shard launches its own
  kernels at its own head counts, and the row-parallel partials meet in
  ``parallel/comm.py``'s collectives. A ``stage`` axis runs GPipe
  microbatches (``pp_microbatches``); an ``expert`` axis the
  capacity-based MoE dispatch (``ops/moe.py``) at a dropless capacity
  factor; a ``seq`` axis the long-prompt path: prompts of at least
  ``cp_min_tokens`` prefill in one sequence-parallel pass (``sp_impl``
  ring or Ulysses, ``parallel/cp.py``) straight into their pages, then
  decode from them. The host logic (allocator, scheduler, sampling,
  graphs) stays one copy. On ``cuda`` every shard's launches are captured
  in the engine's graphs when all slots name one card; over distinct
  cards the engine runs eagerly. The byte paths, the host tier and the
  embeddings see the global pool (heads in shard order) and give the
  unsharded engine's bytes and vectors.

Threading: the engine is synchronous and single-owner (one ``step()``
caller); the serving layer runs it on a dedicated thread.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from dataclasses import replace as dc_replace
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_inference_server_tpu_torch.core.errors import (
    CacheDeserializationError,
    CacheFull,
)
from distributed_inference_server_tpu_torch.core.models import (
    FinishReason,
    Usage,
)
from distributed_inference_server_tpu_torch.core.types import RequestId
from distributed_inference_server_tpu_torch.engine.graph_loop import LoopGraph
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    _KIND_LATENT,
    _KIND_QPOOL,
    _KIND_WIRE8,
    DIGEST_DEPTH,
    LATENT_QUANTS,
    WIRE_QUANTS,
    HostTier,
    KvChunk,
    KvImportSession,
    LatentCodec,
    PageAllocator,
    PagedCacheConfig,
    PagedKVState,
    _encode_group,
    _page_slots,
    _pull_group,
    _scatter_payload,
    _to_device as _host_to_device,
    chunk_crc,
    deserialize_into_allocator,
    deserialize_kv,
    encoded_page_fraction,
    iter_chain_hashes,
    payload_kind,
    serialize_kv,
    serialize_kv_chunks,
)
from distributed_inference_server_tpu_torch.engine.speculative import (
    PatternTrackers,
    SpecConfig,
    accept_and_resample,
    categorical,
    spec_signature,
)
from distributed_inference_server_tpu_torch.engine.speculative import (
    _probs as spec_probs,
)
from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.configs import ModelConfig
from distributed_inference_server_tpu_torch.models.tokenizer import Tokenizer
from distributed_inference_server_tpu_torch.ops import kernels
from distributed_inference_server_tpu_torch.ops.quant import (
    QuantPool,
    is_quantized,
)
from distributed_inference_server_tpu_torch.ops.sampling import (
    counter_uniform,
    nucleus_probs,
    sample_tokens,
)
from distributed_inference_server_tpu_torch.parallel import tp as tp_rules
from distributed_inference_server_tpu_torch.parallel.mesh import Mesh
from distributed_inference_server_tpu_torch.parallel.pp import validate_pp
from distributed_inference_server_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)
from distributed_inference_server_tpu_torch.utils.profiler import DeviceTrace

logger = logging.getLogger(__name__)


def _chosen_logprob(logits: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """log softmax(logits)[token] per row, as logits[token] -
    logsumexp(logits): [B, V] x [B] -> [B] f32."""
    x = logits.float()
    chosen = x.gather(1, tokens.long().clamp(min=0)[:, None])[:, 0]
    return chosen - torch.logsumexp(x, dim=-1)


def _mid_prefill(s: "_Seq") -> bool:
    """Seated and still loading its prompt (no first token sampled yet)."""
    return s.next_token is None and s.seq_len < len(s.token_ids)


def _sample_mode(rows: Sequence["_Seq"]) -> int:
    """Cheapest sampler the rows need: 0 all greedy (argmax only), 1
    sampled without a nucleus, 2 nucleus rows present."""
    if any(s.params.top_p < 1.0 and s.params.temperature > 0.0 for s in rows):
        return 2
    return 1 if any(s.params.temperature > 0.0 for s in rows) else 0


SAMPLE_MODES = (0, 1, 2)


def _sample(logits, temp, top_p, generator, mode: int,
            key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next tokens for the sampling ``mode``; sampled modes draw from
    ``generator``, or from ``counter_uniform`` under ``key`` when given."""
    if mode == 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    uniform = None if key is None else counter_uniform(logits.shape, key)
    return sample_tokens(logits, temp, top_p, generator, use_topp=mode == 2,
                         uniform=uniform)


# looped-block exit reasons by code (0 = still running)
LOOP_EXITS = ("", "eos", "budget", "pages", "cap")


def _device_append_pages(block_tables: torch.Tensor, bt_counts: torch.Tensor,
                         free_pages: torch.Tensor, n_free: torch.Tensor,
                         free_used: torch.Tensor, needed: torch.Tensor,
                         rows: torch.Tensor) -> torch.Tensor:
    """Grow row block tables from the device-held page free-list inside a
    looped block (port of the JAX engine's ``_device_append_pages``, one
    round): each row whose page count is short of ``needed`` (0 for rows
    that must not grow) takes the next free-list page, in row order, by a
    cumsum rank over the short rows. ``free_used`` indexes into
    ``free_pages`` (padded past ``n_free``). Updates ``block_tables``
    [B, P], ``bt_counts`` [B] and ``free_used`` [1] IN PLACE, with no host
    read; the order is deterministic, so the host replays it from the
    returned tables. Returns the rows the list could not cover
    (``starved``)."""
    P = block_tables.shape[1]
    need = (bt_counts < needed) & (bt_counts < P)
    rank = torch.cumsum(need.to(torch.int32), 0, dtype=torch.int32) - 1
    draw_idx = free_used + rank
    got = need & (draw_idx < n_free)
    new_page = free_pages[draw_idx.clamp(0, free_pages.shape[0] - 1).long()]
    col = bt_counts.clamp(max=P - 1).long()
    cur = block_tables[rows, col]
    block_tables.index_put_((rows, col), torch.where(got, new_page, cur))
    bt_counts.add_(got.to(torch.int32))
    free_used.add_(got.sum(dtype=torch.int32))
    return bt_counts < needed


def _make_allocator(pcfg: PagedCacheConfig, force: Optional[bool],
                    need_offload_hook: bool = False):
    """The page-allocator tier, chosen as the JAX engine chooses: the
    native C++ allocator (``native/allocator.cpp``) when its library is
    available, the Python one otherwise; the host tier's offload hook
    needs the Python one (the native allocator has no eviction
    callback). ``force`` True / False demands the native / Python tier."""
    if need_offload_hook:
        if force is True:
            raise RuntimeError(
                "native_allocator=True is incompatible with the host-tier "
                "prefix cache (host_tier_bytes > 0): the native allocator "
                "has no offload hook")
        logger.info("page allocator tier: python (the host tier needs the "
                    "offload hook)")
        return PageAllocator(pcfg)
    if force is not False:
        from distributed_inference_server_tpu_torch import native

        if native.available():
            logger.info("page allocator tier: native")
            return native.NativePageAllocator(pcfg)
        if force is True:
            raise RuntimeError(
                "native_allocator=True but the native library is unavailable")
        logger.info("native allocator unavailable; page allocator tier: "
                    "python")
    return PageAllocator(pcfg)


@dataclass(frozen=True)
class SamplingParams:
    max_tokens: int = 256
    temperature: float = 1.0
    top_p: float = 1.0
    stop_sequences: Tuple[str, ...] = ()


@dataclass(frozen=True)
class EngineConfig:
    """The slice's subset of the JAX ``EngineConfig``, same defaults."""

    max_batch: int = 8
    prefill_buckets: Tuple[int, ...] = (32, 128, 512)
    paged: PagedCacheConfig = field(default_factory=PagedCacheConfig)
    seed: int = 0
    # "kernel": RMSNorm, RoPE and paged attention through the hand-written
    # kernels (their plain versions for CPU tensors); "plain": the
    # reference path on any device (gathered window + dense attention)
    attention_impl: str = "kernel"
    # decode steps per block: one host read per block, not per token
    decode_block_size: int = 8
    # blocks kept in flight beyond the one being processed: with depth 1
    # the host walks block N-1's tokens while the device runs block N;
    # 0 = read each block right after its launch
    pipeline_depth: int = 1
    # up to this many waiting prompts share one batched prefill chunk
    prefill_batch: int = 4
    # padded prefill tokens (rows x bucket) per engine step; at least one
    # chunk always runs
    prefill_token_budget: int = 2048
    # > 0 enables the ragged mixed step: the TOTAL packed width of one
    # mixed dispatch (every decode slot plus the prefill budget), so it
    # must exceed max_batch; 0 = the quantum path only
    mixed_step_tokens: int = 0
    # KV pool quantization: "none" (pools in the engine's dtype) or
    # "int8" (QuantPool: int8 codes + one f32 scale per slot and KV head)
    kv_quant: str = "none"
    # run-to-completion looped decode blocks: pure-decode iterations step
    # on the device until every row stops (EOS, budget, device free-list
    # exhaustion, loop_max_steps), one dispatch per block; the mixed step
    # then advances decode_block_size decode tokens per dispatch
    loop_to_completion: bool = False
    # per-launch iteration cap of a looped block (scaled down by
    # set_loop_cap_frac); a block that hits it resumes at the next step
    loop_max_steps: int = 256
    # run warmup() before serving (the runner does, when set): every
    # prefill bucket and the decode block run once, and on cuda every
    # CUDA graph is captured. Off by default, as in the reference: tests
    # build many engines; the server turns it on
    warmup_compile: bool = False
    # page allocator tier: None = the native C++ allocator when its library
    # builds, else the Python one; True / False force native / Python
    native_allocator: Optional[bool] = None
    # host-RAM second tier of the prefix cache, in bytes (0 = off): evicted
    # prefix pages demote there and prefix matching falls through into it.
    # Takes the Python allocator tier (the offload hook)
    host_tier_bytes: int = 0
    # host-tier encoding of float pools: "none", "int8" (per-vector codes +
    # scales), "latent" / "latent_int8" (rank-r codes; needs latent_rank);
    # quantized pools always keep their native codes
    host_tier_quant: str = "none"
    # rank of the latent page codec calibrated at construction (0 = no
    # codec; latent wire and tier settings then degrade to "none"). Float
    # pools without a draft model only
    latent_rank: int = 0
    # chain depth of the published routing digest: the first K page
    # hashes of each cached chain, all the cache-aware router can score
    # and peer-fetch (serving/scheduler.py plan_route)
    digest_depth: int = DIGEST_DEPTH
    # GPipe microbatches per forward when the mesh has a stage axis; must
    # divide max_batch and prefill_batch
    pp_microbatches: int = 1
    # with a seq mesh axis: prompts at least this long prefill in one
    # sequence-parallel pass over it, straight into their pages. None =
    # one past the largest prefill bucket
    cp_min_tokens: Optional[int] = None
    # that pass's attention: "ring" (K/V chunks rotate, any axis size) or
    # "ulysses" (all-to-all head scatter; the axis must divide the
    # per-tensor-shard query and KV head counts)
    sp_impl: str = "ring"


@dataclass
class SequenceExport:
    """A live sequence lifted off its engine for KV handoff: everything a
    receiving engine needs to resume decoding where the source stopped
    (the K/V payload, the host text and emission state, the sampling
    params). ``kv_chunks`` replaces ``kv`` for a streamed export;
    ``stalled_at`` is the host-local instant the sequence stopped decoding
    on the source (never on the wire)."""

    request_id: RequestId
    token_ids: List[int]  # tokens whose K/V is resident
    prompt_len: int
    seq_len: int  # == len(token_ids) at a decode boundary
    next_token: int  # sampled, not yet decoded (the migration point)
    params: "SamplingParams"
    output_text: str
    emitted_upto: int
    emitted_tokens: int
    pending_ids: List[int]
    kv: bytes
    draft_kv: Optional[bytes] = None
    source_engine: str = ""
    kv_chunks: Optional[List[KvChunk]] = None
    wire_quant: str = "none"
    stalled_at: float = 0.0

    def kv_bytes(self) -> int:
        n = len(self.kv) + len(self.draft_kv or b"")
        if self.kv_chunks is not None:
            n += sum(len(c.payload) for c in self.kv_chunks)
        return n


@dataclass
class HandoffExportSession:
    """One streamed (decode-overlapped) export, owned by the engine
    thread: the immutable full-page prefix taken at
    ``export_handoff_begin``, the chunks serialized so far, and liveness
    (``dead``: the migration is off; the request itself is unaffected)."""

    seq: "_Seq"
    prefix_pages: List[int]
    chunk_pages: int
    wire_quant: str
    chunks: List[KvChunk] = field(default_factory=list)
    prefix_done: bool = False
    dead: bool = False

    @property
    def request_id(self) -> RequestId:
        return self.seq.request_id


@dataclass
class StepOutput:
    """One event emitted by step(): a token delta and/or completion."""

    request_id: RequestId
    token_id: Optional[int] = None
    text: str = ""
    token_index: int = 0
    logprob: Optional[float] = None
    finished: bool = False
    finish_reason: Optional[FinishReason] = None
    usage: Optional[Usage] = None
    error: Optional[str] = None


class _Seq:
    """Host-side state of one in-flight request."""

    __slots__ = (
        "request_id", "token_ids", "prompt_len", "block_table", "seq_len",
        "next_token", "params", "output_text", "emitted_upto",
        "emitted_tokens", "dev_pos", "dev_steps_left", "pending_ids",
        "freed_upto", "prefill_only", "exporting",
    )

    def __init__(self, request_id: RequestId, prompt_ids: List[int],
                 params: SamplingParams):
        self.request_id = request_id
        self.token_ids: List[int] = list(prompt_ids)
        self.prompt_len = len(prompt_ids)
        self.block_table: List[int] = []
        # table entries below this index were reclaimed behind the sliding
        # window (sentinel num_pages)
        self.freed_upto = 0
        self.seq_len = 0  # tokens with K/V resident in pages
        self.next_token: Optional[int] = None  # sampled, not yet decoded
        self.params = params
        self.output_text = ""
        self.emitted_upto = 0
        self.emitted_tokens = 0
        # device-side projection: position and step budget after the
        # blocks issued so far (exact again once a block is processed)
        self.dev_pos = 0
        self.dev_steps_left = 0
        # incremental detokenization: ids whose text is an incomplete
        # UTF-8 sequence
        self.pending_ids: List[int] = []
        # KV handoff: park after the first token instead of decoding here
        self.prefill_only = False
        # a streamed export is in flight: the sequence decodes here while
        # its prefix pages serialize (window reclaim must not free them)
        self.exporting = False

    def num_output_tokens(self) -> int:
        return len(self.token_ids) - self.prompt_len


@dataclass
class _EmbedState:
    """An embeddings job: the (input index, chunk ids) work list, the
    next chunk to run, the per-input pooled sums (on the engine device)
    and valid-token counts."""

    work: List[Tuple[int, List[int]]]
    sums: torch.Tensor
    counts: np.ndarray
    idx: int = 0


class _Graph:
    """One captured CUDA graph and the kernel launches its capture
    recorded (added to the counts on every replay). For a looped block
    ``graph`` is the ``LoopGraph``, ``counts`` its prologue's launches
    (once per launch) and ``step_counts`` one iteration's (added times the
    iterations the block ran)."""

    __slots__ = ("graph", "counts", "step_counts")

    def __init__(self, graph, counts: Dict[str, int],
                 step_counts: Optional[Dict[str, int]] = None):
        self.graph = graph
        self.counts = counts
        self.step_counts = step_counts or {}


class LLMEngine:
    """Single-model continuous-batching engine on one device or one device
    mesh."""

    def __init__(
        self,
        params: llama.Params,
        cfg: ModelConfig,
        tokenizer: Tokenizer,
        engine_cfg: Optional[EngineConfig] = None,
        dtype: torch.dtype = torch.bfloat16,
        device: DeviceLike = None,
        _graphs: bool = True,
        draft_params: Optional[llama.Params] = None,
        draft_cfg: Optional[ModelConfig] = None,
        spec: Optional[SpecConfig] = None,
        mesh: Optional[Mesh] = None,
    ):
        """``params``: the ``models/llama.py`` tree (moved to ``device`` if
        it lives elsewhere); ``dtype``: the KV pools' dtype; ``device``:
        ``cuda`` unless the caller asks for ``cpu``. ``mesh``: a device
        mesh (``parallel/mesh.py``) to shard the model over; the engine's
        device is then the mesh's first slot's. Quantized weights
        (``Q8Tensor`` / ``Q4Tensor`` leaves) pass through as they are.
        ``_graphs=False`` runs the quantum path eagerly on ``cuda`` too
        (for comparing the graph path with the eager one).
        ``draft_params`` / ``draft_cfg``: a draft model (the target's
        vocabulary) enabling speculative decoding with ``spec`` (default
        ``SpecConfig()``)."""
        self.mesh = mesh
        if mesh is not None:
            if device is not None and resolve_device(device).type != \
                    mesh.primary.type:
                raise ValueError(f"device {device} differs from the mesh's "
                                 f"{mesh.primary}")
            device = mesh.primary
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tok = tokenizer
        self.ecfg = engine_cfg or EngineConfig()
        self.pcfg = self.ecfg.paged
        self.dtype = dtype
        if self.ecfg.attention_impl not in llama.IMPLS:
            raise ValueError(
                f"attention_impl must be one of {llama.IMPLS}, got "
                f"{self.ecfg.attention_impl!r}")
        if self.ecfg.decode_block_size < 1:
            raise ValueError(
                f"decode_block_size must be >= 1, got "
                f"{self.ecfg.decode_block_size}")
        if self.ecfg.pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got "
                f"{self.ecfg.pipeline_depth}")
        if self.ecfg.mixed_step_tokens and (
                self.ecfg.mixed_step_tokens <= self.ecfg.max_batch):
            raise ValueError(
                f"mixed_step_tokens ({self.ecfg.mixed_step_tokens}) must "
                f"exceed max_batch ({self.ecfg.max_batch}): the packed width "
                "holds every decode slot plus at least one prefill token")
        if self.ecfg.loop_to_completion and self.ecfg.loop_max_steps < 1:
            raise ValueError(
                f"loop_max_steps must be >= 1, got "
                f"{self.ecfg.loop_max_steps}")
        if draft_params is not None:
            if draft_cfg is None:
                raise ValueError("draft_params needs its draft_cfg")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"the draft model's vocabulary ({draft_cfg.vocab_size}) "
                    f"differs from the target's ({cfg.vocab_size})")
            if (self.ecfg.mixed_step_tokens
                    and not self.ecfg.loop_to_completion):
                raise ValueError(
                    "mixed_step_tokens does not compose with speculative "
                    "decoding: the mixed step owns the decode carry one "
                    "token at a time, the spec block gamma+1 at a time "
                    "(set engine.loop_to_completion to compose them)")
        self.spec = spec or SpecConfig()
        if self.spec.num_draft_tokens < 1:
            raise ValueError(f"num_draft_tokens must be >= 1, got "
                             f"{self.spec.num_draft_tokens}")
        if mesh is not None:
            self._validate_mesh(mesh, cfg, draft_params, draft_cfg)
        self.draft_cfg = draft_cfg if draft_params is not None else None
        self.spec_trackers = (PatternTrackers(self.spec)
                              if draft_params is not None else None)
        # cumulative speculation traffic (spec_stats "totals"): spec
        # launches, and over the rows that speculated, their rounds, the
        # draft tokens proposed and accepted
        self._spec_totals = {"blocks": 0, "row_rounds": 0, "proposed": 0,
                             "accepted": 0}
        if self._moe_impl() == "ep":
            # serving is dropless: no expert takes more than N tokens (the
            # top k are distinct per token), so a capacity factor of E/k
            # keeps every assignment
            dropless = cfg.num_experts / cfg.num_experts_per_tok
            if cfg.moe_capacity_factor < dropless:
                self.cfg = cfg = cfg.with_overrides(
                    moe_capacity_factor=dropless)
        self.params = self._place_model(params, cfg)
        self.state = self._make_state(cfg)
        # the draft's pool: the target's page geometry and kv_quant, the
        # target's block tables and write slots
        self.draft_params = self.draft_state = None
        if draft_params is not None:
            self.draft_params = self._place_model(draft_params, draft_cfg)
            self.draft_state = self._make_state(draft_cfg)
        if self.ecfg.host_tier_bytes < 0:
            raise ValueError("host_tier_bytes must be >= 0")
        if self.ecfg.host_tier_quant not in WIRE_QUANTS:
            raise ValueError(
                f"host_tier_quant must be one of {'/'.join(WIRE_QUANTS)}, "
                f"got {self.ecfg.host_tier_quant!r}")
        if self.ecfg.latent_rank < 0:
            raise ValueError("latent_rank must be >= 0")
        # a speculative engine never gets a host tier (its shared pages
        # cover both pools; the tier would re-seat prefixes with a stale
        # draft half), so it neither needs nor rejects the native tier
        self._need_offload_hook = (self.ecfg.host_tier_bytes > 0
                                   and self.draft_state is None)
        self.allocator = _make_allocator(self.pcfg,
                                         self.ecfg.native_allocator,
                                         self._need_offload_hook)
        self.host_tier: Optional[HostTier] = None
        if self.ecfg.host_tier_bytes > 0:
            if self.draft_state is not None:
                logger.warning(
                    "host-tier prefix cache disabled: speculative engines "
                    "would re-seat prefixes with a stale draft KV pool")
            else:
                self.host_tier = HostTier(
                    self.ecfg.host_tier_bytes,
                    quant=self.ecfg.host_tier_quant,
                    inflight_window=self._OFFLOAD_GROUP)
                self.allocator.offload_hook = self._offload_pages
        # host-tier traffic: pages reloaded, and each reload's seconds
        self._host_hit_pages = 0
        self._host_reload_durations: List[float] = []
        # prefill_only sequences whose first token is out, pages held,
        # waiting for export_handoff
        self._handoff_ready: Dict[RequestId, _Seq] = {}
        # encoded payload bytes by kind (every encode site), and the raw
        # bytes the latent encodes stood in for
        self._payload_bytes: Dict[str, int] = {
            k: 0 for k in ("raw", "int8", "qpool", "latent", "latent_int8")}
        self._latent_raw_equiv_bytes = 0
        self.latent_codec: Optional[LatentCodec] = None
        self._warned_latent_off = False
        self.waiting: Deque[_Seq] = deque()
        self.slots: List[Optional[_Seq]] = [None] * self.ecfg.max_batch
        self._by_id: Dict[RequestId, _Seq] = {}
        self._num_slots_flat = self.pcfg.num_pages * self.pcfg.page_size
        dev = self.device
        # prefill and decode draw from separate device generators, as the
        # JAX engine keeps separate keys (seed, seed + 1)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(self.ecfg.seed)
        self._decode_gen = torch.Generator(device=dev)
        self._decode_gen.manual_seed(self.ecfg.seed + 1)

        # host mirror of per-slot block tables / sampling params, uploaded
        # at each block launch
        B = self.ecfg.max_batch
        P = self.pcfg.max_pages_per_seq
        K = self.ecfg.decode_block_size
        self._bt = np.zeros((B, P), np.int32)
        self._bt_pages = np.zeros((B,), np.int32)
        self._temp = np.ones((B,), np.float32)
        self._topp = np.ones((B,), np.float32)
        # slot -> (active, token, position, steps) merged into the device
        # carry at the next launch (admissions and deactivations)
        self._slot_updates: Dict[int, Tuple[bool, int, int, int]] = {}
        # static device buffers, the CUDA graphs' inputs and outputs. The
        # decode block reads its staged carry overrides (mask, active,
        # token, position, steps; [B] each) and the block tables [B, P]
        # from one int32 buffer, the temperatures and top-p from one f32
        # buffer, and writes [2, K, B] tokens and log-probabilities
        i32, f32 = torch.int32, torch.float32
        self._d_int = torch.zeros((5 * B + B * P,), dtype=i32, device=dev)
        self._d_flt = torch.ones((2 * B,), dtype=f32, device=dev)
        self._d_out = torch.zeros((2, K, B), dtype=f32, device=dev)
        # the device decode carry (tokens, positions, steps_left, active),
        # updated in place by every decode block and mixed step
        self._carry = (torch.zeros((B,), dtype=i32, device=dev),
                       torch.zeros((B,), dtype=i32, device=dev),
                       torch.zeros((B,), dtype=i32, device=dev),
                       torch.zeros((B,), dtype=torch.bool, device=dev))
        # per prefill bucket: ids, positions, write slots ([Bp, bucket]
        # each), tables [Bp, P], kv_valid and the logits index ([Bp] each);
        # temperatures and top-p; [2, Bp] first tokens and log-probs
        Bp = self.ecfg.prefill_batch
        self._p_int = {b: torch.zeros((3 * Bp * b + Bp * P + 2 * Bp,),
                                      dtype=i32, device=dev)
                       for b in self.ecfg.prefill_buckets}
        self._p_flt = {b: torch.ones((2 * Bp,), dtype=f32, device=dev)
                       for b in self.ecfg.prefill_buckets}
        self._p_out = {b: torch.zeros((2, Bp), dtype=f32, device=dev)
                       for b in self.ecfg.prefill_buckets}
        self._eos = torch.tensor(sorted(tokenizer.eos_ids), dtype=i32,
                                 device=dev)
        # the mixed step (mixed_step_tokens > 0): the prefill share's ids,
        # positions, tok_row, write slots ([Sp] each), kv_valid, the logits
        # index ([Bp] each) and tables [Bp, P]; temperatures and top-p
        # [Bp] each; out: [2, K * B + Bp] decode ids (-1 = frozen row) and
        # first-token candidates, and their log-probabilities
        S = self.ecfg.mixed_step_tokens
        Sp, Bm = max(0, S - B), min(Bp, max(0, S - B))
        self._m_int = torch.zeros((4 * Sp + 2 * Bm + Bm * P,) if S else (0,),
                                  dtype=i32, device=dev)
        self._m_flt = torch.ones((2 * Bm,), dtype=f32, device=dev)
        self._m_out = torch.zeros((2, self._mixed_block_k() * B + Bm)
                                  if S else (2, 0), dtype=f32, device=dev)
        # looped blocks (loop_to_completion). In: the block tables' page
        # counts [B], the device free-list [num_pages] (padded with
        # num_pages past its length), its length and the iteration cap;
        # the noise key of sampled blocks (int64). State: the step
        # counter k, the continue flag, the free-list pages used, the exit
        # codes so far [B], the final exit codes [B], the page counts [B]
        # and the block tables [B, P] the loop grows. Out: [2, C, B] tokens
        # (-1 = frozen row) and log-probabilities, C = loop_max_steps
        N = self.pcfg.num_pages
        C = self.ecfg.loop_max_steps if self.ecfg.loop_to_completion else 0
        self._l_in = torch.zeros((B + N + 2,), dtype=i32, device=dev)
        self._l_key = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._l_state = torch.zeros((3 + 3 * B + B * P,), dtype=i32,
                                    device=dev)
        st = self._l_state
        self._l_k, self._l_cont, self._l_used = st[0:1], st[1:2], st[2:3]
        self._l_exit = st[3:3 + B]
        self._l_fin = st[3 + B:3 + 2 * B]
        self._l_cnt = st[3 + 2 * B:3 + 3 * B]
        self._l_tbl = st[3 + 3 * B:].view(B, P)
        self._l_out = torch.zeros((2, C, B), dtype=f32, device=dev)
        self._loop_launches = 0
        # speculation. In: spec_ok per slot [B] (1 = the row's pattern
        # speculates). Out of a fixed spec block (R = decode_block_size
        # rounds of W = gamma + 1) and of a looped one (R = its round cap):
        # [R, B, W] tokens (-1 = not emitted) and log-probabilities, then
        # [R, B] emitted counts, accepted and proposed draft tokens, all
        # f32 in one buffer (one host read)
        W = self.spec.num_draft_tokens + 1
        R = K if draft_params is not None else 0
        # a looped spec block runs whole rounds: at most ceil(C / W)
        self._spec_loop_rounds = -(-C // W) if draft_params is not None else 0
        self._s_ok = torch.zeros((B,), dtype=i32, device=dev)
        self._s_out = torch.zeros((R * B * (2 * W + 3),), dtype=f32,
                                  device=dev)
        self._ls_out = torch.zeros(
            (self._spec_loop_rounds * B * (2 * W + 3),), dtype=f32,
            device=dev)
        # launched-but-unprocessed blocks: (host [2, K, B] tokens and
        # log-probabilities, the event after their copy or None, the
        # launch snapshot, the step-clock kind)
        self._pending: Deque[tuple] = deque()
        # CUDA graphs on the quantum path (cuda only), captured on the
        # engine's own stream from one shared memory pool
        # graphs capture one card's launches: a mesh over distinct cards
        # runs eagerly
        self._use_graphs = (dev.type == "cuda" and _graphs and (
            mesh is None or len(mesh.distinct_devices()) == 1))
        self._graphs: Dict[tuple, _Graph] = {}
        self._stream = None
        self._pool = None
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(device=dev)
            # params, pools and buffers were made on the caller's stream
            self._stream.wait_stream(torch.cuda.current_stream(dev))
        if self._use_graphs:
            self._pool = torch.cuda.graph_pool_handle()
        # looped-block control and traffic counters (loop_stats)
        self._loop_cap_frac = 1.0
        self._loop_blocks = 0
        self._loop_steps = 0
        self._loop_decode_tokens = 0
        self._loop_exits = {r: 0 for r in LOOP_EXITS[1:]}
        # mixed-step control and traffic counters (mixed_stats)
        self._mixed_prefill_frac = 1.0
        self._mixed_steps = 0
        self._mixed_prefill_tokens = 0
        self._mixed_decode_tokens = 0
        self._mixed_density_sum = 0.0
        # engine step clock: host wall time, dispatches, tokens and rows
        # per dispatch kind (time.monotonic around the host sections,
        # never a device sync), plus the step loop's pressure events
        self._sc_kinds: Dict[str, Dict[str, float]] = {
            k: {"dispatches": 0, "wall_s": 0.0, "tokens": 0, "rows": 0}
            for k in ("prefill", "decode_block", "mixed", "loop")
        }
        self._sc_events: Dict[str, int] = {
            "cache_full": 0, "preempt": 0, "reclaim": 0, "retrace": 0,
        }
        self._sc_samples: List[Tuple[str, float]] = []
        # warmup() builds every graph up front: boot cost, not the
        # mid-serving "retrace" event
        self._in_warmup = False
        # step-scoped device trace (utils/profiler.py): (n, event, holder)
        # armed by profile_steps(); the active one is [steps left,
        # DeviceTrace, event, holder]
        self._prof_req = None
        self._prof_active = None
        # the latent page codec: calibrated last, through the normal
        # request path, before any graph is captured (gated like the host
        # tier: float pools, no draft model)
        if self.ecfg.latent_rank > 0:
            if self.draft_state is not None or isinstance(self.state.k,
                                                          QuantPool):
                logger.warning(
                    "latent KV codec disabled: %s",
                    "speculative engines need the draft pool bit-exact"
                    if self.draft_state is not None
                    else "quantized pools ship native codes exactly")
            else:
                self.latent_codec = self._calibrate_latent(
                    self.ecfg.latent_rank)

    def _validate_mesh(self, mesh: Mesh, cfg: ModelConfig, draft_params,
                       draft_cfg: Optional[ModelConfig]) -> None:
        """The JAX engine's mesh refusals: the mixed step on tensor-only
        meshes, ``sp_impl`` and Ulysses' divisibility, the tensor and
        pipeline splits of target and draft; and the ``data`` axis's
        split of the decode and prefill rows."""
        shape, ecfg = mesh.shape, self.ecfg
        if ecfg.mixed_step_tokens and (shape["stage"] > 1 or shape["seq"] > 1
                                       or shape["data"] > 1):
            raise ValueError(
                "mixed_step_tokens supports single-device and tensor-axis "
                "meshes only (the ragged attend shards heads; stage/seq/"
                "data axes take the quantum path)")
        if ecfg.sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl must be 'ring' or 'ulysses', got "
                             f"{ecfg.sp_impl!r}")
        tp, sp_ax = shape["tensor"], shape["seq"]
        if sp_ax > 1 and ecfg.sp_impl == "ulysses" and (
                (cfg.num_heads // tp) % sp_ax
                or (cfg.num_kv_heads // tp) % sp_ax):
            raise ValueError(
                f"Ulysses seq axis {sp_ax} must divide the per-tensor-shard "
                f"head counts ({cfg.num_heads // tp} q / "
                f"{cfg.num_kv_heads // tp} kv); use sp_impl='ring' for "
                "larger axes")
        tp_rules.validate_tp(cfg, tp)
        if shape["stage"] > 1:
            for c in (cfg, draft_cfg if draft_params is not None else None):
                if c is None:
                    continue
                validate_pp(c, shape["stage"], ecfg.max_batch,
                            ecfg.pp_microbatches)
                validate_pp(c, shape["stage"], ecfg.prefill_batch,
                            ecfg.pp_microbatches)
        if draft_params is not None:
            tp_rules.validate_tp(draft_cfg, tp)
        dp = shape["data"]
        if ecfg.max_batch % dp or ecfg.prefill_batch % dp:
            raise ValueError(
                f"data axis {dp} must divide max_batch ({ecfg.max_batch}) "
                f"and prefill_batch ({ecfg.prefill_batch})")

    def _moe_impl(self) -> str:
        """The capacity-based expert-parallel dispatch (``ops/moe.py``)
        when the mesh has an expert axis; else every expert on every
        token (exact, no capacity drops)."""
        if (self.cfg.is_moe and self.mesh is not None
                and self.mesh.shape["expert"] > 1):
            return "ep"
        return "dense"

    def _place_model(self, params: llama.Params, cfg: ModelConfig):
        """The params on the engine's device, or cut over its mesh (a
        ``ShardedParams`` carrying the microbatches and MoE dispatch)."""
        if self.mesh is None:
            out = _to_device(params, self.device)
            if out["embed"].dtype != torch.float32:
                # f32 logits every step: keep the f32 unembedding once
                out["unembed_f32"] = llama.unembed_weight_f32(out, cfg)
            return out
        sp = tp_rules.shard_params(params, self.mesh, cfg)
        ep = cfg.is_moe and self.mesh.shape["expert"] > 1
        factor = cfg.moe_capacity_factor
        if ep:
            factor = max(factor, cfg.num_experts / cfg.num_experts_per_tok)
        return sp.with_options(microbatches=self.ecfg.pp_microbatches,
                               moe_impl="ep" if ep else "dense",
                               moe_capacity_factor=factor)

    def _make_state(self, cfg: ModelConfig) -> PagedKVState:
        """A model's paged pools: one pair on the device, or per (stage,
        tensor) shard over the mesh."""
        if self.mesh is None:
            return PagedKVState.create(cfg, self.pcfg, dtype=self.dtype,
                                       device=self.device,
                                       kv_quant=self.ecfg.kv_quant)
        return PagedKVState(*tp_rules.make_sharded_pools(
            self.mesh, cfg, self.pcfg.num_pages * self.pcfg.page_size,
            self.dtype, self.ecfg.kv_quant))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def add_request(self, request_id: RequestId, prompt_ids: List[int],
                    params: SamplingParams,
                    prefill_only: bool = False) -> None:
        """Queue a tokenized request. ``prefill_only``: emit the first
        sampled token, then park the sequence for KV handoff
        (``handoff_ready_ids``) instead of decoding here."""
        seq = _Seq(request_id, prompt_ids, params)
        seq.prefill_only = prefill_only
        self._by_id[request_id] = seq
        self.waiting.append(seq)

    def abort(self, request_id: RequestId) -> bool:
        """Abort a queued or running request; returns True if found. Its
        pages are released at once: a block still in flight may write
        into them, but a reader only gathers slots its own sequence wrote
        (positions < kv_valid), and the new owner's writes are issued
        after the in-flight block on the same stream."""
        seq = self._by_id.pop(request_id, None)
        if seq is None:
            return False
        self._handoff_ready.pop(request_id, None)
        if seq in self.waiting:
            self.waiting.remove(seq)
        for i, s in enumerate(self.slots):
            if s is seq:
                self.slots[i] = None
                self._deact_slot(i)
        self._release_seq(seq)
        return True

    def has_work(self) -> bool:
        return bool(self._by_id)

    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def num_waiting(self) -> int:
        return len(self.waiting)

    def step(self) -> List[StepOutput]:
        """One engine iteration: admit waiting requests into free slots,
        run up to one prefill quantum (first tokens sampled on the
        device), launch one K-step decode block, and walk the oldest
        pending block's tokens once more than ``pipeline_depth`` blocks
        are in flight (or nothing new was launched). Token events arrive
        in bursts of up to ``decode_block_size`` per sequence,
        ``pipeline_depth`` blocks behind the device. With
        ``mixed_step_tokens`` set and a seated prompt still loading, one
        ragged mixed dispatch replaces the quantum and the block. With
        ``loop_to_completion`` a pure-decode iteration runs one looped
        block instead of the K-step block, processed right after it ends
        (looped blocks do not pipeline)."""
        outputs: List[StepOutput] = []
        self._prof_begin()
        with self._on_stream():
            self._admit(outputs)
            if self.ecfg.mixed_step_tokens and any(
                    s is not None and _mid_prefill(s) for s in self.slots):
                launched = self._mixed_step(outputs)
            elif self.ecfg.loop_to_completion:
                self._prefill_quantum(outputs)
                launched = self._loop_step(outputs)
            else:
                self._prefill_quantum(outputs)
                launched = self._maybe_launch(outputs)
            if self._pending and (
                    len(self._pending) > self.ecfg.pipeline_depth
                    or not launched):
                self._process_block(outputs)
        self._prof_end_step()
        return outputs

    def profile_steps(self, n: int):
        """Arm a device trace (``utils/profiler.py``) over the next ``n``
        engine steps. Returns (event, holder): the event is set when the
        trace is done and ``holder`` then has its summary (or an
        ``error``). The trace starts at the next step() call, so an idle
        engine traces nothing until work arrives. Engine-thread only."""
        ev, holder = threading.Event(), {}
        if self.device.type != "cuda":
            holder["error"] = "no CUDA device to trace"
            ev.set()
        else:
            self._prof_req = (max(1, int(n)), ev, holder)
        return ev, holder

    def cancel_profile(self, holder) -> None:
        """Disarm a trace that has not started (its waiter gave up)."""
        if self._prof_req is not None and self._prof_req[2] is holder:
            self._prof_req = None

    def _prof_begin(self) -> None:
        if self._prof_req is None or self._prof_active is not None:
            return
        n, ev, holder = self._prof_req
        self._prof_req = None
        try:
            trace = DeviceTrace()
        except Exception as e:  # noqa: BLE001 — e.g. a trace in progress
            holder["error"] = str(e)
            ev.set()
            return
        self._prof_active = [n, trace, ev, holder]

    def _prof_end_step(self) -> None:
        if self._prof_active is None:
            return
        self._prof_active[0] -= 1
        if self._prof_active[0] > 0:
            return
        n, trace, ev, holder = self._prof_active
        self._prof_active = None
        try:
            holder.update(trace.stop())
            holder["mode"] = "steps"
        except Exception as e:  # noqa: BLE001 — profiler teardown failure
            holder["error"] = str(e)
        ev.set()

    def warmup(self) -> None:
        """Run every serving program once before traffic arrives: one
        throwaway greedy request per prefill bucket, decoded through at
        least one full block, plus one near the context limit (every
        chunk of a long prompt). On ``cuda`` this also captures every
        CUDA graph: the decode block per sampling mode, the prefill chunk
        per (bucket, sampling mode), and with them on, the mixed step
        and the looped block per sampling mode."""
        steps = self.ecfg.decode_block_size + 1
        cap = self.pcfg.max_seq_len - steps - 2
        lengths = [min(b, cap) for b in self.ecfg.prefill_buckets]
        if cap > max(lengths, default=0):
            lengths.append(cap)
        thr = self._cp_threshold()
        if thr is not None:
            lengths.append(min(thr, cap))
        self._in_warmup = True
        try:
            for i, n in enumerate(lengths):
                if n < 1:
                    continue
                # distinct leading token per warmup: prefix reuse against
                # an earlier warmup would shrink the chunk into a smaller
                # bucket and leave this one cold
                tok_id = 1 + i % max(1, self.cfg.vocab_size - 1)
                self.add_request(f"__warmup_{i}", [tok_id] * n,
                                 SamplingParams(max_tokens=steps,
                                                temperature=0.0))
                # one at a time: co-seated warmups would share the largest
                # bucket and leave the others cold
                while self.has_work():
                    self.step()  # outputs discarded
            if self._use_graphs:
                with self._on_stream():
                    self._drain_pending([])
                    self._capture_all()
        finally:
            self._in_warmup = False

    def set_mixed_prefill_frac(self, frac: float) -> None:
        """Shrink (or restore) the prefill share of the mixed step's packed
        budget; floor 0.05 so prompts always progress. Engine-thread
        only."""
        self._mixed_prefill_frac = min(1.0, max(0.05, float(frac)))

    def set_loop_cap_frac(self, frac: float) -> None:
        """Shrink (or restore) the looped block's iteration cap; floor 0.05
        so decode always progresses. Engine-thread only."""
        self._loop_cap_frac = min(1.0, max(0.05, float(frac)))

    def _loop_cap(self) -> int:
        """Iteration cap of the next looped block: ``loop_max_steps``
        scaled by the cap fraction, never below one step."""
        return max(1, int(self.ecfg.loop_max_steps * self._loop_cap_frac))

    def loop_stats(self) -> Optional[Dict[str, object]]:
        """Looped-block traffic since construction; None when
        ``loop_to_completion`` is off. ``steps`` counts device iterations,
        ``exits`` the rows' stop reasons at each block's reconcile."""
        if not self.ecfg.loop_to_completion:
            return None
        return {
            "blocks": self._loop_blocks,
            "steps": self._loop_steps,
            "decode_tokens": self._loop_decode_tokens,
            "exits": dict(self._loop_exits),
            "cap": self._loop_cap(),
            "cap_frac": self._loop_cap_frac,
        }

    def spec_stats(self) -> Optional[Dict[str, object]]:
        """Speculation for ``/server/stats`` and ``/metrics``: the
        aggregate acceptance rate, estimated speedup and enabled flag
        (over each pattern's window), the per-pattern breakdown and gamma,
        as the reference reports them; and the port's ``totals`` since
        construction (spec launches; the rounds of the rows that
        speculated, their draft tokens proposed, accepted, and tokens
        emitted) and the draft pool's element type. None without a draft
        model."""
        if self.spec_trackers is None:
            return None
        out = self.spec_trackers.stats()
        out["num_draft_tokens"] = self.spec.num_draft_tokens
        t = dict(self._spec_totals)
        t["emitted"] = t["accepted"] + t["row_rounds"]
        out["totals"] = t
        pool = self.draft_state.k
        out["draft_pool"] = str(getattr(pool, "data", pool).dtype).replace(
            "torch.", "")
        return out

    def _mixed_block_k(self) -> int:
        """Decode tokens one mixed dispatch advances: decode_block_size
        under ``loop_to_completion`` (the K-block form), else 1."""
        return (self.ecfg.decode_block_size
                if self.ecfg.loop_to_completion else 1)

    def mixed_stats(self) -> Optional[Dict[str, object]]:
        """Mixed-step traffic since construction; None when the mixed step
        is off. ``batch_density``: mean (real packed tokens) /
        mixed_step_tokens over the mixed dispatches."""
        if not self.ecfg.mixed_step_tokens:
            return None
        steps = self._mixed_steps
        return {
            "steps": steps,
            "prefill_tokens": self._mixed_prefill_tokens,
            "decode_tokens": self._mixed_decode_tokens,
            "batch_density": round(
                self._mixed_density_sum / steps, 4) if steps else 0.0,
            "prefill_frac": self._mixed_prefill_frac,
        }

    def step_clock_stats(self) -> Dict[str, Dict[str, object]]:
        """Cumulative step-clock counters: per dispatch kind (prefill,
        decode_block, mixed, loop) the dispatches, host wall seconds,
        tokens and rows; and the events (cache_full, preempt, reclaim,
        retrace: a CUDA graph captured while serving)."""
        return {
            "kinds": {k: dict(v) for k, v in self._sc_kinds.items()},
            "events": dict(self._sc_events),
        }

    def drain_step_samples(self) -> List[Tuple[str, float]]:
        """Per-segment (kind, wall_s) samples since the last drain."""
        out, self._sc_samples = self._sc_samples, []
        return out

    def release(self) -> None:
        """Let go of the device state that outlives a stopped engine's
        last reference only through its CUDA graphs: wait for the stream,
        drop every graph and the graph pool. A runner calls it before it
        builds a replacement engine."""
        if self._stream is not None:
            self._stream.synchronize()
        self._pending.clear()
        self._graphs.clear()
        self._pool = None

    def memory_stats(self) -> Optional[Dict[str, object]]:
        """Device memory (cuda only): the bytes allocated now and the
        allocator's peak (the whole process: every replica on the card),
        its reserved bytes, the bytes held by this engine's CUDA graphs'
        private pool and the number of graphs captured."""
        if self.device.type != "cuda":
            return None
        pool_bytes = None
        if self._pool is not None:
            pool_bytes = sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id") or ())
                == tuple(self._pool))
        return {
            "allocated_bytes": torch.cuda.memory_allocated(self.device),
            "max_allocated_bytes": torch.cuda.max_memory_allocated(
                self.device),
            "reserved_bytes": torch.cuda.memory_reserved(self.device),
            "graph_pool_bytes": pool_bytes,
            "graphs": len(self._graphs),
        }

    def cache_stats(self):
        return self.allocator.stats()

    def audit_pages(self, extra_pages: Sequence[int] = ()) -> List[str]:
        """KV-page conservation audit: every page a live sequence holds
        (waiting, seated, handoff-ready and mid-export ones alike; plus
        ``extra_pages``, e.g. open import sessions' reservations) against
        the allocator's books, on either allocator tier. Returns
        inconsistency strings (empty = clean)."""
        sentinel = self.pcfg.num_pages  # reclaimed entries are not pages
        live = [p for s in self._by_id.values() for p in s.block_table
                if p != sentinel]
        live.extend(extra_pages)
        return self.allocator.audit(live)

    # ------------------------------------------------------------------
    # host-tier prefix cache
    # ------------------------------------------------------------------

    #: pages per demotion gather (and the host tier's in-flight window)
    _OFFLOAD_GROUP = 32

    def _offload_pages(self, victims) -> None:
        """Allocator offload hook: demote a batch of LRU-evicted pages to
        the host tier. Each group of at most 32 pages is gathered (and
        encoded) on the engine stream BEFORE the ids are recycled, so the
        gather reads their old content and every later write to them is
        ordered after it; its copy into pinned host memory starts here and
        the tier reads it only behind the copy's event."""
        tier = self.host_tier
        if tier is None:
            return
        victims = [v for v in victims if not tier.has(v.hash)]
        ps = self.pcfg.page_size
        cap = self._OFFLOAD_GROUP
        quant = self._effective_wire_quant(tier.quant)
        with self._on_stream():
            for start in range(0, len(victims), cap):
                group = victims[start:start + cap]
                kind, host = _pull_group(
                    self.state, _page_slots([v.page_id for v in group], ps),
                    quant, self.latent_codec)
                self._note_payload(kind, quant, sum(
                    a.numel() * a.element_size() for a in host.tensors))
                # groups past the first continue this burst: the window
                # never drains the burst's own copies in flight
                tier.offer([(v.hash, v.depth, v.root) for v in group], kind,
                           host, ps, new_burst=(start == 0))

    def _host_tier_reload(self, seq: _Seq, prompt: List[int]) -> None:
        """Prefix-match fallthrough: continue the content-hash chain past
        the HBM match into the host tier, write every matched page into
        fresh pages with ONE in-place scatter on the engine stream (codes
        uploaded through pinned memory and decoded on the device), and
        content-address them so the next prompt hits them in HBM. Always
        leaves at least one token to compute. Best-effort: a failure
        releases the pages and the prefill recomputes."""
        tier = self.host_tier
        ps = self.pcfg.page_size
        n = len(prompt)
        start = len(seq.block_table)  # pages already shared from HBM
        if tier.empty or (start + 1) * ps >= n:
            return
        hash_it = iter_chain_hashes(prompt, ps)
        for _ in range(start):  # the hashes the HBM match covered
            next(hash_it)
        entries = []
        idx = start
        while (idx + 1) * ps < n:
            h = next(hash_it, None)
            if h is None:
                break
            e = tier.get(h)
            if e is None or (entries and e.kind != entries[0].kind):
                break
            entries.append(e)
            idx += 1
        if not entries:
            return
        t0 = time.monotonic()
        try:
            pages = self.allocator.allocate(len(entries))
        except CacheFull:
            return  # pool too tight to re-seat; the prefill recomputes
        try:
            kind = entries[0].kind
            merged = tuple(
                _host_to_device(
                    torch.cat([e.parts[m] for e in entries], dim=1),
                    self.device)
                for m in range(len(entries[0].parts)))
            dt = None if kind == _KIND_QPOOL else self.state.k.dtype
            if kind == _KIND_WIRE8:
                k_q, v_q, k_s, v_s = merged
                parts = ((k_q.float() * k_s[..., None]).to(dt),
                         (v_q.float() * v_s[..., None]).to(dt))
            elif kind == _KIND_LATENT:
                if self.latent_codec is None:
                    raise CacheDeserializationError(
                        "host tier holds latent pages but the engine has "
                        "no codec")
                if len(merged) == 4:  # latent_int8: codes dequantized
                    k_q, v_q, k_s, v_s = merged
                    codes = (k_q.float() * k_s[..., None],
                             v_q.float() * v_s[..., None])
                else:
                    codes = merged
                k, v = self.latent_codec.decode_device(*codes)
                parts = (k.to(dt), v.to(dt))
            else:  # raw into a float pool, qpool into a QuantPool
                parts = merged
            _scatter_payload(self.state, _page_slots(pages, ps), parts)
        except Exception as e:  # noqa: BLE001 — reload is best-effort
            # not yet in the table nor addressed: straight back to free
            self.allocator.release(pages)
            logger.warning("host-tier reload of %d pages failed: %s",
                           len(entries), e)
            return
        seq.block_table.extend(pages)
        seq.seq_len = (start + len(entries)) * ps
        self.allocator.publish(prompt[:seq.seq_len], seq.block_table)
        self._host_hit_pages += len(entries)
        self._host_reload_durations.append(time.monotonic() - t0)
        if len(self._host_reload_durations) > 1024:
            del self._host_reload_durations[:-1024]

    def evict_cache(self, target_frac: float,
                    drop_host_tier: bool = False) -> None:
        """Reclaim cached pages down to ``target_frac`` of the pool,
        demoting them to the host tier on the way out;
        ``drop_host_tier`` drops them and clears the tier instead."""
        with self._on_stream():
            if self.host_tier is not None:
                self.allocator.evict_below(target_frac,
                                           demote=not drop_host_tier)
                if drop_host_tier:
                    self.host_tier.clear()
                else:
                    # one demotion burst may exceed the window with
                    # nothing later to drain it
                    self.host_tier.drain_to_window()
            else:
                self.allocator.evict_below(target_frac)

    def prefix_digest(self, max_depth: Optional[int] = None) -> frozenset:
        """Cached prefix chains' first ``max_depth`` page hashes (HBM and
        host tier; None = ``ecfg.digest_depth``). Empty on the native
        allocator tier (it addresses pages by its own hash): the router
        then falls back to least-loaded."""
        if max_depth is None:
            max_depth = self.ecfg.digest_depth
        dig = getattr(self.allocator, "prefix_digest", None)
        out = dig(max_depth) if dig is not None else frozenset()
        if self.host_tier is not None:
            out = frozenset(out) | frozenset(
                self.host_tier.digest_hashes(max_depth))
        return out

    def host_tier_stats(self) -> Optional[Dict[str, int]]:
        """Host-tier occupancy and traffic; None when the tier is off."""
        if self.host_tier is None:
            return None
        s = self.host_tier.stats()
        return {"budget_bytes": s.budget_bytes, "bytes": s.bytes_used,
                "pages": s.pages, "hits": s.hits,
                "hit_pages": self._host_hit_pages, "offloads": s.offloads,
                "evictions": s.evictions}

    def drain_reload_durations(self) -> List[float]:
        """The host-tier reload durations since the last drain."""
        out, self._host_reload_durations = self._host_reload_durations, []
        return out

    def allocator_tier(self) -> str:
        """The page allocator's tier: ``native`` or ``python``."""
        return ("python" if isinstance(self.allocator, PageAllocator)
                else "native")

    # ------------------------------------------------------------------
    # latent page codec
    # ------------------------------------------------------------------

    def _calibrate_latent(self, rank: int) -> Optional[LatentCodec]:
        """Fit the projections by SVD over a deterministic calibration
        pass (the JAX engine's): two seeded prompts prefill through the
        normal request path, the touched pool slots are the samples, and
        the engine is reset to pristine IN PLACE (pools zeroed, a fresh
        allocator, the generators reseeded, the step clock cleared). It
        runs eagerly, before any graph is captured."""
        head_dim = self.cfg.head_dim
        if not 0 < rank <= head_dim:
            raise ValueError(f"latent_rank must be in (0, head_dim="
                             f"{head_dim}], got {rank}")
        cap = self.pcfg.max_seq_len - 2
        n_tok = min(max(2 * head_dim, 32), cap)
        rng = np.random.default_rng(0x7A7E)
        vocab = max(2, self.cfg.vocab_size - 1)
        greedy = SamplingParams(max_tokens=1, temperature=0.0)
        graphs, self._use_graphs = self._use_graphs, False
        try:
            for i in range(2):
                prompt = [1 + int(t) for t in rng.integers(0, vocab, n_tok)]
                self.add_request(f"__latent_calib_{i}", prompt, greedy)
                while self.has_work():
                    self.step()
        finally:
            self._use_graphs = graphs
        with self._on_stream():
            k, v = self.state.k[:, :-1], self.state.v[:, :-1]  # no drop slot
            used = ((k != 0).any(dim=(0, 2, 3)) | (v != 0).any(dim=(0, 2, 3)))
            idx = torch.nonzero(used)[:, 0]
            k_s = k.index_select(1, idx).float().cpu().numpy()
            v_s = v.index_select(1, idx).float().cpu().numpy()
            # reset to pristine, in place: graphs read these buffers
            self.state.k.zero_()
            self.state.v.zero_()
            for t in self._carry:
                t.zero_()
        if k_s.shape[1] < 2:
            logger.warning("latent KV codec disabled: calibration pass "
                           "touched %d pool slots", k_s.shape[1])
            codec = None
        else:
            codec = LatentCodec.calibrate(k_s, v_s, rank)
        self.allocator = _make_allocator(self.pcfg,
                                         self.ecfg.native_allocator,
                                         self._need_offload_hook)
        if self.host_tier is not None:
            self.host_tier.clear()
            self.allocator.offload_hook = self._offload_pages
        self._by_id.clear()
        self.waiting.clear()
        self._handoff_ready.clear()
        self.slots = [None] * self.ecfg.max_batch
        self._slot_updates.clear()
        self._pending.clear()
        self._bt.fill(0)
        self._bt_pages.fill(0)
        self._gen.manual_seed(self.ecfg.seed)
        self._decode_gen.manual_seed(self.ecfg.seed + 1)
        self._loop_launches = 0
        for d in self._sc_kinds.values():
            d.update(dispatches=0, wall_s=0.0, tokens=0, rows=0)
        self._sc_events = {k: 0 for k in self._sc_events}
        self._sc_samples.clear()
        self._host_hit_pages = 0
        self._host_reload_durations.clear()
        self._payload_bytes = {k: 0 for k in self._payload_bytes}
        self._warned_latent_off = False
        self._latent_raw_equiv_bytes = 0
        return codec

    def _effective_wire_quant(self, wire_quant: str) -> str:
        """A latent wire request degrades to "none" (one warning) on an
        engine with no codec and a float pool; QuantPool exports pass
        their native codes whatever the setting."""
        if (wire_quant in LATENT_QUANTS and self.latent_codec is None
                and not isinstance(self.state.k, QuantPool)):
            if not self._warned_latent_off:
                self._warned_latent_off = True
                logger.warning(
                    "wire_quant %r degraded to \"none\": engine has no "
                    "latent codec (latent_rank unset or codec gated off)",
                    wire_quant)
            return "none"
        return wire_quant

    def _payload_label(self, kind: int, wire_quant: str) -> str:
        if kind == _KIND_QPOOL:
            return "qpool"
        if kind == _KIND_LATENT:
            return "latent_int8" if wire_quant == "latent_int8" else "latent"
        return "int8" if kind == _KIND_WIRE8 else "raw"

    def _note_payload(self, kind: int, wire_quant: str, nbytes: int) -> None:
        """Account encoded payload bytes by kind (handoff, streamed
        chunks, prefix export, host-tier offload)."""
        self._payload_bytes[self._payload_label(kind, wire_quant)] += int(
            nbytes)
        if kind == _KIND_LATENT and self.latent_codec is not None:
            frac = encoded_page_fraction(
                wire_quant, self.state.k.element_size(), self.cfg.head_dim,
                self.latent_codec.rank)
            if frac > 0:
                self._latent_raw_equiv_bytes += int(nbytes / frac)

    def payload_byte_counters(self) -> Dict[str, int]:
        """Cumulative encoded bytes by payload kind."""
        return dict(self._payload_bytes)

    def latent_stats(self) -> Optional[Dict[str, int]]:
        """The codec's rank and its encoded vs saved bytes; None without
        a codec."""
        if self.latent_codec is None:
            return None
        encoded = (self._payload_bytes["latent"]
                   + self._payload_bytes["latent_int8"])
        return {"rank": self.latent_codec.rank, "encoded_bytes": encoded,
                "saved_bytes": max(0, self._latent_raw_equiv_bytes
                                   - encoded)}

    # ------------------------------------------------------------------
    # KV handoff (disaggregated prefill / decode) and peer prefix fetch
    # ------------------------------------------------------------------

    def handoff_ready_ids(self) -> List[RequestId]:
        """Requests parked after their first token under ``prefill_only``
        (pages held), waiting for export."""
        return list(self._handoff_ready)

    def _export(self, seq: _Seq, kv: bytes = b"", **kw) -> SequenceExport:
        return SequenceExport(
            request_id=seq.request_id, token_ids=list(seq.token_ids),
            prompt_len=seq.prompt_len, seq_len=seq.seq_len,
            next_token=int(seq.next_token), params=seq.params,
            output_text=seq.output_text, emitted_upto=seq.emitted_upto,
            emitted_tokens=seq.emitted_tokens,
            pending_ids=list(seq.pending_ids), kv=kv, **kw)

    def _lift(self, seq: _Seq) -> None:
        """Take an exported sequence off this engine: publish its full
        pages (the prefix cache stays warm) and release them."""
        self._by_id.pop(seq.request_id, None)
        if seq.freed_upto == 0:
            self.allocator.publish(seq.token_ids, seq.block_table)
        self._release_seq(seq)

    def export_handoff(self, request_id: RequestId,
                       wire_quant: str = "none"
                       ) -> Optional[SequenceExport]:
        """Lift a handoff-ready sequence off this engine: its K/V as one
        payload (``wire_quant`` applies to float pools; the draft pool,
        when speculating, always raw), its host emission state and
        sampling params; then publish and release its pages. None if the
        request is unknown (e.g. aborted meanwhile)."""
        seq = self._handoff_ready.pop(request_id, None)
        if seq is None or self._by_id.get(request_id) is not seq:
            return None
        if seq.freed_upto or self.pcfg.num_pages in seq.block_table:
            self._handoff_ready[request_id] = seq
            raise RuntimeError("handoff candidate has window-reclaimed "
                               "pages")
        ps = self.pcfg.page_size
        wire_quant = self._effective_wire_quant(wire_quant)
        with self._on_stream():
            kv = serialize_kv(self.state, seq.block_table, ps, seq.seq_len,
                              wire_quant=wire_quant, codec=self.latent_codec)
            self._note_payload(payload_kind(self.state.k, wire_quant),
                               wire_quant, len(kv))
            draft_kv = (serialize_kv(self.draft_state, seq.block_table, ps,
                                     seq.seq_len)
                        if self.draft_state is not None else None)
        exp = self._export(seq, kv, draft_kv=draft_kv, wire_quant=wire_quant)
        self._lift(seq)
        return exp

    def export_handoff_begin(self, request_id: RequestId,
                             chunk_pages: int = 8, wire_quant: str = "none"
                             ) -> Optional[HandoffExportSession]:
        """Start a streamed export: the sequence's full prefix pages are
        immutable, so they serialize while the sequence goes back to
        decoding here (re-queued; admission seats it straight into the
        carry). Returns the session to pump between steps and finish at
        the switchover, or None (use ``export_handoff``) when there is no
        full page to stream or the budget left would finish inside the
        overlap window (about 3 decode blocks)."""
        seq = self._handoff_ready.get(request_id)
        if seq is None or self._by_id.get(request_id) is not seq:
            return None
        if seq.freed_upto or self.pcfg.num_pages in seq.block_table:
            raise RuntimeError("handoff candidate has window-reclaimed "
                               "pages")
        n_full = seq.seq_len // self.pcfg.page_size
        overlap = 3 * self.ecfg.decode_block_size
        if n_full == 0 or (seq.params.max_tokens - seq.emitted_tokens
                           <= overlap + 2):
            return None
        self._handoff_ready.pop(request_id, None)
        session = HandoffExportSession(
            seq=seq, prefix_pages=list(seq.block_table[:n_full]),
            chunk_pages=max(1, chunk_pages),
            wire_quant=self._effective_wire_quant(wire_quant))
        seq.exporting = True
        seq.prefill_only = False
        self.waiting.append(seq)  # decode resumes here during the stream
        return session

    def _session_alive(self, session: HandoffExportSession) -> bool:
        seq = session.seq
        return (self._by_id.get(seq.request_id) is seq and seq.seq_len > 0
                and seq.freed_upto == 0
                and seq.block_table[:len(session.prefix_pages)]
                == session.prefix_pages)

    def _chunks(self, pages: Sequence[int], chunk_pages: int,
                wire_quant: str, **kw) -> List[KvChunk]:
        """Serialize pages as chunks on the engine stream, counted."""
        with self._on_stream():
            chunks = list(serialize_kv_chunks(
                self.state, pages, self.pcfg.page_size,
                chunk_pages=chunk_pages, wire_quant=wire_quant,
                codec=self.latent_codec, **kw))
        kind = payload_kind(self.state.k, wire_quant)
        for c in chunks:
            self._note_payload(kind, wire_quant, len(c.payload))
        return chunks

    def export_handoff_pump(self, session: HandoffExportSession) -> bool:
        """Serialize the session's immutable prefix (double-buffered
        pulls) while the sequence keeps decoding; engine thread, between
        steps. True once the prefix is done or the session died (aborted,
        finished in place, preempted: the caller drops the migration)."""
        if session.prefix_done or session.dead:
            return True
        if not self._session_alive(session):
            session.dead = True
            session.seq.exporting = False
            return True
        session.chunks.extend(self._chunks(
            session.prefix_pages, session.chunk_pages, session.wire_quant))
        session.prefix_done = True
        return True

    def export_handoff_cancel(self, session: HandoffExportSession) -> None:
        """Abandon a streamed export: the sequence keeps decoding here."""
        session.dead = True
        seq = session.seq
        if self._by_id.get(seq.request_id) is seq:
            seq.exporting = False

    def export_handoff_finish(self, session: HandoffExportSession
                              ) -> Tuple[Optional[SequenceExport],
                                         List[StepOutput]]:
        """Switch over: drain the blocks in flight (host view exact), stop
        the sequence, serialize the TAIL pages written during the overlap
        as the last chunks, and lift the sequence off (publish + release).
        Returns (None, outputs) when it finished or died meanwhile; the
        drained outputs carry its token events either way."""
        outputs: List[StepOutput] = []
        seq = session.seq
        if session.dead:
            return None, outputs
        with self._on_stream():
            self._drain_pending(outputs)
        if not self._session_alive(session):
            session.dead = True
            seq.exporting = False
            return None, outputs
        stalled_at = time.monotonic()
        for i, s in enumerate(self.slots):
            if s is seq:
                self.slots[i] = None
                self._deact_slot(i)
        if seq in self.waiting:  # switchover before a seat opened
            self.waiting.remove(seq)
        n_prefix = len(session.prefix_pages)
        chunks = list(session.chunks)
        tail_pages = seq.block_table[n_prefix:]
        if tail_pages:
            chunks.extend(self._chunks(
                tail_pages, session.chunk_pages, session.wire_quant,
                first_chunk_index=len(chunks), first_page_index=n_prefix))
        chunks = [dc_replace(c, total=len(chunks)) for c in chunks]
        exp = self._export(seq, b"", kv_chunks=chunks,
                           wire_quant=session.wire_quant,
                           stalled_at=stalled_at)
        self._lift(seq)
        seq.exporting = False
        session.dead = True
        return exp, outputs

    def import_sequence(self, exp: SequenceExport) -> None:
        """Resume an exported sequence here: allocate pages, write its K/V
        in place and content-address its full pages (the monolithic
        payload, or streamed chunks through a ``KvImportSession``), and
        queue it for an immediate decode seat: no prefill. Raises
        CacheFull / CacheDeserializationError with the engine unchanged
        (modulo bytes in freed pages, which nothing reads)."""
        n = exp.seq_len
        ps = self.pcfg.page_size
        self._validate_import(exp)
        if (exp.draft_kv is None) != (self.draft_params is None):
            raise CacheDeserializationError(
                "draft-model topology mismatch between source and target "
                "engines (speculation must match across a handoff)")
        with self._on_stream():
            if exp.kv_chunks is not None:
                session = KvImportSession(self.state, self.allocator, ps,
                                          codec=self.latent_codec)
                try:
                    session.reserve(-(-n // ps))
                    for chunk in exp.kv_chunks:
                        session.add_chunk(chunk)
                    _, pages = session.finish(self.state, exp.token_ids)
                except Exception as e:
                    session.abort()
                    if isinstance(e, (CacheDeserializationError, CacheFull)):
                        raise
                    raise CacheDeserializationError(str(e)) from None
            elif exp.draft_kv is None:
                _, pages = deserialize_into_allocator(
                    self.state, self.allocator, exp.kv, exp.token_ids, ps,
                    codec=self.latent_codec)
            else:
                # both pools into the SAME pages; publish only once both
                # are in, so no address covers a torn draft half
                pages = self.allocator.allocate(-(-n // ps))
                try:
                    for state, blob, what in (
                            (self.state, exp.kv, "payload"),
                            (self.draft_state, exp.draft_kv,
                             "draft payload")):
                        _, tc = deserialize_kv(state, blob, pages, ps)
                        if tc != n:
                            raise CacheDeserializationError(
                                f"{what} carries {tc} tokens, expected {n}")
                except Exception:
                    self.allocator.release(pages)
                    raise
                self.allocator.publish(exp.token_ids, pages)
        self._seat_imported(exp, pages)

    def _validate_import(self, exp: SequenceExport) -> None:
        """Import preconditions shared by ``import_sequence`` and
        ``import_stream_commit``."""
        n = exp.seq_len
        if n != len(exp.token_ids) or exp.next_token is None:
            raise CacheDeserializationError(
                "export is not at a decode boundary (seq_len != resident "
                "tokens or no sampled token)")
        if n + 1 > self.pcfg.max_seq_len:
            raise CacheDeserializationError(
                f"sequence of {n} tokens exceeds this engine's capacity "
                f"({self.pcfg.max_seq_len} tokens)")
        if exp.request_id in self._by_id:
            raise CacheDeserializationError(
                f"request {exp.request_id} is already live on this engine")

    def _seat_imported(self, exp: SequenceExport, pages: List[int]) -> None:
        seq = _Seq(exp.request_id, list(exp.token_ids), exp.params)
        seq.prompt_len = exp.prompt_len
        seq.block_table = list(pages)
        seq.seq_len = exp.seq_len
        seq.next_token = int(exp.next_token)
        seq.output_text = exp.output_text
        seq.emitted_upto = int(exp.emitted_upto)
        seq.emitted_tokens = int(exp.emitted_tokens)
        seq.pending_ids = list(exp.pending_ids)
        self._by_id[seq.request_id] = seq
        self.waiting.append(seq)

    def import_stream_open(self, request_id: RequestId,
                           prefix_pages: int) -> KvImportSession:
        """Open an incremental import for a streamed handoff, reserving
        the prefix pages up front (a CacheFull surfaces here, while the
        source still decodes in place)."""
        if request_id in self._by_id:
            raise CacheDeserializationError(
                f"request {request_id} is already live on this engine")
        if self.draft_params is not None:
            raise CacheDeserializationError(
                "streamed handoff carries no draft pool; this engine "
                "speculates (topology must match across a handoff)")
        if prefix_pages > self.pcfg.max_pages_per_seq:
            raise CacheDeserializationError(
                f"prefix of {prefix_pages} pages exceeds this engine's "
                f"per-sequence capacity ({self.pcfg.max_pages_per_seq})")
        session = KvImportSession(self.state, self.allocator,
                                  self.pcfg.page_size,
                                  codec=self.latent_codec)
        try:
            with self._on_stream():
                session.reserve(prefix_pages)
        except Exception:
            session.abort()
            raise
        return session

    def import_stream_add(self, session: KvImportSession,
                          chunks: List[KvChunk]) -> None:
        """Validate arrived chunks and write them into the reserved pages
        now (invisible to prefix matching until the commit)."""
        with self._on_stream():
            for chunk in chunks:
                session.add_chunk(chunk)
            session.apply_ready(self.state)

    def import_stream_commit(self, session: KvImportSession,
                             exp: SequenceExport) -> None:
        """Absorb the last chunks, validate the stream complete, publish
        and seat the sequence. On any failure the session is aborted
        (every reserved page released) and the error propagates."""
        try:
            self._validate_import(exp)
            with self._on_stream():
                for chunk in exp.kv_chunks or []:
                    session.add_chunk(chunk)
                _, pages = session.finish(self.state, exp.token_ids)
        except Exception as e:
            session.abort()
            if isinstance(e, (CacheDeserializationError, CacheFull)):
                raise
            raise CacheDeserializationError(str(e)) from None
        self._seat_imported(exp, pages)

    def import_stream_abort(self, session: KvImportSession) -> None:
        """Drop a phased import: every reserved page is released."""
        session.abort()

    def export_prefix_chunks(self, hashes: Sequence[int],
                             chunk_pages: int = 8, wire_quant: str = "none"
                             ) -> Tuple[int, List[KvChunk]]:
        """Peer-fetch export: walk ``hashes`` (a request's content-hash
        chain) from the head through the HBM prefix cache, then the host
        tier, and serialize every consecutive match as KvChunks (HBM pages
        through the double-buffered pull, ``wire_quant`` applied;
        host-tier pages in their stored encoding). Returns (depth served,
        chunks). Touches nothing but host-tier clocks. Under the native
        allocator tier no HBM page is addressable by these hashes."""
        ps = self.pcfg.page_size
        wire_quant = self._effective_wire_quant(wire_quant)
        lookup = getattr(self.allocator, "cached_page", None)
        entries: List[Tuple[str, object]] = []
        for h in hashes:
            pid = lookup(h) if lookup is not None else None
            if pid is not None:
                entries.append(("hbm", pid))
                continue
            hp = self.host_tier.get(h) if self.host_tier is not None else None
            if hp is None:
                break
            entries.append(("host", hp))
        chunks: List[KvChunk] = []
        chunk_pages = max(1, chunk_pages)
        i = 0
        while i < len(entries):
            j = i + 1
            if entries[i][0] == "hbm":
                while j < len(entries) and entries[j][0] == "hbm":
                    j += 1
                chunks.extend(self._chunks(
                    [p for _, p in entries[i:j]], chunk_pages, wire_quant,
                    first_chunk_index=len(chunks), first_page_index=i))
            else:
                kind = entries[i][1].kind
                while (j < len(entries) and entries[j][0] == "host"
                       and entries[j][1].kind == kind
                       and j - i < chunk_pages):
                    j += 1
                group = [e for _, e in entries[i:j]]
                merged = tuple(
                    torch.cat([g.parts[m] for g in group], dim=1)
                    for m in range(len(group[0].parts)))
                # the handoff wire's one encoder; kind 3 derives its int8
                # flag from the part count
                payload = _encode_group(self.state, kind, merged, 0)
                self._note_payload(kind, self.host_tier.quant, len(payload))
                chunks.append(KvChunk(
                    index=len(chunks), total=0, page_start=i,
                    page_count=len(group), payload=payload,
                    crc32=chunk_crc(payload)))
            i = j
        return len(entries), chunks

    def import_prefix(self, tokens: Sequence[int],
                      chunks: Sequence[KvChunk]) -> int:
        """Peer-fetch import: seat a peer's exported prefix pages (the
        whole-page prefix ``tokens`` they cover) into this engine's prefix
        cache through a ``KvImportSession`` (validated, published only
        when complete), then release them: refcount-0 addressed pages are
        the CACHED state ``match_prefix`` shares from. Returns pages
        seated. Raises CacheFull / CacheDeserializationError with nothing
        leaked."""
        ps = self.pcfg.page_size
        n = len(tokens)
        if n <= 0 or n % ps != 0:
            raise CacheDeserializationError(
                f"prefix import must cover whole pages (got {n} tokens, "
                f"page_size {ps})")
        if self.draft_params is not None:
            raise CacheDeserializationError(
                "peer-fetched prefix carries no draft pool; seating it on "
                "a speculative engine would publish pages whose draft KV "
                "is garbage")
        session = KvImportSession(self.state, self.allocator, ps,
                                  codec=self.latent_codec)
        try:
            with self._on_stream():
                session.reserve(n // ps)
                for chunk in chunks:
                    session.add_chunk(chunk)
                _, pages = session.finish(self.state, list(tokens))
        except Exception as e:
            session.abort()
            if isinstance(e, (CacheDeserializationError, CacheFull)):
                raise
            raise CacheDeserializationError(str(e)) from None
        self.allocator.release(pages)
        return len(pages)

    # ------------------------------------------------------------------
    # embeddings (the /embeddings routes' compute)
    # ------------------------------------------------------------------

    def embed_start(self, ids_list: List[List[int]]) -> "_EmbedState":
        """Begin an incremental embeddings computation: inputs longer than
        the largest prefill bucket split into bucket-sized chunks, and the
        chunks form one work list that ``embed_step`` runs ``max_batch``
        rows at a time (the serving runner interleaves the steps with
        decode). The pooled sums stay on the device until
        ``embed_finish``."""
        max_bucket = self.ecfg.prefill_buckets[-1]
        work = [(b, row[start:start + max_bucket])
                for b, row in enumerate(ids_list)
                for start in range(0, len(row), max_bucket)]
        return _EmbedState(
            work=work,
            sums=torch.zeros((len(ids_list), self.cfg.hidden_size),
                             dtype=torch.float32, device=self.device),
            counts=np.zeros((len(ids_list),), np.float32))

    def embed_step(self, state: "_EmbedState") -> bool:
        """Run one device batch of the work list; True when done. Each
        chunk is its own sequence from position 0 (``llama.hidden_states``
        over the engine's ``attention_impl``: on ``cuda`` the kernel path's
        RMSNorm and RoPE); its final hidden states, masked to its valid
        tokens, are summed in f32 into its input's row. On ``cuda`` the
        batch is queued on the engine stream behind any block in flight,
        with no wait on the device."""
        if state.idx >= len(state.work):
            return True
        batch = state.work[state.idx:state.idx + self.ecfg.max_batch]
        state.idx += len(batch)
        bucket = self._pick_bucket(max(len(c) for _, c in batch))
        B = len(batch)
        ids = np.zeros((B, bucket), np.int32)
        lens = np.zeros((B,), np.int32)
        for j, (b, chunk) in enumerate(batch):
            ids[j, :len(chunk)] = chunk
            lens[j] = len(chunk)
            state.counts[b] += len(chunk)
        with self._on_stream():
            d_lens = self._device_array(lens)
            pos = torch.arange(bucket, dtype=torch.int32,
                               device=self.device).repeat(B, 1)
            h = llama.hidden_states(self.params, self.cfg,
                                    self._device_array(ids), pos, d_lens,
                                    impl=self.ecfg.attention_impl)
            mask = (pos < d_lens[:, None]).to(torch.float32)
            pooled = (h * mask[:, :, None]).sum(1)
            # one add per chunk, in work-list order: the sums come out the
            # same on every run (an atomic scatter would not)
            for j, (b, _) in enumerate(batch):
                state.sums[b].add_(pooled[j])
        return state.idx >= len(state.work)

    def embed_finish(self, state: "_EmbedState") -> np.ndarray:
        """Mean-pooled, L2-normalised [inputs, hidden] f32: the one read
        of the pooled sums from the device."""
        with self._on_stream():
            sums = state.sums.cpu().numpy()
        pooled = sums / np.maximum(state.counts, 1.0)[:, None]
        norms = np.linalg.norm(pooled, axis=-1, keepdims=True)
        return pooled / np.maximum(norms, 1e-9)

    def embed_ids(self, ids_list: List[List[int]]) -> np.ndarray:
        """Mean-pooled, L2-normalised final hidden states per input: the
        one-shot form of the incremental API above."""
        state = self.embed_start(ids_list)
        while not self.embed_step(state):
            pass
        return self.embed_finish(state)

    # ------------------------------------------------------------------
    # step clock
    # ------------------------------------------------------------------

    def _clock(self, kind: str, wall_s: float, tokens: int = 0,
               rows: int = 0, dispatches: int = 0) -> None:
        """Attribute one host wall-time segment to a dispatch kind."""
        c = self._sc_kinds[kind]
        c["dispatches"] += dispatches
        c["wall_s"] += wall_s
        c["tokens"] += tokens
        c["rows"] += rows
        self._sc_samples.append((kind, wall_s))
        if len(self._sc_samples) > 4096:
            # a headless engine (tests, tools) must stay bounded too
            del self._sc_samples[:-2048]

    def _event(self, name: str, n: int = 1) -> None:
        if name == "retrace" and self._in_warmup:
            return  # a graph captured at boot, not mid-serving
        self._sc_events[name] = self._sc_events.get(name, 0) + n

    # ------------------------------------------------------------------
    # device plumbing: the engine stream, uploads, CUDA graphs
    # ------------------------------------------------------------------

    def _on_stream(self):
        """Run on the engine's own stream (cuda): eager work, graph
        captures and replays share it, so they run in issue order."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _upload(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """Copy a host array into a device buffer without waiting for the
        device: through pinned memory, non-blocking (the pinned block is
        not reused before its copy has run)."""
        src = torch.from_numpy(arr)
        if dst.device.type == "cuda":
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def _device_array(self, arr: np.ndarray) -> torch.Tensor:
        out = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype,
                          device=self.device)
        self._upload(out, np.ascontiguousarray(arr))
        return out

    def _run(self, key: tuple, body, generator: torch.Generator) -> None:
        """Run ``body`` (which reads and writes only static buffers): as a
        replay of its CUDA graph, captured on first use right after an
        eager run that does this call's work; or eagerly (CPU, or
        ``_graphs=False``)."""
        if not self._use_graphs:
            body()
            return
        g = self._graphs.get(key)
        if g is None:
            body()
            self._capture(key, body, generator)
            return
        g.graph.replay()
        kernels.add_launch_counts(g.counts)

    def _capture(self, key: tuple, body, generator: torch.Generator) -> None:
        """Capture ``body`` as the CUDA graph for ``key`` on the engine
        stream. Sampled modes register ``generator`` with the graph, so
        each replay draws new numbers. Raises on failure (the eager path
        is never taken in its place)."""
        self._event("retrace")
        graph = torch.cuda.CUDAGraph()
        if key[-1] != 0:  # a sampled mode draws from the generator
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    "this PyTorch cannot register a generator with a CUDA "
                    "graph (CUDAGraph.register_generator_state): sampled "
                    "decode blocks cannot be captured")
            graph.register_generator_state(generator)
        # capture on the engine stream (current here) from the shared
        # pool; unlike torch.cuda.graph(), no garbage collection and no
        # emptying of the allocator's cache before each capture
        torch.cuda.synchronize(self.device)
        # only this thread's launches: another replica may be serving on
        # its own thread while this one captures
        with kernels.recording() as counts:
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                body()
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            graph.capture_end()
        kernels.add_launch_counts(counts, -1)  # capture launched nothing
        self._graphs[key] = _Graph(graph, counts)

    def _capture_all(self) -> None:
        """Capture every graph not captured yet (an idle engine: no row is
        live, so the eager run before each capture is fed padding, whose
        writes land in the drop slot)."""
        B = self.ecfg.max_batch
        Bp = self.ecfg.prefill_batch
        idle = np.zeros(self._d_int.shape, np.int32)
        idle[:B] = 1  # every slot overridden: inactive
        for mode in SAMPLE_MODES:
            if ("decode", mode) in self._graphs:
                continue
            self._upload(self._d_int, idle)
            self._run(("decode", mode), functools.partial(
                self._decode_body, mode), self._decode_gen)
        K = self._mixed_block_k()
        for mode in SAMPLE_MODES if self.ecfg.mixed_step_tokens else ():
            if ("mixed", K, mode) in self._graphs:
                continue
            self._upload(self._d_int, idle)
            self._upload(self._m_int, self._mixed_padding())
            self._run(("mixed", K, mode), functools.partial(
                self._mixed_body, mode, K), self._decode_gen)
        for mode in SAMPLE_MODES if self.ecfg.loop_to_completion else ():
            if ("loop", mode) not in self._graphs:
                self._upload(self._d_int, idle)
                self._stage_loop_inputs([], 1)
                self._run_loop(mode)
        for mode in SAMPLE_MODES if self.draft_params is not None else ():
            if self.ecfg.loop_to_completion:
                if ("sloop", mode) not in self._graphs:
                    self._upload(self._d_int, idle)
                    self._stage_loop_inputs([], 1)
                    self._run_loop(mode, spec=True)
            elif ("spec", mode) not in self._graphs:
                self._upload(self._d_int, idle)
                self._run(("spec", mode), functools.partial(
                    self._spec_body, mode), self._decode_gen)
        for b in self.ecfg.prefill_buckets:
            ints = np.zeros(self._p_int[b].shape, np.int32)
            ints[2 * Bp * b:3 * Bp * b] = self._num_slots_flat  # drop
            self._upload(self._p_int[b], ints)
            for mode in SAMPLE_MODES:
                if ("prefill", b, mode) not in self._graphs:
                    self._run(("prefill", b, mode), functools.partial(
                        self._prefill_body, b, mode), self._gen)

    # ------------------------------------------------------------------
    # admission / prefill
    # ------------------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _admit(self, outputs: List[StepOutput]) -> None:
        while self.waiting:
            slot = self._free_slot()
            if slot is None:
                return
            seq = self.waiting[0]
            n = len(seq.token_ids)
            needed_pages = -(-(n + 1) // self.pcfg.page_size)
            if (n + 1 > self.pcfg.max_seq_len
                    or needed_pages > self.pcfg.num_pages):
                self.waiting.popleft()
                self._by_id.pop(seq.request_id, None)
                outputs.append(StepOutput(
                    request_id=seq.request_id, finished=True,
                    error=f"prompt of {n} tokens exceeds the engine "
                          f"capacity ({self.pcfg.max_seq_len} tokens)",
                ))
                continue
            if (seq.next_token is not None and seq.block_table
                    and seq.seq_len >= len(seq.token_ids)):
                # imported (KV handoff): its K/V is already in this
                # engine's pages; seat it straight into the decode carry
                self.waiting.popleft()
                self.slots[slot] = seq
                self._stage_seat(slot, seq)
                continue
            try:
                self._start_prefill(seq)
            except CacheFull:
                self._event("cache_full")
                return  # no pages; retry next step
            except Exception as e:  # failure isolation
                self.waiting.popleft()
                self._by_id.pop(seq.request_id, None)
                self._release_seq(seq)
                outputs.append(StepOutput(
                    request_id=seq.request_id, finished=True, error=str(e)))
                continue
            self.waiting.popleft()
            self.slots[slot] = seq  # seated, prefilling (next_token None)

    def _start_prefill(self, seq: _Seq) -> None:
        """Claim pages for the whole prompt (prefix-shared where possible);
        the compute runs in budgeted quanta (_prefill_quantum)."""
        ps = self.pcfg.page_size
        self._release_seq(seq)
        prompt = seq.token_ids  # after preemption: includes generated ids
        n = len(prompt)
        # match prompt[:-1] so a fully cached prompt still computes >= 1
        # token (its logits give the first sampled token)
        shared_pages, shared_tokens = self.allocator.match_prefix(
            prompt[: n - 1])
        seq.block_table = list(shared_pages)
        seq.seq_len = shared_tokens
        seq.next_token = None
        # host-tier fallthrough: HBM misses may still be warm in host RAM
        if self.host_tier is not None:
            self._host_tier_reload(seq, prompt)
        pages_needed = -(-n // ps) - len(seq.block_table)
        if pages_needed > 0:
            try:
                seq.block_table.extend(self.allocator.allocate(pages_needed))
            except CacheFull:
                self._release_seq(seq)
                raise

    def _prefill_body(self, bucket: int, mode: int) -> None:
        """One prefill chunk over the bucket's static buffers: the forward
        at [prefill_batch, bucket] and each row's first-token sample, into
        ``_p_out[bucket]``."""
        Bp = self.ecfg.prefill_batch
        P = self.pcfg.max_pages_per_seq
        ints, flts = self._p_int[bucket], self._p_flt[bucket]
        n = Bp * bucket
        ids, positions, write_slots = (ints[k * n:(k + 1) * n].view(Bp, bucket)
                                       for k in range(3))
        tables = ints[3 * n:3 * n + Bp * P].view(Bp, P)
        kv_valid = ints[3 * n + Bp * P:3 * n + Bp * P + Bp]
        last_idx = ints[3 * n + Bp * P + Bp:]
        logits, _, _ = llama.paged_forward(
            self.params, self.cfg, ids, positions, self.state.k,
            self.state.v, write_slots, tables, kv_valid,
            impl=self.ecfg.attention_impl, page_size=self.pcfg.page_size,
            logits_idx=last_idx)
        if self.draft_params is not None:
            # the draft prefills the same chunk into its own pool (same
            # slots); its logits are never read, so only last_idx is
            # unembedded
            llama.paged_forward(
                self.draft_params, self.draft_cfg, ids, positions,
                self.draft_state.k, self.draft_state.v, write_slots, tables,
                kv_valid, impl=self.ecfg.attention_impl,
                page_size=self.pcfg.page_size, logits_idx=last_idx)
        last = logits[:, 0]
        toks = _sample(last, flts[:Bp], flts[Bp:], self._gen, mode)
        out = self._p_out[bucket]
        out[0].copy_(toks.float())
        out[1].copy_(_chosen_logprob(last, toks))

    def _prefill_quantum(self, outputs: List[StepOutput]) -> None:
        """Run up to ``prefill_token_budget`` prefill tokens: chunks of up
        to ``prefill_batch`` prompts share one forward per length bucket.
        Every chunk is issued before any first token is read back; prompts
        whose last chunk ran sample their first token on the device and
        are staged into the decode carry."""
        sc_t0 = time.monotonic()
        sc_tokens = sc_rows = sc_disp = 0
        budget = self.ecfg.prefill_token_budget
        Bp = self.ecfg.prefill_batch
        ps = self.pcfg.page_size
        P = self.pcfg.max_pages_per_seq
        dispatched = []
        thr = self._cp_threshold()
        if thr is not None:
            # at most ONE sequence-parallel prefill a step, and it takes
            # the step's whole prefill budget: seated rows get a decode
            # block between long-prompt admissions
            for slot, s in enumerate(self.slots):
                if (s is not None and s.next_token is None
                        and len(s.token_ids) >= thr):
                    remaining = len(s.token_ids) - s.seq_len
                    try:
                        self._cp_prefill_seq(slot, s, outputs)
                        sc_tokens += remaining
                        sc_rows += 1
                        sc_disp += 1
                    except Exception as e:  # failure isolation
                        self.slots[slot] = None
                        self._by_id.pop(s.request_id, None)
                        self._release_seq(s)
                        outputs.append(StepOutput(
                            request_id=s.request_id, finished=True,
                            error=str(e)))
                    budget = 0
                    break
        while budget > 0:
            group = [(i, s) for i, s in enumerate(self.slots)
                     if s is not None and _mid_prefill(s)
                     and (thr is None or len(s.token_ids) < thr)][:Bp]
            if not group:
                break
            bucket = self._pick_bucket(max(
                len(s.token_ids) - s.seq_len for _, s in group))
            n = Bp * bucket
            ints = np.zeros((3 * n + Bp * P + 2 * Bp,), np.int32)
            ids, positions, write_slots = (
                ints[k * n:(k + 1) * n].reshape(Bp, bucket) for k in range(3))
            tables = ints[3 * n:3 * n + Bp * P].reshape(Bp, P)
            kv_valid = ints[3 * n + Bp * P:3 * n + Bp * P + Bp]
            last_idx = ints[3 * n + Bp * P + Bp:]
            write_slots[:] = self._num_slots_flat
            flts = np.ones((2 * Bp,), np.float32)  # temperature, top-p
            chunk_lens: List[int] = []
            for j, (_, s) in enumerate(group):
                start = s.seq_len
                t = min(len(s.token_ids) - start, bucket)
                chunk_lens.append(t)
                ids[j, :t] = s.token_ids[start : start + t]
                positions[j] = np.arange(start, start + bucket,
                                         dtype=np.int32)
                table = np.asarray(s.block_table[:P], np.int32)
                tables[j, : len(table)] = table
                pos = positions[j, :t]
                page = pos // ps
                ok = page < len(table)
                write_slots[j, :t] = np.where(
                    ok, table[np.minimum(page, max(len(table) - 1, 0))] * ps
                    + pos % ps, self._num_slots_flat)
                kv_valid[j] = start + t
                last_idx[j] = t - 1
                flts[j] = s.params.temperature
                flts[Bp + j] = s.params.top_p
            self._upload(self._p_int[bucket], ints)
            self._upload(self._p_flt[bucket], flts)
            mode = _sample_mode([s for _, s in group])
            self._run(("prefill", bucket, mode), functools.partial(
                self._prefill_body, bucket, mode), self._gen)
            # the next chunk of this bucket overwrites the static output
            res = self._p_out[bucket].clone()
            budget -= Bp * bucket
            sc_tokens += sum(chunk_lens)
            sc_rows += len(group)
            sc_disp += 1
            done: List[bool] = []
            for j, (_, s) in enumerate(group):
                s.seq_len += chunk_lens[j]
                done.append(s.seq_len >= len(s.token_ids))
            dispatched.append((res, list(group), done))

        # reap: one read per chunk that finished a prompt
        for res, group, done in dispatched:
            if not any(done):
                continue
            both = res.cpu().numpy()
            self._reap_first_tokens(group, done, both[0], both[1], outputs)
        if sc_disp:
            self._clock("prefill", time.monotonic() - sc_t0,
                        tokens=sc_tokens, rows=sc_rows, dispatches=sc_disp)

    def _reap_first_tokens(self, group, done, toks, lps,
                           outputs: List[StepOutput]) -> None:
        """Emit the first sampled token of every prompt in ``group`` whose
        prefill completed (``done[j]``) and stage it for decode. ``toks``
        and ``lps`` are host arrays indexed like ``group``."""
        for j, (slot, s) in enumerate(group):
            if not done[j] or self._by_id.get(s.request_id) is not s:
                continue
            try:
                self._emit_token(s, int(toks[j]), outputs, float(lps[j]))
            except Exception as e:  # failure isolation
                self.slots[slot] = None
                self._by_id.pop(s.request_id, None)
                self._release_seq(s)
                outputs.append(StepOutput(
                    request_id=s.request_id, finished=True, error=str(e)))
                continue
            if self._by_id.get(s.request_id) is s:
                if s.prefill_only:
                    # the handoff point (quantum and mixed paths alike):
                    # the first token is out; free the slot, keep the
                    # pages for export_handoff
                    self.slots[slot] = None
                    self._handoff_ready[s.request_id] = s
                else:
                    self._stage_seat(slot, s)

    # ------------------------------------------------------------------
    # sequence-parallel prefill: the long-prompt path on a seq mesh axis
    # ------------------------------------------------------------------

    def _cp_threshold(self) -> Optional[int]:
        """Prompt length from which the prefill runs sequence-parallel over
        the ``seq`` axis (None: no seq axis, or Ulysses on a stage mesh,
        which takes the chunked prefill as in the JAX engine)."""
        if self.mesh is None or self.mesh.shape["seq"] <= 1:
            return None
        if self.mesh.shape["stage"] > 1 and self.ecfg.sp_impl != "ring":
            return None
        if self.ecfg.cp_min_tokens is not None:
            return self.ecfg.cp_min_tokens
        return self.ecfg.prefill_buckets[-1] + 1

    def _cp_bucket(self, n: int) -> int:
        """The prompt buffer of a sequence-parallel prefill: a power of two
        (at least 16 and the axis size), an exact multiple of the axis for
        other sizes, clamped to the longest admissible prompt."""
        seq_ax = self.mesh.shape["seq"]
        cap = -(-self.pcfg.max_seq_len // seq_ax) * seq_ax
        b = max(16, seq_ax)
        while b < n:
            b *= 2
        if b % seq_ax:
            b = -(-n // seq_ax) * seq_ax
        return min(b, max(cap, -(-n // seq_ax) * seq_ax))

    def _cp_prefill_seq(self, slot: int, s: _Seq,
                        outputs: List[StepOutput]) -> None:
        """Prefill one long prompt in one sequence-parallel pass (ring or
        Ulysses over ``seq``, ``parallel/cp.py``), its K/V written into its
        pages (the draft's too), sample the first token and seat it for
        decode. The whole prompt runs from position 0: prefix-shared pages
        are rewritten with the same contents. Eager, as every prompt
        length is its own shape."""
        from distributed_inference_server_tpu_torch.parallel.cp import (
            cp_paged_prefill_any,
        )

        n = len(s.token_ids)
        T = self._cp_bucket(n)
        ps = self.pcfg.page_size
        ids = np.zeros((1, T), np.int32)
        ids[0, :n] = s.token_ids
        pos = np.arange(T)
        table = np.asarray(s.block_table, np.int64)
        page = pos // ps
        ok = (pos < n) & (page < len(table))
        write = np.where(ok, table[np.minimum(page, len(table) - 1)] * ps
                         + pos % ps, self._num_slots_flat)[None]
        d_ids = self._device_array(ids)
        d_valid = self._device_array(np.array([n], np.int32))
        d_write = self._device_array(write.astype(np.int64))
        impl = self.ecfg.attention_impl
        logits, _, _ = cp_paged_prefill_any(
            self.params, self.cfg, self.mesh, d_ids, d_valid, self.state.k,
            self.state.v, d_write, self.ecfg.sp_impl, impl)
        if self.draft_params is not None:
            cp_paged_prefill_any(
                self.draft_params, self.draft_cfg, self.mesh, d_ids, d_valid,
                self.draft_state.k, self.draft_state.v, d_write,
                self.ecfg.sp_impl, impl)
        mode = _sample_mode([s])
        flts = self._device_array(np.array(
            [s.params.temperature, s.params.top_p], np.float32))
        toks = _sample(logits, flts[:1], flts[1:], self._gen, mode)
        lps = _chosen_logprob(logits, toks)
        s.seq_len = n
        both = torch.stack([toks.float(), lps]).cpu().numpy()
        self._reap_first_tokens([(slot, s)], [True], both[0], both[1],
                                outputs)

    def _pick_bucket(self, remaining: int) -> int:
        for b in self.ecfg.prefill_buckets:
            if remaining <= b:
                return b
        return self.ecfg.prefill_buckets[-1]

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _stage_seat(self, slot: int, seq: _Seq) -> None:
        """Stage a freshly prefilled sequence into a decode slot: its first
        sampled token, position and step budget are merged into the carry
        at the next block launch."""
        budget = max(0, min(
            seq.params.max_tokens - seq.emitted_tokens,
            self.pcfg.max_seq_len - 1 - seq.seq_len,
        ))
        seq.dev_pos = seq.seq_len
        seq.dev_steps_left = budget
        self._slot_updates[slot] = (True, int(seq.next_token), seq.seq_len,
                                    budget)
        self._temp[slot] = seq.params.temperature
        self._topp[slot] = seq.params.top_p
        self._bt_pages[slot] = 0
        self._refresh_bt_row(slot, seq)

    def _deact_slot(self, slot: int) -> None:
        self._slot_updates[slot] = (False, 0, 0, 0)

    def _refresh_bt_row(self, slot: int, seq: _Seq) -> None:
        table = seq.block_table[: self.pcfg.max_pages_per_seq]
        start = int(self._bt_pages[slot])
        if start > len(table):
            start = 0
        for p in range(start, len(table)):
            self._bt[slot, p] = table[p]
        self._bt_pages[slot] = len(table)

    def _assumed_adv(self, seq: _Seq, use_spec: bool = False) -> int:
        """Upper bound on the positions this sequence writes in one block
        (the page pre-allocation and projection unit). Plain blocks: with
        blocks in flight the projection (dev_pos, dev_steps_left) is exact
        for the device row, which freezes once its steps run out, so a
        projection at or below zero steps writes nothing more.

        Speculative blocks (the reference's rule): R rounds write up to
        R * (gamma + 1) positions, and a round may overshoot the budget by
        gamma before the row freezes. With blocks in flight the projection
        is an upper bound on the device position but only a LOWER bound on
        its remaining steps (a round emits fewer tokens than assumed
        whenever a proposal is rejected; the reconcile restores
        exactness). dev_pos + dev_steps_left is conserved, so the next
        block's last write is below min(dev_pos + R * (gamma + 1),
        dev_pos + dev_steps_left + gamma): the bound must not floor at
        dev_steps_left <= 0 while a block is pending, or a still-active
        device row writes past its pages into another sequence's KV."""
        if use_spec:
            if seq.dev_steps_left <= 0 and not self._pending:
                return 0  # host view exact: the row is frozen
            gamma = self.spec.num_draft_tokens
            return max(0, min(self.ecfg.decode_block_size * (gamma + 1),
                              seq.dev_steps_left + gamma))
        return max(0, min(self.ecfg.decode_block_size, seq.dev_steps_left))

    def _ensure_block_pages(self, seq: _Seq, steps: int) -> None:
        """Pre-allocate pages covering positions dev_pos ..
        dev_pos + steps - 1. Raises CacheFull."""
        if steps <= 0:
            return
        needed = (seq.dev_pos + steps - 1) // self.pcfg.page_size + 1
        missing = (min(needed, self.pcfg.max_pages_per_seq)
                   - len(seq.block_table))
        if missing > 0:
            seq.block_table.extend(self.allocator.allocate(missing))

    def _maybe_launch(self, outputs: List[StepOutput]) -> bool:
        """Launch one decode block if a seated row has budget left or a
        host override is staged. Under page pressure the pending blocks
        are drained first (finished rows release pages), then the
        youngest sequence is preempted until the block's pages fit.
        Returns whether a block was launched."""
        sc_t0 = time.monotonic()
        sc_excl = 0.0  # drained frames clock their own processing
        while True:
            seated = [(i, s) for i, s in enumerate(self.slots)
                      if s is not None]
            if not any(u[0] for u in self._slot_updates.values()) and not any(
                    s.dev_steps_left > 0 for _, s in seated):
                return False
            use_spec, spec_ok = self._spec_plan(seated)
            for _, s in seated:
                self._reclaim_window_pages(s)
            # spec_ok False rows of a spec launch take the spec bound too:
            # the verify forward writes gamma + 1 positions a round for
            # every active row
            advs = {id(s): self._assumed_adv(s, use_spec) for _, s in seated}
            try:
                for _, s in seated:
                    self._ensure_block_pages(s, advs[id(s)])
                break
            except CacheFull:
                self._event("cache_full")
                if self._pending:
                    drain_t0 = time.monotonic()
                    self._drain_pending(outputs)
                    sc_excl += time.monotonic() - drain_t0
                    continue
                if seated:
                    self._preempt_youngest(outputs)
                    continue
                return False
        for i, s in seated:
            if self._bt_pages[i] != len(s.block_table):
                self._refresh_bt_row(i, s)
        self._launch(seated, advs, spec_ok if use_spec else None)
        for _, s in seated:
            adv = advs[id(s)]
            # no floor: negatives reconcile exactly when the block is read
            s.dev_pos += adv
            s.dev_steps_left -= adv
        self._clock("decode_block",
                    max(0.0, time.monotonic() - sc_t0 - sc_excl),
                    rows=len(seated), dispatches=1)
        return True

    def _stage_decode_inputs(self) -> None:
        """Upload the staged carry overrides (admissions and
        deactivations), the block tables and the sampling parameters into
        the decode block's static buffers: one copy each."""
        B = self.ecfg.max_batch
        ints = np.zeros(self._d_int.shape, np.int32)
        for slot, (act, tok, pos, steps) in self._slot_updates.items():
            ints[slot] = 1
            ints[B + slot] = act
            ints[2 * B + slot] = tok
            ints[3 * B + slot] = pos
            ints[4 * B + slot] = steps
        self._slot_updates.clear()
        ints[5 * B:] = self._bt.reshape(-1)
        self._upload(self._d_int, ints)
        self._upload(self._d_flt, np.concatenate([self._temp, self._topp]))

    def _merged_carry(self) -> Tuple[torch.Tensor, ...]:
        """The device decode carry (tokens, positions, steps_left, active)
        with the staged overrides merged in; shared by the decode block and
        the mixed step."""
        B = self.ecfg.max_batch
        ints = self._d_int
        mask = ints[:B] != 0
        tokens, positions, steps_left, active = self._carry
        return (torch.where(mask, ints[2 * B:3 * B], tokens),
                torch.where(mask, ints[3 * B:4 * B], positions),
                torch.where(mask, ints[4 * B:5 * B], steps_left),
                torch.where(mask, ints[B:2 * B] != 0, active))

    def _store_carry(self, *new: torch.Tensor) -> None:
        for buf, t in zip(self._carry, new):
            buf.copy_(t)

    def _decode_step(self, tokens, positions, steps_left, active, tables,
                     temp, top_p, mode: int, key=None):
        """One decode step of the K-step block's math over [B, P] block
        ``tables``: the model step with on-device sampling (from the
        decode generator, or from ``counter_uniform`` under ``key``), EOS
        masking and the per-row budget. Returns the step's tokens (-1 =
        frozen row), their log-probabilities, the EOS mask and the new
        (tokens, positions, steps_left, active)."""
        B = self.ecfg.max_batch
        P = self.pcfg.max_pages_per_seq
        ps = self.pcfg.page_size
        rows = torch.arange(B, device=self.device)
        page = tables[rows, (positions // ps).clamp(max=P - 1)]
        write = torch.where(active, page * ps + positions % ps,
                            torch.full_like(positions, self._num_slots_flat))
        kv_valid = torch.where(active, positions + 1,
                               torch.zeros_like(positions))
        logits, _, _ = llama.paged_forward(
            self.params, self.cfg, tokens[:, None], positions[:, None],
            self.state.k, self.state.v, write[:, None], tables, kv_valid,
            impl=self.ecfg.attention_impl, page_size=ps,
        )
        last = logits[:, 0]
        nxt = _sample(last, temp, top_p, self._decode_gen, mode, key)
        lp = _chosen_logprob(last, nxt)
        out = torch.where(active, nxt, torch.full_like(nxt, -1))
        is_eos = (nxt[:, None] == self._eos[None, :]).any(-1)
        positions = torch.where(active, positions + 1, positions)
        steps_left = torch.where(active, steps_left - 1, steps_left)
        tokens = torch.where(active, nxt, tokens)
        active = active & ~is_eos & (steps_left > 0)
        return out, lp, is_eos, tokens, positions, steps_left, active

    def _decode_body(self, mode: int) -> None:
        """The K-step decode block over the static buffers: K model steps
        with on-device sampling, EOS masking, per-row budgets and
        block-table slot arithmetic; the [2, K, B] tokens (-1 = frozen
        row) and log-probabilities go to ``_d_out``, the carry is updated
        in place."""
        B = self.ecfg.max_batch
        P = self.pcfg.max_pages_per_seq
        carry = self._merged_carry()
        block_tables = self._d_int[5 * B:].view(B, P)
        temp, top_p = self._d_flt[:B], self._d_flt[B:]
        outs, lps = [], []
        for _ in range(self.ecfg.decode_block_size):
            out, lp, _, *carry = self._decode_step(
                *carry, block_tables, temp, top_p, mode)
            outs.append(out)
            lps.append(lp)
        self._store_carry(*carry)
        # token ids are exact in f32 (vocab < 2**24): one tensor, one read
        self._d_out[0].copy_(torch.stack(outs).float())
        self._d_out[1].copy_(torch.stack(lps))

    def _launch(self, seated: List[Tuple[int, _Seq]],
                advs: Dict[int, int],
                spec_ok: Optional[Dict[int, bool]] = None) -> None:
        """Issue one decode block (a speculative one when ``spec_ok`` is
        given) and queue its result: a non-blocking copy into pinned host
        memory behind an event (a CPU copy on the CPU), with the launch
        snapshot."""
        self._stage_decode_inputs()
        mode = _sample_mode([s for _, s in seated])
        snapshot = [(i, s, advs[id(s)]) for i, s in seated]
        if spec_ok is not None:
            self._stage_spec_ok(seated, spec_ok)
            self._run(("spec", mode), functools.partial(self._spec_body,
                                                        mode),
                      self._decode_gen)
            self._pending.append((*self._read_later(self._s_out), snapshot,
                                  "decode_block"))
            return
        self._run(("decode", mode), functools.partial(self._decode_body,
                                                      mode), self._decode_gen)
        self._pending.append((*self._read_later(self._d_out), snapshot,
                              "decode_block"))

    # ------------------------------------------------------------------
    # speculative blocks
    # ------------------------------------------------------------------

    def _spec_plan(self, seated: List[Tuple[int, "_Seq"]]
                   ) -> Tuple[bool, Optional[Dict[int, bool]]]:
        """Per-launch speculation plan: ``(use_spec, ok_by_slot)``, a
        seated row speculating iff its request pattern's tracker is
        enabled. A launch whose rows are all on disabled patterns takes
        the plain block; a mixed one masks the disabled rows (one target
        token a round, no acceptance statistics). Engine thread: it owns
        the probation re-enable."""
        if self.spec_trackers is None:
            return False, None
        ok: Dict[int, bool] = {}
        for i, s in seated:
            ok[i] = self.spec_trackers.consume_probation(
                spec_signature(s.params))
        return any(ok.values()), ok

    def _stage_spec_ok(self, seated, spec_ok: Dict[int, bool]) -> None:
        ok = np.zeros((self.ecfg.max_batch,), np.int32)
        for i, _ in seated:
            ok[i] = spec_ok.get(i, True)
        self._upload(self._s_ok, ok)

    def _spec_round(self, tokens, positions, steps_left, active, tables,
                    mode: int, key=None):
        """One speculative round over [B, P] block ``tables`` (the JAX
        ``_build_spec_block`` round): gamma + 1 draft decodes over the
        draft pool (the last only writes d_gamma's K/V), ONE target verify
        forward over [last, d_1..d_gamma] at T = gamma + 1, then
        acceptance and resampling, EOS truncation and the budget freeze.
        Writes at or past capacity go to the drop slot. Random draws come
        from the decode generator, or from ``counter_uniform`` under
        ``key`` (looped blocks); greedy launches (mode 0) draw nothing.
        Returns the round's [B, W] tokens (-1 = not emitted) and
        log-probabilities, [B] emitted / accepted / proposed counts, and
        the new (tokens, positions, steps_left, active)."""
        B = self.ecfg.max_batch
        P = self.pcfg.max_pages_per_seq
        ps = self.pcfg.page_size
        smax = self.pcfg.max_seq_len
        gamma = self.spec.num_draft_tokens
        W = gamma + 1
        V = self.cfg.vocab_size
        dev = self.device
        impl = self.ecfg.attention_impl
        temp, top_p = self._d_flt[:B], self._d_flt[B:]
        spec_ok = self._s_ok != 0
        rows = torch.arange(B, device=dev)
        drop = torch.full_like(positions, self._num_slots_flat)
        zero = torch.zeros_like(positions)
        noise = None
        if key is not None and mode:
            noise = counter_uniform((gamma + 2, B, V), key)
        # ---- draft: gamma proposals, one T = 1 step each ----
        dtoks, dqs = [], []
        tok, pos = tokens, positions
        for i in range(W):
            page = tables[rows, (pos // ps).clamp(max=P - 1)]
            write = torch.where(active & (pos < smax), page * ps + pos % ps,
                                drop)
            kv_valid = torch.where(active, (pos + 1).clamp(max=smax), zero)
            logits, _, _ = llama.paged_forward(
                self.draft_params, self.draft_cfg, tok[:, None],
                pos[:, None], self.draft_state.k, self.draft_state.v,
                write[:, None], tables, kv_valid, impl=impl, page_size=ps)
            if i == gamma:
                break  # the last step only writes d_gamma's K/V
            q = spec_probs(logits[:, 0], temp)
            if mode == 2:
                # proposals come from the same q~ the verifier scores
                q = nucleus_probs(q, top_p)
            if mode == 0:
                nxt = torch.argmax(q, dim=-1).to(torch.int32)
            else:
                nxt = categorical(q, self._decode_gen,
                                  None if noise is None else noise[i])
            dtoks.append(nxt)
            dqs.append(q)
            tok, pos = nxt, pos + 1
        draft_toks = torch.stack(dtoks, 1)
        draft_qs = torch.stack(dqs, 1)
        # ---- target: one verify forward over [last, d_1..d_gamma] ----
        ver_pos = positions[:, None] + torch.arange(
            W, dtype=positions.dtype, device=dev)[None]
        vpage = tables[rows[:, None], (ver_pos // ps).clamp(max=P - 1)]
        write = torch.where(active[:, None] & (ver_pos < smax),
                            vpage * ps + ver_pos % ps,
                            torch.full_like(ver_pos, self._num_slots_flat))
        kv_valid = torch.where(active, (positions + W).clamp(max=smax), zero)
        logits, _, _ = llama.paged_forward(
            self.params, self.cfg,
            torch.cat([tokens[:, None], draft_toks], 1), ver_pos,
            self.state.k, self.state.v, write, tables, kv_valid, impl=impl,
            page_size=ps)
        x32 = logits.float()
        lse = torch.logsumexp(x32, dim=-1)  # [B, W]
        u = None
        if noise is not None:
            u = noise[gamma][:, :gamma]
        toks_out, num_acc = accept_and_resample(
            spec_probs(x32, temp[:, None]), draft_toks, draft_qs,
            self._decode_gen, spec_ok=spec_ok,
            top_p=top_p if mode == 2 else None, greedy_only=mode == 0, u=u,
            noise=None if noise is None else noise[gamma + 1])
        idx = torch.arange(W, device=dev)[None]
        base = num_acc + 1
        is_eos = ((toks_out[..., None] == self._eos[None, None, :]).any(-1)
                  & (idx < base[:, None]))
        has_eos = is_eos.any(-1)
        first_eos = torch.argmax(is_eos.to(torch.int32), dim=-1)
        emitted = torch.where(has_eos, torch.minimum(base, first_eos + 1),
                              base)
        emitted = torch.where(active, emitted, zero)
        ok = active & spec_ok
        acc = torch.where(ok, num_acc, zero)
        prop = torch.where(ok, torch.full_like(num_acc, gamma), zero)
        toks_out = torch.where((idx < emitted[:, None]) & active[:, None],
                               toks_out, torch.full_like(toks_out, -1))
        lp_out = (x32.gather(-1, toks_out.clamp(min=0).long()[..., None])
                  [..., 0] - lse)
        new_last = toks_out[rows, (emitted.clamp(min=1) - 1).long()]
        tokens = torch.where(active & (emitted > 0), new_last, tokens)
        positions = positions + emitted
        steps_left = steps_left - emitted
        active = active & ~has_eos & (steps_left > 0)
        return (toks_out, lp_out, emitted, acc, prop,
                (tokens, positions, steps_left, active))

    def _spec_pack(self, out: torch.Tensor, R: int, k, toks, lps, emitted,
                   acc, prop) -> None:
        """Write round ``k`` (an int, or a one-element device index) into
        a flat spec output buffer of R rounds (layout at ``_s_out``)."""
        B = self.ecfg.max_batch
        W = self.spec.num_draft_tokens + 1
        n = R * B * W
        parts = (out[:n].view(R, B, W), out[n:2 * n].view(R, B, W),
                 out[2 * n:2 * n + R * B].view(R, B),
                 out[2 * n + R * B:2 * n + 2 * R * B].view(R, B),
                 out[2 * n + 2 * R * B:].view(R, B))
        vals = (toks.float(), lps, emitted.float(), acc.float(),
                prop.float())
        for dst, v in zip(parts, vals):
            if isinstance(k, int):
                dst[k].copy_(v)
            else:
                dst.index_copy_(0, k, v[None])

    def _spec_unpack(self, flat: np.ndarray, R: int):
        """(tokens [R, B, W] int, log-probabilities [R, B, W], emitted,
        accepted, proposed [R, B] int) of a host spec output buffer."""
        B = self.ecfg.max_batch
        W = self.spec.num_draft_tokens + 1
        n = R * B * W
        ints = lambda a: np.rint(a).astype(np.int64)  # noqa: E731
        return (ints(flat[:n].reshape(R, B, W)),
                flat[n:2 * n].reshape(R, B, W),
                ints(flat[2 * n:2 * n + R * B].reshape(R, B)),
                ints(flat[2 * n + R * B:2 * n + 2 * R * B].reshape(R, B)),
                ints(flat[2 * n + 2 * R * B:].reshape(R, B)))

    def _spec_body(self, mode: int) -> None:
        """The speculative decode block over the static buffers: the
        staged carry overrides merged, R = decode_block_size rounds, each
        round's outputs into ``_s_out``, the carry updated in place."""
        B = self.ecfg.max_batch
        P = self.pcfg.max_pages_per_seq
        R = self.ecfg.decode_block_size
        carry = self._merged_carry()
        tables = self._d_int[5 * B:].view(B, P)
        for k in range(R):
            *res, carry = self._spec_round(*carry, tables, mode)
            self._spec_pack(self._s_out, R, k, *res)
        self._store_carry(*carry)

    def _record_acceptance(self, acc: np.ndarray, prop: np.ndarray,
                           snapshot) -> None:
        """Per-pattern acceptance from a spec frame's [R, B] accepted and
        proposed counts: each seated row's rounds update its own request
        pattern's tracker (masked and inactive rows proposed nothing)."""
        agg: Dict[tuple, List[int]] = {}
        for entry in snapshot:
            slot, seq = entry[0], entry[1]
            p = int(prop[:, slot].sum())
            if p <= 0:
                continue
            a = agg.setdefault(spec_signature(seq.params), [0, 0, 0])
            a[0] += int(acc[:, slot].sum())
            a[1] += p
            a[2] += int((prop[:, slot] > 0).sum())
        t = self._spec_totals
        t["blocks"] += 1
        for sig, (acc_n, prop_n, rows_n) in agg.items():
            self.spec_trackers.update(sig, acc_n, prop_n, rows=rows_n)
            t["accepted"] += acc_n
            t["proposed"] += prop_n
            t["row_rounds"] += rows_n

    def _walk_spec_frame(self, flat: np.ndarray, snapshot,
                         outputs: List[StepOutput]) -> int:
        R = self.ecfg.decode_block_size
        toks, lps, counts, acc, prop = self._spec_unpack(flat, R)
        self._record_acceptance(acc, prop, snapshot)
        return self._walk_block(toks, lps, snapshot, outputs, counts)

    def _read_later(self, t: torch.Tensor) -> Tuple[torch.Tensor, object]:
        """(host copy of ``t``, event to wait on before reading it)."""
        if self.device.type != "cuda":
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return host, ev

    def _drain_pending(self, outputs: List[StepOutput]) -> None:
        """Process every in-flight block. Afterwards the host view is exact
        (device position == seq.seq_len for every live row), which
        preemption requires."""
        while self._pending:
            self._process_block(outputs)

    def _process_block(self, outputs: List[StepOutput]) -> None:
        """Walk the oldest pending block's tokens once its copy is in (the
        only wait on the device), then reconcile each row's projected
        advance with what it emitted."""
        sc_t0 = time.monotonic()
        host, ev, snapshot, kind = self._pending.popleft()
        if ev is not None:
            ev.synchronize()
        both = host.numpy() if isinstance(host, torch.Tensor) else host
        if both.ndim == 1:  # a speculative block's flat frame
            emitted = self._walk_spec_frame(both, snapshot, outputs)
        else:
            emitted = self._walk_block(both[0], both[1], snapshot, outputs)
        self._clock(kind, time.monotonic() - sc_t0,
                    tokens=emitted if kind == "decode_block" else 0)

    def _walk_block(self, toks: np.ndarray, lps: np.ndarray, snapshot,
                    outputs: List[StepOutput],
                    counts: Optional[np.ndarray] = None) -> int:
        """Emit a block's host-side tokens row by row, then reconcile each
        row's projected advance with what it emitted: [K, B] tokens (-1 =
        frozen row) and log-probabilities, or a speculative block's
        [R, B, W] with ``counts`` [R, B] tokens emitted per round (0 = the
        row was frozen). Returns the tokens emitted."""
        if counts is None:
            toks, lps = toks[:, :, None], lps[:, :, None]
            counts = (toks[:, :, 0] >= 0).astype(np.int32)
        R = toks.shape[0]
        total = 0
        for slot, seq, assumed in snapshot:
            if self._by_id.get(seq.request_id) is not seq:
                continue  # finished or aborted meanwhile
            emitted_here = 0
            try:
                done = False
                for k in range(R):
                    c = int(counts[k, slot])
                    if c <= 0:
                        break  # row frozen on the device
                    for w in range(c):
                        t = int(toks[k, slot, w])
                        if t < 0:
                            break
                        seq.token_ids.append(seq.next_token)
                        seq.seq_len += 1
                        emitted_here += 1
                        self._emit_token(seq, t, outputs,
                                         float(lps[k, slot, w]))
                        if self._by_id.get(seq.request_id) is not seq:
                            # finished (stop sequences are host-only):
                            # the device row may still be live
                            self._deact_slot(slot)
                            done = True
                            break
                    if done:
                        break
            except Exception as e:  # failure isolation
                if self.slots[slot] is seq:
                    self.slots[slot] = None
                self._deact_slot(slot)
                self._by_id.pop(seq.request_id, None)
                self._release_seq(seq)
                outputs.append(StepOutput(
                    request_id=seq.request_id, finished=True, error=str(e)))
                continue
            total += emitted_here
            if self._by_id.get(seq.request_id) is seq:
                delta = assumed - emitted_here
                seq.dev_pos -= delta
                seq.dev_steps_left += delta
        return total

    # ------------------------------------------------------------------
    # ragged mixed step
    # ------------------------------------------------------------------

    def _mixed_padding(self) -> np.ndarray:
        """The mixed step's int32 inputs with no prefill token: tok_row -1
        and every write into the drop slot."""
        Sp = self.ecfg.mixed_step_tokens - self.ecfg.max_batch
        ints = np.zeros(self._m_int.shape, np.int32)
        ints[2 * Sp:3 * Sp] = -1
        ints[3 * Sp:4 * Sp] = self._num_slots_flat
        return ints

    def _mixed_body(self, mode: int, K: int) -> None:
        """One ragged mixed dispatch over the static buffers: the staged
        carry overrides merged, one packed forward over [decode rows |
        prefill chunks | padding], every active decode row and each
        chunk-final token sampled, the decode carry advanced one token;
        with K > 1 (the K-block form) K - 1 more steps of the decode
        block's math over the decode rows' tables. Writes the [K, B]
        decode ids (-1 = frozen row) and the [Bp] first-token candidates,
        with their log-probabilities, to ``_m_out``."""
        B = self.ecfg.max_batch
        P = self.pcfg.max_pages_per_seq
        ps = self.pcfg.page_size
        Sp = self.ecfg.mixed_step_tokens - B
        Bp = min(self.ecfg.prefill_batch, Sp)
        m = self._m_int
        p_ids, p_pos, p_row, p_write = (m[k * Sp:(k + 1) * Sp]
                                        for k in range(4))
        p_valid = m[4 * Sp:4 * Sp + Bp]
        p_last = m[4 * Sp + Bp:4 * Sp + 2 * Bp]
        p_tables = m[4 * Sp + 2 * Bp:].view(Bp, P)
        d_tables = self._d_int[5 * B:].view(B, P)
        temp, top_p = self._d_flt[:B], self._d_flt[B:]
        tokens, positions, steps_left, active = self._merged_carry()
        rows = torch.arange(B, device=self.device)
        page = d_tables[rows, (positions // ps).clamp(max=P - 1)]
        none = torch.full_like(positions, -1)
        write = torch.where(active, page * ps + positions % ps,
                            torch.full_like(positions, self._num_slots_flat))
        logits, _, _ = llama.ragged_paged_forward(
            self.params, self.cfg,
            torch.cat([tokens, p_ids])[None],
            torch.cat([positions, p_pos])[None],
            self.state.k, self.state.v, torch.cat([write, p_write])[None],
            torch.cat([torch.where(active, rows.int(), none), p_row]),
            torch.cat([d_tables, p_tables]),
            torch.cat([torch.where(active, positions + 1, none + 1),
                       p_valid]),
            torch.cat([rows, p_last.long()]),
            impl=self.ecfg.attention_impl, page_size=ps,
        )  # [B + Bp, V]
        nxt = _sample(logits, torch.cat([temp, self._m_flt[:Bp]]),
                      torch.cat([top_p, self._m_flt[Bp:]]),
                      self._decode_gen, mode)
        lps = _chosen_logprob(logits, nxt)
        d_next = nxt[:B]
        outs, d_lps = [torch.where(active, d_next, none)], [lps[:B]]
        steps_left = torch.where(active, steps_left - 1, steps_left)
        carry = [torch.where(active, d_next, tokens),
                 torch.where(active, positions + 1, positions),
                 steps_left,
                 active & ~(d_next[:, None] == self._eos[None, :]).any(-1)
                 & (steps_left > 0)]
        for _ in range(K - 1):
            out, lp, _, *carry = self._decode_step(
                *carry, d_tables, temp, top_p, mode)
            outs.append(out)
            d_lps.append(lp)
        self._store_carry(*carry)
        out = self._m_out
        out[0, :K * B].copy_(torch.stack(outs).float().reshape(-1))
        out[1, :K * B].copy_(torch.stack(d_lps).reshape(-1))
        out[0, K * B:].copy_(nxt[B:].float())
        out[1, K * B:].copy_(lps[B:])

    def _mixed_step(self, outputs: List[StepOutput]) -> bool:
        """One ragged mixed dispatch: every seated decode row advances one
        token from the device carry (K = decode_block_size tokens under
        ``loop_to_completion``) while up to ``prefill_batch`` loading
        prompts pack exact-length chunks (no bucket padding) into the rest
        of the budget. Under page pressure the pending blocks are drained
        first, then the youngest sequence is preempted until the decode
        rows' pages fit. The packed layout is decode slots 0..B-1
        (inactive ones -1 in ``tok_row``), then the chunks back to back,
        then padding. The first tokens of finished prompts are emitted at
        once; the [K, B] decode frame joins the pending blocks."""
        sc_t0 = time.monotonic()
        sc_excl = 0.0
        S = self.ecfg.mixed_step_tokens
        B = self.ecfg.max_batch
        Sp = S - B
        Bp = min(self.ecfg.prefill_batch, Sp)
        ps = self.pcfg.page_size
        P = self.pcfg.max_pages_per_seq
        K = self._mixed_block_k()
        while True:
            decode_seated = [(i, s) for i, s in enumerate(self.slots)
                             if s is not None and not _mid_prefill(s)]
            # window reclaim for every seated row, as before a decode
            # block: a prompt backlog keeps the engine on the mixed path
            for s in self.slots:
                if s is not None:
                    self._reclaim_window_pages(s)
            # pages for the full K-token advance (exact for active rows:
            # each emits what it assumes unless it freezes, and frozen
            # rows stop writing)
            advs = {id(s): min(K, max(0, s.dev_steps_left))
                    for _, s in decode_seated}
            try:
                for _, s in decode_seated:
                    self._ensure_block_pages(s, advs[id(s)])
                break
            except CacheFull:
                self._event("cache_full")
                if self._pending:
                    drain_t0 = time.monotonic()
                    self._drain_pending(outputs)
                    sc_excl += time.monotonic() - drain_t0
                    continue
                if not decode_seated:
                    break  # prefill rows already hold their prompt pages
                self._preempt_youngest(outputs)

        group = [(i, s) for i, s in enumerate(self.slots)
                 if s is not None and _mid_prefill(s)][:Bp]
        budget = max(1, min(Sp, int(Sp * self._mixed_prefill_frac)))
        p_int = self._mixed_padding()
        p_ids, p_pos, p_row, p_write = (p_int[k * Sp:(k + 1) * Sp]
                                        for k in range(4))
        p_valid = p_int[4 * Sp:4 * Sp + Bp]
        p_last = p_int[4 * Sp + Bp:4 * Sp + 2 * Bp]
        tables = p_int[4 * Sp + 2 * Bp:].reshape(Bp, P)
        p_flt = np.ones((2 * Bp,), np.float32)  # temperature, top-p
        chunk_lens: List[int] = []
        off = 0
        for j, (_, s) in enumerate(group):
            tb = s.block_table[:P]
            tables[j, :len(tb)] = tb
            start = s.seq_len
            t = min(len(s.token_ids) - start, budget - off)
            chunk_lens.append(max(t, 0))
            if t <= 0:
                continue
            flat = np.arange(start, start + t, dtype=np.int32)
            table = np.asarray(s.block_table, np.int32)
            p_ids[off:off + t] = s.token_ids[start:start + t]
            p_pos[off:off + t] = flat
            p_write[off:off + t] = table[flat // ps] * ps + flat % ps
            p_row[off:off + t] = B + j
            p_valid[j] = start + t
            p_last[j] = B + off + t - 1
            p_flt[j] = s.params.temperature
            p_flt[Bp + j] = s.params.top_p
            off += t
        for i, s in decode_seated:
            if self._bt_pages[i] != len(s.block_table):
                self._refresh_bt_row(i, s)

        self._stage_decode_inputs()
        self._upload(self._m_int, p_int)
        self._upload(self._m_flt, p_flt)
        mode = _sample_mode([s for _, s in decode_seated + group])
        self._run(("mixed", K, mode), functools.partial(
            self._mixed_body, mode, K), self._decode_gen)
        host, ev = self._read_later(self._m_out)

        for _, s in decode_seated:
            s.dev_pos += advs[id(s)]
            s.dev_steps_left -= advs[id(s)]
        prefill_tokens, decode_tokens = sum(chunk_lens), sum(advs.values())
        self._mixed_steps += 1
        self._mixed_prefill_tokens += prefill_tokens
        self._mixed_decode_tokens += decode_tokens
        self._mixed_density_sum += (prefill_tokens + decode_tokens) / S
        done = []
        for j, (_, s) in enumerate(group):
            s.seq_len += chunk_lens[j]
            done.append(chunk_lens[j] > 0 and s.seq_len >= len(s.token_ids))
        # the decode rows' [K, B] frame joins the pending blocks, so
        # blocks are walked in launch order
        self._pending.append((host[:, :K * B].view(2, K, B), ev,
                              [(i, s, advs[id(s)]) for i, s in decode_seated],
                              "mixed"))
        if any(done):  # the first-token candidates: read only when needed
            if ev is not None:
                ev.synchronize()
            both = host.numpy()
            self._reap_first_tokens(group, done, both[0, K * B:],
                                    both[1, K * B:], outputs)
        self._clock("mixed", max(0.0, time.monotonic() - sc_t0 - sc_excl),
                    tokens=prefill_tokens + decode_tokens,
                    rows=len(decode_seated) + sum(1 for t in chunk_lens if t),
                    dispatches=1)
        return True

    # ------------------------------------------------------------------
    # looped blocks (kernel looping)
    # ------------------------------------------------------------------

    def _stage_loop_inputs(self, drawn: Sequence[int], cap: int) -> None:
        """Upload a looped block's inputs beside the decode block's staged
        ones: the tables' page counts, the drawn device free-list (padded
        with ``num_pages``), its length and the cap; and a new noise key
        (sampled blocks draw ``counter_uniform`` under key + step)."""
        B = self.ecfg.max_batch
        N = self.pcfg.num_pages
        ints = np.full((B + N + 2,), N, np.int32)
        ints[:B] = self._bt_pages
        ints[B:B + len(drawn)] = drawn
        ints[B + N] = len(drawn)
        ints[B + N + 1] = cap
        self._upload(self._l_in, ints)
        self._loop_launches += 1
        # disjoint per (seed, launch): the step counter fills the low bits
        key = ((self.ecfg.seed + 1) << 40) + (self._loop_launches << 16)
        self._upload(self._l_key, np.array([key], np.int64))

    def _loop_prologue(self, spec: bool = False) -> None:
        """Start a looped block: merge the staged carry overrides, reset
        the loop state (counter, free-list use, exit codes, outputs: the
        spec outputs for a speculative block) and load the tables to grow;
        the continue flag says whether any row is active."""
        B = self.ecfg.max_batch
        P = self.pcfg.max_pages_per_seq
        carry = self._merged_carry()
        self._store_carry(*carry)
        self._l_state[:3 + 2 * B].zero_()
        self._l_cnt.copy_(self._l_in[:B])
        self._l_tbl.copy_(self._d_int[5 * B:].view(B, P))
        if spec:
            self._ls_out.zero_()
        else:
            self._l_out[0].fill_(-1.0)
            self._l_out[1].zero_()
        self._l_cont.copy_(carry[3].any().to(torch.int32).view(1))

    def _loop_body(self, mode: int) -> None:
        """One looped-block iteration over the static buffers (the JAX
        ``_build_loop_block`` body): rows whose next write enters a page
        they lack take one from the device free-list (rows it cannot cover
        freeze with exit 3), then one step of the decode block's math over
        the growing full-capacity tables, the freeze law (exit 1 eos, 2
        budget), the step's tokens and log-probabilities written at row k
        of ``_l_out``, the final exit codes as if the loop stopped here (4
        for rows still running: the cap), k + 1, and the continue flag
        (k < cap and any row active). No host read."""
        B = self.ecfg.max_batch
        N = self.pcfg.num_pages
        ps = self.pcfg.page_size
        tokens, positions, steps_left, active = self._carry
        rows = torch.arange(B, device=self.device)
        needed = torch.where(active, positions // ps + 1,
                             torch.zeros_like(positions))
        starved = _device_append_pages(
            self._l_tbl, self._l_cnt, self._l_in[B:B + N],
            self._l_in[B + N], self._l_used, needed, rows)
        exit_code = torch.where(starved & (self._l_exit == 0),
                                torch.full_like(self._l_exit, 3),
                                self._l_exit)
        active = active & ~starved
        key = self._l_key + self._l_k if mode else None
        out, lp, is_eos, *carry = self._decode_step(
            tokens, positions, steps_left, active, self._l_tbl,
            self._d_flt[:B], self._d_flt[B:], mode, key)
        froze = active & ~carry[3]
        zero = exit_code == 0
        exit_code = torch.where(froze & is_eos & zero,
                                torch.full_like(exit_code, 1), exit_code)
        exit_code = torch.where(froze & ~is_eos & zero,
                                torch.full_like(exit_code, 2), exit_code)
        k = self._l_k.long()
        self._l_out[0].index_copy_(0, k, out.float()[None])
        self._l_out[1].index_copy_(0, k, lp[None])
        self._store_carry(*carry)
        self._l_exit.copy_(exit_code)
        self._l_fin.copy_(torch.where(carry[3] & (exit_code == 0),
                                      torch.full_like(exit_code, 4),
                                      exit_code))
        self._l_k.add_(1)
        self._l_cont.copy_(((self._l_k < self._l_in[B + N + 1])
                            & carry[3].any()).to(torch.int32))

    def _spec_loop_body(self, mode: int) -> None:
        """One iteration of a speculative looped block (the JAX
        ``_build_spec_loop_block`` body): rows take device free-list pages
        until their table covers this round's gamma + 1 writes (rows it
        cannot cover freeze with exit 3), then one speculative round over
        the growing tables, its outputs at round k of ``_ls_out``, the
        exit codes (1 eos, 2 budget, 4 still running), k + 1 and the
        continue flag (k below the round cap and any row active)."""
        B = self.ecfg.max_batch
        N = self.pcfg.num_pages
        ps = self.pcfg.page_size
        W = self.spec.num_draft_tokens + 1
        smax = self.pcfg.max_seq_len
        tokens, positions, steps_left, active = self._carry
        rows = torch.arange(B, device=self.device)
        last = (positions + W - 1).clamp(max=smax - 1)
        needed = torch.where(active, last // ps + 1,
                             torch.zeros_like(positions))
        # one page per row per pass; a round spans at most W // ps + 2
        for _ in range(W // ps + 2):
            starved = _device_append_pages(
                self._l_tbl, self._l_cnt, self._l_in[B:B + N],
                self._l_in[B + N], self._l_used, needed, rows)
        exit_code = torch.where(starved & (self._l_exit == 0),
                                torch.full_like(self._l_exit, 3),
                                self._l_exit)
        active = active & ~starved
        key = self._l_key + self._l_k if mode else None
        *res, carry = self._spec_round(tokens, positions, steps_left,
                                       active, self._l_tbl, mode, key)
        toks_out = res[0]  # -1 past each row's emitted tokens
        is_eos = ((toks_out[..., None] == self._eos[None, None, :]).any(-1)
                  .any(-1))
        froze = active & ~carry[3]
        zero = exit_code == 0
        exit_code = torch.where(froze & is_eos & zero,
                                torch.full_like(exit_code, 1), exit_code)
        exit_code = torch.where(froze & ~is_eos & zero,
                                torch.full_like(exit_code, 2), exit_code)
        self._spec_pack(self._ls_out, self._spec_loop_rounds,
                        self._l_k.long(), *res)
        self._store_carry(*carry)
        self._l_exit.copy_(exit_code)
        self._l_fin.copy_(torch.where(carry[3] & (exit_code == 0),
                                      torch.full_like(exit_code, 4),
                                      exit_code))
        self._l_k.add_(1)
        self._l_cont.copy_(((self._l_k < self._l_in[B + N + 1])
                            & carry[3].any()).to(torch.int32))

    def _run_loop(self, mode: int, spec: bool = False) -> Optional[_Graph]:
        """Run one looped block (a speculative one with ``spec``): its
        WHILE graph's launch (``cuda``, captured on first use right after
        an eager run of this block), or eagerly, reading the continue flag
        before each iteration (CPU, or ``_graphs=False``). Returns the
        graph launched, if one was: its iterations' launches are counted
        once their number is read."""
        key = ("sloop" if spec else "loop", mode)
        g = self._graphs.get(key) if self._use_graphs else None
        if g is not None:
            g.graph.launch(self._stream)
            kernels.add_launch_counts(g.counts)
            return g
        body = self._spec_loop_body if spec else self._loop_body
        self._loop_prologue(spec)
        while int(self._l_cont[0]):
            body(mode)
        if self._use_graphs:
            self._capture_loop(mode, spec)
        return None

    def _capture_loop(self, mode: int, spec: bool = False) -> None:
        """Capture the looped block for ``mode``: its prologue and one
        iteration as two graphs on the engine stream (kept, not
        instantiated), joined by a WHILE node into one instantiated graph
        (``graph_loop.LoopGraph``). Sampled iterations draw
        ``counter_uniform`` noise, not the generator. Raises on failure."""
        self._event("retrace")
        parts = []
        torch.cuda.synchronize(self.device)
        body = self._spec_loop_body if spec else self._loop_body
        for fn in (functools.partial(self._loop_prologue, spec),
                   functools.partial(body, mode)):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with kernels.recording() as counts:
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    fn()
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
            kernels.add_launch_counts(counts, -1)  # captured, not launched
            parts.append((graph, counts))
        (pro, pro_counts), (it, it_counts) = parts
        self._graphs[("sloop" if spec else "loop", mode)] = _Graph(
            LoopGraph(pro, it, self._l_cont), pro_counts, it_counts)

    def _loop_step(self, outputs: List[StepOutput]) -> bool:
        """Launch ONE looped block and process it right after (looped
        blocks do not pipeline: the loop itself amortizes the host round
        trip, and the host view stays exact for admission and
        preemption). Pending fixed and mixed frames drain first. Page
        pressure drains or preempts as ``_maybe_launch`` does, but the
        host guarantees only each row's first write; a device free-list
        draw covers the worst-case remainder (``min(cap, steps left)`` per
        row) and is reconciled with the allocator afterwards."""
        if self._pending:
            self._drain_pending(outputs)
        sc_t0 = time.monotonic()
        sc_excl = 0.0
        cap = self._loop_cap()
        while True:
            seated = [(i, s) for i, s in enumerate(self.slots)
                      if s is not None]
            if not any(u[0] for u in self._slot_updates.values()) and not any(
                    s.dev_steps_left > 0 for _, s in seated):
                return False
            use_spec, spec_ok = self._spec_plan(seated)
            W = self.spec.num_draft_tokens + 1 if use_spec else 1
            for _, s in seated:  # before the block's tables are staged
                self._reclaim_window_pages(s)
            try:
                for _, s in seated:
                    if s.dev_steps_left > 0:
                        self._ensure_block_pages(s, W)
                break
            except CacheFull:
                self._event("cache_full")
                if self._pending:
                    drain_t0 = time.monotonic()
                    self._drain_pending(outputs)
                    sc_excl += time.monotonic() - drain_t0
                    continue
                if seated:
                    self._preempt_youngest(outputs)
                    continue
                return False
        ps = self.pcfg.page_size
        P = self.pcfg.max_pages_per_seq
        # a speculative block runs whole rounds: the cap rounds up to
        # ceil(cap / W) of them, and a round may overshoot by gamma
        rounds = max(1, -(-cap // W))
        advs: Dict[int, int] = {}
        want = 0
        for _, s in seated:
            if s.dev_steps_left <= 0:
                adv = 0
            elif use_spec:
                adv = min(rounds * W, s.dev_steps_left + W - 1)
            else:
                adv = min(cap, s.dev_steps_left)
            advs[id(s)] = adv
            if adv:
                needed = min((s.dev_pos + adv - 1) // ps + 1, P)
                want += max(0, needed - len(s.block_table))
        drawn = self.allocator.draw_device(want) if want > 0 else []
        for i, s in seated:
            if self._bt_pages[i] != len(s.block_table):
                self._refresh_bt_row(i, s)
        # each row's table length at launch: the reconcile reads the
        # device's appends off the returned tables past it
        snapshot = [(i, s, advs[id(s)], len(s.block_table))
                    for i, s in seated]
        self._stage_decode_inputs()
        if use_spec:
            self._stage_spec_ok(seated, spec_ok)
        self._stage_loop_inputs(drawn, rounds if use_spec else cap)
        launched = self._run_loop(_sample_mode([s for _, s in seated]),
                                  use_spec)
        # both copies behind the second one's event
        results = (self._read_later(self._l_state)[0],
                   *self._read_later(self._ls_out if use_spec
                                     else self._l_out))
        for _, s in seated:
            s.dev_pos += advs[id(s)]
            s.dev_steps_left -= advs[id(s)]
        emitted = self._process_loop_block(results, launched, snapshot,
                                           drawn, outputs)
        self._clock("loop", max(0.0, time.monotonic() - sc_t0 - sc_excl),
                    tokens=emitted, rows=len(seated), dispatches=1)
        return True

    def _process_loop_block(self, results, graph: Optional[_Graph],
                            snapshot, drawn: List[int],
                            outputs: List[StepOutput]) -> int:
        """Reconcile one looped block (its state and outputs come back
        through pinned memory behind one event, the only wait). Pages
        first: the device's appends join live rows' block tables (so a row
        the walk finishes releases them like any other page); appends on
        rows aborted meanwhile, and the draw's unused pages, go back
        through ``reconcile_device``. Then the K-step path's token walk,
        the re-staging of rows the free-list starved (exit 3) and the
        exit counters; a launched ``graph`` adds its iteration's launches
        times the iterations run. Returns the tokens emitted."""
        B = self.ecfg.max_batch
        P = self.pcfg.max_pages_per_seq
        state, out, ev = results
        if ev is not None:
            ev.synchronize()
        state, out = state.numpy(), out.numpy()
        # iterations run: steps, or rounds of a speculative block
        n_steps = int(state[0])
        codes = state[3 + B:3 + 2 * B]
        cnt = state[3 + 2 * B:3 + 3 * B]
        tbl = state[3 + 3 * B:].reshape(B, P)
        if graph is not None and n_steps:
            kernels.add_launch_counts(
                {k: v * n_steps for k, v in graph.step_counts.items()})
        claimed: List[int] = []
        for slot, seq, _, n0 in snapshot:
            n1 = int(cnt[slot])
            if n1 > n0 and self._by_id.get(seq.request_id) is seq:
                pages = [int(p) for p in tbl[slot, n0:n1]]
                claimed.extend(pages)
                seq.block_table.extend(pages)
        if drawn:
            claimed_set = set(claimed)
            self.allocator.reconcile_device(
                claimed, [p for p in drawn if p not in claimed_set])
        walk = [(i, s, a) for i, s, a, _ in snapshot]
        if out.ndim == 1:  # a speculative block's rounds
            toks, lps, counts, acc, prop = self._spec_unpack(
                out, self._spec_loop_rounds)
            self._record_acceptance(acc[:n_steps], prop[:n_steps], walk)
            emitted = self._walk_block(toks[:n_steps], lps[:n_steps], walk,
                                       outputs, counts[:n_steps])
        else:
            emitted = self._walk_block(out[0, :n_steps], out[1, :n_steps],
                                       walk, outputs)
        for slot, seq, _, _ in snapshot:
            c = int(codes[slot])
            if c:
                self._loop_exits[LOOP_EXITS[c]] += 1
            if (c == 3 and self._by_id.get(seq.request_id) is seq
                    and self.slots[slot] is seq):
                self._stage_seat(slot, seq)
        self._loop_blocks += 1
        self._loop_steps += n_steps
        self._loop_decode_tokens += emitted
        return emitted

    # ------------------------------------------------------------------
    # token emission & completion
    # ------------------------------------------------------------------

    def _decode_piece(self, seq: _Seq, token_id: int) -> str:
        """Incremental detokenization: a token whose text ends in U+FFFD is
        held back and decoded together with its successors until the
        joint text is clean (at most 8 tokens)."""
        if seq.pending_ids:
            seq.pending_ids.append(token_id)
            text = self.tok.decode(seq.pending_ids)
            if text.endswith("�") and len(seq.pending_ids) < 8:
                return ""
            seq.pending_ids = []
            return text
        piece = self.tok.decode_token(token_id)
        if piece.endswith("�"):
            seq.pending_ids = [token_id]
            return ""
        return piece

    def _flush_pending_text(self, seq: _Seq) -> None:
        if seq.pending_ids:
            seq.output_text += self.tok.decode(seq.pending_ids)
            seq.pending_ids = []

    def _emit_token(self, seq: _Seq, token_id: int,
                    outputs: List[StepOutput],
                    logprob: Optional[float] = None) -> None:
        """One sampled token: EOS / length / stop-sequence handling and
        the text delta, holding back a possible stop-sequence prefix."""
        p = seq.params
        if token_id in self.tok.eos_ids:
            self._finish(seq, FinishReason.STOP, outputs)
            return

        seq.next_token = token_id
        seq.emitted_tokens += 1
        seq.output_text += self._decode_piece(seq, token_id)

        if p.stop_sequences:
            earliest = -1
            for stop in p.stop_sequences:
                idx = seq.output_text.find(
                    stop, max(0, seq.emitted_upto - len(stop)))
                if idx >= 0 and (earliest < 0 or idx < earliest):
                    earliest = idx
            if earliest >= 0:
                seq.output_text = seq.output_text[:earliest]
                seq.pending_ids = []
                self._finish(seq, FinishReason.STOP_SEQUENCE, outputs)
                return

        if (seq.emitted_tokens >= p.max_tokens
                or seq.seq_len + 1 >= self.pcfg.max_seq_len):
            outputs.append(StepOutput(
                request_id=seq.request_id, token_id=token_id, text="",
                token_index=seq.emitted_tokens - 1, logprob=logprob,
            ))
            self._finish(seq, FinishReason.LENGTH, outputs)
            return

        hold = max((len(s) for s in p.stop_sequences), default=1) - 1
        safe_upto = max(seq.emitted_upto, len(seq.output_text) - hold)
        delta = seq.output_text[seq.emitted_upto : safe_upto]
        seq.emitted_upto = safe_upto
        outputs.append(StepOutput(
            request_id=seq.request_id, token_id=token_id, text=delta,
            token_index=seq.emitted_tokens - 1, logprob=logprob,
        ))

    def _finish(self, seq: _Seq, reason: FinishReason,
                outputs: List[StepOutput]) -> None:
        self._flush_pending_text(seq)
        outputs.append(StepOutput(
            request_id=seq.request_id,
            text=seq.output_text[seq.emitted_upto :],
            token_index=max(0, seq.emitted_tokens - 1),
            finished=True,
            finish_reason=reason,
            usage=Usage.of(seq.prompt_len, seq.emitted_tokens),
        ))
        for i, s in enumerate(self.slots):
            if s is seq:
                self.slots[i] = None
        self._by_id.pop(seq.request_id, None)
        # publish full pages for prefix reuse, then drop our references;
        # a window-reclaimed table holds sentinels (K/V gone): not reusable
        if seq.freed_upto == 0:
            self.allocator.publish(seq.token_ids, seq.block_table)
        self._release_seq(seq)

    def _release_seq(self, seq: _Seq) -> None:
        if seq.block_table:
            sentinel = self.pcfg.num_pages
            live = [p for p in seq.block_table if p != sentinel]
            if live:
                self.allocator.release(live)
            seq.block_table = []
            seq.freed_upto = 0

    def _reclaim_window_pages(self, seq: _Seq) -> None:
        """Sliding-window KV reclaim: pages whose positions all lie behind
        every future query's window (position <= seq_len - W, seq_len being
        the exact resident count, a lower bound on the device position)
        are released and their table entries set to the sentinel
        ``num_pages``. Nothing attends them again: the kernels walk each
        row from its window's lower edge, the plain path clamps the
        sentinel into the pool and masks it. A re-prefill after preemption
        starts from a fresh table. Alternating local / global layers
        (Gemma-2's ``sliding_window_pattern``) reclaim nothing: the global
        layers still attend the whole history."""
        W = self.cfg.sliding_window
        if not W or not seq.block_table or self.cfg.sliding_window_pattern:
            return
        if seq.prefill_only or seq.exporting:
            # a handoff candidate keeps every page serializable, also while
            # a streamed export is in flight
            return
        ps = self.pcfg.page_size
        sentinel = self.pcfg.num_pages
        limit = seq.seq_len - W + 1  # positions < limit are dead
        freed: List[int] = []
        j = seq.freed_upto
        while j < len(seq.block_table) and (j + 1) * ps <= limit:
            page = seq.block_table[j]
            if page != sentinel:
                freed.append(page)
                seq.block_table[j] = sentinel
            j += 1
        seq.freed_upto = j
        if freed:
            self._event("reclaim", len(freed))
            self.allocator.release(freed)

    # ------------------------------------------------------------------
    # preemption
    # ------------------------------------------------------------------

    def _preempt_youngest(self, outputs: List[StepOutput]) -> None:
        """Send the seated sequence with the fewest generated tokens back
        to the queue, releasing its pages."""
        youngest: Optional[_Seq] = None
        for s in self.slots:
            if s is not None and (
                    youngest is None
                    or s.num_output_tokens() < youngest.num_output_tokens()):
                youngest = s
        if youngest is not None:
            self._preempt(youngest, outputs)

    def _preempt(self, seq: _Seq, outputs: List[StepOutput]) -> None:
        # only called with the pipeline drained, so the host state is
        # exact, not a lagging projection
        self._event("preempt")
        for i, s in enumerate(self.slots):
            if s is seq:
                self.slots[i] = None
                self._deact_slot(i)
        self._release_seq(seq)
        seq.seq_len = 0
        seq.dev_pos = 0
        seq.dev_steps_left = 0
        # the sampled-but-undecoded token joins the prompt so re-prefill
        # resumes exactly where the sequence stopped
        if seq.next_token is not None:
            seq.token_ids.append(seq.next_token)
            seq.next_token = None
        self.waiting.appendleft(seq)


def _to_device(params, device: torch.device):
    def leaf(v):
        if is_quantized(v):
            return type(v)(*(t.to(device) for t in v))
        return v.to(device)

    return {k: _to_device(v, device) if isinstance(v, dict) else leaf(v)
            for k, v in params.items()}
