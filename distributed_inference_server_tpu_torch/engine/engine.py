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
  the decode block: every seated decode row advances one token and prompt
  chunks fill the rest of the token budget, attended by the ragged paged
  kernel. Its decode ids, their log-probabilities and the first-token
  candidates come back in one host read.

- **Quantized serving**: the params may carry ``Q8Tensor`` /
  ``Q4Tensor`` weights (``ops/quant.py quantize_params``), which the
  engine passes through to the model as they are; ``kv_quant="int8"``
  keeps the pools as int8 ``QuantPool`` pairs (half the KV bytes per
  decode step).

Not ported yet: the pipelined blocks (``pipeline_depth``), looped
blocks (and so the mixed step's K-block form), speculation, meshes, the
mixed step over int8 pools, the host tier, KV handoff and embeddings.
Without pipelining each block is read right after its launch; the tokens
are the same.

Threading: the engine is synchronous and single-owner (one ``step()``
caller); the serving layer runs it on a dedicated thread.
"""

from __future__ import annotations

import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_inference_server_tpu_torch.core.errors import CacheFull
from distributed_inference_server_tpu_torch.core.models import (
    FinishReason,
    Usage,
)
from distributed_inference_server_tpu_torch.core.types import RequestId
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PageAllocator,
    PagedCacheConfig,
    PagedKVState,
)
from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.configs import ModelConfig
from distributed_inference_server_tpu_torch.models.tokenizer import Tokenizer
from distributed_inference_server_tpu_torch.ops.quant import is_quantized
from distributed_inference_server_tpu_torch.ops.sampling import sample_tokens
from distributed_inference_server_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)

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


def _sample(logits, temp, top_p, generator, mode: int) -> torch.Tensor:
    if mode == 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sample_tokens(logits, temp, top_p, generator, use_topp=mode == 2)


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
    )

    def __init__(self, request_id: RequestId, prompt_ids: List[int],
                 params: SamplingParams):
        self.request_id = request_id
        self.token_ids: List[int] = list(prompt_ids)
        self.prompt_len = len(prompt_ids)
        self.block_table: List[int] = []
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

    def num_output_tokens(self) -> int:
        return len(self.token_ids) - self.prompt_len


class LLMEngine:
    """Single-model continuous-batching engine on one device."""

    def __init__(
        self,
        params: llama.Params,
        cfg: ModelConfig,
        tokenizer: Tokenizer,
        engine_cfg: Optional[EngineConfig] = None,
        dtype: torch.dtype = torch.bfloat16,
        device: DeviceLike = None,
    ):
        """``params``: the ``models/llama.py`` tree (moved to ``device`` if
        it lives elsewhere); ``dtype``: the KV pools' dtype; ``device``:
        ``cuda`` unless the caller asks for ``cpu``. Quantized weights
        (``Q8Tensor`` / ``Q4Tensor`` leaves) pass through as they are."""
        llama.check_supported(cfg)
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
        if self.ecfg.mixed_step_tokens and (
                self.ecfg.mixed_step_tokens <= self.ecfg.max_batch):
            raise ValueError(
                f"mixed_step_tokens ({self.ecfg.mixed_step_tokens}) must "
                f"exceed max_batch ({self.ecfg.max_batch}): the packed width "
                "holds every decode slot plus at least one prefill token")
        if self.ecfg.mixed_step_tokens and self.ecfg.kv_quant != "none":
            raise ValueError(
                "mixed_step_tokens with kv_quant='int8' is not ported yet: "
                "the ragged mixed step does not read int8 pools")
        self.params = _to_device(params, self.device)
        if self.params["embed"].dtype != torch.float32:
            # f32 logits every step: keep the f32 unembedding once
            self.params["unembed_f32"] = llama.unembed_weight_f32(
                self.params, cfg)
        self.state = PagedKVState.create(cfg, self.pcfg, dtype=dtype,
                                         device=self.device,
                                         kv_quant=self.ecfg.kv_quant)
        self.allocator = PageAllocator(self.pcfg)
        self.waiting: Deque[_Seq] = deque()
        self.slots: List[Optional[_Seq]] = [None] * self.ecfg.max_batch
        self._by_id: Dict[RequestId, _Seq] = {}
        self._num_slots_flat = self.pcfg.num_pages * self.pcfg.page_size
        # prefill and decode draw from separate device generators, as the
        # JAX engine keeps separate keys (seed, seed + 1)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.ecfg.seed)
        self._decode_gen = torch.Generator(device=self.device)
        self._decode_gen.manual_seed(self.ecfg.seed + 1)

        # host mirror of per-slot block tables / sampling params, uploaded
        # at each block launch
        B = self.ecfg.max_batch
        self._bt = np.zeros((B, self.pcfg.max_pages_per_seq), np.int32)
        self._bt_pages = np.zeros((B,), np.int32)
        self._temp = np.ones((B,), np.float32)
        self._topp = np.ones((B,), np.float32)
        # slot -> (active, token, position, steps) merged into the device
        # carry at the next launch (admissions and deactivations)
        self._slot_updates: Dict[int, Tuple[bool, int, int, int]] = {}
        # device decode carry: (tokens, positions, steps_left, active)
        self._carry: Optional[Tuple[torch.Tensor, ...]] = None
        self._eos = torch.tensor(sorted(tokenizer.eos_ids), dtype=torch.int32,
                                 device=self.device)
        # mixed-step control and traffic counters (mixed_stats)
        self._mixed_prefill_frac = 1.0
        self._mixed_steps = 0
        self._mixed_prefill_tokens = 0
        self._mixed_decode_tokens = 0
        self._mixed_density_sum = 0.0

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def add_request(self, request_id: RequestId, prompt_ids: List[int],
                    params: SamplingParams) -> None:
        """Queue a tokenized request."""
        seq = _Seq(request_id, prompt_ids, params)
        self._by_id[request_id] = seq
        self.waiting.append(seq)

    def abort(self, request_id: RequestId) -> bool:
        """Abort a queued or running request; returns True if found. Its
        pages are released at once."""
        seq = self._by_id.pop(request_id, None)
        if seq is None:
            return False
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

    def step(self) -> List[StepOutput]:
        """One engine iteration: admit waiting requests into free slots,
        run up to one prefill quantum (first tokens sampled on the
        device), then issue one K-step decode block and read its tokens
        back once. With ``mixed_step_tokens`` set and a seated prompt
        still loading, one ragged mixed dispatch replaces the quantum and
        the block."""
        outputs: List[StepOutput] = []
        self._admit(outputs)
        if self.ecfg.mixed_step_tokens and any(
                s is not None and _mid_prefill(s) for s in self.slots):
            self._mixed_step(outputs)
            return outputs
        self._prefill_quantum(outputs)
        block = self._maybe_launch(outputs)
        if block is not None:
            self._process_block(block, outputs)
        return outputs

    def set_mixed_prefill_frac(self, frac: float) -> None:
        """Shrink (or restore) the prefill share of the mixed step's packed
        budget; floor 0.05 so prompts always progress. Engine-thread
        only."""
        self._mixed_prefill_frac = min(1.0, max(0.05, float(frac)))

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

    def cache_stats(self):
        return self.allocator.stats()

    def audit_pages(self, extra_pages: Sequence[int] = ()) -> List[str]:
        """KV-page conservation audit: every page a live sequence holds
        (plus ``extra_pages``) against the allocator's books. Returns
        inconsistency strings (empty = clean)."""
        live = [p for s in self._by_id.values() for p in s.block_table]
        live.extend(extra_pages)
        return self.allocator.audit(live)

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
            try:
                self._start_prefill(seq)
            except CacheFull:
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
        pages_needed = -(-n // ps) - len(seq.block_table)
        if pages_needed > 0:
            try:
                seq.block_table.extend(self.allocator.allocate(pages_needed))
            except CacheFull:
                self._release_seq(seq)
                raise

    def _prefill_quantum(self, outputs: List[StepOutput]) -> None:
        """Run up to ``prefill_token_budget`` prefill tokens: chunks of up
        to ``prefill_batch`` prompts share one forward per length bucket.
        Every chunk is issued before any first token is read back; prompts
        whose last chunk ran sample their first token on the device and
        are staged into the decode carry."""
        budget = self.ecfg.prefill_token_budget
        Bp = self.ecfg.prefill_batch
        ps = self.pcfg.page_size
        P = self.pcfg.max_pages_per_seq
        dispatched = []
        while budget > 0:
            group = [(i, s) for i, s in enumerate(self.slots)
                     if s is not None and _mid_prefill(s)][:Bp]
            if not group:
                break
            bucket = self._pick_bucket(max(
                len(s.token_ids) - s.seq_len for _, s in group))
            ids = np.zeros((Bp, bucket), np.int32)
            positions = np.zeros((Bp, bucket), np.int32)
            write_slots = np.full((Bp, bucket), self._num_slots_flat,
                                  np.int32)
            tables = np.zeros((Bp, P), np.int32)
            kv_valid = np.zeros((Bp,), np.int32)
            last_idx = np.zeros((Bp,), np.int32)
            temp = np.ones((Bp,), np.float32)
            top_p = np.ones((Bp,), np.float32)
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
                temp[j] = s.params.temperature
                top_p[j] = s.params.top_p
            dev = self.device
            logits, _, _ = llama.paged_forward(
                self.params, self.cfg,
                torch.from_numpy(ids).to(dev),
                torch.from_numpy(positions).to(dev),
                self.state.k, self.state.v,
                torch.from_numpy(write_slots).to(dev),
                torch.from_numpy(tables).to(dev),
                torch.from_numpy(kv_valid).to(dev),
                impl=self.ecfg.attention_impl, page_size=ps,
                logits_idx=torch.from_numpy(last_idx).to(dev),
            )
            last = logits[:, 0]
            toks = _sample(last, torch.from_numpy(temp).to(dev),
                           torch.from_numpy(top_p).to(dev), self._gen,
                           _sample_mode([s for _, s in group]))
            lps = _chosen_logprob(last, toks)
            budget -= Bp * bucket
            done: List[bool] = []
            for j, (_, s) in enumerate(group):
                s.seq_len += chunk_lens[j]
                done.append(s.seq_len >= len(s.token_ids))
            dispatched.append((toks, lps, list(group), done))

        # reap: one read per chunk that finished a prompt
        for toks, lps, group, done in dispatched:
            if not any(done):
                continue
            both = torch.stack([toks.float(), lps]).cpu().numpy()
            self._reap_first_tokens(group, done, both[0], both[1], outputs)

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
                self._stage_seat(slot, s)

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

    def _assumed_adv(self, seq: _Seq) -> int:
        """Tokens this sequence can emit in one block (the page
        pre-allocation unit)."""
        if seq.dev_steps_left <= 0:
            return 0
        return min(self.ecfg.decode_block_size, seq.dev_steps_left)

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

    def _maybe_launch(self, outputs: List[StepOutput]):
        """Issue one decode block if a seated row has budget left or a host
        override is staged. Under page pressure the youngest sequence is
        preempted until the block's pages fit. Returns the issued block
        (device tokens + the launch snapshot) or None."""
        while True:
            seated = [(i, s) for i, s in enumerate(self.slots)
                      if s is not None]
            if not any(u[0] for u in self._slot_updates.values()) and not any(
                    s.dev_steps_left > 0 for _, s in seated):
                return None
            advs = {id(s): self._assumed_adv(s) for _, s in seated}
            try:
                for _, s in seated:
                    self._ensure_block_pages(s, advs[id(s)])
                break
            except CacheFull:
                if seated:
                    self._preempt_youngest(outputs)
                    continue
                return None
        for i, s in seated:
            if self._bt_pages[i] != len(s.block_table):
                self._refresh_bt_row(i, s)
        block = self._launch(seated, advs)
        for _, s in seated:
            adv = advs[id(s)]
            s.dev_pos += adv
            s.dev_steps_left -= adv
        return block

    def _merged_carry(self) -> Tuple[torch.Tensor, ...]:
        """The device decode carry (tokens, positions, steps_left, active)
        with the staged host overrides merged in (admissions and
        deactivations); shared by the decode block and the mixed step."""
        set_mask, set_active, set_tokens, set_pos, set_steps = (
            self._drain_slot_updates())
        tokens, positions, steps_left, active = self._carry
        return (torch.where(set_mask, set_tokens, tokens),
                torch.where(set_mask, set_pos, positions),
                torch.where(set_mask, set_steps, steps_left),
                torch.where(set_mask, set_active, active))

    def _drain_slot_updates(self) -> Tuple[torch.Tensor, ...]:
        B = self.ecfg.max_batch
        set_mask = np.zeros((B,), bool)
        set_active = np.zeros((B,), bool)
        set_tokens = np.zeros((B,), np.int32)
        set_pos = np.zeros((B,), np.int32)
        set_steps = np.zeros((B,), np.int32)
        for slot, (act, tok, pos, steps) in self._slot_updates.items():
            set_mask[slot] = True
            set_active[slot] = act
            set_tokens[slot] = tok
            set_pos[slot] = pos
            set_steps[slot] = steps
        self._slot_updates.clear()
        dev = self.device
        if self._carry is None:
            z = torch.zeros((B,), dtype=torch.int32, device=dev)
            self._carry = (z, z.clone(), z.clone(),
                           torch.zeros((B,), dtype=torch.bool, device=dev))
        return tuple(torch.from_numpy(a).to(dev) for a in (
            set_mask, set_active, set_tokens, set_pos, set_steps))

    def _launch(self, seated: List[Tuple[int, _Seq]],
                advs: Dict[int, int]):
        """The K-step decode block: K model steps with on-device sampling,
        EOS masking, per-row budgets and block-table slot arithmetic, all
        issued without reading anything back. Returns ([2, K, B] f32
        device tensor of tokens (-1 = frozen row) and their
        log-probabilities, launch snapshot)."""
        tokens, positions, steps_left, active = self._merged_carry()
        dev = self.device
        ps = self.pcfg.page_size
        num_slots = self._num_slots_flat
        block_tables = torch.from_numpy(self._bt).to(dev)
        temp = torch.from_numpy(self._temp).to(dev)
        top_p = torch.from_numpy(self._topp).to(dev)
        mode = _sample_mode([s for _, s in seated])
        rows = torch.arange(block_tables.shape[0], device=dev)
        P = block_tables.shape[1]
        drop = torch.full_like(positions, num_slots)
        outs, lps = [], []
        for _ in range(self.ecfg.decode_block_size):
            page = block_tables[rows, (positions // ps).clamp(max=P - 1)]
            write = torch.where(active, page * ps + positions % ps, drop)
            kv_valid = torch.where(active, positions + 1,
                                   torch.zeros_like(positions))
            logits, _, _ = llama.paged_forward(
                self.params, self.cfg, tokens[:, None], positions[:, None],
                self.state.k, self.state.v, write[:, None], block_tables,
                kv_valid, impl=self.ecfg.attention_impl, page_size=ps,
            )
            last = logits[:, 0]
            nxt = _sample(last, temp, top_p, self._decode_gen, mode)
            lps.append(_chosen_logprob(last, nxt))
            outs.append(torch.where(active, nxt, torch.full_like(nxt, -1)))
            is_eos = torch.isin(nxt, self._eos)
            positions = torch.where(active, positions + 1, positions)
            steps_left = torch.where(active, steps_left - 1, steps_left)
            tokens = torch.where(active, nxt, tokens)
            active = active & ~is_eos & (steps_left > 0)
        self._carry = (tokens, positions, steps_left, active)
        # token ids are exact in f32 (vocab < 2**24): one tensor, one read
        result = torch.stack([torch.stack(outs).float(), torch.stack(lps)])
        snapshot = [(i, s, advs[id(s)]) for i, s in seated]
        return result, snapshot

    def _process_block(self, block, outputs: List[StepOutput]) -> None:
        """Read a block's [K, B] tokens once and walk each row's tokens
        through the emission path (EOS / stop sequences / length), then
        reconcile each row's projected advance with what it emitted."""
        result, snapshot = block
        both = result.cpu().numpy()  # the block's one host read
        self._walk_block(both[0], both[1], snapshot, outputs)

    def _walk_block(self, toks: np.ndarray, lps: np.ndarray, snapshot,
                    outputs: List[StepOutput]) -> None:
        """Emit a block's host-side [K, B] tokens (-1 = frozen row) and
        log-probabilities row by row, then reconcile each row's projected
        advance with what it emitted."""
        K = toks.shape[0]
        for slot, seq, assumed in snapshot:
            if self._by_id.get(seq.request_id) is not seq:
                continue  # finished or aborted meanwhile
            emitted_here = 0
            try:
                for k in range(K):
                    t = int(toks[k, slot])
                    if t < 0:
                        break  # row frozen on the device
                    seq.token_ids.append(seq.next_token)
                    seq.seq_len += 1
                    emitted_here += 1
                    self._emit_token(seq, t, outputs, float(lps[k, slot]))
                    if self._by_id.get(seq.request_id) is not seq:
                        # finished (stop sequences are host-only): the
                        # device row may still be live
                        self._deact_slot(slot)
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
            if self._by_id.get(seq.request_id) is seq:
                delta = assumed - emitted_here
                seq.dev_pos -= delta
                seq.dev_steps_left += delta

    # ------------------------------------------------------------------
    # ragged mixed step
    # ------------------------------------------------------------------

    def _mixed_step(self, outputs: List[StepOutput]) -> None:
        """One ragged mixed dispatch: every seated decode row advances one
        token from the device carry while up to ``prefill_batch`` loading
        prompts pack exact-length chunks (no bucket padding) into the rest
        of the budget. Under page pressure the youngest sequence is
        preempted until the decode rows' pages fit. The packed layout is
        decode slots 0..B-1 (inactive ones -1 in ``tok_row``), then the
        chunks back to back, then padding."""
        S = self.ecfg.mixed_step_tokens
        B = self.ecfg.max_batch
        Sp = S - B
        Bp = min(self.ecfg.prefill_batch, Sp)
        ps = self.pcfg.page_size
        P = self.pcfg.max_pages_per_seq
        while True:
            decode_seated = [(i, s) for i, s in enumerate(self.slots)
                             if s is not None and not _mid_prefill(s)]
            advs = {id(s): min(1, max(0, s.dev_steps_left))
                    for _, s in decode_seated}
            try:
                for _, s in decode_seated:
                    self._ensure_block_pages(s, advs[id(s)])
                break
            except CacheFull:
                if not decode_seated:
                    break  # prefill rows already hold their prompt pages
                self._preempt_youngest(outputs)

        group = [(i, s) for i, s in enumerate(self.slots)
                 if s is not None and _mid_prefill(s)][:Bp]
        budget = max(1, min(Sp, int(Sp * self._mixed_prefill_frac)))
        # int32 rows: ids, positions, tok_row, write slots (each [Sp]),
        # then kv_valid and logits index (each [Bp])
        p_int = np.zeros((4 * Sp + 2 * Bp,), np.int32)
        p_ids, p_pos, p_row, p_write = (p_int[k * Sp:(k + 1) * Sp]
                                        for k in range(4))
        p_valid = p_int[4 * Sp:4 * Sp + Bp]
        p_last = p_int[4 * Sp + Bp:]
        p_row[:] = -1
        p_write[:] = self._num_slots_flat
        p_temp = np.ones((Bp,), np.float32)
        p_topp = np.ones((Bp,), np.float32)
        tables = np.zeros((B + Bp, P), np.int32)
        chunk_lens: List[int] = []
        off = 0
        for j, (_, s) in enumerate(group):
            tb = s.block_table[:P]
            tables[B + j, :len(tb)] = tb
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
            p_temp[j] = s.params.temperature
            p_topp[j] = s.params.top_p
            off += t
        for i, s in decode_seated:
            if self._bt_pages[i] != len(s.block_table):
                self._refresh_bt_row(i, s)
        tables[:B] = self._bt

        dev = self.device
        tokens, positions, steps_left, active = self._merged_carry()
        p_dev = torch.from_numpy(p_int).to(dev)
        d_ids, d_pos, d_row, d_write = (p_dev[k * Sp:(k + 1) * Sp]
                                        for k in range(4))
        d_valid = p_dev[4 * Sp:4 * Sp + Bp]
        d_last = p_dev[4 * Sp + Bp:]
        samp = torch.from_numpy(np.concatenate(
            [self._temp, p_temp, self._topp, p_topp])).to(dev)
        tables_dev = torch.from_numpy(tables).to(dev)
        rows = torch.arange(B, device=dev)
        page = tables_dev[rows, (positions // ps).clamp(max=P - 1)]
        none = torch.full_like(positions, -1)
        write = torch.where(active, page * ps + positions % ps,
                            torch.full_like(positions, self._num_slots_flat))
        logits, _, _ = llama.ragged_paged_forward(
            self.params, self.cfg,
            torch.cat([tokens, d_ids])[None], torch.cat([positions, d_pos])[None],
            self.state.k, self.state.v, torch.cat([write, d_write])[None],
            torch.cat([torch.where(active, rows.int(), none), d_row]),
            tables_dev,
            torch.cat([torch.where(active, positions + 1, none + 1), d_valid]),
            torch.cat([rows, d_last.long()]),
            impl=self.ecfg.attention_impl, page_size=ps,
        )  # [B + Bp, V]
        nxt = _sample(logits, samp[:B + Bp], samp[B + Bp:], self._decode_gen,
                      _sample_mode([s for _, s in decode_seated + group]))
        lps = _chosen_logprob(logits, nxt)
        d_next = nxt[:B]
        steps_left = torch.where(active, steps_left - 1, steps_left)
        self._carry = (
            torch.where(active, d_next, tokens),
            torch.where(active, positions + 1, positions),
            steps_left,
            active & ~torch.isin(d_next, self._eos) & (steps_left > 0))
        # decode ids (-1 = frozen row), first-token candidates and their
        # log-probabilities: the dispatch's one host read
        ids = torch.cat([torch.where(active, d_next, none), nxt[B:]])
        both = torch.stack([ids.float(), lps]).cpu().numpy()

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
        self._reap_first_tokens(group, done, both[0, B:], both[1, B:],
                                outputs)
        self._walk_block(both[:1, :B], both[1:, :B],
                         [(i, s, advs[id(s)]) for i, s in decode_seated],
                         outputs)

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
        # publish full pages for prefix reuse, then drop our references
        self.allocator.publish(seq.token_ids, seq.block_table)
        self._release_seq(seq)

    def _release_seq(self, seq: _Seq) -> None:
        if seq.block_table:
            self.allocator.release(seq.block_table)
            seq.block_table = []

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
        # every issued block has been processed here, so the host state
        # is exact
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
