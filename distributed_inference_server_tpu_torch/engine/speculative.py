"""Speculative decoding: a draft model proposes, the target verifies (port of
``distributed_inference_server_tpu/engine/speculative.py``).

A small draft model proposes ``gamma`` tokens one at a time; the target
scores all of them in ONE forward pass over T = gamma + 1 positions, and
rejection sampling accepts a prefix, resamples at the first rejection and
adds a bonus token when everything was accepted. At temperature 0 this is
exact greedy matching, so greedy output equals plain greedy decoding
whatever the draft.

- ``AcceptanceTracker``: the rolling acceptance rate and estimated speedup
  over a window of rounds, auto-disable below the threshold (default 50 %)
  and re-enable after a probation time; ``PatternTrackers`` keeps one per
  request pattern (``spec_signature``: temperature band x top-p band), so
  a badly speculating pattern is disabled alone.
- ``accept_and_resample``: the shared rejection-sampling core, used by the
  dense-cache ``spec_round`` here and by the engine's paged speculative
  blocks. Top-p rows are verified nucleus-aware: the draft samples from
  its nucleus-filtered q~ and the target side is filtered the same way, so
  the output law is exactly nucleus sampling from the target.
- ``spec_round`` / ``speculative_generate``: rounds over the dense KV cache
  (``models/llama.py forward``), the correctness anchor of the engine's
  paged rounds.

Rolled-back positions need no cache surgery: entries past a row's valid
length are never attended and are overwritten when the position is reused.
Random draws come from an explicit ``torch.Generator``, or from given
uniform noise (the engine's looped blocks hash a device counter:
``ops/sampling.py counter_uniform``); the bits differ from JAX's, so
sampled rounds are compared by distribution.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional, Tuple

import numpy as np
import torch

from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.configs import ModelConfig
from distributed_inference_server_tpu_torch.ops.sampling import (
    _gumbel_argmax,
    nucleus_probs,
)


@dataclass(frozen=True)
class SpecConfig:
    num_draft_tokens: int = 4  # gamma
    disable_threshold: float = 0.5  # auto-disable below this rate
    window: int = 64  # rounds in the rolling acceptance window
    # after an auto-disable, re-enable and re-measure once this much time
    # has passed (traffic changes); <= 0 keeps it disabled until a reset
    reenable_after_s: float = 30.0


class AcceptanceTracker:
    """Rolling acceptance rate / speedup with auto-disable and probation
    re-enable."""

    def __init__(self, cfg: SpecConfig, clock=None):
        self.cfg = cfg
        self._clock = clock or time.monotonic
        # (accepted, proposed, rows) per recorded round
        self._events: Deque[Tuple[int, int, int]] = deque(maxlen=cfg.window)
        self._disabled_at: Optional[float] = None

    def update(self, accepted: int, proposed: int, rows: int = 1) -> None:
        """Record one round: ``accepted`` / ``proposed`` summed over the
        ``rows`` batch rows that speculated in it."""
        self._events.append((accepted, proposed, rows))
        if (len(self._events) == self.cfg.window
                and self.rate() < self.cfg.disable_threshold):
            self._disabled_at = self._clock()

    def totals(self) -> Tuple[int, int, int, int]:
        """(accepted, proposed, rows, emitted) summed over the window."""
        acc = prop = rows = 0
        for a, p, r in tuple(self._events):
            acc += a
            prop += p
            rows += r
        return acc, prop, rows, acc + rows

    def rate(self) -> float:
        acc, prop, _, _ = self.totals()
        return acc / prop if prop else 1.0

    def speedup(self) -> float:
        """Tokens emitted per row per target forward (>= 1.0): accepted
        draft tokens plus the bonus / resampled token."""
        _, _, rows, emitted = self.totals()
        return emitted / rows if rows else 1.0

    def force_disable(self) -> None:
        """Put the tracker on probation now (admin and test hook)."""
        self._disabled_at = self._clock()

    @property
    def enabled(self) -> bool:
        """Pure read: never disabled, or the probation time has passed."""
        if self._disabled_at is None:
            return True
        cooldown = self.cfg.reenable_after_s
        return cooldown > 0 and self._clock() - self._disabled_at >= cooldown

    def consume_probation(self) -> bool:
        """Engine-thread check: once the probation time has passed,
        re-enable with a fresh window (a still-bad pattern disables again
        within one window)."""
        if self._disabled_at is not None and self.enabled:
            self.reset()
        return self._disabled_at is None

    def reset(self) -> None:
        self._events.clear()
        self._disabled_at = None


def spec_signature(params) -> Tuple[int, int]:
    """Request-pattern key: temperature band x top-p band (at most 12
    trackers). ``params`` has ``temperature`` and ``top_p``."""
    t = params.temperature
    p = params.top_p
    tband = 0 if t <= 0.0 else (1 if t <= 0.5 else (2 if t <= 1.0 else 3))
    pband = 0 if p >= 1.0 else (1 if p >= 0.9 else 2)
    return (tband, pband)


class PatternTrackers:
    """One ``AcceptanceTracker`` per request pattern. Writers run on the
    engine thread, the aggregate readers on stats threads; one lock guards
    the registry and every tracker, and ``enabled`` never inserts."""

    def __init__(self, cfg: SpecConfig, clock=None):
        self.cfg = cfg
        self._clock = clock
        self._by_sig: dict = {}
        self._lock = threading.Lock()

    def _tracker_locked(self, sig) -> AcceptanceTracker:
        tr = self._by_sig.get(sig)
        if tr is None:
            tr = self._by_sig[sig] = AcceptanceTracker(self.cfg,
                                                       clock=self._clock)
        return tr

    def consume_probation(self, sig) -> bool:
        with self._lock:
            return self._tracker_locked(sig).consume_probation()

    def enabled(self, sig) -> bool:
        with self._lock:
            tr = self._by_sig.get(sig)
            return tr.enabled if tr is not None else True

    def update(self, sig, accepted: int, proposed: int,
               rows: int = 1) -> None:
        with self._lock:
            self._tracker_locked(sig).update(accepted, proposed, rows)

    def disable(self, sig) -> None:
        with self._lock:
            self._tracker_locked(sig).force_disable()

    def reset(self) -> None:
        """Drop every pattern's history and disables."""
        with self._lock:
            self._by_sig.clear()

    def _totals_locked(self):
        acc = prop = rows = emitted = 0
        for tr in self._by_sig.values():
            a, p, r, e = tr.totals()
            acc += a
            prop += p
            rows += r
            emitted += e
        return acc, prop, rows, emitted

    def rate(self) -> float:
        with self._lock:
            acc, prop, _, _ = self._totals_locked()
        return acc / prop if prop else 1.0

    def speedup(self) -> float:
        with self._lock:
            _, _, rows, emitted = self._totals_locked()
        return emitted / rows if rows else 1.0

    @property
    def all_enabled(self) -> bool:
        with self._lock:
            return all(tr.enabled for tr in self._by_sig.values())

    def stats(self) -> dict:
        """Aggregate and per-pattern rates for ``/server/stats``."""
        with self._lock:
            acc, prop, rows, emitted = self._totals_locked()
            return {
                "acceptance_rate": round(acc / prop if prop else 1.0, 4),
                "estimated_speedup": round(
                    emitted / rows if rows else 1.0, 4),
                "enabled": all(tr.enabled for tr in self._by_sig.values()),
                "patterns": {
                    f"temp_band={t},top_p_band={p}": {
                        "acceptance_rate": round(tr.rate(), 4),
                        "estimated_speedup": round(tr.speedup(), 4),
                        "enabled": tr.enabled,
                    }
                    for (t, p), tr in sorted(self._by_sig.items())
                },
            }


def _probs(logits: torch.Tensor, temperature: torch.Tensor) -> torch.Tensor:
    """Temperature distributions [..., V] f32; temperature 0 gives the
    one-hot argmax (greedy as a limit of sampling, so the accept math is
    the same for every row)."""
    x = logits.float()
    # a scatter, not F.one_hot: no host check, so a CUDA graph captures it
    greedy = torch.zeros_like(x).scatter_(
        -1, torch.argmax(x, dim=-1, keepdim=True), 1.0)
    t = temperature.clamp(min=1e-6)[..., None]
    sampled = torch.softmax(x / t, dim=-1)
    return torch.where((temperature <= 0.0)[..., None], greedy, sampled)


def categorical(probs: torch.Tensor, generator=None,
                uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One draw per row from ``probs`` [..., V] (Gumbel-max over
    log(probs + 1e-30), as ``jax.random.categorical``), with ``uniform``
    noise of probs' shape when given, else from ``generator``. int32."""
    return _gumbel_argmax(torch.log(probs + 1e-30), generator,
                          uniform).to(torch.int32)


def accept_and_resample(
    target_ps: torch.Tensor,  # [B, gamma + 1, V] target distributions
    draft_toks: torch.Tensor,  # [B, gamma] draft proposals
    draft_qs: torch.Tensor,  # [B, gamma, V] the laws they were drawn from
    generator=None,
    spec_ok: Optional[torch.Tensor] = None,  # [B] False: reject at 0
    top_p: Optional[torch.Tensor] = None,  # [B] nucleus-aware verify
    greedy_only: bool = False,
    u: Optional[torch.Tensor] = None,  # [B, gamma] accept noise
    noise: Optional[torch.Tensor] = None,  # [B, V] resample noise
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rejection-sampling core of one speculative round.

    Per row: accept the longest prefix of draft tokens with
    u < min(1, p/q), then draw the next token from norm(max(p - q, 0)) at
    the first rejection (from the target's bonus distribution when all
    were accepted: q := 0). With ``top_p`` the target distributions are
    nucleus-filtered and renormalized first; ``draft_qs`` must be the laws
    the proposals were ACTUALLY drawn from (already filtered), and are not
    filtered again. ``spec_ok`` False rows reject at position 0 and draw
    their one token from the (filtered) target. ``greedy_only`` (every
    row at temperature 0: one-hot laws) takes the argmax instead of a
    draw. The noise comes from ``u`` / ``noise`` when given, else from
    ``generator`` (``u`` is not needed when ``greedy_only``: one-hot laws
    accept iff p > 0).

    Returns (tokens [B, gamma + 1] int32, row r's valid prefix
    tokens[r, :num_accepted[r] + 1]; num_accepted [B] int32 in
    [0, gamma])."""
    B, gamma = draft_toks.shape
    dev = draft_toks.device
    rows = torch.arange(B, device=dev)
    if top_p is not None:
        target_ps = nucleus_probs(target_ps, top_p[:, None])
    idx = draft_toks.long()[..., None]
    p_at = target_ps[:, :gamma].gather(-1, idx)[..., 0]  # [B, gamma]
    q_at = draft_qs.gather(-1, idx)[..., 0]
    if greedy_only:
        u = torch.zeros((B, gamma), dtype=torch.float32, device=dev)
    elif u is None:
        u = torch.rand((B, gamma), generator=generator, device=dev,
                       dtype=torch.float32)
    accept = u < torch.clamp(p_at / q_at.clamp(min=1e-30), max=1.0)
    num_accepted = torch.cumprod(accept.to(torch.int32), 1).sum(
        1, dtype=torch.int32)
    if spec_ok is not None:
        num_accepted = torch.where(spec_ok, num_accepted,
                                   torch.zeros_like(num_accepted))
    rejected = num_accepted < gamma
    if spec_ok is not None:
        rejected = rejected & spec_ok
    na = num_accepted.long()
    p_rej = target_ps[rows, na]  # [B, V]
    q_rej = torch.where(rejected[:, None],
                        draft_qs[rows, na.clamp(max=gamma - 1)],
                        torch.zeros_like(p_rej))
    resid = (p_rej - q_rej).clamp(min=0.0)
    resid_sum = resid.sum(-1, keepdim=True)
    # numerical corner (p == q exactly): fall back to the target
    resid = torch.where(resid_sum > 1e-30, resid, p_rej)
    if greedy_only:
        extra = torch.argmax(resid, dim=-1).to(torch.int32)
    else:
        extra = categorical(resid, generator, noise)
    widx = torch.arange(gamma + 1, device=dev)[None]
    padded = torch.cat([draft_toks.to(torch.int32),
                        torch.zeros((B, 1), dtype=torch.int32, device=dev)],
                       1)
    tokens = torch.where(
        widx < num_accepted[:, None], padded,
        torch.where(widx == num_accepted[:, None], extra[:, None],
                    torch.zeros_like(padded)))
    return tokens, num_accepted


@torch.no_grad()
def spec_round(
    draft_params: llama.Params,
    draft_cfg: ModelConfig,
    draft_cache: llama.KVCache,
    params: llama.Params,
    cfg: ModelConfig,
    cache: llama.KVCache,
    last_token: torch.Tensor,  # [B] most recent accepted token
    seq_len: torch.Tensor,  # [B] tokens resident per row
    temperature: torch.Tensor,  # [B]
    generator: Optional[torch.Generator],
    gamma: int,
    live: Optional[torch.Tensor] = None,  # [B] rows still generating
    top_p: Optional[torch.Tensor] = None,  # [B] nucleus-aware verify
):
    """One speculative round over the dense caches (updated in place).
    Returns (tokens [B, gamma + 1], num_emitted [B] in [0, gamma + 1],
    num_accepted [B], new seq_len); row r's output is
    tokens[r, :num_emitted[r]]. ``live`` False rows emit nothing and keep
    their seq_len. The draft runs gamma + 1 steps: the last one writes the
    last proposal's K/V (needed when all are accepted), its sample is
    dropped."""
    tok, pos = last_token, seq_len
    dtoks, dqs = [], []
    for _ in range(gamma + 1):
        logits, draft_cache = llama.forward(
            draft_params, draft_cfg, tok[:, None], pos[:, None],
            draft_cache, pos[:, None], pos + 1)
        q = _probs(logits[:, 0], temperature)
        if top_p is not None:
            # proposals come from the same q~ the verifier scores
            q = nucleus_probs(q, top_p)
        nxt = categorical(q, generator)
        dtoks.append(nxt)
        dqs.append(q)
        tok, pos = nxt, pos + 1
    draft_toks = torch.stack(dtoks[:gamma], 1)
    draft_qs = torch.stack(dqs[:gamma], 1)
    ver = torch.cat([last_token[:, None].to(torch.int32), draft_toks], 1)
    positions = seq_len[:, None] + torch.arange(
        gamma + 1, device=seq_len.device)[None]
    logits, cache = llama.forward(params, cfg, ver, positions, cache,
                                  positions, seq_len + gamma + 1)
    target_ps = _probs(logits, temperature[:, None])
    tokens, num_accepted = accept_and_resample(
        target_ps, draft_toks, draft_qs, generator, top_p=top_p)
    num_emitted = num_accepted + 1
    if live is not None:
        num_emitted = torch.where(live, num_emitted,
                                  torch.zeros_like(num_emitted))
    return tokens, num_emitted, num_accepted, seq_len + num_emitted


@torch.no_grad()
def speculative_generate(
    draft_params: llama.Params,
    draft_cfg: ModelConfig,
    params: llama.Params,
    cfg: ModelConfig,
    prompt_ids: torch.Tensor,  # [B, T0], no padding
    max_new_tokens: int,
    max_seq: int,
    spec: SpecConfig = SpecConfig(),
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    tracker: Optional[AcceptanceTracker] = None,
    top_p: float = 1.0,
) -> np.ndarray:
    """Generate with speculative decoding; returns [B, max_new_tokens].
    A host loop over rounds; rows finish in different rounds (the extra
    tokens are trimmed). While ``tracker`` is disabled, rounds take
    gamma = 1 until it is re-enabled."""
    dev = params["embed"].device
    prompt_ids = prompt_ids.to(dev, torch.int32)
    B, T0 = prompt_ids.shape
    gamma_cfg = spec.num_draft_tokens
    needed = T0 + max_new_tokens + gamma_cfg + 1
    if needed > max_seq:
        raise ValueError(
            f"max_seq={max_seq} too small: prompt {T0} + max_new_tokens "
            f"{max_new_tokens} + speculative overshoot {gamma_cfg + 1} "
            f"needs {needed}")
    temp = torch.full((B,), float(temperature), dtype=torch.float32,
                      device=dev)
    topp = (torch.full((B,), float(top_p), dtype=torch.float32, device=dev)
            if top_p < 1.0 else None)
    positions = torch.arange(T0, device=dev).expand(B, T0)
    lens = torch.full((B,), T0, dtype=torch.int32, device=dev)
    dcache = llama.KVCache.create(draft_cfg, B, max_seq,
                                  dtype=draft_params["embed"].dtype,
                                  device=dev)
    llama.forward(draft_params, draft_cfg, prompt_ids, positions, dcache,
                  positions, lens)
    cache = llama.KVCache.create(cfg, B, max_seq,
                                 dtype=params["embed"].dtype, device=dev)
    logits, cache = llama.forward(params, cfg, prompt_ids, positions, cache,
                                  positions, lens)
    p0 = _probs(logits[:, -1], temp)
    if topp is not None:
        p0 = nucleus_probs(p0, topp)
    last = categorical(p0, generator)
    out = [[int(t)] for t in last.tolist()]
    seq_len = lens  # the caches hold T0 tokens; `last` is not written yet
    while min(len(o) for o in out) < max_new_tokens:
        use_gamma = (spec.num_draft_tokens
                     if tracker is None or tracker.enabled else 1)
        live_np = np.asarray([len(o) < max_new_tokens for o in out])
        live = torch.as_tensor(live_np, device=dev)
        tokens, emitted, accepted, seq_len = spec_round(
            draft_params, draft_cfg, dcache, params, cfg, cache, last,
            seq_len, temp, generator, use_gamma, live, topp)
        tok_np = tokens.cpu().numpy()
        em_np = emitted.cpu().numpy()
        for b in range(B):
            out[b].extend(tok_np[b, :em_np[b]].tolist())
        rows = torch.arange(B, device=dev)
        last = torch.where(
            live, tokens[rows, (emitted.clamp(min=1) - 1).long()], last)
        if tracker is not None and use_gamma > 1 and live_np.any():
            n_live = int(live_np.sum())
            tracker.update(int(accepted.cpu().numpy()[live_np].sum()),
                           n_live * use_gamma, rows=n_live)
    return np.asarray([o[:max_new_tokens] for o in out])
