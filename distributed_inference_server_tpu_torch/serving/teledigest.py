"""Performance telemetry: deterministic, mergeable log-bucket latency
digests with sliding epoch rings, the step clock's counter store, and SLO /
goodput accounting (the port's copy of
``distributed_inference_server_tpu/serving/teledigest.py``; pure Python,
its wire dicts equal the reference's for the same observations).

- ``bucket_of`` / ``bucket_value_ms``: a fixed logarithmic layout (8
  buckets per octave, ~4.4 % mid-bucket quantile error); everything
  downstream is integer counts, so merging digests is exact.
- ``WindowedDigest``: a ring of wall-clock-aligned epochs (``time //
  epoch_s``), each with sparse bucket counts and exact n / integer-µs sum;
  ``count`` makes it a windowed counter (SLO burn rates). Every method
  that reads the clock takes ``now``, the injectable clock.
- ``merge_digests`` / ``window_stats`` / ``windowed_count``: the algebra on
  wire dicts (sorted epochs, parallel bucket / count arrays).
- ``PerfTelemetry``: the per-process store of named digests and cumulative
  counters (``step.<engine>.<kind>.<field>``, ``events.<engine>.<event>``)
  behind ``GET /server/perf``; ``clock`` is its injectable wall clock.
- ``SloSettings`` / ``slo_verdict``: request-level objectives and the
  verdict a finished request's phase partition earns.
- ``build_perf_payload``: the ``GET /server/perf`` JSON.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple)

# ---------------------------------------------------------------------------
# Log-bucket layout (shared by every digest; never reconfigured — a
# layout change would silently mis-merge against older digests)
# ---------------------------------------------------------------------------

#: buckets per octave: bucket width = 2^(1/8) ≈ +9.05%, so a quantile
#: read at the geometric midpoint is within ~4.4% of the true value
BUCKETS_PER_OCTAVE = 8
#: smallest resolvable value (milliseconds): 1 microsecond
MIN_VALUE_MS = 1e-3
#: bucket 0 holds values <= MIN_VALUE_MS (including exact zeros);
#: the top bucket absorbs everything past ~38 hours
MAX_BUCKET = 37 * BUCKETS_PER_OCTAVE

_LOG2_MIN = math.log2(MIN_VALUE_MS)


def bucket_of(value_ms: float) -> int:
    """Deterministic value -> bucket index (integers merge exactly)."""
    if not value_ms > MIN_VALUE_MS:  # catches <= MIN, 0, negatives, NaN
        return 0
    idx = 1 + int((math.log2(value_ms) - _LOG2_MIN) * BUCKETS_PER_OCTAVE)
    return idx if idx < MAX_BUCKET else MAX_BUCKET


def bucket_value_ms(idx: int) -> float:
    """Bucket index -> representative value (geometric midpoint)."""
    if idx <= 0:
        return 0.0
    return 2.0 ** (_LOG2_MIN + (idx - 0.5) / BUCKETS_PER_OCTAVE)


# ---------------------------------------------------------------------------
# Sliding epoch ring
# ---------------------------------------------------------------------------


class WindowedDigest:
    """One named series: a ring of wall-clock-aligned epochs, each with
    sparse bucket counts plus exact n/sum. NOT thread-safe on its own —
    PerfTelemetry serializes access (one short lock, no allocation on
    the common path)."""

    __slots__ = ("epoch_s", "ring_epochs", "_epochs")

    def __init__(self, epoch_s: float = 5.0, window_s: float = 60.0):
        self.epoch_s = float(epoch_s)
        # keep one extra epoch beyond the window so a query straddling
        # an epoch boundary still sees a full window behind it
        self.ring_epochs = max(1, int(math.ceil(window_s / self.epoch_s))) + 1
        # epoch index -> [bucket_counts dict, n, sum_us]
        self._epochs: Dict[int, list] = {}

    def epoch_index(self, now: Optional[float] = None) -> int:
        # wall clock, not monotonic: epoch indices must align ACROSS
        # processes so the registry host can merge member epochs
        return int((time.time() if now is None else now) // self.epoch_s)

    def observe(self, value_ms: float, now: Optional[float] = None) -> None:
        ep = self._epoch_locked(self.epoch_index(now))
        b = bucket_of(value_ms)
        ep[0][b] = ep[0].get(b, 0) + 1
        ep[1] += 1
        # exact integer microseconds: float addition is order-dependent
        # in its last bits, which would break the bit-equality of
        # merged views under re-grouping; integers are associative
        ep[2] += int(round(value_ms * 1000.0))

    def count(self, k: int = 1, now: Optional[float] = None) -> None:
        """Bucketless observation: the digest as a windowed counter
        (SLO burn rates — per-epoch n only, still mergeable)."""
        ep = self._epoch_locked(self.epoch_index(now))
        ep[1] += k

    def _epoch_locked(self, idx: int) -> list:
        # _locked: the OWNING PerfTelemetry's lock serializes every
        # mutation path (observe/count are only reached under it);
        # direct WindowedDigest use is single-threaded (tests, merges)
        ep = self._epochs.get(idx)
        if ep is None:
            ep = self._epochs[idx] = [{}, 0, 0]
            if len(self._epochs) > self.ring_epochs:
                for old in sorted(self._epochs)[: len(self._epochs)
                                                - self.ring_epochs]:
                    del self._epochs[old]
        return ep

    def to_wire(self, name: str) -> Dict[str, Any]:
        """Canonical wire dict (== the TeleDigest protowire message):
        epochs sorted by index, bucket/count parallel arrays sorted by
        bucket — byte-stable, so equal contents encode equal."""
        epochs = []
        for idx in sorted(self._epochs):
            counts, n, total = self._epochs[idx]
            buckets = sorted(counts)
            epochs.append({
                "index": idx,
                "buckets": buckets,
                "counts": [counts[b] for b in buckets],
                "n": n,
                "sum_us": total,
            })
        return {"name": name, "epoch_s": self.epoch_s, "epochs": epochs}


# ---------------------------------------------------------------------------
# Wire-dict algebra: ONE merge + ONE quantile path for member-local
# views, the host's fleet merge, and offline re-merges
# ---------------------------------------------------------------------------


def merge_digests(wires: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Exact merge of same-series wire dicts: per-epoch, per-bucket
    count addition. Deterministic: output epochs/buckets are sorted, so
    any grouping/ordering of the inputs yields the identical dict.

    Epoch geometry is part of the key space: a wire whose ``epoch_s``
    differs from the first non-empty input's is EXCLUDED (its epoch
    indices are denominated in a different time unit — adding its
    counts at numerically-colliding indices would corrupt the merged
    windows). The fleet ingest path additionally drops and counts such
    digests at the wire (FleetServer.ingest_telemetry), so this guard
    is the merge algebra staying sound, not the operator signal."""
    name = ""
    epoch_s = 0.0
    acc: Dict[int, list] = {}  # index -> [counts dict, n, sum_us]
    for w in wires:
        if not w:
            continue
        name = name or w.get("name", "")
        epoch_s = epoch_s or float(w.get("epoch_s", 0.0))
        if float(w.get("epoch_s", 0.0)) != epoch_s:
            continue  # foreign epoch geometry: see docstring
        for ep in w.get("epochs", []):
            idx = int(ep.get("index", 0))
            slot = acc.get(idx)
            if slot is None:
                slot = acc[idx] = [{}, 0, 0]
            counts = slot[0]
            for b, c in zip(ep.get("buckets", []), ep.get("counts", [])):
                counts[int(b)] = counts.get(int(b), 0) + int(c)
            slot[1] += int(ep.get("n", 0))
            slot[2] += int(ep.get("sum_us", 0))
    epochs = []
    for idx in sorted(acc):
        counts, n, total = acc[idx]
        buckets = sorted(counts)
        epochs.append({"index": idx, "buckets": buckets,
                       "counts": [counts[b] for b in buckets],
                       "n": n, "sum_us": total})
    return {"name": name, "epoch_s": epoch_s, "epochs": epochs}


def window_stats(wire: Dict[str, Any], window_s: float,
                 as_of_epoch: Optional[int] = None) -> Dict[str, Any]:
    """p50/p90/p99 (+count/mean) over the trailing window of a wire
    dict. Pure and deterministic: given the same dict, window, and
    ``as_of_epoch``, every process computes the identical floats — the
    fleet-smoke merge-identity acceptance compares exactly this."""
    epoch_s = float(wire.get("epoch_s", 0.0)) or 1.0
    if as_of_epoch is None:
        as_of_epoch = int(time.time() // epoch_s)
    first = as_of_epoch - max(1, int(math.ceil(window_s / epoch_s))) + 1
    counts: Dict[int, int] = {}
    n = 0
    total = 0
    for ep in wire.get("epochs", []):
        idx = int(ep.get("index", 0))
        if idx < first or idx > as_of_epoch:
            continue
        for b, c in zip(ep.get("buckets", []), ep.get("counts", [])):
            counts[int(b)] = counts.get(int(b), 0) + int(c)
        n += int(ep.get("n", 0))
        total += int(ep.get("sum_us", 0))
    out: Dict[str, Any] = {"count": n}
    bucketed = sum(counts.values())
    if bucketed:
        out.update(
            p50=_quantile(counts, bucketed, 0.50),
            p90=_quantile(counts, bucketed, 0.90),
            p99=_quantile(counts, bucketed, 0.99),
        )
        out["mean"] = total / 1000.0 / bucketed
    return out


def _quantile(counts: Dict[int, int], n: int, q: float) -> float:
    rank = max(1, int(math.ceil(q * n)))
    seen = 0
    for b in sorted(counts):
        seen += counts[b]
        if seen >= rank:
            return bucket_value_ms(b)
    return bucket_value_ms(MAX_BUCKET)


def windowed_count(wire: Dict[str, Any], window_s: float,
                   as_of_epoch: Optional[int] = None) -> int:
    """Trailing-window n of a count-only digest (SLO burn rates)."""
    return int(window_stats(wire, window_s, as_of_epoch)["count"])


# ---------------------------------------------------------------------------
# Per-process telemetry store
# ---------------------------------------------------------------------------


class PerfTelemetry:
    """Named windowed digests + a flat cumulative counter map — the
    per-process half of the fleet telemetry plane. Thread-safe; the
    per-observation cost is one short lock + a dict bump (the engine
    step clock observes per DISPATCH, never per token)."""

    def __init__(self, epoch_s: float = 5.0, window_s: float = 60.0,
                 clock: Callable[[], float] = time.time):
        self.epoch_s = float(epoch_s)
        self.window_s = float(window_s)
        # wall clock of observations and window reads (tests inject one)
        self.clock = clock
        self._lock = threading.Lock()
        self._digests: Dict[str, WindowedDigest] = {}
        self._counters: Dict[str, float] = {}

    def configure(self, epoch_s: float, window_s: float) -> None:
        """Re-shape the rings (boot-time only — the server applies the
        ``slo.epoch_s``/``slo.window_s`` config before traffic; a live
        reconfigure would discard the accumulated epochs)."""
        with self._lock:
            self.epoch_s = float(epoch_s)
            self.window_s = float(window_s)
            self._digests.clear()

    # -- recording ---------------------------------------------------------

    def observe(self, name: str, value_ms: float) -> None:
        with self._lock:
            self._digest_locked(name).observe(value_ms, self.clock())

    def count(self, name: str, k: int = 1) -> None:
        with self._lock:
            self._digest_locked(name).count(k, self.clock())

    def add_counter(self, name: str, delta: float) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + delta

    def _digest_locked(self, name: str) -> WindowedDigest:
        d = self._digests.get(name)
        if d is None:
            d = self._digests[name] = WindowedDigest(self.epoch_s,
                                                     self.window_s)
        return d

    # -- snapshots ---------------------------------------------------------

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def wire_digests(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {name: d.to_wire(name)
                    for name, d in sorted(self._digests.items())}

    def wire_digest(self, name: str) -> Dict[str, Any]:
        """One series' wire dict ({} when it has no observations) —
        for callers that need a single series (the /server/stats
        sliding p99) without serializing the whole store."""
        with self._lock:
            d = self._digests.get(name)
            return d.to_wire(name) if d is not None else {}

    def wire(self) -> Dict[str, Any]:
        """The FleetTelemetry frame body (sans member_id): bounded by
        construction — a fixed digest-name set × a bounded epoch ring ×
        sparse buckets, and a counter per (engine, kind, field)."""
        with self._lock:
            return {
                "digests": [d.to_wire(name)
                            for name, d in sorted(self._digests.items())],
                "counters": [{"name": n, "value": v}
                             for n, v in sorted(self._counters.items())],
            }

    def stats(self, window_s: Optional[float] = None,
              as_of_epoch: Optional[int] = None) -> Dict[str, Any]:
        window = window_s or self.window_s
        if as_of_epoch is None:
            as_of_epoch = self.as_of_epoch()
        return {
            name: window_stats(w, window, as_of_epoch)
            for name, w in self.wire_digests().items()
        }

    def as_of_epoch(self) -> int:
        return int(self.clock() // self.epoch_s)


# ---------------------------------------------------------------------------
# SLO layer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SloSettings:
    """Config section ``slo`` (serving/config.py): request-level
    latency objectives. 0 = that objective is unset; a request with no
    applicable objective gets no verdict (and never counts toward the
    burn rate). Per-tenant overrides win over the global values."""

    ttft_ms: float = 0.0
    tbt_p99_ms: float = 0.0
    tenant_ttft_ms: Mapping[str, float] = field(default_factory=dict)
    tenant_tbt_ms: Mapping[str, float] = field(default_factory=dict)
    window_s: float = 60.0
    epoch_s: float = 5.0

    def enabled(self) -> bool:
        return bool(self.ttft_ms or self.tbt_p99_ms
                    or self.tenant_ttft_ms or self.tenant_tbt_ms)

    def limits_for(self, tenant: str) -> Tuple[float, float]:
        """(ttft_ms, tbt_ms) applicable to ``tenant`` (0 = none)."""
        return (
            float(self.tenant_ttft_ms.get(tenant, self.ttft_ms)),
            float(self.tenant_tbt_ms.get(tenant, self.tbt_p99_ms)),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ttft_ms": self.ttft_ms,
            "tbt_p99_ms": self.tbt_p99_ms,
            "tenant_ttft_ms": dict(self.tenant_ttft_ms),
            "tenant_tbt_ms": dict(self.tenant_tbt_ms),
            "window_s": self.window_s,
            "epoch_s": self.epoch_s,
        }


def slo_verdict(slo: SloSettings, tenant: str,
                ttft_s: Optional[float], tbt_s: Optional[float],
                status: str) -> Optional[Dict[str, Any]]:
    """Derive a request's SLO verdict from its exact phase partition
    (serving/flightrec.py): ``ttft_s`` is admit -> first token (the
    queue_wait + prefill + peer_fetch phases, exactly), ``tbt_s`` the
    mean inter-token gap of first -> last token (decode + handoff
    stalls — the client observes the stall, so the SLO charges it).
    Returns None when no objective applies; an errored request with an
    applicable objective is always a violation (goodput = useful
    completed work)."""
    ttft_lim, tbt_lim = slo.limits_for(tenant)
    if not ttft_lim and not tbt_lim:
        return None
    ttft_violated = bool(
        ttft_lim and (ttft_s is None or ttft_s * 1000.0 > ttft_lim))
    tbt_violated = bool(
        tbt_lim and tbt_s is not None and tbt_s * 1000.0 > tbt_lim)
    violated = ttft_violated or tbt_violated or status != "ok"
    out: Dict[str, Any] = {
        "verdict": "violated" if violated else "ok",
        "tenant": tenant,
    }
    if ttft_lim:
        out["ttft_violated"] = ttft_violated
    if tbt_lim:
        out["tbt_violated"] = tbt_violated
    if status != "ok":
        out["errored"] = True
    return out


# ---------------------------------------------------------------------------
# Catalogs: the /server/perf fields, telemetry metric names and digest
# series, as the reference lists them
# ---------------------------------------------------------------------------

#: top-level fields of the GET /server/perf payload
PERF_FIELDS = (
    "as_of_epoch",
    "epoch_s",
    "window_s",
    "engines",
    "windows",
    "slo",
    "digests",
    "fleet",
)

#: telemetry metric names registered in serving/metrics.py (the rest of
#: the metric namespace predates the telemetry plane and is DL006-only)
TELEMETRY_METRICS = (
    "engine_step_seconds_total",
    "engine_step_dispatches_total",
    "engine_step_tokens_total",
    "engine_step_events_total",
    "slo_requests_total",
    "slo_goodput_tokens_total",
    "fleet_telemetry_frames_total",
    "fleet_member_step_tokens",
    "fleet_member_ttft_p99_ms",
)

#: named digest series (the keys of /server/perf "digests"/"windows")
DIGEST_NAMES = (
    "ttft_ms",
    "tbt_ms",
    "queue_wait_ms",
    "latency_ms",
    "step_ms.prefill",
    "step_ms.decode_block",
    "step_ms.mixed",
    "step_ms.loop",
    "slo.ok",
    "slo.violated",
)


def build_perf_payload(
    perf: PerfTelemetry,
    slo: Optional[SloSettings],
    slo_counts: Optional[Dict[str, Dict[str, int]]] = None,
    goodput: Optional[Dict[str, int]] = None,
    fleet_members: Optional[Dict[str, Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Assemble the ``GET /server/perf`` JSON (keys ⊆ PERF_FIELDS).

    ``fleet_members`` (registry host only): member_id -> {"digests":
    {name: wire}, "counters": {...}, "age_s": float} as ingested from
    FleetTelemetry frames. The merged view merges the LOCAL digests
    with every member's, per series, through the same merge_digests /
    window_stats pair an operator would use offline — so re-merging the
    response's own per-member digests reproduces the merged percentiles
    bit-for-bit."""
    as_of = perf.as_of_epoch()
    window = perf.window_s
    local_wires = perf.wire_digests()
    counters = perf.counters()

    engines: Dict[str, Dict[str, Any]] = {}
    for name, value in counters.items():
        parts = name.split(".")
        if parts[0] == "step" and len(parts) == 4:
            _, engine_id, kind, fld = parts
            eng = engines.setdefault(engine_id,
                                     {"kinds": {}, "events": {}})
            eng["kinds"].setdefault(kind, {})[fld] = value
        elif parts[0] == "events" and len(parts) == 3:
            _, engine_id, event = parts
            eng = engines.setdefault(engine_id,
                                     {"kinds": {}, "events": {}})
            eng["events"][event] = int(value)

    windows = {
        name: window_stats(w, window, as_of)
        for name, w in local_wires.items()
        if not name.startswith("slo.")
    }

    payload: Dict[str, Any] = {
        "as_of_epoch": as_of,
        "epoch_s": perf.epoch_s,
        "window_s": window,
        "engines": engines,
        "windows": windows,
        "digests": local_wires,
    }

    slo_block: Dict[str, Any] = {}
    if slo is not None and slo.enabled():
        slo_block["config"] = slo.to_dict()
    if slo_counts:
        slo_block["requests"] = {t: dict(v) for t, v in slo_counts.items()}
    if goodput:
        slo_block["goodput_tokens"] = dict(goodput)
    ok_w = windowed_count(local_wires.get("slo.ok", {}), window, as_of)
    bad_w = windowed_count(local_wires.get("slo.violated", {}), window,
                           as_of)
    if ok_w or bad_w:
        slo_block["window_requests"] = {"ok": ok_w, "violated": bad_w}
        slo_block["burn_rate"] = bad_w / (ok_w + bad_w)
    if slo_block:
        payload["slo"] = slo_block

    if fleet_members is not None:
        # slo.* burn-rate counters stay per-process (a fleet burn rate
        # would need per-member objectives to mean anything), so skip
        # them BEFORE the merge instead of merging and discarding
        series: Dict[str, List[Dict[str, Any]]] = {
            name: [w] for name, w in local_wires.items()
            if not name.startswith("slo.")
        }
        for member_id in sorted(fleet_members):
            for name, w in fleet_members[member_id].get("digests",
                                                        {}).items():
                if not name.startswith("slo."):
                    series.setdefault(name, []).append(w)
        payload["fleet"] = {
            "members": {
                m: {"counters": dict(v.get("counters", {})),
                    "digests": dict(v.get("digests", {})),
                    "age_s": round(float(v.get("age_s", 0.0)), 3)}
                for m, v in fleet_members.items()
            },
            "merged": {
                name: window_stats(merge_digests(ws), window, as_of)
                for name, ws in sorted(series.items())
            },
        }
    return payload
