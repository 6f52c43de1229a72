"""Server configuration: file < env < CLI precedence, validation, hot
reload (the port's copy of ``distributed_inference_server_tpu/serving/
config.py``: the same schema, so one config file loads in both packages).

- **Sources and precedence** (Property 26): a TOML or YAML file,
  overridden by ``DIS_TPU_*`` environment variables, overridden by CLI
  flags: CLI > env > file > defaults. YAML needs the ``yaml`` module,
  imported only when a ``.yaml`` file is read; without it the load is a
  ``ConfigError`` that says so.
- **Validation** (Property 27): range checks on load; the entry point
  exits 2 with ``config error:`` on an invalid value.
  ``check_ported`` refuses a setting whose subsystem cannot run here
  instead of failing at serve time: ``server.grpc_port`` where the
  ``grpcio`` package is not installed.
- **Hot reload**: ``ConfigWatcher`` polls the file's mtime; on a change
  the hot-reloadable subset (batching window and size, queue watermarks
  and timeout, scheduling strategy) goes to the subscribers. A torn or
  missing file keeps the active config and is retried.

Env naming: ``DIS_TPU_<SECTION>__<FIELD>`` (double underscore between
section and field), e.g. ``DIS_TPU_QUEUE__HIGH_WATERMARK=1500``.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from distributed_inference_server_tpu_torch.core.errors import ConfigError
from distributed_inference_server_tpu_torch.core.queue import QueueConfig
from distributed_inference_server_tpu_torch.core.validator import (
    ValidatorConfig,
)
from distributed_inference_server_tpu_torch.serving.batcher import (
    BatcherConfig,
)
from distributed_inference_server_tpu_torch.serving.fleet import (
    parse_connect,
)
from distributed_inference_server_tpu_torch.serving.scheduler import (
    SchedulingStrategy,
)

logger = logging.getLogger(__name__)

ENV_PREFIX = "DIS_TPU_"

# section -> field -> (type, default)
_SCHEMA: Dict[str, Dict[str, Any]] = {
    "server": {
        "host": (str, "0.0.0.0"),
        "port": (int, 8000),
        # gRPC transport next to HTTP (serving/grpc_server.py); 0 = off
        "grpc_port": (int, 0),
        # the JAX package's persistent compilation cache; accepted and
        # without effect in the port, whose kernels build into build/
        "compile_cache_dir": (
            str, "~/.cache/distributed-inference-server-tpu/xla"
        ),
        "num_engines": (int, 1),
        # disaggregated prefill/decode serving (serving/disagg.py;
        # docs/DISAGG.md): comma-separated role per replica, e.g.
        # "prefill,decode" for num_engines=2. "" = all unified (the
        # monolithic default). Validated against num_engines and for
        # nonsensical topologies (decode with no prefill and vice versa).
        "engine_roles": (str, ""),
        "strategy": (str, "least_loaded"),
        "auto_restart": (bool, True),
        "health_check_interval_s": (float, 1.0),
        # failed auto-restarts back off exponentially (jittered, capped)
        # instead of retrying every health sweep (docs/RESILIENCE.md)
        "restart_backoff_s": (float, 1.0),
        "restart_backoff_max_s": (float, 30.0),
        # crash-safe redispatch budget: how many times a zero-token
        # in-flight request may be moved off a dead engine before it
        # fails to its client; 0 = off (docs/RESILIENCE.md)
        "max_redispatch": (int, 2),
        "drain_timeout_s": (float, 30.0),
    },
    "model": {
        "model_dir": (str, ""),
        "model_name": (str, "tiny"),
        "dtype": (str, "bfloat16"),
        # weight-only quantization: none | int8 | int4 (ops/quant.py; the
        # reference's GGUF quantization levels, design.md:324-332 [spec])
        "quantization": (str, "none"),
        # speculative decoding (Req 12): a draft model configured on the
        # server enables speculation inside the serving engine
        "draft_model_name": (str, ""),
        "draft_model_dir": (str, ""),
    },
    "engine": {
        "tensor_parallel": (int, 1),
        # pipeline stages (parallel/pp.py) and context-parallel ring-
        # prefill width (parallel/cp.py) — per-replica mesh axes alongside
        # tensor_parallel; a replica owns tensor*stage*seq devices
        "pipeline_parallel": (int, 1),
        "pp_microbatches": (int, 1),
        "context_parallel": (int, 1),
        # prompts at least this long take the ring-prefill path when
        # context_parallel > 1 (0 = auto: one past the largest bucket)
        "cp_min_tokens": (int, 0),
        # sequence-parallel attention flavor: ring | ulysses
        "sp_impl": (str, "ring"),
        # continuous-batching decode slots per replica
        "max_batch": (int, 64),
        "prefill_buckets": (list, [32, 128, 512]),
        "page_size": (int, 16),
        "num_pages": (int, 2048),
        "max_pages_per_seq": (int, 512),
        # decode-block pipelining (engine/engine.py): device steps (or
        # speculative rounds) per compiled block, and blocks in flight
        "decode_block_size": (int, 8),
        "pipeline_depth": (int, 1),
        "prefill_batch": (int, 16),
        "prefill_token_budget": (int, 8192),
        # ragged mixed-batch stepping (engine/engine.py; docs/PERF.md):
        # > 0 replaces the prefill-quantum + decode-block pair with ONE
        # dispatch over a packed batch of decode rows + prefill chunks
        # whenever prefill work is pending — flat TBT under prompt
        # bursts on a unified replica. The value is the TOTAL packed
        # width (decode slots + prefill budget) and must exceed
        # engine.max_batch. 0 = off (quantum-interleave baseline).
        "mixed_step_tokens": (int, 0),
        # run-to-completion decode blocks (engine/engine.py; docs/PERF.md
        # "Kernel Looping"): decode blocks carry an on-device page
        # free-list and keep stepping inside ONE compiled program until
        # EOS / budget / free-list exhaustion / loop_max_steps, instead
        # of returning to the host every decode_block_size tokens. Also
        # folds the mixed step into K-block form and lets speculation
        # compose with mixed_step_tokens.
        "loop_to_completion": (bool, False),
        # per-launch iteration cap for looped blocks — bounds how long a
        # runaway row can hold the device before admission runs again;
        # degradation rungs shrink the effective cap further
        "loop_max_steps": (int, 256),
        # speculative decoding knobs (Req 12.3-12.5)
        "num_draft_tokens": (int, 4),
        "spec_disable_threshold": (float, 0.5),
        # probation re-enable after auto-disable (Req 12.5 "per request
        # pattern"); <= 0 = stay disabled until an explicit reset
        "spec_reenable_after_s": (float, 30.0),
        # compile all serving programs before a replica reports ready
        "warmup_compile": (bool, True),
        # KV cache quantization: none | int8 (engine/kv_cache.py
        # QuantPool — half the KV memory traffic, double the context
        # capacity)
        "kv_quant": (str, "none"),
    },
    "cache": {
        # host-RAM second tier of the prefix cache (docs/CACHING.md;
        # engine/kv_cache.py HostTier): LRU-evicted refcount-0 prefix
        # pages demote to a bounded host pool instead of dropping, and
        # prefix matching falls through HBM misses into it. 0 = off.
        # Pair with server.strategy=cache_aware so repeated-prefix
        # traffic routes to the replica whose tiers are already warm.
        "host_tier_bytes": (int, 0),
        # host-tier storage encoding for float pools: none | int8
        # (per-vector absmax codes + f32 scales — 4x smaller for f32
        # pools, bounded accuracy cost like disagg.wire_quant) |
        # latent | latent_int8 (rank-r latent page codes, needs
        # cache.latent_rank > 0 — docs/CACHING.md "Latent KV pages")
        "host_tier_quant": (str, "none"),
        # latent page codec rank (TPLA stage (a); docs/CACHING.md
        # "Latent KV pages"): per-(layer, kv-head) projection rank the
        # engine calibrates at construction. 0 = no codec; required > 0
        # by the latent/latent_int8 wire and tier encodings. Rule of
        # thumb: head_dim/4 holds greedy token identity on the models
        # benched so far at ~2.5× fewer bytes than int8.
        "latent_rank": (int, 0),
        # chain depth of the published routing digest (first-K page
        # hashes per cached chain): the cache_aware cost model can only
        # score — and peer-fetch — matches it can see, so deep shared
        # prefixes want a deeper digest (docs/CACHING.md); the price is
        # a bigger per-replica EngineStatus snapshot
        "digest_depth": (int, 8),
        # fleet-wide prefix sharing (docs/CACHING.md): let the
        # cache_aware router FETCH a matched prefix from a warm peer
        # onto a cold replica instead of queueing behind the warm one.
        # false = the pre-fetch two-way routing (warm | recompute).
        "peer_fetch": (bool, True),
        # cost-model weights (scheduler.FetchCosts), in pages of prefill
        # recompute: minimum fetchable gain worth a wire transfer,
        # wire cost per fetched page (< 1 or fetching never pays), and
        # the queueing penalty per active/waiting request on a replica
        "fetch_min_pages": (int, 2),
        "fetch_page_cost": (float, 0.25),
        "fetch_load_cost": (float, 4.0),
    },
    "disagg": {
        # migration budget per handoff: past the deadline (or after the
        # retries) the request decodes in place on its prefill engine
        "handoff_timeout_s": (float, 5.0),
        "handoff_retries": (int, 1),
        # transfer backend: "inproc" (zero-copy object pass) or
        # "protowire" (round-trips the KvHandoff protobuf framing —
        # the cross-process wire format, exercised in-process)
        "channel": (str, "inproc"),
        # streamed handoff (docs/DISAGG.md "Streaming handoff"): the
        # immutable prefix serializes in page-group chunks while the
        # sequence keeps decoding on the source; off = the monolithic
        # stop-the-world export (A/B baseline)
        "stream": (bool, True),
        "chunk_pages": (int, 8),
        # per-chunk wire encoding of float KV pools: none | int8
        # (per-vector absmax codes + f32 scales — halves-plus the bytes
        # moved, bounded accuracy cost; quantized pools pass through) |
        # latent | latent_int8 (rank-r latent page codes, needs
        # cache.latent_rank > 0 — several-fold fewer bytes than int8,
        # docs/CACHING.md "Latent KV pages")
        "wire_quant": (str, "none"),
    },
    "faults": {
        # fault injection (serving/faults.py; docs/RESILIENCE.md):
        # semicolon-separated "point:key=val,..." rules, e.g.
        # "disagg.chunk:nth=3;runner.step:prob=0.01". "" = disarmed (the
        # production default — injection points are a global load + None
        # check). Reachable via env as DIS_TPU_FAULTS__SPEC. Never arm
        # in production.
        "spec": (str, ""),
        "seed": (int, 0),
    },
    "tracing": {
        # OTLP/HTTP collector URL for span export (utils/otlp.py), e.g.
        # http://collector:4318/v1/traces; empty = in-memory ring only
        "otlp_endpoint": (str, ""),
        "service_name": (str, "distributed-inference-server-tpu"),
    },
    "distributed": {
        # multi-host data plane (parallel/distributed.py): every process
        # of the fleet runs the same config with its own process_id
        # (-1 = platform auto-detection); num_processes 1 = single host
        "coordinator_address": (str, ""),
        "num_processes": (int, 1),
        "process_id": (int, -1),
    },
    "queue": {
        "high_watermark": (int, 1000),
        "low_watermark": (int, 500),
        "request_timeout_s": (float, 30.0),
        "max_queue_size": (int, 2000),
        # per-tenant fair admission (core/queue.py; docs/FLEET.md):
        # deficit-weighted round robin across tenants within each
        # priority level, so one hot tenant cannot starve the fleet.
        # Requests carry a "tenant" field; absent = "default". Forces
        # the Python queue tier (the native tier has no tenant lanes).
        "tenant_fairness": (bool, False),
        # "tenantA=2,tenantB=1": relative dequeue weights; unlisted
        # tenants weigh 1. "" = all equal.
        "tenant_weights": (str, ""),
    },
    "fleet": {
        # multi-host fleet control plane (serving/fleet.py,
        # serving/remote_runner.py; docs/FLEET.md). enabled=true on the
        # REGISTRY HOST starts the fleet listener; a WORKER process sets
        # connect=host:port instead and joins by heartbeating.
        "enabled": (bool, False),
        "host": (str, "127.0.0.1"),
        "port": (int, 0),  # 0 = ephemeral (tests/smoke)
        "connect": (str, ""),
        "member_id": (str, ""),  # "" = derived hostname:pid
        "heartbeat_interval_s": (float, 0.5),
        # member aging: alive -> suspect after suspect_after_s without a
        # beat (routing avoids it), suspect -> dead after dead_after_s
        # (in-flight requests take the crash-safe redispatch path)
        "suspect_after_s": (float, 2.0),
        "dead_after_s": (float, 5.0),
        # dynamic role rebalancing (RoleBalancer): a unified engine
        # re-roles to prefill when queued+waiting prompts per admission
        # replica crosses rerole_high_ratio, and back below
        # rerole_low_ratio; the band plus rerole_cooldown_s between
        # flips is the hysteresis that stops role flapping
        "rerole": (bool, False),
        "rerole_high_ratio": (float, 4.0),
        "rerole_low_ratio": (float, 1.0),
        "rerole_cooldown_s": (float, 10.0),
        "rerole_interval_s": (float, 0.5),
        # fleet KV data plane (serving/fleet_kv.py; docs/FLEET.md "KV
        # data plane"): workers bind a KV data listener (kv_data_port;
        # 0 = ephemeral) advertised per heartbeat; the registry host
        # dials it lazily for cross-host handoff and peer prefix
        # fetch. kv_enabled=false keeps a worker control-plane-only
        # (no handoff target, no fetch source).
        "kv_enabled": (bool, True),
        "kv_data_port": (int, 0),
        # cost of moving one page from a REMOTE peer, in recompute-page
        # units (scheduler.FetchCosts.remote_page_cost): pricier than
        # cache.fetch_page_cost so the route/fetch/recompute decision
        # stays honest about the slower cross-host wire
        "kv_page_cost": (float, 0.6),
        # bounded in-flight bulk streams per member data channel; the
        # (N+1)th concurrent handoff/fetch fails fast to its local
        # fallback instead of queueing behind multi-MB transfers
        "kv_max_streams": (int, 4),
        "kv_connect_timeout_s": (float, 5.0),
        # member<->member KV mesh (serving/fleet_mesh.py; docs/FLEET.md
        # "KV mesh"): the registry brokers introductions (KvIntro
        # frames) and members dial each other's data listeners
        # directly, so fetch bytes scale with member count instead of
        # relaying through the registry host
        "mesh_enabled": (bool, False),
        # learned wire rates (MeshWireRates): observed chunk
        # bytes/seconds aggregate in a sliding window this wide; a
        # wire with no observation in the window is COLD and charges
        # kv_page_cost as the prior. kv_rate_prior is the byte rate
        # kv_page_cost is assumed to price (default ~1 Gbit/s) — the
        # learned cost is kv_page_cost * prior/learned, clamped.
        # kv_rate_prior=0 disables learned pricing (constant only).
        "kv_rate_window_s": (float, 30.0),
        "kv_rate_prior": (float, 125000000.0),
        # registry HA (serving/fleet_ha.py; docs/FLEET.md "Registry
        # HA"): the ORDERED endpoint list every fleet process agrees
        # on. On a registry host it must contain this host's own
        # host:port (list position breaks election ties); on a worker
        # it is the full set of registries to heartbeat (dual-
        # heartbeat keeps every standby's member table warm). Empty =
        # HA off (single-registry fleet, no behavior change).
        "registries": (tuple, []),
        # lease aging mirrors member aging: a standby treats the
        # primary as suspect after lease_suspect_s without a
        # RegistryLease frame and promotes (epoch+1) after lease_s
        "lease_s": (float, 3.0),
        "lease_suspect_s": (float, 1.5),
        # standby_http=true (default) keeps every registry's HTTP
        # ingress open — multi-ingress serving through any registry;
        # false gates /generate admission to the current primary
        "standby_http": (bool, True),
    },
    "health": {
        # gray-failure defense (serving/health.py HealthScorer;
        # docs/RESILIENCE.md "Gray failures and overload"): a periodic
        # scorer demotes engines healthy -> degraded -> ejected on
        # telemetry evidence (step-clock wedge, windowed p99 far above
        # the fleet median, repeated wire failures) with two-sided
        # hysteresis; routing deprioritizes degraded replicas and
        # excludes ejected ones while any alternative exists.
        "enabled": (bool, True),
        "interval_s": (float, 1.0),
        # wedge: no step-clock dispatch progress while work is queued
        # for this long (armed only after the engine dispatched once)
        "stall_s": (float, 5.0),
        # latency demotion band: bad above latency_ratio x the median
        # of the other sources' p99s, clean below recover_ratio x it
        "latency_ratio": (float, 3.0),
        "recover_ratio": (float, 1.5),
        # consecutive bad/clean evaluations to move one level down/up
        "demote_after": (int, 3),
        "recover_after": (int, 3),
        # windowed samples required before a latency verdict is trusted
        "min_window_requests": (int, 8),
        # consecutive wire failures ejecting a member's engines (also
        # the KV data channel breaker's closed -> open threshold)
        "wire_failures": (int, 3),
        # breaker open -> half-open probe delay
        "breaker_open_s": (float, 5.0),
        # shared retry budget (redispatch / handoff retry / kv
        # reconnect): retries per window as a fraction of admits,
        # floored at retry_budget_min
        "retry_budget_ratio": (float, 0.1),
        "retry_budget_min": (int, 3),
        "retry_window_s": (float, 10.0),
        # SLO burn-rate escalation input to the degradation ladder
        # (serving/degradation.py): burn >= slo_burn_high escalates to
        # REJECT_LOW_PRIORITY (>= half of it to REDUCED_BATCH_SIZE)
        # once the window holds slo_burn_min_requests verdicts
        "slo_burn_high": (float, 0.5),
        "slo_burn_min_requests": (int, 20),
    },
    "admission": {
        # deadline-aware admission shedding (serving/health.py
        # AdmissionControl): requests shed AT ADMISSION — 503 +
        # Retry-After + the distinct admission_shed code — when the
        # windowed queue-wait estimate already blows their deadline,
        # instead of queueing doomed work toward queue_timeout.
        "shed_enabled": (bool, True),
        # explicit deadline (ms); 0 = derive from the applicable
        # (per-tenant) slo.ttft_ms objective
        "deadline_ms": (float, 0.0),
        # deadline = deadline_factor x the applicable TTFT objective
        "deadline_factor": (float, 1.0),
        # brownout ordering on the DRR weights (queue.tenant_weights):
        # tenant weight w sheds at estimate > deadline * w / w_max, so
        # the lowest-weight tenants brown out first
        "brownout": (bool, True),
        # cold-estimator guard: no shedding until the window holds this
        # many queue-wait samples
        "min_window_requests": (int, 8),
        "retry_after_cap_s": (float, 30.0),
    },
    "slo": {
        # SLO / goodput accounting (serving/teledigest.py SloSettings;
        # docs/OBSERVABILITY.md "Performance telemetry"): request-level
        # latency objectives. 0 = that objective unset (requests with
        # no applicable objective get no verdict and never count
        # toward the burn rate). flightrec.finish() derives the verdict
        # from the exact phase partition; violations feed
        # slo_requests_total{tenant,verdict} and the windowed burn rate
        # at GET /server/perf.
        "ttft_ms": (float, 0.0),
        "tbt_p99_ms": (float, 0.0),
        # per-tenant overrides, "tenantA=500,tenantB=250" (ms); an
        # override wins over the global objective for that tenant
        "tenant_ttft_ms": (str, ""),
        "tenant_tbt_ms": (str, ""),
        # windowed-digest geometry shared by /server/perf percentiles,
        # the /server/stats sliding p99, and SLO burn rates: epochs of
        # epoch_s seconds, percentiles over the trailing window_s
        "window_s": (float, 60.0),
        "epoch_s": (float, 5.0),
    },
    "batcher": {
        "window_ms": (float, 50.0),
        "max_batch_size": (int, 32),
    },
    "validator": {
        "max_context_tokens": (int, 8192),
        "max_output_tokens": (int, 4096),
    },
}

# (section, field) pairs that may change at runtime without restart
HOT_RELOADABLE = {
    ("batcher", "window_ms"),
    ("batcher", "max_batch_size"),
    ("queue", "high_watermark"),
    ("queue", "low_watermark"),
    ("queue", "request_timeout_s"),
    ("server", "strategy"),
}


def parse_tenant_weights(spec: str,
                         key: str = "queue.tenant_weights",
                         allow_zero: bool = False) -> Dict[str, float]:
    """Parse a ``"tenantA=2,tenantB=1"`` map — ``queue.tenant_weights``
    (core/queue.py DRR weights) and the per-tenant SLO overrides
    (``slo.tenant_ttft_ms``/``slo.tenant_tbt_ms``, milliseconds) share
    the grammar. Raises ConfigError (attributed to ``key``) on
    malformed entries or out-of-range values. ``allow_zero`` (the SLO
    maps): 0 is a legal override meaning "objective unset for this
    tenant" — the only way to exempt one tenant from a global
    objective; a DRR weight of 0 stays illegal (it would starve the
    tenant entirely)."""
    out: Dict[str, float] = {}
    floor = -1.0 if allow_zero else 0.0
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, value = part.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ConfigError(
                f"{key}: {part!r} is not tenant=value"
            )
        try:
            weight = float(value)
        except ValueError:
            raise ConfigError(
                f"{key}: value {value!r} for {name!r} is not a number"
            ) from None
        if weight <= floor:
            raise ConfigError(
                f"{key}: value for {name!r} must be "
                + (">= 0 (0 = objective unset)" if allow_zero
                   else "positive")
            )
        out[name] = weight
    return out


def _defaults() -> Dict[str, Dict[str, Any]]:
    return {
        sec: {k: copy.copy(d) for k, (_, d) in fields.items()}
        for sec, fields in _SCHEMA.items()
    }


def _coerce(section: str, key: str, value: Any) -> Any:
    try:
        typ, _ = _SCHEMA[section][key]
    except KeyError:
        raise ConfigError(f"unknown config key: {section}.{key}") from None
    if typ is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.strip().lower()
            if low in ("1", "true", "yes", "on"):
                return True
            if low in ("0", "false", "no", "off"):
                return False
        raise ConfigError(f"{section}.{key}: expected boolean, got {value!r}")
    if typ is list:
        if isinstance(value, (list, tuple)):
            return [int(v) for v in value]
        if isinstance(value, str):
            return [int(v) for v in value.split(",") if v.strip()]
        raise ConfigError(f"{section}.{key}: expected list, got {value!r}")
    if typ is tuple:
        # string list (e.g. fleet.registries): a YAML/TOML list or a
        # comma-separated string ("hostA:7070,hostB:7070") — the latter
        # is how env/CLI overrides spell it
        if isinstance(value, (list, tuple)):
            return [str(v) for v in value]
        if isinstance(value, str):
            return [v.strip() for v in value.split(",") if v.strip()]
        raise ConfigError(
            f"{section}.{key}: expected list of strings, got {value!r}"
        )
    try:
        return typ(value)
    except (TypeError, ValueError):
        raise ConfigError(
            f"{section}.{key}: expected {typ.__name__}, got {value!r}"
        ) from None


def _load_file(path: str) -> Dict[str, Any]:
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError:
            raise ConfigError(
                f"config file {path} is YAML but the yaml module is not "
                "installed (use .toml)") from None
        with open(path) as f:
            obj = yaml.safe_load(f) or {}
    elif path.endswith(".toml"):
        from distributed_inference_server_tpu_torch.utils.compat import (
            load_toml,
        )

        obj = load_toml(path)
    else:
        raise ConfigError(f"unsupported config format: {path} (use .toml/.yaml)")
    if not isinstance(obj, dict):
        raise ConfigError(f"config file {path} must contain a table/mapping")
    return obj


def _env_overrides(environ: Optional[Dict[str, str]] = None) -> Dict[str, Dict[str, Any]]:
    environ = os.environ if environ is None else environ
    out: Dict[str, Dict[str, Any]] = {}
    for name, raw in environ.items():
        if not name.startswith(ENV_PREFIX):
            continue
        rest = name[len(ENV_PREFIX):]
        if "__" not in rest:
            continue
        section, key = rest.split("__", 1)
        out.setdefault(section.lower(), {})[key.lower()] = raw
    return out


@dataclass
class ServerConfig:
    """Typed view over the merged section/field table."""

    raw: Dict[str, Dict[str, Any]] = field(default_factory=_defaults)
    source_file: Optional[str] = None
    # kept so hot-reload re-merges with the SAME CLI overrides (Property 26
    # must survive reloads, not just initial load)
    cli_args: List[str] = field(default_factory=list)

    # -- construction ------------------------------------------------------

    @classmethod
    def load(
        cls,
        file_path: Optional[str] = None,
        cli_args: Optional[List[str]] = None,
        environ: Optional[Dict[str, str]] = None,
    ) -> "ServerConfig":
        """Merge defaults < file < env < CLI (Property 26), then validate
        (Property 27)."""
        merged = _defaults()

        def apply(section: str, key: str, value: Any) -> None:
            if section not in merged or key not in merged[section]:
                raise ConfigError(f"unknown config key: {section}.{key}")
            merged[section][key] = _coerce(section, key, value)

        cli = _parse_cli(cli_args or [])
        # always pop the file key — the apply loop must see only
        # (section, key) tuples, even when file_path was passed directly
        # (hot-reload re-merges with the original --config in cli_args)
        cli_file = cli.pop("_config_file", None)
        file_path = file_path or cli_file

        if file_path:
            for section, fields in _load_file(file_path).items():
                if not isinstance(fields, dict):
                    raise ConfigError(f"config section {section} must be a table")
                for key, value in fields.items():
                    apply(str(section), str(key), value)
        for section, fields in _env_overrides(environ).items():
            for key, value in fields.items():
                apply(section, key, value)
        for (section, key), value in cli.items():
            apply(section, key, value)

        cfg = cls(raw=merged, source_file=file_path,
                  cli_args=list(cli_args or []))
        cfg.validate()
        return cfg

    # -- access ------------------------------------------------------------

    def get(self, section: str, key: str) -> Any:
        return self.raw[section][key]

    def queue_config(self) -> QueueConfig:
        q = self.raw["queue"]
        return QueueConfig(
            high_watermark=q["high_watermark"],
            low_watermark=q["low_watermark"],
            request_timeout_s=q["request_timeout_s"],
            max_queue_size=q["max_queue_size"],
            tenant_fairness=q["tenant_fairness"],
            tenant_weights=parse_tenant_weights(q["tenant_weights"]),
        )

    def batcher_config(self) -> BatcherConfig:
        b = self.raw["batcher"]
        return BatcherConfig(
            window_ms=b["window_ms"], max_batch_size=b["max_batch_size"]
        )

    def validator_config(self) -> ValidatorConfig:
        v = self.raw["validator"]
        return ValidatorConfig(
            max_context_tokens=v["max_context_tokens"],
            max_output_tokens=v["max_output_tokens"],
        )

    def strategy(self) -> SchedulingStrategy:
        return SchedulingStrategy.parse(self.raw["server"]["strategy"])

    def engine_roles(self):
        """Validated per-replica role list (serving/disagg.py). Fleet
        membership (registry host OR joined worker) relaxes the
        single-sided-topology checks — the counterpart role may live on
        another member, reachable over the KV data plane."""
        from distributed_inference_server_tpu_torch.serving.disagg import (
            parse_roles,
        )

        f = self.raw["fleet"]
        return parse_roles(self.raw["server"]["engine_roles"],
                           self.raw["server"]["num_engines"],
                           fleet=bool(f["enabled"] or f["connect"]))

    def disagg_settings(self):
        from distributed_inference_server_tpu_torch.serving.disagg import (
            DisaggSettings,
        )

        d = self.raw["disagg"]
        return DisaggSettings(
            handoff_timeout_s=d["handoff_timeout_s"],
            handoff_retries=d["handoff_retries"],
            channel=d["channel"],
            stream=d["stream"],
            chunk_pages=d["chunk_pages"],
            wire_quant=d["wire_quant"],
        )

    def fleet_settings(self):
        """The fleet's knobs (``serving/fleet.py`` ``FleetSettings``)."""
        from distributed_inference_server_tpu_torch.serving.fleet import (
            FleetSettings,
        )

        f = self.raw["fleet"]
        return FleetSettings(
            enabled=f["enabled"],
            host=f["host"],
            port=f["port"],
            connect=f["connect"],
            member_id=f["member_id"],
            heartbeat_interval_s=f["heartbeat_interval_s"],
            suspect_after_s=f["suspect_after_s"],
            dead_after_s=f["dead_after_s"],
            rerole=f["rerole"],
            rerole_high_ratio=f["rerole_high_ratio"],
            rerole_low_ratio=f["rerole_low_ratio"],
            rerole_cooldown_s=f["rerole_cooldown_s"],
            rerole_interval_s=f["rerole_interval_s"],
            kv_enabled=f["kv_enabled"],
            kv_data_port=f["kv_data_port"],
            kv_max_streams=f["kv_max_streams"],
            kv_connect_timeout_s=f["kv_connect_timeout_s"],
            mesh_enabled=f["mesh_enabled"],
            kv_rate_window_s=f["kv_rate_window_s"],
            kv_rate_prior=f["kv_rate_prior"],
            registries=tuple(f["registries"]),
            lease_s=f["lease_s"],
            lease_suspect_s=f["lease_suspect_s"],
            standby_http=f["standby_http"],
        )

    def slo_settings(self):
        """SLO / performance-telemetry knobs (teledigest.SloSettings);
        always constructed — the window/epoch geometry shapes the
        /server/perf digests even with no objective set."""
        from distributed_inference_server_tpu_torch.serving.teledigest import (
            SloSettings,
        )

        s = self.raw["slo"]
        return SloSettings(
            ttft_ms=s["ttft_ms"],
            tbt_p99_ms=s["tbt_p99_ms"],
            tenant_ttft_ms=parse_tenant_weights(
                s["tenant_ttft_ms"], key="slo.tenant_ttft_ms",
                allow_zero=True),
            tenant_tbt_ms=parse_tenant_weights(
                s["tenant_tbt_ms"], key="slo.tenant_tbt_ms",
                allow_zero=True),
            window_s=s["window_s"],
            epoch_s=s["epoch_s"],
        )

    def health_settings(self):
        """Gray-failure defense knobs (serving/health.py
        HealthSettings; docs/RESILIENCE.md)."""
        from distributed_inference_server_tpu_torch.serving.health import (
            HealthSettings,
        )

        h = self.raw["health"]
        return HealthSettings(
            enabled=h["enabled"],
            interval_s=h["interval_s"],
            stall_s=h["stall_s"],
            latency_ratio=h["latency_ratio"],
            recover_ratio=h["recover_ratio"],
            demote_after=h["demote_after"],
            recover_after=h["recover_after"],
            min_window_requests=h["min_window_requests"],
            wire_failures=h["wire_failures"],
            breaker_open_s=h["breaker_open_s"],
            retry_budget_ratio=h["retry_budget_ratio"],
            retry_budget_min=h["retry_budget_min"],
            retry_window_s=h["retry_window_s"],
            slo_burn_high=h["slo_burn_high"],
            slo_burn_min_requests=h["slo_burn_min_requests"],
        )

    def admission_settings(self):
        """Deadline-aware admission knobs (serving/health.py
        AdmissionSettings)."""
        from distributed_inference_server_tpu_torch.serving.health import (
            AdmissionSettings,
        )

        a = self.raw["admission"]
        return AdmissionSettings(
            shed_enabled=a["shed_enabled"],
            deadline_ms=a["deadline_ms"],
            deadline_factor=a["deadline_factor"],
            brownout=a["brownout"],
            min_window_requests=a["min_window_requests"],
            retry_after_cap_s=a["retry_after_cap_s"],
        )

    def fetch_costs(self):
        """cache_aware three-way cost-model weights (fleet prefix
        sharing, serving/scheduler.py plan_route)."""
        from distributed_inference_server_tpu_torch.serving.scheduler import (
            FetchCosts,
        )

        c = self.raw["cache"]
        return FetchCosts(
            enabled=c["peer_fetch"],
            min_pages=c["fetch_min_pages"],
            page_cost=c["fetch_page_cost"],
            load_cost_pages=c["fetch_load_cost"],
            remote_page_cost=self.raw["fleet"]["kv_page_cost"],
            wire_frac=self._wire_frac(),
        )

    def _wire_frac(self) -> float:
        """Encoded bytes-per-page fraction of the configured fetch wire
        (kv_cache.encoded_page_fraction): the cost model charges what
        the wire actually moves — int8 is ~3.2× fewer bytes than f32
        raw, latent several-fold fewer still. Falls back to 1.0 when
        the model geometry is not resolvable from the config (custom
        checkpoint dirs) or the pool is natively quantized (QuantPool
        codes pass through whatever the wire setting)."""
        wq = self.raw["disagg"]["wire_quant"]
        if wq == "none" or self.raw["engine"]["kv_quant"] != "none":
            return 1.0
        try:
            from distributed_inference_server_tpu_torch.engine.kv_cache import (
                encoded_page_fraction,
            )
            from distributed_inference_server_tpu_torch.models.configs import (
                get_config,
            )

            head_dim = get_config(self.raw["model"]["model_name"]).head_dim
            itemsize = {"float32": 4, "bfloat16": 2,
                        "float16": 2}[self.raw["model"]["dtype"]]
            return encoded_page_fraction(
                wq, itemsize, head_dim, self.raw["cache"]["latent_rank"]
            )
        except Exception as e:  # noqa: BLE001 — cost scaling is best-effort
            logger.debug("wire_frac: cannot resolve model geometry for "
                         "%r (%s); charging raw pages", wq, e)
            return 1.0

    # -- validation --------------------------------------------------------

    def validate(self) -> None:
        """Range checks (Property 27); raises ConfigError."""
        r = self.raw

        def positive(section: str, key: str) -> None:
            if r[section][key] <= 0:
                raise ConfigError(f"{section}.{key} must be positive")

        for sec, key in (
            ("server", "port"), ("server", "num_engines"),
            ("engine", "tensor_parallel"),
            ("engine", "pipeline_parallel"), ("engine", "pp_microbatches"),
            ("engine", "context_parallel"),
            ("engine", "max_batch"), ("engine", "page_size"),
            ("engine", "num_pages"), ("engine", "max_pages_per_seq"),
            ("queue", "high_watermark"), ("queue", "low_watermark"),
            ("queue", "request_timeout_s"), ("queue", "max_queue_size"),
            ("batcher", "max_batch_size"),
            ("validator", "max_context_tokens"),
            ("validator", "max_output_tokens"),
        ):
            positive(sec, key)
        if not (0 < r["server"]["port"] < 65536):
            raise ConfigError("server.port must be in (0, 65536)")
        if r["queue"]["low_watermark"] >= r["queue"]["high_watermark"]:
            raise ConfigError(
                "queue.low_watermark must be below queue.high_watermark"
            )
        if r["queue"]["high_watermark"] > r["queue"]["max_queue_size"]:
            raise ConfigError(
                "queue.high_watermark must be <= queue.max_queue_size"
            )
        if r["batcher"]["window_ms"] < 0:
            raise ConfigError("batcher.window_ms must be >= 0")
        if r["engine"]["mixed_step_tokens"] < 0:
            raise ConfigError("engine.mixed_step_tokens must be >= 0")
        if (0 < r["engine"]["mixed_step_tokens"]
                <= r["engine"]["max_batch"]):
            raise ConfigError(
                "engine.mixed_step_tokens must exceed engine.max_batch "
                "(the packed width holds every decode slot plus at "
                "least one prefill token)"
            )
        if r["engine"]["loop_max_steps"] < 1:
            raise ConfigError("engine.loop_max_steps must be >= 1")
        if not r["engine"]["prefill_buckets"]:
            raise ConfigError("engine.prefill_buckets must be non-empty")
        if sorted(r["engine"]["prefill_buckets"]) != r["engine"]["prefill_buckets"]:
            raise ConfigError("engine.prefill_buckets must be ascending")
        try:
            SchedulingStrategy.parse(r["server"]["strategy"])
        except ValueError:
            raise ConfigError(
                f"server.strategy must be one of "
                f"{[s.value for s in SchedulingStrategy]}, "
                f"got {r['server']['strategy']!r}"
            ) from None
        if r["model"]["dtype"] not in ("bfloat16", "float32", "float16"):
            raise ConfigError(
                f"model.dtype must be bfloat16/float32/float16, "
                f"got {r['model']['dtype']!r}"
            )
        if r["engine"]["sp_impl"] not in ("ring", "ulysses"):
            raise ConfigError(
                f"engine.sp_impl must be ring/ulysses, "
                f"got {r['engine']['sp_impl']!r}"
            )
        if r["model"]["quantization"] not in ("none", "int8", "int4"):
            raise ConfigError(
                f"model.quantization must be none/int8/int4, "
                f"got {r['model']['quantization']!r}"
            )
        # disaggregated serving: roles parse + topology sanity
        # (decode-with-no-prefill etc.) live in disagg.parse_roles
        self.engine_roles()
        if r["disagg"]["handoff_timeout_s"] <= 0:
            raise ConfigError("disagg.handoff_timeout_s must be positive")
        if r["disagg"]["handoff_retries"] < 0:
            raise ConfigError("disagg.handoff_retries must be >= 0")
        if r["disagg"]["channel"] not in ("inproc", "protowire"):
            raise ConfigError(
                f"disagg.channel must be inproc/protowire, "
                f"got {r['disagg']['channel']!r}"
            )
        if r["disagg"]["chunk_pages"] <= 0:
            raise ConfigError("disagg.chunk_pages must be positive")
        if r["disagg"]["wire_quant"] not in ("none", "int8", "latent",
                                             "latent_int8"):
            raise ConfigError(
                f"disagg.wire_quant must be none/int8/latent/latent_int8, "
                f"got {r['disagg']['wire_quant']!r}"
            )
        if r["server"]["max_redispatch"] < 0:
            raise ConfigError("server.max_redispatch must be >= 0")
        if r["server"]["restart_backoff_s"] <= 0:
            raise ConfigError("server.restart_backoff_s must be positive")
        if (r["server"]["restart_backoff_max_s"]
                < r["server"]["restart_backoff_s"]):
            raise ConfigError(
                "server.restart_backoff_max_s must be >= "
                "server.restart_backoff_s"
            )
        if r["faults"]["spec"]:
            from distributed_inference_server_tpu_torch.serving.faults import (
                FaultSpecError,
                parse_spec,
            )

            try:
                parse_spec(r["faults"]["spec"], r["faults"]["seed"])
            except FaultSpecError as e:
                raise ConfigError(f"faults.spec: {e}") from None
        if r["cache"]["host_tier_bytes"] < 0:
            raise ConfigError("cache.host_tier_bytes must be >= 0")
        if r["cache"]["host_tier_quant"] not in ("none", "int8", "latent",
                                                 "latent_int8"):
            raise ConfigError(
                f"cache.host_tier_quant must be none/int8/latent/"
                f"latent_int8, got {r['cache']['host_tier_quant']!r}"
            )
        if r["cache"]["latent_rank"] < 0:
            raise ConfigError("cache.latent_rank must be >= 0")
        if r["cache"]["latent_rank"] == 0:
            for key, section in (("disagg.wire_quant", r["disagg"]["wire_quant"]),
                                 ("cache.host_tier_quant",
                                  r["cache"]["host_tier_quant"])):
                if section in ("latent", "latent_int8"):
                    raise ConfigError(
                        f"{key}={section!r} needs cache.latent_rank > 0 "
                        "(the engine has no codec to encode with)"
                    )
        if r["cache"]["digest_depth"] <= 0:
            raise ConfigError("cache.digest_depth must be positive")
        if r["cache"]["fetch_min_pages"] < 1:
            raise ConfigError("cache.fetch_min_pages must be >= 1")
        if r["cache"]["fetch_page_cost"] < 0:
            raise ConfigError("cache.fetch_page_cost must be >= 0")
        if r["cache"]["fetch_load_cost"] < 0:
            raise ConfigError("cache.fetch_load_cost must be >= 0")
        # per-tenant fairness: weights parse + positivity
        parse_tenant_weights(r["queue"]["tenant_weights"])
        # SLO / performance telemetry (serving/teledigest.py)
        s = r["slo"]
        if s["ttft_ms"] < 0:
            raise ConfigError("slo.ttft_ms must be >= 0 (0 = unset)")
        if s["tbt_p99_ms"] < 0:
            raise ConfigError("slo.tbt_p99_ms must be >= 0 (0 = unset)")
        parse_tenant_weights(s["tenant_ttft_ms"],
                             key="slo.tenant_ttft_ms", allow_zero=True)
        parse_tenant_weights(s["tenant_tbt_ms"],
                             key="slo.tenant_tbt_ms", allow_zero=True)
        if s["epoch_s"] <= 0:
            raise ConfigError("slo.epoch_s must be positive")
        if s["window_s"] < s["epoch_s"]:
            raise ConfigError(
                "slo.window_s must be >= slo.epoch_s (the window is a "
                "whole number of epochs)"
            )
        # gray-failure defense (serving/health.py)
        h = r["health"]
        for key in ("interval_s", "stall_s", "breaker_open_s",
                    "retry_window_s"):
            if h[key] <= 0:
                raise ConfigError(f"health.{key} must be positive")
        for key in ("demote_after", "recover_after", "wire_failures",
                    "retry_budget_min", "min_window_requests",
                    "slo_burn_min_requests"):
            if h[key] < 1:
                raise ConfigError(f"health.{key} must be >= 1")
        if h["recover_ratio"] <= 1.0:
            raise ConfigError("health.recover_ratio must exceed 1.0")
        if h["latency_ratio"] <= h["recover_ratio"]:
            raise ConfigError(
                "health.latency_ratio must exceed health.recover_ratio "
                "(the two-sided hysteresis band)"
            )
        if not (0.0 <= h["retry_budget_ratio"] <= 1.0):
            raise ConfigError(
                "health.retry_budget_ratio must be in [0, 1]"
            )
        if not (0.0 < h["slo_burn_high"] <= 1.0):
            raise ConfigError("health.slo_burn_high must be in (0, 1]")
        a = r["admission"]
        if a["deadline_ms"] < 0:
            raise ConfigError(
                "admission.deadline_ms must be >= 0 (0 = derive from "
                "the TTFT SLO)"
            )
        if a["deadline_factor"] <= 0:
            raise ConfigError("admission.deadline_factor must be positive")
        if a["min_window_requests"] < 1:
            raise ConfigError(
                "admission.min_window_requests must be >= 1"
            )
        if a["retry_after_cap_s"] < 1:
            raise ConfigError("admission.retry_after_cap_s must be >= 1")
        # fleet control plane (serving/fleet.py)
        f = r["fleet"]
        if f["heartbeat_interval_s"] <= 0:
            raise ConfigError("fleet.heartbeat_interval_s must be positive")
        if f["suspect_after_s"] <= f["heartbeat_interval_s"]:
            raise ConfigError(
                "fleet.suspect_after_s must exceed "
                "fleet.heartbeat_interval_s (one missed beat is jitter, "
                "not suspicion)"
            )
        if f["dead_after_s"] <= f["suspect_after_s"]:
            raise ConfigError(
                "fleet.dead_after_s must exceed fleet.suspect_after_s"
            )
        if not (0 <= f["port"] < 65536):
            raise ConfigError("fleet.port must be in [0, 65536)")
        if f["connect"]:
            parse_connect(f["connect"])
        if f["rerole_low_ratio"] >= f["rerole_high_ratio"]:
            raise ConfigError(
                "fleet.rerole_low_ratio must be below "
                "fleet.rerole_high_ratio (the hysteresis band)"
            )
        if f["rerole_low_ratio"] < 0:
            raise ConfigError("fleet.rerole_low_ratio must be >= 0")
        if f["rerole_cooldown_s"] < 0:
            raise ConfigError("fleet.rerole_cooldown_s must be >= 0")
        if f["rerole_interval_s"] <= 0:
            raise ConfigError("fleet.rerole_interval_s must be positive")
        # fleet KV data plane (serving/fleet_kv.py)
        if not (0 <= f["kv_data_port"] < 65536):
            raise ConfigError("fleet.kv_data_port must be in [0, 65536)")
        if f["kv_page_cost"] < 0:
            raise ConfigError("fleet.kv_page_cost must be >= 0")
        if f["kv_max_streams"] < 1:
            raise ConfigError("fleet.kv_max_streams must be >= 1")
        if f["kv_connect_timeout_s"] <= 0:
            raise ConfigError(
                "fleet.kv_connect_timeout_s must be positive"
            )
        # KV mesh learned wire costs (serving/fleet_mesh.py)
        if f["kv_rate_window_s"] <= 0:
            raise ConfigError("fleet.kv_rate_window_s must be positive")
        if f["kv_rate_prior"] < 0:
            raise ConfigError(
                "fleet.kv_rate_prior must be >= 0 (0 disables learned "
                "pricing)"
            )
        # registry HA (serving/fleet_ha.py)
        if f["registries"]:
            for ep in f["registries"]:
                try:
                    parse_connect(ep)
                except Exception:
                    raise ConfigError(
                        f"fleet.registries: {ep!r} is not a host:port "
                        "endpoint"
                    ) from None
            if f["lease_suspect_s"] <= f["heartbeat_interval_s"]:
                raise ConfigError(
                    "fleet.lease_suspect_s must exceed "
                    "fleet.heartbeat_interval_s (one missed lease beat "
                    "is jitter, not a dead primary)"
                )
            if f["lease_s"] <= f["lease_suspect_s"]:
                raise ConfigError(
                    "fleet.lease_s must exceed fleet.lease_suspect_s"
                )

    def check_ported(self) -> None:
        """Refuse, with a ``ConfigError`` naming the key, a setting whose
        subsystem cannot run in this installation: ``server.grpc_port``
        (the gRPC transport, ``serving/grpc_server.py``) where ``grpcio``
        is not installed. ``validate`` (the reference's checks) passes
        such settings; the entry point calls this after it, so the
        process exits 2 at once instead of failing at serve time."""
        if (self.raw["server"]["grpc_port"] != 0
                and importlib.util.find_spec("grpc") is None):
            raise ConfigError(
                "server.grpc_port needs the grpcio package (import grpc), "
                "which is not installed")

    def hot_diff(self, other: "ServerConfig") -> Dict[tuple, Any]:
        """(section, key) -> new value for hot-reloadable keys that differ."""
        out = {}
        for section, key in HOT_RELOADABLE:
            new = other.raw[section][key]
            if self.raw[section][key] != new:
                out[(section, key)] = new
        return out


def _parse_cli(argv: List[str]) -> Dict[Any, Any]:
    """CLI flags: ``--config FILE`` plus ``--<section>-<field>`` per schema
    entry (clap-equivalent surface, Cargo.toml:45)."""
    parser = argparse.ArgumentParser(
        prog="python -m distributed_inference_server_tpu_torch",
        description="LLM inference server (PyTorch/CUDA)",
    )
    parser.add_argument("--config", dest="_config_file", default=None,
                        help="TOML/YAML config file")
    for section, fields in _SCHEMA.items():
        for key in fields:
            parser.add_argument(
                f"--{section}-{key}".replace("_", "-"),
                dest=f"{section}.{key}",
                default=None,
            )
    ns = vars(parser.parse_args(argv))
    out: Dict[Any, Any] = {}
    cfg_file = ns.pop("_config_file")
    if cfg_file:
        out["_config_file"] = cfg_file
    for dotted, value in ns.items():
        if value is None:
            continue
        section, key = dotted.split(".", 1)
        out[(section, key)] = value
    return out


class ConfigWatcher:
    """Polls the config file; publishes hot-reloadable changes to
    subscribers (requirements.md:146 watch-channel analogue)."""

    def __init__(self, config: ServerConfig, poll_interval_s: float = 1.0):
        self.current = config
        self._interval = poll_interval_s
        self._subs: List[Callable[[Dict[tuple, Any], ServerConfig], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mtime = self._stat()

    def subscribe(
        self, callback: Callable[[Dict[tuple, Any], ServerConfig], None]
    ) -> None:
        self._subs.append(callback)

    def _stat(self) -> float:
        path = self.current.source_file
        if not path:
            return 0.0
        try:
            return os.stat(path).st_mtime
        except OSError:
            return 0.0

    def check_once(self) -> bool:
        """Reload if the file changed; returns True if a reload happened.
        Invalid new config is rejected (old config stays active)."""
        path = self.current.source_file
        if not path:
            return False
        mtime = self._stat()
        if mtime == self._mtime:
            return False
        try:
            # re-merge with the original CLI args so CLI > env > file
            # precedence survives the reload (Property 26)
            new = ServerConfig.load(file_path=path,
                                    cli_args=self.current.cli_args)
        except Exception as e:  # noqa: BLE001 — malformed/partial file edits
            # (toml parse errors, ENOENT during atomic replace) must
            # never kill hot-reload; the old config stays active. The
            # recorded mtime is NOT advanced on failure: if the writer
            # completes within the same mtime tick (coarse filesystem
            # timestamps), the next poll still retries instead of
            # treating the torn snapshot as current forever
            logger.warning("config hot-reload: %s rejected (%s); keeping "
                           "the active config", path, e)
            return False
        self._mtime = mtime
        diff = self.current.hot_diff(new)
        self.current = new
        if diff:
            for cb in self._subs:
                try:
                    cb(diff, new)
                except Exception:  # noqa: BLE001 — subscriber isolation
                    logger.exception(
                        "config hot-reload subscriber %r failed; other "
                        "subscribers still run", cb,
                    )
        return True

    def start(self) -> None:
        if self._thread is not None or not self.current.source_file:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="config-watcher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — watcher must stay alive
                logger.exception("config watcher poll failed; retrying")
