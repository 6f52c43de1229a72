"""Serve a model over HTTP: ``python -m distributed_inference_server_tpu_torch
[--config FILE.toml|FILE.yaml] [--<section>-<field> VALUE ...]
[--device cuda|cpu] [--seed S]``.

The settings are the JAX package's config (``serving/config.py``, the same
schema): defaults < the ``--config`` file < ``DIS_TPU_<SECTION>__<FIELD>``
environment variables < ``--<section>-<field>`` flags, e.g.
``--model-model-name llama-3.2-1b --server-port 8000
--engine-mixed-step-tokens 512 --batcher-window-ms 0``. At the defaults the
engine is the one ``python -m distributed_inference_server_tpu`` builds
(``max_batch`` 64, 2048 pages of 16 tokens, 512 pages per sequence,
prefill batches of 16 rows within 8192 tokens). An invalid value exits 2
with ``config error:``, and so does a setting whose subsystem the port
does not have yet (``server.grpc_port``, ``fleet.registries``):
``<section.key> is not ported yet``.

The fleet's control plane (``serving/fleet.py``): ``--fleet-enabled true``
makes the process a registry host listening at ``fleet.host:fleet.port``
(its members' engines join its routing set); ``--fleet-connect host:port``
joins such a host as a member once the server has started, printing
``joined fleet at <host:port> as <member id>``; a refused dial is retried
for up to ``FLEET_JOIN_TIMEOUT_S``. A member that cannot reach its host
exits 1 (``fleet join failed``) and never serves alone.

``engine.tensor_parallel`` / ``pipeline_parallel`` / ``context_parallel``
give each replica a device mesh (``parallel/mesh.py``) over a disjoint
slice of this process's devices: the cards, or on ``--device cpu`` the
``--xla_force_host_platform_device_count`` of ``XLA_FLAGS``, as the JAX
entry point counts them. Too few devices, ``context_parallel`` with
``pipeline_parallel``, or a draft model with ``pipeline_parallel`` exit 2
with ``config error:``. ``distributed.num_processes`` above 1 joins the
process group at ``distributed.coordinator_address`` before any device
is touched (``parallel/distributed.py``); meshes then hold this process's
devices only.
``server.compile_cache_dir`` is accepted and has no effect: the kernels
build into ``build/``. The validator's context limit is lowered to what
the engine can seat (``page_size x max_pages_per_seq - 1``), so an
over-long prompt is a 400. While the server runs, a ``ConfigWatcher``
applies edits of the file's hot-reloadable keys (the batching window and
size, the queue watermarks and timeout, the strategy).

Two flags are the port's own: ``--device`` (the card unless ``cpu`` is
asked for; a missing card is an error) and ``--seed`` (the random weights'
generator; a draft model's is seeded ``--seed`` + 1).

With ``--model-model-dir`` the config and weights come from that HF
checkpoint directory and the tokenizer from its ``tokenizer.json`` (the
byte tokenizer when it has none), with the chat template of its
``tokenizer_config.json``; without it the weights are random for the
``--model-model-name`` preset, with the byte tokenizer.
``--model-quantization`` quantizes the linear families (a preset's are
drawn quantized, so mixtral-8x7b's bf16 tree never exists);
``--engine-kv-quant int8`` keeps the KV pools as int8 codes + scales. A
draft model (``--model-draft-model-name`` or ``--model-draft-model-dir``)
turns on speculative decoding; it must share the target's vocabulary.

Every request passes the admission layer (``serving/dispatcher.py``:
queue, batching window, deadline-aware shedding, the degradation ladder's
gates) and reaches one of ``--server-num-engines`` replicas, each with its
own weights, KV pool, stream and CUDA graphs on the device, routed by
``--server-strategy`` and given a role by ``--server-engine-roles``.
``--faults-spec`` arms the fault-injection points (testing only).
``POST /admin/scale`` changes the number of replicas at runtime;
``POST /admin/model-swap`` answers 501, as the JAX package's entry point
does (no model resolver is configured here).
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import signal
import sys
from dataclasses import replace
from typing import List, Optional, Tuple

import torch

from distributed_inference_server_tpu_torch.core.errors import (
    ConfigError,
    ModelLoadError,
)
from distributed_inference_server_tpu_torch.core.validator import (
    ValidatorConfig,
)
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    KV_QUANTS,
    PagedCacheConfig,
    encoded_page_fraction,
)
from distributed_inference_server_tpu_torch.engine.speculative import (
    SpecConfig,
)
from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.configs import (
    ModelConfig,
    get_config,
)
from distributed_inference_server_tpu_torch.models.loader import (
    config_from_hf_json,
    load_checkpoint,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    load_tokenizer,
)
from distributed_inference_server_tpu_torch.ops.quant import (
    init_random_quantized,
    quantize_params,
)
from distributed_inference_server_tpu_torch.parallel.distributed import (
    DistributedConfig,
    initialize,
    local_devices,
)
from distributed_inference_server_tpu_torch.parallel.mesh import (
    MeshSpec,
    make_mesh,
)
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving.config import (
    ConfigWatcher,
    ServerConfig,
)
from distributed_inference_server_tpu_torch.serving.remote_runner import (
    FleetWorker,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)
from distributed_inference_server_tpu_torch.utils.device import (
    dtype_from_name,
    resolve_device,
)

# seconds a member keeps redialing a registry host that refuses (a host
# started beside it is still warming its engines up)
FLEET_JOIN_TIMEOUT_S = 120.0


def _port_args(argv: List[str]) -> Tuple[argparse.Namespace, List[str]]:
    """Split off the port's own flags; the rest are the config's."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    return ap.parse_known_args(argv)


def engine_settings(cfg: ServerConfig, seed: int = 0) -> EngineConfig:
    """The ``EngineConfig`` the config describes (the JAX entry point's
    fields, plus the port's ``seed``)."""
    g = cfg.get
    return EngineConfig(
        seed=seed,
        max_batch=g("engine", "max_batch"),
        prefill_buckets=tuple(g("engine", "prefill_buckets")),
        paged=PagedCacheConfig(
            num_pages=g("engine", "num_pages"),
            page_size=g("engine", "page_size"),
            max_pages_per_seq=g("engine", "max_pages_per_seq")),
        decode_block_size=g("engine", "decode_block_size"),
        pipeline_depth=g("engine", "pipeline_depth"),
        prefill_batch=g("engine", "prefill_batch"),
        prefill_token_budget=g("engine", "prefill_token_budget"),
        mixed_step_tokens=g("engine", "mixed_step_tokens"),
        loop_to_completion=g("engine", "loop_to_completion"),
        loop_max_steps=g("engine", "loop_max_steps"),
        warmup_compile=g("engine", "warmup_compile"),
        kv_quant=g("engine", "kv_quant"),
        host_tier_bytes=g("cache", "host_tier_bytes"),
        host_tier_quant=g("cache", "host_tier_quant"),
        latent_rank=g("cache", "latent_rank"),
        digest_depth=g("cache", "digest_depth"),
        pp_microbatches=g("engine", "pp_microbatches"),
        cp_min_tokens=g("engine", "cp_min_tokens") or None,
        sp_impl=g("engine", "sp_impl"))


def spec_settings(cfg: ServerConfig) -> Optional[SpecConfig]:
    """The speculation settings when a draft model is configured."""
    if not (cfg.get("model", "draft_model_dir")
            or cfg.get("model", "draft_model_name")):
        return None
    return SpecConfig(
        num_draft_tokens=cfg.get("engine", "num_draft_tokens"),
        disable_threshold=cfg.get("engine", "spec_disable_threshold"),
        reenable_after_s=cfg.get("engine", "spec_reenable_after_s"))


def validator_settings(cfg: ServerConfig) -> ValidatorConfig:
    """The validator's limits, its context limit lowered to what the
    engine can seat (``page_size x max_pages_per_seq - 1``: one slot for
    the sampled token), so an over-long prompt is a 400 at the validator
    and never reaches the engine."""
    cap = (cfg.get("engine", "page_size")
           * cfg.get("engine", "max_pages_per_seq") - 1)
    v = cfg.validator_config()
    if v.max_context_tokens > cap:
        v = replace(v, max_context_tokens=cap)
    return v


def _replica_settings(cfg: ServerConfig, mcfg: ModelConfig,
                      dtype: torch.dtype) -> dict:
    """The replica, scheduler, handoff and fetch settings as
    ``InferenceServer`` arguments, plus the parsed ``faults`` (None when
    the spec is empty). The fetch term charges the wire's encoded bytes
    at the served model's head dim (a checkpoint's too; quantized pools
    move their own codes whatever the wire setting)."""
    ecfg_kv = cfg.get("engine", "kv_quant")
    fetch_costs = cfg.fetch_costs()
    wq = cfg.get("disagg", "wire_quant")
    if wq != "none" and ecfg_kv == "none":
        fetch_costs = replace(fetch_costs, wire_frac=encoded_page_fraction(
            wq, torch.empty((), dtype=dtype).element_size(), mcfg.head_dim,
            cfg.get("cache", "latent_rank")))
    spec = cfg.get("faults", "spec")
    return {
        "num_engines": cfg.get("server", "num_engines"),
        "strategy": cfg.strategy(),
        "engine_roles": cfg.engine_roles(),
        "auto_restart": cfg.get("server", "auto_restart"),
        "health_check_interval_s": cfg.get("server",
                                           "health_check_interval_s"),
        "restart_backoff_s": cfg.get("server", "restart_backoff_s"),
        "restart_backoff_max_s": cfg.get("server", "restart_backoff_max_s"),
        "max_redispatch": cfg.get("server", "max_redispatch"),
        "disagg_settings": cfg.disagg_settings(),
        "fetch_costs": fetch_costs,
        "fleet_settings": cfg.fleet_settings(),
        "faults": (faults.parse_spec(spec, cfg.get("faults", "seed"))
                   if spec else None),
    }


def _dir_config(model_dir: str) -> ModelConfig:
    """The model config of an HF checkpoint directory's config.json."""
    with open(os.path.join(model_dir, "config.json")) as f:
        return config_from_hf_json(json.load(f))


def _port_checks(cfg: ServerConfig, ecfg: EngineConfig) -> None:
    """Checks of values the reference leaves to its engine, with the
    port's messages; raises ``ConfigError``."""
    g = cfg.get
    if g("model", "draft_model_dir") and g("model", "draft_model_name"):
        raise ConfigError("set model.draft_model_name or "
                          "model.draft_model_dir, not both")
    if g("engine", "num_draft_tokens") < 1:
        raise ConfigError("engine.num_draft_tokens must be >= 1")
    if ecfg.kv_quant not in KV_QUANTS:
        raise ConfigError(f"engine.kv_quant must be none/int8, got "
                          f"{ecfg.kv_quant!r}")
    if ecfg.pipeline_depth < 0:
        raise ConfigError("engine.pipeline_depth must be >= 0")
    if ecfg.decode_block_size < 1:
        raise ConfigError("engine.decode_block_size must be >= 1")
    if ecfg.prefill_batch < 1 or ecfg.prefill_token_budget < 1:
        raise ConfigError("engine.prefill_batch and "
                          "engine.prefill_token_budget must be >= 1")
    for key in ("model_dir", "draft_model_dir"):
        d = g("model", key)
        if d and not os.path.isfile(os.path.join(d, "config.json")):
            raise ConfigError(f"model.{key} {d!r} has no config.json")


def _join_process_group(cfg: ServerConfig) -> None:
    """Join the multi-process runtime when ``distributed.num_processes`` >
    1 (``parallel/distributed.py``); a no-op for one process."""
    initialize(DistributedConfig(
        coordinator_address=cfg.get("distributed", "coordinator_address"),
        num_processes=cfg.get("distributed", "num_processes"),
        process_id=cfg.get("distributed", "process_id")))


def _replica_devices(cfg: ServerConfig, device: torch.device,
                     draft_cfg: Optional[ModelConfig]
                     ) -> Tuple[List[torch.device], Optional[MeshSpec]]:
    """This process's devices and each replica's mesh shape (None: one
    device per replica). Raises ``ConfigError`` for the combinations the
    JAX entry point refuses and for too few devices."""
    g = cfg.get
    nproc = g("distributed", "num_processes")
    tp, pp, cp = (g("engine", "tensor_parallel"),
                  g("engine", "pipeline_parallel"),
                  g("engine", "context_parallel"))
    if cp > 1 and pp > 1:
        raise ConfigError("engine.context_parallel > 1 with "
                          "engine.pipeline_parallel > 1 is not supported")
    if draft_cfg is not None and pp > 1:
        raise ConfigError("speculative decoding (model.draft_model_*) with "
                          "engine.pipeline_parallel > 1 is not supported")
    per_replica = tp * pp * cp
    if per_replica <= 1:
        return [], None
    devices = local_devices(device)
    num_engines = g("server", "num_engines")
    needed = per_replica * num_engines
    if needed > len(devices):
        raise ConfigError(
            f"{num_engines} engines x (tensor_parallel={tp} x "
            f"pipeline_parallel={pp} x context_parallel={cp}) needs "
            f"{needed} devices, have {len(devices)}"
            + (" on this host" if nproc > 1 else ""))
    return devices, MeshSpec(tensor=tp, stage=pp, seq=cp)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    own, rest = _port_args(sys.argv[1:] if argv is None else argv)
    try:
        cfg = ServerConfig.load(cli_args=rest)
        cfg.check_ported()
        _join_process_group(cfg)  # before any device is touched
        ecfg = engine_settings(cfg, own.seed)
        _port_checks(cfg, ecfg)
        model_dir = cfg.get("model", "model_dir") or None
        draft_dir = cfg.get("model", "draft_model_dir") or None
        draft_name = cfg.get("model", "draft_model_name") or None
        quant = cfg.get("model", "quantization")
        device = resolve_device(own.device)
        mcfg = (_dir_config(model_dir) if model_dir
                else get_config(cfg.get("model", "model_name")))
        draft_cfg = (_dir_config(draft_dir) if draft_dir
                     else get_config(draft_name) if draft_name else None)
        if draft_cfg is not None and draft_cfg.vocab_size != mcfg.vocab_size:
            raise ConfigError(
                f"the draft model's vocabulary ({draft_cfg.vocab_size}) "
                f"differs from the target's ({mcfg.vocab_size})")
        if draft_cfg is not None and (ecfg.mixed_step_tokens
                                      and not ecfg.loop_to_completion):
            raise ConfigError(
                "engine.mixed_step_tokens with a draft model needs "
                "engine.loop_to_completion")
        dtype = dtype_from_name(cfg.get("model", "dtype"))
        replicas = _replica_settings(cfg, mcfg, dtype)
        armed = replicas.pop("faults")
        spec = spec_settings(cfg)
        tokenizer = load_tokenizer(model_dir)
        devices, mesh_spec = _replica_devices(cfg, device, draft_cfg)
    except (RuntimeError, KeyError, ValueError, ModelLoadError,
            ConfigError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2

    if armed is not None:
        faults.install(armed)

    def engine_factory(replica_idx: int) -> LLMEngine:
        mesh = None
        if mesh_spec is not None:
            # each replica owns a DISJOINT slice of this process's devices
            n = math.prod(mesh_spec.sizes())
            mesh = make_mesh(mesh_spec,
                             devices[replica_idx * n:(replica_idx + 1) * n])
        if model_dir:
            params, model_cfg = load_checkpoint(model_dir, dtype=dtype,
                                                device=device)
            params = quantize_params(params, quant)
        else:
            model_cfg = mcfg
            gen = torch.Generator(device=device)
            gen.manual_seed(own.seed)
            params = init_random_quantized(model_cfg, quant, gen,
                                           dtype=dtype, device=device)
        draft_params = None
        draft_model_cfg = draft_cfg
        if draft_dir:
            draft_params, draft_model_cfg = load_checkpoint(
                draft_dir, dtype=dtype, device=device)
        elif draft_name:
            # its own generator: the draft's draw differs from the target's
            dgen = torch.Generator(device=device)
            dgen.manual_seed(own.seed + 1)
            draft_params = llama.init_params(draft_cfg, dgen, dtype=dtype,
                                             device=device)
        return LLMEngine(params, model_cfg, tokenizer, ecfg, dtype=dtype,
                         device=device, draft_params=draft_params,
                         draft_cfg=draft_model_cfg, spec=spec, mesh=mesh)

    server = InferenceServer(
        engine_factory, tokenizer,
        model_name=cfg.get("model", "model_name"),
        queue_config=cfg.queue_config(),
        batcher_config=cfg.batcher_config(),
        validator_config=validator_settings(cfg),
        otlp_endpoint=cfg.get("tracing", "otlp_endpoint"),
        otlp_service_name=cfg.get("tracing", "service_name"),
        slo_settings=cfg.slo_settings(),
        health_settings=cfg.health_settings(),
        admission_settings=cfg.admission_settings(), **replicas)
    try:
        server.start()
    except (ModelLoadError, RuntimeError, TimeoutError) as e:
        print(f"startup error: {e}", file=sys.stderr)
        server.shutdown(drain_timeout_s=0)
        return 1

    fleet_worker = None
    if cfg.get("fleet", "connect"):
        # worker mode: join the registry host; the local engines keep
        # their own HTTP surface too
        fleet_worker = FleetWorker(server.scheduler, cfg.fleet_settings(),
                                   metrics=server.metrics,
                                   tracer=server.tracer)
        try:
            # the host may still be warming its engines up
            fleet_worker.start(connect_timeout_s=FLEET_JOIN_TIMEOUT_S)
        except OSError as e:
            print(f"fleet join failed: {e}", file=sys.stderr)
            server.shutdown(drain_timeout_s=0)
            return 1
        print(f"joined fleet at {cfg.get('fleet', 'connect')} as "
              f"{fleet_worker.member_id}", flush=True)

    watcher = ConfigWatcher(cfg)
    watcher.subscribe(server.apply_hot_config)
    watcher.start()

    def _stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _stop)
    host, port = cfg.get("server", "host"), cfg.get("server", "port")
    print(f"serving {model_dir or cfg.get('model', 'model_name')} on "
          f"{device} at {host}:{port}", flush=True)
    try:
        server.serve(host, port)
    except KeyboardInterrupt:
        pass
    finally:
        watcher.stop()
        if fleet_worker is not None:
            fleet_worker.stop()
        server.shutdown(drain_timeout_s=cfg.get("server", "drain_timeout_s"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
