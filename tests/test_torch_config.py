"""The port's configuration against the JAX package's: the same file, env
and CLI give the same ``get()`` for every schema key; every invalid case
raises ``ConfigError`` in both, naming the same key; ``hot_diff`` agrees;
the watcher survives torn writes, atomic replaces and a missing file; and
the port's entry point builds the engine, speculation and validator
settings the JAX entry point builds (at the defaults and under a sample
file), refusing the settings it has not ported."""

from __future__ import annotations

import os
import time

import pytest

import distributed_inference_server_tpu.serving.config as jcfg
import distributed_inference_server_tpu_torch.serving.config as pcfg
from distributed_inference_server_tpu.core.errors import (
    ConfigError as JConfigError,
)
from distributed_inference_server_tpu_torch.core.errors import ConfigError

MODS = {"jax": (jcfg, JConfigError), "torch": (pcfg, ConfigError)}

SAMPLE_TOML = """
[server]
port = 9100
num_engines = 2
engine_roles = "prefill,decode"
strategy = "cache_aware"
max_redispatch = 3
[model]
model_name = "tiny"
dtype = "float32"
draft_model_name = "tiny"
[engine]
max_batch = 24
prefill_buckets = [16, 64]
page_size = 8
num_pages = 300
max_pages_per_seq = 40
decode_block_size = 4
pipeline_depth = 2
prefill_batch = 6
prefill_token_budget = 1000
mixed_step_tokens = 64
loop_to_completion = true
loop_max_steps = 32
num_draft_tokens = 3
spec_disable_threshold = 0.25
spec_reenable_after_s = 5.0
warmup_compile = false
[cache]
digest_depth = 4
fetch_page_cost = 0.5
[disagg]
channel = "protowire"
chunk_pages = 4
[queue]
high_watermark = 40
low_watermark = 10
tenant_fairness = true
tenant_weights = "gold=4,bronze=1"
[batcher]
window_ms = 20.0
[validator]
max_context_tokens = 1000
[slo]
ttft_ms = 250.0
tenant_ttft_ms = "gold=500"
[health]
stall_s = 9.0
[admission]
deadline_factor = 2.0
"""


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _both(fn):
    """``fn(module, ConfigError)`` in both packages; returns (jax, torch)."""
    return tuple(fn(*MODS[k]) for k in ("jax", "torch"))


def _all_keys(cfg):
    return {(s, k): cfg.get(s, k) for s, fields in jcfg._SCHEMA.items()
            for k in fields}


# ---------------------------------------------------------------------------
# schema and precedence
# ---------------------------------------------------------------------------


def test_schema_is_the_reference_schema():
    assert pcfg._SCHEMA == jcfg._SCHEMA
    assert pcfg.HOT_RELOADABLE == jcfg.HOT_RELOADABLE
    assert pcfg.ENV_PREFIX == jcfg.ENV_PREFIX


@pytest.mark.parametrize("source", ["defaults", "toml", "yaml", "env", "cli",
                                    "all_three"])
def test_every_key_equal_in_both(source, tmp_path):
    toml = _write(tmp_path, "c.toml", SAMPLE_TOML)
    yaml_path = _write(tmp_path, "c.yaml",
                       "server:\n  port: 9200\nbatcher:\n  window_ms: 7\n")
    env = {"DIS_TPU_SERVER__PORT": "9300",
           "DIS_TPU_ENGINE__PREFILL_BUCKETS": "16,64,256",
           "DIS_TPU_SERVER__AUTO_RESTART": "off"}
    cli = ["--server-port", "9400", "--batcher-window-ms", "10",
           "--queue-tenant-weights", "a=2"]
    kw = {"defaults": {"environ": {}},
          "toml": {"file_path": toml, "environ": {}},
          "yaml": {"file_path": yaml_path, "environ": {}},
          "env": {"environ": env},
          "cli": {"cli_args": cli, "environ": {}},
          "all_three": {"cli_args": ["--config", toml] + cli,
                        "environ": env}}[source]
    j, p = _both(lambda m, _e: _all_keys(m.ServerConfig.load(**kw)))
    assert j == p
    if source == "all_three":  # CLI > env > file > defaults
        assert p[("server", "port")] == 9400
        assert p[("engine", "prefill_buckets")] == [16, 64, 256]
        assert p[("queue", "high_watermark")] == 40


def test_typed_views_equal(tmp_path):
    toml = _write(tmp_path, "c.toml", SAMPLE_TOML)

    def views(m, _e):
        c = m.ServerConfig.load(file_path=toml, environ={})
        q, b, v = c.queue_config(), c.batcher_config(), c.validator_config()
        d, slo = c.disagg_settings(), c.slo_settings()
        h, a, f = c.health_settings(), c.admission_settings(), c.fetch_costs()
        return (vars(q), vars(b), (v.max_context_tokens, v.max_output_tokens),
                c.strategy().value, c.engine_roles(), vars(d), slo.to_dict(),
                vars(h), vars(a),
                (f.enabled, f.min_pages, f.page_cost, f.load_cost_pages,
                 f.wire_frac))

    j, p = _both(views)
    assert j == p


def test_yaml_without_the_module_is_a_config_error(tmp_path, monkeypatch):
    import builtins

    path = _write(tmp_path, "c.yaml", "server:\n  port: 9200\n")
    real = builtins.__import__

    def blocked(name, *a, **k):
        if name == "yaml":
            raise ImportError("no yaml")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", blocked)
    with pytest.raises(ConfigError, match="yaml"):
        pcfg.ServerConfig.load(file_path=path, environ={})


# ---------------------------------------------------------------------------
# validation: the same key named in both
# ---------------------------------------------------------------------------

INVALID = [
    # tests/test_config.py::TestValidation
    {"DIS_TPU_SERVER__PORT": "0"},
    {"DIS_TPU_SERVER__PORT": "99999"},
    {"DIS_TPU_SERVER__PORT": "not-a-number"},
    {"DIS_TPU_QUEUE__HIGH_WATERMARK": "-5"},
    {"DIS_TPU_QUEUE__LOW_WATERMARK": "2000"},
    {"DIS_TPU_QUEUE__HIGH_WATERMARK": "5000"},
    {"DIS_TPU_SERVER__STRATEGY": "psychic"},
    {"DIS_TPU_MODEL__DTYPE": "int4"},
    {"DIS_TPU_ENGINE__MAX_BATCH": "0"},
    {"DIS_TPU_ENGINE__MIXED_STEP_TOKENS": "-1"},
    {"DIS_TPU_ENGINE__MIXED_STEP_TOKENS": "64"},
    # tests/test_health.py::TestHealthConfig
    {"DIS_TPU_HEALTH__RECOVER_RATIO": "0.9"},
    {"DIS_TPU_HEALTH__LATENCY_RATIO": "1.2"},
    {"DIS_TPU_HEALTH__RETRY_BUDGET_RATIO": "1.5"},
    {"DIS_TPU_HEALTH__DEMOTE_AFTER": "0"},
    {"DIS_TPU_ADMISSION__DEADLINE_FACTOR": "0"},
    {"DIS_TPU_ADMISSION__DEADLINE_MS": "-1"},
    # the rest of the sections
    {"DIS_TPU_SLO__WINDOW_S": "1", "DIS_TPU_SLO__EPOCH_S": "5"},
    {"DIS_TPU_SLO__TENANT_TTFT_MS": "a=x"},
    {"DIS_TPU_QUEUE__TENANT_WEIGHTS": "a=0"},
    {"DIS_TPU_CACHE__HOST_TIER_QUANT": "latent"},
    {"DIS_TPU_DISAGG__WIRE_QUANT": "fp4"},
    {"DIS_TPU_FLEET__CONNECT": "nohost"},
    {"DIS_TPU_FLEET__REGISTRIES": "a:1,b"},
    {"DIS_TPU_ENGINE__PREFILL_BUCKETS": "128,32"},
    {"DIS_TPU_BOGUS__KEY": "1"},
]


@pytest.mark.parametrize("environ", INVALID,
                         ids=[next(iter(e)) + "=" + next(iter(e.values()))
                              for e in INVALID])
def test_invalid_rejected_naming_the_same_key(environ):
    def err(m, exc):
        with pytest.raises(exc) as ei:
            m.ServerConfig.load(environ=environ)
        return str(ei.value)

    j, p = _both(err)
    assert j == p


def test_cli_exits_2_with_config_error(capsys):
    from distributed_inference_server_tpu_torch.__main__ import main

    assert main(["--server-port", "0", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("config error:") and "server.port" in err


# the parallel settings and the multi-process runtime are ported: past the
# devices there are (the suite's 8 virtual CPU devices) or without a
# coordinator they exit 2 with their own config error; so are the fleet's
# control-plane keys, which exit 2 with their own checks' errors
_PORTED_REFUSALS = {
    "engine.tensor_parallel": "needs 16 devices, have 8",
    "engine.pipeline_parallel": "needs 16 devices, have 8",
    "engine.context_parallel": "needs 16 devices, have 8",
    "distributed.num_processes": "distributed.",
    "fleet.enabled": "fleet.port must be in [0, 65536)",
    "fleet.connect": "fleet.connect must be host:port",
    "fleet.rerole": "fleet.rerole_low_ratio must be below",
}


@pytest.mark.parametrize("flags,key", [
    (["--engine-tensor-parallel", "16"], "engine.tensor_parallel"),
    (["--engine-pipeline-parallel", "16"], "engine.pipeline_parallel"),
    (["--engine-context-parallel", "16"], "engine.context_parallel"),
    (["--distributed-num-processes", "2"], "distributed.num_processes"),
    (["--server-grpc-port", "50051"], "server.grpc_port"),
    (["--fleet-enabled", "true", "--fleet-port", "70000"], "fleet.enabled"),
    (["--fleet-connect", "no-port"], "fleet.connect"),
    (["--fleet-registries", "127.0.0.1:7070"], "fleet.registries"),
    (["--fleet-rerole", "true", "--fleet-rerole-low-ratio", "9"],
     "fleet.rerole"),
])
def test_unported_settings_are_refused(flags, key, capsys, monkeypatch):
    """The gRPC transport and registry HA exit 2 as not ported yet; the
    ported parallel and fleet settings exit 2 with the device-count,
    coordinator or value error instead, never as unported."""
    from distributed_inference_server_tpu_torch.__main__ import main

    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=8")
    monkeypatch.delenv("RANK", raising=False)
    assert main(flags + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("config error:")
    if key in _PORTED_REFUSALS:
        assert "not ported" not in err
        assert _PORTED_REFUSALS[key] in err
    else:
        assert f"{key} is not ported yet" in err


def test_compile_cache_dir_is_accepted():
    cfg = pcfg.ServerConfig.load(
        cli_args=["--server-compile-cache-dir", "/nowhere"], environ={})
    cfg.check_ported()
    assert cfg.get("server", "compile_cache_dir") == "/nowhere"


# -- the JAX cases that waited for the port's config ----------------------


def test_digest_depth_config_validation():
    with pytest.raises(ConfigError):
        pcfg.ServerConfig.load(environ={"DIS_TPU_CACHE__DIGEST_DEPTH": "0"})
    cfg = pcfg.ServerConfig.load(environ={
        "DIS_TPU_CACHE__DIGEST_DEPTH": "16",
        "DIS_TPU_CACHE__FETCH_PAGE_COST": "0.1"})
    assert cfg.get("cache", "digest_depth") == 16
    costs = cfg.fetch_costs()
    assert costs.page_cost == 0.1 and costs.enabled


def test_config_gates_and_validates_spec():
    cfg = pcfg.ServerConfig.load(
        environ={"DIS_TPU_FAULTS__SPEC": "runner.step:nth=1",
                 "DIS_TPU_FAULTS__SEED": "5"})
    assert cfg.get("faults", "spec") == "runner.step:nth=1"
    assert cfg.get("faults", "seed") == 5
    with pytest.raises(ConfigError):
        pcfg.ServerConfig.load(environ={"DIS_TPU_FAULTS__SPEC": "nonsense"})


def test_config_wires_roles_and_validates():
    cfg = pcfg.ServerConfig.load(environ={
        "DIS_TPU_SERVER__NUM_ENGINES": "2",
        "DIS_TPU_SERVER__ENGINE_ROLES": "prefill,decode",
        "DIS_TPU_DISAGG__CHANNEL": "protowire",
        "DIS_TPU_DISAGG__HANDOFF_RETRIES": "3",
    })
    assert cfg.engine_roles() == ["prefill", "decode"]
    s = cfg.disagg_settings()
    assert s.channel == "protowire" and s.handoff_retries == 3
    with pytest.raises(ConfigError):
        pcfg.ServerConfig.load(environ={
            "DIS_TPU_SERVER__NUM_ENGINES": "2",
            "DIS_TPU_SERVER__ENGINE_ROLES": "decode,decode"})
    with pytest.raises(ConfigError):
        pcfg.ServerConfig.load(environ={
            "DIS_TPU_DISAGG__CHANNEL": "smoke-signal"})


# ---------------------------------------------------------------------------
# hot reload
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env", [
    {"DIS_TPU_BATCHER__MAX_BATCH_SIZE": "16", "DIS_TPU_SERVER__PORT": "9999"},
    {"DIS_TPU_QUEUE__HIGH_WATERMARK": "50", "DIS_TPU_QUEUE__LOW_WATERMARK":
     "10", "DIS_TPU_SERVER__STRATEGY": "memory_aware",
     "DIS_TPU_QUEUE__MAX_QUEUE_SIZE": "5000"},
    {"DIS_TPU_BATCHER__WINDOW_MS": "0", "DIS_TPU_QUEUE__REQUEST_TIMEOUT_S":
     "5", "DIS_TPU_ENGINE__MAX_BATCH": "8"},
])
def test_hot_diff_equal(env):
    j, p = _both(lambda m, _e: m.ServerConfig.load(environ={}).hot_diff(
        m.ServerConfig.load(environ=env)))
    assert j == p and p
    assert all(k in pcfg.HOT_RELOADABLE for k in p)


def _watcher(tmp_path, text="[batcher]\nmax_batch_size = 32\n", **kw):
    path = _write(tmp_path, "c.toml", text)
    return path, pcfg.ConfigWatcher(
        pcfg.ServerConfig.load(file_path=path, environ={}), **kw)


def test_watcher_applies_file_change_and_keeps_cli(tmp_path):
    path = _write(tmp_path, "c.toml", "[queue]\nrequest_timeout_s = 10.0\n")
    cfg = pcfg.ServerConfig.load(
        cli_args=["--config", path, "--batcher-window-ms", "10"], environ={})
    w = pcfg.ConfigWatcher(cfg)
    seen = []
    w.subscribe(lambda diff, new: seen.append(diff))
    _write(tmp_path, "c.toml", "[queue]\nrequest_timeout_s = 20.0\n")
    os.utime(path, (0, 0))
    assert w.check_once() is True
    assert seen == [{("queue", "request_timeout_s"): 20.0}]
    assert w.current.get("batcher", "window_ms") == 10.0  # CLI kept


def test_watcher_rejects_invalid_new_config(tmp_path):
    path, w = _watcher(tmp_path)
    _write(tmp_path, "c.toml", "[queue]\nhigh_watermark = -1\n")
    os.utime(path, (0, 0))
    assert w.check_once() is False
    assert w.current.get("batcher", "max_batch_size") == 32


def test_torn_write_then_same_mtime_completion_still_reloads(tmp_path):
    path, w = _watcher(tmp_path)
    _write(tmp_path, "c.toml", "[batcher\nmax_batch")  # torn write
    os.utime(path, (5, 5))
    assert w.check_once() is False
    assert w.current.get("batcher", "max_batch_size") == 32
    _write(tmp_path, "c.toml", "[batcher]\nmax_batch_size = 8\n")
    os.utime(path, (5, 5))  # the same mtime as the torn snapshot
    assert w.check_once() is True
    assert w.current.get("batcher", "max_batch_size") == 8


def test_atomic_replace_applies(tmp_path):
    path, w = _watcher(tmp_path)
    tmp = _write(tmp_path, "c.toml.tmp", "[batcher]\nmax_batch_size = 4\n")
    os.replace(tmp, path)
    os.utime(path, (9, 9))
    assert w.check_once() is True
    assert w.current.get("batcher", "max_batch_size") == 4


def test_enoent_window_survives_and_recovers(tmp_path):
    path, w = _watcher(tmp_path)
    os.unlink(path)
    assert w.check_once() is False
    assert w.current.get("batcher", "max_batch_size") == 32
    _write(tmp_path, "c.toml", "[batcher]\nmax_batch_size = 16\n")
    os.utime(path, (7, 7))
    assert w.check_once() is True
    assert w.current.get("batcher", "max_batch_size") == 16


def test_watcher_thread_polls_and_stops(tmp_path):
    path, w = _watcher(tmp_path, poll_interval_s=0.05)
    seen = []
    w.subscribe(lambda diff, new: seen.append(diff))
    w.start()
    try:
        _write(tmp_path, "c.toml", "[batcher]\nmax_batch_size = 2\n")
        os.utime(path, (3, 3))
        deadline = time.monotonic() + 5.0
        while not seen and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        w.stop()
    assert seen == [{("batcher", "max_batch_size"): 2}]


def _bare_server():
    """A port ``InferenceServer`` shell with only its dispatcher and
    scheduler (no engines)."""
    from distributed_inference_server_tpu_torch.serving.dispatcher import (
        Dispatcher,
    )
    from distributed_inference_server_tpu_torch.serving.scheduler import (
        AdaptiveScheduler,
    )
    from distributed_inference_server_tpu_torch.serving.server import (
        InferenceServer,
    )

    srv = InferenceServer.__new__(InferenceServer)
    srv.scheduler = AdaptiveScheduler()
    srv.dispatcher = Dispatcher(srv.scheduler, native_queue=False)
    return srv


def test_server_applies_hot_config_and_no_non_hot_key_leaks():
    srv = _bare_server()
    old_cap = srv.dispatcher.queue.config.max_queue_size
    new = pcfg.ServerConfig.load(environ={
        "DIS_TPU_BATCHER__MAX_BATCH_SIZE": "4",
        "DIS_TPU_BATCHER__WINDOW_MS": "0",
        "DIS_TPU_QUEUE__HIGH_WATERMARK": "50",
        "DIS_TPU_QUEUE__LOW_WATERMARK": "10",
        "DIS_TPU_QUEUE__MAX_QUEUE_SIZE": "5000",
        "DIS_TPU_SERVER__STRATEGY": "memory_aware"})
    srv.apply_hot_config(pcfg.ServerConfig.load(environ={}).hot_diff(new),
                         new)
    assert srv.dispatcher.batcher.config.max_batch_size == 4
    assert srv.dispatcher.batcher.config.window_ms == 0
    assert srv.dispatcher.queue.config.high_watermark == 50
    assert srv.dispatcher.queue.config.max_queue_size == old_cap
    assert srv.scheduler.strategy().value == "memory_aware"


# ---------------------------------------------------------------------------
# the entry point's engine settings (the JAX __main__'s, fault 1)
# ---------------------------------------------------------------------------


class _Captured(Exception):
    pass


def _capture_main(monkeypatch, which: str, argv):
    """Run one package's ``main`` up to the server start; returns the
    server's keyword arguments and the engine factory's LLMEngine call."""
    got = {}

    class FakeServer:
        def __init__(self, engine_factory, tokenizer, **kw):
            got["factory"] = engine_factory
            got["server"] = kw

        def start(self):
            raise RuntimeError("stopped before start")

        def shutdown(self, *a, **k):
            pass

    def fake_engine(*args, **kw):
        got["engine"] = (args, kw)
        raise _Captured()

    if which == "jax":
        import distributed_inference_server_tpu.__main__ as jmain
        import distributed_inference_server_tpu.engine.engine as jengine
        import distributed_inference_server_tpu.serving.server as jserver

        monkeypatch.setattr(jserver, "InferenceServer", FakeServer)
        monkeypatch.setattr(jengine, "LLMEngine", fake_engine)
        assert jmain.main(argv) == 1
    else:
        import distributed_inference_server_tpu_torch.__main__ as pmain

        monkeypatch.setattr(pmain, "InferenceServer", FakeServer)
        monkeypatch.setattr(pmain, "LLMEngine", fake_engine)
        assert pmain.main(argv + ["--device", "cpu"]) == 1
    import inspect

    factory = got["factory"]
    with pytest.raises(_Captured):
        # the JAX factory takes the replica index
        factory(0) if inspect.signature(factory).parameters else factory()
    return got


ENGINE_FIELDS = ("max_batch", "prefill_buckets", "decode_block_size",
                 "pipeline_depth", "prefill_batch", "prefill_token_budget",
                 "mixed_step_tokens", "loop_to_completion", "loop_max_steps",
                 "warmup_compile", "kv_quant", "host_tier_bytes",
                 "host_tier_quant", "latent_rank", "digest_depth")


@pytest.mark.parametrize("source", ["defaults", "sample_file"])
def test_entry_point_builds_the_jax_engine_settings(source, tmp_path,
                                                    monkeypatch):
    for k in [k for k in os.environ if k.startswith("DIS_TPU_")]:
        monkeypatch.delenv(k)
    argv = ["--server-compile-cache-dir", ""]
    if source == "sample_file":
        argv += ["--config", _write(tmp_path, "c.toml", SAMPLE_TOML)]
    j = _capture_main(monkeypatch, "jax", argv)
    p = _capture_main(monkeypatch, "torch", argv)
    (jargs, jkw), (pargs, pkw) = j["engine"], p["engine"]
    je, pe = jargs[3], pargs[3]
    for f in ENGINE_FIELDS:
        assert getattr(pe, f) == getattr(je, f), f
    for f in ("num_pages", "page_size", "max_pages_per_seq"):
        assert getattr(pe.paged, f) == getattr(je.paged, f), f
    js, ps = jkw["spec"], pkw["spec"]
    assert (js is None) == (ps is None) == (source == "defaults")
    if js is not None:
        assert vars(ps) == vars(js)
    jv, pv = j["server"]["validator_config"], p["server"]["validator_config"]
    assert pv.max_context_tokens == jv.max_context_tokens
    assert pv.max_output_tokens == jv.max_output_tokens
    for key in ("num_engines", "max_redispatch", "auto_restart",
                "otlp_endpoint"):
        assert p["server"][key] == j["server"][key], key
    if source == "defaults":
        # the JAX schema's engine, not the port's old EngineConfig defaults
        assert (pe.max_batch, pe.paged.num_pages, pe.paged.max_pages_per_seq,
                pe.prefill_batch, pe.prefill_token_budget) == (
                    64, 2048, 512, 16, 8192)
        assert pv.max_context_tokens == 8191
    else:
        assert pv.max_context_tokens == 8 * 40 - 1  # clamped to the pool
