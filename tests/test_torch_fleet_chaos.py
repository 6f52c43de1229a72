"""The fleet's chaos scenarios on the port: the control-plane scenarios of
``tools/chaos_fleet.py`` (which drives the JAX package) re-implemented over
the port's servers, at the committed seeds of ``tests/test_chaos.py``.

Each scenario runs on a TINY f32 fleet built like the reference's: a
registry host and a member ``InferenceServer`` joined over a real
localhost connection by a ``FleetWorker`` (``chaos-w1``), hot health
loops, and short aging windows. After each one, with the faults disarmed,
the reference's invariants hold (``tools/chaos_fleet.py:432-495``): every
request ends exactly once and streams nothing after its end, every
engine's page audit is clean on both servers, the in-flight maps, the
admission queue, the batcher and the migrations drain, and with restarts
on every replica is healthy again.

- ``registry_partition``: heartbeats dropped at the registry age the member
  to dead, then it rejoins and serves.
- ``remote_runner_crash_mid_request``: the forwarded submit dies on the
  wire or the member crashes on receipt; the request completes by
  redispatch.
- ``rerole_flap``: the ``sched.rerole`` flag oscillates the balancer's
  signal; the cooldown bounds the flips and the roles converge back.
- ``slow_member_brownout``: a member delayed by ``fleet.slow_member`` is
  demoted by the health scorer on its own telemetry, drained without a
  client error, and promoted again once fast.
"""

from __future__ import annotations

import random
import threading
import time

import pytest
import torch

from distributed_inference_server_tpu_torch.core.errors import QueueFull
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PagedCacheConfig,
)
from distributed_inference_server_tpu_torch.models import llama
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving.disagg import (
    DisaggSettings,
)
from distributed_inference_server_tpu_torch.serving.fleet import (
    FleetSettings,
)
from distributed_inference_server_tpu_torch.serving.health import (
    HealthSettings,
)
from distributed_inference_server_tpu_torch.serving.remote_runner import (
    FleetWorker,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    ServerRequest,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)
from distributed_inference_server_tpu_torch.serving.teledigest import (
    SloSettings,
)

_PROMPT = "chaos is a ladder, resilience is a lattice"
MEMBER = "chaos-w1"
_PARAMS = llama.init_params(TINY, torch.Generator().manual_seed(0),
                            dtype=torch.float32, device="cpu")


class ChaosSink:
    """Records the stream contract: terminal events, ordering violations
    and codes."""

    def __init__(self, rid: str):
        self.rid = rid
        self.tokens = 0
        self.dones = 0
        self.errors = []
        self.violations = []
        self.ev = threading.Event()
        self._lock = threading.Lock()

    def _terminal(self, kind: str) -> None:
        with self._lock:
            if self.ev.is_set():
                self.violations.append(
                    f"{self.rid}: second terminal event ({kind})")
            self.ev.set()

    def on_token(self, token_id, text, token_index, logprob=None):
        with self._lock:
            if self.ev.is_set():
                self.violations.append(
                    f"{self.rid}: token streamed after a terminal event")
            self.tokens += 1

    def on_done(self, finish_reason, usage):
        self._terminal("done")
        self.dones += 1

    def on_error(self, message, code):
        self._terminal(f"error:{code}")
        self.errors.append((message, code))

    @property
    def terminal_count(self) -> int:
        return self.dones + len(self.errors)


def _factory():
    return LLMEngine(_PARAMS, TINY, ByteTokenizer(),
                     EngineConfig(max_batch=4, prefill_buckets=(16, 64),
                                  paged=PagedCacheConfig(192, 8, 32)),
                     dtype=torch.float32, device="cpu")


def _chaos_health() -> HealthSettings:
    return HealthSettings(
        interval_s=60.0, stall_s=10.0, latency_ratio=2.5,
        recover_ratio=1.2, demote_after=2, recover_after=2,
        min_window_requests=3, wire_failures=2, breaker_open_s=0.4)


def _chaos_slo() -> SloSettings:
    return SloSettings(ttft_ms=300.0, window_s=4.0, epoch_s=0.5)


def build_fleet(roles=("unified",), fleet=False, rerole=False,
                health=None, slo=None):
    """The reference's chaos fleet on the port: a host server and, with
    ``fleet``, a member server joined as ``chaos-w1``. The balancer's own
    loop is slowed to a minute: scenarios drive ``evaluate()``."""
    settings = FleetSettings(
        enabled=fleet, heartbeat_interval_s=0.1, suspect_after_s=0.6,
        dead_after_s=1.5, rerole=rerole, rerole_high_ratio=2.0,
        rerole_low_ratio=0.5, rerole_cooldown_s=0.3,
        rerole_interval_s=60.0)
    srv = InferenceServer(
        _factory, ByteTokenizer(), "tiny-chaos", num_engines=len(roles),
        engine_roles=list(roles), auto_restart=True,
        health_check_interval_s=0.1, restart_backoff_s=0.2,
        restart_backoff_max_s=2.0,
        disagg_settings=DisaggSettings(handoff_timeout_s=20.0),
        fleet_settings=settings, health_settings=health, slo_settings=slo)
    srv.start()
    srv.member_srv = srv.member_worker = None
    if fleet:
        srv.member_srv = InferenceServer(
            _factory, ByteTokenizer(), "tiny-chaos-member", num_engines=1,
            auto_restart=True, health_check_interval_s=0.1,
            slo_settings=slo)
        srv.member_srv.start()
        srv.member_settings = FleetSettings(
            connect=f"127.0.0.1:{srv.fleet_server.bound_port}",
            heartbeat_interval_s=0.1)
        ensure_member(srv)
    return srv


def shutdown_fleet(srv) -> None:
    if srv.member_worker is not None:
        srv.member_worker.stop()
    if srv.member_srv is not None:
        srv.member_srv.shutdown(drain_timeout_s=5.0)
    srv.shutdown(drain_timeout_s=5.0)


def ensure_member(srv, timeout_s: float = 20.0):
    """The member connected, alive and its proxy healthy; a member crashed
    by an earlier seed rejoins under the same id."""
    fw = srv.member_worker
    if fw is None or fw._crashed or not fw.is_connected():
        if fw is not None:
            fw.stop()
        fw = FleetWorker(srv.member_srv.scheduler, srv.member_settings,
                         member_id=MEMBER, metrics=srv.member_srv.metrics,
                         tracer=srv.member_srv.tracer)
        fw.start()
        srv.member_worker = fw
    if not _wait_until(lambda: _member_up(srv), timeout_s):
        raise RuntimeError(f"chaos fleet member {MEMBER} failed to join")
    return fw


def _member_up(srv) -> bool:
    return (srv.fleet_registry.member_state(MEMBER) == "alive"
            and any(r.is_healthy() for r in _remotes(srv)))


def _remotes(srv):
    return [r for r in srv.scheduler.engines()
            if getattr(r, "is_remote", False)]


def _wait_until(pred, timeout_s: float, interval_s: float = 0.03) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval_s)
    return False


def _wait_member_state(srv, state: str, timeout_s: float = 10.0) -> bool:
    return _wait_until(
        lambda: srv.fleet_registry.member_state(MEMBER) == state, timeout_s)


def _request(rid: str, sink, prompt: str = _PROMPT, max_tokens: int = 16):
    return ServerRequest(rid, list(prompt.encode()),
                         SamplingParams(max_tokens=max_tokens,
                                        temperature=0.0), sink)


def submit(srv, rid: str, max_tokens: int = 16, sinks=None):
    """One request through the dispatcher; None when admission refused it
    (backpressure, not a violation)."""
    sink = ChaosSink(rid)
    try:
        srv.dispatcher.submit(_request(rid, sink, max_tokens=max_tokens))
    except QueueFull:
        return None
    if sinks is not None:
        sinks.append(sink)
    return sink


def drive_remote(srv, rid: str, max_tokens: int = 8, sinks=None):
    """One request straight at the member's proxy."""
    sink = ChaosSink(rid)
    _remotes(srv)[0].submit([_request(rid, sink, max_tokens=max_tokens)])
    if sinks is not None:
        sinks.append(sink)
    return sink


def wait_terminal(sinks, timeout_s: float = 60.0):
    deadline = time.monotonic() + timeout_s
    return [s.rid for s in sinks
            if not s.ev.wait(max(0.0, deadline - time.monotonic()))]


def _arm(spec: str, seed: int) -> None:
    faults.install(faults.parse_spec(spec, seed))


def check_invariants(srv, sinks, require_success=False,
                     converge_timeout_s: float = 30.0):
    violations = []
    for s in sinks:
        violations.extend(s.violations)
        if s.terminal_count != 1:
            violations.append(
                f"{s.rid}: {s.terminal_count} terminal events "
                f"({s.dones} done, {len(s.errors)} error), want exactly 1")
        if require_success and s.errors:
            violations.append(f"{s.rid}: expected success, got {s.errors}")
    members = [srv.member_srv] if srv.member_srv is not None else []

    def drained() -> bool:
        runners = srv.scheduler.engines()
        for m in members:
            runners = runners + m.scheduler.engines()
        return (all(r.is_healthy() for r in runners)
                and all(r.active_count() == 0 for r in runners)
                and srv.dispatcher.queue.is_empty()
                and srv.dispatcher.batcher.pending_count() == 0
                and (srv.disagg is None or srv.disagg.pending_count() == 0)
                and srv.prefix_fetcher.pending_count() == 0)

    if not _wait_until(drained, converge_timeout_s, 0.05):
        state = {r.engine_id: (r.is_healthy(), r.active_count())
                 for r in srv.scheduler.engines()}
        violations.append(f"fleet did not reconverge or drain within "
                          f"{converge_timeout_s}s: engines={state}")
    for server in [srv] + members:
        for r in server.local_runners():
            violations.extend(r.audit())
    return violations


# ---------------------------------------------------------------------------
# scenarios: each arms a seeded fault set, drives traffic and returns
# (sinks, require_success, extra violations)
# ---------------------------------------------------------------------------


def scenario_registry_partition(srv, seed: int):
    rng = random.Random(seed)
    sinks, extra = [], []
    ensure_member(srv)
    # enough consecutive dropped beats to cross dead_after_s
    _arm(f"fleet.heartbeat:nth=1,times={rng.randint(22, 30)}", seed)
    for i in range(rng.randint(1, 3)):
        submit(srv, f"part-{seed}-{i}", sinks=sinks)
    if not _wait_member_state(srv, "dead", timeout_s=12.0):
        extra.append("member never aged out to dead under dropped beats")
    faults.clear()  # the partition heals
    if not _wait_member_state(srv, "alive", timeout_s=12.0):
        extra.append("member never rejoined after the partition healed")
    else:
        ensure_member(srv)
        rejoin = submit(srv, f"part-{seed}-rejoin", sinks=sinks)
        if rejoin is not None:
            rejoin.ev.wait(60)
            if rejoin.errors:
                extra.append(f"post-rejoin request failed: {rejoin.errors}")
    for s in sinks:
        for _msg, code in s.errors:
            if code != "engine_crashed":
                extra.append(f"{s.rid}: unexpected failure code {code!r}")
    extra += [f"{r}: no terminal event (wedged)"
              for r in wait_terminal(sinks)]
    return sinks, False, extra


def scenario_remote_runner_crash_mid_request(srv, seed: int):
    rng = random.Random(seed)
    ensure_member(srv)
    # hit 1 = the proxy's submit (the wire), hit 2 = the member's
    # executor (a crash on receipt)
    _arm(f"fleet.submit:nth={rng.randint(1, 2)}", seed)
    sinks = []
    drive_remote(srv, f"rrc-{seed}", max_tokens=16, sinks=sinks)
    wedged = wait_terminal(sinks, timeout_s=60.0)
    return sinks, True, [f"{r}: no terminal event (wedged)" for r in wedged]


def scenario_rerole_flap(srv, seed: int):
    rng = random.Random(seed)
    bal = srv.role_balancer
    bal.stop()
    before = srv.metrics.fleet_counters()["reroles"]
    sinks = []
    _arm("sched.rerole:prob=0.5,times=1000", seed)
    t0 = time.monotonic()
    for i in range(rng.randint(30, 45)):
        bal.evaluate()
        if i % 10 == 0:
            submit(srv, f"flapr-{seed}-{i}", max_tokens=8, sinks=sinks)
        time.sleep(0.02)
    faults.clear()
    elapsed = time.monotonic() - t0
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and bal.stats()["flipped"]:
        bal.evaluate()
        time.sleep(0.05)
    after = srv.metrics.fleet_counters()["reroles"]
    flips = sum(after.get(k, 0) - before.get(k, 0)
                for k in ("to_prefill", "to_unified"))
    bound = int((elapsed + 10.0) / bal.settings.rerole_cooldown_s) + 2
    extra = []
    if flips > bound:
        extra.append(f"role flapping: {flips} flips in {elapsed:.1f}s "
                     f"(bound {bound})")
    if flips < 2:
        extra.append(f"rerole never exercised (flips={flips})")
    if bal.stats()["flipped"]:
        extra.append(f"balancer did not restore {bal.stats()['flipped']}")
    roles = {r.engine_id: r.role for r in srv.local_runners()}
    if "prefill" in roles.values():
        extra.append(f"fleet did not converge back to unified: {roles}")
    extra += [f"{r}: no terminal event (wedged)"
              for r in wait_terminal(sinks)]
    return sinks, True, extra


def _remote_health(srv) -> str:
    return srv.health_scorer.state(_remotes(srv)[0].engine_id)


def scenario_slow_member_brownout(srv, seed: int):
    rng = random.Random(seed)
    ensure_member(srv)
    sinks, extra = [], []

    def traffic(tag, n_local, n_remote):
        batch = [s for s in (submit(srv, f"smb-{seed}-{tag}-l{i}",
                                    max_tokens=8, sinks=sinks)
                             for i in range(n_local)) if s is not None]
        batch += [drive_remote(srv, f"smb-{seed}-{tag}-r{i}", sinks=sinks)
                  for i in range(n_remote)]
        wait_terminal(batch, timeout_s=90.0)

    # both sources collect windowed TTFT samples while the member is slow
    _arm(f"fleet.slow_member:prob=1.0,delay_ms={rng.randint(350, 450)},"
         "times=1000", seed)
    traffic("warm", 4, 4)
    deadline = time.monotonic() + 20.0
    while (time.monotonic() < deadline
           and _remote_health(srv) != "degraded"):
        traffic("evid", 1, 1)
        srv.health_scorer.evaluate()
        time.sleep(0.15)
    if _remote_health(srv) != "degraded":
        extra.append(f"slow member never demoted (health="
                     f"{_remote_health(srv)}, "
                     f"stats={srv.health_scorer.stats()})")
    else:
        # new admissions drain onto the healthy local replica, cleanly
        traffic("drain", 3, 0)
    faults.clear()  # the member is fast again
    deadline = time.monotonic() + 30.0
    while (time.monotonic() < deadline
           and _remote_health(srv) != "healthy"):
        traffic("recov", 1, 1)
        srv.health_scorer.evaluate()
        time.sleep(0.25)
    if _remote_health(srv) != "healthy":
        extra.append(f"member never recovered (health="
                     f"{_remote_health(srv)})")
    extra += [f"{r}: no terminal event (wedged)"
              for r in wait_terminal(sinks, timeout_s=90.0)]
    return sinks, True, extra


SCENARIOS = {
    "registry_partition": (scenario_registry_partition,
                           {"roles": ("unified",), "fleet": True}),
    "remote_runner_crash_mid_request": (
        scenario_remote_runner_crash_mid_request,
        {"roles": ("unified",), "fleet": True}),
    # one unified admission engine and one decode target: the balancer
    # is the prefill source
    "rerole_flap": (scenario_rerole_flap,
                    {"roles": ("unified", "decode"), "rerole": True}),
    "slow_member_brownout": (scenario_slow_member_brownout,
                             {"roles": ("unified",), "fleet": True,
                              "health": _chaos_health(),
                              "slo": _chaos_slo()}),
}


def run_scenario(name: str, seed: int, srv=None):
    fn, kwargs = SCENARIOS[name]
    if srv is None:
        srv = build_fleet(**kwargs)
    try:
        sinks, require_success, extra = fn(srv, seed)
    finally:
        faults.clear()
    return list(extra) + check_invariants(
        srv, sinks, require_success=require_success), srv


@pytest.fixture(scope="module")
def fleet_cache():
    """One fleet per scenario, reused across its seeds (scenarios heal a
    crashed member through ``ensure_member``)."""
    cache = {}
    yield cache
    faults.clear()
    for srv in cache.values():
        shutdown_fleet(srv)


@pytest.mark.parametrize("scenario,seed", [
    ("registry_partition", 31),
    ("registry_partition", 32),
    ("registry_partition", 33),
    # 31 kills the forwarded submit on the host's wire, 34 and 35 crash
    # the member on receipt
    ("remote_runner_crash_mid_request", 31),
    ("remote_runner_crash_mid_request", 34),
    ("remote_runner_crash_mid_request", 35),
    ("rerole_flap", 31),
    ("rerole_flap", 32),
    ("rerole_flap", 33),
    ("slow_member_brownout", 51),
    # the seed suite's further brownout seeds, each tens of seconds
    pytest.param("slow_member_brownout", 52, marks=pytest.mark.slow),
    pytest.param("slow_member_brownout", 53, marks=pytest.mark.slow),
])
def test_scenario_clean(scenario, seed, fleet_cache):
    violations, srv = run_scenario(scenario, seed,
                                   srv=fleet_cache.get(scenario))
    fleet_cache[scenario] = srv
    assert violations == []
