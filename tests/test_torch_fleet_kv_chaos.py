"""The chaos scenarios of the fleet's KV data plane, mesh and registry HA on
the port: ``cross_host_handoff_death``, ``remote_fetch_source_death``,
``breaker_flap``, ``mesh_peer_wire_death``, ``registry_failover`` and
``registry_split_brain`` of ``tools/chaos_fleet.py`` (which drives the JAX
package), re-implemented over the port's servers at the committed seeds of
``tests/test_chaos.py``.

Each scenario runs on a TINY f32 fleet built like the reference's: a
registry host and a member ``InferenceServer`` joined over real localhost
connections (the control wire and the KV data channel) by a
``FleetWorker`` (``chaos-w1``); the mesh adds a second member
(``chaos-w2``), HA a second registry on an ordered ``fleet.registries``
list with chaos-fast lease windows. After each scenario, with the faults
disarmed, the reference's invariants hold: every request ends exactly
once and streams nothing after its end, the in-flight maps, the queue, the
batcher, the migrations and the fetches drain, every replica is healthy
again, and every engine's page audit is clean on every process. The HA
scenarios add theirs: the standby promotes at a higher epoch and serves
through its own front door, the restarted old primary comes back a standby
at the new epoch, a split brain heals to one primary with the epochs
converged, and the member fences the stale primary's submits.
"""

from __future__ import annotations

import dataclasses
import random
import socket
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
    chain_hashes,
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
from distributed_inference_server_tpu_torch.serving.scheduler import (
    SchedulingStrategy,
    prefix_match_depth,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)

_PROMPT = "chaos is a ladder, resilience is a lattice"
W1, W2 = "chaos-w1", "chaos-w2"
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


def _chaos_health() -> HealthSettings:
    return HealthSettings(
        interval_s=60.0, stall_s=10.0, latency_ratio=2.5,
        recover_ratio=1.2, demote_after=2, recover_after=2,
        min_window_requests=3, wire_failures=2, breaker_open_s=0.4)


def _free_ports(n: int):
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class ChaosFleet:
    """The reference's chaos fleet on the port (``build_fleet``): a host
    server (``srv``) and a member (``chaos-w1``); ``mesh`` adds a second
    member (``chaos-w2``) and the member-to-member mesh, ``ha`` a standby
    registry (``standby``) on a two-entry ``fleet.registries``."""

    def __init__(self, roles=("unified",), member_roles=("unified",),
                 strategy="least_loaded", native_allocator=None,
                 health=None, mesh=False, ha=False):
        def factory():
            return LLMEngine(_PARAMS, TINY, ByteTokenizer(), EngineConfig(
                max_batch=4, prefill_buckets=(16, 64),
                paged=PagedCacheConfig(192, 8, 32),
                native_allocator=native_allocator),
                dtype=torch.float32, device="cpu")

        registries = ()
        ports = (0, 0)
        if ha:
            ports = tuple(_free_ports(2))
            registries = tuple(f"127.0.0.1:{p}" for p in ports)
        settings = FleetSettings(
            enabled=True, heartbeat_interval_s=0.1, suspect_after_s=0.6,
            dead_after_s=1.5, mesh_enabled=mesh, port=ports[0],
            registries=registries, lease_s=1.2, lease_suspect_s=0.6)

        def server(name, fleet_settings=None, roles_=roles, **kw):
            srv = InferenceServer(
                factory, ByteTokenizer(), name, num_engines=len(roles_),
                engine_roles=list(roles_), auto_restart=True,
                health_check_interval_s=0.1, restart_backoff_s=0.2,
                restart_backoff_max_s=2.0,
                strategy=SchedulingStrategy.parse(strategy),
                fleet_settings=fleet_settings, **kw)
            srv.start()
            return srv

        self.srv = server("tiny-chaos", settings,
                          disagg_settings=DisaggSettings(
                              handoff_timeout_s=20.0),
                          health_settings=health)
        self.standby = None
        if ha:
            self.standby = server("tiny-chaos-standby",
                                  dataclasses.replace(settings,
                                                      port=ports[1]))
            if not _wait_until(self.srv.fleet_ha.is_primary, 15.0):
                raise RuntimeError("the HA fleet never elected a primary")
        self.members = {W1: server("tiny-chaos-member",
                                   roles_=member_roles)}
        if mesh:
            self.members[W2] = server("tiny-chaos-member2",
                                      roles_=member_roles)
        self.member_settings = FleetSettings(
            connect=f"127.0.0.1:{self.srv.fleet_server.bound_port}",
            heartbeat_interval_s=0.1, mesh_enabled=mesh,
            registries=registries)
        self.workers = {}
        for member_id in self.members:
            self.ensure_member(member_id)

    def registries(self):
        return [s for s in (self.srv, self.standby) if s is not None]

    def ensure_member(self, member_id=W1, timeout_s: float = 20.0):
        """The member connected, alive and its proxy healthy; one crashed
        by an earlier seed rejoins under the same id."""
        fw = self.workers.get(member_id)
        if fw is None or fw._crashed or not fw.is_connected():
            if fw is not None:
                fw.stop()
            msrv = self.members[member_id]
            fw = FleetWorker(msrv.scheduler, self.member_settings,
                             member_id=member_id, metrics=msrv.metrics,
                             tracer=msrv.tracer)
            fw.start()
            self.workers[member_id] = fw
        if not _wait_until(lambda: _member_up(self.srv, member_id),
                           timeout_s):
            raise RuntimeError(f"chaos member {member_id} failed to join")
        return fw

    def all_servers(self):
        return self.registries() + list(self.members.values())

    def close(self):
        faults.clear()
        for fw in self.workers.values():
            fw.stop()
        for srv in list(self.members.values()) + [self.standby, self.srv]:
            if srv is not None:
                srv.shutdown(drain_timeout_s=5.0)


def _remote(srv, member_id=W1):
    return next((r for r in srv.scheduler.engines()
                 if getattr(r, "is_remote", False)
                 and r.engine_id.startswith(member_id + ":")), None)


def _member_up(srv, member_id=W1) -> bool:
    r = _remote(srv, member_id)
    return (srv.fleet_registry.member_state(member_id) == "alive"
            and r is not None and r.is_healthy())


def _wait_until(pred, timeout_s: float, interval_s: float = 0.03) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval_s)
    return False


def _request(rid, sink, prompt=_PROMPT, max_tokens=16):
    return ServerRequest(rid, list(prompt.encode()),
                         SamplingParams(max_tokens=max_tokens,
                                        temperature=0.0), sink)


def submit(srv, rid, prompt=_PROMPT, max_tokens=16, sinks=None):
    """One request through the dispatcher; None when admission refused it
    (backpressure, not a violation)."""
    sink = ChaosSink(rid)
    try:
        srv.dispatcher.submit(_request(rid, sink, prompt, max_tokens))
    except QueueFull:
        return None
    if sinks is not None:
        sinks.append(sink)
    return sink


def drive_remote(srv, rid, member_id=W1, prompt=_PROMPT, max_tokens=8,
                 sinks=None):
    """One request straight at a member's proxy."""
    sink = ChaosSink(rid)
    _remote(srv, member_id).submit([_request(rid, sink, prompt, max_tokens)])
    if sinks is not None:
        sinks.append(sink)
    return sink


def wait_terminal(sinks, timeout_s: float = 60.0):
    deadline = time.monotonic() + timeout_s
    return [s.rid for s in sinks
            if not s.ev.wait(max(0.0, deadline - time.monotonic()))]


def _arm(spec: str, seed: int) -> None:
    faults.install(faults.parse_spec(spec, seed))


def check_invariants(fleet: ChaosFleet, sinks, require_success=False,
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
    srv = fleet.srv
    others = [s for s in fleet.all_servers() if s is not srv]

    def drained() -> bool:
        runners = srv.scheduler.engines()
        for m in others:
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
    # zero pages leaked on every process of the data plane
    for server in fleet.all_servers():
        for r in server.local_runners():
            violations.extend(r.audit())
    return violations


# ---------------------------------------------------------------------------
# the data plane's scenarios
# ---------------------------------------------------------------------------


def scenario_cross_host_handoff_death(fleet, seed: int):
    """The host's prefill engine migrates every sequence to the member's
    decode replica over the data channel, and the stream dies before the
    switchover: the dial fails (``fleet.kv_connect``), the wire tears at
    the Nth chunk (``fleet.kv_chunk``) or the member crashes on the import
    command (``runner.inbox``). The request decodes in place, once."""
    rng = random.Random(seed)
    fleet.ensure_member()
    sinks = []
    spec = rng.choice([
        "fleet.kv_connect:nth=1",
        f"fleet.kv_chunk:nth={rng.randint(1, 3)}",
        # hit 1 is the host prefill's submit; 2 and up the member's import
        f"runner.inbox:nth={rng.randint(2, 3)}",
    ])
    _arm(spec, seed)
    submit(fleet.srv, f"xh-{seed}", max_tokens=rng.randint(32, 48),
           sinks=sinks)
    wedged = wait_terminal(sinks, timeout_s=90.0)
    return sinks, True, [f"{r}: no terminal event (wedged)" for r in wedged]


def _warm(srv, member_id, prompt, rid_prefix, page_size=8):
    """Warm ``prompt`` on a member through the control wire, then wait for
    its whole chain in the member's heartbeated digest (a reused fleet's
    digest is already non-empty)."""
    remote = _remote(srv, member_id)
    warm = [drive_remote(srv, f"{rid_prefix}-{i}", member_id, prompt)
            for i in range(2)]
    wait_terminal(warm)
    hashes = chain_hashes(list(prompt.encode()), page_size)
    _wait_until(lambda: (prefix_match_depth(remote.status(), hashes)
                         == len(hashes)
                         and remote.status().data_plane), 10.0, 0.05)
    return remote


def scenario_remote_fetch_source_death(fleet, seed: int):
    """The cost model picks the remote warm member as the fetch source
    (forced by ``sched.fetch_decision``) and the data channel dies under
    the fetch (the dial, or a chunk torn off the response): the request
    recomputes on its local target, once."""
    rng = random.Random(seed)
    fleet.ensure_member()
    prompt = _PROMPT + " remote" * rng.randint(2, 3)
    _warm(fleet.srv, W1, prompt, f"rfw-{seed}")
    sinks = []
    spec = rng.choice([
        "sched.fetch_decision:nth=1;fleet.kv_connect:nth=1",
        f"sched.fetch_decision:nth=1;fleet.kv_chunk:nth={rng.randint(1, 2)}",
    ])
    _arm(spec, seed)
    submit(fleet.srv, f"rf-{seed}", prompt=prompt, max_tokens=16,
           sinks=sinks)
    wedged = wait_terminal(sinks, timeout_s=90.0)
    return sinks, True, [f"{r}: no terminal event (wedged)" for r in wedged]


def scenario_breaker_flap(fleet, seed: int):
    """A flapping data wire (``fleet.wire_timeout``) under cross-process
    handoffs: the channel's breaker opens after ``health.wire_failures``
    failures (handoffs decode in place, once; election skips the member),
    probes no earlier than ``breaker_open_s``, and closes once the wire
    heals."""
    rng = random.Random(seed)
    fleet.ensure_member()
    srv = fleet.srv
    sinks, extra = [], []

    def channel():
        session = srv.fleet_server._by_member.get(W1)
        return session.kv_channel if session is not None else None

    def breaker():
        return srv.fleet_server.kv_stats().get(W1, {}).get("breaker", {})

    _arm(f"fleet.wire_timeout:prob=1.0,times={rng.randint(4, 6)}", seed)
    for i in range(4):
        submit(srv, f"bf-{seed}-{i}", max_tokens=rng.randint(24, 40),
               sinks=sinks)
        wait_terminal(sinks[-1:], timeout_s=90.0)
        if breaker().get("state") == "open":
            break
    if breaker().get("state") != "open":
        extra.append(f"breaker never opened: {breaker()}")
    faults.clear()  # the wire heals
    open_s = srv.health_settings.breaker_open_s
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline and breaker().get("state") != "closed":
        time.sleep(max(0.05, open_s / 4))
        submit(srv, f"bf-{seed}-p{int(time.monotonic() * 1000)}",
               max_tokens=16, sinks=sinks)
        wait_terminal(sinks[-1:], timeout_s=90.0)
    if breaker().get("state") != "closed":
        extra.append(f"breaker never re-closed after heal: {breaker()}")
    # the hysteresis: no half-open probe before the cooldown since the
    # breaker opened
    ch = channel()
    history = ch.breaker.history() if ch is not None else []
    last_open, probes = None, 0
    for t, state in history:
        if state == "open":
            last_open = t
        elif state == "half_open":
            probes += 1
            if last_open is not None and t - last_open < open_s * 0.85:
                extra.append(f"breaker half-opened {t - last_open:.3f}s "
                             f"after opening (cooldown {open_s}s)")
    if probes < 1:
        extra.append(f"breaker never probed half-open: {history}")
    extra += [f"{r}: no terminal event (wedged)"
              for r in wait_terminal(sinks, timeout_s=90.0)]
    return sinks, True, extra


def scenario_mesh_peer_wire_death(fleet, seed: int):
    """The mesh: the cost model picks the remote member ``chaos-w2`` as the
    fetch target against the warm remote member ``chaos-w1`` (admissible
    only through the registry's introduction), so the host sends a fetch
    hint and w2 pulls the chunks from w1 over its own wire. That wire dies
    (the peer dial, a torn chunk, or w2's import rejecting a chunk): the
    request recomputes on w2, once, and the hint did leave the host."""
    rng = random.Random(seed)
    fleet.ensure_member(W1)
    fleet.ensure_member(W2)
    srv = fleet.srv
    # seed-unique from the first page (chain hashes are cumulative)
    prompt = f"mesh{seed} " * rng.randint(2, 3) + _PROMPT
    _warm(srv, W1, prompt, f"mw-{seed}")
    _wait_until(lambda: srv.fleet_server.mesh_route(W2, W1), 10.0, 0.05)

    def delegated():
        cache = srv.metrics.snapshot().to_dict().get("cache") or {}
        return (cache.get("peer_fetch") or {}).get("delegated", 0)

    before = delegated()
    sinks = []
    spec = rng.choice([
        "sched.fetch_decision:nth=1;fleet.kv_peer_dial:nth=1",
        f"sched.fetch_decision:nth=1;fleet.kv_chunk:nth={rng.randint(1, 2)}",
        "sched.fetch_decision:nth=1;kv.import_chunk:nth=1",
    ])
    # the local engine leaves routing for the one faulted decision, so the
    # mesh pair is the only fetch the flag can force (a previous seed's
    # learned rate on the mesh wire would otherwise route it host-side)
    local = srv.local_runners()[0]
    srv.scheduler.unregister(local.engine_id)
    try:
        _arm(spec, seed)
        submit(srv, f"mesh-{seed}", prompt=prompt, max_tokens=16,
               sinks=sinks)
        wedged = wait_terminal(sinks, timeout_s=90.0)
    finally:
        srv.scheduler.register(local)
    extra = [f"{r}: no terminal event (wedged)" for r in wedged]
    if delegated() <= before:
        extra.append("the fetch was never delegated to the mesh")
    return sinks, True, extra


# ---------------------------------------------------------------------------
# registry HA's scenarios
# ---------------------------------------------------------------------------


def _registry_serving(reg) -> bool:
    return (reg.fleet_registry.member_state(W1) == "alive"
            and any(getattr(r, "is_remote", False) and r.is_healthy()
                    for r in reg.scheduler.engines()))


def _roles(fleet):
    a, b = fleet.srv, fleet.standby
    return (a, b) if a.fleet_ha.is_primary() else (b, a)


def scenario_registry_failover(fleet, seed: int):
    """The primary registry dies (its lease loop and listener stopped):
    the warm standby promotes within the lease at a higher epoch and
    serves through its own front door; the old primary restarted on its
    port comes back a standby at the new epoch. Odd seeds crash the first
    promotion (``fleet.takeover``): it must be atomic or absent."""
    rng = random.Random(seed)
    fleet.ensure_member()
    pri, stb = _roles(fleet)
    lease_s = fleet.srv.fleet_settings.lease_s
    pri_epoch = pri.fleet_ha.epoch
    sinks, extra = [], []
    for i in range(rng.randint(1, 2)):
        submit(pri, f"fo-{seed}-a{i}", sinks=sinks)
    extra += [f"{r}: no terminal event (wedged)"
              for r in wait_terminal(sinks)]
    if seed % 2:
        _arm("fleet.takeover:nth=1", seed)
    pri.fleet_ha.stop()
    pri.fleet_server.stop()
    if not _wait_until(stb.fleet_ha.is_primary, lease_s * 4 + 5.0):
        extra.append(f"standby never promoted: {stb.fleet_ha.stats()}")
    faults.clear()
    takeovers = stb.fleet_ha.stats()["takeovers"]
    if stb.fleet_ha.is_primary() and not takeovers.get("lease_expired"):
        extra.append(f"promotion not counted as lease_expired: {takeovers}")
    if stb.fleet_ha.is_primary() and stb.fleet_ha.epoch <= pri_epoch:
        extra.append(f"promotion did not bump the epoch: "
                     f"{stb.fleet_ha.epoch} <= {pri_epoch}")
    if not _wait_until(lambda: _registry_serving(stb), 10.0):
        extra.append("the standby's member table never went live")
    elif submit(stb, f"fo-{seed}-post", sinks=sinks) is None:
        extra.append("post-takeover submit rejected at the new primary")
    extra += [f"{r}: no terminal event (wedged)"
              for r in wait_terminal(sinks, timeout_s=90.0)]
    # the old primary restarts on its port: a standby at the new epoch
    pri.fleet_server.start()
    pri.fleet_ha.start(f"127.0.0.1:{pri.fleet_server.bound_port}")
    if not _wait_until(lambda: (not pri.fleet_ha.is_primary()
                                and pri.fleet_ha.epoch
                                == stb.fleet_ha.epoch), lease_s * 4 + 5.0):
        extra.append(f"old primary did not rejoin as a standby: "
                     f"{pri.fleet_ha.stats()} vs {stb.fleet_ha.stats()}")
    if stb.fleet_ha.is_primary() == pri.fleet_ha.is_primary():
        extra.append("not exactly one primary after the rejoin")
    if not _wait_until(lambda: _registry_serving(pri), 15.0):
        extra.append("the restarted registry's member table never "
                     "re-warmed")
    return sinks, False, extra


def scenario_registry_split_brain(fleet, seed: int):
    """A registry-to-registry partition (``fleet.lease_beat`` drops every
    lease beat) with both registries alive: the standby promotes at a
    higher epoch and two primaries exist. The member, having seen the new
    epoch, fences the old primary's submit (``worker_failure``); once the
    partition heals the old primary steps down: one primary, the epochs
    converged."""
    random.Random(seed)  # the seed selects the fault set's RNG
    worker = fleet.ensure_member()
    pri, stb = _roles(fleet)
    lease_s = fleet.srv.fleet_settings.lease_s
    fenced_before = pri.fleet_ha.stats()["takeovers"].get("fenced", 0)
    sinks, extra = [], []
    _arm("fleet.lease_beat:prob=1.0,times=100000", seed)
    if not _wait_until(stb.fleet_ha.is_primary, lease_s * 4 + 5.0):
        extra.append(f"standby never promoted under the partition: "
                     f"{stb.fleet_ha.stats()}")
    split = pri.fleet_ha.is_primary() and stb.fleet_ha.is_primary()
    if not split:
        extra.append(f"no split brain: {pri.fleet_ha.stats()} / "
                     f"{stb.fleet_ha.stats()}")
    if _wait_until(lambda: _registry_serving(stb), 10.0):
        # one request through the new primary teaches the member its epoch
        drive_remote(stb, f"sb-{seed}-new", sinks=sinks)
        wait_terminal(sinks[-1:], timeout_s=60.0)
        if worker._fleet_epoch != stb.fleet_ha.epoch:
            extra.append(f"member never learned the new epoch: "
                         f"{worker._fleet_epoch} != {stb.fleet_ha.epoch}")
    else:
        extra.append("the new primary's member view never went live")
    if split and _registry_serving(pri):
        # the old primary's submit is fenced on the member; it redispatches
        # on its own side (or, its budget spent, fails as worker_failure)
        fenced = drive_remote(pri, f"sb-{seed}-old", sinks=sinks)
        fenced.ev.wait(60.0)
        for _msg, code in fenced.errors:
            if code != "worker_failure":
                extra.append(f"fenced submit failed with {code!r}")
    faults.clear()  # the partition heals
    if not _wait_until(lambda: (not pri.fleet_ha.is_primary()
                                and stb.fleet_ha.is_primary()),
                       lease_s * 4 + 5.0):
        extra.append(f"old primary never fenced after the heal: "
                     f"{pri.fleet_ha.stats()} / {stb.fleet_ha.stats()}")
    else:
        if (pri.fleet_ha.stats()["takeovers"].get("fenced", 0)
                <= fenced_before):
            extra.append(f"demotion not counted as fenced: "
                         f"{pri.fleet_ha.stats()}")
        if pri.fleet_ha.epoch != stb.fleet_ha.epoch:
            extra.append(f"epochs never converged: {pri.fleet_ha.epoch} != "
                         f"{stb.fleet_ha.epoch}")
    extra += [f"{r}: no terminal event (wedged)"
              for r in wait_terminal(sinks, timeout_s=90.0)]
    return sinks, False, extra


SCENARIOS = {
    # host: one prefill engine, member: one decode engine; every admission
    # wants a cross-process migration
    "cross_host_handoff_death": (scenario_cross_host_handoff_death,
                                 {"roles": ("prefill",),
                                  "member_roles": ("decode",)}),
    # digests need the Python allocator
    "remote_fetch_source_death": (scenario_remote_fetch_source_death,
                                  {"strategy": "cache_aware",
                                   "native_allocator": False}),
    "breaker_flap": (scenario_breaker_flap,
                     {"roles": ("prefill",), "member_roles": ("decode",),
                      "health": _chaos_health()}),
    "mesh_peer_wire_death": (scenario_mesh_peer_wire_death,
                             {"mesh": True, "strategy": "cache_aware",
                              "native_allocator": False}),
    "registry_failover": (scenario_registry_failover, {"ha": True}),
    "registry_split_brain": (scenario_registry_split_brain, {"ha": True}),
}


def run_scenario(name: str, seed: int, fleet=None):
    fn, kwargs = SCENARIOS[name]
    if fleet is None:
        fleet = ChaosFleet(**kwargs)
    try:
        sinks, require_success, extra = fn(fleet, seed)
    finally:
        faults.clear()
    return list(extra) + check_invariants(
        fleet, sinks, require_success=require_success), fleet


@pytest.fixture(scope="module")
def fleet_cache():
    """One fleet per scenario, reused across its seeds."""
    cache = {}
    yield cache
    faults.clear()
    for fleet in cache.values():
        fleet.close()


@pytest.mark.parametrize("scenario,seed", [
    # the dial fails (41), the member crashes on the import command (43),
    # the wire tears at the Nth chunk (45)
    ("cross_host_handoff_death", 41),
    ("cross_host_handoff_death", 43),
    ("cross_host_handoff_death", 45),
    # the dial fails (41), a response chunk tears (42, 45)
    ("remote_fetch_source_death", 41),
    ("remote_fetch_source_death", 42),
    ("remote_fetch_source_death", 45),
    ("breaker_flap", 51),
    ("breaker_flap", 52),
    ("breaker_flap", 53),
    # w2's import rejects a chunk (61), the peer dial fails (62), a chunk
    # tears off the response (63)
    ("mesh_peer_wire_death", 61),
    ("mesh_peer_wire_death", 62),
    ("mesh_peer_wire_death", 63),
    # odd seeds also crash the first promotion
    ("registry_failover", 71),
    ("registry_failover", 72),
    ("registry_failover", 73),
    ("registry_split_brain", 71),
    ("registry_split_brain", 72),
    ("registry_split_brain", 73),
])
def test_scenario_clean(scenario, seed, fleet_cache):
    violations, fleet = run_scenario(scenario, seed,
                                     fleet=fleet_cache.get(scenario))
    fleet_cache[scenario] = fleet
    assert violations == []
