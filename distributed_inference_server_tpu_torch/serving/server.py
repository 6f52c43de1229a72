"""Inference server: engine replicas behind the adaptive scheduler and a
standard-library HTTP server (the counterpart of
``distributed_inference_server_tpu/serving/server.py``).

It wires the ``MetricsCollector``; ``num_engines`` ``EngineRunner``
replicas, each built by ``engine_factory(replica_index)`` (or a
zero-argument factory) on its own thread, with its role (``prefill``,
``decode`` or ``unified``); the ``AdaptiveScheduler`` over them (its
strategy, health loop and automatic restarts); the ``DisaggController``
when any role is prefill or decode, and the ``PrefixFetcher`` for the
cache_aware route's peer fetches (``serving/disagg.py``); the
``Dispatcher`` in front (queue, batching window, timeout sweep, crash-safe
redispatch); and the ``InferenceHandler``. ``serve`` runs a
``ThreadingHTTPServer`` (one thread per connection) on the app in
``serving/app.py`` and, with ``grpc_port``, the gRPC transport
(``serving/grpc_server.py``) on the same handler. ``scale_to`` adds replicas or retires them (unified
ones first, youngest first), draining a retired replica before it stops.

As the reference's server it always builds the observability and control
plane: a ``Tracer`` (with the OTLP exporter when ``otlp_endpoint`` is set)
and a ``FlightRecorder`` (SLO verdicts with ``slo_settings``), the shared
``RetryBudget`` (redispatch and the handoff retry draw from it), the
``HealthScorer`` (on by default; its verdicts ride ``statuses()``),
``AdmissionControl`` (deadline-aware shedding) and the
``DegradationController`` (the memory-pressure and SLO-burn ladder).
``swap_model`` hot-swaps every replica's model; ``apply_hot_config`` takes
the ``ConfigWatcher``'s hot-reloadable changes.

With ``fleet_settings.enabled`` the server is a fleet's registry host
(``serving/fleet.py``): a ``FleetRegistry`` and a ``FleetServer`` whose
``RemoteRunner`` proxies put the members' engines in the scheduler; with
``fleet_settings.rerole`` a ``RoleBalancer`` flips local engines between
unified and prefill. The registry host prices the fleet's KV wires from
their learned rates (``serving/fleet_mesh.py``): the scheduler's
``wire_cost`` and ``mesh_route`` and the fetcher's ``mesh_route``. With
``fleet_settings.registries`` it runs ``RegistryHA``
(``serving/fleet_ha.py``): the lease election, the epoch on every control
frame, the balancer active only on the primary, and with
``standby_http`` false a standby's dispatcher turning ingress away. The
proxies are not the server's to scale, swap or report per replica:
``scale_to``, ``swap_model`` and the ``replicas`` block cover the local
replicas only.

``server.runner`` is the first replica (``engine-0``): it is never
retired, and a restart keeps its runner object.
"""

from __future__ import annotations

import inspect
import logging
import threading
import time
from dataclasses import replace
from http.server import ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from distributed_inference_server_tpu_torch.core.queue import QueueConfig
from distributed_inference_server_tpu_torch.core.validator import (
    ValidatorConfig,
)
from distributed_inference_server_tpu_torch.engine.engine import LLMEngine
from distributed_inference_server_tpu_torch.models.tokenizer import Tokenizer
from distributed_inference_server_tpu_torch.ops import kernels
from distributed_inference_server_tpu_torch.serving import faults
from distributed_inference_server_tpu_torch.serving.app import make_handler
from distributed_inference_server_tpu_torch.serving.batcher import (
    BatcherConfig,
)
from distributed_inference_server_tpu_torch.serving.disagg import (
    DisaggController,
    DisaggSettings,
    PrefixFetcher,
    make_channel,
    parse_roles,
)
from distributed_inference_server_tpu_torch.serving.degradation import (
    DegradationController,
)
from distributed_inference_server_tpu_torch.serving.dispatcher import (
    Dispatcher,
)
from distributed_inference_server_tpu_torch.serving.fleet import (
    FleetRegistry,
    FleetServer,
    FleetSettings,
    RoleBalancer,
)
from distributed_inference_server_tpu_torch.serving.flightrec import (
    FlightRecorder,
)
from distributed_inference_server_tpu_torch.serving.handler import (
    InferenceHandler,
)
from distributed_inference_server_tpu_torch.serving.health import (
    AdmissionControl,
    AdmissionSettings,
    HealthScorer,
    HealthSettings,
    RetryBudget,
)
from distributed_inference_server_tpu_torch.serving.metrics import (
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    EngineRunner,
)
from distributed_inference_server_tpu_torch.serving.scheduler import (
    AdaptiveScheduler,
    FetchCosts,
    SchedulingStrategy,
)
from distributed_inference_server_tpu_torch.serving.teledigest import (
    SloSettings,
    build_perf_payload,
)
from distributed_inference_server_tpu_torch.utils.tracing import Tracer

logger = logging.getLogger(__name__)


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: the standard library's 5 drops the connection
    # attempts of a burst beyond it, which the client's TCP retries a
    # second later; 128 is aiohttp's default, the reference's transport
    request_queue_size = 128


def _bind_factory(factory: Callable, idx: int) -> Callable[[], LLMEngine]:
    """Bind a replica index: a factory that takes one (``def f(i)``) gets
    it, a zero-argument factory passes through."""
    try:
        takes_index = bool(inspect.signature(factory).parameters)
    except (TypeError, ValueError):
        takes_index = False
    return (lambda: factory(idx)) if takes_index else factory


class InferenceServer:
    """Serving spine for one model's engine replicas."""

    def __init__(
        self,
        engine_factory: Callable[..., LLMEngine],
        tokenizer: Tokenizer,
        model_name: str,
        queue_config: Optional[QueueConfig] = None,
        batcher_config: Optional[BatcherConfig] = None,
        num_engines: int = 1,
        strategy: SchedulingStrategy = SchedulingStrategy.LEAST_LOADED,
        engine_roles: Optional[Sequence[str]] = None,
        disagg_settings: Optional[DisaggSettings] = None,
        fetch_costs: Optional[FetchCosts] = None,
        auto_restart: bool = True,
        health_check_interval_s: float = 1.0,
        restart_backoff_s: float = 1.0,
        restart_backoff_max_s: float = 30.0,
        max_redispatch: int = 2,
        validator_config: Optional[ValidatorConfig] = None,
        model_resolver: Optional[Callable[[str], Callable]] = None,
        otlp_endpoint: str = "",
        otlp_service_name: str = "distributed-inference-server-tpu",
        slo_settings: Optional[SloSettings] = None,
        health_settings: Optional[HealthSettings] = None,
        admission_settings: Optional[AdmissionSettings] = None,
        fleet_settings: Optional[FleetSettings] = None,
    ):
        """``queue_config`` / ``batcher_config``: the admission queue's
        watermarks, timeout, cap and tenant lanes, and the batching window
        (the reference defaults when None). ``engine_roles``: one role per
        replica, or a comma-separated string (None / all unified: every
        replica prefills and decodes in place); ``disagg_settings``: the
        handoff's timeout, retries, channel, streaming, chunk size and
        wire encoding, also the peer fetch's channel and encoding.
        ``fetch_costs``: the cache_aware cost model's weights.
        ``auto_restart``: the health loop (every
        ``health_check_interval_s``) restarts a dead replica, backing off
        ``restart_backoff_s`` doubling up to ``restart_backoff_max_s``
        after a failed restart. ``max_redispatch``: moves off a dead
        replica per zero-token request (0 = off). ``validator_config``:
        the request validator's limits. ``model_resolver(name) ->
        engine_factory`` enables ``POST /admin/model-swap`` (None: 501).
        ``otlp_endpoint``: a collector's ``/v1/traces`` URL (empty: spans
        stay in the in-memory ring). ``slo_settings``: SLO verdicts and
        the digests' window geometry. ``health_settings`` /
        ``admission_settings``: the health scorer, retry budget, SLO-burn
        ladder input and deadline-aware shedding (None: the defaults).
        ``fleet_settings``: ``enabled`` makes this a registry host,
        ``rerole`` arms the role balancer (None: neither)."""
        from distributed_inference_server_tpu_torch import native
        from distributed_inference_server_tpu_torch.utils.otlp import (
            OTLPExporter,
        )

        self.tok = tokenizer
        self.model_name = model_name
        self.engine_factory = engine_factory
        self.model_resolver = model_resolver
        self.metrics = MetricsCollector()
        self.slo_settings = slo_settings
        if slo_settings is not None:
            # boot time: the rings are still empty
            self.metrics.configure_perf(slo_settings.epoch_s,
                                        slo_settings.window_s)
        self.tracer = Tracer()
        self.tracer.on_drop = self.metrics.record_trace_drops
        self.recorder = FlightRecorder(metrics=self.metrics,
                                       slo=slo_settings)
        # fault arm / disarm hops land in the recorder's global window
        self._fault_observer = self.recorder.note_global
        faults.add_observer(self._fault_observer)
        self.otlp: Optional[OTLPExporter] = None
        if otlp_endpoint:
            self.otlp = OTLPExporter(
                otlp_endpoint, service_name=otlp_service_name
            ).attach(self.tracer)
        self.scheduler = AdaptiveScheduler(
            strategy=strategy,
            health_check_interval_s=health_check_interval_s,
            auto_restart=auto_restart, metrics=self.metrics,
            restart_backoff_s=restart_backoff_s,
            restart_backoff_max_s=restart_backoff_max_s,
            fetch_costs=fetch_costs)
        self.health_settings = health_settings or HealthSettings()
        self.retry_budget = RetryBudget(
            ratio=self.health_settings.retry_budget_ratio,
            min_retries=self.health_settings.retry_budget_min,
            window_s=self.health_settings.retry_window_s,
            metrics=self.metrics)
        self.health_scorer: Optional[HealthScorer] = None
        if self.health_settings.enabled:
            self.health_scorer = HealthScorer(
                self.health_settings, self.scheduler, metrics=self.metrics,
                recorder=self.recorder)
            self.scheduler.health_scorer = self.health_scorer
        self.admission = AdmissionControl(
            admission_settings or AdmissionSettings(), slo=slo_settings,
            metrics=self.metrics,
            tenant_weights=(queue_config.tenant_weights
                            if queue_config is not None else None))
        if isinstance(engine_roles, str):
            engine_roles = parse_roles(engine_roles, num_engines)
        self._roles: List[str] = list(engine_roles or [])
        settings = disagg_settings or DisaggSettings()
        self.disagg: Optional[DisaggController] = None
        if any(r in ("prefill", "decode") for r in self._roles):
            self.disagg = DisaggController(
                self.scheduler, metrics=self.metrics,
                channel=make_channel(settings.channel), settings=settings,
                tracer=self.tracer, recorder=self.recorder)
            # the handoff retry draws from the shared budget
            self.disagg.retry_budget = self.retry_budget
            self.metrics.set_engines_by_role(
                DisaggController.role_counts(self._roles))
        # always built: whether it runs is the cost model's decision,
        # which says "fetch" only under cache_aware with peer fetch on
        self.prefix_fetcher = PrefixFetcher(
            channel=make_channel(settings.channel), settings=settings,
            metrics=self.metrics, tracer=self.tracer,
            recorder=self.recorder)
        self.dispatcher = Dispatcher(
            self.scheduler, queue_config, batcher_config, self.metrics,
            disagg=self.disagg, max_redispatch=max_redispatch,
            prefix_fetcher=self.prefix_fetcher, tracer=self.tracer,
            recorder=self.recorder, admission=self.admission,
            retry_budget=self.retry_budget)
        # the validator's tier, as the reference picks it: native when the
        # library builds
        self.handler = InferenceHandler(
            self.dispatcher, tokenizer, model_name, self.metrics,
            native.make_validator(validator_config), tracer=self.tracer,
            recorder=self.recorder)
        self.degradation = DegradationController(
            self.dispatcher, self.scheduler, metrics=self.metrics,
            burn_high=self.health_settings.slo_burn_high,
            burn_min_requests=self.health_settings.slo_burn_min_requests)
        self.fleet_settings = fleet_settings or FleetSettings()
        self.fleet_registry: Optional[FleetRegistry] = None
        self.fleet_server: Optional[FleetServer] = None
        self.role_balancer: Optional[RoleBalancer] = None
        self.fleet_ha = None
        if self.fleet_settings.enabled:
            self.fleet_registry = FleetRegistry(self.fleet_settings,
                                                metrics=self.metrics)
            self.fleet_server = FleetServer(
                self.fleet_registry, self.scheduler, self.fleet_settings,
                metrics=self.metrics, redispatch=self.dispatcher.redispatch,
                tracer=self.tracer, recorder=self.recorder,
                health_settings=self.health_settings,
                retry_budget=self.retry_budget)
            if self.health_scorer is not None:
                # the scorer compares the members' latency with the
                # frames /server/perf merges
                self.health_scorer.telemetry_fn = (
                    self.fleet_server.telemetry_snapshot)
            self._wire_fleet_prices(self.fleet_server)
            if self.fleet_settings.registries:
                from distributed_inference_server_tpu_torch.serving.fleet_ha \
                    import RegistryHA

                self.fleet_ha = RegistryHA(
                    self.fleet_server, self.fleet_settings,
                    metrics=self.metrics, recorder=self.recorder)
                self.fleet_server.ha = self.fleet_ha
                if not self.fleet_settings.standby_http:
                    # one front door: a standby turns ingress away until
                    # it holds the lease
                    self.dispatcher.ingress_gate = self.fleet_ha.is_primary
        if self.fleet_settings.rerole:
            self.role_balancer = RoleBalancer(
                self.scheduler, self.dispatcher, self.fleet_settings,
                metrics=self.metrics, recorder=self.recorder)
            if self.fleet_ha is not None:
                # only the lease holder balances roles
                self.role_balancer.active_fn = self.fleet_ha.is_primary
        self._num_engines = num_engines
        self._next_engine_idx = 0
        self._scale_lock = threading.Lock()
        self.runner: Optional[EngineRunner] = None
        self._accepting = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._grpc = None  # the gRPC transport, with ``grpc_port``
        self.started_at = time.time()

    def _wire_fleet_prices(self, fs: FleetServer) -> None:
        """Price the fleet's KV wires from their learned rates: a status
        pair becomes the (src, dst) key of the wire a move crosses (a
        member id, or "registry" for this host and for the handoff's
        source), and ``mesh_route`` admits member-to-member fetches."""

        def member_of(status) -> str:
            if status is None or not getattr(status, "remote", False):
                return "registry"
            return status.engine_id.rsplit(":", 1)[0]

        def wire_cost(target, peer):
            dst, src = member_of(target), member_of(peer)
            if src == dst:
                return None  # no wire crossed
            base = self.scheduler._fetch_costs.remote_page_cost
            # rates are keyed by the channel that carries the chunks: the
            # host's channels are ("registry", member) either way
            if "registry" in (src, dst):
                member = dst if src == "registry" else src
                return fs.mesh_rates.page_cost("registry", member, base)
            return fs.mesh_rates.page_cost(dst, src, base)

        def mesh_route(target, peer) -> bool:
            return fs.mesh_route(member_of(target), member_of(peer))

        self.scheduler.wire_cost = wire_cost
        self.scheduler.mesh_route = mesh_route
        self.prefix_fetcher.mesh_route = fs.mesh_route

    # -- lifecycle ---------------------------------------------------------

    def start(self, wait_ready: bool = True) -> None:
        """Start the controller, the replicas one after another (each
        warms up before the next is built), the health loop and the
        dispatcher."""
        if self.disagg is not None:
            self.disagg.start()
        for _ in range(self._num_engines):
            self._spawn_engine(wait_ready=wait_ready)
        self.scheduler.start_health_loop()
        self.dispatcher.start()
        self.degradation.start()
        if self.health_scorer is not None:
            self.health_scorer.start()
        if self.fleet_server is not None:
            self.fleet_server.start()
        if self.fleet_ha is not None:
            # after the listener: the lease wire's identity is the bound
            # port (fleet.port 0 binds an ephemeral one)
            self.fleet_ha.start(
                f"{self.fleet_settings.host}:{self.fleet_server.bound_port}")
        if self.role_balancer is not None:
            self.role_balancer.start()
        self._accepting = True

    def serve(self, host: str = "0.0.0.0", port: int = 8000,
              block: bool = True, grpc_port: int = 0) -> int:
        """Serve HTTP on ``host:port`` (0 = an ephemeral port) and, with
        ``grpc_port`` > 0, the gRPC transport on ``host:grpc_port`` over
        the same handler (``serving/grpc_server.py``; needs ``grpcio``).
        Blocks unless ``block`` is False; returns the bound HTTP port."""
        if grpc_port:
            # the only import of grpc: a server without the port never
            # needs the package
            from distributed_inference_server_tpu_torch.serving.grpc_server \
                import serve_grpc

            self._grpc = serve_grpc(self.handler, host, grpc_port)
        self._httpd = _HTTPServer((host, port), make_handler(self))
        self._httpd.daemon_threads = True
        bound = self._httpd.server_address[1]
        if block:
            self._httpd.serve_forever()
        else:
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever, name="http", daemon=True)
            self._http_thread.start()
        return bound

    def shutdown(self, drain_timeout_s: float = 30.0) -> None:
        """Stop accepting, drain the admission queue, the migrations, the
        fetches and the in-flight requests (up to ``drain_timeout_s``),
        then stop gRPC (5 s of grace) and HTTP, the controller (leftover migrations resume in
        place), the health loop and the replicas."""
        self._accepting = False
        self.degradation.stop()
        if self.health_scorer is not None:
            self.health_scorer.stop()
        if self.role_balancer is not None:
            self.role_balancer.stop()
        self.dispatcher.shutdown(drain_timeout_s)
        if self._grpc is not None:
            from distributed_inference_server_tpu_torch.serving.grpc_server \
                import stop_grpc

            stop_grpc(self._grpc)  # RPCs in progress get its grace
            self._grpc = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(10)
        if self.fleet_ha is not None:
            # before the listener: the lease loop must not race its
            # teardown (peers see the lease age out)
            self.fleet_ha.stop()
        if self.fleet_server is not None:
            # after the drain (remote requests counted), before the local
            # engines stop: the member sessions detach cleanly
            self.fleet_server.stop()
        if self.disagg is not None:
            self.disagg.shutdown()
        self.scheduler.stop_health_loop()
        for runner in self.scheduler.engines():
            runner.shutdown()
        if self.otlp is not None:
            self.otlp.shutdown()
        faults.remove_observer(self._fault_observer)

    # -- elasticity --------------------------------------------------------

    def local_runners(self) -> List[EngineRunner]:
        """This process's replicas: the scheduler's engines without the
        fleet's remote proxies (their members own them)."""
        return [r for r in self.scheduler.engines()
                if not getattr(r, "is_remote", False)]

    def _spawn_engine(self, wait_ready: bool = True) -> EngineRunner:
        idx = self._next_engine_idx
        self._next_engine_idx += 1
        # replicas beyond the role list (scale_to) come up unified
        role = self._roles[idx] if idx < len(self._roles) else "unified"
        runner = EngineRunner(
            f"engine-{idx}", _bind_factory(self.engine_factory, idx),
            self.metrics, role=role, disagg=self.disagg, tracer=self.tracer,
            recorder=self.recorder)
        # crash-safe redispatch: a dead runner hands its zero-token
        # requests back to the dispatcher
        runner.redispatch = self.dispatcher.redispatch
        if self.runner is None:
            self.runner = runner
        runner.start(wait_ready=wait_ready)
        self.scheduler.register(runner)
        return runner

    def scale_to(self, n: int) -> None:
        """Add or retire replicas at runtime. A retired replica leaves the
        routing set at once and stops once its in-flight requests finish;
        unified replicas go first (youngest first), so scaling down never
        takes a disaggregated topology's only decode replica while a
        unified spare exists."""
        with self._scale_lock:
            current = self.local_runners()
            for _ in range(n - len(current)):
                self._spawn_engine()
            if n < len(current):
                unified = [r for r in current if r.role == "unified"]
                roled = [r for r in current if r.role != "unified"]
                for runner in (unified[::-1] + roled[::-1])[
                        :len(current) - n]:
                    self.scheduler.unregister(runner.engine_id)
                    self._drain_and_stop(runner)

    def _drain_and_stop(self, runner: EngineRunner) -> None:
        def _wait() -> None:
            deadline = time.monotonic() + 60.0
            while runner.active_count() and time.monotonic() < deadline:
                time.sleep(0.05)
            runner.shutdown()
            runner.release_engine()

        threading.Thread(target=_wait, name=f"retire-{runner.engine_id}",
                         daemon=True).start()

    # -- model hot swap ----------------------------------------------------

    def swap_model(self, engine_factory: Callable[..., LLMEngine],
                   model_name: Optional[str] = None,
                   timeout_s: float = 600.0) -> Tuple[bool, Optional[str]]:
        """Swap every replica to a new model: each builds its new engine
        in the background and switches at an inbox drain; in-flight
        requests finish on the old model. Returns ``(ok, error)``. A
        replica whose build fails keeps its old model and the call fails;
        replicas past ``timeout_s`` are cancelled (they never install
        late). On success the handler serves under ``model_name`` with the
        new model's tokenizer (its chat template follows)."""
        runners = self.local_runners()
        results: Dict[str, Tuple[bool, Optional[str]]] = {}
        events = []
        cancelled = threading.Event()
        for idx, runner in enumerate(runners):
            ev = threading.Event()
            events.append(ev)

            def _cb(ok, err, eid=runner.engine_id, ev=ev):
                results[eid] = (ok, err)
                ev.set()

            runner.swap_model(_bind_factory(engine_factory, idx), _cb,
                              cancelled=cancelled)
        deadline = time.monotonic() + timeout_s
        for ev in events:
            if not ev.wait(max(0.0, deadline - time.monotonic())):
                cancelled.set()
                installed = sorted(e for e, (ok, _) in results.items()
                                   if ok)
                return False, (
                    f"model swap timed out after {timeout_s}s; replicas "
                    f"already on the new model: {installed or 'none'} — "
                    "retry the swap to converge")
        failed = {e: err for e, (ok, err) in results.items() if not ok}
        if failed:
            return False, f"swap failed on {failed}"
        self.engine_factory = engine_factory
        if model_name is not None:
            self.model_name = model_name
            self.handler.model_name = model_name
        # the chat template follows the tokenizer and the model name:
        # templating for the new family with the old tokenizer would
        # garble every /chat prompt
        for runner in runners:
            tok = runner.tokenizer()
            if tok is not None:
                self.tok = self.handler.tok = tok
                break
        else:
            logger.error("model swap to %r succeeded but no replica "
                         "yielded a tokenizer; the handler keeps the old "
                         "one", model_name)
        return True, None

    def swap_by_name(self, name: str) -> Tuple[bool, Optional[str]]:
        """``POST /admin/model-swap``: resolve ``name`` to an engine
        factory and swap to it."""
        try:
            factory = self.model_resolver(name)
        except Exception as e:  # noqa: BLE001 — unknown model etc.
            return False, str(e)
        return self.swap_model(factory, model_name=name)

    # -- hot reload ----------------------------------------------------------

    def apply_hot_config(self, diff: dict, new_config) -> None:
        """Apply the hot-reloadable changes (the ``ConfigWatcher``'s
        subscriber): the batching window and size, the queue watermarks
        and timeout, the scheduling strategy. Only the diffed hot keys
        apply; a non-hot key changed in the same edit does not."""
        batcher = {k: v for (sec, k), v in diff.items() if sec == "batcher"}
        if batcher:
            self.dispatcher.batcher.config = replace(
                self.dispatcher.batcher.config, **batcher)
        queue = {k: v for (sec, k), v in diff.items() if sec == "queue"}
        if queue:
            self.dispatcher.queue.config = replace(
                self.dispatcher.queue.config, **queue)
        if ("server", "strategy") in diff:
            self.scheduler.set_strategy(new_config.strategy())

    # -- endpoints ---------------------------------------------------------

    def perf_stats(self) -> dict:
        """``GET /server/perf``: per-engine step clock, windowed latency
        percentiles, SLO burn and the raw digests."""
        slo_counts, goodput = self.metrics.slo_counts()
        return build_perf_payload(
            self.metrics.perf_store(), self.slo_settings,
            slo_counts=slo_counts, goodput=goodput,
            fleet_members=(self.fleet_server.telemetry_snapshot()
                           if self.fleet_server is not None else None))

    def fleet_stats(self) -> Optional[dict]:
        """The ``fleet`` block of ``/server/stats`` (None without a
        registry or a balancer): the members with their state and
        last-beat age, the count per state, the balancer's signal,
        flipped engines and history, the role of every routed engine, the
        heartbeat, rerole and intro counts, each member's data channel
        (``kv_channels``), every priced wire with its learned rate
        (``kv_wires``) and, with HA, this registry's role, epoch, lease and
        peers (``registry``)."""
        if self.fleet_registry is None and self.role_balancer is None:
            return None
        out: dict = {}
        if self.fleet_registry is not None:
            out.update(self.fleet_registry.stats())
        if self.fleet_server is not None:
            out["kv_channels"] = self.fleet_server.kv_stats()
            out["kv_wires"] = self.fleet_server.kv_wire_stats()
        if self.fleet_ha is not None:
            out["registry"] = self.fleet_ha.stats()
        if self.role_balancer is not None:
            out["rebalancer"] = self.role_balancer.stats()
        out["role_map"] = {r.engine_id: r.role
                           for r in self.scheduler.engines()}
        out.update(self.metrics.fleet_counters())
        return out

    def health_stats(self) -> dict:
        """The ``health`` block of ``/server/stats``: the scorer's states
        and evidence, the retry budget and the admission estimator."""
        out: dict = {}
        if self.health_scorer is not None:
            out.update(self.health_scorer.stats())
        out["retry_budget"] = self.retry_budget.stats()
        out["admission"] = self.admission.stats()
        return out

    def _engine_settings(self) -> Optional[dict]:
        """The first replica's engine settings (batch, pool, prefill)."""
        eng = self.runner._engine if self.runner is not None else None
        if eng is None:
            return None
        e, p = eng.ecfg, eng.pcfg
        return {"max_batch": e.max_batch, "num_pages": p.num_pages,
                "page_size": p.page_size,
                "max_pages_per_seq": p.max_pages_per_seq,
                "prefill_batch": e.prefill_batch,
                "prefill_token_budget": e.prefill_token_budget,
                "prefill_buckets": list(e.prefill_buckets),
                "decode_block_size": e.decode_block_size,
                "mixed_step_tokens": e.mixed_step_tokens}

    def admission_stats(self) -> dict:
        d = self.dispatcher.queue.queue_depth()
        return {
            "tier": self.dispatcher.tier,
            "accepting": self.dispatcher.is_accepting(),
            "queue": {"high": d.high, "normal": d.normal, "low": d.low,
                      "total": d.total},
            "window_ms": self.dispatcher.batcher.config.window_ms,
            "max_batch_size": self.dispatcher.batcher.config.max_batch_size,
            "max_queue_size": self.dispatcher.queue.config.max_queue_size,
            "high_watermark": self.dispatcher.queue.config.high_watermark,
            "degradation": self.degradation.level.name,
            "reject_low_priority": self.dispatcher.reject_low_priority,
            "reject_all": self.dispatcher.reject_all,
            "size_divisor": self.dispatcher.batcher.size_divisor,
        }

    def kernel_counts(self) -> Dict[str, int]:
        return kernels.launch_counts()

    def reset_kernel_counts(self) -> None:
        kernels.reset_launch_counts()

    def device_name(self) -> str:
        eng_dev = getattr(self.runner._engine, "device", None)
        if eng_dev is not None and eng_dev.type == "cuda":
            return torch.cuda.get_device_name(eng_dev)
        return str(eng_dev)

    def _observe_all(self) -> Tuple:
        return tuple(r.observe() for r in self.scheduler.engines())

    def health(self) -> Tuple[int, dict]:
        """``/health``: the reference's ``{status, accepting, engines}``
        over every replica (200 while any is healthy, else 503) and the
        port's ``model``, ``device`` and the first replica's last error
        while it is down."""
        statuses = self._observe_all()
        healthy = any(s.healthy for s in statuses)
        r = self.runner
        return (200 if healthy else 503), {
            "status": "ok" if healthy else "unhealthy",
            "accepting": self._accepting and self.dispatcher.is_accepting(),
            "engines": [s.to_dict() for s in statuses],
            "model": self.model_name,
            "device": self.device_name(),
            "error": None if r.is_healthy() else r.last_error(),
        }

    def metrics_text(self) -> bytes:
        """``/metrics``: the collector's Prometheus text, with every
        replica's cumulative counters read at this scrape."""
        self._observe_all()
        return self.metrics.prometheus_text()

    @staticmethod
    def _engine_blocks(r: EngineRunner) -> dict:
        """One replica's allocator, step clock and device memory, read on
        its thread (empty when it cannot answer)."""
        if not r.is_healthy():
            return {}
        try:
            cache, step_clock, memory = r.call(lambda e: (
                {**e.cache_stats().to_dict(),
                 "allocator_tier": e.allocator_tier()},
                e.step_clock_stats(), e.memory_stats()))
        except (TimeoutError, RuntimeError):
            return {}
        return {"cache": cache, "step_clock": step_clock, "memory": memory}

    def stats(self) -> dict:
        """``/server/stats``: the ``MetricsSnapshot`` over every replica
        (with its ``disagg`` and ``resilience`` blocks; its ``cache`` block
        with the first replica's allocator page counts and tier, native or
        python, added) and the port's blocks: the counters summed over the
        replicas (requests in flight and finished, tokens, engine steps and
        their seconds), and for the first replica ``mixed``
        (``mixed_stats()``, null while the mixed step is off), ``loop``
        (``loop_stats()``, null while looped blocks are off),
        ``step_clock`` (host wall time, dispatches, tokens and rows per
        dispatch kind, and the pressure events), ``memory`` (device
        memory, null on the CPU) and ``warmup_s``; ``engine`` (the first
        replica's batch, pool and prefill settings); ``admission`` (the
        queue tier, the queue's depth by priority, whether it accepts, the
        live batching window and size, the queue's cap and high
        watermark, the degradation level and its gates); the reference's
        ``health`` block (the scorer's states and evidence, the retry
        budget, the admission estimator) and ``tracing`` block (spans
        dropped, the flight recorder's phase sums and counts, and with an
        OTLP endpoint its exported and dropped spans); ``replicas``, one
        entry per replica
        (id, role, health, warmup seconds, restarts, steps, requests
        finished, kernel launches on its thread, its cache, step clock and
        memory, and its page audit: empty when clean); with a prefill /
        decode topology ``handoff_s`` (host seconds of the handoff's
        exports and imports on the replicas and in the channel, and their
        counts); each kernel's launch count in the process; and on a
        registry host or with the balancer armed, the ``fleet`` block
        (``fleet_stats``). The snapshot's ``worker_statuses`` include the
        fleet's remote proxies; ``replicas`` and the sums are the local
        replicas'."""
        statuses = self._observe_all()
        runners = self.local_runners()
        out = self.metrics.snapshot(statuses).to_dict()
        blocks = {r.engine_id: self._engine_blocks(r) for r in runners}
        first = blocks.get(self.runner.engine_id, {})
        first_status = next((s for s in statuses
                             if s.engine_id == self.runner.engine_id), None)
        out["cache"] = {**out["cache"], **(first.get("cache") or {})}
        out.update({
            "model": self.model_name,
            "device": self.device_name(),
            "healthy": any(s.healthy for s in statuses),
            "uptime_s": time.time() - self.started_at,
            "strategy": self.scheduler.strategy().value,
            "requests_in_flight": sum(r.active_count() for r in runners),
            "requests_finished": sum(r.requests_finished for r in runners),
            "tokens_generated": sum(r.tokens_generated for r in runners),
            "engine_steps": sum(r.steps for r in runners),
            "engine_step_seconds": sum(r.step_seconds for r in runners),
            "warmup_s": self.runner.warmup_seconds,
            "admission": self.admission_stats(),
            "mixed": first_status.mixed if first_status else None,
            "loop": first_status.loop if first_status else None,
            "step_clock": first.get("step_clock"),
            "memory": first.get("memory"),
            "replicas": [{
                "engine_id": r.engine_id,
                "role": r.role,
                "healthy": r.is_healthy(),
                "warmup_s": r.warmup_seconds,
                "restarts": r.restarts,
                "engine_steps": r.steps,
                "requests_finished": r.requests_finished,
                "kernel_launches": r.launch_counts(),
                "audit": r.audit(),
                **blocks[r.engine_id],
            } for r in runners],
            "kernel_launches": self.kernel_counts(),
            "engine": self._engine_settings(),
            "health": self.health_stats(),
        })
        fleet = self.fleet_stats()
        if fleet is not None:
            out["fleet"] = fleet
        tracing = out.setdefault("tracing", {})
        tracing["tracer_dropped"] = self.tracer.dropped()
        tracing["flight_recorder"] = self.recorder.stats()
        if self.otlp is not None:
            tracing["otlp"] = {"exported": self.otlp.exported,
                               "dropped": self.otlp.dropped}
        if self.disagg is not None:
            out["handoff_s"] = {
                "export": sum(r.handoff_s["export"] for r in runners),
                "import": sum(r.handoff_s["import"] for r in runners),
                "channel": self.disagg.channel_s,
                "exports": sum(r.handoff_s["exports"] for r in runners),
                "imports": sum(r.handoff_s["imports"] for r in runners),
            }
        return out
