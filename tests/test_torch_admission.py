"""The port's admission layer against the JAX package's, and served.

- ``core/queue.py``: the same random operation sequences (enqueue at
  three priorities and several tenants, dequeues, expiry sweeps,
  cancels) go through the JAX ``PriorityQueueManager`` and the port's
  Python and native C++ tiers; every result and every depth must agree.
  The cases of ``tests/test_core_queue.py`` run on the port's tiers.
- ``serving/batcher.py``: the cases of ``TestAdmissionBatcher``
  (``tests/test_serving_units.py``) on the port's Python and native
  batchers, and a random poll / cancel / flush sequence against the JAX
  batcher.
- ``serving/dispatcher.py``: the cases of ``TestDispatcher`` on both
  tiers.
- The validator's native tier against the Python one.
- Served, on one TINY CPU server (Python tier: the test pauses the
  dispatch thread by holding the batcher's lock, which only that tier
  has): a queued ``high`` request reaches the engine before ``normal``
  ones; the watermarks answer 503 ``queue_full`` and release only below
  the low mark (hysteresis); a request that waits past the timeout gets
  408 ``queue_timeout``; ``tenant`` picks DRR lanes.
"""

import dataclasses
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.core import queue as jq
from distributed_inference_server_tpu.core.errors import (
    QueueFull as JQueueFull,
)
from distributed_inference_server_tpu.core.types import Priority as JPriority
from distributed_inference_server_tpu.serving import batcher as jb
from distributed_inference_server_tpu_torch import native
from distributed_inference_server_tpu_torch.core import queue as pq
from distributed_inference_server_tpu_torch.core.errors import QueueFull
from distributed_inference_server_tpu_torch.core.models import (
    ChatMessage,
    ChatRequest,
    EmbeddingsRequest,
    GenerateRequest,
    Role,
)
from distributed_inference_server_tpu_torch.core.types import Priority
from distributed_inference_server_tpu_torch.core.validator import (
    RequestValidator,
)
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
from distributed_inference_server_tpu_torch.serving import batcher as pb
from distributed_inference_server_tpu_torch.serving.dispatcher import (
    Dispatcher,
)
from distributed_inference_server_tpu_torch.serving.metrics import (
    EngineStatus,
    MetricsCollector,
)
from distributed_inference_server_tpu_torch.serving.runner import (
    ServerRequest,
)
from distributed_inference_server_tpu_torch.serving.scheduler import (
    AdaptiveScheduler,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)

assert native.available(), "g++ builds the native admission tier"

TIERS = ("python", "native")


def port_queue(tier: str, cfg: pq.QueueConfig):
    if tier == "native":
        return native.NativePriorityQueue(cfg)
    return pq.PriorityQueueManager(cfg)


def port_batcher(q, cfg: pb.BatcherConfig):
    if isinstance(q, native.NativePriorityQueue):
        return native.NativeAdmissionBatcher(q, cfg)
    return pb.AdmissionBatcher(q, cfg)


def both_configs(**kw):
    return jq.QueueConfig(**kw), pq.QueueConfig(**kw)


def _req(i, priority, tenant="default", enqueued_at=None, port=True):
    cls = pq.QueuedRequest if port else jq.QueuedRequest
    prio = Priority(priority) if port else JPriority(priority)
    kw = {} if enqueued_at is None else {"enqueued_at": enqueued_at}
    return cls(id=f"r{i}", data=i, priority=prio, tenant=tenant, **kw)


def _ids(reqs):
    return [r.id for r in reqs]


# ---------------------------------------------------------------------------
# the queue: differential against the JAX queue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("tier,fair", [("python", False), ("python", True),
                                       ("native", False)])
def test_queue_ops_match_jax(tier, fair, seed):
    rng = np.random.default_rng(seed)
    kw = dict(high_watermark=12, low_watermark=6, request_timeout_s=5.0,
              max_queue_size=20, tenant_fairness=fair,
              tenant_weights={"a": 2.0, "c": 0.5} if fair else {})
    jcfg, pcfg = both_configs(**kw)
    ref, got = jq.PriorityQueueManager(jcfg), port_queue(tier, pcfg)
    now, n = 1000.0, 0
    for _ in range(400):
        op = rng.choice(["enq", "enq", "enq", "deq", "one", "exp", "cancel"])
        if op == "enq":
            prio = int(rng.integers(0, 3))
            tenant = str(rng.choice(["a", "b", "c"]))
            outs = []
            for q, port in ((ref, False), (got, True)):
                try:
                    q.enqueue(_req(n, prio, tenant, now, port))
                    outs.append("ok")
                except (JQueueFull, QueueFull):
                    outs.append("full")
            assert outs[0] == outs[1]
            n += 1
            now += float(rng.uniform(0.0, 1.0))
        elif op == "deq":
            k = int(rng.integers(0, 6))
            assert _ids(got.dequeue_batch(k)) == _ids(ref.dequeue_batch(k))
        elif op == "one":
            a, b = ref.dequeue_one(), got.dequeue_one()
            assert (a is None) == (b is None)
            assert a is None or a.id == b.id
        elif op == "exp":
            t = now + float(rng.uniform(0.0, 6.0))
            assert _ids(got.remove_expired(t)) == _ids(ref.remove_expired(t))
        else:
            rid = f"r{int(rng.integers(0, max(n, 1)))}"
            a, b = ref.cancel(rid), got.cancel(rid)
            assert (a is None) == (b is None)
        jd, pdp = ref.queue_depth(), got.queue_depth()
        assert (pdp.high, pdp.normal, pdp.low, pdp.total) == (
            jd.high, jd.normal, jd.low, jd.total)
        assert got.is_accepting() == ref.is_accepting()
        if tier == "python":
            assert got.tenant_depths() == ref.tenant_depths()


# ---------------------------------------------------------------------------
# the queue: the cases of tests/test_core_queue.py on the port's tiers
# ---------------------------------------------------------------------------


def _make(i, priority):
    return pq.QueuedRequest(id=f"req-{i}", data=i, priority=priority)


@pytest.mark.parametrize("tier", TIERS)
def test_dequeue_order_strict_priority_fifo_within(tier):
    rng = np.random.default_rng(5)
    prios = [Priority(int(p)) for p in rng.integers(0, 3, size=50)]
    q = port_queue(tier, pq.QueueConfig(high_watermark=10_000,
                                        max_queue_size=20_000))
    for i, p in enumerate(prios):
        q.enqueue(_make(i, p))
    out = q.dequeue_batch(60)
    levels = [r.priority for r in out]
    assert levels == sorted(levels, key=lambda p: -int(p))
    for level in Priority:
        ids = [r.data for r in out if r.priority == level]
        assert ids == sorted(ids)
    assert q.dequeue_one() is None


@pytest.mark.parametrize("tier", TIERS)
def test_backpressure_hysteresis_cycle(tier):
    q = port_queue(tier, pq.QueueConfig(high_watermark=10, low_watermark=5,
                                        max_queue_size=100))
    for i in range(10):
        q.enqueue(_make(i, Priority.NORMAL))
    assert q.is_accepting()  # activation is strict >
    q.enqueue(_make(10, Priority.NORMAL))
    assert not q.is_accepting()
    with pytest.raises(QueueFull):
        q.enqueue(_make(11, Priority.NORMAL))
    q.dequeue_batch(6)  # 11 -> 5: still rejecting (release is strict <)
    assert not q.is_accepting()
    with pytest.raises(QueueFull):
        q.enqueue(_make(12, Priority.NORMAL))
    q.dequeue_batch(1)  # 5 -> 4
    assert q.is_accepting()
    q.enqueue(_make(13, Priority.NORMAL))


@pytest.mark.parametrize("tier", TIERS)
def test_absolute_cap_expiry_and_cancel(tier):
    q = port_queue(tier, pq.QueueConfig(high_watermark=1000,
                                        low_watermark=500, max_queue_size=5,
                                        request_timeout_s=10.0))
    now = time.monotonic()
    q.enqueue(pq.QueuedRequest(id="old", data=0, enqueued_at=now - 60.0))
    for i in range(1, 5):
        q.enqueue(_make(i, Priority.NORMAL))
    with pytest.raises(QueueFull):
        q.enqueue(_make(5, Priority.NORMAL))
    assert _ids(q.remove_expired(now)) == ["old"]
    assert q.cancel("req-3").id == "req-3"
    assert q.cancel("req-3") is None
    assert [r.data for r in q.dequeue_batch(10)] == [1, 2, 4]


@pytest.mark.parametrize("tier", TIERS)
def test_remove_expired_releases_backpressure(tier):
    q = port_queue(tier, pq.QueueConfig(high_watermark=2, low_watermark=1,
                                        max_queue_size=10,
                                        request_timeout_s=1.0))
    now = time.monotonic()
    for i in range(3):
        q.enqueue(pq.QueuedRequest(id=f"x{i}", data=i,
                                   enqueued_at=now - 5.0))
    assert not q.is_accepting()
    assert len(q.remove_expired(now)) == 3
    assert q.is_accepting()


def _fair(**kw):
    return pq.PriorityQueueManager(pq.QueueConfig(
        high_watermark=10_000, low_watermark=5_000, max_queue_size=20_000,
        tenant_fairness=True, **kw))


def _t(i, tenant, priority=Priority.NORMAL):
    return pq.QueuedRequest(id=f"req-{tenant}-{i}", data=i,
                            priority=priority, tenant=tenant)


def test_tenant_fair_round_robin_and_weight_ratio():
    q = _fair()
    for i in range(100):
        q.enqueue(_t(i, "hog"))
    for i in range(5):
        q.enqueue(_t(i, "mouse"))
    out = q.dequeue_batch(10)
    pos = [j for j, r in enumerate(out) if r.tenant == "mouse"]
    assert len(pos) == 5
    assert all(p <= 2 * (k + 1) for k, p in enumerate(pos))
    q = _fair(tenant_weights={"hog": 3.0, "mouse": 1.0})
    for i in range(200):
        q.enqueue(_t(i, "hog"))
    for i in range(8):
        q.enqueue(_t(i, "mouse"))
    out = [q.dequeue_one() for _ in range(48)]
    pos = [j for j, r in enumerate(out) if r.tenant == "mouse"]
    assert len(pos) == 8
    assert all(p <= 4 * (k + 1) + 1 for k, p in enumerate(pos))
    assert sum(r.tenant == "hog" for r in out) >= 0.6 * len(out)


def test_tenant_fair_levels_fifo_depths_and_late_tenant():
    q = _fair(request_timeout_s=10.0)
    q.enqueue(_t(0, "a", Priority.LOW))
    q.enqueue(_t(0, "b"))
    q.enqueue(_t(1, "b"))
    q.enqueue(_t(0, "c", Priority.HIGH))
    assert q.tenant_depths() == {"a": 1, "b": 2, "c": 1}
    out = q.dequeue_batch(10)
    assert [r.priority for r in out] == [Priority.HIGH, Priority.NORMAL,
                                         Priority.NORMAL, Priority.LOW]
    assert [r.data for r in out if r.tenant == "b"] == [0, 1]
    assert q.tenant_depths() == {}
    for i in range(50):
        q.enqueue(_t(i, "hog"))
    q.dequeue_batch(10)
    q.enqueue(_t(0, "late"))
    assert any(r.tenant == "late" for r in q.dequeue_batch(4))
    # a request without a tenant goes to the default lane
    q.enqueue(pq.QueuedRequest(id="anon", data=0))
    assert q.tenant_depths()["default"] == 1


def test_parse_tenant_weights():
    # the config's parser (serving/config.py), which builds QueueConfig
    from distributed_inference_server_tpu_torch.core.errors import (
        ConfigError,
    )
    from distributed_inference_server_tpu_torch.serving.config import (
        parse_tenant_weights,
    )

    assert parse_tenant_weights("a=2, b=0.5,") == {"a": 2.0, "b": 0.5}
    assert parse_tenant_weights("") == {}
    for bad in ("a", "=2", "a=x", "a=0", "a=-1"):
        with pytest.raises(ConfigError, match="tenant_weights"):
            parse_tenant_weights(bad)


# ---------------------------------------------------------------------------
# the admission batcher
# ---------------------------------------------------------------------------


def _batcher(tier, window_ms=50.0, max_batch=4):
    q = port_queue(tier, pq.QueueConfig(high_watermark=10_000,
                                        low_watermark=5_000,
                                        max_queue_size=20_000))
    return q, port_batcher(q, pb.BatcherConfig(window_ms=window_ms,
                                               max_batch_size=max_batch))


@pytest.mark.parametrize("tier", TIERS)
def test_batcher_size_and_window_triggers(tier):
    q, b = _batcher(tier, window_ms=1e9, max_batch=4)
    for i in range(4):
        q.enqueue(pq.QueuedRequest(id=f"r{i}", data=i))
    batch = b.poll(100.0)
    assert batch is not None and len(batch) == 4
    q, b = _batcher(tier, window_ms=50.0, max_batch=32)
    q.enqueue(pq.QueuedRequest(id="r0", data=0))
    assert b.poll(100.0) is None  # the window opens
    q.enqueue(pq.QueuedRequest(id="r1", data=1))
    assert b.poll(100.03) is None  # a late request does not reset it
    assert b.poll(100.049) is None
    batch = b.poll(100.0501)
    assert batch is not None and _ids(batch.requests) == ["r0", "r1"]


@pytest.mark.parametrize("tier", TIERS)
def test_batcher_priority_order_bounds_flush_cancel(tier):
    q, b = _batcher(tier, window_ms=0.0, max_batch=10)
    q.enqueue(pq.QueuedRequest(id="low", data=0, priority=Priority.LOW))
    q.enqueue(pq.QueuedRequest(id="high", data=1, priority=Priority.HIGH))
    q.enqueue(pq.QueuedRequest(id="norm", data=2, priority=Priority.NORMAL))
    assert _ids(b.poll(1.0).requests) == ["high", "norm", "low"]
    for max_batch in (1, 3, 7):
        q, b = _batcher(tier, window_ms=0.0, max_batch=max_batch)
        for i in range(20):
            q.enqueue(pq.QueuedRequest(id=f"r{i}", data=i))
        seen, t = [], 0.0
        while (batch := b.poll(t)) is not None:
            assert 1 <= len(batch) <= max_batch
            seen += _ids(batch.requests)
            t += 1.0
        assert seen == [f"r{i}" for i in range(20)]
    q, b = _batcher(tier, window_ms=1e9, max_batch=32)
    for i in range(3):
        q.enqueue(pq.QueuedRequest(id=f"w{i}", data=i))
    assert b.poll(0.0) is None and b.pending_count() == 3
    assert b.cancel("w1").id == "w1" and b.cancel("w1") is None
    assert _ids(b.flush().requests) == ["w0", "w2"]
    assert b.flush() is None and b.pending_count() == 0


@pytest.mark.parametrize("tier", TIERS)
def test_batcher_matches_jax(tier):
    rng = np.random.default_rng(11)
    jqueue = jq.PriorityQueueManager(jq.QueueConfig(high_watermark=10_000,
                                                    max_queue_size=20_000))
    ref = jb.AdmissionBatcher(jqueue, jb.BatcherConfig(window_ms=30.0,
                                                       max_batch_size=5))
    q, got = _batcher(tier, window_ms=30.0, max_batch=5)
    t, n = 0.0, 0
    for _ in range(300):
        op = rng.choice(["enq", "enq", "poll", "poll", "cancel", "flush"])
        if op == "enq":
            prio = int(rng.integers(0, 3))
            jqueue.enqueue(_req(n, prio, port=False))
            q.enqueue(_req(n, prio))
            n += 1
        elif op == "poll":
            t += float(rng.uniform(0.0, 0.02))
            a, b = ref.poll(t), got.poll(t)
            assert (a is None) == (b is None)
            assert a is None or _ids(a.requests) == _ids(b.requests)
        elif op == "cancel":
            rid = f"r{int(rng.integers(0, max(n, 1)))}"
            a, b = ref.cancel(rid), got.cancel(rid)
            assert (a is None) == (b is None)
        else:
            a, b = ref.flush(t), got.flush(t)
            assert (a is None) == (b is None)
            assert a is None or _ids(a.requests) == _ids(b.requests)
        assert got.pending_count() == ref.pending_count()


# ---------------------------------------------------------------------------
# the dispatcher: the cases of TestDispatcher
# ---------------------------------------------------------------------------


class RecordingSink:
    def __init__(self):
        self.errors = []

    def on_token(self, *a, **k):
        pass

    def on_done(self, *a, **k):
        pass

    def on_error(self, message, code):
        self.errors.append((message, code))


class FakeRunner:
    """A replica that records the batches it is handed."""

    engine_id = "engine-0"

    def __init__(self, healthy=True):
        self.healthy = healthy
        self.batches = []
        self.aborted = []

    def is_healthy(self):
        return self.healthy

    def status(self):
        return EngineStatus(engine_id=self.engine_id, healthy=self.healthy,
                            active_requests=0, waiting_requests=0,
                            total_processed=0)

    def submit(self, requests):
        self.batches.append([r.request_id for r in requests])

    def abort(self, rid):
        self.aborted.append(rid)

    def active_count(self):
        return 0


def _sreq(rid="r"):
    return ServerRequest(rid, [1, 2, 3], SamplingParams(), RecordingSink())


def _scheduler(runner):
    """The server's scheduler over one replica."""
    s = AdaptiveScheduler()
    s.register(runner)
    return s


def _dispatcher(tier, runner=None, **kw):
    return Dispatcher(_scheduler(runner or FakeRunner()),
                      native_queue=tier == "native", **kw)


@pytest.mark.parametrize("tier", TIERS)
def test_dispatcher_backpressure_and_not_accepting(tier):
    d = _dispatcher(tier, queue_config=pq.QueueConfig(
        high_watermark=2, low_watermark=1, max_queue_size=10))
    assert d.tier == tier
    with pytest.raises(QueueFull):
        d.submit(_sreq())  # not started: not accepting
    d._accepting = True
    for rid in "abc":
        d.submit(_sreq(rid))  # 3 > the high watermark: backpressure on
    with pytest.raises(QueueFull):
        d.submit(_sreq("d"))
    assert not d.is_accepting()


@pytest.mark.parametrize("tier", TIERS)
def test_dispatcher_sweep_expires_to_queue_timeout(tier):
    m = MetricsCollector()
    d = _dispatcher(tier, queue_config=pq.QueueConfig(request_timeout_s=5.0),
                    metrics=m)
    d._accepting = True
    victim, fresh = _sreq("victim"), _sreq("fresh")
    d.submit(victim)
    d._sweep(time.monotonic())
    assert victim.sink.errors == [] and not d.queue.is_empty()
    d._sweep(time.monotonic() + 10.0)
    assert victim.sink.errors[0][1] == "queue_timeout"
    assert d.queue.is_empty()
    assert m.snapshot().to_dict()["resilience"]["requests_expired"] == 1
    assert b"requests_expired_total 1.0" in m.prometheus_text()
    assert fresh.sink.errors == []


@pytest.mark.parametrize("tier", TIERS)
def test_dispatcher_dispatch_abort_and_unhealthy(tier):
    runner = FakeRunner()
    d = _dispatcher(tier, runner, batcher_config=pb.BatcherConfig(
        window_ms=1e9, max_batch_size=32))
    d._accepting = True
    d.submit(_sreq("gone"))
    d.abort("gone")  # still queued
    assert d.queue.is_empty()
    d.submit(_sreq("windowed"))
    assert d.batcher.poll(time.monotonic()) is None  # pulled, window open
    d.abort("windowed")
    assert d.batcher.pending_count() == 0 and d.batcher.flush() is None
    d.abort("in-flight")  # neither queued nor pending: the runner's
    assert runner.aborted == ["in-flight"]
    d.submit(_sreq("x"))
    d.submit(_sreq("y"))
    assert d.batcher.poll(time.monotonic()) is None  # in the window
    d.shutdown(drain_timeout_s=0.05)  # the window's leftovers go out
    assert runner.batches == [["x", "y"]]
    sick = _dispatcher(tier, FakeRunner(healthy=False),
                       metrics=MetricsCollector())
    r = _sreq()
    sick._dispatch([pq.QueuedRequest(id=r.request_id, data=r)])
    assert r.sink.errors and r.sink.errors[0][1] == "no_workers"


@pytest.mark.parametrize("tier", TIERS)
def test_dispatcher_under_concurrent_submitters(tier):
    """Eight threads submit while the dispatch thread drains, with a short
    switch interval: every request reaches the runner exactly once, in
    batches of at most the batcher's size."""
    import sys

    runner = FakeRunner()
    d = _dispatcher(tier, runner, queue_config=pq.QueueConfig(
        high_watermark=10_000, low_watermark=5_000, max_queue_size=20_000),
        batcher_config=pb.BatcherConfig(window_ms=1.0, max_batch_size=7),
        poll_interval_s=0.0005)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        d.start()

        def submit(w):
            for i in range(150):
                d.submit(_sreq(f"w{w}-{i}"),
                         Priority(i % 3))

        threads = [threading.Thread(target=submit, args=(w,))
                   for w in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert not any(th.is_alive() for th in threads)
        d.shutdown(drain_timeout_s=10.0)
    finally:
        sys.setswitchinterval(old)
    got = [rid for batch in runner.batches for rid in batch]
    assert sorted(got) == sorted(f"w{w}-{i}" for w in range(8)
                                 for i in range(150))
    assert all(1 <= len(b) <= 7 for b in runner.batches)


@pytest.mark.parametrize("tier", TIERS)
def test_idle_dispatcher_sleeps_until_submit(tier):
    """With the queue and the window empty the dispatch thread does not
    poll every 2 ms: it sleeps until a submit wakes it, and dispatches that
    request at once (well before the 1 s sweep would have woken it)."""
    runner = FakeRunner()
    d = _dispatcher(tier, runner, batcher_config=pb.BatcherConfig(
        window_ms=0.0, max_batch_size=32))
    polls = []
    poll = d.batcher.poll
    d.batcher.poll = lambda now: polls.append(now) or poll(now)
    d.start()
    try:
        time.sleep(0.3)
        idle_polls = len(polls)
        t0 = time.monotonic()
        d.submit(_sreq("woken"))
        while not runner.batches and time.monotonic() - t0 < 5.0:
            time.sleep(0.001)
        waited = time.monotonic() - t0
    finally:
        d.shutdown(drain_timeout_s=1.0)
    assert idle_polls <= 3, idle_polls  # a 2 ms poll would make ~150
    assert runner.batches == [["woken"]]
    assert waited < 0.25, waited


def test_tenant_fairness_takes_the_python_tier():
    d = Dispatcher(_scheduler(FakeRunner()),
                   queue_config=pq.QueueConfig(tenant_fairness=True))
    assert d.tier == "python"
    with pytest.raises(RuntimeError, match="tenant"):
        Dispatcher(_scheduler(FakeRunner()),
                   queue_config=pq.QueueConfig(tenant_fairness=True),
                   native_queue=True)


# ---------------------------------------------------------------------------
# the validator's native tier
# ---------------------------------------------------------------------------


def _outcome(fn, req):
    try:
        fn(req)
        return None
    except Exception as e:  # noqa: BLE001 — compared by type and text
        return type(e), str(e)


def test_native_validator_matches_python():
    py, nat = RequestValidator(), native.make_validator()
    assert isinstance(nat, native.NativeRequestValidator)
    prompts = ["hi", "", "   ", "　 ", "x" * 40000, "é" * 5,
               "ok\ud800"]
    for prompt in prompts:
        for mt, temp, tp in ((16, 0.0, 1.0), (10 ** 9, 0.5, 0.5),
                             (-1, 0.0, 1.0), (8, 3.0, 1.0), (8, 1.0, 1.5)):
            req = GenerateRequest(prompt=prompt, max_tokens=mt,
                                  temperature=temp, top_p=tp)
            assert _outcome(nat.validate_generate, req) == _outcome(
                py.validate_generate, req), (prompt[:8], mt, temp, tp)
    for msgs in ([], [ChatMessage(Role.USER, " ")],
                 [ChatMessage(Role.USER, "hello")]):
        req = ChatRequest(messages=tuple(msgs))
        assert _outcome(nat.validate_chat, req) == _outcome(
            py.validate_chat, req)
    for inp in (["a", "b"], ["a", " "], []):
        req = EmbeddingsRequest(input=inp)
        assert _outcome(nat.validate_embeddings, req) == _outcome(
            py.validate_embeddings, req)


# ---------------------------------------------------------------------------
# served: priority, watermarks with hysteresis, queue_timeout, tenants
# ---------------------------------------------------------------------------


class Served:
    """One TINY CPU server on the Python queue tier with tenant lanes,
    watermarks high 3 / low 2, batches of one request, and a log of the
    order in which requests reach the runner."""

    def __init__(self):
        params = llama.init_params(TINY, torch.Generator().manual_seed(0),
                                   dtype=torch.float32, device="cpu")

        def factory():
            return LLMEngine(params, TINY, ByteTokenizer(), EngineConfig(
                max_batch=2, prefill_buckets=(16, 64),
                paged=PagedCacheConfig(96, 8, 16)), dtype=torch.float32,
                device="cpu")

        self.server = InferenceServer(
            factory, ByteTokenizer(), "tiny-admission",
            queue_config=pq.QueueConfig(high_watermark=3, low_watermark=2,
                                        tenant_fairness=True),
            batcher_config=pb.BatcherConfig(window_ms=0.0,
                                            max_batch_size=1))
        self.server.start()
        self.port = self.server.serve("127.0.0.1", 0, block=False)
        self.order = []
        runner = self.server.runner
        submit = runner.submit

        def logged(requests):
            self.order.extend(r.prompt_ids for r in requests)
            submit(requests)

        runner.submit = logged

    @property
    def dispatcher(self):
        return self.server.dispatcher

    def post(self, body, timeout=60.0):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=timeout)
        conn.request("POST", "/generate", json.dumps(body))
        resp = conn.getresponse()
        out = resp.status, json.loads(resp.read() or b"null")
        conn.close()
        return out

    def post_async(self, body):
        box = {}
        th = threading.Thread(target=lambda: box.update(r=self.post(body)))
        th.start()
        return th, box

    def wait_depth(self, n, timeout=10.0):
        deadline = time.monotonic() + timeout
        while self.dispatcher.queue.total_depth() != n:
            assert time.monotonic() < deadline, (
                self.dispatcher.queue.total_depth(), n)
            time.sleep(0.005)

    def paused(self):
        """Hold the dispatch thread in its next poll: requests stay in the
        queue until the block ends."""
        return self.dispatcher.batcher._lock


@pytest.fixture(scope="module")
def served():
    s = Served()
    yield s
    s.server.shutdown(drain_timeout_s=5.0)


def _body(prompt, **kw):
    return {"prompt": prompt, "max_tokens": 2, "temperature": 0.0, **kw}


def _ids_of(text):
    return ByteTokenizer().encode(text)


def test_served_high_priority_admitted_first(served):
    served.order.clear()
    jobs = []
    with served.paused():
        for i, prio in enumerate(("normal", "normal", "normal", "high")):
            jobs.append(served.post_async(_body(f"p{i}", priority=prio)))
            served.wait_depth(i + 1)
    for th, _ in jobs:
        th.join(60)
    assert all(box["r"][0] == 200 for _, box in jobs)
    assert served.order == [_ids_of(p) for p in ("p3", "p0", "p1", "p2")]


def test_served_watermarks_503_with_hysteresis(served):
    jobs = []
    with served.paused():
        # a streamed request whose client will go away while it is queued
        conn = http.client.HTTPConnection("127.0.0.1", served.port,
                                          timeout=30)
        conn.request("POST", "/generate",
                     json.dumps(_body("gone", stream=True)))
        served.wait_depth(1)
        for i in range(3):
            jobs.append(served.post_async(_body(f"w{i}")))
            served.wait_depth(i + 2)
        # 4 queued > high watermark 3: backpressure
        status, body = served.post(_body("refused"))
        assert status == 503 and body["error"]["code"] == "queue_full"
        conn.close()  # the queued stream's client goes away
        served.wait_depth(3)
        # 3 queued: not above the high mark, not below the low one: still
        # refused (hysteresis)
        status, body = served.post(_body("still refused"))
        assert status == 503 and body["error"]["code"] == "queue_full"
    for th, _ in jobs:
        th.join(60)
    assert [box["r"][0] for _, box in jobs] == [200, 200, 200]
    served.wait_depth(0)
    status, _ = served.post(_body("accepted"))  # below the low mark
    assert status == 200


def test_served_queue_timeout_408(served):
    q = served.dispatcher.queue
    q.config = dataclasses.replace(q.config, request_timeout_s=0.3)
    try:
        with served.paused():
            jobs = [served.post_async(_body(f"t{i}")) for i in range(3)]
            served.wait_depth(3)
            time.sleep(1.2)  # past the timeout and one sweep period
        for th, _ in jobs:
            th.join(60)
    finally:
        q.config = dataclasses.replace(q.config, request_timeout_s=30.0)
    statuses = sorted(box["r"][0] for _, box in jobs)
    # the first request out of the paused poll is dispatched; the sweep
    # right after it expires the other two
    assert statuses == [200, 408, 408]
    codes = {box["r"][1]["error"]["code"] for _, box in jobs
             if box["r"][0] == 408}
    assert codes == {"queue_timeout"}


def test_served_tenant_lanes(served):
    served.order.clear()
    jobs = []
    with served.paused():
        for i, tenant in enumerate(("hot", "hot", "hot", "cold")):
            jobs.append(served.post_async(_body(f"{tenant}{i}",
                                                tenant=tenant)))
            served.wait_depth(i + 1)
        assert served.dispatcher.queue.tenant_depths() == {"hot": 3,
                                                           "cold": 1}
    for th, _ in jobs:
        th.join(60)
    # deficit round robin, equal weights: the cold tenant's one request
    # goes second, not behind the hot tenant's backlog
    assert served.order == [_ids_of(p) for p in
                            ("hot0", "cold3", "hot1", "hot2")]


def test_served_stats_report_the_admission_tier(served):
    conn = http.client.HTTPConnection("127.0.0.1", served.port, timeout=30)
    conn.request("GET", "/server/stats")
    stats = json.loads(conn.getresponse().read())
    adm = stats["admission"]
    assert adm["tier"] == "python"  # tenant lanes take the Python tier
    assert adm["window_ms"] == 0.0 and adm["max_batch_size"] == 1
    assert stats["resilience"]["requests_expired"] >= 2
    conn.request("GET", "/metrics")
    text = conn.getresponse().read().decode()
    assert "requests_expired_total" in text and "queue_depth" in text
