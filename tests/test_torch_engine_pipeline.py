"""The port's pipelined engine against the JAX engine, step by step.

``pipeline_depth`` keeps launched decode blocks in flight and walks the
oldest one once more than ``pipeline_depth`` are pending (or nothing new
was launched). At depths 0, 1 and 2 both engines get the same weights
(JAX ``init_params`` -> numpy, every matrix scaled by 8 so TINY's greedy
continuations vary) and the same script of requests, steps and aborts, in
float32 on the CPU (the JAX engine on its reference path); every step's
outputs (request, token, text delta, finish reason, error) must be equal,
not only each request's final tokens, so the pipelining itself is held
against the reference's. Covered: the scenarios of ``tests/test_engine.py``
(static generate, concurrent rows, more requests than slots, prefix reuse,
preemption under page pressure, stop sequences, EOS, an oversized prompt,
aborts mid-pipeline, failure isolation, chunked prefill interleaved with
decode, a greedy row beside sampled ones) and seeded runs of
``tests/test_engine_fuzz.py``'s random workload generator with its
invariants. Also: ``warmup`` leaves the page books clean and changes no
later token, ``step_clock_stats`` has the JAX engine's keys after the
same trace, and a CPU server started with ``--model-model-dir`` on the
``tiny_llama_hf`` fixture answers with the JAX engine's text for that
checkpoint.

Greedy tokens are compared only after checking that every generated
step's top-2 logit gap exceeds ``TIE_TOL`` (an independent dense forward),
so a near-tie is reported as such, not as a fault.
"""

import json
import os
import random
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.engine.engine import (
    EngineConfig as JEngineConfig,
)
from distributed_inference_server_tpu.engine.engine import LLMEngine as JEngine
from distributed_inference_server_tpu.engine.engine import (
    SamplingParams as JSamplingParams,
)
from distributed_inference_server_tpu.engine.kv_cache import (
    PagedCacheConfig as JPagedCacheConfig,
)
from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu.models.loader import (
    load_checkpoint as j_load_checkpoint,
)
from distributed_inference_server_tpu.models.tokenizer import (
    ByteTokenizer as JByteTokenizer,
)
from distributed_inference_server_tpu.models.tokenizer import (
    load_tokenizer as j_load_tokenizer,
)
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PagedCacheConfig,
)
from distributed_inference_server_tpu_torch.models import llama as t_llama
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)

SCALE = 8.0
TIE_TOL = 1e-3  # >> the ~1e-5 f32 logit difference between the packages
TOK = ByteTokenizer()
DEPTHS = (0, 1, 2)


@pytest.fixture(scope="module")
def shared():
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * SCALE
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * SCALE
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    return j_params, params_from_numpy(tree, device="cpu",
                                       dtype=torch.float32)


class _EosTok:
    """The byte tokenizer with another EOS id (both packages' engines only
    read ``eos_ids``, ``encode`` and ``decode``)."""

    def __init__(self, base, eos):
        self._base = base
        self.bos_id = base.bos_id
        self.vocab_size = base.vocab_size
        self.eos_ids = (eos,)

    def encode(self, text, add_bos=True):
        return self._base.encode(text, add_bos)

    def decode(self, ids):
        return self._base.decode(ids)

    def decode_token(self, token_id):
        return self._base.decode_token(token_id)


def _engines(shared, depth, paged=(32, 4, 8), eos=None, **kw):
    kw = {"max_batch": 4, "prefill_buckets": (8, 32), **kw}
    j_params, t_params = shared
    jtok, ttok = JByteTokenizer(), TOK
    if eos is not None:
        jtok, ttok = _EosTok(jtok, eos), _EosTok(ttok, eos)
    je = JEngine(j_params, J_TINY, jtok, JEngineConfig(
        paged=JPagedCacheConfig(*paged), attention_impl="xla",
        native_allocator=False, pipeline_depth=depth, **kw),
        dtype=jnp.float32)
    te = LLMEngine(t_params, TINY, ttok, EngineConfig(
        paged=PagedCacheConfig(*paged), pipeline_depth=depth, **kw),
        dtype=torch.float32, device="cpu")
    return je, te


def _event(o):
    return (o.request_id, o.token_id, o.text, o.finished,
            getattr(o.finish_reason, "value", None), o.error)


def _lockstep(je, te, actions, sp=(JSamplingParams, SamplingParams),
              max_steps=1000):
    """Apply ``actions`` — ("add", rid, ids, kw), ("steps", n) or
    ("abort", rid) — to both engines, then step both until idle. Every
    step's outputs must be equal. Returns {rid: tokens, text, finish}."""
    res = {}

    def step():
        jo = [_event(o) for o in je.step()]
        to = [_event(o) for o in te.step()]
        assert to == jo
        for rid, tok, text, fin, reason, err in to:
            r = res.setdefault(rid, {"tokens": [], "text": "",
                                     "finish": None, "error": None})
            r["text"] += text
            if tok is not None:
                r["tokens"].append(tok)
            if fin:
                r["finish"], r["error"] = reason, err

    for act in actions:
        if act[0] == "add":
            je.add_request(act[1], list(act[2]), sp[0](**act[3]))
            te.add_request(act[1], list(act[2]), sp[1](**act[3]))
        elif act[0] == "abort":
            assert te.abort(act[1]) == je.abort(act[1])
        else:
            for _ in range(act[1]):
                step()
    for _ in range(max_steps):
        if not (je.has_work() or te.has_work()):
            break
        step()
    assert not te.has_work() and not je.has_work(), "engines did not drain"
    assert len(te._pending) == len(je._pending)
    return res


def _dense_logits(t_params, ids):
    n = len(ids)
    cache = t_llama.KVCache.create(TINY, 1, n, dtype=torch.float32,
                                   device="cpu")
    pos = torch.arange(n)[None]
    logits, _ = t_llama.forward(t_params, TINY, torch.tensor([ids]), pos,
                                cache, pos, torch.tensor([n]))
    return logits[0]


def _assert_no_near_ties(t_params, prompt, tokens):
    if not tokens:
        return
    steps = _dense_logits(t_params, list(prompt) + tokens[:-1])[
        len(prompt) - 1:]
    top2 = torch.topk(steps, 2, dim=-1).values
    for i, g in enumerate((top2[:, 0] - top2[:, 1]).tolist()):
        assert g > TIE_TOL, (
            f"near-tie at generated step {i}: top-2 logit gap {g:.2e} <= "
            f"{TIE_TOL} — a tie, not a fault")


def _greedy(n, **kw):
    return dict(temperature=0.0, max_tokens=n, **kw)


# ---------------------------------------------------------------------------
# tests/test_engine.py's scenarios, at every depth
# ---------------------------------------------------------------------------


def _sc_static():
    return {}, [("add", "r1", TOK.encode("hello"), _greedy(8))]


def _sc_concurrent():
    return {}, [("add", f"r{i}", TOK.encode(f"prompt number {i}"),
                 _greedy(8)) for i in range(4)]


def _sc_more_than_slots():
    return ({"max_batch": 2},
            [("add", f"r{i}", TOK.encode(f"req {i}"), _greedy(8))
             for i in range(5)])


def _sc_prefix_reuse():
    prompt = TOK.encode("shared prefix, reuse")  # > 1 full page
    return {}, [("add", "first", prompt, _greedy(8)), ("steps", 40),
                ("add", "second", prompt, _greedy(8))]


def _sc_preemption():
    return ({"paged": (8, 4, 6), "max_batch": 2},
            [("add", "a", TOK.encode("abcdefgh"), _greedy(10)),
             ("add", "b", TOK.encode("12345678"), _greedy(10))])


def _sc_oversized():
    return ({"paged": (8, 4, 2)},
            [("add", "big", list(range(1, 40)), _greedy(8)),
             ("add", "ok", TOK.encode("fits"), _greedy(4))])


def _sc_abort_mid_pipeline():
    return {}, [("add", "gone", TOK.encode("hello world"), _greedy(50)),
                ("add", "stay", TOK.encode("stay put"), _greedy(12)),
                ("steps", 3), ("abort", "gone"),
                ("add", "next", TOK.encode("hello world"), _greedy(6))]


def _sc_chunked_interleave():
    long_ids = [1 + (i % 200) for i in range(40)]  # 5 chunks of 8
    return ({"max_batch": 2, "paged": (64, 4, 16), "decode_block_size": 2,
             "prefill_batch": 2, "prefill_token_budget": 8},
            [("add", "short", TOK.encode("hi"), _greedy(40)), ("steps", 1),
             ("add", "long", long_ids, _greedy(8))])


def _sc_sampled_beside_greedy():
    return {}, [("add", "g", TOK.encode("greedy row"), _greedy(8)),
                ("add", "t", TOK.encode("hot"),
                 dict(temperature=0.9, top_p=0.8, max_tokens=8))]


SCENARIOS = {
    "static": _sc_static, "concurrent": _sc_concurrent,
    "more_than_slots": _sc_more_than_slots,
    "prefix_reuse": _sc_prefix_reuse, "preemption": _sc_preemption,
    "oversized": _sc_oversized, "abort_mid_pipeline": _sc_abort_mid_pipeline,
    "chunked_interleave": _sc_chunked_interleave,
}


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios_match_jax_step_by_step(shared, name, depth):
    kw, actions = SCENARIOS[name]()
    je, te = _engines(shared, depth, **kw)
    res = _lockstep(je, te, actions)
    for act in actions:
        if act[0] == "add" and res[act[1]]["error"] is None:
            _assert_no_near_ties(shared[1], act[2], res[act[1]]["tokens"])
    assert te.audit_pages() == []
    s = te.cache_stats()
    assert s.pages_free + s.pages_cached == s.pages_total
    if name == "prefix_reuse":
        assert res["second"]["tokens"] == res["first"]["tokens"]
        assert te.cache_stats().hits == je.allocator.stats().hits > 0
    if name == "preemption":
        assert te.step_clock_stats()["events"]["preempt"] > 0
    if name == "oversized":
        assert "exceeds" in res["big"]["error"]


@pytest.mark.parametrize("depth", DEPTHS)
def test_greedy_row_unchanged_beside_sampled_rows(shared, depth):
    """A sampled row switches the block to the sampling mode; the greedy
    row's tokens stay the JAX engine's (sampled tokens differ by RNG)."""
    _, actions = _sc_sampled_beside_greedy()
    je, te = _engines(shared, depth)
    out = {}
    for eng, sp in ((je, JSamplingParams), (te, SamplingParams)):
        for _, rid, ids, kw in actions:
            eng.add_request(rid, list(ids), sp(**kw))
        toks = {}
        while eng.has_work():
            for o in eng.step():
                if o.token_id is not None:
                    toks.setdefault(o.request_id, []).append(o.token_id)
        out[eng is te] = toks
    assert out[True]["g"] == out[False]["g"]
    assert len(out[True]["t"]) == 8
    assert te.audit_pages() == []


@pytest.mark.parametrize("depth", DEPTHS)
def test_stop_sequence_and_eos(shared, depth):
    prompt = TOK.encode("hello")
    je, te = _engines(shared, depth)
    probe = _lockstep(je, te, [("add", "probe", prompt, _greedy(8))])
    text, first = probe["probe"]["text"], probe["probe"]["tokens"][0]
    stop = text[1:3]
    assert stop and len(text) >= 3
    res = _lockstep(je, te, [("add", "s", prompt,
                              _greedy(8, stop_sequences=(stop,)))])
    assert res["s"]["finish"] == "stop_sequence"
    assert res["s"]["text"] == text[: text.find(stop)]
    # EOS = the first greedy token: finishes at once with no output
    je, te = _engines(shared, depth, eos=first)
    res = _lockstep(je, te, [("add", "e", prompt, _greedy(8)),
                             ("add", "f", TOK.encode("other"), _greedy(6))])
    assert res["e"]["finish"] == "stop" and res["e"]["tokens"] == []
    assert te.audit_pages() == []


@pytest.mark.parametrize("depth", DEPTHS)
def test_failure_isolation_mid_pipeline(shared, depth):
    """A request whose host processing explodes errors out alone; its
    batch-mates' tokens and the page books are unaffected."""
    class Exploding(tuple):
        def __iter__(self):  # poison the stop-sequence scan
            raise RuntimeError("injected failure")

    je, te = _engines(shared, depth)
    for eng, sp in ((je, JSamplingParams), (te, SamplingParams)):
        eng.add_request("ok", TOK.encode("good"), sp(**_greedy(8)))
        eng.add_request("boom", TOK.encode("bad"), sp(**_greedy(8)))
        seq = eng._by_id["boom"]
        seq.params = sp(**_greedy(8))
        object.__setattr__(seq.params, "stop_sequences", Exploding(("z",)))
    res = _lockstep(je, te, [])
    assert res["boom"]["error"] is not None and res["ok"]["error"] is None
    assert len(res["ok"]["tokens"]) == 8
    assert te.audit_pages() == []


# ---------------------------------------------------------------------------
# tests/test_engine_fuzz.py's generator, seeded, with its invariants
# ---------------------------------------------------------------------------


def _fuzz_lockstep(je, te, rnd, n_requests=14, abort_frac=0.25, prompt_max=40,
                   max_steps=3000):
    """The fuzz test's random admissions and aborts, applied to both
    engines in lockstep; each step's outputs must be equal."""
    outcomes, prompts = {}, {}
    pending = list(range(n_requests))
    live = []
    steps = 0
    while (pending or te.has_work()) and steps < max_steps:
        steps += 1
        if pending and rnd.random() < 0.4:
            i = pending.pop()
            rid = f"r{i}"
            ids = [rnd.randint(1, 250) for _ in range(rnd.randint(
                1, prompt_max))]
            kw = _greedy(rnd.randint(1, 24))
            je.add_request(rid, ids, JSamplingParams(**kw))
            te.add_request(rid, ids, SamplingParams(**kw))
            prompts[rid] = ids
            live.append(rid)
        if live and rnd.random() < abort_frac * 0.3:
            rid = rnd.choice(live)
            found = te.abort(rid)
            assert je.abort(rid) == found
            if found:
                outcomes.setdefault(rid, []).append("aborted")
                live.remove(rid)
        jo = [_event(o) for o in je.step()]
        to = [_event(o) for o in te.step()]
        assert to == jo, f"step {steps}"
        for rid, _, _, fin, reason, err in to:
            if fin:
                outcomes.setdefault(rid, []).append(
                    "error" if err is not None else reason)
                if rid in live:
                    live.remove(rid)
    assert steps < max_steps, "engine failed to drain (livelock?)"
    return outcomes


@pytest.mark.parametrize("depth", DEPTHS)
def test_fuzz_matches_jax_with_invariants(shared, depth, monkeypatch):
    """The fuzz baseline's workload (pool of 24 pages of 4 tokens: prompts
    of up to 40 tokens force preemption; random aborts) at every depth.
    Besides step-by-step equality: every request terminates exactly once,
    the books drain, every page comes back, and no processed block shows a
    row emitting more tokens than the pages its launch ensured."""
    overshoot = []
    orig = LLMEngine._walk_block

    def spy(self, toks, lps, snapshot, outputs):
        for slot, _, assumed in snapshot:
            live = int((toks[:, slot] >= 0).sum())
            if live > assumed:
                overshoot.append((slot, live, assumed))
        return orig(self, toks, lps, snapshot, outputs)

    monkeypatch.setattr(LLMEngine, "_walk_block", spy)
    je, te = _engines(shared, depth, paged=(24, 4, 16), decode_block_size=3)
    free0 = te.cache_stats().pages_free
    outcomes = _fuzz_lockstep(je, te, random.Random(1))
    assert len(outcomes) == 14
    for rid, events in outcomes.items():
        assert len(events) == 1, f"{rid} terminated twice: {events}"
        assert events[0] in ("length", "stop", "aborted"), (rid, events)
    assert te.num_active() == 0 and te.num_waiting() == 0
    assert not te._by_id and te.audit_pages() == []
    s = te.cache_stats()
    assert s.pages_free + s.pages_cached == s.pages_total == free0
    assert overshoot == []
    assert te.step_clock_stats()["events"]["preempt"] > 0


# ---------------------------------------------------------------------------
# warmup and the step clock
# ---------------------------------------------------------------------------


def test_warmup_is_clean_and_changes_no_token(shared):
    prompt = TOK.encode("after the warmup")
    kw = dict(paged=(64, 4, 16), max_batch=2)
    je, cold = _engines(shared, 1, **kw)
    _, warm = _engines(shared, 1, **kw)
    warm.warmup()
    je.warmup()
    assert not warm.has_work() and warm.audit_pages() == []
    # one throwaway per bucket (8, 32) plus one near the context limit
    # (64 - 9 - 2 = 53 tokens: two 32-token chunks), as the reference
    assert warm.step_clock_stats()["kinds"]["prefill"]["dispatches"] == (
        je.step_clock_stats()["kinds"]["prefill"]["dispatches"]) == 4
    assert warm.step_clock_stats()["events"]["retrace"] == 0
    want = _lockstep(je, cold, [("add", "r", prompt, _greedy(10))])
    got = {}
    warm.add_request("r", prompt, SamplingParams(**_greedy(10)))
    while warm.has_work():
        for o in warm.step():
            if o.token_id is not None:
                got.setdefault(o.request_id, []).append(o.token_id)
    assert got["r"] == want["r"]["tokens"]
    assert warm.audit_pages() == []


def test_step_clock_has_the_jax_keys(shared):
    """After the same trace (prefill, decode blocks, preemption) the port's
    step clock has the JAX engine's kinds, fields and events, with the
    same dispatch, token and row counts and pressure events."""
    je, te = _engines(shared, 1, paged=(8, 4, 6), max_batch=2)
    _lockstep(je, te, [("add", "a", TOK.encode("abcdefgh"), _greedy(10)),
                       ("add", "b", TOK.encode("12345678"), _greedy(10))])
    js, ts = je.step_clock_stats(), te.step_clock_stats()
    assert set(js) == {"kinds", "events"}
    # the port's device clock beside them: idle gaps by cause
    assert set(ts) == set(js) | {"idle"}
    assert set(ts["events"]) == set(js["events"])
    assert set(ts["kinds"]) == set(js["kinds"])
    for kind, jc in js["kinds"].items():
        assert set(ts["kinds"][kind]) == set(jc) | {
            "forwards", "capacity", "device_s"}, kind
        for key in ("dispatches", "tokens", "rows"):
            assert ts["kinds"][kind][key] == jc[key], (kind, key)
    for name in ("cache_full", "preempt", "reclaim"):
        assert ts["events"][name] == js["events"][name], name
    assert ts["kinds"]["decode_block"]["tokens"] > 0
    samples = te.drain_step_samples()
    assert samples and {k for k, _ in samples} <= set(ts["kinds"])
    assert te.drain_step_samples() == []


def test_step_clock_counts_forwards_and_capacity(shared):
    """Two 700-token prompts at buckets 32/128/512, four prefill rows and
    a 2048-token budget: one [4, 512] chunk a step, twice (the rest, 188
    tokens, still takes the 512 bucket), so 2 forwards over 2 x 4 x 512
    computed tokens for 1400 prompt tokens; each decode block K forwards
    over max_batch x K. On the CPU no device time and no idle gap is
    read. Each first token carries its prefill chunks: both issue times,
    2 chunks over 2 engine steps."""
    te = LLMEngine(shared[1], TINY, TOK, EngineConfig(
        max_batch=4, paged=PagedCacheConfig(256, 16, 64)),
        dtype=torch.float32, device="cpu")
    for rid, first in (("a", 5), ("b", 6)):
        te.add_request(rid, [first] * 700, SamplingParams(**_greedy(17)))
    marks = {}
    while te.has_work():
        for o in te.step():
            if o.prefill is not None:
                marks[o.request_id] = o.prefill
    sc = te.step_clock_stats()
    pre, dec = sc["kinds"]["prefill"], sc["kinds"]["decode_block"]
    assert (pre["dispatches"], pre["forwards"]) == (2, 2)
    assert (pre["tokens"], pre["capacity"]) == (1400, 2 * 4 * 512)
    K = te.ecfg.decode_block_size
    assert dec["dispatches"] >= 1
    assert dec["forwards"] == K * dec["dispatches"]
    assert dec["capacity"] == 4 * K * dec["dispatches"]
    assert sc["kinds"]["mixed"]["capacity"] == sc["kinds"]["loop"][
        "forwards"] == 0
    assert all(c["device_s"] == 0.0 for c in sc["kinds"].values())
    assert sc["idle"] == {c: 0.0 for c in (
        "admit", "schedule", "walk", "reap", "runner", "other")}
    assert set(marks) == {"a", "b"}
    for t0, t1, chunks, steps in marks.values():
        assert t0 < t1 and (chunks, steps) == (2, 2)


def test_pipeline_depth_must_be_non_negative(shared):
    with pytest.raises(ValueError, match="pipeline_depth"):
        LLMEngine(shared[1], TINY, TOK, EngineConfig(pipeline_depth=-1),
                  dtype=torch.float32, device="cpu")


# ---------------------------------------------------------------------------
# the server on a checkpoint directory
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "tests", "fixtures", "tiny_llama_hf")


def _http(method, url, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def test_cpu_server_on_a_checkpoint_dir_matches_jax(tmp_path):
    prompts = ["The quick brown fox", "Paged attention maps"]
    j_params, j_cfg = j_load_checkpoint(CKPT, dtype=jnp.float32)
    je = JEngine(j_params, j_cfg, j_load_tokenizer(CKPT), JEngineConfig(
        attention_impl="xla", native_allocator=False), dtype=jnp.float32)
    jtok = j_load_tokenizer(CKPT)
    want = {}
    for i, p in enumerate(prompts):
        je.add_request(i, jtok.encode(p), JSamplingParams(
            max_tokens=12, temperature=0.0))
    while je.has_work():
        for o in je.step():
            want[o.request_id] = want.get(o.request_id, "") + o.text

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_inference_server_tpu_torch",
         "--model-model-dir", CKPT, "--device", "cpu", "--model-dtype",
         "float32", "--server-host", "127.0.0.1", "--server-port",
         str(port), "--engine-warmup-compile", "false"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        t0 = time.monotonic()
        while True:
            assert proc.poll() is None, (tmp_path / "server.log").read_text()
            try:
                if _http("GET", base + "/health", timeout=5)[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            assert time.monotonic() - t0 < 120, "server never became healthy"
            time.sleep(0.2)
        for i, p in enumerate(prompts):
            st, body = _http("POST", base + "/generate", {
                "prompt": p, "max_tokens": 12, "temperature": 0.0})
            assert st == 200, body
            assert body["choices"][0]["text"] == want[i], p
        _, stats = _http("GET", base + "/server/stats")
        sc = stats["step_clock"]
        assert sc["kinds"]["decode_block"]["dispatches"] > 0
        assert stats["warmup_s"] is None and stats["memory"] is None
        # the trace route: no card here, so it says so and measures nothing
        with pytest.raises(urllib.error.HTTPError) as busy:
            _http("POST", base + "/server/profile", {"steps": 2})
        assert busy.value.code == 409
        assert "no CUDA device" in json.loads(busy.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as bad:
            _http("POST", base + "/server/profile", {"steps": 0})
        assert bad.value.code == 400
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()


def test_cpu_engine_runs_eagerly(shared):
    """On the CPU nothing is captured and no stream or pinned memory is
    used; the device memory report is null."""
    _, te = _engines(shared, 1)
    te.add_request("r", TOK.encode("eager"), SamplingParams(**_greedy(6)))
    while te.has_work():
        te.step()
    assert te._graphs == {} and te._stream is None
    assert te.memory_stats() is None


def test_profiler_busy_time_is_the_union_of_device_intervals():
    from distributed_inference_server_tpu_torch.utils.profiler import (
        _union_us,
    )

    assert _union_us([]) == 0.0
    assert _union_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17.0
    assert _union_us([(3, 4), (0, 1)]) == 2.0
