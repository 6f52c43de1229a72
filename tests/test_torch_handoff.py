"""KV handoff and peer prefix fetch across the JAX package and the port.

TINY f32 weights drawn by the JAX package (every matrix scaled by 8 so
greedy continuations vary; the latent cases use the JAX package's own
unscaled fixture, whose K/V a rank-4 latent keeps token-exact) are shared
by conversion. A sequence exported by one package imports into the other
and continues with greedy tokens identical to the JAX unified engine's
cold run, for the monolithic payload, the streamed handoff and
``import_prefix``, over the ``none``, ``int8`` and ``latent`` wires, and
with the draft pool's payload between speculative engines. Then the
engine cases of ``tests/test_disagg.py``, ``tests/test_prefix_fetch.py``,
``tests/test_latent_kv.py`` and ``test_streamed_export_overlap_under_loop``
of ``tests/test_engine_loop.py`` against the port, each with its
reference tokens from the JAX engine and ``audit_pages() == []``.

One JAX engine per configuration serves every case: its prefix cache is
dropped (``evict_cache(0.0)``) before each cold run or export, so each
run is cold.
"""

import dataclasses
import functools
import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.engine import engine as jeng
from distributed_inference_server_tpu.engine import kv_cache as jkv
from distributed_inference_server_tpu.engine.speculative import (
    SpecConfig as JSpecConfig,
)
from distributed_inference_server_tpu.models import llama as j_llama
from distributed_inference_server_tpu.models import tokenizer as jtok
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu_torch.core.errors import (
    CacheDeserializationError,
)
from distributed_inference_server_tpu_torch.engine import kv_cache as tkv
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
    SequenceExport,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    DIGEST_DEPTH,
    PagedCacheConfig,
    chain_hashes,
)
from distributed_inference_server_tpu_torch.engine.speculative import (
    SpecConfig,
)
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)

PS = 4
PAGED = (96, PS, 32)  # 128 tokens a sequence
BUCKETS = (8, 64)
TOK = ByteTokenizer()
GAMMA = 3


@functools.lru_cache(maxsize=None)
def _tree(scale: float = 8.0):
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * scale
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * scale
    return tree


def _jp(scale=8.0):
    return jax.tree_util.tree_map(jnp.asarray, _tree(scale))


def _pp(scale=8.0):
    return params_from_numpy(_tree(scale), device="cpu", dtype=torch.float32)


def j_engine(scale=8.0, draft=False, **kw):
    return jeng.LLMEngine(
        _jp(scale), J_TINY, jtok.ByteTokenizer(),
        jeng.EngineConfig(
            max_batch=4, prefill_buckets=BUCKETS,
            paged=jkv.PagedCacheConfig(*PAGED), attention_impl="xla",
            native_allocator=False, **kw),
        dtype=jnp.float32,
        draft_params=_jp(scale) if draft else None,
        draft_cfg=J_TINY if draft else None,
        spec=JSpecConfig(num_draft_tokens=GAMMA) if draft else None)


def p_engine(scale=8.0, draft=False, **kw):
    return LLMEngine(
        _pp(scale), TINY, TOK,
        EngineConfig(max_batch=4, prefill_buckets=BUCKETS,
                     paged=PagedCacheConfig(*PAGED), **kw),
        dtype=torch.float32, device="cpu",
        draft_params=_pp(scale) if draft else None,
        draft_cfg=TINY if draft else None,
        spec=SpecConfig(num_draft_tokens=GAMMA) if draft else None)


@pytest.fixture(scope="module")
def jx():
    return j_engine()


@pytest.fixture(scope="module")
def jlat():
    return j_engine(scale=1.0, latent_rank=4)


@pytest.fixture(scope="module")
def jspec():
    return j_engine(draft=True, decode_block_size=3)


def _sp(engine, max_tokens):
    cls = (jeng.SamplingParams if isinstance(engine, jeng.LLMEngine)
           else SamplingParams)
    return cls(max_tokens=max_tokens, temperature=0.0)


def drain(engine, toks):
    """Step until idle or a handoff is ready, collecting token ids."""
    while engine.has_work() and not engine.handoff_ready_ids():
        for o in engine.step():
            assert o.error is None, o.error
            if o.token_id is not None:
                toks.append(o.token_id)
    return toks


def cold_run(engine, rid, prompt, max_tokens):
    """Greedy tokens of ``prompt`` from a cold prefix cache."""
    engine.evict_cache(0.0)
    engine.add_request(rid, list(prompt), _sp(engine, max_tokens))
    toks = drain(engine, [])
    assert not engine.has_work()
    return toks


def prefill_ready(engine, rid, prompt, max_tokens):
    engine.evict_cache(0.0)
    engine.add_request(rid, list(prompt), _sp(engine, max_tokens),
                       prefill_only=True)
    toks = drain(engine, [])
    assert engine.handoff_ready_ids() == [rid]
    return toks


def convert(exp, to_jax: bool):
    """A SequenceExport of one package as the other's."""
    d = {f.name: getattr(exp, f.name) for f in dataclasses.fields(exp)}
    d["params"] = (jeng.SamplingParams if to_jax else SamplingParams)(
        **dataclasses.asdict(exp.params))
    chunk = jkv.KvChunk if to_jax else tkv.KvChunk
    if exp.kv_chunks is not None:
        d["kv_chunks"] = [chunk(**dataclasses.asdict(c))
                          for c in exp.kv_chunks]
    return (jeng.SequenceExport if to_jax else SequenceExport)(**d)


def _chunks(chunks, to_jax: bool):
    cls = jkv.KvChunk if to_jax else tkv.KvChunk
    return [cls(**dataclasses.asdict(c)) for c in chunks]


def _prompt(i, n=26):
    """A prompt of its own: no case shares a page with another."""
    rng = np.random.default_rng(100 + i)
    return [1 + i] + rng.integers(1, 255, n - 1).tolist()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["none", "int8"])
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_monolithic_handoff_crosses_packages(jx, wire, direction):
    prompt = _prompt(1 + (wire == "int8") + 2 * (direction == "port->jax"))
    want = cold_run(jx, "ref", prompt, 10)
    if direction == "jax->port":
        src, dst, to_jax = jx, p_engine(), False
    else:
        src, dst, to_jax = p_engine(), jx, True
    got = prefill_ready(src, "r", prompt, 10)
    exp = src.export_handoff("r", wire_quant=wire)
    assert exp is not None and exp.wire_quant == wire
    dst.evict_cache(0.0)
    dst.import_sequence(convert(exp, to_jax))
    drain(dst, got)
    assert got == want
    assert src.audit_pages() == [] and dst.audit_pages() == []


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_streamed_handoff_crosses_packages(jx, direction):
    prompt = _prompt(10 + (direction == "port->jax"))
    want = cold_run(jx, "ref", prompt, 40)
    if direction == "jax->port":
        src, dst, to_jax = jx, p_engine(), False
    else:
        src, dst, to_jax = p_engine(), jx, True
    got = prefill_ready(src, "r", prompt, 40)
    session = src.export_handoff_begin("r", chunk_pages=2)
    assert session is not None
    for o in src.step():  # the sequence decodes while its prefix moves
        if o.token_id is not None:
            got.append(o.token_id)
    src.export_handoff_pump(session)
    dst.evict_cache(0.0)
    isess = dst.import_stream_open("r", len(session.prefix_pages))
    dst.import_stream_add(isess, _chunks(session.chunks, to_jax))
    exp, outputs = src.export_handoff_finish(session)
    got += [o.token_id for o in outputs if o.token_id is not None]
    assert exp is not None and not src.has_work()
    tail = exp.kv_chunks[len(session.chunks):]
    dst.import_stream_commit(
        isess, convert(dataclasses.replace(exp, kv_chunks=tail), to_jax))
    drain(dst, got)
    assert got == want
    assert src.audit_pages() == [] and dst.audit_pages() == []


@pytest.mark.parametrize("wire", ["none", "int8"])
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_prefix_fetch_crosses_packages(jx, wire, direction):
    prompt = _prompt(20 + (wire == "int8") + 2 * (direction == "port->jax"))
    want = cold_run(jx, "ref", prompt, 6)
    hashes = chain_hashes(prompt, PS, max_pages=(len(prompt) - 1) // PS)
    if direction == "jax->port":
        src, dst, to_jax = jx, p_engine(), False
    else:
        src, dst, to_jax = p_engine(native_allocator=False), jx, True
    cold_run(src, "warm", prompt, 6)  # leaves the prompt's pages cached
    depth, chunks = src.export_prefix_chunks(hashes, chunk_pages=2,
                                             wire_quant=wire)
    assert depth == len(hashes)
    dst.evict_cache(0.0)
    assert dst.import_prefix(prompt[: depth * PS],
                             _chunks(chunks, to_jax)) == depth
    dst.add_request("probe", list(prompt), _sp(dst, 6))
    assert drain(dst, []) == want
    assert dst.audit_pages() == []


@pytest.mark.parametrize("wire", ["latent", "latent_int8"])
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_latent_handoff_crosses_packages(jlat, wire, direction):
    """A latent wire between engines whose codecs were each calibrated by
    their own package (projectors within 1e-4): the JAX engine's tokens."""
    prompt = _prompt(30 + (wire == "latent_int8") + 2 * (
        direction == "port->jax"), n=22)
    want = cold_run(jlat, "ref", prompt, 8)
    port = p_engine(scale=1.0, latent_rank=4)
    src, dst, to_jax = ((jlat, port, False) if direction == "jax->port"
                        else (port, jlat, True))
    got = prefill_ready(src, "r", prompt, 8)
    exp = src.export_handoff("r", wire_quant=wire)
    assert exp.wire_quant == wire
    dst.evict_cache(0.0)
    dst.import_sequence(convert(exp, to_jax))
    drain(dst, got)
    assert got == want
    assert src.audit_pages() == [] and dst.audit_pages() == []


def test_latent_projectors_agree_with_jax(jlat):
    port = p_engine(scale=1.0, latent_rank=4)
    for a, b in ((jlat.latent_codec.k_proj, port.latent_codec.k_proj),
                 (jlat.latent_codec.v_proj, port.latent_codec.v_proj)):
        pa = np.einsum("lkdr,lker->lkde", a, a)  # the projector P P^T
        pb = np.einsum("lkdr,lker->lkde", b, b)
        np.testing.assert_allclose(pb, pa, atol=1e-4)
    # the reset left nothing behind: a fresh engine's books and pools
    assert port.audit_pages() == [] and not port.has_work()
    assert port.cache_stats().pages_free == PAGED[0]
    assert not port.state.k.any() and not port.state.v.any()
    assert all(v == 0 for v in port.payload_byte_counters().values())


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_speculative_handoff_carries_the_draft_pool(jx, jspec, direction):
    prompt = _prompt(40 + (direction == "port->jax"))
    want = cold_run(jx, "ref", prompt, 12)  # greedy spec == plain
    port = p_engine(draft=True, decode_block_size=3)
    src, dst, to_jax = ((jspec, port, False) if direction == "jax->port"
                        else (port, jspec, True))
    got = prefill_ready(src, "r", prompt, 12)
    exp = src.export_handoff("r")
    assert exp.draft_kv is not None
    dst.evict_cache(0.0)
    dst.import_sequence(convert(exp, to_jax))
    drain(dst, got)
    assert got == want
    assert src.audit_pages() == [] and dst.audit_pages() == []
    # a plain engine refuses a payload with a draft half, and vice versa
    with pytest.raises(CacheDeserializationError, match="topology"):
        p_engine().import_sequence(convert(exp, False))
    plain = p_engine()
    got2 = prefill_ready(plain, "r2", prompt, 12)
    assert got2 == want[:1]
    with pytest.raises(CacheDeserializationError, match="topology"):
        port.import_sequence(plain.export_handoff("r2"))


# ---------------------------------------------------------------------------
# the port's engine cases (tests/test_disagg.py)
# ---------------------------------------------------------------------------


def test_export_import_token_identical(jx):
    prompt = _prompt(50)
    want = cold_run(jx, "ref", prompt, 10)
    pre, dec = p_engine(), p_engine()
    got = prefill_ready(pre, "r", prompt, 10)
    exp = pre.export_handoff("r")
    assert not pre.has_work()
    assert exp.seq_len == len(prompt) and exp.prompt_len == len(prompt)
    dec.import_sequence(exp)
    drain(dec, got)
    assert got == want
    # the source kept the prompt's full pages warm
    assert pre.cache_stats().pages_cached == len(prompt) // PS
    assert pre.audit_pages() == [] and dec.audit_pages() == []


def test_one_shot_chunked_import_sequence(jx):
    prompt = _prompt(51)
    want = cold_run(jx, "ref", prompt, 8)
    pre = p_engine()
    got = prefill_ready(pre, "r", prompt, 8)
    seq = pre._handoff_ready["r"]
    chunks = list(tkv.serialize_kv_chunks(pre.state, seq.block_table, PS,
                                          chunk_pages=2))
    chunks = [dataclasses.replace(c, total=len(chunks)) for c in chunks]
    exp = pre.export_handoff("r")
    dec = p_engine()
    dec.import_sequence(dataclasses.replace(exp, kv=b"", kv_chunks=chunks))
    assert drain(dec, list(got)) == want


def test_abort_of_handoff_ready_releases_pages():
    eng = p_engine()
    free0 = eng.allocator.num_free()
    eng.add_request("r", _prompt(52), SamplingParams(max_tokens=4,
                                                     temperature=0.0),
                    prefill_only=True)
    while not eng.handoff_ready_ids():
        eng.step()
    assert eng.allocator.num_free() < free0
    assert eng.audit_pages() == []
    assert eng.abort("r")
    assert eng.handoff_ready_ids() == [] and not eng.has_work()
    assert eng.allocator.num_free() == free0
    assert eng.export_handoff("r") is None


def test_import_refusals():
    eng = p_engine()
    exp = SequenceExport(
        request_id="req-1", token_ids=[1, 2, 3, 4, 5], prompt_len=5,
        seq_len=3, next_token=42,
        params=SamplingParams(max_tokens=16, temperature=0.0), output_text="",
        emitted_upto=0, emitted_tokens=1, pending_ids=[], kv=b"junk")
    with pytest.raises(CacheDeserializationError, match="decode boundary"):
        eng.import_sequence(exp)
    with pytest.raises(CacheDeserializationError, match="capacity"):
        eng.import_sequence(dataclasses.replace(
            exp, token_ids=list(range(200)), seq_len=200))
    free0 = eng.allocator.num_free()
    with pytest.raises(CacheDeserializationError):  # torn payload
        eng.import_sequence(dataclasses.replace(exp, seq_len=5))
    assert eng.allocator.num_free() == free0 and not eng.has_work()


def _streamed_src(prompt, max_tokens=96, **kw):
    src = p_engine(**kw)
    got = prefill_ready(src, "r", prompt, max_tokens)
    return src, got


def _collect(outs, got):
    for o in outs:
        assert o.error is None
        if o.token_id is not None:
            got.append(o.token_id)


def test_streamed_export_token_identical(jx):
    prompt = _prompt(53)
    want = cold_run(jx, "ref", prompt, 96)
    src, got = _streamed_src(prompt)
    dst = p_engine()
    session = src.export_handoff_begin("r", chunk_pages=2)
    assert session is not None
    _collect(src.step(), got)
    src.export_handoff_pump(session)
    isess = dst.import_stream_open("r", len(session.prefix_pages))
    dst.import_stream_add(isess, session.chunks)
    _collect(src.step(), got)
    exp, outputs = src.export_handoff_finish(session)
    assert exp is not None
    _collect(outputs, got)
    assert len(got) > 1, "no token decoded during the overlap window"
    assert not src.has_work()
    assert exp.stalled_at > 0 and exp.kv_bytes() > 0
    tail = exp.kv_chunks[len(session.chunks):]
    dst.import_stream_commit(isess, dataclasses.replace(exp, kv_chunks=tail))
    drain(dst, got)
    assert got == want
    assert src.audit_pages() == [] and dst.audit_pages() == []


def test_streamed_export_int8_wire(jx):
    prompt = _prompt(54)
    want = cold_run(jx, "ref", prompt, 96)
    src, got = _streamed_src(prompt)
    session = src.export_handoff_begin("r", chunk_pages=2, wire_quant="int8")
    _collect(src.step(), got)
    src.export_handoff_pump(session)
    exp, outputs = src.export_handoff_finish(session)
    assert exp is not None and exp.wire_quant == "int8"
    _collect(outputs, got)
    pages = sum(c.page_count for c in exp.kv_chunks)
    raw_bytes = (TINY.num_layers * pages * PS * TINY.num_kv_heads
                 * TINY.head_dim * 4 * 2)
    assert exp.kv_bytes() * 2 <= raw_bytes
    dst = p_engine()
    dst.import_sequence(exp)
    assert drain(dst, got) == want


def test_streamed_commit_with_empty_tail(jx):
    prompt = list(range(1, 33))  # 32 tokens: exactly 8 full pages
    want = cold_run(jx, "ref", prompt, 64)
    src, got = _streamed_src(prompt, 64)
    session = src.export_handoff_begin("r", chunk_pages=2)
    src.export_handoff_pump(session)  # no step: nothing decoded meanwhile
    assert all(c.total == 0 for c in session.chunks)
    dst = p_engine()
    isess = dst.import_stream_open("r", len(session.prefix_pages))
    dst.import_stream_add(isess, session.chunks)
    exp, outputs = src.export_handoff_finish(session)
    assert exp is not None and not outputs
    tail = exp.kv_chunks[len(session.chunks):]
    assert tail == []
    dst.import_stream_commit(isess, dataclasses.replace(exp, kv_chunks=tail))
    assert drain(dst, got) == want


def test_streamed_export_abort_midstream_releases_everything():
    src, _ = _streamed_src(_prompt(55))
    free0 = src.allocator.num_free()
    session = src.export_handoff_begin("r", chunk_pages=2)
    src.step()
    assert src.abort("r")
    src.export_handoff_pump(session)
    assert session.dead
    exp, _ = src.export_handoff_finish(session)
    assert exp is None and not src.has_work()
    assert src.allocator.num_free() >= free0
    assert src.audit_pages() == []


def test_streamed_export_refuses_short_budget():
    eng = p_engine()
    prefill_ready(eng, "r", _prompt(56), 10)
    assert eng.export_handoff_begin("r") is None
    assert eng.export_handoff("r") is not None


def test_import_commit_failure_releases_pages():
    src, _ = _streamed_src(_prompt(57))
    dst = p_engine()
    session = src.export_handoff_begin("r", chunk_pages=2)
    src.step()
    src.export_handoff_pump(session)
    free0 = dst.allocator.num_free()
    isess = dst.import_stream_open("r", len(session.prefix_pages))
    dst.import_stream_add(isess, session.chunks)
    assert dst.audit_pages(isess.pages) == []  # reserved, unpublished
    exp, _ = src.export_handoff_finish(session)
    with pytest.raises(CacheDeserializationError):
        dst.import_stream_commit(isess, dataclasses.replace(exp,
                                                            kv_chunks=[]))
    assert dst.allocator.num_free() == free0 and not dst.has_work()
    assert dst.audit_pages() == []


def test_streamed_export_overlap_under_loop(jx):
    """The sequence keeps decoding through looped blocks (cap 2) while its
    prefix serializes; the migrated decode gives the JAX fixed path's
    tokens (greedy looped == fixed)."""
    prompt = TOK.encode("the quick brown fox jumps over the lazy dog")
    want = cold_run(jx, "ref", prompt, 40)
    src, got = _streamed_src(prompt, 40, loop_to_completion=True,
                             loop_max_steps=2)
    dst = p_engine(loop_to_completion=True)
    session = src.export_handoff_begin("r", chunk_pages=2)
    assert session is not None
    _collect(src.step(), got)
    src.export_handoff_pump(session)
    isess = dst.import_stream_open("r", len(session.prefix_pages))
    dst.import_stream_add(isess, session.chunks)
    _collect(src.step(), got)
    exp, outputs = src.export_handoff_finish(session)
    assert exp is not None
    _collect(outputs, got)
    assert not src.has_work() and src.audit_pages() == []
    tail = exp.kv_chunks[len(session.chunks):]
    dst.import_stream_commit(isess, dataclasses.replace(exp, kv_chunks=tail))
    drain(dst, got)
    assert dst.audit_pages() == []
    assert got == want


# ---------------------------------------------------------------------------
# peer prefix fetch (tests/test_prefix_fetch.py)
# ---------------------------------------------------------------------------

PREFIX = list(range(40, 60))  # 5 full pages
PROMPT = PREFIX + [7, 8]
HASHES = chain_hashes(PROMPT, PS, max_pages=(len(PROMPT) - 1) // PS)


@pytest.fixture(scope="module")
def prompt_want(jx):
    return cold_run(jx, "ref", PROMPT, 6)


def _warm():
    warm = p_engine(native_allocator=False)
    cold_run(warm, "warm", PROMPT, 6)
    return warm


def test_peer_fetch_token_identity(prompt_want):
    warm = _warm()
    depth, chunks = warm.export_prefix_chunks(HASHES, chunk_pages=2)
    assert depth == len(HASHES)
    assert sum(c.page_count for c in chunks) == depth
    target = p_engine()
    assert target.import_prefix(PROMPT[: depth * PS], chunks) == depth
    s0 = target.cache_stats()
    assert s0.pages_cached == depth
    target.add_request("p", PROMPT, SamplingParams(max_tokens=6,
                                                   temperature=0.0))
    assert drain(target, []) == prompt_want
    assert target.cache_stats().hits > s0.hits
    assert target.audit_pages() == [] and warm.audit_pages() == []


def test_registry_staleness_partial_and_full_eviction():
    warm = _warm()
    depth, _ = warm.export_prefix_chunks(HASHES[:2] + [12345] + HASHES[3:])
    assert depth == 2  # consecutive from the head only
    warm.evict_cache(0.0, drop_host_tier=True)
    assert warm.export_prefix_chunks(HASHES) == (0, [])
    # the native tier addresses pages by its own hash: nothing to export
    native_warm = p_engine()
    assert native_warm.allocator_tier() == "native"
    cold_run(native_warm, "warm", PROMPT, 6)
    assert native_warm.export_prefix_chunks(HASHES) == (0, [])


def test_import_prefix_fuzz_reorder_truncation_crc(prompt_want):
    warm = _warm()
    depth, chunks = warm.export_prefix_chunks(HASHES, chunk_pages=1)
    assert len(chunks) == depth >= 3
    tokens = PROMPT[: depth * PS]
    shuffled = list(chunks)
    random.Random(7).shuffle(shuffled)
    tgt = p_engine()
    tgt.import_prefix(tokens, shuffled)
    tgt.add_request("p", PROMPT, SamplingParams(max_tokens=6,
                                                temperature=0.0))
    assert drain(tgt, []) == prompt_want

    def rejects(bad):
        eng = p_engine()
        with pytest.raises(CacheDeserializationError):
            eng.import_prefix(tokens, bad)
        s = eng.cache_stats()
        assert s.pages_free == s.pages_total
        assert eng.audit_pages() == []

    rejects(chunks[:-1])
    rejects([dataclasses.replace(chunks[0], crc32=chunks[0].crc32 ^ 1)]
            + chunks[1:])
    rejects([chunks[0]] + chunks)
    short = chunks[0].payload[:-4]
    rejects([dataclasses.replace(chunks[0], payload=short,
                                 crc32=zlib.crc32(short) & 0xFFFFFFFF)]
            + chunks[1:])


def test_import_prefix_validation():
    eng = p_engine()
    with pytest.raises(CacheDeserializationError):
        eng.import_prefix(PREFIX[:3], [])
    with pytest.raises(CacheDeserializationError):
        eng.import_prefix([], [])
    with pytest.raises(CacheDeserializationError, match="draft"):
        p_engine(draft=True).import_prefix(PREFIX[:4], [])


def test_digest_depth_configurable():
    prompt = list(range(48)) + [7, 8]  # 12 full pages
    eng = p_engine(native_allocator=False)
    cold_run(eng, "s", prompt, 2)
    hashes = chain_hashes(prompt, PS, max_pages=12)
    assert sum(h in eng.prefix_digest() for h in hashes) == DIGEST_DEPTH
    assert sum(h in eng.prefix_digest(4) for h in hashes) == 4
    assert sum(h in eng.prefix_digest(16) for h in hashes) == 12


# ---------------------------------------------------------------------------
# the latent wire on engines (tests/test_latent_kv.py TestEngineE2E)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["latent", "latent_int8"])
def test_latent_handoff_token_identity_and_bytes(jlat, wire):
    prompt = _prompt(60 + (wire == "latent_int8"), n=22)
    want = cold_run(jlat, "ref", prompt, 8)
    src = p_engine(scale=1.0, latent_rank=4)
    got = prefill_ready(src, "r", prompt, 8)
    exp = src.export_handoff("r", wire_quant=wire)
    src2 = p_engine(scale=1.0, latent_rank=4)
    prefill_ready(src2, "r", prompt, 8)
    exp8 = src2.export_handoff("r", wire_quant="int8")
    assert len(exp8.kv) >= 2 * len(exp.kv)
    dst = p_engine(scale=1.0, latent_rank=4)
    dst.import_sequence(exp)
    assert drain(dst, got) == want
    assert src.audit_pages() == [] and dst.audit_pages() == []
    assert src.payload_byte_counters()[wire] == len(exp.kv)
    stats = src.latent_stats()
    assert stats["rank"] == 4 and stats["saved_bytes"] > 0


def test_latent_peer_fetch_token_identity(jlat):
    prompt = _prompt(62, n=22)
    want = cold_run(jlat, "ref", prompt, 6)
    hashes = chain_hashes(prompt, PS, max_pages=(len(prompt) - 1) // PS)
    warm = p_engine(scale=1.0, latent_rank=4, native_allocator=False)
    cold_run(warm, "warm", prompt, 6)
    depth, chunks = warm.export_prefix_chunks(hashes, chunk_pages=2,
                                              wire_quant="latent")
    assert depth == len(hashes)
    _, chunks8 = warm.export_prefix_chunks(hashes, chunk_pages=2,
                                           wire_quant="int8")
    assert sum(len(c.payload) for c in chunks8) >= 2 * sum(
        len(c.payload) for c in chunks)
    target = p_engine(scale=1.0, latent_rank=4)
    assert target.import_prefix(prompt[: depth * PS], chunks) == depth
    target.add_request("p", prompt, SamplingParams(max_tokens=6,
                                                   temperature=0.0))
    assert drain(target, []) == want
    assert target.audit_pages() == [] and warm.audit_pages() == []


def test_quantpool_engine_gates_codec_off():
    eng = p_engine(kv_quant="int8", latent_rank=4)
    assert eng.latent_codec is None and eng.latent_stats() is None
    prompt = _prompt(63)
    want = cold_run(eng, "a", prompt, 6)
    src = p_engine(kv_quant="int8", latent_rank=4)
    got = prefill_ready(src, "r", prompt, 6)
    exp = src.export_handoff("r", wire_quant="latent")
    assert exp.wire_quant == "latent"  # native codes pass through
    assert src.payload_byte_counters()["qpool"] == len(exp.kv)
    dst = p_engine(kv_quant="int8")
    dst.import_sequence(exp)
    assert drain(dst, got) == want
    assert src.audit_pages() == [] and dst.audit_pages() == []


def test_no_codec_degrades_to_raw_wire():
    src = p_engine()
    assert src.latent_codec is None
    prefill_ready(src, "r", _prompt(64), 6)
    exp = src.export_handoff("r", wire_quant="latent")
    assert exp is not None and exp.wire_quant == "none"
    p_engine().import_sequence(exp)
    assert src.audit_pages() == []


def test_engine_config_validation():
    for kw in (dict(host_tier_bytes=-1), dict(host_tier_quant="fp4"),
               dict(latent_rank=-1), dict(latent_rank=TINY.head_dim + 1)):
        with pytest.raises(ValueError):
            p_engine(**kw)
    with pytest.raises(RuntimeError, match="offload hook"):
        p_engine(host_tier_bytes=1 << 20, native_allocator=True)
    assert p_engine(native_allocator=False).allocator_tier() == "python"
    assert p_engine(host_tier_bytes=1 << 20).allocator_tier() == "python"
