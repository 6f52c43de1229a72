"""The port's KV byte paths against the JAX package's, byte for byte.

The same pool contents (drawn from a seed with numpy) and page ids go
through both packages' codecs:

- raw f32 and bf16 pools, the ``int8`` wire and ``QuantPool`` pools give
  byte-identical ``serialize_kv`` and ``serialize_kv_chunks`` payloads
  (bf16 as the raw 2-byte words ml_dtypes writes), and each package
  decodes the other's payloads to the same pool values;
- latent payloads have identical headers and decode within 1e-5 of each
  other (the f32 einsum orders differ);
- ``LatentCodec.calibrate`` on the same samples is bit-identical;
- the cases of ``tests/test_disagg.py`` (round trips and refusals of the
  payload, ``deserialize_into_allocator``, ``KvImportSession``) and
  ``tests/test_latent_kv.py`` (the codec's units and chunk validation)
  run against the port;
- the port's native allocator against its Python allocator on one random
  operation sequence, and its prefix reuse (``tests/test_native.py``),
  where g++ is present.
"""

import dataclasses
import zlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.engine import kv_cache as jkv
from distributed_inference_server_tpu.models.configs import TINY as J_TINY
from distributed_inference_server_tpu.ops.quant import QuantPool as JQuantPool
from distributed_inference_server_tpu_torch import native
from distributed_inference_server_tpu_torch.core.errors import (
    CacheDeserializationError,
    CacheFull,
)
from distributed_inference_server_tpu_torch.engine import kv_cache as tkv
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    _KIND_QPOOL,
    KvImportSession,
    LatentCodec,
    PageAllocator,
    PagedCacheConfig,
    PagedKVState,
    default_latent_rank,
    deserialize_into_allocator,
    deserialize_kv,
    encoded_page_fraction,
    payload_kind,
    serialize_kv,
    serialize_kv_chunks,
)
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.ops.quant import QuantPool

PS = 4
D = TINY.head_dim
CFG = PagedCacheConfig(num_pages=16, page_size=PS, max_pages_per_seq=8)
J_CFG = jkv.PagedCacheConfig(num_pages=16, page_size=PS, max_pages_per_seq=8)
N_SLOTS = CFG.num_pages * PS
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(dtype="float32", kv_quant="none", seed=0, values=None):
    """The same pool contents in both packages: (jax state, port state).
    ``values``: optional (k, v) f32 arrays [L, slots, KV, D]."""
    rng = np.random.default_rng(seed)
    shape = (TINY.num_layers, N_SLOTS, TINY.num_kv_heads, D)
    if kv_quant == "int8":
        parts = [rng.integers(-127, 127, shape, np.int8),
                 rng.random(shape[:-1], np.float32),
                 rng.integers(-127, 127, shape, np.int8),
                 rng.random(shape[:-1], np.float32)]
        js = jkv.PagedKVState(JQuantPool(*map(jnp.asarray, parts[:2])),
                              JQuantPool(*map(jnp.asarray, parts[2:])))
        drop = [np.zeros((p.shape[0], 1) + p.shape[2:], p.dtype)
                for p in parts]
        tp = [torch.from_numpy(np.concatenate([p, d], 1))
              for p, d in zip(parts, drop)]
        return js, PagedKVState(QuantPool(*tp[:2]), QuantPool(*tp[2:]))
    if values is None:
        values = (rng.standard_normal(shape, np.float32),
                  rng.standard_normal(shape, np.float32))
    pools = []
    for a in values:
        host = a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a
        pools.append(host)
    js = jkv.PagedKVState(*(jnp.asarray(p) for p in pools))

    def port(p):
        t = (torch.from_numpy(p.view(np.int16)).view(torch.bfloat16)
             if dtype == "bfloat16" else torch.from_numpy(p))
        return torch.cat([t, torch.zeros_like(t[:, :1])], 1)  # drop slot

    return js, PagedKVState(*(port(p) for p in pools))


def _port_values(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _fresh(dtype="float32", kv_quant="none"):
    return PagedKVState.create(TINY, CFG, dtype=TORCH_DT[dtype],
                               device="cpu", kv_quant=kv_quant)


def _slots(pages):
    return np.concatenate([np.arange(p * PS, (p + 1) * PS) for p in pages])


def _latent_values(rng, rank):
    """K/V in a rank-``rank`` subspace per (layer, kv-head), and the codec
    calibrated on them (the JAX test's ``_latent_state``)."""
    L, KV = TINY.num_layers, TINY.num_kv_heads
    basis_k = rng.standard_normal((L, KV, D, rank))
    basis_v = rng.standard_normal((L, KV, D, rank))
    k = np.einsum("lskr,lkdr->lskd",
                  rng.standard_normal((L, N_SLOTS, KV, rank)), basis_k)
    v = np.einsum("lskr,lkdr->lskd",
                  rng.standard_normal((L, N_SLOTS, KV, rank)), basis_v)
    return k.astype(np.float32), v.astype(np.float32)


def _latent_state(rng, rank, dtype="float32"):
    k, v = _latent_values(rng, rank)
    _, state = _pair(dtype, values=(k, v))
    return state, LatentCodec.calibrate(k, v, rank)


def _with_totals(chunks):
    return [dataclasses.replace(c, total=len(chunks)) for c in chunks]


# ---------------------------------------------------------------------------
# byte identity with the JAX package
# ---------------------------------------------------------------------------

CASES = [("float32", "none", "none"), ("bfloat16", "none", "none"),
         ("float32", "none", "int8"), ("bfloat16", "none", "int8"),
         ("float32", "int8", "none")]


@pytest.mark.parametrize("dtype,kv_quant,wire", CASES)
def test_serialize_byte_identical_to_jax(dtype, kv_quant, wire):
    js, ts = _pair(dtype, kv_quant)
    pages = [3, 7, 1]
    want = jkv.serialize_kv(js, pages, PS, 10, wire_quant=wire)
    assert serialize_kv(ts, pages, PS, 10, wire_quant=wire) == want
    jc = list(jkv.serialize_kv_chunks(js, [3, 7, 1, 4, 9], PS,
                                      chunk_pages=2, wire_quant=wire,
                                      first_chunk_index=1,
                                      first_page_index=2))
    tc = list(serialize_kv_chunks(ts, [3, 7, 1, 4, 9], PS, chunk_pages=2,
                                  wire_quant=wire, first_chunk_index=1,
                                  first_page_index=2))
    assert [dataclasses.astuple(c) for c in tc] == [
        dataclasses.astuple(c) for c in jc]


@pytest.mark.parametrize("dtype,kv_quant,wire", CASES)
def test_payloads_cross_decode(dtype, kv_quant, wire):
    """Each package restores the other's payload to the same values."""
    js, ts = _pair(dtype, kv_quant, seed=1)
    pages, dst = [2, 5], [6, 0]
    from_jax = jkv.serialize_kv(js, pages, PS, 8, wire_quant=wire)
    from_port = serialize_kv(ts, pages, PS, 8, wire_quant=wire)
    port_in = _fresh(dtype, kv_quant)
    deserialize_kv(port_in, from_jax, dst, PS)
    jax_in = jkv.PagedKVState.create(J_TINY, J_CFG, dtype=JAX_DT[dtype],
                                     kv_quant=kv_quant)
    jax_in, n = jkv.deserialize_kv(jax_in, from_port, dst, PS)
    assert n == 8
    sl = _slots(dst)
    if kv_quant == "int8":
        for j, t in ((jax_in.k.data, port_in.k.data),
                     (jax_in.k.scale, port_in.k.scale),
                     (jax_in.v.data, port_in.v.data)):
            np.testing.assert_array_equal(np.asarray(j)[:, sl],
                                          t[:, sl].numpy())
    else:
        for j, t in ((jax_in.k, port_in.k), (jax_in.v, port_in.v)):
            np.testing.assert_array_equal(
                np.asarray(j[:, sl].astype(jnp.float32)),
                _port_values(t[:, sl]))


@pytest.mark.parametrize("wire", ["latent", "latent_int8"])
def test_latent_payload_headers_identical_values_close(wire):
    k, v = _latent_values(np.random.default_rng(4), 4)
    js, ts = _pair(values=(k, v))
    jcodec = jkv.LatentCodec.calibrate(k, v, 4)
    tcodec = LatentCodec.calibrate(k, v, 4)
    pages = [1, 4, 2]
    jb = jkv.serialize_kv(js, pages, PS, 12, wire_quant=wire, codec=jcodec)
    tb = serialize_kv(ts, pages, PS, 12, wire_quant=wire, codec=tcodec)
    head = 4 + 2 + len("float32") + 24 + 1  # magic..dims, flags byte
    assert len(tb) == len(jb) and tb[:head] == jb[:head]
    dst = [0, 3, 5]
    port_in = _fresh()
    deserialize_kv(port_in, jb, dst, PS, codec=tcodec)
    jax_in = jkv.PagedKVState.create(J_TINY, J_CFG, dtype=jnp.float32)
    jax_in, _ = jkv.deserialize_kv(jax_in, tb, dst, PS, codec=jcodec)
    sl = _slots(dst)
    np.testing.assert_allclose(port_in.k[:, sl].numpy(),
                               np.asarray(jax_in.k)[:, sl], atol=1e-5)
    np.testing.assert_allclose(port_in.v[:, sl].numpy(),
                               np.asarray(jax_in.v)[:, sl], atol=1e-5)


def test_latent_calibration_bit_identical_to_jax():
    rng = np.random.default_rng(2)
    k = rng.standard_normal((2, 24, 2, D))
    v = rng.standard_normal((2, 24, 2, D))
    # a rank past the samples' span takes the QR completion
    low = np.repeat(rng.standard_normal((2, 3, 2, D)), 8, axis=1)
    for ks, vs, rank in ((k, v, 4), (k, v, D), (low, low, 5)):
        a = jkv.LatentCodec.calibrate(ks, vs, rank)
        b = LatentCodec.calibrate(ks, vs, rank)
        assert np.array_equal(a.k_proj, b.k_proj)
        assert np.array_equal(a.v_proj, b.v_proj)


def test_kvchunk_crc_and_constants_match_jax():
    assert tkv.WIRE_QUANTS == jkv.WIRE_QUANTS
    assert tkv.LATENT_QUANTS == jkv.LATENT_QUANTS
    assert tkv.DIGEST_DEPTH == jkv.DIGEST_DEPTH
    assert tkv.chunk_crc(b"kv-bytes") == jkv.chunk_crc(b"kv-bytes")
    for wq in jkv.WIRE_QUANTS:
        assert encoded_page_fraction(wq, 2, 64, 16) == \
            jkv.encoded_page_fraction(wq, 2, 64, 16)
    assert [f.name for f in dataclasses.fields(tkv.KvChunk)] == [
        f.name for f in dataclasses.fields(jkv.KvChunk)]


# ---------------------------------------------------------------------------
# round trips and refusals (tests/test_disagg.py TestKvRoundTrip)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roundtrip_exact(dtype):
    _, state = _pair(dtype)
    pages = [3, 7, 1]
    blob = serialize_kv(state, pages, PS, token_count=10)
    fresh = _fresh(dtype)
    restored, n = deserialize_kv(fresh, blob, pages, PS)
    assert n == 10 and restored is fresh  # written in place
    sl = torch.from_numpy(_slots(pages))
    assert torch.equal(restored.k[:, sl], state.k[:, sl])
    assert torch.equal(restored.v[:, sl], state.v[:, sl])


def test_roundtrip_int8_quantized():
    _, state = _pair(kv_quant="int8")
    pages = [2, 5]
    blob = serialize_kv(state, pages, PS, token_count=8)
    fresh = _fresh(kv_quant="int8")
    _, n = deserialize_kv(fresh, blob, pages, PS)
    assert n == 8
    sl = torch.from_numpy(_slots(pages))
    assert torch.equal(fresh.k.data[:, sl], state.k.data[:, sl])
    assert torch.equal(fresh.k.scale[:, sl], state.k.scale[:, sl])


def test_quantized_payload_into_float_pool_rejected():
    _, state = _pair(kv_quant="int8")
    blob = serialize_kv(state, [0], PS, token_count=4)
    with pytest.raises(CacheDeserializationError):
        deserialize_kv(_fresh(), blob, [0], PS)


def test_deserialize_into_allocator_registers_prefix():
    _, state = _pair()
    alloc = PageAllocator(CFG)
    tokens = list(range(1, 9))  # 8 tokens = 2 full pages
    src = alloc.allocate(2)
    alloc.publish(tokens, src)
    blob = serialize_kv(state, src, PS, token_count=8)
    alloc2 = PageAllocator(CFG)
    _, pages = deserialize_into_allocator(state, alloc2, blob, tokens, PS)
    assert len(pages) == 2
    shared, matched = alloc2.match_prefix(tokens + [99])
    assert matched == 8 and shared == list(pages)
    alloc2.release(shared)


def test_deserialize_into_allocator_no_leak_on_failure():
    _, state = _pair()
    alloc = PageAllocator(CFG)
    blob = serialize_kv(state, [0, 1], PS, token_count=8)
    free_before = alloc.num_free()
    with pytest.raises(CacheDeserializationError):
        deserialize_into_allocator(state, alloc, blob, list(range(12)), PS)
    assert alloc.num_free() == free_before


def test_deserialize_into_allocator_cache_full():
    _, state = _pair()
    alloc = PageAllocator(CFG)
    held = alloc.allocate(CFG.num_pages)
    blob = serialize_kv(state, [0], PS, token_count=4)
    with pytest.raises(CacheFull):
        deserialize_into_allocator(state, alloc, blob, [1, 2, 3, 4], PS)
    alloc.release(held)


def test_torn_payloads_rejected():
    _, state = _pair()
    blob = serialize_kv(state, [0, 1], PS, token_count=8)
    for bad in (b"KVP2" + blob[4:], blob[:-3], blob + b"\0"):
        with pytest.raises(CacheDeserializationError):
            deserialize_kv(_fresh(), bad, [0, 1], PS)
    with pytest.raises(CacheDeserializationError, match="page count"):
        deserialize_kv(_fresh(), blob, [0, 1, 2], PS)


# ---------------------------------------------------------------------------
# streamed payloads and the import session (TestStreamedKv)
# ---------------------------------------------------------------------------


def test_serialize_roundtrip_byte_identical():
    _, state = _pair()
    pages = [3, 7, 1]
    blob = serialize_kv(state, pages, PS, token_count=10)
    fresh = _fresh()
    deserialize_kv(fresh, blob, pages, PS)
    assert serialize_kv(fresh, pages, PS, 10) == blob


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_roundtrip_any_order(dtype):
    _, state = _pair(dtype)
    pages = [3, 7, 1, 4, 9]
    chunks = _with_totals(list(serialize_kv_chunks(state, pages, PS,
                                                   chunk_pages=2)))
    assert [c.page_start for c in chunks] == [0, 2, 4]
    alloc = PageAllocator(CFG)
    fresh = _fresh(dtype)
    sess = KvImportSession(fresh, alloc, PS)
    sess.reserve(len(pages))
    for c in reversed(chunks):
        sess.add_chunk(c)
    tokens = list(range(1, len(pages) * PS + 1))
    restored, got = sess.finish(fresh, tokens)
    src, dst = (torch.from_numpy(_slots(p)) for p in (pages, got))
    assert torch.equal(restored.k[:, dst], state.k[:, src])
    assert torch.equal(restored.v[:, dst], state.v[:, src])
    shared, matched = alloc.match_prefix(tokens + [999])
    assert matched == len(tokens) and shared == got


def test_wire_quant_int8_halves_bytes_and_bounds_error():
    _, state = _pair()
    pages = [0, 1, 2, 3]
    raw = serialize_kv(state, pages, PS, 16)
    quant = serialize_kv(state, pages, PS, 16, wire_quant="int8")
    assert len(raw) >= 2 * len(quant)
    fresh = _fresh()
    deserialize_kv(fresh, quant, pages, PS)
    sl = torch.from_numpy(_slots(pages))
    orig, got = state.k[:, sl].numpy(), fresh.k[:, sl].numpy()
    bound = np.abs(orig).max(-1, keepdims=True) / 127.0 * 0.51 + 1e-7
    assert (np.abs(got - orig) <= bound).all()


def test_import_session_crc_corruption_rejected():
    _, state = _pair()
    chunks = _with_totals(list(serialize_kv_chunks(state, [0, 1], PS,
                                                   chunk_pages=1)))
    bad = dataclasses.replace(
        chunks[0], payload=chunks[0].payload[:-1]
        + bytes([chunks[0].payload[-1] ^ 0x55]))
    alloc = PageAllocator(CFG)
    sess = KvImportSession(state, alloc, PS)
    sess.reserve(2)
    free_before = alloc.num_free()
    with pytest.raises(CacheDeserializationError, match="crc"):
        sess.add_chunk(bad)
    sess.abort()
    assert alloc.num_free() == free_before + 2


def test_import_session_missing_chunk_releases_everything():
    _, state = _pair()
    chunks = _with_totals(list(serialize_kv_chunks(state, [0, 1, 2], PS,
                                                   chunk_pages=1)))
    alloc = PageAllocator(CFG)
    total_free = alloc.num_free()
    sess = KvImportSession(state, alloc, PS)
    sess.reserve(3)
    sess.add_chunk(chunks[0])
    sess.add_chunk(chunks[2])
    with pytest.raises(CacheDeserializationError, match="incomplete"):
        sess.finish(state, list(range(12)))
    sess.abort()
    assert alloc.num_free() == total_free


def test_import_session_duplicate_and_overlap_rejected():
    _, state = _pair()
    chunks = _with_totals(list(serialize_kv_chunks(state, [0, 1], PS,
                                                   chunk_pages=1)))
    sess = KvImportSession(state, PageAllocator(CFG), PS)
    sess.reserve(2)
    sess.add_chunk(chunks[0])
    with pytest.raises(CacheDeserializationError, match="duplicate"):
        sess.add_chunk(chunks[0])
    sess.abort()
    sess2 = KvImportSession(state, PageAllocator(CFG), PS)
    sess2.reserve(2)
    sess2.add_chunk(chunks[0])
    sess2.add_chunk(dataclasses.replace(chunks[1], page_start=0, index=1))
    with pytest.raises(CacheDeserializationError, match="tile"):
        sess2.finish(state, list(range(8)))
    sess2.abort()


# ---------------------------------------------------------------------------
# the latent codec (tests/test_latent_kv.py TestCodecUnit and
# TestLatentChunkValidation)
# ---------------------------------------------------------------------------


def test_calibrate_shapes_and_orthonormal():
    rng = np.random.default_rng(1)
    L, KV, rank = TINY.num_layers, TINY.num_kv_heads, 4
    codec = LatentCodec.calibrate(rng.standard_normal((L, 24, KV, D)),
                                  rng.standard_normal((L, 24, KV, D)), rank)
    assert codec.rank == rank and codec.head_dim == D
    assert codec.k_proj.shape == (L, KV, D, rank)
    for proj in (codec.k_proj, codec.v_proj):
        gram = np.einsum("lkdr,lkds->lkrs", proj, proj)
        np.testing.assert_allclose(
            gram, np.broadcast_to(np.eye(rank), gram.shape), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [2, 4, 8])
@pytest.mark.parametrize("n_pages", [1, 3, 5])
def test_latent_roundtrip_error_bounded(dtype, rank, n_pages):
    state, codec = _latent_state(np.random.default_rng(rank), rank, dtype)
    pages = list(range(2, 2 + n_pages))
    blob = serialize_kv(state, pages, PS, n_pages * PS, wire_quant="latent",
                        codec=codec)
    fresh = _fresh(dtype)
    deserialize_kv(fresh, blob, pages, PS, codec=codec)
    sl = torch.from_numpy(_slots(pages))
    orig, got = _port_values(state.k[:, sl]), _port_values(fresh.k[:, sl])
    tol = 0.02 if dtype == "bfloat16" else 2e-3
    assert np.abs(got - orig).max() <= tol * (np.abs(orig).max() + 1e-6)


def test_latent_int8_roundtrip_bounded():
    state, codec = _latent_state(np.random.default_rng(7), 4)
    blob = serialize_kv(state, [1, 2], PS, 8, wire_quant="latent_int8",
                        codec=codec)
    fresh = _fresh()
    deserialize_kv(fresh, blob, [1, 2], PS, codec=codec)
    sl = torch.arange(PS, 3 * PS)
    orig, got = state.k[:, sl].numpy(), fresh.k[:, sl].numpy()
    assert np.abs(got - orig).max() <= 0.05 * (np.abs(orig).max() + 1e-6)


def test_latent_bytes_beat_int8_by_2x():
    state, codec = _latent_state(np.random.default_rng(3),
                                 default_latent_rank(D))
    pages = [0, 1, 2, 3]
    int8 = serialize_kv(state, pages, PS, 16, wire_quant="int8")
    latent = serialize_kv(state, pages, PS, 16, wire_quant="latent",
                          codec=codec)
    latent8 = serialize_kv(state, pages, PS, 16, wire_quant="latent_int8",
                           codec=codec)
    assert len(int8) >= 2 * len(latent) and len(latent8) <= len(latent)
    state8, codec8 = _latent_state(np.random.default_rng(4), 8)
    wide = serialize_kv(state8, pages, PS, 16, wire_quant="latent",
                        codec=codec8)
    wide8 = serialize_kv(state8, pages, PS, 16, wire_quant="latent_int8",
                         codec=codec8)
    assert len(wide8) < len(wide)


def test_encoded_page_fraction_and_default_rank():
    assert encoded_page_fraction("none", 4, D) == 1.0
    assert encoded_page_fraction("int8", 4, D) == pytest.approx(0.3125)
    assert encoded_page_fraction("latent", 4, D, 4) == pytest.approx(0.125)
    assert encoded_page_fraction("latent_int8", 4, D, 4) == pytest.approx(
        0.125)
    assert (default_latent_rank(16), default_latent_rank(128),
            default_latent_rank(4)) == (4, 32, 2)


def test_quantpool_pass_through_decision():
    _, state = _pair(kv_quant="int8")
    assert payload_kind(state.k, "latent") == _KIND_QPOOL
    assert payload_kind(state.k, "latent_int8") == _KIND_QPOOL
    blob = serialize_kv(state, [0, 1], PS, 8, wire_quant="latent")
    fresh = _fresh(kv_quant="int8")
    deserialize_kv(fresh, blob, [0, 1], PS)
    sl = torch.arange(2 * PS)
    assert torch.equal(fresh.k.data[:, sl], state.k.data[:, sl])
    assert torch.equal(fresh.k.scale[:, sl], state.k.scale[:, sl])


def test_latent_refusals():
    state, codec4 = _latent_state(np.random.default_rng(5), 4)
    with pytest.raises(ValueError, match="codec"):
        serialize_kv(state, [0], PS, 4, wire_quant="latent")
    blob = serialize_kv(state, [0], PS, 4, wire_quant="latent", codec=codec4)
    with pytest.raises(CacheDeserializationError, match="LatentCodec"):
        deserialize_kv(_fresh(), blob, [0], PS)
    k = np.random.default_rng(6).standard_normal(
        (TINY.num_layers, 16, TINY.num_kv_heads, D))
    with pytest.raises(CacheDeserializationError, match="rank"):
        deserialize_kv(_fresh(), blob, [0], PS,
                       codec=LatentCodec.calibrate(k, k, 8))
    with pytest.raises(CacheDeserializationError):
        deserialize_kv(_fresh(kv_quant="int8"), blob, [0], PS, codec=codec4)


def _latent_chunks(wire_quant="latent"):
    state, codec = _latent_state(np.random.default_rng(9), 4)
    pages = [3, 7, 1, 4]
    chunks = _with_totals(list(serialize_kv_chunks(
        state, pages, PS, chunk_pages=1, wire_quant=wire_quant,
        codec=codec)))
    return state, codec, pages, chunks


@pytest.mark.parametrize("wire_quant", ["latent", "latent_int8"])
def test_latent_chunks_reorder_seats_identically(wire_quant):
    state, codec, pages, chunks = _latent_chunks(wire_quant)
    fresh = _fresh()
    sess = KvImportSession(fresh, PageAllocator(CFG), PS, codec=codec)
    sess.reserve(len(pages))
    for c in reversed(chunks):
        sess.add_chunk(c)
    restored, got = sess.finish(fresh, list(range(len(pages) * PS)))
    src, dst = (torch.from_numpy(_slots(p)) for p in (pages, got))
    err = (restored.k[:, dst] - state.k[:, src]).abs().max()
    assert err <= 0.05 * state.k.abs().max()


def test_latent_truncated_and_corrupt_chunks_release_everything():
    _, codec, pages, chunks = _latent_chunks()

    def rejects(bad):
        alloc = PageAllocator(CFG)
        free0 = alloc.num_free()
        fresh = _fresh()
        sess = KvImportSession(fresh, alloc, PS, codec=codec)
        sess.reserve(len(pages))
        with pytest.raises(CacheDeserializationError):
            for c in bad:
                sess.add_chunk(c)
            sess.finish(fresh, list(range(len(pages) * PS)))
        sess.abort()
        assert alloc.num_free() == free0

    rejects(chunks[:-1])
    rejects([dataclasses.replace(chunks[0], crc32=chunks[0].crc32 ^ 1)]
            + chunks[1:])
    cut = chunks[0].payload[: len(chunks[0].payload) // 2]
    rejects([dataclasses.replace(chunks[0], payload=cut,
                                 crc32=zlib.crc32(cut) & 0xFFFFFFFF)]
            + chunks[1:])
    rejects([chunks[0]] + chunks)


def test_codecless_session_rejects_kind3():
    _, _, pages, chunks = _latent_chunks()
    alloc = PageAllocator(CFG)
    free0 = alloc.num_free()
    sess = KvImportSession(_fresh(), alloc, PS)
    sess.reserve(len(pages))
    with pytest.raises(CacheDeserializationError, match="LatentCodec"):
        sess.add_chunk(chunks[0])
    sess.abort()
    assert alloc.num_free() == free0


def test_latent_codec_save_load(tmp_path):
    _, codec = _latent_state(np.random.default_rng(8), 4)
    path = str(tmp_path / "codec.npz")
    codec.save(path)
    back = LatentCodec.load(path)
    assert np.array_equal(back.k_proj, codec.k_proj)
    # the JAX package reads the same keys
    assert np.array_equal(jkv.LatentCodec.load(path).v_proj, codec.v_proj)


# ---------------------------------------------------------------------------
# the port's native allocator (tests/test_native.py)
# ---------------------------------------------------------------------------

needs_native = pytest.mark.skipif(
    not native.available(), reason="no C++ compiler (g++) to build the "
    "port's native library")


@needs_native
def test_allocator_differential_random_ops():
    import random

    cfg = PagedCacheConfig(num_pages=24, page_size=4, max_pages_per_seq=8)
    py = PageAllocator(cfg)
    cc = native.NativePageAllocator(cfg)
    rnd = random.Random(1)
    held_py, held_cc = [], []
    for step in range(2000):
        op = rnd.random()
        if op < 0.35:
            n_tokens = rnd.randint(1, 28)
            tokens = [rnd.randint(0, 5) for _ in range(n_tokens)]
            res = []
            for impl, held in ((py, held_py), (cc, held_cc)):
                shared, matched = impl.match_prefix(tokens)
                needed = -(-n_tokens // cfg.page_size) - len(shared)
                try:
                    fresh = impl.allocate(needed)
                    impl.publish(tokens, shared + fresh)
                    held.append((tokens, shared + fresh))
                    res.append(("ok", shared, matched, fresh))
                except CacheFull:
                    impl.release(shared)
                    res.append(("full", shared, matched, None))
            assert res[0] == res[1], f"admit diverged at step {step}"
        elif op < 0.75 and held_py:
            i = rnd.randrange(len(held_py))
            py.release(held_py.pop(i)[1])
            cc.release(held_cc.pop(i)[1])
        elif op < 0.85 and held_py:
            i = rnd.randrange(len(held_py))
            py.touch(held_py[i][1])
            cc.touch(held_cc[i][1])
        elif op < 0.95:
            frac = rnd.random()
            assert py.evict_below(frac) == cc.evict_below(frac)
        else:
            assert py.num_free() == cc.num_free()
        s_py, s_cc = py.stats(), cc.stats()
        assert vars(s_py) == vars(s_cc), f"stats diverged at step {step}"
        if step % 100 == 0:  # both audits clean with the live holders
            live = [p for _, pages in held_py for p in pages]
            assert py.audit(live) == [] and cc.audit(live) == []


@needs_native
def test_allocator_prefix_reuse_native():
    cfg = PagedCacheConfig(num_pages=16, page_size=4, max_pages_per_seq=8)
    a = native.NativePageAllocator(cfg)
    tokens = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    assert a.match_prefix(tokens) == ([], 0)
    fresh = a.allocate(3)
    a.publish(tokens, fresh)
    shared2, matched2 = a.match_prefix(tokens)
    assert shared2 == fresh[:2] and matched2 == 8
    a.release(shared2)
    a.release(fresh)
    assert a.num_free() == cfg.num_pages
    assert a.audit([]) == []


@needs_native
def test_native_audit_finds_a_leak():
    a = native.NativePageAllocator(CFG)
    held = a.allocate(3)
    a.publish(list(range(12)), held)
    assert a.audit(held) == []
    issues = a.audit(held[:2])  # one reference nobody holds
    assert any("leaked" in i or "no live holder" in i for i in issues)
