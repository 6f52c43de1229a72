"""A tensor-parallel engine's bytes and vectors, the entry point over a
mesh, and the entry point's mesh refusals (CPU, float32).

- Bytes: a handoff payload and a prefix export from a tensor 2 engine
  equal an unsharded engine's byte for byte (raw, int8 wire, int8 pools);
  the payload imports into a tensor 2 engine and decodes the unsharded
  tokens; the host tier demotes and reloads through the global view;
  embeddings equal.
- Served: ``--engine-tensor-parallel 2 --device cpu`` (the suite's 8
  virtual CPU devices) answers over HTTP with the unsharded engine's
  texts.
- Refusals: ``context_parallel`` with ``pipeline_parallel``, a draft with
  ``pipeline_parallel`` exit 2 with ``config error:``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PagedCacheConfig,
    chain_hashes,
    serialize_kv,
)
from distributed_inference_server_tpu_torch.models import configs, llama
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)
from distributed_inference_server_tpu_torch.parallel.mesh import tp_mesh

ROOT = Path(__file__).resolve().parents[1]
TOK = ByteTokenizer()
PS = 4
PROMPT = list(b"a prompt whose pages move between engines, byte for byte")


@pytest.fixture(scope="module")
def params():
    p = llama.init_params(configs.TINY, torch.Generator().manual_seed(3),
                          dtype=torch.float32, device="cpu")
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        p["layers"][k] = p["layers"][k] * 8
    return p


def _engine(params, tp=1, **kw):
    mesh = tp_mesh(tp, devices=[torch.device("cpu")] * tp) if tp > 1 \
        else None
    return LLMEngine(params, configs.TINY, TOK, EngineConfig(
        max_batch=2, prefill_buckets=(16, 64), decode_block_size=4,
        paged=PagedCacheConfig(48, PS, 32), native_allocator=False, **kw),
        dtype=torch.float32, device="cpu", mesh=mesh)


def _run(e, rid, prompt, n, prefill_only=False):
    e.add_request(rid, list(prompt), SamplingParams(temperature=0.0,
                                                    max_tokens=n),
                  prefill_only=prefill_only)
    toks = []
    for _ in range(200):
        if (rid in e.handoff_ready_ids() if prefill_only
                else not e.has_work()):
            return toks
        toks += [o.token_id for o in e.step() if o.token_id is not None]
    raise AssertionError(f"{rid} did not finish")


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_payloads_equal_unsharded_bytes(params, kv_quant):
    """The global view moves the unsharded bytes: a handoff payload and a
    prefix export of an unsharded engine, imported into a tensor 2
    engine (heads scattered to the shards), serialize back byte for byte
    from its pools (float pools raw, int8 pools their codes and scales).

    Pools filled by the two engines' own forwards agree bit for bit in
    layer 0 only: from layer 1 on, the row-parallel partials summed in
    shard order move the f32 K/V by an ulp or so (the tokens stay equal,
    ``test_torch_parallel_engine.py``); the layer-0 check below holds the
    sharded forward to that."""
    src = _engine(params, kv_quant=kv_quant)
    _run(src, "h", PROMPT, 4, prefill_only=True)
    exp = src.export_handoff("h")
    _run(src, "warm", PROMPT, 2)
    hashes = chain_hashes(PROMPT, PS, max_pages=8)
    depth, chunks = src.export_prefix_chunks(hashes, chunk_pages=3)
    assert depth == len(hashes) and len(exp.kv) > 0

    dst = _engine(params, 2, kv_quant=kv_quant)
    dst.import_sequence(exp)
    seq = dst._by_id["h"]
    assert serialize_kv(dst.state, seq.block_table, PS, exp.seq_len) == \
        exp.kv
    assert dst.import_prefix(PROMPT[:depth * PS], chunks) == depth
    depth2, chunks2 = dst.export_prefix_chunks(hashes, chunk_pages=3)
    assert depth2 == depth
    assert [c.payload for c in chunks2] == [c.payload for c in chunks]

    # the sharded engine's own forward: layer 0 bit-equal
    own = _engine(params, 2, kv_quant=kv_quant)
    _run(own, "h", PROMPT, 4, prefill_only=True)
    mine = own.export_handoff("h")
    assert mine.next_token == exp.next_token
    assert len(mine.kv) == len(exp.kv)
    if kv_quant == "none":  # [K | V] blocks of [L, T, KV, D] f32
        cfg = configs.TINY
        per_layer = exp.seq_len * cfg.num_kv_heads * cfg.head_dim * 4
        head = len(exp.kv) - 2 * cfg.num_layers * per_layer
        assert mine.kv[:head + per_layer] == exp.kv[:head + per_layer]
    assert dst.audit_pages() == [] and own.audit_pages() == []


def test_handoff_into_tensor_engine_decodes_unsharded_tokens(params):
    want = _run(_engine(params), "w", PROMPT, 9)
    src = _engine(params)
    _run(src, "h", PROMPT, 9, prefill_only=True)
    dst = _engine(params, 2)
    dst.import_sequence(src.export_handoff("h"))
    got = [want[0]]
    for _ in range(200):
        if not dst.has_work():
            break
        got += [o.token_id for o in dst.step() if o.token_id is not None]
    assert got == want
    assert dst.audit_pages() == []


def test_host_tier_and_embeddings_under_tensor(params):
    """The host tier demotes evicted pages through the global pool view
    and reloads them into the shards; the prompt then decodes the
    unsharded tokens. Embeddings equal the unsharded engine's."""
    want = _run(_engine(params), "w", PROMPT, 6)
    e = _engine(params, 2, host_tier_bytes=1 << 20)
    assert _run(e, "a", PROMPT, 6) == want
    e.evict_cache(0.0)
    e.host_tier.flush()
    assert e.host_tier_stats()["pages"] > 0
    assert _run(e, "b", PROMPT, 6) == want
    assert e.host_tier_stats()["hit_pages"] > 0  # reloaded into the shards
    assert e.audit_pages() == []
    ids = [list(b"one input"), list(b"and a second, longer input")]
    np.testing.assert_allclose(e.embed_ids(ids), _engine(params).embed_ids(
        ids), atol=1e-6)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_entry_point_serves_tensor_parallel_texts():
    """``python -m distributed_inference_server_tpu_torch
    --engine-tensor-parallel 2 --device cpu`` over 8 virtual CPU devices
    answers /generate with the unsharded engine's texts (random TINY
    weights from seed 0, as the entry point draws them)."""
    port = _free_port()
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_inference_server_tpu_torch",
         "--model-model-name", "tiny", "--device", "cpu", "--model-dtype",
         "float32", "--engine-warmup-compile", "false",
         "--engine-tensor-parallel", "2", "--batcher-window-ms", "0",
         "--server-port", str(port)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "server did not start"
            time.sleep(0.2)
        got = [_post(port, "/generate", {
            "prompt": p, "max_tokens": 8, "temperature": 0.0,
        })["choices"][0]["text"] for p in ("hello", "tensor parallel")]
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/server/stats", timeout=10).read())
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    ref = LLMEngine(llama.init_params(configs.TINY, gen, dtype=torch.float32,
                                      device="cpu"), configs.TINY, TOK,
                    EngineConfig(), dtype=torch.float32, device="cpu")
    want = []
    for i, p in enumerate(("hello", "tensor parallel")):
        ref.add_request(f"r{i}", TOK.encode(p),
                        SamplingParams(temperature=0.0, max_tokens=8))
        text = ""
        for _ in range(200):
            if not ref.has_work():
                break
            text += "".join(o.text for o in ref.step())
        want.append(text)
    assert got == want
    assert stats  # the server answered its stats over the mesh


@pytest.mark.parametrize("flags,msg", [
    (["--engine-context-parallel", "2", "--engine-pipeline-parallel", "2"],
     "engine.context_parallel > 1 with engine.pipeline_parallel"),
    (["--engine-pipeline-parallel", "2", "--model-draft-model-name", "tiny"],
     "speculative decoding"),
])
def test_mesh_config_errors_exit_2(flags, msg, capsys, monkeypatch):
    from distributed_inference_server_tpu_torch.__main__ import main

    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=8")
    assert main(flags + ["--device", "cpu", "--model-model-name",
                         "tiny"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("config error:") and msg in err
