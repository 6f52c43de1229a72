"""The port's HTTP server, in process on the CPU, against the JAX package.

The server runs the port's engine on TINY weights shared with a JAX
engine (float32, every matrix scaled by 8 so greedy continuations vary),
on an ephemeral port. ``POST /generate`` bodies must parse as the JAX
package's ``GenerateResponse`` with the same fields, and their text and
usage must be what the JAX engine (reference path) produces for the same
request; errors must parse as its ``ErrorResponse``. A second server runs
the ragged mixed step (``mixed_step_tokens``) and is held against the
JAX engine's mixed step the same way; ``/server/stats`` carries its
``mixed`` block (null when the step is off). A third server serves int8
weights over int8 KV pools and is held against the JAX engine with the
same quantized weights and ``kv_quant="int8"``.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_server_tpu.core.models import (
    ErrorResponse as JErrorResponse,
)
from distributed_inference_server_tpu.core.models import (
    GenerateResponse as JGenerateResponse,
)
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
from distributed_inference_server_tpu.models.tokenizer import (
    ByteTokenizer as JByteTokenizer,
)
from distributed_inference_server_tpu.ops.quant import quantize_params
from distributed_inference_server_tpu_torch.engine.engine import (
    EngineConfig,
    LLMEngine,
)
from distributed_inference_server_tpu_torch.engine.kv_cache import (
    PagedCacheConfig,
)
from distributed_inference_server_tpu_torch.models.configs import TINY
from distributed_inference_server_tpu_torch.models.convert import (
    params_from_numpy,
)
from distributed_inference_server_tpu_torch.models.tokenizer import (
    ByteTokenizer,
)
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer,
)

PAGED = (64, 4, 32)
BUCKETS = (8, 32)


def _serve(mixed_step_tokens, quantization="none", kv_quant="none",
           loop=False):
    """(base URL, JAX engine, server) on shared TINY weights (quantized by
    the JAX package with group 32 when ``quantization`` is not none);
    ``loop``: looped decode blocks on both engines."""
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * 8.0
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * 8.0
    if quantization != "none":
        tree = jax.tree_util.tree_map(np.asarray, quantize_params(
            jax.tree_util.tree_map(jnp.asarray, tree), quantization, 32))
    t_params = params_from_numpy(tree, device="cpu", dtype=torch.float32)

    def factory():
        return LLMEngine(t_params, TINY, ByteTokenizer(), EngineConfig(
            max_batch=4, prefill_buckets=BUCKETS,
            paged=PagedCacheConfig(*PAGED),
            mixed_step_tokens=mixed_step_tokens, kv_quant=kv_quant,
            loop_to_completion=loop), dtype=torch.float32, device="cpu")

    server = InferenceServer(factory, ByteTokenizer(), model_name="tiny")
    server.start()
    port = server.serve("127.0.0.1", 0, block=False)
    j_engine = JEngine(jax.tree_util.tree_map(jnp.asarray, tree), J_TINY,
                       JByteTokenizer(), JEngineConfig(
                           max_batch=4, prefill_buckets=BUCKETS,
                           paged=JPagedCacheConfig(*PAGED),
                           mixed_step_tokens=mixed_step_tokens,
                           kv_quant=kv_quant, attention_impl="xla",
                           native_allocator=False, loop_to_completion=loop),
                       dtype=jnp.float32)
    return f"http://127.0.0.1:{port}", j_engine, server


@pytest.fixture(scope="module")
def stack():
    base, j_engine, server = _serve(0)
    yield base, j_engine, server
    server.shutdown()


def _post(base, path, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def _jax_text(j_engine, prompt, **kw):
    tok = JByteTokenizer()
    j_engine.add_request("x", tok.encode(prompt), JSamplingParams(**kw))
    text, finish, usage = "", None, None
    while j_engine.has_work():
        for o in j_engine.step():
            text += o.text
            if o.finished:
                finish, usage = o.finish_reason.value, o.usage.to_dict()
    return text, finish, usage


@pytest.mark.parametrize("prompt,kw", [
    ("hello from the port", dict(max_tokens=8)),
    ("a longer prompt that spans the second bucket.", dict(max_tokens=5)),
    ("stop me", dict(max_tokens=12, stop_sequences=["never"])),
])
def test_generate_matches_jax_engine(stack, prompt, kw):
    base, j_engine, _ = stack
    status, body = _post(base, "/generate", {"prompt": prompt,
                                             "temperature": 0.0, **kw})
    assert status == 200, body
    resp = JGenerateResponse.from_dict(body)  # the JAX schema parses it
    assert resp.to_dict() == body
    assert resp.object == "text_completion" and resp.model == "tiny"
    assert resp.id.startswith("cmpl-")
    text, finish, usage = _jax_text(
        j_engine, prompt, temperature=0.0,
        **{k: tuple(v) if k == "stop_sequences" else v
           for k, v in kw.items()})
    choice = body["choices"][0]
    assert choice["text"] == text
    assert choice["finish_reason"] == finish
    assert body["usage"] == usage


def test_concurrent_requests_match_solo(stack):
    base, _, _ = stack
    prompts = [f"concurrent request {i}" for i in range(4)]
    solo = [_post(base, "/generate", {"prompt": p, "temperature": 0.0,
                                      "max_tokens": 6})[1] for p in prompts]
    out = [None] * 4

    def worker(i):
        out[i] = _post(base, "/generate", {"prompt": prompts[i],
                                           "temperature": 0.0,
                                           "max_tokens": 6})[1]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for a, b in zip(solo, out):
        assert a["choices"] == b["choices"]


@pytest.mark.parametrize("body,code", [
    ({"prompt": "   "}, "empty_prompt"),
    ({"max_tokens": 3}, "missing_field"),
    ({"prompt": "x", "temperature": 9.0}, "invalid_parameter"),
    (b"{not json", "invalid_json"),
])
def test_errors_use_the_jax_schema(stack, body, code):
    base, _, _ = stack
    status, err = _post(base, "/generate", body)
    assert status == 400
    parsed = JErrorResponse.from_dict(err)
    assert parsed.error.code == code
    assert parsed.error.error_type == "invalid_request_error"


def test_health_and_stats(stack):
    base, _, _ = stack
    status, health = _get(base, "/health")
    assert status == 200 and health["status"] == "ok"
    assert health["device"] == "cpu"
    _post(base, "/generate", {"prompt": "count me", "max_tokens": 2})
    status, stats = _get(base, "/server/stats")
    assert status == 200
    assert set(stats["kernel_launches"]) == {
        "paged_decode", "paged_decode_int8", "paged_prefill", "paged_ragged",
        "rms_norm", "rope", "quant_matmul_q8", "quant_matmul_q4"}
    assert stats["mixed"] is None  # the mixed step is off
    assert stats["loop"] is None  # looped blocks are off
    assert stats["requests_finished"] >= 1 and stats["tokens_generated"] >= 2
    assert stats["cache"]["pages_total"] == PAGED[0]
    status, reset = _post(base, "/server/kernel_counts/reset", {})
    assert status == 200
    assert all(v == 0 for v in reset["kernel_launches"].values())


MIXED = 12


@pytest.fixture(scope="module")
def mixed_stack():
    base, j_engine, server = _serve(MIXED)
    yield base, j_engine, server
    server.shutdown()


def test_mixed_server_matches_jax_mixed_engine(mixed_stack):
    base, j_engine, _ = mixed_stack
    prompt = "a prompt long enough for several mixed steps of twelve."
    status, body = _post(base, "/generate", {"prompt": prompt,
                                             "temperature": 0.0,
                                             "max_tokens": 7})
    assert status == 200, body
    text, finish, usage = _jax_text(j_engine, prompt, temperature=0.0,
                                    max_tokens=7)
    assert body["choices"][0]["text"] == text
    assert body["choices"][0]["finish_reason"] == finish
    assert body["usage"] == usage
    _, stats = _get(base, "/server/stats")
    mixed = stats["mixed"]
    assert mixed["steps"] >= 5 and mixed["prefill_tokens"] >= len(prompt)
    assert stats["kernel_launches"]["paged_prefill"] == 0


def test_mixed_prefill_frac_reaches_stats(mixed_stack):
    base, _, server = mixed_stack
    server.runner.set_mixed_prefill_frac(0.5)
    _post(base, "/generate", {"prompt": "after the change", "max_tokens": 2})
    _, stats = _get(base, "/server/stats")
    assert stats["mixed"]["prefill_frac"] == 0.5
    server.runner.set_mixed_prefill_frac(1.0)


@pytest.mark.parametrize("value", ["4", "8", "-1"])
def test_cli_rejects_mixed_step_tokens_up_to_max_batch(value, capsys):
    from distributed_inference_server_tpu_torch.__main__ import main

    assert main(["--device", "cpu", "--engine-mixed-step-tokens",
                 value]) == 2
    assert "mixed_step_tokens" in capsys.readouterr().err


@pytest.mark.parametrize("argv,what", [
    (["--model-quantization", "int2"], "model.quantization"),
    (["--engine-kv-quant", "fp8"], "engine.kv_quant"),
    (["--engine-kv-quant", "int4"], "engine.kv_quant"),
])
def test_cli_rejects_bad_quantization(argv, what, capsys):
    from distributed_inference_server_tpu_torch.__main__ import main

    assert main(["--device", "cpu", *argv]) == 2
    err = capsys.readouterr().err
    assert "config error:" in err and what in err


@pytest.mark.parametrize("argv,what", [
    (["--engine-loop-to-completion", "true", "--engine-loop-max-steps", "0"],
     "loop_max_steps"),
    (["--engine-loop-max-steps", "-4"], "loop_max_steps"),
    (["--engine-loop-to-completion", "sometimes"], "loop_to_completion"),
])
def test_cli_rejects_bad_loop_flags(argv, what, capsys):
    from distributed_inference_server_tpu_torch.__main__ import main

    assert main(["--device", "cpu", *argv]) == 2
    err = capsys.readouterr().err
    assert "config error:" in err and what in err


def test_cli_accepts_int8_kv_with_mixed_step(monkeypatch, capsys):
    """``--engine-kv-quant int8`` with ``--engine-mixed-step-tokens`` passes
    the config checks (it stopped at a config error before the mixed step
    read int8 pools): the run gets as far as starting the server."""
    from distributed_inference_server_tpu_torch import __main__ as cli

    def refuse(self):
        raise RuntimeError("server start stubbed out")

    monkeypatch.setattr(cli.InferenceServer, "start", refuse)
    assert cli.main(["--device", "cpu", "--model-model-name", "tiny",
                     "--engine-kv-quant", "int8", "--engine-max-batch", "8",
                     "--engine-mixed-step-tokens", "12",
                     "--engine-loop-to-completion", "true"]) == 1
    err = capsys.readouterr().err
    assert "config error" not in err and "stubbed out" in err


def test_int8_mixed_loop_server_matches_jax_engine():
    """int8 weights over int8 KV pools with the mixed step in its K-block
    form and looped decode blocks, served: the text, finish and usage of
    the JAX engine in the same configuration, and ``/server/stats``
    carries the ``loop`` and ``mixed`` blocks."""
    base, j_engine, server = _serve(12, "int8", "int8", loop=True)
    try:
        prompt = "a prompt long enough for several mixed steps of twelve."
        status, body = _post(base, "/generate", {"prompt": prompt,
                                                 "temperature": 0.0,
                                                 "max_tokens": 10})
        assert status == 200, body
        text, finish, usage = _jax_text(j_engine, prompt, temperature=0.0,
                                        max_tokens=10)
        assert body["choices"][0]["text"] == text
        assert body["choices"][0]["finish_reason"] == finish
        assert body["usage"] == usage
        _, stats = _get(base, "/server/stats")
        assert set(stats["loop"]) == {"blocks", "steps", "decode_tokens",
                                      "exits", "cap", "cap_frac"}
        assert set(stats["loop"]["exits"]) == {"eos", "budget", "pages",
                                               "cap"}
        assert stats["loop"]["cap"] == 256
        assert stats["mixed"]["steps"] >= 3  # the prompt loads
        assert stats["loop"]["blocks"] >= 1  # then looped blocks decode
    finally:
        server.shutdown()


def test_int8_server_matches_jax_engine():
    """int8 weights over int8 KV pools, served: the text, finish and usage
    of the JAX engine with the same quantized weights and int8 KV."""
    base, j_engine, server = _serve(0, "int8", "int8")
    try:
        prompt = "quantized serving on the port"
        status, body = _post(base, "/generate", {"prompt": prompt,
                                                 "temperature": 0.0,
                                                 "max_tokens": 8})
        assert status == 200, body
        text, finish, usage = _jax_text(j_engine, prompt, temperature=0.0,
                                        max_tokens=8)
        assert body["choices"][0]["text"] == text
        assert body["choices"][0]["finish_reason"] == finish
        assert body["usage"] == usage
    finally:
        server.shutdown()
