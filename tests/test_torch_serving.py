"""The port's HTTP server, in process on the CPU, against the JAX package.

The server runs the port's engine on TINY weights shared with a JAX
engine (float32, every matrix scaled by 8 so greedy continuations vary),
on an ephemeral port. ``POST /generate`` bodies must parse as the JAX
package's ``GenerateResponse`` with the same fields, and their text and
usage must be what the JAX engine (reference path) produces for the same
request; errors must parse as its ``ErrorResponse``.
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


@pytest.fixture(scope="module")
def stack():
    jp = j_llama.init_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["embed"] = tree["embed"] * 8.0
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * 8.0
    t_params = params_from_numpy(tree, device="cpu", dtype=torch.float32)

    def factory():
        return LLMEngine(t_params, TINY, ByteTokenizer(), EngineConfig(
            max_batch=4, prefill_buckets=BUCKETS,
            paged=PagedCacheConfig(*PAGED)), dtype=torch.float32,
            device="cpu")

    server = InferenceServer(factory, ByteTokenizer(), model_name="tiny")
    server.start()
    port = server.serve("127.0.0.1", 0, block=False)
    j_engine = JEngine(jax.tree_util.tree_map(jnp.asarray, tree), J_TINY,
                       JByteTokenizer(), JEngineConfig(
                           max_batch=4, prefill_buckets=BUCKETS,
                           paged=JPagedCacheConfig(*PAGED),
                           attention_impl="xla", native_allocator=False),
                       dtype=jnp.float32)
    yield f"http://127.0.0.1:{port}", j_engine, server
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
        "paged_decode", "paged_prefill", "rms_norm", "rope"}
    assert stats["requests_finished"] >= 1 and stats["tokens_generated"] >= 2
    assert stats["cache"]["pages_total"] == PAGED[0]
    status, reset = _post(base, "/server/kernel_counts/reset", {})
    assert status == 200
    assert all(v == 0 for v in reset["kernel_launches"].values())
