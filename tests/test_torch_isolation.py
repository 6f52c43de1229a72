"""The port stands alone: no module of it imports ``jax``, the JAX
package, ``aiohttp`` or ``prometheus_client`` (the card's machine has
neither of the last two), and it imports in a process where those imports
raise.

``ops/kernels/_triton_fused.py`` imports ``triton`` at module level (it is
loaded only by the launching functions, on a machine with a card), so the
import test skips that one module where ``triton`` is missing.
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

import distributed_inference_server_tpu_torch as port

PKG_DIR = pathlib.Path(port.__file__).resolve().parent
ROOT = PKG_DIR.parent
JAX_PKG = "distributed_inference_server_tpu"
FORBIDDEN = ("jax", "jaxlib", JAX_PKG, "aiohttp", "prometheus_client")


def _port_files():
    files = sorted(PKG_DIR.rglob("*.py"))
    assert len(files) > 20
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_no_module_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {n}"
                          for n in names if _forbidden(n)]
    assert offenders == []


def test_port_imports_where_jax_cannot():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG_DIR.rglob("*.py")
        if p.name != "__init__.py" or p.parent != PKG_DIR
    )
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    script = textwrap.dedent(f"""
        import importlib, importlib.util, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {FORBIDDEN!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        has_triton = importlib.util.find_spec("triton") is not None
        for m in {modules!r}:
            if m.endswith("_triton_fused") and not has_triton:
                continue
            importlib.import_module(m)
        leaked = [k for k in sys.modules
                  if k.split(".")[0] in {FORBIDDEN!r}]
        assert not leaked, leaked
        print("ok", len({modules!r}))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result
    line."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_two_replica_servers_serve_where_jax_cannot():
    """Two unified replicas, and a prefill/decode pair, each start and
    answer a greedy ``/generate`` in a process where ``import jax``
    raises; the two texts agree."""
    script = textwrap.dedent(f"""
        import json, sys, urllib.request

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {FORBIDDEN!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import torch
        from distributed_inference_server_tpu_torch.engine.engine import (
            EngineConfig, LLMEngine)
        from distributed_inference_server_tpu_torch.models import llama
        from distributed_inference_server_tpu_torch.models.configs import (
            TINY)
        from distributed_inference_server_tpu_torch.models.tokenizer import (
            ByteTokenizer)
        from distributed_inference_server_tpu_torch.serving.server import (
            InferenceServer)

        def factory(i):
            gen = torch.Generator().manual_seed(0)
            params = llama.init_params(TINY, gen, dtype=torch.float32,
                                       device="cpu")
            return LLMEngine(params, TINY, ByteTokenizer(), EngineConfig(),
                             dtype=torch.float32, device="cpu")

        texts = []
        for roles in ("", "prefill,decode"):
            srv = InferenceServer(factory, ByteTokenizer(), "tiny",
                                  num_engines=2, engine_roles=roles)
            srv.start()
            port = srv.serve("127.0.0.1", 0, block=False)
            body = json.dumps({{"prompt": "no jax here", "max_tokens": 8,
                               "temperature": 0.0}}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{{port}}/generate", data=body,
                method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
                texts.append(json.loads(resp.read())["choices"][0]["text"])
            stats = srv.stats()
            assert len(stats["replicas"]) == 2, stats["replicas"]
            if roles:
                assert stats["disagg"]["handoffs"] == {{"ok": 1}}
            srv.shutdown(drain_timeout_s=5.0)
        assert texts[0] == texts[1] and texts[0], texts
        leaked = [k for k in sys.modules
                  if k.split(".")[0] in {FORBIDDEN!r}]
        assert not leaked, leaked
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# the configuration, control and observability modules
CONTROL_MODULES = (
    "distributed_inference_server_tpu_torch.utils.compat",
    "distributed_inference_server_tpu_torch.utils.tracing",
    "distributed_inference_server_tpu_torch.utils.otlp",
    "distributed_inference_server_tpu_torch.serving.config",
    "distributed_inference_server_tpu_torch.serving.teledigest",
    "distributed_inference_server_tpu_torch.serving.flightrec",
    "distributed_inference_server_tpu_torch.serving.health",
    "distributed_inference_server_tpu_torch.serving.degradation",
    "distributed_inference_server_tpu_torch.__main__",
)


def test_no_module_imports_yaml_at_module_level():
    """``yaml`` (absent on the card's machine) is imported only inside the
    function that reads a YAML file."""
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names
                          if n.split(".")[0] == "yaml"]
    assert offenders == []


def test_control_modules_import_each_by_itself():
    """Each new module imports on its own (the package's modules purged
    before each), where jax, the JAX package, aiohttp, prometheus_client
    and yaml cannot be imported."""
    blocked = FORBIDDEN + ("yaml",)
    script = textwrap.dedent(f"""
        import importlib, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {blocked!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        for m in {CONTROL_MODULES!r}:
            for k in [k for k in sys.modules
                      if k.startswith("distributed_inference_server_tpu_torch")]:
                del sys.modules[k]
            importlib.import_module(m)
            leaked = [k for k in sys.modules
                      if k.split(".")[0] in {blocked!r}]
            assert not leaked, (m, leaked)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# the multi-device parallelism modules
PARALLEL_MODULES = (
    "distributed_inference_server_tpu_torch.parallel",
    "distributed_inference_server_tpu_torch.parallel.mesh",
    "distributed_inference_server_tpu_torch.parallel.comm",
    "distributed_inference_server_tpu_torch.parallel.tp",
    "distributed_inference_server_tpu_torch.parallel.pp",
    "distributed_inference_server_tpu_torch.parallel.cp",
    "distributed_inference_server_tpu_torch.parallel.distributed",
    "distributed_inference_server_tpu_torch.ops.moe",
    "distributed_inference_server_tpu_torch.ops.ring_attention",
    "distributed_inference_server_tpu_torch.ops.ulysses",
)


def test_mesh_engines_run_where_jax_cannot():
    """Each parallel module imports on its own where jax, the JAX package,
    aiohttp and prometheus_client cannot be imported; there, engines on
    tensor 2, stage 2 (2 microbatches), seq 2 (the ring prefill), Ulysses
    and expert 2 meshes decode the unsharded engine's greedy tokens."""
    script = textwrap.dedent(f"""
        import importlib, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {FORBIDDEN!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        for m in {PARALLEL_MODULES!r}:
            for k in [k for k in sys.modules
                      if k.startswith("distributed_inference_server_tpu_torch")]:
                del sys.modules[k]
            importlib.import_module(m)
        import torch
        from distributed_inference_server_tpu_torch.engine.engine import (
            EngineConfig, LLMEngine, SamplingParams)
        from distributed_inference_server_tpu_torch.engine.kv_cache import (
            PagedCacheConfig)
        from distributed_inference_server_tpu_torch.models import configs
        from distributed_inference_server_tpu_torch.models import llama
        from distributed_inference_server_tpu_torch.models.tokenizer import (
            ByteTokenizer)
        from distributed_inference_server_tpu_torch.parallel.mesh import (
            MeshSpec, make_mesh)

        def tokens(cfg, axes=None, **kw):
            gen = torch.Generator().manual_seed(0)
            p = llama.init_params(cfg, gen, dtype=torch.float32,
                                  device="cpu")
            for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                p["layers"][k] = p["layers"][k] * 8
            mesh = None if axes is None else make_mesh(
                MeshSpec(**axes), devices=[torch.device("cpu")] * 8)
            e = LLMEngine(p, cfg, ByteTokenizer(), EngineConfig(
                max_batch=2, prefill_buckets=(16,), cp_min_tokens=24,
                paged=PagedCacheConfig(32, 4, 16), **kw),
                dtype=torch.float32, device="cpu", mesh=mesh)
            out = {{}}
            for i, p_ in enumerate((b"no jax here", b"x" * 30)):
                e.add_request(i, list(p_), SamplingParams(
                    temperature=0.0, max_tokens=6))
            for _ in range(200):
                if not e.has_work():
                    break
                for o in e.step():
                    if o.token_id is not None:
                        out.setdefault(o.request_id, []).append(o.token_id)
            assert e.audit_pages() == []
            return out

        for name, axes, kw in (
                ("tiny", dict(tensor=2), {{}}),
                ("tiny", dict(stage=2), dict(pp_microbatches=2)),
                ("tiny", dict(seq=2), {{}}),
                ("tiny", dict(seq=2), dict(sp_impl="ulysses")),
                ("tiny-moe", dict(expert=2), {{}})):
            cfg = configs.get_config(name)
            assert tokens(cfg, axes, **kw) == tokens(cfg), (name, axes)
        leaked = [k for k in sys.modules
                  if k.split(".")[0] in {FORBIDDEN!r}]
        assert not leaked, leaked
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# the fleet's control plane
FLEET_MODULES = (
    "distributed_inference_server_tpu_torch.serving.fleet",
    "distributed_inference_server_tpu_torch.serving.remote_runner",
)


def test_fleet_serves_where_jax_cannot():
    """The fleet modules import each by itself where jax, the JAX
    package, aiohttp and prometheus_client cannot be imported; there, a
    registry host and a member joined over localhost serve a request
    through the member with the host engine's greedy tokens."""
    script = textwrap.dedent(f"""
        import importlib, sys, threading, time

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {FORBIDDEN!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        for m in {FLEET_MODULES!r}:
            for k in [k for k in sys.modules
                      if k.startswith("distributed_inference_server_tpu_torch")]:
                del sys.modules[k]
            importlib.import_module(m)
        import torch
        from distributed_inference_server_tpu_torch.engine.engine import (
            EngineConfig, LLMEngine, SamplingParams)
        from distributed_inference_server_tpu_torch.engine.kv_cache import (
            PagedCacheConfig)
        from distributed_inference_server_tpu_torch.models import llama
        from distributed_inference_server_tpu_torch.models.configs import TINY
        from distributed_inference_server_tpu_torch.models.tokenizer import (
            ByteTokenizer)
        from distributed_inference_server_tpu_torch.serving.fleet import (
            FleetSettings)
        from distributed_inference_server_tpu_torch.serving.remote_runner \\
            import FleetWorker
        from distributed_inference_server_tpu_torch.serving.runner import (
            ServerRequest)
        from distributed_inference_server_tpu_torch.serving.server import (
            InferenceServer)

        p = llama.init_params(TINY, torch.Generator().manual_seed(0),
                              dtype=torch.float32, device="cpu")

        def factory():
            return LLMEngine(p, TINY, ByteTokenizer(), EngineConfig(
                max_batch=2, prefill_buckets=(16,),
                paged=PagedCacheConfig(32, 4, 16)),
                dtype=torch.float32, device="cpu")

        host = InferenceServer(factory, ByteTokenizer(), "tiny",
                               fleet_settings=FleetSettings(
                                   enabled=True, heartbeat_interval_s=0.1))
        host.start()
        member = InferenceServer(factory, ByteTokenizer(), "tiny")
        member.start()
        w = FleetWorker(member.scheduler, FleetSettings(
            connect=f"127.0.0.1:{{host.fleet_server.bound_port}}",
            heartbeat_interval_s=0.1), member_id="w1")
        w.start()
        deadline = time.monotonic() + 30
        while not any(getattr(r, "is_remote", False) and r.is_healthy()
                      for r in host.scheduler.engines()):
            assert time.monotonic() < deadline, "no join"
            time.sleep(0.05)

        class Sink:
            def __init__(self):
                self.toks, self.ev = [], threading.Event()
            def on_token(self, t, text, i, lp=None):
                self.toks.append(t)
            def on_done(self, reason, usage):
                self.ev.set()
            def on_error(self, message, code):
                raise AssertionError(message)

        out = []
        for r in host.scheduler.engines():
            s = Sink()
            r.submit([ServerRequest(r.engine_id, list(b"no jax here"),
                                    SamplingParams(max_tokens=6,
                                                   temperature=0.0), s)])
            assert s.ev.wait(60)
            out.append(s.toks)
        w.stop(); member.shutdown(5); host.shutdown(5)
        assert len(out) == 2 and out[0] == out[1], out
        leaked = [k for k in sys.modules
                  if k.split(".")[0] in {FORBIDDEN!r}]
        assert not leaked, leaked
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
