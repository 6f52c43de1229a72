"""No module that a run loads is JAX or the JAX package (whole top-level
names), and the reference loads nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "distributed_inference_server_tpu"}
PORT = "distributed_inference_server_tpu_torch"

_PROBE = """
import json, sys
import benchmark.run as run
from benchmark import devtrace, weights
from benchmark.reference import model
from distributed_inference_server_tpu_torch.engine.engine import LLMEngine
from distributed_inference_server_tpu_torch.serving.server import (
    InferenceServer)
from distributed_inference_server_tpu_torch.models.loader import (
    config_from_hf_json)
for m in %s:
    spec_mod = run.spec.metric_reader(m)
print(json.dumps(sorted({k.split(".", 1)[0] for k in sys.modules})))
"""


def _tops(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(spec.ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    b = spec.benchmark_json()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    tops = _tops(_PROBE % json.dumps(names))
    assert PORT in tops
    assert not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    tops = _tops("import json, sys\n"
                 "from benchmark.reference import model\n"
                 "print(json.dumps(sorted({k.split('.', 1)[0] "
                 "for k in sys.modules})))")
    assert not tops & (FORBIDDEN | {PORT})
    for path in (spec.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".", 1)[0] not in FORBIDDEN | {PORT}, (
                    path, m)


def test_the_run_module_checks_whole_top_level_names():
    from benchmark import run

    assert set(run.FORBIDDEN) == FORBIDDEN
    assert PORT.split(".", 1)[0] not in run.FORBIDDEN
