"""Find and read the benchmark's files by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics; the
files under this folder carry what each one is. A later cell, configuration
or per-layer metric is a new file here and a new entry there: nothing in
this module names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

OPEN, CLOSED = "open", "closed"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(name: str, base: Path = HERE) -> dict:
    """``workloads/<name>.json`` with its ``name``; raises ``ValueError``
    for a file that misses a key the harness needs."""
    w = load_json(base / "workloads" / f"{name}.json")
    w["name"] = name
    for key in ("config", "loop", "prompt_tokens", "output_tokens",
                "drain_s", "check", "why"):
        if key not in w:
            raise ValueError(f"workload {name}: missing {key!r}")
    if w["loop"] == OPEN:
        if float(w.get("rate_per_s", 0)) <= 0:
            raise ValueError(f"workload {name}: an open loop needs "
                             "rate_per_s > 0")
    elif w["loop"] == CLOSED:
        if int(w.get("clients", 0)) < 1:
            raise ValueError(f"workload {name}: a closed loop needs "
                             "clients >= 1")
        if float(w.get("ramp_s", 0)) < 0:
            raise ValueError(f"workload {name}: ramp_s must be >= 0")
    else:
        raise ValueError(f"workload {name}: loop must be open or closed")
    if not w["check"].get("limits"):
        raise ValueError(f"workload {name}: check.limits names no number")
    for key in ("prompt_tokens", "output_tokens"):
        d = w[key]
        if not 1 <= d["min"] <= d["median"] <= d["max"]:
            raise ValueError(f"workload {name}: {key} needs "
                             "1 <= min <= median <= max")
    return w


def config(name: str, base: Path = HERE) -> dict:
    """``configs/<name>.json``: the published config keys at the top
    level, ``quantization``, ``dtype`` and ``engine``."""
    c = load_json(base / "configs" / f"{name}.json")
    c["name"] = name
    for key in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                "num_key_value_heads", "intermediate_size", "vocab_size",
                "quantization", "dtype", "engine"):
        if key not in c:
            raise ValueError(f"config {name}: missing {key!r}")
    return c


def metric_reader(name: str, base: Path = HERE
                  ) -> Callable[[dict], Optional[float]]:
    """The ``read`` function of ``metrics/<name>.py`` (loaded from its
    path: a metric's name may hold dots)."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def chips(bench: dict, cell: str) -> Optional[int]:
    """The chips ``cell`` asks for in BENCHMARK.json (None: no such
    cell)."""
    return next((int(c.get("chips", 1)) for c in bench["workloads"]
                 if c["name"] == cell), None)


def cell_metrics(bench: dict, cell: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metric entries that ``cell``
    reports: those without ``workloads`` and those that list it."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]

    return {"end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}
