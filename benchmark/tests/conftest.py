"""Fixtures of the benchmark's CPU tests: the tiny cells under
``fixtures/`` in a folder laid out as ``benchmark/`` is (their configs and
workloads, the real metric readers), and a BENCHMARK.json that lists
them."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest

from benchmark import spec

FIXTURES = Path(__file__).resolve().parent / "fixtures"
TINY_CELLS = ("tiny-swa.open", "tiny-moe-int8.closed")


@pytest.fixture
def tiny_base(tmp_path: Path) -> Path:
    shutil.copytree(FIXTURES / "configs", tmp_path / "configs")
    shutil.copytree(FIXTURES / "workloads", tmp_path / "workloads")
    shutil.copytree(spec.HERE / "metrics", tmp_path / "metrics")
    return tmp_path


@pytest.fixture
def tiny_bench() -> dict:
    """BENCHMARK.json with the tiny cells added to every metric's cells."""
    bench = copy.deepcopy(spec.benchmark_json())
    for cell in TINY_CELLS:
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": "tiny", "chips": 1,
                                   "why": "a CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    return bench


@pytest.fixture
def cuda_device():
    """The card, decided here (never at import): skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)
