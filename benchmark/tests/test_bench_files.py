"""BENCHMARK.json keeps to its contract, and every cell, configuration
and metric is a file the harness finds by name."""

from __future__ import annotations

import json
import re
import shutil

from benchmark import loadgen, spec
from benchmark.tests.conftest import load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_names_and_units():
    b = spec.benchmark_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {c["name"] for c in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        # reported only where the metric it moves is
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(moved)
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_config_and_metric_is_a_file():
    b = spec.benchmark_json()
    for c in b["configs"]:
        cfg = spec.config(c["name"])
        assert spec.ROOT.joinpath(c["file"]).is_file()
        assert c["reduced"] == cfg["reduced"] == []
    for c in b["workloads"]:
        assert NAME.match(c["name"]) and c["chips"] == 1
        w = spec.workload(c["name"])
        assert w["config"] == c["config"]
        assert w["why"] == c["why"] and len(c["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_configs_hold_the_published_widths():
    mistral = spec.config("mistral-7b")
    mixtral = spec.config("mixtral-8x7b-int8")
    for c in (mistral, mixtral):
        assert (c["hidden_size"], c["intermediate_size"],
                c["num_hidden_layers"], c["num_attention_heads"],
                c["num_key_value_heads"], c["vocab_size"]) == (
            4096, 14336, 32, 32, 8, 32000)
    assert mistral["sliding_window"] == 4096
    assert mistral["rope_theta"] == 10000.0
    assert (mixtral["num_local_experts"], mixtral["num_experts_per_tok"],
            mixtral["rope_theta"], mixtral["sliding_window"]) == (
        8, 2, 1e6, None)
    for c in (mistral, mixtral):
        for key in c["changed"]:
            assert key in c["engine"]


def test_a_new_cell_is_one_more_file(tmp_path):
    """A throwaway configuration, cell and metric, each a file of its
    own, are found by name and used, with no other file edited."""
    shutil.copytree(spec.HERE / "configs", tmp_path / "configs")
    shutil.copytree(spec.HERE / "workloads", tmp_path / "workloads")
    shutil.copytree(spec.HERE / "metrics", tmp_path / "metrics")
    cfg = load(spec.HERE / "configs" / "mistral-7b.json")
    cfg["sliding_window"] = None
    (tmp_path / "configs" / "throwaway-7b.json").write_text(json.dumps(cfg))
    new = load(spec.HERE / "workloads" / "mistral-7b.chat.json")
    new.update(config="throwaway-7b", rate_per_s=3.0,
               why="a throwaway cell")
    (tmp_path / "workloads" / "mistral-7b.throwaway.json").write_text(
        json.dumps(new))
    (tmp_path / "metrics" / "throwaway_count.py").write_text(
        "def read(run):\n    return float(len(run['requests']))\n")
    w = spec.workload("mistral-7b.throwaway", tmp_path)
    cfg = spec.config(w["config"], tmp_path)
    assert cfg["name"] == "throwaway-7b" and cfg["sliding_window"] is None
    reqs = loadgen.schedule(w, 5, 10.0, cfg["vocab_size"])
    assert len(reqs) == 30
    reader = spec.metric_reader("throwaway_count", tmp_path)
    assert reader({"requests": reqs}) == 30.0
