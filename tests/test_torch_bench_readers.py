"""The benchmark's readers of the engine's device clock, prefill split and
in-server front end (``benchmark/metrics/``) on synthetic run records:
each reads its number from the step clock's snapshots and the /metrics
scrapes a run keeps, and reads nothing (None, no exception) from a
program without the counters it needs."""

from __future__ import annotations

import pytest

from benchmark import spec


def _kinds(prefill, decode):
    keys = ("dispatches", "wall_s", "tokens", "rows", "forwards",
            "capacity", "device_s")
    return {"prefill": dict(zip(keys, prefill)),
            "decode_block": dict(zip(keys, decode)),
            "mixed": dict.fromkeys(keys, 0), "loop": dict.fromkeys(keys, 0)}


def _phase(name, s, n):
    label = '{phase="%s"}' % name
    return {("request_phase_seconds_sum", label): s,
            ("request_phase_seconds_count", label): n}


IDLE0 = {"admit": 0.0, "schedule": 0.1, "walk": 0.2, "reap": 0.0,
         "runner": 0.0, "other": 0.05}
IDLE1 = {"admit": 0.01, "schedule": 0.12, "walk": 0.26, "reap": 0.02,
         "runner": 0.04, "other": 0.07}


def _run():
    """A window in which 4 prefill chunks ran 0.32 device s over
    2 x 4 x 512 + 2 x 4 x 128 tokens computed for 3000 prompt tokens, and
    decode blocks 80 forwards in 0.6 device s; 10 requests spent 0.5 s
    in engine_wait, 4 s in prefill, 0.03 s in ingress, and 10 first
    frames 0.02 s behind their first tokens; the traced sub-window of 4 s
    grew the idle gaps by 0.17 s."""
    c0 = {"kinds": _kinds((10, 1.0, 5000, 30, 10, 16384, 0.8),
                          (50, 2.0, 3000, 400, 400, 25600, 3.0)),
          "events": {}, "idle": IDLE0}
    c1 = {"kinds": _kinds((14, 1.5, 8000, 42, 14, 16384 + 5120, 1.12),
                          (60, 2.5, 3600, 480, 480, 30720, 3.6)),
          "events": {}, "idle": IDLE1}
    m0 = {**_phase("engine_wait", 1.0, 20), **_phase("prefill", 6.0, 20),
          **_phase("ingress", 0.06, 20),
          ("request_first_frame_seconds_sum", ""): 0.04,
          ("request_first_frame_seconds_count", ""): 20}
    m1 = {**_phase("engine_wait", 1.5, 30), **_phase("prefill", 10.0, 30),
          **_phase("ingress", 0.09, 30),
          ("request_first_frame_seconds_sum", ""): 0.06,
          ("request_first_frame_seconds_count", ""): 30}
    return {"clock_open": c0, "clock_cut": c1, "metrics_open": m0,
            "metrics_cut": m1,
            "trace": {"window_s": 4.0, "clock0": c0, "clock1": c1}}


def _parent_run():
    """The same window from a program without the device clock, the
    forward and capacity counters and the port's phases."""
    run = _run()
    for key in ("clock_open", "clock_cut"):
        c = run[key]
        c.pop("idle")
        for kc in c["kinds"].values():
            for f in ("forwards", "capacity", "device_s"):
                kc.pop(f)
    for key in ("metrics_open", "metrics_cut"):
        run[key] = {k: v for k, v in run[key].items()
                    if k[1] == '{phase="prefill"}'}
    return run


WANT = {
    "engine_wait_ms.ttft": 50.0,
    "prefill_span_ms.ttft": 400.0,
    "front_end_server_ms.ttft": 5.0,
    "prefill_chunk_device_ms.ttft": 80.0,
    "prefill_fill_share.ttft": 100.0 * 3000 / 5120,
    "decode_step_device_ms.tpot": 7.5,
    "decode_step_device_ms.batch": 7.5,
    "engine_idle_share.tpot": 100.0 * 0.17 / 4.0,
    "engine_idle_share.batch": 100.0 * 0.17 / 4.0,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_a_synthetic_run(name):
    read = spec.metric_reader(name)
    assert read(_run()) == pytest.approx(WANT[name])
    assert read(_parent_run()) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_is_listed_where_its_counters_exist(name):
    entry = {m["name"]: m for m in spec.benchmark_json()["per_layer"]}[name]
    assert entry["source"] == "program_counter"
    cells = {"batch": ["mixtral-8x7b-int8.batch"]}.get(
        name.rsplit(".", 1)[1], ["mistral-7b.longctx", "mistral-7b.chat"])
    assert entry["workloads"] == cells


def test_readers_of_device_time_read_nothing_from_a_cpu_engine():
    run = _run()
    for key in ("clock_open", "clock_cut"):
        for kc in run[key]["kinds"].values():
            kc["device_s"] = 0.0
    for name in ("prefill_chunk_device_ms.ttft",
                 "decode_step_device_ms.tpot"):
        assert spec.metric_reader(name)(run) is None
    run["trace"] = None
    assert spec.metric_reader("engine_idle_share.tpot")(run) is None
