"""On the card: a tiny cell through the whole harness with the device
trace on, its per-layer readers' shares within 0..100 %. Skips without a
card (decided in the fixture)."""

from __future__ import annotations

import pytest

from benchmark import run, spec


@pytest.mark.gpu
def test_tiny_cell_traced_on_the_card(cuda_device, tiny_base, tiny_bench):
    res = run.run_cell("tiny-swa.open", 11, 4.0, True, cuda_device,
                       tiny_bench, base=tiny_base, log=lambda *a, **k: None)
    assert res["correct"]
    assert res["device"]["busy_s"] > 0
    assert 0 < res["device"]["window_s"]
    for name, m in res["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, (name, m)
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert spec.metric_reader("device_idle_share.tpot")(res["_run"]) >= 0
