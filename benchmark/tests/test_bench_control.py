"""``correct`` separates: at the tiny cells' size a whole run of the
harness (the port's server on the CPU, the load generator, the check)
comes out correct, its lower-precision control does not, and a run with
the timed path broken underneath comes out not correct, once for each
fault a served cell can have."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import load


def _cell(cell, base, bench, control=False):
    res = run.run_cell(cell, 2**31 + 99, 3.0, False, torch.device("cpu"),
                       bench, base=base, control=control,
                       log=lambda *a, **k: None)
    return res


@pytest.mark.parametrize("cell", ["tiny-swa.open", "tiny-moe-int8.closed"])
def test_program_passes_and_control_fails(cell, tiny_base, tiny_bench):
    res = _cell(cell, tiny_base, tiny_bench, control=True)
    assert res["correct"], res["check"]
    assert res["_check"]["requests"] >= 1
    assert not res["control_correct"], res["control"]
    limits = res["_check"]["limits"]
    assert res["control"]["widest"] > 3 * limits["logit_gap_max"]
    assert res["control"]["mean"] > 3 * limits["logit_gap_mean"]


def test_a_closed_loop_ramps_in_and_the_pages_are_read(tiny_base,
                                                      tiny_bench):
    res = _cell("tiny-moe-int8.closed", tiny_base, tiny_bench)
    rec = res["_run"]
    # the clients started over the ramp, before the window opened
    assert min(r["sent"] for r in rec["requests"]) < rec["t0"]
    p = rec["pages"]
    assert 0 < p["live"] <= p["used"] <= p["total"]


def test_sampled_requests_are_checked_where_the_cell_names_them(
        tiny_base, tiny_bench):
    path = tiny_base / "workloads" / "tiny-swa.open.json"
    w = load(path)
    w["check"].update(sampled_tokens=60, sampled_max_requests=4)
    w["check"]["limits"].update(sampled_excess_nats=10.0,
                                sampled_outside_share=1.0)
    path.write_text(json.dumps(w))
    res = _cell("tiny-swa.open", tiny_base, tiny_bench, control=True)
    assert res["correct"], res["check"]
    for name in run.SAMPLED:
        assert res["check"][name]["value"] is not None
        assert res["control"][run.NUMBERS[name]] is not None
    chk = res["_check"]
    assert chk["sampled_requests"] >= 1
    assert (res["fault_temperature"]["sampled_tokens"]
            == chk["sampled_served_tokens"])


def _skip_kv_writes(monkeypatch):
    """A step that returns its state unchanged: the K/V writes are
    dropped, so every later step reads a pool the step never updated."""
    from distributed_inference_server_tpu_torch.models import llama

    orig = llama.make_paged_write_fn

    def broken(*a, **k):
        orig(*a, **k)
        return lambda pool, l, new: pool

    monkeypatch.setattr(llama, "make_paged_write_fn", broken)


def _drop_half_the_rows(monkeypatch):
    """Half of the batch left out: the odd rows of every normed
    activation are zeroed before the layer uses them."""
    from distributed_inference_server_tpu_torch.models import llama

    orig = llama.rms_norm

    def broken(x, *a, **k):
        y = orig(x, *a, **k)
        flat = y.reshape(-1, y.shape[-1]).clone()
        flat[1::2] = 0
        return flat.reshape(y.shape)

    monkeypatch.setattr(llama, "rms_norm", broken)


def _alter_tokens(monkeypatch):
    """A token altered where it is produced: every sampled token is
    replaced by its successor before the engine emits it."""
    from distributed_inference_server_tpu_torch.engine import engine

    orig = engine.LLMEngine._emit_token
    vocab = 512

    def broken(self, seq, token_id, outputs, logprob=None):
        eos = self.tok.eos_ids
        if token_id not in eos:
            token_id = (token_id + 1) % vocab
            if token_id in eos:
                token_id = (token_id + 1) % vocab
        return orig(self, seq, token_id, outputs, logprob)

    monkeypatch.setattr(engine.LLMEngine, "_emit_token", broken)


@pytest.mark.parametrize("fault", [_skip_kv_writes, _drop_half_the_rows,
                                   _alter_tokens])
@pytest.mark.parametrize("cell", ["tiny-swa.open", "tiny-moe-int8.closed"])
def test_a_broken_timed_path_is_not_correct(cell, fault, tiny_base,
                                            tiny_bench, monkeypatch):
    fault(monkeypatch)
    res = _cell(cell, tiny_base, tiny_bench)
    assert not res["correct"], res["check"]
