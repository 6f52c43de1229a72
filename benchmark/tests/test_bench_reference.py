"""The plain float32 reference against the port's own plain forward at a
tiny size (this test may import both; the reference imports nothing of
the port)."""

from __future__ import annotations

import pytest
import torch

from benchmark import spec, weights, work
from benchmark.reference import model as ref
from benchmark.tests.conftest import FIXTURES


@pytest.mark.parametrize("name", ["tiny-swa", "tiny-moe-int8"])
def test_reference_matches_the_port_forward(name):
    from distributed_inference_server_tpu_torch.models import llama
    from distributed_inference_server_tpu_torch.models.loader import (
        config_from_hf_json,
    )

    cfg = spec.config(name, FIXTURES)
    d = work.dims(cfg)
    tree = weights.make(d, 12345, "cpu", torch.float32)
    mcfg = config_from_hf_json(cfg)
    T = 100  # past the tiny window of 48
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(3, d.vocab, (1, T), generator=gen)
    cache = llama.KVCache.create(mcfg, 1, T, torch.float32, "cpu")
    pos = torch.arange(T)[None]
    logits, _ = llama.forward(weights.as_port_tree(tree), mcfg, ids, pos,
                              cache, pos, torch.tensor([T]), impl="plain")
    mine = ref.forward_logits(cfg, tree, [ids[0].tolist()],
                              [list(range(T))], "cpu")[0]
    assert torch.allclose(mine, logits[0], atol=2e-4, rtol=1e-4), (
        (mine - logits[0]).abs().max())


def test_window_changes_the_logits():
    cfg = spec.config("tiny-swa", FIXTURES)
    d = work.dims(cfg)
    tree = weights.make(d, 7, "cpu", torch.float32)
    seq = list(range(3, 103))
    a = ref.forward_logits(cfg, tree, [seq], [[99]], "cpu")[0]
    b = ref.forward_logits(dict(cfg, sliding_window=None), tree, [seq],
                           [[99]], "cpu")[0]
    assert (a - b).abs().max() > 1e-3


def test_controls_move_the_logits():
    for name in ("tiny-swa", "tiny-moe-int8"):
        cfg = spec.config(name, FIXTURES)
        tree = weights.make(work.dims(cfg), 3, "cpu", torch.float32)
        seq = list(range(3, 60))
        a = ref.forward_logits(cfg, tree, [seq], [[56]], "cpu")[0]
        b = ref.forward_logits(cfg, tree, [seq], [[56]], "cpu",
                               cfg["control"])[0]
        assert (a - b).abs().max() > 1e-3


def _logits(rows=300, vocab=4000, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(rows, vocab, generator=gen) * 1.3 for _ in range(3)]


def _draws(kind, lg, gen):
    """Tokens at each row of ``lg``: drawn as a sampled request at
    temperature 0.8 and top_p 0.95 is served, or with one of its faults."""
    if kind == "temperature ignored":
        return ref.nucleus_draw(lg, [1.0] * 3, [0.95] * 3, gen)
    if kind == "top_p ignored":
        return ref.nucleus_draw(lg, [0.8] * 3, [1.0] * 3, gen)
    good = ref.nucleus_draw(lg, [0.8] * 3, [0.95] * 3, gen)
    if kind == "token altered":
        return [(t + 1) % lg[0].shape[1] for t in good]
    return good


def test_tokens_drawn_as_served_fit_the_nucleus():
    gen = torch.Generator().manual_seed(1)
    lg = _logits()
    fit = ref.sampled_fit(lg, _draws("served", lg, gen), [0.8] * 3,
                          [0.95] * 3)
    assert fit["tokens"] == 900
    assert fit["outside"] == 0.0
    # mean 0, standard error about 1.6 / sqrt(900)
    assert abs(fit["excess"]) < 0.2


@pytest.mark.parametrize("kind", ["temperature ignored", "top_p ignored",
                                  "token altered"])
def test_a_sampler_fault_does_not_fit(kind):
    gen = torch.Generator().manual_seed(2)
    lg = _logits()
    fit = ref.sampled_fit(lg, _draws(kind, lg, gen), [0.8] * 3, [0.95] * 3)
    assert fit["outside"] > 0.02 or fit["excess"] > 0.3, fit


def test_the_nucleus_keeps_ties_and_the_smallest_prefix():
    q = torch.tensor([[0.3, 0.3, 0.2, 0.1, 0.1]])
    above = ref._mass_above(q)
    assert torch.allclose(above, torch.tensor([[0.0, 0.0, 0.6, 0.8, 0.8]]))
    kept = ref._kept(q, 0.7)
    assert kept.tolist() == [[1.0, 1.0, 1.0, 0.0, 0.0]]
    p = ref.nucleus(torch.log(q), 1.0, 0.7)
    assert torch.allclose(p, torch.tensor([[0.375, 0.375, 0.25, 0, 0]]))
