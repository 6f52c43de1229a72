"""The load schedule repeats exactly for a seed and offers the same work
on every seed; the tokenizer's pieces round-trip."""

from __future__ import annotations

from benchmark import loadgen, spec, tokenizer


def _sizes(reqs):
    return sorted((len(r["prompt_ids"]), r["max_tokens"], r["greedy"])
                  for r in reqs)


def test_schedule_repeats_for_a_seed():
    w = spec.workload("mistral-7b.chat")
    a = loadgen.schedule(w, 2**31 + 17, 20.0, 32000)
    b = loadgen.schedule(w, 2**31 + 17, 20.0, 32000)
    assert a == b


def test_seeds_reorder_the_same_work():
    w = spec.workload("mistral-7b.longctx")
    a = loadgen.schedule(w, 1, 30.0, 32000)
    b = loadgen.schedule(w, 2**40 + 3, 30.0, 32000)
    assert _sizes(a) == _sizes(b)
    assert [r["prompt_ids"] for r in a] != [r["prompt_ids"] for r in b]
    # the same instants, other requests at them
    assert [r["at"] for r in a] == [r["at"] for r in b]
    assert a[0]["at"] == 0.0
    assert [r["max_tokens"] for r in a] != [r["max_tokens"] for r in b]
    # each block of 8 consecutive requests holds the same sizes
    for b0 in range(0, len(a), 8):
        assert _sizes(a[b0:b0 + 8]) == _sizes(b[b0:b0 + 8])
    assert max(r["at"] for r in a) < 30.0


def test_lengths_keep_to_the_file():
    w = spec.workload("mistral-7b.longctx")
    reqs = loadgen.schedule(w, 9, 40.0, 32000)
    p, o = w["prompt_tokens"], w["output_tokens"]
    for r in reqs:
        assert p["min"] <= len(r["prompt_ids"]) <= p["max"]
        assert o["min"] <= r["max_tokens"] <= o["max"]
        assert r["prompt_ids"][0] == 1
        assert min(r["prompt_ids"][1:]) >= loadgen.FIRST_ORDINARY_ID
    chat = loadgen.schedule(spec.workload("mistral-7b.chat"), 9, 40.0,
                            32000)
    greedy = sum(r["greedy"] for r in chat)
    assert greedy == round(len(chat) / 2)
    assert all(r["temperature"] == 0.0 for r in chat if r["greedy"])


def test_pieces_round_trip():
    tok = tokenizer.PieceTokenizer(32000)
    ids = [3, 4, 31999, 257, 12345]
    text = tokenizer.text_of(ids)
    assert len(text) == 3 * len(ids)
    assert tok.encode(text) == [1] + ids
    assert [tok.decode_token(i) for i in ids] == [
        text[3 * k:3 * k + 3] for k in range(len(ids))]
    assert len({tokenizer.piece(i) for i in range(32000)}) == 32000
