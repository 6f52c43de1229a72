"""The port's looped decode blocks and K-block mixed step against the JAX
engine on the model families, step by step; and the sliding-window page
reclaim against the JAX engine's.

The cases, weights and lockstep checks of
``tests/test_torch_engine_families.py`` (every step's outputs, block
tables with their reclaim sentinels, reclaimed prefixes and ``reclaim``
counts equal; the port's page books balance, the device free-list of the
looped blocks included), with ``loop_to_completion`` (looped blocks of at
most 16 iterations, K = 4) alone and with the mixed step. Then
``TINY_SWA`` past its window: rows that decode far beyond it hold
sentinel entries and the pool serves more tokens than it has slots, in
each step mode, as the JAX engine does.
"""

import pytest

from test_torch_engine_families import CASES, lockstep, make_engines

LOOP = dict(loop_to_completion=True, loop_max_steps=16, decode_block_size=4)
MODES = {
    "loop": LOOP,
    "mixed-kblock": dict(mixed_step_tokens=24, **LOOP),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_family_engine_matches_jax(case, mode):
    je, te = make_engines(case, **MODES[mode])
    toks, reclaimed = lockstep(je, te)
    assert set(toks) == {"r0", "r1", "r2", "r3"}
    assert (reclaimed > 0) == (case == "swa")
    assert te.loop_stats()["blocks"] > 0


# rows decoding 40-48 tokens past an 8-token window over 4-token pages
LONG_SCRIPT = [
    ("add", "a", "sliding window row one", 48),
    ("add", "b", "row two", 40),
    ("steps", 2),
    ("add", "c", "a third row that arrives late", 44),
]


@pytest.mark.parametrize("mode", ["depth1", "mixed", "loop"])
@pytest.mark.parametrize("num_pages", [64, 10])
def test_window_reclaim_matches_jax(mode, num_pages):
    """64 pages: no pressure; 10 pages (40 slots for 3 rows of up to 74
    tokens): the rows finish only because pages behind the window return
    to the pool, and the late row waits for them at admission
    (``cache_full``). Tables, sentinels, events and tokens equal the JAX
    engine's at every step."""
    kw = {"depth1": dict(pipeline_depth=1),
          "mixed": dict(mixed_step_tokens=24),
          "loop": LOOP}[mode]
    je, te = make_engines("swa", paged=(num_pages, 4, 24), **kw)
    sentinel_seen = []
    step = te.step

    def watched_step():
        out = step()
        sentinel_seen.extend(rid for rid, s in te._by_id.items()
                             if num_pages in s.block_table)
        return out

    te.step = watched_step
    toks, reclaimed = lockstep(je, te, LONG_SCRIPT)
    assert {len(t) for t in toks.values()} == {48, 40, 44}
    assert reclaimed >= 3 * 8  # every row freed pages behind its window
    assert set(sentinel_seen) == {"a", "b", "c"}
    assert te._sc_events == je._sc_events | {"retrace": 0}
    assert (te._sc_events["cache_full"] > 0) == (num_pages == 10)
    assert vars(te.cache_stats()) == vars(je.allocator.stats())
