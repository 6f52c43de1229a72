"""Kernel launch counters: the process total of each wrapper
(``<wrapper>.launches``) and the launches each thread made.

A wrapper calls ``count(fn)`` where it launches its kernel, and nowhere
else. The process total is updated under one lock, so two engine threads
never lose an increment. Each thread also keeps its own tally: an engine
runs on one thread, so its replica's launches are that thread's
(``thread_counts``). ``recording()`` collects what the calling thread
launches inside the block and nothing another thread launches meanwhile:
a CUDA graph capture uses it to learn the launches its graph will replay
while a second replica serves beside it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List

_lock = threading.Lock()
_tls = threading.local()
# every thread's tally, so a reset reaches them all (guarded by _lock)
_tallies: List[Dict[str, int]] = []
_names: List[str] = []


def register(fn, name: str) -> None:
    """Give wrapper ``fn`` its kernel name and a zero process total."""
    fn.kernel_name = name
    fn.launches = 0
    _names.append(name)


def _tally() -> Dict[str, int]:
    t = getattr(_tls, "tally", None)
    if t is None:
        t = dict.fromkeys(_names, 0)
        _tls.tally = t
        _tls.recordings = []
        with _lock:
            _tallies.append(t)
    return t


def count(fn, n: int = 1) -> None:
    """``n`` launches of ``fn``'s kernel by the calling thread."""
    with _lock:
        fn.launches += n
    name = fn.kernel_name
    tally = _tally()
    tally[name] = tally.get(name, 0) + n
    for rec in _tls.recordings:
        rec[name] = rec.get(name, 0) + n


def add(kernels: Dict[str, object], counts: Dict[str, int],
        sign: int = 1) -> None:
    """Add ``sign * counts[name]`` to the process totals and the calling
    thread's tally (a graph replay, or a capture taking its launches
    back); not seen by a recording."""
    tally = _tally()
    with _lock:
        for name, n in counts.items():
            kernels[name].launches += sign * n
    for name, n in counts.items():
        tally[name] = tally.get(name, 0) + sign * n


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """The calling thread's launches inside the block, by kernel name."""
    _tally()
    rec: Dict[str, int] = {}
    _tls.recordings.append(rec)
    try:
        yield rec
    finally:
        _tls.recordings.remove(rec)


def thread_counts() -> Dict[str, int]:
    """The calling thread's tally: a live dict, written only by this
    thread (other threads read copies)."""
    return _tally()


def reset(kernels: Dict[str, object]) -> None:
    with _lock:
        for fn in kernels.values():
            fn.launches = 0
        for t in _tallies:
            for name in t:
                t[name] = 0
