"""The port's native tier under contention (``native/stress.cpp``, the
counterpart of the JAX package's harness that ``tests/test_native.py``
runs): producer, consumer, canceller, config-writer and audit threads
hammer the queue, the admission batcher and the page allocator through the
C ABI, built by ``native.build_stress`` into the gitignored
``build/native/``. Under ThreadSanitizer with ``halt_on_error=1`` any data
race aborts the binary; the plain build checks the locks' correctness
under contention (every page back at the end, the audit's books
consistent while they change)."""

import os
import shutil
import subprocess

import pytest

from distributed_inference_server_tpu_torch import native


def _needs_compiler() -> None:
    if not (os.environ.get("CXX") or shutil.which("g++")
            or shutil.which("c++")):
        pytest.skip("no C++ compiler")


def _run_stress(kind: str, env_extra=None) -> str:
    _needs_compiler()
    path = native.build_stress((kind,))[kind]
    env = dict(os.environ, **(env_extra or {}))
    run = subprocess.run([str(path)], capture_output=True, timeout=600,
                         env=env, text=True)
    assert run.returncode == 0, (
        f"stress_{kind} failed:\n{run.stdout[-1000:]}\n{run.stderr[-3000:]}")
    assert "stress OK" in run.stdout
    return run.stdout


def test_native_stress_tsan():
    """The whole tier (queue, batcher, allocator with its audit snapshot)
    hammered from concurrent threads under ThreadSanitizer."""
    _run_stress("tsan", {"TSAN_OPTIONS": "halt_on_error=1"})


def test_native_stress_plain():
    _run_stress("plain")


def test_stress_builds_are_keyed_by_sources_and_flags():
    """Both binaries live under ``build/native/`` with the hash of their
    sources and flags in the name, apart from each other and from the
    library, and a second call reuses them."""
    _needs_compiler()
    first = native.build_stress()
    assert set(first) == {"tsan", "plain"}
    build_dir = native.lib_path().parent
    for kind, path in first.items():
        assert path.parent == build_dir
        assert path.name.startswith(f"stress_{kind}-")
    assert first["tsan"].name[-12:] != first["plain"].name[-12:]
    mtimes = {k: p.stat().st_mtime_ns for k, p in first.items()}
    again = native.build_stress()
    assert again == first
    assert {k: p.stat().st_mtime_ns for k, p in again.items()} == mtimes
