"""Build the package's CUDA sources with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, ints, floats
and the CUDA stream; every function returns ``cudaGetLastError()``), so it
compiles in seconds: no PyTorch headers. The shared library lands in
``build/kernels/lib<name>-<hash>.so`` in the checkout (gitignored), where
the hash covers the source and the flags — a stale library is never loaded, and concurrent
processes (the server and ``chip_smoke.py``) share one build.

Nothing here runs at import time: the first kernel launch builds. A build
failure raises. ``ticket_buffer`` keeps the zeroed int32 counters with which
a kernel's last block finds that it is last (the split merges of the
quantized matmul and the paged decode).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              *ARCH_FLAGS]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_tickets: Dict[tuple, list] = {}
# the compiler's report of each source built with verbose=True
reports: Dict[str, str] = {}


def build_root() -> Path:
    """Root of the gitignored build tree (``<checkout>/build``)."""
    return _PKG_DIR.parent / "build"


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME)")


def _lib_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_root() / "kernels" / f"lib{name}-{digest.hexdigest()[:12]}.so"


def compile_source(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists.
    ``verbose`` adds ``-Xptxas -v``, prints the compiler's report
    (registers, shared memory, spills per kernel) and keeps it in
    ``reports[name]``. Returns the path."""
    out = _lib_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        reports[name] = proc.stdout + proc.stderr
        print(f"[build] {' '.join(cmd)}\n{reports[name]}", flush=True)
    os.replace(tmp, out)
    return out


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every source in parallel (one nvcc per file, all started
    together)."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(lambda n: compile_source(n, verbose), names))
    return dict(zip(names, paths))


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(compile_source(name)))
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ticket_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters for the kernels launched on ``stream``,
    zeroed once here. Every kernel that takes a ticket puts it back to zero
    before it ends, so one buffer serves every launch on the stream, one
    after another, without a memset per call. A buffer too small for ``n``
    is replaced but kept alive: a captured CUDA graph may still use it."""
    bufs = _tickets.setdefault((device.index, stream), [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=device))
    return bufs[-1]
