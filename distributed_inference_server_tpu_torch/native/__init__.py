"""The port's native C++ admission tier, reached over a C ABI via ctypes (port
of ``distributed_inference_server_tpu/native/__init__.py``: the queue, the
admission batcher and the request validator; the page allocator is not
ported yet).

``pqueue.cpp``, ``batcher.cpp`` and ``validator.cpp`` (this package's own
copies) have the exact contracts of ``core/queue.py``,
``serving/batcher.py`` and ``core/validator.py``; the Python modules are
the canonical semantics, and ``tests/test_torch_admission.py`` drives both
tiers with the same operation sequences.

The shared library is built with ``g++`` on first use into
``build/native/libdis_torch_native-<hash>.so`` in the checkout (gitignored;
the hash covers the sources and flags, so a stale library is never
loaded). When no compiler is there, ``available()`` is False and the
dispatcher takes the Python tier; it logs the tier it chose.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

_DIR = Path(__file__).resolve().parent
_SOURCES = ("pqueue.cpp", "batcher.cpp", "validator.cpp")
_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def lib_path() -> Path:
    """Where the library for the current sources lives."""
    digest = hashlib.sha1(" ".join(_FLAGS).encode())
    for name in _SOURCES:
        digest.update((_DIR / name).read_bytes())
    return (_DIR.parents[1] / "build" / "native"
            / f"libdis_torch_native-{digest.hexdigest()[:12]}.so")


def _compile(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *_FLAGS, *(str(_DIR / s) for s in _SOURCES), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        # under the lock on purpose: concurrent first callers wait for the
        # one build instead of racing it
        try:
            out = lib_path()
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            _declare(lib)
        except (OSError, RuntimeError, AttributeError,
                subprocess.SubprocessError) as e:
            logger.info("native admission tier unavailable: %s", e)
            _build_failed = True
            return None
        _lib = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    intp = ctypes.POINTER(ctypes.c_int)
    lib.pq_create.restype = ctypes.c_void_p
    lib.pq_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double,
                              ctypes.c_int]
    lib.pq_destroy.argtypes = [ctypes.c_void_p]
    lib.pq_set_config.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_double, ctypes.c_int]
    lib.pq_enqueue.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                               ctypes.c_double]
    lib.pq_dequeue_batch.argtypes = [ctypes.c_void_p, u64p, ctypes.c_int]
    lib.pq_dequeue_one.argtypes = [ctypes.c_void_p, u64p]
    lib.pq_depth.argtypes = [ctypes.c_void_p, intp]
    lib.pq_is_accepting.argtypes = [ctypes.c_void_p]
    lib.pq_remove_expired.argtypes = [ctypes.c_void_p, ctypes.c_double, u64p,
                                      ctypes.c_int]
    lib.pq_cancel.argtypes = [ctypes.c_void_p, ctypes.c_uint64]

    lib.batcher_create.restype = ctypes.c_void_p
    lib.batcher_create.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                   ctypes.c_int]
    lib.batcher_destroy.argtypes = [ctypes.c_void_p]
    lib.batcher_set_config.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                       ctypes.c_int]
    lib.batcher_set_divisor.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.batcher_pending.argtypes = [ctypes.c_void_p]
    lib.batcher_cancel.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.batcher_poll.argtypes = [ctypes.c_void_p, ctypes.c_double, u64p,
                                 ctypes.c_int]
    lib.batcher_flush.argtypes = [ctypes.c_void_p, u64p, ctypes.c_int]

    u8pp = ctypes.POINTER(ctypes.c_char_p)
    lib.val_token_count.restype = ctypes.c_int64
    lib.val_token_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.val_generate.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_void_p, i64p,
    ]
    lib.val_chat.argtypes = [
        u8pp, i64p, ctypes.c_int, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_void_p, i64p,
    ]
    lib.val_embeddings.argtypes = [
        u8pp, i64p, ctypes.c_int, ctypes.c_void_p, i64p, intp,
    ]


def available() -> bool:
    """True when the native library is built (builds on first call)."""
    return _load() is not None


class NativePriorityQueue:
    """ctypes façade over ``pqueue.cpp`` with the contract of
    ``core.queue.PriorityQueueManager`` (no tenant lanes)."""

    def __init__(self, config=None):
        from distributed_inference_server_tpu_torch.core.queue import (
            QueueConfig,
        )

        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._config = config or QueueConfig()
        self._ptr = lib.pq_create(
            self._config.high_watermark, self._config.low_watermark,
            ctypes.c_double(self._config.request_timeout_s),
            self._config.max_queue_size)
        self._next_handle = 1
        self._by_handle: Dict[int, object] = {}
        self._lock = threading.Lock()

    @property
    def config(self):
        return self._config

    @config.setter
    def config(self, cfg) -> None:
        """Push new watermarks, timeout and cap down to the native side."""
        self._config = cfg
        self._lib.pq_set_config(
            self._ptr, cfg.high_watermark, cfg.low_watermark,
            ctypes.c_double(cfg.request_timeout_s), cfg.max_queue_size)

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.pq_destroy(ptr)
            self._ptr = None

    def enqueue(self, request) -> None:
        from distributed_inference_server_tpu_torch.core.errors import (
            QueueFull,
        )

        with self._lock:
            handle = self._next_handle
            # Priority is LOW=0..HIGH=2; the native levels are 0 = High ..
            # 2 = Low
            rc = self._lib.pq_enqueue(
                self._ptr, handle, 2 - int(request.priority),
                ctypes.c_double(request.enqueued_at))
            if rc != 0:
                raise QueueFull()
            self._next_handle += 1
            self._by_handle[handle] = request

    def dequeue_batch(self, max_count: int) -> List:
        out = (ctypes.c_uint64 * max(max_count, 1))()
        with self._lock:
            n = self._lib.pq_dequeue_batch(self._ptr, out, max_count)
            return [self._by_handle.pop(out[i]) for i in range(n)]

    def dequeue_one(self):
        got = self.dequeue_batch(1)
        return got[0] if got else None

    def queue_depth(self):
        from distributed_inference_server_tpu_torch.core.queue import (
            QueueDepth,
        )

        out = (ctypes.c_int * 3)()
        self._lib.pq_depth(self._ptr, out)
        return QueueDepth(high=out[0], normal=out[1], low=out[2],
                          total=out[0] + out[1] + out[2])

    def is_accepting(self) -> bool:
        return bool(self._lib.pq_is_accepting(self._ptr))

    def total_depth(self) -> int:
        return self.queue_depth().total

    def is_empty(self) -> bool:
        return self.total_depth() == 0

    def remove_expired(self, now: Optional[float] = None) -> List:
        now = time.monotonic() if now is None else now
        with self._lock:
            cap = len(self._by_handle) or 1
            out = (ctypes.c_uint64 * cap)()
            n = self._lib.pq_remove_expired(self._ptr, ctypes.c_double(now),
                                            out, cap)
            return [self._by_handle.pop(out[i]) for i in range(min(n, cap))]

    def cancel(self, request_id):
        with self._lock:
            for handle, req in self._by_handle.items():
                if req.id == request_id:
                    if self._lib.pq_cancel(self._ptr, handle):
                        self._by_handle.pop(handle)
                        return req
                    return None
            return None


class NativeAdmissionBatcher:
    """ctypes façade over ``batcher.cpp`` with the contract of
    ``serving.batcher.AdmissionBatcher``. It needs a
    ``NativePriorityQueue``: one native ``batcher_poll`` drains the native
    queue and keeps the window, with no Python per request; handles
    resolve to requests only when a batch is dispatched."""

    def __init__(self, queue: NativePriorityQueue, config=None):
        from distributed_inference_server_tpu_torch.serving.batcher import (
            BatcherConfig,
        )

        if not isinstance(queue, NativePriorityQueue):
            raise TypeError(
                "NativeAdmissionBatcher requires a NativePriorityQueue")
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.queue = queue
        self._config = config or BatcherConfig()
        self._divisor = 1
        self._ptr = lib.batcher_create(
            queue._ptr, ctypes.c_double(self._config.window_ms),
            self._config.max_batch_size)

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.batcher_destroy(ptr)
            self._ptr = None

    @property
    def config(self):
        return self._config

    @config.setter
    def config(self, cfg) -> None:
        self._config = cfg
        self._lib.batcher_set_config(
            self._ptr, ctypes.c_double(cfg.window_ms), cfg.max_batch_size)

    @property
    def size_divisor(self) -> int:
        return self._divisor

    @size_divisor.setter
    def size_divisor(self, d: int) -> None:
        self._divisor = d
        self._lib.batcher_set_divisor(self._ptr, int(d))

    def effective_max_batch(self) -> int:
        return max(1, self._config.max_batch_size // max(1, self._divisor))

    def pending_count(self) -> int:
        return self._lib.batcher_pending(self._ptr)

    def cancel(self, request_id):
        """Remove a request still waiting in the batching window. Returns
        the removed request or None."""
        with self.queue._lock:
            for handle, req in self.queue._by_handle.items():
                if req.id == request_id:
                    if self._lib.batcher_cancel(self._ptr, handle):
                        self.queue._by_handle.pop(handle)
                        return req
                    return None
        return None

    def _resolve(self, out, n):
        with self.queue._lock:
            return [self.queue._by_handle.pop(out[i]) for i in range(n)]

    def _batch(self, out, n, now):
        from distributed_inference_server_tpu_torch.core.types import (
            new_batch_id,
        )
        from distributed_inference_server_tpu_torch.serving.batcher import (
            AdmissionBatch,
        )

        return AdmissionBatch(new_batch_id(), self._resolve(out, n), now)

    def poll(self, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        cap = max(1, self.effective_max_batch())
        out = (ctypes.c_uint64 * cap)()
        n = self._lib.batcher_poll(self._ptr, ctypes.c_double(now), out, cap)
        return self._batch(out, n, now) if n > 0 else None

    def flush(self, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        cap = max(1, self.pending_count())
        out = (ctypes.c_uint64 * cap)()
        n = self._lib.batcher_flush(self._ptr, out, cap)
        return self._batch(out, n, now) if n > 0 else None


class _ValLimits(ctypes.Structure):
    _fields_ = [
        ("max_context_tokens", ctypes.c_int64),
        ("max_output_tokens", ctypes.c_int64),
        ("min_temperature", ctypes.c_double),
        ("max_temperature", ctypes.c_double),
        ("min_top_p", ctypes.c_double),
        ("max_top_p", ctypes.c_double),
    ]


class NativeRequestValidator:
    """``validator.cpp`` with the decisions of ``core/validator.py``: the
    same check order, the same ceil(codepoints / 4) token estimate and the
    same Unicode-whitespace blank rule. The native side scans and checks
    accepted requests; any rejection, and any input the C ABI cannot carry
    (lone surrogates), goes to the Python validator, so the raised
    exceptions are the Python tier's by construction."""

    def __init__(self, config=None):
        from distributed_inference_server_tpu_torch.core.validator import (
            RequestValidator,
            ValidatorConfig,
        )

        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.config = config or ValidatorConfig()
        self._py = RequestValidator(self.config)
        c = self.config
        self._lim = _ValLimits(c.max_context_tokens, c.max_output_tokens,
                               c.min_temperature, c.max_temperature,
                               c.min_top_p, c.max_top_p)

    @staticmethod
    def _carr(items):
        n = len(items)
        arr = (ctypes.c_char_p * max(1, n))(*items)
        lens = (ctypes.c_int64 * max(1, n))(*[len(c) for c in items])
        return arr, lens, n

    @staticmethod
    def _clamp64(v: int) -> int:
        # c_int64 wraps out-of-range ints: clamp so over the limit stays
        # over it (the rejection re-runs the Python validator anyway)
        return max(-(2**62), min(int(v), 2**62))

    def token_count(self, text: str) -> int:
        return self._py.token_count(text)

    def validate_generate(self, request):
        try:
            b = request.prompt.encode("utf-8")
        except UnicodeEncodeError:
            return self._py.validate_generate(request)
        toks = ctypes.c_int64(0)
        rc = self._lib.val_generate(
            b, len(b), self._clamp64(request.max_tokens),
            float(request.temperature), float(request.top_p),
            ctypes.byref(self._lim), ctypes.byref(toks))
        return request if rc == 0 else self._py.validate_generate(request)

    def validate_chat(self, request):
        try:
            contents = [m.content.encode("utf-8") for m in request.messages]
        except UnicodeEncodeError:
            return self._py.validate_chat(request)
        arr, lens, n = self._carr(contents)
        toks = ctypes.c_int64(0)
        rc = self._lib.val_chat(
            arr, lens, n, self._clamp64(request.max_tokens),
            float(request.temperature), float(request.top_p),
            ctypes.byref(self._lim), ctypes.byref(toks))
        return request if rc == 0 else self._py.validate_chat(request)

    def validate_embeddings(self, request):
        try:
            inputs = [t.encode("utf-8") for t in request.input_list()]
        except UnicodeEncodeError:
            return self._py.validate_embeddings(request)
        arr, lens, n = self._carr(inputs)
        toks = ctypes.c_int64(0)
        idx = ctypes.c_int(0)
        rc = self._lib.val_embeddings(arr, lens, n, ctypes.byref(self._lim),
                                      ctypes.byref(toks), ctypes.byref(idx))
        return request if rc == 0 else self._py.validate_embeddings(request)


def make_validator(config=None, native: Optional[bool] = None):
    """The validator tier: native when the library builds (``native=True``
    requires it), the Python validator otherwise or with
    ``native=False``."""
    from distributed_inference_server_tpu_torch.core.validator import (
        RequestValidator,
    )

    if native is False:
        return RequestValidator(config)
    if available():
        return NativeRequestValidator(config)
    if native is True:
        raise RuntimeError("native validator forced but library unavailable")
    return RequestValidator(config)


__all__ = ["available", "NativePriorityQueue", "NativeAdmissionBatcher",
           "NativeRequestValidator", "make_validator"]
