"""The port's native C++ serving tier, reached over a C ABI via ctypes (port
of ``distributed_inference_server_tpu/native/__init__.py``: the queue, the
admission batcher, the request validator and the page allocator).

``pqueue.cpp``, ``batcher.cpp``, ``validator.cpp`` and ``allocator.cpp``
(this package's own copies) have the exact contracts of ``core/queue.py``,
``serving/batcher.py``, ``core/validator.py`` and ``engine/kv_cache.py``'s
``PageAllocator``; the Python modules are the canonical semantics, and
``tests/test_torch_admission.py`` and ``tests/test_torch_kv_bytes.py``
drive both tiers with the same operation sequences. The native allocator
content-addresses pages by its own FNV-1a chain, so it has no prefix
digest, no ``cached_page`` and no offload hook; the engine takes the
Python allocator when the host tier needs the hook.

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
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

_DIR = Path(__file__).resolve().parent
_SOURCES = ("pqueue.cpp", "batcher.cpp", "validator.cpp", "allocator.cpp")
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

    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.pa_create.restype = ctypes.c_void_p
    lib.pa_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pa_destroy.argtypes = [ctypes.c_void_p]
    lib.pa_num_free.argtypes = [ctypes.c_void_p]
    lib.pa_match_prefix.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int, i32p]
    lib.pa_allocate.argtypes = [ctypes.c_void_p, ctypes.c_int, i32p]
    lib.pa_publish.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int, i32p,
                               ctypes.c_int]
    lib.pa_retain.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int]
    lib.pa_release.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int]
    lib.pa_touch.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int]
    lib.pa_evict_below.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.pa_stats.argtypes = [ctypes.c_void_p, i64p]
    lib.pa_snapshot_sizes.argtypes = [ctypes.c_void_p, i64p]
    lib.pa_snapshot.argtypes = [ctypes.c_void_p, ctypes.c_int64, i32p,
                                ctypes.c_int64, i32p, ctypes.c_int64, i32p,
                                i32p, i32p]

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


def _i32arr(values: Sequence[int]):
    return (ctypes.c_int32 * max(len(values), 1))(*values)


class NativePageAllocator:
    """ctypes façade over ``allocator.cpp`` with the contract of
    ``engine.kv_cache.PageAllocator`` (a drop-in for the engine), audit
    included (over ``pa_snapshot``'s copy of the books)."""

    def __init__(self, cfg):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.cfg = cfg
        self._ptr = lib.pa_create(cfg.num_pages, cfg.page_size)
        # pages drawn onto a looped block's device free-list: tracked here
        # (the native core sees a plain allocate; returned pages go back
        # through release())
        self._device_held: set = set()

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.pa_destroy(ptr)
            self._ptr = None

    def num_free(self) -> int:
        return self._lib.pa_num_free(self._ptr)

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        out = (ctypes.c_int32 * max(len(tokens) // self.cfg.page_size, 1))()
        n = self._lib.pa_match_prefix(self._ptr, _i32arr(list(tokens)),
                                      len(tokens), out)
        return [out[i] for i in range(n)], n * self.cfg.page_size

    def allocate(self, n: int) -> List[int]:
        from distributed_inference_server_tpu_torch.core.errors import (
            CacheFull,
        )

        out = (ctypes.c_int32 * max(n, 1))()
        if self._lib.pa_allocate(self._ptr, n, out) != 0:
            raise CacheFull()
        return [out[i] for i in range(n)]

    def draw_device(self, n: int) -> List[int]:
        """``PageAllocator.draw_device``: up to ``n`` pages (free list
        first, then LRU reclaim) into the DEVICE-HELD state; a partial
        draw never raises."""
        m = min(n, self.num_free())
        if m <= 0:
            return []
        pages = self.allocate(m)
        self._device_held.update(pages)
        return pages

    def reconcile_device(self, claimed: Sequence[int],
                         returned: Sequence[int]) -> None:
        """``PageAllocator.reconcile_device``: ``claimed`` pages are now
        live-held, ``returned`` ones go back to the free list."""
        for pid in list(claimed) + list(returned):
            if pid not in self._device_held:
                raise ValueError(f"page {pid} reconciled but not "
                                 "device-held")
            self._device_held.discard(pid)
        if returned:
            self.release(list(returned))

    def device_held(self) -> int:
        return len(self._device_held)

    def publish(self, tokens: Sequence[int], page_ids: Sequence[int]) -> None:
        self._lib.pa_publish(self._ptr, _i32arr(list(tokens)), len(tokens),
                             _i32arr(list(page_ids)), len(page_ids))

    def retain(self, page_ids: Sequence[int]) -> None:
        self._lib.pa_retain(self._ptr, _i32arr(list(page_ids)), len(page_ids))

    def release(self, page_ids: Sequence[int]) -> None:
        self._lib.pa_release(self._ptr, _i32arr(list(page_ids)),
                             len(page_ids))

    def touch(self, page_ids: Sequence[int]) -> None:
        self._lib.pa_touch(self._ptr, _i32arr(list(page_ids)), len(page_ids))

    def evict_below(self, target_frac: float) -> int:
        return self._lib.pa_evict_below(self._ptr,
                                        ctypes.c_double(target_frac))

    def stats(self):
        from distributed_inference_server_tpu_torch.engine.kv_cache import (
            CacheStats,
        )

        out = (ctypes.c_int64 * 6)()
        self._lib.pa_stats(self._ptr, out)
        hits, misses, evictions, total, free, cached = (int(x) for x in out)
        return CacheStats(
            hits=hits, misses=misses, evictions=evictions, pages_total=total,
            pages_free=free, pages_cached=cached,
            memory_used_frac=1.0 - (free + cached) / total if total else 0.0)

    def hit_rate(self) -> float:
        s = self.stats()
        total = s.hits + s.misses
        return s.hits / total if total else 0.0

    def _snapshot(self):
        """(free list, LRU oldest first, {page: (refcount, in_lru)})."""
        while True:
            sizes = (ctypes.c_int64 * 3)()
            self._lib.pa_snapshot_sizes(self._ptr, sizes)
            nf, nl, na = (int(x) for x in sizes)
            bufs = [(ctypes.c_int32 * max(n, 1))() for n in
                    (nf, nl, na, na, na)]
            if self._lib.pa_snapshot(self._ptr, nf, bufs[0], nl, bufs[1], na,
                                     bufs[2], bufs[3], bufs[4]) == 0:
                break
        free, lru = list(bufs[0][:nf]), list(bufs[1][:nl])
        addressed = {bufs[2][i]: (bufs[3][i], bool(bufs[4][i]))
                     for i in range(na)}
        return free, lru, addressed

    def audit(self, live_pages: Optional[Sequence[int]] = None) -> List[str]:
        """``PageAllocator.audit`` over the native books: free-list
        uniqueness and range, free and device-held pages never addressed,
        refcount 0 exactly for LRU pages; with ``live_pages`` (every page
        a live holder references, with multiplicity) conservation and
        refcounts equal to holder counts. Returns inconsistency strings
        (empty = clean)."""
        issues: List[str] = []
        bad = issues.append
        total = self.cfg.num_pages
        free, lru, addressed = self._snapshot()
        free_set, lru_set = set(free), set(lru)
        if len(free_set) != len(free):
            bad(f"free list holds duplicates ({len(free) - len(free_set)})")
        for pid in free_set:
            if not 0 <= pid < total:
                bad(f"free page {pid} out of range [0, {total})")
            if pid in addressed:
                bad(f"page {pid} is both free and content-addressed")
        for pid in self._device_held:
            if pid in free_set or pid in addressed:
                bad(f"device-held page {pid} is free or content-addressed")
        for pid in lru_set - set(addressed):
            bad(f"LRU page {pid} is not content-addressed")
        for pid, (ref, in_lru) in addressed.items():
            if ref < 0:
                bad(f"page {pid} refcount {ref} < 0")
            if (ref == 0) != (pid in lru_set) or in_lru != (pid in lru_set):
                bad(f"page {pid}: refcount {ref} disagrees with the LRU")
        if live_pages is not None:
            from distributed_inference_server_tpu_torch.engine.kv_cache import (
                audit_live_pages,
            )

            refs = {pid: ref for pid, (ref, _) in addressed.items()}
            audit_live_pages(bad, total, free_set, lru_set, refs,
                             self._device_held, live_pages)
        return issues


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
           "NativePageAllocator",
           "NativeRequestValidator", "make_validator"]
