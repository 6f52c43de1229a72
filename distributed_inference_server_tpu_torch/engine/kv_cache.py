"""Paged KV cache: device page pool + host-side allocator with prefix reuse
(port of ``distributed_inference_server_tpu/engine/kv_cache.py``: the pool,
``flat_slots``, the chain hashes and the Python ``PageAllocator``).

K/V live in a fixed pool of device pages per layer and sequences hold
block tables (page-id lists):

- **Prefix reuse**: full pages are content-addressed by a hash chain over
  token blocks; a new request walks the chain and shares every matching
  page (refcounted; shared pages are never written — the first divergent
  token starts a fresh page).
- **LRU eviction**: pages whose refcount drops to zero stay in the prefix
  cache, reclaimed least-recently-used first when the free list runs dry.

- **KV byte paths**: a sequence's pages serialize into self-describing
  KVP1 payloads (``serialize_kv``; streamed as crc-guarded ``KvChunk``
  groups by ``serialize_kv_chunks``), raw, wire-quantized to int8, as
  native ``QuantPool`` codes, or projected into a rank-r latent by a
  ``LatentCodec``; ``deserialize_kv`` and ``KvImportSession`` restore them
  into a live pool. The bytes are the JAX package's, dtype names
  included (bf16 travels as its raw 2-byte words), so a payload exported by
  either package imports into the other.
- **Host tier**: ``HostTier`` keeps LRU-evicted prefix pages in host RAM
  (raw, int8 or latent) under a byte budget, fed by the allocator's
  ``offload_hook``.

Device pools are written IN PLACE (``index_copy_``): the engine's captured
CUDA graphs read them by address. Device->host pulls go into pinned host
memory with non-blocking copies and are read only behind a CUDA event.
"""

from __future__ import annotations

import heapq
import logging
import struct
import warnings
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import (
    Callable,
    Deque,
    Dict,
    Iterator,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Set,
    Tuple,
)

import numpy as np
import torch

from distributed_inference_server_tpu_torch.core.errors import (
    CacheDeserializationError,
    CacheFull,
)
from distributed_inference_server_tpu_torch.models.configs import ModelConfig
from distributed_inference_server_tpu_torch.ops.quant import (
    QuantPool,
    quantize_kv,
)

logger = logging.getLogger(__name__)


def _fault(point: str) -> bool:
    """Fault-injection trampoline (``serving/faults.py``). The engine layer
    does not import the serving package when it is imported, so the first
    call resolves the real ``fire`` and rebinds this name: from then on an
    injection point costs what it costs in the serving layer, one global
    load and a ``None`` check."""
    global _fault
    from distributed_inference_server_tpu_torch.serving.faults import fire
    _fault = fire
    return fire(point)

KV_QUANTS = ("none", "int8")


@dataclass(frozen=True)
class PagedCacheConfig:
    num_pages: int = 1024
    page_size: int = 16  # tokens per page
    max_pages_per_seq: int = 128  # 2048-token context per sequence

    @property
    def max_seq_len(self) -> int:
        return self.page_size * self.max_pages_per_seq


class PagedKVState:
    """Device pools for the paged cache: k, v are
    [num_layers, num_pages * page_size + 1, num_kv_heads, head_dim], or
    with ``kv_quant="int8"`` ``QuantPool`` pairs of int8 codes of that
    shape and f32 scales [num_layers, num_pages * page_size + 1,
    num_kv_heads].

    The one slot past ``num_pages * page_size`` is the drop slot that
    padded and inactive writes land in (``models/llama.py``
    ``make_paged_write_fn``); readers see ``pool[l, :-1]``. The engine
    updates the pools in place and is their only holder."""

    __slots__ = ("k", "v")

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k
        self.v = v

    @classmethod
    def create(cls, cfg: ModelConfig, pcfg: PagedCacheConfig,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda",
               kv_quant: str = "none") -> "PagedKVState":
        shape = (cfg.num_layers, pcfg.num_pages * pcfg.page_size + 1,
                 cfg.num_kv_heads, cfg.head_dim)
        if kv_quant == "int8":
            def pool():
                return QuantPool(
                    torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device))

            return cls(pool(), pool())
        if kv_quant != "none":
            raise ValueError(
                f"unknown kv_quant {kv_quant!r}; known: none|int8")
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def flat_slots(block_tables: torch.Tensor, positions: torch.Tensor,
               page_size: int) -> torch.Tensor:
    """Map absolute positions [B, T] to flat pool slots through the block
    tables [B, max_pages]. Positions past the table clamp to its last
    entry (callers mask those writes with the drop slot)."""
    page_idx = (positions // page_size).clamp(max=block_tables.shape[1] - 1)
    offset = positions % page_size
    rows = torch.arange(block_tables.shape[0],
                        device=block_tables.device)[:, None]
    return block_tables[rows, page_idx] * page_size + offset


# ---------------------------------------------------------------------------
# Host-side page allocator with prefix cache
# ---------------------------------------------------------------------------


def _chunk_hash(prev: int, tokens: Tuple[int, ...]) -> int:
    """Stable hash chain over token blocks (content address of a full page);
    int/tuple hashing is not seeded, so the hashes equal the JAX
    package's."""
    h = hash((prev,) + tokens)
    return h & 0x7FFFFFFFFFFFFFFF


def iter_chain_hashes(tokens: Sequence[int], page_size: int) -> Iterator[int]:
    """Yield hash i (addressing pages 0..i) of the full pages of
    ``tokens``, lazily."""
    h = 0
    for start in range(0, len(tokens) - page_size + 1, page_size):
        h = _chunk_hash(h, tuple(tokens[start : start + page_size]))
        yield h


#: chain depth covered by prefix digests (first-K page hashes per chain)
DIGEST_DEPTH = 8


def chain_hashes(tokens: Sequence[int], page_size: int,
                 max_pages: Optional[int] = None) -> List[int]:
    """Content-address hash chain over the full pages of ``tokens``."""
    it = iter_chain_hashes(tokens, page_size)
    if max_pages is not None:
        return [h for h, _ in zip(it, range(max_pages))]
    return list(it)


class PageVictim(NamedTuple):
    """One LRU-evicted content-addressed page, as handed to the offload
    hook (batched): identity and chain coordinates."""

    page_id: int
    hash: int
    depth: int
    root: int


@dataclass
class _CachedPage:
    page_id: int
    refcount: int = 0
    # chain position of the page's content address (0 = first page of a
    # prefix) and the depth-0 hash of its chain, set by publish: they
    # drive digest truncation and the host tier's eviction order
    depth: int = 0
    root: int = 0


@dataclass(frozen=True)
class CacheStats:
    hits: int
    misses: int
    evictions: int
    pages_total: int
    pages_free: int
    pages_cached: int  # refcount-0 pages retained for prefix reuse
    memory_used_frac: float

    def to_dict(self) -> Dict[str, object]:
        return dict(self.__dict__)


def audit_live_pages(bad, total: int, free_set: set, lru_set: set,
                     refcounts: Dict[int, int], device_held,
                     live_pages: Sequence[int]) -> None:
    """The live-holder half of an allocator audit, shared by both tiers:
    every page a live holder references (with multiplicity) is in range,
    neither free nor device-held, and holds a refcount equal to its
    holders; every referenced page has a holder; and every page is
    exactly one of free / cached / live / device-held. ``refcounts``
    maps each content-addressed page to its refcount; each finding goes
    to ``bad``."""
    held: Dict[int, int] = {}
    for pid in live_pages:
        held[pid] = held.get(pid, 0) + 1
    for pid, count in held.items():
        if not 0 <= pid < total:
            bad(f"live page {pid} out of range [0, {total})")
            continue
        if pid in free_set:
            bad(f"live page {pid} is on the free list (use-after-free)")
        if pid in device_held:
            bad(f"live page {pid} is still device-held "
                "(unreconciled device draw)")
        if pid in refcounts:
            if refcounts[pid] != count:
                bad(f"page {pid}: refcount {refcounts[pid]} != {count} "
                    "live holders")
        elif count != 1:
            bad(f"unaddressed page {pid} held by {count} holders "
                "(pages can only be shared once published)")
    for pid, ref in refcounts.items():
        if ref > 0 and held.get(pid, 0) == 0:
            bad(f"page {pid}: refcount {ref} with no live holder "
                "(leaked reference)")
    live = len(set(held) - lru_set)
    accounted = len(free_set) + len(lru_set) + live + len(device_held)
    if accounted != total:
        bad(f"conservation: {len(free_set)} free + {len(lru_set)} cached + "
            f"{live} live + {len(device_held)} device-held = {accounted}, "
            f"pool has {total} ({total - accounted:+d} leaked)")


class PageAllocator:
    """Host bookkeeping for the device page pool. Pages are FREE (never
    cached / evicted), ACTIVE (refcount > 0), CACHED (refcount 0 but
    content-addressed, reclaimable LRU) or DEVICE-HELD (drawn onto a
    looped decode block's device free-list until its reconcile).
    Single-owner: the engine thread."""

    def __init__(self, cfg: PagedCacheConfig):
        self.cfg = cfg
        self._free: List[int] = list(range(cfg.num_pages - 1, -1, -1))
        self._by_hash: Dict[int, _CachedPage] = {}
        self._by_page: Dict[int, Tuple[int, _CachedPage]] = {}
        # refcount-0 content-addressed pages, oldest first: page_id -> hash
        self._lru: "OrderedDict[int, int]" = OrderedDict()
        # pages on an in-flight looped block's device free-list
        self._device_held: Set[int] = set()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        # host-tier demotion hook: called ONCE per eviction burst with the
        # whole victim batch, BEFORE any evicted id is handed back, so the
        # hook can pull the pages' K/V while it is intact. Its failure
        # degrades to a plain drop: eviction itself never fails.
        self.offload_hook: Optional[Callable[[List[PageVictim]], None]] = None

    # -- queries -----------------------------------------------------------

    def num_free(self) -> int:
        """Pages allocatable right now (free list + LRU-reclaimable)."""
        return len(self._free) + len(self._lru)

    def stats(self) -> CacheStats:
        cached = len(self._lru)
        return CacheStats(
            hits=self._hits,
            misses=self._misses,
            evictions=self._evictions,
            pages_total=self.cfg.num_pages,
            pages_free=len(self._free),
            pages_cached=cached,
            memory_used_frac=1.0 - (len(self._free) + cached)
            / self.cfg.num_pages,
        )

    def hit_rate(self) -> float:
        total = self._hits + self._misses
        return self._hits / total if total else 0.0

    # -- prefix matching ---------------------------------------------------

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest-prefix match over full pages. Returns (shared page ids,
        matched token count); each returned page gains a reference (and
        leaves the LRU). Each matched page is a hit; the lookup that breaks
        the chain is one miss."""
        ps = self.cfg.page_size
        shared: List[int] = []
        for h in iter_chain_hashes(tokens, ps):
            entry = self._by_hash.get(h)
            if entry is None:
                self._misses += 1
                break
            if entry.refcount == 0:
                self._lru.pop(entry.page_id, None)
            entry.refcount += 1
            shared.append(entry.page_id)
            self._hits += 1
        return shared, len(shared) * ps

    # -- allocation --------------------------------------------------------

    def allocate(self, n: int) -> List[int]:
        """Allocate n fresh pages: free-list pages first, then LRU-evicted
        cached pages. Raises CacheFull when not enough pages exist."""
        if self.num_free() < n:
            raise CacheFull()
        deficit = n - len(self._free)
        evicted = self._evict_lru_batch(deficit) if deficit > 0 else []
        out: List[int] = []
        while len(out) < n - len(evicted):
            out.append(self._free.pop())
        out.extend(evicted)
        return out

    def draw_device(self, n: int) -> List[int]:
        """Move up to ``n`` pages into the DEVICE-HELD state for a looped
        decode block's device free-list: free-list pages first, then LRU
        reclaim for the remainder. A partial draw is fine (the loop freezes
        rows with exit reason ``pages`` when the device list runs dry), so
        this never raises for a shortfall. The draw is settled by
        ``reconcile_device`` when the block returns."""
        out: List[int] = []
        while self._free and len(out) < n:
            out.append(self._free.pop())
        deficit = n - len(out)
        if deficit > 0 and self._lru:
            out.extend(self._evict_lru_batch(deficit))
        self._device_held.update(out)
        return out

    def reconcile_device(self, claimed: Sequence[int],
                         returned: Sequence[int]) -> None:
        """Settle a device draw: ``claimed`` pages were appended to a live
        row's block table inside the loop and are now plain live-held;
        ``returned`` pages were never assigned (or their row was aborted
        meanwhile) and go back to the free list. Every drawn page comes
        back through exactly one of the two lists, else ValueError."""
        for pid in claimed:
            if pid not in self._device_held:
                raise ValueError(f"page {pid} claimed but not device-held")
            self._device_held.discard(pid)
        for pid in returned:
            if pid not in self._device_held:
                raise ValueError(f"page {pid} returned but not device-held")
            self._device_held.discard(pid)
            self._free.append(pid)

    def device_held(self) -> int:
        """Pages currently drawn onto a looped block's device free-list."""
        return len(self._device_held)

    def _evict_lru_batch(self, count: int, demote: bool = True) -> List[int]:
        """Evict up to ``count`` LRU cached pages (oldest first), handing
        the whole victim batch to ``offload_hook`` once (unless
        ``demote`` is False) before any id is returned. Raises CacheFull
        only when nothing is evictable."""
        if not self._lru:
            raise CacheFull()
        ids: List[int] = []
        victims: List[PageVictim] = []
        while self._lru and len(ids) < count:
            page_id, victim_hash = self._lru.popitem(last=False)
            entry = self._by_hash.pop(victim_hash, None)
            self._by_page.pop(page_id, None)
            self._evictions += 1
            ids.append(page_id)
            if entry is not None:
                victims.append(PageVictim(page_id, victim_hash, entry.depth,
                                          entry.root))
        if demote and victims and self.offload_hook is not None:
            try:
                self.offload_hook(victims)
            except Exception as e:  # noqa: BLE001 — offload is best-effort
                logger.debug("host-tier offload hook failed for %d pages: "
                             "%s", len(victims), e)
        return ids

    # -- publishing & release ---------------------------------------------

    def publish(self, tokens: Sequence[int], page_ids: Sequence[int]) -> None:
        """Content-address the full pages of a sequence so later requests
        can share them. The caller holds a reference to every page;
        publishing adds the address without changing refcounts. A page
        whose content is already published under another page stays
        unpublished (the existing one wins)."""
        ps = self.cfg.page_size
        root = 0
        for i, h in enumerate(iter_chain_hashes(tokens, ps)):
            if i >= len(page_ids):
                break
            if i == 0:
                root = h
            entry = self._by_hash.get(h)
            if entry is None:
                page_id = page_ids[i]
                if page_id in self._by_page:
                    continue  # already addressed under another chain
                entry = _CachedPage(page_id=page_id, refcount=1, depth=i,
                                    root=root)
                self._by_hash[h] = entry
                self._by_page[page_id] = (h, entry)

    def retain(self, page_ids: Sequence[int]) -> None:
        """Add a reference to each content-addressed page."""
        for pid in page_ids:
            entry = self._by_page.get(pid)
            if entry is not None:
                if entry[1].refcount == 0:
                    self._lru.pop(pid, None)
                entry[1].refcount += 1

    def release(self, page_ids: Sequence[int]) -> None:
        """Drop one reference per page. Content-addressed pages with zero
        references stay CACHED (LRU); unaddressed pages go back to the
        free list."""
        for pid in page_ids:
            addressed = self._by_page.get(pid)
            if addressed is None:
                self._free.append(pid)
            else:
                entry = addressed[1]
                entry.refcount = max(0, entry.refcount - 1)
                if entry.refcount == 0:
                    self._lru[pid] = addressed[0]
                    self._lru.move_to_end(pid)

    def touch(self, page_ids: Sequence[int]) -> None:
        """Refresh the LRU position of cached pages (most recent last)."""
        for pid in page_ids:
            if pid in self._by_page and pid in self._lru:
                self._lru.move_to_end(pid)

    def evict_below(self, target_frac: float, demote: bool = True) -> int:
        """Reclaim cached pages until memory used (cached included) is at
        most ``target_frac`` of the pool; returns pages reclaimed.
        ``demote=False`` skips the offload hook (content dropped)."""
        total = self.cfg.num_pages
        k = 0
        while ((total - len(self._free) - k) / total > target_frac
               and k < len(self._lru)):
            k += 1
        if k == 0:
            return 0
        ids = self._evict_lru_batch(k, demote=demote)
        self._free.extend(ids)
        return len(ids)

    def prefix_digest(self, max_depth: int = DIGEST_DEPTH) -> frozenset:
        """Content hashes of cached chains, the first ``max_depth`` pages
        of each (the HBM half of the routing digest)."""
        return frozenset(
            h for h, e in self._by_hash.items() if e.depth < max_depth)

    def cached_page(self, h: int) -> Optional[int]:
        """Page id content-addressed by ``h``, or None. Live pages count
        too (full pages are immutable, so a peer export may read them);
        the hit counters are untouched."""
        entry = self._by_hash.get(h)
        return entry.page_id if entry is not None else None

    # -- consistency audit -------------------------------------------------

    def audit(self, live_pages: Optional[Sequence[int]] = None) -> List[str]:
        """Cross-check the books; returns inconsistency strings (empty =
        clean): free-list uniqueness and range, free ∩ addressed = ∅, the
        hash <-> page bijection, LRU ⊆ addressed, refcount 0 ⇔ in LRU.
        With ``live_pages`` (every page held by a live sequence, with
        multiplicity) it also proves conservation: every page is exactly
        one of free / cached / live, and refcounts equal holder counts."""
        issues: List[str] = []
        total = self.cfg.num_pages
        bad = issues.append

        free = list(self._free)
        free_set = set(free)
        if len(free_set) != len(free):
            bad(f"free list holds duplicates ({len(free) - len(free_set)})")
        for pid in free_set:
            if not (0 <= pid < total):
                bad(f"free page {pid} out of range [0, {total})")
            if pid in self._by_page:
                bad(f"page {pid} is both free and content-addressed")
        for pid in self._device_held:
            if not (0 <= pid < total):
                bad(f"device-held page {pid} out of range [0, {total})")
            if pid in free_set:
                bad(f"page {pid} is both free and device-held")
            if pid in self._by_page:
                bad(f"page {pid} is both device-held and "
                    "content-addressed")
        for h, entry in self._by_hash.items():
            back = self._by_page.get(entry.page_id)
            if back is None or back[0] != h or back[1] is not entry:
                bad(f"hash {h:#x} -> page {entry.page_id} has no matching "
                    "_by_page entry")
            if entry.refcount < 0:
                bad(f"page {entry.page_id} refcount {entry.refcount} < 0")
        for pid, (h, entry) in self._by_page.items():
            if self._by_hash.get(h) is not entry:
                bad(f"_by_page entry for page {pid} not in _by_hash")
            in_lru = pid in self._lru
            if entry.refcount == 0 and not in_lru:
                bad(f"cached page {pid} (refcount 0) missing from LRU")
            if entry.refcount > 0 and in_lru:
                bad(f"held page {pid} (refcount {entry.refcount}) still "
                    "in LRU")
        for pid, h in self._lru.items():
            entry = self._by_page.get(pid)
            if entry is None:
                bad(f"LRU page {pid} is not content-addressed")
            elif entry[0] != h:
                bad(f"LRU page {pid} hash mismatch")

        if live_pages is not None:
            audit_live_pages(
                bad, total, free_set, set(self._lru),
                {pid: e.refcount for pid, (_, e) in self._by_page.items()},
                self._device_held, live_pages)
        return issues


# ---------------------------------------------------------------------------
# Serialize / deserialize: the KVP1 payload (the JAX package's bytes)
# ---------------------------------------------------------------------------

# Payload layout (one buffer, assembled with a single join):
#   magic "KVP1" | kind u8 | dtype_len u8 | dtype name | L,S,KV,D u32 |
#   token_count u64 [| flags u8] | k bytes | v bytes
#   [| k_scale f32 | v_scale f32]
# kind: 0 = raw pool values (dtype as named); 1 = wire-quantized int8 codes
# + f32 per-vector scales (dtype names the ORIGINAL pool dtype, restored
# on import); 2 = native QuantPool codes + scales (exact); 3 = latent page
# codes of a ``LatentCodec``: the D slot of the dims carries the RANK,
# dtype names the original pool dtype, and one flags byte follows the dims
# (bit0 = int8 codes + f32 per-vector scales instead of f16 codes).
# dtype names are numpy's ("float32", "bfloat16", "int8"); bf16 buffers
# are their raw 2-byte words, as ml_dtypes writes them.
_KV_MAGIC = b"KVP1"
_KIND_RAW, _KIND_WIRE8, _KIND_QPOOL, _KIND_LATENT = 0, 1, 2, 3
_HDR = struct.Struct("<4sBB")
_DIMS = struct.Struct("<IIIIQ")
_LATENT_FLAG_INT8 = 0x01

WIRE_QUANTS = ("none", "int8", "latent", "latent_int8")
LATENT_QUANTS = ("latent", "latent_int8")

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8"}
_NAMED_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}
# numpy carrier of each torch dtype's bytes (bf16 as its 2-byte words)
_NP_CARRIER = {torch.float32: np.float32, torch.bfloat16: np.int16,
               torch.float16: np.float16, torch.int8: np.int8}


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a pool dtype, as the JAX package writes it."""
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"no payload encoding for dtype {dtype}") from None


def _named_dtype(name: str) -> torch.dtype:
    try:
        return _NAMED_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown payload dtype {name!r}") from None


def _raw_view(t: torch.Tensor) -> np.ndarray:
    """Flat uint8 view of a host tensor (bf16 included), for the join."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _as_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host tensor over ``arr``'s memory (read-only buffers included:
    nothing writes through it), reinterpreted as ``dtype``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # non-writable buffer: never written
        t = torch.from_numpy(arr)
    return t.view(dtype) if t.dtype != dtype else t


def _page_slots(page_ids: Sequence[int], page_size: int) -> np.ndarray:
    return np.concatenate(
        [np.arange(p * page_size, (p + 1) * page_size) for p in page_ids])


def _pool_device(state: "PagedKVState") -> torch.device:
    pool = state.k
    return (pool.data if isinstance(pool, QuantPool) else pool).device


def _to_device(t: torch.Tensor, device: torch.device,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host tensor on ``device``: through pinned memory with a
    non-blocking copy on the current stream (a pageable copy would
    synchronize it)."""
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if device.type != "cuda" or t.device.type == "cuda":
        return t
    return t.contiguous().pin_memory().to(device, non_blocking=True)


class HostCopy:
    """Device->host copies in flight: pinned host tensors written by
    non-blocking copies on the current stream, readable once ``wait()``
    has waited on the CUDA event recorded after them (on the CPU the
    tensors are ready at once)."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors: Sequence[torch.Tensor], event=None):
        self.tensors = tuple(tensors)
        self.event = event

    def wait(self) -> Tuple[torch.Tensor, ...]:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.tensors


def start_host_copies(arrs: Sequence[torch.Tensor]) -> HostCopy:
    """Start the device->host copies of a payload group now and read them
    later (``HostCopy.wait``)."""
    if not arrs or arrs[0].device.type != "cuda":
        return HostCopy(arrs)
    hosts = []
    for a in arrs:
        h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        h.copy_(a, non_blocking=True)
        hosts.append(h)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(arrs[0].device))
    return HostCopy(hosts, ev)


class LatentCodec:
    """Per-(layer, kv-head) rank-``r`` projection pairs for the latent
    page codec (kind 3): K/V vectors project into a rank-r latent on the
    device before the host pull and reconstruct on import. Projections
    are orthonormal columns from an SVD over calibration samples (numpy
    float64, a canonical sign per column and a QR completion: the JAX
    package's code, so the same samples give bit-identical projections),
    or loaded from an ``.npz`` with ``k_proj`` / ``v_proj``."""

    def __init__(self, k_proj: np.ndarray, v_proj: np.ndarray):
        k_proj = np.asarray(k_proj, dtype=np.float32)
        v_proj = np.asarray(v_proj, dtype=np.float32)
        if k_proj.shape != v_proj.shape or k_proj.ndim != 4:
            raise ValueError(
                f"latent projections must share one [L, KV, D, r] shape, "
                f"got {k_proj.shape} / {v_proj.shape}")
        self.k_proj = k_proj
        self.v_proj = v_proj
        self.rank = int(k_proj.shape[-1])
        self.head_dim = int(k_proj.shape[-2])
        if not 0 < self.rank <= self.head_dim:
            raise ValueError(
                f"latent rank must be in (0, head_dim={self.head_dim}], "
                f"got {self.rank}")
        self._device: Dict[torch.device, tuple] = {}

    def device_projs(self, device) -> tuple:
        """f32 copies of the projections on ``device`` (cached)."""
        device = torch.device(device)
        if device not in self._device:
            self._device[device] = tuple(
                _to_device(torch.from_numpy(p), device)
                for p in (self.k_proj, self.v_proj))
        return self._device[device]

    @staticmethod
    def _basis(samples: np.ndarray, rank: int) -> np.ndarray:
        """Top-``rank`` right singular vectors of [N, D] samples as a
        [D, rank] orthonormal basis, each column's largest-|component|
        positive; completed through QR against the identity when the
        samples span fewer than ``rank`` directions."""
        d = samples.shape[-1]
        _, s, vt = np.linalg.svd(samples.astype(np.float64),
                                 full_matrices=False)
        keep = min(rank, int(np.sum(s > 1e-10)))
        basis = vt[:keep].T  # [D, keep]
        if keep < rank:
            q, _ = np.linalg.qr(np.concatenate([basis, np.eye(d)], axis=1))
            basis = q[:, :rank]
        for j in range(basis.shape[1]):
            col = basis[:, j]
            if col[np.argmax(np.abs(col))] < 0:
                basis[:, j] = -col
        return np.ascontiguousarray(basis, dtype=np.float32)

    @classmethod
    def calibrate(cls, k_samples: np.ndarray, v_samples: np.ndarray,
                  rank: int) -> "LatentCodec":
        """Fit per-(layer, head) bases over samples [L, N, KV, D]."""
        k_samples = np.asarray(k_samples, dtype=np.float32)
        v_samples = np.asarray(v_samples, dtype=np.float32)
        if k_samples.ndim != 4 or k_samples.shape != v_samples.shape:
            raise ValueError(
                f"calibration samples must share one [L, N, KV, D] "
                f"shape, got {k_samples.shape} / {v_samples.shape}")
        num_layers, _, num_heads, head_dim = k_samples.shape
        if not 0 < rank <= head_dim:
            raise ValueError(
                f"latent rank must be in (0, head_dim={head_dim}], "
                f"got {rank}")
        shape = (num_layers, num_heads, head_dim, rank)
        k_proj = np.empty(shape, dtype=np.float32)
        v_proj = np.empty(shape, dtype=np.float32)
        for layer in range(num_layers):
            for head in range(num_heads):
                k_proj[layer, head] = cls._basis(k_samples[layer, :, head],
                                                 rank)
                v_proj[layer, head] = cls._basis(v_samples[layer, :, head],
                                                 rank)
        return cls(k_proj, v_proj)

    @classmethod
    def load(cls, path: str) -> "LatentCodec":
        with np.load(path) as z:
            return cls(z["k_proj"], z["v_proj"])

    def save(self, path: str) -> None:
        np.savez(path, k_proj=self.k_proj, v_proj=self.v_proj)

    def encode_device(self, k: torch.Tensor, v: torch.Tensor) -> tuple:
        """Gathered K/V [L, S, KV, D] -> f32 latent codes [L, S, KV, r]."""
        kp, vp = self.device_projs(k.device)
        return (torch.einsum("lskd,lkdr->lskr", k.float(), kp),
                torch.einsum("lskd,lkdr->lskr", v.float(), vp))

    def decode_host(self, k_codes: np.ndarray, v_codes: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host codes [L, S, KV, r] -> f32 K/V [L, S, KV, D]."""
        k = np.einsum("lskr,lkdr->lskd", k_codes.astype(np.float32),
                      self.k_proj)
        v = np.einsum("lskr,lkdr->lskd", v_codes.astype(np.float32),
                      self.v_proj)
        return k, v

    def decode_device(self, k_codes: torch.Tensor, v_codes: torch.Tensor
                      ) -> tuple:
        """Device codes [L, S, KV, r] -> f32 K/V [L, S, KV, D]."""
        kp, vp = self.device_projs(k_codes.device)
        return (torch.einsum("lskr,lkdr->lskd", k_codes.float(), kp),
                torch.einsum("lskr,lkdr->lskd", v_codes.float(), vp))


def default_latent_rank(head_dim: int) -> int:
    """A quarter of the head dim, floor 2."""
    return max(2, head_dim // 4)


def encoded_page_fraction(wire_quant: str, itemsize: int, head_dim: int,
                          rank: int = 0) -> float:
    """Encoded bytes per page as a fraction of the raw pool bytes. Per
    K/V vector: raw D * itemsize; int8 D codes + one f32 scale; latent r
    f16 components; latent_int8 r int8 codes + one f32 scale."""
    raw = float(head_dim * itemsize)
    if wire_quant == "int8":
        return (head_dim + 4) / raw
    if wire_quant == "latent":
        return (2 * rank) / raw if rank else 1.0
    if wire_quant == "latent_int8":
        return (rank + 4) / raw if rank else 1.0
    return 1.0


def _encode_payload(kind: int, dname: str, shape: Tuple[int, ...],
                    token_count: int, buffers: Sequence[torch.Tensor],
                    extra: bytes = b"") -> bytes:
    name = dname.encode("ascii")
    header = (_HDR.pack(_KV_MAGIC, kind, len(name)) + name
              + _DIMS.pack(*shape, token_count) + extra)
    return b"".join([header] + [_raw_view(b) for b in buffers])


def payload_kind(pool, quant: str) -> int:
    """Payload layout for a pool under a wire encoding: quantized pools
    always move their native codes exactly (no latent re-encoding); float
    pools move raw values, int8 codes + scales (``"int8"``) or latent
    codes (``LATENT_QUANTS``)."""
    if isinstance(pool, QuantPool):
        return _KIND_QPOOL
    if quant in LATENT_QUANTS:
        return _KIND_LATENT
    return _KIND_WIRE8 if quant == "int8" else _KIND_RAW


def gather_kv_parts(quant: str, *args) -> tuple:
    """Gather one page group's K/V in payload order (k, v[, k_scale,
    v_scale]) on the pools' device. Forms, by ``quant`` then arity:

    - a latent quant + 5 args = float pools and codec projections (k, v,
      slots, k_proj, v_proj): rank-r codes, f16 (or int8 codes + f32
      scales for ``latent_int8``);
    - 5 args otherwise = a QuantPool's fields (k_data, k_scale, v_data,
      v_scale, slots): native codes pass through (callers pass "none");
    - 3 args = float pools (k, v, slots), quantized per vector when
      ``quant == "int8"``."""
    if quant in LATENT_QUANTS and len(args) == 5:
        k, v, slots, k_proj, v_proj = args
        k_codes = torch.einsum("lskd,lkdr->lskr",
                               k.index_select(1, slots).float(), k_proj)
        v_codes = torch.einsum("lskd,lkdr->lskr",
                               v.index_select(1, slots).float(), v_proj)
        if quant == "latent_int8":
            k_q, k_s = quantize_kv(k_codes)
            v_q, v_s = quantize_kv(v_codes)
            return k_q, v_q, k_s, v_s
        return k_codes.half(), v_codes.half()
    if len(args) == 5:
        kd, ks, vd, vs, slots = args
        return (kd.index_select(1, slots), vd.index_select(1, slots),
                ks.index_select(1, slots), vs.index_select(1, slots))
    k, v, slots = args
    if quant == "int8":
        k_q, k_s = quantize_kv(k.index_select(1, slots))
        v_q, v_s = quantize_kv(v.index_select(1, slots))
        return k_q, v_q, k_s, v_s
    return k.index_select(1, slots), v.index_select(1, slots)


def _slot_tensor(slots: np.ndarray, device: torch.device) -> torch.Tensor:
    return _to_device(torch.from_numpy(np.asarray(slots, np.int64)), device)


def _pull_group(state: "PagedKVState", slots: np.ndarray, wire_quant: str,
                codec: Optional[LatentCodec] = None
                ) -> Tuple[int, HostCopy]:
    """Issue one page group's device gather (and wire quantization or
    latent projection) on the current stream and start its copy into
    pinned host memory, without waiting: the double-buffering
    primitive. Returns (kind, the copy in flight)."""
    dev = _pool_device(state)
    sl = _slot_tensor(slots, dev)
    kind = payload_kind(state.k, wire_quant)
    if kind == _KIND_QPOOL:
        arrs = gather_kv_parts("none", state.k.data, state.k.scale,
                               state.v.data, state.v.scale, sl)
    elif kind == _KIND_LATENT:
        if codec is None:
            raise ValueError(
                f"wire_quant {wire_quant!r} needs a LatentCodec "
                "(engine has no calibrated codec)")
        arrs = gather_kv_parts(wire_quant, state.k, state.v, sl,
                               *codec.device_projs(dev))
    else:
        arrs = gather_kv_parts(wire_quant, state.k, state.v, sl)
    return kind, start_host_copies(arrs)


def _encode_group(state: "PagedKVState", kind: int, arrs,
                  token_count: int) -> bytes:
    """Encode one group's host parts (a ``HostCopy``, waited on here, or
    host tensors) as one payload."""
    hosts = arrs.wait() if isinstance(arrs, HostCopy) else tuple(arrs)
    extra = b""
    if kind == _KIND_WIRE8:
        dname = dtype_name(state.k.dtype)
    elif kind == _KIND_QPOOL:
        dname = "int8"
    elif kind == _KIND_LATENT:
        # the ORIGINAL pool dtype (restored on import); the dims' D slot
        # carries the rank; flags bit0 = int8-over-latent (4 buffers)
        dname = dtype_name(state.k.dtype)
        extra = bytes([_LATENT_FLAG_INT8 if len(hosts) == 4 else 0])
    else:
        dname = dtype_name(hosts[0].dtype)
    return _encode_payload(kind, dname, tuple(hosts[0].shape), token_count,
                           hosts, extra)


def serialize_kv(state: "PagedKVState", page_ids: Sequence[int],
                 page_size: int, token_count: int, wire_quant: str = "none",
                 codec: Optional[LatentCodec] = None) -> bytes:
    """Pull a sequence's K/V pages to the host and pack them with their
    metadata (one payload; the streamed form is ``serialize_kv_chunks``).
    ``"int8"`` quantizes float pools per vector for the wire (lossy);
    ``"latent"`` / ``"latent_int8"`` project them into ``codec``'s rank-r
    latent; quantized pools always move their native codes exactly."""
    if wire_quant not in WIRE_QUANTS:
        raise ValueError(f"unknown wire_quant {wire_quant!r}; known: "
                         + "|".join(WIRE_QUANTS))
    kind, host = _pull_group(state, _page_slots(page_ids, page_size),
                             wire_quant, codec)
    return _encode_group(state, kind, host, token_count)


@dataclass(frozen=True)
class KvChunk:
    """One page group of a streamed KV payload: a self-describing payload
    (``serialize_kv``'s layout) covering ``page_count`` pages from
    sequence page ``page_start``; ``total`` is the final chunk count
    (patched once the export completes, 0 before); ``crc32`` guards the
    payload."""

    index: int
    total: int
    page_start: int
    page_count: int
    payload: bytes
    crc32: int


def chunk_crc(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def serialize_kv_chunks(state: "PagedKVState", page_ids: Sequence[int],
                        page_size: int, *, chunk_pages: int = 8,
                        wire_quant: str = "none", first_chunk_index: int = 0,
                        first_page_index: int = 0,
                        codec: Optional[LatentCodec] = None
                        ) -> Iterator[KvChunk]:
    """Streamed serialize: one KvChunk per ``chunk_pages``-page group,
    double-buffered: group n + 1's gather and host copy are issued before
    group n is encoded, so the next copy runs behind the host's packing of
    the current one. Chunks carry total=0."""
    if wire_quant not in WIRE_QUANTS:
        raise ValueError(f"unknown wire_quant {wire_quant!r}; known: "
                         + "|".join(WIRE_QUANTS))
    if chunk_pages <= 0:
        raise ValueError(f"chunk_pages must be positive, got {chunk_pages}")
    groups = [list(page_ids[i:i + chunk_pages])
              for i in range(0, len(page_ids), chunk_pages)]
    if not groups:
        return
    pending = _pull_group(state, _page_slots(groups[0], page_size),
                          wire_quant, codec)
    for n, group in enumerate(groups):
        nxt = None
        if n + 1 < len(groups):
            nxt = _pull_group(state, _page_slots(groups[n + 1], page_size),
                              wire_quant, codec)
        kind, host = pending
        payload = _encode_group(state, kind, host, 0)
        yield KvChunk(index=first_chunk_index + n, total=0,
                      page_start=first_page_index + n * chunk_pages,
                      page_count=len(group), payload=payload,
                      crc32=chunk_crc(payload))
        pending = nxt


def deserialize_into_allocator(state: "PagedKVState",
                               allocator: "PageAllocator", data: bytes,
                               tokens: Sequence[int], page_size: int,
                               codec: Optional[LatentCodec] = None
                               ) -> Tuple["PagedKVState", List[int]]:
    """Allocate pages for ``tokens`` from a live allocator, restore the
    payload into them in place and content-address their full pages.
    Returns (state, page ids); the caller owns one reference per page.
    On any failure no page stays allocated. Raises CacheFull /
    CacheDeserializationError."""
    n = len(tokens)
    if n <= 0:
        raise CacheDeserializationError("cannot import an empty sequence")
    pages = allocator.allocate(-(-n // page_size))
    try:
        state, token_count = deserialize_kv(state, data, pages, page_size,
                                            codec)
        if token_count != n:
            raise CacheDeserializationError(
                f"payload carries {token_count} tokens, expected {n}")
    except Exception:
        allocator.release(pages)
        raise
    allocator.publish(tokens, pages)
    return state, pages


def _decode_payload(state: "PagedKVState", data: bytes,
                    codec: Optional[LatentCodec] = None):
    """Parse one payload into host tensors matched to the target pool:
    ``(token_count, (k, v))`` for float pools, ``(token_count, (k, v,
    k_scale, v_scale))`` for QuantPool targets. Wire-quantized payloads
    are dequantized to the payload's pool dtype, latent ones rebuilt
    through ``codec`` (numpy f32, as the JAX package does)."""
    quant = isinstance(state.k, QuantPool)
    try:
        magic, kind, dlen = _HDR.unpack_from(data, 0)
        if magic != _KV_MAGIC:
            raise ValueError("bad payload magic")
        off = _HDR.size
        dname = bytes(data[off:off + dlen]).decode("ascii")
        off += dlen
        L, S, KV, D, token_count = _DIMS.unpack_from(data, off)
        off += _DIMS.size
        shape = (L, S, KV, D)
        n = L * S * KV * D

        def take(dt, count, shp) -> np.ndarray:
            nonlocal off
            dt = np.dtype(dt)
            arr = np.frombuffer(data, dt, count=count, offset=off
                                ).reshape(shp)
            off += count * dt.itemsize
            return arr

        def codes_and_scales():
            return (take(np.int8, n, shape), take(np.int8, n, shape),
                    take(np.float32, L * S * KV, (L, S, KV)),
                    take(np.float32, L * S * KV, (L, S, KV)))

        if kind == _KIND_RAW:
            if quant:
                raise ValueError(
                    "raw payload cannot restore into a quantized pool")
            dt = _named_dtype(dname)
            carrier = _NP_CARRIER[dt]
            parts = (_as_tensor(take(carrier, n, shape), dt),
                     _as_tensor(take(carrier, n, shape), dt))
        elif kind == _KIND_WIRE8:
            if quant:
                raise ValueError(
                    "wire-quantized payload cannot restore into a "
                    "quantized pool (pools quantize natively)")
            k_q, v_q, k_s, v_s = codes_and_scales()
            dt = _named_dtype(dname)
            parts = tuple(
                (torch.from_numpy(q.astype(np.float32))
                 * _as_tensor(s, torch.float32)[..., None]).to(dt)
                for q, s in ((k_q, k_s), (v_q, v_s)))
        elif kind == _KIND_QPOOL:
            if not quant:
                raise ValueError(
                    "quantized-pool payload cannot restore into a float "
                    "pool")
            k_q, v_q, k_s, v_s = codes_and_scales()
            parts = (_as_tensor(k_q, torch.int8), _as_tensor(v_q, torch.int8),
                     _as_tensor(k_s, torch.float32),
                     _as_tensor(v_s, torch.float32))
        elif kind == _KIND_LATENT:
            # injected latent-decode failure: the import wraps it into
            # CacheDeserializationError and the caller degrades exactly
            # once, as for any torn payload
            _fault("kv.latent_decode")
            if quant:
                raise ValueError(
                    "latent payload cannot restore into a quantized pool "
                    "(pools quantize natively)")
            if codec is None:
                raise ValueError(
                    "latent payload needs a LatentCodec (importing engine "
                    "has no calibrated codec)")
            rank = D  # dims carry (L, S, KV, rank); a flags byte follows
            if rank != codec.rank:
                raise ValueError(
                    f"latent rank mismatch: payload rank {rank}, codec "
                    f"rank {codec.rank}")
            flags = data[off]
            off += 1
            if flags & _LATENT_FLAG_INT8:
                k_q, v_q, k_s, v_s = codes_and_scales()
                k_codes = k_q.astype(np.float32) * k_s[..., None]
                v_codes = v_q.astype(np.float32) * v_s[..., None]
            else:
                k_codes = take(np.float16, n, shape)
                v_codes = take(np.float16, n, shape)
            dt = _named_dtype(dname)
            k_rec, v_rec = codec.decode_host(k_codes, v_codes)
            parts = (torch.from_numpy(k_rec).to(dt),
                     torch.from_numpy(v_rec).to(dt))
        else:
            raise ValueError(f"unknown payload kind {kind}")
        if off != len(data):
            raise ValueError(f"payload length mismatch: {len(data)} bytes, "
                             f"expected {off}")
    except CacheDeserializationError:
        raise
    except Exception as e:
        raise CacheDeserializationError(str(e)) from None
    return token_count, parts


def _scatter_payload(state: "PagedKVState", slots: np.ndarray, parts
                     ) -> "PagedKVState":
    """Write host parts into the pools at ``slots`` IN PLACE (one
    ``index_copy_`` per pool member, uploads through pinned memory on the
    current stream): captured graphs keep reading the same buffers."""
    try:
        dev = _pool_device(state)
        sl = _slot_tensor(slots, dev)
        if isinstance(state.k, QuantPool):
            k, v, k_scale, v_scale = parts
            for dst, src in ((state.k.data, k), (state.v.data, v),
                             (state.k.scale, k_scale),
                             (state.v.scale, v_scale)):
                dst.index_copy_(1, sl, _to_device(src, dev, dst.dtype))
        else:
            k, v = parts
            for dst, src in ((state.k, k), (state.v, v)):
                dst.index_copy_(1, sl, _to_device(src, dev, dst.dtype))
    except Exception as e:
        raise CacheDeserializationError(str(e)) from None
    return state


def deserialize_kv(state: "PagedKVState", data: bytes,
                   page_ids: Sequence[int], page_size: int,
                   codec: Optional[LatentCodec] = None
                   ) -> Tuple["PagedKVState", int]:
    """Restore a payload into ``page_ids`` (in place). Returns the state
    and the payload's token count."""
    token_count, parts = _decode_payload(state, data, codec)
    slots = _page_slots(page_ids, page_size)
    if parts[0].shape[1] != len(slots):
        raise CacheDeserializationError(
            f"page count mismatch: payload {parts[0].shape[1]} slots, "
            f"target {len(slots)}")
    return _scatter_payload(state, slots, parts), token_count


class KvImportSession:
    """Incremental import of a streamed payload. Pages are reserved UP
    FRONT (``reserve``); chunks arrive in any order, each validated (crc,
    duplicate index, page range, payload shape) by ``add_chunk`` and
    written into the reserved pages by ``apply_ready``. Nothing is
    published before ``finish`` validates the stream complete (indices
    0..n-1, page ranges tiling the sequence). ``abort`` releases every
    reserved page; data already written there is never read."""

    def __init__(self, state: "PagedKVState", allocator: "PageAllocator",
                 page_size: int, codec: Optional[LatentCodec] = None):
        self._state = state
        self._allocator = allocator
        self._ps = page_size
        self._codec = codec
        self.pages: List[int] = []
        # index -> (page_start, page_count, decoded parts)
        self._parts: Dict[int, Tuple[int, int, tuple]] = {}
        self._applied: Set[int] = set()
        self._total: Optional[int] = None
        self._closed = False

    def reserve(self, total_pages: int) -> None:
        """Grow the reservation to ``total_pages`` (idempotent; raises
        CacheFull with the existing reservation intact)."""
        if self._closed:
            raise CacheDeserializationError("import session already closed")
        missing = total_pages - len(self.pages)
        if missing > 0:
            self.pages.extend(self._allocator.allocate(missing))

    def add_chunk(self, chunk: KvChunk) -> None:
        if self._closed:
            raise CacheDeserializationError("import session already closed")
        # injected import-validation failure: the session's owner must
        # abort() and release every reserved page
        _fault("kv.import_chunk")
        if chunk_crc(chunk.payload) != chunk.crc32:
            raise CacheDeserializationError(
                f"chunk {chunk.index}: crc mismatch (corrupt payload)")
        if chunk.index < 0 or chunk.index in self._parts:
            raise CacheDeserializationError(
                f"chunk index {chunk.index} duplicate or negative")
        if chunk.total:
            if self._total is not None and self._total != chunk.total:
                raise CacheDeserializationError(
                    f"inconsistent chunk totals ({self._total} vs "
                    f"{chunk.total})")
            self._total = chunk.total
        if chunk.page_start < 0 or chunk.page_count <= 0:
            raise CacheDeserializationError(
                f"chunk {chunk.index}: bad page range [{chunk.page_start}, "
                f"{chunk.page_start + chunk.page_count})")
        _, parts = _decode_payload(self._state, chunk.payload, self._codec)
        if parts[0].shape[1] != chunk.page_count * self._ps:
            raise CacheDeserializationError(
                f"chunk {chunk.index}: payload covers {parts[0].shape[1]} "
                f"slots, header says {chunk.page_count * self._ps}")
        self._parts[chunk.index] = (chunk.page_start, chunk.page_count, parts)

    def apply_ready(self, state: "PagedKVState") -> "PagedKVState":
        """Write every not-yet-applied chunk whose page range lies within
        the reservation into ``state`` (one scatter per call, in place).
        The pages are reserved and unpublished: decoding never reads
        them."""
        if self._closed:
            raise CacheDeserializationError("import session already closed")
        ready = sorted(
            (idx for idx, (start, count, _) in self._parts.items()
             if idx not in self._applied and start + count <= len(self.pages)),
            key=lambda i: self._parts[i][0])
        if not ready:
            return state
        slot_groups, part_groups = [], []
        for idx in ready:
            start, count, parts = self._parts[idx]
            slot_groups.append(_page_slots(self.pages[start:start + count],
                                           self._ps))
            part_groups.append(parts)
            self._applied.add(idx)
            self._parts[idx] = (start, count, ())  # host parts released
        merged = tuple(torch.cat([g[m] for g in part_groups], dim=1)
                       for m in range(len(part_groups[0])))
        return _scatter_payload(state, np.concatenate(slot_groups), merged)

    def finish(self, state: "PagedKVState", tokens: Sequence[int]
               ) -> Tuple["PagedKVState", List[int]]:
        """Validate completeness, reserve and write any remainder, and
        content-address the full pages. Returns (state, pages); the
        caller owns one reference per page."""
        if self._closed:
            raise CacheDeserializationError("import session already closed")
        n = len(tokens)
        if n <= 0:
            raise CacheDeserializationError("cannot import an empty sequence")
        num_pages = -(-n // self._ps)
        # completeness comes from the page tiling below; ``total`` is only
        # a consistency check when some chunk carried it
        total = self._total
        if total is not None and total != len(self._parts):
            raise CacheDeserializationError(
                f"incomplete stream: {len(self._parts)} of {total} chunks "
                "arrived")
        if sorted(self._parts) != list(range(len(self._parts))):
            raise CacheDeserializationError("chunk indices are not 0..total-1")
        covered = 0
        for page_start, page_count, _ in sorted(self._parts.values(),
                                                key=lambda t: t[0]):
            if page_start != covered:
                raise CacheDeserializationError(
                    f"chunk page ranges do not tile the sequence "
                    f"(gap/overlap at page {covered})")
            covered += page_count
        if covered != num_pages:
            raise CacheDeserializationError(
                f"chunks cover {covered} pages, sequence has {num_pages}")
        if len(self.pages) > num_pages:
            raise CacheDeserializationError(
                f"reservation of {len(self.pages)} pages exceeds the "
                f"{num_pages}-page sequence")
        self.reserve(num_pages)
        state = self.apply_ready(state)
        self._allocator.publish(list(tokens), self.pages)
        self._closed = True
        return state, list(self.pages)

    def abort(self) -> None:
        """Release every reserved page (idempotent)."""
        if not self._closed:
            self._closed = True
            if self.pages:
                self._allocator.release(self.pages)


# ---------------------------------------------------------------------------
# Host-RAM second tier of the prefix cache
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HostTierStats:
    budget_bytes: int
    bytes_used: int
    pages: int
    hits: int
    misses: int
    offloads: int
    evictions: int


@dataclass
class _HostPage:
    depth: int  # chain position (0 = first page of a prefix)
    root: int  # depth-0 hash of the chain (protection is per chain)
    kind: int  # payload layout of ``parts``
    parts: Tuple[torch.Tensor, ...]  # host tensors, slot axis 1
    nbytes: int
    stamp: int  # LRU clock value of the last access


@dataclass
class _InflightGroup:
    """One demotion group awaiting materialization: ``arrs`` is its host
    copy in flight, slot axis covering every page of ``entries`` at its
    recorded index (slots past the last real page are ignored)."""

    entries: List[Tuple[int, int, int, int]]  # (idx, hash, depth, root)
    kind: int
    page_size: int
    arrs: HostCopy
    burst: int  # ingest-burst id: a burst never drains itself


class HostTier:
    """Bounded host-RAM pool of demoted prefix-cache pages (the JAX
    package's ``HostTier``, over pinned host tensors).

    The engine's offload hook gathers evicted pages on the device, starts
    their copy into pinned host memory and ``offer``s the copy in flight.
    An in-flight window (``inflight_window`` pages) keeps eviction
    non-blocking: ``offer`` waits on (``_drain_one``: the group's CUDA
    event) only the OLDEST groups once the window overflows, and only
    groups of an EARLIER burst; ``inflight_window=0`` materializes every
    offer at once.

    Eviction under the byte budget is chain-aware: chains are PROTECTED
    once matched (``get``), so never-hit (probationary) chains evict
    first; within the class the DEEPEST page goes first (a chain is only
    matchable from its head), ties least recently used.

    Single-owner: the engine thread; ``stats()`` only reads ints."""

    def __init__(self, budget_bytes: int, quant: str = "none",
                 inflight_window: int = 32):
        if quant not in WIRE_QUANTS:
            raise ValueError(f"unknown host-tier quant {quant!r}; known: "
                             + "|".join(WIRE_QUANTS))
        if budget_bytes <= 0:
            raise ValueError("host-tier budget_bytes must be positive")
        self.budget_bytes = int(budget_bytes)
        self.quant = quant
        self._window = max(0, int(inflight_window))
        self._pages: Dict[int, _HostPage] = {}
        self._inflight: Deque[_InflightGroup] = deque()
        self._inflight_hashes: Set[int] = set()
        # chain root -> match count: chains with hits are protected
        self._chain_hits: Dict[int, int] = {}
        # eviction order: two lazy heaps of (-depth, stamp, hash),
        # probationary before protected; stale entries (page gone or
        # clock refreshed: stamps are unique) are skipped on pop
        self._prob_heap: List[Tuple[int, int, int]] = []
        self._prot_heap: List[Tuple[int, int, int]] = []
        # chain root -> resident page count (protection GC without a scan)
        self._root_pages: Dict[int, int] = {}
        self._clock = 0
        self._burst = 0
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.offloads = 0
        self.evictions = 0

    # -- ingest (allocator offload hook path) ------------------------------

    @property
    def empty(self) -> bool:
        return not self._pages and not self._inflight

    def has(self, h: int) -> bool:
        return h in self._pages or h in self._inflight_hashes

    def _inflight_pages(self) -> int:
        return sum(len(g.entries) for g in self._inflight)

    def offer(self, entries: Sequence[Tuple[int, int, int]], kind: int,
              arrs, page_size: int, new_burst: bool = True) -> None:
        """Accept one demoted page group: ``entries`` are (hash, depth,
        root) per page, positional against ``arrs`` (a ``HostCopy`` in
        flight, or host tensors) whose slot axis holds page i at
        ``[i * page_size, (i + 1) * page_size)``. Window overflow drains
        only groups of EARLIER bursts (``new_burst=False`` continues the
        previous offer's burst); a window of 0 drains everything."""
        # injected host-copy failure: the whole demotion burst drops
        # instead of demoting; the allocator's hook boundary absorbs it,
        # eviction itself never fails
        _fault("kv.host_copy")
        if not isinstance(arrs, HostCopy):
            arrs = HostCopy(arrs)
        if new_burst:
            self._burst += 1
        fresh = [(i, h, depth, root)
                 for i, (h, depth, root) in enumerate(entries)
                 if not self.has(h)]  # resident: keep the old copy
        if fresh:
            self._inflight.append(
                _InflightGroup(fresh, kind, page_size, arrs, self._burst))
            self._inflight_hashes.update(h for _, h, _, _ in fresh)
            self.offloads += len(fresh)
        # drain even when this offer dedups away entirely: a NEW burst
        # pulls a previous burst's overshoot back down to the window
        while (self._inflight_pages() > self._window and self._inflight
               and (self._window == 0
                    or self._inflight[0].burst != self._burst)):
            self._drain_one()

    def drain_to_window(self) -> None:
        """Materialize in-flight groups (oldest first, own-burst rule
        suspended) until the window bound holds: for callers off the
        decode path (the degradation ladder's demotion)."""
        while self._inflight and self._inflight_pages() > self._window:
            self._drain_one()

    def _drain_one(self) -> None:
        g = self._inflight.popleft()
        self._inflight_hashes.difference_update(h for _, h, _, _ in g.entries)
        whole = g.arrs.wait()
        ps = g.page_size
        for idx, h, depth, root in g.entries:
            if h in self._pages:
                continue
            # own copies: a view would pin the whole group's buffer
            parts = tuple(
                p[:, idx * ps:(idx + 1) * ps].clone(
                    memory_format=torch.contiguous_format)
                for p in whole)
            nbytes = sum(p.numel() * p.element_size() for p in parts)
            if nbytes > self.budget_bytes:
                self.evictions += 1  # one page exceeds the whole budget
                continue
            self._clock += 1
            self._pages[h] = _HostPage(depth=depth, root=root, kind=g.kind,
                                       parts=parts, nbytes=nbytes,
                                       stamp=self._clock)
            self._bytes += nbytes
            self._root_pages[root] = self._root_pages.get(root, 0) + 1
            heapq.heappush(
                self._prot_heap if root in self._chain_hits
                else self._prob_heap, (-depth, self._clock, h))
            while self._bytes > self.budget_bytes:
                self._evict_one()

    def _compact(self, heap: List[Tuple[int, int, int]]
                 ) -> List[Tuple[int, int, int]]:
        """Rebuild a lazy heap with only its live entries (a tier under
        its budget never pops, while every hit pushes)."""
        live = [t for t in heap
                if (e := self._pages.get(t[2])) is not None
                and e.stamp == t[1]]
        heapq.heapify(live)
        return live

    def _pop_victim(self, heap: List[Tuple[int, int, int]],
                    protected: bool) -> Optional[int]:
        while heap:
            negdepth, stamp, h = heapq.heappop(heap)
            e = self._pages.get(h)
            if e is None or e.stamp != stamp:
                continue
            if not protected and e.root in self._chain_hits:
                # protected since the push: re-file, do not return
                heapq.heappush(self._prot_heap, (negdepth, stamp, h))
                continue
            return h
        return None

    def _evict_one(self) -> None:
        victim = self._pop_victim(self._prob_heap, protected=False)
        if victim is None:
            victim = self._pop_victim(self._prot_heap, protected=True)
        if victim is None:  # unreachable: every resident page has a
            victim = next(iter(self._pages))  # live heap entry
        gone = self._pages.pop(victim)
        self._bytes -= gone.nbytes
        self.evictions += 1
        left = self._root_pages.get(gone.root, 1) - 1
        if left <= 0:  # a fully evicted chain loses its protection
            self._root_pages.pop(gone.root, None)
            self._chain_hits.pop(gone.root, None)
        else:
            self._root_pages[gone.root] = left

    def flush(self) -> None:
        """Materialize every in-flight page."""
        while self._inflight:
            self._drain_one()

    # -- lookup -------------------------------------------------------------

    def get(self, h: int) -> Optional[_HostPage]:
        """Look up a chain hash, refreshing its clock and protecting its
        chain. An in-flight page is matchable: groups drain, oldest
        first, until it materializes. A miss drains nothing."""
        entry = self._pages.get(h)
        if entry is None and h in self._inflight_hashes:
            while h not in self._pages and self._inflight:
                self._drain_one()
            entry = self._pages.get(h)
        if entry is None:
            self.misses += 1
            return None
        self._clock += 1
        entry.stamp = self._clock
        self._chain_hits[entry.root] = self._chain_hits.get(entry.root, 0) + 1
        heapq.heappush(self._prot_heap, (-entry.depth, entry.stamp, h))
        if (len(self._prob_heap) + len(self._prot_heap)
                > 4 * len(self._pages) + 64):
            self._prob_heap = self._compact(self._prob_heap)
            self._prot_heap = self._compact(self._prot_heap)
        self.hits += 1
        return entry

    def digest_hashes(self, max_depth: int = DIGEST_DEPTH) -> List[int]:
        """Host half of the routing digest (chain heads only)."""
        return [h for h, e in self._pages.items() if e.depth < max_depth] + [
            h for g in self._inflight
            for _, h, d, _ in g.entries if d < max_depth]

    # -- maintenance -------------------------------------------------------

    def clear(self) -> int:
        """Drop everything; returns pages dropped."""
        n = len(self._pages) + self._inflight_pages()
        self._pages.clear()
        self._inflight.clear()
        self._inflight_hashes.clear()
        self._chain_hits.clear()
        self._prob_heap.clear()
        self._prot_heap.clear()
        self._root_pages.clear()
        self._bytes = 0
        self.evictions += n
        return n

    def stats(self) -> HostTierStats:
        return HostTierStats(
            budget_bytes=self.budget_bytes, bytes_used=self._bytes,
            pages=len(self._pages), hits=self.hits, misses=self.misses,
            offloads=self.offloads, evictions=self.evictions)
