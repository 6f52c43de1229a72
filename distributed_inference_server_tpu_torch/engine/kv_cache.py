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

Not ported yet: the C++ allocator binding, the host tier, the
device-held free-list of looped decode blocks, and the KV byte paths
(serialize / wire quantization / latent codec).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import torch

from distributed_inference_server_tpu_torch.core.errors import CacheFull
from distributed_inference_server_tpu_torch.models.configs import ModelConfig
from distributed_inference_server_tpu_torch.ops.quant import QuantPool

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


def chain_hashes(tokens: Sequence[int], page_size: int,
                 max_pages: Optional[int] = None) -> List[int]:
    """Content-address hash chain over the full pages of ``tokens``."""
    it = iter_chain_hashes(tokens, page_size)
    if max_pages is not None:
        return [h for h, _ in zip(it, range(max_pages))]
    return list(it)


@dataclass
class _CachedPage:
    page_id: int
    refcount: int = 0


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

    def _evict_lru_batch(self, count: int) -> List[int]:
        """Evict up to ``count`` LRU cached pages (oldest first)."""
        if not self._lru:
            raise CacheFull()
        ids: List[int] = []
        while self._lru and len(ids) < count:
            page_id, victim_hash = self._lru.popitem(last=False)
            self._by_hash.pop(victim_hash, None)
            self._by_page.pop(page_id, None)
            self._evictions += 1
            ids.append(page_id)
        return ids

    # -- publishing & release ---------------------------------------------

    def publish(self, tokens: Sequence[int], page_ids: Sequence[int]) -> None:
        """Content-address the full pages of a sequence so later requests
        can share them. The caller holds a reference to every page;
        publishing adds the address without changing refcounts. A page
        whose content is already published under another page stays
        unpublished (the existing one wins)."""
        ps = self.cfg.page_size
        for i, h in enumerate(iter_chain_hashes(tokens, ps)):
            if i >= len(page_ids):
                break
            entry = self._by_hash.get(h)
            if entry is None:
                page_id = page_ids[i]
                if page_id in self._by_page:
                    continue  # already addressed under another chain
                entry = _CachedPage(page_id=page_id, refcount=1)
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
            held: Dict[int, int] = {}
            for pid in live_pages:
                held[pid] = held.get(pid, 0) + 1
            for pid, count in held.items():
                if not (0 <= pid < total):
                    bad(f"live page {pid} out of range [0, {total})")
                    continue
                if pid in free_set:
                    bad(f"live page {pid} is on the free list "
                        "(use-after-free)")
                if pid in self._device_held:
                    bad(f"live page {pid} is still device-held "
                        "(unreconciled device draw)")
                addressed = self._by_page.get(pid)
                if addressed is not None:
                    if addressed[1].refcount != count:
                        bad(f"page {pid}: refcount "
                            f"{addressed[1].refcount} != {count} live "
                            "holders")
                elif count != 1:
                    bad(f"unaddressed page {pid} held by {count} holders "
                        "(pages can only be shared once published)")
            for pid, (h, entry) in self._by_page.items():
                if entry.refcount > 0 and held.get(pid, 0) == 0:
                    bad(f"page {pid}: refcount {entry.refcount} with no "
                        "live holder (leaked reference)")
            accounted = (len(free_set) + len(self._lru)
                         + len(set(held) - set(self._lru))
                         + len(self._device_held))
            if accounted != total:
                bad(f"conservation: {len(free_set)} free + "
                    f"{len(self._lru)} cached + "
                    f"{len(set(held) - set(self._lru))} live + "
                    f"{len(self._device_held)} device-held = "
                    f"{accounted}, pool has {total} "
                    f"({total - accounted:+d} leaked)")
        return issues
