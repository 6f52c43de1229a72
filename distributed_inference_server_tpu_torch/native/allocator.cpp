// Paged-KV page allocator with content-addressed prefix cache — native
// C++ tier of engine/kv_cache.py:PageAllocator (the port's own copy of the
// JAX package's native/allocator.cpp, plus pa_snapshot_sizes/pa_snapshot
// for the audit).
//
// The reference spec'd its KV cache manager in Rust (design.md:369-412:
// get/get_prefix/put/evict_lru/stats with LRU eviction and prefix reuse);
// in the TPU design the host-side bookkeeping is this allocator: pages
// move FREE -> ACTIVE (refcounted) -> CACHED (refcount 0, content-
// addressed, LRU-reclaimable). This is the per-request hot host path
// (prefix match + allocate on admission, release on completion), hence
// native. Content addresses use an FNV-1a hash chain over token pages —
// the address scheme is internal, so it need not match Python's.
//
// Thread safety: a mutex guards every entry point — the engine thread
// mutates while the serving/asyncio thread polls pa_stats/pa_num_free
// (ctypes releases the GIL, so cross-thread calls really are concurrent).

#include <cstddef>
#include <cstdint>
#include <list>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 1469598103934665603ULL;
constexpr uint64_t kFnvPrime = 1099511628211ULL;

uint64_t chunk_hash(uint64_t prev, const int32_t* tokens, int n) {
    uint64_t h = kFnvOffset ^ prev;
    for (int i = 0; i < n; ++i) {
        uint64_t t = static_cast<uint64_t>(static_cast<uint32_t>(tokens[i]));
        for (int b = 0; b < 4; ++b) {
            h ^= (t >> (8 * b)) & 0xFF;
            h *= kFnvPrime;
        }
    }
    return h;
}

struct CachedPage {
    int32_t page_id;
    int refcount;
    uint64_t hash;
    // position in the LRU list when refcount == 0 (oldest at front)
    std::list<int32_t>::iterator lru_it;
    bool in_lru = false;
};

struct Allocator {
    std::mutex mu;
    int num_pages;
    int page_size;
    std::vector<int32_t> free_list;  // back = next to allocate
    std::unordered_map<uint64_t, CachedPage*> by_hash;
    std::unordered_map<int32_t, CachedPage*> by_page;
    std::list<int32_t> lru;  // refcount-0 content-addressed, oldest first
    int64_t hits = 0, misses = 0, evictions = 0;

    ~Allocator() {
        for (auto& kv : by_page) delete kv.second;
    }

    size_t reclaimable() const { return free_list.size() + lru.size(); }

    void lru_remove(CachedPage* e) {
        if (e->in_lru) {
            lru.erase(e->lru_it);
            e->in_lru = false;
        }
    }

    void lru_push_back(CachedPage* e) {
        lru_remove(e);
        e->lru_it = lru.insert(lru.end(), e->page_id);
        e->in_lru = true;
    }

    int32_t evict_lru_one() {  // caller checks !lru.empty()
        int32_t page_id = lru.front();
        lru.pop_front();
        CachedPage* e = by_page[page_id];
        by_hash.erase(e->hash);
        by_page.erase(page_id);
        delete e;
        ++evictions;
        return page_id;
    }
};

}  // namespace

extern "C" {

void* pa_create(int num_pages, int page_size) {
    auto* a = new Allocator();
    a->num_pages = num_pages;
    a->page_size = page_size;
    a->free_list.reserve(num_pages);
    for (int i = num_pages - 1; i >= 0; --i) a->free_list.push_back(i);
    return a;
}

void pa_destroy(void* p) { delete static_cast<Allocator*>(p); }

int pa_num_free(void* p) {
    auto* a = static_cast<Allocator*>(p);
    std::lock_guard<std::mutex> lock(a->mu);
    return static_cast<int>(a->reclaimable());
}

// Longest-prefix match over full pages (Property 9). Writes shared page
// ids to out_pages (caller provides >= n/page_size slots); each matched
// page's refcount is incremented. Returns matched page count.
int pa_match_prefix(void* p, const int32_t* tokens, int n,
                    int32_t* out_pages) {
    auto* a = static_cast<Allocator*>(p);
    std::lock_guard<std::mutex> lock(a->mu);
    int count = 0;
    uint64_t h = 0;
    for (int start = 0; start + a->page_size <= n; start += a->page_size) {
        h = chunk_hash(h, tokens + start, a->page_size);
        auto it = a->by_hash.find(h);
        if (it == a->by_hash.end()) {
            ++a->misses;
            break;
        }
        CachedPage* e = it->second;
        if (e->refcount == 0) a->lru_remove(e);
        ++e->refcount;
        out_pages[count++] = e->page_id;
        ++a->hits;
    }
    return count;
}

// Allocate n fresh pages (reclaiming LRU cached pages when the free list
// runs dry — Property 10). Returns 0, or -1 when the pool cannot supply n.
int pa_allocate(void* p, int n, int32_t* out_pages) {
    auto* a = static_cast<Allocator*>(p);
    std::lock_guard<std::mutex> lock(a->mu);
    if (a->reclaimable() < static_cast<size_t>(n)) return -1;
    for (int i = 0; i < n; ++i) {
        if (!a->free_list.empty()) {
            out_pages[i] = a->free_list.back();
            a->free_list.pop_back();
        } else {
            out_pages[i] = a->evict_lru_one();
        }
    }
    return 0;
}

// Content-address the full pages of a sequence (paged `put`,
// design.md:397). Caller must hold references; duplicates of an
// already-published identical page stay unpublished (existing one wins).
void pa_publish(void* p, const int32_t* tokens, int n, const int32_t* pages,
                int npages) {
    auto* a = static_cast<Allocator*>(p);
    std::lock_guard<std::mutex> lock(a->mu);
    uint64_t h = 0;
    int i = 0;
    for (int start = 0; start + a->page_size <= n && i < npages;
         start += a->page_size, ++i) {
        h = chunk_hash(h, tokens + start, a->page_size);
        auto it = a->by_hash.find(h);
        if (it == a->by_hash.end()) {
            if (a->by_page.count(pages[i])) continue;  // addressed elsewhere
            auto* e = new CachedPage{pages[i], 1, h, {}, false};
            a->by_hash[h] = e;
            a->by_page[pages[i]] = e;
        }
        // identical content already cached under another page: keep ours
        // unpublished (freed on release)
    }
}

void pa_retain(void* p, const int32_t* pages, int n) {
    auto* a = static_cast<Allocator*>(p);
    std::lock_guard<std::mutex> lock(a->mu);
    for (int i = 0; i < n; ++i) {
        auto it = a->by_page.find(pages[i]);
        if (it == a->by_page.end()) continue;
        CachedPage* e = it->second;
        if (e->refcount == 0) a->lru_remove(e);
        ++e->refcount;
    }
}

// Drop one reference per page: unaddressed pages return to the free list;
// content-addressed pages at refcount 0 become CACHED (LRU-reclaimable).
void pa_release(void* p, const int32_t* pages, int n) {
    auto* a = static_cast<Allocator*>(p);
    std::lock_guard<std::mutex> lock(a->mu);
    for (int i = 0; i < n; ++i) {
        auto it = a->by_page.find(pages[i]);
        if (it == a->by_page.end()) {
            a->free_list.push_back(pages[i]);
            continue;
        }
        CachedPage* e = it->second;
        if (e->refcount > 0) --e->refcount;
        if (e->refcount == 0) a->lru_push_back(e);  // most recently used
    }
}

// Refresh access clocks (Property 11): move cached pages to MRU.
void pa_touch(void* p, const int32_t* pages, int n) {
    auto* a = static_cast<Allocator*>(p);
    std::lock_guard<std::mutex> lock(a->mu);
    for (int i = 0; i < n; ++i) {
        auto it = a->by_page.find(pages[i]);
        if (it != a->by_page.end() && it->second->in_lru)
            a->lru_push_back(it->second);
    }
}

// Reclaim cached pages until used/total <= target_frac (degradation
// ladder hook). Returns pages reclaimed.
int pa_evict_below(void* p, double target_frac) {
    auto* a = static_cast<Allocator*>(p);
    std::lock_guard<std::mutex> lock(a->mu);
    int n = 0;
    while (!a->lru.empty() &&
           static_cast<double>(a->num_pages - a->free_list.size()) /
                   a->num_pages >
               target_frac) {
        a->free_list.push_back(a->evict_lru_one());
        ++n;
    }
    return n;
}

// out = {hits, misses, evictions, pages_total, pages_free, pages_cached}.
void pa_stats(void* p, int64_t* out6) {
    auto* a = static_cast<Allocator*>(p);
    std::lock_guard<std::mutex> lock(a->mu);
    out6[0] = a->hits;
    out6[1] = a->misses;
    out6[2] = a->evictions;
    out6[3] = a->num_pages;
    out6[4] = static_cast<int64_t>(a->free_list.size());
    out6[5] = static_cast<int64_t>(a->lru.size());
}

// Sizes of the books pa_snapshot copies out: out3 = {free, lru, addressed}.
void pa_snapshot_sizes(void* p, int64_t* out3) {
    auto* a = static_cast<Allocator*>(p);
    std::lock_guard<std::mutex> lock(a->mu);
    out3[0] = static_cast<int64_t>(a->free_list.size());
    out3[1] = static_cast<int64_t>(a->lru.size());
    out3[2] = static_cast<int64_t>(a->by_page.size());
}

// Copy the books out for an audit: the free list, the LRU (oldest first)
// and every content-addressed page with its refcount and whether it is
// in the LRU. Each buffer holds at least the size pa_snapshot_sizes gave.
// Returns -1 when the books grew past those sizes since.
int pa_snapshot(void* p, int64_t n_free, int32_t* free_out, int64_t n_lru,
                int32_t* lru_out, int64_t n_addr, int32_t* page_out,
                int32_t* ref_out, int32_t* in_lru_out) {
    auto* a = static_cast<Allocator*>(p);
    std::lock_guard<std::mutex> lock(a->mu);
    if (static_cast<int64_t>(a->free_list.size()) > n_free ||
        static_cast<int64_t>(a->lru.size()) > n_lru ||
        static_cast<int64_t>(a->by_page.size()) > n_addr)
        return -1;
    int64_t i = 0;
    for (int32_t pid : a->free_list) free_out[i++] = pid;
    i = 0;
    for (int32_t pid : a->lru) lru_out[i++] = pid;
    i = 0;
    for (auto& kv : a->by_page) {
        page_out[i] = kv.first;
        ref_out[i] = kv.second->refcount;
        in_lru_out[i] = kv.second->in_lru ? 1 : 0;
        ++i;
    }
    return 0;
}

}  // extern "C"
