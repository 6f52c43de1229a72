// Concurrency stress harness for the port's native serving tier (the
// counterpart of distributed_inference_server_tpu/native/stress.cpp).
//
// Producer, consumer, canceller, config-writer and audit threads hammer the
// priority queue, the admission batcher and the page allocator through the
// same C ABI the ctypes wrappers use. Built twice by
// native/__init__.py:build_stress (tests/test_torch_native_stress.py runs
// both): under ThreadSanitizer, where any data race aborts the binary
// (TSAN_OPTIONS=halt_on_error=1), and as a plain -O2 build that doubles as
// a smoke test for lock correctness under contention. Beyond the JAX
// harness, one thread copies the allocator's books out with
// pa_snapshot_sizes / pa_snapshot (the page audit's entry points) while
// the others mutate them.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

extern "C" {
void* pq_create(int, int, double, int);
void pq_destroy(void*);
void pq_set_config(void*, int, int, double, int);
int pq_enqueue(void*, uint64_t, int, double);
int pq_dequeue_batch(void*, uint64_t*, int);
void pq_depth(void*, int*);
int pq_is_accepting(void*);
int pq_remove_expired(void*, double, uint64_t*, int);
int pq_cancel(void*, uint64_t);

void* batcher_create(void*, double, int);
void batcher_destroy(void*);
void batcher_set_config(void*, double, int);
void batcher_set_divisor(void*, int);
int batcher_pending(void*);
int batcher_cancel(void*, uint64_t);
int batcher_poll(void*, double, uint64_t*, int);
int batcher_flush(void*, uint64_t*, int);

void* pa_create(int, int);
void pa_destroy(void*);
int pa_num_free(void*);
int pa_match_prefix(void*, const int32_t*, int, int32_t*);
int pa_allocate(void*, int, int32_t*);
void pa_publish(void*, const int32_t*, int, const int32_t*, int);
void pa_retain(void*, const int32_t*, int);
void pa_release(void*, const int32_t*, int);
void pa_touch(void*, const int32_t*, int);
int pa_evict_below(void*, double);
void pa_stats(void*, int64_t*);
void pa_snapshot_sizes(void*, int64_t*);
int pa_snapshot(void*, int64_t, int32_t*, int64_t, int32_t*, int64_t,
                int32_t*, int32_t*, int32_t*);
}

namespace {

constexpr int kIters = 4000;
constexpr int kPages = 256;
std::atomic<uint64_t> g_handle{1};
std::atomic<uint64_t> g_consumed{0};
std::atomic<uint64_t> g_snapshots{0};
std::atomic<int> g_alloc_running{0};

uint32_t rng_next(uint32_t& s) {
    s ^= s << 13;
    s ^= s >> 17;
    s ^= s << 5;
    return s;
}

void producer(void* pq, uint32_t seed) {
    uint32_t s = seed;
    for (int i = 0; i < kIters; ++i) {
        uint64_t h = g_handle.fetch_add(1);
        pq_enqueue(pq, h, static_cast<int>(rng_next(s) % 3),
                   i * 1e-4);
        if ((rng_next(s) & 15) == 0) pq_cancel(pq, h);
    }
}

void batch_consumer(void* b, uint32_t seed) {
    uint32_t s = seed;
    uint64_t out[64];
    for (int i = 0; i < kIters; ++i) {
        int n = batcher_poll(b, i * 2e-4, out, 64);
        g_consumed.fetch_add(n);
        if ((rng_next(s) & 31) == 0) {
            n = batcher_flush(b, out, 64);
            g_consumed.fetch_add(n);
        }
        if ((rng_next(s) & 63) == 0)
            batcher_set_divisor(b, 1 + (rng_next(s) & 3));
        if ((rng_next(s) & 127) == 0)
            batcher_set_config(b, 1.0 + (rng_next(s) & 7), 32);
    }
}

void sweeper(void* pq, void* b) {
    uint64_t out[256];
    int depth[3];
    for (int i = 0; i < kIters / 4; ++i) {
        pq_remove_expired(pq, i * 1e-3, out, 256);
        pq_depth(pq, depth);
        pq_is_accepting(pq);
        batcher_pending(b);
        batcher_cancel(b, g_handle.load() / 2);
        if ((i & 63) == 0) pq_set_config(pq, 800, 400, 5.0, 2000);
    }
}

void alloc_worker(void* pa, uint32_t seed) {
    uint32_t s = seed;
    int32_t pages[32];
    int32_t tokens[64] = {};
    for (int i = 0; i < kIters; ++i) {
        int want = 1 + (rng_next(s) & 7);
        int got = pa_allocate(pa, want, pages);
        if (got < 0) {
            pa_evict_below(pa, 0.5);
            continue;
        }
        for (int t = 0; t < want * 8 && t < 64; ++t)
            tokens[t] = static_cast<int32_t>(rng_next(s) & 255);
        switch (rng_next(s) & 3) {
            case 0:
                pa_publish(pa, tokens, want * 8, pages, want);
                pa_release(pa, pages, want);
                break;
            case 1:
                pa_touch(pa, pages, want);
                pa_release(pa, pages, want);
                break;
            default:
                pa_release(pa, pages, want);
        }
        if ((rng_next(s) & 31) == 0) {
            // a prefix hit holds its pages: one more reference, then both
            // dropped (the pages go back to the LRU)
            int32_t shared[8];
            int m = pa_match_prefix(pa, tokens, 32, shared);
            pa_retain(pa, shared, m);
            pa_touch(pa, shared, m);
            pa_release(pa, shared, m);
            pa_release(pa, shared, m);
            pa_num_free(pa);
        }
        if ((rng_next(s) & 255) == 0) {
            int64_t stats[6];
            pa_stats(pa, stats);
        }
    }
    g_alloc_running.fetch_sub(1);
}

// The page audit's two-call protocol against live mutation: size the
// buffers, copy the books out, retry when they grew in between. Each
// copy must name only pages of the pool, none twice.
void auditor(void* pa) {
    std::vector<int32_t> free_ids, lru_ids, page_ids, refs, in_lru;
    do {
        int64_t sizes[3];
        pa_snapshot_sizes(pa, sizes);
        // -1 marks the slots a list that shrank since the sizing left
        // unwritten (pa_snapshot copies the books, not their sizes)
        free_ids.assign(sizes[0] + 1, -1);
        lru_ids.assign(sizes[1] + 1, -1);
        page_ids.assign(sizes[2] + 1, -1);
        refs.assign(sizes[2] + 1, -1);
        in_lru.assign(sizes[2] + 1, -1);
        if (pa_snapshot(pa, static_cast<int64_t>(free_ids.size()),
                        free_ids.data(),
                        static_cast<int64_t>(lru_ids.size()), lru_ids.data(),
                        static_cast<int64_t>(page_ids.size()),
                        page_ids.data(), refs.data(), in_lru.data()) != 0)
            continue;  // the books grew past the sizes: size again
        // a page is free at most once, and never free and cached at once
        std::vector<char> seen(kPages, 0);
        auto mark = [&](int32_t page, const char* book) {
            if (page == -1) return;
            if (page < 0 || page >= kPages || seen[page]) {
                std::fprintf(stderr, "audit: page %d in the %s list is out "
                             "of range or listed twice\n", page, book);
                std::abort();
            }
            seen[page] = 1;
        };
        for (int64_t i = 0; i < sizes[0]; ++i) mark(free_ids[i], "free");
        for (int64_t i = 0; i < sizes[1]; ++i) mark(lru_ids[i], "LRU");
        g_snapshots.fetch_add(1);
    } while (g_alloc_running.load() > 0);
}

}  // namespace

int main() {
    void* pq = pq_create(1000, 500, 30.0, 2000);
    void* b = batcher_create(pq, 2.0, 32);
    void* pa = pa_create(kPages, 8);

    std::vector<std::thread> threads;
    for (int i = 0; i < 3; ++i)
        threads.emplace_back(producer, pq, 0x1234u + i);
    threads.emplace_back(batch_consumer, b, 0x9999u);
    threads.emplace_back(sweeper, pq, b);
    g_alloc_running.store(2);
    for (int i = 0; i < 2; ++i)
        threads.emplace_back(alloc_worker, pa, 0x4321u + i);
    threads.emplace_back(auditor, pa);
    for (auto& t : threads) t.join();

    uint64_t drained[64];
    int n;
    while ((n = batcher_flush(b, drained, 64)) > 0) g_consumed.fetch_add(n);
    while ((n = pq_dequeue_batch(pq, drained, 64)) > 0)
        g_consumed.fetch_add(n);

    // quiescent: every page is back (free or cached), none referenced
    int64_t stats[6];
    pa_stats(pa, stats);
    int reclaimable = pa_num_free(pa);
    if (reclaimable != kPages) {
        std::fprintf(stderr, "stress: %d of %d pages reclaimable after the "
                     "workers stopped\n", reclaimable, kPages);
        return 1;
    }

    batcher_destroy(b);
    pq_destroy(pq);
    pa_destroy(pa);
    std::printf("stress OK: consumed %llu, snapshots %llu\n",
                static_cast<unsigned long long>(g_consumed.load()),
                static_cast<unsigned long long>(g_snapshots.load()));
    return 0;
}
