// Windowed admission batcher — native C++ tier.
//
// The reference's serving layer is native (Rust workspace, Cargo.toml:2)
// and its spec'd RequestBatcher (design.md:227-267, requirements.md:45-49)
// sits on the admission hot path: every request crosses it between queue
// and engine. This realizes that component in C++ behind the same C ABI as
// pqueue.cpp — one batcher_poll call drains the native priority queue,
// manages the batching window, and returns a dispatched batch's handles,
// with no Python in the per-request path.
// serving/batcher.py holds the canonical semantics; the differential tests
// (tests/test_torch_admission.py) drive both.
//
// Properties preserved (SURVEY §4.2): every batch has 1 <= len <=
// effective max (Property 4); a request waits at most one window before
// dispatch while capacity allows (Property 5); strict-priority inclusion
// comes from the underlying pqueue drain order (Property 6).
//
// The batcher references (does not own) a PQueue created by pq_create;
// destroy order is caller's responsibility (wrapper keeps the queue
// alive). Lock order: batcher -> queue (the queue never calls back).

#include <cstdint>
#include <deque>
#include <mutex>

extern "C" {
int pq_dequeue_batch(void* p, uint64_t* out, int max_count);
}

namespace {

struct Batcher {
    void* pq;
    double window_ms;
    int max_batch_size;
    int size_divisor = 1;
    std::deque<uint64_t> pending;
    bool window_open = false;
    double window_opened_at = 0.0;  // caller-supplied monotonic seconds
    std::mutex mu;

    int effective_max() const {
        int d = size_divisor < 1 ? 1 : size_divisor;
        int cap = max_batch_size / d;
        return cap < 1 ? 1 : cap;
    }
};

}  // namespace

extern "C" {

void* batcher_create(void* pq, double window_ms, int max_batch_size) {
    auto* b = new Batcher();
    b->pq = pq;
    b->window_ms = window_ms;
    b->max_batch_size = max_batch_size;
    return b;
}

void batcher_destroy(void* p) { delete static_cast<Batcher*>(p); }

// Hot-reload (requirements.md:146): window/max apply from the next poll.
void batcher_set_config(void* p, double window_ms, int max_batch_size) {
    auto* b = static_cast<Batcher*>(p);
    std::lock_guard<std::mutex> lock(b->mu);
    b->window_ms = window_ms;
    b->max_batch_size = max_batch_size;
}

// Degradation-ladder throttle (design.md:938-941): effective cap =
// max_batch_size / divisor, composing with hot-reloaded config.
void batcher_set_divisor(void* p, int divisor) {
    auto* b = static_cast<Batcher*>(p);
    std::lock_guard<std::mutex> lock(b->mu);
    b->size_divisor = divisor;
}

int batcher_pending(void* p) {
    auto* b = static_cast<Batcher*>(p);
    std::lock_guard<std::mutex> lock(b->mu);
    return static_cast<int>(b->pending.size());
}

// Remove a request still waiting in the window (client disconnect between
// dequeue and dispatch, Req 5.4). 1 = removed, 0 = not pending.
int batcher_cancel(void* p, uint64_t handle) {
    auto* b = static_cast<Batcher*>(p);
    std::lock_guard<std::mutex> lock(b->mu);
    for (auto it = b->pending.begin(); it != b->pending.end(); ++it) {
        if (*it == handle) {
            b->pending.erase(it);
            if (b->pending.empty()) b->window_open = false;
            return 1;
        }
    }
    return 0;
}

// Pull from the queue, then dispatch when the size cap is reached or the
// window (opened at first pull) has expired. Returns the batch size
// written to out (0 = no dispatch this poll). `now` is monotonic seconds.
int batcher_poll(void* p, double now, uint64_t* out, int cap) {
    auto* b = static_cast<Batcher*>(p);
    std::lock_guard<std::mutex> lock(b->mu);
    int eff = b->effective_max();
    int room = eff - static_cast<int>(b->pending.size());
    if (room > 0) {
        uint64_t buf[256];
        if (room > 256) room = 256;
        int n = pq_dequeue_batch(b->pq, buf, room);
        if (n > 0 && !b->window_open) {
            b->window_open = true;
            b->window_opened_at = now;
        }
        for (int i = 0; i < n; ++i) b->pending.push_back(buf[i]);
    }
    if (b->pending.empty()) return 0;
    bool expired = b->window_open &&
                   (now - b->window_opened_at) * 1000.0 >= b->window_ms;
    if (static_cast<int>(b->pending.size()) < eff && !expired) return 0;
    int n = 0;
    while (!b->pending.empty() && n < cap) {
        out[n++] = b->pending.front();
        b->pending.pop_front();
    }
    b->window_open = false;
    return n;
}

// Dispatch whatever is pending immediately (shutdown drain).
int batcher_flush(void* p, uint64_t* out, int cap) {
    auto* b = static_cast<Batcher*>(p);
    std::lock_guard<std::mutex> lock(b->mu);
    int n = 0;
    while (!b->pending.empty() && n < cap) {
        out[n++] = b->pending.front();
        b->pending.pop_front();
    }
    b->window_open = false;
    return n;
}

}  // extern "C"
