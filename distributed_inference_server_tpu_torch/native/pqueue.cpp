// Priority queue manager with backpressure hysteresis — native C++ tier.
//
// The reference implements this queue in Rust (crates/core/src/queue.rs:
// three FIFO levels drained in strict priority order, hysteresis
// backpressure between low/high watermarks, absolute cap, timeout expiry
// sweep). This is the same contract as a C ABI shared library so the
// serving layer's hot host path (every request admission and batch drain)
// runs native; distributed_inference_server_tpu_torch/core/queue.py holds the
// canonical semantics and the differential tests drive both.
//
// Requests are opaque u64 handles; ownership of payloads stays with the
// caller (the ctypes wrapper maps handles back to Python objects).

#include <cstddef>
#include <cstdint>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Entry {
    uint64_t handle;
    double enqueued_at;
};

struct PQueue {
    std::deque<Entry> queues[3];  // 0=High, 1=Normal, 2=Low
    int high_watermark;
    int low_watermark;
    double timeout_s;
    int max_size;
    bool backpressure = false;
    std::mutex mu;

    size_t total() const {
        return queues[0].size() + queues[1].size() + queues[2].size();
    }
    // Hysteresis: activate above high watermark, release below low
    // (queue.rs:235-249 semantics; Property 7).
    void update_backpressure() {
        size_t t = total();
        if (backpressure) {
            if (t < static_cast<size_t>(low_watermark)) backpressure = false;
        } else {
            if (t > static_cast<size_t>(high_watermark)) backpressure = true;
        }
    }
};

}  // namespace

extern "C" {

void* pq_create(int high_wm, int low_wm, double timeout_s, int max_size) {
    auto* q = new PQueue();
    q->high_watermark = high_wm;
    q->low_watermark = low_wm;
    q->timeout_s = timeout_s;
    q->max_size = max_size;
    return q;
}

void pq_destroy(void* p) { delete static_cast<PQueue*>(p); }

// Hot-reload of watermarks/timeout/cap (requirements.md:146): applies to
// subsequent operations; the backpressure flag re-evaluates on next update.
void pq_set_config(void* p, int high_wm, int low_wm, double timeout_s,
                   int max_size) {
    auto* q = static_cast<PQueue*>(p);
    std::lock_guard<std::mutex> lock(q->mu);
    q->high_watermark = high_wm;
    q->low_watermark = low_wm;
    q->timeout_s = timeout_s;
    q->max_size = max_size;
    q->update_backpressure();
}

// 0 = enqueued, -1 = rejected (backpressure active or absolute cap).
int pq_enqueue(void* p, uint64_t handle, int priority, double enqueued_at) {
    auto* q = static_cast<PQueue*>(p);
    std::lock_guard<std::mutex> lock(q->mu);
    if (q->backpressure) return -1;
    if (q->total() >= static_cast<size_t>(q->max_size)) return -1;
    if (priority < 0 || priority > 2) return -2;
    q->queues[priority].push_back({handle, enqueued_at});
    q->update_backpressure();
    return 0;
}

// Strict priority drain, FIFO within a level (Property 6). Returns count.
int pq_dequeue_batch(void* p, uint64_t* out, int max_count) {
    auto* q = static_cast<PQueue*>(p);
    std::lock_guard<std::mutex> lock(q->mu);
    int n = 0;
    for (int level = 0; level < 3 && n < max_count; ++level) {
        auto& dq = q->queues[level];
        while (n < max_count && !dq.empty()) {
            out[n++] = dq.front().handle;
            dq.pop_front();
        }
    }
    q->update_backpressure();
    return n;
}

// 1 = dequeued into *out, 0 = empty.
int pq_dequeue_one(void* p, uint64_t* out) {
    return pq_dequeue_batch(p, out, 1);
}

// out3 = {high, normal, low}.
void pq_depth(void* p, int* out3) {
    auto* q = static_cast<PQueue*>(p);
    std::lock_guard<std::mutex> lock(q->mu);
    for (int i = 0; i < 3; ++i) out3[i] = static_cast<int>(q->queues[i].size());
}

int pq_is_accepting(void* p) {
    auto* q = static_cast<PQueue*>(p);
    std::lock_guard<std::mutex> lock(q->mu);
    return q->backpressure ? 0 : 1;
}

// Sweep entries older than timeout (strictly greater, matching
// queue.rs:64-66 / queue.py is_expired); survivors keep FIFO order
// (Property 8). Returns number of expired handles written (capped).
int pq_remove_expired(void* p, double now, uint64_t* out, int cap) {
    auto* q = static_cast<PQueue*>(p);
    std::lock_guard<std::mutex> lock(q->mu);
    int n = 0;
    for (int level = 0; level < 3; ++level) {
        auto& dq = q->queues[level];
        std::deque<Entry> survivors;
        for (const auto& e : dq) {
            if ((now - e.enqueued_at) > q->timeout_s) {
                if (n < cap) out[n] = e.handle;
                ++n;
            } else {
                survivors.push_back(e);
            }
        }
        dq.swap(survivors);
    }
    q->update_backpressure();
    return n;
}

// 1 = found and removed, 0 = not queued.
int pq_cancel(void* p, uint64_t handle) {
    auto* q = static_cast<PQueue*>(p);
    std::lock_guard<std::mutex> lock(q->mu);
    for (int level = 0; level < 3; ++level) {
        auto& dq = q->queues[level];
        for (auto it = dq.begin(); it != dq.end(); ++it) {
            if (it->handle == handle) {
                dq.erase(it);
                q->update_backpressure();
                return 1;
            }
        }
    }
    return 0;
}

}  // extern "C"
