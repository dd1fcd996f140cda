// liorf_runtime — native host runtime for lio_slam_tpu_torch (the port's own
// copy of native/liorf_runtime.cpp; the two must not drift apart, which
// tests/test_torch_native.py checks).
//
// Replacement for the reference's intra-process runtime plumbing
// (C++ there too): the bounded subscriber deques + mutex handoff in
// imageProjection/mapOptmization/imuPreintegration (e.g.
// imageProjection.cpp:116-118 cloud queue 5-deep, IMU/odom queues 2000-deep,
// stale-sample pops under std::mutex), and the PCD export fast path used by
// the save-map service (mapOptmization.cpp:928-963).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).  All queues are
// single-producer/single-consumer lock-free rings — the host feeder thread
// pushes sensor records while the python driver drains windows for the
// device; no GIL involvement on the producer side.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Generic SPSC ring buffer of fixed-size records
// ---------------------------------------------------------------------------

struct RingBuffer {
    size_t record_size;
    size_t capacity;          // power of two
    std::atomic<uint64_t> head{0};   // consumer position
    std::atomic<uint64_t> tail{0};   // producer position
    uint8_t* data;
};

static size_t next_pow2(size_t v) {
    size_t p = 1;
    while (p < v) p <<= 1;
    return p;
}

void* rb_create(size_t record_size, size_t capacity) {
    auto* rb = new RingBuffer();
    rb->record_size = record_size;
    rb->capacity = next_pow2(capacity);
    rb->data = static_cast<uint8_t*>(std::malloc(rb->capacity * record_size));
    if (!rb->data) { delete rb; return nullptr; }
    return rb;
}

int rb_push(void* h, const void* rec) {
    auto* rb = static_cast<RingBuffer*>(h);
    uint64_t tail = rb->tail.load(std::memory_order_relaxed);
    uint64_t head = rb->head.load(std::memory_order_acquire);
    if (tail - head >= rb->capacity) return -1;  // full
    std::memcpy(rb->data + (tail & (rb->capacity - 1)) * rb->record_size,
                rec, rb->record_size);
    rb->tail.store(tail + 1, std::memory_order_release);
    return 0;
}

int rb_push_overwrite(void* h, const void* rec) {
    // bounded-queue semantics of the reference's subscriber queues: the
    // oldest record is dropped when full (queue_size overflow in ROS)
    auto* rb = static_cast<RingBuffer*>(h);
    if (rb_push(h, rec) == 0) return 0;
    uint64_t head = rb->head.load(std::memory_order_relaxed);
    rb->head.store(head + 1, std::memory_order_release);
    return rb_push(h, rec) == 0 ? 1 : -1;
}

int rb_pop(void* h, void* rec) {
    auto* rb = static_cast<RingBuffer*>(h);
    uint64_t head = rb->head.load(std::memory_order_relaxed);
    uint64_t tail = rb->tail.load(std::memory_order_acquire);
    if (head == tail) return -1;                 // empty
    std::memcpy(rec, rb->data + (head & (rb->capacity - 1)) * rb->record_size,
                rb->record_size);
    rb->head.store(head + 1, std::memory_order_release);
    return 0;
}

size_t rb_size(void* h) {
    auto* rb = static_cast<RingBuffer*>(h);
    return static_cast<size_t>(rb->tail.load(std::memory_order_acquire)
                               - rb->head.load(std::memory_order_acquire));
}

void rb_destroy(void* h) {
    auto* rb = static_cast<RingBuffer*>(h);
    std::free(rb->data);
    delete rb;
}

// ---------------------------------------------------------------------------
// Timestamped sample queue with windowed extraction (IMU / odometry feeds)
// ---------------------------------------------------------------------------
// Mirrors the reference's pattern: push at sensor rate; per scan, pop
// samples up to (scan_start - margin) and hand the window
// [scan_start - margin, scan_end] to deskew/preintegration
// (imageProjection.cpp:359-418 stale-pop + bracketing).

struct SampleQueue {
    size_t dim;                  // floats per sample
    size_t capacity;
    std::vector<double> ts;
    std::vector<float> vals;
    size_t begin = 0, end = 0;   // ring indices (not wrapped; compacted)
};

void* sq_create(size_t dim, size_t capacity) {
    auto* q = new SampleQueue();
    q->dim = dim;
    q->capacity = capacity;
    q->ts.resize(capacity);
    q->vals.resize(capacity * dim);
    return q;
}

int sq_push(void* h, double t, const float* vals) {
    auto* q = static_cast<SampleQueue*>(h);
    if (q->end == q->capacity) {
        // compact: drop consumed prefix
        size_t n = q->end - q->begin;
        std::memmove(q->ts.data(), q->ts.data() + q->begin, n * sizeof(double));
        std::memmove(q->vals.data(), q->vals.data() + q->begin * q->dim,
                     n * q->dim * sizeof(float));
        q->begin = 0;
        q->end = n;
        if (q->end == q->capacity) {  // still full: drop oldest
            std::memmove(q->ts.data(), q->ts.data() + 1,
                         (n - 1) * sizeof(double));
            std::memmove(q->vals.data(), q->vals.data() + q->dim,
                         (n - 1) * q->dim * sizeof(float));
            q->end = n - 1;
        }
    }
    // Hostile-stream tolerance: real vehicle logs contain locally
    // out-of-order and duplicated messages (loaded TCPROS graphs misorder;
    // recorders duplicate).  A late sample is inserted at its sorted
    // position (jitter is local, so the shift is a few records); an exact
    // duplicate of an existing timestamp is dropped — the window contract
    // (sorted, unique) holds for deskew/preintegration downstream.
    size_t pos = q->end;
    while (pos > q->begin && q->ts[pos - 1] > t) pos--;
    if (pos > q->begin && q->ts[pos - 1] == t) return 0;   // duplicate
    if (pos < q->end) {
        std::memmove(q->ts.data() + pos + 1, q->ts.data() + pos,
                     (q->end - pos) * sizeof(double));
        std::memmove(q->vals.data() + (pos + 1) * q->dim,
                     q->vals.data() + pos * q->dim,
                     (q->end - pos) * q->dim * sizeof(float));
    }
    q->ts[pos] = t;
    std::memcpy(q->vals.data() + pos * q->dim, vals,
                q->dim * sizeof(float));
    q->end++;
    return 0;
}

// Extract samples with t in [t0, t1]; samples strictly older than t0 - margin
// are dropped (the reference pops IMU older than scan_start - 0.01,
// imageProjection.cpp:365-369).  Returns the number of samples written.
int sq_window(void* h, double t0, double t1, double margin,
              double* ts_out, float* vals_out, int max_n) {
    auto* q = static_cast<SampleQueue*>(h);
    size_t b = q->begin;
    while (b < q->end && q->ts[b] < t0 - margin) b++;
    q->begin = b;                      // permanently drop stale samples
    int n = 0;
    for (size_t i = b; i < q->end && n < max_n; ++i) {
        if (q->ts[i] > t1) break;
        ts_out[n] = q->ts[i];
        std::memcpy(vals_out + n * q->dim, q->vals.data() + i * q->dim,
                    q->dim * sizeof(float));
        n++;
    }
    return n;
}

size_t sq_size(void* h) {
    auto* q = static_cast<SampleQueue*>(h);
    return q->end - q->begin;
}

void sq_destroy(void* h) { delete static_cast<SampleQueue*>(h); }

// ---------------------------------------------------------------------------
// PCD binary fast path (pcl::io::savePCDFileBinary equivalent)
// ---------------------------------------------------------------------------

int pcd_write_binary(const char* path, const float* xyz,
                     const float* intensity, long n) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    const int with_i = intensity != nullptr;
    std::fprintf(f,
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        "FIELDS %s\nSIZE %s\nTYPE %s\nCOUNT %s\n"
        "WIDTH %ld\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS %ld\nDATA binary\n",
        with_i ? "x y z intensity" : "x y z",
        with_i ? "4 4 4 4" : "4 4 4",
        with_i ? "F F F F" : "F F F",
        with_i ? "1 1 1 1" : "1 1 1",
        n, n);
    if (with_i) {
        std::vector<float> row(4);
        for (long i = 0; i < n; ++i) {
            row[0] = xyz[i * 3 + 0];
            row[1] = xyz[i * 3 + 1];
            row[2] = xyz[i * 3 + 2];
            row[3] = intensity[i];
            std::fwrite(row.data(), sizeof(float), 4, f);
        }
    } else {
        std::fwrite(xyz, sizeof(float), static_cast<size_t>(n) * 3, f);
    }
    std::fclose(f);
    return 0;
}

// voxel-downsample on host (ingest-side decimation before device transfer);
// centroid per occupied voxel, like pcl::VoxelGrid.  Returns output count.
long host_voxel_downsample(const float* xyz, long n, float leaf,
                           float* out, long max_out) {
    struct Cell { int64_t key; float x, y, z; int cnt; };
    std::vector<std::pair<int64_t, long>> keys(static_cast<size_t>(n));
    const double inv = 1.0 / leaf;
    for (long i = 0; i < n; ++i) {
        int64_t cx = static_cast<int64_t>(std::floor(xyz[i * 3 + 0] * inv));
        int64_t cy = static_cast<int64_t>(std::floor(xyz[i * 3 + 1] * inv));
        int64_t cz = static_cast<int64_t>(std::floor(xyz[i * 3 + 2] * inv));
        keys[static_cast<size_t>(i)] = {
            (cx * 73856093) ^ (cy * 19349663) ^ (cz * 83492791), i};
    }
    std::sort(keys.begin(), keys.end());
    long m = 0;
    size_t i = 0;
    while (i < keys.size() && m < max_out) {
        int64_t k = keys[i].first;
        double sx = 0, sy = 0, sz = 0;
        int c = 0;
        while (i < keys.size() && keys[i].first == k) {
            long src = keys[i].second;
            sx += xyz[src * 3 + 0];
            sy += xyz[src * 3 + 1];
            sz += xyz[src * 3 + 2];
            ++c; ++i;
        }
        out[m * 3 + 0] = static_cast<float>(sx / c);
        out[m * 3 + 1] = static_cast<float>(sy / c);
        out[m * 3 + 2] = static_cast<float>(sz / c);
        ++m;
    }
    return m;
}

}  // extern "C"
