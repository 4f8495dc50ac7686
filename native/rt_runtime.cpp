// Native real-time runtime for the serving host.
//
// The reference's real-time story lives in C++ host code: a three-phase
// backoff spinlock (/root/reference/HIRT_Multichannel_Convolution/ThreadLocks.hpp:51-87),
// a lock-guarded hot-swappable buffer the audio thread may only attempt()
// (MemorySwap.h:174-212), and dual staging buffers that decouple the audio
// callback from the processing cadence (PartitionedConvolve.cpp:304-307,
// TimeDomainConvolve.cpp:142-143). This library is that runtime for the JAX
// framework: the device compute is JAX, but the serving host around it —
// the audio-callback thread, the lock discipline, the sample staging — is
// native so a real audio callback (PortAudio/JACK/CoreAudio) can run it
// without touching the Python interpreter.
//
// Components (all original code; the reference files cited describe the
// *semantics* being reproduced, not the implementation):
//  - ht_lock_*  three-phase backoff spinlock (spin, timed spin, sleep)
//  - ht_swap_*  hot-swappable (value, size) cell guarded by that lock; the
//               old value is returned to the swapping thread so it is always
//               freed by the assigning side (MemorySwap.h:15-17 discipline)
//  - ht_ring_*  lock-free single-producer/single-consumer float ring buffer
//               (the staging-buffer counterpart; audio-callback safe)
//  - ht_host_*  a simulated duplex audio-callback thread: produces capture
//               blocks into an input ring and consumes playback blocks from
//               an output ring at a fixed block cadence, counting
//               overruns/underruns — the native test driver for the serving
//               loop (the reference's - Test/ drivers are timing hosts; this
//               is the real-time analogue).
//
// Build: g++ -O3 -shared -fPIC -pthread -o librt_runtime.so rt_runtime.cpp

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>

namespace {

using Clock = std::chrono::steady_clock;

inline void nano_sleep(int64_t ns) {
    std::this_thread::sleep_for(std::chrono::nanoseconds(ns));
}

// ---------------------------------------------------------------------------
// Spinlock: three-phase backoff (ThreadLocks.hpp:51-87 semantics).
// ---------------------------------------------------------------------------

struct SpinLock {
    std::atomic_flag flag = ATOMIC_FLAG_INIT;

    bool attempt() { return !flag.test_and_set(std::memory_order_acquire); }

    void acquire() {
        // Phase 1: a burst of raw attempts.
        for (int i = 0; i < 10; i++)
            if (attempt()) return;
        // Phase 2: ~10 us of timed spinning.
        auto deadline = Clock::now() + std::chrono::microseconds(10);
        while (Clock::now() < deadline)
            if (attempt()) return;
        // Phase 3: yield the core between attempts.
        while (!attempt()) nano_sleep(100'000);
    }

    void release() { flag.clear(std::memory_order_release); }
};

// ---------------------------------------------------------------------------
// Hot-swappable cell (MemorySwap.h semantics over an opaque payload).
// ---------------------------------------------------------------------------

struct SwapCell {
    SpinLock lock;
    uint64_t value = 0;   // opaque payload (a pointer or a registry index)
    uint64_t size = 0;
};

// ---------------------------------------------------------------------------
// SPSC ring buffer. head: total elements written (producer-owned);
// tail: total elements read (consumer-owned). Capacity is a power of two.
// ---------------------------------------------------------------------------

template <typename T>
struct RingT {
    T* data = nullptr;
    uint64_t mask = 0;       // capacity - 1
    std::atomic<uint64_t> head{0};
    std::atomic<uint64_t> tail{0};

    uint64_t capacity() const { return mask + 1; }

    uint64_t readable() const {
        return head.load(std::memory_order_acquire) -
               tail.load(std::memory_order_acquire);
    }

    uint64_t writable() const { return capacity() - readable(); }

    // Producer side: copy up to n elements in; returns the count written.
    uint64_t write(const T* src, uint64_t n) {
        uint64_t h = head.load(std::memory_order_relaxed);
        uint64_t t = tail.load(std::memory_order_acquire);
        uint64_t room = capacity() - (h - t);
        if (n > room) n = room;
        for (uint64_t i = 0; i < n; i++) data[(h + i) & mask] = src[i];
        head.store(h + n, std::memory_order_release);
        return n;
    }

    // Consumer side: copy up to n elements out; returns the count read.
    uint64_t read(T* dst, uint64_t n) {
        uint64_t t = tail.load(std::memory_order_relaxed);
        uint64_t h = head.load(std::memory_order_acquire);
        uint64_t avail = h - t;
        if (n > avail) n = avail;
        for (uint64_t i = 0; i < n; i++) dst[i] = data[(t + i) & mask];
        tail.store(t + n, std::memory_order_release);
        return n;
    }

    // Consumer side: drop up to n elements; returns the count dropped.
    uint64_t discard(uint64_t n) {
        uint64_t t = tail.load(std::memory_order_relaxed);
        uint64_t h = head.load(std::memory_order_acquire);
        uint64_t avail = h - t;
        if (n > avail) n = avail;
        tail.store(t + n, std::memory_order_release);
        return n;
    }
};

using Ring = RingT<float>;        // audio staging (samples)
using ByteRing = RingT<uint8_t>;  // data-loader staging (raw PCM bytes)

template <typename T>
void* ring_create(uint64_t capacity) {
    uint64_t cap = 1;
    while (cap < capacity) cap <<= 1;
    RingT<T>* r = new RingT<T>();
    r->data = new T[cap]();
    r->mask = cap - 1;
    return r;
}

// ---------------------------------------------------------------------------
// Async file loader: a background thread streams a byte range of a file into
// a ByteRing with backpressure — the prefetching data-loader half of the
// native runtime (the reference reads synchronously on the caller's thread,
// IAudioFile.cpp readAudio; a serving host wants the disk off the hot path).
// ---------------------------------------------------------------------------

struct FileLoader {
    FILE* file = nullptr;
    ByteRing* ring;
    uint64_t remaining;       // bytes left to deliver
    uint64_t chunk;           // read granularity
    std::atomic<bool> stop{false};
    std::atomic<bool> finished{false};
    std::atomic<int64_t> bytes_read{0};
    std::atomic<int64_t> stalls{0};   // ring-full backoffs
    std::atomic<int64_t> io_errors{0};
    std::thread thread;

    void run() {
        uint8_t* buf = new uint8_t[chunk];
        while (remaining > 0 && !stop.load()) {
            uint64_t want = remaining < chunk ? remaining : chunk;
            size_t got = fread(buf, 1, want, file);
            if (got == 0) { io_errors++; break; }
            uint64_t pushed = 0;
            while (pushed < got && !stop.load()) {
                uint64_t w = ring->write(buf + pushed, got - pushed);
                pushed += w;
                if (pushed < got) {
                    stalls++;
                    nano_sleep(200'000);
                }
            }
            remaining -= got;
            bytes_read += got;
        }
        delete[] buf;
        finished.store(true);
    }
};

// ---------------------------------------------------------------------------
// Simulated duplex audio-callback host.
// ---------------------------------------------------------------------------

struct HostStats {
    // `blocks` is polled by ht_host_done from another thread while the host
    // thread increments it — atomic, like FileLoader's finished/bytes_read.
    // The rest are only read after ht_host_join joins the thread.
    std::atomic<int64_t> blocks{0};  // callbacks fired
    int64_t underruns = 0;    // playback blocks with insufficient samples
    int64_t overruns = 0;     // capture blocks that didn't fit the input ring
    int64_t late_ns_max = 0;  // worst wake-up lateness observed
};

struct Host {
    Ring* in_ring;            // host -> worker (capture)
    Ring* out_ring;           // worker -> host (playback)
    const float* src;         // interleaved source, looped
    uint64_t src_len;         // floats
    uint64_t block_floats;    // frames_per_block * channels
    int64_t period_ns;
    int64_t total_blocks;     // stop after this many callbacks
    int64_t warmup_blocks;    // underruns not counted for the first W blocks
    float* sink;              // optional capture of played-back audio
    uint64_t sink_len;        // floats (total_blocks * block_floats expected)
    std::atomic<bool> stop{false};
    HostStats stats;
    std::thread thread;

    void run() {
        uint64_t src_pos = 0;
        uint64_t sink_pos = 0;
        float* scratch = new float[block_floats];
        auto next = Clock::now();
        for (int64_t b = 0; b < total_blocks && !stop.load(); b++) {
            next += std::chrono::nanoseconds(period_ns);
            std::this_thread::sleep_until(next);
            int64_t late = std::chrono::duration_cast<std::chrono::nanoseconds>(
                               Clock::now() - next).count();
            if (late > stats.late_ns_max) stats.late_ns_max = late;

            // Capture: push the next source block into the input ring.
            for (uint64_t i = 0; i < block_floats; i++) {
                scratch[i] = src[src_pos];
                if (++src_pos == src_len) src_pos = 0;
            }
            if (in_ring->write(scratch, block_floats) != block_floats)
                stats.overruns++;

            // Playback: pull one block from the output ring.
            uint64_t got = out_ring->read(scratch, block_floats);
            if (got < block_floats) {
                if (b >= warmup_blocks) stats.underruns++;
                std::memset(scratch + got, 0, (block_floats - got) * 4);
            }
            if (sink && sink_pos + block_floats <= sink_len) {
                std::memcpy(sink + sink_pos, scratch, block_floats * 4);
                sink_pos += block_floats;
            }
            stats.blocks.fetch_add(1, std::memory_order_relaxed);
        }
        delete[] scratch;
    }
};

}  // namespace

extern "C" {

// -- spinlock ---------------------------------------------------------------

void* ht_lock_create() { return new SpinLock(); }
void ht_lock_destroy(void* p) { delete static_cast<SpinLock*>(p); }
int32_t ht_lock_attempt(void* p) {
    return static_cast<SpinLock*>(p)->attempt() ? 1 : 0;
}
void ht_lock_acquire(void* p) { static_cast<SpinLock*>(p)->acquire(); }
void ht_lock_release(void* p) { static_cast<SpinLock*>(p)->release(); }

// -- swap cell --------------------------------------------------------------

void* ht_swap_create() { return new SwapCell(); }
void ht_swap_destroy(void* p) { delete static_cast<SwapCell*>(p); }

// Non-blocking acquire; returns 1 and fills (value, size) when the lock was
// free (MemorySwap::attempt, :180-185). The caller must release on success.
int32_t ht_swap_attempt(void* p, uint64_t* value, uint64_t* size) {
    SwapCell* c = static_cast<SwapCell*>(p);
    if (!c->lock.attempt()) return 0;
    *value = c->value;
    *size = c->size;
    return 1;
}

// Blocking acquire (MemorySwap::access, :174-178).
void ht_swap_access(void* p, uint64_t* value, uint64_t* size) {
    SwapCell* c = static_cast<SwapCell*>(p);
    c->lock.acquire();
    *value = c->value;
    *size = c->size;
}

// Replace the payload; requires the lock HELD by this thread. The previous
// payload is returned so the swapping thread frees it (MemorySwap.h:15-17).
void ht_swap_set(void* p, uint64_t value, uint64_t size,
                 uint64_t* old_value, uint64_t* old_size) {
    SwapCell* c = static_cast<SwapCell*>(p);
    *old_value = c->value;
    *old_size = c->size;
    c->value = value;
    c->size = size;
}

void ht_swap_release(void* p) { static_cast<SwapCell*>(p)->lock.release(); }

// -- SPSC ring --------------------------------------------------------------

// capacity_floats is rounded up to a power of two.
void* ht_ring_create(uint64_t capacity_floats) {
    return ring_create<float>(capacity_floats);
}

void ht_ring_destroy(void* p) {
    Ring* r = static_cast<Ring*>(p);
    delete[] r->data;
    delete r;
}

uint64_t ht_ring_capacity(void* p) { return static_cast<Ring*>(p)->capacity(); }
uint64_t ht_ring_readable(void* p) { return static_cast<Ring*>(p)->readable(); }
uint64_t ht_ring_writable(void* p) { return static_cast<Ring*>(p)->writable(); }
uint64_t ht_ring_write(void* p, const float* src, uint64_t n) {
    return static_cast<Ring*>(p)->write(src, n);
}
uint64_t ht_ring_read(void* p, float* dst, uint64_t n) {
    return static_cast<Ring*>(p)->read(dst, n);
}
uint64_t ht_ring_discard(void* p, uint64_t n) {
    return static_cast<Ring*>(p)->discard(n);
}

// -- byte ring (data-loader staging) ---------------------------------------

void* ht_bring_create(uint64_t capacity_bytes) {
    return ring_create<uint8_t>(capacity_bytes);
}

void ht_bring_destroy(void* p) {
    ByteRing* r = static_cast<ByteRing*>(p);
    delete[] r->data;
    delete r;
}

uint64_t ht_bring_capacity(void* p) {
    return static_cast<ByteRing*>(p)->capacity();
}
uint64_t ht_bring_readable(void* p) {
    return static_cast<ByteRing*>(p)->readable();
}
uint64_t ht_bring_writable(void* p) {
    return static_cast<ByteRing*>(p)->writable();
}
uint64_t ht_bring_write(void* p, const uint8_t* src, uint64_t n) {
    return static_cast<ByteRing*>(p)->write(src, n);
}
uint64_t ht_bring_read(void* p, uint8_t* dst, uint64_t n) {
    return static_cast<ByteRing*>(p)->read(dst, n);
}

// -- async file loader ------------------------------------------------------

// Streams [offset, offset + length) of the file into the byte ring from a
// background thread. Returns null when the file cannot be opened/positioned.
void* ht_loader_create(const char* path, uint64_t offset, uint64_t length,
                       uint64_t chunk_bytes, void* byte_ring) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    if (fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
        fclose(f);
        return nullptr;
    }
    FileLoader* l = new FileLoader();
    l->file = f;
    l->ring = static_cast<ByteRing*>(byte_ring);
    l->remaining = length;
    l->chunk = chunk_bytes ? chunk_bytes : (1 << 16);
    l->thread = std::thread([l] { l->run(); });
    return l;
}

int32_t ht_loader_finished(void* p) {
    return static_cast<FileLoader*>(p)->finished.load() ? 1 : 0;
}

void ht_loader_join(void* p, int64_t* bytes_read, int64_t* stalls,
                    int64_t* io_errors) {
    FileLoader* l = static_cast<FileLoader*>(p);
    l->stop.store(true);
    if (l->thread.joinable()) l->thread.join();
    *bytes_read = l->bytes_read.load();
    *stalls = l->stalls.load();
    *io_errors = l->io_errors.load();
}

void ht_loader_destroy(void* p) {
    FileLoader* l = static_cast<FileLoader*>(p);
    l->stop.store(true);
    if (l->thread.joinable()) l->thread.join();
    if (l->file) fclose(l->file);
    delete l;
}

// -- audio-callback host ----------------------------------------------------

// Starts the callback thread immediately. src is copied by reference — it
// must outlive the host. sink (optional, may be null) receives the played
// audio verbatim for offline verification.
void* ht_host_create(void* in_ring, void* out_ring,
                     const float* src, uint64_t src_len,
                     int32_t frames_per_block, int32_t channels,
                     double sample_rate, int64_t total_blocks,
                     int64_t warmup_blocks, float* sink, uint64_t sink_len) {
    Host* h = new Host();
    h->in_ring = static_cast<Ring*>(in_ring);
    h->out_ring = static_cast<Ring*>(out_ring);
    h->src = src;
    h->src_len = src_len;
    h->block_floats = static_cast<uint64_t>(frames_per_block) * channels;
    h->period_ns = static_cast<int64_t>(1e9 * frames_per_block / sample_rate);
    h->total_blocks = total_blocks;
    h->warmup_blocks = warmup_blocks;
    h->sink = sink;
    h->sink_len = sink_len;
    h->thread = std::thread([h] { h->run(); });
    return h;
}

int32_t ht_host_done(void* p) {
    Host* h = static_cast<Host*>(p);
    return h->stats.blocks.load(std::memory_order_relaxed)
               >= h->total_blocks ? 1 : 0;
}

// Joins the thread (signalling stop first) and fills the stats.
void ht_host_join(void* p, int64_t* blocks, int64_t* underruns,
                  int64_t* overruns, int64_t* late_ns_max) {
    Host* h = static_cast<Host*>(p);
    h->stop.store(true);
    if (h->thread.joinable()) h->thread.join();
    *blocks = h->stats.blocks.load(std::memory_order_relaxed);
    *underruns = h->stats.underruns;
    *overruns = h->stats.overruns;
    *late_ns_max = h->stats.late_ns_max;
}

void ht_host_destroy(void* p) {
    Host* h = static_cast<Host*>(p);
    h->stop.store(true);
    if (h->thread.joinable()) h->thread.join();
    delete h;
}

int32_t ht_rt_version() { return 1; }

}  // extern "C"
