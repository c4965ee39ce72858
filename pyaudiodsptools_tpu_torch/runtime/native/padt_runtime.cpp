// Native realtime runtime: lock-free SPSC ring buffers + stream pump stats.
//
// Role: the reference's realtime path runs inside PortAudio's C callback
// thread (Example3.py:20-25) with a hard deadline of block_size/sample_rate
// seconds. This library is the host-side native layer of the PyTorch/CUDA
// engine: audio producers/consumers exchange float32 samples with the Python
// pump through wait-free single-producer/single-consumer rings, and the pump
// tracks deadline statistics (xruns, worst-case block latency).
//
// The DSP itself runs on the GPU (the chain's streaming step); this layer is
// the glue that must never allocate, lock, or syscall on the audio thread.
// It is the JAX package's runtime/native/padt_runtime.cpp, kept as the port's
// own copy.
//
// C ABI only -- consumed from Python via ctypes.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

namespace {

struct Ring {
  float* data;
  size_t capacity;  // power of two
  size_t mask;
  alignas(64) std::atomic<uint64_t> head;  // write index (producer-owned)
  alignas(64) std::atomic<uint64_t> tail;  // read index (consumer-owned)
};

size_t next_pow2(size_t v) {
  size_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

Ring* padt_ring_create(size_t capacity) {
  Ring* r = static_cast<Ring*>(std::malloc(sizeof(Ring)));
  if (!r) return nullptr;
  r->capacity = next_pow2(capacity < 2 ? 2 : capacity);
  r->mask = r->capacity - 1;
  r->data = static_cast<float*>(std::calloc(r->capacity, sizeof(float)));
  if (!r->data) {
    std::free(r);
    return nullptr;
  }
  new (&r->head) std::atomic<uint64_t>(0);
  new (&r->tail) std::atomic<uint64_t>(0);
  return r;
}

void padt_ring_destroy(Ring* r) {
  if (!r) return;
  std::free(r->data);
  std::free(r);
}

size_t padt_ring_capacity(const Ring* r) { return r->capacity; }

size_t padt_ring_available(const Ring* r) {
  return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                             r->tail.load(std::memory_order_acquire));
}

size_t padt_ring_space(const Ring* r) {
  return r->capacity - padt_ring_available(r);
}

// Producer side. Returns samples actually written (partial when full).
size_t padt_ring_write(Ring* r, const float* src, size_t n) {
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  size_t space = r->capacity - static_cast<size_t>(head - tail);
  if (n > space) n = space;
  for (size_t i = 0; i < n; ++i) {
    r->data[(head + i) & r->mask] = src[i];
  }
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Consumer side. Returns samples actually read (partial when drained).
size_t padt_ring_read(Ring* r, float* dst, size_t n) {
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  size_t avail = static_cast<size_t>(head - tail);
  if (n > avail) n = avail;
  for (size_t i = 0; i < n; ++i) {
    dst[i] = r->data[(tail + i) & r->mask];
  }
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

// Consumer side, but zero-fills when underrun (realtime output contract:
// the audio device always gets a full block; we count the xrun instead).
size_t padt_ring_read_or_silence(Ring* r, float* dst, size_t n) {
  size_t got = padt_ring_read(r, dst, n);
  if (got < n) std::memset(dst + got, 0, (n - got) * sizeof(float));
  return got;
}

// ---------------------------------------------------------------------------
// Pump statistics: deadline accounting for a block-processing loop.

struct PumpStats {
  std::atomic<uint64_t> blocks;
  std::atomic<uint64_t> xruns;
  std::atomic<uint64_t> total_ns;
  std::atomic<uint64_t> worst_ns;
  uint64_t deadline_ns;
};

PumpStats* padt_stats_create(uint64_t deadline_ns) {
  PumpStats* s = static_cast<PumpStats*>(std::malloc(sizeof(PumpStats)));
  if (!s) return nullptr;
  new (&s->blocks) std::atomic<uint64_t>(0);
  new (&s->xruns) std::atomic<uint64_t>(0);
  new (&s->total_ns) std::atomic<uint64_t>(0);
  new (&s->worst_ns) std::atomic<uint64_t>(0);
  s->deadline_ns = deadline_ns;
  return s;
}

void padt_stats_destroy(PumpStats* s) { std::free(s); }

void padt_stats_record(PumpStats* s, uint64_t elapsed_ns) {
  s->blocks.fetch_add(1, std::memory_order_relaxed);
  s->total_ns.fetch_add(elapsed_ns, std::memory_order_relaxed);
  uint64_t prev = s->worst_ns.load(std::memory_order_relaxed);
  while (elapsed_ns > prev &&
         !s->worst_ns.compare_exchange_weak(prev, elapsed_ns,
                                            std::memory_order_relaxed)) {
  }
  if (elapsed_ns > s->deadline_ns) {
    s->xruns.fetch_add(1, std::memory_order_relaxed);
  }
}

uint64_t padt_stats_blocks(const PumpStats* s) {
  return s->blocks.load(std::memory_order_relaxed);
}
uint64_t padt_stats_xruns(const PumpStats* s) {
  return s->xruns.load(std::memory_order_relaxed);
}
uint64_t padt_stats_total_ns(const PumpStats* s) {
  return s->total_ns.load(std::memory_order_relaxed);
}
uint64_t padt_stats_worst_ns(const PumpStats* s) {
  return s->worst_ns.load(std::memory_order_relaxed);
}

}  // extern "C"
