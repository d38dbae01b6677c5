// Lock-free bounded MPMC ring over a shared-memory region (Vyukov
// per-slot-sequence design): the native experience transport between actor
// processes and the learner. The reference ships experience blocks through
// Ray's plasma object store (C++; worker.py:558,565) — this
// is the framework's equivalent: fixed-shape Block records move host→host
// with ONE memcpy per side and no pickling, through a region created by
// Python's multiprocessing.shared_memory and operated on entirely here.
//
// Layout of the region (64-bit words, 8-byte aligned):
//   [0]  capacity (slots)
//   [1]  slot_bytes (payload bytes per slot)
//   [2]  enqueue_pos   (atomic)
//   [3]  dequeue_pos   (atomic)
//   [4..] per-slot: { atomic<u64> seq; atomic<u64> reserve_ms;
//                     u8 payload[slot_stride-16] }
//
// Cross-process safety: std::atomic<uint64_t> is address-free/lock-free on
// every 64-bit target this builds on (asserted), so the atomics work across
// processes mapping the same region. Multiple producers (actor processes)
// and one-or-more consumers are both safe — the algorithm is full MPMC.
//
// Crash recovery: a producer dying between reserve and commit would wedge
// the ring forever (the head slot never publishes). reserve stamps the slot
// with CLOCK_MONOTONIC ms (shared across processes on Linux); the
// supervisor — after reaping a dead actor process — calls
// ring_recover_stalled() to skip head slots that are reserved-uncommitted
// (enqueue_pos passed them but seq never advanced) AND stale beyond a
// grace, which a live producer's millisecond-scale memcpy can never be.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>

static_assert(sizeof(std::atomic<uint64_t>) == 8, "atomic u64 must be 8B");

namespace {

struct Header {
  uint64_t capacity;
  uint64_t slot_bytes;
  std::atomic<uint64_t> enqueue_pos;
  std::atomic<uint64_t> dequeue_pos;
};

inline uint64_t slot_stride(uint64_t slot_bytes) {
  // seq word + reserve-timestamp word + aligned payload
  return 16 + ((slot_bytes + 7) & ~uint64_t(7));
}

inline std::atomic<uint64_t>* slot_seq(void* base, uint64_t idx) {
  auto* h = static_cast<Header*>(base);
  char* slots = static_cast<char*>(base) + sizeof(Header);
  return reinterpret_cast<std::atomic<uint64_t>*>(
      slots + idx * slot_stride(h->slot_bytes));
}

inline std::atomic<uint64_t>* slot_ts(void* base, uint64_t idx) {
  return slot_seq(base, idx) + 1;
}

inline char* slot_payload(void* base, uint64_t idx) {
  return reinterpret_cast<char*>(slot_seq(base, idx)) + 16;
}

inline uint64_t monotonic_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000 + uint64_t(ts.tv_nsec) / 1000000;
}

}  // namespace

extern "C" {

uint64_t ring_required_bytes(uint64_t capacity, uint64_t slot_bytes) {
  return sizeof(Header) + capacity * slot_stride(slot_bytes);
}

void ring_init(void* base, uint64_t capacity, uint64_t slot_bytes) {
  auto* h = static_cast<Header*>(base);
  h->capacity = capacity;
  h->slot_bytes = slot_bytes;
  h->enqueue_pos.store(0, std::memory_order_relaxed);
  h->dequeue_pos.store(0, std::memory_order_relaxed);
  for (uint64_t i = 0; i < capacity; ++i)
    slot_seq(base, i)->store(i, std::memory_order_relaxed);
}

// Reserve/commit: reserve returns the position whose slot the caller may
// read/write EXCLUSIVELY until the matching commit publishes it. Lets the
// Python side serialize Block fields directly into the shared slot (one
// memcpy per side total) instead of staging through a packed buffer.

int64_t ring_reserve_push(void* base) {
  auto* h = static_cast<Header*>(base);
  uint64_t pos = h->enqueue_pos.load(std::memory_order_relaxed);
  for (;;) {
    uint64_t seq = slot_seq(base, pos % h->capacity)
                       ->load(std::memory_order_acquire);
    int64_t dif = int64_t(seq) - int64_t(pos);
    if (dif == 0) {
      // Stamp BEFORE the CAS: a winner must never be observable as
      // reserved with the slot's previous-lap (stale) timestamp, or
      // recover_stalled could reclaim a live reservation. A CAS loser's
      // stray stamp only freshens another writer's ts — recovery just
      // gets more conservative.
      slot_ts(base, pos % h->capacity)
          ->store(monotonic_ms(), std::memory_order_relaxed);
      if (h->enqueue_pos.compare_exchange_weak(pos, pos + 1,
                                               std::memory_order_relaxed)) {
        return int64_t(pos);
      }
    } else if (dif < 0) {
      return -1;  // full
    } else {
      pos = h->enqueue_pos.load(std::memory_order_relaxed);
    }
  }
}

void ring_commit_push(void* base, int64_t pos) {
  auto* h = static_cast<Header*>(base);
  slot_seq(base, uint64_t(pos) % h->capacity)
      ->store(uint64_t(pos) + 1, std::memory_order_release);
}

int64_t ring_reserve_pop(void* base) {
  auto* h = static_cast<Header*>(base);
  uint64_t pos = h->dequeue_pos.load(std::memory_order_relaxed);
  for (;;) {
    uint64_t seq = slot_seq(base, pos % h->capacity)
                       ->load(std::memory_order_acquire);
    int64_t dif = int64_t(seq) - int64_t(pos + 1);
    if (dif == 0) {
      if (h->dequeue_pos.compare_exchange_weak(pos, pos + 1,
                                               std::memory_order_relaxed))
        return int64_t(pos);
    } else if (dif < 0) {
      return -1;  // empty
    } else {
      pos = h->dequeue_pos.load(std::memory_order_relaxed);
    }
  }
}

void ring_commit_pop(void* base, int64_t pos) {
  auto* h = static_cast<Header*>(base);
  slot_seq(base, uint64_t(pos) % h->capacity)
      ->store(uint64_t(pos) + h->capacity, std::memory_order_release);
}

// Byte offset of a reserved position's payload from the region base.
uint64_t ring_payload_offset(void* base, int64_t pos) {
  auto* h = static_cast<Header*>(base);
  return uint64_t(slot_payload(base, uint64_t(pos) % h->capacity) -
                  static_cast<char*>(base));
}

// Skip head slots wedged by a crashed producer: reserved (enqueue_pos is
// past them) but uncommitted (seq never advanced) and stale for more than
// ``stale_ms``. Call ONLY after reaping a dead producer — the staleness
// grace is what protects a live producer mid-memcpy. Returns slots freed.
uint64_t ring_recover_stalled(void* base, uint64_t stale_ms) {
  auto* h = static_cast<Header*>(base);
  uint64_t freed = 0;
  for (;;) {
    uint64_t pos = h->dequeue_pos.load(std::memory_order_relaxed);
    uint64_t enq = h->enqueue_pos.load(std::memory_order_acquire);
    if (enq <= pos) break;  // nothing in flight
    auto* seq_w = slot_seq(base, pos % h->capacity);
    uint64_t seq = seq_w->load(std::memory_order_acquire);
    if (seq != pos) break;  // head slot is committed (or already recycled)
    uint64_t ts = slot_ts(base, pos % h->capacity)
                      ->load(std::memory_order_relaxed);
    if (monotonic_ms() - ts < stale_ms) break;  // give a live writer time
    if (h->dequeue_pos.compare_exchange_strong(pos, pos + 1,
                                               std::memory_order_relaxed)) {
      seq_w->store(pos + h->capacity, std::memory_order_release);
      ++freed;
    }
  }
  return freed;
}

// Approximate occupancy (racy by nature; fine for monitoring).
uint64_t ring_size(void* base) {
  auto* h = static_cast<Header*>(base);
  uint64_t e = h->enqueue_pos.load(std::memory_order_relaxed);
  uint64_t d = h->dequeue_pos.load(std::memory_order_relaxed);
  return e > d ? e - d : 0;
}

}  // extern "C"
