// Memory-mapped replay transition store with multithreaded batch gather.
//
// Native counterpart of YARR's disk-mode replay (uniform_replay_buffer.py:322-386),
// which pickles ONE FILE PER TRANSITION and unpickles on every sample. Here a single
// mmap'd file holds fixed-stride rows: adds are a memcpy into the map, batch gathers
// fan out across threads straight into the caller's (pinned, numpy) buffer, and
// persistence is free — the file IS the buffer, so a crashed run resumes by reopening
// (the reference documents corrupted-pickle crashes as delete-and-restart).
//
// Layout: [Header | capacity * row_bytes]. Writes bump a monotone add counter last
// (release order) so concurrent readers never observe a torn row as valid.
//
// C ABI only — bound from Python via ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x56584152u;  // "VXAR"

struct Header {
  uint64_t magic;
  uint64_t capacity;
  uint64_t row_bytes;
  std::atomic<uint64_t> add_count;
  uint64_t reserved[4];
};

struct Store {
  int fd = -1;
  uint8_t* base = nullptr;
  size_t map_bytes = 0;
  Header* header = nullptr;
  uint8_t* rows = nullptr;
};

inline uint64_t row_slot(const Store* s, uint64_t index) {
  return index % s->header->capacity;
}

}  // namespace

extern "C" {

// Create (or truncate) a store file. Returns handle or nullptr.
void* rs_create(const char* path, uint64_t capacity, uint64_t row_bytes) {
  int fd = ::open(path, O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return nullptr;
  size_t bytes = sizeof(Header) + capacity * row_bytes;
  if (::ftruncate(fd, (off_t)bytes) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->base = (uint8_t*)base;
  s->map_bytes = bytes;
  s->header = (Header*)base;
  s->rows = s->base + sizeof(Header);
  s->header->magic = kMagic;
  s->header->capacity = capacity;
  s->header->row_bytes = row_bytes;
  s->header->add_count.store(0, std::memory_order_release);
  return s;
}

// Open an existing store. Returns nullptr on magic/shape mismatch.
void* rs_open(const char* path) {
  int fd = ::open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* base =
      ::mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->base = (uint8_t*)base;
  s->map_bytes = (size_t)st.st_size;
  s->header = (Header*)base;
  s->rows = s->base + sizeof(Header);
  if (s->header->magic != kMagic ||
      sizeof(Header) + s->header->capacity * s->header->row_bytes > s->map_bytes) {
    ::munmap(base, s->map_bytes);
    ::close(fd);
    delete s;
    return nullptr;
  }
  return s;
}

uint64_t rs_capacity(void* handle) {
  return ((Store*)handle)->header->capacity;
}

uint64_t rs_row_bytes(void* handle) {
  return ((Store*)handle)->header->row_bytes;
}

uint64_t rs_add_count(void* handle) {
  return ((Store*)handle)->header->add_count.load(std::memory_order_acquire);
}

uint64_t rs_size(void* handle) {
  Store* s = (Store*)handle;
  uint64_t n = rs_add_count(handle);
  uint64_t cap = s->header->capacity;
  return n < cap ? n : cap;
}

// Append one row; returns the slot written.
uint64_t rs_add(void* handle, const void* row) {
  Store* s = (Store*)handle;
  uint64_t idx = s->header->add_count.load(std::memory_order_relaxed);
  uint64_t slot = idx % s->header->capacity;
  std::memcpy(s->rows + slot * s->header->row_bytes, row, s->header->row_bytes);
  s->header->add_count.store(idx + 1, std::memory_order_release);
  return slot;
}

// Append n contiguous rows (bulk demo ingestion).
void rs_add_batch(void* handle, const void* rows, uint64_t n) {
  Store* s = (Store*)handle;
  const uint8_t* src = (const uint8_t*)rows;
  for (uint64_t i = 0; i < n; ++i) {
    rs_add(handle, src + i * s->header->row_bytes);
  }
}

// Gather rows at `indices` (slot ids in [0, size)) into `out`, using up to
// `num_threads` workers. out must hold n * row_bytes.
void rs_gather(void* handle, const uint64_t* indices, uint64_t n, void* out,
               int num_threads) {
  Store* s = (Store*)handle;
  const uint64_t rb = s->header->row_bytes;
  uint8_t* dst = (uint8_t*)out;
  auto work = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * rb, s->rows + row_slot(s, indices[i]) * rb, rb);
    }
  };
  if (num_threads <= 1 || n < 4) {
    work(0, n);
    return;
  }
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t t = (uint64_t)(num_threads < (int)hw ? num_threads : (int)hw);
  if (t < 1) t = 1;
  std::vector<std::thread> threads;
  uint64_t chunk = (n + t - 1) / t;
  for (uint64_t k = 0; k < t; ++k) {
    uint64_t lo = k * chunk;
    uint64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Read one row.
void rs_read(void* handle, uint64_t index, void* out) {
  Store* s = (Store*)handle;
  std::memcpy(out, s->rows + row_slot(s, index) * s->header->row_bytes,
              s->header->row_bytes);
}

void rs_flush(void* handle) {
  Store* s = (Store*)handle;
  ::msync(s->base, s->map_bytes, MS_SYNC);
}

}  // extern "C"

// ---------------------------------------------------------------------------------
// Async batch sampler: the native counterpart of the reference's
// DataLoader(num_workers, pin_memory) feed (pytorch_replay_buffer.py:75-82).
// Producer threads sample uniform transition indices, gather rows into a ring of
// pre-allocated batch buffers, and publish them; the consumer (Python) acquires a
// ready buffer (zero-copy numpy view), then releases it back to the free list.
// Known benign race: once add_count wraps capacity, a producer's memcpy of a row
// being concurrently overwritten by rs_add can read a torn row (mixed old/new
// bytes). Training tolerates a rare stale/torn sample; version rows if that ever
// changes.
// ---------------------------------------------------------------------------------

#include <chrono>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <random>

namespace {

struct Sampler {
  Store* store = nullptr;
  uint64_t batch = 0;
  uint64_t row_bytes = 0;
  std::vector<std::vector<uint8_t>> ring;
  std::deque<int> free_bufs;
  std::deque<int> ready_bufs;
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  // consumers blocked in bs_acquire; bs_stop drains them before delete
  int active_consumers = 0;
  std::condition_variable cv_drained;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  uint64_t seed = 0;

  void worker(int wid) {
    std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ull * (wid + 1));
    while (!stop.load(std::memory_order_relaxed)) {
      int buf = -1;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_bufs.empty(); });
        if (stop.load()) return;
        buf = free_bufs.front();
        free_bufs.pop_front();
      }
      // wait for enough transitions (the reference blocks the data iter the
      // same way until the replay holds a batch)
      uint64_t size;
      while ((size = rs_size(store)) < batch && !stop.load()) {
        std::this_thread::sleep_for(std::chrono::milliseconds(1));
      }
      if (stop.load()) return;
      uint8_t* dst = ring[buf].data();
      for (uint64_t i = 0; i < batch; ++i) {
        uint64_t idx = rng() % size;
        std::memcpy(dst + i * row_bytes,
                    store->rows + row_slot(store, idx) * row_bytes, row_bytes);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ready_bufs.push_back(buf);
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// Start the engine: `ring_size` batch buffers, `num_threads` producers.
void* bs_start(void* store_handle, uint64_t batch, int ring_size,
               int num_threads, uint64_t seed) {
  auto* sm = new Sampler();
  sm->store = (Store*)store_handle;
  sm->batch = batch;
  sm->row_bytes = sm->store->header->row_bytes;
  sm->seed = seed;
  sm->ring.resize(ring_size);
  for (int i = 0; i < ring_size; ++i) {
    sm->ring[i].resize(batch * sm->row_bytes);
    sm->free_bufs.push_back(i);
  }
  for (int w = 0; w < num_threads; ++w) {
    sm->workers.emplace_back([sm, w] { sm->worker(w); });
  }
  return sm;
}

// Block until a batch is ready; returns its ring index.
int bs_acquire(void* handle) {
  auto* sm = (Sampler*)handle;
  std::unique_lock<std::mutex> lk(sm->mu);
  sm->active_consumers++;
  sm->cv_ready.wait(lk, [&] { return sm->stop.load() || !sm->ready_bufs.empty(); });
  int buf = -1;
  if (!sm->ready_bufs.empty() && !sm->stop.load()) {
    buf = sm->ready_bufs.front();
    sm->ready_bufs.pop_front();
  }
  sm->active_consumers--;
  if (sm->active_consumers == 0) sm->cv_drained.notify_all();
  return buf;
}

// Pointer to a ring buffer's bytes (valid until bs_release of that index).
void* bs_buffer(void* handle, int buf) {
  auto* sm = (Sampler*)handle;
  return sm->ring[buf].data();
}

// Hand the buffer back to the producers.
void bs_release(void* handle, int buf) {
  auto* sm = (Sampler*)handle;
  {
    std::lock_guard<std::mutex> lk(sm->mu);
    sm->free_bufs.push_back(buf);
  }
  sm->cv_free.notify_one();
}

void bs_stop(void* handle) {
  auto* sm = (Sampler*)handle;
  {
    // fence: a consumer blocked in bs_acquire re-locks mu on wakeup, so the
    // Sampler must stay alive until every acquirer has left the wait
    std::unique_lock<std::mutex> lk(sm->mu);
    sm->stop.store(true);
    sm->cv_free.notify_all();
    sm->cv_ready.notify_all();
    sm->cv_drained.wait(lk, [&] { return sm->active_consumers == 0; });
  }
  for (auto& t : sm->workers) t.join();
  delete sm;
}

void rs_close(void* handle) {
  Store* s = (Store*)handle;
  if (s->base) ::munmap(s->base, s->map_bytes);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

}  // extern "C"
