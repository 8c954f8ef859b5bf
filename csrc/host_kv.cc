// Host-DRAM KV tier (SURVEY.md C6, L1): the spill backend behind the
// HBM-resident table. The reference class ships a native CPU hash-table
// backend (README.md:2 "Supports GPU, CPU"; .gitignore:14-17 shared-library
// artifacts); this is this framework's equivalent: an open-addressing
// int64 -> float32-row store exposed through a C ABI for ctypes (no pybind11
// in the toolchain). All batch entry points drop the GIL by construction
// (ctypes releases it around foreign calls) and shard large batches across a
// thread pool.
//
// Layout: power-of-two capacity, linear probing, tombstone-free deletion via
// backward-shift (keeps probe chains dense; no sticky overflow flags needed),
// grow-by-rehash at 85% load. Keys: arbitrary int64 except INT64_MIN
// (reserved empty sentinel, same convention as table/hashing.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <shared_mutex>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kEmpty = INT64_MIN;
constexpr double kMaxLoad = 0.85;

inline uint64_t mix64(uint64_t x) {
  // splitmix64 finalizer: full avalanche, matches quality of hashing.py.
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

class HostKV {
 public:
  HostKV(int width, int64_t cap_hint) : width_(width) {
    int64_t cap = 1024;
    while (cap < cap_hint * 2) cap <<= 1;
    Alloc(cap);
  }

  int width() const { return width_; }

  int64_t size() const {
    std::shared_lock<std::shared_mutex> g(mu_);
    return size_;
  }

  int64_t capacity() const {
    std::shared_lock<std::shared_mutex> g(mu_);
    return cap_;
  }

  void InsertBatch(int64_t n, const int64_t* keys, const float* rows) {
    std::unique_lock<std::shared_mutex> g(mu_);
    Reserve(size_ + n);
    for (int64_t i = 0; i < n; ++i) {
      if (keys[i] == kEmpty) continue;
      InsertOne(keys[i], rows + i * width_);
    }
  }

  int64_t LookupBatch(int64_t n, const int64_t* keys, float* out,
                      uint8_t* found) const {
    std::shared_lock<std::shared_mutex> g(mu_);
    std::atomic<int64_t> hits{0};
    auto work = [&](int64_t lo, int64_t hi) {
      int64_t local = 0;
      for (int64_t i = lo; i < hi; ++i) {
        int64_t s = Find(keys[i]);
        if (s >= 0) {
          std::memcpy(out + i * width_, vals_.data() + s * width_,
                      sizeof(float) * width_);
          found[i] = 1;
          ++local;
        } else {
          std::memset(out + i * width_, 0, sizeof(float) * width_);
          found[i] = 0;
        }
      }
      hits.fetch_add(local, std::memory_order_relaxed);
    };
    ParallelFor(n, work);
    return hits.load();
  }

  int64_t EraseBatch(int64_t n, const int64_t* keys, uint8_t* found) {
    std::unique_lock<std::shared_mutex> g(mu_);
    int64_t erased = 0;
    for (int64_t i = 0; i < n; ++i) {
      bool ok = EraseOne(keys[i]);
      if (found) found[i] = ok;
      erased += ok;
    }
    return erased;
  }

  // Streamed export: scan slots [start, cap), copy up to max_n live entries.
  // Returns count; *next = slot to resume from (== cap when done).
  int64_t Export(int64_t start, int64_t max_n, int64_t* keys, float* rows,
                 int64_t* next) const {
    std::shared_lock<std::shared_mutex> g(mu_);
    int64_t n = 0, s = start < 0 ? 0 : start;
    for (; s < cap_ && n < max_n; ++s) {
      if (keys_[s] != kEmpty) {
        keys[n] = keys_[s];
        std::memcpy(rows + n * width_, vals_.data() + s * width_,
                    sizeof(float) * width_);
        ++n;
      }
    }
    *next = s;
    return n;
  }

  void Clear() {
    std::unique_lock<std::shared_mutex> g(mu_);
    std::fill(keys_.begin(), keys_.end(), kEmpty);
    size_ = 0;
  }

 private:
  void Alloc(int64_t cap) {
    cap_ = cap;
    mask_ = cap - 1;
    keys_.assign(cap, kEmpty);
    vals_.assign(cap * width_, 0.f);
    size_ = 0;
  }

  void Reserve(int64_t want) {
    if (want < static_cast<int64_t>(cap_ * kMaxLoad)) return;
    int64_t ncap = cap_;
    while (want >= static_cast<int64_t>(ncap * kMaxLoad)) ncap <<= 1;
    std::vector<int64_t> ok(std::move(keys_));
    std::vector<float> ov(std::move(vals_));
    int64_t ocap = cap_;
    Alloc(ncap);
    for (int64_t s = 0; s < ocap; ++s) {
      if (ok[s] != kEmpty) InsertOne(ok[s], ov.data() + s * width_);
    }
  }

  void InsertOne(int64_t key, const float* row) {
    int64_t s = mix64(static_cast<uint64_t>(key)) & mask_;
    while (true) {
      if (keys_[s] == key) break;
      if (keys_[s] == kEmpty) {
        keys_[s] = key;
        ++size_;
        break;
      }
      s = (s + 1) & mask_;
    }
    std::memcpy(vals_.data() + s * width_, row, sizeof(float) * width_);
  }

  int64_t Find(int64_t key) const {
    if (key == kEmpty) return -1;
    int64_t s = mix64(static_cast<uint64_t>(key)) & mask_;
    while (true) {
      if (keys_[s] == key) return s;
      if (keys_[s] == kEmpty) return -1;
      s = (s + 1) & mask_;
    }
  }

  bool EraseOne(int64_t key) {
    int64_t s = Find(key);
    if (s < 0) return false;
    // Backward-shift deletion: close the probe chain instead of tombstoning.
    int64_t hole = s;
    int64_t cur = (s + 1) & mask_;
    while (keys_[cur] != kEmpty) {
      int64_t home = mix64(static_cast<uint64_t>(keys_[cur])) & mask_;
      // cur may move into hole iff hole lies in [home, cur] cyclically.
      bool movable = ((cur - home) & mask_) >= ((cur - hole) & mask_);
      if (movable) {
        keys_[hole] = keys_[cur];
        std::memcpy(vals_.data() + hole * width_, vals_.data() + cur * width_,
                    sizeof(float) * width_);
        hole = cur;
      }
      cur = (cur + 1) & mask_;
    }
    keys_[hole] = kEmpty;
    --size_;
    return true;
  }

  template <typename F>
  static void ParallelFor(int64_t n, F&& f) {
    const int64_t grain = 1 << 14;
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthreads =
        std::min<int64_t>(hw ? hw : 1, (n + grain - 1) / grain);
    if (nthreads <= 1) {
      f(0, n);
      return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int64_t t = 0; t < nthreads; ++t) {
      int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
      if (lo >= hi) break;
      ts.emplace_back([&f, lo, hi] { f(lo, hi); });
    }
    for (auto& t : ts) t.join();
  }

  int width_;
  int64_t cap_ = 0, mask_ = 0, size_ = 0;
  std::vector<int64_t> keys_;
  std::vector<float> vals_;
  mutable std::shared_mutex mu_;
};

}  // namespace

extern "C" {

void* hkv_create(int width, int64_t cap_hint) {
  return new (std::nothrow) HostKV(width, cap_hint);
}

void hkv_destroy(void* h) { delete static_cast<HostKV*>(h); }

void hkv_insert(void* h, int64_t n, const int64_t* keys, const float* rows) {
  static_cast<HostKV*>(h)->InsertBatch(n, keys, rows);
}

int64_t hkv_lookup(void* h, int64_t n, const int64_t* keys, float* out,
                   uint8_t* found) {
  return static_cast<HostKV*>(h)->LookupBatch(n, keys, out, found);
}

int64_t hkv_erase(void* h, int64_t n, const int64_t* keys, uint8_t* found) {
  return static_cast<HostKV*>(h)->EraseBatch(n, keys, found);
}

int64_t hkv_size(void* h) { return static_cast<HostKV*>(h)->size(); }

int64_t hkv_capacity(void* h) { return static_cast<HostKV*>(h)->capacity(); }

int64_t hkv_export(void* h, int64_t start, int64_t max_n, int64_t* keys,
                   float* rows, int64_t* next) {
  return static_cast<HostKV*>(h)->Export(start, max_n, keys, rows, next);
}

void hkv_clear(void* h) { static_cast<HostKV*>(h)->Clear(); }

int hkv_width(void* h) { return static_cast<HostKV*>(h)->width(); }

}  // extern "C"
