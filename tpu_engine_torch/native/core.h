// Native runtime core of tpu_engine_torch (libtpucore_torch.so) — C++17.
//
// The port's own copy of tpu_engine/native/core.h, in a namespace of its
// own (tpucore_torch) so both libraries can live in one process: the LRU
// result cache (reference include/lru_cache.h), the FNV-1a consistent-hash
// ring (src/consistent_hash.cpp), the circuit breaker
// (src/circuit_breaker.cpp) and the dynamic batch queue
// (include/batch_processor.h). Keys and values are opaque byte blobs, the
// ring has elastic add/remove, and the batch queue is an MPMC structure
// whose timed batch-pop is called with the GIL released. No CUDA.
//
// Exposed to Python through the flat C API in core_api.cc (ctypes:
// tpu_engine_torch/core/native.py).

#ifndef TPU_ENGINE_TORCH_NATIVE_CORE_H_
#define TPU_ENGINE_TORCH_NATIVE_CORE_H_

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <list>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

namespace tpucore_torch {

// ---------------------------------------------------------------------------
// LruCache: mutex-guarded LRU over byte-blob keys and values.
// ---------------------------------------------------------------------------
class LruCache {
 public:
  explicit LruCache(std::size_t capacity) : capacity_(capacity) {}

  // Returns true and copies the value on hit; promotes the entry to MRU.
  // count_miss=false is for probe callers (the native HTTP front) whose
  // misses fall through to a second, counted Get on the Python path —
  // counting both would double every miss in the hit-rate stats.
  bool Get(const std::string& key, std::string* value_out,
           bool count_miss = true) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = index_.find(key);
    if (it == index_.end()) {
      if (count_miss) ++misses_;
      return false;
    }
    order_.splice(order_.begin(), order_, it->second);
    ++hits_;
    *value_out = it->second->second;
    return true;
  }

  void Put(const std::string& key, std::string value) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = index_.find(key);
    if (it != index_.end()) {
      it->second->second = std::move(value);
      order_.splice(order_.begin(), order_, it->second);
      return;
    }
    if (order_.size() >= capacity_ && !order_.empty()) {
      index_.erase(order_.back().first);
      order_.pop_back();
    }
    order_.emplace_front(key, std::move(value));
    index_[key] = order_.begin();
  }

  void Clear() {
    std::lock_guard<std::mutex> lk(mu_);
    order_.clear();
    index_.clear();
    hits_ = 0;
    misses_ = 0;
  }

  std::size_t Size() const {
    std::lock_guard<std::mutex> lk(mu_);
    return order_.size();
  }
  std::size_t capacity() const { return capacity_; }
  std::uint64_t hits() const {
    std::lock_guard<std::mutex> lk(mu_);
    return hits_;
  }
  std::uint64_t misses() const {
    std::lock_guard<std::mutex> lk(mu_);
    return misses_;
  }

 private:
  const std::size_t capacity_;
  mutable std::mutex mu_;
  // MRU at front. list<pair<key, value>> with an index into it.
  std::list<std::pair<std::string, std::string>> order_;
  std::unordered_map<std::string,
                     std::list<std::pair<std::string, std::string>>::iterator>
      index_;
  std::uint64_t hits_ = 0;
  std::uint64_t misses_ = 0;
};

// ---------------------------------------------------------------------------
// HashRing: FNV-1a/32 consistent hash with virtual nodes.
// Constants match the reference (src/consistent_hash.cpp:6-14) so request →
// lane assignment is bit-identical across the Python and native paths.
// ---------------------------------------------------------------------------
class HashRing {
 public:
  explicit HashRing(int virtual_nodes) : virtual_nodes_(virtual_nodes) {}

  static std::uint32_t Fnv1a(const std::string& key) {
    std::uint32_t h = 2166136261u;
    for (unsigned char c : key) {
      h ^= c;
      h *= 16777619u;
    }
    return h;
  }

  void AddNode(const std::string& node) {
    std::lock_guard<std::mutex> lk(mu_);
    for (int i = 0; i < virtual_nodes_; ++i) {
      ring_[Fnv1a(node + "#" + std::to_string(i))] = node;
    }
  }

  void RemoveNode(const std::string& node) {
    std::lock_guard<std::mutex> lk(mu_);
    for (int i = 0; i < virtual_nodes_; ++i) {
      auto it = ring_.find(Fnv1a(node + "#" + std::to_string(i)));
      if (it != ring_.end() && it->second == node) ring_.erase(it);
    }
  }

  // First vnode clockwise of hash(key), wrapping. Empty ring -> false.
  bool GetNode(const std::string& key, std::string* node_out) const {
    std::lock_guard<std::mutex> lk(mu_);
    if (ring_.empty()) return false;
    auto it = ring_.lower_bound(Fnv1a(key));
    if (it == ring_.end()) it = ring_.begin();
    *node_out = it->second;
    return true;
  }

  // Distinct nodes in ring order (failover order).
  std::vector<std::string> AllNodes() const {
    std::lock_guard<std::mutex> lk(mu_);
    std::vector<std::string> out;
    std::unordered_set<std::string> seen;
    for (const auto& kv : ring_) {
      if (seen.insert(kv.second).second) out.push_back(kv.second);
    }
    return out;
  }

  std::size_t NumNodes() const {
    std::lock_guard<std::mutex> lk(mu_);
    std::unordered_set<std::string> seen;
    for (const auto& kv : ring_) seen.insert(kv.second);
    return seen.size();
  }

 private:
  const int virtual_nodes_;
  mutable std::mutex mu_;
  std::map<std::uint32_t, std::string> ring_;
};

// ---------------------------------------------------------------------------
// Breaker: CLOSED -> OPEN -> HALF_OPEN machine, consecutive-failure
// semantics identical to the reference (src/circuit_breaker.cpp:12-47).
// ---------------------------------------------------------------------------
class Breaker {
 public:
  enum State : int { kClosed = 0, kOpen = 1, kHalfOpen = 2 };

  Breaker(int failure_threshold, int success_threshold, double timeout_s)
      : failure_threshold_(failure_threshold),
        success_threshold_(success_threshold),
        timeout_(timeout_s),
        last_failure_(Clock::now()) {}

  bool AllowRequest() {
    std::lock_guard<std::mutex> lk(mu_);
    if (state_ == kOpen) {
      if (std::chrono::duration<double>(Clock::now() - last_failure_).count() >=
          timeout_) {
        state_ = kHalfOpen;
        success_count_ = 0;
        return true;
      }
      return false;
    }
    return true;
  }

  void RecordSuccess() {
    std::lock_guard<std::mutex> lk(mu_);
    if (state_ == kHalfOpen) {
      if (++success_count_ >= success_threshold_) {
        state_ = kClosed;
        failure_count_ = 0;
      }
    } else {
      failure_count_ = 0;  // threshold counts *consecutive* failures
    }
  }

  void RecordFailure() {
    std::lock_guard<std::mutex> lk(mu_);
    ++failure_count_;
    last_failure_ = Clock::now();
    if (failure_count_ >= failure_threshold_ || state_ == kHalfOpen) {
      state_ = kOpen;
    }
  }

  int state() const {
    std::lock_guard<std::mutex> lk(mu_);
    return state_;
  }
  int failure_count() const {
    std::lock_guard<std::mutex> lk(mu_);
    return failure_count_;
  }
  int success_count() const {
    std::lock_guard<std::mutex> lk(mu_);
    return success_count_;
  }

 private:
  using Clock = std::chrono::steady_clock;
  const int failure_threshold_;
  const int success_threshold_;
  const double timeout_;
  mutable std::mutex mu_;
  State state_ = kClosed;
  int failure_count_ = 0;
  int success_count_ = 0;
  Clock::time_point last_failure_;
};

// ---------------------------------------------------------------------------
// BatchQueue: MPMC queue with a size-or-timeout timed batch pop.
//
// This is the native half of the dynamic batcher: producers (request
// handler threads) push byte-blob payloads and receive tickets; the
// dispatch loop calls PopBatch, which blocks until the queue is non-empty
// (reference wake semantics, batch_processor.h:105-129) or the timeout
// fires, then drains up to max_batch items. Response delivery (futures) is
// the caller's concern — this structure stays language-neutral.
// ---------------------------------------------------------------------------
class BatchQueue {
 public:
  struct Item {
    std::int64_t ticket;
    std::string payload;
  };

  BatchQueue(std::size_t max_batch, double timeout_s)
      : max_batch_(max_batch), timeout_(timeout_s) {}

  // Returns the ticket, or -1 if the queue is closed.
  std::int64_t Push(std::string payload) {
    std::int64_t ticket;
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (closed_) return -1;
      ticket = next_ticket_++;
      queue_.push_back(Item{ticket, std::move(payload)});
    }
    cv_.notify_one();
    return ticket;
  }

  // Blocks until items are available or timeout. Fills `out` with up to
  // min(max_batch_, caller_max) items (caller_max=0 means max_batch_). Sets
  // *timed_out when the wait expired (the batch classification signal).
  // Returns false when closed and drained.
  bool PopBatch(std::vector<Item>* out, bool* timed_out,
                std::size_t caller_max = 0) {
    const std::size_t limit =
        caller_max ? std::min(caller_max, max_batch_) : max_batch_;
    std::unique_lock<std::mutex> lk(mu_);
    *timed_out = !cv_.wait_for(
        lk, std::chrono::duration<double>(timeout_),
        [this] { return !queue_.empty() || closed_; });
    if (queue_.empty() && closed_) return false;
    out->clear();
    while (!queue_.empty() && out->size() < limit) {
      out->push_back(std::move(queue_.front()));
      queue_.pop_front();
    }
    return true;
  }

  void Close() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      closed_ = true;
    }
    cv_.notify_all();
  }

  std::size_t Size() const {
    std::lock_guard<std::mutex> lk(mu_);
    return queue_.size();
  }

 private:
  const std::size_t max_batch_;
  const double timeout_;
  mutable std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Item> queue_;
  std::int64_t next_ticket_ = 0;
  bool closed_ = false;
};

}  // namespace tpucore_torch

#endif  // TPU_ENGINE_TORCH_NATIVE_CORE_H_
