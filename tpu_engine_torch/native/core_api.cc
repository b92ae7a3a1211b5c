// Flat C API over the tpucore_torch classes, consumed from Python via
// ctypes (tpu_engine_torch/core/native.py); the same names and contracts as
// tpu_engine/native/core_api.cc. The library is built with
// -fvisibility=hidden: only this extern "C" block is exported. Ownership
// rules: every handle returned by a *_create is released by the matching
// *_destroy; byte buffers returned via malloc-ed pointers are released with
// tpu_free.

#include <clocale>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <locale.h>  // newlocale/uselocale (POSIX.1-2008)

#include "core.h"
#include "http_front.h"

using tpucore_torch::BatchQueue;
using tpucore_torch::Breaker;
using tpucore_torch::HashRing;
using tpucore_torch::HttpFront;
using tpucore_torch::LruCache;
using tpucore_torch::ReplySlot;

#pragma GCC visibility push(default)
extern "C" {

// ----- shared ---------------------------------------------------------------

void tpu_free(void* p) { std::free(p); }

static char* AllocCopy(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() ? s.size() : 1));
  if (out && !s.empty()) std::memcpy(out, s.data(), s.size());
  return out;
}

// ----- fast JSON float encode ------------------------------------------------

// "[a,b,...]" with %.6g — six significant digits, the noise floor of the
// bf16 serving dtype (float32 responses keep ~1e-6 relative error, far
// inside every consumer's tolerance). json.dumps(list) costs ~700 us per
// 1000 floats under the GIL; this runs GIL-free (ctypes releases it) in
// ~tens of us, which matters because the reference's miss path pays float
// serialization per REQUEST (worker_node.cpp:75-82 builds the response
// JSON eagerly). Non-finite values spell NaN/Infinity/-Infinity exactly
// like Python's json.dumps so json.loads round-trips. Caller frees *out
// with tpu_free; returns the byte length.
std::size_t tpu_json_encode_f32(const float* data, std::size_t n,
                                char** out) {
  std::size_t cap = n * 16 + 3;  // "-3.40282e+38," is 13; 16 is safe
  char* buf = static_cast<char*>(std::malloc(cap));
  if (!buf) {
    *out = nullptr;
    return 0;
  }
  // snprintf honors LC_NUMERIC: a host locale with comma decimals would
  // emit "1,5" — which json.loads reads as TWO elements. Pin the C locale
  // for the whole encode (json.dumps, the path this replaces, is
  // locale-free).
  static locale_t c_loc = newlocale(LC_ALL_MASK, "C", nullptr);
  locale_t prior = uselocale(c_loc);
  std::size_t w = 0;
  buf[w++] = '[';
  for (std::size_t i = 0; i < n; ++i) {
    if (i) buf[w++] = ',';
    float v = data[i];
    if (std::isnan(v)) {
      std::memcpy(buf + w, "NaN", 3);
      w += 3;
    } else if (std::isinf(v)) {
      if (v < 0) {
        std::memcpy(buf + w, "-Infinity", 9);
        w += 9;
      } else {
        std::memcpy(buf + w, "Infinity", 8);
        w += 8;
      }
    } else {
      w += std::snprintf(buf + w, 17, "%.6g", static_cast<double>(v));
    }
  }
  buf[w++] = ']';
  uselocale(prior);
  *out = buf;
  return w;
}

// ----- LRU cache ------------------------------------------------------------

void* tpu_lru_create(std::size_t capacity) { return new LruCache(capacity); }
void tpu_lru_destroy(void* h) { delete static_cast<LruCache*>(h); }

// Returns 1 on hit (caller frees *val_out with tpu_free), 0 on miss.
int tpu_lru_get(void* h, const char* key, std::size_t klen, char** val_out,
                std::size_t* vlen_out) {
  std::string value;
  if (!static_cast<LruCache*>(h)->Get(std::string(key, klen), &value)) {
    return 0;
  }
  *val_out = AllocCopy(value);
  *vlen_out = value.size();
  return 1;
}

void tpu_lru_put(void* h, const char* key, std::size_t klen, const char* val,
                 std::size_t vlen) {
  static_cast<LruCache*>(h)->Put(std::string(key, klen),
                                 std::string(val, vlen));
}

void tpu_lru_clear(void* h) { static_cast<LruCache*>(h)->Clear(); }
std::size_t tpu_lru_size(void* h) { return static_cast<LruCache*>(h)->Size(); }
std::size_t tpu_lru_capacity(void* h) {
  return static_cast<LruCache*>(h)->capacity();
}
std::uint64_t tpu_lru_hits(void* h) { return static_cast<LruCache*>(h)->hits(); }
std::uint64_t tpu_lru_misses(void* h) {
  return static_cast<LruCache*>(h)->misses();
}

// ----- consistent-hash ring -------------------------------------------------

void* tpu_ring_create(int virtual_nodes) { return new HashRing(virtual_nodes); }
void tpu_ring_destroy(void* h) { delete static_cast<HashRing*>(h); }
void tpu_ring_add(void* h, const char* node) {
  static_cast<HashRing*>(h)->AddNode(node);
}
void tpu_ring_remove(void* h, const char* node) {
  static_cast<HashRing*>(h)->RemoveNode(node);
}

// Returns 1 and allocates *node_out on success, 0 if the ring is empty.
int tpu_ring_get(void* h, const char* key, char** node_out,
                 std::size_t* nlen_out) {
  std::string node;
  if (!static_cast<HashRing*>(h)->GetNode(key, &node)) return 0;
  *node_out = AllocCopy(node);
  *nlen_out = node.size();
  return 1;
}

// Distinct nodes in ring order, framed as repeated
// <uint32 little-endian length><bytes> records so arbitrary node names
// (including '\n') round-trip exactly. Caller frees with tpu_free.
int tpu_ring_all_nodes(void* h, char** out, std::size_t* len_out) {
  std::string joined;
  for (const auto& n : static_cast<HashRing*>(h)->AllNodes()) {
    std::uint32_t len = static_cast<std::uint32_t>(n.size());
    joined.append(reinterpret_cast<const char*>(&len), sizeof(len));
    joined += n;
  }
  *out = AllocCopy(joined);
  *len_out = joined.size();
  return 1;
}

std::size_t tpu_ring_num_nodes(void* h) {
  return static_cast<HashRing*>(h)->NumNodes();
}

std::uint32_t tpu_fnv1a(const char* key, std::size_t klen) {
  return HashRing::Fnv1a(std::string(key, klen));
}

// ----- circuit breaker ------------------------------------------------------

void* tpu_breaker_create(int failure_threshold, int success_threshold,
                         double timeout_s) {
  return new Breaker(failure_threshold, success_threshold, timeout_s);
}
void tpu_breaker_destroy(void* h) { delete static_cast<Breaker*>(h); }
int tpu_breaker_allow(void* h) {
  return static_cast<Breaker*>(h)->AllowRequest() ? 1 : 0;
}
void tpu_breaker_success(void* h) { static_cast<Breaker*>(h)->RecordSuccess(); }
void tpu_breaker_failure(void* h) { static_cast<Breaker*>(h)->RecordFailure(); }
int tpu_breaker_state(void* h) { return static_cast<Breaker*>(h)->state(); }
int tpu_breaker_failures(void* h) {
  return static_cast<Breaker*>(h)->failure_count();
}
int tpu_breaker_successes(void* h) {
  return static_cast<Breaker*>(h)->success_count();
}

// ----- batch queue ----------------------------------------------------------

void* tpu_bq_create(std::size_t max_batch, double timeout_s) {
  return new BatchQueue(max_batch, timeout_s);
}
void tpu_bq_destroy(void* h) { delete static_cast<BatchQueue*>(h); }

long long tpu_bq_push(void* h, const char* data, std::size_t len) {
  return static_cast<BatchQueue*>(h)->Push(std::string(data, len));
}

// Pops up to min(max, queue max_batch) items. Fills parallel arrays of
// malloc'd payload pointers (caller frees each with tpu_free), lengths and
// tickets. Returns the item count (0 = timeout with empty queue), or -1
// when closed+drained.
int tpu_bq_pop_batch(void* h, char** bufs, std::size_t* lens,
                     long long* tickets, int max, int* timed_out) {
  std::vector<BatchQueue::Item> items;
  bool to = false;
  if (max <= 0) {
    *timed_out = 0;
    return 0;
  }
  if (!static_cast<BatchQueue*>(h)->PopBatch(
          &items, &to, static_cast<std::size_t>(max))) {
    *timed_out = to ? 1 : 0;
    return -1;
  }
  *timed_out = to ? 1 : 0;
  int n = 0;
  for (auto& item : items) {
    bufs[n] = AllocCopy(item.payload);
    lens[n] = item.payload.size();
    tickets[n] = item.ticket;
    ++n;
  }
  return n;
}

void tpu_bq_close(void* h) { static_cast<BatchQueue*>(h)->Close(); }
std::size_t tpu_bq_size(void* h) { return static_cast<BatchQueue*>(h)->Size(); }

// ----- native HTTP front ----------------------------------------------------

void* tpu_front_create(int port, int virtual_nodes, int fake_cached_us) {
  return new HttpFront(port, virtual_nodes, fake_cached_us);
}
void tpu_front_destroy(void* h) { delete static_cast<HttpFront*>(h); }

// lru_handle must be a tpu_lru_create handle; breaker_handle a
// tpu_breaker_create handle or NULL. The front borrows both (the Python
// WorkerNode/Gateway keep ownership and share the same objects).
void tpu_front_add_lane(void* h, const char* name, void* lru_handle,
                        void* breaker_handle) {
  static_cast<HttpFront*>(h)->AddLane(name,
                                      static_cast<LruCache*>(lru_handle),
                                      static_cast<Breaker*>(breaker_handle));
}
void tpu_front_set_lane_enabled(void* h, const char* name, int enabled) {
  static_cast<HttpFront*>(h)->SetLaneEnabled(name, enabled != 0);
}
void tpu_front_set_handler(void* h, tpucore_torch::PyHandler handler) {
  static_cast<HttpFront*>(h)->SetHandler(handler);
}
int tpu_front_start(void* h) { return static_cast<HttpFront*>(h)->Start(); }
void tpu_front_stop(void* h) { static_cast<HttpFront*>(h)->Stop(); }
std::uint64_t tpu_front_lane_total(void* h, const char* name) {
  return static_cast<HttpFront*>(h)->LaneTotal(name);
}
std::uint64_t tpu_front_lane_hits(void* h, const char* name) {
  return static_cast<HttpFront*>(h)->LaneHits(name);
}

// Called by the Python fallback handler (inside the handler callback) to
// deliver its response; the front copies the bytes before returning.
void tpu_front_reply(void* reply_ctx, int status, const char* data,
                     std::size_t len) {
  auto* slot = static_cast<ReplySlot*>(reply_ctx);
  slot->status = status;
  slot->body.assign(data, len);
}

// Variant carrying an explicit Content-Type (e.g. /metrics' Prometheus
// text exposition).
void tpu_front_reply2(void* reply_ctx, int status, const char* data,
                      std::size_t len, const char* content_type) {
  auto* slot = static_cast<ReplySlot*>(reply_ctx);
  slot->status = status;
  slot->body.assign(data, len);
  if (content_type != nullptr && content_type[0] != '\0') {
    slot->content_type = content_type;
  }
}

}  // extern "C"
#pragma GCC visibility pop
