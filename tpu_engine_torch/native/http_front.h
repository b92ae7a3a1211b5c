// Native HTTP front door of tpu_engine_torch — C++17, no dependencies.
//
// The port's own copy of tpu_engine/native/http_front.h: a
// thread-per-connection HTTP/1.1 keep-alive server that answers /infer
// CACHE HITS entirely in C++ — FNV-1a ring lookup, LRU fetch of the
// pre-encoded output fragment, response splice — without touching the
// Python interpreter (no GIL). Misses, shaped requests, and every other
// route call back into Python (ctypes callback; ctypes acquires the GIL
// per call).
//
// Protocol subset: HTTP/1.1, Content-Length bodies only (no chunked),
// case-insensitive header match for Content-Length/Connection.

#ifndef TPU_ENGINE_TORCH_NATIVE_HTTP_FRONT_H_
#define TPU_ENGINE_TORCH_NATIVE_HTTP_FRONT_H_

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "core.h"

namespace tpucore_torch {

// Filled by the Python fallback handler through tpu_front_reply(ctx, ...)
// or tpu_front_reply2(ctx, ..., content_type) — the latter carries a
// non-JSON content type (e.g. /metrics' Prometheus text exposition, which
// Prometheus 3.x refuses to scrape under application/json).
struct ReplySlot {
  int status = 500;
  std::string body = "{\"error\": \"python handler did not reply\"}";
  std::string content_type = "application/json";
};

// void handler(void* reply_ctx, method, path, body, body_len)
using PyHandler = void (*)(void*, const char*, const char*, const char*,
                           std::size_t);

class HttpFront {
 public:
  struct Lane {
    std::string name;
    LruCache* cache;                    // not owned (Python side owns)
    Breaker* breaker;                   // not owned; shared with the gateway
    std::atomic<bool> enabled{true};
    std::atomic<std::uint64_t> total{0};
    std::atomic<std::uint64_t> hits{0};
    Lane(std::string n, LruCache* c, Breaker* b)
        : name(std::move(n)), cache(c), breaker(b) {}
  };

  HttpFront(int port, int virtual_nodes, int fake_cached_latency_us)
      : ring_(virtual_nodes), fake_us_(fake_cached_latency_us), port_(port) {}

  ~HttpFront() { Stop(); }

  void AddLane(const std::string& name, LruCache* cache, Breaker* breaker) {
    std::lock_guard<std::mutex> lk(mu_);
    lanes_.push_back(std::make_unique<Lane>(name, cache, breaker));
    index_[name] = lanes_.back().get();
    ring_.AddNode(name);
  }

  // Takes the lane out of the ring and the index: no hit is answered or
  // counted for it afterwards. Its Lane stays allocated (a hit that found
  // it just before reads a live object, and sees it disabled), as do the
  // cache and breaker it borrows, which the Python side keeps.
  void RemoveLane(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = index_.find(name);
    if (it == index_.end()) return;
    it->second->enabled.store(false);
    index_.erase(it);
    ring_.RemoveNode(name);
  }

  // The ring's lanes in failover order.
  std::vector<std::string> RingNodes() const { return ring_.AllNodes(); }

  void SetLaneEnabled(const std::string& name, bool enabled) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = index_.find(name);
    if (it != index_.end()) it->second->enabled.store(enabled);
  }

  void SetHandler(PyHandler h) { handler_ = h; }

  // Binds + starts the accept loop. Returns the bound port, or -1.
  int Start() {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return -1;
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<std::uint16_t>(port_));
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
        0) {
      ::close(listen_fd_);
      listen_fd_ = -1;
      return -1;
    }
    if (port_ == 0) {
      socklen_t alen = sizeof(addr);
      ::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &alen);
      port_ = ntohs(addr.sin_port);
    }
    ::listen(listen_fd_, 1024);
    running_.store(true);
    accept_thread_ = std::thread([this] { AcceptLoop(); });
    return port_;
  }

  void Stop() {
    bool was = running_.exchange(false);
    if (!was) return;
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
    if (accept_thread_.joinable()) accept_thread_.join();
    // Half-close live keep-alive connections so handler threads see EOF.
    {
      std::lock_guard<std::mutex> lk(conn_mu_);
      for (int fd : conn_fds_) ::shutdown(fd, SHUT_RDWR);
    }
    std::unordered_map<std::uint64_t, std::thread> rest;
    {
      std::lock_guard<std::mutex> lk(threads_mu_);
      rest.swap(conn_threads_);
    }
    for (auto& kv : rest) {
      if (kv.second.joinable()) kv.second.join();
    }
  }

  int port() const { return port_; }
  std::uint64_t LaneTotal(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = index_.find(name);
    return it == index_.end() ? 0 : it->second->total.load();
  }
  std::uint64_t LaneHits(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = index_.find(name);
    return it == index_.end() ? 0 : it->second->hits.load();
  }

 private:
  void AcceptLoop() {
    while (running_.load()) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        if (!running_.load()) break;
        continue;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      ReapFinished();
      {
        std::lock_guard<std::mutex> lk(conn_mu_);
        conn_fds_.insert(fd);
      }
      std::uint64_t tid = next_thread_id_.fetch_add(1);
      std::thread t([this, fd, tid] {
        Serve(fd);
        // Self-registration on the done list is the ONLY cross-thread
        // signal; the accept loop joins exclusively ids found here, so it
        // never blocks on a thread still serving a live connection, and it
        // holds neither conn_mu_ nor threads_mu_ while joining.
        std::lock_guard<std::mutex> lk(done_mu_);
        done_ids_.push_back(tid);
      });
      {
        std::lock_guard<std::mutex> lk(threads_mu_);
        conn_threads_.emplace(tid, std::move(t));
      }
    }
  }

  // Joins only threads whose Serve() already returned. Join happens outside
  // every mutex: a joined thread's final act is the done-list append, so the
  // join can only wait on that last statement, never on live I/O.
  void ReapFinished() {
    std::vector<std::uint64_t> done;
    {
      std::lock_guard<std::mutex> lk(done_mu_);
      done.swap(done_ids_);
    }
    for (std::uint64_t tid : done) {
      std::thread t;
      {
        std::lock_guard<std::mutex> lk(threads_mu_);
        auto it = conn_threads_.find(tid);
        if (it == conn_threads_.end()) {
          // Finished before the accept loop emplaced it; retry next reap.
          std::lock_guard<std::mutex> dlk(done_mu_);
          done_ids_.push_back(tid);
          continue;
        }
        t = std::move(it->second);
        conn_threads_.erase(it);
      }
      if (t.joinable()) t.join();
    }
  }

  // Caps: a single header line (and the buffered remainder while looking for
  // one) may not exceed kMaxHeaderBytes (431), and a declared body may not
  // exceed kMaxBodyBytes (413); either way the connection is closed — without
  // this, one never-terminated or huge request exhausts server memory.
  static constexpr std::size_t kMaxHeaderBytes = 64 * 1024;
  static constexpr std::size_t kMaxBodyBytes = 64ull * 1024 * 1024;

  static bool ReadLine(int fd, std::string* buf, std::string* line) {
    // Reads from fd into *buf until a "\r\n" is available; pops it.
    for (;;) {
      auto pos = buf->find("\r\n");
      if (pos != std::string::npos) {
        *line = buf->substr(0, pos);
        buf->erase(0, pos + 2);
        return true;
      }
      if (buf->size() > kMaxHeaderBytes) return false;
      char tmp[4096];
      ssize_t n = ::recv(fd, tmp, sizeof(tmp), 0);
      if (n <= 0) return false;
      buf->append(tmp, static_cast<std::size_t>(n));
    }
  }

  static bool ReadN(int fd, std::string* buf, std::size_t n,
                    std::string* out) {
    while (buf->size() < n) {
      char tmp[8192];
      ssize_t r = ::recv(fd, tmp, sizeof(tmp), 0);
      if (r <= 0) return false;
      buf->append(tmp, static_cast<std::size_t>(r));
    }
    *out = buf->substr(0, n);
    buf->erase(0, n);
    return true;
  }

  static bool SendAll(int fd, const char* data, std::size_t len) {
    std::size_t off = 0;
    while (off < len) {
      ssize_t n = ::send(fd, data + off, len - off, MSG_NOSIGNAL);
      if (n <= 0) return false;
      off += static_cast<std::size_t>(n);
    }
    return true;
  }

  // Sends 431 before closing when a ReadLine failure was a header-size
  // overflow (vs a plain EOF/reset, where the peer is already gone).
  void MaybeReject431(int fd, const std::string& buf) {
    if (buf.size() > kMaxHeaderBytes) {
      std::string resp;
      WrapHttp(431, "{\"error\": \"request header too large\"}", &resp);
      SendAll(fd, resp.data(), resp.size());
    }
  }

  void Serve(int fd) {
    std::string buf;
    while (running_.load()) {
      std::string req_line;
      if (!ReadLine(fd, &buf, &req_line)) {
        MaybeReject431(fd, buf);
        break;
      }
      if (req_line.empty()) continue;
      auto sp1 = req_line.find(' ');
      auto sp2 = req_line.find(' ', sp1 + 1);
      if (sp1 == std::string::npos || sp2 == std::string::npos) break;
      std::string method = req_line.substr(0, sp1);
      std::string path = req_line.substr(sp1 + 1, sp2 - sp1 - 1);
      auto q = path.find('?');
      if (q != std::string::npos) path.erase(q);

      std::size_t content_length = 0;
      bool close_conn = false;
      std::string header;
      for (;;) {
        if (!ReadLine(fd, &buf, &header)) {
          MaybeReject431(fd, buf);
          return CloseFd(fd);
        }
        if (header.empty()) break;
        std::string lower;
        lower.reserve(header.size());
        for (char c : header) lower += static_cast<char>(std::tolower(c));
        if (lower.rfind("content-length:", 0) == 0) {
          content_length = std::strtoull(header.c_str() + 15, nullptr, 10);
        } else if (lower.rfind("connection:", 0) == 0 &&
                   lower.find("close") != std::string::npos) {
          close_conn = true;
        }
      }
      if (content_length > kMaxBodyBytes) {
        std::string resp;
        WrapHttp(413, "{\"error\": \"request body too large\"}", &resp);
        SendAll(fd, resp.data(), resp.size());
        return CloseFd(fd);
      }
      std::string body;
      if (content_length &&
          !ReadN(fd, &buf, content_length, &body)) {
        return CloseFd(fd);
      }

      std::string resp;
      if (method == "POST" && path == "/infer") {
        if (!TryInferHit(body, &resp)) PyFallback(method, path, body, &resp);
      } else {
        PyFallback(method, path, body, &resp);
      }
      if (!SendAll(fd, resp.data(), resp.size())) break;
      if (close_conn) break;
    }
    CloseFd(fd);
  }

  void CloseFd(int fd) {
    {
      std::lock_guard<std::mutex> lk(conn_mu_);
      conn_fds_.erase(fd);
    }
    ::close(fd);
  }

  // ---- /infer fast path -----------------------------------------------------

  // Extracts the JSON string value after `"key":`. Returns false on any
  // complexity (escapes, absence) — caller punts to Python.
  static bool JsonString(const std::string& body, const char* key,
                         std::string* out) {
    std::string pat = std::string("\"") + key + "\"";
    auto kpos = body.find(pat);
    if (kpos == std::string::npos) return false;
    auto colon = body.find(':', kpos + pat.size());
    if (colon == std::string::npos) return false;
    auto start = body.find('"', colon + 1);
    if (start == std::string::npos) return false;
    auto end = start + 1;
    while (end < body.size() && body[end] != '"') {
      if (body[end] == '\\') return false;  // escapes → Python
      ++end;
    }
    if (end >= body.size()) return false;
    *out = body.substr(start + 1, end - start - 1);
    return true;
  }

  // Parses the flat float array after `"input_data":` into f32 bytes,
  // bit-identical to the worker's key: numpy float32 of json.loads' values,
  // each a double (an int converted as float() converts it) rounded once to
  // float — strtod, then the cast. An integer literal is a Python int,
  // which has no negative zero: "-0" keys as +0.0.
  static bool ParseInputKey(const std::string& body, std::string* key_out) {
    auto kpos = body.find("\"input_data\"");
    if (kpos == std::string::npos) return false;
    auto open = body.find('[', kpos);
    if (open == std::string::npos) return false;
    std::size_t i = open + 1;
    std::string key;
    key.reserve(64);
    for (;;) {
      while (i < body.size() &&
             (body[i] == ' ' || body[i] == ',' || body[i] == '\n' ||
              body[i] == '\t' || body[i] == '\r')) {
        ++i;
      }
      if (i >= body.size()) return false;
      if (body[i] == ']') break;
      if (body[i] == '[') return false;  // nested → Python
      const char* begin = body.c_str() + i;
      char* endp = nullptr;
      double d = std::strtod(begin, &endp);
      if (endp == begin) return false;
      if (d == 0.0 && IsIntegerLiteral(begin, endp)) d = 0.0;
      float f = static_cast<float>(d);
      key.append(reinterpret_cast<const char*>(&f), sizeof(f));
      i = static_cast<std::size_t>(endp - body.c_str());
    }
    *key_out = std::move(key);
    return true;
  }

  // "-?digits" only: json.loads makes such a token an int.
  static bool IsIntegerLiteral(const char* begin, const char* end) {
    const char* p = begin;
    if (p < end && *p == '-') ++p;
    if (p == end) return false;
    for (; p < end; ++p) {
      if (*p < '0' || *p > '9') return false;
    }
    return true;
  }

  bool TryInferHit(const std::string& body, std::string* resp) {
    if (body.find("\"shape\"") != std::string::npos) return false;
    std::string rid;
    if (!JsonString(body, "request_id", &rid)) return false;
    std::string key;
    if (!ParseInputKey(body, &key)) return false;

    std::string node;
    if (!ring_.GetNode(rid, &node)) return false;
    Lane* lane = nullptr;
    {
      std::lock_guard<std::mutex> lk(mu_);
      auto it = index_.find(node);
      if (it == index_.end()) return false;
      lane = it->second;
    }
    if (!lane->enabled.load()) return false;
    // Shared-breaker gate: an OPEN lane must not serve even cached answers
    // from C++ (reference semantics: the gateway controls the probe), and
    // the hit below is a genuine success the breaker must observe — this is
    // how a healed lane's HALF_OPEN probes re-close through the hot path.
    if (lane->breaker != nullptr && !lane->breaker->AllowRequest()) {
      return false;  // Python gateway applies its own gate + failover.
    }
    std::string frag;
    if (!lane->cache->Get(key, &frag, /*count_miss=*/false)) {
      return false;  // Python path re-Gets and counts the miss there.
    }
    if (lane->breaker != nullptr) lane->breaker->RecordSuccess();
    lane->total.fetch_add(1);
    lane->hits.fetch_add(1);

    std::string payload;
    payload.reserve(frag.size() + rid.size() + 96);
    payload += "{\"request_id\": \"";
    payload += rid;
    payload += "\", \"output_data\": ";
    payload += frag;
    payload += ", \"node_id\": \"";
    payload += node;
    payload += "\", \"cached\": true, \"inference_time_us\": ";
    payload += std::to_string(fake_us_);
    payload += "}";
    WrapHttp(200, payload, resp);
    return true;
  }

  void PyFallback(const std::string& method, const std::string& path,
                  const std::string& body, std::string* resp) {
    ReplySlot slot;
    if (handler_ != nullptr) {
      handler_(&slot, method.c_str(), path.c_str(), body.data(), body.size());
    }
    WrapHttp(slot.status, slot.body, resp, slot.content_type.c_str());
  }

  static void WrapHttp(int status, const std::string& payload,
                       std::string* resp,
                       const char* content_type = "application/json") {
    const char* reason = status == 200 ? "OK"
                         : status == 400 ? "Bad Request"
                         : status == 404 ? "Not Found"
                         : status == 413 ? "Payload Too Large"
                         : status == 431 ? "Request Header Fields Too Large"
                                         : "Internal Server Error";
    resp->clear();
    resp->reserve(payload.size() + 160);
    *resp += "HTTP/1.1 ";
    *resp += std::to_string(status);
    *resp += " ";
    *resp += reason;
    *resp += "\r\nContent-Type: ";
    *resp += content_type;
    *resp += "\r\nContent-Length: ";
    *resp += std::to_string(payload.size());
    *resp += "\r\n\r\n";
    *resp += payload;
  }

  HashRing ring_;
  const int fake_us_;
  int port_;
  int listen_fd_ = -1;
  std::atomic<bool> running_{false};
  PyHandler handler_ = nullptr;
  std::thread accept_thread_;
  std::mutex mu_;
  std::vector<std::unique_ptr<Lane>> lanes_;
  std::unordered_map<std::string, Lane*> index_;
  std::mutex conn_mu_;
  std::unordered_set<int> conn_fds_;
  std::mutex threads_mu_;
  std::unordered_map<std::uint64_t, std::thread> conn_threads_;
  std::mutex done_mu_;
  std::vector<std::uint64_t> done_ids_;
  std::atomic<std::uint64_t> next_thread_id_{0};
};

}  // namespace tpucore_torch

#endif  // TPU_ENGINE_TORCH_NATIVE_HTTP_FRONT_H_
