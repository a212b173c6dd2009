// Native parameter server: sharded sparse/dense tables behind a TCP
// protocol, with server-side optimizer application, checkpoint save/load,
// table shrink, worker barrier and heartbeat tracking.
//
// TPU-native replacement for the reference's PS runtime (reference:
// paddle/fluid/operators/distributed/ — RPCServer + request handlers;
// brpc/grpc transports; fleet_wrapper.h pull/push sparse/dense; heartbeat
// monitor heart_beat_monitor.h:54). gRPC/BRPC are replaced by a dependency-
// free length-prefixed TCP protocol (this image has no grpc dev libs); the
// table/optimizer model follows pslib: embeddings live host-side on servers,
// updates are applied where the rows live, and the TPU only ever sees dense
// pulled rows (XLA hates scatter-heavy workloads — SURVEY §7 hard parts).
//
// Protocol (little-endian):
//   request:  u32 body_len | u8 cmd | u32 table_id | payload
//   response: u32 body_len | u8 status | payload
// Commands: 1=CREATE_TABLE 2=PULL_SPARSE 3=PUSH_SPARSE 4=PULL_DENSE
//           5=PUSH_DENSE 6=SAVE 7=LOAD 8=SHRINK 9=BARRIER 10=HEARTBEAT
//           11=STOP 12=STATS
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread -o libps.so ps.cc

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <random>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

enum Cmd : uint8_t {
  kCreateTable = 1,
  kPullSparse = 2,
  kPushSparse = 3,
  kPullDense = 4,
  kPushDense = 5,
  kSave = 6,
  kLoad = 7,
  kShrink = 8,
  kBarrier = 9,
  kHeartbeat = 10,
  kStop = 11,
  kStats = 12,
};

enum OptType : uint8_t { kSGD = 0, kAdagrad = 1 };

struct SparseRow {
  std::vector<float> w;
  std::vector<float> g2;  // adagrad accumulator
  uint64_t version = 0;   // bumped on each update; used by shrink
};

struct Table {
  uint8_t is_dense = 0;
  uint32_t dim = 0;
  float init_range = 0.01f;
  uint8_t opt = kSGD;
  // sparse
  std::unordered_map<uint64_t, SparseRow> rows;
  // dense
  std::vector<float> dense;
  std::vector<float> dense_g2;
  uint64_t version = 0;
  std::shared_mutex mu;
};

struct Server {
  ~Server() = default;
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stopping{false};
  std::vector<std::thread> threads;
  std::thread accept_thread;
  // shared_ptr: a re-created table must not be freed under a concurrent
  // handler still using the old instance
  std::unordered_map<uint32_t, std::shared_ptr<Table>> tables;
  std::shared_mutex tables_mu;
  // open connection fds, so stop() can shutdown() blocked recv()s
  std::mutex conns_mu;
  std::vector<int> conn_fds;
  // barrier
  std::mutex barrier_mu;
  std::condition_variable barrier_cv;
  uint32_t barrier_count = 0;
  uint64_t barrier_generation = 0;
  // heartbeat: worker id -> last seen (steady seconds)
  std::mutex hb_mu;
  std::unordered_map<uint32_t, double> last_seen;
};

double now_sec() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= r;
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= r;
  }
  return true;
}

bool send_response(int fd, uint8_t status, const std::string& payload) {
  uint32_t len = static_cast<uint32_t>(1 + payload.size());
  std::string out;
  out.resize(4 + 1 + payload.size());
  memcpy(&out[0], &len, 4);
  out[4] = static_cast<char>(status);
  memcpy(&out[5], payload.data(), payload.size());
  return write_full(fd, out.data(), out.size());
}

template <typename T>
T read_pod(const char*& p) {
  T v;
  memcpy(&v, p, sizeof(T));
  p += sizeof(T);
  return v;
}

template <typename T>
void append_pod(std::string* s, T v) {
  s->append(reinterpret_cast<const char*>(&v), sizeof(T));
}

void init_row(SparseRow* row, const Table& t, uint64_t id) {
  // deterministic per-id init: workers pulling the same id on different
  // servers/restarts see the same fresh vector
  std::mt19937 gen(static_cast<uint32_t>(id * 2654435761u ^ 0x9e3779b9u));
  std::uniform_real_distribution<float> dist(-t.init_range, t.init_range);
  row->w.resize(t.dim);
  for (auto& v : row->w) v = dist(gen);
  if (t.opt == kAdagrad) row->g2.assign(t.dim, 0.f);
}

void apply_update(std::vector<float>* w, std::vector<float>* g2,
                  const float* grad, uint32_t dim, float lr, uint8_t opt) {
  if (opt == kAdagrad) {
    for (uint32_t i = 0; i < dim; ++i) {
      (*g2)[i] += grad[i] * grad[i];
      (*w)[i] -= lr * grad[i] / (std::sqrt((*g2)[i]) + 1e-6f);
    }
  } else {
    for (uint32_t i = 0; i < dim; ++i) (*w)[i] -= lr * grad[i];
  }
}

void handle_conn(Server* srv, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  {
    std::lock_guard<std::mutex> lk(srv->conns_mu);
    srv->conn_fds.push_back(fd);
  }
  std::string body;
  while (!srv->stopping.load()) {
    uint32_t len;
    if (!read_full(fd, &len, 4)) break;
    if (len < 5 || len > (1u << 30)) break;
    body.resize(len);
    if (!read_full(fd, &body[0], len)) break;
    const char* p = body.data();
    uint8_t cmd = read_pod<uint8_t>(p);
    uint32_t table_id = read_pod<uint32_t>(p);

    // validate the per-command fixed header BEFORE any read_pod touches it:
    // a frame long enough for cmd+table_id but shorter than the command's
    // fields would otherwise advance p past the body and make later
    // (end - p) remaining-size math underflow to a huge unsigned value
    {
      uint64_t avail = static_cast<uint64_t>(body.data() + body.size() - p);
      uint64_t fixed_need = 0;
      switch (cmd) {
        case kCreateTable: fixed_need = 18; break;  // u8+u32+u64+f32+u8
        case kPullSparse:
        case kShrink: fixed_need = 8; break;
        case kPushSparse:
        case kPushDense: fixed_need = 12; break;  // f32 lr + u64 n
        case kSave:
        case kLoad:
        case kBarrier:
        case kHeartbeat: fixed_need = 4; break;
        default: break;
      }
      if (avail < fixed_need) {
        send_response(fd, 1, "truncated request");
        continue;
      }
    }

    if (cmd == kStop) {
      send_response(fd, 0, "");
      {
        // barrier_mu held across store+notify: otherwise a waiter that just
        // evaluated its predicate can sleep through the notification forever
        std::lock_guard<std::mutex> lk(srv->barrier_mu);
        srv->stopping.store(true);
      }
      srv->barrier_cv.notify_all();
      break;
    }

    if (cmd == kCreateTable) {
      uint8_t is_dense = read_pod<uint8_t>(p);
      uint32_t dim = read_pod<uint32_t>(p);
      uint64_t dense_size = read_pod<uint64_t>(p);
      float init_range = read_pod<float>(p);
      uint8_t opt = read_pod<uint8_t>(p);
      auto t = std::make_shared<Table>();
      t->is_dense = is_dense;
      t->dim = dim;
      t->init_range = init_range;
      t->opt = opt;
      if (is_dense) {
        t->dense.assign(dense_size, 0.f);
        if (opt == kAdagrad) t->dense_g2.assign(dense_size, 0.f);
      }
      {
        std::unique_lock<std::shared_mutex> lk(srv->tables_mu);
        // replace: the shared_ptr keeps the old instance alive for any
        // handler that already grabbed it
        srv->tables[table_id] = std::move(t);
      }
      send_response(fd, 0, "");
      continue;
    }

    std::shared_ptr<Table> t;
    if (cmd != kBarrier && cmd != kHeartbeat && cmd != kStats) {
      std::shared_lock<std::shared_mutex> lk(srv->tables_mu);
      auto it = srv->tables.find(table_id);
      if (it == srv->tables.end()) {
        send_response(fd, 1, "no such table");
        continue;
      }
      t = it->second;
    }

    switch (cmd) {
      case kPullSparse: {
        uint64_t n = read_pod<uint64_t>(p);
        // never trust wire counts: n ids must fit in the remaining body
        if (n > static_cast<uint64_t>(body.data() + body.size() - p) / 8) {
          send_response(fd, 1, "pull_sparse: id count exceeds body");
          break;
        }
        std::string out;
        out.reserve(n * t->dim * 4);
        {
          // serialize under the lock, send AFTER releasing it — a slow
          // client's socket must not stall every other worker's table access
          std::unique_lock<std::shared_mutex> lk(t->mu);  // may insert
          for (uint64_t i = 0; i < n; ++i) {
            uint64_t id = read_pod<uint64_t>(p);
            auto it = t->rows.find(id);
            if (it == t->rows.end()) {
              it = t->rows.emplace(id, SparseRow()).first;
              init_row(&it->second, *t, id);
            }
            out.append(reinterpret_cast<const char*>(it->second.w.data()),
                       t->dim * 4);
          }
        }
        send_response(fd, 0, out);
        break;
      }
      case kPushSparse: {
        float lr = read_pod<float>(p);
        uint64_t n = read_pod<uint64_t>(p);
        // n ids (8B each) + n*dim grads (4B each) must fit in the body;
        // division form avoids u64 overflow for hostile n/dim
        uint64_t remain = static_cast<uint64_t>(body.data() + body.size() - p);
        if (n > remain / 8 ||
            (t->dim && (remain - n * 8) / 4 / t->dim < n)) {
          send_response(fd, 1, "push_sparse: payload exceeds body");
          break;
        }
        const char* ids_p = p;
        const char* grads_p = p + n * 8;
        std::unique_lock<std::shared_mutex> lk(t->mu);
        t->version++;
        for (uint64_t i = 0; i < n; ++i) {
          uint64_t id;
          memcpy(&id, ids_p + i * 8, 8);
          auto it = t->rows.find(id);
          if (it == t->rows.end()) {
            it = t->rows.emplace(id, SparseRow()).first;
            init_row(&it->second, *t, id);
          }
          it->second.version = t->version;
          apply_update(&it->second.w, &it->second.g2,
                       reinterpret_cast<const float*>(grads_p) + i * t->dim,
                       t->dim, lr, t->opt);
        }
        send_response(fd, 0, "");
        break;
      }
      case kPullDense: {
        std::string out;
        {
          std::shared_lock<std::shared_mutex> lk(t->mu);
          out.assign(reinterpret_cast<const char*>(t->dense.data()),
                     t->dense.size() * 4);
        }
        send_response(fd, 0, out);
        break;
      }
      case kPushDense: {
        float lr = read_pod<float>(p);
        uint64_t n = read_pod<uint64_t>(p);
        std::unique_lock<std::shared_mutex> lk(t->mu);
        if (n != t->dense.size() ||
            n * 4 > static_cast<uint64_t>(body.data() + body.size() - p)) {
          send_response(fd, 1, "dense size mismatch");
          break;
        }
        apply_update(&t->dense, &t->dense_g2,
                     reinterpret_cast<const float*>(p),
                     static_cast<uint32_t>(n), lr, t->opt);
        send_response(fd, 0, "");
        break;
      }
      case kSave: {
        uint32_t plen = read_pod<uint32_t>(p);
        if (plen > static_cast<uint64_t>(body.data() + body.size() - p)) {
          send_response(fd, 1, "truncated path");
          break;
        }
        std::string path(p, plen);
        std::shared_lock<std::shared_mutex> lk(t->mu);
        FILE* f = fopen(path.c_str(), "wb");
        if (!f) {
          send_response(fd, 1, "cannot open " + path);
          break;
        }
        uint8_t has_g2 = t->opt == kAdagrad ? 1 : 0;
        fwrite(&t->is_dense, 1, 1, f);
        fwrite(&has_g2, 1, 1, f);
        fwrite(&t->dim, 4, 1, f);
        if (t->is_dense) {
          uint64_t n = t->dense.size();
          fwrite(&n, 8, 1, f);
          fwrite(t->dense.data(), 4, n, f);
          if (has_g2) fwrite(t->dense_g2.data(), 4, n, f);
        } else {
          uint64_t n = t->rows.size();
          fwrite(&n, 8, 1, f);
          for (auto& kv : t->rows) {
            fwrite(&kv.first, 8, 1, f);
            fwrite(kv.second.w.data(), 4, t->dim, f);
            if (has_g2) fwrite(kv.second.g2.data(), 4, t->dim, f);
          }
        }
        fclose(f);
        send_response(fd, 0, "");
        break;
      }
      case kLoad: {
        uint32_t plen = read_pod<uint32_t>(p);
        if (plen > static_cast<uint64_t>(body.data() + body.size() - p)) {
          send_response(fd, 1, "truncated path");
          break;
        }
        std::string path(p, plen);
        std::unique_lock<std::shared_mutex> lk(t->mu);
        FILE* f = fopen(path.c_str(), "rb");
        if (!f) {
          send_response(fd, 1, "cannot open " + path);
          break;
        }
        uint8_t is_dense, has_g2;
        uint32_t dim;
        uint64_t n;
        if (fread(&is_dense, 1, 1, f) != 1 || fread(&has_g2, 1, 1, f) != 1 ||
            fread(&dim, 4, 1, f) != 1 || fread(&n, 8, 1, f) != 1 ||
            is_dense != t->is_dense || dim != t->dim) {
          fclose(f);
          send_response(fd, 1, "checkpoint/table mismatch");
          break;
        }
        bool ok = true;
        if (t->is_dense) {
          t->dense.resize(n);
          ok = fread(t->dense.data(), 4, n, f) == n;
          if (ok && has_g2) {
            t->dense_g2.resize(n);
            ok = fread(t->dense_g2.data(), 4, n, f) == n;
          }
        } else {
          t->rows.clear();
          for (uint64_t i = 0; i < n && ok; ++i) {
            uint64_t id;
            ok = fread(&id, 8, 1, f) == 1;
            if (!ok) break;
            SparseRow row;
            row.w.resize(dim);
            ok = fread(row.w.data(), 4, dim, f) == dim;
            if (ok && has_g2) {
              row.g2.resize(dim);
              ok = fread(row.g2.data(), 4, dim, f) == dim;
            } else if (t->opt == kAdagrad) {
              row.g2.assign(dim, 0.f);
            }
            // loaded rows start at the current generation — a shrink right
            // after restore must NOT wipe the table
            row.version = t->version + 1;
            t->rows.emplace(id, std::move(row));
          }
          if (ok) t->version++;
        }
        fclose(f);
        if (!ok) {
          send_response(fd, 1, "short read");
          break;
        }
        send_response(fd, 0, "");
        break;
      }
      case kShrink: {
        // drop rows untouched for `keep_versions` updates (reference:
        // fleet_wrapper.h:226 ShrinkSparseTable)
        uint64_t keep_versions = read_pod<uint64_t>(p);
        std::unique_lock<std::shared_mutex> lk(t->mu);
        uint64_t floor =
            t->version > keep_versions ? t->version - keep_versions : 0;
        uint64_t dropped = 0;
        for (auto it = t->rows.begin(); it != t->rows.end();) {
          if (it->second.version <= floor) {
            it = t->rows.erase(it);
            dropped++;
          } else {
            ++it;
          }
        }
        std::string out;
        append_pod(&out, dropped);
        send_response(fd, 0, out);
        break;
      }
      case kBarrier: {
        uint32_t n_workers = read_pod<uint32_t>(p);
        std::unique_lock<std::mutex> lk(srv->barrier_mu);
        uint64_t gen = srv->barrier_generation;
        if (++srv->barrier_count >= n_workers) {
          srv->barrier_count = 0;
          srv->barrier_generation++;
          srv->barrier_cv.notify_all();
        } else {
          srv->barrier_cv.wait(lk, [&] {
            return srv->barrier_generation != gen || srv->stopping.load();
          });
        }
        send_response(fd, 0, "");
        break;
      }
      case kHeartbeat: {
        uint32_t worker = read_pod<uint32_t>(p);
        std::lock_guard<std::mutex> lk(srv->hb_mu);
        srv->last_seen[worker] = now_sec();
        std::string out;
        append_pod<uint32_t>(&out, static_cast<uint32_t>(srv->last_seen.size()));
        for (auto& kv : srv->last_seen) {
          append_pod<uint32_t>(&out, kv.first);
          append_pod<float>(&out, static_cast<float>(now_sec() - kv.second));
        }
        send_response(fd, 0, out);
        break;
      }
      case kStats: {
        std::string out;
        std::shared_lock<std::shared_mutex> lk(srv->tables_mu);
        append_pod<uint32_t>(&out, static_cast<uint32_t>(srv->tables.size()));
        for (auto& kv : srv->tables) {
          append_pod<uint32_t>(&out, kv.first);
          std::shared_lock<std::shared_mutex> tl(kv.second->mu);
          uint64_t n = kv.second->is_dense ? kv.second->dense.size()
                                           : kv.second->rows.size();
          append_pod<uint64_t>(&out, n);
        }
        send_response(fd, 0, out);
        break;
      }
      default:
        send_response(fd, 1, "bad command");
        break;
    }
  }
  {
    // deregister BEFORE close: stop() must never shutdown() a recycled fd
    // number belonging to an unrelated file in this process
    std::lock_guard<std::mutex> lk(srv->conns_mu);
    auto& v = srv->conn_fds;
    v.erase(std::remove(v.begin(), v.end(), fd), v.end());
  }
  ::close(fd);
}

void accept_loop(Server* srv) {
  while (!srv->stopping.load()) {
    int fd = ::accept(srv->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (srv->stopping.load()) break;
      continue;
    }
    srv->threads.emplace_back(handle_conn, srv, fd);
  }
}

}  // namespace

extern "C" {

// Start a server on `port` (0 = ephemeral). Returns handle, or null.
void* paddle_ps_start(int port) {
  auto* srv = new Server();
  srv->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (srv->listen_fd < 0) {
    delete srv;
    return nullptr;
  }
  int one = 1;
  setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) < 0 ||
      ::listen(srv->listen_fd, 128) < 0) {
    ::close(srv->listen_fd);
    delete srv;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  srv->port = ntohs(addr.sin_port);
  srv->accept_thread = std::thread(accept_loop, srv);
  return srv;
}

int paddle_ps_port(void* h) { return static_cast<Server*>(h)->port; }

void paddle_ps_stop(void* h) {
  auto* srv = static_cast<Server*>(h);
  {
    std::lock_guard<std::mutex> lk(srv->barrier_mu);
    srv->stopping.store(true);
  }
  srv->barrier_cv.notify_all();
  ::shutdown(srv->listen_fd, SHUT_RDWR);
  ::close(srv->listen_fd);
  {
    // unblock connection threads parked in recv()
    std::lock_guard<std::mutex> lk(srv->conns_mu);
    for (int fd : srv->conn_fds) ::shutdown(fd, SHUT_RDWR);
  }
  if (srv->accept_thread.joinable()) srv->accept_thread.join();
  for (auto& t : srv->threads)
    if (t.joinable()) t.join();
  delete srv;
}

}  // extern "C"
