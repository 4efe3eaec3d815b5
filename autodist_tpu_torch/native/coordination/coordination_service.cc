// Coordination service — the native control-plane runtime.
//
// TPU-native replacement for the native surfaces the reference borrows from
// TensorFlow's C++ runtime (SURVEY §2.0): the per-node distributed gRPC
// server (reference autodist/utils/server_starter.py launches tf.Server),
// and the C++ ConditionalAccumulator / token-FIFOQueue kernels that
// implement PS sync barriers and bounded staleness
// (reference kernel/synchronization/ps_synchronizer.py:335-458).
//
// XLA owns the data plane (ICI/DCN collectives); what training jobs still
// need from a host-side service is exactly what those queues provided:
//   - job-wide named barriers            (sync PS step boundary)
//   - a key/value board                  (strategy-id / address exchange)
//   - per-worker step reports + MINSTEP  (bounded-staleness window:
//                                         proceed while my_step <= min+s)
//   - heartbeats + dead-worker detection (the Coordinator's fail-fast
//                                         watcher, reference coordinator.py:98-110)
//
// Design: single-threaded poll(2) event loop, newline-delimited text
// protocol, no dependencies. Blocking ops (BARRIER, WAITMIN) are handled by
// parking the reply until the condition fires — no server-side threads.
//
// Protocol (one command per line, space-separated):
//   PING                      -> PONG
//   PUT <key> <value>         -> OK
//   GET <key>                 -> VAL <value> | NONE
//   INC <name> [token]        -> VAL <n>              (atomic counter)
//   BARRIER <name> <n> [token] -> OK                  (blocks until n arrive)
//   STEP <worker> <step> [token] -> OK                (report progress)
//   MINSTEP                   -> VAL <min over workers>
//   WAITMIN <step> <stale>    -> OK                   (blocks until
//                                                      step <= minstep+stale)
//   HEARTBEAT <worker>        -> OK
//   GOODBYE <worker>          -> OK                   (clean deregister:
//                                                      drops heartbeat +
//                                                      step records so a
//                                                      finished worker is
//                                                      never counted dead
//                                                      and stops holding
//                                                      the staleness window)
//   DEADLIST <timeout_s>      -> VAL <w1,w2,...> | NONE
//   BPUT <key> <ver> <b64>    -> OK                   (versioned blob store:
//                                                      async-PS value serving)
//   BGET <key>                -> BVAL <ver> <b64> | NONE
//   QPUSH <q> <b64>           -> OK                   (FIFO blob queue:
//                                                      async-PS grad push)
//   QPOP <q>                  -> QVAL <b64> | NONE
//   QLEN <q>                  -> VAL <n>
//   SHUTDOWN                  -> OK (then exits)
//
// Idempotency tokens (round 6): the side-effecting commands INC, STEP,
// BARRIER, BPUTB and QPUSHB accept an optional trailing <token> argument
// (any whitespace-free string, client-generated, unique per LOGICAL
// operation). The service remembers the reply it produced for each token
// (bounded FIFO cache, kMaxTokens entries) and REPLAYS it for a repeated
// token without re-applying the command — so a client that retries after
// an ambiguous connection drop (request possibly applied, reply lost) can
// never double-apply a gradient blob, double-count a barrier arrival, or
// double-increment a counter. The dedup state lives in service memory:
// it survives any number of connection drops but NOT a service restart —
// consistent, since a restart also loses the counters/queues/blobs the
// tokens guarded. Read-only and naturally idempotent commands (GET,
// BGET*, QLEN, MINSTEP, WAITMIN, HEARTBEAT, PUT, GOODBYE) take no token:
// re-running them is always safe.
//
// Binary blob framing (round 4): the b64 text forms above cost +33% wire
// and an encode/decode pass on every gradient/value blob. The B-suffixed
// variants carry the payload as RAW bytes, length-prefixed by the header
// line (the control plane stays newline-delimited text):
//   BPUTB <key> <ver> <n> [token]\n<n raw bytes>  -> OK
//   BGETB <key>               -> BVALB <ver> <n>\n<n raw bytes> | NONE
//   QPUSHB <q> <n> [token]\n<n raw bytes>         -> OK | ERR queue full
//   QPOPB <q>                 -> QVALB <n>\n<n raw bytes> | NONE
// Blobs are stored raw either way; text and binary commands interoperate
// on the same keys/queues (text reads of binary-written blobs b64-encode
// on the way out).
//
// The blob commands are the wire of the ASYNC parameter-server path
// (autodist_tpu/runtime/ps_service.py): the owner publishes versioned
// parameter blobs with BPUT, workers fetch with BGET and push gradient
// blobs with QPUSH, and the owner's apply thread drains with QPOP — the
// role the reference's C++ ConditionalAccumulator + gRPC send/recv kernels
// played for async PS (reference ps_synchronizer.py:556-633). Payloads are
// base64 (the protocol stays newline-delimited text).

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <deque>
#include <map>
#include <string>
#include <utility>
#include <vector>

namespace {

// Strict length parse: the whole token must be digits (optionally signed)
// and in range. atol() returns 0 for garbage like "x16" — which would
// accept a zero-byte frame and then parse the real payload as commands —
// and has undefined behavior on overflow.
bool ParseLen(const std::string& s, long* out) {
  if (s.empty()) return false;
  errno = 0;
  char* end = nullptr;
  long v = strtol(s.c_str(), &end, 10);
  if (errno == ERANGE || end != s.c_str() + s.size()) return false;
  *out = v;
  return true;
}

const char kB64[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

std::string B64Encode(const std::string& in) {
  std::string out;
  out.reserve(((in.size() + 2) / 3) * 4);
  size_t i = 0;
  for (; i + 2 < in.size(); i += 3) {
    unsigned v = (static_cast<unsigned char>(in[i]) << 16) |
                 (static_cast<unsigned char>(in[i + 1]) << 8) |
                 static_cast<unsigned char>(in[i + 2]);
    out += kB64[(v >> 18) & 63]; out += kB64[(v >> 12) & 63];
    out += kB64[(v >> 6) & 63]; out += kB64[v & 63];
  }
  if (i < in.size()) {
    unsigned v = static_cast<unsigned char>(in[i]) << 16;
    bool two = i + 1 < in.size();
    if (two) v |= static_cast<unsigned char>(in[i + 1]) << 8;
    out += kB64[(v >> 18) & 63]; out += kB64[(v >> 12) & 63];
    out += two ? kB64[(v >> 6) & 63] : '=';
    out += '=';
  }
  return out;
}

std::string B64Decode(const std::string& in) {
  static int rev[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) rev[i] = -1;
    for (int i = 0; i < 64; ++i) rev[static_cast<unsigned char>(kB64[i])] = i;
    init = true;
  }
  std::string out;
  out.reserve((in.size() / 4) * 3);
  unsigned v = 0;
  int bits = 0;
  for (char c : in) {
    int d = rev[static_cast<unsigned char>(c)];
    if (d < 0) continue;  // '=' padding / whitespace
    v = (v << 6) | d;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out += static_cast<char>((v >> bits) & 0xFF);
    }
  }
  return out;
}

double NowSeconds() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

struct Waiter {
  int fd;
  // barrier waiter
  std::string barrier;
  // staleness waiter: proceed when step <= minstep + staleness
  bool is_waitmin = false;
  long step = 0;
  long staleness = 0;
};

struct Conn {
  int fd;
  std::string inbuf;
  std::string outbuf;
  size_t out_off = 0;  // sent prefix of outbuf (offset beats erase():
                       // an 8 MB blob would memmove itself per send)
  // binary framing: >0 while awaiting this many raw payload bytes for the
  // parked command below
  size_t bin_need = 0;
  std::vector<std::string> bin_args;
  // bytes of a *rejected* frame's payload still to drain: the client sends
  // header+payload in one write, so after an ERR the payload bytes are
  // already in flight and must not be parsed as command lines
  size_t bin_discard = 0;
  bool close_requested = false;  // length unparseable -> cannot resync
};

class Server {
 public:
  explicit Server(int port) : port_(port) {}

  int Run() {
    listen_fd_ = socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) { perror("socket"); return 1; }
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port_));
    if (bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
      perror("bind");
      return 1;
    }
    if (listen(listen_fd_, 128) < 0) { perror("listen"); return 1; }
    fprintf(stderr, "[coordination_service] listening on :%d\n", port_);
    fflush(stderr);
    EventLoop();
    return 0;
  }

 private:
  void EventLoop() {
    while (!shutdown_) {
      std::vector<pollfd> fds;
      fds.push_back({listen_fd_, POLLIN, 0});
      for (auto& [fd, conn] : conns_) {
        short events = POLLIN;
        if (conn.out_off < conn.outbuf.size()) events |= POLLOUT;
        fds.push_back({fd, events, 0});
      }
      int rc = poll(fds.data(), fds.size(), 1000);
      if (rc < 0 && errno != EINTR) { perror("poll"); break; }
      if (fds[0].revents & POLLIN) Accept();
      std::vector<int> closed;
      for (size_t i = 1; i < fds.size(); ++i) {
        int fd = fds[i].fd;
        auto it = conns_.find(fd);
        if (it == conns_.end()) continue;
        if (fds[i].revents & (POLLERR | POLLHUP)) {
          closed.push_back(fd);
          continue;
        }
        if (fds[i].revents & POLLIN) {
          if (!ReadFrom(it->second)) closed.push_back(fd);
        }
        if (fds[i].revents & POLLOUT) Flush(it->second);
      }
      for (int fd : closed) CloseConn(fd);
    }
  }

  void Accept() {
    int fd = accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) return;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
    conns_[fd] = Conn{fd, "", ""};
  }

  bool ReadFrom(Conn& conn) {
    char buf[262144];  // blob-sized reads: 4 KB would cost one syscall
                       // per 4 KB of a multi-MB gradient payload
    while (true) {
      ssize_t n = recv(conn.fd, buf, sizeof(buf), 0);
      if (n > 0) {
        conn.inbuf.append(buf, n);
      } else if (n == 0) {
        return false;  // peer closed
      } else {
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        return false;
      }
    }
    while (true) {
      if (conn.bin_discard > 0) {
        size_t drop = std::min(conn.bin_discard, conn.inbuf.size());
        conn.inbuf.erase(0, drop);
        conn.bin_discard -= drop;
        if (conn.bin_discard > 0) break;  // more to drain on a later read
        continue;
      }
      if (conn.bin_need > 0) {
        if (conn.inbuf.size() < conn.bin_need) break;  // payload incomplete
        std::string payload = conn.inbuf.substr(0, conn.bin_need);
        conn.inbuf.erase(0, conn.bin_need);
        conn.bin_need = 0;
        HandleBinaryPayload(conn, std::move(payload));
        continue;
      }
      size_t pos = conn.inbuf.find('\n');
      if (pos == std::string::npos) break;
      std::string line = conn.inbuf.substr(0, pos);
      conn.inbuf.erase(0, pos + 1);
      if (!line.empty() && line.back() == '\r') line.pop_back();
      Handle(conn, line);
      if (conn.close_requested) break;
    }
    Flush(conn);
    return !conn.close_requested;
  }

  static std::vector<std::string> Split(const std::string& s) {
    std::vector<std::string> out;
    size_t i = 0;
    while (i < s.size()) {
      size_t j = s.find(' ', i);
      if (j == std::string::npos) j = s.size();
      if (j > i) out.push_back(s.substr(i, j - i));
      i = j + 1;
    }
    return out;
  }

  void Reply(Conn& conn, const std::string& msg) {
    conn.outbuf += msg;
    conn.outbuf += '\n';
  }

  void ReplyFd(int fd, const std::string& msg) {
    auto it = conns_.find(fd);
    if (it != conns_.end()) {
      Reply(it->second, msg);
      Flush(it->second);
    }
  }

  void Flush(Conn& conn) {
    while (conn.out_off < conn.outbuf.size()) {
      ssize_t n = send(conn.fd, conn.outbuf.data() + conn.out_off,
                       conn.outbuf.size() - conn.out_off, MSG_NOSIGNAL);
      if (n > 0) {
        conn.out_off += static_cast<size_t>(n);
      } else {
        return;  // EAGAIN or error; poll will retry / detect close
      }
    }
    conn.outbuf.clear();
    conn.out_off = 0;
  }

  // ---- idempotency-token dedup: replies keyed by client token, bounded
  //      FIFO eviction (kMaxTokens). Stored replies are the RAW outbuf
  //      bytes (newline included), so replay is a verbatim append.
  bool ReplayToken(Conn& conn, const std::string& tok) {
    if (tok.empty()) return false;
    auto it = token_replies_.find(tok);
    if (it == token_replies_.end()) return false;
    conn.outbuf += it->second;
    return true;
  }

  void RememberToken(const std::string& tok, const std::string& raw_reply) {
    if (tok.empty()) return;
    if (token_replies_.emplace(tok, raw_reply).second) {
      token_order_.push_back(tok);
      if (token_order_.size() > kMaxTokens) {
        token_replies_.erase(token_order_.front());
        token_order_.pop_front();
      }
    }
  }

  // execute-and-remember for immediate (non-parked) tokened commands:
  // the reply bytes the handler appends are captured as the token's
  // replay record
  void ReplyTokened(Conn& conn, const std::string& tok,
                    const std::string& msg) {
    Reply(conn, msg);
    RememberToken(tok, msg + "\n");
  }

  void Handle(Conn& conn, const std::string& line) {
    auto parts = Split(line);
    if (parts.empty()) return;
    const std::string& cmd = parts[0];
    if (cmd == "PING") {
      Reply(conn, "PONG");
    } else if (cmd == "PUT" && parts.size() >= 3) {
      // value may contain spaces: everything after the key
      size_t vpos = line.find(parts[1]) + parts[1].size() + 1;
      kv_[parts[1]] = line.substr(vpos);
      Reply(conn, "OK");
    } else if (cmd == "GET" && parts.size() == 2) {
      auto it = kv_.find(parts[1]);
      if (it == kv_.end()) Reply(conn, "NONE");
      else Reply(conn, "VAL " + it->second);
    } else if (cmd == "INC" && (parts.size() == 2 || parts.size() == 3)) {
      const std::string tok = parts.size() == 3 ? parts[2] : "";
      if (ReplayToken(conn, tok)) return;
      long v = ++counters_[parts[1]];
      ReplyTokened(conn, tok, "VAL " + std::to_string(v));
    } else if (cmd == "BARRIER" && (parts.size() == 3 || parts.size() == 4)) {
      const std::string& name = parts[1];
      long want = atol(parts[2].c_str());
      const std::string tok = parts.size() == 4 ? parts[3] : "";
      // a token that already fired replays OK immediately — the retried
      // arrival must NOT wait for peers who already passed the barrier
      if (ReplayToken(conn, tok)) return;
      auto& waiters = barrier_waiters_[name];
      // a retry whose ORIGINAL arrival is still parked (its dead
      // connection not yet reaped in this poll cycle) must REPLACE it,
      // not join it — one logical arrival, never two
      bool replaced = false;
      if (!tok.empty()) {
        for (auto& w : waiters) {
          if (w.second == tok) { w.first = conn.fd; replaced = true; break; }
        }
      }
      if (!replaced) waiters.push_back({conn.fd, tok});
      if (static_cast<long>(barrier_waiters_[name].size()) >= want) {
        for (auto& [fd, wtok] : barrier_waiters_[name]) {
          ReplyFd(fd, "OK");
          RememberToken(wtok, "OK\n");
        }
        barrier_waiters_.erase(name);
      }
    } else if (cmd == "STEP" && (parts.size() == 3 || parts.size() == 4)) {
      const std::string tok = parts.size() == 4 ? parts[3] : "";
      if (ReplayToken(conn, tok)) return;
      steps_[parts[1]] = atol(parts[2].c_str());
      ReplyTokened(conn, tok, "OK");
      WakeStaleWaiters();
    } else if (cmd == "MINSTEP") {
      Reply(conn, "VAL " + std::to_string(MinStep()));
    } else if (cmd == "WAITMIN" && parts.size() == 3) {
      long step = atol(parts[1].c_str());
      long stale = atol(parts[2].c_str());
      if (step <= MinStep() + stale) {
        Reply(conn, "OK");
      } else {
        stale_waiters_.push_back(Waiter{conn.fd, "", true, step, stale});
      }
    } else if (cmd == "HEARTBEAT" && parts.size() == 2) {
      heartbeats_[parts[1]] = NowSeconds();
      Reply(conn, "OK");
    } else if (cmd == "GOODBYE" && parts.size() == 2) {
      heartbeats_.erase(parts[1]);
      steps_.erase(parts[1]);
      Reply(conn, "OK");
      // the departed worker no longer bounds the staleness window
      WakeStaleWaiters();
    } else if (cmd == "DEADLIST" && parts.size() == 2) {
      double timeout = atof(parts[1].c_str());
      double now = NowSeconds();
      std::string dead;
      for (auto& [w, t] : heartbeats_) {
        if (now - t > timeout) {
          if (!dead.empty()) dead += ",";
          dead += w;
        }
      }
      Reply(conn, dead.empty() ? "NONE" : "VAL " + dead);
    } else if (cmd == "BPUT" && parts.size() == 4) {
      // storage is RAW bytes for both wire forms; the text form carries
      // b64 and converts at the boundary
      blobs_[parts[1]] = {atol(parts[2].c_str()), B64Decode(parts[3])};
      Reply(conn, "OK");
    } else if (cmd == "BGET" && parts.size() == 2) {
      auto it = blobs_.find(parts[1]);
      if (it == blobs_.end()) {
        Reply(conn, "NONE");
      } else {
        Reply(conn, "BVAL " + std::to_string(it->second.first) + " " +
                        B64Encode(it->second.second));
      }
    } else if (cmd == "QPUSH" && parts.size() == 3) {
      // cap: a queue nobody drains (dead owner) must not eat the host's
      // memory; clients see the rejection and fail loudly
      auto& q = queues_[parts[1]];
      if (q.size() >= kMaxQueueLen) {
        Reply(conn, "ERR queue full");
      } else {
        q.push_back(B64Decode(parts[2]));
        Reply(conn, "OK");
      }
    } else if (cmd == "QPOP" && parts.size() == 2) {
      auto it = queues_.find(parts[1]);
      if (it == queues_.end() || it->second.empty()) {
        Reply(conn, "NONE");
      } else {
        Reply(conn, "QVAL " + B64Encode(it->second.front()));
        it->second.pop_front();
      }
    } else if (cmd == "QLEN" && parts.size() == 2) {
      auto it = queues_.find(parts[1]);
      long n = (it == queues_.end()) ? 0 : static_cast<long>(it->second.size());
      Reply(conn, "VAL " + std::to_string(n));
    } else if (cmd == "BPUTB" && (parts.size() == 4 || parts.size() == 5)) {
      long n = 0;
      const std::string tok = parts.size() == 5 ? parts[4] : "";
      if (!ParseLen(parts[3], &n) || n < 0) {
        // length unparseable/negative -> the payload boundary is lost
        // (atol would return 0 for "x16" and the real payload would be
        // parsed as command lines); close rather than desync
        Reply(conn, "ERR bad length");
        conn.close_requested = true;
      } else if (n > kMaxBlobBytes) {
        // the client already sent header+payload in one write: drain
        // exactly n bytes so line parsing resumes at the next frame
        Reply(conn, "ERR bad length");
        conn.bin_discard = static_cast<size_t>(n);
      } else if (ReplayToken(conn, tok)) {
        // duplicate: replay the recorded reply, but the retried payload
        // bytes are already in flight and must still be drained
        conn.bin_discard = static_cast<size_t>(n);
      } else {
        conn.bin_args = {cmd, parts[1], parts[2], tok};
        conn.bin_need = static_cast<size_t>(n);
        if (conn.bin_need == 0) HandleBinaryPayload(conn, "");
      }
    } else if (cmd == "QPUSHB" && (parts.size() == 3 || parts.size() == 4)) {
      long n = 0;
      const std::string tok = parts.size() == 4 ? parts[3] : "";
      if (!ParseLen(parts[2], &n) || n < 0) {
        Reply(conn, "ERR bad length");
        conn.close_requested = true;
      } else if (n > kMaxBlobBytes) {
        Reply(conn, "ERR bad length");
        conn.bin_discard = static_cast<size_t>(n);
      } else if (ReplayToken(conn, tok)) {
        conn.bin_discard = static_cast<size_t>(n);
      } else {
        conn.bin_args = {cmd, parts[1], tok};
        conn.bin_need = static_cast<size_t>(n);
        if (conn.bin_need == 0) HandleBinaryPayload(conn, "");
      }
    } else if (cmd == "BGETB" && parts.size() == 2) {
      auto it = blobs_.find(parts[1]);
      if (it == blobs_.end()) {
        Reply(conn, "NONE");
      } else {
        Reply(conn, "BVALB " + std::to_string(it->second.first) + " " +
                        std::to_string(it->second.second.size()));
        conn.outbuf += it->second.second;  // raw, length-prefixed above
      }
    } else if (cmd == "QPOPB" && parts.size() == 2) {
      auto it = queues_.find(parts[1]);
      if (it == queues_.end() || it->second.empty()) {
        Reply(conn, "NONE");
      } else {
        Reply(conn, "QVALB " + std::to_string(it->second.front().size()));
        conn.outbuf += it->second.front();
        it->second.pop_front();
      }
    } else if (cmd == "SHUTDOWN") {
      Reply(conn, "OK");
      Flush(conn);
      shutdown_ = true;
    } else {
      Reply(conn, "ERR unknown command");
    }
  }

  void HandleBinaryPayload(Conn& conn, std::string payload) {
    std::vector<std::string> args;
    args.swap(conn.bin_args);
    if (args.empty()) return;
    if (args[0] == "BPUTB") {
      blobs_[args[1]] = {atol(args[2].c_str()), std::move(payload)};
      ReplyTokened(conn, args[3], "OK");
    } else if (args[0] == "QPUSHB") {
      auto& q = queues_[args[1]];
      if (q.size() >= kMaxQueueLen) {
        // remembered too: a retry of a rejected push must replay the
        // rejection, not sneak a second copy in once the queue drains
        ReplyTokened(conn, args[2], "ERR queue full");
      } else {
        q.push_back(std::move(payload));
        ReplyTokened(conn, args[2], "OK");
      }
    }
  }

  long MinStep() {
    long m = 0;
    bool first = true;
    for (auto& [w, s] : steps_) {
      if (first || s < m) { m = s; first = false; }
    }
    return m;
  }

  void WakeStaleWaiters() {
    long m = MinStep();
    std::vector<Waiter> still;
    for (auto& w : stale_waiters_) {
      if (w.step <= m + w.staleness) ReplyFd(w.fd, "OK");
      else still.push_back(w);
    }
    stale_waiters_.swap(still);
  }

  void CloseConn(int fd) {
    // drop from any barrier/staleness wait lists: a parked arrival whose
    // connection died is forgotten, so the client's tokened retry counts
    // as the (single) arrival
    for (auto& [name, waiters] : barrier_waiters_) {
      waiters.erase(std::remove_if(waiters.begin(), waiters.end(),
                                   [fd](const std::pair<int, std::string>& w) {
                                     return w.first == fd;
                                   }),
                    waiters.end());
    }
    std::vector<Waiter> still;
    for (auto& w : stale_waiters_)
      if (w.fd != fd) still.push_back(w);
    stale_waiters_.swap(still);
    close(fd);
    conns_.erase(fd);
  }

  int port_;
  int listen_fd_ = -1;
  bool shutdown_ = false;
  std::map<int, Conn> conns_;
  std::map<std::string, std::string> kv_;
  static constexpr size_t kMaxQueueLen = 4096;
  // binary-frame payload cap: far above any gradient blob, far below
  // anything that could park the parser / eat host memory
  static constexpr long kMaxBlobBytes = 1L << 31;  // 2 GB
  std::map<std::string, std::pair<long, std::string>> blobs_;
  std::map<std::string, std::deque<std::string>> queues_;
  std::map<std::string, long> counters_;
  // idempotency dedup: token -> raw reply bytes, FIFO-evicted. 64k
  // entries bound the memory; a token older than 64k subsequent tokened
  // RPCs can no longer be retried — far beyond any client retry window.
  static constexpr size_t kMaxTokens = 1 << 16;
  std::map<std::string, std::string> token_replies_;
  std::deque<std::string> token_order_;
  std::map<std::string, std::vector<std::pair<int, std::string>>>
      barrier_waiters_;
  std::vector<Waiter> stale_waiters_;
  std::map<std::string, long> steps_;
  std::map<std::string, double> heartbeats_;
};

}  // namespace

int main(int argc, char** argv) {
  signal(SIGPIPE, SIG_IGN);
  int port = argc > 1 ? atoi(argv[1]) : 15999;
  Server server(port);
  return server.Run();
}
