// Vendored HTTP/2 unary-gRPC ingress for the rate limiter's PyTorch/CUDA
// port.
//
// The port's own copy of native/h2ingress.cc (the JAX package's ingress),
// built by limitador_tpu_torch/native/build.py with h2_hpack_tables.h;
// limitador_tpu_torch/native/ingress.py binds it.
//
// A bounded, from-scratch HTTP/2 server (RFC 7540 framing + RFC 7541
// HPACK, tables in h2_hpack_tables.h) sufficient for unary gRPC from
// real grpc clients: preface, SETTINGS exchange, HEADERS/CONTINUATION
// with full HPACK decode (static + dynamic table, Huffman), DATA with
// flow-control accounting and window refill, PING/GOAWAY/RST_STREAM/
// WINDOW_UPDATE/PRIORITY, and grpc-framed unary responses (HEADERS +
// DATA + trailers, or trailers-only for errors).
//
// Counterpart of the reference's tonic ingress
// (limitador-server/src/envoy_rls/server.rs:238-272) redesigned for the
// batched device serving model: ONE epoll thread owns every socket, parses
// frames, and accumulates complete request payloads; application
// threads pull whole batches (h2i_take) and answer whole batches
// (h2i_respond) — the per-request hot path never enters Python.
//
// Deliberately out of scope (unary server needs none of it): server
// push, priority scheduling, request trailers semantics beyond HPACK
// consistency, TLS (grpc clients speak h2c to insecure ports).

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "h2_hpack_tables.h"

namespace {

// ------------------------------------------------------- respond telemetry
// One log2-ns histogram over h2i_respond_coded — the native half of the
// zero-Python response path (the native telemetry plane). Process-
// global and wait-free like hostpath.cc's Tel: relaxed atomics, two
// steady_clock reads per respond batch, nothing per row. Drained
// cumulative by h2i_tel_drain; Python converts to increments.

constexpr int H2I_TEL_BUCKETS = 40;

std::atomic<int32_t> g_tel_enabled{0};
std::atomic<uint64_t> g_tel_count{0};
std::atomic<uint64_t> g_tel_sum{0};
std::atomic<uint64_t> g_tel_buckets[H2I_TEL_BUCKETS];

inline int64_t tel_now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

inline void tel_observe(int64_t ns) {
  if (ns < 0) ns = 0;
  int b = 0;
  uint64_t v = (uint64_t)ns;
  while (v >>= 1) b++;
  if (b >= H2I_TEL_BUCKETS) b = H2I_TEL_BUCKETS - 1;
  // relaxed: independently-monotone counters; a concurrent drain may
  // split one observation's (count, sum, bucket) triple across two
  // drains — the Python side converts per-bucket deltas, so the
  // observation lands whole next drain (same invariant as hostpath's
  // tel_observe)
  g_tel_count.fetch_add(1, std::memory_order_relaxed);
  g_tel_sum.fetch_add((uint64_t)ns, std::memory_order_relaxed);
  g_tel_buckets[b].fetch_add(1, std::memory_order_relaxed);
}

// ---------------------------------------------------------------- huffman

struct HuffNode {
  int32_t child[2] = {-1, -1};
  int32_t sym = -1;
};

struct HuffTrie {
  std::vector<HuffNode> nodes;
  HuffTrie() {
    nodes.emplace_back();
    for (int s = 0; s < 257; s++) {
      uint32_t code = kHuffCodes[s];
      int len = kHuffLens[s];
      int cur = 0;
      for (int b = len - 1; b >= 0; b--) {
        int bit = (code >> b) & 1;
        if (nodes[cur].child[bit] < 0) {
          nodes[cur].child[bit] = (int32_t)nodes.size();
          nodes.emplace_back();
        }
        cur = nodes[cur].child[bit];
      }
      nodes[cur].sym = s;
    }
  }
};

const HuffTrie& huff_trie() {
  static HuffTrie t;
  return t;
}

// Returns false on malformed input (EOS inside, bad padding).
bool huff_decode(const uint8_t* p, size_t len, std::string* out) {
  const HuffTrie& t = huff_trie();
  int cur = 0;
  int bits_since_sym = 0;
  bool all_ones = true;
  for (size_t i = 0; i < len; i++) {
    for (int b = 7; b >= 0; b--) {
      int bit = (p[i] >> b) & 1;
      if (!bit) all_ones = false;
      cur = t.nodes[cur].child[bit];
      if (cur < 0) return false;
      bits_since_sym++;
      int sym = t.nodes[cur].sym;
      if (sym >= 0) {
        if (sym == 256) return false;  // EOS in the body is an error
        out->push_back((char)sym);
        cur = 0;
        bits_since_sym = 0;
        all_ones = true;
      }
    }
  }
  // Padding must be < 8 bits of the EOS prefix (all ones).
  return bits_since_sym < 8 && (bits_since_sym == 0 || all_ones);
}

// ---------------------------------------------------------------- hpack

struct Header {
  std::string name, value;
};

struct HpackDecoder {
  std::deque<Header> dyn;  // most-recent first (index 62 = dyn[0])
  size_t dyn_size = 0;
  size_t dyn_max = 4096;
  size_t dyn_cap = 4096;  // protocol max from our SETTINGS (we keep default)

  void evict() {
    while (dyn_size > dyn_max && !dyn.empty()) {
      dyn_size -= dyn.back().name.size() + dyn.back().value.size() + 32;
      dyn.pop_back();
    }
  }

  void add(std::string name, std::string value) {
    size_t sz = name.size() + value.size() + 32;
    if (sz > dyn_max) {  // entry larger than table: clears it
      dyn.clear();
      dyn_size = 0;
      return;
    }
    dyn.push_front(Header{std::move(name), std::move(value)});
    dyn_size += sz;
    evict();
  }

  bool get(uint64_t idx, Header* out) {
    if (idx == 0) return false;
    if (idx <= 61) {
      out->name = kStaticTable[idx - 1].name;
      out->value = kStaticTable[idx - 1].value;
      return true;
    }
    uint64_t d = idx - 62;
    if (d >= dyn.size()) return false;
    *out = dyn[d];
    return true;
  }
};

// RFC 7541 5.1 integer; returns false on truncation/overflow.
bool read_int(const uint8_t*& p, const uint8_t* end, int prefix_bits,
              uint64_t* out) {
  if (p >= end) return false;
  uint64_t max_prefix = (1u << prefix_bits) - 1;
  uint64_t v = *p & max_prefix;
  p++;
  if (v < max_prefix) {
    *out = v;
    return true;
  }
  int shift = 0;
  while (p < end) {
    uint8_t b = *p++;
    v += (uint64_t)(b & 0x7f) << shift;
    shift += 7;
    if (shift > 56) return false;
    if (!(b & 0x80)) {
      *out = v;
      return true;
    }
  }
  return false;
}

bool read_string(const uint8_t*& p, const uint8_t* end, std::string* out) {
  if (p >= end) return false;
  bool huff = (*p & 0x80) != 0;
  uint64_t len;
  if (!read_int(p, end, 7, &len)) return false;
  if ((uint64_t)(end - p) < len) return false;
  if (huff) {
    if (!huff_decode(p, len, out)) return false;
  } else {
    out->assign((const char*)p, len);
  }
  p += len;
  return true;
}

bool hpack_decode(HpackDecoder* dec, const uint8_t* p, size_t n,
                  std::vector<Header>* out) {
  const uint8_t* end = p + n;
  while (p < end) {
    uint8_t b = *p;
    if (b & 0x80) {  // indexed
      uint64_t idx;
      if (!read_int(p, end, 7, &idx)) return false;
      Header h;
      if (!dec->get(idx, &h)) return false;
      out->push_back(std::move(h));
    } else if (b & 0x40) {  // literal, incremental indexing
      uint64_t idx;
      if (!read_int(p, end, 6, &idx)) return false;
      Header h;
      if (idx) {
        Header nh;
        if (!dec->get(idx, &nh)) return false;
        h.name = nh.name;
      } else if (!read_string(p, end, &h.name)) {
        return false;
      }
      if (!read_string(p, end, &h.value)) return false;
      dec->add(h.name, h.value);
      out->push_back(std::move(h));
    } else if (b & 0x20) {  // dynamic table size update
      uint64_t sz;
      if (!read_int(p, end, 5, &sz)) return false;
      if (sz > dec->dyn_cap) return false;
      dec->dyn_max = sz;
      dec->evict();
    } else {  // literal without indexing (0000) / never indexed (0001)
      uint64_t idx;
      if (!read_int(p, end, 4, &idx)) return false;
      Header h;
      if (idx) {
        Header nh;
        if (!dec->get(idx, &nh)) return false;
        h.name = nh.name;
      } else if (!read_string(p, end, &h.name)) {
        return false;
      }
      if (!read_string(p, end, &h.value)) return false;
      out->push_back(std::move(h));
    }
  }
  return true;
}

// ---------------------------------------------------------------- frames

constexpr uint8_t F_DATA = 0, F_HEADERS = 1, F_PRIORITY = 2, F_RST = 3,
                  F_SETTINGS = 4, F_PUSH = 5, F_PING = 6, F_GOAWAY = 7,
                  F_WINUPD = 8, F_CONT = 9;
constexpr uint8_t FL_END_STREAM = 0x1, FL_ACK = 0x1, FL_END_HEADERS = 0x4,
                  FL_PADDED = 0x8, FL_PRIORITY = 0x20;
constexpr size_t MAX_FRAME = 16384;       // we advertise the default
constexpr size_t MAX_HEADER_BLOCK = 1 << 20;
constexpr size_t MAX_BODY = 8 << 20;
constexpr const char* PREFACE = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";

void put_frame_header(std::string* buf, size_t len, uint8_t type,
                      uint8_t flags, uint32_t stream) {
  buf->push_back((char)((len >> 16) & 0xff));
  buf->push_back((char)((len >> 8) & 0xff));
  buf->push_back((char)(len & 0xff));
  buf->push_back((char)type);
  buf->push_back((char)flags);
  buf->push_back((char)((stream >> 24) & 0x7f));
  buf->push_back((char)((stream >> 16) & 0xff));
  buf->push_back((char)((stream >> 8) & 0xff));
  buf->push_back((char)(stream & 0xff));
}

void put_u32(std::string* buf, uint32_t v) {
  buf->push_back((char)(v >> 24));
  buf->push_back((char)(v >> 16));
  buf->push_back((char)(v >> 8));
  buf->push_back((char)v);
}

// Literal header field without indexing, new name, no Huffman (responses
// are tiny and fixed; indexing would force us to model the client's
// decoder table for zero gain).
void put_literal(std::string* buf, const char* name, const std::string& val) {
  size_t nl = strlen(name);
  buf->push_back((char)0x00);
  buf->push_back((char)nl);  // all our names are < 127 bytes
  buf->append(name, nl);
  buf->push_back((char)val.size());
  buf->append(val);
}

// grpc-message carries arbitrary exception text from the application;
// anything outside printable ASCII would make the header field value
// itself invalid and tear down the whole connection.
std::string sanitize_field_value(const std::string& in) {
  std::string out;
  out.reserve(in.size());
  for (char ch : in)
    out.push_back((ch >= 0x20 && ch < 0x7f) ? ch : '_');
  return out;
}

// ---------------------------------------------------------------- conn

struct Stream {
  std::string body;
  std::string path;
  bool headers_done = false;
  bool end_stream = false;
  bool responded = false;
  bool streaming = false;         // registered bidi-stream path (reflection)
  bool resp_headers_sent = false; // streaming: response HEADERS emitted
  int64_t send_win = 65535;
};

struct Parked {  // DATA (+optional trailers) waiting for send window
  uint32_t stream;
  std::string data_payload;   // grpc-framed message (DATA frame payload)
  std::string trailer_frame;  // fully framed trailers HEADERS ("" = none)
  bool close_stream = true;   // erase the stream after this item
};

struct Conn {
  int fd = -1;
  uint64_t id = 0;
  std::string rbuf;
  std::string wbuf;
  bool preface_done = false;
  bool writable_armed = false;
  bool dead = false;
  HpackDecoder hpack;
  std::unordered_map<uint32_t, Stream> streams;
  int64_t send_win = 65535;
  int64_t initial_stream_win = 65535;
  size_t max_frame = 16384;  // client's SETTINGS_MAX_FRAME_SIZE
  uint32_t cont_stream = 0;  // nonzero: collecting CONTINUATION for it
  uint8_t cont_flags = 0;
  std::string cont_block;
  std::deque<Parked> parked;
};

struct InflightReq {
  uint64_t conn_id;
  uint32_t stream;
  std::string payload;
  std::string path;  // ":path"; the app routes non-target methods
  bool streaming = false;  // answer keeps the stream open (status -1 closes)
};

struct Resp {
  uint64_t rid;
  int status;  // 0 = OK with payload; else grpc-status code
  std::string payload;  // message bytes (status 0) or grpc-message text
};

struct Ctx {
  int listen_fd = -1;
  int epoll_fd = -1;
  int wake_fd = -1;
  int port = 0;
  std::string target_path;
  std::string stream_path;  // bidi-stream method ("" = none registered)
  std::thread io;
  std::atomic<bool> stop{false};

  std::mutex mu;
  std::condition_variable cv;
  std::deque<uint64_t> ready;
  std::unordered_map<uint64_t, InflightReq> inflight;
  std::vector<Resp> responses;

  // Coded-response templates (h2i_set_code / h2i_respond_coded): the
  // hot lane answers whole batches by outcome code, so the prebuilt
  // (status, payload) pairs live here instead of crossing ctypes per
  // request.
  struct CodeTmpl {
    bool set = false;
    int status = 0;
    std::string payload;
  };
  CodeTmpl code_tmpls[16];

  std::unordered_map<uint64_t, Conn*> conns;
  uint64_t next_conn_id = 2;  // 0 = listen socket tag, 1 = wake eventfd tag
  uint64_t next_rid = 1;
  std::atomic<uint64_t> stat_conns{0};
  std::atomic<uint64_t> stat_reqs{0};
  std::atomic<uint64_t> stat_resps{0};
  std::atomic<uint64_t> stat_proto_errors{0};
};

void arm(Ctx* c, Conn* conn, bool want_write) {
  if (conn->writable_armed == want_write) return;
  conn->writable_armed = want_write;
  epoll_event ev{};
  ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0);
  ev.data.u64 = conn->id;
  epoll_ctl(c->epoll_fd, EPOLL_CTL_MOD, conn->fd, &ev);
}

void flush_writes(Ctx* c, Conn* conn) {
  while (!conn->wbuf.empty()) {
    ssize_t k = ::send(conn->fd, conn->wbuf.data(), conn->wbuf.size(),
                       MSG_NOSIGNAL);
    if (k > 0) {
      conn->wbuf.erase(0, (size_t)k);
    } else if (k < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      arm(c, conn, true);
      return;
    } else {
      conn->dead = true;
      return;
    }
  }
  arm(c, conn, false);
}

void kill_conn(Ctx* c, Conn* conn) {
  epoll_ctl(c->epoll_fd, EPOLL_CTL_DEL, conn->fd, nullptr);
  ::close(conn->fd);
  c->conns.erase(conn->id);
  delete conn;
}

void goaway(Ctx* c, Conn* conn, uint32_t err) {
  std::string f;
  put_frame_header(&f, 8, F_GOAWAY, 0, 0);
  put_u32(&f, 0);
  put_u32(&f, err);
  conn->wbuf += f;
  conn->dead = true;  // killed after flush attempt
  c->stat_proto_errors++;
  flush_writes(c, conn);
}

// Emit as much of the parked response queue as the peer's frame-size
// and flow-control limits allow. DATA splits into <= max_frame chunks
// and partial window credit makes partial progress; a response whose
// window is exhausted stays at the queue head until WINDOW_UPDATE
// (FIFO per connection — responses here are tiny, head-of-line across
// streams is accepted for boundedness).
void drain_parked(Conn* conn) {
  while (!conn->parked.empty()) {
    Parked& p = conn->parked.front();
    auto it = conn->streams.find(p.stream);
    if (it == conn->streams.end()) {  // stream reset while parked
      conn->parked.pop_front();
      continue;
    }
    Stream& st = it->second;
    while (!p.data_payload.empty()) {
      int64_t allow = conn->send_win < st.send_win ? conn->send_win
                                                   : st.send_win;
      if (allow <= 0) return;  // wait for WINDOW_UPDATE / SETTINGS
      size_t chunk = p.data_payload.size();
      if (chunk > (size_t)allow) chunk = (size_t)allow;
      if (chunk > conn->max_frame) chunk = conn->max_frame;
      put_frame_header(&conn->wbuf, chunk, F_DATA, 0, p.stream);
      conn->wbuf.append(p.data_payload, 0, chunk);
      p.data_payload.erase(0, chunk);
      conn->send_win -= (int64_t)chunk;
      st.send_win -= (int64_t)chunk;
    }
    if (!p.trailer_frame.empty()) conn->wbuf += p.trailer_frame;
    if (p.close_stream) conn->streams.erase(it);
    conn->parked.pop_front();
  }
}

// Build a response: headers immediately (not flow-controlled), the
// grpc-framed DATA + trailers through the parked queue so frame-size
// and window limits apply uniformly.
void write_response(Conn* conn, uint32_t stream, int status,
                    const std::string& payload) {
  if (status == 0) {
    std::string hb;
    hb.push_back((char)0x88);  // :status 200 (static 8)
    put_literal(&hb, "content-type", "application/grpc");
    put_frame_header(&conn->wbuf, hb.size(), F_HEADERS, FL_END_HEADERS,
                     stream);
    conn->wbuf += hb;

    std::string data;
    data.push_back((char)0);  // uncompressed
    put_u32(&data, (uint32_t)payload.size());
    data += payload;

    std::string tb;
    put_literal(&tb, "grpc-status", "0");
    std::string tf;
    put_frame_header(&tf, tb.size(), F_HEADERS,
                     FL_END_HEADERS | FL_END_STREAM, stream);
    tf += tb;

    conn->parked.push_back(Parked{stream, std::move(data), std::move(tf)});
    drain_parked(conn);
  } else {
    // trailers-only (grpc error): one HEADERS with END_STREAM
    std::string hb;
    hb.push_back((char)0x88);
    put_literal(&hb, "content-type", "application/grpc");
    put_literal(&hb, "grpc-status", std::to_string(status));
    if (!payload.empty() && payload.size() < 120)
      put_literal(&hb, "grpc-message", sanitize_field_value(payload));
    put_frame_header(&conn->wbuf, hb.size(), F_HEADERS,
                     FL_END_HEADERS | FL_END_STREAM, stream);
    conn->wbuf += hb;
    conn->streams.erase(stream);
  }
}

// Streaming (bidi) responses: HEADERS once, then one grpc-framed DATA per
// message through the parked queue WITHOUT trailers; close writes the
// trailers (or a trailers-only error) and retires the stream.
void ensure_stream_headers(Conn* conn, uint32_t sid, Stream* st) {
  if (st->resp_headers_sent) return;
  st->resp_headers_sent = true;
  std::string hb;
  hb.push_back((char)0x88);  // :status 200 (static 8)
  put_literal(&hb, "content-type", "application/grpc");
  put_frame_header(&conn->wbuf, hb.size(), F_HEADERS, FL_END_HEADERS, sid);
  conn->wbuf += hb;
}

void write_stream_msg(Conn* conn, uint32_t sid, const std::string& payload) {
  auto it = conn->streams.find(sid);
  if (it == conn->streams.end()) return;  // reset while in flight
  ensure_stream_headers(conn, sid, &it->second);
  std::string data;
  data.push_back((char)0);  // uncompressed
  put_u32(&data, (uint32_t)payload.size());
  data += payload;
  conn->parked.push_back(Parked{sid, std::move(data), "", false});
  drain_parked(conn);
}

void write_stream_close(Conn* conn, uint32_t sid, int status,
                        const std::string& msg) {
  auto it = conn->streams.find(sid);
  if (it == conn->streams.end()) return;
  Stream& st = it->second;
  if (!st.resp_headers_sent && status != 0) {
    write_response(conn, sid, status, msg);  // trailers-only error
    return;
  }
  ensure_stream_headers(conn, sid, &st);
  std::string tb;
  put_literal(&tb, "grpc-status", std::to_string(status));
  if (status != 0 && !msg.empty() && msg.size() < 120)
    put_literal(&tb, "grpc-message", sanitize_field_value(msg));
  std::string tf;
  put_frame_header(&tf, tb.size(), F_HEADERS,
                   FL_END_HEADERS | FL_END_STREAM, sid);
  tf += tb;
  conn->parked.push_back(Parked{sid, "", std::move(tf), true});
  drain_parked(conn);
}

// Queue one stream event for the app. Messages carry the stream path;
// the client's half-close arrives as path + "#eos" with an empty payload
// (the app answers it with status -1 = "close the stream OK").
void deliver_stream_event(Ctx* c, Conn* conn, uint32_t sid,
                          std::string payload, bool eos) {
  uint64_t rid;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    rid = c->next_rid++;
    c->inflight.emplace(
        rid, InflightReq{conn->id, sid, std::move(payload),
                         eos ? c->stream_path + "#eos" : c->stream_path,
                         true});
    c->ready.push_back(rid);
  }
  c->stat_reqs++;
  c->cv.notify_all();
}

// Extract complete grpc frames from a streaming upload; returns false
// when the stream was answered with an error (caller stops processing).
bool pump_stream_msgs(Ctx* c, Conn* conn, uint32_t sid, Stream* st) {
  while (st->body.size() >= 5) {
    if (st->body[0] != 0) {
      st->responded = true;
      write_response(conn, sid, 12, "compression not supported");
      return false;
    }
    uint32_t mlen = ((uint8_t)st->body[1] << 24) |
                    ((uint8_t)st->body[2] << 16) |
                    ((uint8_t)st->body[3] << 8) | (uint8_t)st->body[4];
    if ((size_t)mlen > MAX_BODY) {
      st->responded = true;
      write_response(conn, sid, 8, "message too large");  // RESOURCE_EXHAUSTED
      return false;
    }
    if (st->body.size() < 5 + (size_t)mlen) break;  // partial frame
    deliver_stream_event(c, conn, sid, st->body.substr(5, mlen), false);
    st->body.erase(0, 5 + (size_t)mlen);
  }
  return true;
}

// A stream finished uploading: route it.
void complete_stream(Ctx* c, Conn* conn, uint32_t sid, Stream* st) {
  if (st->responded) return;
  if (st->streaming) {
    // Half-close on a bidi stream: any complete frames were already
    // delivered on arrival; leftover bytes are a framing error.
    st->responded = true;
    if (!st->body.empty()) {
      write_response(conn, sid, 13, "bad grpc frame length");  // INTERNAL
      return;
    }
    deliver_stream_event(c, conn, sid, "", true);
    return;
  }
  st->responded = true;
  if (st->body.size() < 5 || st->body[0] != 0) {
    write_response(conn, sid, 12,
                   st->body.empty() ? "missing grpc frame"
                                    : "compression not supported");
    return;
  }
  uint32_t mlen = ((uint8_t)st->body[1] << 24) | ((uint8_t)st->body[2] << 16) |
                  ((uint8_t)st->body[3] << 8) | (uint8_t)st->body[4];
  if ((size_t)mlen + 5 != st->body.size()) {
    write_response(conn, sid, 13, "bad grpc frame length");  // INTERNAL
    return;
  }
  // Every well-framed unary request reaches the app; the pump routes the
  // hot target path into the columnar engine and everything else to its
  // registered Python handler (or UNIMPLEMENTED).
  uint64_t rid;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    rid = c->next_rid++;
    c->inflight.emplace(
        rid, InflightReq{conn->id, sid, st->body.substr(5),
                         std::move(st->path)});
    c->ready.push_back(rid);
  }
  c->stat_reqs++;
  c->cv.notify_all();
}

void on_headers_block(Ctx* c, Conn* conn, uint32_t sid, uint8_t flags,
                      const std::string& block) {
  std::vector<Header> headers;
  if (!hpack_decode(&conn->hpack, (const uint8_t*)block.data(), block.size(),
                    &headers)) {
    goaway(c, conn, 9);  // COMPRESSION_ERROR
    return;
  }
  Stream& st = conn->streams[sid];
  if (!st.headers_done) {
    st.headers_done = true;
    st.send_win = conn->initial_stream_win;
    for (auto& h : headers)
      if (h.name == ":path") st.path = h.value;
    st.streaming = !c->stream_path.empty() && st.path == c->stream_path;
  }
  // else: request trailers — decoded for HPACK consistency, nothing kept.
  if (flags & FL_END_STREAM) {
    st.end_stream = true;
    complete_stream(c, conn, sid, &st);
  }
}

void handle_frame(Ctx* c, Conn* conn, uint8_t type, uint8_t flags,
                  uint32_t sid, const uint8_t* p, size_t len) {
  if (conn->cont_stream != 0 && type != F_CONT) {
    goaway(c, conn, 1);  // PROTOCOL_ERROR: CONTINUATION interrupted
    return;
  }
  switch (type) {
    case F_SETTINGS: {
      if (flags & FL_ACK) return;
      if (len % 6) {
        goaway(c, conn, 6);  // FRAME_SIZE_ERROR
        return;
      }
      for (size_t i = 0; i + 6 <= len; i += 6) {
        uint16_t ident = (p[i] << 8) | p[i + 1];
        uint32_t value = ((uint32_t)p[i + 2] << 24) |
                         ((uint32_t)p[i + 3] << 16) |
                         ((uint32_t)p[i + 4] << 8) | p[i + 5];
        if (ident == 4) {  // INITIAL_WINDOW_SIZE: adjust open streams
          int64_t delta = (int64_t)value - conn->initial_stream_win;
          conn->initial_stream_win = value;
          for (auto& kv : conn->streams) kv.second.send_win += delta;
        } else if (ident == 5 && value >= 16384 && value <= 0xffffff) {
          conn->max_frame = value;  // MAX_FRAME_SIZE
        }
        // HEADER_TABLE_SIZE (1) would cap OUR encoder's dynamic table;
        // we never index, so nothing to do.
      }
      put_frame_header(&conn->wbuf, 0, F_SETTINGS, FL_ACK, 0);
      drain_parked(conn);
      break;
    }
    case F_PING: {
      if (len != 8) {
        goaway(c, conn, 6);
        return;
      }
      if (!(flags & FL_ACK)) {
        put_frame_header(&conn->wbuf, 8, F_PING, FL_ACK, 0);
        conn->wbuf.append((const char*)p, 8);
      }
      break;
    }
    case F_HEADERS: {
      if (sid == 0 || (sid % 2) == 0) {
        goaway(c, conn, 1);
        return;
      }
      size_t off = 0, tail = 0;
      if (flags & FL_PADDED) {
        if (len < 1) { goaway(c, conn, 1); return; }
        tail = p[0];
        off = 1;
      }
      if (flags & FL_PRIORITY) off += 5;
      if (off + tail > len) { goaway(c, conn, 1); return; }
      std::string block((const char*)p + off, len - off - tail);
      if (flags & FL_END_HEADERS) {
        on_headers_block(c, conn, sid, flags, block);
      } else {
        conn->cont_stream = sid;
        conn->cont_flags = flags;
        conn->cont_block = std::move(block);
      }
      break;
    }
    case F_CONT: {
      if (conn->cont_stream != sid) {
        goaway(c, conn, 1);
        return;
      }
      conn->cont_block.append((const char*)p, len);
      if (conn->cont_block.size() > MAX_HEADER_BLOCK) {
        goaway(c, conn, 11);  // ENHANCE_YOUR_CALM
        return;
      }
      if (flags & FL_END_HEADERS) {
        uint32_t s = conn->cont_stream;
        uint8_t f = conn->cont_flags;
        std::string block = std::move(conn->cont_block);
        conn->cont_stream = 0;
        conn->cont_block.clear();
        on_headers_block(c, conn, s, f, block);
      }
      break;
    }
    case F_DATA: {
      if (sid == 0) { goaway(c, conn, 1); return; }
      size_t off = 0, tail = 0;
      if (flags & FL_PADDED) {
        if (len < 1) { goaway(c, conn, 1); return; }
        tail = p[0];
        off = 1;
      }
      if (off + tail > len) { goaway(c, conn, 1); return; }
      auto it = conn->streams.find(sid);
      if (it != conn->streams.end() && !it->second.responded) {
        Stream& st = it->second;
        st.body.append((const char*)p + off, len - off - tail);
        if (st.body.size() > MAX_BODY) {
          goaway(c, conn, 11);
          return;
        }
        // Bidi-stream path: complete messages dispatch on ARRIVAL (the
        // client keeps the stream open awaiting answers — buffering to
        // END_STREAM would deadlock well-behaved reflection clients).
        // On a framing error pump_stream_msgs answers inline (which may
        // erase the stream — `st` is then dead); fall through so the
        // connection window refill below still runs.
        bool stream_ok = true;
        if (st.streaming) stream_ok = pump_stream_msgs(c, conn, sid, &st);
        if (stream_ok && (flags & FL_END_STREAM)) {
          st.end_stream = true;
          complete_stream(c, conn, sid, &st);
          // complete_stream can answer inline (unknown method, bad grpc
          // frame), and write_response erases the stream — `it` is dead.
        }
      }
      // Refill what the client spent, regardless of stream fate: the
      // connection window must never strand a busy client.
      if (len > 0) {
        put_frame_header(&conn->wbuf, 4, F_WINUPD, 0, 0);
        put_u32(&conn->wbuf, (uint32_t)len);
        if (!(flags & FL_END_STREAM) &&
            conn->streams.find(sid) != conn->streams.end()) {
          put_frame_header(&conn->wbuf, 4, F_WINUPD, 0, sid);
          put_u32(&conn->wbuf, (uint32_t)len);
        }
      }
      break;
    }
    case F_WINUPD: {
      if (len != 4) { goaway(c, conn, 6); return; }
      uint32_t inc = (((uint32_t)p[0] & 0x7f) << 24) |
                     ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
      if (sid == 0) {
        conn->send_win += inc;
      } else {
        auto it = conn->streams.find(sid);
        if (it != conn->streams.end()) it->second.send_win += inc;
      }
      drain_parked(conn);
      break;
    }
    case F_RST: {
      conn->streams.erase(sid);
      // A parked response for the stream is abandoned.
      for (auto it = conn->parked.begin(); it != conn->parked.end();) {
        if (it->stream == sid)
          it = conn->parked.erase(it);
        else
          ++it;
      }
      break;
    }
    case F_PRIORITY:
      break;  // advisory; ignored
    case F_GOAWAY:
      conn->dead = conn->streams.empty() && conn->wbuf.empty();
      break;
    case F_PUSH:
      goaway(c, conn, 1);  // clients must not push
      break;
    default:
      break;  // unknown frame types are ignored per RFC 7540 §4.1
  }
}

void on_readable(Ctx* c, Conn* conn) {
  char tmp[65536];
  for (;;) {
    ssize_t k = ::recv(conn->fd, tmp, sizeof(tmp), 0);
    if (k > 0) {
      conn->rbuf.append(tmp, (size_t)k);
      if (conn->rbuf.size() > (32 << 20)) {  // runaway peer
        conn->dead = true;
        return;
      }
    } else if (k == 0) {
      conn->dead = true;
      return;
    } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
      break;
    } else {
      conn->dead = true;
      return;
    }
  }
  if (!conn->preface_done) {
    if (conn->rbuf.size() < 24) return;
    if (memcmp(conn->rbuf.data(), PREFACE, 24) != 0) {
      conn->dead = true;
      return;
    }
    conn->rbuf.erase(0, 24);
    conn->preface_done = true;
    // Server preface: our SETTINGS.
    std::string f;
    put_frame_header(&f, 6, F_SETTINGS, 0, 0);
    f.push_back(0); f.push_back(3);       // MAX_CONCURRENT_STREAMS
    put_u32(&f, 4096);
    conn->wbuf += f;
  }
  while (!conn->dead && conn->rbuf.size() >= 9) {
    size_t len = ((uint8_t)conn->rbuf[0] << 16) |
                 ((uint8_t)conn->rbuf[1] << 8) | (uint8_t)conn->rbuf[2];
    if (len > MAX_FRAME) {
      goaway(c, conn, 6);
      return;
    }
    if (conn->rbuf.size() < 9 + len) break;
    uint8_t type = conn->rbuf[3];
    uint8_t flags = conn->rbuf[4];
    uint32_t sid = (((uint8_t)conn->rbuf[5] & 0x7f) << 24) |
                   ((uint8_t)conn->rbuf[6] << 16) |
                   ((uint8_t)conn->rbuf[7] << 8) | (uint8_t)conn->rbuf[8];
    handle_frame(c, conn, type, flags, sid,
                 (const uint8_t*)conn->rbuf.data() + 9, len);
    conn->rbuf.erase(0, 9 + len);
  }
  if (!conn->wbuf.empty()) flush_writes(c, conn);
}

void drain_responses(Ctx* c) {
  std::vector<Resp> batch;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    batch.swap(c->responses);
  }
  for (Resp& r : batch) {
    InflightReq req;
    {
      std::lock_guard<std::mutex> lk(c->mu);
      auto it = c->inflight.find(r.rid);
      if (it == c->inflight.end()) continue;
      req = std::move(it->second);
      c->inflight.erase(it);
    }
    auto cit = c->conns.find(req.conn_id);
    if (cit == c->conns.end()) continue;  // peer went away
    Conn* conn = cit->second;
    if (conn->dead) continue;
    if (req.streaming) {
      // status 0 = one response message (stream stays open);
      // status -1 = clean close; status >0 = error close.
      if (r.status == 0)
        write_stream_msg(conn, req.stream, r.payload);
      else
        write_stream_close(conn, req.stream,
                           r.status < 0 ? 0 : r.status, r.payload);
    } else {
      write_response(conn, req.stream, r.status, r.payload);
    }
    c->stat_resps++;
  }
  // Flush every conn we touched (cheap: flush all with pending bytes).
  std::vector<Conn*> dead;
  for (auto& kv : c->conns) {
    if (!kv.second->wbuf.empty()) flush_writes(c, kv.second);
    if (kv.second->dead) dead.push_back(kv.second);
  }
  for (Conn* d : dead) kill_conn(c, d);
}

void io_loop(Ctx* c) {
  epoll_event evs[256];
  // relaxed: stop is a pure shutdown latch polled once per epoll tick;
  // h2i_close joins this thread after setting it, and the join (not
  // the flag) is the synchronization point for teardown state
  while (!c->stop.load(std::memory_order_relaxed)) {
    int n = epoll_wait(c->epoll_fd, evs, 256, 100);
    for (int i = 0; i < n; i++) {
      uint64_t tag = evs[i].data.u64;
      if (tag == 0) {  // listen socket
        for (;;) {
          int fd = accept4(c->listen_fd, nullptr, nullptr,
                           SOCK_NONBLOCK | SOCK_CLOEXEC);
          if (fd < 0) break;
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          Conn* conn = new Conn();
          conn->fd = fd;
          conn->id = c->next_conn_id++;
          c->conns[conn->id] = conn;
          c->stat_conns++;
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.u64 = conn->id;
          epoll_ctl(c->epoll_fd, EPOLL_CTL_ADD, fd, &ev);
        }
      } else if (tag == 1) {  // wake eventfd: responses ready
        uint64_t v;
        while (read(c->wake_fd, &v, 8) == 8) {
        }
        drain_responses(c);
      } else {
        auto it = c->conns.find(tag);
        if (it == c->conns.end()) continue;
        Conn* conn = it->second;
        if (evs[i].events & (EPOLLHUP | EPOLLERR)) conn->dead = true;
        if (!conn->dead && (evs[i].events & EPOLLIN)) on_readable(c, conn);
        if (!conn->dead && (evs[i].events & EPOLLOUT)) flush_writes(c, conn);
        if (conn->dead) kill_conn(c, conn);
      }
    }
    // Periodic response drain in case the eventfd write raced epoll_wait.
    drain_responses(c);
  }
}

}  // namespace

extern "C" {

void* h2i_create(const char* host, int port, const char* target_path,
                 const char* stream_path) {
  Ctx* c = new Ctx();
  c->target_path = target_path;
  if (stream_path != nullptr) c->stream_path = stream_path;
  c->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
  if (c->listen_fd < 0) {
    delete c;
    return nullptr;
  }
  int one = 1;
  setsockopt(c->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1)
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
  if (bind(c->listen_fd, (sockaddr*)&addr, sizeof(addr)) < 0 ||
      listen(c->listen_fd, 1024) < 0) {
    ::close(c->listen_fd);
    delete c;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(c->listen_fd, (sockaddr*)&addr, &alen);
  c->port = ntohs(addr.sin_port);

  c->epoll_fd = epoll_create1(EPOLL_CLOEXEC);
  c->wake_fd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.u64 = 0;
  epoll_ctl(c->epoll_fd, EPOLL_CTL_ADD, c->listen_fd, &ev);
  ev.data.u64 = 1;
  epoll_ctl(c->epoll_fd, EPOLL_CTL_ADD, c->wake_fd, &ev);
  c->io = std::thread(io_loop, c);
  return c;
}

int h2i_port(void* vc) { return ((Ctx*)vc)->port; }

int h2i_take(void* vc, int max_n, int timeout_ms, uint64_t* ids,
             const uint8_t** ptrs, uint32_t* lens,
             const char** path_ptrs, uint32_t* path_lens) {
  Ctx* c = (Ctx*)vc;
  std::unique_lock<std::mutex> lk(c->mu);
  if (c->ready.empty()) {
    // wait_until(system_clock) instead of wait_for: libstdc++'s
    // wait_for lowers to pthread_cond_clockwait (CLOCK_MONOTONIC), which
    // ThreadSanitizer does not intercept — the sanitizer then models the
    // mutex as never released across the wait and every h2i critical
    // section cross-reports as a race. wait_until(system_clock) lowers to the
    // intercepted pthread_cond_timedwait. Cost: a wall-clock jump can
    // stretch/shrink one 10-100ms pump poll — the pump loops anyway.
    c->cv.wait_until(lk,
                     std::chrono::system_clock::now()
                         + std::chrono::milliseconds(timeout_ms),
                     [&] { return !c->ready.empty() || c->stop.load(); });
  }
  int n = 0;
  while (n < max_n && !c->ready.empty()) {
    uint64_t rid = c->ready.front();
    c->ready.pop_front();
    auto it = c->inflight.find(rid);
    if (it == c->inflight.end()) continue;
    ids[n] = rid;
    ptrs[n] = (const uint8_t*)it->second.payload.data();
    lens[n] = (uint32_t)it->second.payload.size();
    if (it->second.path == c->target_path) {
      path_ptrs[n] = nullptr;  // hot path: no string copy needed
      path_lens[n] = 0;
    } else {
      path_ptrs[n] = it->second.path.data();
      path_lens[n] = (uint32_t)it->second.path.size();
    }
    n++;
  }
  return n;
}

void h2i_respond(void* vc, int n, const uint64_t* ids, const int* statuses,
                 const uint8_t* const* payloads, const uint32_t* lens) {
  Ctx* c = (Ctx*)vc;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    for (int i = 0; i < n; i++) {
      c->responses.push_back(Resp{
          ids[i], statuses[i],
          std::string((const char*)payloads[i], lens[i])});
    }
  }
  uint64_t one = 1;
  ssize_t ignored = write(c->wake_fd, &one, 8);
  (void)ignored;
}

// Register the (grpc status, payload) template answered for outcome
// ``code`` by h2i_respond_coded. Codes are small ints (the hostpath hot
// lane's LANE_* values); call before serving traffic.
void h2i_set_code(void* vc, int code, int status, const uint8_t* payload,
                  uint32_t len) {
  Ctx* c = (Ctx*)vc;
  if (code < 0 || code >= 16) return;
  std::lock_guard<std::mutex> lk(c->mu);
  c->code_tmpls[code].set = true;
  c->code_tmpls[code].status = status;
  c->code_tmpls[code].payload.assign((const char*)payload, len);
}

// Batch-complete answers in ONE native call: every row whose code has a
// registered template is answered with it; negative / unregistered
// codes are skipped (answered elsewhere — the miss/slow lanes). This is
// the response half of the zero-Python hot lane: the pump hands the
// take-side id buffer and the hot lane's code column straight back.
void h2i_respond_coded(void* vc, int n, const uint64_t* ids,
                       const int8_t* codes) {
  Ctx* c = (Ctx*)vc;
  // relaxed: enable flag gates clock reads only; a respond straddling
  // a config flip measures (or skips) this one batch
  const int32_t tel = g_tel_enabled.load(std::memory_order_relaxed);
  const int64_t tel_t0 = tel ? tel_now_ns() : 0;
  int queued = 0;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    for (int i = 0; i < n; i++) {
      int code = codes[i];
      if (code < 0 || code >= 16 || !c->code_tmpls[code].set) continue;
      c->responses.push_back(Resp{
          ids[i], c->code_tmpls[code].status, c->code_tmpls[code].payload});
      queued++;
    }
  }
  if (tel) tel_observe(tel_now_ns() - tel_t0);
  if (queued == 0) return;
  uint64_t one = 1;
  ssize_t ignored = write(c->wake_fd, &one, 8);
  (void)ignored;
}

// ---- respond-path telemetry (the native telemetry plane) ------------------

void h2i_tel_config(int32_t enabled) {
  // relaxed: single self-contained flag, nothing published through it
  g_tel_enabled.store(enabled, std::memory_order_relaxed);
}

// Snapshot the cumulative respond histogram: [count, sum_ns,
// bucket_0 .. bucket_{H2I_TEL_BUCKETS-1}] (same log2-ns layout as
// hostpath.cc's hp_tel_drain, one phase). Writes min(cap, needed)
// int64s and returns the full layout size.
int32_t h2i_tel_drain(int64_t* out, int64_t cap) {
  const int64_t need = 2 + H2I_TEL_BUCKETS;
  int64_t idx = 0;
  // relaxed reads of monotone counters (see tel_observe's invariant):
  // a one-observation skew between count/sum/buckets self-corrects at
  // the next drain; snapshot consistency would need a lock the
  // wait-free respond path exists to avoid
  if (idx < cap)
    out[idx++] = (int64_t)g_tel_count.load(std::memory_order_relaxed);
  if (idx < cap)
    out[idx++] = (int64_t)g_tel_sum.load(std::memory_order_relaxed);
  for (int b = 0; b < H2I_TEL_BUCKETS && idx < cap; b++)
    out[idx++] = (int64_t)g_tel_buckets[b].load(std::memory_order_relaxed);
  return (int32_t)need;
}

// Opaque per-stream key for a taken item: (conn id << 32) | stream id,
// 0 when the rid is unknown (already answered / peer gone). Lets the
// app key per-stream state (answer-serialization locks) without the
// take path copying ids per item; valid between h2i_take and
// h2i_respond for that rid.
uint64_t h2i_stream_key(void* vc, uint64_t rid) {
  Ctx* c = (Ctx*)vc;
  std::lock_guard<std::mutex> lk(c->mu);
  auto it = c->inflight.find(rid);
  if (it == c->inflight.end()) return 0;
  return (it->second.conn_id << 32) | (uint64_t)it->second.stream;
}

uint64_t h2i_stat(void* vc, int what) {
  Ctx* c = (Ctx*)vc;
  switch (what) {
    case 0: return c->stat_conns.load();
    case 1: return c->stat_reqs.load();
    case 2: return c->stat_resps.load();
    case 3: return c->stat_proto_errors.load();
    default: return 0;
  }
}

// Test hooks: a standalone HPACK decoder whose dynamic table persists
// across blocks (the RFC 7541 Appendix C sequences exercise exactly
// that). Output is u32le length-prefixed fields (len+name, len+value,
// repeated); returns bytes written, -1 on decode error, -2 if out_cap
// is too small.
void* h2i_hpack_decoder_new() { return new HpackDecoder(); }

void h2i_hpack_decoder_free(void* d) { delete (HpackDecoder*)d; }

uint64_t h2i_hpack_dyn_size(void* d) {
  return ((HpackDecoder*)d)->dyn_size;
}

int h2i_hpack_decode_test(void* d, const uint8_t* block, uint32_t len,
                          uint8_t* out, uint32_t out_cap) {
  HpackDecoder* dec = (HpackDecoder*)d;
  std::vector<Header> headers;
  if (!hpack_decode(dec, block, len, &headers)) return -1;
  size_t off = 0;
  // Length-prefixed framing (u32le len + bytes per field): HPACK strings
  // are arbitrary octet strings, so a separator byte would be ambiguous.
  auto put = [&](const std::string& s) -> bool {
    if (off + 4 + s.size() > out_cap) return false;
    uint32_t n = (uint32_t)s.size();
    memcpy(out + off, &n, 4);
    off += 4;
    memcpy(out + off, s.data(), s.size());
    off += s.size();
    return true;
  };
  for (auto& h : headers) {
    if (!put(h.name) || !put(h.value)) return -2;
  }
  return (int)off;
}

void h2i_close(void* vc) {
  Ctx* c = (Ctx*)vc;
  c->stop.store(true);
  uint64_t one = 1;
  ssize_t ignored = write(c->wake_fd, &one, 8);
  (void)ignored;
  c->cv.notify_all();
  if (c->io.joinable()) c->io.join();
  for (auto& kv : c->conns) {
    ::close(kv.second->fd);
    delete kv.second;
  }
  ::close(c->listen_fd);
  ::close(c->epoll_fd);
  ::close(c->wake_fd);
  delete c;
}

}  // extern "C"
