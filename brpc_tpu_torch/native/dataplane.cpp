// dataplane — the native transport core (SURVEY §7: "C++ ... must be native
// to hit latency targets"; reference socket.cpp / event_dispatcher_epoll.cpp
// / input_messenger.cpp are the blueprint, re-designed for a hybrid
// C++-engine + Python-policy stack).
//
// What runs here, GIL-free, on dedicated event-loop threads:
//   - epoll event loops (reference EventDispatcher::Run,
//     event_dispatcher_epoll.cpp:196-206), one epoll per loop thread,
//     connections spread round-robin (event_dispatcher_num analog)
//   - nonblocking sockets with claimed-writer inline send + queued drain on
//     EPOLLOUT (reference Socket::StartWrite/KeepWrite, socket.cpp:1692)
//   - TRPC/TSTR frame cutting straight off the read buffer (reference
//     InputMessenger::CutInputMessage, input_messenger.cpp:84)
//   - native services: registered (service, method) pairs answered entirely
//     in C++ (the reference's user code IS C++; echo is the built-in one)
//   - a minimal protobuf wire reader/writer for RpcMeta — just the fields
//     the fast path needs (proto/rpc_meta.proto layout)
//
// Everything else — protocol policy, retries, auth, limiters, user Python
// services — stays in Python: complete frames are handed up through a
// poll()-based event queue (one malloc per message, batch retrieval), and
// Python hands packed response/request packets back through dp_send.
// Connections that speak anything other than the TRPC frame family are
// DETACHED: removed from the native epoll and surfaced with their fd and
// buffered bytes so the Python stack (http dashboard, grpc, redis ...)
// takes over that connection transparently.
//
// No dependencies beyond libc/pthread. C ABI only (ctypes loads it).
//
// The port's copy of the JAX package's native/dataplane.cpp. It differs in
// three places: the TPUC tunnel frames to the handshake version its peer
// advertises (v1 engines, or the Python lane's v2 epoch word in DATA/ACK
// bodies); a tunnel pool's name is unlinked once the peer has mapped it,
// so an exit without closing leaves no /dev/shm segment; and the h2
// parser bounds what a peer can make it hold or read (header blocks, the
// pre-HEADERS prelude, concurrent streams, name lengths, window and table
// sizes, grpc-timeout, HPACK padding).

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <stdio.h>
#include <time.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <string>
#include <random>
#include <thread>
#include <unordered_map>
#include <vector>

#include "hpack_tables.h"  // RFC 7541 data, generated from policy/hpack.py

namespace {

// ---------------------------------------------------------------- constants
constexpr uint32_t kHeaderSize = 12;
constexpr uint64_t kDefaultMaxBody = 512ull << 20;
constexpr uint64_t kWriteQueueMax = 64ull << 20;   // EOVERCROWDED beyond
constexpr uint64_t kEventQueueMaxBytes = 512ull << 20;
constexpr size_t kReadChunk = 256 * 1024;

// TPUC tunnel framing (brpc_tpu_torch/tpu/transport.py wire format — the
// RDMA-endpoint analog: shm block pools + credit window over a TCP
// bootstrap; this engine speaks it natively for the zero-kernel-copy
// payload path)
constexpr uint32_t kTpuHdrSize = 9;  // "TPUC" + u8 type + u32 len (BE)
enum { TFT_HELLO = 1, TFT_HELLO_ACK = 2, TFT_DATA = 3, TFT_ACK = 4,
       TFT_BYE = 5 };
constexpr uint32_t kTpuInlineMax = 16 << 10;
constexpr uint32_t kTpuBlockSize = 256 << 10;
constexpr uint32_t kTpuBlockCount = 64;   // 16 MB window per direction
constexpr int kTpuMaxSegs = 32;
// Handshake version this engine advertises. v2 (the Python lane's
// tpu/transport.py since its window generations) puts a 4-byte epoch word
// first in every DATA and ACK body and a "gen" in HELLO/HELLO_ACK; v1
// peers (an engine built before v2) frame without it. The engine frames
// to what the PEER advertised, so it talks to both; it never advertises
// v3 (the Python lane's priority frames and coalesced doorbells).
constexpr int kTpuHandshakeVersion = 2;
constexpr uint32_t kTpuDialGen = 1;  // a native dial's window generation

// event kinds (Python mirror in rpc/native_transport.py)
enum {
  EV_FRAME = 1,     // tag: 0 TRPC / 1 TSTR; meta+body buffers
  EV_FAILED = 2,    // tag: error class; meta: reason text
  EV_ACCEPTED = 3,  // aux: listener id; meta: "host:port" of peer
  EV_DETACHED = 4,  // aux: fd (now owned by consumer); meta: buffered bytes
  // fast-path events: the engine already parsed RpcMeta — Python never
  // touches protobuf on these (reference keeps ProcessRpcRequest native,
  // baidu_rpc_protocol.cpp:565; this is our analog for Python services)
  EV_REQUEST = 5,   // aux: cid; meta: ReqLite+svc+method; body: payload+att
  EV_RESPONSE = 6,  // aux: cid; tag: error_code; meta: RespLite+error_text
  // zero-copy tunnel response: the payload stays in the registered pool
  // blocks (reference rdma zero-copy recv: blocks attach straight to the
  // IOBuf, block_pool.cpp). meta: RespLite + u32 nsegs + nsegs*(u64 ptr,
  // u64 len) + u32 ack_len + ack body; the consumer reads the segments,
  // then MUST dp_tpu_ack the ack blob to return the peer's credits.
  EV_RESPONSE_ZC = 7,
};

// packed structs riding EV_REQUEST / EV_RESPONSE meta buffers (same-machine
// host endianness; Python reads them with struct.unpack_from)
struct ReqLite {
  uint64_t cid;
  uint64_t attempt;
  uint64_t att_size;
  int64_t log_id;
  int64_t trace_id;   // sampled traces ride the fast path end to end
  int64_t span_id;
  int32_t timeout_ms;
  uint16_t svc_len;
  uint16_t meth_len;
};
struct RespLite {
  uint64_t attempt;
  uint64_t att_size;
};

// frames at/above this take the zero-copy donation path (EV_FRAME with the
// whole read buffer) instead of the parsed fast path — the pb meta parse is
// noise at that size and the memcpy is not
constexpr uint64_t kFastFrameMax = 64 << 10;

// error classes for EV_FAILED.tag / dp_send return (Python maps to errors.py)
enum {
  DPE_OK = 0,
  DPE_EOF = 1,         // clean close by peer
  DPE_IO = 2,          // errno-style failure
  DPE_PROTOCOL = 3,    // bad frame
  DPE_OVERCROWDED = 4, // write queue limit
  DPE_NOTFOUND = 5,    // unknown conn id
  DPE_TIMEDOUT = 6,    // dp_call_sync deadline exceeded
};

struct DpEvent {
  int32_t kind;
  int32_t tag;
  uint64_t conn_id;
  int64_t aux;
  void* base;  // single free() handle for meta+body
  void* meta;
  uint64_t meta_len;
  void* body;
  uint64_t body_len;
};

// ------------------------------------------------------------ pb wire codec
// Minimal protobuf reader for RpcMeta / RequestMeta (proto/rpc_meta.proto).
bool pb_varint(const uint8_t*& p, const uint8_t* end, uint64_t* v) {
  uint64_t r = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    r |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *v = r;
      return true;
    }
    shift += 7;
  }
  return false;
}

bool pb_skip(const uint8_t*& p, const uint8_t* end, uint32_t wire_type) {
  uint64_t tmp;
  switch (wire_type) {
    case 0:
      return pb_varint(p, end, &tmp);
    case 1:
      if (end - p < 8) return false;
      p += 8;
      return true;
    case 2:
      if (!pb_varint(p, end, &tmp) || uint64_t(end - p) < tmp) return false;
      p += tmp;
      return true;
    case 5:
      if (end - p < 4) return false;
      p += 4;
      return true;
    default:
      return false;
  }
}

void pb_put_varint(std::string* out, uint64_t v) {
  while (v >= 0x80) {
    out->push_back(char(v | 0x80));
    v >>= 7;
  }
  out->push_back(char(v));
}

void pb_put_tag(std::string* out, uint32_t field, uint32_t wt) {
  pb_put_varint(out, (field << 3) | wt);
}

// Parsed just-enough RpcMeta for routing + the native fast path.
struct MetaLite {
  bool has_request = false;
  bool has_response = false;
  bool has_stream_settings = false;
  bool has_auth = false;
  uint64_t correlation_id = 0;
  uint64_t attempt_version = 0;
  uint64_t compress_type = 0;
  uint64_t attachment_size = 0;
  uint64_t checksum = 0;
  int64_t log_id = 0;
  int64_t trace_id = 0;
  int64_t span_id = 0;
  int64_t timeout_ms = 0;
  int64_t resp_error_code = 0;
  std::string resp_error_text;
  std::string service;
  std::string method;
};

bool parse_request_meta(const uint8_t* p, const uint8_t* end, MetaLite* m) {
  while (p < end) {
    uint64_t key;
    if (!pb_varint(p, end, &key)) return false;
    uint32_t field = key >> 3, wt = key & 7;
    if (field == 1 && wt == 2) {
      uint64_t len;
      if (!pb_varint(p, end, &len) || uint64_t(end - p) < len) return false;
      m->service.assign(reinterpret_cast<const char*>(p), len);
      p += len;
    } else if (field == 2 && wt == 2) {
      uint64_t len;
      if (!pb_varint(p, end, &len) || uint64_t(end - p) < len) return false;
      m->method.assign(reinterpret_cast<const char*>(p), len);
      p += len;
    } else if (field == 3 && wt == 0) {
      uint64_t v;
      if (!pb_varint(p, end, &v)) return false;
      m->log_id = int64_t(v);
    } else if ((field == 4 || field == 5) && wt == 0) {
      uint64_t v;
      if (!pb_varint(p, end, &v)) return false;
      // traces ride the fast path: ReqLite carries the ids end to end
      if (field == 4) m->trace_id = int64_t(v);
      else m->span_id = int64_t(v);
    } else if (field == 7 && wt == 0) {
      uint64_t v;
      if (!pb_varint(p, end, &v)) return false;
      m->timeout_ms = int64_t(v);
    } else if (!pb_skip(p, end, wt)) {
      return false;
    }
  }
  return true;
}

bool parse_response_meta(const uint8_t* p, const uint8_t* end, MetaLite* m) {
  while (p < end) {
    uint64_t key;
    if (!pb_varint(p, end, &key)) return false;
    uint32_t field = key >> 3, wt = key & 7;
    if (field == 1 && wt == 0) {
      uint64_t v;
      if (!pb_varint(p, end, &v)) return false;
      // int32 on the wire: negatives arrive as 10-byte varints
      m->resp_error_code = int64_t(int32_t(uint32_t(v)));
    } else if (field == 2 && wt == 2) {
      uint64_t len;
      if (!pb_varint(p, end, &len) || uint64_t(end - p) < len) return false;
      m->resp_error_text.assign(reinterpret_cast<const char*>(p), len);
      p += len;
    } else if (!pb_skip(p, end, wt)) {
      return false;
    }
  }
  return true;
}

bool parse_meta_lite(const uint8_t* p, const uint8_t* end, MetaLite* m) {
  while (p < end) {
    uint64_t key;
    if (!pb_varint(p, end, &key)) return false;
    uint32_t field = key >> 3, wt = key & 7;
    uint64_t v;
    switch (field) {
      case 1:  // RequestMeta
        if (wt != 2) return false;
        if (!pb_varint(p, end, &v) || uint64_t(end - p) < v) return false;
        m->has_request = true;
        if (!parse_request_meta(p, p + v, m)) return false;
        p += v;
        break;
      case 2:  // ResponseMeta
        if (wt != 2) return false;
        if (!pb_varint(p, end, &v) || uint64_t(end - p) < v) return false;
        m->has_response = true;
        if (!parse_response_meta(p, p + v, m)) return false;
        p += v;
        break;
      case 3:
        if (!pb_varint(p, end, &m->correlation_id)) return false;
        break;
      case 4:
        if (!pb_varint(p, end, &m->attempt_version)) return false;
        break;
      case 5:
        if (!pb_varint(p, end, &m->compress_type)) return false;
        break;
      case 6:
        if (!pb_varint(p, end, &m->attachment_size)) return false;
        break;
      case 7:
        if (!pb_varint(p, end, &m->checksum)) return false;
        break;
      case 8:
        m->has_stream_settings = true;
        if (!pb_skip(p, end, wt)) return false;
        break;
      case 9:
        m->has_auth = true;
        if (!pb_skip(p, end, wt)) return false;
        break;
      default:
        if (!pb_skip(p, end, wt)) return false;
    }
  }
  return true;
}

// RpcMeta for a native fast-path response:
//   response{} (empty = OK), correlation_id, attempt_version,
//   attachment_size — mirroring server_processing._send_response.
std::string build_echo_response_meta(const MetaLite& req) {
  std::string meta;
  pb_put_tag(&meta, 2, 2);  // response submessage, present-but-empty = OK
  pb_put_varint(&meta, 0);
  if (req.correlation_id) {
    pb_put_tag(&meta, 3, 0);
    pb_put_varint(&meta, req.correlation_id);
  }
  if (req.attempt_version) {
    pb_put_tag(&meta, 4, 0);
    pb_put_varint(&meta, req.attempt_version);
  }
  if (req.attachment_size) {
    pb_put_tag(&meta, 6, 0);
    pb_put_varint(&meta, req.attachment_size);
  }
  return meta;
}

// General response RpcMeta for dp_respond (server_processing._send_response
// kept native): response{error_code,error_text}, cid, attempt, att_size.
std::string build_response_meta(uint64_t cid, uint64_t attempt,
                                int32_t error_code, const char* etext,
                                uint64_t etext_len, uint64_t att_size,
                                int32_t compress_type = 0) {
  std::string resp;
  if (error_code) {
    pb_put_tag(&resp, 1, 0);
    pb_put_varint(&resp, uint64_t(uint32_t(error_code)));
  }
  if (etext_len) {
    pb_put_tag(&resp, 2, 2);
    pb_put_varint(&resp, etext_len);
    resp.append(etext, etext_len);
  }
  std::string meta;
  pb_put_tag(&meta, 2, 2);
  pb_put_varint(&meta, resp.size());
  meta.append(resp);
  if (cid) {
    pb_put_tag(&meta, 3, 0);
    pb_put_varint(&meta, cid);
  }
  if (attempt) {
    pb_put_tag(&meta, 4, 0);
    pb_put_varint(&meta, attempt);
  }
  if (compress_type) {
    pb_put_tag(&meta, 5, 0);
    pb_put_varint(&meta, uint64_t(uint32_t(compress_type)));
  }
  if (att_size) {
    pb_put_tag(&meta, 6, 0);
    pb_put_varint(&meta, att_size);
  }
  return meta;
}

// Request RpcMeta for dp_call (Controller._issue_rpc's meta kept native).
std::string build_request_meta(const char* svc, uint64_t svc_len,
                               const char* meth, uint64_t meth_len,
                               uint64_t cid, uint64_t attempt,
                               int64_t log_id, int64_t trace_id,
                               int64_t span_id, int32_t timeout_ms,
                               uint64_t att_size) {
  std::string rm;
  pb_put_tag(&rm, 1, 2);
  pb_put_varint(&rm, svc_len);
  rm.append(svc, svc_len);
  pb_put_tag(&rm, 2, 2);
  pb_put_varint(&rm, meth_len);
  rm.append(meth, meth_len);
  if (log_id) {
    pb_put_tag(&rm, 3, 0);
    pb_put_varint(&rm, uint64_t(log_id));
  }
  if (trace_id) {
    pb_put_tag(&rm, 4, 0);
    pb_put_varint(&rm, uint64_t(trace_id));
  }
  if (span_id) {
    pb_put_tag(&rm, 5, 0);
    pb_put_varint(&rm, uint64_t(span_id));
  }
  if (timeout_ms) {
    pb_put_tag(&rm, 7, 0);
    pb_put_varint(&rm, uint64_t(uint32_t(timeout_ms)));
  }
  std::string meta;
  pb_put_tag(&meta, 1, 2);
  pb_put_varint(&meta, rm.size());
  meta.append(rm);
  if (cid) {
    pb_put_tag(&meta, 3, 0);
    pb_put_varint(&meta, cid);
  }
  if (attempt) {
    pb_put_tag(&meta, 4, 0);
    pb_put_varint(&meta, attempt);
  }
  if (att_size) {
    pb_put_tag(&meta, 6, 0);
    pb_put_varint(&meta, att_size);
  }
  return meta;
}

// 12-byte TRPC header in front of a meta+body packet.
void put_trpc_header(std::string* out, uint64_t meta_size,
                     uint64_t body_size) {
  out->append("TRPC", 4);
  uint32_t ms = htonl(uint32_t(meta_size));
  uint32_t bs = htonl(uint32_t(body_size));
  out->append(reinterpret_cast<char*>(&ms), 4);
  out->append(reinterpret_cast<char*>(&bs), 4);
}

// --------------------------------------------------------------- data types
struct Runtime;

struct RBuf {
  uint8_t* data = nullptr;
  size_t cap = 0;
  size_t size = 0;
  ~RBuf() { free(data); }
  uint8_t* tail(size_t need) {
    if (size + need > cap) {
      size_t ncap = cap ? cap * 2 : (64 << 10);
      while (ncap < size + need) ncap *= 2;
      data = static_cast<uint8_t*>(realloc(data, ncap));
      cap = ncap;
    }
    return data + size;
  }
  // grow once to `total` — doubling reallocs memcpy an MB-scale frame
  // several times over on the shared core
  void reserve(size_t total) {
    if (total > cap) {
      data = static_cast<uint8_t*>(realloc(data, total));
      cap = total;
    }
  }
};

// Tunnel state for a TPUC conn (reference RdmaEndpoint: registered block
// pool, credit window, bootstrap handshake — rdma_endpoint.cpp:127-130,
// block_pool.cpp, rdma_endpoint.h:256-261).
struct TpuState {
  // our receive pool: WE create it, the PEER writes into it
  std::string pool_name;
  uint8_t* pool = nullptr;
  size_t pool_len = 0;
  uint32_t bs = kTpuBlockSize, bc = kTpuBlockCount;
  bool pool_owner = false;
  // the pool's name is unlinked once the peer has mapped it (the mapping
  // outlives the name), so a process that exits without closing its
  // tunnels leaves nothing behind in /dev/shm
  std::atomic<bool> pool_unlinked{false};
  // the peer's pool: we write request/response bytes into it
  uint8_t* peer = nullptr;
  size_t peer_len = 0;
  uint32_t peer_bs = 0, peer_bc = 0;
  bool inline_only = false;  // cross-host fallback (pool not attachable)
  // negotiated at the handshake, before the tunnel is published ready:
  // the peer's advertised version and the window generation (epoch word
  // of every DATA/ACK body when peer_v >= 2)
  int peer_v = 1;
  uint32_t epoch = 0;
  std::vector<uint8_t> inflight;  // per-block: handed out, not yet ACKed
  // sender-side credit window over the peer's blocks
  std::mutex cmu;
  std::condition_variable ccv;
  std::deque<uint32_t> credits;
  bool closed = false;
  // tunnel senders serialize (frame order IS stream order)
  std::mutex smu;
  // handshake rendezvous (dp_connect_tpu blocks here)
  std::mutex hmu;
  std::condition_variable hcv;
  bool ready = false;
  std::string err;
  int ordinal = 0;
  // native-service responses NEVER send from the loop thread (it must stay
  // free to process the credit ACKs); one per-conn sender worker drains
  // this queue in order
  struct Resp {
    std::string head;
    uint8_t* base = nullptr;     // free() after send (stolen stream buffer)
    const uint8_t* body = nullptr;
    uint64_t blen = 0;
    // zero-copy echo: body segments referencing OUR pool blocks; `ack`
    // (the TFT_ACK body returning those blocks) is sent AFTER the
    // response bytes leave — the peer must not reuse them mid-read
    std::vector<std::pair<const uint8_t*, uint64_t>> segs;
    std::string ack;
  };
  std::mutex qmu;
  std::condition_variable qcv;
  std::deque<Resp> respq;
  bool sender_running = false;
  bool q_closed = false;  // closed-mirror guarded by qmu (wakeup safety)

  ~TpuState() {
    if (pool) munmap(pool, pool_len);
    if (peer) munmap(peer, peer_len);
    unlink_pool();
  }

  void unlink_pool() {
    if (pool_owner && !pool_name.empty() && !pool_unlinked.exchange(true)) {
      shm_unlink(("/" + pool_name).c_str());
    }
  }
};

// ------------------------------------------------------------------ HTTP/2
// Native h2c + gRPC data plane (VERDICT r4 #5; reference
// policy/http2_rpc_protocol.cpp + details/hpack.cpp, re-designed for the
// hybrid engine). The engine owns h2 FRAMING, HPACK and flow control;
// grpc unary requests ride the same EV_REQUEST fast path / native-echo
// registry as the std protocol. A server conn whose FIRST request is not
// application/grpc is detached with its raw bytes (from the preface)
// replayed, and the Python h2 stack takes over — dashboard-over-h2 and
// exotic h2 stay at Python speed, grpc runs at engine speed.
constexpr uint8_t H2F_DATA = 0x0, H2F_HEADERS = 0x1, H2F_RST = 0x3,
    H2F_SETTINGS = 0x4, H2F_PING = 0x6, H2F_GOAWAY = 0x7,
    H2F_WINUP = 0x8, H2F_CONT = 0x9;
constexpr uint8_t H2FL_END_STREAM = 0x1, H2FL_ACK = 0x1,
    H2FL_END_HEADERS = 0x4, H2FL_PADDED = 0x8, H2FL_PRIORITY = 0x20;
constexpr uint32_t kH2RecvWindow = 1u << 30;  // our advertised window
constexpr uint32_t kH2MaxFrame = 1u << 20;    // our SETTINGS_MAX_FRAME_SIZE
constexpr uint32_t kH2MaxStreams = 1024;      // our MAX_CONCURRENT_STREAMS
// a peer's header block (HEADERS + CONTINUATIONs) and the control frames
// it sends before its first HEADERS are held in memory until complete:
// both are capped, and past the cap the connection fails
constexpr size_t kH2MaxHeaderBlock = 256u << 10;
constexpr size_t kH2MaxPrelude = 64u << 10;
// SETTINGS_HEADER_TABLE_SIZE: never advertised, so the RFC 7541 default
constexpr uint64_t kH2HeaderTableSize = 4096;
constexpr uint32_t kH2ErrFlowControl = 0x3, kH2ErrRefusedStream = 0x7;
static const char kH2Preface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
constexpr size_t kH2PrefaceLen = 24;

const std::unordered_map<uint64_t, int>& huff_decode_map() {
  static const std::unordered_map<uint64_t, int>* m = [] {
    auto* t = new std::unordered_map<uint64_t, int>();
    for (int i = 0; i < 257; i++) {
      (*t)[(uint64_t(kHuffCodes[i].bits) << 32) | kHuffCodes[i].code] = i;
    }
    return t;
  }();
  return *m;
}

bool huff_decode(const uint8_t* p, size_t len, std::string* out) {
  const auto& m = huff_decode_map();
  uint32_t code = 0;
  int bits = 0;
  for (size_t i = 0; i < len; i++) {
    for (int b = 7; b >= 0; b--) {
      code = (code << 1) | ((p[i] >> b) & 1);
      bits++;
      auto it = m.find((uint64_t(bits) << 32) | code);
      if (it != m.end()) {
        if (it->second == 256) return false;  // EOS inside a string
        out->push_back(char(it->second));
        code = 0;
        bits = 0;
      } else if (bits > 30) {
        return false;
      }
    }
  }
  // trailing padding must be an all-ones EOS prefix of at most 7 bits
  // (RFC 7541 §5.2: longer padding is a decoding error)
  return bits == 0 || (bits < 8 && code == (1u << bits) - 1);
}

bool hp_read_int(const uint8_t* p, size_t len, size_t* pos, int prefix,
                 uint64_t* out) {
  if (*pos >= len) return false;
  uint64_t max_pfx = (1u << prefix) - 1;
  uint64_t v = p[(*pos)++] & max_pfx;
  if (v < max_pfx) {
    *out = v;
    return true;
  }
  int shift = 0;
  for (;;) {
    if (*pos >= len || shift > 56) return false;
    uint8_t b = p[(*pos)++];
    v += uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  *out = v;
  return true;
}

bool hp_read_str(const uint8_t* p, size_t len, size_t* pos,
                 std::string* out) {
  if (*pos >= len) return false;
  bool huff = (p[*pos] & 0x80) != 0;
  uint64_t n;
  if (!hp_read_int(p, len, pos, 7, &n)) return false;
  if (n > len - *pos || n > (64u << 20)) return false;
  if (huff) {
    if (!huff_decode(p + *pos, size_t(n), out)) return false;
  } else {
    out->assign(reinterpret_cast<const char*>(p + *pos), size_t(n));
  }
  *pos += size_t(n);
  return true;
}

using HdrList = std::vector<std::pair<std::string, std::string>>;

struct HpackDec {
  std::deque<std::pair<std::string, std::string>> dyn;  // front = newest
  size_t dyn_bytes = 0;
  size_t max_bytes = 4096;

  void evict() {
    while (dyn_bytes > max_bytes && !dyn.empty()) {
      dyn_bytes -= dyn.back().first.size() + dyn.back().second.size() + 32;
      dyn.pop_back();
    }
  }
  void add(const std::string& n, const std::string& v) {
    dyn.emplace_front(n, v);
    dyn_bytes += n.size() + v.size() + 32;
    evict();
  }
  bool get(uint64_t idx, std::string* n, std::string* v) const {
    if (idx >= 1 && idx <= 61) {
      *n = kHpackStatic[idx - 1].name;
      *v = kHpackStatic[idx - 1].value;
      return true;
    }
    uint64_t di = idx - 62;
    if (di >= dyn.size()) return false;
    *n = dyn[size_t(di)].first;
    *v = dyn[size_t(di)].second;
    return true;
  }
};

bool hpack_decode_block(HpackDec* d, const uint8_t* p, size_t len,
                        HdrList* out) {
  size_t pos = 0;
  while (pos < len) {
    uint8_t b = p[pos];
    if (b & 0x80) {  // indexed field
      uint64_t idx;
      if (!hp_read_int(p, len, &pos, 7, &idx) || idx == 0) return false;
      std::string n, v;
      if (!d->get(idx, &n, &v)) return false;
      out->emplace_back(std::move(n), std::move(v));
    } else if ((b & 0xc0) == 0x40) {  // literal + incremental indexing
      uint64_t idx;
      if (!hp_read_int(p, len, &pos, 6, &idx)) return false;
      std::string n, v, ign;
      if (idx) {
        if (!d->get(idx, &n, &ign)) return false;
      } else if (!hp_read_str(p, len, &pos, &n)) {
        return false;
      }
      if (!hp_read_str(p, len, &pos, &v)) return false;
      d->add(n, v);
      out->emplace_back(std::move(n), std::move(v));
    } else if ((b & 0xe0) == 0x20) {  // dynamic table size update
      uint64_t sz;
      if (!hp_read_int(p, len, &pos, 5, &sz)) return false;
      // RFC 7541 §6.3: at most the advertised SETTINGS_HEADER_TABLE_SIZE
      if (sz > kH2HeaderTableSize) return false;
      d->max_bytes = size_t(sz);
      d->evict();
    } else {  // literal without indexing / never-indexed (prefix 4)
      uint64_t idx;
      if (!hp_read_int(p, len, &pos, 4, &idx)) return false;
      std::string n, v, ign;
      if (idx) {
        if (!d->get(idx, &n, &ign)) return false;
      } else if (!hp_read_str(p, len, &pos, &n)) {
        return false;
      }
      if (!hp_read_str(p, len, &pos, &v)) return false;
      out->emplace_back(std::move(n), std::move(v));
    }
  }
  return true;
}

// HPACK encoding — static-table-only (stateless: no dynamic-table sync)
void hp_put_int(std::string* o, uint64_t v, int prefix, uint8_t first) {
  uint64_t max_pfx = (1u << prefix) - 1;
  if (v < max_pfx) {
    o->push_back(char(first | v));
    return;
  }
  o->push_back(char(first | max_pfx));
  v -= max_pfx;
  while (v >= 128) {
    o->push_back(char(0x80 | (v & 0x7f)));
    v >>= 7;
  }
  o->push_back(char(v));
}

void hp_put_str(std::string* o, const char* s, size_t n) {
  hp_put_int(o, n, 7, 0x00);  // raw (no huffman) is always valid
  o->append(s, n);
}

void hp_put_indexed(std::string* o, int idx) { hp_put_int(o, idx, 7, 0x80); }

// literal without indexing; name_idx > 0 names via the static table
void hp_put_literal(std::string* o, int name_idx, const char* name,
                    const char* value, size_t value_len) {
  if (name_idx > 0) {
    hp_put_int(o, uint64_t(name_idx), 4, 0x00);
  } else {
    o->push_back(0x00);
    hp_put_str(o, name, strlen(name));
  }
  hp_put_str(o, value, value_len);
}

void h2_frame_hdr(std::string* o, uint32_t len, uint8_t type,
                  uint8_t flags, uint32_t sid) {
  o->push_back(char((len >> 16) & 0xff));
  o->push_back(char((len >> 8) & 0xff));
  o->push_back(char(len & 0xff));
  o->push_back(char(type));
  o->push_back(char(flags));
  uint32_t s = htonl(sid & 0x7fffffffu);
  o->append(reinterpret_cast<const char*>(&s), 4);
}

// reference grpc.cpp ErrorCodeToGrpcStatus / mirror of
// policy/grpc_protocol.py BRPC_TO_GRPC (errors.py numeric codes)
int grpc_status_of(int code) {
  switch (code) {
    case 0: return 0;
    case 1001: case 1002: return 12;   // UNIMPLEMENTED
    case 1003: return 3;               // INVALID_ARGUMENT
    case 1008: return 4;               // DEADLINE_EXCEEDED
    case 1012: case 2004: return 8;    // RESOURCE_EXHAUSTED
    case 1009: case 1010: case 1011: return 14;  // UNAVAILABLE
    case 2003: return 16;              // UNAUTHENTICATED
    case 1015: return 1;               // CANCELLED
    default: return 13;                // INTERNAL
  }
}

int brpc_code_of_grpc(int g) {
  switch (g) {
    case 0: return 0;
    case 1: return 1015;
    case 3: return 1003;
    case 4: return 1008;
    case 5: case 12: return 1002;
    case 8: return 1012;
    case 14: return 1010;
    case 16: return 2003;
    default: return 2001;
  }
}

int parse_grpc_timeout(const std::string& v) {  // -> ms (0 = none)
  if (v.empty()) return 0;
  char unit = v.back();
  // RFC: at most 8 ASCII digits — also the overflow guard (an attacker-
  // controlled value must not wrap into a negative/instant deadline)
  if (v.size() > 9) return 0;
  long long n = atoll(v.substr(0, v.size() - 1).c_str());
  if (n < 0) return 0;
  long long ms;
  switch (unit) {
    case 'H': ms = n * 3600000; break;
    case 'M': ms = n * 60000; break;
    case 'S': ms = n * 1000; break;
    case 'm': ms = n; break;
    case 'u': ms = (n + 999) / 1000; break;
    case 'n': ms = (n + 999999) / 1000000; break;
    default: return 0;
  }
  // a deadline the client sent stays a deadline: sub-millisecond (and
  // zero) budgets round up to 1 ms, never down to "none"
  if (ms < 1) ms = 1;
  if (ms > 0x7fffffff) ms = 0x7fffffff;
  return int(ms);
}

struct H2Stream {
  HdrList headers;
  bool headers_done = false;
  std::string data;        // inbound DATA accumulation (grpc-framed)
  // outbound flow control (bytes not yet emitted)
  int64_t send_window = 65535;
  std::string out;         // grpc-framed payload awaiting window
  size_t out_off = 0;
  std::string trailers;    // server: trailers frame to send after out
  bool end_after_out = false;  // client: END_STREAM on the last DATA
  bool sent_all = false;
  uint64_t cid = 0;        // client: correlation id
};

struct H2State {
  std::mutex mu;  // streams + windows + send state (parse loop + senders)
  bool client = false;
  int phase = 0;  // server: 0 preface, 1 sniffing, 2 engine-owned
  std::string prelude;      // raw bytes kept for a possible detach
  std::string pending_ctrl; // pre-decision replies (pongs), sent at engage
  int unacked_settings = 0;
  HpackDec dec;
  std::unordered_map<uint32_t, H2Stream> streams;
  int64_t conn_send_window = 65535;
  uint32_t peer_initial_window = 65535;
  uint32_t peer_max_frame = 16384;
  uint64_t recv_since_update = 0;
  uint32_t cont_sid = 0;    // CONTINUATION reassembly
  uint8_t cont_flags = 0;
  std::string cont_buf;
  uint32_t next_stream_id = 1;  // client request sids (odd)
  std::string authority;        // client: host:port for :authority
};

struct Conn {
  int listener_id = -1;
  uint64_t id = 0;
  int fd = -1;
  int loop = 0;
  bool is_server = false;
  std::atomic<bool> failed{false};
  bool detached = false;
  // parsed fast-path events enabled (server conns: copied from the
  // listener at accept; client conns: dp_conn_set_fastpath)
  std::atomic<bool> py_fast{false};

  // queued dp_respond/dp_call packets awaiting dp_flush_all (one writev
  // per poll batch instead of one per RPC — single-core syscalls are the
  // hybrid lane's wall clock)
  std::mutex pmu;
  std::string pending;
  int pending_msgs = 0;

  // TPUC tunnel: 0 = plain TCP conn; 1 = negotiating; 2 = ready
  int tpu_mode = 0;
  std::unique_ptr<TpuState> tpu;
  // HTTP/2: 0 = not h2; 2 = engine-owned h2 conn (grpc fast path)
  int h2_mode = 0;
  std::unique_ptr<H2State> h2;
  // read side (loop thread only)
  RBuf rbuf;
  size_t rpos = 0;
  // reassembled tunnel byte stream (TRPC frames are cut from here)
  RBuf sbuf;
  size_t spos = 0;

  // write side (any thread; wmu guards)
  std::mutex wmu;
  std::deque<std::string> wq;
  size_t wq_off = 0;  // offset into wq.front()
  uint64_t wq_bytes = 0;
  bool want_write = false;

  std::atomic<uint64_t> in_bytes{0}, out_bytes{0};
  std::atomic<uint64_t> in_msgs{0}, out_msgs{0};
  // zero-copy events referencing this conn's pool still in consumer hands
  std::atomic<int> zc_outstanding{0};
};

struct Listener {
  int fd = -1;
  int port = 0;
  int tpu_ordinal = -1;  // >=0: conns speak the TPUC tunnel natively
  bool py_fast = false;  // parsed EV_REQUEST events for Python services
  bool logoff = false;   // graceful stop: native services answer ELOGOFF
};

struct Loop {
  int epfd = -1;
  int evfd = -1;  // eventfd wakeup for the task queue
  std::thread thr;
  std::mutex tmu;
  std::vector<std::function<void()>> tasks;
};

// A Python thread blocked inside dp_call_sync (GIL released): the poller
// threads complete it directly — no event queue, no Python poller, no
// threading.Event. This is what makes N sync client threads scale: they
// park in C, so the interpreter only ever runs ONE of them at a time for
// the ~µs of pb work around the call. (Reference analog: a bthread
// blocking on its CallId butex, brpc/controller.cpp Join.)
struct SyncWaiter {
  uint64_t cid = 0;
  uint64_t conn_id = 0;
  std::mutex mu;
  std::condition_variable cv;
  bool done = false;
  int32_t terr = 0;           // transport error (DPE_*), 0 = completed
  int32_t code = 0;           // app-level error code from RpcMeta
  uint64_t attempt = 0;
  uint64_t att_size = 0;
  std::string etext;
  uint8_t* base = nullptr;    // free() handle (may differ from body)
  uint8_t* body = nullptr;
  uint64_t body_len = 0;
};

struct Runtime {
  std::vector<std::unique_ptr<Loop>> loops;
  std::atomic<bool> running{true};
  uint64_t max_body = kDefaultMaxBody;

  std::mutex swmu;  // outstanding dp_call_sync waiters by cid
  std::unordered_map<uint64_t, SyncWaiter*> sync_waiters;

  std::mutex cmu;  // conns + listeners
  std::unordered_map<uint64_t, std::shared_ptr<Conn>> conns;
  std::vector<Listener> listeners;
  std::atomic<uint64_t> next_conn_id{1};
  std::atomic<int> rr{0};

  std::mutex emu;
  std::condition_variable ecv;
  std::deque<DpEvent> events;
  uint64_t event_bytes = 0;

  // Native services run the reference's FULL per-request path in the
  // engine: admission (logoff + concurrency limit) and method status
  // (qps/latency/errors) are native, like MethodStatus::OnRequested in
  // baidu_rpc_protocol.cpp:661-712 — not a policy bypass.
  struct EchoSvc {
    int lid;  // native services are scoped to their listener — one
              // server's fast path must not answer another's traffic
    std::string service;
    std::string method;
    int32_t max_concurrency = 0;  // 0 = unlimited
    std::atomic<bool> logoff{false};
    std::atomic<int32_t> concurrency{0};
    std::atomic<uint64_t> requests{0};
    std::atomic<uint64_t> errors{0};
    std::atomic<uint64_t> latency_sum_ns{0};
    std::atomic<uint64_t> latency_max_ns{0};
  };
  std::mutex rmu;  // native service registry
  std::vector<std::unique_ptr<EchoSvc>> echo_services;

  // TPUC per-conn sender workers: tracked (not detached) so shutdown can
  // quiesce them before the Runtime dies. Finished entries are reaped on
  // the next registration (one worker per conn lifetime keeps this small).
  struct SenderSlot {
    std::thread thr;
    std::shared_ptr<std::atomic<bool>> done;
  };
  std::mutex smu_senders;
  std::vector<SenderSlot> senders;

  // listeners muted after EMFILE/ENFILE (fd exhaustion): disarmed from
  // epoll so level-triggered readiness cannot busy-spin loop 0, re-armed
  // by the loop tick once the backoff expires
  std::mutex amu;
  std::vector<std::pair<int, int64_t>> muted_listeners;  // (lid, rearm_ns)

  // conns with queued dp_respond/dp_call packets (dp_flush_all drains)
  std::mutex fmu;
  std::vector<std::shared_ptr<Conn>> flush_list;

  // pools of failed conns with zero-copy events still out: the mapping
  // must outlive the consumer's reads (freed at shutdown; bounded by
  // conns that die with events in flight)
  std::mutex gmu;
  std::vector<std::unique_ptr<TpuState>> tpu_graveyard;
};

int64_t mono_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

void register_sender(Runtime* rt, std::thread thr,
                     std::shared_ptr<std::atomic<bool>> done) {
  std::lock_guard<std::mutex> lk(rt->smu_senders);
  for (auto it = rt->senders.begin(); it != rt->senders.end();) {
    if (it->done->load()) {
      it->thr.join();
      it = rt->senders.erase(it);
    } else {
      ++it;
    }
  }
  rt->senders.push_back({std::move(thr), std::move(done)});
}

// ------------------------------------------------------------------ helpers
void push_event(Runtime* rt, DpEvent ev) {
  std::unique_lock<std::mutex> lk(rt->emu);
  rt->event_bytes += ev.meta_len + ev.body_len + sizeof(DpEvent);
  // soft cap: beyond it the loop threads stall here — natural backpressure
  // (the consumer is the Python poller; it drains in batches)
  while (rt->running.load() && rt->event_bytes > kEventQueueMaxBytes &&
         rt->events.size() > 16) {
    lk.unlock();
    usleep(1000);
    lk.lock();
  }
  bool was_empty = rt->events.empty();
  rt->events.push_back(ev);
  if (was_empty) {
    // consumers only sleep when the queue is empty (predicate-gated
    // wait), so the 0->1 transition is the only one that needs a signal —
    // per-message notifies were a futex syscall per frame under load
    rt->ecv.notify_one();
  }
}

// Batched variant: one lock round trip for a whole parse pass of frames
// (order within the batch is the conn's arrival order).
void push_event_batch(Runtime* rt, std::vector<DpEvent>& evs) {
  if (evs.empty()) return;
  uint64_t add = 0;
  for (auto& ev : evs) add += ev.meta_len + ev.body_len + sizeof(DpEvent);
  std::unique_lock<std::mutex> lk(rt->emu);
  rt->event_bytes += add;
  while (rt->running.load() && rt->event_bytes > kEventQueueMaxBytes &&
         rt->events.size() > 16) {
    lk.unlock();
    usleep(1000);
    lk.lock();
  }
  bool was_empty = rt->events.empty();
  for (auto& ev : evs) rt->events.push_back(ev);
  if (was_empty) rt->ecv.notify_one();
  lk.unlock();
  evs.clear();
}

void emit_failed(Runtime* rt, Conn* c, int err_class, const char* reason) {
  size_t rl = strlen(reason);
  char* buf = static_cast<char*>(malloc(rl ? rl : 1));
  memcpy(buf, reason, rl);
  DpEvent ev{};
  ev.kind = EV_FAILED;
  ev.tag = err_class;
  ev.conn_id = c->id;
  ev.base = buf;
  ev.meta = buf;
  ev.meta_len = rl;
  push_event(rt, ev);
}

void loop_submit(Runtime* rt, int li, std::function<void()> fn) {
  Loop* l = rt->loops[li].get();
  {
    std::lock_guard<std::mutex> lk(l->tmu);
    l->tasks.push_back(std::move(fn));
  }
  uint64_t one = 1;
  ssize_t r = write(l->evfd, &one, 8);
  (void)r;
}

// epoll re-arm helper. Loop-thread-only for IN; OUT armed from writers too
// (epoll_ctl is thread-safe).
void arm(Runtime* rt, Conn* c, bool out) {
  epoll_event ev{};
  ev.events = out ? (EPOLLIN | EPOLLOUT) : EPOLLIN;
  ev.data.u64 = c->id;
  epoll_ctl(rt->loops[c->loop]->epfd, EPOLL_CTL_MOD, c->fd, &ev);
}

// ------------------------------------------------------------- tpu tunnel
// Clamp a requested pool geometry to sane bounds (reference negotiates
// queue geometry in its handshake, rdma_endpoint.cpp:127-130; a peer must
// not be able to demand an absurd registration)
void tpu_clamp_geometry(uint32_t* bs, uint32_t* bc) {
  if (*bs == 0) *bs = kTpuBlockSize;
  if (*bc == 0) *bc = kTpuBlockCount;
  if (*bs < (16u << 10)) *bs = 16u << 10;
  if (*bs > (4u << 20)) *bs = 4u << 20;
  *bs = (*bs + 4095u) & ~4095u;  // page-align
  if (*bc < 4) *bc = 4;
  if (*bc > 512) *bc = 512;
  while (uint64_t(*bs) * *bc > (512ull << 20) && *bc > 4) *bc /= 2;
}

bool tpu_create_pool(TpuState* t) {
  char name[64];
  static std::atomic<uint32_t> seq{0};
  uint32_t rnd = 0;
  {
    std::random_device rd;  // unseeded rand() repeats across processes
    rnd = rd();
  }
  snprintf(name, sizeof(name), "brpctpu_%x_%08x%04x", getpid(), rnd,
           seq.fetch_add(1) & 0xffff);
  t->pool_name = name;
  int fd = shm_open(("/" + t->pool_name).c_str(),
                    O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return false;
  t->pool_len = size_t(t->bs) * t->bc;
  if (ftruncate(fd, off_t(t->pool_len)) != 0) {
    close(fd);
    shm_unlink(("/" + t->pool_name).c_str());
    return false;
  }
  t->pool = static_cast<uint8_t*>(mmap(nullptr, t->pool_len,
                                       PROT_READ | PROT_WRITE, MAP_SHARED,
                                       fd, 0));
  close(fd);
  if (t->pool == MAP_FAILED) {
    t->pool = nullptr;
    shm_unlink(("/" + t->pool_name).c_str());
    return false;
  }
  t->pool_owner = true;
  return true;
}

bool tpu_attach_peer(TpuState* t, const std::string& name, uint32_t bs,
                     uint32_t bc) {
  if (bs == 0 || bc == 0 || uint64_t(bs) * bc > (1ull << 30)) return false;
  if (name.find('/') != std::string::npos) return false;
  int fd = shm_open(("/" + name).c_str(), O_RDWR, 0600);
  if (fd < 0) return false;
  size_t len = size_t(bs) * bc;
  struct stat st {};
  // the claimed geometry must fit the object's REAL size at attach time —
  // mapping past EOF turns the first copy into a SIGBUS. NOTE this cannot
  // stop a peer that ftruncates its pool AFTER the handshake; tunnel
  // peers are processes of the same deployment (the reference's RDMA
  // peers hold registered memory under the same trust model).
  if (fstat(fd, &st) != 0 || uint64_t(st.st_size) < len) {
    close(fd);
    return false;
  }
  t->peer = static_cast<uint8_t*>(mmap(nullptr, len,
                                       PROT_READ | PROT_WRITE, MAP_SHARED,
                                       fd, 0));
  close(fd);
  if (t->peer == MAP_FAILED) {
    t->peer = nullptr;
    return false;
  }
  t->peer_len = len;
  t->peer_bs = bs;
  t->peer_bc = bc;
  {
    std::lock_guard<std::mutex> lk(t->cmu);
    t->credits.clear();
    for (uint32_t i = 0; i < bc; i++) t->credits.push_back(i);
    t->inflight.assign(bc, 0);
  }
  return true;
}

// flat-JSON field scanners — the HELLO body is a fixed flat dict
// (tpu/transport.py _hello_body); a full JSON parser is not needed
size_t json_value_pos(const std::string& s, const char* key) {
  // position after `"key"` + `:` + optional whitespace; npos if absent
  std::string pat = std::string("\"") + key + "\"";
  size_t p = s.find(pat);
  if (p == std::string::npos) return std::string::npos;
  p += pat.size();
  while (p < s.size() && (s[p] == ' ' || s[p] == '\t')) p++;
  if (p >= s.size() || s[p] != ':') return std::string::npos;
  p++;
  while (p < s.size() && (s[p] == ' ' || s[p] == '\t')) p++;
  return p;
}

bool json_str(const std::string& s, const char* key, std::string* out) {
  size_t p = json_value_pos(s, key);
  if (p == std::string::npos || p >= s.size() || s[p] != '"') return false;
  p++;
  size_t e = s.find('"', p);
  if (e == std::string::npos) return false;
  *out = s.substr(p, e - p);
  return true;
}

bool json_int(const std::string& s, const char* key, int64_t* out) {
  size_t p = json_value_pos(s, key);
  if (p == std::string::npos) return false;
  char* end = nullptr;
  long long v = strtoll(s.c_str() + p, &end, 10);
  if (end == s.c_str() + p) return false;
  *out = v;
  return true;
}

std::string tpu_hello_json(TpuState* t, int ordinal) {
  char buf[256];
  snprintf(buf, sizeof(buf),
           "{\"v\": %d, \"pool\": \"%s\", \"bs\": %u, \"bc\": %u, "
           "\"ordinal\": %d, \"pid\": %d, \"gen\": %u}",
           kTpuHandshakeVersion, t->pool_name.c_str(), t->bs, t->bc, ordinal,
           getpid(), t->epoch);
  return buf;
}

// bytes of epoch word leading a DATA/ACK body on this tunnel (0 or 4)
inline uint32_t tpu_epoch_words(const TpuState* t) {
  return (t != nullptr && t->peer_v >= 2) ? 4u : 0u;
}

int conn_writev(Runtime* rt, const std::shared_ptr<Conn>& c,
                const uint8_t* const* bufs, const uint64_t* lens, int nseg,
                int nmsgs = 1);
int tpu_send_packet(Runtime* rt, const std::shared_ptr<Conn>& c,
                    const uint8_t* const* bufs, const uint64_t* lens,
                    int nseg);

// send one TPUC ctrl frame: 9-byte header + body segments
int tpu_ctrl_send(Runtime* rt, const std::shared_ptr<Conn>& c, uint8_t ftype,
                  const uint8_t* const* body_bufs, const uint64_t* body_lens,
                  int nbody) {
  uint64_t body_len = 0;
  for (int i = 0; i < nbody; i++) body_len += body_lens[i];
  if (nbody < 0 || nbody > 33) return DPE_PROTOCOL;
  // a v2 peer reads the window generation first in DATA and ACK bodies
  uint32_t epoch_be = 0;
  const bool epoch = (ftype == TFT_DATA || ftype == TFT_ACK) &&
                     tpu_epoch_words(c->tpu.get()) != 0;
  if (epoch) {
    epoch_be = htonl(c->tpu->epoch);
    body_len += 4;
  }
  uint8_t hdr[kTpuHdrSize];
  memcpy(hdr, "TPUC", 4);
  hdr[4] = ftype;
  uint32_t be = htonl(uint32_t(body_len));
  memcpy(hdr + 5, &be, 4);
  const uint8_t* bufs[35];
  uint64_t lens[35];
  int n = 0;
  bufs[n] = hdr;
  lens[n++] = kTpuHdrSize;
  if (epoch) {
    bufs[n] = reinterpret_cast<const uint8_t*>(&epoch_be);
    lens[n++] = 4;
  }
  for (int i = 0; i < nbody; i++) {
    bufs[n] = body_bufs[i];
    lens[n++] = body_lens[i];
  }
  return conn_writev(rt, c, bufs, lens, n);
}

void tpu_teardown(Conn* c) {
  TpuState* t = c->tpu.get();
  if (t == nullptr) return;
  {
    std::lock_guard<std::mutex> lk(t->cmu);
    t->closed = true;
  }
  t->ccv.notify_all();
  {
    // set the flag and notify UNDER qmu: a notify racing the sender's
    // predicate evaluation would otherwise be lost forever, pinning the
    // sender thread (and the conn + shm mappings it holds) for good
    std::lock_guard<std::mutex> lk(t->qmu);
    t->q_closed = true;
    for (auto& r : t->respq) free(r.base);
    t->respq.clear();
    t->qcv.notify_all();
  }
  {
    std::lock_guard<std::mutex> lk(t->hmu);
    if (!t->ready && t->err.empty()) t->err = "connection failed";
  }
  t->hcv.notify_all();
}

// Fail a connection: unregister, close, emit event, drop from table.
// Runs on the owning loop thread (writers route through loop_submit).
void sync_fail_conn(Runtime* rt, uint64_t conn_id, int err_class,
                    const char* reason);

void conn_fail(Runtime* rt, const std::shared_ptr<Conn>& c, int err_class,
               const char* reason) {
  static const bool h2dbg = getenv("DP_H2_DEBUG") != nullptr;
  if (h2dbg) {
    fprintf(stderr, "[dp] conn_fail id=%llu class=%d reason=%s h2=%d\n",
            (unsigned long long)c->id, err_class, reason ? reason : "",
            c->h2_mode);
  }
  bool expected = false;
  if (!c->failed.compare_exchange_strong(expected, true)) return;
  {
    // exclude in-flight writers before closing: a writev racing the close
    // could otherwise land on a recycled fd of a brand-new connection
    std::lock_guard<std::mutex> wlk(c->wmu);
    epoll_ctl(rt->loops[c->loop]->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
    close(c->fd);
    c->fd = -1;
  }
  tpu_teardown(c.get());
  if (c->tpu && c->zc_outstanding.load() > 0) {
    // a consumer still holds pointers into the pool — keep the mapping
    // alive past the conn (reclaimed at runtime shutdown)
    std::lock_guard<std::mutex> glk(rt->gmu);
    rt->tpu_graveyard.push_back(std::move(c->tpu));
  }
  emit_failed(rt, c.get(), err_class, reason);
  sync_fail_conn(rt, c->id, err_class, reason);
  std::lock_guard<std::mutex> lk(rt->cmu);
  rt->conns.erase(c->id);
}

// ----------------------------------------------------------------- writing
// dp_send core: claimed-writer inline vectored send, queue remainder, arm
// EPOLLOUT (reference Socket::StartWrite, socket.cpp:1692-1800). One packet
// = n segments (header/meta/payload/attachment refs from the IOBuf chain);
// the common case finishes in one writev with ZERO assembly copies.
int conn_writev(Runtime* rt, const std::shared_ptr<Conn>& c,
                const uint8_t* const* bufs, const uint64_t* lens, int nseg,
                int nmsgs) {
  uint64_t len = 0;
  for (int i = 0; i < nseg; i++) len += lens[i];
  if (c->failed.load()) return DPE_IO;
  std::lock_guard<std::mutex> lk(c->wmu);
  if (c->failed.load() || c->fd < 0) return DPE_IO;
  if (c->wq_bytes + len > kWriteQueueMax) return DPE_OVERCROWDED;
  uint64_t off = 0;  // bytes of the packet already on the wire
  if (c->wq.empty()) {
    iovec iov[64];
    while (off < len) {
      // rebuild the iov for the unwritten tail
      uint64_t skip = off;
      int iv = 0;
      for (int i = 0; i < nseg && iv < 64; i++) {
        if (skip >= lens[i]) {
          skip -= lens[i];
          continue;
        }
        iov[iv].iov_base = const_cast<uint8_t*>(bufs[i]) + skip;
        iov[iv].iov_len = size_t(lens[i] - skip);
        skip = 0;
        iv++;
      }
      ssize_t n = ::writev(c->fd, iov, iv);
      if (n > 0) {
        off += uint64_t(n);
      } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        break;
      } else if (n < 0 && errno == EINTR) {
        continue;
      } else {
        // hard error: the loop will observe it too; report now
        return DPE_IO;
      }
    }
    c->out_bytes.fetch_add(off, std::memory_order_relaxed);
  }
  if (off < len) {
    // assemble only the unwritten remainder
    std::string rest;
    rest.reserve(size_t(len - off));
    uint64_t skip = off;
    for (int i = 0; i < nseg; i++) {
      if (skip >= lens[i]) {
        skip -= lens[i];
        continue;
      }
      rest.append(reinterpret_cast<const char*>(bufs[i]) + skip,
                  size_t(lens[i] - skip));
      skip = 0;
    }
    c->wq_bytes += rest.size();
    c->wq.push_back(std::move(rest));
    if (!c->want_write) {
      c->want_write = true;
      arm(rt, c.get(), true);
    }
  }
  c->out_msgs.fetch_add(uint64_t(nmsgs), std::memory_order_relaxed);
  return DPE_OK;
}

int conn_write(Runtime* rt, const std::shared_ptr<Conn>& c,
               const uint8_t* data, uint64_t len) {
  const uint8_t* bufs[1] = {data};
  const uint64_t lens[1] = {len};
  return conn_writev(rt, c, bufs, lens, 1);
}

// EPOLLOUT drain on the loop thread (KeepWrite analog).
void conn_drain_writes(Runtime* rt, const std::shared_ptr<Conn>& c) {
  std::lock_guard<std::mutex> lk(c->wmu);
  if (c->failed.load() || c->fd < 0) return;
  while (!c->wq.empty()) {
    std::string& front = c->wq.front();
    size_t left = front.size() - c->wq_off;
    ssize_t n = ::send(c->fd, front.data() + c->wq_off, left, MSG_NOSIGNAL);
    if (n > 0) {
      c->out_bytes.fetch_add(uint64_t(n), std::memory_order_relaxed);
      c->wq_bytes -= uint64_t(n);
      c->wq_off += size_t(n);
      if (c->wq_off == front.size()) {
        c->wq.pop_front();
        c->wq_off = 0;
      }
    } else if (n < 0 && errno == EINTR) {
      continue;
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      return;  // stay armed
    } else {
      c->want_write = false;
      // fail from the loop thread after the lock is released
      loop_submit(rt, c->loop, [rt, c] { conn_fail(rt, c, DPE_IO, "send"); });
      return;
    }
  }
  c->want_write = false;
  arm(rt, c.get(), false);
}

// ----------------------------------------------------------------- parsing
// Accumulators for one parse pass: native echo responses coalesce into a
// handful of writev calls and delivered events into one queue push — on a
// single shared core, syscalls and lock round trips ARE the QPS ceiling
// (reference batches the same way: KeepWrite gathers up to 256 IOBufs,
// socket.cpp:1789; OnNewMessages NOSIGNAL-batches, input_messenger.cpp:194).
struct ParseBatch {
  std::vector<DpEvent> events;
  // (head, body-ref) pairs; heads in a deque so appends don't move them
  std::deque<std::string> heads;
  std::vector<std::pair<const uint8_t*, uint64_t>> segs;
  int nresp = 0;
};

// Flush echo responses + events. MUST run before the read buffer is
// compacted/stolen (segs reference it) and before any conn_fail/detach
// (frames precede EV_FAILED in the queue).
void flush_batch(Runtime* rt, const std::shared_ptr<Conn>& c, ParseBatch* b) {
  if (!b->segs.empty()) {
    size_t i = 0;
    bool wrote_err = false;
    while (i < b->segs.size() && !wrote_err) {
      const uint8_t* bufs[64];
      uint64_t lens[64];
      int n = 0;
      int msgs = 0;
      while (i < b->segs.size() && n + 2 <= 64) {
        bufs[n] = b->segs[i].first;
        lens[n] = b->segs[i].second;
        bufs[n + 1] = b->segs[i + 1].first;
        lens[n + 1] = b->segs[i + 1].second;
        n += 2;
        i += 2;
        msgs++;
      }
      int rc = conn_writev(rt, c, bufs, lens, n, msgs);
      if (rc != DPE_OK) {
        // a consumed request whose response can't go out leaves the
        // client hanging — the stream contract is broken, tear down
        loop_submit(rt, c->loop, [rt, c, rc] {
          conn_fail(rt, c, rc == DPE_OVERCROWDED ? DPE_OVERCROWDED : DPE_IO,
                    "native echo response undeliverable");
        });
        wrote_err = true;
      }
    }
    b->segs.clear();
    b->heads.clear();
    b->nresp = 0;
  }
  push_event_batch(rt, b->events);
}

Runtime::EchoSvc* echo_match(Runtime* rt, int lid, const MetaLite& m) {
  if (lid < 0) return nullptr;
  std::lock_guard<std::mutex> lk(rt->rmu);
  for (auto& sm : rt->echo_services) {
    if (sm->lid == lid && sm->service == m.service &&
        sm->method == m.method) {
      return sm.get();  // registry only grows; entries are stable
    }
  }
  return nullptr;
}

// brpc_tpu_torch/rpc/errors.py mirrors (native admission responses)
constexpr int32_t kElogoff = 1011;
constexpr int32_t kElimit = 1012;

// Native request-path admission + method status (reference
// MethodStatus::OnRequested, baidu_rpc_protocol.cpp:661-712).
struct EchoAdmit {
  Runtime::EchoSvc* svc = nullptr;
  int64_t t0 = 0;
  int32_t ecode = 0;
  const char* etext = "";
  bool counted = false;
};

// False: not a registered native service (frame goes to Python). True:
// admission ran; a->ecode holds the rejection (0 = admitted).
bool echo_admit(Runtime* rt, Conn* c, const MetaLite& m, EchoAdmit* a) {
  if (!c->is_server || !m.has_request || m.has_response || m.compress_type ||
      m.checksum || m.has_stream_settings || m.has_auth) {
    return false;
  }
  a->svc = echo_match(rt, c->listener_id, m);
  if (a->svc == nullptr) return false;
  a->t0 = mono_ns();
  a->svc->requests.fetch_add(1, std::memory_order_relaxed);
  if (a->svc->logoff.load(std::memory_order_relaxed)) {
    a->ecode = kElogoff;
    a->etext = "server is stopping";
  } else if (a->svc->max_concurrency) {
    int32_t cur = a->svc->concurrency.fetch_add(
                      1, std::memory_order_relaxed) + 1;
    if (cur > a->svc->max_concurrency) {
      a->svc->concurrency.fetch_sub(1, std::memory_order_relaxed);
      a->ecode = kElimit;
      a->etext = "method concurrency limit";
    } else {
      a->counted = true;
    }
  }
  return true;
}

void echo_settle(EchoAdmit* a) {
  if (a->counted) {
    a->svc->concurrency.fetch_sub(1, std::memory_order_relaxed);
  }
  if (a->ecode) a->svc->errors.fetch_add(1, std::memory_order_relaxed);
  uint64_t dt = uint64_t(mono_ns() - a->t0);
  a->svc->latency_sum_ns.fetch_add(dt, std::memory_order_relaxed);
  uint64_t prev = a->svc->latency_max_ns.load(std::memory_order_relaxed);
  while (dt > prev &&
         !a->svc->latency_max_ns.compare_exchange_weak(prev, dt)) {
  }
}

// Queue a tunnel response on the per-conn sender worker (NEVER send from
// the loop thread: tpu_send_packet may wait for credit ACKs that only the
// loop can deliver). Spawns the worker on first use; ts is captured by
// value — conn_fail may move the TpuState into the graveyard, but the
// object itself stays alive.
void tpu_enqueue_resp(Runtime* rt, const std::shared_ptr<Conn>& c,
                      TpuState* ts, TpuState::Resp&& resp) {
  {
    std::lock_guard<std::mutex> lk(ts->qmu);
    ts->respq.push_back(std::move(resp));
    if (!ts->sender_running) {
      ts->sender_running = true;
      auto done = std::make_shared<std::atomic<bool>>(false);
      std::thread thr([rt, c, ts, done] {
        for (;;) {
          TpuState::Resp item;
          {
            std::unique_lock<std::mutex> qlk(ts->qmu);
            ts->qcv.wait(qlk, [ts, &c] {
              return !ts->respq.empty() || ts->q_closed ||
                     c->failed.load();
            });
            if (ts->respq.empty()) {  // closed/failed: drain done
              done->store(true);
              return;
            }
            item = std::move(ts->respq.front());
            ts->respq.pop_front();
          }
          int rc;
          if (!item.segs.empty()) {
            // zero-copy echo: head + pool-block segments, then the ACK
            // returning those blocks (never before — the peer may reuse
            // them the instant the credit lands)
            std::vector<const uint8_t*> bb(item.segs.size() + 1);
            std::vector<uint64_t> ll(item.segs.size() + 1);
            bb[0] = reinterpret_cast<const uint8_t*>(item.head.data());
            ll[0] = item.head.size();
            for (size_t si = 0; si < item.segs.size(); si++) {
              bb[si + 1] = item.segs[si].first;
              ll[si + 1] = item.segs[si].second;
            }
            rc = tpu_send_packet(rt, c, bb.data(), ll.data(),
                                 int(bb.size()));
          } else {
            const uint8_t* bb[2] = {
                reinterpret_cast<const uint8_t*>(item.head.data()),
                item.body};
            const uint64_t ll[2] = {item.head.size(), item.blen};
            rc = tpu_send_packet(rt, c, bb, ll, 2);
          }
          if (rc == DPE_OK && !item.ack.empty()) {
            // the donated blocks go back on EVERY outcome that keeps the
            // conn alive — an admission-rejected request (segs empty, no
            // body echoed) must still return the peer's credits
            const uint8_t* ab[1] = {
                reinterpret_cast<const uint8_t*>(item.ack.data())};
            const uint64_t al[1] = {item.ack.size()};
            rc = tpu_ctrl_send(rt, c, TFT_ACK, ab, al, 1);
          }
          free(item.base);
          if (rc != DPE_OK) {
            if (rt->running.load()) {
              loop_submit(rt, c->loop, [rt, c] {
                conn_fail(rt, c, DPE_IO,
                          "native service response undeliverable");
              });
            }
            done->store(true);
            return;
          }
        }
      });
      register_sender(rt, std::move(thr), done);
    }
  }
  ts->qcv.notify_one();
}

std::string echo_response_head(const MetaLite& m, const EchoAdmit& a,
                               uint64_t body_len) {
  std::string meta = a.ecode
      ? build_response_meta(m.correlation_id, m.attempt_version, a.ecode,
                            a.etext, strlen(a.etext), 0)
      : build_echo_response_meta(m);
  std::string head;
  head.reserve(kHeaderSize + meta.size());
  put_trpc_header(&head, meta.size(), a.ecode ? 0 : body_len);
  head.append(meta);
  return head;
}

// Answer a registered echo request natively, running the full native
// request path: admission (logoff, per-method concurrency limit) +
// method status (qps/latency/errors) + user code (echo) + response pack.
// Returns false if the frame should go to Python instead.
bool try_native_echo(Runtime* rt, const std::shared_ptr<Conn>& c,
                     const MetaLite& m, const uint8_t* body,
                     uint64_t body_len, RBuf* whole_buf, ParseBatch* batch) {
  if (m.attachment_size > body_len) return false;
  EchoAdmit admit;
  if (!echo_admit(rt, c.get(), m, &admit)) return false;
  int32_t ecode = admit.ecode;
  auto settle = [&](bool) { echo_settle(&admit); };
  if (ecode) body_len = 0;  // admission rejections carry no body
  std::string head = echo_response_head(m, admit, body_len);
  // body still points into the conn's read buffer: conn_writev either puts
  // it on the wire or copies the remainder before returning, so the
  // zero-assembly reference is safe
  if (c->tpu_mode != 0) {
    // NEVER send from the loop thread: tpu_send_packet may wait for
    // credit ACKs that only this thread can deliver. One per-conn sender
    // worker drains responses in order; a send failure fails the conn
    // (a consumed request must never be silently dropped).
    TpuState* t = c->tpu.get();
    if (t == nullptr) return false;
    TpuState::Resp resp;
    resp.head = std::move(head);
    if (whole_buf != nullptr && body_len >= (64 << 10)) {
      // the stream buffer holds exactly this one frame: donate it to the
      // sender instead of copying the body (single-core: copies are
      // serial wall-clock)
      resp.base = whole_buf->data;
      resp.body = body;
      resp.blen = body_len;
      whole_buf->data = nullptr;
      whole_buf->cap = 0;
      whole_buf->size = 0;
    } else {
      resp.base = static_cast<uint8_t*>(malloc(body_len ? body_len : 1));
      memcpy(resp.base, body, body_len);
      resp.body = resp.base;
      resp.blen = body_len;
    }
    tpu_enqueue_resp(rt, c, t, std::move(resp));
    settle(ecode != 0);
    return true;
  }
  // TCP lane: accumulate; the whole parse pass flushes in a few writevs
  // (bodies point into the conn's read buffer, stable until flush)
  batch->heads.push_back(std::move(head));
  const std::string& h = batch->heads.back();
  batch->segs.emplace_back(reinterpret_cast<const uint8_t*>(h.data()),
                           h.size());
  batch->segs.emplace_back(body, body_len);
  batch->nresp++;
  settle(ecode != 0);
  return true;
}

// Zero-copy consumption of one DATA frame whose pool blocks hold exactly
// one complete TRPC frame (the common bulk-transfer shape: one message
// per DATA frame once the window is negotiated). Two routes skip the
// stream-reassembly copy entirely (reference rdma zero-copy recv —
// blocks attach straight to the IOBuf, block_pool.cpp):
//   - native echo: respond straight FROM the blocks, ACK after the send
//   - client response on a fast conn: EV_RESPONSE_ZC hands the consumer
//     segment views + the ACK blob (dp_tpu_ack returns the credits)
// Returns true when fully handled; false -> caller takes the copy path.
bool tpu_try_zero_copy(Runtime* rt, const std::shared_ptr<Conn>& c,
                       TpuState* t, const uint8_t* body, uint32_t nsegs) {
  struct Seg {
    const uint8_t* p;
    uint32_t len;
    uint32_t idx;
  };
  if (nsegs > 64) return false;
  Seg segs[64];
  uint64_t total = 0;
  const uint8_t* sp = body + 8;
  for (uint32_t i = 0; i < nsegs; i++) {
    uint32_t idx = ntohl(*reinterpret_cast<const uint32_t*>(sp + i * 8));
    uint32_t ln = ntohl(*reinterpret_cast<const uint32_t*>(sp + i * 8 + 4));
    if (idx >= t->bc || ln > t->bs || ln == 0) return false;
    segs[i] = {t->pool + size_t(idx) * t->bs, ln, idx};
    total += ln;
  }
  if (segs[0].len < kHeaderSize) return false;
  const uint8_t* h = segs[0].p;
  if (memcmp(h, "TRPC", 4) != 0) return false;  // TSTR: copy path
  uint64_t meta_size = ntohl(*reinterpret_cast<const uint32_t*>(h + 4));
  uint64_t body_size = ntohl(*reinterpret_cast<const uint32_t*>(h + 8));
  if (kHeaderSize + meta_size + body_size != total) return false;
  if (kHeaderSize + meta_size > segs[0].len) return false;  // meta split
  if (meta_size + body_size > rt->max_body) return false;
  MetaLite m;
  if (!parse_meta_lite(h + kHeaderSize, h + kHeaderSize + meta_size, &m)) {
    return false;  // copy path surfaces the protocol error
  }
  if (m.attachment_size > body_size) return false;
  // payload views: bytes after header+meta, spanning the blocks
  std::vector<std::pair<const uint8_t*, uint64_t>> views;
  uint64_t skip = kHeaderSize + meta_size;
  for (uint32_t i = 0; i < nsegs; i++) {
    if (skip >= segs[i].len) {
      skip -= segs[i].len;
      continue;
    }
    views.emplace_back(segs[i].p + skip, uint64_t(segs[i].len) - skip);
    skip = 0;
  }
  // the ACK returning exactly these blocks
  std::string ack;
  ack.resize(4 + size_t(nsegs) * 4);
  uint32_t n_be = htonl(nsegs);
  memcpy(&ack[0], &n_be, 4);
  for (uint32_t i = 0; i < nsegs; i++) {
    uint32_t idx_be = htonl(segs[i].idx);
    memcpy(&ack[4 + size_t(i) * 4], &idx_be, 4);
  }
  // route 1: native echo — reply straight from the blocks
  EchoAdmit admit;
  if (echo_admit(rt, c.get(), m, &admit)) {
    c->in_msgs.fetch_add(1, std::memory_order_relaxed);
    TpuState::Resp resp;
    resp.head = echo_response_head(m, admit, body_size);
    if (!admit.ecode) resp.segs = std::move(views);
    resp.ack = std::move(ack);
    tpu_enqueue_resp(rt, c, t, std::move(resp));
    echo_settle(&admit);
    return true;
  }
  // route 2: client-side response on a fast conn — deliver views + ack
  if (!c->is_server && c->py_fast.load(std::memory_order_relaxed) &&
      m.has_response && !m.has_request && !m.compress_type && !m.checksum &&
      !m.has_stream_settings && !m.has_auth) {
    c->in_msgs.fetch_add(1, std::memory_order_relaxed);
    size_t et = m.resp_error_text.size();
    size_t need = sizeof(RespLite) + 4 + views.size() * 16 + 4 +
                  ack.size() + et;
    uint8_t* blk = static_cast<uint8_t*>(malloc(need ? need : 1));
    RespLite rl{};
    rl.attempt = m.attempt_version;
    rl.att_size = m.attachment_size;
    memcpy(blk, &rl, sizeof(rl));
    uint8_t* w = blk + sizeof(rl);
    uint32_t nv = uint32_t(views.size());
    memcpy(w, &nv, 4);
    w += 4;
    for (auto& v : views) {
      uint64_t p = reinterpret_cast<uint64_t>(v.first);
      memcpy(w, &p, 8);
      memcpy(w + 8, &v.second, 8);
      w += 16;
    }
    uint32_t alen = uint32_t(ack.size());
    memcpy(w, &alen, 4);
    w += 4;
    memcpy(w, ack.data(), ack.size());
    w += ack.size();
    memcpy(w, m.resp_error_text.data(), et);
    DpEvent ev{};
    ev.kind = EV_RESPONSE_ZC;
    ev.tag = int32_t(m.resp_error_code);
    ev.conn_id = c->id;
    ev.aux = int64_t(m.correlation_id);
    ev.base = blk;
    ev.meta = blk;
    ev.meta_len = need;
    ev.body = nullptr;
    ev.body_len = body_size;  // informational: total payload bytes
    c->zc_outstanding.fetch_add(1, std::memory_order_relaxed);
    push_event(rt, ev);
    return true;
  }
  return false;  // anything else: the copy path handles it
}

// Detach: hand the fd + buffered bytes to Python (non-TRPC protocol on a
// native port — http dashboard, grpc, redis... take over seamlessly).
void conn_detach(Runtime* rt, const std::shared_ptr<Conn>& c,
                 const std::string* prefix = nullptr) {
  bool expected = false;
  if (!c->failed.compare_exchange_strong(expected, true)) return;
  int fd;
  {
    std::lock_guard<std::mutex> wlk(c->wmu);
    c->detached = true;
    epoll_ctl(rt->loops[c->loop]->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
    fd = c->fd;
    c->fd = -1;  // ownership transfers to the consumer via the event
  }
  // prefix: bytes already consumed by a protocol sniff (h2 preface +
  // pre-decision frames) — replayed so the Python stack starts from a
  // pristine byte stream
  size_t plen = prefix ? prefix->size() : 0;
  size_t left = c->rbuf.size - c->rpos;
  uint8_t* blk =
      static_cast<uint8_t*>(malloc((plen + left) ? (plen + left) : 1));
  if (plen) memcpy(blk, prefix->data(), plen);
  memcpy(blk + plen, c->rbuf.data + c->rpos, left);
  DpEvent ev{};
  ev.kind = EV_DETACHED;
  ev.tag = 0;
  ev.conn_id = c->id;
  ev.aux = fd;
  ev.base = blk;
  ev.meta = blk;
  ev.meta_len = plen + left;
  push_event(rt, ev);
  std::lock_guard<std::mutex> lk(rt->cmu);
  rt->conns.erase(c->id);
}

// ---- sync-waiter completion (dp_call_sync)
SyncWaiter* sync_take(Runtime* rt, uint64_t cid) {
  std::lock_guard<std::mutex> lk(rt->swmu);
  auto it = rt->sync_waiters.find(cid);
  if (it == rt->sync_waiters.end()) return nullptr;
  SyncWaiter* w = it->second;
  rt->sync_waiters.erase(it);
  return w;
}

// Conn-scoped take: a response only completes a waiter parked on ITS
// connection (cids are process-unique, but a buggy/malicious peer could
// echo a guessed cid — without this check it would complete another
// channel's call with foreign bytes).
SyncWaiter* sync_take_conn(Runtime* rt, uint64_t cid, uint64_t conn_id) {
  std::lock_guard<std::mutex> lk(rt->swmu);
  auto it = rt->sync_waiters.find(cid);
  if (it == rt->sync_waiters.end()) return nullptr;
  if (it->second->conn_id != conn_id) return nullptr;
  SyncWaiter* w = it->second;
  rt->sync_waiters.erase(it);
  return w;
}

// After notify, the completer must not touch w again: the waiter owns the
// storage (stack frame) and frees it once it re-acquires w->mu and sees
// done. Holding mu across the notify makes that handoff safe.
void sync_complete(SyncWaiter* w, int32_t code, uint64_t attempt,
                   uint64_t att_size, const char* etext, size_t elen,
                   uint8_t* base, uint8_t* body, uint64_t blen) {
  std::lock_guard<std::mutex> lk(w->mu);
  w->code = code;
  w->attempt = attempt;
  w->att_size = att_size;
  if (elen) w->etext.assign(etext, elen);
  w->base = base;
  w->body = body;
  w->body_len = blen;
  w->done = true;
  w->cv.notify_one();
}

// Wake every sync waiter parked on a failing conn (transport error).
void sync_fail_conn(Runtime* rt, uint64_t conn_id, int err_class,
                    const char* reason) {
  std::vector<SyncWaiter*> hit;
  {
    std::lock_guard<std::mutex> lk(rt->swmu);
    for (auto it = rt->sync_waiters.begin();
         it != rt->sync_waiters.end();) {
      if (it->second->conn_id == conn_id) {
        hit.push_back(it->second);
        it = rt->sync_waiters.erase(it);
      } else {
        ++it;
      }
    }
  }
  for (auto* w : hit) {
    std::lock_guard<std::mutex> lk(w->mu);
    w->terr = err_class ? err_class : DPE_IO;
    if (reason) w->etext.assign(reason);
    w->done = true;
    w->cv.notify_one();
  }
}

// Parsed fast-path event builders (meta struct + names/text + body in ONE
// allocation — dp_free stays a single free()).
void batch_fast_request(ParseBatch* b, Conn* c, const MetaLite& m,
                        const uint8_t* body, uint64_t body_len) {
  size_t hdr = sizeof(ReqLite) + m.service.size() + m.method.size();
  uint8_t* blk = static_cast<uint8_t*>(malloc(hdr + body_len + 1));
  ReqLite rl{};
  rl.cid = m.correlation_id;
  rl.attempt = m.attempt_version;
  rl.att_size = m.attachment_size;
  rl.log_id = m.log_id;
  rl.trace_id = m.trace_id;
  rl.span_id = m.span_id;
  rl.timeout_ms = int32_t(m.timeout_ms);
  rl.svc_len = uint16_t(m.service.size());
  rl.meth_len = uint16_t(m.method.size());
  memcpy(blk, &rl, sizeof(rl));
  memcpy(blk + sizeof(rl), m.service.data(), m.service.size());
  memcpy(blk + sizeof(rl) + m.service.size(), m.method.data(),
         m.method.size());
  memcpy(blk + hdr, body, body_len);
  DpEvent ev{};
  ev.kind = EV_REQUEST;
  ev.conn_id = c->id;
  ev.aux = int64_t(m.correlation_id);
  ev.base = blk;
  ev.meta = blk;
  ev.meta_len = hdr;
  ev.body = blk + hdr;
  ev.body_len = body_len;
  b->events.push_back(ev);
}

void batch_fast_response(ParseBatch* b, Conn* c, const MetaLite& m,
                         const uint8_t* body, uint64_t body_len) {
  size_t hdr = sizeof(RespLite) + m.resp_error_text.size();
  uint8_t* blk = static_cast<uint8_t*>(malloc(hdr + body_len + 1));
  RespLite rl{};
  rl.attempt = m.attempt_version;
  rl.att_size = m.attachment_size;
  memcpy(blk, &rl, sizeof(rl));
  memcpy(blk + sizeof(rl), m.resp_error_text.data(),
         m.resp_error_text.size());
  memcpy(blk + hdr, body, body_len);
  DpEvent ev{};
  ev.kind = EV_RESPONSE;
  ev.tag = int32_t(m.resp_error_code);
  ev.conn_id = c->id;
  ev.aux = int64_t(m.correlation_id);
  ev.base = blk;
  ev.meta = blk;
  ev.meta_len = hdr;
  ev.body = blk + hdr;
  ev.body_len = body_len;
  b->events.push_back(ev);
}

// Cut complete TRPC/TSTR frames out of (buf, pos) — the wire buffer for
// plain conns, the reassembled tunnel stream for TPUC conns.
void cut_trpc(Runtime* rt, const std::shared_ptr<Conn>& c, RBuf& buf,
              size_t& pos, bool allow_detach) {
  ParseBatch batch;
  bool fast = c->py_fast.load(std::memory_order_relaxed);
  for (;;) {
    size_t avail = buf.size - pos;
    if (avail < kHeaderSize) break;
    const uint8_t* p = buf.data + pos;
    bool is_trpc = memcmp(p, "TRPC", 4) == 0;
    bool is_tstr = !is_trpc && memcmp(p, "TSTR", 4) == 0;
    if (!is_trpc && !is_tstr) {
      flush_batch(rt, c, &batch);  // frames precede the detach/fail event
      if (allow_detach) {
        conn_detach(rt, c);
      } else {
        conn_fail(rt, c, DPE_PROTOCOL, "garbage in tunnel stream");
      }
      return;
    }
    uint32_t meta_size = ntohl(*reinterpret_cast<const uint32_t*>(p + 4));
    uint32_t body_size = ntohl(*reinterpret_cast<const uint32_t*>(p + 8));
    uint64_t total = uint64_t(meta_size) + body_size;
    if (total > rt->max_body) {
      flush_batch(rt, c, &batch);
      conn_fail(rt, c, DPE_PROTOCOL, "frame exceeds max_body");
      return;
    }
    if (avail < kHeaderSize + total) break;
    const uint8_t* meta = p + kHeaderSize;
    const uint8_t* body = meta + meta_size;
    c->in_msgs.fetch_add(1, std::memory_order_relaxed);
    bool handled = false;
    bool whole = (pos == 0 && kHeaderSize + total == buf.size);
    MetaLite m;
    bool meta_ok = false;
    if (is_trpc) {
      if (parse_meta_lite(meta, meta + meta_size, &m)) {
        meta_ok = true;
        handled = try_native_echo(rt, c, m, body, body_size,
                                  whole ? &buf : nullptr, &batch);
        if (handled && buf.data == nullptr) {
          pos = 0;  // the echo stole the buffer (tpu lane, single frame:
                    // batch is necessarily empty of body refs)
          flush_batch(rt, c, &batch);
          return;
        }
        if (c->failed.load()) {  // tpu-lane echo enqueue tore it down
          flush_batch(rt, c, &batch);
          return;
        }
      } else {
        flush_batch(rt, c, &batch);
        conn_fail(rt, c, DPE_PROTOCOL, "bad RpcMeta");
        return;
      }
    }
    if (!handled) {
      // a Python thread parked in dp_call_sync for this cid? complete it
      // right here on the parse thread — no event queue, no GIL. Only
      // plain responses (no compress/checksum/stream riders) finish
      // natively; anything else falls through to the EV_FRAME path and
      // the Python fallback completes the waiter via dp_sync_complete_py.
      if (is_trpc && meta_ok && !c->is_server && m.has_response &&
          !m.has_request && !m.compress_type && !m.checksum &&
          !m.has_stream_settings && m.attachment_size <= body_size) {
        SyncWaiter* w = sync_take_conn(rt, m.correlation_id, c->id);
        if (w != nullptr) {
          if (whole && total >= kFastFrameMax) {
            // steal the read buffer like the EV_FRAME donation path:
            // megabyte responses reach the sync caller with ZERO copies
            uint8_t* base = buf.data;
            uint8_t* bp = buf.data + kHeaderSize + meta_size;
            buf.data = nullptr;
            buf.cap = 0;
            buf.size = 0;
            pos = 0;
            flush_batch(rt, c, &batch);
            sync_complete(w, int32_t(m.resp_error_code),
                          m.attempt_version, m.attachment_size,
                          m.resp_error_text.data(),
                          m.resp_error_text.size(), base, bp, body_size);
            return;
          }
          uint8_t* blk = nullptr;
          if (body_size) {
            blk = static_cast<uint8_t*>(malloc(body_size));
            memcpy(blk, body, body_size);
          }
          sync_complete(w, int32_t(m.resp_error_code), m.attempt_version,
                        m.attachment_size, m.resp_error_text.data(),
                        m.resp_error_text.size(), blk, blk, body_size);
          pos += kHeaderSize + total;
          continue;
        }
      }
      // BIG fast-eligible server requests skip the EV_FRAME donation and
      // ride the parsed fast path too (VERDICT r3 #6): one native memcpy
      // here (GIL-free) replaces the Python-side pb meta parse + IOBuf
      // split/pack copies of the full pipeline, and the response returns
      // through dp_respond's zero-copy writev. Pooled bulk conns then
      // only serialize on the two unavoidable Python copies.
      // (names past 64 KiB do not fit ReqLite's u16 lengths: those take
      // the full pipeline, which reads them from the pb meta)
      if (fast && is_trpc && meta_ok && c->is_server && m.has_request &&
          !m.has_response && !m.compress_type && !m.checksum &&
          !m.has_stream_settings && !m.has_auth &&
          m.attachment_size <= body_size && m.service.size() <= 0xffff &&
          m.method.size() <= 0xffff) {
        batch_fast_request(&batch, c.get(), m, body, body_size);
        pos += kHeaderSize + total;
        continue;
      }
      if (whole && total >= kFastFrameMax) {
        // the buffer holds exactly this one large frame: hand the WHOLE
        // buffer to the consumer instead of memcpy'ing megabytes — the
        // dominant copy on the delivery path (this machine is single-core;
        // every copy is serial wall-clock)
        DpEvent ev{};
        ev.kind = EV_FRAME;
        ev.tag = is_tstr ? 1 : 0;
        ev.conn_id = c->id;
        ev.base = buf.data;
        ev.meta = buf.data + kHeaderSize;
        ev.meta_len = meta_size;
        ev.body = buf.data + kHeaderSize + meta_size;
        ev.body_len = body_size;
        buf.data = nullptr;
        buf.cap = 0;
        buf.size = 0;
        pos = 0;
        batch.events.push_back(ev);
        flush_batch(rt, c, &batch);
        return;
      }
      // parsed fast-path events: Python receives pre-cracked meta fields
      // and never runs protobuf on the hot path. Anything with policy
      // riding the meta (compress, checksum, auth, streams) takes the
      // full EV_FRAME path; trace ids ride ReqLite natively. (Server
      // requests of EVERY size were already taken above.)
      if (fast && is_trpc && meta_ok && !m.compress_type && !m.checksum &&
          !m.has_stream_settings && !m.has_auth &&
          m.attachment_size <= body_size &&
          !c->is_server && m.has_response && !m.has_request) {
        batch_fast_response(&batch, c.get(), m, body, body_size);
        pos += kHeaderSize + total;
        continue;
      }
      uint8_t* blk = static_cast<uint8_t*>(
          malloc(uint64_t(meta_size) + body_size + 1));
      memcpy(blk, meta, meta_size);
      memcpy(blk + meta_size, body, body_size);
      DpEvent ev{};
      ev.kind = EV_FRAME;
      ev.tag = is_tstr ? 1 : 0;
      ev.conn_id = c->id;
      ev.base = blk;
      ev.meta = blk;
      ev.meta_len = meta_size;
      ev.body = blk + meta_size;
      ev.body_len = body_size;
      batch.events.push_back(ev);
    }
    pos += kHeaderSize + total;
  }
  flush_batch(rt, c, &batch);  // before compaction: segs reference buf
  // compact
  if (pos == buf.size) {
    buf.size = 0;
    pos = 0;
  } else if (pos > (1 << 20)) {
    memmove(buf.data, buf.data + pos, buf.size - pos);
    buf.size -= pos;
    pos = 0;
  }
}

// ---- TPUC tunnel frame processing (reference RdmaEndpoint recv path:
// blocks -> reassembled stream -> the SAME message cutter as TCP,
// input_messenger.cpp:416)
void tpu_handle_hello(Runtime* rt, const std::shared_ptr<Conn>& c,
                      const std::string& body);
void tpu_handle_hello_ack(Runtime* rt, const std::shared_ptr<Conn>& c,
                          const std::string& body);

void tpu_parse(Runtime* rt, const std::shared_ptr<Conn>& c) {
  RBuf& buf = c->rbuf;
  TpuState* t = c->tpu.get();
  for (;;) {
    size_t avail = buf.size - c->rpos;
    if (avail < kTpuHdrSize) break;
    const uint8_t* p = buf.data + c->rpos;
    if (memcmp(p, "TPUC", 4) != 0) {
      conn_fail(rt, c, DPE_PROTOCOL, "bad tunnel magic");
      return;
    }
    uint8_t ftype = p[4];
    uint32_t blen = ntohl(*reinterpret_cast<const uint32_t*>(p + 5));
    if (ftype < TFT_HELLO || ftype > TFT_BYE || blen > (32u << 20)) {
      conn_fail(rt, c, DPE_PROTOCOL, "bad tunnel frame");
      return;
    }
    if (avail < kTpuHdrSize + blen) break;
    const uint8_t* body = p + kTpuHdrSize;
    const uint32_t frame_len = blen;
    if (ftype == TFT_DATA || ftype == TFT_ACK) {
      // v2 peer: strip the window-generation word; a frame of another
      // generation (never sent by a live peer: the engine does not rebuild
      // a tunnel in place) is dropped without credit, as the Python lane
      // drops it
      uint32_t ew = tpu_epoch_words(t);
      if (blen < ew) {
        conn_fail(rt, c, DPE_PROTOCOL, "short tunnel frame");
        return;
      }
      if (ew && ntohl(*reinterpret_cast<const uint32_t*>(body)) !=
                    t->epoch) {
        c->rpos += kTpuHdrSize + frame_len;
        continue;
      }
      body += ew;
      blen -= ew;
      // the peer sends DATA/ACK only after it mapped our pool (on its
      // HELLO_ACK): the name can go
      if (c->is_server && t != nullptr &&
          !t->pool_unlinked.load(std::memory_order_relaxed)) {
        t->unlink_pool();
      }
    }
    switch (ftype) {
      case TFT_HELLO:
        tpu_handle_hello(rt, c, std::string(
            reinterpret_cast<const char*>(body), blen));
        break;
      case TFT_HELLO_ACK:
        tpu_handle_hello_ack(rt, c, std::string(
            reinterpret_cast<const char*>(body), blen));
        break;
      case TFT_DATA: {
        if (blen < 8) {
          conn_fail(rt, c, DPE_PROTOCOL, "short DATA frame");
          return;
        }
        uint32_t inline_len = ntohl(*reinterpret_cast<const uint32_t*>(body));
        uint32_t nsegs = ntohl(*reinterpret_cast<const uint32_t*>(body + 4));
        if (8 + uint64_t(inline_len) + uint64_t(nsegs) * 8 > blen ||
            nsegs > 4096) {
          conn_fail(rt, c, DPE_PROTOCOL, "bad DATA frame");
          return;
        }
        if (inline_len == 0 && nsegs > 0 && c->sbuf.size == c->spos &&
            t != nullptr && t->pool != nullptr &&
            tpu_try_zero_copy(rt, c, t, body, nsegs)) {
          if (c->failed.load()) return;
          c->rpos += kTpuHdrSize + frame_len;
          continue;  // consumed without touching the stream buffer
        }
        if (inline_len) {
          memcpy(c->sbuf.tail(inline_len), body + 8, inline_len);
          c->sbuf.size += inline_len;
        }
        if (nsegs) {
          // presize the reassembled stream to the frame being built: the
          // stream head names its total length (TRPC/TSTR header)
          size_t shave = c->sbuf.size - c->spos;
          if (shave >= kHeaderSize) {
            const uint8_t* sp = c->sbuf.data + c->spos;
            if (!memcmp(sp, "TRPC", 4) || !memcmp(sp, "TSTR", 4)) {
              uint64_t ftotal = kHeaderSize +
                  uint64_t(ntohl(*reinterpret_cast<const uint32_t*>(
                      sp + 4))) +
                  uint64_t(ntohl(*reinterpret_cast<const uint32_t*>(
                      sp + 8)));
              if (ftotal <= rt->max_body + kHeaderSize) {
                c->sbuf.reserve(c->spos + ftotal);
              }
            }
          }
          // copy the peer-written registered blocks into the stream, then
          // return the credits (reference explicit-ACK sliding window)
          std::string ack;
          ack.resize(4 + size_t(nsegs) * 4);
          uint32_t n_be = htonl(nsegs);
          memcpy(&ack[0], &n_be, 4);
          const uint8_t* sp = body + 8 + inline_len;
          for (uint32_t i = 0; i < nsegs; i++) {
            uint32_t idx = ntohl(*reinterpret_cast<const uint32_t*>(
                sp + i * 8));
            uint32_t ln = ntohl(*reinterpret_cast<const uint32_t*>(
                sp + i * 8 + 4));
            if (t == nullptr || t->pool == nullptr || idx >= t->bc ||
                ln > t->bs) {
              conn_fail(rt, c, DPE_PROTOCOL, "bad block ref");
              return;
            }
            memcpy(c->sbuf.tail(ln), t->pool + size_t(idx) * t->bs, ln);
            c->sbuf.size += ln;
            uint32_t idx_be = htonl(idx);
            memcpy(&ack[4 + size_t(i) * 4], &idx_be, 4);
          }
          const uint8_t* ab[1] = {
              reinterpret_cast<const uint8_t*>(ack.data())};
          const uint64_t al[1] = {ack.size()};
          if (tpu_ctrl_send(rt, c, TFT_ACK, ab, al, 1) != DPE_OK) {
            conn_fail(rt, c, DPE_IO, "ACK send failed");
            return;
          }
        }
        break;
      }
      case TFT_ACK: {
        if (blen < 4) break;
        uint32_t n = ntohl(*reinterpret_cast<const uint32_t*>(body));
        if (4 + uint64_t(n) * 4 > blen) break;
        if (t != nullptr) {
          {
            std::lock_guard<std::mutex> lk(t->cmu);
            for (uint32_t i = 0; i < n; i++) {
              uint32_t idx = ntohl(*reinterpret_cast<const uint32_t*>(
                  body + 4 + size_t(i) * 4));
              // only blocks actually in flight earn a credit back:
              // replayed/forged ACKs must not inflate the window or hand
              // a block to two writers at once
              if (idx < t->peer_bc && idx < t->inflight.size() &&
                  t->inflight[idx]) {
                t->inflight[idx] = 0;
                t->credits.push_back(idx);
              }
            }
          }
          t->ccv.notify_all();
        }
        break;
      }
      case TFT_BYE:
        conn_fail(rt, c, DPE_EOF, "peer sent BYE");
        return;
    }
    if (c->failed.load()) return;
    c->rpos += kTpuHdrSize + frame_len;
  }
  // compact the wire buffer
  if (c->rpos == buf.size) {
    buf.size = 0;
    c->rpos = 0;
  } else if (c->rpos > (1 << 20)) {
    memmove(buf.data, buf.data + c->rpos, buf.size - c->rpos);
    buf.size -= c->rpos;
    c->rpos = 0;
  }
  // cut RPC messages from the reassembled stream — same cutter as TCP
  cut_trpc(rt, c, c->sbuf, c->spos, /*allow_detach=*/false);
}

// --------------------------------------------------------- h2 parse side
int flush_conn_pending(Runtime* rt, const std::shared_ptr<Conn>& c);
void queue_packet(Runtime* rt, const std::shared_ptr<Conn>& c,
                  const std::string& head, const uint8_t* payload,
                  uint64_t plen, const uint8_t* att, uint64_t alen);

// EV_REQUEST for a grpc stream — same packed layout as
// batch_fast_request, pushed directly (h2 frames are not batch-cut).
// ``strip``: stream whose inbound buffers are dropped BEFORE the event
// is pushed — the instant the poller can see the event it may respond
// and erase the stream node, so the parse loop must not touch it after.
void h2_push_request_event(Runtime* rt, Conn* c, const MetaLite& m,
                           const uint8_t* body, uint64_t body_len,
                           H2Stream* strip) {
  size_t hdr = sizeof(ReqLite) + m.service.size() + m.method.size();
  uint8_t* blk = static_cast<uint8_t*>(malloc(hdr + body_len + 1));
  ReqLite rl{};
  rl.cid = m.correlation_id;
  rl.attempt = 0;
  rl.att_size = 0;
  rl.log_id = 0;
  rl.trace_id = 0;
  rl.span_id = 0;
  rl.timeout_ms = int32_t(m.timeout_ms);
  rl.svc_len = uint16_t(m.service.size());
  rl.meth_len = uint16_t(m.method.size());
  memcpy(blk, &rl, sizeof(rl));
  memcpy(blk + sizeof(rl), m.service.data(), m.service.size());
  memcpy(blk + sizeof(rl) + m.service.size(), m.method.data(),
         m.method.size());
  memcpy(blk + hdr, body, body_len);
  if (strip != nullptr) {  // body was just copied; see the contract above
    strip->data.clear();
    strip->data.shrink_to_fit();
    strip->headers.clear();
  }
  DpEvent ev{};
  ev.kind = EV_REQUEST;
  ev.conn_id = c->id;
  ev.aux = int64_t(m.correlation_id);
  ev.base = blk;
  ev.meta = blk;
  ev.meta_len = hdr;
  ev.body = blk + hdr;
  ev.body_len = body_len;
  push_event(rt, ev);
}

// Client-side completion: a response stream finished (trailers or
// headers-only reply). Completes the parked sync waiter, else pushes
// EV_RESPONSE with the batch_fast_response layout.
void h2_client_complete(Runtime* rt, const std::shared_ptr<Conn>& c,
                        uint32_t sid) {
  H2State* h = c->h2.get();
  H2Stream st;
  {
    std::lock_guard<std::mutex> lk(h->mu);
    auto it = h->streams.find(sid);
    if (it == h->streams.end()) return;
    st = std::move(it->second);
    h->streams.erase(it);
  }
  int gstatus = -1;
  std::string gmsg;
  std::string http_status;
  for (auto& kv : st.headers) {
    if (kv.first == "grpc-status") gstatus = atoi(kv.second.c_str());
    else if (kv.first == "grpc-message") gmsg = kv.second;
    else if (kv.first == ":status") http_status = kv.second;
  }
  int code;
  if (gstatus == 0) {
    code = 0;
  } else if (gstatus > 0) {
    code = brpc_code_of_grpc(gstatus);
  } else {
    code = 2002;  // ERESPONSE: no grpc-status at all
    gmsg = "missing grpc-status (:status " + http_status + ")";
  }
  const uint8_t* body = nullptr;
  uint64_t blen = 0;
  if (code == 0) {
    // a grpc-status-0 response MUST carry one well-formed identity
    // message; a short/truncated/compressed frame is ERESPONSE, not a
    // silently-empty success (mirrors the server-side rejects)
    if (st.data.size() < 5 || st.data[0] != 0) {
      code = 2002;
      gmsg = "bad grpc response frame";
    } else {
      uint32_t mlen = ntohl(*reinterpret_cast<const uint32_t*>(
          st.data.data() + 1));
      if (uint64_t(mlen) + 5 > st.data.size()) {
        code = 2002;
        gmsg = "grpc response frame truncated";
      } else {
        body = reinterpret_cast<const uint8_t*>(st.data.data()) + 5;
        blen = mlen;
      }
    }
  }
  c->in_msgs.fetch_add(1, std::memory_order_relaxed);
  SyncWaiter* w = sync_take_conn(rt, st.cid, c->id);
  if (w != nullptr) {
    uint8_t* blk = static_cast<uint8_t*>(malloc(blen ? blen : 1));
    if (blen) memcpy(blk, body, blen);
    sync_complete(w, code, 0, 0, gmsg.data(), gmsg.size(), blk, blk,
                  blen);
    return;
  }
  if (!c->py_fast.load(std::memory_order_relaxed)) return;
  size_t hdr = sizeof(RespLite) + (code ? gmsg.size() : 0);
  uint8_t* blk = static_cast<uint8_t*>(malloc(hdr + blen + 1));
  RespLite rl{};
  memcpy(blk, &rl, sizeof(rl));
  if (code && !gmsg.empty()) {
    memcpy(blk + sizeof(rl), gmsg.data(), gmsg.size());
  }
  if (blen) memcpy(blk + hdr, body, blen);
  DpEvent ev{};
  ev.kind = EV_RESPONSE;
  ev.tag = code;
  ev.conn_id = c->id;
  ev.aux = int64_t(st.cid);
  ev.base = blk;
  ev.meta = blk;
  ev.meta_len = hdr;
  ev.body = blk + hdr;
  ev.body_len = blen;
  push_event(rt, ev);
}

std::string h2_settings_prefix() {
  // SETTINGS{MAX_CONCURRENT_STREAMS, INITIAL_WINDOW_SIZE, MAX_FRAME_SIZE}
  // + conn WINDOW_UPDATE up to kH2RecvWindow
  std::string o;
  std::string body;
  auto put16 = [&](uint16_t v) {
    uint16_t be = htons(v);
    body.append(reinterpret_cast<const char*>(&be), 2);
  };
  auto put32 = [&](uint32_t v) {
    uint32_t be = htonl(v);
    body.append(reinterpret_cast<const char*>(&be), 4);
  };
  put16(0x3); put32(1024);            // MAX_CONCURRENT_STREAMS
  put16(0x4); put32(kH2RecvWindow);   // INITIAL_WINDOW_SIZE
  put16(0x5); put32(kH2MaxFrame);     // MAX_FRAME_SIZE
  h2_frame_hdr(&o, uint32_t(body.size()), H2F_SETTINGS, 0, 0);
  o.append(body);
  std::string wu;
  uint32_t inc = htonl(kH2RecvWindow - 65535);
  wu.append(reinterpret_cast<const char*>(&inc), 4);
  h2_frame_hdr(&o, 4, H2F_WINUP, 0, 0);
  o.append(wu);
  return o;
}

// Emit whatever the peer's windows allow for one stream (h->mu held).
// Appends DATA frames (grpc-framed bytes already in st->out) and, once
// drained, the server trailers / client END_STREAM.
void h2_emit_stream(H2State* h, uint32_t sid, H2Stream* st,
                    std::string* frames) {
  while (st->out_off < st->out.size()) {
    int64_t win = std::min(st->send_window, h->conn_send_window);
    if (win <= 0) return;  // parked until WINDOW_UPDATE
    uint64_t chunk = std::min<uint64_t>(
        std::min<uint64_t>(uint64_t(win), st->out.size() - st->out_off),
        h->peer_max_frame);
    bool last = (st->out_off + chunk == st->out.size());
    uint8_t fl = (last && st->end_after_out && st->trailers.empty())
                     ? H2FL_END_STREAM : 0;
    h2_frame_hdr(frames, uint32_t(chunk), H2F_DATA, fl, sid);
    frames->append(st->out.data() + st->out_off, size_t(chunk));
    st->out_off += size_t(chunk);
    st->send_window -= int64_t(chunk);
    h->conn_send_window -= int64_t(chunk);
  }
  if (st->out_off >= st->out.size()) {
    if (!st->trailers.empty()) {
      frames->append(st->trailers);
      st->trailers.clear();
    }
    st->sent_all = true;
  }
}

// Re-try parked streams after a WINDOW_UPDATE / SETTINGS change (loop
// thread). h->mu is held across the emit AND the write: per-stream frame
// order is the h->mu acquisition order, so a pump can never overtake the
// HEADERS+first-chunk a responder emitted under the same lock (pending
// flushes first for the queued-respond case).
void h2_pump(Runtime* rt, const std::shared_ptr<Conn>& c) {
  H2State* h = c->h2.get();
  std::string frames;
  std::vector<uint32_t> done;
  std::lock_guard<std::mutex> lk(h->mu);
  for (auto& kv : h->streams) {
    if (kv.second.out_off < kv.second.out.size() ||
        !kv.second.trailers.empty()) {
      h2_emit_stream(h, kv.first, &kv.second, &frames);
      if (kv.second.sent_all && !h->client) done.push_back(kv.first);
    }
  }
  for (uint32_t sid : done) h->streams.erase(sid);
  if (!frames.empty()) {
    flush_conn_pending(rt, c);
    conn_write(rt, c, reinterpret_cast<const uint8_t*>(frames.data()),
               frames.size());
  }
}

// Server-side grpc response, entirely in-engine. Called from the parse
// loop (native echo / rejects) and from dp_respond (Python services).
int h2_grpc_respond(Runtime* rt, const std::shared_ptr<Conn>& c,
                    uint32_t sid, int code, const char* etext,
                    uint64_t etext_len, const uint8_t* payload,
                    uint64_t plen, const uint8_t* att, uint64_t alen,
                    int queue) {
  H2State* h = c->h2.get();
  std::string hb;
  hp_put_indexed(&hb, 8);  // :status 200
  hp_put_literal(&hb, 31, nullptr, "application/grpc", 16);
  std::string frames;
  h2_frame_hdr(&frames, uint32_t(hb.size()), H2F_HEADERS, H2FL_END_HEADERS,
               sid);
  frames.append(hb);
  std::string msg;  // grpc length-prefixed message (payload + attachment)
  if (code == 0) {
    uint64_t mlen = plen + alen;
    msg.reserve(5 + mlen);
    msg.push_back(0);
    uint32_t be = htonl(uint32_t(mlen));
    msg.append(reinterpret_cast<const char*>(&be), 4);
    if (plen) msg.append(reinterpret_cast<const char*>(payload),
                         size_t(plen));
    if (alen) msg.append(reinterpret_cast<const char*>(att), size_t(alen));
  }
  std::string tb;
  std::string gs = std::to_string(grpc_status_of(code));
  hp_put_literal(&tb, 0, "grpc-status", gs.data(), gs.size());
  if (code != 0 && etext_len) {
    hp_put_literal(&tb, 0, "grpc-message",
                   reinterpret_cast<const char*>(etext),
                   size_t(etext_len));
  }
  std::string trailers;
  h2_frame_hdr(&trailers, uint32_t(tb.size()), H2F_HEADERS,
               H2FL_END_HEADERS | H2FL_END_STREAM, sid);
  trailers.append(tb);
  // h->mu is held through the write/enqueue: a WINDOW_UPDATE pump on the
  // loop thread must not interleave this stream's continuation ahead of
  // the HEADERS + first chunk emitted here (lock order: h->mu -> pmu/wmu)
  std::lock_guard<std::mutex> lk(h->mu);
  auto it = h->streams.find(sid);
  if (it == h->streams.end()) {
    // stream already gone (client RST / conn teardown): dropping the
    // response is the h2 contract — resurrecting the sid would send
    // frames on a closed stream
    return DPE_OK;
  }
  H2Stream& st = it->second;
  st.out = std::move(msg);
  st.out_off = 0;
  st.trailers = std::move(trailers);
  h2_emit_stream(h, sid, &st, &frames);
  if (st.sent_all) h->streams.erase(it);
  if (queue) {
    queue_packet(rt, c, frames, nullptr, 0, nullptr, 0);
    return DPE_OK;
  }
  return conn_write(rt, c,
                    reinterpret_cast<const uint8_t*>(frames.data()),
                    frames.size());
}

// Client-side grpc request: HEADERS + flow-controlled DATA(+END_STREAM).
// The attachment rides the body (grpc has no attachment concept —
// policy/grpc_protocol.py does the same).
int h2_grpc_call(Runtime* rt, const std::shared_ptr<Conn>& c,
                 const char* svc, uint64_t svc_len, const char* meth,
                 uint64_t meth_len, uint64_t cid, int32_t timeout_ms,
                 const uint8_t* payload, uint64_t plen,
                 const uint8_t* att, uint64_t alen, int queue) {
  H2State* h = c->h2.get();
  std::string path;
  path.reserve(svc_len + meth_len + 2);
  path.push_back('/');
  path.append(svc, svc_len);
  path.push_back('/');
  path.append(meth, meth_len);
  std::string hb;
  hp_put_indexed(&hb, 3);  // :method POST
  hp_put_indexed(&hb, 6);  // :scheme http
  hp_put_literal(&hb, 4, nullptr, path.data(), path.size());
  hp_put_literal(&hb, 1, nullptr, h->authority.data(),
                 h->authority.size());
  hp_put_literal(&hb, 31, nullptr, "application/grpc", 16);
  hp_put_literal(&hb, 0, "te", "trailers", 8);
  std::string tv;
  if (timeout_ms > 0) {
    tv = std::to_string(timeout_ms) + "m";
    hp_put_literal(&hb, 0, "grpc-timeout", tv.data(), tv.size());
  }
  std::string msg;
  msg.reserve(5 + plen + alen);
  msg.push_back(0);
  uint32_t be = htonl(uint32_t(plen + alen));
  msg.append(reinterpret_cast<const char*>(&be), 4);
  if (plen) msg.append(reinterpret_cast<const char*>(payload),
                       size_t(plen));
  if (alen) msg.append(reinterpret_cast<const char*>(att), size_t(alen));
  std::string frames;
  // h->mu held from sid allocation through the write/enqueue: RFC 9113
  // requires monotonically increasing stream ids ON THE WIRE, so the
  // allocation and the socket handoff must be one atomic step when
  // several threads share the conn (channel "single" semantics)
  std::lock_guard<std::mutex> lk(h->mu);
  uint32_t sid = h->next_stream_id;
  h->next_stream_id += 2;
  h2_frame_hdr(&frames, uint32_t(hb.size()), H2F_HEADERS,
               H2FL_END_HEADERS, sid);
  frames.append(hb);
  H2Stream& st = h->streams[sid];
  st.send_window = int64_t(h->peer_initial_window);
  st.cid = cid;
  st.headers_done = false;
  st.out = std::move(msg);
  st.end_after_out = true;
  h2_emit_stream(h, sid, &st, &frames);
  // the stream node survives until the response completes it
  if (queue) {
    queue_packet(rt, c, frames, nullptr, 0, nullptr, 0);
    return DPE_OK;
  }
  return conn_write(rt, c,
                    reinterpret_cast<const uint8_t*>(frames.data()),
                    frames.size());
}

// Completed inbound server stream -> native echo / EV_REQUEST / reject.
void h2_dispatch(Runtime* rt, const std::shared_ptr<Conn>& c, uint32_t sid,
                 H2Stream* st) {
  std::string path, ctype, timeout;
  for (auto& kv : st->headers) {
    if (kv.first == ":path") path = kv.second;
    else if (kv.first == "content-type") ctype = kv.second;
    else if (kv.first == "grpc-timeout") timeout = kv.second;
  }
  c->in_msgs.fetch_add(1, std::memory_order_relaxed);
  if (ctype.compare(0, 16, "application/grpc") != 0) {
    static const char e[] = "not a grpc request";
    h2_grpc_respond(rt, c, sid, 1002, e, sizeof(e) - 1, nullptr, 0,
                    nullptr, 0, /*queue=*/0);
    return;
  }
  // "/pkg.Service/Method" — Python registers bare names; take the last
  // dot component (grpc_protocol.py does the same)
  size_t s1 = path.find('/', 1);
  if (path.empty() || path[0] != '/' || s1 == std::string::npos) {
    static const char e[] = "bad grpc path";
    h2_grpc_respond(rt, c, sid, 1002, e, sizeof(e) - 1, nullptr, 0,
                    nullptr, 0, 0);
    return;
  }
  std::string svc_full = path.substr(1, s1 - 1);
  std::string meth = path.substr(s1 + 1);
  size_t dot = svc_full.rfind('.');
  std::string svc =
      dot == std::string::npos ? svc_full : svc_full.substr(dot + 1);
  if (svc.size() > 0xffff || meth.size() > 0xffff) {
    // the packed EV_REQUEST carries u16 name lengths
    static const char e[] = "grpc service or method name too long";
    h2_grpc_respond(rt, c, sid, 1003, e, sizeof(e) - 1, nullptr, 0,
                    nullptr, 0, 0);
    return;
  }
  // grpc message framing: flag byte (0 = identity) + u32 length
  if (st->data.size() < 5 || st->data[0] != 0) {
    static const char e[] = "bad grpc frame";
    h2_grpc_respond(rt, c, sid, 1003, e, sizeof(e) - 1, nullptr, 0,
                    nullptr, 0, 0);
    return;
  }
  uint32_t mlen = ntohl(*reinterpret_cast<const uint32_t*>(
      st->data.data() + 1));
  if (uint64_t(mlen) + 5 > st->data.size()) {
    static const char e[] = "grpc frame truncated";
    h2_grpc_respond(rt, c, sid, 1003, e, sizeof(e) - 1, nullptr, 0,
                    nullptr, 0, 0);
    return;
  }
  const uint8_t* body =
      reinterpret_cast<const uint8_t*>(st->data.data()) + 5;
  MetaLite m;
  m.has_request = true;
  m.correlation_id = sid;
  m.service = svc;
  m.method = meth;
  m.timeout_ms = parse_grpc_timeout(timeout);
  EchoAdmit admit;
  if (echo_admit(rt, c.get(), m, &admit)) {
    // native service: answer in-engine (C++ user code lane, grpc flavor)
    int code = admit.ecode;
    h2_grpc_respond(rt, c, sid, code, admit.etext,
                    code ? strlen(admit.etext) : 0, code ? nullptr : body,
                    code ? 0 : mlen, nullptr, 0, 0);
    echo_settle(&admit);
    return;
  }
  if (c->py_fast.load(std::memory_order_relaxed)) {
    // EV_REQUEST fast path: same packed layout as the std protocol.
    // After the push the poller may respond + erase the stream node at
    // any moment — st must not be touched again on this thread.
    m.attachment_size = 0;
    h2_push_request_event(rt, c.get(), m, body, mlen, st);
    return;
  }
  static const char e[] = "no such grpc service";
  h2_grpc_respond(rt, c, sid, 1001, e, sizeof(e) - 1, nullptr, 0, nullptr,
                  0, 0);
}

// Parse loop for an h2 conn (server sniff + engine-owned, both roles).
void h2_parse_inner(Runtime* rt, const std::shared_ptr<Conn>& c) {
  H2State* h = c->h2.get();
  RBuf& buf = c->rbuf;
  for (;;) {
    size_t avail = buf.size - c->rpos;
    const uint8_t* p = buf.data + c->rpos;
    if (h->phase == 0) {  // server: await the full client preface
      if (avail < kH2PrefaceLen) return;
      if (memcmp(p, kH2Preface, kH2PrefaceLen) != 0) {
        conn_fail(rt, c, DPE_PROTOCOL, "bad h2 preface");
        return;
      }
      h->prelude.append(reinterpret_cast<const char*>(p), kH2PrefaceLen);
      c->rpos += kH2PrefaceLen;
      h->phase = 1;
      continue;
    }
    if (avail < 9) return;
    uint32_t flen = (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | p[2];
    uint8_t type = p[3];
    uint8_t flags = p[4];
    uint32_t sid = ntohl(*reinterpret_cast<const uint32_t*>(p + 5))
                   & 0x7fffffffu;
    if (flen > kH2MaxFrame + 1024) {
      conn_fail(rt, c, DPE_PROTOCOL, "h2 frame too large");
      return;
    }
    if (avail < 9 + uint64_t(flen)) return;
    const uint8_t* fp = p + 9;
    static const bool h2dbg = getenv("DP_H2_DEBUG") != nullptr;
    if (h2dbg) {
      fprintf(stderr, "[dp] h2 frame type=%d flags=%d sid=%u flen=%u phase=%d client=%d\n",
              type, flags, sid, flen, h->phase, int(h->client));
    }
    if (h->phase == 1) {
      h->prelude.append(reinterpret_cast<const char*>(p), 9 + flen);
      // before the first HEADERS every frame is kept for a possible
      // detach; the header block itself is capped below
      if (type != H2F_HEADERS && type != H2F_CONT &&
          h->prelude.size() + h->pending_ctrl.size() > kH2MaxPrelude) {
        conn_fail(rt, c, DPE_PROTOCOL, "h2 prelude too large");
        return;
      }
    }
    c->rpos += 9 + flen;
    switch (type) {
      case H2F_SETTINGS: {
        if (flags & H2FL_ACK) break;
        for (uint32_t off = 0; off + 6 <= flen; off += 6) {
          uint16_t id = ntohs(*reinterpret_cast<const uint16_t*>(
              fp + off));
          uint32_t val = ntohl(*reinterpret_cast<const uint32_t*>(
              fp + off + 2));
          std::lock_guard<std::mutex> lk(h->mu);
          if (id == 0x4 && val > 0x7fffffffu) {
            // RFC 9113 §6.5.2: a FLOW_CONTROL_ERROR on the connection
            std::string ga;
            h2_frame_hdr(&ga, 8, H2F_GOAWAY, 0, 0);
            uint32_t last = 0, ec = htonl(kH2ErrFlowControl);
            ga.append(reinterpret_cast<const char*>(&last), 4);
            ga.append(reinterpret_cast<const char*>(&ec), 4);
            conn_write(rt, c, reinterpret_cast<const uint8_t*>(ga.data()),
                       ga.size());
            conn_fail(rt, c, DPE_PROTOCOL,
                      "h2 INITIAL_WINDOW_SIZE above 2^31-1");
            return;
          }
          if (id == 0x4) {  // INITIAL_WINDOW_SIZE: adjust live streams
            int64_t delta =
                int64_t(val) - int64_t(h->peer_initial_window);
            h->peer_initial_window = val;
            for (auto& kv : h->streams) kv.second.send_window += delta;
          } else if (id == 0x5 && val >= 16384 && val <= (1u << 24)) {
            h->peer_max_frame = val;
          }
        }
        if (h->phase == 2) {
          std::string ack;
          h2_frame_hdr(&ack, 0, H2F_SETTINGS, H2FL_ACK, 0);
          conn_write(rt, c,
                     reinterpret_cast<const uint8_t*>(ack.data()),
                     ack.size());
          h2_pump(rt, c);  // window growth may release parked data
        } else {
          h->unacked_settings++;
        }
        break;
      }
      case H2F_PING: {
        if (flags & H2FL_ACK) break;
        std::string pong;
        h2_frame_hdr(&pong, flen, H2F_PING, H2FL_ACK, 0);
        pong.append(reinterpret_cast<const char*>(fp), flen);
        if (h->phase == 2) {
          conn_write(rt, c,
                     reinterpret_cast<const uint8_t*>(pong.data()),
                     pong.size());
        } else {
          h->pending_ctrl.append(pong);  // replied only if we engage
        }
        break;
      }
      case H2F_WINUP: {
        if (flen != 4) break;
        uint32_t inc = ntohl(*reinterpret_cast<const uint32_t*>(fp))
                       & 0x7fffffffu;
        {
          std::lock_guard<std::mutex> lk(h->mu);
          if (sid == 0) {
            h->conn_send_window += inc;
          } else {
            auto it = h->streams.find(sid);
            if (it != h->streams.end()) it->second.send_window += inc;
          }
        }
        if (h->phase == 2) h2_pump(rt, c);
        break;
      }
      case H2F_RST: {
        uint64_t cancelled_cid = 0;
        {
          std::lock_guard<std::mutex> lk(h->mu);
          auto it = h->streams.find(sid);
          if (it != h->streams.end()) {
            cancelled_cid = it->second.cid;
            h->streams.erase(it);
          }
        }
        if (h->client && cancelled_cid != 0) {
          // the in-flight call must complete, not hang (ECANCELED=1015)
          SyncWaiter* w = sync_take_conn(rt, cancelled_cid, c->id);
          static const char kRst[] = "stream reset by peer";
          if (w != nullptr) {
            uint8_t* blk = static_cast<uint8_t*>(malloc(1));
            sync_complete(w, 1015, 0, 0, kRst, sizeof(kRst) - 1, blk,
                          blk, 0);
          } else if (c->py_fast.load(std::memory_order_relaxed)) {
            size_t hdr = sizeof(RespLite) + sizeof(kRst) - 1;
            uint8_t* blk = static_cast<uint8_t*>(malloc(hdr + 1));
            RespLite rl{};
            memcpy(blk, &rl, sizeof(rl));
            memcpy(blk + sizeof(rl), kRst, sizeof(kRst) - 1);
            DpEvent ev{};
            ev.kind = EV_RESPONSE;
            ev.tag = 1015;
            ev.conn_id = c->id;
            ev.aux = int64_t(cancelled_cid);
            ev.base = blk;
            ev.meta = blk;
            ev.meta_len = hdr;
            push_event(rt, ev);
          }
        }
        break;
      }
      case H2F_GOAWAY:
        if (h->client) {
          conn_fail(rt, c, DPE_EOF, "h2 GOAWAY");
          return;
        }
        break;
      case H2F_HEADERS:
      case H2F_CONT: {
        const uint8_t* hb = fp;
        uint32_t hlen = flen;
        if (type == H2F_HEADERS) {
          if (flags & H2FL_PADDED) {
            if (!hlen) break;
            uint8_t pad = hb[0];
            hb++;
            hlen--;
            if (pad > hlen) break;
            hlen -= pad;
          }
          if (flags & H2FL_PRIORITY) {
            if (hlen < 5) break;
            hb += 5;
            hlen -= 5;
          }
          h->cont_sid = sid;
          h->cont_flags = flags;
          h->cont_buf.assign(reinterpret_cast<const char*>(hb), hlen);
        } else {
          if (sid != h->cont_sid) break;
          h->cont_buf.append(reinterpret_cast<const char*>(hb), hlen);
          h->cont_flags |= (flags & H2FL_END_HEADERS);
        }
        if (h->cont_buf.size() > kH2MaxHeaderBlock) {
          conn_fail(rt, c, DPE_PROTOCOL, "h2 header block too large");
          return;
        }
        if (!(h->cont_flags & H2FL_END_HEADERS)) {
          break;  // CONTINUATION follows
        }
        HdrList hdrs;
        if (!hpack_decode_block(
                &h->dec,
                reinterpret_cast<const uint8_t*>(h->cont_buf.data()),
                h->cont_buf.size(), &hdrs)) {
          conn_fail(rt, c, DPE_PROTOCOL, "hpack decode failed");
          return;
        }
        h->cont_buf.clear();
        bool end_stream = (h->cont_flags & H2FL_END_STREAM) != 0;
        if (h->phase == 1) {
          // the sniff decision: first request grpc -> engine; else the
          // Python h2 stack takes the conn (raw bytes replayed)
          std::string ctype;
          for (auto& kv : hdrs) {
            if (kv.first == "content-type") ctype = kv.second;
          }
          if (ctype.compare(0, 16, "application/grpc") == 0) {
            h->phase = 2;
            std::string pre = h2_settings_prefix();
            for (; h->unacked_settings > 0; h->unacked_settings--) {
              h2_frame_hdr(&pre, 0, H2F_SETTINGS, H2FL_ACK, 0);
            }
            pre.append(h->pending_ctrl);
            h->pending_ctrl.clear();
            h->prelude.clear();
            h->prelude.shrink_to_fit();
            conn_write(rt, c,
                       reinterpret_cast<const uint8_t*>(pre.data()),
                       pre.size());
          } else {
            conn_detach(rt, c, &h->prelude);
            return;
          }
        }
        H2Stream* st;
        {
          std::unique_lock<std::mutex> lk(h->mu);
          if (!h->client && h->streams.size() >= kH2MaxStreams &&
              h->streams.find(sid) == h->streams.end()) {
            // past the advertised MAX_CONCURRENT_STREAMS: refuse the
            // stream (RFC 9113 §5.1.2); its DATA then finds no stream
            lk.unlock();
            std::string rst;
            h2_frame_hdr(&rst, 4, H2F_RST, 0, sid);
            uint32_t ec = htonl(kH2ErrRefusedStream);
            rst.append(reinterpret_cast<const char*>(&ec), 4);
            conn_write(rt, c, reinterpret_cast<const uint8_t*>(rst.data()),
                       rst.size());
            break;
          }
          auto ins = h->streams.try_emplace(sid);
          st = &ins.first->second;
          if (ins.second) {
            st->send_window = int64_t(h->peer_initial_window);
          }
          if (!st->headers_done) {
            st->headers = std::move(hdrs);
            st->headers_done = true;
          } else {
            // trailers (client side: grpc-status etc.)
            for (auto& kv : hdrs) st->headers.push_back(std::move(kv));
          }
        }
        if (end_stream) {
          if (h->client) {
            h2_client_complete(rt, c, sid);
          } else {
            h2_dispatch(rt, c, sid, st);
            std::lock_guard<std::mutex> lk(h->mu);
            auto it = h->streams.find(sid);
            // keep only streams with parked response bytes
            if (it != h->streams.end() && it->second.sent_all) {
              h->streams.erase(it);
            }
          }
        }
        break;
      }
      case H2F_DATA: {
        const uint8_t* db = fp;
        uint32_t dlen = flen;
        if (flags & H2FL_PADDED) {
          if (!dlen) break;
          uint8_t pad = db[0];
          db++;
          dlen--;
          if (pad > dlen) break;
          dlen -= pad;
        }
        bool complete = false;
        {
          std::lock_guard<std::mutex> lk(h->mu);
          auto it = h->streams.find(sid);
          if (it == h->streams.end()) break;
          H2Stream& st = it->second;
          if (st.data.size() + dlen > rt->max_body) {
            conn_fail(rt, c, DPE_PROTOCOL, "grpc body exceeds max_body");
            return;
          }
          st.data.append(reinterpret_cast<const char*>(db), dlen);
          complete = (flags & H2FL_END_STREAM) != 0;
        }
        h->recv_since_update += flen;
        if (h->recv_since_update > kH2RecvWindow / 2) {
          std::string wu;
          uint32_t inc = htonl(uint32_t(h->recv_since_update));
          h2_frame_hdr(&wu, 4, H2F_WINUP, 0, 0);
          wu.append(reinterpret_cast<const char*>(&inc), 4);
          conn_write(rt, c,
                     reinterpret_cast<const uint8_t*>(wu.data()),
                     wu.size());
          h->recv_since_update = 0;
        }
        if (complete) {
          if (h->client) {
            h2_client_complete(rt, c, sid);
          } else {
            H2Stream* st;
            {
              std::lock_guard<std::mutex> lk(h->mu);
              st = &h->streams[sid];
            }
            h2_dispatch(rt, c, sid, st);
            std::lock_guard<std::mutex> lk(h->mu);
            auto it = h->streams.find(sid);
            if (it != h->streams.end() && it->second.sent_all) {
              h->streams.erase(it);
            }
          }
        }
        break;
      }
      default:
        break;  // PRIORITY / PUSH_PROMISE / unknown: ignored
    }
    if (c->failed.load()) return;
  }
}

void h2_parse(Runtime* rt, const std::shared_ptr<Conn>& c) {
  h2_parse_inner(rt, c);
  if (c->failed.load()) return;
  RBuf& buf = c->rbuf;
  if (c->rpos == buf.size) {
    buf.size = 0;
    c->rpos = 0;
  } else if (c->rpos > (1 << 20)) {
    memmove(buf.data, buf.data + c->rpos, buf.size - c->rpos);
    buf.size -= c->rpos;
    c->rpos = 0;
  }
}

// Parse dispatcher (loop thread only).
void conn_parse(Runtime* rt, const std::shared_ptr<Conn>& c) {
  if (c->tpu_mode != 0) {
    tpu_parse(rt, c);
    return;
  }
  if (c->h2_mode != 0) {
    h2_parse(rt, c);
    return;
  }
  // h2c prior-knowledge sniff (server conns on fast-path listeners): the
  // client preface never collides with TRPC/TSTR/TPUC magics
  if (c->is_server && c->py_fast.load(std::memory_order_relaxed)) {
    size_t avail = c->rbuf.size - c->rpos;
    size_t n = avail < kH2PrefaceLen ? avail : kH2PrefaceLen;
    if (n != 0 && memcmp(c->rbuf.data + c->rpos, kH2Preface, n) == 0) {
      if (avail < kH2PrefaceLen) return;  // wait for the whole preface
      c->h2_mode = 2;
      c->h2.reset(new H2State());
      h2_parse(rt, c);
      return;
    }
  }
  // a TPUC HELLO on a tpu-enabled native listener upgrades the conn to a
  // native tunnel endpoint (reference AppConnect handshake-then-switch);
  // on a plain listener it detaches to the Python transport
  if (c->is_server && c->rbuf.size - c->rpos >= 4 &&
      memcmp(c->rbuf.data + c->rpos, "TPUC", 4) == 0) {
    int ordinal = -1;
    {
      std::lock_guard<std::mutex> lk(rt->cmu);
      if (c->listener_id >= 0 &&
          size_t(c->listener_id) < rt->listeners.size()) {
        ordinal = rt->listeners[size_t(c->listener_id)].tpu_ordinal;
      }
    }
    if (ordinal >= 0) {
      c->tpu_mode = 1;
      c->tpu.reset(new TpuState());
      c->tpu->ordinal = ordinal;
      tpu_parse(rt, c);
      return;
    }
  }
  cut_trpc(rt, c, c->rbuf, c->rpos, /*allow_detach=*/true);
}

void conn_readable(Runtime* rt, const std::shared_ptr<Conn>& c) {
  for (;;) {
    // when mid-frame, read the whole remainder in one recv
    size_t want = kReadChunk;
    size_t avail = c->rbuf.size - c->rpos;
    if (avail >= kHeaderSize) {
      const uint8_t* p = c->rbuf.data + c->rpos;
      if (!memcmp(p, "TRPC", 4) || !memcmp(p, "TSTR", 4)) {
        uint64_t total = kHeaderSize +
            uint64_t(ntohl(*reinterpret_cast<const uint32_t*>(p + 4))) +
            uint64_t(ntohl(*reinterpret_cast<const uint32_t*>(p + 8)));
        if (total > avail && total - avail > want &&
            total <= rt->max_body + kHeaderSize) {
          want = total - avail;
        }
      }
    }
    uint8_t* dst = c->rbuf.tail(want);
    ssize_t n = ::recv(c->fd, dst, want, 0);
    if (n > 0) {
      c->rbuf.size += size_t(n);
      c->in_bytes.fetch_add(uint64_t(n), std::memory_order_relaxed);
      conn_parse(rt, c);
      if (c->failed.load()) return;
      if (size_t(n) < want) return;  // drained
    } else if (n == 0) {
      conn_parse(rt, c);
      if (!c->failed.load()) conn_fail(rt, c, DPE_EOF, "peer closed");
      return;
    } else if (errno == EINTR) {
      continue;
    } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
      return;
    } else {
      conn_fail(rt, c, DPE_IO, strerror(errno));
      return;
    }
  }
}

void tpu_handle_hello(Runtime* rt, const std::shared_ptr<Conn>& c,
                      const std::string& body) {
  TpuState* t = c->tpu.get();
  if (t == nullptr || c->tpu_mode == 2 || !c->is_server ||
      t->pool != nullptr) {
    // a client conn (or a conn that already created its pool) must never
    // re-run pool creation — it would leak the prior shm mapping
    conn_fail(rt, c, DPE_PROTOCOL, "unexpected HELLO");
    return;
  }
  std::string pool;
  int64_t bs = 0, bc = 0, requested = 0, peer_v = 1, gen = 0;
  json_str(body, "pool", &pool);
  json_int(body, "bs", &bs);
  json_int(body, "bc", &bc);
  json_int(body, "ordinal", &requested);
  json_int(body, "v", &peer_v);
  json_int(body, "gen", &gen);
  // frame to what the dialer speaks; its generation names the window
  t->peer_v = int(peer_v);
  t->epoch = uint32_t(gen);
  // mirror the dialer's geometry for OUR receive pool (window negotiation:
  // a bulk-transfer client gets a bulk-sized window both ways)
  if (bs > 0 && bc > 0) {
    uint32_t mbs = uint32_t(bs), mbc = uint32_t(bc);
    tpu_clamp_geometry(&mbs, &mbc);
    t->bs = mbs;
    t->bc = mbc;
  }
  if (t->ordinal >= 0 && requested != t->ordinal) {
    // refuse a dial addressed to a device this server does not front
    char err[160];
    snprintf(err, sizeof(err),
             "{\"v\": %d, \"pool\": \"\", \"bs\": 0, \"bc\": 0, "
             "\"ordinal\": %d, \"gen\": %u, \"err\": \"server fronts "
             "device %d, dial requested %d\"}",
             kTpuHandshakeVersion, t->ordinal, t->epoch, t->ordinal,
             int(requested));
    const uint8_t* b[1] = {reinterpret_cast<const uint8_t*>(err)};
    const uint64_t l[1] = {strlen(err)};
    tpu_ctrl_send(rt, c, TFT_HELLO_ACK, b, l, 1);
    conn_fail(rt, c, DPE_PROTOCOL, "device ordinal mismatch");
    return;
  }
  if (!tpu_create_pool(t)) {
    conn_fail(rt, c, DPE_IO, "cannot create shm pool");
    return;
  }
  if (pool.empty() ||
      !tpu_attach_peer(t, pool, uint32_t(bs), uint32_t(bc))) {
    t->inline_only = true;  // cross-host fallback: inline DATA frames only
  }
  std::string ack = tpu_hello_json(t, int(t->ordinal >= 0 ? t->ordinal
                                                          : requested));
  const uint8_t* b[1] = {reinterpret_cast<const uint8_t*>(ack.data())};
  const uint64_t l[1] = {ack.size()};
  if (tpu_ctrl_send(rt, c, TFT_HELLO_ACK, b, l, 1) != DPE_OK) {
    conn_fail(rt, c, DPE_IO, "HELLO_ACK send failed");
    return;
  }
  c->tpu_mode = 2;
}

void tpu_handle_hello_ack(Runtime* rt, const std::shared_ptr<Conn>& c,
                          const std::string& body) {
  TpuState* t = c->tpu.get();
  if (t == nullptr) {
    conn_fail(rt, c, DPE_PROTOCOL, "unexpected HELLO_ACK");
    return;
  }
  std::string err;
  if (json_str(body, "err", &err) && !err.empty()) {
    {
      std::lock_guard<std::mutex> lk(t->hmu);
      t->err = err;
    }
    t->hcv.notify_all();
    conn_fail(rt, c, DPE_PROTOCOL, "handshake refused");
    return;
  }
  std::string pool;
  int64_t bs = 0, bc = 0, peer_v = 1;
  json_str(body, "pool", &pool);
  json_int(body, "bs", &bs);
  json_int(body, "bc", &bc);
  json_int(body, "v", &peer_v);
  t->peer_v = int(peer_v);  // before ready: senders read it after the wait
  t->unlink_pool();  // the server mapped our pool before it answered
  if (pool.empty() ||
      !tpu_attach_peer(t, pool, uint32_t(bs), uint32_t(bc))) {
    t->inline_only = true;
  }
  c->tpu_mode = 2;
  {
    std::lock_guard<std::mutex> lk(t->hmu);
    t->ready = true;
  }
  t->hcv.notify_all();
}

// Ship one RPC packet through the tunnel (reference CutFromIOBufList,
// rdma_endpoint.h:89: post blocks, window--, stream through on exhaustion).
int tpu_send_packet(Runtime* rt, const std::shared_ptr<Conn>& c,
                    const uint8_t* const* bufs, const uint64_t* lens,
                    int nseg) {
  TpuState* t = c->tpu.get();
  if (t == nullptr || c->tpu_mode != 2) return DPE_IO;
  uint64_t total = 0;
  for (int i = 0; i < nseg; i++) total += lens[i];
  std::lock_guard<std::mutex> slk(t->smu);  // frame order IS stream order
  if (c->failed.load()) return DPE_IO;
  int vi = 0;
  uint64_t voff = 0;
  auto copy_out = [&](uint8_t* dst, uint64_t want) -> uint64_t {
    uint64_t done = 0;
    while (done < want && vi < nseg) {
      uint64_t take = lens[vi] - voff;
      if (take > want - done) take = want - done;
      memcpy(dst + done, bufs[vi] + voff, take);
      voff += take;
      done += take;
      if (voff == lens[vi]) {
        vi++;
        voff = 0;
      }
    }
    return done;
  };
  if (t->inline_only || total <= kTpuInlineMax) {
    uint64_t left = total;
    while (left > 0 || total == 0) {
      uint64_t part = left < kTpuBlockSize ? left : kTpuBlockSize;
      std::string body;
      body.resize(8 + part);
      uint32_t il_be = htonl(uint32_t(part));
      uint32_t z = 0;
      memcpy(&body[0], &il_be, 4);
      memcpy(&body[4], &z, 4);
      copy_out(reinterpret_cast<uint8_t*>(&body[8]), part);
      const uint8_t* b[1] = {reinterpret_cast<const uint8_t*>(body.data())};
      const uint64_t l[1] = {body.size()};
      int rc = tpu_ctrl_send(rt, c, TFT_DATA, b, l, 1);
      if (rc != DPE_OK) {
        if (left != total) {
          // mid-packet failure desyncs the stream for good
          loop_submit(rt, c->loop, [rt, c] {
            conn_fail(rt, c, DPE_IO, "mid-packet tunnel send failure");
          });
        }
        return rc;
      }
      left -= part;
      if (total == 0) break;
    }
    return DPE_OK;
  }
  uint64_t sent = 0;
  while (sent < total) {
    uint32_t want_blocks =
        uint32_t((total - sent + t->peer_bs - 1) / t->peer_bs);
    if (want_blocks > uint32_t(kTpuMaxSegs)) want_blocks = kTpuMaxSegs;
    std::vector<uint32_t> got;
    {
      std::unique_lock<std::mutex> lk(t->cmu);
      if (!t->ccv.wait_for(lk, std::chrono::seconds(30), [t] {
            return !t->credits.empty() || t->closed;
          })) {
        lk.unlock();
        if (sent > 0) {
          // frames of this packet already reached the peer's stream: it is
          // desynced for good (Python send_packet fails the tunnel the
          // same way)
          loop_submit(rt, c->loop, [rt, c] {
            conn_fail(rt, c, DPE_OVERCROWDED, "tunnel window wedged");
          });
        }
        return DPE_OVERCROWDED;
      }
      if (t->closed) return DPE_IO;
      while (!t->credits.empty() && got.size() < want_blocks) {
        uint32_t idx = t->credits.front();
        t->credits.pop_front();
        if (idx < t->inflight.size()) t->inflight[idx] = 1;
        got.push_back(idx);
      }
    }
    std::vector<std::pair<uint32_t, uint32_t>> segs;
    for (uint32_t idx : got) {
      uint64_t want = total - sent;
      if (want > t->peer_bs) want = t->peer_bs;
      if (want == 0) break;
      uint64_t wrote = copy_out(t->peer + size_t(idx) * t->peer_bs, want);
      segs.emplace_back(idx, uint32_t(wrote));
      sent += wrote;
    }
    if (segs.size() < got.size()) {
      // grabbed more credits than needed — return the extras
      std::lock_guard<std::mutex> lk(t->cmu);
      for (size_t i = segs.size(); i < got.size(); i++) {
        if (got[i] < t->inflight.size()) t->inflight[got[i]] = 0;
        t->credits.push_back(got[i]);
      }
    }
    std::string body;
    body.resize(8 + segs.size() * 8);
    uint32_t z = 0, ns_be = htonl(uint32_t(segs.size()));
    memcpy(&body[0], &z, 4);
    memcpy(&body[4], &ns_be, 4);
    for (size_t i = 0; i < segs.size(); i++) {
      uint32_t idx_be = htonl(segs[i].first);
      uint32_t ln_be = htonl(segs[i].second);
      memcpy(&body[8 + i * 8], &idx_be, 4);
      memcpy(&body[8 + i * 8 + 4], &ln_be, 4);
    }
    const uint8_t* b[1] = {reinterpret_cast<const uint8_t*>(body.data())};
    const uint64_t l[1] = {body.size()};
    int rc = tpu_ctrl_send(rt, c, TFT_DATA, b, l, 1);
    if (rc != DPE_OK) {
      // the peer never saw these blocks: reclaim the credits, then kill
      // the desynced stream if part of the packet already went out
      {
        std::lock_guard<std::mutex> lk(t->cmu);
        for (auto& s : segs) {
          if (s.first < t->inflight.size()) t->inflight[s.first] = 0;
          t->credits.push_back(s.first);
        }
      }
      loop_submit(rt, c->loop, [rt, c] {
        conn_fail(rt, c, DPE_IO, "mid-packet tunnel send failure");
      });
      return rc;
    }
  }
  return DPE_OK;
}

// --------------------------------------------- queued packets (fast path)
// dp_respond/dp_call with queue=1 append whole packets here; dp_flush_all
// drains every queued conn in one writev each. The Python poller answers a
// whole poll batch, then flushes once — syscalls per RPC drop below one.
void queue_packet(Runtime* rt, const std::shared_ptr<Conn>& c,
                  const std::string& head, const uint8_t* payload,
                  uint64_t plen, const uint8_t* att, uint64_t alen) {
  bool first = false;
  {
    std::lock_guard<std::mutex> lk(c->pmu);
    first = c->pending.empty();
    c->pending.reserve(c->pending.size() + head.size() + plen + alen);
    c->pending.append(head);
    if (plen) c->pending.append(reinterpret_cast<const char*>(payload),
                                size_t(plen));
    if (alen) c->pending.append(reinterpret_cast<const char*>(att),
                                size_t(alen));
    c->pending_msgs++;
  }
  if (first) {
    std::lock_guard<std::mutex> lk(rt->fmu);
    rt->flush_list.push_back(c);
  }
}

int flush_conn_pending(Runtime* rt, const std::shared_ptr<Conn>& c) {
  // pmu is held ACROSS the write (not just the swap): with the swap
  // outside, a second flusher racing this one could write newer bytes
  // before these leave, breaking per-conn FIFO — fatal for h2 streams
  // (HEADERS must precede their window-parked DATA continuations).
  // conn_writev is nonblocking (EAGAIN queues to wq), so the hold is
  // short; lock order pmu -> wmu matches every other path.
  std::unique_lock<std::mutex> lk(c->pmu);
  std::string out;
  int msgs = 0;
  out.swap(c->pending);
  msgs = c->pending_msgs;
  c->pending_msgs = 0;
  if (out.empty()) return DPE_OK;
  const uint8_t* b[1] = {reinterpret_cast<const uint8_t*>(out.data())};
  const uint64_t l[1] = {out.size()};
  int rc = c->tpu_mode != 0 ? tpu_send_packet(rt, c, b, l, 1)
                            : conn_writev(rt, c, b, l, 1, msgs);
  lk.unlock();
  if (rc != DPE_OK && !c->failed.load()) {
    // queued responses that can't go out leave callers hanging forever —
    // same contract breach as the native echo path: tear down
    loop_submit(rt, c->loop, [rt, c, rc] {
      conn_fail(rt, c, rc == DPE_OVERCROWDED ? DPE_OVERCROWDED : DPE_IO,
                "queued packet undeliverable");
    });
  }
  return rc;
}

// ------------------------------------------------------------ registration
std::shared_ptr<Conn> create_conn(Runtime* rt, int fd, bool is_server) {
  auto c = std::make_shared<Conn>();
  c->id = rt->next_conn_id.fetch_add(1);
  c->fd = fd;
  c->is_server = is_server;
  c->loop = rt->rr.fetch_add(1) % int(rt->loops.size());
  std::lock_guard<std::mutex> lk(rt->cmu);
  rt->conns[c->id] = c;
  return c;
}

// Arm the conn's fd in its loop's epoll. Must run AFTER any bookkeeping
// whose events must precede the conn's first frame (ACCEPTED ordering).
void activate_conn(Runtime* rt, const std::shared_ptr<Conn>& c) {
  loop_submit(rt, c->loop, [rt, c] {
    // under wmu: a writer that queued bytes BEFORE this ADD ran saw its
    // EPOLL_CTL_MOD fail silently (fd not registered yet) — honoring
    // want_write here closes the lost-EPOLLOUT race (first large call on
    // a fresh conn would otherwise truncate and time out)
    std::lock_guard<std::mutex> wlk(c->wmu);
    if (c->failed.load() || c->fd < 0) return;
    epoll_event ev{};
    ev.events = c->want_write ? (EPOLLIN | EPOLLOUT) : EPOLLIN;
    ev.data.u64 = c->id;
    if (epoll_ctl(rt->loops[c->loop]->epfd, EPOLL_CTL_ADD, c->fd, &ev) != 0) {
      loop_submit(rt, c->loop, [rt, c] {
        conn_fail(rt, c, DPE_IO, "epoll add");
      });
    }
  });
}

void accept_ready(Runtime* rt, int lid) {
  int lfd = -1;
  bool py_fast = false;
  {
    // dp_listen may grow the vector and dp_listener_close retire the fd
    // concurrently — snapshot under the lock
    std::lock_guard<std::mutex> lk(rt->cmu);
    if (lid < 0 || size_t(lid) >= rt->listeners.size()) return;
    lfd = rt->listeners[size_t(lid)].fd;
    py_fast = rt->listeners[size_t(lid)].py_fast;
  }
  if (lfd < 0) return;
  for (;;) {
    sockaddr_storage ss{};
    socklen_t slen = sizeof(ss);
    int fd = accept4(lfd, reinterpret_cast<sockaddr*>(&ss), &slen,
                     SOCK_NONBLOCK | SOCK_CLOEXEC);
    if (fd < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) return;
      if (errno == EMFILE || errno == ENFILE || errno == ENOBUFS ||
          errno == ENOMEM) {
        // fd exhaustion: the listener stays readable forever under
        // level-triggered epoll, which would turn loop 0 into a 100% spin.
        // Disarm it and let the loop tick re-arm after a backoff.
        epoll_ctl(rt->loops[0]->epfd, EPOLL_CTL_DEL, lfd, nullptr);
        std::lock_guard<std::mutex> lk(rt->amu);
        rt->muted_listeners.emplace_back(lid, mono_ns() + 100000000);
      }
      return;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    int bufsz = 4 << 20;  // deep buffers keep MB-scale echoes streaming
    setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &bufsz, sizeof(bufsz));
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &bufsz, sizeof(bufsz));
    auto c = create_conn(rt, fd, /*is_server=*/true);
    c->listener_id = lid;
    c->py_fast.store(py_fast, std::memory_order_relaxed);
    char host[NI_MAXHOST] = "?", serv[NI_MAXSERV] = "0";
    getnameinfo(reinterpret_cast<sockaddr*>(&ss), slen, host, sizeof(host),
                serv, sizeof(serv), NI_NUMERICHOST | NI_NUMERICSERV);
    std::string peer = std::string(host) + ":" + serv;
    char* blk = static_cast<char*>(malloc(peer.size() + 1));
    memcpy(blk, peer.data(), peer.size());
    DpEvent ev{};
    ev.kind = EV_ACCEPTED;
    ev.conn_id = c->id;
    ev.aux = lid;
    ev.base = blk;
    ev.meta = blk;
    ev.meta_len = peer.size();
    push_event(rt, ev);         // ACCEPTED strictly precedes the conn's frames
    activate_conn(rt, c);
  }
}

// -------------------------------------------------------------- loop body
// epoll data encoding: conn events carry the conn id; listener i is encoded
// as (1<<63)|i; the eventfd as ~0.
constexpr uint64_t kListenerBit = 1ull << 63;
constexpr uint64_t kEventFdKey = ~0ull;

void loop_run(Runtime* rt, int li) {
  Loop* l = rt->loops[li].get();
  std::vector<epoll_event> evs(256);
  while (rt->running.load()) {
    int n = epoll_wait(l->epfd, evs.data(), int(evs.size()), 100);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    if (li == 0) {
      // re-arm listeners muted by fd exhaustion once their backoff expires
      std::lock_guard<std::mutex> alk(rt->amu);
      if (!rt->muted_listeners.empty()) {
        int64_t now = mono_ns();
        for (auto it = rt->muted_listeners.begin();
             it != rt->muted_listeners.end();) {
          if (now < it->second) {
            ++it;
            continue;
          }
          int lfd = -1;
          {
            std::lock_guard<std::mutex> clk(rt->cmu);
            if (it->first >= 0 &&
                size_t(it->first) < rt->listeners.size()) {
              lfd = rt->listeners[size_t(it->first)].fd;
            }
          }
          if (lfd >= 0) {
            epoll_event ev{};
            ev.events = EPOLLIN;
            ev.data.u64 = kListenerBit | uint64_t(it->first);
            if (epoll_ctl(l->epfd, EPOLL_CTL_ADD, lfd, &ev) != 0 &&
                errno != EEXIST) {
              // still under resource pressure: keep retrying, never leave
              // the listener in neither epoll nor the retry list
              it->second = now + 100000000;
              ++it;
              continue;
            }
          }
          it = rt->muted_listeners.erase(it);
        }
      }
    }
    for (int i = 0; i < n; i++) {
      uint64_t key = evs[i].data.u64;
      if (key == kEventFdKey) {
        uint64_t drain;
        ssize_t r = read(l->evfd, &drain, 8);
        (void)r;
        std::vector<std::function<void()>> tasks;
        {
          std::lock_guard<std::mutex> lk(l->tmu);
          tasks.swap(l->tasks);
        }
        for (auto& t : tasks) t();
        continue;
      }
      if (key & kListenerBit) {
        accept_ready(rt, int(key & ~kListenerBit));
        continue;
      }
      std::shared_ptr<Conn> c;
      {
        std::lock_guard<std::mutex> lk(rt->cmu);
        auto it = rt->conns.find(key);
        if (it != rt->conns.end()) c = it->second;
      }
      if (!c || c->failed.load()) continue;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        // let the read path surface the exact error/EOF
        conn_readable(rt, c);
        continue;
      }
      if (evs[i].events & EPOLLOUT) conn_drain_writes(rt, c);
      if (c->failed.load()) continue;
      if (evs[i].events & EPOLLIN) conn_readable(rt, c);
    }
  }
}

}  // namespace

// ===================================================================== ABI
extern "C" {

int dp_abi_version() { return 3; }

void* dp_rt_create(int nloops, uint64_t max_body) {
  if (nloops <= 0) nloops = 2;
  auto* rt = new Runtime();
  if (max_body) rt->max_body = max_body;
  for (int i = 0; i < nloops; i++) {
    auto loop = std::make_unique<Loop>();
    loop->epfd = epoll_create1(EPOLL_CLOEXEC);
    loop->evfd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = kEventFdKey;
    epoll_ctl(loop->epfd, EPOLL_CTL_ADD, loop->evfd, &ev);
    rt->loops.push_back(std::move(loop));
  }
  for (int i = 0; i < nloops; i++) {
    rt->loops[size_t(i)]->thr = std::thread(loop_run, rt, i);
  }
  return rt;
}

void dp_rt_shutdown(void* h) {
  auto* rt = static_cast<Runtime*>(h);
  rt->running.store(false);
  {
    // wake every parked sync caller before the loops die
    std::vector<SyncWaiter*> all;
    {
      std::lock_guard<std::mutex> lk(rt->swmu);
      for (auto& kv : rt->sync_waiters) all.push_back(kv.second);
      rt->sync_waiters.clear();
    }
    for (auto* w : all) {
      std::lock_guard<std::mutex> lk(w->mu);
      w->terr = DPE_IO;
      w->etext = "runtime shutdown";
      w->done = true;
      w->cv.notify_one();
    }
  }
  for (auto& l : rt->loops) {
    uint64_t one = 1;
    ssize_t r = write(l->evfd, &one, 8);
    (void)r;
  }
  for (auto& l : rt->loops) {
    if (l->thr.joinable()) l->thr.join();
  }
  // Quiesce every conn BEFORE tearing the Runtime down: mark failed and
  // retire the fd under wmu (so an in-flight writer can't land on a
  // recycled fd), then wake the TPUC machinery so blocked sender workers
  // observe closed/q_closed and exit.
  std::vector<std::shared_ptr<Conn>> conns;
  {
    std::lock_guard<std::mutex> lk(rt->cmu);
    for (auto& kv : rt->conns) conns.push_back(kv.second);
    rt->conns.clear();
    for (auto& l : rt->listeners) {
      if (l.fd >= 0) close(l.fd);
    }
  }
  for (auto& c : conns) {
    c->failed.store(true);
    {
      std::lock_guard<std::mutex> wlk(c->wmu);
      if (c->fd >= 0) close(c->fd);
      c->fd = -1;
    }
    tpu_teardown(c.get());
  }
  {
    std::lock_guard<std::mutex> lk(rt->smu_senders);
    for (auto& s : rt->senders) {
      if (s.thr.joinable()) s.thr.join();
    }
    rt->senders.clear();
  }
  conns.clear();
  {
    std::lock_guard<std::mutex> lk(rt->fmu);
    rt->flush_list.clear();
  }
  {
    std::lock_guard<std::mutex> lk(rt->emu);
    for (auto& ev : rt->events) free(ev.base);
    rt->events.clear();
    rt->ecv.notify_all();
  }
  {
    // consumers are gone: zero-copy mappings kept for them can go too
    std::lock_guard<std::mutex> lk(rt->gmu);
    rt->tpu_graveyard.clear();
  }
  for (auto& l : rt->loops) {
    close(l->epfd);
    close(l->evfd);
  }
  delete rt;
}

// Returns listener id >= 0, or -errno.
int dp_listen(void* h, const char* host, int port) {
  auto* rt = static_cast<Runtime*>(h);
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
  if (fd < 0) return -errno;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return -EINVAL;
  }
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 1024) != 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  sockaddr_in bound{};
  socklen_t blen = sizeof(bound);
  getsockname(fd, reinterpret_cast<sockaddr*>(&bound), &blen);
  int lid;
  {
    std::lock_guard<std::mutex> lk(rt->cmu);
    lid = int(rt->listeners.size());
    rt->listeners.push_back({fd, ntohs(bound.sin_port)});
  }
  // all listeners live on loop 0 (accepted conns spread round-robin)
  loop_submit(rt, 0, [rt, fd, lid] {
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = kListenerBit | uint64_t(lid);
    epoll_ctl(rt->loops[0]->epfd, EPOLL_CTL_ADD, fd, &ev);
  });
  return lid;
}

int dp_listener_close(void* h, int lid) {
  auto* rt = static_cast<Runtime*>(h);
  int fd = -1;
  {
    std::lock_guard<std::mutex> lk(rt->cmu);
    if (lid < 0 || size_t(lid) >= rt->listeners.size()) return -1;
    fd = rt->listeners[size_t(lid)].fd;
    rt->listeners[size_t(lid)].fd = -1;
  }
  if (fd < 0) return -1;
  loop_submit(rt, 0, [rt, fd] {
    epoll_ctl(rt->loops[0]->epfd, EPOLL_CTL_DEL, fd, nullptr);
    close(fd);
  });
  return 0;
}

int dp_listener_set_tpu(void* h, int lid, int ordinal) {
  auto* rt = static_cast<Runtime*>(h);
  std::lock_guard<std::mutex> lk(rt->cmu);
  if (lid < 0 || size_t(lid) >= rt->listeners.size()) return -1;
  rt->listeners[size_t(lid)].tpu_ordinal = ordinal;
  return 0;
}

int dp_listen_port(void* h, int lid) {
  auto* rt = static_cast<Runtime*>(h);
  std::lock_guard<std::mutex> lk(rt->cmu);
  if (lid < 0 || size_t(lid) >= rt->listeners.size()) return -1;
  return rt->listeners[size_t(lid)].port;
}

int dp_register_echo(void* h, int lid, const char* service,
                     const char* method) {
  auto* rt = static_cast<Runtime*>(h);
  if (lid < 0) return -1;
  auto svc = std::make_unique<Runtime::EchoSvc>();
  svc->lid = lid;
  svc->service = service;
  svc->method = method;
  std::lock_guard<std::mutex> lk(rt->rmu);
  rt->echo_services.push_back(std::move(svc));
  return 0;
}

// drop a listener's native services (Server teardown). Entries are marked
// dead, not freed: a loop thread may hold an EchoSvc* across the
// unregister (pointers stay valid for the runtime's lifetime).
int dp_unregister_listener_echoes(void* h, int lid) {
  auto* rt = static_cast<Runtime*>(h);
  std::lock_guard<std::mutex> lk(rt->rmu);
  for (auto& e : rt->echo_services) {
    if (e->lid == lid) e->lid = -2;
  }
  return 0;
}

// per-method concurrency limit for a native service (MethodStatus analog)
int dp_svc_set_limit(void* h, int lid, const char* service,
                     const char* method, int max_concurrency) {
  auto* rt = static_cast<Runtime*>(h);
  std::lock_guard<std::mutex> lk(rt->rmu);
  for (auto& e : rt->echo_services) {
    if (e->lid == lid && e->service == service && e->method == method) {
      e->max_concurrency = max_concurrency;
      return 0;
    }
  }
  return -1;
}

// graceful-stop: native services of this listener answer ELOGOFF
int dp_listener_set_logoff(void* h, int lid, int on) {
  auto* rt = static_cast<Runtime*>(h);
  std::lock_guard<std::mutex> lk(rt->rmu);
  for (auto& e : rt->echo_services) {
    if (e->lid == lid) e->logoff.store(on != 0, std::memory_order_relaxed);
  }
  return 0;
}

// method status counters for a native service (surfaced at /status)
int dp_svc_stats(void* h, int lid, const char* service, const char* method,
                 uint64_t* requests, uint64_t* errs, uint64_t* latency_sum_ns,
                 uint64_t* latency_max_ns, int32_t* concurrency) {
  auto* rt = static_cast<Runtime*>(h);
  std::lock_guard<std::mutex> lk(rt->rmu);
  for (auto& e : rt->echo_services) {
    if (e->lid == lid && e->service == service && e->method == method) {
      *requests = e->requests.load(std::memory_order_relaxed);
      *errs = e->errors.load(std::memory_order_relaxed);
      *latency_sum_ns = e->latency_sum_ns.load(std::memory_order_relaxed);
      *latency_max_ns = e->latency_max_ns.load(std::memory_order_relaxed);
      *concurrency = e->concurrency.load(std::memory_order_relaxed);
      return 0;
    }
  }
  return -1;
}

// Returns conn id > 0, or 0 with *err_out=errno.
uint64_t dp_connect_ex(void* h, const char* host, int port,
                       int timeout_ms, int* err_out, int grpc_mode) {
  auto* rt = static_cast<Runtime*>(h);
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
  if (fd < 0) {
    *err_out = errno;
    return 0;
  }
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    // resolve
    addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    if (getaddrinfo(host, nullptr, &hints, &res) != 0 || !res) {
      close(fd);
      *err_out = EHOSTUNREACH;
      return 0;
    }
    addr.sin_addr = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
    freeaddrinfo(res);
  }
  int rc = connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
  if (rc != 0 && errno == EINPROGRESS) {
    pollfd pfd{fd, POLLOUT, 0};
    rc = poll(&pfd, 1, timeout_ms > 0 ? timeout_ms : 3000);
    if (rc <= 0) {
      close(fd);
      *err_out = rc == 0 ? ETIMEDOUT : errno;
      return 0;
    }
    int soerr = 0;
    socklen_t slen = sizeof(soerr);
    getsockopt(fd, SOL_SOCKET, SO_ERROR, &soerr, &slen);
    if (soerr != 0) {
      close(fd);
      *err_out = soerr;
      return 0;
    }
  } else if (rc != 0) {
    *err_out = errno;
    close(fd);
    return 0;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  int bufsz = 4 << 20;
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &bufsz, sizeof(bufsz));
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &bufsz, sizeof(bufsz));
  auto c = create_conn(rt, fd, /*is_server=*/false);
  if (grpc_mode) {
    // h2 state MUST exist before the loop thread can read from the fd
    // (a grpc server may speak first with its SETTINGS preface)
    c->h2_mode = 2;
    c->h2.reset(new H2State());
    c->h2->client = true;
    c->h2->phase = 2;
    c->h2->authority = std::string(host) + ":" + std::to_string(port);
  }
  activate_conn(rt, c);
  if (grpc_mode) {
    std::string pre(kH2Preface, kH2PrefaceLen);
    pre.append(h2_settings_prefix());
    if (conn_write(rt, c, reinterpret_cast<const uint8_t*>(pre.data()),
                   pre.size()) != DPE_OK) {
      *err_out = EPIPE;
      return 0;
    }
  }
  *err_out = 0;
  return c->id;
}

uint64_t dp_connect(void* h, const char* host, int port, int timeout_ms,
                    int* err_out) {
  return dp_connect_ex(h, host, port, timeout_ms, err_out, 0);
}

void dp_conn_close(void* h, uint64_t conn_id);

// Dial a tpu:// endpoint natively: TCP bootstrap + TPUC handshake + shm
// pools, entirely in the engine (reference RdmaEndpoint AppConnect).
// bs/bc request the tunnel window geometry (0 = defaults); the server
// mirrors them for its own receive pool, so bulk dials get bulk windows.
uint64_t dp_connect_tpu2(void* h, const char* host, int port, int ordinal,
                         int timeout_ms, uint32_t bs, uint32_t bc,
                         int* err_out) {
  auto* rt = static_cast<Runtime*>(h);
  uint64_t cid = dp_connect(h, host, port, timeout_ms, err_out);
  if (!cid) return 0;
  std::shared_ptr<Conn> c;
  {
    std::lock_guard<std::mutex> lk(rt->cmu);
    auto it = rt->conns.find(cid);
    if (it != rt->conns.end()) c = it->second;
  }
  if (!c) {
    *err_out = ECONNRESET;
    return 0;
  }
  auto* t = new TpuState();
  t->ordinal = ordinal;
  t->epoch = kTpuDialGen;
  tpu_clamp_geometry(&bs, &bc);
  t->bs = bs;
  t->bc = bc;
  c->tpu.reset(t);
  c->tpu_mode = 1;  // published before any byte can arrive: the peer only
                    // speaks after our HELLO below
  if (!tpu_create_pool(t)) {
    dp_conn_close(h, cid);
    *err_out = ENOMEM;
    return 0;
  }
  std::string hello = tpu_hello_json(t, ordinal);
  const uint8_t* b[1] = {reinterpret_cast<const uint8_t*>(hello.data())};
  const uint64_t l[1] = {hello.size()};
  if (tpu_ctrl_send(rt, c, TFT_HELLO, b, l, 1) != DPE_OK) {
    dp_conn_close(h, cid);
    *err_out = EPIPE;
    return 0;
  }
  {
    std::unique_lock<std::mutex> lk(t->hmu);
    if (!t->hcv.wait_for(lk, std::chrono::milliseconds(
            timeout_ms > 0 ? timeout_ms : 3000),
            [t] { return t->ready || !t->err.empty(); })) {
      lk.unlock();
      dp_conn_close(h, cid);
      *err_out = ETIMEDOUT;
      return 0;
    }
    if (!t->ready) {
      lk.unlock();
      dp_conn_close(h, cid);
      *err_out = ECONNREFUSED;
      return 0;
    }
  }
  return cid;
}

uint64_t dp_connect_tpu(void* h, const char* host, int port, int ordinal,
                        int timeout_ms, int* err_out) {
  return dp_connect_tpu2(h, host, port, ordinal, timeout_ms, 0, 0, err_out);
}

// gRPC client conn (h2c prior knowledge): dp_call / dp_call_sync on the
// returned conn speak grpc end to end inside the engine.
uint64_t dp_connect_grpc(void* h, const char* host, int port,
                         int timeout_ms, int* err_out) {
  return dp_connect_ex(h, host, port, timeout_ms, err_out, 1);
}

int dp_send(void* h, uint64_t conn_id, const uint8_t* data, uint64_t len) {
  auto* rt = static_cast<Runtime*>(h);
  std::shared_ptr<Conn> c;
  {
    std::lock_guard<std::mutex> lk(rt->cmu);
    auto it = rt->conns.find(conn_id);
    if (it != rt->conns.end()) c = it->second;
  }
  if (!c) return DPE_NOTFOUND;
  if (c->tpu_mode != 0) {
    const uint8_t* bufs[1] = {data};
    const uint64_t lens[1] = {len};
    return tpu_send_packet(rt, c, bufs, lens, 1);
  }
  return conn_write(rt, c, data, len);
}

// Vectored variant: one RPC packet as up to 64 segments, written without
// assembling (the IOBuf ref chain crosses the boundary as pointers).
int dp_sendv(void* h, uint64_t conn_id, const uint8_t* const* bufs,
             const uint64_t* lens, int nseg) {
  if (nseg <= 0 || nseg > 64) return DPE_PROTOCOL;
  auto* rt = static_cast<Runtime*>(h);
  std::shared_ptr<Conn> c;
  {
    std::lock_guard<std::mutex> lk(rt->cmu);
    auto it = rt->conns.find(conn_id);
    if (it != rt->conns.end()) c = it->second;
  }
  if (!c) return DPE_NOTFOUND;
  if (c->tpu_mode != 0) return tpu_send_packet(rt, c, bufs, lens, nseg);
  return conn_writev(rt, c, bufs, lens, nseg);
}

// Enable parsed EV_REQUEST events for a listener's conns (Python servers
// that understand the fast path flip this right after dp_listen).
int dp_listener_set_fastpath(void* h, int lid, int on) {
  auto* rt = static_cast<Runtime*>(h);
  std::lock_guard<std::mutex> lk(rt->cmu);
  if (lid < 0 || size_t(lid) >= rt->listeners.size()) return -1;
  rt->listeners[size_t(lid)].py_fast = on != 0;
  return 0;
}

// Enable parsed EV_RESPONSE events for a client conn.
int dp_conn_set_fastpath(void* h, uint64_t conn_id, int on) {
  auto* rt = static_cast<Runtime*>(h);
  std::lock_guard<std::mutex> lk(rt->cmu);
  auto it = rt->conns.find(conn_id);
  if (it == rt->conns.end()) return -1;
  it->second->py_fast.store(on != 0, std::memory_order_relaxed);
  return 0;
}

// Server response, packed natively (server_processing._send_response with
// zero Python protobuf). queue=1 defers the write to dp_flush_all.
int dp_respond(void* h, uint64_t conn_id, uint64_t cid, uint64_t attempt,
               int error_code, const char* etext, uint64_t etext_len,
               const uint8_t* payload, uint64_t plen, const uint8_t* att,
               uint64_t alen, int compress_type, int queue) {
  auto* rt = static_cast<Runtime*>(h);
  std::shared_ptr<Conn> c;
  {
    std::lock_guard<std::mutex> lk(rt->cmu);
    auto it = rt->conns.find(conn_id);
    if (it != rt->conns.end()) c = it->second;
  }
  if (!c) return DPE_NOTFOUND;
  if (c->h2_mode != 0) {
    // grpc stream response: cid IS the h2 stream id
    return h2_grpc_respond(rt, c, uint32_t(cid), error_code, etext,
                           etext_len, payload, plen, att, alen, queue);
  }
  std::string meta = build_response_meta(cid, attempt, error_code, etext,
                                         etext_len, alen,
                                         int32_t(compress_type));
  std::string head;
  head.reserve(kHeaderSize + meta.size());
  put_trpc_header(&head, meta.size(), plen + alen);
  head.append(meta);
  if (queue) {
    queue_packet(rt, c, head, payload, plen, att, alen);
    return DPE_OK;
  }
  const uint8_t* bufs[3] = {reinterpret_cast<const uint8_t*>(head.data()),
                            payload, att};
  const uint64_t lens[3] = {head.size(), plen, alen};
  int nseg = alen ? 3 : (plen ? 2 : 1);
  if (c->tpu_mode != 0) return tpu_send_packet(rt, c, bufs, lens, nseg);
  return conn_writev(rt, c, bufs, lens, nseg);
}

// Client request, packed natively (Controller._issue_rpc's meta build with
// zero Python protobuf). queue=1 defers the write to dp_flush_all.
int dp_call(void* h, uint64_t conn_id, const char* svc, uint64_t svc_len,
            const char* meth, uint64_t meth_len, uint64_t cid,
            uint64_t attempt, int64_t log_id, int64_t trace_id,
            int64_t span_id, int32_t timeout_ms, const uint8_t* payload,
            uint64_t plen, const uint8_t* att, uint64_t alen, int queue) {
  auto* rt = static_cast<Runtime*>(h);
  std::shared_ptr<Conn> c;
  {
    std::lock_guard<std::mutex> lk(rt->cmu);
    auto it = rt->conns.find(conn_id);
    if (it != rt->conns.end()) c = it->second;
  }
  if (!c) return DPE_NOTFOUND;
  if (c->h2_mode != 0) {
    return h2_grpc_call(rt, c, svc, svc_len, meth, meth_len, cid,
                        timeout_ms, payload, plen, att, alen, queue);
  }
  std::string meta = build_request_meta(svc, svc_len, meth, meth_len, cid,
                                        attempt, log_id, trace_id, span_id,
                                        timeout_ms, alen);
  std::string head;
  head.reserve(kHeaderSize + meta.size());
  put_trpc_header(&head, meta.size(), plen + alen);
  head.append(meta);
  if (queue) {
    queue_packet(rt, c, head, payload, plen, att, alen);
    return DPE_OK;
  }
  const uint8_t* bufs[3] = {reinterpret_cast<const uint8_t*>(head.data()),
                            payload, att};
  const uint64_t lens[3] = {head.size(), plen, alen};
  int nseg = alen ? 3 : (plen ? 2 : 1);
  if (c->tpu_mode != 0) return tpu_send_packet(rt, c, bufs, lens, nseg);
  return conn_writev(rt, c, bufs, lens, nseg);
}

// Struct-parameter call (layout mirrored by _CALL_IN in
// rpc/native_transport.py): the async client lane's dp_call with 17
// marshalled scalars folded into one reusable param block.
struct CallParams {
  uint64_t conn_id;    //  0
  uint64_t cid;        //  8
  int64_t log_id;      // 16
  int64_t trace_id;    // 24
  int64_t span_id;     // 32
  int32_t timeout_ms;  // 40
  int32_t queue;       // 44
};

int dp_call2(void* h, const uint8_t* pb, const char* svc,
             uint64_t svc_len, const char* meth, uint64_t meth_len,
             const uint8_t* payload, uint64_t plen, const uint8_t* att,
             uint64_t alen) {
  auto* p = reinterpret_cast<const CallParams*>(pb);
  return dp_call(h, p->conn_id, svc, svc_len, meth, meth_len, p->cid, 0,
                 p->log_id, p->trace_id, p->span_id, p->timeout_ms,
                 payload, plen, att, alen, p->queue);
}

// Struct-parameter respond (layout mirrored by _RESPOND_IN in
// rpc/native_transport.py): 13 marshalled scalars -> pointers + sizes.
struct RespondParams {
  uint64_t conn_id;    //  0
  uint64_t cid;        //  8
  uint64_t attempt;    // 16
  int32_t error_code;  // 24
  int32_t compress;    // 28
  int32_t queue;       // 32
  int32_t _pad;        // 36
};

int dp_respond2(void* h, const uint8_t* pb, const char* etext,
                uint64_t etext_len, const uint8_t* payload, uint64_t plen,
                const uint8_t* att, uint64_t alen) {
  auto* p = reinterpret_cast<const RespondParams*>(pb);
  return dp_respond(h, p->conn_id, p->cid, p->attempt, p->error_code,
                    etext, etext_len, payload, plen, att, alen,
                    p->compress, p->queue);
}

// Blocking fast call: the calling (Python) thread parks HERE, in C, with
// the GIL released — the engine's parse thread completes it directly.
// Returns DPE_OK when an RPC-level answer arrived (out_code = app error
// code, body ownership passes to the caller: free via dp_free(out_base)),
// DPE_TIMEDOUT on deadline, other DPE_* on transport failure.
int dp_call_sync(void* h, uint64_t conn_id, const char* svc,
                 uint64_t svc_len, const char* meth, uint64_t meth_len,
                 uint64_t cid, int64_t log_id, int64_t trace_id,
                 int64_t span_id, int32_t timeout_ms,
                 const uint8_t* payload, uint64_t plen, const uint8_t* att,
                 uint64_t alen, int32_t* out_code, uint64_t* out_attempt,
                 uint64_t* out_att_size, void** out_base, void** out_body,
                 uint64_t* out_body_len, char* etext_buf,
                 uint64_t* etext_cap_len) {
  auto* rt = static_cast<Runtime*>(h);
  SyncWaiter w;
  w.cid = cid;
  w.conn_id = conn_id;
  {
    std::lock_guard<std::mutex> lk(rt->swmu);
    rt->sync_waiters.emplace(cid, &w);
  }
  int rc = dp_call(h, conn_id, svc, svc_len, meth, meth_len, cid, 0,
                   log_id, trace_id, span_id, timeout_ms, payload, plen,
                   att, alen, 0);
  if (rc != DPE_OK) {
    if (sync_take(rt, cid) != nullptr) {  // nobody owns us: bail
      if (etext_cap_len) *etext_cap_len = 0;
      return rc;
    }
    // a completer (conn_fail fan-out) already took the waiter — it is
    // committed to signaling; take its verdict below
  }
  {
    std::unique_lock<std::mutex> lk(w.mu);
    if (timeout_ms > 0) {
      if (!w.cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                         [&] { return w.done; })) {
        lk.unlock();
        if (sync_take(rt, cid) != nullptr) {
          if (etext_cap_len) *etext_cap_len = 0;
          return DPE_TIMEDOUT;
        }
        lk.lock();  // completion in flight: it is quick, wait it out
        w.cv.wait(lk, [&] { return w.done; });
      }
    } else {
      w.cv.wait(lk, [&] { return w.done; });
    }
  }
  uint64_t cap = etext_cap_len ? *etext_cap_len : 0;
  uint64_t n = cap < w.etext.size() ? cap : w.etext.size();
  if (n) memcpy(etext_buf, w.etext.data(), n);
  if (etext_cap_len) *etext_cap_len = n;
  if (w.terr) return w.terr;
  *out_code = w.code;
  *out_attempt = w.attempt;
  *out_att_size = w.att_size;
  *out_base = w.base;
  *out_body = w.body;
  *out_body_len = w.body_len;
  return DPE_OK;
}

// Struct-parameter variant of dp_call_sync: ctypes marshals TWO pointer
// args instead of 23 scalars (~4us/call of marshalling on the shared
// core). Layout mirrored by _SYNC_PARAMS in rpc/native_transport.py.
struct SyncCallParams {
  uint64_t conn_id;    //  0  in
  uint64_t cid;        //  8  in
  int64_t log_id;      // 16  in
  int64_t trace_id;    // 24  in
  int64_t span_id;     // 32  in
  int32_t timeout_ms;  // 40  in
  int32_t code;        // 44  out: app error code
  uint64_t attempt;    // 48  out
  uint64_t att_size;   // 56  out
  uint64_t base;       // 64  out: free handle (dp_free)
  uint64_t body;       // 72  out
  uint64_t body_len;   // 80  out
  uint64_t etext_len;  // 88  out
  char etext[256];     // 96  out
};

int dp_call_sync2(void* h, uint8_t* pb, const char* svc, uint64_t svc_len,
                  const char* meth, uint64_t meth_len,
                  const uint8_t* payload, uint64_t plen,
                  const uint8_t* att, uint64_t alen) {
  auto* p = reinterpret_cast<SyncCallParams*>(pb);
  int32_t code = 0;
  uint64_t attempt = 0, att_size = 0, blen = 0;
  void* base = nullptr;
  void* body = nullptr;
  uint64_t elen = sizeof(p->etext);
  int rc = dp_call_sync(h, p->conn_id, svc, svc_len, meth, meth_len,
                        p->cid, p->log_id, p->trace_id, p->span_id,
                        p->timeout_ms, payload, plen, att, alen, &code,
                        &attempt, &att_size, &base, &body, &blen,
                        p->etext, &elen);
  p->code = code;
  p->attempt = attempt;
  p->att_size = att_size;
  p->base = reinterpret_cast<uint64_t>(base);
  p->body = reinterpret_cast<uint64_t>(body);
  p->body_len = blen;
  p->etext_len = elen;
  return rc;
}

// Python-side fallback completion: a response that needed Python policy
// (decompression, big donated frame via EV_FRAME, ZC tunnel reassembly)
// finishes a parked sync caller through here.
int dp_sync_complete_py(void* h, uint64_t cid, int32_t code,
                        const char* etext, uint64_t elen,
                        const uint8_t* body, uint64_t blen,
                        uint64_t att_size, uint64_t attempt) {
  auto* rt = static_cast<Runtime*>(h);
  SyncWaiter* w = sync_take(rt, cid);
  if (w == nullptr) return DPE_NOTFOUND;
  uint8_t* blk = nullptr;
  if (blen) {
    blk = static_cast<uint8_t*>(malloc(blen));
    memcpy(blk, body, blen);
  }
  sync_complete(w, code, attempt, att_size, etext, elen, blk, blk, blen);
  return DPE_OK;
}

// Return the pool blocks named by an EV_RESPONSE_ZC ack blob to the peer
// (the consumer has finished reading the zero-copy segments).
int dp_tpu_ack(void* h, uint64_t conn_id, const uint8_t* ack, uint64_t len) {
  auto* rt = static_cast<Runtime*>(h);
  std::shared_ptr<Conn> c;
  {
    std::lock_guard<std::mutex> lk(rt->cmu);
    auto it = rt->conns.find(conn_id);
    if (it != rt->conns.end()) c = it->second;
  }
  if (!c) return DPE_NOTFOUND;  // conn died; its pool sits in the graveyard
  c->zc_outstanding.fetch_sub(1, std::memory_order_relaxed);
  if (c->failed.load()) return DPE_IO;
  const uint8_t* b[1] = {ack};
  const uint64_t l[1] = {len};
  return tpu_ctrl_send(rt, c, TFT_ACK, b, l, 1);
}

// Drain every conn with queued packets (call once per answered poll batch).
int dp_flush_all(void* h) {
  auto* rt = static_cast<Runtime*>(h);
  std::vector<std::shared_ptr<Conn>> conns;
  {
    std::lock_guard<std::mutex> lk(rt->fmu);
    conns.swap(rt->flush_list);
  }
  int bad = 0;
  for (auto& c : conns) {
    if (flush_conn_pending(rt, c) != DPE_OK) bad++;
  }
  return bad;
}

int dp_poll(void* h, DpEvent* out, int maxn, int timeout_ms) {
  auto* rt = static_cast<Runtime*>(h);
  std::unique_lock<std::mutex> lk(rt->emu);
  if (rt->events.empty()) {
    rt->ecv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [rt] {
      return !rt->events.empty() || !rt->running.load();
    });
  }
  int n = 0;
  while (n < maxn && !rt->events.empty()) {
    out[n] = rt->events.front();
    rt->event_bytes -=
        out[n].meta_len + out[n].body_len + sizeof(DpEvent);
    rt->events.pop_front();
    n++;
  }
  return n;
}

// Batched event delivery with inline payloads: one ctypes call + ONE
// buffer read hands Python a whole poll batch (VERDICT r3 #1 — the
// interpreter boundary is crossed per BATCH, not per event). Small events
// are memcpy'd back-to-back into the caller's buffer and freed here (no
// per-event dp_free crossing); big events (donated read buffers, ZC
// tunnel descriptors) stay zero-copy as pointer records the consumer
// frees as before. Record layout (host endian, packed):
//   i32 kind (bit 30 set = pointer record)  i32 tag
//   u64 conn_id  i64 aux  u64 meta_len  u64 body_len
//   inline:  meta bytes, body bytes
//   pointer: u64 base, u64 meta_ptr, u64 body_ptr
constexpr int32_t kPackedPtrFlag = 1 << 30;
constexpr uint64_t kPackInlineMax = 8 << 10;  // per-event inline budget
constexpr uint64_t kPackedHdr = 40;

int dp_poll_packed(void* h, uint8_t* buf, uint64_t cap, int timeout_ms,
                   int maxn) {
  auto* rt = static_cast<Runtime*>(h);
  // Phase 1 (under the event lock): POP the fitting events into a local
  // batch — fit arithmetic only, no memcpy/free, so the engine's parse
  // threads never stall on rt->emu behind a megabyte of packing.
  std::vector<DpEvent> batch;
  {
    std::unique_lock<std::mutex> lk(rt->emu);
    if (rt->events.empty()) {
      rt->ecv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [rt] {
        return !rt->events.empty() || !rt->running.load();
      });
    }
    uint64_t off = 0;
    while (int(batch.size()) < maxn && !rt->events.empty()) {
      DpEvent& ev = rt->events.front();
      uint64_t blen = ev.body ? ev.body_len : 0;
      uint64_t blob = ev.meta_len + blen;
      uint64_t need = kPackedHdr + (blob <= kPackInlineMax ? blob : 24);
      if (off + need > cap) break;  // delivered next call
      off += need;
      rt->event_bytes -= ev.meta_len + ev.body_len + sizeof(DpEvent);
      batch.push_back(ev);
      rt->events.pop_front();
    }
  }
  // Phase 2 (lock-free): pack into the caller's buffer.
  uint64_t off = 0;
  for (DpEvent& ev : batch) {
    // EV_RESPONSE_ZC carries body=nullptr with an INFORMATIONAL body_len
    // (the payload lives in pool blocks named by the meta); copy/ship
    // only bytes that exist
    uint64_t blen = ev.body ? ev.body_len : 0;
    uint64_t blob = ev.meta_len + blen;
    bool inlined = blob <= kPackInlineMax;
    uint8_t* p = buf + off;
    int32_t kind = ev.kind | (inlined ? 0 : kPackedPtrFlag);
    memcpy(p, &kind, 4);
    memcpy(p + 4, &ev.tag, 4);
    memcpy(p + 8, &ev.conn_id, 8);
    memcpy(p + 16, &ev.aux, 8);
    memcpy(p + 24, &ev.meta_len, 8);
    memcpy(p + 32, &blen, 8);
    p += kPackedHdr;
    if (inlined) {
      if (ev.meta_len) memcpy(p, ev.meta, ev.meta_len);
      if (blen) memcpy(p + ev.meta_len, ev.body, blen);
      free(ev.base);
      off += kPackedHdr + blob;
    } else {
      uint64_t base = reinterpret_cast<uint64_t>(ev.base);
      uint64_t mp = reinterpret_cast<uint64_t>(ev.meta);
      uint64_t bp = reinterpret_cast<uint64_t>(ev.body);
      memcpy(p, &base, 8);
      memcpy(p + 8, &mp, 8);
      memcpy(p + 16, &bp, 8);
      off += kPackedHdr + 24;
    }
  }
  return int(off);  // bytes written; 0 = timeout/empty
}

void dp_free(void* base) { free(base); }

void dp_conn_close(void* h, uint64_t conn_id) {
  auto* rt = static_cast<Runtime*>(h);
  std::shared_ptr<Conn> c;
  {
    std::lock_guard<std::mutex> lk(rt->cmu);
    auto it = rt->conns.find(conn_id);
    if (it != rt->conns.end()) c = it->second;
  }
  if (!c) return;
  loop_submit(rt, c->loop,
              [rt, c] { conn_fail(rt, c, DPE_EOF, "closed locally"); });
}

int dp_conn_stats(void* h, uint64_t conn_id, uint64_t* in_bytes,
                  uint64_t* out_bytes, uint64_t* in_msgs,
                  uint64_t* out_msgs) {
  auto* rt = static_cast<Runtime*>(h);
  std::lock_guard<std::mutex> lk(rt->cmu);
  auto it = rt->conns.find(conn_id);
  if (it == rt->conns.end()) return -1;
  auto& c = it->second;
  *in_bytes = c->in_bytes.load();
  *out_bytes = c->out_bytes.load();
  *in_msgs = c->in_msgs.load();
  *out_msgs = c->out_msgs.load();
  return 0;
}

// ------------------------------------------------------------------ bench
// The reference measures its framework with C++ client binaries
// (example/multi_threaded_echo_c++/client.cpp, rdma_performance/client.cpp).
// This is ours: a pipelined echo client that drives the SAME engine lane
// (dp_connect / conn_writev / the frame cutter) against a server, entirely
// in C++, and reports QPS + latency percentiles + bandwidth.
int dp_bench_echo2(const char* host, int port, int use_tpu, int nconns,
                   int depth, uint64_t payload_len, int duration_ms,
                   const char* service, const char* method,
                   double* out_qps, double* out_gbps, double* out_p50_us,
                   double* out_p99_us, double* out_p999_us) {
  void* h = dp_rt_create(2, 0);
  // request packet: header + meta(RequestMeta{service,method}, cid) + body
  std::string reqmeta_tail;  // everything except the cid varint
  {
    std::string rm;
    pb_put_tag(&rm, 1, 2);
    pb_put_varint(&rm, strlen(service));
    rm.append(service);
    pb_put_tag(&rm, 2, 2);
    pb_put_varint(&rm, strlen(method));
    rm.append(method);
    pb_put_tag(&reqmeta_tail, 1, 2);
    pb_put_varint(&reqmeta_tail, rm.size());
    reqmeta_tail.append(rm);
  }
  std::string body(size_t(payload_len), '\xab');
  // bulk payloads dial with a bulk window: ~8 messages in flight
  // (negotiated geometry; the server mirrors it)
  uint32_t want_bs = 0, want_bc = 0;
  if (use_tpu == 1 && payload_len > (256u << 10)) {
    want_bs = uint32_t(std::min<uint64_t>(4u << 20, payload_len / 8));
    want_bc = 64;
  }
  std::vector<uint64_t> conns;
  for (int i = 0; i < nconns; i++) {
    int err = 0;
    // use_tpu: 0 = plain TCP trpc_std, 1 = TPUC tunnel, 2 = grpc/h2
    uint64_t cid = use_tpu == 1
        ? dp_connect_tpu2(h, host, port, 0, 5000, want_bs, want_bc, &err)
        : use_tpu == 2
            ? dp_connect_grpc(h, host, port, 3000, &err)
            : dp_connect(h, host, port, 3000, &err);
    if (!cid) {
      dp_rt_shutdown(h);
      return -1;
    }
    // parsed EV_RESPONSE completions: cid arrives pre-cracked in ev.aux
    dp_conn_set_fastpath(h, cid, 1);
    conns.push_back(cid);
  }
  std::atomic<uint64_t> done_count{0}, errors_seen{0};
  std::atomic<bool> stop{false};
  std::mutex lat_mu;
  std::vector<double> latencies;
  latencies.reserve(1 << 20);
  // per-correlation-id send timestamps (cid space: conn_index * depth + slot)
  std::vector<std::atomic<int64_t>> sent_ns(size_t(nconns) * depth);
  auto now_ns = [] {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
  };
  // queued sends (one writev per conn per poll batch via dp_flush_all —
  // the same batched lane the Python fast path drives)
  // queueing copies the payload once — a win for small frames (syscalls
  // dominate), a loss for MB-scale ones (writev from the caller's buffer)
  const int q_mode = payload_len < (64 << 10) ? 1 : 0;
  auto send_one = [&](int conn_idx, int slot) {
    uint64_t cid = uint64_t(conn_idx) * depth + slot + 1;
    sent_ns[cid - 1].store(now_ns(), std::memory_order_relaxed);
    return dp_call(h, conns[size_t(conn_idx)], service, strlen(service),
                   method, strlen(method), cid, 0, 0, 0, 0, 0,
                   reinterpret_cast<const uint8_t*>(body.data()),
                   body.size(), nullptr, 0, q_mode);
  };
  // prime the pipeline
  for (int ci = 0; ci < nconns; ci++) {
    for (int s = 0; s < depth; s++) {
      if (send_one(ci, s) != DPE_OK) {
        dp_rt_shutdown(h);
        return -2;
      }
    }
  }
  dp_flush_all(h);
  int64_t t_start = now_ns();
  int64_t t_end = t_start + int64_t(duration_ms) * 1000000;
  // consumer: poll completions, re-issue (the framework's event queue IS
  // the completion channel; same lane Python uses)
  std::vector<DpEvent> evs(256);
  while (!stop.load()) {
    int n = dp_poll(h, evs.data(), int(evs.size()), 50);
    int64_t now = now_ns();
    bool queued = false;
    for (int i = 0; i < n; i++) {
      DpEvent& ev = evs[i];
      uint64_t cid = 0;
      if (ev.kind == EV_RESPONSE) {
        cid = uint64_t(ev.aux);
      } else if (ev.kind == EV_RESPONSE_ZC) {
        // zero-copy completion: touch the payload views (they live in OUR
        // registered pool — that IS the receive), then return the credits
        cid = uint64_t(ev.aux);
        const uint8_t* mp = static_cast<const uint8_t*>(ev.meta);
        uint32_t nv;
        memcpy(&nv, mp + sizeof(RespLite), 4);
        const uint8_t* w = mp + sizeof(RespLite) + 4;
        volatile uint8_t sink = 0;
        for (uint32_t v = 0; v < nv; v++) {
          uint64_t p, ln;
          memcpy(&p, w, 8);
          memcpy(&ln, w + 8, 8);
          if (ln) sink ^= *reinterpret_cast<const uint8_t*>(p);
          w += 16;
        }
        (void)sink;
        uint32_t alen;
        memcpy(&alen, w, 4);
        dp_tpu_ack(h, ev.conn_id, w + 4, alen);
      } else if (ev.kind == EV_FRAME) {
        // big frames (>=64KB) still arrive as donated EV_FRAME buffers
        MetaLite m;
        const uint8_t* mp = static_cast<const uint8_t*>(ev.meta);
        if (parse_meta_lite(mp, mp + ev.meta_len, &m)) {
          cid = m.correlation_id;
        }
      } else if (ev.kind == EV_FAILED) {
        errors_seen.fetch_add(1);
      }
      if (cid && cid <= uint64_t(nconns) * uint64_t(depth)) {
        int64_t t0 = sent_ns[cid - 1].load(std::memory_order_relaxed);
        {
          std::lock_guard<std::mutex> lk(lat_mu);
          latencies.push_back(double(now - t0) / 1000.0);
        }
        done_count.fetch_add(1);
        if (now < t_end) {
          int conn_idx = int((cid - 1) / depth);
          int slot = int((cid - 1) % depth);
          send_one(conn_idx, slot);
          queued = true;
        }
      }
      free(ev.base);
    }
    if (queued) dp_flush_all(h);
    if (now >= t_end) {
      // drain stragglers briefly, then stop
      static const int64_t grace = 200000000;
      if (now >= t_end + grace) stop.store(true);
      if (n == 0) stop.store(true);
    }
    if (errors_seen.load() > uint64_t(nconns)) {
      dp_rt_shutdown(h);
      return -3;
    }
  }
  int64_t elapsed = now_ns() - t_start;
  double secs = double(elapsed) / 1e9;
  uint64_t completed = done_count.load();
  std::sort(latencies.begin(), latencies.end());
  auto pct = [&](double p) -> double {
    if (latencies.empty()) return 0.0;
    size_t idx = size_t(p * double(latencies.size()));
    if (idx >= latencies.size()) idx = latencies.size() - 1;
    return latencies[idx];
  };
  *out_qps = double(completed) / secs;
  *out_gbps = 2.0 * double(payload_len) * double(completed) / secs / 1e9;
  *out_p50_us = pct(0.5);
  *out_p99_us = pct(0.99);
  *out_p999_us = pct(0.999);
  dp_rt_shutdown(h);
  return 0;
}

int dp_bench_echo(const char* host, int port, int nconns, int depth,
                  uint64_t payload_len, int duration_ms,
                  const char* service, const char* method,
                  double* out_qps, double* out_gbps, double* out_p50_us,
                  double* out_p99_us, double* out_p999_us) {
  return dp_bench_echo2(host, port, 0, nconns, depth, payload_len,
                        duration_ms, service, method, out_qps, out_gbps,
                        out_p50_us, out_p99_us, out_p999_us);
}

}  // extern "C"
