// Native trace codec: varint-delimited pb/trace TraceEvent stream ->
// tensorized replay op arrays, and the health journal's NDJSON encoder.
//
// Host C++ (not a CUDA kernel), built with g++ at first use by
// go_libp2p_pubsub_tpu_torch/trace/native.py and loaded with ctypes. A copy
// of the JAX package's native/trace_codec.cpp: the C++ twin of
// trace/replay.py `tensorize_trace` (the delivery-record state machine of
// score.go:840-877) plus the wire walk of pb/trace.proto (pb/codec.py
// schemas). Parsing and tensorizing a large trace in Python dominates the
// replay's host time; this path does it without per-event Python objects,
// with the Python tensorizer as the fallback where no compiler is found.
//
// Contract: op streams identical to the Python tensorizer's, array for
// array (tests/test_torch_native_codec.py), and health rows that parse to
// the Python encoder's values (sim/telemetry.py).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---- op codes (trace/replay.py) ----
enum Op {
  OP_NOP = 0, OP_DECAY = 1, OP_GRAFT = 2, OP_PRUNE = 3, OP_FIRST = 4,
  OP_DUP = 5, OP_INVALID = 6, OP_PENALTY = 7, OP_JOIN = 8, OP_LEAVE = 9,
  OP_PUBLISH = 10, OP_DELIVER = 11, OP_CONNECT = 12, OP_DISCONNECT = 13,
};

// ---- trace event types (pb/codec.py TRACE_TYPES) ----
enum EvType {
  EV_PUBLISH_MESSAGE = 0, EV_REJECT_MESSAGE = 1, EV_DUPLICATE_MESSAGE = 2,
  EV_DELIVER_MESSAGE = 3, EV_ADD_PEER = 4, EV_REMOVE_PEER = 5,
  EV_RECV_RPC = 6, EV_SEND_RPC = 7, EV_DROP_RPC = 8, EV_JOIN = 9,
  EV_LEAVE = 10, EV_GRAFT = 11, EV_PRUNE = 12,
};

// delivery-record states (score.go:90-120)
enum RecStatus { ST_UNKNOWN = 0, ST_VALID, ST_INVALID, ST_THROTTLED, ST_IGNORED };

struct Record {
  int status = ST_UNKNOWN;
  std::vector<std::string> peers;  // insertion-ordered, may hold unknown ids
  double validated = 0.0;
};

struct Slice {
  const uint8_t* p = nullptr;
  size_t len = 0;
  bool empty() const { return p == nullptr; }
  std::string str() const { return std::string((const char*)p, len); }
};

bool read_uvarint(const uint8_t* buf, size_t len, size_t* pos, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (*pos < len && shift < 64) {
    uint8_t b = buf[(*pos)++];
    v |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) { *out = v; return true; }
    shift += 7;
  }
  return false;
}

// walk a proto2 message; callback per (field, wire, varint value | slice).
// Length checks are overflow-safe: lengths are compared against the
// remaining byte count, never added to pos first.
template <typename F>
bool walk_fields(const uint8_t* buf, size_t len, F&& cb) {
  size_t pos = 0;
  while (pos < len) {
    uint64_t key;
    if (!read_uvarint(buf, len, &pos, &key)) return false;
    uint32_t field = (uint32_t)(key >> 3), wire = (uint32_t)(key & 7);
    if (wire == 0) {
      uint64_t v;
      if (!read_uvarint(buf, len, &pos, &v)) return false;
      cb(field, wire, v, Slice{});
    } else if (wire == 2) {
      uint64_t l;
      if (!read_uvarint(buf, len, &pos, &l)) return false;
      if (l > len - pos) return false;
      cb(field, wire, 0, Slice{buf + pos, (size_t)l});
      pos += l;
    } else if (wire == 5) {
      if (len - pos < 4) return false;
      pos += 4;
    } else if (wire == 1) {
      if (len - pos < 8) return false;
      pos += 8;
    } else {
      return false;
    }
  }
  return true;
}

struct Payload {
  Slice mid, peer, topic, reason;
};

// payload sub-message schemas (pb/codec.py _PAYLOAD_SCHEMAS). Field numbers:
//   publishMessage: 1 mid, 2 topic
//   rejectMessage: 1 mid, 2 peer, 3 reason, 4 topic
//   duplicateMessage: 1 mid, 2 peer, 3 topic
//   deliverMessage: 1 mid, 2 topic, 3 peer
//   addPeer: 1 peer, 2 proto ; removePeer: 1 peer
//   join: 1 topic ; leave: 2 topic (the proto's one oddity, trace.proto:94)
//   graft/prune: 1 peer, 2 topic
bool parse_payload(int ev_type, Slice s, Payload* out_p) {
  Payload& out = *out_p;
  return walk_fields(s.p, s.len, [&](uint32_t f, uint32_t w, uint64_t, Slice v) {
    if (w != 2) return;
    switch (ev_type) {
      case EV_PUBLISH_MESSAGE:
        if (f == 1) out.mid = v; else if (f == 2) out.topic = v;
        break;
      case EV_REJECT_MESSAGE:
        if (f == 1) out.mid = v; else if (f == 2) out.peer = v;
        else if (f == 3) out.reason = v; else if (f == 4) out.topic = v;
        break;
      case EV_DUPLICATE_MESSAGE:
        if (f == 1) out.mid = v; else if (f == 2) out.peer = v;
        else if (f == 3) out.topic = v;
        break;
      case EV_DELIVER_MESSAGE:
        if (f == 1) out.mid = v; else if (f == 2) out.topic = v;
        else if (f == 3) out.peer = v;
        break;
      case EV_ADD_PEER:
      case EV_REMOVE_PEER:
        if (f == 1) out.peer = v;
        break;
      case EV_JOIN:
        if (f == 1) out.topic = v;
        break;
      case EV_LEAVE:
        if (f == 2) out.topic = v;
        break;
      case EV_GRAFT:
      case EV_PRUNE:
        if (f == 1) out.peer = v; else if (f == 2) out.topic = v;
        break;
      default:
        break;
    }
  });
}

// rejection-reason strings (trace/events.py, tracer.go:27-39)
bool is_sig_reject(const std::string& r) {
  return r == "missing signature" || r == "invalid signature" ||
         r == "unexpected signature" || r == "unexpected auth info" ||
         r == "self originated message";
}
bool is_silent_reject(const std::string& r) {
  return r == "blacklisted peer" || r == "blacklisted source" ||
         r == "validation queue full";
}

struct Tensorizer {
  std::unordered_map<std::string, int32_t> peer_index, topic_index;
  std::unordered_map<std::string, int32_t> mid_slot;
  std::vector<std::string> mid_order;
  std::unordered_map<std::string, Record> records;  // key: observer \x00 mid
  std::vector<int32_t> ops;  // interleaved (op, a, b, c)
  const double* dup_window = nullptr;
  double decay_interval = 1.0;
  double next_decay = 1.0;
  long msg_window = 0;

  void emit(int32_t op, int32_t a, int32_t b, int32_t c) {
    ops.push_back(op); ops.push_back(a); ops.push_back(b); ops.push_back(c);
  }

  int32_t peer_of(Slice s) {
    if (s.empty()) return -1;
    auto it = peer_index.find(s.str());
    return it == peer_index.end() ? -1 : it->second;
  }
  int32_t topic_of(Slice s) {
    if (s.empty()) return -1;
    auto it = topic_index.find(s.str());
    return it == topic_index.end() ? -1 : it->second;
  }
  int32_t slot_of(const std::string& mid) {
    auto it = mid_slot.find(mid);
    if (it != mid_slot.end()) return it->second;
    int32_t s = (int32_t)mid_slot.size();
    if (s >= msg_window) return -1;  // caller maps to rc=3
    mid_slot.emplace(mid, s);
    mid_order.push_back(mid);
    return s;
  }
  Record& rec_of(const std::string& obs, const std::string& mid) {
    std::string key = obs;
    key.push_back('\0');
    key += mid;
    return records[key];
  }

  bool event(int type, const std::string& obs, double ts, const Payload& pl) {
    constexpr double eps = 1e-9;
    while (ts >= next_decay - eps) {
      emit(OP_DECAY, 0, 0, 0);
      next_decay += decay_interval;
    }
    auto ai_it = peer_index.find(obs);
    if (ai_it == peer_index.end()) return true;
    int32_t ai = ai_it->second;

    switch (type) {
      case EV_GRAFT:
      case EV_PRUNE: {
        int32_t bi = peer_of(pl.peer), ci = topic_of(pl.topic);
        if (bi >= 0 && ci >= 0)
          emit(type == EV_GRAFT ? OP_GRAFT : OP_PRUNE, ai, bi, ci);
        break;
      }
      case EV_JOIN: {
        int32_t ci = topic_of(pl.topic);
        if (ci >= 0) emit(OP_JOIN, ai, -1, ci);
        break;
      }
      case EV_LEAVE: {
        int32_t ci = topic_of(pl.topic);
        if (ci >= 0) emit(OP_LEAVE, ai, -1, ci);
        break;
      }
      case EV_ADD_PEER: {
        int32_t bi = peer_of(pl.peer);
        if (bi >= 0) emit(OP_CONNECT, ai, bi, -1);
        break;
      }
      case EV_REMOVE_PEER: {
        int32_t bi = peer_of(pl.peer);
        if (bi >= 0) emit(OP_DISCONNECT, ai, bi, -1);
        break;
      }
      case EV_PUBLISH_MESSAGE: {
        int32_t ci = topic_of(pl.topic);
        if (ci < 0 || pl.mid.empty()) break;
        int32_t sl = slot_of(pl.mid.str());
        if (sl < 0) return false;
        emit(OP_PUBLISH, ai, sl, ci);
        break;
      }
      case EV_DELIVER_MESSAGE: {
        int32_t ci = topic_of(pl.topic);
        if (ci < 0 || pl.mid.empty()) break;
        std::string mid = pl.mid.str();
        int32_t sl = slot_of(mid);
        if (sl < 0) return false;
        std::string rf = pl.peer.empty() ? std::string() : pl.peer.str();
        // raw score hook gated on received_from != observer (trace/bus.py)
        if (!rf.empty() && rf != obs) {
          int32_t bi = peer_of(pl.peer);
          if (bi >= 0) emit(OP_FIRST, ai, bi, ci);
          Record& r = rec_of(obs, mid);
          if (r.status == ST_UNKNOWN) {
            r.status = ST_VALID;
            r.validated = ts;
            for (const auto& p : r.peers) {
              if (p != rf) {
                auto it = peer_index.find(p);
                if (it != peer_index.end()) emit(OP_DUP, ai, it->second, ci);
              }
            }
          }
        }
        emit(OP_DELIVER, ai, sl, ci);
        break;
      }
      case EV_DUPLICATE_MESSAGE: {
        int32_t ci = topic_of(pl.topic);
        if (ci < 0 || pl.mid.empty() || pl.peer.empty()) break;
        std::string rf = pl.peer.str();
        if (rf == obs) break;
        Record& r = rec_of(obs, pl.mid.str());
        bool seen = false;
        for (const auto& p : r.peers) if (p == rf) { seen = true; break; }
        if (seen) break;
        if (r.status == ST_UNKNOWN) {
          r.peers.push_back(rf);
        } else if (r.status == ST_VALID) {
          r.peers.push_back(rf);
          if (ts - r.validated <= dup_window[ci]) {
            int32_t bi = peer_of(pl.peer);
            if (bi >= 0) emit(OP_DUP, ai, bi, ci);
          }
        } else if (r.status == ST_INVALID) {
          int32_t bi = peer_of(pl.peer);
          if (bi >= 0) emit(OP_INVALID, ai, bi, ci);
        }
        break;
      }
      case EV_REJECT_MESSAGE: {
        int32_t ci = topic_of(pl.topic);
        if (ci < 0 || pl.mid.empty() || pl.peer.empty()) break;
        std::string rf = pl.peer.str();
        if (rf == obs) break;
        std::string reason = pl.reason.empty() ? std::string() : pl.reason.str();
        int32_t bi = peer_of(pl.peer);
        if (is_sig_reject(reason)) {
          if (bi >= 0) emit(OP_INVALID, ai, bi, ci);
          break;
        }
        if (is_silent_reject(reason)) break;
        Record& r = rec_of(obs, pl.mid.str());
        if (r.status != ST_UNKNOWN) break;
        if (reason == "validation throttled") {
          r.status = ST_THROTTLED;
          r.peers.clear();
        } else if (reason == "validation ignored") {
          r.status = ST_IGNORED;
          r.peers.clear();
        } else {
          r.status = ST_INVALID;
          if (bi >= 0) emit(OP_INVALID, ai, bi, ci);
          for (const auto& p : r.peers) {
            auto it = peer_index.find(p);
            if (it != peer_index.end()) emit(OP_INVALID, ai, it->second, ci);
          }
          r.peers.clear();
        }
        break;
      }
      default:
        break;  // RPC meta events carry no replayable state
    }
    return true;
  }
};

// blob format: n records of (uint32 LE length + raw bytes) — binary-safe
// for peer ids that are raw multihashes (pb/codec.py decodes them with
// surrogateescape; the Python side re-encodes byte-preserving)
void split_blob(const char* blob, long n, std::unordered_map<std::string, int32_t>* out) {
  const char* p = blob;
  for (long i = 0; i < n; i++) {
    uint32_t l;
    memcpy(&l, p, 4);
    p += 4;
    out->emplace(std::string(p, l), (int32_t)i);
    p += l;
  }
}

}  // namespace

extern "C" {

// Parse a uvarint-delimited TraceEvent stream and tensorize it.
// peers_blob / topics_blob: n length-prefixed names (uint32 LE length +
// raw bytes each), index = position.
// Returns 0 on success; fills *out (malloc'd interleaved int32 op,a,b,c),
// *out_events (number of ops), *mids (malloc'd NUL-joined message ids in
// slot order), *n_mids. Caller frees via trace_codec_free.
int trace_codec_tensorize(
    const uint8_t* buf, long len,
    const char* peers_blob, long n_peers,
    const char* topics_blob, long n_topics,
    const double* dup_window, double decay_interval,
    double t_end, int has_t_end, long msg_window,
    int32_t** out, long* out_events,
    char** mids, long* n_mids) {
  Tensorizer tz;
  split_blob(peers_blob, n_peers, &tz.peer_index);
  split_blob(topics_blob, n_topics, &tz.topic_index);
  tz.dup_window = dup_window;
  tz.decay_interval = decay_interval;
  tz.next_decay = decay_interval;
  tz.msg_window = msg_window;

  size_t pos = 0;
  while (pos < (size_t)len) {
    uint64_t elen;
    if (!read_uvarint(buf, len, &pos, &elen)) return 2;
    if (elen > (size_t)len - pos) return 2;
    const uint8_t* ep = buf + pos;
    pos += elen;

    int type = -1;
    double ts = 0.0;
    std::string obs;
    Slice payload;
    bool ok = walk_fields(ep, elen, [&](uint32_t f, uint32_t w, uint64_t v, Slice s) {
      if (f == 1 && w == 0) type = (int)v;
      else if (f == 2 && w == 2) obs = s.str();
      else if (f == 3 && w == 0) ts = (double)v / 1e9;
      else if (f >= 4 && f <= 16 && w == 2) payload = s;
    });
    if (!ok) return 2;  // malformed event body -> loud error, like the
                        // Python codec's _iter_fields raising
    if (type < 0) continue;
    Payload pl;
    if (!payload.empty() && !parse_payload(type, payload, &pl)) return 2;
    if (!tz.event(type, obs, ts, pl)) return 3;
  }

  if (has_t_end) {
    constexpr double eps = 1e-9;
    while (tz.next_decay <= t_end + eps) {
      tz.emit(OP_DECAY, 0, 0, 0);
      tz.next_decay += decay_interval;
    }
  }
  if (tz.ops.empty()) tz.emit(OP_NOP, 0, 0, 0);

  long n_ops = (long)(tz.ops.size() / 4);
  int32_t* arr = (int32_t*)malloc(tz.ops.size() * sizeof(int32_t));
  memcpy(arr, tz.ops.data(), tz.ops.size() * sizeof(int32_t));
  *out = arr;
  *out_events = n_ops;

  // message ids are binary (default id = from||seqno, midgen.py), so the
  // slot-order blob is length-prefixed: uint32 LE length + raw bytes each
  size_t mlen = 0;
  for (const auto& m : tz.mid_order) mlen += 4 + m.size();
  char* mblob = (char*)malloc(mlen ? mlen : 1);
  char* mp = mblob;
  for (const auto& m : tz.mid_order) {
    uint32_t l = (uint32_t)m.size();
    memcpy(mp, &l, 4);
    mp += 4;
    memcpy(mp, m.data(), m.size());
    mp += m.size();
  }
  *mids = mblob;
  *n_mids = (long)tz.mid_order.size();
  return 0;
}

void trace_codec_free(void* p) { free(p); }

// Encode helper: frame a pre-encoded TraceEvent blob stream is trivial in
// Python; the native side only ships the parse/tensorize hot path.

// Health-row NDJSON encoder (sim/telemetry.py hot sink path): format a
// whole chunk's [n_rows, n_cols] float64 row matrix as one NDJSON blob in
// a single call — the per-row Python dict + json.dumps overhead is the
// encoder-side cost the streaming plane removes. names_blob uses the
// split_blob convention (uint32 LE length + raw bytes per column name);
// is_int marks columns printed as integers. Doubles print as %.17g
// (round-trips every finite double bit-exactly through a JSON parser);
// non-finite values print as null (NaN is not JSON — a degraded row must
// stay machine-readable). Returns 0; caller frees *out via
// trace_codec_free.
int trace_codec_health_json(const double* vals, long n_rows, long n_cols,
                            const char* names_blob, long names_len,
                            const unsigned char* is_int,
                            char** out, long* out_len) {
  std::vector<std::string> names;
  names.reserve(n_cols);
  {
    const char* p = names_blob;
    (void)names_len;
    for (long i = 0; i < n_cols; i++) {
      uint32_t l;
      memcpy(&l, p, 4);
      p += 4;
      names.emplace_back(p, l);
      p += l;
    }
  }
  // pre-render the '"name":' fragments once; rows reuse them
  std::vector<std::string> keys;
  keys.reserve(n_cols);
  for (long c = 0; c < n_cols; c++)
    keys.push_back(std::string(c ? ",\"" : "{\"kind\":\"health\",\"")
                   + names[c] + "\":");
  std::string buf;
  buf.reserve((size_t)n_rows * n_cols * 24 + 64);
  char num[40];
  for (long r = 0; r < n_rows; r++) {
    const double* row = vals + r * n_cols;
    for (long c = 0; c < n_cols; c++) {
      buf += keys[c];
      double v = row[c];
      if (!std::isfinite(v)) {
        buf += "null";
      } else if (is_int[c]) {
        snprintf(num, sizeof num, "%lld", (long long)v);
        buf += num;
      } else {
        snprintf(num, sizeof num, "%.17g", v);
        buf += num;
      }
    }
    buf += "}\n";
  }
  char* p = (char*)malloc(buf.size() ? buf.size() : 1);
  memcpy(p, buf.data(), buf.size());
  *out = p;
  *out_len = (long)buf.size();
  return 0;
}

}  // extern "C"
