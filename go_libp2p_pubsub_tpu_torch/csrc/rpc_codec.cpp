// Native RPC wire scanner: uvarint-delimited pb/rpc.proto frame streams ->
// per-frame statistics + per-message arrays (port of native/rpc_codec.cpp).
//
// Host C++, not a CUDA kernel: the twin of walking pb/codec.py
// `read_frames` output in Python. The wire format is go-libp2p-pubsub's
// stream framing (comm.go:157-171: uvarint length prefix, max 1 MiB
// payload) over the proto2 RPC schema (pb/rpc.proto:5-57):
// RPC{subscriptions=1, publish=2, control=3},
// Message{from=1, data=2, seqno=3, topic=4, signature=5, key=6},
// ControlMessage{ihave=1{topic=1, mids=2}, iwant=2{mids=1},
// graft=3{topic=1}, prune=4{topic=1, peers=2{peer=1, record=2}, backoff=3}}.
//
// Bulk host-side RPC streams (interop captures, adversarial load fixtures,
// differential-test corpora) are scanned here without a Python object per
// frame. go_libp2p_pubsub_tpu_torch/pb/native_rpc.py builds it with g++ at
// first use and binds it with ctypes; its `scan_bytes_python` is the plain
// twin, array for array. A seqno is stored as int64: the big-endian value
// of its first 8 bytes, wrapped two's-complement above 2^63 - 1.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

bool read_uvarint(const uint8_t* buf, size_t len, size_t* pos, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (*pos < len && shift < 64) {
    uint8_t b = buf[(*pos)++];
    v |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

struct Field {
  uint32_t num;
  uint32_t wire;
  uint64_t varint;      // wire 0
  const uint8_t* p;     // wire 2
  uint64_t len;         // wire 2
};

// Walk one proto2 message's fields; returns false on malformed input.
bool next_field(const uint8_t* buf, size_t len, size_t* pos, Field* f) {
  if (*pos >= len) return false;
  uint64_t key;
  if (!read_uvarint(buf, len, pos, &key)) return false;
  f->num = (uint32_t)(key >> 3);
  f->wire = (uint32_t)(key & 7);
  f->p = nullptr;
  f->len = 0;
  f->varint = 0;
  switch (f->wire) {
    case 0:
      return read_uvarint(buf, len, pos, &f->varint);
    case 2: {
      uint64_t l;
      if (!read_uvarint(buf, len, pos, &l)) return false;
      if (l > len - *pos) return false;
      f->p = buf + *pos;
      f->len = l;
      *pos += l;
      return true;
    }
    case 1:
      if (len - *pos < 8) return false;
      *pos += 8;
      return true;
    case 5:
      if (len - *pos < 4) return false;
      *pos += 4;
      return true;
    default:
      return false;
  }
}

struct Scanner {
  std::vector<int64_t> stats;   // 8 per frame
  std::vector<int64_t> msgs;    // 4 per publish message
  std::vector<std::string> topics;
  std::unordered_map<std::string, int64_t> topic_ids;

  int64_t intern(const uint8_t* p, uint64_t len) {
    std::string t((const char*)p, len);
    auto it = topic_ids.find(t);
    if (it != topic_ids.end()) return it->second;
    int64_t id = (int64_t)topics.size();
    topics.push_back(t);
    topic_ids.emplace(std::move(t), id);
    return id;
  }

  // counts message ids (field `mid_field`) inside an ihave/iwant body
  static bool count_mids(const uint8_t* p, uint64_t len, uint32_t mid_field,
                         int64_t* out) {
    size_t pos = 0;
    Field f;
    while (pos < len) {
      if (!next_field(p, len, &pos, &f)) return false;
      if (f.num == mid_field && f.wire == 2) (*out)++;
    }
    return true;
  }

  bool scan_message(const uint8_t* p, uint64_t len, int64_t frame) {
    size_t pos = 0;
    Field f;
    int64_t topic_id = -1, data_len = 0;
    uint64_t seqno = 0;
    while (pos < len) {
      if (!next_field(p, len, &pos, &f)) return false;
      if (f.wire != 2) continue;
      if (f.num == 2) {
        data_len = (int64_t)f.len;
      } else if (f.num == 3) {
        // big-endian seqno bytes (pubsub.go:1341-1346), up to 8 bytes
        seqno = 0;
        for (uint64_t i = 0; i < f.len && i < 8; i++)
          seqno = (seqno << 8) | f.p[i];
      } else if (f.num == 4 && f.len > 0) {
        // empty topic stays -1: the Python twin decodes proto2 absent and
        // present-but-empty to the same "" and interns neither, so the
        // native path must not invent a topic id for it
        topic_id = intern(f.p, f.len);
      }
    }
    msgs.push_back(frame);
    msgs.push_back(topic_id);
    msgs.push_back(data_len);
    msgs.push_back((int64_t)seqno);
    return true;
  }

  bool scan_control(const uint8_t* p, uint64_t len, int64_t* st) {
    size_t pos = 0;
    Field f;
    while (pos < len) {
      if (!next_field(p, len, &pos, &f)) return false;
      if (f.wire != 2) continue;
      switch (f.num) {
        case 1:
          if (!count_mids(f.p, f.len, 2, &st[3])) return false;
          break;
        case 2:
          if (!count_mids(f.p, f.len, 1, &st[4])) return false;
          break;
        case 3:
          st[5]++;
          break;
        case 4: {
          st[6]++;
          size_t ppos = 0;
          Field pf;
          while (ppos < f.len) {
            if (!next_field(f.p, f.len, &ppos, &pf)) return false;
            if (pf.num == 2 && pf.wire == 2) st[7]++;  // PX records
          }
          break;
        }
      }
    }
    return true;
  }

  // returns 0 ok, 2 malformed framing/proto, 3 oversize frame
  int scan(const uint8_t* buf, size_t len, uint64_t max_frame) {
    size_t pos = 0;
    int64_t frame = 0;
    while (pos < len) {
      uint64_t flen;
      if (!read_uvarint(buf, len, &pos, &flen)) return 2;
      if (flen > len - pos) return 2;
      if (max_frame && flen > max_frame) return 3;
      const uint8_t* fp = buf + pos;
      pos += flen;
      stats.insert(stats.end(), 8, 0);
      int64_t* st = &stats[stats.size() - 8];
      size_t mp = 0;
      Field f;
      while (mp < flen) {
        if (!next_field(fp, flen, &mp, &f)) return 2;
        if (f.wire != 2) continue;
        if (f.num == 1) {
          st[0]++;
        } else if (f.num == 2) {
          st[1]++;
          if (!scan_message(f.p, f.len, frame)) return 2;
          st[2] += msgs[msgs.size() - 2];  // the row's data_len
        } else if (f.num == 3) {
          if (!scan_control(f.p, f.len, st)) return 2;
        }
      }
      frame++;
    }
    return 0;
  }
};

char* pack_topics(const std::vector<std::string>& topics, long* n_bytes) {
  size_t total = 0;
  for (const auto& t : topics) total += 4 + t.size();
  char* out = (char*)malloc(total ? total : 1);
  size_t off = 0;
  for (const auto& t : topics) {
    uint32_t l = (uint32_t)t.size();
    memcpy(out + off, &l, 4);
    off += 4;
    memcpy(out + off, t.data(), t.size());
    off += t.size();
  }
  *n_bytes = (long)total;
  return out;
}

}  // namespace

extern "C" {

// Scan a uvarint-delimited RPC frame stream.
// Outputs (malloc'd; caller frees via rpc_codec_free):
//   *stats  [n_frames, 8] int64: subs, publish, publish_data_bytes,
//           ihave_ids, iwant_ids, grafts, prunes, px_records
//   *msgs   [n_msgs, 4] int64: frame_idx, topic_id, data_len, seqno
//   *topics length-prefixed (u32 LE) topic strings in topic_id order
// Returns 0 ok, 2 malformed, 3 frame over max_frame (0 = unlimited).
int rpc_codec_scan(const uint8_t* buf, long len, long max_frame,
                   int64_t** stats, long* n_frames,
                   int64_t** msgs, long* n_msgs,
                   char** topics, long* topics_bytes) {
  Scanner sc;
  int rc = sc.scan(buf, (size_t)len, (uint64_t)max_frame);
  if (rc != 0) return rc;
  *n_frames = (long)(sc.stats.size() / 8);
  *stats = (int64_t*)malloc(sc.stats.size() * sizeof(int64_t) + 1);
  memcpy(*stats, sc.stats.data(), sc.stats.size() * sizeof(int64_t));
  *n_msgs = (long)(sc.msgs.size() / 4);
  *msgs = (int64_t*)malloc(sc.msgs.size() * sizeof(int64_t) + 1);
  memcpy(*msgs, sc.msgs.data(), sc.msgs.size() * sizeof(int64_t));
  *topics = pack_topics(sc.topics, topics_bytes);
  return 0;
}

void rpc_codec_free(void* p) { free(p); }

}  // extern "C"
