// Native Deli sequencer: per-document total-order stamping on the host hot
// path (C++ counterpart of server/deli.py — identical policies, built for
// the low-jitter ingest loop feeding the device-resident op queue;
// SURVEY.md §7.5). The PyTorch package keeps its own copy of this source
// and builds it into its own build directory.
//
// The reference (Routerlicious Deli) is TypeScript on Node; this rebuild
// keeps the policy layer in Python and puts the per-op stamping — the part
// that must keep pace with millions of ops/sec across 10k docs — in native
// code with a batch API, exposed over a C ABI for ctypes (no pybind11 in
// this image).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ClientState {
  int32_t last_client_seq = 0;
  int32_t ref_seq = 0;
};

struct DocState {
  int64_t seq = 0;
  int64_t min_seq = 0;
  std::unordered_map<int32_t, ClientState> clients;

  int64_t compute_msn() const {
    if (clients.empty()) {
      return seq > min_seq ? seq : min_seq;
    }
    int64_t msn = INT64_MAX;
    for (const auto& kv : clients) {
      if (kv.second.ref_seq < msn) msn = kv.second.ref_seq;
    }
    return msn > min_seq ? msn : min_seq;
  }
};

struct Deli {
  std::unordered_map<std::string, DocState> docs;
  // Row-handle interning for the columnar ingest path: a handle is a dense
  // int32 resolving straight to the DocState without per-op string hashing.
  // unordered_map nodes are pointer-stable, so the raw pointers stay valid.
  std::vector<DocState*> by_handle;
  std::unordered_map<std::string, int32_t> handle_of;
};

// nack codes (match server/deli.py NackReason, offset to negatives)
constexpr int64_t kNackUnknownClient = -1;
constexpr int64_t kNackClientSeqGap = -2;
constexpr int64_t kNackDuplicate = -3;
constexpr int64_t kNackRefSeqBelowMsn = -4;

// One op's stamping against a resolved DocState — shared by the string-keyed
// single-op path and the handle-keyed batch path.
inline int64_t sequence_on(DocState& doc, int32_t client, int32_t client_seq,
                           int32_t ref_seq, int32_t is_noop,
                           int64_t* out_min_seq) {
  auto it = doc.clients.find(client);
  if (it == doc.clients.end()) return kNackUnknownClient;
  ClientState& cs = it->second;
  if (!is_noop) {
    const int32_t expected = cs.last_client_seq + 1;
    if (client_seq < expected) return kNackDuplicate;
    if (client_seq > expected) return kNackClientSeqGap;
  }
  if (ref_seq < doc.min_seq) return kNackRefSeqBelowMsn;
  // clamp: a ref_seq above the current doc seq would inflate the MSN past
  // seq and permanently nack every later op (client cannot see the future)
  if (ref_seq > doc.seq) ref_seq = static_cast<int32_t>(doc.seq);
  if (!is_noop) cs.last_client_seq = client_seq;
  if (ref_seq > cs.ref_seq) cs.ref_seq = ref_seq;
  doc.seq += 1;
  doc.min_seq = doc.compute_msn();
  if (out_min_seq != nullptr) *out_min_seq = doc.min_seq;
  return doc.seq;
}

}  // namespace

extern "C" {

void* deli_create() { return new Deli(); }

void deli_destroy(void* h) { delete static_cast<Deli*>(h); }

int64_t deli_client_join(void* h, const char* doc_id, int32_t client) {
  auto& doc = static_cast<Deli*>(h)->docs[doc_id];
  ClientState cs;
  cs.ref_seq = static_cast<int32_t>(doc.seq);
  doc.clients[client] = cs;
  doc.seq += 1;
  doc.min_seq = doc.compute_msn();
  return doc.seq;
}

int64_t deli_client_leave(void* h, const char* doc_id, int32_t client) {
  auto& doc = static_cast<Deli*>(h)->docs[doc_id];
  if (doc.clients.erase(client) == 0) return 0;
  doc.seq += 1;
  doc.min_seq = doc.compute_msn();
  return doc.seq;
}

// Returns the stamped seq (>0) or a negative nack code; *out_min_seq gets
// the post-op MSN on success.
int64_t deli_sequence(void* h, const char* doc_id, int32_t client,
                      int32_t client_seq, int32_t ref_seq, int32_t is_noop,
                      int64_t* out_min_seq) {
  auto& doc = static_cast<Deli*>(h)->docs[doc_id];
  return sequence_on(doc, client, client_seq, ref_seq, is_noop, out_min_seq);
}

// Dense row handle for a document (registers it on first use) — resolves a
// doc without string hashing on the per-op path. Handles are session-local:
// they do NOT survive checkpoint/restore (re-register after restore).
int32_t deli_doc_handle(void* h, const char* doc_id) {
  auto* deli = static_cast<Deli*>(h);
  auto it = deli->handle_of.find(doc_id);
  if (it != deli->handle_of.end()) return it->second;
  DocState* doc = &deli->docs[doc_id];
  const int32_t handle = static_cast<int32_t>(deli->by_handle.size());
  deli->by_handle.push_back(doc);
  deli->handle_of.emplace(doc_id, handle);
  return handle;
}

// Columnar ingest: stamp n ops across many documents in one call (the
// host-side hot loop feeding the TPU batch). out_seqs[i] < 0 = nack code;
// out_min_seqs[i] = the doc's MSN after op i either way.
void deli_sequence_batch_rows(void* h, int32_t n, const int32_t* handles,
                              const int32_t* clients,
                              const int32_t* client_seqs,
                              const int32_t* ref_seqs, const int32_t* is_noop,
                              int64_t* out_seqs, int64_t* out_min_seqs) {
  auto* deli = static_cast<Deli*>(h);
  const int32_t n_handles = static_cast<int32_t>(deli->by_handle.size());
  for (int32_t i = 0; i < n; ++i) {
    if (handles[i] < 0 || handles[i] >= n_handles) {
      // stale handle (they do not survive restore): nack, don't crash
      out_seqs[i] = kNackUnknownClient;
      out_min_seqs[i] = 0;
      continue;
    }
    DocState& doc = *deli->by_handle[handles[i]];
    out_seqs[i] = sequence_on(doc, clients[i], client_seqs[i], ref_seqs[i],
                              is_noop ? is_noop[i] : 0, &out_min_seqs[i]);
    if (out_seqs[i] < 0) out_min_seqs[i] = doc.min_seq;
  }
}

// Re-apply an already-sequenced message to sequencer state (log-tail replay
// after restoring an older checkpoint). type matches MessageType: 1 = NOOP,
// 2 = CLIENT_JOIN, 3 = CLIENT_LEAVE, anything else = a sequenced op.
void deli_replay(void* h, const char* doc_id, int32_t client,
                 int32_t client_seq, int32_t ref_seq, int64_t seq,
                 int64_t min_seq, int32_t type) {
  auto& doc = static_cast<Deli*>(h)->docs[doc_id];
  if (type == 2) {
    ClientState cs;
    cs.ref_seq = ref_seq;
    doc.clients[client] = cs;
  } else if (type == 3) {
    doc.clients.erase(client);
  } else {
    auto it = doc.clients.find(client);
    if (it != doc.clients.end()) {
      if (type != 1 && client_seq > it->second.last_client_seq) {
        it->second.last_client_seq = client_seq;
      }
      if (ref_seq > it->second.ref_seq) it->second.ref_seq = ref_seq;
    }
  }
  if (seq > doc.seq) doc.seq = seq;
  if (min_seq > doc.min_seq) doc.min_seq = min_seq;
}

// Batch stamping for one document: the TPU-ingest hot path. out_seqs[i] gets
// the stamped seq or a negative nack code; out_min_seqs[i] the MSN after op i.
void deli_sequence_batch(void* h, const char* doc_id, int32_t n,
                         const int32_t* clients, const int32_t* client_seqs,
                         const int32_t* ref_seqs, const int32_t* is_noop,
                         int64_t* out_seqs, int64_t* out_min_seqs) {
  for (int32_t i = 0; i < n; ++i) {
    out_seqs[i] = deli_sequence(h, doc_id, clients[i], client_seqs[i],
                                ref_seqs[i], is_noop[i], &out_min_seqs[i]);
    if (out_seqs[i] < 0 && out_min_seqs != nullptr) {
      out_min_seqs[i] =
          static_cast<Deli*>(h)->docs[doc_id].min_seq;
    }
  }
}

int64_t deli_doc_seq(void* h, const char* doc_id) {
  auto* deli = static_cast<Deli*>(h);
  auto it = deli->docs.find(doc_id);
  return it == deli->docs.end() ? 0 : it->second.seq;
}

int64_t deli_doc_min_seq(void* h, const char* doc_id) {
  auto* deli = static_cast<Deli*>(h);
  auto it = deli->docs.find(doc_id);
  return it == deli->docs.end() ? 0 : it->second.min_seq;
}

// --------------------------------------------------------------- checkpoint
// Text format, one doc per line:
//   doc_id\tseq\tmin_seq\t[client:last_cs:ref_seq,...]\n
// Doc ids are caller-controlled strings: the delimiters ('\t', '\n') and the
// escape char ('%') are percent-encoded so an adversarial id cannot inject
// rows, and restore parses with strtoll (no exceptions across the C ABI).

}  // extern "C"

namespace {

std::string encode_doc_id(const std::string& id) {
  std::string out;
  out.reserve(id.size());
  for (char c : id) {
    if (c == '%' || c == '\t' || c == '\n') {
      static const char* hex = "0123456789ABCDEF";
      out += '%';
      out += hex[(static_cast<unsigned char>(c) >> 4) & 0xF];
      out += hex[static_cast<unsigned char>(c) & 0xF];
    } else {
      out += c;
    }
  }
  return out;
}

std::string decode_doc_id(const std::string& enc) {
  auto nib = [](char c) -> int {
    if (c >= '0' && c <= '9') return c - '0';
    if (c >= 'A' && c <= 'F') return c - 'A' + 10;
    if (c >= 'a' && c <= 'f') return c - 'a' + 10;
    return -1;
  };
  std::string out;
  out.reserve(enc.size());
  for (size_t i = 0; i < enc.size(); ++i) {
    if (enc[i] == '%' && i + 2 < enc.size()) {
      const int hi = nib(enc[i + 1]);
      const int lo = nib(enc[i + 2]);
      if (hi >= 0 && lo >= 0) {
        out += static_cast<char>((hi << 4) | lo);
        i += 2;
        continue;
      }
    }
    out += enc[i];
  }
  return out;
}

// exception-free integer parse; returns 0 on malformed input
int64_t parse_i64(const std::string& s) {
  return std::strtoll(s.c_str(), nullptr, 10);
}

}  // namespace

extern "C" {

int64_t deli_checkpoint(void* h, char* buf, int64_t cap) {
  auto* deli = static_cast<Deli*>(h);
  std::string out;
  for (const auto& kv : deli->docs) {
    out += encode_doc_id(kv.first);
    out += '\t';
    out += std::to_string(kv.second.seq);
    out += '\t';
    out += std::to_string(kv.second.min_seq);
    out += '\t';
    bool first = true;
    for (const auto& ckv : kv.second.clients) {
      if (!first) out += ',';
      first = false;
      out += std::to_string(ckv.first) + ":" +
             std::to_string(ckv.second.last_client_seq) + ":" +
             std::to_string(ckv.second.ref_seq);
    }
    out += '\n';
  }
  const int64_t needed = static_cast<int64_t>(out.size());
  if (buf != nullptr && cap >= needed) {
    std::memcpy(buf, out.data(), out.size());
  }
  return needed;
}

void* deli_restore(const char* buf, int64_t len) {
  auto* deli = new Deli();
  std::string data(buf, static_cast<size_t>(len));
  size_t pos = 0;
  while (pos < data.size()) {
    size_t eol = data.find('\n', pos);
    if (eol == std::string::npos) break;
    std::string line = data.substr(pos, eol - pos);
    pos = eol + 1;
    size_t t1 = line.find('\t');
    size_t t2 = line.find('\t', t1 + 1);
    size_t t3 = line.find('\t', t2 + 1);
    if (t1 == std::string::npos || t2 == std::string::npos ||
        t3 == std::string::npos) {
      continue;
    }
    DocState doc;
    doc.seq = parse_i64(line.substr(t1 + 1, t2 - t1 - 1));
    doc.min_seq = parse_i64(line.substr(t2 + 1, t3 - t2 - 1));
    std::string clients = line.substr(t3 + 1);
    size_t cpos = 0;
    while (cpos < clients.size()) {
      size_t comma = clients.find(',', cpos);
      std::string entry = clients.substr(
          cpos, comma == std::string::npos ? std::string::npos : comma - cpos);
      size_t c1 = entry.find(':');
      size_t c2 = entry.find(':', c1 + 1);
      if (c1 != std::string::npos && c2 != std::string::npos) {
        ClientState cs;
        cs.last_client_seq =
            static_cast<int32_t>(parse_i64(entry.substr(c1 + 1, c2 - c1 - 1)));
        cs.ref_seq = static_cast<int32_t>(parse_i64(entry.substr(c2 + 1)));
        doc.clients[static_cast<int32_t>(parse_i64(entry.substr(0, c1)))] = cs;
      }
      if (comma == std::string::npos) break;
      cpos = comma + 1;
    }
    deli->docs[decode_doc_id(line.substr(0, t1))] = doc;
  }
  return deli;
}

}  // extern "C"
