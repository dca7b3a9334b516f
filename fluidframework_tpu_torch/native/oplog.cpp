// Native durable op log: CRC-framed append-only partition segments — the
// Kafka role (ordered durable log per partition) on the serving host's IO
// hot path (C++ counterpart of server/oplog.py; the Python binding and the
// record codec live in server/native_oplog.py).
//
// Record framing per partition file:
//   [u32 payload_len][u32 crc32(payload)][payload bytes]
// Append is O(1) at the tail; reads are random-access via an in-memory
// offset index rebuilt on open. Open SCANS the file and truncates a torn
// tail (short header, short payload, or CRC mismatch) — the crash-recovery
// contract: every record before the tear survives, the tear disappears.
// C ABI for ctypes. The file format is the JAX package's, byte for byte.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#ifndef _WIN32
#include <unistd.h>
#endif

namespace {

uint32_t crc_table[256];
bool crc_ready = false;

void crc_init() {
  if (crc_ready) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_ready = true;
}

uint32_t crc32(const uint8_t* data, size_t n) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Partition {
  FILE* f = nullptr;
  std::vector<uint64_t> positions;  // file offset of each record's header
  uint64_t tail = 0;                // next write position

  ~Partition() {
    if (f) fclose(f);
  }
};

struct Log {
  std::vector<Partition> parts;
};

// Scan an existing file, rebuilding the index; returns the valid length.
uint64_t scan(FILE* f, std::vector<uint64_t>* positions) {
  positions->clear();
  uint64_t pos = 0;
  fseek(f, 0, SEEK_END);
  uint64_t file_len = static_cast<uint64_t>(ftell(f));
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf;
  while (pos + 8 <= file_len) {
    uint32_t hdr[2];
    fseek(f, static_cast<long>(pos), SEEK_SET);
    if (fread(hdr, 1, 8, f) != 8) break;
    uint64_t len = hdr[0];
    if (pos + 8 + len > file_len) break;  // torn payload
    buf.resize(len);
    if (len && fread(buf.data(), 1, len, f) != len) break;
    if (crc32(buf.data(), len) != hdr[1]) break;  // corrupt record
    positions->push_back(pos);
    pos += 8 + len;
  }
  return pos;
}

}  // namespace

extern "C" {

void* oplog_open(const char* dir, int32_t n_partitions) {
  Log* log = new Log();
  log->parts.resize(n_partitions);
  for (int32_t p = 0; p < n_partitions; ++p) {
    std::string path = std::string(dir) + "/p" + std::to_string(p) + ".log";
    FILE* f = fopen(path.c_str(), "r+b");
    if (!f) f = fopen(path.c_str(), "w+b");
    if (!f) {
      delete log;
      return nullptr;
    }
    Partition& part = log->parts[p];
    part.f = f;
    part.tail = scan(f, &part.positions);
    // truncate any torn tail so appends continue from a clean record edge
    fseek(f, 0, SEEK_END);
    if (static_cast<uint64_t>(ftell(f)) != part.tail) {
      // freopen-free truncate: ftruncate via fileno
      fflush(f);
#ifdef _WIN32
#else
      if (ftruncate(fileno(f), static_cast<off_t>(part.tail)) != 0) {
        delete log;
        return nullptr;
      }
#endif
    }
  }
  return log;
}

void oplog_close(void* handle) { delete static_cast<Log*>(handle); }

// Append one record; returns its offset (record index), or -1 on error.
int64_t oplog_append(void* handle, int32_t partition, const uint8_t* data,
                     int64_t len) {
  Log* log = static_cast<Log*>(handle);
  if (partition < 0 ||
      partition >= static_cast<int32_t>(log->parts.size()) || len < 0)
    return -1;
  Partition& part = log->parts[partition];
  uint32_t hdr[2] = {static_cast<uint32_t>(len),
                     crc32(data, static_cast<size_t>(len))};
  fseek(part.f, static_cast<long>(part.tail), SEEK_SET);
  if (fwrite(hdr, 1, 8, part.f) != 8) return -1;
  if (len && fwrite(data, 1, static_cast<size_t>(len), part.f) !=
                 static_cast<size_t>(len))
    return -1;
  fflush(part.f);
  part.positions.push_back(part.tail);
  part.tail += 8 + static_cast<uint64_t>(len);
  return static_cast<int64_t>(part.positions.size()) - 1;
}

// Durability barrier: fsync the partition file (group-commit point).
int32_t oplog_sync(void* handle, int32_t partition) {
  Log* log = static_cast<Log*>(handle);
  if (partition < 0 || partition >= static_cast<int32_t>(log->parts.size()))
    return -1;
  Partition& part = log->parts[partition];
  fflush(part.f);
#ifndef _WIN32
  return fsync(fileno(part.f)) == 0 ? 0 : -1;
#else
  return 0;
#endif
}

int64_t oplog_size(void* handle, int32_t partition) {
  Log* log = static_cast<Log*>(handle);
  if (partition < 0 || partition >= static_cast<int32_t>(log->parts.size()))
    return -1;
  return static_cast<int64_t>(log->parts[partition].positions.size());
}

// Length of record `offset` (for buffer sizing), or -1 if out of range.
int64_t oplog_record_len(void* handle, int32_t partition, int64_t offset) {
  Log* log = static_cast<Log*>(handle);
  if (partition < 0 || partition >= static_cast<int32_t>(log->parts.size()))
    return -1;
  Partition& part = log->parts[partition];
  if (offset < 0 || offset >= static_cast<int64_t>(part.positions.size()))
    return -1;
  uint32_t hdr[2];
  fseek(part.f, static_cast<long>(part.positions[offset]), SEEK_SET);
  if (fread(hdr, 1, 8, part.f) != 8) return -1;
  return hdr[0];
}

// Copy record `offset` into `out` (caller sized it via oplog_record_len).
// Returns bytes written, or -1.
int64_t oplog_read(void* handle, int32_t partition, int64_t offset,
                   uint8_t* out, int64_t out_len) {
  Log* log = static_cast<Log*>(handle);
  if (partition < 0 || partition >= static_cast<int32_t>(log->parts.size()))
    return -1;
  Partition& part = log->parts[partition];
  if (offset < 0 || offset >= static_cast<int64_t>(part.positions.size()))
    return -1;
  uint32_t hdr[2];
  fseek(part.f, static_cast<long>(part.positions[offset]), SEEK_SET);
  if (fread(hdr, 1, 8, part.f) != 8) return -1;
  if (static_cast<int64_t>(hdr[0]) > out_len) return -1;
  if (hdr[0] && fread(out, 1, hdr[0], part.f) != hdr[0]) return -1;
  if (crc32(out, hdr[0]) != hdr[1]) return -1;
  return hdr[0];
}

}  // extern "C"
