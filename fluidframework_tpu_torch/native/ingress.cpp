// Native decode of the columnar front door's drain pass.
//
// The door (server/columnar_ingress.py) appends raw recv() chunks to a
// per-connection buffer and decodes every connection's bytes in one pass
// a window. This library owns the two byte-bound stages of that pass, so
// drain cost scales with bytes drained, not frames seen:
//
//   ingress_scan   — split one accumulated buffer into complete
//                    [u8 type | u32 len | payload | u32 crc32] frames,
//                    CRC-verifying each payload (slicing-by-4 CRC32,
//                    zlib polynomial — no -lz link dependency).
//   ingress_gather — gather the 16-byte op records of many frame runs
//                    into seven contiguous int32 planes (row, kind, a0,
//                    a1, tidx, cseq, ref) ready for ingest_planes.
//
// The ctypes binding is server/native_ingress.py. Anything that needs
// Python semantics (UTF-8 text tables, props JSON, protocol errors) stays
// in Python: this file never interprets payload contents beyond the
// record section.
//
// Build: native/build.py → libingress.so (g++ -O2 -shared -fPIC).

#include <cstdint>
#include <cstring>

namespace {

// CRC32 (zlib polynomial, reflected), slicing-by-4. Table built on first
// use; ~4 KB, shared by every scan call.
uint32_t CRC_TAB[4][256];
bool crc_ready = false;

void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        CRC_TAB[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = CRC_TAB[0][i];
        for (int t = 1; t < 4; t++) {
            c = CRC_TAB[0][c & 0xFF] ^ (c >> 8);
            CRC_TAB[t][i] = c;
        }
    }
    crc_ready = true;
}

uint32_t crc32_buf(const uint8_t* p, int64_t n) {
    if (!crc_ready) crc_init();
    uint32_t c = 0xFFFFFFFFu;
    while (n >= 4) {
        c ^= (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
             ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
        c = CRC_TAB[3][c & 0xFF] ^ CRC_TAB[2][(c >> 8) & 0xFF] ^
            CRC_TAB[1][(c >> 16) & 0xFF] ^ CRC_TAB[0][c >> 24];
        p += 4;
        n -= 4;
    }
    while (n-- > 0)
        c = CRC_TAB[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

uint32_t rd_u32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);  // little-endian hosts only (x86/arm LE)
    return v;
}

uint16_t rd_u16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return v;
}

}  // namespace

extern "C" {

// Scan an accumulated rx buffer for complete frames.
//
// Outputs (caller-allocated, capacity max_frames): ftype[i], poff[i],
// plen[i] describe frame i's payload. n_frames = frames emitted,
// consumed = bytes those frames cover (a trailing partial frame stays in
// the buffer). status: 0 = clean, 1 = CRC mismatch, 2 = oversized
// payload (> max_payload) — on 1/2 the scan stops AT the bad frame
// (it is not emitted; consumed excludes it) so the caller can deliver
// the good prefix, then fault the connection.
void ingress_scan(const uint8_t* buf, int64_t len, int64_t max_payload,
                  int64_t max_frames, uint8_t* ftype, int64_t* poff,
                  int64_t* plen, int64_t* n_frames, int64_t* consumed,
                  int32_t* status) {
    int64_t off = 0, n = 0;
    *status = 0;
    while (n < max_frames && len - off >= 5) {
        uint32_t length = rd_u32(buf + off + 1);
        if ((int64_t)length > max_payload) {
            *status = 2;
            break;
        }
        int64_t total = 5 + (int64_t)length + 4;
        if (len - off < total)
            break;  // torn frame: wait for more bytes
        const uint8_t* payload = buf + off + 5;
        if (crc32_buf(payload, length) != rd_u32(payload + length)) {
            *status = 1;
            break;
        }
        ftype[n] = buf[off];
        poff[n] = off + 5;
        plen[n] = (int64_t)length;
        n++;
        off += total;
    }
    *n_frames = n;
    *consumed = off;
}

// Gather op records from n_runs record sections (roff[i] = byte offset
// of run i's first 16-byte record in buf, rcnt[i] = its record count)
// into seven contiguous int32 planes, concatenated in run order. The
// record layout is _OP_DTYPE: row u16 | kind u8 | a0 u16 | a1 u16 |
// tidx u8 | cseq u32 | ref u32 (little-endian, 16 bytes).
void ingress_gather(const uint8_t* buf, int64_t n_runs,
                    const int64_t* roff, const int64_t* rcnt,
                    int32_t* row, int32_t* kind, int32_t* a0, int32_t* a1,
                    int32_t* tidx, int32_t* cseq, int32_t* ref) {
    int64_t j = 0;
    for (int64_t r = 0; r < n_runs; r++) {
        const uint8_t* p = buf + roff[r];
        for (int64_t i = 0; i < rcnt[r]; i++, p += 16, j++) {
            row[j] = (int32_t)rd_u16(p);
            kind[j] = (int32_t)p[2];
            a0[j] = (int32_t)rd_u16(p + 3);
            a1[j] = (int32_t)rd_u16(p + 5);
            tidx[j] = (int32_t)p[7];
            cseq[j] = (int32_t)rd_u32(p + 8);
            ref[j] = (int32_t)rd_u32(p + 12);
        }
    }
}

}  // extern "C"
