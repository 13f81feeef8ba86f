// The benchmark's frozen reference encoder: Snappy's greedy hash-table
// block encoder and the framing format (google/snappy framing_format.txt),
// as a plain C interface for ctypes.
//
// A copy of the plain block encoder of the port's native codec, kept here
// so that a change to the port cannot change the yardstick: the load
// cells' input streams and the save cells' expected streams both come
// from this file.  plain.py holds the same algorithm in pure Python, and
// the tests hold the two together byte for byte.
//
// Framing: chunks of at most 65,536 uncompressed bytes; a chunk is stored
// uncompressed (type 0x01) when its compressed body (varint length plus
// element) saves under 12.5%, else compressed (type 0x00); each chunk
// carries the masked CRC-32C of its uncompressed bytes.
//
// table_bits caps the hash table at 2**table_bits entries.  The reference
// is 14; a smaller table is the control: a faster encoder whose streams
// are valid Snappy but not the reference's bytes.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const int kChunk = 65536;
const int kInputMargin = 15;
const int kMinNonLiteralBlockSize = 18;

uint32_t crc_table[8][256];

struct CrcInit {
  CrcInit() {
    for (uint32_t n = 0; n < 256; n++) {
      uint32_t c = n;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (~((c & 1) - 1)));
      crc_table[0][n] = c;
    }
    for (uint32_t n = 0; n < 256; n++) {
      uint32_t c = crc_table[0][n];
      for (int k = 1; k < 8; k++) {
        c = crc_table[0][c & 0xff] ^ (c >> 8);
        crc_table[k][n] = c;
      }
    }
  }
} crc_init_once;

uint32_t crc32c(const uint8_t* data, uint64_t n) {
  uint32_t crc = ~0u;
  uint64_t i = 0;
  while (i + 8 <= n) {
    uint32_t lo, hi;
    memcpy(&lo, data + i, 4);
    memcpy(&hi, data + i + 4, 4);
    uint32_t c0 = crc ^ lo;
    crc = crc_table[7][c0 & 0xff] ^ crc_table[6][(c0 >> 8) & 0xff] ^
          crc_table[5][(c0 >> 16) & 0xff] ^ crc_table[4][c0 >> 24] ^
          crc_table[3][hi & 0xff] ^ crc_table[2][(hi >> 8) & 0xff] ^
          crc_table[1][(hi >> 16) & 0xff] ^ crc_table[0][hi >> 24];
    i += 8;
  }
  while (i < n) crc = crc_table[0][(crc ^ data[i++]) & 0xff] ^ (crc >> 8);
  return ~crc;
}

uint32_t mask_crc(uint32_t c) { return ((c >> 15) | (c << 17)) + 0xa282ead8u; }

uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;  // little-endian hosts
}

uint32_t hash32(uint32_t u, uint32_t shift) { return (u * 0x1e35a7bdu) >> shift; }

uint8_t* emit_literal(uint8_t* dst, const uint8_t* lit, int len) {
  int n = len - 1;
  if (n < 60) {
    *dst++ = (uint8_t)(n << 2);
  } else if (n < (1 << 8)) {
    *dst++ = 60 << 2;
    *dst++ = (uint8_t)n;
  } else {  // a chunk is at most 64 KiB, so n < 1 << 16
    *dst++ = 61 << 2;
    *dst++ = (uint8_t)n;
    *dst++ = (uint8_t)(n >> 8);
  }
  memcpy(dst, lit, (size_t)len);
  return dst + len;
}

uint8_t* emit_copy(uint8_t* dst, int offset, int length) {
  while (length >= 68) {
    *dst++ = (63 << 2) | 2;
    *dst++ = (uint8_t)offset;
    *dst++ = (uint8_t)(offset >> 8);
    length -= 64;
  }
  if (length > 64) {
    *dst++ = (59 << 2) | 2;
    *dst++ = (uint8_t)offset;
    *dst++ = (uint8_t)(offset >> 8);
    length -= 60;
  }
  if (length >= 12 || offset >= 2048) {
    *dst++ = (uint8_t)(((length - 1) << 2) | 2);
    *dst++ = (uint8_t)offset;
    *dst++ = (uint8_t)(offset >> 8);
  } else {
    *dst++ = (uint8_t)(((offset >> 8) << 5) | ((length - 4) << 2) | 1);
    *dst++ = (uint8_t)offset;
  }
  return dst;
}

// One block of 1 to 65,536 bytes: its element (no length varint).
uint8_t* encode_block(uint8_t* dst, const uint8_t* src, int len,
                      int table_bits, std::vector<uint16_t>& table) {
  if (len < kMinNonLiteralBlockSize) return emit_literal(dst, src, len);
  uint32_t shift = 32 - 8;
  int table_size = 1 << 8;
  while (table_size < (1 << table_bits) && table_size < len) {
    shift--;
    table_size *= 2;
  }
  table.assign((size_t)table_size, 0);
  int s_limit = len - kInputMargin;
  int next_emit = 0;
  int s = 1;
  uint32_t next_hash = hash32(load32(src + s), shift);
  for (;;) {
    int skip = 32;
    int next_s = s;
    int candidate = 0;
    for (;;) {
      s = next_s;
      int bytes_between = skip >> 5;
      next_s = s + bytes_between;
      skip += bytes_between;
      if (next_s > s_limit) goto emit_remainder;
      candidate = table[next_hash];
      table[next_hash] = (uint16_t)s;
      next_hash = hash32(load32(src + next_s), shift);
      if (load32(src + s) == load32(src + candidate)) break;
    }
    dst = emit_literal(dst, src + next_emit, s - next_emit);
    for (;;) {
      int base = s;
      s += 4;
      int i = candidate + 4;
      while (s < len && src[i] == src[s]) {
        i++;
        s++;
      }
      dst = emit_copy(dst, base - candidate, s - base);
      next_emit = s;
      if (s >= s_limit) goto emit_remainder;
      uint32_t prev = load32(src + s - 1);
      table[hash32(prev, shift)] = (uint16_t)(s - 1);
      uint32_t cur = load32(src + s);
      uint32_t curr_hash = hash32(cur, shift);
      candidate = table[curr_hash];
      table[curr_hash] = (uint16_t)s;
      if (cur != load32(src + candidate)) {
        next_hash = hash32(load32(src + s + 1), shift);
        s++;
        break;
      }
    }
  }
emit_remainder:
  if (next_emit < len) dst = emit_literal(dst, src + next_emit, len - next_emit);
  return dst;
}

uint8_t* put_uvarint(uint8_t* dst, uint64_t v) {
  while (v >= 0x80) {
    *dst++ = (uint8_t)(v) | 0x80;
    v >>= 7;
  }
  *dst++ = (uint8_t)v;
  return dst;
}

const uint8_t kStreamId[10] = {0xff, 0x06, 0x00, 0x00, 's', 'N', 'a', 'P', 'p', 'Y'};
const uint64_t kSlot = 8 + 3 + kChunk + kChunk / 6 + 32;  // a record at most

}  // namespace

extern "C" {

// Bytes that pb_frame may write for n input bytes.
uint64_t pb_frame_bound(uint64_t n) {
  return 10 + (n + kChunk - 1) / kChunk * kSlot;
}

// Frame n bytes of src into dst (pb_frame_bound(n) bytes); returns the
// stream's length.  elem_lens[c] receives chunk c's element length (its
// tags, without the length varint), whether or not the chunk is stored
// uncompressed.  threads > 1 encodes chunks in parallel: the same bytes.
int64_t pb_frame(const uint8_t* src, uint64_t n, uint8_t* dst,
                 int32_t* elem_lens, int threads, int table_bits) {
  if (table_bits < 8 || table_bits > 14) return -1;
  uint64_t nchunks = (n + kChunk - 1) / kChunk;
  memcpy(dst, kStreamId, 10);
  std::vector<uint8_t> scratch(nchunks * kSlot);
  std::vector<uint64_t> rec_len(nchunks);
  std::atomic<uint64_t> next(0);
  auto worker = [&]() {
    std::vector<uint16_t> table;
    for (;;) {
      uint64_t c = next.fetch_add(1);
      if (c >= nchunks) break;
      const uint8_t* chunk = src + c * kChunk;
      int len = (int)(n - c * kChunk < (uint64_t)kChunk ? n - c * kChunk : kChunk);
      uint8_t* rec = scratch.data() + c * kSlot;
      uint8_t* elem = put_uvarint(rec + 8, (uint64_t)len);
      uint8_t* end = encode_block(elem, chunk, len, table_bits, table);
      elem_lens[c] = (int32_t)(end - elem);
      uint64_t body = (uint64_t)(end - (rec + 8));
      uint8_t type = 0x00;
      if (body >= (uint64_t)(len - len / 8)) {
        type = 0x01;
        memcpy(rec + 8, chunk, (size_t)len);
        body = (uint64_t)len;
      }
      uint64_t blen = body + 4;
      uint32_t crc = mask_crc(crc32c(chunk, (uint64_t)len));
      rec[0] = type;
      rec[1] = (uint8_t)blen;
      rec[2] = (uint8_t)(blen >> 8);
      rec[3] = (uint8_t)(blen >> 16);
      memcpy(rec + 4, &crc, 4);
      rec_len[c] = 4 + blen;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; t++) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  uint64_t pos = 10;
  for (uint64_t c = 0; c < nchunks; c++) {
    memcpy(dst + pos, scratch.data() + c * kSlot, rec_len[c]);
    pos += rec_len[c];
  }
  return (int64_t)pos;
}

}  // extern "C"
