// snappy_tpu native host codec (L7, SURVEY.md §7.6).
// The port's copy of snappy_tpu/native/src/snappy_native.cpp: a fix to one
// copy is made in both.
//
// Where the reference drives native helpers (cgo islands + shelled-out
// binaries, SURVEY.md §2.2), this framework is native here: a C++
// implementation of the reference Snappy block codec (exactly the greedy
// hash-table emission our L0 oracle defines), hardware CRC-32C
// (SSE4.2 with a slice-by-8 fallback), and multithreaded framed-stream
// encode/decode for the host path.  Exposed via a plain C ABI for
// ctypes binding (no pybind11 in this image).
//
// Error codes mirror snappy_tpu.errors (0 ok; negative = error class).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// error codes (keep in sync with snappy_tpu_torch/native/__init__.py)
enum {
  SN_OK = 0,
  SN_ERR_CORRUPT = -1,
  SN_ERR_TOO_LARGE = -2,
  SN_ERR_CHECKSUM = -3,
  SN_ERR_UNSUPPORTED = -4,
  SN_ERR_BUFFER = -5,
};

// ---------------------------------------------------------------------
// CRC-32C
static uint32_t crc_table[8][256];

static void crc_init_tables() {
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

static struct CrcInit {
  CrcInit() { crc_init_tables(); }
} crc_init_once;

uint32_t sn_crc32c(const uint8_t* data, uint64_t n, uint32_t crc) {
  uint64_t i = 0;
  crc = ~crc;
#if defined(__SSE4_2__)
  uint64_t c = crc;
  while (i + 8 <= n) {
    uint64_t word;
    memcpy(&word, data + i, 8);
    c = _mm_crc32_u64(c, word);
    i += 8;
  }
  while (i < n) c = _mm_crc32_u8((uint32_t)c, data[i++]);
  return ~(uint32_t)c;
#else
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
#endif
}

static inline uint32_t mask_crc(uint32_t c) {
  return (uint32_t)(((c >> 15) | (c << 17)) + 0xa282ead8u);
}

// ---------------------------------------------------------------------
// block format helpers

static inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/arm64)
}
static inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

static inline void store64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }

extern "C++" {  // templates cannot carry C linkage
// Shared validating tag walk over one block element's payload.  The
// fast loop decodes each tag from a single unaligned 64-bit load
// (s + 8 <= n makes every tag's extra bytes readable without per-byte
// bounds checks); the tail falls back to the byte-careful loop.  Sink
// supplies the data movement:
//   bool lit(uint64_t d, uint64_t s, uint64_t len)   src[s:s+len) -> out[d]
//   bool copy(uint64_t d, uint64_t off, uint64_t len) out[d-off:..) -> out[d]
//   bool finish()
// false aborts with SN_ERR_BUFFER (planner budget overflow).
template <class Sink>
static int walk_stream(const uint8_t* src, uint64_t n, uint64_t s,
                       uint64_t dst_len, Sink& sink) {
  uint64_t d = 0;
  while (s + 8 <= n) {
    uint64_t w8 = load64(src + s);
    uint32_t c = (uint32_t)w8 & 0xff;
    uint64_t length, offset;
    if ((c & 3) == 0) {
      uint32_t x = c >> 2;
      if (__builtin_expect(x < 60, 1)) {
        length = (uint64_t)x + 1;
        s += 1;
      } else {
        uint32_t nb = x - 59;  // 1..4 extra length bytes
        uint64_t ex =
            (w8 >> 8) & ((nb == 4) ? 0xffffffffull : ((1ull << (8 * nb)) - 1));
        length = ex + 1;
        s += 1 + nb;
      }
      if (length > dst_len - d || length > n - s) return SN_ERR_CORRUPT;
      if (!sink.lit(d, s, length)) return SN_ERR_BUFFER;
      s += length;
      d += length;
      continue;
    } else if ((c & 3) == 1) {
      length = 4 + ((c >> 2) & 7);
      offset = ((uint64_t)(c & 0xe0) << 3) | ((w8 >> 8) & 0xff);
      s += 2;
    } else if ((c & 3) == 2) {
      length = 1 + (c >> 2);
      offset = (w8 >> 8) & 0xffff;
      s += 3;
    } else {
      length = 1 + (c >> 2);
      offset = (w8 >> 8) & 0xffffffffull;
      s += 5;
    }
    if (offset == 0 || d < offset) return SN_ERR_CORRUPT;
    if (length > dst_len - d) return SN_ERR_CORRUPT;
    if (!sink.copy(d, offset, length)) return SN_ERR_BUFFER;
    d += length;
  }
  // byte-careful tail (identical validation to the classic walk)
  while (s < n) {
    uint32_t tag = src[s] & 3;
    uint64_t length, offset;
    if (tag == 0) {
      uint32_t x = src[s] >> 2;
      if (x < 60) {
        s += 1;
      } else if (x == 60) {
        s += 2;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 1];
      } else if (x == 61) {
        s += 3;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 2] | ((uint32_t)src[s - 1] << 8);
      } else if (x == 62) {
        s += 4;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 3] | ((uint32_t)src[s - 2] << 8) |
            ((uint32_t)src[s - 1] << 16);
      } else {
        s += 5;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 4] | ((uint32_t)src[s - 3] << 8) |
            ((uint32_t)src[s - 2] << 16) | ((uint32_t)src[s - 1] << 24);
      }
      length = (uint64_t)x + 1;
      if (length > dst_len - d || length > n - s) return SN_ERR_CORRUPT;
      if (!sink.lit(d, s, length)) return SN_ERR_BUFFER;
      s += length;
      d += length;
      continue;
    } else if (tag == 1) {
      s += 2;
      if (s > n) return SN_ERR_CORRUPT;
      length = 4 + ((src[s - 2] >> 2) & 7);
      offset = ((uint64_t)(src[s - 2] & 0xe0) << 3) | src[s - 1];
    } else if (tag == 2) {
      s += 3;
      if (s > n) return SN_ERR_CORRUPT;
      length = 1 + (src[s - 3] >> 2);
      offset = src[s - 2] | ((uint64_t)src[s - 1] << 8);
    } else {
      s += 5;
      if (s > n) return SN_ERR_CORRUPT;
      length = 1 + (src[s - 5] >> 2);
      offset = src[s - 4] | ((uint64_t)src[s - 3] << 8) |
               ((uint64_t)src[s - 2] << 16) | ((uint64_t)src[s - 1] << 24);
    }
    if (offset == 0 || d < offset) return SN_ERR_CORRUPT;
    if (length > dst_len - d) return SN_ERR_CORRUPT;
    if (!sink.copy(d, offset, length)) return SN_ERR_BUFFER;
    d += length;
  }
  if (d != dst_len) return SN_ERR_CORRUPT;
  if (!sink.finish()) return SN_ERR_BUFFER;
  return SN_OK;
}
}  // extern "C++"

// Overlap-safe copy expansion with wide stores and slop.  Establishes
// a store distance >= 8 that is a multiple of the period (byte phase
// for offsets < 8), doubles the distance with full-period word writes
// until >= 32, then streams 32-byte chunks.  Every word write copies
// from exactly -dist, so bytes inside [start, end) are always correct;
// garbage lands only in the <= 31-byte slop past the write frontier and
// is overwritten by the next round or left past `end`.  Caller
// guarantees end + 31 stays inside the allocation.
static inline void copy_pattern_slop(uint8_t* dp, uint64_t offset,
                                     uint64_t len) {
  uint8_t* end = dp + len;
  if (offset < 8) {
    uint8_t* stop = dp + (len < 16 ? len : 16);
    while (dp < stop) {
      *dp = *(dp - offset);
      dp++;
    }
    if (dp == end) return;
    offset *= (8 + offset - 1) / offset;  // smallest multiple >= 8
  }
  const uint8_t* sp = dp - offset;
  while ((uint64_t)(dp - sp) < 32) {
    uint64_t dist = (uint64_t)(dp - sp);
    for (uint64_t i = 0; i < dist; i += 8) store64(dp + i, load64(sp + i));
    dp += dist;
    if (dp >= end) return;
  }
  while (dp < end) {
    store64(dp, load64(sp));
    store64(dp + 8, load64(sp + 8));
    store64(dp + 16, load64(sp + 16));
    store64(dp + 24, load64(sp + 24));
    dp += 32;
    sp += 32;
  }
}

static const int kMaxBlockSize = 65536;
static const int kInputMargin = 15;
static const int kMinNonLiteralBlockSize = 18;

static inline uint32_t hash32(uint32_t u, uint32_t shift) {
  return (u * 0x1e35a7bdu) >> shift;
}

static uint8_t* emit_literal(uint8_t* dst, const uint8_t* lit, int len) {
  int n = len - 1;
  if (n < 60) {
    *dst++ = (uint8_t)(n << 2);
  } else if (n < (1 << 8)) {
    *dst++ = 60 << 2;
    *dst++ = (uint8_t)n;
  } else if (n < (1 << 16)) {
    *dst++ = 61 << 2;
    *dst++ = (uint8_t)n;
    *dst++ = (uint8_t)(n >> 8);
  } else if (n < (1 << 24)) {
    *dst++ = 62 << 2;
    *dst++ = (uint8_t)n;
    *dst++ = (uint8_t)(n >> 8);
    *dst++ = (uint8_t)(n >> 16);
  } else {
    *dst++ = 63 << 2;
    *dst++ = (uint8_t)n;
    *dst++ = (uint8_t)(n >> 8);
    *dst++ = (uint8_t)(n >> 16);
    *dst++ = (uint8_t)((uint32_t)n >> 24);
  }
  memcpy(dst, lit, (size_t)len);
  return dst + len;
}

static uint8_t* emit_copy(uint8_t* dst, int offset, int length) {
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

// Record-emitting cursor for the fused encode stage: mirrors
// sn_parse_tags' per-TAG records (emit_copy's length chops produce one
// record per emitted tag) so the encode planner can skip the separate
// parse pass over the emission it just produced (r4: the parse re-walk
// cost ~38 us/block).  Bit-identical records to sn_parse_tags over the
// same emission (tests enforce through the staged-plan parity).
struct RecCursor {
  int32_t* rec;
  uint64_t k;
  const uint8_t* elem0;  // element base (lit_src is element-relative)
  int64_t d;             // output position
  inline void lit(const uint8_t* data_at, int length) {
    int32_t* r = rec + 4 * k++;
    r[0] = 0;
    r[1] = length;
    r[2] = (int32_t)(data_at - elem0);
    r[3] = (int32_t)d;
    d += length;
  }
  inline void copy(int offset, int length) {
    // replicate emit_copy's chop sequence record-for-record
    while (length >= 68) {
      int32_t* r = rec + 4 * k++;
      r[0] = 1; r[1] = 64; r[2] = offset; r[3] = (int32_t)d;
      d += 64;
      length -= 64;
    }
    if (length > 64) {
      int32_t* r = rec + 4 * k++;
      r[0] = 1; r[1] = 60; r[2] = offset; r[3] = (int32_t)d;
      d += 60;
      length -= 60;
    }
    int32_t* r = rec + 4 * k++;
    r[0] = 1; r[1] = length; r[2] = offset; r[3] = (int32_t)d;
    d += length;
  }
};

// Reference greedy hash-table encoder for one block (the exact algorithm
// of our L0 oracle, spec/reference.py encode_block).  r4 tuning (same
// decisions, same emission byte-for-byte): thread_local table instead of
// a per-call zeroed vector, and 64-bit XOR/ctz match extension instead
// of the byte loop — measured 0.35 -> ~0.5+ GB/s/core on the corpus
// (upstream C++ snappy context: 0.59 here).
extern "C++" {
// REC=true also streams per-tag records through a RecCursor (the fused
// encode stage's parse elision); REC=false is the plain encoder.  Both
// emit identical bytes.
template <bool REC>
static uint8_t* encode_block_t(uint8_t* dst, const uint8_t* src, int len,
                               RecCursor* rc) {
  if (len < kMinNonLiteralBlockSize) {
    uint8_t* nd = emit_literal(dst, src, len);
    if (REC) rc->lit(nd - len, len);
    return nd;
  }

  uint32_t shift = 32 - 8;
  int table_size = 1 << 8;
  while (table_size < (1 << 14) && table_size < len) {
    shift--;
    table_size *= 2;
  }
  static thread_local std::vector<uint16_t> table_tls;
  if ((int)table_tls.size() < table_size) table_tls.resize(1 << 14);
  uint16_t* table = table_tls.data();
  memset(table, 0, (size_t)table_size * sizeof(uint16_t));

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
    {
      uint8_t* nd = emit_literal(dst, src + next_emit, s - next_emit);
      if (REC && s > next_emit) rc->lit(nd - (s - next_emit), s - next_emit);
      dst = nd;
    }

    for (;;) {
      int base = s;
      s += 4;
      int i = candidate + 4;
      // 64-bit match extension (i < s always, so src[i..i+8) is readable
      // whenever src[s..s+8) is); identical match lengths to the byte loop
      while (s + 8 <= len) {
        uint64_t x = load64(src + i) ^ load64(src + s);
        if (x) {
          int adv = (int)(__builtin_ctzll(x) >> 3);
          s += adv;
          i += adv;
          goto ext_done;
        }
        s += 8;
        i += 8;
      }
      while (s < len && src[i] == src[s]) {
        i++;
        s++;
      }
    ext_done:
      dst = emit_copy(dst, base - candidate, s - base);
      if (REC) rc->copy(base - candidate, s - base);
      next_emit = s;
      if (s >= s_limit) goto emit_remainder;
      uint64_t x = load64(src + s - 1);
      uint32_t prev_hash = hash32((uint32_t)x, shift);
      table[prev_hash] = (uint16_t)(s - 1);
      uint32_t curr_hash = hash32((uint32_t)(x >> 8), shift);
      candidate = table[curr_hash];
      table[curr_hash] = (uint16_t)s;
      if ((uint32_t)(x >> 8) != load32(src + candidate)) {
        next_hash = hash32((uint32_t)(x >> 16), shift);
        s++;
        break;
      }
    }
  }
emit_remainder:
  if (next_emit < len) {
    uint8_t* nd = emit_literal(dst, src + next_emit, len - next_emit);
    if (REC) rc->lit(nd - (len - next_emit), len - next_emit);
    dst = nd;
  }
  return dst;
}
}  // extern "C++"

static uint8_t* encode_block(uint8_t* dst, const uint8_t* src, int len) {
  return encode_block_t<false>(dst, src, len, nullptr);
}

extern "C++" {
// TWO-BLOCK INTERLEAVED matcher (round 5, the encode-study's winning
// variant — tools/enc_study.py, docs/performance.md).  Blocks are
// independent (separate tables, separate dst), so running two as
// round-robin lanes puts two independent dependency chains in the OoO
// window — the single-block loop is latency-bound (~5 cyc/B measured),
// not throughput-bound; measured +32% at 4 threads on this box.
// Byte-identical per block to encode_block: each lane replicates the
// exact probe/store/emit sequence (enc_study asserts; tests anchor
// sn_compress_batch to sn_compress row-for-row).
struct Lane {
  const uint8_t* src;
  uint8_t* d;
  uint16_t* tab;
  int len, s_limit, next_emit, s, next_s, skip, candidate;
  uint32_t next_hash, shift;
  int state;  // 0 = skip/probe loop, 1 = copy loop, 2 = done
};

static inline void lane_init(Lane& L, const uint8_t* src, uint8_t* dst,
                             int len, uint16_t* tab) {
  L.src = src;
  L.d = dst;
  L.tab = tab;
  L.len = len;
  L.next_emit = 0;
  if (len < kMinNonLiteralBlockSize) {
    L.d = emit_literal(L.d, src, len);
    L.state = 2;
    return;
  }
  L.shift = 32 - 8;
  int table_size = 1 << 8;
  while (table_size < (1 << 14) && table_size < len) {
    L.shift--;
    table_size *= 2;
  }
  memset(tab, 0, (size_t)table_size * sizeof(uint16_t));
  L.s_limit = len - kInputMargin;
  L.s = 1;
  L.next_hash = hash32(load32(src + 1), L.shift);
  L.skip = 32;
  L.next_s = 1;
  L.candidate = 0;
  L.state = 0;
}

static inline void lane_finish(Lane& L) {
  if (L.next_emit < L.len)
    L.d = emit_literal(L.d, L.src + L.next_emit, L.len - L.next_emit);
  L.state = 2;
}

// One probe (state 0) or one copy iteration (state 1).
static inline void lane_step(Lane& L) {
  if (L.state == 0) {
    L.s = L.next_s;
    int bytes_between = L.skip >> 5;
    L.next_s = L.s + bytes_between;
    L.skip += bytes_between;
    if (L.next_s > L.s_limit) {
      lane_finish(L);
      return;
    }
    L.candidate = L.tab[L.next_hash];
    L.tab[L.next_hash] = (uint16_t)L.s;
    L.next_hash = hash32(load32(L.src + L.next_s), L.shift);
    if (load32(L.src + L.s) == load32(L.src + L.candidate)) {
      L.d = emit_literal(L.d, L.src + L.next_emit, L.s - L.next_emit);
      L.state = 1;
    }
    return;
  }
  // state 1: one copy-loop iteration (extension + emit + transition)
  const uint8_t* src = L.src;
  int len = L.len;
  int base = L.s;
  int s = L.s + 4;
  int i = L.candidate + 4;
  while (s + 8 <= len) {
    uint64_t x = load64(src + i) ^ load64(src + s);
    if (x) {
      int adv = (int)(__builtin_ctzll(x) >> 3);
      s += adv;
      i += adv;
      goto ext_done;
    }
    s += 8;
    i += 8;
  }
  while (s < len && src[i] == src[s]) {
    i++;
    s++;
  }
ext_done:
  L.d = emit_copy(L.d, base - L.candidate, s - base);
  L.next_emit = s;
  if (s >= L.s_limit) {
    lane_finish(L);
    return;
  }
  {
    uint64_t x = load64(src + s - 1);
    uint32_t prev_hash = hash32((uint32_t)x, L.shift);
    L.tab[prev_hash] = (uint16_t)(s - 1);
    uint32_t curr_hash = hash32((uint32_t)(x >> 8), L.shift);
    L.candidate = L.tab[curr_hash];
    L.tab[curr_hash] = (uint16_t)s;
    if ((uint32_t)(x >> 8) != load32(src + L.candidate)) {
      L.next_hash = hash32((uint32_t)(x >> 16), L.shift);
      L.s = s + 1;
      L.skip = 32;
      L.next_s = L.s;
      L.state = 0;
    } else {
      L.s = s;  // stay in the copy loop with the new candidate
    }
  }
}

// Encode a PAIR of blocks in lockstep; returns each end pointer.
static inline void encode_pair_interleaved(
    const uint8_t* srcA, int lenA, uint8_t* dstA, uint8_t** endA,
    const uint8_t* srcB, int lenB, uint8_t* dstB, uint8_t** endB) {
  static thread_local std::vector<uint16_t> tA, tB;
  if (tA.size() < (1u << 14)) tA.resize(1 << 14);
  if (tB.size() < (1u << 14)) tB.resize(1 << 14);
  Lane A, B;
  lane_init(A, srcA, dstA, lenA, tA.data());
  lane_init(B, srcB, dstB, lenB, tB.data());
  while (A.state != 2 && B.state != 2) {
    lane_step(A);
    lane_step(B);
  }
  while (A.state != 2) lane_step(A);
  while (B.state != 2) lane_step(B);
  *endA = A.d;
  *endB = B.d;
}

}  // extern "C++"

uint64_t sn_max_compressed_length(uint64_t n) { return 32 + n + n / 6; }

// A/B seam for the interleaved matcher (tools/enc_study.py): set
// SN_ENC_PAIR=0 to force the plain per-block path everywhere.
static bool sn_pair_enabled() {
  static const bool on = [] {
    const char* e = getenv("SN_ENC_PAIR");
    return !(e && e[0] == '0');
  }();
  return on;
}

static uint8_t* put_uvarint(uint8_t* dst, uint64_t v) {
  while (v >= 0x80) {
    *dst++ = (uint8_t)(v) | 0x80;
    v >>= 7;
  }
  *dst++ = (uint8_t)v;
  return dst;
}

int64_t sn_compress(const uint8_t* src, uint64_t n, uint8_t* dst) {
  if (n > 0xffffffffull) return SN_ERR_TOO_LARGE;
  uint8_t* d = put_uvarint(dst, n);
  uint64_t pos = 0;
  // 64 KiB fragments are self-contained (fresh table each), so
  // consecutive PAIRS run through the interleaved matcher (+12%
  // single-thread, byte-identical); lane B emits into a thread_local
  // scratch (its dst offset depends on A's length) and is memcpy'd
  // into place — ~1 extra byte move per ~3 output bytes.
  static thread_local std::vector<uint8_t> scratchB;
  while (sn_pair_enabled() && pos + 2 * (uint64_t)kMaxBlockSize <= n) {
    if (scratchB.size() < sn_max_compressed_length(kMaxBlockSize))
      scratchB.resize(sn_max_compressed_length(kMaxBlockSize));
    uint8_t *eA, *eB;
    encode_pair_interleaved(src + pos, kMaxBlockSize, d, &eA,
                            src + pos + kMaxBlockSize, kMaxBlockSize,
                            scratchB.data(), &eB);
    size_t lenB = (size_t)(eB - scratchB.data());
    memcpy(eA, scratchB.data(), lenB);
    d = eA + lenB;
    pos += 2 * (uint64_t)kMaxBlockSize;
  }
  while (pos < n) {
    int blk = (int)((n - pos < (uint64_t)kMaxBlockSize) ? (n - pos) : kMaxBlockSize);
    d = encode_block(d, src + pos, blk);
    pos += blk;
  }
  return (int64_t)(d - dst);
}

int sn_uncompressed_length(const uint8_t* src, uint64_t n, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  for (int i = 0; i < 5; i++) {
    if ((uint64_t)i >= n) return SN_ERR_CORRUPT;
    uint8_t b = src[i];
    v |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      if (v > 0xffffffffull) return SN_ERR_TOO_LARGE;
      *out = v;
      return i + 1;  // header length
    }
    shift += 7;
  }
  return SN_ERR_CORRUPT;
}

// Strict validating decoder (reference error surface).
// Pure-decode sink: wide copies with slop confined to THIS element's
// output span (framed chunks decode concurrently into one buffer, so
// slop must never cross into a neighbor's region).
struct DecodeSink {
  uint8_t* dst;
  const uint8_t* src;
  uint64_t dst_len, src_len;
  inline bool lit(uint64_t d, uint64_t s, uint64_t L) {
    if (d + L + 31 < dst_len && s + L + 31 < src_len) {
      uint8_t* dp = dst + d;
      const uint8_t* sp = src + s;
      uint64_t i = 0;
      do {
        memcpy(dp + i, sp + i, 32);
        i += 32;
      } while (i < L);
    } else {
      memcpy(dst + d, src + s, (size_t)L);
    }
    return true;
  }
  inline bool copy(uint64_t d, uint64_t off, uint64_t L) {
    if (d + L + 31 < dst_len) {
      if (off >= 32) {
        uint8_t* dp = dst + d;
        const uint8_t* sp = dp - off;
        uint64_t i = 0;
        do {
          memcpy(dp + i, sp + i, 32);
          i += 32;
        } while (i < L);
      } else {
        copy_pattern_slop(dst + d, off, L);
      }
    } else if (off >= 8 && L <= off) {
      memcpy(dst + d, dst + d - off, (size_t)L);
    } else {
      for (uint64_t k = 0, p = d; k < L; k++, p++) dst[p] = dst[p - off];
    }
    return true;
  }
  inline bool finish() { return true; }
};

int sn_decode_block(const uint8_t* src, uint64_t n, uint64_t s, uint8_t* dst,
                    uint64_t dst_len) {
  DecodeSink sink{dst, src, dst_len, n};
  return walk_stream(src, n, s, dst_len, sink);
}

// Tag pre-parse for the hybrid device decoder: walk the element stream
// once (validating), emitting one fixed-width record per element:
//   rec[4*k+0] = kind        (0 literal, 1 copy)
//   rec[4*k+1] = out_len
//   rec[4*k+2] = offset      (copies) / literal byte position in src (lits)
//   rec[4*k+3] = out_start   (exclusive scan of out_len)
// Returns the element count, or a negative error.  The device kernel
// then skips tag-boundary discovery entirely (SURVEY.md §7.3.1).
extern "C++" {
struct TagRecordSink {
  int32_t* rec;
  uint64_t k, max_tags;
  inline bool lit(uint64_t d, uint64_t s, uint64_t L) {
    if (k >= max_tags) return false;
    int32_t* r = rec + 4 * k++;
    r[0] = 0;
    r[1] = (int32_t)L;
    r[2] = (int32_t)s;
    r[3] = (int32_t)d;
    return true;
  }
  inline bool copy(uint64_t d, uint64_t off, uint64_t L) {
    if (k >= max_tags) return false;
    int32_t* r = rec + 4 * k++;
    r[0] = 1;
    r[1] = (int32_t)L;
    r[2] = (int32_t)off;
    r[3] = (int32_t)d;
    return true;
  }
  inline bool finish() { return true; }
};
}  // extern "C++"

int64_t sn_parse_tags(const uint8_t* src, uint64_t n, uint64_t s,
                      uint64_t dst_len, int32_t* rec, uint64_t max_tags) {
  TagRecordSink sink{rec, 0, max_tags};
  int rc = walk_stream(src, n, s, dst_len, sink);
  if (rc != SN_OK) return rc;
  return (int64_t)sink.k;
}

int sn_decompress(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t dst_len) {
  uint64_t want = 0;
  int hdr = sn_uncompressed_length(src, n, &want);
  if (hdr < 0) return hdr;
  if (want != dst_len) return SN_ERR_BUFFER;
  return sn_decode_block(src, n, (uint64_t)hdr, dst, dst_len);
}

// ---------------------------------------------------------------------
// framed format (multithreaded over chunks)

static const uint8_t kStreamId[10] = {0xff, 0x06, 0x00, 0x00,
                                      's',  'N',  'a',  'P', 'p', 'Y'};

int64_t sn_framed_max_length(uint64_t n, uint64_t chunk) {
  if (chunk == 0 || chunk > 65536) return SN_ERR_BUFFER;
  uint64_t chunks = (n + chunk - 1) / chunk;
  return 10 + (uint64_t)(n + chunks * (8 + 8) + 64);
}

// Shared body of sn_compress_framed / sn_compress_framed_crc.
// crcs: optional per-chunk RAW CRC-32C values (e.g. computed on the
// TPU's MXU before the bytes left HBM) — masked here; when null the
// host computes them.  rec_lens: optional per-chunk framed-record
// lengths (header+crc+body) so callers can split the concatenated
// output back into records (the multi-host assembly contract).
// write_id: emit the 10-byte stream identifier (0 lets per-batch
// calls concatenate into one stream — framed chunks are independent).
static int64_t compress_framed_impl(const uint8_t* src, uint64_t n,
                                    uint8_t* dst, uint64_t chunk_size,
                                    int threads, const uint32_t* crcs,
                                    uint64_t* rec_lens, int write_id) {
  if (chunk_size == 0 || chunk_size > 65536) return SN_ERR_BUFFER;
  uint64_t nchunks = n ? (n + chunk_size - 1) / chunk_size : 0;
  uint64_t hdr = 0;
  if (write_id) {
    memcpy(dst, kStreamId, 10);
    hdr = 10;
  }
  if (!nchunks) return (int64_t)hdr;

  // worst case per chunk body: 8 hdr + max_compressed(chunk)
  uint64_t per = 8 + sn_max_compressed_length(chunk_size);
  std::vector<uint64_t> out_len(nchunks, 0);
  // uninitialized on purpose: a value-initialized vector memsets
  // ~76 KiB/chunk (≈8% of the whole call at 256 MB) for bytes the
  // workers overwrite anyway
  std::unique_ptr<uint8_t[]> scratch_owner(new uint8_t[per * nchunks]);
  uint8_t* const scratch = scratch_owner.get();

  int nt = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  std::atomic<uint64_t> next(0);
  // finalize one chunk: incompressible fallback + header write
  auto finish = [&](uint64_t c, uint64_t off, uint64_t len,
                    int64_t comp, uint32_t crc) {
    uint8_t* out = scratch + c * per;
    uint8_t type = 0x00;
    uint64_t body;
    if (comp < 0 || (uint64_t)comp >= len - len / 8) {
      type = 0x01;
      memcpy(out + 8, src + off, len);
      body = len + 4;
    } else {
      body = (uint64_t)comp + 4;
    }
    out[0] = type;
    out[1] = (uint8_t)body;
    out[2] = (uint8_t)(body >> 8);
    out[3] = (uint8_t)(body >> 16);
    out[4] = (uint8_t)crc;
    out[5] = (uint8_t)(crc >> 8);
    out[6] = (uint8_t)(crc >> 16);
    out[7] = (uint8_t)(crc >> 24);
    out_len[c] = 4 + body;
  };
  // Workers take chunk PAIRS: the two bodies land in independent scratch
  // slots, so the interleaved matcher runs with no scratch copy
  // (byte-identical emission; see encode_pair_interleaved).
  const bool pair_on = sn_pair_enabled();
  auto worker = [&]() {
    for (;;) {
      uint64_t c = next.fetch_add(2);
      if (c >= nchunks) break;
      uint64_t c2 = c + 1;
      uint64_t off = c * chunk_size;
      uint64_t len = (n - off < chunk_size) ? (n - off) : chunk_size;
      if (pair_on && c2 < nchunks) {
        uint64_t off2 = c2 * chunk_size;
        uint64_t len2 =
            (n - off2 < chunk_size) ? (n - off2) : chunk_size;
        if (len >= 1 && len <= (uint64_t)kMaxBlockSize && len2 >= 1 &&
            len2 <= (uint64_t)kMaxBlockSize) {
          uint8_t* outA = scratch + c * per + 8;
          uint8_t* outB = scratch + c2 * per + 8;
          uint32_t crcA = mask_crc(crcs ? crcs[c]
                                        : sn_crc32c(src + off, len, 0));
          uint32_t crcB = mask_crc(crcs ? crcs[c2]
                                        : sn_crc32c(src + off2, len2, 0));
          uint8_t* bA = put_uvarint(outA, len);
          uint8_t* bB = put_uvarint(outB, len2);
          uint8_t *eA, *eB;
          encode_pair_interleaved(src + off, (int)len, bA, &eA,
                                  src + off2, (int)len2, bB, &eB);
          finish(c, off, len, (int64_t)(eA - outA), crcA);
          finish(c2, off2, len2, (int64_t)(eB - outB), crcB);
          continue;
        }
      }
      for (uint64_t cc = c; cc <= c2 && cc < nchunks; cc++) {
        uint64_t o = cc * chunk_size;
        uint64_t l = (n - o < chunk_size) ? (n - o) : chunk_size;
        uint8_t* out = scratch + cc * per;
        uint32_t crc = mask_crc(crcs ? crcs[cc]
                                     : sn_crc32c(src + o, l, 0));
        int64_t comp = sn_compress(src + o, l, out + 8);
        finish(cc, o, l, comp, crc);
      }
    }
  };
  std::vector<std::thread> ths;
  for (int t = 0; t < nt - 1; t++) ths.emplace_back(worker);
  worker();
  for (auto& t : ths) t.join();

  // ordered assembly: offsets by prefix sum, then the compaction
  // memcpys run threaded (disjoint destinations) — serially this copy
  // was ~15% of the call on incompressible data
  std::vector<uint64_t> offs(nchunks + 1);
  offs[0] = 0;
  for (uint64_t c = 0; c < nchunks; c++) {
    offs[c + 1] = offs[c] + out_len[c];
    if (rec_lens) rec_lens[c] = out_len[c];
  }
  uint8_t* base = dst + hdr;
  if (nchunks >= 64 && nt > 1) {
    std::atomic<uint64_t> cnext(0);
    auto copier = [&]() {
      for (;;) {
        uint64_t c = cnext.fetch_add(16);
        if (c >= nchunks) break;
        uint64_t e = c + 16 < nchunks ? c + 16 : nchunks;
        for (uint64_t i = c; i < e; i++)
          memcpy(base + offs[i], scratch + i * per, out_len[i]);
      }
    };
    std::vector<std::thread> cths;
    for (int t = 0; t < nt - 1; t++) cths.emplace_back(copier);
    copier();
    for (auto& t : cths) t.join();
  } else {
    for (uint64_t c = 0; c < nchunks; c++)
      memcpy(base + offs[c], scratch + c * per, out_len[c]);
  }
  return (int64_t)(hdr + offs[nchunks]);
}

int64_t sn_compress_framed(const uint8_t* src, uint64_t n, uint8_t* dst,
                           uint64_t chunk_size, int threads) {
  return compress_framed_impl(src, n, dst, chunk_size, threads, nullptr,
                              nullptr, 1);
}

// From-device assembly entry: same framed output as sn_compress_framed
// but with per-chunk CRCs supplied by the caller (raw, unmasked — the
// MXU graph's values) and the stream id optional so per-batch calls
// concatenate.  rec_lens (optional) receives each chunk's framed
// record length for record-oriented callers (multi-host pwrite
// assembly).
int64_t sn_compress_framed_crc(const uint8_t* src, uint64_t n,
                               uint8_t* dst, uint64_t chunk_size,
                               int threads, const uint32_t* crcs,
                               uint64_t* rec_lens, int write_id) {
  return compress_framed_impl(src, n, dst, chunk_size, threads, crcs,
                              rec_lens, write_id);
}

// Header-only scan: total uncompressed length of a framed stream
// (chunk headers carry decoded sizes — the same property the
// zero-collective multi-host decode rides).  Lets callers allocate
// the EXACT destination (e.g. an uninitialized PyBytes the decoder
// fills in place, eliding the wrapper's output copy) instead of
// guess-and-grow.  Validates what the decode scan validates; the
// decode itself re-validates everything it touches.
int64_t sn_framed_uncompressed_length(const uint8_t* src, uint64_t n,
                                      uint64_t* out_len) {
  if (n < 10 || memcmp(src, kStreamId, 10) != 0) return SN_ERR_CORRUPT;
  uint64_t pos = 10, out = 0;
  while (pos < n) {
    if (n - pos < 4) return SN_ERR_CORRUPT;
    uint8_t type = src[pos];
    uint64_t body = src[pos + 1] | ((uint64_t)src[pos + 2] << 8) |
                    ((uint64_t)src[pos + 3] << 16);
    pos += 4;
    if (n - pos < body) return SN_ERR_CORRUPT;
    if (type == 0xff) {
      if (body != 6 || memcmp(src + pos, "sNaPpY", 6) != 0)
        return SN_ERR_CORRUPT;
      pos += body;
      continue;
    }
    if (type == 0xfe || (type >= 0x80 && type <= 0xfd)) {
      pos += body;
      continue;
    }
    if (type >= 0x02 && type <= 0x7f) return SN_ERR_UNSUPPORTED;
    if (body < 4) return SN_ERR_CORRUPT;
    uint64_t payload_off = pos + 4, payload_len = body - 4;
    if (type == 0x00) {
      uint64_t want;
      int hdr = sn_uncompressed_length(src + payload_off, payload_len,
                                       &want);
      if (hdr < 0) return hdr;
      if (want > 65536) return SN_ERR_CORRUPT;
      out += want;
    } else {
      if (payload_len > 65536) return SN_ERR_CORRUPT;
      out += payload_len;
    }
    pos += body;
  }
  *out_len = out;
  return SN_OK;
}

// Two-phase framed decode: scan chunk headers (cheap), then decode
// chunks in parallel.
int64_t sn_decompress_framed(const uint8_t* src, uint64_t n, uint8_t* dst,
                             uint64_t dst_cap, int verify, int threads) {
  if (n < 10 || memcmp(src, kStreamId, 10) != 0) return SN_ERR_CORRUPT;
  struct Chunk {
    uint64_t src_off, src_len, dst_off, dst_len;
    uint8_t type;
    uint32_t crc;
  };
  std::vector<Chunk> chunks;
  uint64_t pos = 10, out = 0;
  while (pos < n) {
    if (n - pos < 4) return SN_ERR_CORRUPT;
    uint8_t type = src[pos];
    uint64_t body = src[pos + 1] | ((uint64_t)src[pos + 2] << 8) |
                    ((uint64_t)src[pos + 3] << 16);
    pos += 4;
    if (n - pos < body) return SN_ERR_CORRUPT;
    if (type == 0xff) {
      if (body != 6 || memcmp(src + pos, "sNaPpY", 6) != 0) return SN_ERR_CORRUPT;
      pos += body;
      continue;
    }
    if (type == 0xfe || (type >= 0x80 && type <= 0xfd)) {
      pos += body;
      continue;
    }
    if (type >= 0x02 && type <= 0x7f) return SN_ERR_UNSUPPORTED;
    if (body < 4) return SN_ERR_CORRUPT;
    uint32_t crc = src[pos] | ((uint32_t)src[pos + 1] << 8) |
                   ((uint32_t)src[pos + 2] << 16) | ((uint32_t)src[pos + 3] << 24);
    uint64_t payload_off = pos + 4, payload_len = body - 4;
    uint64_t dlen;
    if (type == 0x00) {
      uint64_t want;
      int hdr = sn_uncompressed_length(src + payload_off, payload_len, &want);
      if (hdr < 0) return hdr;
      if (want > 65536) return SN_ERR_CORRUPT;
      dlen = want;
    } else {
      if (payload_len > 65536) return SN_ERR_CORRUPT;
      dlen = payload_len;
    }
    if (out + dlen > dst_cap) return SN_ERR_BUFFER;
    chunks.push_back({payload_off, payload_len, out, dlen, type, crc});
    out += dlen;
    pos += body;
  }

  std::atomic<uint64_t> next(0);
  std::atomic<int> err(SN_OK);
  int nt = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  auto worker = [&]() {
    for (;;) {
      uint64_t c = next.fetch_add(1);
      if (c >= chunks.size() || err.load() != SN_OK) break;
      const Chunk& ch = chunks[c];
      if (ch.type == 0x00) {
        int rc = sn_decompress(src + ch.src_off, ch.src_len, dst + ch.dst_off,
                               ch.dst_len);
        if (rc != SN_OK) {
          err.store(rc);
          break;
        }
      } else {
        memcpy(dst + ch.dst_off, src + ch.src_off, ch.dst_len);
      }
      if (verify) {
        uint32_t got = mask_crc(sn_crc32c(dst + ch.dst_off, ch.dst_len, 0));
        if (got != ch.crc) {
          err.store(SN_ERR_CHECKSUM);
          break;
        }
      }
    }
  };
  std::vector<std::thread> ths;
  for (int t = 0; t < nt - 1; t++) ths.emplace_back(worker);
  worker();
  for (auto& t : ths) t.join();
  if (err.load() != SN_OK) return err.load();
  return (int64_t)out;
}

// Wave-group planner for the TPU wave decoder (kernels/decode_wavegroup
// .py): takes sn_parse_tags records and emits packed 8-slot groups.
// Mirrors plan_waves decision-for-decision; the Python planner is the
// readable contract, this is the production-speed path.
//   rec:   int32[n_tags * 4]   (kind, out_len, offset|lit_src, out_start)
//   words: int32[cap_groups * 16]  (slot k: src|is_out<<17, dst|len<<17)
// Returns the group count, or SN_ERR_BUFFER if cap_groups is exceeded.
int64_t sn_plan_waves(const int32_t* rec, uint64_t n_tags, int32_t* words,
                      uint64_t cap_groups) {
  const int kSlots = 8;
  const int64_t kSpanBytes = 1024;
  uint64_t g = 0;       // completed groups
  int cur = 0;          // slots used in the open group
  int64_t d0 = 0;       // open group's output start
  int32_t* w = words;   // open group's 16 words

  auto admit = [&](int64_t src, int64_t dst, int64_t ln, int is_out) -> bool {
    bool need_new = cur == kSlots || (is_out && src + ln > d0) ||
                    (dst + ln - d0 > kSpanBytes);
    if (need_new || cur == 0) {
      if (cur) {
        g++;
        cur = 0;
      }
      if (g >= cap_groups) return false;
      w = words + g * 16;
      for (int i = 0; i < 16; i++) w[i] = 0;
      d0 = dst;
    }
    w[2 * cur] = (int32_t)(src | ((int64_t)is_out << 17));
    w[2 * cur + 1] = (int32_t)(dst | (ln << 17));
    cur++;
    return true;
  };

  // zero the first group eagerly so empty plans read clean
  if (cap_groups) for (int i = 0; i < 16; i++) words[i] = 0;

  for (uint64_t t = 0; t < n_tags; t++) {
    int32_t kind = rec[4 * t + 0];
    int64_t out_len = rec[4 * t + 1];
    int64_t arg = rec[4 * t + 2];
    int64_t out_start = rec[4 * t + 3];
    if (kind == 0) {
      for (int64_t pos = 0; pos < out_len;) {
        int64_t ln = out_len - pos < 128 ? out_len - pos : 128;
        if (!admit(arg + pos, out_start + pos, ln, 0)) return SN_ERR_BUFFER;
        pos += ln;
      }
    } else {
      int64_t off = arg, d = out_start, remaining = out_len, cur_off = off;
      while (remaining > 0) {
        int64_t ln = cur_off < remaining ? cur_off : remaining;
        if (ln > 128) ln = 128;
        if (!admit(d - cur_off, d, ln, 1)) return SN_ERR_BUFFER;
        d += ln;
        remaining -= ln;
        cur_off += ln;
      }
    }
  }
  if (cur) g++;
  return (int64_t)g;
}

// ---------------------------------------------------------------------
// Flat-plan planner + packer for the TPU flat decoder
// (kernels/decode_flat.py): resolves a parsed tag stream into
// dependency-free pieces and packs them into device trips.  Mirrors
// plan_flat + pack_trips decision-for-decision; the Python planner is
// the readable contract (tests enforce bit-identical meta/starts/pat),
// this is the production-speed path.
//   rec:    int32[n_tags * 4]  (kind, out_len, offset|lit_src, out_start)
//   comp:   the compressed element bytes (lit_src indexes into it)
//   rb:     rows of the device B buffer (kernels.decode_flat.rows_b_for)
//   meta:   int32[2*4*trip_cap * 128]   out, zeroed here
//   starts: int32[8 * 128]              out, zeroed here
//   pat:    uint8[kPatRows * 128]       out, zeroed here
// Returns the trip count, or SN_ERR_BUFFER when piece_cap/trip_cap is
// exceeded (caller falls back to the wave engine).

namespace flatplan {
static const int kVec = 128;
static const int kNsub = 4;
static const int kWRows = 128;
static const int kPatRows = 512;  // a full 64 KiB output IMAGE
                                  // (mirror[j] = out[j]; v2.5)
// Direct-gather threshold: below it bytes ride the phase-aligned
// mirror — a direct gather costs its own rotation group under the
// rot-homogeneous packer, worth it only for long literals (many
// same-rot rows).  Mirrors kernels.decode_flat.DIRECT_T.
static int g_direct_t = 4096;  // sn_set_direct_t (experiments/tests)
static const int kPatPeriodMax = 63;
static const int32_t kValid = 1 << 21;

struct Piece {
  int32_t b, dst, len;
};

// Shared packer: stable counting sort on (rot class, rot, dst row,
// source row), greedy subpanel packing (mirrors kernels.decode_flat.
// pack_trips).  Trips are class-homogeneous: rot != 0 pieces pack into
// the leading trips, phase-aligned (rot == 0) pieces into the trailing
// trips, padded to a trip boundary between the classes — the kernel
// runs the trailing trips through a roll-free body.  Subpanels are
// additionally ROT-HOMOGENEOUS: the shared rotation rides the starts
// word and the kernel applies it as ONE dynamic-shift roll (the
// per-piece barrel shifter it replaced was the dominant rot-trip
// latency).  Destinations are FREE-DSTART (probe20): a subpanel
// composes into a dynamic 128-row window at Dq = min(drow) — no dst
// binning — so subpanels pack dense and plans need fewer trips.
// Returns n_trips | (n_aligned_trips << 16), or SN_ERR_BUFFER past
// trip_cap.
static int64_t pack(const std::vector<Piece>& pieces, int64_t rb,
                    int64_t trip_cap, int32_t* meta, int32_t* starts_out) {
  const int64_t Pn = (int64_t)pieces.size();
  memset(starts_out, 0, (size_t)8 * kVec * sizeof(int32_t));
  if (Pn == 0) return 0;
  static thread_local std::vector<int32_t> order, order2, q, rot, dphi, drow;
  order.resize(Pn);
  order2.resize(Pn);
  q.resize(Pn);
  rot.resize(Pn);
  dphi.resize(Pn);
  drow.resize(Pn);
  // pass 1a: stable counting sort on q (q < rb <= 2048)
  int32_t qhist[2049];
  memset(qhist, 0, sizeof(qhist));
  for (int64_t i = 0; i < Pn; i++) {
    const Piece& pc = pieces[i];
    int32_t dp = pc.dst & (kVec - 1);
    int32_t base = pc.b - dp;
    dphi[i] = dp;
    q[i] = base >> 7;
    rot[i] = (kVec - (base & (kVec - 1))) & (kVec - 1);
    drow[i] = pc.dst >> 7;
    qhist[q[i] + 1]++;
  }
  for (int k = 1; k <= 2048; k++) qhist[k] += qhist[k - 1];
  for (int64_t i = 0; i < Pn; i++) order[qhist[q[i]]++] = (int32_t)i;
  // pass 1b: stable counting sort on drow (< 1024) — order (drow, q)
  int32_t dhist[1025];
  memset(dhist, 0, sizeof(dhist));
  for (int64_t i = 0; i < Pn; i++) dhist[drow[i] + 1]++;
  for (int k = 1; k <= 1024; k++) dhist[k] += dhist[k - 1];
  for (int64_t i = 0; i < Pn; i++) {
    int32_t idx = order[i];
    order2[dhist[drow[idx]]++] = idx;
  }
  // pass 2: stable counting sort on rkey (rot, with rot == 0 LAST:
  // the aligned class trails) — final order (cls, rot, drow, q)
  int32_t rhist[130];
  memset(rhist, 0, sizeof(rhist));
  int64_t R = 0;  // index of the first aligned piece in order[]
  for (int64_t i = 0; i < Pn; i++) {
    int32_t rk = rot[i] == 0 ? 128 : rot[i];
    rhist[rk + 1]++;
    if (rot[i] != 0) R++;
  }
  for (int k = 1; k <= 129; k++) rhist[k] += rhist[k - 1];
  for (int64_t i = 0; i < Pn; i++) {
    int32_t idx = order2[i];
    int32_t rk = rot[idx] == 0 ? 128 : rot[idx];
    order[rhist[rk]++] = idx;
  }

  int64_t n_sub = 0, rot_subs = 0, i = 0;
  while (i < Pn) {
    if (i == R && n_sub % kNsub)  // class boundary: pad to a trip
      n_sub += kNsub - n_sub % kNsub;
    int64_t t = n_sub / kNsub, s = n_sub % kNsub;
    if (t >= trip_cap) return SN_ERR_BUFFER;
    if (s == 0)  // zero the whole trip's meta rows as it opens
      memset(meta + 2 * kNsub * t * kVec, 0,
             (size_t)2 * kNsub * kVec * sizeof(int32_t));
    int32_t r0 = rot[order[i]];
    int32_t d0 = drow[order[i]];  // min drow: drow ascends within (cls,rot)
    int32_t qlo = q[order[i]], qhi = qlo;
    int64_t cls_end = i < R ? R : Pn;
    int64_t jcap = i + kVec < cls_end ? i + kVec : cls_end;
    int64_t j = i + 1;
    // greedy extension: rot-homogeneous, src rows fit one W_ROWS
    // window, dst rows fit one 128-row window
    while (j < jcap) {
      int32_t idx = order[j];
      if (rot[idx] != r0 || drow[idx] - d0 > kVec - 1) break;
      int32_t nqlo = qlo < q[idx] ? qlo : q[idx];
      int32_t nqhi = qhi > q[idx] ? qhi : q[idx];
      int32_t Sc = nqlo < (int32_t)(rb - kWRows) ? nqlo
                                                 : (int32_t)(rb - kWRows);
      if (nqhi - Sc > kWRows - 2) break;
      qlo = nqlo;
      qhi = nqhi;
      j++;
    }
    int32_t S = qlo < (int32_t)(rb - kWRows) ? qlo : (int32_t)(rb - kWRows);
    for (int64_t k = i; k < j; k++) {
      int32_t idx = order[k];
      meta[(2 * kNsub * t + s) * kVec + (k - i)] =
          (q[idx] - S) | (rot[idx] << 7);
      meta[(2 * kNsub * t + kNsub + s) * kVec + (k - i)] =
          dphi[idx] | ((pieces[idx].len - 1) << 7) |
          ((drow[idx] - d0) << 14) | kValid;
    }
    starts_out[(t >> 5) * kVec + (t & 31) * 4 + s] =
        S | (d0 << 10) | (r0 << 20);
    n_sub++;
    if (i < R) rot_subs = n_sub;
    i = j;
  }
  int64_t n_trips = (n_sub + kNsub - 1) / kNsub;
  int64_t n_aligned = n_trips - (rot_subs + kNsub - 1) / kNsub;
  return n_trips | (n_aligned << 16);
}
}  // namespace flatplan

// Direct-gather threshold knob (experiments/tests; default 32 mirrors
// kernels.decode_flat.DIRECT_T, 0 sends everything through the mirror).
void sn_set_direct_t(int t) { flatplan::g_direct_t = t; }

namespace flatplan {

// Shared planning context: scratch-decode replay + emission classify.
// Driven tag-by-tag either from parsed records (sn_plan_flat, the
// Python-contract mirror) or inline from the byte stream
// (sn_plan_flat_fused, the production single-pass path) — both produce
// bit-identical plans.  v2.5: the replay target IS the mirror — a full
// output image (dec == pat region, mirror[j] = out[j]) at a
// 128-aligned B base, so run pieces are emitted in place with no
// memcpy, no phase pads, and no capacity failure, all rot 0.
// Wide replay copies: unconditional 32-byte chunks with slop.  Bytes
// written past d+L stay inside the allocation (guarded by the callers'
// dec_cap/comp_len margins) and are either overwritten by a later tag
// or never gathered by any piece — only [0, dst_len) of the image is
// plan-addressed.  Tail tags without margin take the exact-length
// memcpy path.
static inline void replay_fwd(uint8_t* dp, const uint8_t* sp, int64_t L,
                              bool margin) {
  if (margin) {
    int64_t i = 0;
    do {
      memcpy(dp + i, sp + i, 32);
      i += 32;
    } while (i < L);
  } else {
    memcpy(dp, sp, (size_t)L);
  }
}

// One tag's LZ replay into the image at dec[d] (kind 0 = literal from
// comp[arg], kind 1 = copy at distance arg) — shared by the classify
// planner (Ctx::tag) and the plan-free identity stagers.
static inline void replay_tag(uint8_t* dec, int64_t dec_cap,
                              const uint8_t* comp, int64_t comp_len,
                              int64_t kind, int64_t L, int64_t arg,
                              int64_t d) {
  if (kind == 0) {
    replay_fwd(dec + d, comp + arg, L,
               d + L + 32 <= dec_cap && arg + L + 32 <= comp_len);
  } else if (arg >= 32 && arg >= L) {
    // non-overlapping at wide stride: slop reads land on already-
    // written image bytes or in-allocation garbage, both fine
    replay_fwd(dec + d, dec + d - arg, L, d + L + 32 <= dec_cap);
  } else if (d + L + 31 < dec_cap) {
    copy_pattern_slop(dec + d, arg, L);
  } else if (arg >= L) {
    memcpy(dec + d, dec + d - arg, (size_t)L);
  } else {
    // overlapping copy: extend the period-arg pattern by doubling;
    // each memcpy starts at a multiple of arg, so phases line up
    uint8_t* base = dec + d - arg;
    int64_t have = arg, done = 0;
    while (done < L) {
      int64_t t2 = have < L - done ? have : L - done;
      memcpy(dec + d + done, base, (size_t)t2);
      done += t2;
      have += t2;
    }
  }
}

struct Ctx {
  uint8_t* dec;  // the mirror image region (pat buffer / B row)
  const uint8_t* comp;
  int64_t pat_base0;  // B address of dec[0]; 128-aligned
  // Subtracted from payload coordinates when emitting direct-gather
  // pieces: the segmented raw stager stages only the slice
  // [payload_base, slice_hi) into B, so pieces must be slice-relative
  // AT EMISSION TIME — int32 Piece.b cannot hold absolute offsets of
  // multi-GiB raw payloads, and absolute offsets >= 2^27 would collide
  // with the mirror sentinel (round-3 advisor finding).  Zero for the
  // block planners (whole payload staged at B[128..)).
  int64_t payload_base = 0;
  int64_t piece_cap;
  int64_t dec_cap;    // allocation size of dec (slop bound, NOT dst_len)
  int64_t comp_len;   // allocation size of comp (literal slop bound)
  int64_t run_start = -1, run_end = -1;
  std::vector<Piece>* pieces;
  std::vector<int64_t>*lits, *lite, *lita;

  void emit_linear(int64_t b, int64_t dst, int64_t ln) {
    while (ln > 0) {
      int64_t take = kVec - (dst & (kVec - 1));
      if (take > ln) take = ln;
      pieces->push_back({(int32_t)b, (int32_t)dst, (int32_t)take});
      b += take;
      dst += take;
      ln -= take;
    }
  }
  void flush_run() {
    if (run_start < 0) return;
    // image mirror: source address pat_base0 + run_start shares the
    // destination's phase (base aligned), so every piece is rot 0
    emit_linear(pat_base0 + run_start, run_start, run_end - run_start);
    run_start = -1;
  }
  // returns false on budget overflow (caller falls back).  r4 trim:
  // the piece-cap check moved off the per-tag path — pieces only grow
  // at flush/direct boundaries, so the common tag (run extension) is
  // branch-minimal; tags tile the output, so run extension needs no
  // contiguity re-check (the Python contract keeps the readable
  // version of that argument).
  bool tag(int64_t kind, int64_t L, int64_t arg, int64_t d) {
    replay_tag(dec, dec_cap, comp, comp_len, kind, L, arg, d);
    if (__builtin_expect(L >= g_direct_t, 0)) return tag_direct(kind, L, arg, d);
    if (run_start < 0) run_start = d;
    run_end = d + L;
    return true;
  }
  // Rare path: long emissions that may gather straight from the payload.
  // Index only literals that could ever satisfy a direct-copy lookup: a
  // copy with L >= g_direct_t needs a covering literal, itself >=
  // g_direct_t long — short literals can never be consulted.
  bool tag_direct(int64_t kind, int64_t L, int64_t arg, int64_t d) {
    int64_t b_direct = -1;
    if (kind == 0) {
      lits->push_back(d);
      lite->push_back(d + L);
      lita->push_back(arg);
      b_direct = kVec + (arg - payload_base);
    } else {
      int64_t s0 = d - arg;
      int64_t i =
          (int64_t)(std::upper_bound(lits->begin(), lits->end(), s0) -
                    lits->begin()) -
          1;
      if (i >= 0 && (*lite)[i] >= s0 + L)
        b_direct = kVec + ((*lita)[i] - payload_base) + (s0 - (*lits)[i]);
    }
    if (b_direct >= 0) {
      flush_run();
      emit_linear(b_direct, d, L);
      return piece_cap < 0 || (int64_t)pieces->size() <= piece_cap;
    }
    if (run_start < 0) run_start = d;
    run_end = d + L;
    return true;
  }
  bool finish() {
    flush_run();
    return piece_cap < 0 || (int64_t)pieces->size() <= piece_cap;
  }
  // walk_stream sink adapters
  inline bool lit(uint64_t d, uint64_t s, uint64_t L) {
    return tag(0, (int64_t)L, (int64_t)s, (int64_t)d);
  }
  inline bool copy(uint64_t d, uint64_t off, uint64_t L) {
    return tag(1, (int64_t)L, (int64_t)off, (int64_t)d);
  }
};

// thread_local planning scratch shared by both entry points
static thread_local std::vector<Piece> pieces_buf;
static thread_local std::vector<int64_t> lit_s, lit_e, lit_a;

// B address of mirror[0]: first row boundary past the payload
// (mirrors kernels.decode_flat.mirror_base_for)
// Wide replay copies may smear <= 31 bytes of slop past the image end
// (always < dec_cap); zero it after a successful walk so the image is
// deterministic (np-contract parity: everything past dst_len is 0).
static inline void zero_slop_tail(uint8_t* dec, int64_t dst_len,
                                  int64_t cap) {
  int64_t z = cap - dst_len;
  if (z > 32) z = 32;
  if (z > 0) memset(dec + dst_len, 0, (size_t)z);
}

static inline int64_t mirror_base(uint64_t comp_len) {
  return (kVec + (int64_t)comp_len + kVec - 1) & ~(int64_t)(kVec - 1);
}

static Ctx make_ctx(const uint8_t* comp, uint64_t comp_len,
                    int64_t piece_cap, uint8_t* pat_region,
                    int64_t dec_cap) {
  pieces_buf.clear();
  lit_s.clear();
  lit_e.clear();
  lit_a.clear();
  Ctx c;
  c.dec = pat_region;  // replay writes the image in place
  c.comp = comp;
  c.pat_base0 = mirror_base(comp_len);
  c.piece_cap = piece_cap;
  c.dec_cap = dec_cap;
  c.comp_len = (int64_t)comp_len;
  c.pieces = &pieces_buf;
  c.lits = &lit_s;
  c.lite = &lit_e;
  c.lita = &lit_a;
  return c;
}
}  // namespace flatplan

int64_t sn_plan_flat(const int32_t* rec, uint64_t n_tags, const uint8_t* comp,
                     uint64_t comp_len, int64_t rb, int64_t trip_cap,
                     int64_t piece_cap, int32_t* meta, int32_t* starts_out,
                     uint8_t* pat_out) {
  using namespace flatplan;
  if (trip_cap > 256) return SN_ERR_BUFFER;
  // meta rows are zeroed as they are packed (only rows < 2*4*ntrips are
  // ever read by the kernel or the np contract)
  memset(starts_out, 0, (size_t)8 * kVec * sizeof(int32_t));
  memset(pat_out, 0, (size_t)kPatRows * kVec);

  const int64_t out_end =
      n_tags ? (int64_t)rec[4 * (n_tags - 1) + 3] + rec[4 * (n_tags - 1) + 1]
             : 0;
  if (out_end > (int64_t)kPatRows * kVec) return SN_ERR_BUFFER;
  Ctx ctx = make_ctx(comp, comp_len, piece_cap, pat_out,
                     (int64_t)kPatRows * kVec);
  for (uint64_t t = 0; t < n_tags; t++) {
    if (!ctx.tag(rec[4 * t + 0], rec[4 * t + 1], rec[4 * t + 2],
                 rec[4 * t + 3]))
      return SN_ERR_BUFFER;
  }
  if (!ctx.finish()) return SN_ERR_BUFFER;
  zero_slop_tail(pat_out, out_end, (int64_t)kPatRows * kVec);
  std::vector<Piece>& pieces = pieces_buf;

  return pack(pieces, rb, trip_cap, meta, starts_out);
}

// Fused single-pass flat planner: tag parse (validating, mirrors
// sn_parse_tags byte-for-byte), scratch-decode replay, and emission
// classify in ONE walk over the element — no tag-record array is
// written or re-read.  Bit-identical plans to sn_parse_tags +
// sn_plan_flat (tests enforce); ~1.5x the two-pass host rate.
//   src/n: the block element; s: payload offset (preamble skipped);
//   dst_len: decoded size from the preamble.
// Returns pack()'s n_trips|(n_aligned<<16), SN_ERR_CORRUPT on invalid
// streams, or SN_ERR_BUFFER past a cap (caller falls back).
namespace flatplan {
// The fused single-pass walk shared by sn_plan_flat_fused and
// sn_stage_flat_dec: tag parse (validating, mirrors sn_parse_tags
// byte-for-byte), scratch-decode replay, and emission classify in ONE
// walk over the element.  Returns SN_OK / SN_ERR_CORRUPT /
// SN_ERR_BUFFER (cap overflow, caller falls back).
static int fused_walk(const uint8_t* src, uint64_t n, uint64_t s,
                      uint64_t dst_len, Ctx& ctx) {
  return walk_stream(src, n, s, dst_len, ctx);
}
}  // namespace flatplan

int64_t sn_plan_flat_fused(const uint8_t* src, uint64_t n, uint64_t s,
                           uint64_t dst_len, int64_t rb, int64_t trip_cap,
                           int64_t piece_cap, int32_t* meta,
                           int32_t* starts_out, uint8_t* pat_out) {
  using namespace flatplan;
  if (trip_cap > 256) return SN_ERR_BUFFER;
  if ((int64_t)dst_len > (int64_t)kPatRows * kVec) return SN_ERR_BUFFER;
  memset(starts_out, 0, (size_t)8 * kVec * sizeof(int32_t));
  memset(pat_out, 0, (size_t)kPatRows * kVec);

  Ctx ctx = make_ctx(src, n, piece_cap, pat_out,
                     (int64_t)kPatRows * kVec);
  int rc = fused_walk(src, n, s, dst_len, ctx);
  if (rc != SN_OK) return rc;
  zero_slop_tail(pat_out, (int64_t)dst_len, (int64_t)kPatRows * kVec);
  return pack(pieces_buf, rb, trip_cap, meta, starts_out);
}

// Fused STAGE: the whole host half of the flat decode engine in one
// call — parse+validate+replay+classify+pack (identical plans to
// sn_plan_flat_fused; tests enforce) AND assemble the device B row
// in place: element bytes at b_row[128, 128+n), the mirror IMAGE
// written by the replay itself at the 128-aligned mirror_base(n) —
// the replay's one pass over the output bytes is the only byte
// traffic.  No pat buffer, no run memcpy, no 64 KiB memset (the
// payload/mirror gap and the image tail are never gathered by any
// piece: the kernel's one-hot row select + per-piece lane mask only
// ever read bytes the planner wrote).  b_row: uint8[rb*128],
// caller-owned, may be uninitialized (np.empty).
// Returns pack()'s n_trips|(n_aligned<<16), SN_ERR_CORRUPT, or
// SN_ERR_BUFFER past a cap (caller falls back per chunk).
int64_t sn_stage_flat_dec(const uint8_t* src, uint64_t n, uint64_t s,
                          uint64_t dst_len, int64_t rb, int64_t trip_cap,
                          int64_t piece_cap, int32_t* meta,
                          int32_t* starts_out, uint8_t* b_row) {
  using namespace flatplan;
  if (trip_cap > 256) return SN_ERR_BUFFER;
  if ((int64_t)dst_len > (int64_t)kPatRows * kVec) return SN_ERR_BUFFER;
  if (mirror_base(n) + (int64_t)dst_len > rb * (int64_t)kVec)
    return SN_ERR_BUFFER;  // caller's rb cannot hold payload + image
  memset(starts_out, 0, (size_t)8 * kVec * sizeof(int32_t));
  memset(b_row, 0, kVec);  // pad row
  memcpy(b_row + kVec, src, (size_t)n);

  Ctx ctx = make_ctx(src, n, piece_cap, b_row + mirror_base(n),
                     rb * (int64_t)kVec - mirror_base(n));
  int rc = fused_walk(src, n, s, dst_len, ctx);
  if (rc != SN_OK) return rc;
  zero_slop_tail(b_row + mirror_base(n), (int64_t)dst_len,
                 rb * (int64_t)kVec - mirror_base(n));
  return pack(pieces_buf, rb, trip_cap, meta, starts_out);
}

// Flat-plan encode-emission planner: derives dependency-free pieces
// from an already-encoded element (sn_compress output, pre-parsed by
// sn_parse_tags).  Literal DATA gathers from the input block, which
// sits in B rows [1, 513) — out[lit_dst] == input[out_start] by
// construction — while everything else (preamble, tag headers, copy
// tags, and literal runs <= kInlineLit riding inside a segment) is
// appended to a contiguous tag buffer after the input span.  Device
// replay emits the element byte-for-byte, so the ratio bound is
// structural: the emission IS the host encoder's.
//   rec:  int32[n_tags*4] from sn_parse_tags over comp
//   comp: the full element (preamble + body)
//   rb:   B rows (kernels.encode_flat.RB_ENC)
//   meta/starts_out: packed trips (as sn_plan_flat)
//   tagbuf: uint8[tag_cap] out; *tag_used_out = bytes written
// Returns the trip count, or SN_ERR_BUFFER when a cap is exceeded
// (caller picks another engine).
namespace flatplan {
static int64_t plan_enc_impl(const int32_t* rec, uint64_t n_tags,
                             const uint8_t* comp, uint64_t comp_len,
                             int64_t rb, int64_t trip_cap, int64_t piece_cap,
                             int32_t* meta, int32_t* starts_out,
                             uint8_t* tagbuf, uint64_t tag_cap,
                             int64_t* tag_used_out) {
  const int64_t kSrcSpan = 65536;        // input block span in B
  const int64_t kTagBase = kVec + kSrcSpan;
  if (trip_cap > 256) return SN_ERR_BUFFER;

  static thread_local std::vector<Piece> pieces;

  // Inline-literal ladder: literals <= the threshold ride the aligned
  // tag segment (phase-aligned, rot == 0) instead of gathering from
  // the input at their own rotation — under the rot-homogeneous packer
  // each distinct non-inlined literal costs a rotation group, so the
  // first rung inlines aggressively; overflow of the tag buffer
  // retries with the cheaper rungs.
  static const int kInlineLadder[] = {1024, 24, 0};
  for (int inline_lit : kInlineLadder) {
    pieces.clear();
    int64_t tag_used = 0, seg_start = 0;
    bool overflow = false;
    auto emit = [&](int64_t b, int64_t dst, int64_t ln) {
      while (ln > 0) {
        int64_t take = kVec - (dst & (kVec - 1));
        if (take > ln) take = ln;
        pieces.push_back({(int32_t)b, (int32_t)dst, (int32_t)take});
        b += take;
        dst += take;
        ln -= take;
      }
    };
    auto flush_seg = [&](int64_t upto) -> bool {
      int64_t seg = upto - seg_start;
      if (seg <= 0) return true;
      // phase alignment (kTagBase % 128 == 0): aligned segments ride
      // the kernel's roll-free trip class and keep rot-homogeneous
      // subpanels dense — align whenever the tag buffer has room
      int64_t pad = ((seg_start - tag_used) % kVec + kVec) % kVec;
      if (tag_used + pad + seg <= (int64_t)tag_cap) tag_used += pad;
      if (tag_used + seg > (int64_t)tag_cap) return false;
      memcpy(tagbuf + tag_used, comp + seg_start, seg);
      emit(kTagBase + tag_used, seg_start, seg);
      tag_used += seg;
      return true;
    };
    for (uint64_t t = 0; t < n_tags && !overflow; t++) {
      if (rec[4 * t + 0] != 0) continue;  // copies ride in tag segments
      int64_t out_len = rec[4 * t + 1];
      int64_t lit_src = rec[4 * t + 2];
      int64_t out_start = rec[4 * t + 3];
      if (out_len <= inline_lit) continue;  // short literal: stay in segment
      if (!flush_seg(lit_src)) {
        overflow = true;
        break;
      }
      emit(kVec + out_start, lit_src, out_len);
      seg_start = lit_src + out_len;
    }
    if (!overflow && !flush_seg((int64_t)comp_len)) overflow = true;
    if (overflow) {
      if (inline_lit == 0) return SN_ERR_BUFFER;
      continue;  // retry without literal inlining
    }
    if (piece_cap >= 0 && (int64_t)pieces.size() > piece_cap)
      return SN_ERR_BUFFER;
    *tag_used_out = tag_used;
    return pack(pieces, rb, trip_cap, meta, starts_out);
  }
  return SN_ERR_BUFFER;  // unreachable
}
}  // namespace flatplan

int64_t sn_plan_flat_enc(const int32_t* rec, uint64_t n_tags,
                         const uint8_t* comp, uint64_t comp_len,
                         int64_t rb, int64_t trip_cap, int64_t piece_cap,
                         int32_t* meta, int32_t* starts_out,
                         uint8_t* tagbuf, uint64_t tag_cap,
                         int64_t* tag_used_out) {
  return flatplan::plan_enc_impl(rec, n_tags, comp, comp_len, rb, trip_cap,
                                 piece_cap, meta, starts_out, tagbuf,
                                 tag_cap, tag_used_out);
}

// Fused encode STAGE: the whole host half of the flat encode engine in
// one call — compress the block (the reference greedy matcher IS the
// planning pass), parse the emission, plan the device replay, and
// assemble the device B row in place (input block at b_row[128,
// 128+len), tag segments written directly at b_row[128+65536, ...);
// pad gaps and unwritten bytes are never gathered).  The full element
// is always written to elem_out (capacity >= sn_max_compressed_length
// (len) + 8): on SN_ERR_BUFFER the caller uses it as the host-emission
// fallback, otherwise it slices the device emission with *clen_out /
// *hdr_out.  b_row may be uninitialized (np.empty).
// Returns the packed trip count, or SN_ERR_BUFFER past a cap.
int64_t sn_stage_flat_enc(const uint8_t* block, uint64_t len, int64_t rb,
                          int64_t trip_cap, int64_t piece_cap,
                          int32_t* meta, int32_t* starts_out,
                          uint8_t* b_row, uint64_t tag_cap,
                          uint8_t* elem_out, int64_t* clen_out,
                          int64_t* hdr_out) {
  using namespace flatplan;
  const int64_t kSrcSpan = 65536;
  if (len > (uint64_t)kMaxBlockSize) return SN_ERR_BUFFER;
  // r4 parse elision: the encoder streams per-tag records while it
  // emits (RecCursor), replacing the second walk over the emission it
  // just produced (~38 us/block on the corpus); records are
  // bit-identical to sn_parse_tags over the same bytes.
  static thread_local std::vector<int32_t> rec_buf;
  uint64_t max_tags = sn_max_compressed_length(len) / 2 + 2;
  if (rec_buf.size() < 4 * max_tags) rec_buf.resize(4 * max_tags);
  uint8_t* data0 = put_uvarint(elem_out, len);
  RecCursor rc{rec_buf.data(), 0, elem_out, 0};
  uint8_t* dend =
      len ? encode_block_t<true>(data0, block, (int)len, &rc) : data0;
  int64_t clen = dend - elem_out;
  *clen_out = clen;
  *hdr_out = data0 - elem_out;
  int64_t nt = (int64_t)rc.k;
  int64_t tag_used = 0;
  int64_t r = plan_enc_impl(rec_buf.data(), (uint64_t)nt, elem_out,
                            (uint64_t)clen, rb, trip_cap, piece_cap, meta,
                            starts_out, b_row + kVec + kSrcSpan, tag_cap,
                            &tag_used);
  if (r < 0) return r;
  memset(b_row, 0, kVec);  // pad row
  memcpy(b_row + kVec, block, (size_t)len);
  return r;
}

extern "C++" {
// Segmented resume walk over one RAW stream (shared by the classify
// and identity seg stagers): decodes exactly seg_len output bytes,
// resuming and re-saving straddling literal/copy state.  Sink
// supplies the data movement:
//   bool lit(int64_t take, int64_t src_pos, int64_t drel)
//   bool copy(int64_t take, int64_t off, int64_t drel)
// (false aborts with SN_ERR_BUFFER — planner budget overflow).
// Copy offsets past the 64 KiB carry are format-legal but not
// plannable per segment -> SN_ERR_BUFFER (host decoder instead).
//   state: int64[6] = {s, d, lit_src, lit_rem, copy_off, copy_rem}
// On SN_OK the state is advanced past the segment.
template <class S>
static int walk_seg(const uint8_t* src, uint64_t n, uint64_t dst_total,
                    int64_t* state, int64_t seg_len, S& sink) {
  uint64_t s = (uint64_t)state[0];
  int64_t d0 = state[1];
  int64_t lit_src = state[2], lit_rem = state[3];
  int64_t copy_off = state[4], copy_rem = state[5];

  int64_t drel = 0;
  // resume a straddling copy (continues the same period; the replay
  // source reaches into the carry)
  if (copy_rem > 0) {
    int64_t take = copy_rem < seg_len ? copy_rem : seg_len;
    if (!sink.copy(take, copy_off, 0)) return SN_ERR_BUFFER;
    copy_rem -= take;
    drel = take;
  }
  // resume a straddling literal
  if (copy_rem == 0 && lit_rem > 0 && drel < seg_len) {
    int64_t take = lit_rem < seg_len - drel ? lit_rem : seg_len - drel;
    if (!sink.lit(take, lit_src, drel)) return SN_ERR_BUFFER;
    lit_src += take;
    lit_rem -= take;
    drel += take;
  }
  while (drel < seg_len) {
    if (s >= n) return SN_ERR_CORRUPT;
    uint32_t tag = src[s] & 3;
    uint64_t length, offset;
    if (tag == 0) {
      uint32_t x = src[s] >> 2;
      if (x < 60) {
        s += 1;
      } else if (x == 60) {
        s += 2;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 1];
      } else if (x == 61) {
        s += 3;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 2] | ((uint32_t)src[s - 1] << 8);
      } else if (x == 62) {
        s += 4;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 3] | ((uint32_t)src[s - 2] << 8) |
            ((uint32_t)src[s - 1] << 16);
      } else {
        s += 5;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 4] | ((uint32_t)src[s - 3] << 8) |
            ((uint32_t)src[s - 2] << 16) | ((uint32_t)src[s - 1] << 24);
      }
      length = (uint64_t)x + 1;
      if (length > dst_total - (uint64_t)(d0 + drel)) return SN_ERR_CORRUPT;
      if (length > n - s) return SN_ERR_CORRUPT;
      int64_t take = (int64_t)length;
      if (drel + take > seg_len) {
        take = seg_len - drel;
        lit_src = (int64_t)s + take;
        lit_rem = (int64_t)length - take;
      }
      if (!sink.lit(take, (int64_t)s, drel)) return SN_ERR_BUFFER;
      s += length;
      drel += take;
      continue;
    } else if (tag == 1) {
      s += 2;
      if (s > n) return SN_ERR_CORRUPT;
      length = 4 + ((src[s - 2] >> 2) & 7);
      offset = ((uint64_t)(src[s - 2] & 0xe0) << 3) | src[s - 1];
    } else if (tag == 2) {
      s += 3;
      if (s > n) return SN_ERR_CORRUPT;
      length = 1 + (src[s - 3] >> 2);
      offset = src[s - 2] | ((uint64_t)src[s - 1] << 8);
    } else {
      s += 5;
      if (s > n) return SN_ERR_CORRUPT;
      length = 1 + (src[s - 5] >> 2);
      offset = src[s - 4] | ((uint64_t)src[s - 3] << 8) |
               ((uint64_t)src[s - 2] << 16) | ((uint64_t)src[s - 1] << 24);
    }
    if (offset == 0 || (uint64_t)(d0 + drel) < offset) return SN_ERR_CORRUPT;
    // offsets past the 64 KiB carry are format-legal (no real encoder
    // emits them): not plannable per segment — host decoder instead
    if (offset > 65536) return SN_ERR_BUFFER;
    if (length > dst_total - (uint64_t)(d0 + drel)) return SN_ERR_CORRUPT;
    int64_t take = (int64_t)length;
    if (drel + take > seg_len) {
      take = seg_len - drel;
      copy_off = (int64_t)offset;
      copy_rem = (int64_t)length - take;
    }
    if (!sink.copy(take, (int64_t)offset, drel)) return SN_ERR_BUFFER;
    drel += take;
  }
  state[0] = (int64_t)s;
  state[1] = d0 + seg_len;
  state[2] = lit_src;
  state[3] = lit_rem;
  state[4] = copy_off;
  state[5] = copy_rem;
  return SN_OK;
}
}  // extern "C++"

// Classify-planning sink: Ctx plans + replays, slice_hi tracks the
// staged-literal high-water mark for the payload slice.
struct SegClassifySink {
  flatplan::Ctx* ctx;
  int64_t slice_hi;
  inline bool lit(int64_t take, int64_t s, int64_t drel) {
    if (!ctx->tag(0, take, s, drel)) return false;
    if (s + take > slice_hi) slice_hi = s + take;
    return true;
  }
  inline bool copy(int64_t take, int64_t off, int64_t drel) {
    return ctx->tag(1, take, off, drel);
  }
};

// Identity sink (flat v3 raw): pure LZ replay into the segment image,
// no pieces, no payload slice — the staged row IS the output.
struct SegIdSink {
  uint8_t* dec;
  int64_t dec_cap;
  const uint8_t* comp;
  int64_t comp_len;
  inline bool lit(int64_t take, int64_t s, int64_t drel) {
    flatplan::replay_tag(dec, dec_cap, comp, comp_len, 0, take, s, drel);
    return true;
  }
  inline bool copy(int64_t take, int64_t off, int64_t drel) {
    flatplan::replay_tag(dec, dec_cap, comp, comp_len, 1, take, off, drel);
    return true;
  }
};

// Segmented flat STAGE for RAW streams (round 3): one raw snappy
// element decodes as fixed-size output segments, each with its own
// dependency-free flat plan.  Copies reach at most 65535 bytes back,
// so the HOST replay carries a rolling 64 KiB history (img[0..64Ki));
// the DEVICE needs no carry at all — mirror pieces source the
// segment's own image, direct gathers source the staged payload
// slice.  Copies (<= 64 bytes) and literals (any length) may straddle
// a segment boundary; the walk state resumes them.
//   state: int64[6] = {s, d, lit_src, lit_rem, copy_off, copy_rem}
//   img:   host scratch, 65536 + seg_len + 64 bytes; [0,64Ki) = the
//          previous segment's tail (caller slides it), replay writes
//          the segment at img+65536
//   b_row: as sn_stage_flat_dec (payload slice + mirror image)
// Returns pack()'s trips, SN_ERR_CORRUPT, or SN_ERR_BUFFER when the
// payload slice exceeds cmax or a plan cap (caller falls back to the
// host decoder for the stream).
int64_t sn_stage_flat_dec_seg(const uint8_t* src, uint64_t n,
                              uint64_t dst_total, int64_t* state,
                              uint8_t* img, int64_t seg_len, int64_t cmax,
                              int64_t rb, int64_t trip_cap,
                              int64_t piece_cap, int32_t* meta,
                              int32_t* starts_out, uint8_t* b_row) {
  using namespace flatplan;
  if (trip_cap > 256) return SN_ERR_BUFFER;
  if (seg_len > (int64_t)kPatRows * kVec) return SN_ERR_BUFFER;

  // payload slice starts at the resumed literal's data (so its bytes
  // are in-slice for direct gathers) or at the current tag
  int64_t slice_start = state[3] > 0 ? state[2] : state[0];

  uint8_t* dec = img + 65536;
  memset(starts_out, 0, (size_t)8 * kVec * sizeof(int32_t));
  memset(b_row, 0, kVec);  // pad row

  Ctx ctx = make_ctx(src, n, piece_cap, dec, seg_len + 64);
  // the mirror base depends on the slice length, known only after the
  // walk — emit mirror pieces at a sentinel base far above any
  // SLICE-RELATIVE payload address and rebase afterwards.  Payload
  // pieces are emitted slice-relative (ctx.payload_base): they are
  // bounded by the per-segment slice span (<< 2^27), so they can never
  // collide with the sentinel — absolute payload offsets could, once a
  // raw stream's payload crosses 128 MiB (and overflow int32 past
  // 2 GiB).  Regression: tests/test_decode_flat.py
  // test_seg_payload_past_sentinel.
  const int32_t kSegSentinel = 1 << 27;
  ctx.pat_base0 = kSegSentinel;
  ctx.payload_base = slice_start;

  SegClassifySink sink{&ctx, slice_start};
  int rc = walk_seg(src, n, dst_total, state, seg_len, sink);
  if (rc != SN_OK) return rc;
  int64_t slice_hi = sink.slice_hi;  // end of staged literal data
  if (!ctx.finish()) return SN_ERR_BUFFER;

  // only literal DATA is ever gathered from the payload; tags past the
  // last staged literal byte (and straddling literals' unstaged tails)
  // need no staging, so a multi-segment literal never blows the cap
  int64_t slice_len = slice_hi - slice_start;
  if (slice_len > cmax) return SN_ERR_BUFFER;
  int64_t base = mirror_base((uint64_t)slice_len);
  if (base + seg_len + 64 > rb * kVec) return SN_ERR_BUFFER;
  // rebase mirror pieces (sentinel-based); payload gathers are already
  // slice-relative (ctx.payload_base)
  for (auto& p : pieces_buf) {
    if (p.b >= kSegSentinel) p.b = p.b - kSegSentinel + (int32_t)base;
  }
  memcpy(b_row + kVec, src + slice_start, (size_t)slice_len);
  memcpy(b_row + base, dec, (size_t)seg_len);
  zero_slop_tail(b_row + base, seg_len, rb * kVec - base);
  return pack(pieces_buf, rb, trip_cap, meta, starts_out);
}

// Identity seg STAGE (flat v3 raw, decompress-to-device): the resume
// walk decodes the segment straight into the carry image — no pieces,
// no payload slice, no pack — and the staged row IS the output
// segment (b_row[0, seg_len), tail zeroed).  The device graph is a
// pure slice/concat, so this is the staging half of the raw
// decompress-to-device path (H2D carries exactly the decompressed
// bytes).  Same walk validation + >64Ki-offset SN_ERR_BUFFER fallback
// as the classify seg stager; state may be advanced on error returns
// (callers abandon the stream to the host decoder then).
int sn_stage_flat_dec_id_seg(const uint8_t* src, uint64_t n,
                             uint64_t dst_total, int64_t* state,
                             uint8_t* img, int64_t seg_len, int64_t rb,
                             uint8_t* b_row) {
  using namespace flatplan;
  if (seg_len > (int64_t)kPatRows * kVec) return SN_ERR_BUFFER;
  if (rb * (int64_t)kVec < seg_len) return SN_ERR_BUFFER;
  uint8_t* dec = img + 65536;
  SegIdSink sink{dec, seg_len + 64, src, (int64_t)n};
  int rc = walk_seg(src, n, dst_total, state, seg_len, sink);
  if (rc != SN_OK) return rc;
  memcpy(b_row, dec, (size_t)seg_len);
  memset(b_row + seg_len, 0, (size_t)(rb * (int64_t)kVec - seg_len));
  return SN_OK;
}

// Batched flat STAGE entries: one ctypes call stages a whole batch
// with C++ worker threads (atomic row counter).  The Python pool paid
// ~30% GIL-held ctypes marshalling per row and scaled NEGATIVELY past
// one thread; these move the loop below the GIL entirely.
// rc_out[i]: packed trips, or the negative SN_ERR_* for that row
// (BUFFER rows fall back per chunk, CORRUPT rows raise).
// Strides: meta B*(8*trip_cap*128) i32, starts B*(8*128) i32,
// b_rows B*(rb*128) u8.
int64_t sn_stage_flat_dec_batch(
    const uint8_t* elems, const int64_t* offs, const int64_t* lens,
    const int64_t* hdrs, const int64_t* dst_lens, int64_t B, int64_t rb,
    int64_t trip_cap, int64_t piece_cap, int32_t* meta, int32_t* starts,
    uint8_t* b_rows, int64_t* rc_out, int64_t n_threads) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= B) return;
      rc_out[i] = sn_stage_flat_dec(
          elems + offs[i], (uint64_t)lens[i], (uint64_t)hdrs[i],
          (uint64_t)dst_lens[i], rb, trip_cap, piece_cap,
          meta + i * 8 * trip_cap * 128, starts + i * 8 * 128,
          b_rows + i * rb * 128);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  int64_t bad = 0;
  for (int64_t i = 0; i < B; i++)
    if (rc_out[i] < 0) bad++;
  return bad;
}

// Identity STAGE (flat v3, "mirror-only"): the validating walk decodes
// the element DIRECTLY into the staging row — no tag records, no
// classify, no pack, no payload copy.  The device side needs no plan:
// the staged row IS the output image (bytes [0, 64Ki) of a 520-row
// panel; the 8 guard rows absorb the wide-copy slop), so the
// production decode graph is a row slice + the fused MXU CRC.
// Rationale (docs/architecture.md): on the measured corpus the
// classify planner's pieces are rot-0 identity gathers for ~all bytes
// — the gather/compose trips re-assembled bytes the host replay had
// already resolved, while the parse/classify/pack machinery cost ~40%
// of the stage on top of the irreducible LZ walk.  v3 stages at pure
// walk_stream speed and ships 1.016 B per output byte; the general
// trip kernel remains the engine for raw segments, encode emission,
// and FLAT_MODE=classify.
// Returns SN_OK or SN_ERR_CORRUPT (id staging has no caps to overflow;
// SN_ERR_BUFFER only for a caller rb too small for image + slop).
int sn_stage_flat_dec_id(const uint8_t* src, uint64_t n, uint64_t s,
                         uint64_t dst_len, int64_t rb, uint8_t* b_row) {
  using flatplan::kPatRows;
  using flatplan::kVec;
  const int64_t cap = rb * (int64_t)kVec;
  if ((int64_t)dst_len > (int64_t)kPatRows * kVec) return SN_ERR_BUFFER;
  if (cap < (int64_t)kPatRows * kVec + 32) return SN_ERR_BUFFER;
  DecodeSink sink{b_row, src, (uint64_t)cap, n};
  int rc = walk_stream(src, n, s, dst_len, sink);
  if (rc != SN_OK) return rc;
  // zero the tail (short blocks) + slop/guard rows: every byte the
  // device graph slices (rows [0, 512)) is stager-written, and the
  // DMA'd guard rows are deterministic
  memset(b_row + dst_len, 0, (size_t)(cap - (int64_t)dst_len));
  return SN_OK;
}

int64_t sn_stage_flat_dec_id_batch(
    const uint8_t* elems, const int64_t* offs, const int64_t* lens,
    const int64_t* hdrs, const int64_t* dst_lens, int64_t B, int64_t rb,
    uint8_t* b_rows, int64_t* rc_out, int64_t n_threads) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= B) return;
      rc_out[i] = sn_stage_flat_dec_id(
          elems + offs[i], (uint64_t)lens[i], (uint64_t)hdrs[i],
          (uint64_t)dst_lens[i], rb, b_rows + i * rb * 128);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  int64_t bad = 0;
  for (int64_t i = 0; i < B; i++)
    if (rc_out[i] < 0) bad++;
  return bad;
}

// Threaded block compressor (the encode half of flat v3): per-row full
// elements at elem_out + i*elem_cap, clen/hdr per row.  The device's
// encode-side job in v3 is the chunk CRC-32C (MXU GF(2) kernel) over
// the uncompressed blocks — the emission stays host-side, so nothing
// else needs staging.  rc_out rows: SN_OK or the row's SN_ERR_*.
int64_t sn_compress_batch(const uint8_t* blocks, int64_t block_stride,
                          const int64_t* lens, int64_t B,
                          uint8_t* elem_out, int64_t elem_cap,
                          int64_t* clens_out, int64_t* hdrs_out,
                          int64_t* rc_out, int64_t n_threads) {
  std::atomic<int64_t> next(0);
  auto one = [&](int64_t i) {
    uint8_t* dst = elem_out + i * elem_cap;
    if ((int64_t)sn_max_compressed_length((uint64_t)lens[i]) > elem_cap) {
      rc_out[i] = SN_ERR_BUFFER;
      return;
    }
    int64_t clen = sn_compress(blocks + i * block_stride,
                               (uint64_t)lens[i], dst);
    if (clen < 0) {
      rc_out[i] = clen;
      return;
    }
    uint64_t want = 0;
    int hdr = sn_uncompressed_length(dst, (uint64_t)clen, &want);
    if (hdr < 0) {
      rc_out[i] = hdr;
      return;
    }
    clens_out[i] = clen;
    hdrs_out[i] = hdr;
    rc_out[i] = SN_OK;
  };
  // Workers grab PAIRS and run the two-block interleaved matcher
  // (byte-identical emission; study finding: +32% under a GIL-pooled
  // caller and +6% single-thread — the loop is latency-bound and two
  // lanes fill the OoO window — but ~0% under saturated C++ threads
  // on this SMT box; kept because single-thread and partially-loaded
  // callers win and it never loses.  SN_ENC_PAIR=0 disables (A/B
  // seam).  Rows that don't fit the single-fragment fast path (len 0
  // or > 64 KiB, tight caps) take the plain per-row path.
  const bool pair_enabled = sn_pair_enabled();
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(2);
      if (i >= B) return;
      int64_t j = i + 1 < B ? i + 1 : -1;
      bool pair =
          pair_enabled &&
          j >= 0 && lens[i] > 0 && lens[i] <= kMaxBlockSize &&
          lens[j] > 0 && lens[j] <= kMaxBlockSize &&
          (int64_t)sn_max_compressed_length((uint64_t)lens[i]) <=
              elem_cap &&
          (int64_t)sn_max_compressed_length((uint64_t)lens[j]) <=
              elem_cap;
      if (!pair) {
        one(i);
        if (j >= 0) one(j);
        continue;
      }
      uint8_t* di = elem_out + i * elem_cap;
      uint8_t* dj = elem_out + j * elem_cap;
      uint8_t* bi = put_uvarint(di, (uint64_t)lens[i]);
      uint8_t* bj = put_uvarint(dj, (uint64_t)lens[j]);
      uint8_t *ei, *ej;
      encode_pair_interleaved(
          blocks + i * block_stride, (int)lens[i], bi, &ei,
          blocks + j * block_stride, (int)lens[j], bj, &ej);
      clens_out[i] = (int64_t)(ei - di);
      hdrs_out[i] = (int64_t)(bi - di);
      clens_out[j] = (int64_t)(ej - dj);
      hdrs_out[j] = (int64_t)(bj - dj);
      rc_out[i] = SN_OK;
      rc_out[j] = SN_OK;
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  int64_t bad = 0;
  for (int64_t i = 0; i < B; i++)
    if (rc_out[i] < 0) bad++;
  return bad;
}

// Encode twin: blocks at fixed stride block_stride; per-row full
// elements land at elem_out + i*elem_cap with clen/hdr in
// clens_out/hdrs_out (negative rc rows: elem_out holds the host
// emission when rc == SN_ERR_BUFFER, exactly as sn_stage_flat_enc).
int64_t sn_stage_flat_enc_batch(
    const uint8_t* blocks, int64_t block_stride, const int64_t* lens,
    int64_t B, int64_t rb, int64_t trip_cap, int64_t piece_cap,
    int32_t* meta, int32_t* starts, uint8_t* b_rows, uint64_t tag_cap,
    uint8_t* elem_out, int64_t elem_cap, int64_t* clens_out,
    int64_t* hdrs_out, int64_t* rc_out, int64_t n_threads) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= B) return;
      rc_out[i] = sn_stage_flat_enc(
          blocks + i * block_stride, (uint64_t)lens[i], rb, trip_cap,
          piece_cap, meta + i * 8 * trip_cap * 128, starts + i * 8 * 128,
          b_rows + i * rb * 128, tag_cap, elem_out + i * elem_cap,
          clens_out + i, hdrs_out + i);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  int64_t bad = 0;
  for (int64_t i = 0; i < B; i++)
    if (rc_out[i] < 0) bad++;
  return bad;
}

// ---------------------------------------------------------------------
// Emission from device-found candidates (the host half of the
// device-match encode engine, SURVEY.md §7.3.2).  The device matcher
// (kernels/pallas_match.py) delivers, per block position, the nearest
// previous and the first occurrence of the same 4-byte word, packed
// near | first << 16 (0xFFFF = none).  This walk extends both to exact
// byte lengths (cap 64), parses greedy AND lazy, prunes, aligns copy
// starts, and emits the smaller — BYTE-EXACT to the numpy contract
// kernels/match_np.encode_block_sortmatch (tests enforce).

namespace devmatch {

struct El {  // kind 0 = literal(start, len), 1 = copy(offset, len)
  int32_t kind, a, b;
};

static inline int64_t lit_cost(int64_t r) {
  if (r == 0) return 0;
  int64_t n = r - 1;
  return r + (n < 60 ? 1 : n < 256 ? 2 : n < 65536 ? 3 : 4);
}

static inline int64_t copy_cost(int64_t offset, int64_t length) {
  int64_t c = 0;
  while (length >= 68) {
    c += 3;
    length -= 64;
  }
  if (length > 64) {
    c += 3;
    length -= 60;
  }
  return c + ((length >= 12 || offset >= 2048) ? 3 : 2);
}

// exact match length between p and c (c < p), capped at min(64, n - p)
static inline int64_t extend(const uint8_t* b, uint64_t n, int64_t p,
                             int64_t c) {
  int64_t cap = (int64_t)n - p;
  if (cap > 64) cap = 64;
  int64_t m = 0;
  while (m + 8 <= cap) {
    uint64_t x = load64(b + p + m) ^ load64(b + c + m);
    if (x) return m + (__builtin_ctzll(x) >> 3);
    m += 8;
  }
  while (m < cap && b[p + m] == b[c + m]) m++;
  return m;
}

// best candidate at p: longer match wins, ties to the larger (nearer)
// candidate; lengths < 4 are no match (match_np.best_matches contract)
static inline void best_at(const uint8_t* b, uint64_t n,
                           const int32_t* packed, int64_t p, int64_t* cand,
                           int64_t* ml) {
  uint32_t w = (uint32_t)packed[p];
  int64_t near = w & 0xFFFF, first = w >> 16;
  int64_t bc = -1, bl = 0;
  if (near != 0xFFFF && near < p) {
    int64_t l = extend(b, n, p, near);
    if (l >= 4) {
      bc = near;
      bl = l;
    }
  }
  if (first != 0xFFFF && first < p && first != near) {
    int64_t l = extend(b, n, p, first);
    if (l >= 4 && (l > bl || (l == bl && first > bc))) {
      bc = first;
      bl = l;
    }
  }
  *cand = bc;
  *ml = bl;
}

// lazily-memoized best_at: ml 255 = not yet evaluated (real ml <= 64)
static inline int64_t ml_at(const uint8_t* b, uint64_t n,
                            const int32_t* packed, int64_t p, int32_t* cand,
                            uint8_t* ml) {
  if (ml[p] == 255) {
    int64_t c, l;
    best_at(b, n, packed, p, &c, &l);
    cand[p] = (int32_t)c;
    ml[p] = (uint8_t)l;
  }
  return ml[p];
}

static void parse(const uint8_t* b, uint64_t n, const int32_t* packed,
                  int32_t* cand, uint8_t* ml, bool lazy,
                  std::vector<El>& elems) {
  elems.clear();
  int64_t next_emit = 0, p = 1;
  while (p < (int64_t)n) {
    int64_t l = ml_at(b, n, packed, p, cand, ml);
    if (l >= 4) {
      if (lazy && p + 1 < (int64_t)n &&
          ml_at(b, n, packed, p + 1, cand, ml) > l + 1) {
        p += 1;
        continue;
      }
      if (p > next_emit)
        elems.push_back({0, (int32_t)next_emit, (int32_t)(p - next_emit)});
      elems.push_back({1, (int32_t)(p - cand[p]), (int32_t)l});
      p += l;
      next_emit = p;
    } else {
      p += 1;
    }
  }
  if (next_emit < (int64_t)n)
    elems.push_back({0, (int32_t)next_emit, (int32_t)(n - next_emit)});
}

// simultaneous-drop prune, two passes (encode_np._prune semantics)
static void prune(std::vector<El>& elems, std::vector<El>& scratch,
                  std::vector<uint8_t>& elig) {
  for (int pass = 0; pass < 2; pass++) {
    size_t ne = elems.size();
    elig.assign(ne, 0);
    bool any = false;
    for (size_t i = 0; i < ne; i++) {
      const El& e = elems[i];
      if (e.kind != 1) continue;
      bool prev_copy = i > 0 && elems[i - 1].kind == 1;
      bool next_copy = i + 1 < ne && elems[i + 1].kind == 1;
      if (prev_copy || next_copy) continue;
      int64_t a = i > 0 ? elems[i - 1].b : 0;
      int64_t bb = i + 1 < ne ? elems[i + 1].b : 0;
      if (lit_cost(a + e.b + bb) <=
          lit_cost(a) + copy_cost(e.a, e.b) + lit_cost(bb)) {
        elig[i] = 1;
        any = true;
      }
    }
    if (!any) break;
    scratch.clear();
    int64_t pos = 0;
    for (size_t i = 0; i < ne; i++) {
      const El& e = elems[i];
      if (e.kind == 1 && !elig[i]) {
        scratch.push_back(e);
        pos += e.b;
        continue;
      }
      int32_t start = e.kind == 0 ? e.a : (int32_t)pos;
      int32_t length = e.b;
      if (!scratch.empty() && scratch.back().kind == 0)
        scratch.back().b += length;
      else
        scratch.push_back({0, start, length});
      pos += length;
    }
    elems.swap(scratch);
  }
}

// copy-start alignment (encode_np._shift_starts semantics).  Unused by
// sn_emit_from_cands (identity under ML_CAP=64, see above) — kept for
// any future cap change.
__attribute__((unused))
static void shift_starts(std::vector<El>& elems, std::vector<El>& out) {
  out.clear();
  int64_t pos = 0;
  for (const El& e : elems) {
    if (e.kind != 1) {
      out.push_back(e);
      pos += e.b;
      continue;
    }
    int64_t off = e.a, ln = e.b;
    bool have_prev = !out.empty() && out.back().kind == 0;
    int64_t a = have_prev ? out.back().b : 0;
    int64_t best_d = 0, best_cost = lit_cost(a) + copy_cost(off, ln);
    for (int64_t d = 1; d <= 3; d++) {
      if (ln - d < 4) break;
      int64_t cost = lit_cost(a + d) + copy_cost(off, ln - d);
      if (cost < best_cost) {
        best_d = d;
        best_cost = cost;
      }
    }
    if (best_d) {
      if (have_prev)
        out.back().b += (int32_t)best_d;
      else
        out.push_back({0, (int32_t)pos, (int32_t)best_d});
      out.push_back({1, (int32_t)off, (int32_t)(ln - best_d)});
    } else {
      out.push_back(e);
    }
    pos += ln;
  }
}

__attribute__((unused))
static inline int64_t total_size(const std::vector<El>& elems) {
  int64_t sz = 0;
  for (auto& e : elems)
    sz += e.kind ? copy_cost(e.a, e.b) : lit_cost(e.b);
  return sz;
}

}  // namespace devmatch

// Emit one block body (no preamble) from device-found candidates.
// packed: int32[>= n] (pallas_match output, position order).
// Returns bytes written to dst (capacity sn_max_compressed_length(n)),
// never fails on valid candidate images.
int64_t sn_emit_from_cands(const uint8_t* block, uint64_t n,
                           const int32_t* packed, uint8_t* dst) {
  using namespace devmatch;
  if (n == 0) return 0;
  if (n < 4) return (int64_t)(emit_literal(dst, block, (int)n) - dst);
  static thread_local std::vector<El> eg, scratch;
  static thread_local std::vector<uint8_t> elig, ml_buf;
  static thread_local std::vector<int32_t> cand_buf;
  if (ml_buf.size() < n) {
    ml_buf.resize(n);
    cand_buf.resize(n);
  }
  // 255 = "not evaluated"; positions resolve lazily as the parse
  // visits them (best_at is pure).  Greedy parse + prune only: the
  // contract's _shift_starts pass is an identity under ML_CAP=64 (no
  // copy reaches the 65..67 chop window; any start shift costs at
  // least the one tag byte it could save) — the np parity tests keep
  // that argument honest.
  memset(ml_buf.data(), 255, n);
  parse(block, n, packed, cand_buf.data(), ml_buf.data(), false, eg);
  prune(eg, scratch, elig);
  const std::vector<El>& best = eg;
  uint8_t* d = dst;
  for (const El& e : best) {
    if (e.kind == 0)
      d = emit_literal(d, block + e.a, e.b);
    else
      d = emit_copy(d, e.a, e.b);
  }
  return (int64_t)(d - dst);
}

// ---------------------------------------------------------------------
// Encode-rate study (round 5: the per-core ceiling of the matcher,
// VERDICT r4 #3 — same rigor as the r4 decode-walk study).  Variant
// clones of encode_block_t used ONLY by tools/enc_study.py; variant 0
// must stay byte-identical to encode_block (the tool asserts it), and
// any variant that changes table handling must preserve the exact
// probe/store sequence so the emitted bytes cannot drift.
//
//   0  baseline clone (identity anchor + clone-overhead check)
//   1  no-emit: identical control flow + table traffic, dst writes
//      suppressed (isolates emission/memcpy cost)
//   2  epoch-tagged u32 table: no per-block memset (stale entries read
//      as candidate 0, exactly the zeroed-table semantics)
//   9  stats: counts probes / copies / literal+copy bytes / extension
//      steps (separate variant so the hot variants stay clean)

extern "C++" {
namespace encstudy {

template <bool EMIT>
static inline uint8_t* st_emit_literal(uint8_t* dst, const uint8_t* lit,
                                       int len) {
  if (EMIT) return emit_literal(dst, lit, len);
  int n = len - 1;
  return dst + len + (n < 60 ? 1 : n < 256 ? 2 : n < 65536 ? 3 : 4);
}

template <bool EMIT>
static inline uint8_t* st_emit_copy(uint8_t* dst, int offset, int length) {
  if (EMIT) return emit_copy(dst, offset, length);
  while (length >= 68) {
    dst += 3;
    length -= 64;
  }
  if (length > 64) {
    dst += 3;
    length -= 60;
  }
  dst += (length >= 12 || offset >= 2048) ? 3 : 2;
  return dst;
}

// EPOCH=false: thread_local u16 table + per-block memset (baseline).
// EPOCH=true: u32 entries (epoch<<16 | pos); a stale epoch reads as
// candidate 0 — identical decisions, zero per-block clearing.
template <bool EMIT, bool EPOCH, bool STATS>
static uint8_t* encode_block_study(uint8_t* dst, const uint8_t* src,
                                   int len, uint32_t epoch,
                                   uint64_t* st) {
  if (len < kMinNonLiteralBlockSize)
    return st_emit_literal<EMIT>(dst, src, len);

  uint32_t shift = 32 - 8;
  int table_size = 1 << 8;
  while (table_size < (1 << 14) && table_size < len) {
    shift--;
    table_size *= 2;
  }
  static thread_local std::vector<uint16_t> t16;
  static thread_local std::vector<uint32_t> t32;
  uint16_t* tab16 = nullptr;
  uint32_t* tab32 = nullptr;
  const uint32_t etag = epoch << 16;
  if (EPOCH) {
    if (t32.size() < (1u << 14)) t32.assign(1 << 14, 0);
    if (epoch == 0) std::fill(t32.begin(), t32.end(), 0u);  // wrap
    tab32 = t32.data();
  } else {
    if (t16.size() < (1u << 14)) t16.resize(1 << 14);
    tab16 = t16.data();
    memset(tab16, 0, (size_t)table_size * sizeof(uint16_t));
  }
  auto tload = [&](uint32_t h) -> int {
    if (EPOCH) {
      uint32_t e = tab32[h];
      return (e & 0xFFFF0000u) == etag ? (int)(e & 0xFFFFu) : 0;
    }
    return tab16[h];
  };
  auto tstore = [&](uint32_t h, int pos) {
    if (EPOCH)
      tab32[h] = etag | (uint32_t)pos;
    else
      tab16[h] = (uint16_t)pos;
  };

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
      candidate = tload(next_hash);
      tstore(next_hash, s);
      next_hash = hash32(load32(src + next_s), shift);
      if (STATS) st[0]++;
      if (load32(src + s) == load32(src + candidate)) break;
    }
    if (STATS) {
      st[3]++;
      st[4] += (uint64_t)(s - next_emit);
    }
    dst = st_emit_literal<EMIT>(dst, src + next_emit, s - next_emit);

    for (;;) {
      int base = s;
      s += 4;
      int i = candidate + 4;
      while (s + 8 <= len) {
        uint64_t x = load64(src + i) ^ load64(src + s);
        if (STATS) st[5]++;
        if (x) {
          int adv = (int)(__builtin_ctzll(x) >> 3);
          s += adv;
          i += adv;
          goto ext_done;
        }
        s += 8;
        i += 8;
      }
      while (s < len && src[i] == src[s]) {
        i++;
        s++;
        if (STATS) st[5]++;
      }
    ext_done:
      dst = st_emit_copy<EMIT>(dst, base - candidate, s - base);
      if (STATS) {
        st[1]++;
        st[2] += (uint64_t)(s - base);
      }
      next_emit = s;
      if (s >= s_limit) goto emit_remainder;
      uint64_t x = load64(src + s - 1);
      uint32_t prev_hash = hash32((uint32_t)x, shift);
      tstore(prev_hash, s - 1);
      uint32_t curr_hash = hash32((uint32_t)(x >> 8), shift);
      candidate = tload(curr_hash);
      tstore(curr_hash, s);
      if (STATS) st[0]++;
      if ((uint32_t)(x >> 8) != load32(src + candidate)) {
        next_hash = hash32((uint32_t)(x >> 16), shift);
        s++;
        break;
      }
    }
  }
emit_remainder:
  if (next_emit < len) {
    if (STATS) {
      st[3]++;
      st[4] += (uint64_t)(len - next_emit);
    }
    dst = st_emit_literal<EMIT>(dst, src + next_emit, len - next_emit);
  }
  return dst;
}

}  // namespace encstudy
}  // extern "C++"

// Run `variant` over nb blocks (stride-spaced, lens[] bytes each);
// writes each block's compressed length to out_lens, the emission to
// dst rows (dst_stride apart; untouched for no-emit variants), and for
// variant 9 accumulates counters into stats[8].  Returns total
// compressed bytes (computed sizes for no-emit).  GIL-free via ctypes.
int64_t sn_enc_study(const uint8_t* blocks, int64_t nb, int64_t stride,
                     const int64_t* lens, uint8_t* dst,
                     int64_t dst_stride, int64_t* out_lens,
                     int64_t variant, uint64_t* stats) {
  using namespace encstudy;
  int64_t total = 0;
  if (variant == 3) {  // two-block interleaved lanes
    int64_t b = 0;
    for (; b + 1 < nb; b += 2) {
      uint8_t *eA, *eB;
      encode_pair_interleaved(
          blocks + b * stride, (int)lens[b], dst + b * dst_stride, &eA,
          blocks + (b + 1) * stride, (int)lens[b + 1],
          dst + (b + 1) * dst_stride, &eB);
      out_lens[b] = (int64_t)(eA - (dst + b * dst_stride));
      out_lens[b + 1] = (int64_t)(eB - (dst + (b + 1) * dst_stride));
      total += out_lens[b] + out_lens[b + 1];
    }
    if (b < nb) {  // odd tail: baseline
      uint8_t* d = dst + b * dst_stride;
      uint8_t* end = encode_block_study<true, false, false>(
          d, blocks + b * stride, (int)lens[b], 0, nullptr);
      out_lens[b] = (int64_t)(end - d);
      total += out_lens[b];
    }
    return total;
  }
  for (int64_t b = 0; b < nb; b++) {
    const uint8_t* src = blocks + b * stride;
    uint8_t* d = dst + b * dst_stride;
    int len = (int)lens[b];
    uint8_t* end;
    switch (variant) {
      case 1:
        end = encode_block_study<false, false, false>(d, src, len, 0,
                                                      nullptr);
        break;
      case 2:
        end = encode_block_study<true, true, false>(
            d, src, len, (uint32_t)((b & 0xFFFF) ? (b & 0xFFFF) : 0),
            nullptr);
        break;
      case 9:
        end = encode_block_study<true, false, true>(d, src, len, 0,
                                                    (uint64_t*)stats);
        break;
      default:
        end = encode_block_study<true, false, false>(d, src, len, 0,
                                                     nullptr);
    }
    out_lens[b] = (int64_t)(end - d);
    total += out_lens[b];
  }
  return total;
}

}  // extern "C"
