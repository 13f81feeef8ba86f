// Parallel-engine Snappy decode: decode_par.decode_blocks as a chunked
// parallel parse of every row, then the records executed: rows of at most
// 64 KiB by csrc/pretagged.cu's record executor, wider rows by pointer
// jumping over the whole card.
//
// Replaces snappy_tpu/kernels/decode_jnp.py:decode_blocks (an XLA program:
// a speculative tag parse at every byte, the walk's orbit by pointer
// doubling, a source pointer per output byte resolved by pointer doubling,
// one gather).  The contract is decode_par.decode_blocks_plain, the same
// program in torch ops: out[b, :dst_len] is the decoded row and the rest of
// the row is zero when err[b] == 0.  A row with err[b] != 0 is all zero
// here; the plain version leaves the bytes its gather gives, which no
// caller reads (ROADMAP.md, "Known differences").
//
// The error code is decode_jnp's, not pallas_decode's: the largest of the
// codes whose condition holds anywhere in the row, over EVERY tag the walk
// reaches (1 the walk does not end at comp_len, 2 the decoded size differs
// from dst_len, 3 a tag overruns dst_len, 4 a copy offset is 0 or reaches
// before the row, 5 a literal overruns comp_len), with the JAX program's
// wrapping int32 lengths, offsets and sums.  So the walk never stops at an
// error: it follows the tags to the stream's end, ORs the three per-tag
// conditions and checks the end.
//
// The walk is the JAX program's orbit, taken one tag at a time: it starts
// at clamp(start, 0, cmax), reaches the positions below min(comp_len,
// cmax), and steps to nxt (a poisoned 4-byte literal length, >= 2^30, makes
// nxt cmax + 1) when nxt <= comp_len, else it ends.  Bytes at or past
// comp_len read as zero.  decode_blocks checks that its round counts bound
// nothing (2^tag_rounds tags, 2^ptr_rounds hops of a copy chain), so this
// exact walk is what the plain version computes.  A warp walks a 32-byte
// window at a time: each lane decodes a header at its byte, the chain of
// starts is followed with a shuffle a tag (csrc/serial_decode.cuh), each
// start lane tests its tag's three conditions with the output offset the
// chain gives it, and every tag of the chain becomes a record (kind, len,
// source or offset, d): the record executor's layout.
//
// What bounds it on this card: the walk's dependent steps, not bytes (a
// 64-row batch of 64 KiB rows moves ~6 MB; a text row has ~13,000 tags).
// One serial parser and writer warp a row (the first port) ran 64 chains
// of 13,000 steps on 64 SMs.  Now every row is cut into chunks of
// compressed bytes (kNarrowChunk for rows of at most 64 KiB, kChunk for
// wider ones) from clamp(start, 0, cmax), and the walk and the writes
// spread over the card (decode_par.walk_records_chunked and
// narrow_rows_model / resolve_records are this on the host):
//   1. decode_par_spec_kernel, a warp a chunk: a walk from the chunk's
//      first byte, marking the tag starts it visits in a bitmap and
//      keeping its exit (the first position at or past the chunk's end).
//      Where a tag leaves the chunk more than kLeap bytes before its end
//      (most often a literal's length read in a literal's bytes), the
//      walk's marks so far are cleared and it starts again at the next
//      byte (kRestarts times at most), so the marks stay one walk's and
//      lead to its exit;
//   2. decode_par_entry_kernel, a warp a row: where the true walk enters
//      each chunk, walking from the previous chunk's exit until a tag
//      start the chunk's walk visited (the two walks agree from there on:
//      the chunk's exit) or the chunk's end, which keeps a walk that never
//      meets the chunk's (a stream of 3-byte tags entered off phase)
//      exact.  Where the previous chunk's exit is its speculative walk's
//      and this chunk's walk visited it (the common case, checked for 32
//      chunks at once), that is one shuffle; else 32-byte windows as in
//      the other walks;
//   3. decode_par_count_kernel, a warp a chunk: the true walk of the
//      chunk, its tags and output bytes counted; decode_par_scan_kernel,
//      a warp a row, gives each chunk its first record and output offset;
//   4. decode_par_emit_kernel, a warp a chunk: the walk again at that
//      offset, its records to device memory and the per-tag conditions
//      ORed into the row; decode_par_finish_kernel the row's code, and for
//      the executor the row's record count and length (both 0 in a row
//      with an error, which so comes back zero);
//   5. rows of at most 64 KiB: snc_pretagged (csrc/pretagged.cu, not
//      changed), a CTA a row: the literals by lanes, the copies in groups
//      of 32 that wait on their producers' masks, the row built in shared
//      memory;
//   6. wider rows: decode_par_pointer_kernel, a thread an output byte below
//      the row's kept size (none in a row with an error): its record by a
//      binary search of the records' output offsets, then its source,
//      -1 - i for byte i of the compressed row (a literal's) or the index
//      of an earlier output byte (a copy's); every other byte -1 - 2^31,
//      which reads as zero; then decode_par_jump_kernel, ceil(log2(out_max))
//      rounds of pointer jumping, p = ptr[p] while p names an output byte
//      (a copy chain is shorter than out_max), and decode_par_gather_kernel:
//      each byte from the compressed row.

#include <cstdint>
#include <cuda_runtime.h>

#include "serial_decode.cuh"

namespace {

using namespace serial;

constexpr int kErrNone = 0;
constexpr int kErrOverrunInput = 1;
constexpr int kErrSizeMismatch = 2;
constexpr int kErrOverrunOutput = 3;
constexpr int kErrBadOffset = 4;
constexpr int kErrLiteralOverrun = 5;
constexpr int kChunk = 4096;  // compressed bytes of a wide row a warp walks
constexpr int kNarrowChunk = 512;  // ... of a row of at most 64 KiB
constexpr int kLeap = 64;    // a speculative walk leaving this far early
constexpr int kRestarts = 4;  // ... starts again, this often at most
constexpr int kWarpThreads = 128;  // the per-chunk kernels' CTA: 4 warps
constexpr int kByteThreads = 256;  // the per-byte kernels' CTA
constexpr int32_t kZero = INT32_MIN;  // the pointer of a zero byte

// the per-tag conditions, ORed over the walk
constexpr unsigned kOverOut = 1u;
constexpr unsigned kBadOff = 2u;
constexpr unsigned kLitOver = 4u;

// a chunk's fields, and a row's, in the wide rows' scratch
enum { kExit, kEntry, kTags, kOut, kBaseTags, kBaseOut, kLastNxt, kReached,
       kChunkFields };
enum { kRowRecs, kRowTotal, kRowFlags, kRowReached, kRowLastNxt,
       kRowFields = 8 };

// a tag at q: its header, nxt (poisoned past cmax where a 4-byte literal
// length is 2^30 or more), the literal's end, and the walk's successor
// (nxt where nxt <= clen, else cmax; at least q + 1)
struct Step {
  Header h;
  int32_t nxt, lit_end;
  int64_t nq;
};

__device__ __forceinline__ Step step_at(const uint8_t* c, int64_t lim,
                                        int64_t q, int32_t cmax,
                                        int32_t clen) {
  Step t;
  t.h = header_at(c, lim, q);
  const int32_t q32 = static_cast<int32_t>(q);
  t.nxt = t.h.tag == 0 ? add32(q32 + t.h.hdr, t.h.ln) : q32 + t.h.hdr;
  t.lit_end = t.nxt;
  if (t.h.tag == 0 && t.h.x == 63 && t.h.b4 >= 0x40u) t.nxt = cmax + 1;
  t.nq = t.nxt <= clen ? static_cast<int64_t>(t.nxt) : cmax;
  if (t.nq < q + 1) t.nq = q + 1;
  return t;
}

// a warp's walk: the position, the output offset, the conditions ORed,
// the tags taken and whether any, the nxt of the last and its position
struct Span {
  int64_t s;
  int32_t d;
  unsigned flags;
  int32_t ntags;
  bool reached;
  int32_t last_nxt;
  int64_t last_q;
};

__device__ __forceinline__ Span span_at(int64_t s, int32_t d) {
  return Span{s, d, 0u, 0, false, 0, -1};
}

// Where a walk's records and marks go.  slots() gives the window's record
// slots (null: none kept), mark() is told the window's start lanes, took()
// the window's count.
struct RecordOut {  // records to device memory
  int4* rec;
  int32_t n;
  __device__ int4* slots() { return rec + n; }
  __device__ void mark(int64_t, unsigned, int) {}
  __device__ void took(int cnt) { n += cnt; }
};

struct VisitOut {  // the tag starts, a bit each
  uint32_t* bits;
  __device__ int4* slots() { return nullptr; }
  __device__ void mark(int64_t s, unsigned starts, int lane) {
    if (lane != 0) return;
    const int sh = static_cast<int>(s & 31);
    atomicOr(&bits[s >> 5], starts << sh);
    if (sh) atomicOr(&bits[(s >> 5) + 1], starts >> (32 - sh));
  }
  // the bits of [lo, hi] cleared (one thread, after its own marks)
  __device__ void clear(int64_t lo, int64_t hi) {
    for (int64_t wd = lo >> 5; wd <= hi >> 5; ++wd) {
      uint32_t m = kFull;
      if (wd == lo >> 5) m &= kFull << (lo & 31);
      if (wd == hi >> 5) m &= kFull >> (31 - (hi & 31));
      atomicAnd(&bits[wd], ~m);
    }
  }
  __device__ void took(int) {}
};

struct CountOut {  // nothing kept
  __device__ int4* slots() { return nullptr; }
  __device__ void mark(int64_t, unsigned, int) {}
  __device__ void took(int) {}
};

// a warp: the tags at positions below `stop`, from w.s, a 32-byte window
// at a time; each start lane tests its tag's conditions with the output
// offset the chain gives it and becomes a record
template <class Out>
__device__ __forceinline__ void walk_span(Out& out, Span& w, const uint8_t* c,
                                          int32_t cmax, int64_t lim,
                                          int64_t stop, int32_t clen,
                                          int32_t dlen, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  while (w.s < stop) {
    int4* rec = out.slots();
    if (lane == 0 && w.s + 384 < lim)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(c + w.s + 384));
    // speculative header at q = s + lane, and its lane's successor in
    // this window (32: beyond)
    const int64_t q = w.s + lane;
    const Step t = step_at(c, lim, q, cmax, clen);
    const int nl = t.nq - w.s < 32 ? static_cast<int>(t.nq - w.s) : 32;
    const Chain ch = follow_chain(nl, t.h.ln, w.d, w.s, stop, lane);
    if ((ch.starts >> lane) & 1u) {
      if (t.h.ln > sub32(dlen, ch.my_d)) w.flags |= kOverOut;
      if (t.h.tag != 0 && (t.h.off <= 0 || t.h.off > ch.my_d))
        w.flags |= kBadOff;
      if (t.h.tag == 0 && t.lit_end > clen) w.flags |= kLitOver;
      if (rec)
        rec[__popc(ch.starts & lt)] = make_int4(
            t.h.tag == 0 ? 0 : 1, t.h.ln,
            t.h.tag == 0 ? static_cast<int32_t>(q) + t.h.hdr : t.h.off,
            ch.my_d);
    }
    out.mark(w.s, ch.starts, lane);
    const int cnt = __popc(ch.starts);
    out.took(cnt);
    w.ntags += cnt;
    w.reached = true;
    w.last_nxt = __shfl_sync(kFull, t.nxt, ch.p);
    w.last_q = w.s + ch.p;
    w.d = ch.dd;
    w.s = __shfl_sync(kFull, t.nq, ch.p);
  }
  w.flags = __reduce_or_sync(kFull, w.flags);
}

// the row's code: the last of the conditions that holds
__device__ __forceinline__ int row_code(int32_t start, int32_t clen,
                                        int32_t dlen, int32_t d,
                                        unsigned flags, bool reached,
                                        int32_t last_nxt) {
  const bool ends_ok =
      (reached && last_nxt == clen) || (dlen == 0 && start == clen);
  int e = kErrNone;
  if (!ends_ok) e = kErrOverrunInput;
  if (d != dlen) e = kErrSizeMismatch;
  if (flags & kOverOut) e = kErrOverrunOutput;
  if (flags & kBadOff) e = kErrBadOffset;
  if (flags & kLitOver) e = kErrLiteralOverrun;
  return e;
}

__device__ __forceinline__ int64_t first_pos(int32_t start, int32_t cmax) {
  return start < 0 ? 0 : (start > cmax ? cmax : start);
}

// the bytes of a row to keep: none with an error, else the decoded size
// cut to [0, out_max]
__device__ __forceinline__ int64_t kept(int32_t d, int err, int32_t out_max) {
  return err != kErrNone ? 0 : (d < 0 ? 0 : (d < out_max ? d : out_max));
}

// ---------------------------------------------------------------------
// the chunked parse

struct Wide {  // the scratch, carved from one buffer
  int4* recs;         // [B, t_max]
  int32_t* ptr;       // [2, B, out_max] (rows wider than kImage)
  uint32_t* visited;  // [B, vwords]
  int32_t* chunks;    // [B, n_chunks, kChunkFields]
  int32_t* rows;      // [B, kRowFields]
  int32_t* ntags;     // [B]: the executor's record counts (narrow rows)
  int32_t* dl;        // [B]: ... and row lengths
  int64_t vwords;
  int32_t n_chunks;
  int32_t chunk;      // compressed bytes a warp walks
  int32_t t_max;      // records a row
};

inline int64_t up16(int64_t bytes) { return (bytes + 15) & ~int64_t{15}; }

// the scratch's layout from `base` (null: sizes only); returns its bytes
inline int64_t carve(void* base, int32_t cmax, int32_t out_max,
                     int32_t n_rows, Wide* w) {
  const bool narrow = use_shared(out_max);
  uint8_t* p = static_cast<uint8_t*>(base);
  int64_t at = 0;
  const auto take = [&](int64_t bytes) {
    uint8_t* q = p ? p + at : nullptr;
    at += up16(bytes);
    return q;
  };
  w->chunk = narrow ? kNarrowChunk : kChunk;
  w->vwords = (static_cast<int64_t>(cmax) + 31) / 32 + 2;
  w->n_chunks = (cmax + w->chunk - 1) / w->chunk;
  // every tag the walk takes but its last spans 2 bytes or more
  w->t_max = cmax / 2 + 2;
  w->recs = reinterpret_cast<int4*>(
      take(int64_t{16} * n_rows * w->t_max));
  w->ptr = reinterpret_cast<int32_t*>(
      narrow ? nullptr
             : take(int64_t{8} * n_rows * static_cast<int64_t>(out_max)));
  w->visited = reinterpret_cast<uint32_t*>(take(4 * n_rows * w->vwords));
  w->chunks = reinterpret_cast<int32_t*>(
      take(int64_t{4} * n_rows * w->n_chunks * kChunkFields));
  w->rows = reinterpret_cast<int32_t*>(take(int64_t{4} * n_rows * kRowFields));
  w->ntags = reinterpret_cast<int32_t*>(narrow ? take(4 * n_rows) : nullptr);
  w->dl = reinterpret_cast<int32_t*>(narrow ? take(4 * n_rows) : nullptr);
  return at;
}

struct RowView {  // one row of a wide launch
  const uint8_t* c;
  int32_t start, clen, dlen;
  int64_t s0, lim;
};

__device__ __forceinline__ RowView row_view(
    int64_t b, const uint8_t* comp, int64_t pitch, int32_t cmax,
    const int32_t* starts, const int32_t* clens, const int32_t* dlens) {
  RowView r;
  r.c = comp + b * pitch;
  r.start = starts[b];
  r.clen = clens[b];
  r.dlen = dlens[b];
  r.s0 = first_pos(r.start, cmax);
  r.lim = r.clen < 0 ? 0 : (r.clen < cmax ? r.clen : cmax);
  return r;
}

#define WIDE_ARGS                                                          \
  const uint8_t *__restrict__ comp, int64_t pitch, int32_t cmax,          \
      const int32_t *__restrict__ starts, const int32_t *__restrict__ clens, \
      const int32_t *__restrict__ dlens, int32_t n_rows, Wide w

// the warp of (row, chunk): false where the chunk lies past the row
__device__ __forceinline__ bool chunk_of(int32_t n_rows, const Wide& w,
                                         int64_t* b, int32_t* k) {
  const int64_t g = (static_cast<int64_t>(blockIdx.x) * kWarpThreads +
                     threadIdx.x) >> 5;
  *b = g / w.n_chunks;
  *k = static_cast<int32_t>(g - *b * w.n_chunks);
  return *b < n_rows;
}

__global__ void __launch_bounds__(kWarpThreads)
decode_par_spec_kernel(WIDE_ARGS) {
  int64_t b;
  int32_t k;
  if (!chunk_of(n_rows, w, &b, &k)) return;
  const RowView r = row_view(b, comp, pitch, cmax, starts, clens, dlens);
  const int64_t c0 = r.s0 + static_cast<int64_t>(k) * w.chunk;
  if (c0 >= r.lim) return;
  const int64_t stop = c0 + w.chunk < r.lim ? c0 + w.chunk : r.lim;
  VisitOut out{w.visited + b * w.vwords};
  Span s;
  for (int64_t c = c0, again = kRestarts;; --again) {
    s = span_at(c, 0);
    walk_span(out, s, r.c, cmax, r.lim, stop, r.clen, r.dlen,
              threadIdx.x & 31);
    // a tag that left the chunk more than kLeap bytes before its end: a
    // long literal, where the walk most likely read one in a literal's
    // bytes.  Its states would lead a true walk out of the chunk at once
    // or never, so they are unmarked and the walk starts again after it:
    // the chunk's marks are then one walk's, whose exit is the chunk's
    if (again == 0 || s.last_q + kLeap >= stop) break;
    if ((threadIdx.x & 31) == 0) out.clear(c, s.last_q);
    __syncwarp();
    c = s.last_q + 1;
  }
  if ((threadIdx.x & 31) == 0)
    w.chunks[(b * w.n_chunks + k) * kChunkFields + kExit] =
        static_cast<int32_t>(s.s);
}

// a warp: the true walk from e, 32-byte windows of tag starts, until a
// start the chunk's speculative walk visited (from there the two walks
// are one: the chunk's exit) or the chunk's end
__device__ __forceinline__ int64_t enter_chunk(const RowView& r,
                                               const uint32_t* vis,
                                               int32_t cmax, int64_t e,
                                               int64_t stop, int64_t exit_k,
                                               int lane) {
  while (e < stop) {
    const int64_t q = e + lane;
    const Step t = step_at(r.c, r.lim, q, cmax, r.clen);
    const int nl = t.nq - e < 32 ? static_cast<int>(t.nq - e) : 32;
    const Chain chain = follow_chain(nl, 0, 0, e, stop, lane);
    const bool seen = q < stop && ((vis[q >> 5] >> (q & 31)) & 1u);
    if (__ballot_sync(kFull, seen) & chain.starts) return exit_k;
    e = __shfl_sync(kFull, t.nq, chain.p);
  }
  return e;
}

// a warp a row: where the true walk enters each chunk, 32 chunks at a
// time.  Lane j first checks whether chunk k = base + j's walk visited
// the exit of chunk k - 1's walk (the link: a true walk that leaves chunk
// k - 1 there meets chunk k's walk at once).  Then the chunks in order: a
// shuffle where the true entry is that exit and the link holds, else
// enter_chunk.
__global__ void __launch_bounds__(kWarpThreads)
decode_par_entry_kernel(WIDE_ARGS) {
  const int64_t b = (static_cast<int64_t>(blockIdx.x) * kWarpThreads +
                     threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= n_rows) return;
  const RowView r = row_view(b, comp, pitch, cmax, starts, clens, dlens);
  const uint32_t* vis = w.visited + b * w.vwords;
  int32_t* ch = w.chunks + b * w.n_chunks * kChunkFields;
  const int32_t nck = static_cast<int32_t>(
      r.lim > r.s0 ? (r.lim - r.s0 + w.chunk - 1) / w.chunk : 0);
  int64_t e = r.s0;
  for (int32_t base = 0; base < nck; base += 32) {
    const int32_t k = base + lane;
    int64_t stop = 0, px = -1, link = -1;
    if (k < nck) {
      const int64_t c0 = r.s0 + static_cast<int64_t>(k) * w.chunk;
      stop = c0 + w.chunk < r.lim ? c0 + w.chunk : r.lim;
      px = k == 0 ? r.s0 : ch[(k - 1) * kChunkFields + kExit];
      if (px >= c0 && px < stop && ((vis[px >> 5] >> (px & 31)) & 1u))
        link = ch[k * kChunkFields + kExit];
    }
    const int32_t cnt = nck - base < 32 ? nck - base : 32;
    for (int j = 0; j < cnt; ++j) {
      int32_t* f = ch + (base + j) * kChunkFields;
      const int64_t stop_j = __shfl_sync(kFull, stop, j);
      const int64_t px_j = __shfl_sync(kFull, px, j);
      const int64_t link_j = __shfl_sync(kFull, link, j);
      if (lane == 0) f[kEntry] = static_cast<int32_t>(e);
      if (e >= stop_j) continue;
      if (e == px_j && link_j >= 0) {
        e = link_j;
        continue;
      }
      e = enter_chunk(r, vis, cmax, e, stop_j, f[kExit], lane);
    }
  }
}

// the true walk of (row, chunk) from its entry; false where there is none
template <class Out>
__device__ __forceinline__ bool chunk_walk(Out& out, Span& s, WIDE_ARGS,
                                           int64_t b, int32_t k,
                                           int32_t d0) {
  const RowView r = row_view(b, comp, pitch, cmax, starts, clens, dlens);
  const int64_t c0 = r.s0 + static_cast<int64_t>(k) * w.chunk;
  if (c0 >= r.lim) return false;
  const int64_t stop = c0 + w.chunk < r.lim ? c0 + w.chunk : r.lim;
  s = span_at(w.chunks[(b * w.n_chunks + k) * kChunkFields + kEntry], d0);
  walk_span(out, s, r.c, cmax, r.lim, stop, r.clen, r.dlen, threadIdx.x & 31);
  return true;
}

__global__ void __launch_bounds__(kWarpThreads)
decode_par_count_kernel(WIDE_ARGS) {
  int64_t b;
  int32_t k;
  if (!chunk_of(n_rows, w, &b, &k)) return;
  CountOut out;
  Span s;
  if (!chunk_walk(out, s, comp, pitch, cmax, starts, clens, dlens, n_rows, w,
                  b, k, 0))
    return;
  if ((threadIdx.x & 31) == 0) {
    int32_t* f = w.chunks + (b * w.n_chunks + k) * kChunkFields;
    f[kTags] = s.ntags;
    f[kOut] = s.d;
    f[kLastNxt] = s.last_nxt;
    f[kReached] = s.reached;
  }
}

// a warp a row: each chunk's first record and output offset (wrapping
// int32 sums, as the walk's), the row's totals and its last tag's nxt
__global__ void __launch_bounds__(32) decode_par_scan_kernel(WIDE_ARGS) {
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const RowView r = row_view(b, comp, pitch, cmax, starts, clens, dlens);
  const int32_t nck = static_cast<int32_t>(
      r.lim > r.s0 ? (r.lim - r.s0 + w.chunk - 1) / w.chunk : 0);
  int32_t* ch = w.chunks + b * w.n_chunks * kChunkFields;
  int32_t tags = 0, outb = 0, last_nxt = 0, reached = 0;
  for (int32_t base = 0; base < nck; base += 32) {
    const int32_t k = base + lane;
    int32_t* f = ch + k * kChunkFields;
    const bool valid = k < nck;
    const int32_t t = valid ? f[kTags] : 0;
    const int32_t o = valid ? f[kOut] : 0;
    const bool rch = valid && f[kReached];
    int32_t it = t, io = o;
    for (int sft = 1; sft < 32; sft <<= 1) {
      const int32_t ut = __shfl_up_sync(kFull, it, sft);
      const int32_t uo = __shfl_up_sync(kFull, io, sft);
      if (lane >= sft) {
        it += ut;
        io = add32(io, uo);
      }
    }
    if (valid) {
      f[kBaseTags] = tags + it - t;
      f[kBaseOut] = add32(outb, sub32(io, o));
    }
    const unsigned rm = __ballot_sync(kFull, rch);
    if (rm) {
      const int hi = 31 - __clz(rm);
      last_nxt = __shfl_sync(kFull, valid ? f[kLastNxt] : 0, hi);
      reached = 1;
    }
    tags += __shfl_sync(kFull, it, 31);
    outb = add32(outb, __shfl_sync(kFull, io, 31));
  }
  if (lane == 0) {
    int32_t* row = w.rows + b * kRowFields;
    row[kRowRecs] = tags;
    row[kRowTotal] = outb;
    row[kRowFlags] = 0;
    row[kRowReached] = reached;
    row[kRowLastNxt] = last_nxt;
  }
}

__global__ void __launch_bounds__(kWarpThreads)
decode_par_emit_kernel(WIDE_ARGS) {
  int64_t b;
  int32_t k;
  if (!chunk_of(n_rows, w, &b, &k)) return;
  const RowView r = row_view(b, comp, pitch, cmax, starts, clens, dlens);
  if (r.s0 + static_cast<int64_t>(k) * w.chunk >= r.lim) return;
  const int32_t* f = w.chunks + (b * w.n_chunks + k) * kChunkFields;
  RecordOut out{w.recs + b * static_cast<int64_t>(w.t_max) + f[kBaseTags],
                0};
  Span s;
  if (!chunk_walk(out, s, comp, pitch, cmax, starts, clens, dlens, n_rows, w,
                  b, k, f[kBaseOut]))
    return;
  if ((threadIdx.x & 31) == 0 && s.flags)
    atomicOr(reinterpret_cast<unsigned*>(w.rows + b * kRowFields + kRowFlags),
             s.flags);
}

__global__ void decode_par_finish_kernel(WIDE_ARGS, int32_t* err) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (b >= n_rows) return;
  const int32_t* row = w.rows + b * kRowFields;
  const int e = row_code(starts[b], clens[b], dlens[b], row[kRowTotal],
                         static_cast<unsigned>(row[kRowFlags]),
                         row[kRowReached] != 0, row[kRowLastNxt]);
  err[b] = e;
  if (w.ntags) {  // the executor's rows: none of an error row's records
    w.ntags[b] = e != kErrNone ? 0 : row[kRowRecs];
    w.dl[b] = e != kErrNone ? 0 : dlens[b];
  }
}

__global__ void __launch_bounds__(kByteThreads)
decode_par_pointer_kernel(Wide w, int32_t cmax,
                          const int32_t* __restrict__ err, int32_t out_max,
                          int64_t n_all) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kByteThreads +
                      threadIdx.x;
  if (idx >= n_all) return;
  const int64_t b = idx / out_max;
  const int32_t i = static_cast<int32_t>(idx - b * out_max);
  const int32_t* row = w.rows + b * kRowFields;
  if (i >= kept(row[kRowTotal], err[b], out_max)) {
    w.ptr[idx] = kZero;
    return;
  }
  // a good row's records cover [0, total) in order: the last with d <= i
  const int4* r = w.recs + b * static_cast<int64_t>(w.t_max);
  int32_t lo = 0, hi = row[kRowRecs] - 1;
  while (lo < hi) {
    const int32_t mid = (lo + hi + 1) >> 1;
    if (__ldg(&r[mid].w) <= i) lo = mid; else hi = mid - 1;
  }
  const int4 rec = r[lo];
  const int32_t rel = i - rec.w;
  w.ptr[idx] = rec.x == 0 ? -1 - (rec.z + rel) : rec.w - rec.z + rel % rec.z;
}

__global__ void __launch_bounds__(kByteThreads)
decode_par_jump_kernel(const int32_t* __restrict__ src,
                       int32_t* __restrict__ dst, int32_t out_max,
                       int64_t n_all) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kByteThreads +
                      threadIdx.x;
  if (idx >= n_all) return;
  const int32_t p = src[idx];
  dst[idx] = p >= 0 ? src[idx - idx % out_max + p] : p;
}

__global__ void __launch_bounds__(kByteThreads)
decode_par_gather_kernel(const uint8_t* __restrict__ comp, int64_t pitch,
                         int32_t cmax, const int32_t* __restrict__ clens,
                         const int32_t* __restrict__ ptr, int32_t out_max,
                         int64_t n_all, uint8_t* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kByteThreads +
                      threadIdx.x;
  if (idx >= n_all) return;
  const int64_t b = idx / out_max;
  const int32_t p = ptr[idx];
  const int32_t clen = clens[b];
  out[idx] = p < 0 ? static_cast<uint8_t>(byte_at(
                         comp + b * pitch,
                         clen < 0 ? 0 : (clen < cmax ? clen : cmax),
                         -1 - static_cast<int64_t>(p)))
                   : 0;
}

unsigned blocks_for(int64_t threads, int per_block) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

// a warp a row
unsigned chunk_grid_rows(int32_t n_rows) {
  return blocks_for(int64_t{32} * n_rows, kWarpThreads);
}

// steps 1-4 of either width: the chunked parse, the records and codes
cudaError_t parse_rows(const uint8_t* comp, int64_t pitch, int32_t cmax,
                       const int32_t* starts, const int32_t* clens,
                       const int32_t* dlens, int32_t* err, int32_t n_rows,
                       const Wide& w, cudaStream_t st) {
  const cudaError_t rc = cudaMemsetAsync(
      w.visited, 0, sizeof(uint32_t) * n_rows * w.vwords, st);
  if (rc != cudaSuccess) return rc;
  const unsigned chunk_grid =
      blocks_for(int64_t{32} * n_rows * w.n_chunks, kWarpThreads);
  const unsigned row_grid = blocks_for(n_rows, 32);
  decode_par_spec_kernel<<<chunk_grid, kWarpThreads, 0, st>>>(
      comp, pitch, cmax, starts, clens, dlens, n_rows, w);
  decode_par_entry_kernel<<<chunk_grid_rows(n_rows), kWarpThreads, 0, st>>>(
      comp, pitch, cmax, starts, clens, dlens, n_rows, w);
  decode_par_count_kernel<<<chunk_grid, kWarpThreads, 0, st>>>(
      comp, pitch, cmax, starts, clens, dlens, n_rows, w);
  decode_par_scan_kernel<<<n_rows, 32, 0, st>>>(
      comp, pitch, cmax, starts, clens, dlens, n_rows, w);
  decode_par_emit_kernel<<<chunk_grid, kWarpThreads, 0, st>>>(
      comp, pitch, cmax, starts, clens, dlens, n_rows, w);
  decode_par_finish_kernel<<<row_grid, 32, 0, st>>>(
      comp, pitch, cmax, starts, clens, dlens, n_rows, w, err);
  return cudaGetLastError();
}

// step 6: rows wider than kImage
cudaError_t resolve_wide(const uint8_t* comp, int64_t pitch, int32_t cmax,
                         const int32_t* clens, uint8_t* out, int32_t out_max,
                         const int32_t* err, int32_t n_rows, const Wide& w,
                         cudaStream_t st) {
  const int64_t n_all = static_cast<int64_t>(n_rows) * out_max;
  const unsigned grid = blocks_for(n_all, kByteThreads);
  decode_par_pointer_kernel<<<grid, kByteThreads, 0, st>>>(w, cmax, err,
                                                           out_max, n_all);
  int32_t* a = w.ptr;
  int32_t* b = w.ptr + n_all;
  for (int64_t reach = 1; reach < out_max; reach <<= 1) {
    decode_par_jump_kernel<<<grid, kByteThreads, 0, st>>>(a, b, out_max,
                                                         n_all);
    int32_t* t = a;
    a = b;
    b = t;
  }
  decode_par_gather_kernel<<<grid, kByteThreads, 0, st>>>(
      comp, pitch, cmax, clens, a, out_max, n_all, out);
  return cudaGetLastError();
}

}  // namespace

// csrc/pretagged.cu's record executor (step 5)
extern "C" int snc_pretagged(const uint8_t* comp, int64_t pitch,
                             int32_t cmax, const int32_t* recs, int32_t t_max,
                             const int32_t* n_tags, const int32_t* dlens,
                             uint8_t* out, int32_t out_max, int32_t n_rows,
                             void* stream);

// bytes of scratch decode_par needs for n_rows rows of cmax into out_max
// bytes
extern "C" int snc_decode_par_scratch(int32_t cmax, int32_t out_max,
                                      int32_t n_rows, int64_t* bytes) {
  Wide w;
  *bytes = carve(nullptr, cmax, out_max, n_rows, &w);
  return 0;
}

// decode_par.decode_blocks; scratch: snc_decode_par_scratch's bytes,
// 16-byte aligned
extern "C" int snc_decode_par(const uint8_t* comp, int64_t pitch,
                              int32_t cmax, const int32_t* starts,
                              const int32_t* clens, const int32_t* dlens,
                              uint8_t* out, int32_t out_max, int32_t* err,
                              int32_t n_rows, void* scratch, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Wide w;
  carve(scratch, cmax, out_max, n_rows, &w);
  const cudaError_t rc =
      parse_rows(comp, pitch, cmax, starts, clens, dlens, err, n_rows, w, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (!use_shared(out_max))
    return static_cast<int>(resolve_wide(comp, pitch, cmax, clens, out,
                                         out_max, err, n_rows, w, st));
  return snc_pretagged(comp, pitch, cmax,
                       reinterpret_cast<const int32_t*>(w.recs), w.t_max,
                       w.ntags, w.dl, out, out_max, n_rows, stream);
}
