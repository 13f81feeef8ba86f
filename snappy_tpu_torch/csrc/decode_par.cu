// Parallel-engine Snappy decode: decode_par.decode_blocks as a serial walk
// per row.  Rows of at most 64 KiB: a parser warp and a writer warp a row,
// several rows an SM.  Wider rows: the walk's records in device memory,
// then their bytes resolved in parallel over the whole card.
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
// exact walk is what the plain version computes.  Each start lane of a
// window tests its tag's three conditions with the output offset the chain
// gives it, and every tag of the chain becomes a record.
//
// Rows of at most 64 KiB (every batch of the runtime): csrc/
// serial_decode.cuh's parser and writer warps, the same scheme as
// seq_decode.cu's, with this file's parser (ParWalk).  A record of an
// error row can hold anything; the writer's checks skip what it cannot
// run.
//
// Wider rows (out_max > 65536: the one-row raw decode of decode_block_par,
// up to a whole stream in one row) would leave one SM to walk and write
// every byte.  Instead the compressed row is cut into chunks of kChunk
// bytes from clamp(start, 0, cmax), and the walk and the writes spread
// over the card (decode_par.walk_records_chunked and resolve_records are
// this on the host):
//   1. decode_par_spec_kernel, a warp a chunk: a walk from the chunk's
//      first byte, marking the tag starts it visits in a bitmap and
//      keeping its exit (the first position at or past the chunk's end);
//   2. decode_par_entry_kernel, a thread a row: where the true walk
//      enters each chunk, stepping tag by tag from the previous chunk's
//      exit until a position the chunk's walk visited (the two walks
//      agree from there on: the chunk's exit) or the chunk's end;
//   3. decode_par_count_kernel, a warp a chunk: the true walk of the
//      chunk, its tags and output bytes counted; decode_par_scan_kernel,
//      a warp a row, gives each chunk its first record and output offset;
//   4. decode_par_emit_kernel, a warp a chunk: the walk again at that
//      offset, its records to device memory and the per-tag conditions
//      ORed into the row; decode_par_finish_kernel the row's code;
//   5. decode_par_pointer_kernel, a thread an output byte below the row's
//      kept size (none in a row with an error): its record by a binary
//      search of the records' output offsets, then its source, -1 - i for
//      byte i of the compressed row (a literal's) or the index of an
//      earlier output byte (a copy's); every other byte -1 - 2^31, which
//      reads as zero;
//   6. decode_par_jump_kernel, ceil(log2(out_max)) rounds of pointer
//      jumping, p = ptr[p] while p names an output byte (a copy chain is
//      shorter than out_max), and decode_par_gather_kernel: each byte from
//      the compressed row.

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
constexpr int kChunk = 4096;       // compressed bytes of a wide row a warp walks
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
// the tags taken and whether any, the nxt of the last
struct Span {
  int64_t s;
  int32_t d;
  unsigned flags;
  int32_t ntags;
  bool reached;
  int32_t last_nxt;
};

__device__ __forceinline__ Span span_at(int64_t s, int32_t d) {
  return Span{s, d, 0u, 0, false, 0};
}

// Where a walk's records and marks go.  acquire() gives the window's
// record slots (null: none kept), mark() is told the window's start lanes,
// publish() closes the window, drain() the walk.
struct RingSink : RingOut {
  __device__ explicit RingSink(Shared* s) : RingOut(s) {}
  __device__ void mark(int64_t, unsigned, int) {}
};

struct RecordOut {  // records to device memory
  int4* rec;
  int32_t n;
  __device__ int4* acquire() { return rec + n; }
  __device__ void mark(int64_t, unsigned, int) {}
  __device__ void publish(int cnt, bool, int) { n += cnt; }
  __device__ void drain() {}
};

struct VisitOut {  // the tag starts, a bit each
  uint32_t* bits;
  __device__ int4* acquire() { return nullptr; }
  __device__ void mark(int64_t s, unsigned starts, int lane) {
    if (lane != 0) return;
    const int sh = static_cast<int>(s & 31);
    atomicOr(&bits[s >> 5], starts << sh);
    if (sh) atomicOr(&bits[(s >> 5) + 1], starts >> (32 - sh));
  }
  __device__ void publish(int, bool, int) {}
  __device__ void drain() {}
};

struct CountOut {  // nothing kept
  __device__ int4* acquire() { return nullptr; }
  __device__ void mark(int64_t, unsigned, int) {}
  __device__ void publish(int, bool, int) {}
  __device__ void drain() {}
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
  while (true) {
    int4* rec = out.acquire();
    int cnt = 0;
    if (w.s < stop) {
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
              ch.my_d, t.h.ln,
              t.h.tag == 0 ? static_cast<int32_t>(q) + t.h.hdr : t.h.off,
              t.h.tag == 0 ? 0 : 1);
      }
      out.mark(w.s, ch.starts, lane);
      cnt = __popc(ch.starts);
      w.ntags += cnt;
      w.reached = true;
      w.last_nxt = __shfl_sync(kFull, t.nxt, ch.p);
      w.d = ch.dd;
      w.s = __shfl_sync(kFull, t.nq, ch.p);
    }
    const bool last = !(w.s < stop);
    out.publish(cnt, last, lane);
    if (last) break;
  }
  out.drain();
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

struct ParWalk {
  // warp 0 of a row of at most kImage bytes: the whole walk through the
  // ring
  static __device__ void parse(Shared* sh, const uint8_t* c, int32_t cmax,
                               int64_t lim, int32_t start, int32_t clen,
                               int32_t dlen, int lane) {
    RingSink ring(sh);
    Span w = span_at(first_pos(start, cmax), 0);
    walk_span(ring, w, c, cmax, lim, lim, clen, dlen, lane);
    if (lane == 0) {
      sh->d = w.d;
      sh->err = row_code(start, clen, dlen, w.d, w.flags, w.reached,
                         w.last_nxt);
    }
  }

  static __device__ int64_t written(const Shared& sh, int32_t out_max) {
    return kept(sh.d, sh.err, out_max);
  }
};

__global__ void __launch_bounds__(kThreads)
decode_par_kernel(const uint8_t* __restrict__ comp, int64_t pitch,
                  int32_t cmax, const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ clens,
                  const int32_t* __restrict__ dlens, uint8_t* out,
                  int32_t out_max, int32_t* __restrict__ err) {
  decode_row<ParWalk, true>(comp, pitch, cmax, starts, clens, dlens, out,
                            out_max, err);
}

// ---------------------------------------------------------------------
// rows wider than kImage

struct Wide {  // the scratch, carved from one buffer
  int4* recs;         // [B, cmax]
  int32_t* ptr;       // [2, B, out_max]
  uint32_t* visited;  // [B, vwords]
  int32_t* chunks;    // [B, n_chunks, kChunkFields]
  int32_t* rows;      // [B, kRowFields]
  int64_t vwords;
  int32_t n_chunks;
};

inline int64_t up16(int64_t bytes) { return (bytes + 15) & ~int64_t{15}; }

// the scratch's layout from `base` (null: sizes only); returns its bytes
inline int64_t carve(void* base, int32_t cmax, int32_t out_max,
                     int32_t n_rows, Wide* w) {
  uint8_t* p = static_cast<uint8_t*>(base);
  int64_t at = 0;
  const auto take = [&](int64_t bytes) {
    uint8_t* q = p ? p + at : nullptr;
    at += up16(bytes);
    return q;
  };
  w->vwords = (static_cast<int64_t>(cmax) + 31) / 32 + 2;
  w->n_chunks = (cmax + kChunk - 1) / kChunk;
  w->recs = reinterpret_cast<int4*>(take(int64_t{16} * n_rows * cmax));
  w->ptr = reinterpret_cast<int32_t*>(
      take(int64_t{8} * n_rows * static_cast<int64_t>(out_max)));
  w->visited = reinterpret_cast<uint32_t*>(take(4 * n_rows * w->vwords));
  w->chunks = reinterpret_cast<int32_t*>(
      take(int64_t{4} * n_rows * w->n_chunks * kChunkFields));
  w->rows = reinterpret_cast<int32_t*>(take(int64_t{4} * n_rows * kRowFields));
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
  const int64_t c0 = r.s0 + static_cast<int64_t>(k) * kChunk;
  if (c0 >= r.lim) return;
  const int64_t stop = c0 + kChunk < r.lim ? c0 + kChunk : r.lim;
  VisitOut out{w.visited + b * w.vwords};
  Span s = span_at(c0, 0);
  walk_span(out, s, r.c, cmax, r.lim, stop, r.clen, r.dlen,
            threadIdx.x & 31);
  if ((threadIdx.x & 31) == 0)
    w.chunks[(b * w.n_chunks + k) * kChunkFields + kExit] =
        static_cast<int32_t>(s.s);
}

__global__ void decode_par_entry_kernel(WIDE_ARGS) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (b >= n_rows) return;
  const RowView r = row_view(b, comp, pitch, cmax, starts, clens, dlens);
  const uint32_t* vis = w.visited + b * w.vwords;
  int32_t* ch = w.chunks + b * w.n_chunks * kChunkFields;
  int64_t e = r.s0;
  for (int32_t k = 0; r.s0 + static_cast<int64_t>(k) * kChunk < r.lim; ++k) {
    const int64_t c0 = r.s0 + static_cast<int64_t>(k) * kChunk;
    const int64_t stop = c0 + kChunk < r.lim ? c0 + kChunk : r.lim;
    ch[k * kChunkFields + kEntry] = static_cast<int32_t>(e);
    while (e < stop) {
      if ((vis[e >> 5] >> (e & 31)) & 1u) {
        e = ch[k * kChunkFields + kExit];
        break;
      }
      e = step_at(r.c, r.lim, e, cmax, r.clen).nq;
    }
  }
}

// the true walk of (row, chunk) from its entry; false where there is none
template <class Out>
__device__ __forceinline__ bool chunk_walk(Out& out, Span& s, WIDE_ARGS,
                                           int64_t b, int32_t k,
                                           int32_t d0) {
  const RowView r = row_view(b, comp, pitch, cmax, starts, clens, dlens);
  const int64_t c0 = r.s0 + static_cast<int64_t>(k) * kChunk;
  if (c0 >= r.lim) return false;
  const int64_t stop = c0 + kChunk < r.lim ? c0 + kChunk : r.lim;
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
      r.lim > r.s0 ? (r.lim - r.s0 + kChunk - 1) / kChunk : 0);
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
  if (r.s0 + static_cast<int64_t>(k) * kChunk >= r.lim) return;
  const int32_t* f = w.chunks + (b * w.n_chunks + k) * kChunkFields;
  RecordOut out{w.recs + b * static_cast<int64_t>(cmax) + f[kBaseTags], 0};
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
  err[b] = row_code(starts[b], clens[b], dlens[b], row[kRowTotal],
                    static_cast<unsigned>(row[kRowFlags]),
                    row[kRowReached] != 0, row[kRowLastNxt]);
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
  const int4* r = w.recs + b * static_cast<int64_t>(cmax);
  int32_t lo = 0, hi = row[kRowRecs] - 1;
  while (lo < hi) {
    const int32_t mid = (lo + hi + 1) >> 1;
    if (__ldg(&r[mid].x) <= i) lo = mid; else hi = mid - 1;
  }
  const int4 rec = r[lo];
  const int32_t rel = i - rec.x;
  w.ptr[idx] = rec.w == 0 ? -1 - (rec.z + rel) : rec.x - rec.z + rel % rec.z;
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

cudaError_t decode_wide(const uint8_t* comp, int64_t pitch, int32_t cmax,
                        const int32_t* starts, const int32_t* clens,
                        const int32_t* dlens, uint8_t* out, int32_t out_max,
                        int32_t* err, int32_t n_rows, void* scratch,
                        cudaStream_t st) {
  Wide w;
  carve(scratch, cmax, out_max, n_rows, &w);
  cudaError_t rc = cudaMemsetAsync(
      w.visited, 0, sizeof(uint32_t) * n_rows * w.vwords, st);
  if (rc != cudaSuccess) return rc;
  const unsigned chunk_grid =
      blocks_for(int64_t{32} * n_rows * w.n_chunks, kWarpThreads);
  const unsigned row_grid = blocks_for(n_rows, 32);
  decode_par_spec_kernel<<<chunk_grid, kWarpThreads, 0, st>>>(
      comp, pitch, cmax, starts, clens, dlens, n_rows, w);
  decode_par_entry_kernel<<<row_grid, 32, 0, st>>>(
      comp, pitch, cmax, starts, clens, dlens, n_rows, w);
  decode_par_count_kernel<<<chunk_grid, kWarpThreads, 0, st>>>(
      comp, pitch, cmax, starts, clens, dlens, n_rows, w);
  decode_par_scan_kernel<<<n_rows, 32, 0, st>>>(
      comp, pitch, cmax, starts, clens, dlens, n_rows, w);
  decode_par_emit_kernel<<<chunk_grid, kWarpThreads, 0, st>>>(
      comp, pitch, cmax, starts, clens, dlens, n_rows, w);
  decode_par_finish_kernel<<<row_grid, 32, 0, st>>>(
      comp, pitch, cmax, starts, clens, dlens, n_rows, w, err);
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

// bytes of scratch decode_par needs for n_rows rows of cmax into out_max
// bytes: none for out_max <= 65536
extern "C" int snc_decode_par_scratch(int32_t cmax, int32_t out_max,
                                      int32_t n_rows, int64_t* bytes) {
  Wide w;
  *bytes = use_shared(out_max) ? 0 : carve(nullptr, cmax, out_max, n_rows, &w);
  return 0;
}

// decode_par.decode_blocks; scratch: snc_decode_par_scratch's bytes,
// 16-byte aligned (null when that is 0)
extern "C" int snc_decode_par(const uint8_t* comp, int64_t pitch,
                              int32_t cmax, const int32_t* starts,
                              const int32_t* clens, const int32_t* dlens,
                              uint8_t* out, int32_t out_max, int32_t* err,
                              int32_t n_rows, void* scratch, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!use_shared(out_max))
    return static_cast<int>(decode_wide(comp, pitch, cmax, starts, clens,
                                        dlens, out, out_max, err, n_rows,
                                        scratch, st));
  const int smem = smem_bytes(out_max);
  const cudaError_t rc = cudaFuncSetAttribute(
      decode_par_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  decode_par_kernel<<<n_rows, kThreads, smem, st>>>(
      comp, pitch, cmax, starts, clens, dlens, out, out_max, err);
  return static_cast<int>(cudaGetLastError());
}
