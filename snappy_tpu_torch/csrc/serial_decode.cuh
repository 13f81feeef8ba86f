// seq_decode.cu's serial Snappy walk: a parser warp and a writer warp a
// row, several rows an SM.  decode_par.cu's chunked walks share its
// header decode and chain of tag starts (header_at, follow_chain).
//
// * Parser (warp 0), the kernel's own (its error contract): lane i
//   decodes a header speculatively at s + i of a 32-byte window
//   (header_at), the chain of tag starts is followed from lane 0 with a
//   shuffle a tag (follow_chain), and every start of the chain becomes a
//   record (d, len, source or copy offset, kind), put into a slot of a
//   ring of 4 in shared memory (RingOut).  The scheme is that of RAPIDS
//   cuDF's unsnap.cu and of Sitaridi et al., 2016.
// * Writer (warp 1, writer): takes the slots in order, handed over with
//   named barriers (bar.arrive / bar.sync), and executes the records
//   lane-parallel into a shared image of the output row, a copy as
//   out[d + i] = out[d - off + i % off], which reads only bytes below d
//   that earlier records made final; a __syncwarp() orders one record
//   after the next.  A record is checked before it runs: it writes only
//   inside [0, out_max), reads a copy only from below d and a literal only
//   below the row's valid bytes, and otherwise writes nothing, so a parser
//   may hand over the records of a row with an error.
// * Residency: 64 KiB image + 2 KiB ring a row, three CTAs an SM.  Rows
//   wider than the image (out_max > 65536) take the same code through a
//   pointer into device memory.
// * The end (finish_row): the image is copied out 16 bytes a thread where
//   the row's alignment allows, and the row is zero past the bytes the
//   walk wrote.
//
// A kernel supplies its parser as a Walk type:
//   static __device__ void parse(Shared* sh, const uint8_t* c, int32_t cmax,
//                                int64_t lim, int32_t start, int32_t clen,
//                                int32_t dlen, int lane);
//       (sets sh->d and sh->err)
//   static __device__ int64_t written(const Shared& sh, int32_t out_max);
//       (the bytes of the row to keep)
// and its __global__ function calls decode_row<Walk, kShared>.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace serial {

constexpr int kImage = 65536;  // widest row decoded in shared memory
constexpr int kSlots = 4;      // record ring: one parsed window a slot
constexpr int kThreads = 64;   // warp 0 parses, warp 1 writes
constexpr unsigned kFull = 0xFFFFFFFFu;

// named barriers: FULL(k) = 1 + k, EMPTY(k) = 1 + kSlots + k
constexpr int kBarFull = 1;
constexpr int kBarEmpty = 1 + kSlots;

struct Slot {
  int4 rec[32];  // (d, ln, a, kind): kind 0 literal from c[a], 1 copy of offset a
  int count;
  int last;      // the parser's final slot
  int pad[2];
};

struct Shared {
  Slot ring[kSlots];
  int32_t d;    // the walk's decoded size
  int32_t err;  // the row's code
  int32_t pad[2];
};

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// byte i of the row, zero outside [0, lim)
__device__ __forceinline__ uint32_t byte_at(const uint8_t* c, int64_t lim,
                                            int64_t i) {
  return (i >= 0 && i < lim) ? __ldg(c + i) : 0u;
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

// A header decoded at q: its tag, the length byte's upper bits x, byte 4,
// the header's size, the output length (int32, wrapping as the JAX
// programs' do) and a copy's offset (0 for a literal).
struct Header {
  uint32_t tag, x, b4;
  int32_t hdr, ln, off;
};

__device__ __forceinline__ Header header_at(const uint8_t* c, int64_t lim,
                                            int64_t q) {
  const uint32_t b0 = byte_at(c, lim, q);
  const uint32_t b1 = byte_at(c, lim, q + 1);
  const uint32_t b2 = byte_at(c, lim, q + 2);
  const uint32_t b3 = byte_at(c, lim, q + 3);
  const uint32_t b4 = byte_at(c, lim, q + 4);
  const uint32_t w4 = b1 | (b2 << 8) | (b3 << 16) | (b4 << 24);
  Header h;
  h.tag = b0 & 3u;
  h.x = b0 >> 2;
  h.b4 = b4;
  if (h.tag == 0) {
    h.hdr = h.x < 60 ? 1 : static_cast<int32_t>(h.x) - 58;
    const uint32_t raw = h.x < 60    ? h.x
                         : h.x == 60 ? b1
                         : h.x == 61 ? (w4 & 0xFFFFu)
                         : h.x == 62 ? (w4 & 0xFFFFFFu)
                                     : w4;
    h.ln = static_cast<int32_t>(raw + 1u);
    h.off = 0;
  } else {
    h.hdr = h.tag == 1 ? 2 : (h.tag == 2 ? 3 : 5);
    h.ln = h.tag == 1 ? 4 + static_cast<int32_t>(h.x & 7u)
                      : 1 + static_cast<int32_t>(h.x);
    h.off = h.tag == 1 ? static_cast<int32_t>(((b0 & 0xE0u) << 3) | b1)
                       : (h.tag == 2 ? static_cast<int32_t>(w4 & 0xFFFFu)
                                     : static_cast<int32_t>(w4));
  }
  return h;
}

// The chain of tag starts of the window at s, from lane 0: lane i's
// successor is lane nl (32: past the window), and the chain also stops
// where s + nl reaches `stop`.  ln is each lane's output length, d the
// output offset at lane 0.
struct Chain {
  unsigned starts;  // the start lanes
  int p;            // the last of them
  int32_t my_d;     // the output offset before this lane's tag
  int32_t dd;       // the output offset after the chain
};

__device__ __forceinline__ Chain follow_chain(int nl, int32_t ln, int32_t d,
                                              int64_t s, int64_t stop,
                                              int lane) {
  Chain ch{0u, 0, 0, d};
  while (true) {
    ch.starts |= 1u << ch.p;
    const int np = __shfl_sync(kFull, nl, ch.p);
    const int32_t lnp = __shfl_sync(kFull, ln, ch.p);
    if (lane == ch.p) ch.my_d = ch.dd;
    ch.dd = add32(ch.dd, lnp);
    if (np >= 32 || s + np >= stop) break;
    ch.p = np;
  }
  return ch;
}

// The parser's side of the ring: take a slot (waiting for the writer to
// free it), fill its records, publish it; drain before the row's end.
struct RingOut {
  Shared* sh;
  int slot_i;
  Slot* sl;

  __device__ explicit RingOut(Shared* s) : sh(s), slot_i(0), sl(nullptr) {}

  __device__ int4* acquire() {
    sl = &sh->ring[slot_i % kSlots];
    if (slot_i >= kSlots) bar_sync(kBarEmpty + slot_i % kSlots);
    return sl->rec;
  }

  __device__ void publish(int cnt, bool last, int lane) {
    if (lane == 0) {
      sl->count = cnt;
      sl->last = last;
    }
    __syncwarp();
    __threadfence_block();
    bar_arrive(kBarFull + slot_i % kSlots);
    ++slot_i;
  }

  // take back the writer's arrivals on the slots not yet refilled
  __device__ void drain() {
    for (int j = slot_i - kSlots; j < slot_i - 1; ++j)
      if (j >= 0) bar_sync(kBarEmpty + j % kSlots);
  }
};

// warp 1: execute the records into o in order
__device__ __forceinline__ void writer(Shared* sh, uint8_t* o,
                                       int32_t out_max, const uint8_t* c,
                                       int64_t lim, int lane) {
  int slot_i = 0;
  while (true) {
    const Slot* sl = &sh->ring[slot_i % kSlots];
    bar_sync(kBarFull + slot_i % kSlots);
    const int cnt = sl->count;
    const bool last = sl->last;
    for (int r = 0; r < cnt; ++r) {
      const int4 rec = sl->rec[r];
      const int32_t d = rec.x, ln = rec.y, a = rec.z;
      // a record it cannot run (an error row's) writes nothing; a count
      // of 0, not a `continue` past the __syncwarp, which cost the walk
      // 6-13% on the H100 (bench/walk_profile.py)
      const bool runs = d >= 0 && d < out_max && ln > 0 &&
                        (rec.w == 0 || (a > 0 && a <= d));
      const int32_t n_w = !runs ? 0 : (ln < out_max - d ? ln : out_max - d);
      if (rec.w == 0) {
        for (int32_t i = lane; i < n_w; i += 32)
          o[d + i] = static_cast<uint8_t>(
              byte_at(c, lim, static_cast<int64_t>(a) + i));
      } else if (a >= ln) {
        for (int32_t i = lane; i < n_w; i += 32) o[d + i] = o[d - a + i];
      } else {
        for (int32_t i = lane; i < n_w; i += 32) o[d + i] = o[d - a + i % a];
      }
      __syncwarp();
    }
    if (last) break;
    bar_arrive(kBarEmpty + slot_i % kSlots);
    ++slot_i;
  }
}

// all threads: the image's first `written` bytes to orow (kShared), then
// the row zero from there to out_max
template <bool kShared>
__device__ __forceinline__ void finish_row(uint8_t* image, uint8_t* orow,
                                           const uint8_t* out,
                                           int32_t out_max, int64_t written) {
  const int t = threadIdx.x;
  int64_t z0 = written;
  if (kShared) {
    // image and row share their alignment mod 16 only when out_max is a
    // multiple of 16; copy 16 bytes a thread then, else bytes
    if ((out_max & 15) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      const int64_t n16 = (written + 15) >> 4;  // whole 16-byte words
      const uint4* s4 = reinterpret_cast<const uint4*>(image);
      uint4* d4 = reinterpret_cast<uint4*>(orow);
      // the word holding byte `written` is cut: zero its tail first
      if (written & 15) {
        if (t < 16 - (written & 15)) image[written + t] = 0;
        __syncthreads();
      }
      for (int64_t i = t; i < n16; i += kThreads) d4[i] = s4[i];
      z0 = n16 << 4;
    } else {
      for (int64_t i = t; i < written; i += kThreads) orow[i] = image[i];
    }
  }
  // zero the rest of the row
  int64_t head = (16 - (reinterpret_cast<uintptr_t>(orow + z0) & 15u)) & 15u;
  const int64_t rest = out_max - z0;
  if (head > rest) head = rest;
  if (t < head) orow[z0 + t] = 0;
  uint4* z4 = reinterpret_cast<uint4*>(orow + z0 + head);
  const int64_t n16 = (rest - head) >> 4;
  for (int64_t i = t; i < n16; i += kThreads) z4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = z0 + head + (n16 << 4) + t; i < out_max; i += kThreads)
    orow[i] = 0;
}

// one row, a CTA of kThreads: parse and write, then the row's end
template <class Walk, bool kShared>
__device__ __forceinline__ void decode_row(
    const uint8_t* __restrict__ comp, int64_t pitch, int32_t cmax,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ clens,
    const int32_t* __restrict__ dlens, uint8_t* out, int32_t out_max,
    int32_t* __restrict__ err) {
  extern __shared__ __align__(16) uint8_t smem[];
  Shared* sh = reinterpret_cast<Shared*>(smem);
  uint8_t* image = smem + sizeof(Shared);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.x;
  const int32_t clen = clens[b];
  uint8_t* orow = out + b * static_cast<int64_t>(out_max);
  const int64_t lim = clen < 0 ? 0 : (clen < cmax ? clen : cmax);
  const uint8_t* c = comp + b * pitch;

  if (warp == 0)
    Walk::parse(sh, c, cmax, lim, starts[b], clen, dlens[b], lane);
  else
    writer(sh, kShared ? image : orow, out_max, c, lim, lane);
  __syncthreads();
  finish_row<kShared>(image, orow, out, out_max, Walk::written(*sh, out_max));
  if (threadIdx.x == 0) err[b] = sh->err;
}

inline bool use_shared(int32_t out_max) { return out_max <= kImage; }

inline int smem_bytes(int32_t out_max) {
  return static_cast<int>(sizeof(Shared)) +
         (use_shared(out_max) ? ((out_max + 15) & ~15) : 0);
}

}  // namespace serial
}  // namespace
