// Sequential per-block Snappy decode: a parser warp and a writer warp per
// block, several blocks per SM.
//
// Replaces snappy_tpu/kernels/pallas_decode.py:_kernel (and its per-element
// body _step_one), the Pallas decoder that interleaves 8 blocks per grid
// step and moves bytes as rolled 128-byte windows of int32 rows.  Each
// block is an independent serial decoder.  The contract is
// decode_seq.decode_blocks_seq_plain: out[b, :d] are the bytes decoded
// before the first failing element, the rest of the row is zero, err[b] is
// the JAX kernel's code.
//
// What bounds it on this card: the serial chain of each block, not bytes
// (a 64 KiB row moves ~100 KB in ~10^4 elements).  The card keeps
// sm_count x 3 of these chains in flight; the design shortens each chain
// and splits it in two that overlap:
//
// * Parser (warp 0).  It parses 32 bytes of the element stream at a time:
//   lane i decodes a header speculatively at s + i, and the chain of
//   element starts is followed from lane 0 with one shuffle per element
//   (the scheme of RAPIDS cuDF's unsnap.cu and of Sitaridi et al., 2016).
//   Each start lane then checks its element in parallel with _step_one's
//   wrapping int32 tests (they need only s, d, clen and dlen); the first
//   failing lane (ballot + ffs) freezes the cursors and sets err.  The
//   compressed bytes are read from device memory through L1, one line
//   prefetched ahead, so no row is staged in shared memory.
// * Writer (warp 1).  The parser passes the valid elements as records
//   (d, len, source offset or copy offset, kind) through a ring of 4 slots
//   of one window each, handed over with named barriers (bar.arrive /
//   bar.sync).  The writer executes them in order into a 64 KiB shared
//   image of the output row: literals lane-parallel from device memory,
//   copies lane-parallel as out[d + i] = out[d - off + i % off], which
//   reads only bytes below d that earlier records made final; a
//   __syncwarp() orders one record after the next.
// * Residency.  64 KiB image + 2 KiB ring a block: three CTAs fit an SM.
//   The runtime launches at least sm_count x snc_seq_decode_blocks_per_sm
//   rows (kernels/decode_seq.resident_rows), so every SM holds three.
//
// Rows wider than the image (out_max > 65536) are decoded in device
// memory instead (the same code through a global pointer).  Bytes the walk
// reads past the row (a header at the row end) read as zero; they cannot
// change the result, since an element whose header passes its payload end
// fails on `hdr > clen - s` alone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kErrNone = 0;
constexpr int kErrLiteral = 1;
constexpr int kErrCopy = 2;
constexpr int kErrDstShort = 3;
constexpr int kErrSrcTrail = 4;
constexpr int kImage = 65536;  // widest row decoded in shared memory
constexpr int kSlots = 4;      // record ring: one parsed window a slot
constexpr int kThreads = 64;   // warp 0 parses, warp 1 writes
constexpr unsigned kFull = 0xFFFFFFFFu;

// named barriers: FULL(k) = 1 + k, EMPTY(k) = 1 + kSlots + k
constexpr int kBarFull = 1;
constexpr int kBarEmpty = 1 + kSlots;

struct Slot {
  int4 rec[32];  // (d, ln, a, kind): kind 0 literal from comp[a], 1 copy of offset a
  int count;
  int last;      // the parser's final slot
  int pad[2];
};

struct Shared {
  Slot ring[kSlots];
  int32_t d;
  int32_t err;
  int32_t pad[2];
};

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

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

// warp 0: parse windows into records; returns through sh->d / sh->err
__device__ void parser(Shared* sh, const uint8_t* c, int64_t lim, int32_t s,
                       int32_t clen, int32_t dlen, int lane) {
  int32_t d = 0;
  int e = kErrNone;
  int slot_i = 0;
  const unsigned lt = (1u << lane) - 1u;
  while (true) {
    Slot* sl = &sh->ring[slot_i % kSlots];
    if (slot_i >= kSlots) bar_sync(kBarEmpty + slot_i % kSlots);
    int cnt = 0;
    if (s < clen) {
      if (lane == 0 && static_cast<int64_t>(s) + 384 < lim)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(c + s + 384));
      // speculative header at q = s + lane
      const int64_t q = static_cast<int64_t>(s) + lane;
      const uint32_t b0 = byte_at(c, lim, q);
      const uint32_t b1 = byte_at(c, lim, q + 1);
      const uint32_t b2 = byte_at(c, lim, q + 2);
      const uint32_t b3 = byte_at(c, lim, q + 3);
      const uint32_t b4 = byte_at(c, lim, q + 4);
      const uint32_t tag = b0 & 3u;
      const uint32_t x = b0 >> 2;
      const uint32_t w4 = b1 | (b2 << 8) | (b3 << 16) | (b4 << 24);
      int32_t hdr, ln, off = 0;
      int64_t adv;  // bytes of the element in the stream
      if (tag == 0) {
        hdr = x < 60 ? 1 : static_cast<int32_t>(x) - 58;
        const uint32_t raw = x < 60    ? x
                             : x == 60 ? b1
                             : x == 61 ? (w4 & 0xFFFFu)
                             : x == 62 ? (w4 & 0xFFFFFFu)
                                       : w4;
        ln = static_cast<int32_t>(raw + 1u);
        adv = static_cast<int64_t>(hdr) + ln;
      } else {
        hdr = tag == 1 ? 2 : (tag == 2 ? 3 : 5);
        ln = tag == 1 ? 4 + static_cast<int32_t>(x & 7u)
                      : 1 + static_cast<int32_t>(x);
        off = tag == 1 ? static_cast<int32_t>(((b0 & 0xE0u) << 3) | b1)
                       : (tag == 2 ? static_cast<int32_t>(w4 & 0xFFFFu)
                                   : static_cast<int32_t>(w4));
        adv = hdr;
      }
      const int nxt = (adv >= 1 && lane + adv < 32)
                          ? lane + static_cast<int>(adv) : 32;
      // the chain of starts from lane 0, and d before each of them
      unsigned starts = 0;
      int p = 0;
      int32_t dd = d;
      int32_t my_d = 0;
      while (true) {
        starts |= 1u << p;
        const int np = __shfl_sync(kFull, nxt, p);
        const int32_t lnp = __shfl_sync(kFull, ln, p);
        if (lane == p) my_d = dd;
        dd = static_cast<int32_t>(static_cast<uint32_t>(dd) +
                                  static_cast<uint32_t>(lnp));
        if (np >= 32 || static_cast<int64_t>(s) + np >= clen) break;
        p = np;
      }
      // _step_one's checks, one start lane each
      const bool start = (starts >> lane) & 1u;
      const int32_t sq = static_cast<int32_t>(q);
      bool bad;
      if (tag == 0) {
        const int32_t room = sub32(clen, sq);
        bad = hdr > room || ln <= 0 || ln > sub32(dlen, my_d) ||
              ln > sub32(room, hdr);
      } else {
        bad = hdr > sub32(clen, sq) || ln <= 0 || ln > sub32(dlen, my_d) ||
              off <= 0 || off > my_d;
      }
      const unsigned badm = __ballot_sync(kFull, start && bad);
      unsigned okm = starts;
      if (badm) {
        const int f = __ffs(badm) - 1;
        okm = starts & ((1u << f) - 1u);
        e = __shfl_sync(kFull, tag, f) == 0 ? kErrLiteral : kErrCopy;
        d = __shfl_sync(kFull, my_d, f);
        s += f;
      } else {
        const int64_t adv_p = __shfl_sync(kFull, adv, p);
        s = static_cast<int32_t>(static_cast<int64_t>(s) + p + adv_p);
        d = dd;
      }
      if ((okm >> lane) & 1u)
        sl->rec[__popc(okm & lt)] = make_int4(
            my_d, ln, tag == 0 ? sq + hdr : off, tag == 0 ? 0 : 1);
      cnt = __popc(okm);
    }
    const bool last = !(s < clen && e == kErrNone);
    if (lane == 0) {
      sl->count = cnt;
      sl->last = last;
    }
    __syncwarp();
    __threadfence_block();
    bar_arrive(kBarFull + slot_i % kSlots);
    ++slot_i;
    if (last) break;
  }
  // take back the writer's arrivals on the slots not yet refilled
  for (int j = slot_i - kSlots; j < slot_i - 1; ++j)
    if (j >= 0) bar_sync(kBarEmpty + j % kSlots);
  if (e == kErrNone && d != dlen) e = kErrDstShort;
  if (e == kErrNone && s != clen) e = kErrSrcTrail;
  if (lane == 0) {
    sh->d = d;
    sh->err = e;
  }
}

// warp 1: execute the records into o in order
__device__ void writer(Shared* sh, uint8_t* o, int32_t out_max,
                       const uint8_t* c, int64_t lim, int lane) {
  int slot_i = 0;
  while (true) {
    const Slot* sl = &sh->ring[slot_i % kSlots];
    bar_sync(kBarFull + slot_i % kSlots);
    const int cnt = sl->count;
    const bool last = sl->last;
    for (int r = 0; r < cnt; ++r) {
      const int4 rec = sl->rec[r];
      const int32_t d = rec.x, ln = rec.y, a = rec.z;
      const int32_t room = d < out_max ? out_max - d : 0;
      const int32_t n_w = ln < room ? ln : room;
      if (rec.w == 0) {
        for (int32_t i = lane; i < n_w; i += 32)
          o[d + i] = static_cast<uint8_t>(
              byte_at(c, lim, static_cast<int64_t>(a) + i));
      } else if (a >= ln) {
        for (int32_t i = lane; i < n_w; i += 32) {
          const int32_t si = d - a + i;
          o[d + i] = si < out_max ? o[si] : 0;
        }
      } else {
        for (int32_t i = lane; i < n_w; i += 32) {
          const int32_t si = d - a + i % a;
          o[d + i] = si < out_max ? o[si] : 0;
        }
      }
      __syncwarp();
    }
    if (last) break;
    bar_arrive(kBarEmpty + slot_i % kSlots);
    ++slot_i;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
seq_decode_kernel(const uint8_t* __restrict__ comp, int64_t pitch,
                  int32_t cmax, const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ clens,
                  const int32_t* __restrict__ dlens, uint8_t* out,
                  int32_t out_max, int32_t* __restrict__ err) {
  extern __shared__ __align__(16) uint8_t smem[];
  Shared* sh = reinterpret_cast<Shared*>(smem);
  uint8_t* image = smem + sizeof(Shared);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.x;
  const int32_t clen = clens[b];
  const int32_t dlen = dlens[b];
  uint8_t* orow = out + b * static_cast<int64_t>(out_max);
  const int64_t lim = clen < 0 ? 0 : (clen < cmax ? clen : cmax);
  const uint8_t* c = comp + b * pitch;

  if (warp == 0)
    parser(sh, c, lim, starts[b], clen, dlen, lane);
  else
    writer(sh, kShared ? image : orow, out_max, c, lim, lane);
  __syncthreads();

  const int32_t d = sh->d;
  const int64_t written = d < out_max ? d : out_max;
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
  if (t == 0) err[b] = sh->err;
}

bool use_shared(int32_t out_max) { return out_max <= kImage; }

int smem_bytes(int32_t out_max) {
  return static_cast<int>(sizeof(Shared)) +
         (use_shared(out_max) ? ((out_max + 15) & ~15) : 0);
}

template <bool kShared>
cudaError_t prepare(int smem) {
  return cudaFuncSetAttribute(seq_decode_kernel<kShared>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" int snc_seq_decode(const uint8_t* comp, int64_t pitch,
                              int32_t cmax, const int32_t* starts,
                              const int32_t* clens, const int32_t* dlens,
                              uint8_t* out, int32_t out_max, int32_t* err,
                              int32_t n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = smem_bytes(out_max);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (use_shared(out_max)) {
    rc = prepare<true>(smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    seq_decode_kernel<true><<<n_rows, kThreads, smem, st>>>(
        comp, pitch, cmax, starts, clens, dlens, out, out_max, err);
  } else {
    rc = prepare<false>(smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    seq_decode_kernel<false><<<n_rows, kThreads, smem, st>>>(
        comp, pitch, cmax, starts, clens, dlens, out, out_max, err);
  }
  return static_cast<int>(cudaGetLastError());
}

// blocks of the kernel one SM holds at once for rows of out_max bytes
extern "C" int snc_seq_decode_blocks_per_sm(int32_t out_max, int* blocks) {
  const int smem = smem_bytes(out_max);
  cudaError_t rc;
  if (use_shared(out_max)) {
    rc = prepare<true>(smem);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, seq_decode_kernel<true>, kThreads, smem);
  } else {
    rc = prepare<false>(smem);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, seq_decode_kernel<false>, kThreads, smem);
  }
  return static_cast<int>(rc);
}
