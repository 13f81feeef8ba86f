// Parallel-engine Snappy encode: encode_par.encode_blocks as two kernels,
// a candidate pass a block and a parse-and-emit pass a block.
//
// Replaces snappy_tpu/kernels/encode_jnp.py:encode_blocks (an XLA program:
// 4-byte words, a stable sort, three candidates a position, match lengths
// certified by paired Rabin-Karp hashes in a 17-step binary search,
// greedy and lazy walks by pointer doubling, two prune passes, the start
// shift, the emission as per-byte formulas, and an exact check of every
// copy).  The contract is encode_par.encode_blocks_plain, byte for byte,
// which is kernels/encode_np.py's algorithm: comp[b, :comp_len[b]] is the
// block's element stream, the rest of the row zero, ok[b] = comp_len[b]
// <= emax.  Match lengths here are exact (bytes compared), so where the
// plain version's hashes collide (~2^-64 a compare) it may flag ok=False
// or emit another stream (ROADMAP.md, "Known differences").  A copy whose
// offset is 65,536 or more (a block over 64 KiB, bmax = 2**17) keeps the
// reference's chop atoms, each a copy-4.
//
// 1. encode_cands_kernel: one CTA of 32 warps a block, the block's bytes
//    in shared memory.  The positions p < npos = n - 3 are stably radix
//    sorted by their little-endian word in four LSD passes of 8 bits whose
//    digits are the bytes p + k (so no key is stored), through two int32
//    buffers in device memory.  Each warp owns a chunk of consecutive
//    sorted indices; a pass counts digits per warp (equal digits grouped
//    with __match_any_sync), scans the counts digit-major, warp-minor, and
//    scatters each chunk in order, ranking equal digits in lane order:
//    a stable sort.  Then the run heads of the sorted order (a head's index
//    carried across the chunks) give each position its nearest and second
//    nearest previous position with the same word and the word's first
//    position.  A thread a position measures each candidate's match up to
//    kCap = 64 bytes, a word at a time, and writes one uint64 entry: 0 (no
//    candidate), the best (length, candidate) (the longest, on a tie the
//    later), or, where a match reaches kCap short of the block's end, the
//    candidates that reached it, 21 bits each, flagged kLong.  Positions at
//    or past npos have no word and are never written.
// 2. encode_parse_kernel: one CTA of 2 warps a block, the bytes in shared
//    memory.  Warp 0 walks the greedy parse, warp 1 the lazy one, from
//    position 1.  A walk loads the entries of 128 positions at once (four
//    8-byte loads a lane), skips to the next position with a candidate by
//    ballot, and measures a kLong entry's candidates whole, 4 bytes a lane
//    and 128 a step (it then skips over at least kCap bytes).  The lazy
//    walk defers when the next position's best is longer by 2 or more.
//    Taken copies (position, length, offset) go
//    to a list in device memory (cp_max a walk).  Each warp then runs the
//    two simultaneous-drop prune passes over its list (in place, 32
//    copies a step, each step's reads before its writes), the start shift
//    and the emission's size.  The smaller size wins (greedy on a tie);
//    warp 0 emits it, 32 copies a step (a warp scan of the element sizes,
//    each lane writing its tags, the warp copying each gap literal's
//    bytes), while warp 1 zeroes the row past the emission.
//
// What bounds it: the serial walks, not bytes.  A walk's whole compares
// cost the bytes of the copies it takes (it skips over them), more only
// where the lazy walk defers along a chain of matches past kCap growing by
// 2 (the lazy-chain block of encode_par.edge_blocks; PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 32;  // candidate kernel
constexpr int kThreads = kWarps * 32;
constexpr int kBins = 256;
constexpr int kParseThreads = 64;  // warp 0 greedy, warp 1 lazy
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kNone = 0x1FFFFFu;  // a packed "no candidate"
constexpr uint64_t kLong = 1ull << 63;  // an entry of candidates to measure
constexpr int kCap = 64;      // bytes of a match the candidate pass measures
constexpr int kWindow = 128;  // entries a walk loads at once
constexpr int32_t kCopy4Offset = 1 << 16;  // least offset past a copy-2

struct CandShared {
  int32_t cnt[kWarps][kBins];  // per warp and digit: counts, then offsets
  int32_t wsum[kBins / 32];
  int32_t last_head[kWarps];
};

__device__ __forceinline__ int32_t clamp_n(int32_t n, int32_t bmax) {
  return n < 0 ? 0 : (n > bmax ? bmax : n);
}

// the row's bytes into shared memory, 16 zero bytes after bmax
__device__ void load_block(uint8_t* blk, const uint8_t* row, int32_t bmax,
                           int tid, int nthreads) {
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0 && (bmax & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(row);
    uint4* d4 = reinterpret_cast<uint4*>(blk);
    for (int i = tid; i < bmax / 16; i += nthreads) d4[i] = s4[i];
  } else {
    for (int i = tid; i < bmax; i += nthreads) blk[i] = row[i];
  }
  for (int i = tid; i < 16; i += nthreads) blk[bmax + i] = 0;
}

__device__ __forceinline__ uint32_t word_at(const uint8_t* blk, int32_t p) {
  return static_cast<uint32_t>(blk[p]) |
         (static_cast<uint32_t>(blk[p + 1]) << 8) |
         (static_cast<uint32_t>(blk[p + 2]) << 16) |
         (static_cast<uint32_t>(blk[p + 3]) << 24);
}

// 4 bytes of blk at any byte offset x (blk 4-byte aligned, padded)
__device__ __forceinline__ uint32_t load4(const uint8_t* blk, int32_t x) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(blk);
  return __funnelshift_r(w[x >> 2], w[(x >> 2) + 1], (x & 3) * 8);
}

// the match of q and c (their first 4 bytes equal) measured up to lim
// bytes, a word at a time
__device__ __forceinline__ int32_t capped_len(const uint8_t* blk, int32_t q,
                                              int32_t c, int32_t lim) {
  for (int32_t j = 4; j < lim; j += 4) {
    const uint32_t x = load4(blk, q + j) ^ load4(blk, c + j);
    if (x) {
      const int32_t e = j + ((__ffs(x) - 1) >> 3);
      return e < lim ? e : lim;
    }
  }
  return lim;
}

__global__ void __launch_bounds__(kThreads, 1)
encode_cands_kernel(const uint8_t* __restrict__ block, int64_t pitch,
                    int32_t bmax, const int32_t* __restrict__ n_in,
                    int32_t* __restrict__ ord,
                    uint64_t* __restrict__ cands) {
  extern __shared__ __align__(16) uint8_t smem[];
  CandShared& sh = *reinterpret_cast<CandShared*>(smem);
  uint8_t* blk = smem + sizeof(CandShared);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t b = blockIdx.x;
  const int32_t n = clamp_n(n_in[b], bmax);
  const int32_t npos = n > 3 ? n - 3 : 0;
  if (npos == 0) return;
  load_block(blk, block + b * pitch, bmax, tid, kThreads);
  int32_t* o0 = ord + b * 2 * static_cast<int64_t>(bmax);
  int32_t* o1 = o0 + bmax;
  uint64_t* cd = cands + b * static_cast<int64_t>(bmax);
  // sorted indices [f0, f0 + chunk) are this warp's; chunk is a multiple
  // of 32, so every lane runs the same steps
  const int32_t chunk = ((npos + kThreads - 1) / kThreads) * 32;
  const int32_t f0 = warp * chunk;
  int32_t* cnt_flat = &sh.cnt[0][0];
  __syncthreads();

  for (int pass = 0; pass < 4; ++pass) {
    const int32_t* src = pass == 1 || pass == 3 ? o0 : o1;
    int32_t* dst = pass == 1 || pass == 3 ? o1 : o0;
    for (int i = tid; i < kWarps * kBins; i += kThreads) cnt_flat[i] = 0;
    __syncthreads();
    for (int32_t f = f0 + lane; f < f0 + chunk; f += 32) {
      const bool valid = f < npos;
      const int32_t p = !valid ? 0 : (pass == 0 ? f : src[f]);
      const uint32_t d = valid ? blk[p + pass] : kBins;
      const unsigned peers = __match_any_sync(kFull, d);
      if (valid && lane == __ffs(peers) - 1)
        sh.cnt[warp][d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    if (tid < kBins) {  // digit-major, warp-minor offsets
      int32_t total = 0;
      for (int w = 0; w < kWarps; ++w) total += sh.cnt[w][tid];
      int32_t incl = total;
      for (int s = 1; s < 32; s <<= 1) {
        const int32_t up = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl += up;
      }
      if (lane == 31) sh.wsum[warp] = incl;
      asm volatile("bar.sync 1, %0;" ::"r"(kBins));
      int32_t run = incl - total;
      for (int w = 0; w < warp; ++w) run += sh.wsum[w];
      for (int w = 0; w < kWarps; ++w) {
        const int32_t c = sh.cnt[w][tid];
        sh.cnt[w][tid] = run;
        run += c;
      }
    }
    __syncthreads();
    for (int32_t f = f0 + lane; f < f0 + chunk; f += 32) {
      const bool valid = f < npos;
      const int32_t p = !valid ? 0 : (pass == 0 ? f : src[f]);
      const uint32_t d = valid ? blk[p + pass] : kBins;
      const unsigned peers = __match_any_sync(kFull, d);
      const int leader = __ffs(peers) - 1;
      const int32_t at = valid ? sh.cnt[warp][d] : 0;
      __syncwarp();
      if (valid && lane == leader) sh.cnt[warp][d] = at + __popc(peers);
      __syncwarp();
      if (valid) dst[at + __popc(peers & lt)] = p;
    }
    __syncthreads();
  }

  // the run heads of the sorted order (o1): each warp's last head, then
  // the candidates with the head carried across the chunks
  const auto is_head = [&](int32_t f, uint32_t w) {
    return f == 0 || word_at(blk, o1[f - 1]) != w;
  };
  int32_t last = -1;
  for (int32_t f = f0 + lane; f < f0 + chunk; f += 32) {
    const bool head = f < npos && is_head(f, word_at(blk, o1[f]));
    const unsigned hb = __ballot_sync(kFull, head);
    if (hb) last = f - lane + 31 - __clz(hb);
  }
  if (lane == 0) sh.last_head[warp] = last;
  __syncthreads();
  int32_t run = lane < warp ? sh.last_head[lane] : -1;
  for (int s = 16; s > 0; s >>= 1)
    run = max(run, __shfl_xor_sync(kFull, run, s));
  for (int32_t f = f0 + lane; f < f0 + chunk; f += 32) {
    const bool valid = f < npos;
    const int32_t p = valid ? o1[f] : 0;
    const uint32_t w = valid ? word_at(blk, p) : 0u;
    const bool head = valid && is_head(f, w);
    const unsigned hb = __ballot_sync(kFull, head);
    const unsigned upto = hb & (lt | (1u << lane));
    const int32_t h = upto ? f - lane + 31 - __clz(upto) : run;
    if (hb) run = f - lane + 31 - __clz(hb);
    if (!valid) continue;
    if (head) {
      cd[p] = 0;  // no candidate
      continue;
    }
    // the candidates, nearest first; each measured up to kCap bytes
    int32_t c[3] = {o1[f - 1], -1, o1[h]};
    if (f >= 2 && word_at(blk, o1[f - 2]) == w) c[1] = o1[f - 2];
    const int32_t room = n - p;
    const int32_t lim = room < kCap ? room : kCap;
    int32_t len[3];
    int32_t bl = 0, bc = -1;
    for (int k = 0; k < 3; ++k) {
      len[k] = c[k] < 0 ? 0 : capped_len(blk, p, c[k], lim);
      if (len[k] > bl) bl = len[k], bc = c[k];
    }
    if (bl == kCap && room > kCap) {
      // a match past the cap: keep the candidates that reached it, for
      // the walk to measure whole
      uint64_t e = kLong;
      for (int k = 0; k < 3; ++k)
        e |= (len[k] == kCap ? static_cast<uint64_t>(c[k]) : kNone)
             << (21 * k);
      cd[p] = e;
    } else {
      // the longest, on a tie the nearest (the first in this order)
      cd[p] = static_cast<uint64_t>(bl) | (static_cast<uint64_t>(bc) << 8);
    }
  }
}

// ---------------------------------------------------------------------
// parse and emit

__device__ __forceinline__ int32_t lit_cost(int32_t r) {
  if (r <= 0) return 0;
  return r + 1 + (r - 1 >= 60) + (r - 1 >= 256) + (r - 1 >= 65536);
}

// the reference's chop atoms; an offset of 65,536 or more makes every
// atom a 5-byte copy-4
__device__ __forceinline__ int32_t copy_cost(int32_t off, int32_t ln) {
  const int32_t c64 = ln >= 68 ? (ln - 68) / 64 + 1 : 0;
  int32_t rem = ln - 64 * c64;
  const int32_t e60 = rem > 64 ? 1 : 0;
  rem -= 60 * e60;
  if (off >= kCopy4Offset) return 5 * (c64 + e60 + 1);
  return 3 * c64 + 3 * e60 + ((rem >= 12 || off >= 2048) ? 3 : 2);
}

// the exact match length of q and c (their first `from` bytes equal), at
// most limit: 4 bytes a lane, 128 a step
__device__ int32_t match_len(const uint8_t* blk, int32_t q, int32_t c,
                             int32_t from, int32_t limit, int lane) {
  for (int32_t off = from; off < limit; off += 128) {
    const int32_t i = off + 4 * lane;
    int32_t k = 0;  // bytes equal from i on (< 4: the match ends there)
    if (i < limit) {
      const uint32_t x = load4(blk, q + i) ^ load4(blk, c + i);
      k = x ? (__ffs(x) - 1) >> 3 : 4;
      if (k > limit - i) k = limit - i;
    }
    const unsigned m = __ballot_sync(kFull, k < 4);
    if (m) {
      const int32_t end = __shfl_sync(kFull, i + k, __ffs(m) - 1);
      return end < limit ? end : limit;
    }
  }
  return limit;
}

struct Walker {
  const uint64_t* cd;
  const uint8_t* blk;
  int32_t n, npos, wb;
  uint64_t win[kWindow / 32];
  int lane;

  __device__ void load(int32_t at) {
    wb = at;
#pragma unroll
    for (int r = 0; r < kWindow / 32; ++r) {
      const int32_t q = at + 32 * r + lane;
      win[r] = q < npos ? cd[q] : 0;
    }
  }

  // the entry of position q (warp-uniform q)
  __device__ uint64_t at(int32_t q) {
    if (q >= npos) return 0;
    if (q < wb || q >= wb + kWindow) load(q);
    const int r = (q - wb) >> 5, l = (q - wb) & 31;
    uint64_t v = __shfl_sync(kFull, win[0], l);
#pragma unroll
    for (int j = 1; j < kWindow / 32; ++j) {
      const uint64_t u = __shfl_sync(kFull, win[j], l);
      if (r == j) v = u;
    }
    return v;
  }

  // the next position >= p with a candidate, or npos
  __device__ int32_t next(int32_t p) {
    while (p < npos) {
      if (p < wb || p >= wb + kWindow) load(p);
#pragma unroll
      for (int r = 0; r < kWindow / 32; ++r) {
        const int32_t q = wb + 32 * r + lane;
        const unsigned m =
            __ballot_sync(kFull, q >= p && q < npos && win[r] != 0);
        if (m) return wb + 32 * r + __ffs(m) - 1;
      }
      p = wb + kWindow;
    }
    return npos;
  }

  // the best (length, candidate) of q: the longest, on a tie the later;
  // measured whole where the candidate pass stopped at its cap
  __device__ int2 best(int32_t q) {
    const uint64_t v = at(q);
    if (!(v & kLong))
      return make_int2(static_cast<int32_t>(v & 255u),
                       static_cast<int32_t>((v >> 8) & kNone));
    int2 bl = make_int2(0, -1);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint64_t c = (v >> (21 * k)) & kNone;
      if (c == kNone || static_cast<int32_t>(c) == bl.y) continue;
      const int32_t ln = match_len(blk, q, static_cast<int32_t>(c), kCap,
                                   n - q, lane);
      if (ln > bl.x || (ln == bl.x && static_cast<int32_t>(c) > bl.y))
        bl = make_int2(ln, static_cast<int32_t>(c));
    }
    return bl;
  }
};

// one walk into cl; returns the copies taken
__device__ int32_t walk(Walker& wk, bool lazy, int4* cl) {
  int32_t nc = 0;
  int32_t p = 1;
  while (p < wk.n) {
    const int32_t q = wk.next(p);
    if (q >= wk.npos) break;
    const int2 m = wk.best(q);
    if (lazy && wk.best(q + 1).x > m.x + 1) {
      p = q + 1;
      continue;
    }
    if (wk.lane == 0) cl[nc] = make_int4(q, m.x, q - m.y, 0);
    ++nc;
    p = q + m.x;
  }
  __syncwarp();
  return nc;
}

// two simultaneous-drop prune passes over cl[0, nc), in place; returns
// the copies kept
__device__ int32_t prune(int4* cl, int32_t nc, int32_t n, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  for (int pass = 0; pass < 2; ++pass) {
    int32_t kept = 0;
    int32_t carry = 0;  // the end of the copy before this step's first
    for (int32_t base = 0; base < nc; base += 32) {
      const int32_t k = base + lane;
      const bool valid = k < nc;
      const int4 r = valid ? cl[k] : make_int4(0, 0, 0, 0);
      const int32_t next_start = k + 1 < nc ? cl[k + 1].x : n;
      const int32_t end = r.x + r.y;
      int32_t prev_end = __shfl_up_sync(kFull, end, 1);
      if (lane == 0) prev_end = carry;
      const int32_t a = r.x - prev_end, bg = next_start - end;
      const bool elig = valid && !(a == 0 && k > 0) &&
                        !(bg == 0 && k + 1 < nc) &&
                        lit_cost(a + r.y + bg) <=
                            lit_cost(a) + copy_cost(r.z, r.y) + lit_cost(bg);
      const bool keep = valid && !elig;
      const unsigned km = __ballot_sync(kFull, keep);
      carry = __shfl_sync(kFull, end, 31);
      __syncwarp();
      if (keep) cl[kept + __popc(km & lt)] = r;
      kept += __popc(km);
      __syncwarp();
    }
    nc = kept;
  }
  return nc;
}

// the start shift of each copy, in place; returns the emission's size
__device__ int32_t shift(int4* cl, int32_t nc, int32_t n, int lane) {
  int32_t total = 0;
  int32_t carry = 0;
  for (int32_t base = 0; base < nc; base += 32) {
    const int32_t k = base + lane;
    const bool valid = k < nc;
    int4 r = valid ? cl[k] : make_int4(0, 0, 0, 0);
    const int32_t end = r.x + r.y;
    int32_t prev_end = __shfl_up_sync(kFull, end, 1);
    if (lane == 0) prev_end = carry;
    carry = __shfl_sync(kFull, end, 31);
    if (!valid) continue;
    const int32_t a0 = r.x - prev_end;
    int32_t best_d = 0;
    int32_t best = lit_cost(a0) + copy_cost(r.z, r.y);
    for (int32_t d = 1; d <= 3 && r.y - d >= 4; ++d) {
      const int32_t cost = lit_cost(a0 + d) + copy_cost(r.z, r.y - d);
      if (cost < best) {
        best_d = d;
        best = cost;
      }
    }
    r.x += best_d;
    r.y -= best_d;
    cl[k] = r;
    total += best;
  }
  __syncwarp();
  for (int s = 16; s > 0; s >>= 1) total += __shfl_xor_sync(kFull, total, s);
  const int32_t covered = nc > 0 ? cl[nc - 1].x + cl[nc - 1].y : 0;
  return total + lit_cost(n - covered);
}

struct Out {
  uint8_t* o;
  int32_t emax;
  __device__ __forceinline__ void put(int32_t i, uint32_t v) const {
    if (i < emax) o[i] = static_cast<uint8_t>(v);
  }
  // a literal's header of r bytes at i; returns its length
  __device__ int32_t lit_header(int32_t i, int32_t r) const {
    const uint32_t m = static_cast<uint32_t>(r - 1);
    const int extra = (m >= 60) + (m >= 256) + (m >= 65536);
    put(i, extra == 0 ? m << 2 : (59u + extra) << 2);
    for (int j = 0; j < extra; ++j) put(i + 1 + j, (m >> (8 * j)) & 255u);
    return 1 + extra;
  }
  // one copy-2 atom, or a copy-4 where the offset needs it; returns its
  // length
  __device__ int32_t atom(int32_t i, int32_t off, int32_t ln) const {
    const uint32_t o = static_cast<uint32_t>(off);
    const bool four = off >= kCopy4Offset;
    put(i, (static_cast<uint32_t>(ln - 1) << 2) | (four ? 3u : 2u));
    put(i + 1, o & 255u), put(i + 2, (o >> 8) & 255u);
    if (!four) return 3;
    put(i + 3, (o >> 16) & 255u), put(i + 4, o >> 24);
    return 5;
  }
  __device__ void copy_atoms(int32_t i, int32_t off, int32_t ln) const {
    const uint32_t lo = off & 255;
    while (ln >= 68) {
      i += atom(i, off, 64);
      ln -= 64;
    }
    if (ln > 64) {
      i += atom(i, off, 60);
      ln -= 60;
    }
    if (ln < 12 && off < 2048) {
      put(i, (static_cast<uint32_t>(off >> 8) << 5) |
                 (static_cast<uint32_t>(ln - 4) << 2) | 1u);
      put(i + 1, lo);
    } else {
      atom(i, off, ln);
    }
  }
};

// the emission of the copies cl[0, nc) and the tail literal
__device__ void emit(const int4* cl, int32_t nc, int32_t n,
                     const uint8_t* blk, const Out& out, int lane) {
  int32_t o_base = 0;
  int32_t carry = 0;
  for (int32_t base = 0; base < nc; base += 32) {
    const int32_t k = base + lane;
    const bool valid = k < nc;
    const int4 r = valid ? cl[k] : make_int4(0, 0, 0, 0);
    const int32_t end = r.x + r.y;
    int32_t prev_end = __shfl_up_sync(kFull, end, 1);
    if (lane == 0) prev_end = carry;
    carry = __shfl_sync(kFull, end, 31);
    const int32_t a = valid ? r.x - prev_end : 0;
    const int32_t lsz = lit_cost(a);
    const int32_t sz = valid ? lsz + copy_cost(r.z, r.y) : 0;
    int32_t incl = sz;
    for (int s = 1; s < 32; s <<= 1) {
      const int32_t up = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += up;
    }
    const int32_t at = o_base + incl - sz;
    int32_t data = at;  // where the gap literal's bytes go
    if (valid) {
      if (a > 0) data += out.lit_header(at, a);
      out.copy_atoms(at + lsz, r.z, r.y);
    }
    const int32_t cnt = nc - base < 32 ? nc - base : 32;
    for (int j = 0; j < cnt; ++j) {
      const int32_t aj = __shfl_sync(kFull, a, j);
      const int32_t sj = __shfl_sync(kFull, prev_end, j);
      const int32_t dj = __shfl_sync(kFull, data, j);
      for (int32_t i = lane; i < aj; i += 32) out.put(dj + i, blk[sj + i]);
    }
    o_base += __shfl_sync(kFull, incl, 31);
  }
  const int32_t covered = nc > 0 ? cl[nc - 1].x + cl[nc - 1].y : 0;
  const int32_t tail = n - covered;
  if (tail > 0) {
    const int32_t h = 1 + (tail - 1 >= 60) + (tail - 1 >= 256) +
                      (tail - 1 >= 65536);
    if (lane == 0) out.lit_header(o_base, tail);
    for (int32_t i = lane; i < tail; i += 32)
      out.put(o_base + h + i, blk[covered + i]);
  }
}

__global__ void __launch_bounds__(kParseThreads)
encode_parse_kernel(const uint8_t* __restrict__ block, int64_t pitch,
                    int32_t bmax, const int32_t* __restrict__ n_in,
                    const uint64_t* __restrict__ cands, int4* copies,
                    int32_t cp_max, uint8_t* __restrict__ comp, int32_t emax,
                    int32_t* __restrict__ comp_len, uint8_t* __restrict__ ok) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t totals[2];
  __shared__ int32_t counts[2];
  uint8_t* blk = smem;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int32_t n = clamp_n(n_in[b], bmax);
  load_block(blk, block + b * pitch, bmax, tid, kParseThreads);
  __syncthreads();

  int4* cl = copies + (b * 2 + warp) * static_cast<int64_t>(cp_max);
  Walker wk;
  wk.cd = cands + b * static_cast<int64_t>(bmax);
  wk.blk = blk;
  wk.n = n;
  wk.npos = n > 3 ? n - 3 : 0;
  wk.wb = -kWindow;
  wk.lane = lane;
  int32_t nc = walk(wk, warp == 1, cl);
  nc = prune(cl, nc, n, lane);
  const int32_t total = shift(cl, nc, n, lane);
  if (lane == 0) {
    totals[warp] = total;
    counts[warp] = nc;
  }
  __syncthreads();

  const int win = totals[1] < totals[0] ? 1 : 0;
  const int32_t size = totals[win];
  Out out{comp + b * static_cast<int64_t>(emax), emax};
  if (warp == 0) {
    emit(copies + (b * 2 + win) * static_cast<int64_t>(cp_max), counts[win],
         n, blk, out, lane);
  } else {
    for (int32_t i = (size > 0 ? size : 0) + lane; i < emax; i += 32)
      out.o[i] = 0;
  }
  if (tid == 0) {
    comp_len[b] = size;
    ok[b] = size <= emax;
  }
}

int cands_smem(int32_t bmax) {
  return static_cast<int>(sizeof(CandShared)) + bmax + 16;
}

}  // namespace

// encode_par.encode_blocks: the candidate pass, then the parse-and-emit
// pass.  Scratch: ord int32 [B, 2, bmax], cands (the entries) uint64
// [B, bmax], copies int4 [B, 2, cp_max].
extern "C" int snc_encode_par(const uint8_t* block, int64_t pitch,
                              int32_t bmax, const int32_t* n, int32_t* ord,
                              uint64_t* cands, int32_t* copies,
                              int32_t cp_max, uint8_t* comp, int32_t emax,
                              int32_t* comp_len, uint8_t* ok, int32_t n_rows,
                              void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem1 = cands_smem(bmax);
  cudaError_t rc = cudaFuncSetAttribute(
      encode_cands_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  encode_cands_kernel<<<n_rows, kThreads, smem1, st>>>(block, pitch, bmax, n,
                                                       ord, cands);
  const int smem2 = bmax + 16;
  rc = cudaFuncSetAttribute(encode_parse_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  encode_parse_kernel<<<n_rows, kParseThreads, smem2, st>>>(
      block, pitch, bmax, n, cands, reinterpret_cast<int4*>(copies), cp_max,
      comp, emax, comp_len, ok);
  return static_cast<int>(cudaGetLastError());
}
