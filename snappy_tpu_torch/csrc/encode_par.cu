// Parallel-engine Snappy encode: encode_par.encode_blocks as three kernels,
// a candidate pass a block, a parse a block and walk kind, an emission a
// block.
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
// 1. encode_cands_kernel: a cluster of 2 CTAs of 32 warps a block (128
//    CTAs fill the SMs of a 64-row batch), the block's bytes in each CTA's
//    shared memory.  The positions p < npos = n - 3 are stably radix
//    sorted by their little-endian word in four LSD passes of 8 bits whose
//    digits are the bytes p + k (so no key is stored), through two int32
//    buffers in device memory.  Each of the cluster's 64 warps owns a chunk
//    of consecutive sorted indices, rank 0's first (a lane loads kBatch
//    of them at once); a pass counts digits per warp (equal digits
//    grouped with __match_any_sync), takes the other CTA's digit totals
//    from its shared memory, scans the counts digit-major, warp-minor,
//    and scatters each chunk in order, ranking equal digits in lane
//    order: a stable sort; a cluster barrier ends the pass.  Then the run
//    heads of the sorted order (a head's index carried across the chunks
//    and the two CTAs) give each position its nearest and second nearest
//    previous position with the same word and the word's first position.
//    A thread a position measures each candidate's match up to kCap = 64
//    bytes, a word at a time, and writes one uint64 entry: 0 (no
//    candidate), the best (length, candidate) (the longest, on a tie the
//    later), or, where a match reaches kCap short of the block's end, the
//    candidates that reached it, 21 bits each, flagged kLong.  Positions
//    at or past npos have no word and are never written.
// 2. encode_parse_kernel: one CTA of 32 warps a block and walk kind (the
//    greedy walk and the lazy one, from position 1; 2 B CTAs fill the
//    card's SMs), the block's bytes in shared memory.  A walk is the
//    orbit of a successor function over positions: at a position with a
//    candidate the walk takes its best copy (the lazy walk defers to the
//    next position where that one's best is longer by 2 or more), any
//    other position steps by one.  So the positions are cut into chunks
//    of kChunk, and:
//    a. speculative walks, a thread a chunk: each walks from its chunk's
//       first position, finding the next position with a candidate in a
//       bitmap in shared memory (made first from the entries, a ballot a
//       word) and reading an entry with one load; it marks every state it
//       stands on in a second bitmap and keeps its copies (kSlot a chunk,
//       in device memory) and its exit, the first state past the chunk.
//       Where a lane stands on a kLong entry, the whole warp measures its
//       candidates (4 bytes a lane, 128 a step), one lane's at a time,
//       but not past the chunk's end: where a step would depend on bytes
//       past it, the walk stops there, open (a run would otherwise be
//       measured whole from every chunk);
//    b. the true entries.  From the previous chunk's true exit (position
//       1 for chunk 0) the true walk steps until it stands on a marked
//       state.  A walk's next state depends on its state alone, so from
//       there the true walk is the speculative one: the rest of the
//       chunk's copies and its exit are the speculative walk's.  If it
//       never meets a marked state, it walks to the chunk's end itself and
//       its own copies are the chunk's: exact whether the two walks
//       resynchronise or not (they meet after 0-6 copies on text).  The
//       previous chunk's true exit is almost always its speculative exit,
//       so every chunk's walk from there (its link) is taken first, a
//       thread a chunk; then warp 0 runs through the chunks in order,
//       taking a chunk's link where the true walk arrives at its start
//       and walking the chunk itself where it does not.  Where the walk
//       it met stopped open, lane 0 walks on from the open state to the
//       chunk's end, measuring whole (the tail): once a run;
//    c. the copy list: per chunk its entry copies, its speculative copies
//       from the meeting state on and its tail, counted, scanned across
//       the CTA and written in place;
//    d. the two simultaneous-drop prune passes (a copy a thread, a CTA
//       scan for the compaction, between two lists), the start shift and
//       the emission's size, with the whole CTA.
// 3. encode_emit_kernel: one CTA a block.  The smaller size wins (greedy
//    on a tie); a thread a copy writes its tags at a CTA scan of the
//    element sizes, each warp copies its copies' gap literals, then the
//    tail literal and zeros to emax.
//
// What bounds it: the walks' steps, not bytes (a 64-row batch moves ~9 MB
// against thousands of dependent steps a walk of a 64 KiB text block).  One
// warp a walk (the first port) left 128 serial walks on a card that holds
// 8,448 warps; a warp a chunk of 1,024 positions still ran every step's
// instructions 32 times, bound by the SMs' instruction rate (PERF.md); a
// thread a chunk of 256 makes them 256 short walks a block and walk kind,
// 8 warps of one CTA an SM, bound by each step's load of an entry.  A
// walk's whole compares cost the bytes of the copies it takes (it skips
// over them), more only where the lazy walk defers along a chain of
// matches past kCap growing by 2 (the lazy-chain block of
// encode_par.edge_blocks; PERF.md).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kCluster = 2;  // candidate kernel: CTAs a block
constexpr int kWarps = 32;   // ... warps a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kBins = 256;
constexpr int kBatch = 8;  // sorted indices a lane loads at once in a pass
constexpr int kParseWarps = 32;  // parse kernel: a walk kind of a block
constexpr int kParseThreads = kParseWarps * 32;
constexpr int kChunk = 256;  // positions a speculative walk covers
constexpr int kSlot = kChunk / 4 + 1;  // its copies (each 4 bytes or more)
constexpr int kMaxChunks = (1 << 17) / kChunk;  // chunks of a 2**17 block
static_assert(kMaxChunks <= kParseThreads, "a chunk a thread");
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kNone = 0x1FFFFFu;  // a packed "no candidate"
constexpr uint64_t kLong = 1ull << 63;  // an entry of candidates to measure
constexpr int kCap = 64;      // bytes of a match the candidate pass measures
constexpr int32_t kCopy4Offset = 1 << 16;  // least offset past a copy-2

struct CandShared {
  int32_t cnt[kWarps][kBins];  // per warp and digit: counts, then offsets
  int32_t tot[kBins];          // per digit: this CTA's count
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

// a lane's next kBatch sorted indices f, f + 32, ... of a radix pass: the
// position each holds (pass 0: the index itself), -1 past the chunk's end
// or npos; the loads all in flight at once
__device__ __forceinline__ void load_batch(int32_t* pb, const int32_t* src,
                                           int32_t f, int32_t end,
                                           int32_t npos, int pass) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int32_t fu = f + 32 * u;
    pb[u] = fu < end && fu < npos ? (pass == 0 ? fu : src[fu]) : -1;
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
encode_cands_kernel(const uint8_t* __restrict__ block, int64_t pitch,
                    int32_t bmax, const int32_t* __restrict__ n_in,
                    int32_t* __restrict__ ord,
                    uint64_t* __restrict__ cands) {
  extern __shared__ __align__(16) uint8_t smem[];
  CandShared& sh = *reinterpret_cast<CandShared*>(smem);
  uint8_t* blk = smem + sizeof(CandShared);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const CandShared& peer = *cluster.map_shared_rank(&sh, rank ^ 1);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t b = blockIdx.x / kCluster;
  const int32_t n = clamp_n(n_in[b], bmax);
  const int32_t npos = n > 3 ? n - 3 : 0;
  if (npos == 0) return;  // both CTAs of the cluster
  load_block(blk, block + b * pitch, bmax, tid, kThreads);
  int32_t* o0 = ord + b * 2 * static_cast<int64_t>(bmax);
  int32_t* o1 = o0 + bmax;
  uint64_t* cd = cands + b * static_cast<int64_t>(bmax);
  // sorted indices [f0, f0 + chunk) are this warp's, the cluster's warps
  // in rank order; chunk is a multiple of 32, so every lane runs the same
  // steps
  const int32_t chunk =
      ((npos + kCluster * kThreads - 1) / (kCluster * kThreads)) * 32;
  const int32_t f0 = (rank * kWarps + warp) * chunk;
  int32_t* cnt_flat = &sh.cnt[0][0];
  cluster.sync();  // both CTAs run before either reads the other's memory

  for (int pass = 0; pass < 4; ++pass) {
    const int32_t* src = pass == 1 || pass == 3 ? o0 : o1;
    int32_t* dst = pass == 1 || pass == 3 ? o1 : o0;
    for (int i = tid; i < kWarps * kBins; i += kThreads) cnt_flat[i] = 0;
    __syncthreads();
    for (int32_t f = f0 + lane; f < f0 + chunk; f += 32 * kBatch) {
      int32_t pb[kBatch];
      load_batch(pb, src, f, f0 + chunk, npos, pass);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (f - lane + 32 * u >= f0 + chunk) break;  // the same in every lane
        const bool valid = pb[u] >= 0;
        const uint32_t d = valid ? blk[pb[u] + pass] : kBins;
        const unsigned peers = __match_any_sync(kFull, d);
        if (valid && lane == __ffs(peers) - 1)
          sh.cnt[warp][d] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
    if (tid < kBins) {
      int32_t t = 0;
      for (int w = 0; w < kWarps; ++w) t += sh.cnt[w][tid];
      sh.tot[tid] = t;
    }
    cluster.sync();  // both CTAs' digit counts
    if (tid < kBins) {  // digit-major, warp-minor offsets, rank 0 first
      const int32_t other = peer.tot[tid];
      const int32_t total = sh.tot[tid] + other;
      int32_t incl = total;
      for (int s = 1; s < 32; s <<= 1) {
        const int32_t up = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl += up;
      }
      if (lane == 31) sh.wsum[warp] = incl;
      asm volatile("bar.sync 1, %0;" ::"r"(kBins));
      int32_t run = incl - total + (rank == 1 ? other : 0);
      for (int w = 0; w < warp; ++w) run += sh.wsum[w];
      for (int w = 0; w < kWarps; ++w) {
        const int32_t c = sh.cnt[w][tid];
        sh.cnt[w][tid] = run;
        run += c;
      }
    }
    __syncthreads();
    for (int32_t f = f0 + lane; f < f0 + chunk; f += 32 * kBatch) {
      int32_t pb[kBatch];
      load_batch(pb, src, f, f0 + chunk, npos, pass);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (f - lane + 32 * u >= f0 + chunk) break;  // the same in every lane
        const bool valid = pb[u] >= 0;
        const uint32_t d = valid ? blk[pb[u] + pass] : kBins;
        const unsigned peers = __match_any_sync(kFull, d);
        const int leader = __ffs(peers) - 1;
        const int32_t at = valid ? sh.cnt[warp][d] : 0;
        __syncwarp();
        if (valid && lane == leader) sh.cnt[warp][d] = at + __popc(peers);
        __syncwarp();
        if (valid) dst[at + __popc(peers & lt)] = pb[u];
      }
    }
    // the pass's order complete over the cluster before the next reads
    // it; the digit counts read before they are rewritten
    __threadfence();
    cluster.sync();
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
  cluster.sync();
  // the last head before this warp's chunk: of rank 0's warps, then of
  // this CTA's warps before it
  int32_t run = lane < warp ? sh.last_head[lane] : -1;
  if (rank == 1) run = max(run, peer.last_head[lane]);
  for (int s = 16; s > 0; s >>= 1)
    run = max(run, __shfl_xor_sync(kFull, run, s));
  cluster.sync();  // the peer's memory read before either CTA ends
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

// a copy (position, length, offset), 18 bits each in a uint64: the lists
// of the walks, the prune and the emission
struct Copy {
  int32_t pos, len, off;
};

__device__ __forceinline__ uint64_t pack(Copy c) {
  return static_cast<uint64_t>(c.pos) |
         (static_cast<uint64_t>(c.len) << 18) |
         (static_cast<uint64_t>(c.off) << 36);
}

__device__ __forceinline__ Copy unpack(uint64_t v) {
  return Copy{static_cast<int32_t>(v & 0x3FFFFu),
              static_cast<int32_t>((v >> 18) & 0x3FFFFu),
              static_cast<int32_t>((v >> 36) & 0x3FFFFu)};
}

__device__ __forceinline__ int32_t end_of(uint64_t v) {
  const Copy c = unpack(v);
  return c.pos + c.len;
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

// The walks over the entries, a walk a lane: the next position with a
// candidate from a bitmap in shared memory (bit q: entry q is not 0), an
// entry by one load, a kLong entry's candidates measured whole by the
// whole warp, one lane's at a time.  Every lane of the warp calls each
// member; `on` says whether the lane has a position to step at.
struct Walker {
  const uint64_t* cd;
  const uint32_t* has;
  const uint8_t* blk;
  int32_t n, npos;
  int lane;

  __device__ __forceinline__ uint64_t at(int32_t q) const {
    return q < npos ? __ldg(cd + q) : 0;
  }

  // the first position in [p, lim) with a candidate, or lim (lim <= npos)
  __device__ int32_t next(int32_t p, int32_t lim) const {
    if (p >= lim) return lim;
    int32_t w = p >> 5;
    const int32_t last = (lim - 1) >> 5;
    uint32_t m = has[w] & (kFull << (p & 31));
    while (!m && w < last) m = has[++w];
    if (!m) return lim;
    const int32_t q = (w << 5) + __ffs(m) - 1;
    return q < lim ? q : lim;
  }

  // the best (length, candidate) of entry v at q: the longest, on a tie
  // the later; measured whole where the candidate pass stopped at its cap
  // (the warp measures the lanes' kLong entries in turn), but not past
  // bound: *open where a candidate's match reaches it, the result then
  // unknown
  __device__ int2 best(int32_t q, uint64_t v, bool on, int32_t bound,
                       bool* open) const {
    int2 bl = make_int2(static_cast<int32_t>(v & 255u),
                        static_cast<int32_t>((v >> 8) & kNone));
    bool pending = on && (v & kLong);
    if (pending) bl = make_int2(0, -1);
    unsigned need;
    while ((need = __ballot_sync(kFull, pending)) != 0) {
      const int j = __ffs(need) - 1;
      const int32_t qj = __shfl_sync(kFull, q, j);
      const uint64_t vj = __shfl_sync(kFull, v, j);
      const int32_t lim = min(__shfl_sync(kFull, bound, j), n) - qj;
      int2 bj = make_int2(0, -1);
      bool oj = false;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint64_t c = (vj >> (21 * k)) & kNone;
        if (c == kNone || static_cast<int32_t>(c) == bj.y) continue;
        const int32_t ln = match_len(blk, qj, static_cast<int32_t>(c), kCap,
                                     lim, lane);
        oj |= ln >= lim;
        if (ln > bj.x || (ln == bj.x && static_cast<int32_t>(c) > bj.y))
          bj = make_int2(ln, static_cast<int32_t>(c));
      }
      if (lane == j) {
        bl = bj;
        *open |= oj;
        pending = false;
      }
    }
    return bl;
  }

  // the walk at candidate position q: the copy it takes, or (q, 0, 0)
  // where the lazy walk defers to q + 1; *open where a match it measures
  // reaches bound (the step then unknown)
  __device__ Copy step(int32_t q, bool lazy, bool on, int32_t bound,
                       bool* open) const {
    const uint64_t v = on ? at(q) : 0;
    const uint64_t v1 = on && lazy ? at(q + 1) : 0;  // both loads in flight
    const int2 m = best(q, v, on, bound, open);
    if (lazy && best(q + 1, v1, on, bound, open).x > m.x + 1)
      return Copy{q, 0, 0};
    return Copy{q, m.x, q - m.y};
  }
};

struct alignas(16) ParseShared {
  int32_t n_spec[kMaxChunks];  // the chunk's speculative copies
  int32_t exit[kMaxChunks];    // ... and where its walk left the chunk
  int32_t open[kMaxChunks];    // ... or the state where it stopped (-1)
  int32_t link_n[kMaxChunks];  // the link walk's copies (-1: no link)
  int32_t link_met[kMaxChunks];  // ... where it met the chunk's walk
  int32_t link_exit[kMaxChunks];  // ... and its exit
  int32_t resync[kMaxChunks];  // the true walk met it there (-1: never)
  int32_t n_entry[kMaxChunks];  // copies of the true walk before that
  int32_t entry_at[kMaxChunks];  // ... in the entry list (-1: the link's)
  int32_t skip[kMaxChunks];    // speculative copies before the resync
  int32_t tail_n[kMaxChunks];  // copies walked on from an open state
  int32_t tail_at[kMaxChunks];  // ... in the entry list
  int32_t base[kMaxChunks];    // the chunk's first copy in the list
  int32_t sums[32];            // cta_scan's warp sums
};

// the exclusive prefix sum of v over the CTA's threads, in thread order;
// *total the sum.  Every thread calls it.
__device__ int32_t cta_scan(int32_t v, int32_t* sums, int32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int32_t incl = v;
  for (int s = 1; s < 32; s <<= 1) {
    const int32_t up = __shfl_up_sync(kFull, incl, s);
    if (lane >= s) incl += up;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < nw ? sums[lane] : 0;
    for (int s = 1; s < 32; s <<= 1) {
      const int32_t up = __shfl_up_sync(kFull, w, s);
      if (lane >= s) w += up;
    }
    sums[lane] = w;
  }
  __syncthreads();
  const int32_t before = warp > 0 ? sums[warp - 1] : 0;
  *total = sums[nw - 1];
  __syncthreads();  // sums is free for the next call
  return before + incl - v;
}

// the states [p, e] of a walk (positions it stands on) marked in bits;
// only this lane writes the words of its chunk
__device__ __forceinline__ void mark_states(uint32_t* bits, int32_t p,
                                            int32_t e) {
  const int32_t w0 = p >> 5, w1 = e >> 5;
  for (int32_t w = w0; w <= w1; ++w) {
    uint32_t m = kFull;
    if (w == w0) m &= kFull << (p & 31);
    if (w == w1) m &= kFull >> (31 - (e & 31));
    bits[w] |= m;
  }
}

// What a walk_lanes walk is.  kSpecWalk: a speculative walk, marking
// every state it stands on, measuring no match past the chunk's end:
// where a step's decision depends on bytes past it (a kLong match that
// reaches it), the walk stops at that open state, its exit unknown.
// kMeetWalk: a true walk that stops where it stands on a marked state.
// kFullWalk: a true walk to the chunk's end.
enum WalkMode { kSpecWalk, kMeetWalk, kFullWalk };

// A walk a lane from state p through a chunk (its end b), its copies to
// out (*nc of them), returning its exit, the first state at or past b (-1
// where a kSpecWalk walk stopped open, at *stop).  A kMeetWalk walk that
// stands on a marked state, a state of the chunk's speculative walk,
// stops there (*stop that state): a walk's next state depends on its
// state alone, so from there the two walks are one, and the exit is
// spec_exit.  A kMeetWalk walk that meets no marked state walks to the
// chunk's end itself (*stop -1): exact whether the two walks meet or
// not.
__device__ int32_t walk_lanes(const Walker& wk, bool lazy, bool on,
                              WalkMode mode, int32_t p, int32_t b,
                              uint32_t* bits, int32_t spec_exit,
                              uint64_t* out, int32_t* nc, int32_t* stop) {
  int32_t cnt = 0;
  *stop = -1;
  bool active = on && p < b;
  while (__any_sync(kFull, active)) {
    int32_t q = p;
    bool stepping = false;
    if (active) {
      if (mode == kMeetWalk && ((bits[p >> 5] >> (p & 31)) & 1u)) {
        *stop = p;
        p = spec_exit;
        active = false;
      } else {
        q = wk.next(p, b);
        if (mode == kSpecWalk) mark_states(bits, p, q < b ? q : b - 1);
        if (q >= b) {
          p = q;
          active = false;
        } else if (q != p && mode == kMeetWalk) {
          p = q;  // stand on q: its mark is read first
        } else {
          stepping = true;
        }
      }
    }
    bool open = false;
    const Copy c = wk.step(q, lazy, stepping, mode == kSpecWalk ? b : wk.n,
                           &open);
    if (stepping) {
      if (mode == kSpecWalk && open) {
        *stop = q;
        p = -1;
        active = false;
      } else if (c.len == 0) {
        p = q + 1;
      } else {
        out[cnt++] = pack(c);
        p = q + c.len;
      }
      active = active && p < b;
    }
  }
  *nc = cnt;
  return p;
}

// the end of chunk k, cut at npos
__device__ __forceinline__ int32_t chunk_end(int32_t k, int32_t npos) {
  return min((k + 1) * kChunk, npos);
}

// thread k: chunk k's speculative walk, from its first position (1 for
// chunk 0): its states marked, its copies into its slot, count and exit
// (or the state where it stopped open)
__device__ void spec_walks(const Walker& wk, bool lazy, int32_t nck,
                           uint32_t* bits, uint64_t* slot0, ParseShared& sh) {
  const int32_t k = threadIdx.x;
  const bool on = k < nck;
  int32_t nc, open;
  const int32_t x =
      walk_lanes(wk, lazy, on, kSpecWalk, k == 0 ? 1 : k * kChunk,
                 chunk_end(k, wk.npos), bits, 0,
                 slot0 + k * static_cast<int64_t>(kSlot), &nc, &open);
  if (on) {
    sh.n_spec[k] = nc;
    sh.exit[k] = x;
    sh.open[k] = open;
  }
}

// thread k: chunk k's link, the true walk's entry into chunk k where it
// leaves chunk k - 1 at that chunk's speculative exit (position 1 for
// chunk 0), the common case, walked ahead of the true entries; none
// where chunk k - 1's walk stopped open
__device__ void link_walks(const Walker& wk, bool lazy, int32_t nck,
                           uint32_t* bits, uint64_t* link0, ParseShared& sh) {
  const int32_t k = threadIdx.x;
  const bool on = k < nck && (k == 0 || sh.open[k - 1] < 0);
  const int32_t e0 = k == 0 ? 1 : (on ? sh.exit[k - 1] : 0);
  int32_t nc, met;
  const int32_t x =
      walk_lanes(wk, lazy, on, kMeetWalk, e0, chunk_end(k, wk.npos), bits,
                 on ? sh.exit[k] : 0, link0 + k * static_cast<int64_t>(kSlot),
                 &nc, &met);
  if (k < nck) {
    sh.link_n[k] = on ? nc : -1;
    sh.link_met[k] = met;
    sh.link_exit[k] = x;
  }
}

// warp 0: the true walk's entry into each chunk in turn, from position 1:
// the chunk's link where the walk leaves the previous chunk at its
// speculative exit, else lane 0 walks the chunk from the true exit until
// it meets the speculative walk (copies to elist).  Where it met a walk
// that stopped open, lane 0 walks on from that open state to the chunk's
// end (the tail, to elist too).
__device__ void entry_pass(const Walker& wk, bool lazy, int32_t nck,
                           uint32_t* bits, uint64_t* elist,
                           ParseShared& sh) {
  int32_t e = 1, at = 0;
  for (int32_t k = 0; k < nck; ++k) {
    const int32_t b = chunk_end(k, wk.npos);
    int32_t m, met, from = -1, tn = 0;
    if (sh.link_n[k] >= 0 && e == (k == 0 ? 1 : sh.exit[k - 1])) {
      m = sh.link_n[k];
      met = sh.link_met[k];
      e = sh.link_exit[k];
    } else {
      e = walk_lanes(wk, lazy, wk.lane == 0, kMeetWalk, e, b, bits,
                     sh.exit[k], elist + at, &m, &met);
      e = __shfl_sync(kFull, e, 0);
      m = __shfl_sync(kFull, m, 0);
      met = __shfl_sync(kFull, met, 0);
      from = at;
      at += m;
    }
    if (met >= 0 && sh.open[k] >= 0) {
      int32_t unused;
      e = walk_lanes(wk, lazy, wk.lane == 0, kFullWalk, sh.open[k], b,
                     bits, 0, elist + at, &tn, &unused);
      e = __shfl_sync(kFull, e, 0);
      tn = __shfl_sync(kFull, tn, 0);
    }
    if (wk.lane == 0) {
      sh.resync[k] = met;
      sh.n_entry[k] = m;
      sh.entry_at[k] = from;
      sh.tail_n[k] = tn;
      sh.tail_at[k] = at;
    }
    at += tn;
  }
}

// one simultaneous-drop prune pass from src[0, nc) into dst (the whole
// CTA, a copy a thread); returns the copies kept
__device__ int32_t prune_pass(const uint64_t* src, uint64_t* dst, int32_t nc,
                              int32_t n, int32_t* sums) {
  int32_t kept = 0;
  for (int32_t base = 0; base < nc; base += blockDim.x) {
    const int32_t k = base + threadIdx.x;
    const bool valid = k < nc;
    const uint64_t v = valid ? src[k] : 0;
    const Copy c = unpack(v);
    const int32_t prev_end = valid && k > 0 ? end_of(src[k - 1]) : 0;
    const int32_t next_start = k + 1 < nc ? unpack(src[k + 1]).pos : n;
    const int32_t a = c.pos - prev_end, bg = next_start - (c.pos + c.len);
    const bool elig = valid && !(a == 0 && k > 0) &&
                      !(bg == 0 && k + 1 < nc) &&
                      lit_cost(a + c.len + bg) <=
                          lit_cost(a) + copy_cost(c.off, c.len) + lit_cost(bg);
    const bool keep = valid && !elig;
    int32_t tot;
    const int32_t at = cta_scan(keep, sums, &tot);
    if (keep) dst[kept + at] = v;
    kept += tot;
  }
  return kept;
}

// the start shift of each copy of cl[0, nc), in place; returns the
// emission's size
__device__ int32_t shift_pass(uint64_t* cl, int32_t nc, int32_t n,
                              int32_t* sums) {
  int32_t total = 0;
  for (int32_t base = 0; base < nc; base += blockDim.x) {
    const int32_t k = base + threadIdx.x;
    const bool valid = k < nc;
    Copy c = valid ? unpack(cl[k]) : Copy{0, 0, 0};
    // a shift keeps each copy's end, so the previous end reads the same
    // before and after its own shift
    const int32_t prev_end = valid && k > 0 ? end_of(cl[k - 1]) : 0;
    __syncthreads();
    if (!valid) continue;
    const int32_t a0 = c.pos - prev_end;
    int32_t best_d = 0;
    int32_t best = lit_cost(a0) + copy_cost(c.off, c.len);
    for (int32_t d = 1; d <= 3 && c.len - d >= 4; ++d) {
      const int32_t cost = lit_cost(a0 + d) + copy_cost(c.off, c.len - d);
      if (cost < best) {
        best_d = d;
        best = cost;
      }
    }
    c.pos += best_d;
    c.len -= best_d;
    cl[k] = pack(c);
    total += best;
  }
  int32_t sum;
  cta_scan(total, sums, &sum);
  const int32_t covered = nc > 0 ? end_of(cl[nc - 1]) : 0;
  return sum + lit_cost(n - covered);
}

// the bitmap's offset after the block's bytes (16 zero bytes past bmax)
__host__ __device__ __forceinline__ int32_t bits_at(int32_t bmax) {
  return (bmax + 16 + 15) & ~15;
}

// a block's scratch for one walk kind: the chunks' speculative copies
// (kSlot a chunk), the link walks' copies (as many), then three lists of
// cp_max: the entry walks' copies, the copy list, the prune's second
// buffer
__device__ __forceinline__ uint64_t* slots_of(uint64_t* slots, int64_t g,
                                              int32_t n_chunks) {
  return slots + g * 2 * n_chunks * static_cast<int64_t>(kSlot);
}

__device__ __forceinline__ uint64_t* lists_of(uint64_t* lists, int64_t g,
                                              int32_t cp_max) {
  return lists + g * 3 * static_cast<int64_t>(cp_max);
}

// one CTA a block and walk kind (blockIdx.x = 2 b + lazy)
__global__ void __launch_bounds__(kParseThreads, 1)
encode_parse_kernel(const uint8_t* __restrict__ block, int64_t pitch,
                    int32_t bmax, const int32_t* __restrict__ n_in,
                    const uint64_t* __restrict__ cands, uint64_t* slots,
                    uint64_t* lists, int32_t cp_max,
                    int32_t* __restrict__ totals,
                    int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint8_t smem[];
  ParseShared& sh = *reinterpret_cast<ParseShared*>(smem);
  uint8_t* blk = smem + sizeof(ParseShared);
  uint32_t* bits = reinterpret_cast<uint32_t*>(blk + bits_at(bmax));
  uint32_t* has = bits + bmax / 32 + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t g = blockIdx.x;
  const int64_t b = g >> 1;
  const bool lazy = g & 1;
  const int32_t n = clamp_n(n_in[b], bmax);
  const int32_t npos = n > 3 ? n - 3 : 0;
  const int32_t nck = (npos + kChunk - 1) / kChunk;
  const int32_t n_chunks = (bmax + kChunk - 1) / kChunk;
  uint64_t* slot0 = slots_of(slots, g, n_chunks);
  uint64_t* link0 = slot0 + n_chunks * static_cast<int64_t>(kSlot);
  uint64_t* elist = lists_of(lists, g, cp_max);
  uint64_t* cl = elist + cp_max;
  uint64_t* cl2 = cl + cp_max;
  load_block(blk, block + b * pitch, bmax, tid, kParseThreads);
  for (int32_t i = tid; i <= bmax / 32; i += kParseThreads) bits[i] = 0;
  const uint64_t* cd = cands + b * static_cast<int64_t>(bmax);
  for (int32_t w = warp; w <= bmax / 32; w += kParseWarps) {
    const int32_t q = 32 * w + lane;
    const unsigned m = __ballot_sync(kFull, q < npos && __ldg(cd + q) != 0);
    if (lane == 0) has[w] = m;
  }
  __syncthreads();

  Walker wk;
  wk.cd = cd;
  wk.has = has;
  wk.blk = blk;
  wk.n = n;
  wk.npos = npos;
  wk.lane = lane;
  // 1. the speculative walks, a chunk a thread; 2. the links, then the
  // true entries
  spec_walks(wk, lazy, nck, bits, slot0, sh);
  __syncthreads();
  link_walks(wk, lazy, nck, bits, link0, sh);
  __syncthreads();
  if (warp == 0) entry_pass(wk, lazy, nck, bits, elist, sh);
  __syncthreads();
  // 3. the copy list: each chunk's entry copies, its speculative copies
  // from the resync on, then its tail
  for (int32_t k = warp; k < nck; k += kParseWarps) {
    const int32_t rs = sh.resync[k];
    const int32_t ns = sh.n_spec[k];
    int32_t skip = ns;
    if (rs >= 0) {
      const uint64_t* slot = slot0 + k * static_cast<int64_t>(kSlot);
      int32_t before = 0;
      for (int32_t i = lane; i < ns; i += 32)
        before += unpack(slot[i]).pos < rs;
      for (int s = 16; s > 0; s >>= 1)
        before += __shfl_xor_sync(kFull, before, s);
      skip = before;
    }
    if (lane == 0) sh.skip[k] = skip;
  }
  __syncthreads();
  int32_t nc;
  const int32_t mine = tid < nck ? sh.n_entry[tid] + sh.n_spec[tid] -
                                       sh.skip[tid] + sh.tail_n[tid]
                                 : 0;
  const int32_t at = cta_scan(mine, sh.sums, &nc);
  if (tid < nck) sh.base[tid] = at;
  __syncthreads();
  for (int32_t k = warp; k < nck; k += kParseWarps) {
    uint64_t* dst = cl + sh.base[k];
    const int32_t ne = sh.n_entry[k];
    const uint64_t* src = sh.entry_at[k] < 0
                              ? link0 + k * static_cast<int64_t>(kSlot)
                              : elist + sh.entry_at[k];
    for (int32_t i = lane; i < ne; i += 32) dst[i] = src[i];
    dst += ne;
    const uint64_t* slot =
        slot0 + k * static_cast<int64_t>(kSlot) + sh.skip[k];
    const int32_t ns = sh.n_spec[k] - sh.skip[k];
    for (int32_t i = lane; i < ns; i += 32) dst[i] = slot[i];
    dst += ns;
    const uint64_t* tail = elist + sh.tail_at[k];
    for (int32_t i = lane; i < sh.tail_n[k]; i += 32) dst[i] = tail[i];
  }
  __syncthreads();
  // 4. prune twice, shift, the emission's size
  nc = prune_pass(cl, cl2, nc, n, sh.sums);
  __syncthreads();
  nc = prune_pass(cl2, cl, nc, n, sh.sums);
  __syncthreads();
  const int32_t size = shift_pass(cl, nc, n, sh.sums);
  if (tid == 0) {
    totals[g] = size;
    counts[g] = nc;
  }
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

// one CTA a block: the smaller parse (greedy on a tie) emitted, a copy a
// thread (a scan of the element sizes; each warp copies its copies' gap
// literals), then the tail literal, and the row zero past the emission
__global__ void __launch_bounds__(kParseThreads)
encode_emit_kernel(const uint8_t* __restrict__ block, int64_t pitch,
                   int32_t bmax, const int32_t* __restrict__ n_in,
                   const uint64_t* __restrict__ lists, int32_t cp_max,
                   const int32_t* __restrict__ totals,
                   const int32_t* __restrict__ counts,
                   uint8_t* __restrict__ comp, int32_t emax,
                   int32_t* __restrict__ comp_len, uint8_t* __restrict__ ok) {
  __shared__ int32_t sums[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t b = blockIdx.x;
  const int32_t n = clamp_n(n_in[b], bmax);
  const uint8_t* row = block + b * pitch;
  const int64_t g = 2 * b + (totals[2 * b + 1] < totals[2 * b] ? 1 : 0);
  const int32_t size = totals[g];
  const int32_t nc = counts[g];
  const uint64_t* cl = lists + g * 3 * static_cast<int64_t>(cp_max) + cp_max;
  Out out{comp + b * static_cast<int64_t>(emax), emax};
  int32_t o_base = 0;
  for (int32_t base = 0; base < nc; base += kParseThreads) {
    const int32_t k = base + tid;
    const bool valid = k < nc;
    const Copy c = valid ? unpack(cl[k]) : Copy{0, 0, 0};
    const int32_t prev_end = valid && k > 0 ? end_of(cl[k - 1]) : 0;
    const int32_t a = valid ? c.pos - prev_end : 0;
    const int32_t lsz = lit_cost(a);
    const int32_t sz = valid ? lsz + copy_cost(c.off, c.len) : 0;
    int32_t tot;
    const int32_t at = o_base + cta_scan(sz, sums, &tot);
    int32_t data = at;  // where the gap literal's bytes go
    if (valid) {
      if (a > 0) data += out.lit_header(at, a);
      out.copy_atoms(at + lsz, c.off, c.len);
    }
    for (int j = 0; j < 32; ++j) {
      const int32_t aj = __shfl_sync(kFull, a, j);
      const int32_t sj = __shfl_sync(kFull, prev_end, j);
      const int32_t dj = __shfl_sync(kFull, data, j);
      for (int32_t i = lane; i < aj; i += 32) out.put(dj + i, row[sj + i]);
    }
    o_base += tot;
  }
  const int32_t covered = nc > 0 ? end_of(cl[nc - 1]) : 0;
  const int32_t tail = n - covered;
  if (tail > 0) {
    const int32_t h = 1 + (tail - 1 >= 60) + (tail - 1 >= 256) +
                      (tail - 1 >= 65536);
    if (tid == 0) out.lit_header(o_base, tail);
    for (int32_t i = tid; i < tail; i += kParseThreads)
      out.put(o_base + h + i, row[covered + i]);
  }
  for (int32_t i = (size > 0 ? size : 0) + tid; i < emax; i += kParseThreads)
    out.o[i] = 0;
  if (tid == 0) {
    comp_len[b] = size;
    ok[b] = size <= emax;
  }
}

int cands_smem(int32_t bmax) {
  return static_cast<int>(sizeof(CandShared)) + bmax + 16;
}

int parse_smem(int32_t bmax) {  // the block, the state marks, has
  return static_cast<int>(sizeof(ParseShared)) + bits_at(bmax) +
         8 * (bmax / 32 + 1);
}

// the scratch, carved from one buffer: ord int32 [B, 2, bmax], cands
// uint64 [B, bmax], slots uint64 [B, 2, 2, n_chunks, kSlot], lists uint64
// [B, 2, 3, cp_max], totals and counts int32 [B, 2]
struct Scratch {
  int32_t* ord;
  uint64_t* cands;
  uint64_t* slots;
  uint64_t* lists;
  int32_t* totals;
  int32_t* counts;
};

inline int64_t up16(int64_t bytes) { return (bytes + 15) & ~int64_t{15}; }

inline int64_t carve(void* base, int32_t bmax, int32_t cp_max,
                     int32_t n_rows, Scratch* s) {
  uint8_t* p = static_cast<uint8_t*>(base);
  int64_t at = 0;
  const auto take = [&](int64_t bytes) {
    uint8_t* q = p ? p + at : nullptr;
    at += up16(bytes);
    return q;
  };
  const int64_t rows = n_rows;
  const int64_t n_chunks = (bmax + kChunk - 1) / kChunk;
  s->ord = reinterpret_cast<int32_t*>(take(4 * rows * 2 * bmax));
  s->cands = reinterpret_cast<uint64_t*>(take(8 * rows * bmax));
  s->slots = reinterpret_cast<uint64_t*>(
      take(8 * rows * 2 * 2 * n_chunks * kSlot));
  s->lists = reinterpret_cast<uint64_t*>(take(8 * rows * 2 * 3 * cp_max));
  s->totals = reinterpret_cast<int32_t*>(take(4 * rows * 2));
  s->counts = reinterpret_cast<int32_t*>(take(4 * rows * 2));
  return at;
}

}  // namespace

// bytes of scratch encode_par needs for n_rows blocks of bmax bytes
extern "C" int snc_encode_par_scratch(int32_t bmax, int32_t cp_max,
                                      int32_t n_rows, int64_t* bytes) {
  Scratch s;
  *bytes = carve(nullptr, bmax, cp_max, n_rows, &s);
  return 0;
}

// encode_par.encode_blocks: the candidate pass, the parse (a CTA a block
// and walk kind), the emission (a CTA a block).  scratch:
// snc_encode_par_scratch's bytes, 16-byte aligned.
extern "C" int snc_encode_par(const uint8_t* block, int64_t pitch,
                              int32_t bmax, const int32_t* n, void* scratch,
                              int32_t cp_max, uint8_t* comp, int32_t emax,
                              int32_t* comp_len, uint8_t* ok, int32_t n_rows,
                              void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch s;
  carve(scratch, bmax, cp_max, n_rows, &s);
  const int smem1 = cands_smem(bmax);
  cudaError_t rc = cudaFuncSetAttribute(
      encode_cands_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  encode_cands_kernel<<<kCluster * n_rows, kThreads, smem1, st>>>(
      block, pitch, bmax, n, s.ord, s.cands);
  const int smem2 = parse_smem(bmax);
  rc = cudaFuncSetAttribute(encode_parse_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  encode_parse_kernel<<<2 * n_rows, kParseThreads, smem2, st>>>(
      block, pitch, bmax, n, s.cands, s.slots, s.lists, cp_max, s.totals,
      s.counts);
  encode_emit_kernel<<<n_rows, kParseThreads, 0, st>>>(
      block, pitch, bmax, n, s.lists, cp_max, s.totals, s.counts, comp, emax,
      comp_len, ok);
  return static_cast<int>(cudaGetLastError());
}
