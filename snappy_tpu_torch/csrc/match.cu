// Match-candidate search: a stable radix sort of positions by 4-byte word,
// one CTA per block, the whole sort in shared memory and registers.
//
// Replaces snappy_tpu/kernels/pallas_match.py:_match_kernel, which builds the
// v-words with lane and sublane rolls, bitonic-sorts (v, position key) in 136
// compare-exchange substages, finds the run heads with a 16-step segmented
// scan and, for home=True, bitonic-sorts a second time by position.  The
// contract is match.find_candidates_plain, bit for bit in both routes: the
// word at position p is the little-endian word of bytes (p + j) mod slots (the
// JAX kernel's wrap), and the sorted order is (unsigned v, position), which is
// the JAX kernel's (v, position key) order because invalid positions
// (p >= npos) are the highest and already sort last within their word.
//
// What bounds it on this card: the dependent steps of each block's sort, not
// bytes (a 64 KiB block reads 64 KiB and writes 256 KiB).  The design keeps
// every step on chip and fills every SM:
//
// * Shared memory holds the block's bytes (64 KiB), one uint16 buffer of the
//   current order (128 KiB) and the per-warp digit counts (32 KiB): 225 KiB,
//   one CTA of 32 warps an SM, launched sm_count wide
//   (snc_match_blocks_per_sm, kernels/match.resident_rows).  No global
//   scratch (a ping-pong of 2 x 128 KiB a block would spill L2 at this
//   width).
// * Four LSD passes of 8 bits.  A key is never stored: the digit of pass k is
//   byte (p + k) mod slots, so every pass's digits are the block's bytes and
//   the CTA-wide digit totals (the bases of the scatter) are one byte
//   histogram, counted with pass 0's per-warp counts and scanned once.  Only
//   the per-warp offsets depend on the order, and a pass's scatter counts
//   them for the next pass as it places each element (the warp that will
//   own its new index, its next digit): one sweep a pass, not two.  The
//   counts are scanned digit-major, warp-minor; every count and offset
//   fits 16 bits.
// * Each lane holds its slots/1024 positions of the current order in
//   registers (64 at 64 KiB, packed two to a register), so a pass reads the
//   buffer once and scatters into the same buffer: one buffer is enough.  A
//   warp owns slots/32 consecutive sorted indices and walks them 32 at a
//   time; equal digits within a step are ranked with __match_any_sync
//   (stable in lane order) and take their places with one shared atomic of
//   the group's leader, whose old value a shuffle hands to the group.
// * One more walk over the sorted order marks the run heads (equal words
//   compared as funnel-shifted 32-bit loads; a bit per index, and each
//   32-index word's last head, carried across warps).  Each element's
//   predecessor (near, when the word is equal) and run head (first) then
//   come from those in O(1).  home=False writes (position, packed) in
//   sorted order; home=True fills a quarter of the positions at a time in
//   shared memory (the block's bytes are no longer needed) and writes it
//   out whole: scattering 4-byte values to device memory in position order
//   took half the kernel's time on the card (PERF.md).
//
// Measured on the card and not kept (the 256 MiB corpus, kernel-only;
// PERF.md): a counting sweep of its own before each scatter (no
// faster); counting with __match_any_sync leaders instead of shared atomics
// (slower); ranking equal digits with eight ballots instead of
// __match_any_sync (slower); one add of 32 when a step's 32 counts fall on
// one counter (no faster).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kBins = 256;
constexpr int kMaxSlots = 65536;
constexpr int kPer = kMaxSlots / kThreads;  // positions a lane holds at most
constexpr uint32_t kNone16 = 0xFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Shared {
  uint16_t cur[kWarps][kBins];   // this pass's next index, per warp and digit
  uint16_t next[kWarps][kBins];  // the next pass's digit counts, per warp
  int32_t base[kBins];           // exclusive scan of the byte histogram
  int32_t wsum[kBins / 32];
  int32_t last_head[kWarps];
};

// if ok: atomic add of v to the 16-bit counter row[d] (a shared-memory row)
// through its 32-bit word, returning the old value; else 0.  Predicated, so
// a leader's add does not diverge the warp.  No counter carries into its
// neighbour while it is read again.
__device__ __forceinline__ uint32_t add16(bool ok, uint16_t* row, uint32_t d,
                                          uint32_t v) {
  const uint32_t word =
      static_cast<uint32_t>(__cvta_generic_to_shared(row)) + ((d >> 1) << 2);
  const uint32_t shift = (d & 1u) * 16u;
  uint32_t old;
  asm volatile(
      "{ .reg .pred p; setp.ne.u32 p, %1, 0; mov.u32 %0, 0;"
      " @p atom.shared.add.u32 %0, [%2], %3; }"
      : "=r"(old)
      : "r"(static_cast<uint32_t>(ok)), "r"(word), "r"(v << shift)
      : "memory");
  return (old >> shift) & 0xFFFFu;
}

__device__ __forceinline__ uint32_t held(const uint32_t (&pk)[kPer / 2],
                                         int j) {
  return (pk[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
}

__global__ void __launch_bounds__(kThreads, 1)
match_kernel(const uint8_t* __restrict__ words,
             const int32_t* __restrict__ npos_in, int32_t slots,
             int32_t home, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  uint8_t* blk = smem + sizeof(Shared);
  uint16_t* buf = reinterpret_cast<uint16_t*>(blk + slots);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const uint32_t mask = static_cast<uint32_t>(slots) - 1u;
  const int32_t npos = npos_in[b];
  const int per = slots / kThreads;
  const int32_t chunk = slots / kWarps;
  const int32_t f0 = warp * chunk;
  const unsigned lt = (1u << lane) - 1u;

  {
    const uint4* s4 = reinterpret_cast<const uint4*>(words + b * slots);
    uint4* d4 = reinterpret_cast<uint4*>(blk);
    for (int i = tid; i < slots / 16; i += kThreads) d4[i] = s4[i];
  }
  uint32_t pk[kPer / 2];  // this lane's positions, sorted index f0 + lane + 32j
#pragma unroll
  for (int j = 0; j < kPer; j += 2)
    pk[j >> 1] = static_cast<uint32_t>(f0 + lane + 32 * j) |
                 (static_cast<uint32_t>(f0 + lane + 32 * (j + 1)) << 16);
  for (int d = lane; d < kBins; d += 32) sh.next[warp][d] = 0;
  const int chunk_bits = 31 - __clz(chunk);
  __syncthreads();
  for (int32_t f = f0 + lane; f < f0 + chunk; f += 32)  // pass 0's counts
    add16(true, sh.next[warp], blk[f], 1u);
  __syncthreads();

  for (int pass = 0; pass < 4; ++pass) {
    if (pass > 0) {  // the order the last pass scattered
#pragma unroll
      for (int j = 0; j < kPer; j += 2)
        if (j < per)
          pk[j >> 1] = static_cast<uint32_t>(buf[f0 + lane + 32 * j]) |
                       (static_cast<uint32_t>(buf[f0 + lane + 32 * (j + 1)])
                        << 16);
    }
    if (tid < kBins) {  // digit-major, warp-minor start offsets
      if (pass == 0) {  // the counts add up to the byte histogram: scan it
        int32_t total = 0;
        for (int w = 0; w < kWarps; ++w) total += sh.next[w][tid];
        int32_t incl = total;
        for (int s = 1; s < 32; s <<= 1) {
          const int32_t up = __shfl_up_sync(kFull, incl, s);
          if (lane >= s) incl += up;
        }
        if (lane == 31) sh.wsum[warp] = incl;
        __syncwarp();
        asm volatile("bar.sync 1, %0;" ::"r"(kBins));
        int32_t before = 0;
        for (int w = 0; w < warp; ++w) before += sh.wsum[w];
        sh.base[tid] = before + incl - total;
      }
      uint32_t run = static_cast<uint32_t>(sh.base[tid]);
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t c = sh.next[w][tid];
        sh.next[w][tid] = 0;
        sh.cur[w][tid] = static_cast<uint16_t>(run);
        run += c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j < per) {
        const uint32_t p = held(pk, j);
        const uint32_t d = blk[(p + pass) & mask];
        const unsigned peers = __match_any_sync(kFull, d);
        const int leader = __ffs(peers) - 1;
        uint32_t at = add16(lane == leader, sh.cur[warp], d, __popc(peers));
        at = __shfl_sync(kFull, at, leader) + __popc(peers & lt);
        buf[at] = static_cast<uint16_t>(p);
        if (pass < 3)
          add16(true, sh.next[at >> chunk_bits], blk[(p + pass + 1) & mask],
                1u);
      }
    }
    __syncthreads();
  }

  // the run heads of the sorted order: a bit an index (flags), and for every
  // word of 32 indices the last head at or before its end (last), kept
  // where the counters were
  uint32_t* flags = reinterpret_cast<uint32_t*>(&sh.cur[0][0]);
  int32_t* last = reinterpret_cast<int32_t*>(&sh.next[0][0]);
  const uint32_t* blk32 = reinterpret_cast<const uint32_t*>(blk);
  const uint32_t wmask = mask >> 2;
  const auto vword = [&](uint32_t p) {
    const uint32_t i = p >> 2;
    return __funnelshift_r(blk32[i], blk32[(i + 1) & wmask], (p & 3u) * 8u);
  };
  uint32_t vprev = f0 > 0 ? vword(buf[f0 - 1]) : 0u;
  int32_t run = -1;  // this warp's last head so far
  for (int32_t f = f0 + lane; f < f0 + chunk; f += 32) {
    const uint32_t v = vword(buf[f]);
    uint32_t before = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) before = vprev;
    const unsigned hb = __ballot_sync(kFull, f == 0 || before != v);
    if (hb) run = f - lane + 31 - __clz(hb);
    if (lane == 0) {
      flags[f >> 5] = hb;
      last[f >> 5] = run;
    }
    vprev = __shfl_sync(kFull, v, 31);
  }
  if (lane == 0) sh.last_head[warp] = run;
  __syncthreads();
  // a run that began in an earlier warp's indices
  int32_t carry = lane < warp ? sh.last_head[lane] : -1;
  for (int s = 16; s > 0; s >>= 1)
    carry = max(carry, __shfl_xor_sync(kFull, carry, s));
  for (int i = lane; i < per; i += 32)
    if (last[(f0 >> 5) + i] < 0) last[(f0 >> 5) + i] = carry;
  __syncthreads();

  // the packed candidates of sorted index f, position p
  const auto packed_at = [&](int32_t f, uint32_t p) -> uint32_t {
    if (p >= static_cast<uint32_t>(npos)) return kNone16 | (kNone16 << 16);
    const uint32_t word = flags[f >> 5];
    if ((word >> (f & 31)) & 1u) return kNone16 | (kNone16 << 16);  // a head
    const uint32_t upto = word & (0xFFFFFFFFu >> (31 - (f & 31)));
    const int32_t h =
        upto ? (f & ~31) + 31 - __clz(upto) : last[(f >> 5) - 1];
    const uint32_t prev = buf[f - 1];
    const uint32_t head_pos = buf[h];
    const uint32_t near = prev < static_cast<uint32_t>(npos) ? prev : kNone16;
    const uint32_t first =
        head_pos < static_cast<uint32_t>(npos) ? head_pos : kNone16;
    return near | (first << 16);
  };

  int32_t* orow = out + b * static_cast<int64_t>(home ? slots : 2 * slots);
  if (!home) {
    for (int32_t f = tid; f < slots; f += kThreads) {
      const uint32_t p = buf[f];
      orow[f] = static_cast<int32_t>(p);
      orow[slots + f] = static_cast<int32_t>(packed_at(f, p));
    }
    return;
  }
  // home: a quarter of the positions at a time, placed in shared memory
  // where the block's bytes were, then written out whole (coalesced)
  int32_t* stage = reinterpret_cast<int32_t*>(blk);
  const uint32_t quarter = static_cast<uint32_t>(slots) / 4u;
  for (uint32_t lo = 0; lo < static_cast<uint32_t>(slots); lo += quarter) {
    for (int32_t f = tid; f < slots; f += kThreads) {
      const uint32_t p = buf[f];
      if (p - lo < quarter)
        stage[p - lo] = static_cast<int32_t>(packed_at(f, p));
    }
    __syncthreads();
    const uint4* s4 = reinterpret_cast<const uint4*>(stage);
    uint4* d4 = reinterpret_cast<uint4*>(orow + lo);
    for (uint32_t i = tid; i < quarter / 4u; i += kThreads) d4[i] = s4[i];
    __syncthreads();
  }
}

int smem_bytes(int32_t slots) {
  return static_cast<int>(sizeof(Shared)) + 3 * slots;  // bytes + uint16 order
}

cudaError_t prepare(int smem) {
  return cudaFuncSetAttribute(
      match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" int snc_match_cands(const uint8_t* words, const int32_t* npos,
                               int32_t slots, int32_t home, int32_t* out,
                               int32_t n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (slots > kMaxSlots || slots % kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(slots);
  cudaError_t rc = prepare(smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  match_kernel<<<n_rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      words, npos, slots, home, out);
  return static_cast<int>(cudaGetLastError());
}

// blocks of the kernel one SM holds at once for blocks of `slots` bytes
extern "C" int snc_match_blocks_per_sm(int32_t slots, int* blocks) {
  const int smem = smem_bytes(slots);
  cudaError_t rc = prepare(smem);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, match_kernel,
                                                       kThreads, smem);
  return static_cast<int>(rc);
}
