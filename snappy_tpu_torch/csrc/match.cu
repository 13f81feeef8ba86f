// Match-candidate search: a stable radix sort of positions by 4-byte word,
// one CTA per block.
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
// Design: grid of B CTAs of 1,024 threads (32 warps).  The block's bytes sit
// in shared memory; a key is never stored, only recomputed from them (the
// digit of pass k is byte (p + k) mod slots).  Four LSD passes of 8 bits sort
// uint16 positions, ping-ponging between two rows of global scratch (L2
// resident at 128 KiB each): each warp owns a contiguous chunk of slots/32
// elements and keeps its own 256-bin histogram in shared memory; the bins are
// scanned digit-major, warp-minor, which makes the scatter stable; a warp
// ranks equal digits among its 32 lanes with __match_any_sync.  One more pass
// over the sorted order gives each element its predecessor (near, when the
// word is equal) and the head of its run of equal words (first), carried
// across lanes by ballots and across warps by each warp's last head.  The
// packed value goes to out[position] (home) or, beside the position, to
// out[f] and out[slots + f] in sorted order (home=False).
//
// Bound on this card: shared-memory traffic and the dependent warp steps of
// the scatter (slots/32/32 = 64 steps per warp per pass at 64 KiB), and the
// L2 latency of the scratch rows; one CTA per block, BATCH = 64 blocks per
// launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kBins = 256;
constexpr uint32_t kNone16 = 0xFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Shared {
  int32_t hist[kWarps][kBins];  // per-warp digit counts, then offsets
  int32_t base[kBins];          // exclusive scan of the digit totals
  int32_t wsum[kBins / 32];
  int32_t last_head[kWarps];
};

__device__ __forceinline__ uint32_t vword(const uint8_t* blk, uint32_t mask,
                                          uint32_t p) {
  return static_cast<uint32_t>(blk[p]) |
         (static_cast<uint32_t>(blk[(p + 1) & mask]) << 8) |
         (static_cast<uint32_t>(blk[(p + 2) & mask]) << 16) |
         (static_cast<uint32_t>(blk[(p + 3) & mask]) << 24);
}

__global__ void __launch_bounds__(kThreads)
match_kernel(const uint8_t* __restrict__ words,
             const int32_t* __restrict__ npos_in, int32_t slots,
             int32_t home, uint16_t* scratch, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  uint8_t* blk = smem + sizeof(Shared);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const uint32_t mask = static_cast<uint32_t>(slots) - 1u;
  const int32_t npos = npos_in[b];
  const int32_t chunk = slots / kWarps;
  const int32_t f0 = warp * chunk;
  const unsigned lt = (1u << lane) - 1u;

  {
    const uint4* s4 = reinterpret_cast<const uint4*>(words + b * slots);
    uint4* d4 = reinterpret_cast<uint4*>(blk);
    for (int i = tid; i < slots / 16; i += kThreads) d4[i] = s4[i];
  }
  uint16_t* const buf0 = scratch + b * 2 * slots;
  uint16_t* const buf1 = buf0 + slots;
  __syncthreads();

  for (int pass = 0; pass < 4; ++pass) {
    const uint16_t* src = (pass & 1) ? buf0 : buf1;  // pass 0: the identity
    uint16_t* dst = (pass & 1) ? buf1 : buf0;
    for (int d = lane; d < kBins; d += 32) sh.hist[warp][d] = 0;
    __syncwarp();
    for (int32_t f = f0 + lane; f < f0 + chunk; f += 32) {
      const uint32_t p = pass == 0 ? static_cast<uint32_t>(f) : src[f];
      const uint32_t d = blk[(p + pass) & mask];
      const unsigned peers = __match_any_sync(kFull, d);
      if ((peers & lt) == 0) sh.hist[warp][d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    if (tid < kBins) {  // digit-major, warp-minor offsets
      int32_t run = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int32_t c = sh.hist[w][tid];
        sh.hist[w][tid] = run;
        run += c;
      }
      int32_t incl = run;
      for (int s = 1; s < 32; s <<= 1) {
        const int32_t up = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl += up;
      }
      if (lane == 31) sh.wsum[warp] = incl;
      __syncwarp();
      asm volatile("bar.sync 1, %0;" ::"r"(kBins));
      int32_t before = 0;
      for (int w = 0; w < warp; ++w) before += sh.wsum[w];
      sh.base[tid] = before + incl - run;
    }
    __syncthreads();
    for (int32_t f = f0 + lane; f < f0 + chunk; f += 32) {
      const uint32_t p = pass == 0 ? static_cast<uint32_t>(f) : src[f];
      const uint32_t d = blk[(p + pass) & mask];
      const unsigned peers = __match_any_sync(kFull, d);
      const int32_t at = sh.base[d] + sh.hist[warp][d] + __popc(peers & lt);
      dst[at] = static_cast<uint16_t>(p);
      __syncwarp();
      if ((peers & lt) == 0) sh.hist[warp][d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
  }

  const uint16_t* sorted = buf1;  // pass 3 wrote it
  int32_t last = -1;  // this warp's last run head, as a sorted index
  for (int32_t f = f0 + lane; f < f0 + chunk; f += 32) {
    const uint32_t v = vword(blk, mask, sorted[f]);
    const bool head = f == 0 || vword(blk, mask, sorted[f - 1]) != v;
    const unsigned hb = __ballot_sync(kFull, head);
    if (hb) last = f - lane + 31 - __clz(hb);
  }
  if (lane == 0) sh.last_head[warp] = last;
  __syncthreads();

  int32_t carry = lane < warp ? sh.last_head[lane] : -1;
  for (int s = 16; s > 0; s >>= 1)
    carry = max(carry, __shfl_xor_sync(kFull, carry, s));
  int32_t carry_pos = carry >= 0 ? sorted[carry] : 0;
  int32_t* orow = out + b * static_cast<int64_t>(home ? slots : 2 * slots);
  for (int32_t f = f0 + lane; f < f0 + chunk; f += 32) {
    const int32_t p = sorted[f];
    const uint32_t v = vword(blk, mask, p);
    const int32_t prev = f > 0 ? sorted[f - 1] : 0;
    const bool head = f == 0 || vword(blk, mask, prev) != v;
    const unsigned hb = __ballot_sync(kFull, head);
    const unsigned upto = hb & (lt | (1u << lane));
    const int from = upto ? 31 - __clz(upto) : 0;
    const int32_t in_batch = __shfl_sync(kFull, p, from);
    const int32_t head_pos = upto ? in_batch : carry_pos;
    if (hb) carry_pos = __shfl_sync(kFull, p, 31 - __clz(hb));
    uint32_t packed = kNone16 | (kNone16 << 16);
    if (p < npos) {
      const uint32_t near = !head && prev < npos ? prev : kNone16;
      const uint32_t first = !head && head_pos < npos ? head_pos : kNone16;
      packed = near | (first << 16);
    }
    if (home) {
      orow[p] = static_cast<int32_t>(packed);
    } else {
      orow[f] = p;
      orow[slots + f] = static_cast<int32_t>(packed);
    }
  }
}

}  // namespace

extern "C" int snc_match_cands(const uint8_t* words, const int32_t* npos,
                               int32_t slots, int32_t home, uint16_t* scratch,
                               int32_t* out, int32_t n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = static_cast<int>(sizeof(Shared)) + slots;
  cudaError_t rc = cudaFuncSetAttribute(
      match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  match_kernel<<<n_rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      words, npos, slots, home, scratch, out);
  return static_cast<int>(cudaGetLastError());
}
