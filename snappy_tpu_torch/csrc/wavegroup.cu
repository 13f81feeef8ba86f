// Wave-group decode: host-planned groups of up to 8 copies, one CTA per row.
//
// Replaces snappy_tpu/kernels/decode_wavegroup.py:_wg_kernel, which runs a
// group as one 1,280-byte span load, per slot a pair load, a lane select, a
// roll and a masked compose, and one span store: a Mosaic formulation of a
// plain copy.  The contract is decode_wavegroup.decode_blocks_wavegroup_plain:
// slot k of group g copies len <= 128 bytes to out[dst:] from comp[src:] or,
// for a copy piece, from out[src:]; bytes no slot writes are zero.
//
// Design: grid of B CTAs of 256 threads, one warp per slot.  The CTA stages
// the row's compressed bytes in shared memory, zeroes a shared-memory image
// of the output row and writes it out once at the end (rows wider than 96 KiB
// stay in device memory, through the same generic pointers).  The plan words
// come into shared memory 256 groups at a time with 16-byte loads.  In a
// group each lane moves up to 4 bytes of its warp's slot; one __syncthreads()
// ends the group.  That one barrier is enough for plans that keep the
// planner's invariants: a copy piece's source ends at or before the group's
// first destination, so within a group no slot reads a byte that another
// slot writes, and every byte it reads was written by an earlier group.  On
// any other plan the bytes are unspecified, but every access stays inside
// the row: sources past the row read zero, destinations past it are dropped,
// lengths are capped at 128 and the group count at the plan's width.
//
// Bound on this card: the barrier chain, one per group (64-2,000 groups per
// 64 KiB corpus block), at one CTA per row and BATCH = 64 rows per launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 8;
constexpr int kThreads = kSlots * 32;
constexpr int kChunk = 256;       // plan groups staged in shared memory
constexpr int kSmemRow = 98304;   // widest row staged in shared memory
constexpr uint32_t kM17 = (1u << 17) - 1;

__device__ void block_copy(uint8_t* dst, const uint8_t* src, int64_t n,
                           int tid) {
  int64_t i = tid;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15u) == 0) {
    const int64_t n16 = n >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (; i < n16; i += kThreads) d4[i] = s4[i];
    i = (n16 << 4) + tid;
  }
  for (; i < n; i += kThreads) dst[i] = src[i];
}

__device__ void block_zero(uint8_t* dst, int64_t n, int tid) {
  int64_t head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u;
  if (head > n) head = n;
  if (tid < head) dst[tid] = 0;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const int64_t n16 = (n - head) >> 4;
  for (int64_t i = tid; i < n16; i += kThreads)
    d4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = head + (n16 << 4) + tid; i < n; i += kThreads) dst[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
wavegroup_kernel(const uint8_t* __restrict__ comp, int64_t pitch,
                 int32_t cmax, const int32_t* __restrict__ words,
                 int32_t gcap, const int32_t* __restrict__ ngroups,
                 uint8_t* out, int32_t out_max, int32_t smem_comp,
                 int32_t smem_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* wsm = reinterpret_cast<int32_t*>(smem);  // kChunk groups x 16
  uint8_t* csm = smem + kChunk * 16 * sizeof(int32_t);
  uint8_t* osm = csm + smem_comp;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int slot = tid >> 5;
  const int64_t b = blockIdx.x;

  const uint8_t* c = comp + b * pitch;
  if (smem_comp > 0) {
    block_copy(csm, c, cmax, tid);
    c = csm;
  }
  uint8_t* orow = out + b * static_cast<int64_t>(out_max);
  uint8_t* o = smem_out > 0 ? osm : orow;
  block_zero(o, out_max, tid);

  int32_t ng = ngroups[b];
  ng = ng < 0 ? 0 : (ng > gcap ? gcap : ng);
  const int32_t* wrow = words + b * static_cast<int64_t>(gcap) * 16;
  const bool w_aligned = (reinterpret_cast<uintptr_t>(wrow) & 15u) == 0;
  __syncthreads();

  for (int32_t g0 = 0; g0 < ng; g0 += kChunk) {
    const int32_t n = ng - g0 < kChunk ? ng - g0 : kChunk;
    if (w_aligned) {
      const int4* s4 = reinterpret_cast<const int4*>(wrow + g0 * 16);
      int4* d4 = reinterpret_cast<int4*>(wsm);
      for (int i = tid; i < n * 4; i += kThreads) d4[i] = s4[i];
    } else {
      for (int i = tid; i < n * 16; i += kThreads) wsm[i] = wrow[g0 * 16 + i];
    }
    __syncthreads();
    for (int32_t g = 0; g < n; ++g) {
      const uint32_t w1 = static_cast<uint32_t>(wsm[g * 16 + 2 * slot]);
      const uint32_t w2 = static_cast<uint32_t>(wsm[g * 16 + 2 * slot + 1]);
      const int32_t ln = (w2 >> 17) < 128u ? static_cast<int32_t>(w2 >> 17)
                                           : 128;
      const int32_t src = static_cast<int32_t>(w1 & kM17);
      const int32_t dst = static_cast<int32_t>(w2 & kM17);
      const bool from_out = (w1 >> 17) & 1u;
      const uint8_t* sb = from_out ? o : c;
      const int32_t lim = from_out ? out_max : cmax;
      uint8_t v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int32_t j = lane + 32 * t;
        v[t] = (j < ln && src + j < lim) ? sb[src + j] : 0;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int32_t j = lane + 32 * t;
        if (j < ln && dst + j < out_max) o[dst + j] = v[t];
      }
      __syncthreads();
    }
  }
  if (smem_out > 0) block_copy(orow, osm, out_max, tid);
}

int round16(int64_t n) { return static_cast<int>((n + 15) & ~int64_t{15}); }

}  // namespace

extern "C" int snc_wavegroup(const uint8_t* comp, int64_t pitch, int32_t cmax,
                             const int32_t* words, int32_t gcap,
                             const int32_t* ngroups, uint8_t* out,
                             int32_t out_max, int32_t n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const int smem_comp = cmax <= kSmemRow ? round16(cmax) : 0;
  const int smem_out = out_max <= kSmemRow ? round16(out_max) : 0;
  const int smem =
      kChunk * 16 * static_cast<int>(sizeof(int32_t)) + smem_comp + smem_out;
  cudaError_t rc = cudaFuncSetAttribute(
      wavegroup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  wavegroup_kernel<<<n_rows, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      comp, pitch, cmax, words, gcap, ngroups, out, out_max, smem_comp,
      smem_out);
  return static_cast<int>(cudaGetLastError());
}
