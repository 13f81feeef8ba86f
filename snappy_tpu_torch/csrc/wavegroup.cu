// Wave-group decode: host-planned groups of up to 8 copies, one warp per row.
//
// Replaces snappy_tpu/kernels/decode_wavegroup.py:_wg_kernel, which runs a
// group as one 1,280-byte span load, per slot a pair load, a lane select, a
// roll and a masked compose, and one span store: a Mosaic formulation of a
// plain copy.  The contract is decode_wavegroup.decode_blocks_wavegroup_plain:
// slot k of group g copies len <= 128 bytes to out[dst:] from comp[src:] or,
// for a copy piece, from out[src:]; bytes no slot writes are zero.
//
// What bounds it on this card: the chain of groups of each row (up to 2,000
// groups per 64 KiB corpus block), not bytes: a row is a dependent chain of
// groups, and a group's step is a few dozen instructions.  The design keeps
// the step short and as many chains in flight as the card holds:
//
// * One warp runs a row: a CTA of 32 threads, a group a step, __syncwarp()
//   between groups (it orders device memory among the lanes).  That is
//   enough for plans that keep the planner's invariants: a copy piece's
//   source ends at or before the group's first destination, so within a
//   group no slot reads a byte that another slot writes, and every byte it
//   reads was written by an earlier group.
// * Lanes 4k .. 4k + 3 run slot k: lane q moves bytes q, q + 4, ... of it,
//   all its loads before its stores, as predicated PTX (no lane diverges),
//   unrolled for the group's longest slot rounded up to 16, 32, 64 or 128
//   bytes.  A lane needs only its own slot's two plan words (two shuffles).
// * The plan words come eight groups to four 128-byte warp loads, the next
//   eight loaded before the current ones run.  The compressed row is read
//   through L1, never staged.
// * The row is built where it lies in device memory (zeroed first); copy
//   sources are read back with plain loads (never .nc: this kernel wrote
//   them).  No shared memory, at most 64 registers a thread: 32 CTAs an SM,
//   so a launch of sm_count x 32 rows (kernels/decode_wavegroup.
//   resident_rows) holds 4,224 chains on 132 SMs.  A 64 KiB shared-memory
//   image of the row ran each chain no faster on the card and held three
//   rows an SM (PERF.md).  Also measured and not kept: every lane
//   moving bytes of all eight slots (16 shuffles and 64 predicated accesses
//   a group: a row's chain 1.9x as long as a quad a slot), a C++ `if`
//   around each access (a branch and a reconvergence each: 3.7x as long as
//   predicated PTX), and L1 prefetches of comp lines ahead of the literal
//   slots (slower).
//
// On plans that break the invariants the bytes are unspecified, but every
// access stays inside the row: sources past the row read zero, destinations
// past it are dropped, lengths are capped at 128 and the group count at the
// plan's width.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCtasPerSm = 32;  // the most one-warp CTAs an SM holds
constexpr uint32_t kM17 = (1u << 17) - 1;
constexpr unsigned kFull = 0xFFFFFFFFu;

// *a if ok, else 0 (generic address: the device row or the comp row)
__device__ __forceinline__ uint32_t load_if(bool ok, const uint8_t* a) {
  uint32_t v;
  asm volatile(
      "{ .reg .pred p; setp.ne.u32 p, %1, 0; mov.u32 %0, 0;"
      " @p ld.u8 %0, [%2]; }"
      : "=r"(v)
      : "r"(static_cast<uint32_t>(ok)), "l"(a)
      : "memory");
  return v;
}

__device__ __forceinline__ void store_if(bool ok, uint8_t* a, uint32_t v) {
  asm volatile(
      "{ .reg .pred p; setp.ne.u32 p, %0, 0; @p st.u8 [%1], %2; }" ::"r"(
          static_cast<uint32_t>(ok)),
      "l"(a), "r"(v)
      : "memory");
}

// this lane's bytes q + 4i (i < N) of its slot: nl of them readable from
// sp - q, ns writable at dp - q
template <int N>
__device__ __forceinline__ void move(const uint8_t* sp, uint8_t* dp,
                                     int32_t nl, int32_t ns, int q) {
  uint32_t v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = load_if(q + 4 * i < nl, sp + 4 * i);
#pragma unroll
  for (int i = 0; i < N; ++i) store_if(q + 4 * i < ns, dp + 4 * i, v[i]);
}

__device__ void warp_zero(uint8_t* dst, int64_t n, int lane) {
  int64_t head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u;
  if (head > n) head = n;
  if (lane < head) dst[lane] = 0;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const int64_t n16 = (n - head) >> 4;
  for (int64_t i = lane; i < n16; i += 32) d4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = head + (n16 << 4) + lane; i < n; i += 32) dst[i] = 0;
}

__global__ void __launch_bounds__(32, kCtasPerSm)
wavegroup_kernel(const uint8_t* __restrict__ comp, int64_t pitch,
                 int32_t cmax, const int32_t* __restrict__ words,
                 int32_t gcap, const int32_t* __restrict__ ngroups,
                 uint8_t* out, int32_t out_max) {
  const int lane = threadIdx.x;
  const int k = lane >> 2;  // this lane's slot
  const int q = lane & 3;
  const int64_t b = blockIdx.x;
  const uint8_t* c = comp + b * pitch;
  uint8_t* o = out + b * static_cast<int64_t>(out_max);
  warp_zero(o, out_max, lane);

  int32_t ng = ngroups[b];
  ng = ng < 0 ? 0 : (ng > gcap ? gcap : ng);
  const int32_t* wrow = words + b * static_cast<int64_t>(gcap) * 16;
  // words of groups g .. g + 7: lane l holds word l of pair i in ci
  const auto load8 = [&](int32_t g, int pair) -> int32_t {
    return g + 2 * pair + (lane >> 4) < ng ? wrow[(g + 2 * pair) * 16 + lane]
                                           : 0;
  };
  int32_t c0 = load8(0, 0), c1 = load8(0, 1), c2 = load8(0, 2),
          c3 = load8(0, 3);
  __syncwarp();

  for (int32_t g = 0; g < ng; g += 8) {
    const int32_t n0 = load8(g + 8, 0), n1 = load8(g + 8, 1),
                  n2 = load8(g + 8, 2), n3 = load8(g + 8, 3);
    const int cnt = ng - g < 8 ? ng - g : 8;
    for (int h = 0; h < cnt; ++h) {
      const int32_t cw = h < 2 ? c0 : (h < 4 ? c1 : (h < 6 ? c2 : c3));
      const int at = 16 * (h & 1) + 2 * k;
      const uint32_t w1 = static_cast<uint32_t>(__shfl_sync(kFull, cw, at));
      const uint32_t w2 =
          static_cast<uint32_t>(__shfl_sync(kFull, cw, at + 1));
      const int32_t ln = (w2 >> 17) < 128u ? static_cast<int32_t>(w2 >> 17)
                                           : 128;
      const int32_t dst = static_cast<int32_t>(w2 & kM17);
      const int32_t src = static_cast<int32_t>(w1 & kM17);
      const bool from_out = (w1 >> 17) & 1u;
      const int32_t room = (from_out ? out_max : cmax) - src;
      const int32_t nl = ln < room ? ln : room;
      const int32_t ns = ln < out_max - dst ? ln : out_max - dst;
      const uint8_t* sp = (from_out ? o : c) + src + q;
      uint8_t* dp = o + dst + q;
      const unsigned longest =
          __reduce_max_sync(kFull, static_cast<unsigned>(ln));
      if (longest <= 16)
        move<4>(sp, dp, nl, ns, q);
      else if (longest <= 32)
        move<8>(sp, dp, nl, ns, q);
      else if (longest <= 64)
        move<16>(sp, dp, nl, ns, q);
      else
        move<32>(sp, dp, nl, ns, q);
      __syncwarp();
    }
    c0 = n0;
    c1 = n1;
    c2 = n2;
    c3 = n3;
  }
}

}  // namespace

extern "C" int snc_wavegroup(const uint8_t* comp, int64_t pitch, int32_t cmax,
                             const int32_t* words, int32_t gcap,
                             const int32_t* ngroups, uint8_t* out,
                             int32_t out_max, int32_t n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  wavegroup_kernel<<<n_rows, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      comp, pitch, cmax, words, gcap, ngroups, out, out_max);
  return static_cast<int>(cudaGetLastError());
}

// blocks (rows) of the kernel one SM holds at once; rows of any width
// (out_max) are built in device memory, so it does not change the count
extern "C" int snc_wavegroup_blocks_per_sm(int32_t out_max, int* blocks) {
  (void)out_max;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wavegroup_kernel, 32, 0));
}
