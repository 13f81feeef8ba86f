// Sequential per-block Snappy encode: a matcher warp and an emitter warp
// per block, the reference greedy hash-table matcher, emission
// byte-identical to snappy_tpu/spec/reference.py:encode_block.
//
// Replaces snappy_tpu/kernels/pallas_encode.py:_kernel (and its state
// machine _step), the Pallas encoder that keeps two blocks' state in SMEM
// scratch, bytes as int32 [rows, 128] tiles, and reads and writes its hash
// table through rolls and lane masks.  Here a CTA owns one block: the
// block (<= 64 KiB) and its hash table (uint16 positions, since positions
// are < 65536) live in shared memory, 96 KiB per CTA with a 64 KiB block.
//
// What bounds it on this card: the serial chain of the matcher, not bytes
// (64 KiB in, at most ~76 KB out, per ~10^4 probes and copies).  Shared
// memory holds two CTAs an SM.  The design shortens the chain and fills
// the card:
//
// * Matcher (warp 0).  It runs the reference's PROBE / MATCH control flow
//   warp-uniformly and hands each literal run and each copy on as a record
//   (start or offset, length, kind) through a ring of 4 slots of 32
//   records, handed over with named barriers (bar.arrive / bar.sync).
//   Emission, about a third of the chain when the matcher wrote the bytes
//   itself, leaves it.  Every lane reads a table slot (a broadcast) and
//   writes it with the same value, so one __syncwarp() per table access
//   orders it, with no shuffle.  Words are two aligned 32-bit shared loads
//   and __funnelshift_r.  Match extension compares 32 bytes a step, one a
//   lane: most matches end in the first step, and a 128-byte step of
//   words, whose mismatch takes a second shuffle and bit scan to place,
//   measured slower over the whole kernel.
// * Emitter (warp 1).  It executes the records in order into the output
//   row: tag bytes by separate lanes, literal bodies and the 64-byte chops
//   of long copies lane-parallel.  It runs beside the matcher on another
//   scheduler of the SM.
// * Residency.  Two CTAs of two warps fit an SM; the runtime launches at
//   least sm_count x snc_seq_encode_blocks_per_sm rows
//   (kernels/encode_seq.resident_rows), so every SM holds two.
//
// The skip loop's probes depend on the table only through a hit, so they
// can run 32 at a time, one a lane, committing the table writes up to the
// first hit.  Built and measured on the H100, that batch lost: most PROBE
// phases end at their first or second probe, so a batch's vote,
// match_any and commit cost more than the serial probes it saved
// (PERF.md, PR 5).  The probes stay serial.
//
// At the end the CTA zero-fills the row past the element, so every byte of
// the output is written by the kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 65536;
constexpr int kMaxTable = 1 << 14;
constexpr int kInputMargin = 15;
constexpr int kMinNonLiteral = 1 + 2 + kInputMargin;
constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr int kErrLen = 1;
constexpr int kPad = 16;      // zero bytes past the block for word loads
constexpr int kSlots = 4;     // record ring
constexpr int kRecs = 32;     // records a slot
constexpr int kThreads = 64;  // warp 0 matches, warp 1 emits
constexpr unsigned kFull = 0xFFFFFFFFu;

// named barriers: FULL(k) = 1 + k, EMPTY(k) = 1 + kSlots + k
constexpr int kBarFull = 1;
constexpr int kBarEmpty = 1 + kSlots;

struct Slot {
  int2 rec[kRecs];  // (literal start or copy offset, length << 1 | is_copy)
  int count;
  int last;  // the matcher's final slot
  int pad[2];
};

struct Shared {
  Slot ring[kSlots];
  int32_t o;  // the element's length, from the emitter
  int32_t pad[3];
};

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

// little-endian 4 bytes at p[i]; p is 4-byte aligned
__device__ __forceinline__ uint32_t load32(const uint8_t* p, int i) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
  return __funnelshift_r(w[i >> 2], w[(i >> 2) + 1], (i & 3) * 8);
}

__device__ __forceinline__ uint32_t hash32(uint32_t u, int shift) {
  return (u * kHashMul) >> shift;
}

// first j >= s with j == n or src[i + (j - s)] != src[j]
__device__ __forceinline__ int extend_match(const uint8_t* src, int i, int s,
                                            int n, int lane) {
  while (true) {
    const int k = s + lane;
    const bool stop = k >= n || src[i + lane] != src[k];
    const unsigned m = __ballot_sync(kFull, stop);
    if (m) return s + __ffs(m) - 1;
    i += 32;
    s += 32;
  }
}

// the matcher's side of the ring
struct Ring {
  Shared* sh;
  int slot;  // slots handed over so far
  int n;     // records in the current slot
  int lane;

  __device__ void put(int a, int len, int is_copy) {
    if (n == 0 && slot >= kSlots) bar_sync(kBarEmpty + slot % kSlots);
    if (lane == 0)
      sh->ring[slot % kSlots].rec[n] = make_int2(a, (len << 1) | is_copy);
    if (++n == kRecs) hand_over(false);
  }

  __device__ void hand_over(bool last) {
    if (n == 0 && slot >= kSlots) bar_sync(kBarEmpty + slot % kSlots);
    if (lane == 0) {
      sh->ring[slot % kSlots].count = n;
      sh->ring[slot % kSlots].last = last;
    }
    __syncwarp();
    __threadfence_block();
    bar_arrive(kBarFull + slot % kSlots);
    ++slot;
    n = 0;
  }

  // the last slot; then take back the emitter's arrivals on the slots not
  // yet refilled
  __device__ void finish() {
    hand_over(true);
    for (int j = slot - kSlots; j < slot - 1; ++j)
      if (j >= 0) bar_sync(kBarEmpty + j % kSlots);
  }
};

// warp 0: the reference encode_block of src[0, n), n >= kMinNonLiteral, as
// records
__device__ void matcher(Ring& rg, const uint8_t* src, int n, uint16_t* table,
                        int lane) {
  int shift = 24;
  int size = 256;
  while (size < kMaxTable && size < n) {
    --shift;
    size <<= 1;
  }
  uint32_t* t32 = reinterpret_cast<uint32_t*>(table);
  for (int i = lane; i < size / 2; i += 32) t32[i] = 0u;
  __syncwarp();

  const int s_limit = n - kInputMargin;
  int next_emit = 0;
  int s = 1;
  uint32_t next_hash = hash32(load32(src, s), shift);
  while (true) {
    // PROBE: the skip loop
    int skip = 32;
    int next_s = s;
    int cand;
    while (true) {
      s = next_s;
      const int bytes_between = skip >> 5;
      next_s = s + bytes_between;
      skip += bytes_between;
      if (next_s > s_limit) {
        if (next_emit < n) rg.put(next_emit, n - next_emit, 0);
        return;
      }
      cand = table[next_hash];
      __syncwarp();
      table[next_hash] = static_cast<uint16_t>(s);
      next_hash = hash32(load32(src, next_s), shift);
      if (load32(src, s) == load32(src, cand)) break;
    }
    rg.put(next_emit, s - next_emit, 0);
    // MATCH: extend, hand the copy on, double insert
    while (true) {
      const int base = s;
      s = extend_match(src, cand + 4, base + 4, n, lane);
      rg.put(base - cand, s - base, 1);
      next_emit = s;
      if (s >= s_limit) {
        if (next_emit < n) rg.put(next_emit, n - next_emit, 0);
        return;
      }
      const uint32_t x_prev = load32(src, s - 1);
      const uint32_t x_cur = load32(src, s);
      const uint32_t h1 = hash32(x_prev, shift);
      const uint32_t h2 = hash32(x_cur, shift);
      const int t2 = table[h2];
      cand = h1 == h2 ? s - 1 : t2;
      __syncwarp();
      table[h1] = static_cast<uint16_t>(s - 1);
      table[h2] = static_cast<uint16_t>(s);
      if (x_cur != load32(src, cand)) {
        next_hash = hash32(load32(src, s + 1), shift);
        s += 1;
        break;
      }
    }
  }
}

__device__ int emit_literal(uint8_t* out, int o, const uint8_t* src,
                            int start, int len, int lane) {
  const int m = len - 1;
  const int nt = m < 60 ? 1 : (m < 256 ? 2 : 3);
  // blocks are <= 64 KiB, so m < 65536
  if (lane < nt) {
    const int v = lane == 0 ? (m < 60 ? m << 2 : (nt == 2 ? 60 << 2 : 61 << 2))
                            : (lane == 1 ? (m & 0xFF) : (m >> 8));
    out[o + lane] = static_cast<uint8_t>(v);
  }
  o += nt;
  for (int i = lane; i < len; i += 32) out[o + i] = src[start + i];
  return o + len;
}

// spec/reference.py:emit_copy (pallas_encode.py:_emit_copy l.116-156)
__device__ int emit_copy(uint8_t* out, int o, int offset, int length,
                         int lane) {
  const uint8_t lo = static_cast<uint8_t>(offset & 0xFF);
  const uint8_t hi = static_cast<uint8_t>((offset >> 8) & 0xFF);
  const int n68 = length >= 68 ? (length - 68) / 64 + 1 : 0;
  for (int k = lane; k < 3 * n68; k += 32) {
    const int r = k % 3;
    out[o + k] = r == 0 ? static_cast<uint8_t>((63 << 2) | 2) : (r == 1 ? lo : hi);
  }
  o += 3 * n68;
  length -= 64 * n68;
  if (length > 64) {
    if (lane < 3) out[o + lane] = lane == 0 ? static_cast<uint8_t>((59 << 2) | 2)
                                            : (lane == 1 ? lo : hi);
    o += 3;
    length -= 60;
  }
  if (length >= 12 || offset >= 2048) {
    if (lane < 3)
      out[o + lane] = lane == 0 ? static_cast<uint8_t>(((length - 1) << 2) | 2)
                                : (lane == 1 ? lo : hi);
    return o + 3;
  }
  if (lane < 2)
    out[o + lane] =
        lane == 0 ? static_cast<uint8_t>(((offset >> 8) << 5) |
                                         ((length - 4) << 2) | 1)
                  : lo;
  return o + 2;
}

// warp 1: execute the records in order into out; returns the length
__device__ int emitter(Shared* sh, uint8_t* out, const uint8_t* src,
                       int lane) {
  int o = 0;
  for (int slot = 0;; ++slot) {
    const Slot* sl = &sh->ring[slot % kSlots];
    bar_sync(kBarFull + slot % kSlots);
    const int cnt = sl->count;
    const bool last = sl->last;
    for (int r = 0; r < cnt; ++r) {
      const int2 rec = sl->rec[r];
      const int len = rec.y >> 1;
      o = (rec.y & 1) ? emit_copy(out, o, rec.x, len, lane)
                      : emit_literal(out, o, src, rec.x, len, lane);
    }
    if (last) return o;
    __syncwarp();
    bar_arrive(kBarEmpty + slot % kSlots);
  }
}

__device__ void warp_copy(uint8_t* dst, const uint8_t* src, int64_t n,
                          int t, int nt) {
  int64_t i = t;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15u) == 0) {
    const int64_t n16 = n >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (; i < n16; i += nt) d4[i] = s4[i];
    i = (n16 << 4) + t;
  }
  for (; i < n; i += nt) dst[i] = src[i];
}

__device__ void zero_bytes(uint8_t* dst, int64_t n, int t, int nt) {
  int64_t head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u;
  if (head > n) head = n;
  if (t < head) dst[t] = 0;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const int64_t n16 = (n - head) >> 4;
  for (int64_t i = t; i < n16; i += nt) d4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = head + (n16 << 4) + t; i < n; i += nt) dst[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
seq_encode_kernel(const uint8_t* __restrict__ blocks, int64_t pitch,
                  int32_t bmax, const int32_t* __restrict__ lens,
                  uint8_t* __restrict__ comp, int32_t cap,
                  int32_t* __restrict__ clens, int32_t* __restrict__ err,
                  int32_t src_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  Shared* sh = reinterpret_cast<Shared*>(smem);
  uint8_t* src = smem + sizeof(Shared);
  uint16_t* table = reinterpret_cast<uint16_t*>(src + src_bytes);
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int64_t b = blockIdx.x;
  const int32_t n = lens[b];
  uint8_t* out = comp + b * static_cast<int64_t>(cap);
  const bool ok = n >= 0 && n <= bmax && n <= kMaxBlock;

  if (ok) {
    warp_copy(src, blocks + b * pitch, n, t, kThreads);
    if (t < kPad) src[n + t] = 0;
  }
  __syncthreads();
  if (warp == 0) {
    Ring rg{sh, 0, 0, lane};
    if (ok && n >= kMinNonLiteral)
      matcher(rg, src, n, table, lane);
    else if (ok && n > 0)
      rg.put(0, n, 0);
    rg.finish();
  } else {
    const int o = emitter(sh, out, src, lane);
    if (lane == 0) sh->o = o;
  }
  __syncthreads();
  const int o = sh->o;
  zero_bytes(out + o, cap - o, t, kThreads);
  if (t == 0) {
    clens[b] = o;
    err[b] = ok ? 0 : kErrLen;
  }
}

int smem_layout(int32_t bmax, int* src_bytes) {
  const int span = bmax < kMaxBlock ? bmax : kMaxBlock;
  int table = 256;
  while (table < kMaxTable && table < span) table <<= 1;
  *src_bytes = ((span + 15) & ~15) + kPad;
  return static_cast<int>(sizeof(Shared)) + *src_bytes + 2 * table;
}

}  // namespace

extern "C" int snc_seq_encode(const uint8_t* blocks, int64_t pitch,
                              int32_t bmax, const int32_t* lens,
                              uint8_t* comp, int32_t cap, int32_t* clens,
                              int32_t* err, int32_t n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  int src_bytes;
  const int smem = smem_layout(bmax, &src_bytes);
  cudaError_t rc = cudaFuncSetAttribute(
      seq_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  seq_encode_kernel<<<n_rows, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      blocks, pitch, bmax, lens, comp, cap, clens, err, src_bytes);
  return static_cast<int>(cudaGetLastError());
}

// blocks of the kernel one SM holds at once for rows of bmax bytes
extern "C" int snc_seq_encode_blocks_per_sm(int32_t bmax, int* blocks) {
  int src_bytes;
  const int smem = smem_layout(bmax, &src_bytes);
  cudaError_t rc = cudaFuncSetAttribute(
      seq_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks,
                                                       seq_encode_kernel,
                                                       kThreads, smem);
  return static_cast<int>(rc);
}
