// CRC-32C of batched chunk rows: a cluster of kCluster CTAs per row.
//
// Replaces snappy_tpu/kernels/crc32c_jnp.py:crc32c_chunks, the XLA
// GF(2)-matmul CRC that carries the framed main path on the TPU (every
// chunk's checksum on decode and on encode).
//
// Design.  Row b's first len = lengths[b] bytes are the start of a
// virtual 65,536-byte row whose other bytes are zero.  CRC-32C is affine
// with its init equal to its final xor, so crc(data) = raw(data) ^
// crc(len zero bytes), raw being the register-0 CRC with no final xor;
// the zero bytes after the data multiply the raw CRC by x^(8 (65536 -
// len)) mod P, so raw(data) = raw(virtual row) * x^(-8 (65536 - len)).
// Both terms of len are loads from 65,537-entry tables, once per row.
//
// Thread t of CTA r of the row's cluster (2 CTAs of 256 threads) owns the
// virtual bytes [kSeg s, kSeg (s + 1)), s = kThreads r + t, 128 of them:
// a segment starts at a 16-byte address whenever the row does, whatever
// len.  A thread whose segment is all real bytes at a 16-byte address
// loads it whole before the table is built (each 32-byte sector by two
// back-to-back 16-byte loads), runs it as kChains interleaved chains of
// kSub bytes and joins them with a constant shift of kSub bytes; the
// segment holding the row's end (or any segment of a row at an
// unaligned base) runs head bytes, 16-byte words and tail bytes in one
// chain.  A thread then moves its raw CRC over the 65,536 - p1 virtual
// bytes after its last real byte p1 - 1 with one GF(2) product by
// x^(8 (65536 - p1)) mod P, read from a table: for a whole segment a
// constant of the segment, not of len.  The shifted CRCs combine by xor:
// warp shuffles, the CTA's warps in shared memory, and each CTA's value
// stored into CTA 0's shared memory across the cluster before one
// cluster barrier; CTA 0 applies the row's two terms and writes out[b].
//
// Bound on this card: device-memory reads (each byte read once), and at
// the seq engine's 396 rows the instructions of the table steps (about
// five a byte).  The lookups are data dependent, so a shared 1 KiB table
// would serve a warp's 32 lookups in ~3.5 bank passes; each CTA computes
// the table and keeps it once per bank (entry e for lane l at word
// 32 e + l, 32 KiB), so every lookup of a warp is one pass.  A chain step
// waits on its lookup; the interleaved chains hide part of that.  Two
// CTAs a row fill 128 SMs at the id engine's 64 rows.  Bytes at or past
// lengths[b] are never read: staging rows past a chunk's end may hold
// anything.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 2;                        // CTAs per row
constexpr int kThreads = 256;                      // segments per CTA
constexpr int kRow = 65536;                        // virtual row
constexpr int kSeg = kRow / (kCluster * kThreads); // bytes per segment
constexpr int kChains = 2;                         // chains per segment
constexpr int kSub = kSeg / kChains;               // bytes per chain
constexpr int kMinBlocks = 4;                      // CTAs an SM
constexpr uint32_t kPoly = 0x82F63B78u;            // reflected CRC-32C

static_assert(kSub % 16 == 0, "whole 16-byte loads per chain");

__host__ __device__ constexpr uint32_t table_entry(uint32_t c) {
  for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
  return c;
}

// x^(8 n) mod P, reflected: x^0 through n zero bytes
__host__ __device__ constexpr uint32_t zero_bytes_shift(int n) {
  uint32_t e = 0x80000000u;
  for (int k = 0; k < n; ++k) e = table_entry(e & 0xFFu) ^ (e >> 8);
  return e;
}

constexpr uint32_t kChainShift = zero_bytes_shift(kSub);

// a * b mod P, reflected (bit 31 is x^0); with b a constant the
// compiler folds b's sequence into immediates
__device__ __forceinline__ uint32_t gf2_mul(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    p ^= b & (0u - ((a >> i) & 1u));
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

// one byte through the lane's copy of the table
__device__ __forceinline__ uint32_t step(const uint32_t* tab, int lane,
                                         uint32_t c, uint32_t byte) {
  return tab[(((c ^ byte) & 0xFFu) << 5) | lane] ^ (c >> 8);
}

__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kThreads, kMinBlocks)
crc32c_rows_kernel(const uint8_t* __restrict__ rows, int64_t pitch,
                   int width, const int32_t* __restrict__ lengths,
                   const uint32_t* __restrict__ zshift,
                   const uint32_t* __restrict__ unshift,
                   const uint32_t* __restrict__ zero_crc,
                   int64_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t tab[256 * 32];
  __shared__ uint32_t warp_xor[kThreads / 32];
  __shared__ uint32_t cta_xor[kCluster];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  // paired with the wait before the store into CTA 0: every CTA of the
  // cluster has started before one writes into another's shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int64_t b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > width ? width : len);
  const uint8_t* row = rows + b * pitch;

  // this segment's real bytes [p0, p1)
  const int seg = static_cast<int>(rank) * kThreads + tid;
  const int p0 = seg * kSeg;
  const int p1 = min(p0 + kSeg, len);
  const uint8_t* a = row + p0;
  const bool whole = p1 - p0 == kSeg &&
                     (reinterpret_cast<uintptr_t>(a) & 15) == 0;

  // the whole segment's loads in flight before the table is built, the
  // two 16-byte halves of each 32-byte sector back to back
  uint4 v[kSeg / 16];
#pragma unroll
  for (int k = 0; k < kSeg / 16; ++k)
    v[k] = whole ? *reinterpret_cast<const uint4*>(a + 16 * k)
                 : make_uint4(0u, 0u, 0u, 0u);
  const uint32_t shift = p1 > p0 ? zshift[p1] : 0u;
  const bool lead = rank == 0 && tid == 0;
  const uint32_t un = lead ? unshift[len] : 0u;
  const uint32_t zc = lead ? zero_crc[len] : 0u;

  // the CTA's first segment starts before len: it holds real bytes
  if (static_cast<int>(rank) * kThreads * kSeg < len) {
    uint4* tab4 = reinterpret_cast<uint4*>(tab);
    for (int i = tid; i < 256 * 8; i += kThreads) {  // entry i / 8
      const uint32_t v = table_entry(static_cast<uint32_t>(i >> 3));
      tab4[i] = make_uint4(v, v, v, v);
    }
  }
  __syncthreads();

  uint32_t c = 0;
  if (whole) {
    // chain j runs words [j kSub, (j + 1) kSub) of the segment; the
    // chains' steps interleaved: a warp issues in order, so chain j + 1's
    // lookup goes out while chain j's is in flight
    uint32_t cj[kChains];
#pragma unroll
    for (int j = 0; j < kChains; ++j) cj[j] = 0;
#pragma unroll
    for (int k = 0; k < kSub / 16; ++k) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
#pragma unroll
        for (int j = 0; j < kChains; ++j) {
          const uint4& x = v[j * (kSub / 16) + k];
          cj[j] ^= w == 0 ? x.x : w == 1 ? x.y : w == 2 ? x.z : x.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < kChains; ++j)
            cj[j] = tab[((cj[j] & 0xFFu) << 5) | lane] ^ (cj[j] >> 8);
      }
    }
    c = cj[0];
#pragma unroll
    for (int j = 1; j < kChains; ++j) c = gf2_mul(c, kChainShift) ^ cj[j];
  } else if (p1 > p0) {
    int i = p0;
    for (; i < p1 && (reinterpret_cast<uintptr_t>(row + i) & 15); ++i)
      c = step(tab, lane, c, row[i]);
    for (; i + 16 <= p1; i += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + i);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t x = c ^ words[w];
#pragma unroll
        for (int q = 0; q < 4; ++q) x = tab[((x & 0xFFu) << 5) | lane] ^ (x >> 8);
        c = x;
      }
    }
    for (; i < p1; ++i) c = step(tab, lane, c, row[i]);
  }
  if (p1 > p0) c = gf2_mul(shift, c);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    c ^= __shfl_xor_sync(0xFFFFFFFFu, c, off);
  if (lane == 0) warp_xor[tid >> 5] = c;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid == 0) {
    uint32_t acc = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) acc ^= warp_xor[w];
    *cluster.map_shared_rank(&cta_xor[rank], 0) = acc;
  }
  cluster.sync();  // every CTA's value is in CTA 0's shared memory
  if (lead) {
    uint32_t acc = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) acc ^= cta_xor[r];
    out[b] = static_cast<int64_t>(gf2_mul(un, acc) ^ zc);
  }
}

}  // namespace

extern "C" int snc_crc32c_rows(const uint8_t* rows, int64_t pitch,
                               int32_t width, const int32_t* lengths,
                               const uint32_t* zshift,
                               const uint32_t* unshift,
                               const uint32_t* zero_crc, int64_t* out,
                               int32_t n_rows, void* stream) {
  if (n_rows > 0) {
    crc32c_rows_kernel<<<n_rows * kCluster, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        rows, pitch, width, lengths, zshift, unshift, zero_crc, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* snc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
