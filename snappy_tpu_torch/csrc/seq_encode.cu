// Sequential per-block Snappy encode, one warp per block: the reference
// greedy hash-table matcher, emission byte-identical to
// snappy_tpu/spec/reference.py:encode_block.
//
// Replaces snappy_tpu/kernels/pallas_encode.py:_kernel (and its state
// machine _step), the Pallas encoder that keeps two blocks' state in SMEM
// scratch, bytes as int32 [rows, 128] tiles, and reads and writes its hash
// table through rolls and lane masks.  Here a warp owns one block: the
// block (<= 64 KiB) and its hash table (uint16 positions, since positions
// are < 65536) live in shared memory, 96 KiB per CTA with a 64 KiB block.
//
// Design: the PROBE / MATCH / TAIL control flow of the reference is
// scalar, computed identically by all 32 lanes, so it stays warp-uniform.
// Lane 0 alone reads and writes the hash table and broadcasts the
// candidate with a shuffle.  Match extension compares 32 bytes per step,
// one per lane, and finds the first mismatch with __ballot_sync + __ffs.
// Literal bodies are copied lane-parallel; tag bytes are written by lane 0
// (the 64-byte chops of a long copy lane-parallel).  At the end the warp
// zero-fills the row past the element, so every byte of the output is
// written by the kernel.
//
// Bound on this card: the dependent chain of one probe (two 4-byte loads
// from shared memory, the hash, the table swap through lane 0 and a
// shuffle), times ~10^4 probes per 64 KiB block of text.  Two CTAs fit an
// SM; one warp per block leaves most of each SM idle, which is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 65536;
constexpr int kMaxTable = 1 << 14;
constexpr int kInputMargin = 15;
constexpr int kMinNonLiteral = 1 + 2 + kInputMargin;
constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr int kErrLen = 1;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t load32(const uint8_t* p, int i) {
  return static_cast<uint32_t>(p[i]) | (static_cast<uint32_t>(p[i + 1]) << 8) |
         (static_cast<uint32_t>(p[i + 2]) << 16) |
         (static_cast<uint32_t>(p[i + 3]) << 24);
}

__device__ __forceinline__ uint32_t hash32(uint32_t u, int shift) {
  return (u * kHashMul) >> shift;
}

// candidate = table[h]; table[h] = s  (lane 0 only, broadcast to the warp)
__device__ __forceinline__ int table_swap(uint16_t* table, uint32_t h, int s,
                                          int lane) {
  int cand = 0;
  if (lane == 0) {
    cand = table[h];
    table[h] = static_cast<uint16_t>(s);
  }
  return __shfl_sync(kFull, cand, 0);
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

__device__ int emit_literal(uint8_t* out, int o, const uint8_t* src,
                            int start, int len, int lane) {
  const int m = len - 1;
  if (lane == 0) {
    if (m < 60) {
      out[o] = static_cast<uint8_t>(m << 2);
    } else if (m < 256) {
      out[o] = 60 << 2;
      out[o + 1] = static_cast<uint8_t>(m);
    } else {  // blocks are <= 64 KiB, so m < 65536
      out[o] = 61 << 2;
      out[o + 1] = static_cast<uint8_t>(m & 0xFF);
      out[o + 2] = static_cast<uint8_t>(m >> 8);
    }
  }
  o += m < 60 ? 1 : (m < 256 ? 2 : 3);
  for (int i = lane; i < len; i += 32) out[o + i] = src[start + i];
  return o + len;
}

// spec/reference.py:emit_copy (pallas_encode.py:_emit_copy l.116-156)
__device__ int emit_copy(uint8_t* out, int o, int offset, int length,
                         int lane) {
  const uint8_t lo = static_cast<uint8_t>(offset & 0xFF);
  const uint8_t hi = static_cast<uint8_t>((offset >> 8) & 0xFF);
  const int n68 = length >= 68 ? (length - 68) / 64 + 1 : 0;
  for (int k = lane; k < n68; k += 32) {
    out[o + 3 * k] = (63 << 2) | 2;
    out[o + 3 * k + 1] = lo;
    out[o + 3 * k + 2] = hi;
  }
  o += 3 * n68;
  length -= 64 * n68;
  if (length > 64) {
    if (lane == 0) {
      out[o] = (59 << 2) | 2;
      out[o + 1] = lo;
      out[o + 2] = hi;
    }
    o += 3;
    length -= 60;
  }
  if (length >= 12 || offset >= 2048) {
    if (lane == 0) {
      out[o] = static_cast<uint8_t>(((length - 1) << 2) | 2);
      out[o + 1] = lo;
      out[o + 2] = hi;
    }
    return o + 3;
  }
  if (lane == 0) {
    out[o] = static_cast<uint8_t>(((offset >> 8) << 5) | ((length - 4) << 2) | 1);
    out[o + 1] = lo;
  }
  return o + 2;
}

__device__ void warp_copy(uint8_t* dst, const uint8_t* src, int64_t n,
                          int lane) {
  int64_t i = lane;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15u) == 0) {
    const int64_t n16 = n >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (; i < n16; i += 32) d4[i] = s4[i];
    i = (n16 << 4) + lane;
  }
  for (; i < n; i += 32) dst[i] = src[i];
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

// the reference encode_block of src[0, n), n >= kMinNonLiteral; returns
// the element length
__device__ int encode_block(const uint8_t* src, int n, uint16_t* table,
                            uint8_t* out, int lane) {
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
  int o = 0;
  int next_emit = 0;
  int s = 1;
  uint32_t next_hash = hash32(load32(src, s), shift);
  while (true) {
    // PROBE: the skip loop
    int skip = 32;
    int next_s = s;
    int cand = 0;
    while (true) {
      s = next_s;
      const int bytes_between = skip >> 5;
      next_s = s + bytes_between;
      skip += bytes_between;
      if (next_s > s_limit) {
        if (next_emit < n)
          o = emit_literal(out, o, src, next_emit, n - next_emit, lane);
        return o;
      }
      cand = table_swap(table, next_hash, s, lane);
      next_hash = hash32(load32(src, next_s), shift);
      if (load32(src, s) == load32(src, cand)) break;
    }
    o = emit_literal(out, o, src, next_emit, s - next_emit, lane);
    // MATCH: extend, emit the copy, double insert
    while (true) {
      const int base = s;
      s = extend_match(src, cand + 4, base + 4, n, lane);
      o = emit_copy(out, o, base - cand, s - base, lane);
      next_emit = s;
      if (s >= s_limit) {
        if (next_emit < n)
          o = emit_literal(out, o, src, next_emit, n - next_emit, lane);
        return o;
      }
      const uint32_t x_prev = load32(src, s - 1);
      const uint32_t x_cur = load32(src, s);
      if (lane == 0) table[hash32(x_prev, shift)] = static_cast<uint16_t>(s - 1);
      cand = table_swap(table, hash32(x_cur, shift), s, lane);
      if (x_cur != load32(src, cand)) {
        next_hash = hash32(load32(src, s + 1), shift);
        s += 1;
        break;
      }
    }
  }
}

__global__ void __launch_bounds__(32)
seq_encode_kernel(const uint8_t* __restrict__ blocks, int64_t pitch,
                  int32_t bmax, const int32_t* __restrict__ lens,
                  uint8_t* __restrict__ comp, int32_t cap,
                  int32_t* __restrict__ clens, int32_t* __restrict__ err,
                  int32_t src_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* src = smem;
  uint16_t* table = reinterpret_cast<uint16_t*>(smem + src_bytes);
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int32_t n = lens[b];
  uint8_t* out = comp + b * static_cast<int64_t>(cap);

  int o = 0;
  int e = 0;
  if (n < 0 || n > bmax || n > kMaxBlock) {
    e = kErrLen;
  } else {
    warp_copy(src, blocks + b * pitch, n, lane);
    __syncwarp();
    if (n >= kMinNonLiteral)
      o = encode_block(src, n, table, out, lane);
    else if (n > 0)
      o = emit_literal(out, o, src, 0, n, lane);
  }
  warp_zero(out + o, cap - o, lane);
  if (lane == 0) {
    clens[b] = o;
    err[b] = e;
  }
}

}  // namespace

extern "C" int snc_seq_encode(const uint8_t* blocks, int64_t pitch,
                              int32_t bmax, const int32_t* lens,
                              uint8_t* comp, int32_t cap, int32_t* clens,
                              int32_t* err, int32_t n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const int span = bmax < kMaxBlock ? bmax : kMaxBlock;
  int table = 256;
  while (table < kMaxTable && table < span) table <<= 1;
  const int src_bytes = (span + 15) & ~15;
  const int smem = src_bytes + 2 * table;
  cudaError_t rc = cudaFuncSetAttribute(
      seq_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  seq_encode_kernel<<<n_rows, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      blocks, pitch, bmax, lens, comp, cap, clens, err, src_bytes);
  return static_cast<int>(cudaGetLastError());
}
