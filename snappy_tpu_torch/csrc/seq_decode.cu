// Sequential per-block Snappy decode, one warp per block.
//
// Replaces snappy_tpu/kernels/pallas_decode.py:_kernel (and its per-element
// body _step_one), the Pallas decoder that interleaves 8 blocks per grid
// step and moves bytes as rolled 128-byte windows of int32 rows.  None of
// that is needed here: each block is an independent serial decoder, and a
// warp runs one.  The contract is decode_seq.decode_blocks_seq_plain:
// out[b, :d] are the bytes decoded before the first failing element, the
// rest of the row is zero, err[b] is the JAX kernel's code.
//
// Design: grid of B CTAs of 32 threads.  The warp first stages the row's
// compressed bytes in shared memory with coalesced 16-byte loads, and
// decodes into a shared-memory image of the output row, which it writes
// out once at the end; rows wider than the shared-memory budget are read
// and written in device memory instead (the same code through generic
// pointers).  All lanes parse the same element, so control flow is
// warp-uniform.  A literal is copied lane-parallel; a copy of any offset
// is one lane-parallel pass out[d + i] = out[d - off + i % off], which
// reads only bytes below d, all final, so a __syncwarp() after each
// element is the only ordering needed.
//
// Validation is _step_one's to the bit: lengths and offsets are wrapping
// int32, the bounds are subtraction forms, and the first failing element
// freezes the cursors.  Bytes the walk reads past the row (a header at the
// row end) read as zero; they cannot change the result, since an element
// whose header passes its payload end fails on `hdr > clen - s` alone.
//
// Bound on this card: the dependent chain of one element (header loads
// from shared memory, the checks, one __syncwarp) times the number of
// elements; a block of text has ~10^4.  One warp per SM at BATCH = 64
// rows; more rows per launch, or several blocks per CTA, is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kErrNone = 0;
constexpr int kErrLiteral = 1;
constexpr int kErrCopy = 2;
constexpr int kErrDstShort = 3;
constexpr int kErrSrcTrail = 4;
constexpr int kSmemRow = 98304;  // widest row staged in shared memory

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ uint32_t byte_at(const uint8_t* c, int64_t lim,
                                            int64_t i) {
  return (i >= 0 && i < lim) ? c[i] : 0u;
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

__global__ void __launch_bounds__(32)
seq_decode_kernel(const uint8_t* __restrict__ comp, int64_t pitch,
                  int32_t cmax, const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ clens,
                  const int32_t* __restrict__ dlens, uint8_t* out,
                  int32_t out_max, int32_t* __restrict__ err,
                  int32_t smem_comp, int32_t smem_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int32_t clen = clens[b];
  const int32_t dlen = dlens[b];
  uint8_t* orow = out + b * static_cast<int64_t>(out_max);

  // the bytes of the row the walk can use: [0, lim)
  const int64_t lim = clen < 0 ? 0 : (clen < cmax ? clen : cmax);
  const uint8_t* c = comp + b * pitch;
  if (smem_comp > 0) {
    warp_copy(smem, c, lim, lane);
    c = smem;
  }
  uint8_t* o = smem_out > 0 ? smem + smem_comp : orow;
  __syncwarp();

  int32_t s = starts[b];
  int32_t d = 0;
  int e = kErrNone;
  while (s < clen) {
    const uint32_t b0 = byte_at(c, lim, s);
    const uint32_t b1 = byte_at(c, lim, static_cast<int64_t>(s) + 1);
    const uint32_t b2 = byte_at(c, lim, static_cast<int64_t>(s) + 2);
    const uint32_t b3 = byte_at(c, lim, static_cast<int64_t>(s) + 3);
    const uint32_t b4 = byte_at(c, lim, static_cast<int64_t>(s) + 4);
    const uint32_t tag = b0 & 3u;
    const uint32_t x = b0 >> 2;
    const uint32_t w4 = b1 | (b2 << 8) | (b3 << 16) | (b4 << 24);
    int32_t hdr, ln;
    if (tag == 0) {
      hdr = x < 60 ? 1 : static_cast<int32_t>(x) - 58;
      const uint32_t raw = x < 60    ? x
                           : x == 60 ? b1
                           : x == 61 ? (w4 & 0xFFFFu)
                           : x == 62 ? (w4 & 0xFFFFFFu)
                                     : w4;
      ln = static_cast<int32_t>(raw + 1u);
      const int32_t room = sub32(clen, s);
      if (hdr > room || ln <= 0 || ln > sub32(dlen, d) ||
          ln > sub32(room, hdr)) {
        e = kErrLiteral;
        break;
      }
      const int64_t src0 = static_cast<int64_t>(s) + hdr;
      const int32_t room_out = d < out_max ? out_max - d : 0;
      const int32_t n_w = ln < room_out ? ln : room_out;
      for (int32_t i = lane; i < n_w; i += 32)
        o[d + i] = static_cast<uint8_t>(byte_at(c, lim, src0 + i));
      s = static_cast<int32_t>(src0 + ln);
    } else {
      hdr = tag == 1 ? 2 : (tag == 2 ? 3 : 5);
      ln = tag == 1 ? 4 + static_cast<int32_t>(x & 7u)
                    : 1 + static_cast<int32_t>(x);
      const int32_t off =
          tag == 1 ? static_cast<int32_t>(((b0 & 0xE0u) << 3) | b1)
                   : (tag == 2 ? static_cast<int32_t>(w4 & 0xFFFFu)
                               : static_cast<int32_t>(w4));
      if (hdr > sub32(clen, s) || ln <= 0 || ln > sub32(dlen, d) ||
          off <= 0 || off > d) {
        e = kErrCopy;
        break;
      }
      const int64_t base = static_cast<int64_t>(d) - off;
      for (int32_t i = lane; i < ln; i += 32) {
        const int64_t di = static_cast<int64_t>(d) + i;
        const int64_t si = base + (off >= ln ? i : i % off);
        if (di < out_max) o[di] = si < out_max ? o[si] : 0;
      }
      s += hdr;
    }
    d += ln;
    __syncwarp();
  }
  if (e == kErrNone && d != dlen) e = kErrDstShort;
  if (e == kErrNone && s != clen) e = kErrSrcTrail;

  __syncwarp();
  const int64_t written = d < out_max ? d : out_max;
  if (smem_out > 0) warp_copy(orow, o, written, lane);
  warp_zero(orow + written, out_max - written, lane);
  if (lane == 0) err[b] = e;
}

int round16(int64_t n) { return static_cast<int>((n + 15) & ~int64_t{15}); }

}  // namespace

extern "C" int snc_seq_decode(const uint8_t* comp, int64_t pitch,
                              int32_t cmax, const int32_t* starts,
                              const int32_t* clens, const int32_t* dlens,
                              uint8_t* out, int32_t out_max, int32_t* err,
                              int32_t n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const int smem_comp = cmax <= kSmemRow ? round16(cmax) : 0;
  const int smem_out = out_max <= kSmemRow ? round16(out_max) : 0;
  const int smem = smem_comp + smem_out;
  cudaError_t rc = cudaFuncSetAttribute(
      seq_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  seq_decode_kernel<<<n_rows, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      comp, pitch, cmax, starts, clens, dlens, out, out_max, err, smem_comp,
      smem_out);
  return static_cast<int>(cudaGetLastError());
}
