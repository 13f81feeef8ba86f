// CRC-32C of batched chunk rows, one CTA per row.
//
// Replaces snappy_tpu/kernels/crc32c_jnp.py:crc32c_chunks, the XLA
// GF(2)-matmul CRC that carries the framed main path on the TPU (every
// chunk's checksum on decode and on encode).
//
// Design: row b is split into 256-byte segments, one per thread.  Each
// thread runs a byte-wise table CRC over its own segment (table in shared
// memory), then advances its segment CRC through the zero bytes that
// follow the segment inside the row's first lengths[b] bytes, using the
// GF(2) shift matrices of snappy_tpu/spec/crc32c.py:crc_shift_matrix for
// 2^j bytes (binary decomposition of the distance).  Because CRC-32C's
// init value equals its final xor, crc(A||B) = shift(crc(A), |B|) ^ crc(B)
// (spec/crc32c.py:crc_combine), so the row CRC is the xor of the shifted
// segment CRCs: a warp-shuffle reduction plus one shared-memory step.
//
// Bound on this card: device-memory reads (each byte is read once) and
// the dependent shared-memory table lookups of each thread's segment.
// Segments keep 256 threads busy per 64 KiB chunk; rows are read with
// 16-byte loads when the base and pitch allow it.  Bytes at or past
// lengths[b] are never read: staging rows past a chunk's end may hold
// anything.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 256;        // bytes per thread segment
constexpr int kThreads = 256;    // segments per CTA: 64 KiB rows
constexpr int kShiftBits = 16;   // shift distances < 2^16 bytes

__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* cols,
                                              uint32_t c) {
  // cols[i] is the image of CRC bit i under the shift: r = M @ c
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) r ^= (0u - ((c >> i) & 1u)) & cols[i];
  return r;
}

__device__ __forceinline__ uint32_t crc_byte(const uint32_t* table,
                                             uint32_t c, uint32_t byte) {
  return table[(c ^ byte) & 0xFFu] ^ (c >> 8);
}

__global__ void __launch_bounds__(kThreads)
crc32c_rows_kernel(const uint8_t* __restrict__ rows, int64_t pitch,
                   int width, const int32_t* __restrict__ lengths,
                   const uint32_t* __restrict__ table_g,
                   const uint32_t* __restrict__ shifts_g,
                   int64_t* __restrict__ out) {
  __shared__ uint32_t table[256];
  __shared__ uint32_t shifts[kShiftBits * 32];
  __shared__ uint32_t partial[kThreads / 32];

  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += kThreads) table[i] = table_g[i];
  for (int i = tid; i < kShiftBits * 32; i += kThreads)
    shifts[i] = shifts_g[i];
  __syncthreads();

  const int64_t b = blockIdx.x;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > width ? width : len);
  const uint8_t* row = rows + b * pitch;

  const int start = tid * kSeg;
  const int end = min(start + kSeg, len);
  uint32_t seg_crc = 0;  // crc of the empty segment
  if (start < end) {
    uint32_t c = 0xFFFFFFFFu;
    int i = start;
    const bool vec =
        ((reinterpret_cast<uintptr_t>(row) | static_cast<uint64_t>(pitch)) &
         15u) == 0;
    if (vec) {
      for (; i + 16 <= end; i += 16) {
        const uint4 w = *reinterpret_cast<const uint4*>(row + i);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int s = 0; s < 32; s += 8)
            c = crc_byte(table, c, (words[k] >> s) & 0xFFu);
        }
      }
    }
    for (; i < end; ++i) c = crc_byte(table, c, row[i]);
    seg_crc = c ^ 0xFFFFFFFFu;
    // advance through the bytes that follow this segment in the row
    const uint32_t dist = static_cast<uint32_t>(len - end);
#pragma unroll 1
    for (int j = 0; j < kShiftBits; ++j)
      if ((dist >> j) & 1u) seg_crc = gf2_apply(&shifts[j * 32], seg_crc);
  }

  // xor-reduce the shifted segment CRCs
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    seg_crc ^= __shfl_xor_sync(0xFFFFFFFFu, seg_crc, off);
  if ((tid & 31) == 0) partial[tid >> 5] = seg_crc;
  __syncthreads();
  if (tid == 0) {
    uint32_t acc = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) acc ^= partial[w];
    out[b] = static_cast<int64_t>(acc);
  }
}

}  // namespace

extern "C" int snc_crc32c_rows(const uint8_t* rows, int64_t pitch,
                               int32_t width, const int32_t* lengths,
                               const uint32_t* table,
                               const uint32_t* shifts, int64_t* out,
                               int32_t n_rows, void* stream) {
  if (n_rows > 0) {
    crc32c_rows_kernel<<<n_rows, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        rows, pitch, width, lengths, table, shifts, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* snc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
