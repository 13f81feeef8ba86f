// Framed (.sz) records of one batch of chunk rows: a CTA per row.
//
// Replaces no TPU kernel.  The JAX package assembles a framed stream on
// the host, one Python call per chunk (snappy_tpu/runtime/
// device_codec.py, the records of compress_framed); so did the port's
// seq engine (runtime/device_codec.py:_framed_record), bringing each
// batch's element rows, padded to its widest element, and every stored
// chunk back first.  The card already holds every input of a record: the
// chunk's bytes, its element and length from seq_encode, its CRC-32C
// from crc32c_rows.  Written here, only the stream comes back.
//
// Record of row b, byte-identical to _framed_record: the chunk is stored
// raw where varint_len(len) + clen >= len - len / 8
// (spec/format.py:framed_chunk_type); the type byte (0x00 compressed,
// 0x01 stored), the body's length plus 4 in 3 little-endian bytes, the
// masked CRC (rotated right 15, plus 0xA282EAD8) in 4, then the body:
// the uvarint of len and comp[b, :clen], or rows[b, :len].  The records
// lie one after another from framed[0]; ends[b] is the end of row b's.
//
// What bounds it on this card: device-memory bytes, each body read once
// and the stream written once (about 2 x 8 MB for the seq engine's 264
// rows, about 5 us at 3.35 TB/s), and the launch itself.  The design:
//
// * Offsets.  CTA b sums the record lengths of rows 0..b-1 itself, a
//   strided loop, warp shuffles and one shared-memory step: a batch has
//   a few hundred rows, so this costs a few hundred L2 loads a CTA and
//   needs no second launch, grid barrier or scan kernel.
// * Header.  Thread 0 writes the 8 header bytes and the 1-3 varint bytes.
// * Body.  The body lands at any byte offset, beside other CTAs' records,
//   so a CTA stores whole 16-byte words only inside its own body: the
//   bytes before its first 16-byte boundary and after its last are
//   written one by one.  Each whole word is built from the two aligned
//   16-byte source words that hold its bytes (one where the source is at
//   the same alignment), funnel-shifted by the source's offset within
//   them; neighbouring threads read neighbouring words.  No load
//   reaches a word that holds none of the body's bytes.
//
// Lengths outside [0, width] and element lengths outside [0, cap] are
// clamped, as by the plain version (kernels/frame_records.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kMaskDelta = 0xA282EAD8u;

__device__ __forceinline__ int clamp_to(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ int varint_len(int n) {
  return 1 + (n >= 128) + (n >= 16384);  // n <= 65536
}

// whether row j's chunk of n bytes, whose element has c bytes, is stored
__device__ __forceinline__ bool stored(int n, int c) {
  return varint_len(n) + c >= n - n / 8;
}

__device__ __forceinline__ int record_len(int n, int c) {
  return 8 + (stored(n, c) ? n : varint_len(n) + c);
}

// dst[0, n) = src[0, n); dst and src at any byte offset, n >= 0
__device__ void copy_body(uint8_t* dst, const uint8_t* src, int n) {
  const int tid = threadIdx.x;
  const uintptr_t t = reinterpret_cast<uintptr_t>(dst);
  const int head = static_cast<int>(((t + 15) & ~uintptr_t(15)) - t);
  const int tail = static_cast<int>(((t + n) & ~uintptr_t(15)) - t);
  if (head >= tail) {  // no whole 16-byte word of dst inside the body
    for (int i = tid; i < n; i += kThreads) dst[i] = src[i];
    return;
  }
  for (int i = tid; i < head; i += kThreads) dst[i] = src[i];
  for (int i = tail + tid; i < n; i += kThreads) dst[i] = src[i];

  // dst word k holds src[head + 16 k, head + 16 k + 16)
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  const int nw = (tail - head) >> 4;
  const uintptr_t s0 = reinterpret_cast<uintptr_t>(src + head);
  const int sh = static_cast<int>(s0 & 15);
  const uint4* s = reinterpret_cast<const uint4*>(s0 - sh);
  if (sh == 0) {
    for (int k = tid; k < nw; k += kThreads) d[k] = s[k];
    return;
  }
  // bytes sh..15 of s[k], then 0..sh-1 of s[k + 1]: 32-bit words w..w+4
  // of the pair, each pair of neighbours funnel-shifted by 8 (sh & 3)
  const int w = sh >> 2;
  const unsigned bits = 8u * (sh & 3);
  for (int k = tid; k < nw; k += kThreads) {
    const uint4 lo = s[k];
    const uint4 hi = s[k + 1];
    const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t a[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      a[i] = w == 0 ? v[i] : w == 1 ? v[i + 1] : w == 2 ? v[i + 2] : v[i + 3];
    d[k] = make_uint4(__funnelshift_r(a[0], a[1], bits),
                      __funnelshift_r(a[1], a[2], bits),
                      __funnelshift_r(a[2], a[3], bits),
                      __funnelshift_r(a[3], a[4], bits));
  }
}

__global__ void __launch_bounds__(kThreads)
frame_records_kernel(const uint8_t* __restrict__ rows, int64_t row_pitch,
                     int width, const int32_t* __restrict__ lens,
                     const uint8_t* __restrict__ comp, int64_t comp_pitch,
                     int cap, const int32_t* __restrict__ clens,
                     const int64_t* __restrict__ crc,
                     uint8_t* __restrict__ framed,
                     int64_t* __restrict__ ends) {
  __shared__ int64_t warp_sum[kThreads / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  int64_t acc = 0;
  for (int j = tid; j < b; j += kThreads)
    acc += record_len(clamp_to(lens[j], width), clamp_to(clens[j], cap));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  int64_t start = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) start += warp_sum[i];

  const int n = clamp_to(lens[b], width);
  const int c = clamp_to(clens[b], cap);
  const bool raw = stored(n, c);
  const int vlen = raw ? 0 : varint_len(n);
  const int body = raw ? n : vlen + c;
  uint8_t* rec = framed + start;
  if (tid == 0) {
    const uint32_t x = static_cast<uint32_t>(crc[b]);
    const uint32_t m = ((x >> 15) | (x << 17)) + kMaskDelta;
    const int blen = body + 4;
    rec[0] = raw ? 0x01 : 0x00;
    rec[1] = static_cast<uint8_t>(blen);
    rec[2] = static_cast<uint8_t>(blen >> 8);
    rec[3] = static_cast<uint8_t>(blen >> 16);
    rec[4] = static_cast<uint8_t>(m);
    rec[5] = static_cast<uint8_t>(m >> 8);
    rec[6] = static_cast<uint8_t>(m >> 16);
    rec[7] = static_cast<uint8_t>(m >> 24);
    unsigned v = static_cast<unsigned>(n);
    for (int i = 0; i < vlen; ++i, v >>= 7)
      rec[8 + i] = static_cast<uint8_t>(i + 1 < vlen ? (v & 0x7F) | 0x80 : v);
    ends[b] = start + 8 + body;
  }
  if (raw)
    copy_body(rec + 8, rows + b * row_pitch, n);
  else
    copy_body(rec + 8 + vlen, comp + b * comp_pitch, c);
}

}  // namespace

extern "C" int snc_frame_records(const uint8_t* rows, int64_t row_pitch,
                                 int32_t width, const int32_t* lens,
                                 const uint8_t* comp, int64_t comp_pitch,
                                 int32_t cap, const int32_t* clens,
                                 const int64_t* crc, uint8_t* framed,
                                 int64_t* ends, int32_t n_rows,
                                 void* stream) {
  if (n_rows > 0) {
    frame_records_kernel<<<n_rows, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        rows, row_pitch, width, lens, comp, comp_pitch, cap, clens, crc,
        framed, ends);
  }
  return static_cast<int>(cudaGetLastError());
}
