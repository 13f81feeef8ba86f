// Hybrid decode's device half: execute host-parsed element records, a CTA
// per row.
//
// Replaces snappy_tpu/kernels/decode_pretagged.py:decode_blocks_pretagged
// (an XLA program, not a Pallas kernel: per-byte record labels, a source
// pointer per output byte, pointer doubling, one gather).  The contract is
// decode_pretagged.decode_blocks_pretagged_plain on the records the host
// parser emits (native sn_parse_tags): rec = (kind, len, arg, d), kind 0 a
// literal of payload bytes [arg, arg + len), any other kind a copy of
// offset arg, d the element's first output byte.  Row b of the output
// holds its first dlen[b] decoded bytes, then zeros up to out_max.
//
// The records of a row are already validated and in stream order, so the
// row is decoded by executing them, as the writer warp of
// csrc/seq_decode.cu executes its parser's records:
//
// * One CTA per row; the output row is an image in shared memory (rows of
//   at most 64 KiB; wider rows are executed in device memory by the same
//   code), and so is the payload row when both fit (the literals then
//   copy shared memory to shared memory).  Records come in tiles of kTile
//   through shared memory.
// * A tile runs in two phases.  Literals first, a warp per record and all
//   warps at once: a literal reads only the payload, and no record of the
//   tile reads the bytes a later literal writes.  Then the copies, in
//   order, over all threads: out[d + i] = out[d - off + i % off] reads
//   only bytes below d, so an overlapping copy (off < len) is one pass.
// * A copy reads bytes that earlier records wrote.  Literals and earlier
//   tiles are visible after the phase barrier; `dirty` is the first byte a
//   copy wrote since the last barrier, and a copy whose sources reach it
//   waits on one barrier first.  Copies from older bytes run without.
// * The image goes to the row with 16-byte stores, zeros after dlen.
//
// Bytes a record would write at or past min(dlen, out_max) are dropped;
// a literal byte read past the payload row reads as zero, and a copy with
// an offset outside [1, d] writes zeros (neither occurs in parsed records).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;       // records staged in shared memory at once
constexpr int kImage = 65536;    // widest row decoded in shared memory
constexpr int kSmemMax = 232448; // 227 KiB of dynamic shared memory a CTA

__device__ __forceinline__ int32_t round16(int32_t n) { return (n + 15) & ~15; }

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
pretagged_kernel(const uint8_t* __restrict__ comp, int64_t pitch,
                 int32_t cmax, const int4* __restrict__ recs, int32_t t_max,
                 const int32_t* __restrict__ n_tags,
                 const int32_t* __restrict__ dlens, uint8_t* out,
                 int32_t out_max, int stage_comp) {
  extern __shared__ __align__(16) uint8_t smem[];
  int4* tile = reinterpret_cast<int4*>(smem);
  uint8_t* image = smem + kTile * sizeof(int4);
  uint8_t* comp_s = image + (kShared ? round16(out_max) : 0);
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int64_t b = blockIdx.x;
  const uint8_t* c = comp + b * pitch;
  uint8_t* orow = out + b * static_cast<int64_t>(out_max);
  uint8_t* o = kShared ? image : orow;
  const int4* rrow = recs + b * static_cast<int64_t>(t_max);
  int32_t nt = n_tags[b];
  nt = nt < 0 ? 0 : (nt > t_max ? t_max : nt);
  const int32_t dlen = dlens[b];
  const int32_t lim = dlen < 0 ? 0 : (dlen < out_max ? dlen : out_max);

  // the payload row, in shared memory when it fits
  const uint8_t* src = c;
  if (stage_comp) {
    if ((reinterpret_cast<uintptr_t>(c) & 15) == 0 && (cmax & 15) == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(c);
      uint4* d4 = reinterpret_cast<uint4*>(comp_s);
      for (int32_t i = t; i < (cmax >> 4); i += kThreads) d4[i] = __ldg(s4 + i);
    } else {
      for (int32_t i = t; i < cmax; i += kThreads) comp_s[i] = __ldg(c + i);
    }
    src = comp_s;
  }

  for (int32_t base = 0; base < nt; base += kTile) {
    const int cnt = nt - base < kTile ? nt - base : kTile;
    __syncthreads();  // the previous tile is consumed (and the row staged)
    for (int i = t; i < cnt; i += kThreads) tile[i] = __ldg(rrow + base + i);
    __syncthreads();

    // literals: a warp per record, all warps at once
    for (int r = warp; r < cnt; r += kWarps) {
      const int4 rec = tile[r];
      const int32_t ln = rec.y, a = rec.z, d = rec.w;
      if (rec.x != 0 || d < 0 || d >= lim || ln <= 0) continue;
      const int32_t n_w = ln < lim - d ? ln : lim - d;
      for (int32_t i = lane; i < n_w; i += 32) {
        const int64_t si = static_cast<int64_t>(a) + i;
        o[d + i] = (si >= 0 && si < cmax) ? src[si] : 0;
      }
    }
    __syncthreads();

    // copies, in order, over all threads
    int32_t dirty = INT_MAX;
    for (int r = 0; r < cnt; ++r) {
      const int4 rec = tile[r];
      const int32_t ln = rec.y, a = rec.z, d = rec.w;
      if (rec.x == 0 || d < 0 || d >= lim || ln <= 0) continue;
      const int32_t n_w = ln < lim - d ? ln : lim - d;
      if (a <= 0 || a > d) {
        for (int32_t i = t; i < n_w; i += kThreads) o[d + i] = 0;
      } else {
        const int32_t period = a < ln ? a : ln;
        if (d - a + period > dirty) {  // reads bytes written since the barrier
          __syncthreads();
          dirty = INT_MAX;
        }
        if (a >= ln) {
          for (int32_t i = t; i < n_w; i += kThreads) o[d + i] = o[d - a + i];
        } else {
          for (int32_t i = t; i < n_w; i += kThreads)
            o[d + i] = o[d - a + i % a];
        }
      }
      dirty = d < dirty ? d : dirty;
    }
  }
  __syncthreads();

  // the row: [0, lim) from the image (in place when not shared), zeros
  // after; 16-byte stores where the row is 16-byte aligned
  const bool vec = (out_max & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(orow) & 15) == 0;
  if (vec) {
    uint4* d4 = reinterpret_cast<uint4*>(orow);
    const int32_t n16 = out_max >> 4;
    for (int32_t q = t; q < n16; q += kThreads) {
      const int32_t lo = q << 4;
      if (lo + 16 <= lim) {
        if (kShared) d4[q] = reinterpret_cast<const uint4*>(image)[q];
      } else if (lo >= lim) {
        d4[q] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        alignas(16) uint8_t w[16];
        for (int k = 0; k < 16; ++k) w[k] = lo + k < lim ? o[lo + k] : 0;
        d4[q] = *reinterpret_cast<const uint4*>(w);
      }
    }
  } else {
    for (int32_t i = t; i < out_max; i += kThreads)
      orow[i] = i < lim ? o[i] : 0;
  }
}

bool use_shared(int32_t out_max) { return out_max <= kImage; }

// dynamic shared memory of a launch; *stage: the payload row fits too
int smem_bytes(int32_t out_max, int32_t cmax, int* stage) {
  const int64_t fixed = kTile * static_cast<int64_t>(sizeof(int4)) +
                        (use_shared(out_max) ? ((out_max + 15) & ~15) : 0);
  const int64_t with_comp = fixed + ((static_cast<int64_t>(cmax) + 15) & ~15);
  *stage = with_comp <= kSmemMax;
  return static_cast<int>(*stage ? with_comp : fixed);
}

template <bool kShared>
cudaError_t prepare(int smem) {
  return cudaFuncSetAttribute(pretagged_kernel<kShared>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" int snc_pretagged(const uint8_t* comp, int64_t pitch,
                             int32_t cmax, const int32_t* recs, int32_t t_max,
                             const int32_t* n_tags, const int32_t* dlens,
                             uint8_t* out, int32_t out_max, int32_t n_rows,
                             void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  int stage = 0;
  const int smem = smem_bytes(out_max, cmax, &stage);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* r4 = reinterpret_cast<const int4*>(recs);
  cudaError_t rc;
  if (use_shared(out_max)) {
    rc = prepare<true>(smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    pretagged_kernel<true><<<n_rows, kThreads, smem, st>>>(
        comp, pitch, cmax, r4, t_max, n_tags, dlens, out, out_max, stage);
  } else {
    rc = prepare<false>(smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    pretagged_kernel<false><<<n_rows, kThreads, smem, st>>>(
        comp, pitch, cmax, r4, t_max, n_tags, dlens, out, out_max, stage);
  }
  return static_cast<int>(cudaGetLastError());
}
