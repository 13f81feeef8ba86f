// Flat-plan executor: runs a packed flat plan as a plain gather/copy.
//
// Replaces snappy_tpu/kernels/decode_flat.py:_flat_kernel (the Pallas
// kernel behind decode_blocks_flat and encode_flat.encode_blocks_flat),
// which gathers piece rows with one-hot MXU matmuls, aligns lanes with
// rolls and composes the output with a second one-hot matmul.  None of
// that is needed here: the contract is execute_flat_np, where each valid
// piece copies lenm1+1 <= 128 bytes
//     out[(D + drel) * 128 + l] = B[(S + qrel) * 128 + phi + l]
// for l in [dphi, dphi + lenm1], with D = min(Dq, out_rows - 128) (the
// compose clamp, drel shifted by Dq - D) and phi = (128 - rot) & 127.
//
// Word layouts (pack_trips): meta row 2*NSUB*t + s holds the A words
// (qrel | rot << 7) of trip t's subpanel s, row 2*NSUB*t + NSUB + s its B
// words (dphi | lenm1 << 7 | drel << 14 | VALID); the subpanel's
// S | Dq << 10 | rot << 20 word is starts[t >> 5, (t & 31) * 4 + s];
// ntrips & 0xFFFF is the trip count (the high half counts aligned trips).
//
// Two launches: a zero fill of out[:, :dst_max], then one CTA per
// (subpanel, row) in which each warp copies one piece at a time, lane i
// moving bytes dphi + i, dphi + i + 32, ...  Destinations are disjoint by
// construction, so pieces need no ordering.  The B buffer is taken as
// staged (uint8), and the output is written as uint8.
//
// Bound on this card: memory traffic of ~1 byte read and 1 byte written
// per output byte plus the 1 KiB of plan words per subpanel; the byte
// stores of one piece are contiguous across the warp.  A first,
// simple form: no shared-memory staging and no vector copies yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 128;
constexpr int kNsub = 4;
constexpr int32_t kValid = 1 << 21;
constexpr int kZeroThreads = 256;
constexpr int kPieceThreads = 128;

__global__ void __launch_bounds__(kZeroThreads)
flat_zero_kernel(uint8_t* __restrict__ out, int64_t out_pitch,
                 int64_t dst_max, int vec) {
  uint8_t* row = out + static_cast<int64_t>(blockIdx.y) * out_pitch;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (vec) {
    uint4* row4 = reinterpret_cast<uint4*>(row);
    for (int64_t i = t; i < dst_max / 16; i += step)
      row4[i] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int64_t i = t; i < dst_max; i += step) row[i] = 0;
  }
}

__global__ void __launch_bounds__(kPieceThreads)
flat_pieces_kernel(const uint8_t* __restrict__ b, int64_t b_bytes,
                   const int32_t* __restrict__ meta, int32_t trip_cap,
                   const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ ntrips,
                   uint8_t* __restrict__ out, int64_t out_pitch,
                   int64_t dst_max, int32_t out_rows) {
  const int64_t row = blockIdx.y;
  const int t = blockIdx.x / kNsub;
  const int s = blockIdx.x % kNsub;
  const int n = ntrips[row] & 0xFFFF;
  if (t >= n) return;

  const int32_t w = starts[row * 8 * kVec + (t >> 5) * kVec +
                           (t & 31) * kNsub + s];
  const int S = w & 1023;
  const int Dq = (w >> 10) & 1023;
  const int D = min(Dq, out_rows - kVec);
  const int32_t* meta_row = meta + row * (8LL * trip_cap * kVec);
  const int32_t* a_words = meta_row + (2 * kNsub * t + s) * kVec;
  const int32_t* b_words = meta_row + (2 * kNsub * t + kNsub + s) * kVec;
  const uint8_t* b_row = b + row * b_bytes;
  uint8_t* o_row = out + row * out_pitch;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int k = warp; k < kVec; k += kPieceThreads / 32) {
    const int32_t bw = b_words[k];
    if (!(bw & kValid)) continue;
    const int32_t a = a_words[k];
    const int qrel = a & 127;
    const int rot = (a >> 7) & 127;
    const int dphi = bw & 127;
    const int lenm1 = (bw >> 7) & 127;
    const int drel = ((bw >> 14) & 127) + (Dq - D);
    const int phi = (kVec - rot) & (kVec - 1);
    const int64_t src = static_cast<int64_t>(S + qrel) * kVec + phi;
    const int64_t dst = static_cast<int64_t>(D + drel) * kVec;
    for (int l = dphi + lane; l <= dphi + lenm1; l += 32) {
      const int64_t si = src + l;
      const int64_t di = dst + l;
      if (di < dst_max) o_row[di] = si < b_bytes ? b_row[si] : 0;
    }
  }
}

}  // namespace

extern "C" int snc_flat_exec(const uint8_t* b, int64_t b_bytes,
                             const int32_t* meta, int32_t trip_cap,
                             const int32_t* starts, const int32_t* ntrips,
                             uint8_t* out, int64_t out_pitch,
                             int64_t dst_max, int32_t out_rows,
                             int32_t n_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows > 0 && dst_max > 0) {
    const int vec = ((reinterpret_cast<uintptr_t>(out) |
                      static_cast<uint64_t>(out_pitch) |
                      static_cast<uint64_t>(dst_max)) & 15u) == 0;
    const int64_t units = vec ? dst_max / 16 : dst_max;
    int gx = static_cast<int>((units + kZeroThreads - 1) / kZeroThreads);
    gx = gx < 1 ? 1 : (gx > 64 ? 64 : gx);
    flat_zero_kernel<<<dim3(gx, n_rows), kZeroThreads, 0, st>>>(
        out, out_pitch, dst_max, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_rows > 0 && trip_cap > 0) {
    flat_pieces_kernel<<<dim3(kNsub * trip_cap, n_rows), kPieceThreads, 0,
                         st>>>(b, b_bytes, meta, trip_cap, starts, ntrips,
                               out, out_pitch, dst_max, out_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
