// Flat-plan executor: runs a packed flat plan as a plain copy, one CTA
// per (row, 8 KiB slab of the output row).
//
// Replaces snappy_tpu/kernels/decode_flat.py:_flat_kernel (the Pallas
// kernel behind decode_blocks_flat and encode_flat.encode_blocks_flat),
// which gathers piece rows with one-hot MXU matmuls, aligns lanes with
// rolls and composes the output with a second one-hot matmul.  None of
// that is needed here: the contract is execute_flat_np, where each valid
// piece copies its bytes l in [dphi, min(dphi + lenm1, 127)]
//     out[(D + drel) * 128 + l] = B[(S + qrel) * 128 + phi + l]
// with D = min(Dq, out_rows - 128) (the compose clamp, drel shifted by
// Dq - D, so a piece's row D + drel is Dq plus its drel field) and
// phi = (128 - rot) & 127.  Bytes at or past dst_max are dropped, B
// reads at or past b_bytes give 0, and bytes no piece writes are 0.
//
// Word layouts (pack_trips): meta row 2*NSUB*t + s holds the A words
// (qrel | rot << 7) of trip t's subpanel s, row 2*NSUB*t + NSUB + s its B
// words (dphi | lenm1 << 7 | drel << 14 | VALID); the subpanel's
// S | Dq << 10 | rot << 20 word is starts[t >> 5, (t & 31) * 4 + s], i.e.
// word 4 t + s of the row's starts plane; ntrips & 0xFFFF is the trip
// count (the high half counts aligned trips).
//
// Design: one launch, each output byte written to device memory once.
// The grid is rows x slabs of 64 output rows (8 slabs for a 64 KiB
// decode row, 10 for an 80 KiB encode-replay row), whatever the trip cap.
// A CTA:
// 1. zeroes its slab image in shared memory and keeps the used subpanels
//    (4 per trip, ntrips of them) whose destination window
//    [Dq, Dq + 128) rows meets the slab;
// 2. lists their valid pieces that land in the slab (a lane a piece, the
//    A and B words read coalesced), as (source offset, slab offset,
//    length) descriptors;
// 3. spreads the pieces' 16-byte destination chunks over all its
//    threads (a prefix sum of chunks per piece, a binary search per
//    chunk): a chunk's source bytes come in as five aligned 4-byte loads,
//    several chunks' loads in flight at once, are funnel-shifted to the
//    chunk's alignment and stored as words (a word the piece fills
//    whole) or or-ed in (a word it shares with a neighbouring piece);
// 4. writes the slab out with 16-byte stores where the output row
//    allows, byte stores else.
// Pieces write disjoint bytes by construction, so they need no order.
// A round lists at most kCap pieces; a slab with more takes more rounds.
//
// Bound on this card: memory traffic of ~1 byte read and 1 byte written
// per output byte plus the plan words of the used trips; a subpanel's
// window meets two or three slabs, so its words are read that often
// (from L2).  The 512 CTAs of 64 decode rows fit the 132 SMs in one wave
// at four CTAs an SM (64 registers a thread); what is left is the
// latency of each step (select, list, copy, write out) of a CTA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 128;
constexpr int kNsub = 4;
constexpr int32_t kValid = 1 << 21;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlabRows = 64;              // output rows of 128 B a CTA
constexpr int kSlab = kSlabRows * kVec;    // 8 KiB of shared memory
constexpr int kPlane = 8 * kVec;           // subpanel words a starts plane holds
constexpr int kCap = 1024;                 // piece descriptors a round
constexpr int kItems = kCap / 32;          // (subpanel, 32 pieces) items a round
constexpr int kUnroll = 2;                 // chunks a thread has in flight
constexpr int kMinBlocks = 4;              // CTAs an SM: 64 registers

// the bytes of the word at slab offset x that lie in [d0, d1)
__device__ __forceinline__ uint32_t byte_mask(int x, int d0, int d1) {
  uint32_t m = 0;
#pragma unroll
  for (int y = 0; y < 4; ++y)
    if (x + y >= d0 && x + y < d1) m |= 0xFFu << (8 * y);
  return m;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
flat_exec_kernel(const uint8_t* __restrict__ b, int64_t b_bytes,
                 const int32_t* __restrict__ meta, int32_t trip_cap,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ ntrips,
                 uint8_t* __restrict__ out, int64_t out_pitch,
                 int64_t dst_max, int32_t out_rows, int32_t n_slabs) {
  __shared__ __align__(16) uint32_t slab32[kSlab / 4];
  __shared__ int16_t sel[kPlane];
  __shared__ uint32_t d_src[kCap];   // B offset of the piece's first byte
  __shared__ uint32_t d_dst[kCap];   // slab offset | length << 16
  __shared__ int pre[kCap + 1];      // chunks before each piece
  __shared__ int warp_sum[kWarps];
  __shared__ int n_sel, n_desc;

  const int64_t row = blockIdx.x / n_slabs;
  const int r0 = (blockIdx.x % n_slabs) * kSlabRows;  // the slab's first row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_sub = kNsub * min(ntrips[row] & 0xFFFF, trip_cap);
  const int32_t* plane = starts + row * kPlane;
  const int32_t* meta_row = meta + row * (8LL * trip_cap * kVec);
  const uint8_t* b_row = b + row * b_bytes;
  // 4-byte source loads need 4-byte rows; else byte loads
  const bool words = ((reinterpret_cast<uintptr_t>(b) |
                       static_cast<uint64_t>(b_bytes)) & 3) == 0;
  uint8_t* slab = reinterpret_cast<uint8_t*>(slab32);

  uint4* slab4 = reinterpret_cast<uint4*>(slab32);
  for (int i = tid; i < kSlab / 16; i += kThreads)
    slab4[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) n_sel = 0;
  __syncthreads();

  // 1. the used subpanels whose window [Dq, Dq + 128) meets the slab
  for (int base = 0; base < n_sub; base += kThreads) {
    const int i = base + tid;
    bool hit = false;
    if (i < n_sub) {
      const int dq = (plane[i] >> 10) & 1023;
      hit = dq < r0 + kSlabRows && dq + kVec > r0;
    }
    const unsigned m = __ballot_sync(0xFFFFFFFFu, hit);
    int pos = 0;
    if (lane == 0 && m) pos = atomicAdd(&n_sel, __popc(m));
    pos = __shfl_sync(0xFFFFFFFFu, pos, 0);
    if (hit)
      sel[pos + __popc(m & ((1u << lane) - 1u))] = static_cast<int16_t>(i);
  }
  __syncthreads();
  const int n_items = 4 * n_sel;

  for (int item0 = 0; item0 < n_items; item0 += kItems) {
    if (tid == 0) n_desc = 0;
    __syncthreads();
    // 2. the pieces of up to kItems (subpanel, 32-piece) items
    const int item_end = min(n_items, item0 + kItems);
    for (int it = item0 + warp; it < item_end; it += kWarps) {
      const int i = sel[it >> 2];
      const int t = i >> 2;
      const int s = i & 3;
      const int k = 32 * (it & 3) + lane;
      const int32_t w = plane[i];
      const int S = w & 1023;
      const int Dq = (w >> 10) & 1023;
      const int D = min(Dq, out_rows - kVec);
      const int32_t a = meta_row[(2 * kNsub * t + s) * kVec + k];
      const int32_t bw = meta_row[(2 * kNsub * t + kNsub + s) * kVec + k];
      const int drow = D + ((bw >> 14) & 127) + (Dq - D);
      const int dphi = bw & 127;
      const int64_t gdst = static_cast<int64_t>(drow) * kVec + dphi;
      const int len = static_cast<int>(min(
          static_cast<int64_t>(min(dphi + ((bw >> 7) & 127), kVec - 1) - dphi + 1),
          dst_max - gdst));
      const bool keep = (bw & kValid) && drow >= r0 &&
                        drow < r0 + kSlabRows && len > 0;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, keep);
      int pos = 0;
      if (lane == 0 && m) pos = atomicAdd(&n_desc, __popc(m));
      pos = __shfl_sync(0xFFFFFFFFu, pos, 0) + __popc(m & ((1u << lane) - 1u));
      if (keep) {
        const int qrel = a & 127;
        const int rot = (a >> 7) & 127;
        d_src[pos] = static_cast<uint32_t>(
            (S + qrel) * kVec + ((kVec - rot) & (kVec - 1)) + dphi);
        d_dst[pos] = static_cast<uint32_t>((drow - r0) * kVec + dphi) |
                     (static_cast<uint32_t>(len) << 16);
      }
    }
    __syncthreads();

    // 3a. chunk prefix: pre[p] = 16-byte chunks of the pieces before p
    const int nd = n_desc;
    int cnt[4];
    int mine = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 4 * tid + e;
      cnt[e] = 0;
      if (p < nd) {
        const uint32_t dd = d_dst[p];
        const int d0 = dd & 0xFFFF;
        cnt[e] = ((d0 + static_cast<int>(dd >> 16) - 1) >> 4) - (d0 >> 4) + 1;
      }
      mine += cnt[e];
    }
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += x;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (w < warp) before += warp_sum[w];
    int run = before + incl - mine;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 4 * tid + e;
      if (p < nd) pre[p] = run;
      run += cnt[e];
    }
    if (tid == kThreads - 1) pre[nd] = run;
    __syncthreads();

    // 3b. every chunk: loads first, then the slab words
    const int units = pre[nd];
    for (int u0 = 0; u0 < units; u0 += kThreads * kUnroll) {
      uint32_t val[kUnroll][4];
      uint32_t msk[kUnroll][4];
      int at[kUnroll];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const int u = u0 + r * kThreads + tid;
        at[r] = -1;
        if (u >= units) continue;
        int lo = 0, hi = nd;  // the piece p with pre[p] <= u < pre[p + 1]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (pre[mid] <= u) lo = mid; else hi = mid;
        }
        const uint32_t dd = d_dst[lo];
        const int d0 = dd & 0xFFFF;
        const int d1 = d0 + static_cast<int>(dd >> 16);
        const int c16 = ((d0 >> 4) + (u - pre[lo])) << 4;  // chunk's slab offset
        const int64_t sa = static_cast<int64_t>(d_src[lo]) + (c16 - d0);
        at[r] = c16 >> 2;
        uint32_t src[4];
        if (words) {
          const int64_t q0 = sa >> 2;
          const int sh = static_cast<int>(sa & 3) * 8;
          const uint32_t* b32 = reinterpret_cast<const uint32_t*>(b_row);
          uint32_t wv[5];
#pragma unroll
          for (int m = 0; m < 5; ++m)
            wv[m] = 4 * (q0 + m) + 4 <= b_bytes ? __ldg(b32 + q0 + m) : 0u;
#pragma unroll
          for (int m = 0; m < 4; ++m) src[m] = __funnelshift_r(wv[m], wv[m + 1], sh);
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            uint32_t x = 0;
#pragma unroll
            for (int y = 0; y < 4; ++y) {
              const int64_t si = sa + 4 * m + y;
              const int xb = c16 + 4 * m + y;
              if (xb >= d0 && xb < d1 && si < b_bytes)
                x |= static_cast<uint32_t>(__ldg(b_row + si)) << (8 * y);
            }
            src[m] = x;
          }
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          msk[r][m] = byte_mask(c16 + 4 * m, d0, d1);
          val[r][m] = src[m] & msk[r][m];
        }
      }
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        if (at[r] < 0) continue;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (msk[r][m] == 0xFFFFFFFFu) slab32[at[r] + m] = val[r][m];
          else if (msk[r][m]) atomicOr(&slab32[at[r] + m], val[r][m]);
        }
      }
    }
    __syncthreads();
  }

  // 4. the slab's bytes below dst_max, written once
  uint8_t* o = out + row * out_pitch + static_cast<int64_t>(r0) * kVec;
  const int lim = static_cast<int>(
      min(static_cast<int64_t>(kSlab), dst_max - static_cast<int64_t>(r0) * kVec));
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int v = tid; v < lim / 16; v += kThreads) o4[v] = slab4[v];
    done = lim & ~15;
  }
  for (int x = done + tid; x < lim; x += kThreads) o[x] = slab[x];
}

}  // namespace

extern "C" int snc_flat_exec(const uint8_t* b, int64_t b_bytes,
                             const int32_t* meta, int32_t trip_cap,
                             const int32_t* starts, const int32_t* ntrips,
                             uint8_t* out, int64_t out_pitch,
                             int64_t dst_max, int32_t out_rows,
                             int32_t n_rows, void* stream) {
  if (n_rows > 0 && dst_max > 0) {
    const int64_t n_slabs = (dst_max + kSlab - 1) / kSlab;
    const int64_t grid = n_rows * n_slabs;
    if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    flat_exec_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        b, b_bytes, meta, trip_cap, starts, ntrips, out, out_pitch, dst_max,
        out_rows, static_cast<int32_t>(n_slabs));
  }
  return static_cast<int>(cudaGetLastError());
}
