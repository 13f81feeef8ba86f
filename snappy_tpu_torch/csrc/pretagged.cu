// Hybrid decode's device half: execute host-parsed element records, a CTA
// per row, its warps specialised: a loader, a literal writer, a copy
// runner.
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
// What bounds it on this card: the serial work of a row, not bytes (a
// 64 KiB row moves ~280 KB of records and payload in ~13,000 records, most
// of them copies of 4-64 bytes).  A row's copies form chains (a copy reads
// an earlier copy's output) some 400 deep on text; the design runs the
// copies that do not depend on each other at once, 32 at a time:
//
// * Loader (warp 0).  Brings the payload row into shared memory and the
//   records through a ring of kStages tiles of kTile records, with the
//   bulk asynchronous copy (cp.async.bulk global -> shared, completing on
//   an mbarrier), so later tiles land while earlier ones run.  Rows that
//   are not 16-byte aligned take plain loads.
// * Literal writers (warps 2 and 3, alternate tiles).  Per tile: write the
//   tile's literals into the row image (one lane per literal of at most
//   32 bytes, the warp per longer one), compact the tile's copies in place
//   in its ring slot, and give each copy its wait: a mask of its
//   producers in its group of 32 copies (the copies whose outputs meet its
//   sources; starts and ends increase along a row, so two binary searches
//   over the group's lanes).  They run ahead of the copies: their writes
//   never meet the copies' (disjoint outputs), and a copy reads only bytes
//   below its own start.
// * Copy runner (warp 1).  A tile's copies in groups of 32, a lane each,
//   in rounds: each round (one ballot of the pending lanes) the lanes
//   whose producers are done copy, lane by lane, out[d + i] = out[d - off
//   + i % off]; __syncwarp.  No round reads what it writes, and the lowest
//   pending lane is always ready.  The rounds a group takes are the depth
//   of its copies' chains (the CPU model: execute_records_model).
// * The row image is in shared memory (rows of at most 64 KiB; wider rows
//   are built in device memory by the same code, with a fence where shared
//   memory ordering sufficed).  After the last tile the whole CTA writes
//   the row with 16-byte stores, zeros after dlen.
//
// Bytes a record would write at or past min(dlen, out_max) are dropped;
// a literal byte read past the payload row reads as zero, and a copy with
// an offset outside [1, d] writes zeros (neither occurs in parsed records).

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // warps 0-3 the roles, all 8 the row write
constexpr int kTile = 512;       // records a ring slot
constexpr int kStages = 4;       // record ring slots
constexpr int kLitWarps = 2;     // literal writers, on alternate tiles
constexpr int kImage = 65536;    // widest row decoded in shared memory
constexpr int kSmemMax = 232448; // 227 KiB of dynamic shared memory a CTA
constexpr int kBatch = 8;        // bytes a lane loads before it stores
constexpr int kLaneLit = 32;     // longest literal written by one lane
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Ctrl {
  uint64_t full[kStages];   // slot landed: the loader's arrival + its bytes
  uint64_t lit[kStages];    // literals written, copies compacted (32 lanes)
  uint64_t empty[kStages];  // copies done, slot free (32 lanes)
  uint64_t pay;             // payload row landed
  int32_t ncopy[kStages];   // copies compacted in each slot
};
constexpr int kCtrl = 128;  // bytes before the ring
static_assert(2 + kLitWarps <= kThreads / 32, "a warp for each role");
static_assert(sizeof(Ctrl) <= kCtrl, "control block");

__device__ __forceinline__ int32_t round16(int32_t n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   saddr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity; a wait
// that outlasts kWaitCycles (seconds: a tile takes microseconds) can only
// be a fault of the schedule, and traps (the launch fails) rather than
// hanging the card
constexpr long long kWaitCycles = 1ll << 35;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// global -> shared, `bytes` a multiple of 16, both ends 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// warp 0: the payload row, then the record tiles through the ring
__device__ __forceinline__ void loader(Ctrl* ctl, int4* ring, uint8_t* comp_s,
                                       const uint8_t* c, int32_t cmax,
                                       bool stage, const int4* rrow,
                                       int32_t nt, int lane) {
  if (stage && aligned16(c) && (cmax & 15) == 0) {
    if (lane == 0 && cmax > 0) {
      mbar_expect(&ctl->pay, static_cast<uint32_t>(cmax));
      bulk_load(comp_s, c, static_cast<uint32_t>(cmax), &ctl->pay);
    } else if (lane == 0) {
      mbar_arrive(&ctl->pay);
    }
  } else {
    if (stage)
      for (int32_t i = lane; i < cmax; i += 32) comp_s[i] = __ldg(c + i);
    __syncwarp();
    if (lane == 0) mbar_arrive(&ctl->pay);
  }
  const bool bulk = aligned16(rrow);
  for (int32_t base = 0, t = 0; base < nt; base += kTile, ++t) {
    const int s = t % kStages;
    const int k = t / kStages;
    const int cnt = nt - base < kTile ? nt - base : kTile;
    int4* slot = ring + s * kTile;
    if (k > 0) mbar_wait(&ctl->empty[s], (k - 1) & 1);
    if (bulk) {
      if (lane == 0) {
        // the slot was last written by the literal writer's compaction
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect(&ctl->full[s], static_cast<uint32_t>(cnt) * 16u);
        bulk_load(slot, rrow + base, static_cast<uint32_t>(cnt) * 16u,
                  &ctl->full[s]);
      }
    } else {
      const int32_t* r32 = reinterpret_cast<const int32_t*>(rrow + base);
      for (int i = lane; i < cnt; i += 32)
        slot[i] = make_int4(__ldg(r32 + 4 * i), __ldg(r32 + 4 * i + 1),
                            __ldg(r32 + 4 * i + 2), __ldg(r32 + 4 * i + 3));
      __syncwarp();
      if (lane == 0) mbar_arrive(&ctl->full[s]);
    }
  }
}

// one lane: out[d, d + n) = payload[a, a + n), bytes past the row read 0
template <typename Src>
__device__ __forceinline__ void lane_literal(uint8_t* o, int32_t d, int32_t n,
                                             Src src, int32_t a,
                                             int32_t cmax) {
  if (a >= 0 && static_cast<int64_t>(a) + n <= cmax) {
    for (int32_t i = 0; i < n; i += kBatch) {
      uint8_t v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) v[k] = i + k < n ? src(a + i + k) : 0;
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (i + k < n) o[d + i + k] = v[k];
    }
  } else {
    for (int32_t i = 0; i < n; ++i) {
      const int64_t si = static_cast<int64_t>(a) + i;
      o[d + i] = si >= 0 && si < cmax ? src(static_cast<int32_t>(si)) : 0;
    }
  }
}

// the warp: one literal of more than kLaneLit bytes
template <typename Src>
__device__ __forceinline__ void warp_literal(uint8_t* o, int32_t d, int32_t n,
                                             Src src, int32_t a, int32_t cmax,
                                             int lane) {
  const bool inside = a >= 0 && static_cast<int64_t>(a) + n <= cmax;
  for (int32_t i = lane; i < n; i += 128) {
    uint8_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int32_t j = i + 32 * k;
      const int64_t si = static_cast<int64_t>(a) + j;
      v[k] = j < n && (inside || (si >= 0 && si < cmax))
                 ? src(static_cast<int32_t>(si)) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + 32 * k < n) o[d + i + 32 * k] = v[k];
  }
}

// warps 2 and 3 (tiles first, first + kLitWarps, ...): per tile, the
// literals into the image, then the copies compacted in place in the slot
// as (d, len, offset or 0 for zeros), then each group of 32 compacted
// copies' waits: lane j's producers, the lanes i < j of its group whose
// outputs [d_i, d_i + len_i) meet its sources [d - off, d - off +
// min(off, len)), a range [lo, hi) (starts and ends increase along the
// group: two binary searches), kept as a lane mask in place of .w
template <typename Src>
__device__ __forceinline__ void literal_writer(Ctrl* ctl, int4* ring,
                                               uint8_t* o, Src src,
                                               int32_t cmax, int32_t nt,
                                               int32_t lim, int first,
                                               int lane) {
  const unsigned lt = (1u << lane) - 1u;
  mbar_wait(&ctl->pay, 0);
  for (int32_t t = first, base = first * kTile; base < nt;
       t += kLitWarps, base += kLitWarps * kTile) {
    const int s = t % kStages;
    const int cnt = nt - base < kTile ? nt - base : kTile;
    int4* slot = ring + s * kTile;
    mbar_wait(&ctl->full[s], (t / kStages) & 1);
    int32_t nc = 0;
    for (int c0 = 0; c0 < cnt; c0 += 32) {
      const int r = c0 + lane;
      const int4 rec = r < cnt ? slot[r] : make_int4(0, 0, 0, -1);
      const int32_t ln = rec.y, a = rec.z, d = rec.w;
      const bool valid = r < cnt && d >= 0 && d < lim && ln > 0;
      const int32_t n_w = valid ? (ln < lim - d ? ln : lim - d) : 0;
      const bool cp = valid && rec.x != 0;
      const bool li = valid && rec.x == 0;
      const unsigned cpm = __ballot_sync(kFull, cp);
      __syncwarp();  // every lane has read its record before any rewrite
      if (cp)
        slot[nc + __popc(cpm & lt)] =
            make_int4(d, n_w, a <= 0 || a > d ? 0 : a, 0);
      nc += __popc(cpm);
      if (li && n_w <= kLaneLit)
        lane_literal(o, d, n_w, src, a, cmax);
      unsigned lm = __ballot_sync(kFull, li && n_w > kLaneLit);
      while (lm) {
        const int j = __ffs(lm) - 1;
        lm &= lm - 1;
        warp_literal(o, __shfl_sync(kFull, d, j), __shfl_sync(kFull, n_w, j),
                     src, __shfl_sync(kFull, a, j), cmax, lane);
      }
    }
    __syncwarp();
    for (int32_t g = 0; g < nc; g += 32) {
      const bool have = g + lane < nc;
      const int4 rec = have ? slot[g + lane] : make_int4(INT_MAX, 0, 0, 0);
      const int32_t end = have ? rec.x + rec.y : INT_MAX;  // past the output
      const int32_t sl = rec.x - rec.z;
      const int32_t sh = sl + (rec.z < rec.y ? rec.z : rec.y);
      int hi = 0, lo = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kFull, rec.x, hi + step - 1) < sh) hi += step;
        if (__shfl_sync(kFull, end, lo + step - 1) <= sl) lo += step;
      }
      hi = hi < lane ? hi : lane;
      const unsigned wait = rec.z == 0 || lo >= hi
                                ? 0u
                                : ((1u << hi) - 1u) & ~((1u << lo) - 1u);
      if (have) slot[g + lane].w = static_cast<int32_t>(wait);
    }
    if (lane == 0) ctl->ncopy[s] = nc;
    __syncwarp();
    mbar_arrive(&ctl->lit[s]);
  }
}

// one lane: out[d + i] = out[d - a + i % a] for i < n; a == 0 zeros.
// All sources lie below d, so a batch's loads need not wait for its
// stores, and every load reads a source byte (no branch around it): the
// index of byte i is i itself, clamped to n - 1, when the copy does not
// overlap its output (a >= n), else (r + k) % a, computed for each k on
// its own by a multiply with m = floor(65536 / a) + 1 (exact for
// r + k < 2 kBatch) when a < kBatch, by one wrap otherwise
__device__ __forceinline__ void lane_copy(uint8_t* o, int32_t d, int32_t n,
                                          int32_t a) {
  if (a == 0) {
    for (int32_t i = 0; i < n; ++i) o[d + i] = 0;
    return;
  }
  const uint8_t* s = o + (d - a);
  if (a >= n && n <= kBatch) {
    uint8_t v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) v[k] = s[min(k, n - 1)];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (k < n) o[d + k] = v[k];
    return;
  }
  if (a >= n) {
    for (int32_t i = 0; i < n; i += kBatch) {
      uint8_t v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) v[k] = s[min(i + k, n - 1)];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (i + k < n) o[d + i + k] = v[k];
    }
    return;
  }
  const bool small = a < kBatch;
  const uint32_t m =
      small ? static_cast<uint32_t>(65536.0f / static_cast<float>(a)) + 1u
            : 0u;
  int32_t r = 0;  // i % a
  for (int32_t i = 0; i < n; i += kBatch) {
    uint8_t v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int32_t x = r + k;
      const int32_t q = small ? static_cast<int32_t>(
                                    (static_cast<uint32_t>(x) * m) >> 16)
                              : (x >= a);
      v[k] = s[x - a * q];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (i + k < n) o[d + i + k] = v[k];
    const int32_t x = r + kBatch;
    r = x - a * (small ? static_cast<int32_t>(
                             (static_cast<uint32_t>(x) * m) >> 16)
                       : (x >= a));
  }
}

// warp 1: per tile, the compacted copies in groups of 32, a lane each, in
// rounds: a pending lane runs once the lanes of its wait mask are done
// (one ballot a round), copying lane by lane out[d + i] = out[d - off + i
// % off]; __syncwarp.  Its other sources are final: literals (the tile's
// were written before its copies reached this warp), earlier groups and
// tiles; and no lane of a round writes what another reads, since a
// producer still pending holds its consumer back.  The lowest pending
// lane waits on nothing pending (its producers are lower lanes), so every
// round makes progress.
template <bool kShared>
__device__ __forceinline__ void copy_runner(Ctrl* ctl, const int4* ring,
                                            uint8_t* o, int32_t nt,
                                            int lane) {
  for (int32_t base = 0, t = 0; base < nt; base += kTile, ++t) {
    const int s = t % kStages;
    const int4* slot = ring + s * kTile;
    mbar_wait(&ctl->lit[s], (t / kStages) & 1);
    const int32_t nc = ctl->ncopy[s];
    // each group's records, loaded a group ahead
    int4 nrec = lane < nc ? slot[lane] : make_int4(0, 0, 0, 0);
    for (int32_t g = 0; g < nc; g += 32) {
      const bool have = g + lane < nc;
      const int4 rec = nrec;
      if (g + 32 + lane < nc) nrec = slot[g + 32 + lane];
      const unsigned wait = static_cast<unsigned>(rec.w);
      bool pending = have;
      while (true) {
        const unsigned pend = __ballot_sync(kFull, pending);
        if (!pend) break;
        if (pending && (pend & wait) == 0) {
          lane_copy(o, rec.x, rec.y, rec.z);
          pending = false;
        }
        if (!kShared) __threadfence_block();
        __syncwarp();
      }
    }
    __syncwarp();
    mbar_arrive(&ctl->empty[s]);
  }
}

template <bool kShared, bool kStaged>
__global__ void __launch_bounds__(kThreads)
pretagged_kernel(const uint8_t* __restrict__ comp, int64_t pitch,
                 int32_t cmax, const int4* __restrict__ recs, int32_t t_max,
                 const int32_t* __restrict__ n_tags,
                 const int32_t* __restrict__ dlens, uint8_t* out,
                 int32_t out_max) {
  extern __shared__ __align__(128) uint8_t smem[];
  Ctrl* ctl = reinterpret_cast<Ctrl*>(smem);
  int4* ring = reinterpret_cast<int4*>(smem + kCtrl);
  uint8_t* image = reinterpret_cast<uint8_t*>(ring + kStages * kTile);
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

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ctl->full[s], 1);
      mbar_init(&ctl->lit[s], 32);
      mbar_init(&ctl->empty[s], 32);
    }
    mbar_init(&ctl->pay, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    loader(ctl, ring, comp_s, c, cmax, kStaged, rrow, nt, lane);
  } else if (warp == 1) {
    copy_runner<kShared>(ctl, ring, o, nt, lane);
  } else if (warp < 2 + kLitWarps) {
    const int first = warp - 2;
    if (kStaged) {
      literal_writer(ctl, ring, o,
                     [comp_s](int32_t i) -> uint8_t { return comp_s[i]; },
                     cmax, nt, lim, first, lane);
    } else {
      literal_writer(ctl, ring, o,
                     [c](int32_t i) -> uint8_t { return __ldg(c + i); },
                     cmax, nt, lim, first, lane);
    }
  }
  __syncthreads();

  // the row: [0, lim) from the image (in place when not shared), zeros
  // after; 16-byte stores where the row is 16-byte aligned
  const bool vec = (out_max & 15) == 0 && aligned16(orow);
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
int smem_bytes(int32_t out_max, int32_t cmax, bool* stage) {
  const int64_t fixed = kCtrl + kStages * kTile *
                                    static_cast<int64_t>(sizeof(int4)) +
                        (use_shared(out_max) ? ((out_max + 15) & ~15) : 0);
  const int64_t with_comp = fixed + ((static_cast<int64_t>(cmax) + 15) & ~15);
  *stage = with_comp <= kSmemMax;
  return static_cast<int>(*stage ? with_comp : fixed);
}

// the largest dynamic shared memory set on each device, per variant:
// cudaFuncSetAttribute runs once per (device, variant, size)
constexpr int kMaxDevices = 64;

template <bool kShared, bool kStaged>
cudaError_t prepare(int smem) {
  static std::atomic<int> set[kMaxDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && set[dev].load(std::memory_order_relaxed) >= smem)
    return cudaSuccess;
  rc = cudaFuncSetAttribute(pretagged_kernel<kShared, kStaged>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == cudaSuccess && known) {
    int cur = set[dev].load(std::memory_order_relaxed);
    while (cur < smem && !set[dev].compare_exchange_weak(cur, smem)) {
    }
  }
  return rc;
}

template <bool kShared, bool kStaged>
cudaError_t launch(const uint8_t* comp, int64_t pitch, int32_t cmax,
                   const int4* recs, int32_t t_max, const int32_t* n_tags,
                   const int32_t* dlens, uint8_t* out, int32_t out_max,
                   int32_t n_rows, int smem, cudaStream_t st) {
  const cudaError_t rc = prepare<kShared, kStaged>(smem);
  if (rc != cudaSuccess) return rc;
  pretagged_kernel<kShared, kStaged><<<n_rows, kThreads, smem, st>>>(
      comp, pitch, cmax, recs, t_max, n_tags, dlens, out, out_max);
  return cudaGetLastError();
}

}  // namespace

extern "C" int snc_pretagged(const uint8_t* comp, int64_t pitch,
                             int32_t cmax, const int32_t* recs, int32_t t_max,
                             const int32_t* n_tags, const int32_t* dlens,
                             uint8_t* out, int32_t out_max, int32_t n_rows,
                             void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  bool stage = false;
  const int smem = smem_bytes(out_max, cmax, &stage);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* r4 = reinterpret_cast<const int4*>(recs);
  cudaError_t rc;
  if (use_shared(out_max) && stage)
    rc = launch<true, true>(comp, pitch, cmax, r4, t_max, n_tags, dlens, out,
                            out_max, n_rows, smem, st);
  else if (use_shared(out_max))
    rc = launch<true, false>(comp, pitch, cmax, r4, t_max, n_tags, dlens,
                             out, out_max, n_rows, smem, st);
  else if (stage)
    rc = launch<false, true>(comp, pitch, cmax, r4, t_max, n_tags, dlens,
                             out, out_max, n_rows, smem, st);
  else
    rc = launch<false, false>(comp, pitch, cmax, r4, t_max, n_tags, dlens,
                              out, out_max, n_rows, smem, st);
  return static_cast<int>(rc);
}
