// Sequential per-block Snappy decode: a parser warp and a writer warp per
// block, several blocks per SM.
//
// Replaces snappy_tpu/kernels/pallas_decode.py:_kernel (and its per-element
// body _step_one), the Pallas decoder that interleaves 8 blocks per grid
// step and moves bytes as rolled 128-byte windows of int32 rows.  Each
// block is an independent serial decoder.  The contract is
// decode_seq.decode_blocks_seq_plain: out[b, :d] are the bytes decoded
// before the first failing element, the rest of the row is zero, err[b] is
// the JAX kernel's code.
//
// What bounds it on this card: the serial chain of each block, not bytes
// (a 64 KiB row moves ~100 KB in ~10^4 elements).  The card keeps
// sm_count x 3 of these chains in flight; the design shortens each chain
// and splits it in two that overlap:
//
// * Parser (warp 0).  It parses 32 bytes of the element stream at a time:
//   lane i decodes a header speculatively at s + i, and the chain of
//   element starts is followed from lane 0 with one shuffle per element
//   (the scheme of RAPIDS cuDF's unsnap.cu and of Sitaridi et al., 2016).
//   Each start lane then checks its element in parallel with _step_one's
//   wrapping int32 tests (they need only s, d, clen and dlen); the first
//   failing lane (ballot + ffs) freezes the cursors and sets err.  The
//   compressed bytes are read from device memory through L1, one line
//   prefetched ahead, so no row is staged in shared memory.
// * Writer (warp 1).  The parser passes the valid elements as records
//   (d, len, source offset or copy offset, kind) through a ring of 4 slots
//   of one window each; the writer executes them in order into a 64 KiB
//   shared image of the output row.
// * Residency.  64 KiB image + 2 KiB ring a block: three CTAs fit an SM.
//   The runtime launches at least sm_count x snc_seq_decode_blocks_per_sm
//   rows (kernels/decode_seq.resident_rows), so every SM holds three.
//
// The ring, the writer, the header decode, the chain of starts and the
// row's end are csrc/serial_decode.cuh's, shared with decode_par.cu; the
// parser here is this kernel's own (its first failure freezes the
// cursors).  Rows wider than the image (out_max > 65536) are decoded in
// device memory instead (the same code through a global pointer).  Bytes
// the walk reads past the row (a header at the row end) read as zero;
// they cannot change the result, since an element whose header passes its
// payload end fails on `hdr > clen - s` alone.

#include <cstdint>
#include <cuda_runtime.h>

#include "serial_decode.cuh"

namespace {

using namespace serial;

constexpr int kErrNone = 0;
constexpr int kErrLiteral = 1;
constexpr int kErrCopy = 2;
constexpr int kErrDstShort = 3;
constexpr int kErrSrcTrail = 4;

struct SeqWalk {
  // warp 0: parse windows into records, up to the first failing element
  static __device__ void parse(Shared* sh, const uint8_t* c, int32_t cmax,
                               int64_t lim, int32_t s, int32_t clen,
                               int32_t dlen, int lane) {
    int32_t d = 0;
    int e = kErrNone;
    RingOut ring(sh);
    const unsigned lt = (1u << lane) - 1u;
    while (true) {
      int4* rec = ring.acquire();
      int cnt = 0;
      if (s < clen) {
        if (lane == 0 && static_cast<int64_t>(s) + 384 < lim)
          asm volatile("prefetch.global.L1 [%0];" ::"l"(c + s + 384));
        // speculative header at q = s + lane
        const int64_t q = static_cast<int64_t>(s) + lane;
        const Header h = header_at(c, lim, q);
        // bytes of the element in the stream
        const int64_t adv = h.tag == 0 ? static_cast<int64_t>(h.hdr) + h.ln
                                       : h.hdr;
        const int nl = (adv >= 1 && lane + adv < 32)
                           ? lane + static_cast<int>(adv) : 32;
        const Chain ch = follow_chain(nl, h.ln, d, s, clen, lane);
        // _step_one's checks, one start lane each
        const bool start = (ch.starts >> lane) & 1u;
        const int32_t sq = static_cast<int32_t>(q);
        bool bad;
        if (h.tag == 0) {
          const int32_t room = sub32(clen, sq);
          bad = h.hdr > room || h.ln <= 0 || h.ln > sub32(dlen, ch.my_d) ||
                h.ln > sub32(room, h.hdr);
        } else {
          bad = h.hdr > sub32(clen, sq) || h.ln <= 0 ||
                h.ln > sub32(dlen, ch.my_d) || h.off <= 0 || h.off > ch.my_d;
        }
        const unsigned badm = __ballot_sync(kFull, start && bad);
        unsigned okm = ch.starts;
        if (badm) {
          const int f = __ffs(badm) - 1;
          okm = ch.starts & ((1u << f) - 1u);
          e = __shfl_sync(kFull, h.tag, f) == 0 ? kErrLiteral : kErrCopy;
          d = __shfl_sync(kFull, ch.my_d, f);
          s += f;
        } else {
          const int64_t adv_p = __shfl_sync(kFull, adv, ch.p);
          s = static_cast<int32_t>(static_cast<int64_t>(s) + ch.p + adv_p);
          d = ch.dd;
        }
        if ((okm >> lane) & 1u)
          rec[__popc(okm & lt)] = make_int4(
              ch.my_d, h.ln, h.tag == 0 ? sq + h.hdr : h.off, h.tag == 0 ? 0 : 1);
        cnt = __popc(okm);
      }
      const bool last = !(s < clen && e == kErrNone);
      ring.publish(cnt, last, lane);
      if (last) break;
    }
    ring.drain();
    if (e == kErrNone && d != dlen) e = kErrDstShort;
    if (e == kErrNone && s != clen) e = kErrSrcTrail;
    if (lane == 0) {
      sh->d = d;
      sh->err = e;
    }
  }

  // the bytes decoded before the first failing element
  static __device__ int64_t written(const Shared& sh, int32_t out_max) {
    return sh.d < out_max ? sh.d : out_max;
  }
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
seq_decode_kernel(const uint8_t* __restrict__ comp, int64_t pitch,
                  int32_t cmax, const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ clens,
                  const int32_t* __restrict__ dlens, uint8_t* out,
                  int32_t out_max, int32_t* __restrict__ err) {
  decode_row<SeqWalk, kShared>(comp, pitch, cmax, starts, clens, dlens, out,
                               out_max, err);
}

template <bool kShared>
cudaError_t prepare(int smem) {
  return cudaFuncSetAttribute(seq_decode_kernel<kShared>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" int snc_seq_decode(const uint8_t* comp, int64_t pitch,
                              int32_t cmax, const int32_t* starts,
                              const int32_t* clens, const int32_t* dlens,
                              uint8_t* out, int32_t out_max, int32_t* err,
                              int32_t n_rows, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = smem_bytes(out_max);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (use_shared(out_max)) {
    rc = prepare<true>(smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    seq_decode_kernel<true><<<n_rows, kThreads, smem, st>>>(
        comp, pitch, cmax, starts, clens, dlens, out, out_max, err);
  } else {
    rc = prepare<false>(smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    seq_decode_kernel<false><<<n_rows, kThreads, smem, st>>>(
        comp, pitch, cmax, starts, clens, dlens, out, out_max, err);
  }
  return static_cast<int>(cudaGetLastError());
}

// blocks of the kernel one SM holds at once for rows of out_max bytes
extern "C" int snc_seq_decode_blocks_per_sm(int32_t out_max, int* blocks) {
  const int smem = smem_bytes(out_max);
  cudaError_t rc;
  if (use_shared(out_max)) {
    rc = prepare<true>(smem);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, seq_decode_kernel<true>, kThreads, smem);
  } else {
    rc = prepare<false>(smem);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, seq_decode_kernel<false>, kThreads, smem);
  }
  return static_cast<int>(rc);
}
