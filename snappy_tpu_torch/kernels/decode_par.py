"""Parallel Snappy decoder: the CUDA kernel and its plain version, the
portable decode engine.

Counterpart of ``snappy_tpu/kernels/decode_jnp.py`` (an XLA program, not
a Pallas kernel).  Each row of a padded ``[B, cmax]`` batch is one
independent element stream; ``decode_blocks`` returns ``(out uint8 [B,
out_max], err int32 [B])``.

Validation does not raise on the device: each row gets an error code
(0 = OK, the codes below are ``decode_jnp``'s, not ``decode_seq``'s:
the largest code whose condition holds at any tag the walk reaches),
and the host maps codes to CorruptError.  Lengths, offsets and sums are
int32 and wrap as JAX's do, so hostile 4-byte fields give JAX's codes.

On a CUDA tensor the wrapper launches ``csrc/decode_par.cu``: every row
cut into chunks of compressed bytes (``NARROW_CHUNK`` for rows of at most
``IMAGE`` bytes, ``CHUNK`` for wider ones), a warp a chunk walking
speculatively, the true walk's entry into each chunk where it meets the
chunk's walk, the chunks' tags counted and scanned, their records written
and the per-tag conditions ORed; then rows of at most ``IMAGE`` bytes go
to ``csrc/pretagged.cu``'s record executor (a CTA a row, copies in groups
of 32 that wait on their producers) and wider rows to per-byte source
pointers resolved by pointer jumping over the whole card.  On a CPU
tensor it runs the plain version, ``decode_blocks_plain``: JAX's program
in torch ops on the tensor's device (speculative tag parse at every byte
position -> orbit marking by pointer doubling -> one source pointer per
output byte -> pointer-doubling copy resolution -> one gather; the
``[B]`` axis stands in for ``vmap``; gathers clip their indices as the
JAX program does, and scatters with JAX's ``mode="drop"`` write into one
extra slot that is cut off; the doubling loops run their full round
counts, ``common_par``).  There is no other switch.  A row with ``err !=
0`` is all zero from the kernel; its bytes from the plain version are
what its gather gives (no caller reads them).  The kernel walks the
stream exactly, so on a CUDA tensor the round counts must bound nothing:
``2**tag_rounds >= ceil(cmax / 2)`` (every tag spans 2 bytes or more)
and ``2**ptr_rounds >= out_max``, else ValueError.

``decode_rows_model`` is the walk's decomposition on the host, for the
tests: 32-byte windows of speculative headers, the chain of starts, the
per-tag conditions ORed over the walk, the records executed in order
with a writer's guards; in a row wider than ``IMAGE`` the chunked walk
(speculative walks a chunk, the entries, counts and a scan, the
records) and the per-byte pointers in rounds of jumping.
``narrow_rows_model`` is the kernel's schedule for rows of at most
``IMAGE`` bytes: the chunked walk at ``NARROW_CHUNK``, then the record
executor's rounds (``decode_pretagged.execute_records_model``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from snappy_tpu_torch.errors import CorruptError
from snappy_tpu_torch.kernels.common_par import (
    exclusive_cumsum,
    mark_orbit,
    resolve_pointers,
    shifted,
)
from snappy_tpu_torch.spec.format import put_uvarint, read_uvarint

__all__ = ["decode_block_par", "decode_blocks", "decode_blocks_plain",
           "decode_rows_model", "narrow_rows_model", "ERR_NONE",
           "ERR_MESSAGES"]

ERR_NONE = 0
ERR_OVERRUN_INPUT = 1
ERR_SIZE_MISMATCH = 2
ERR_OVERRUN_OUTPUT = 3
ERR_BAD_OFFSET = 4
ERR_LITERAL_OVERRUN = 5

ERR_MESSAGES = {
    ERR_OVERRUN_INPUT: "element overruns input",
    ERR_SIZE_MISMATCH: "decoded size differs from preamble",
    ERR_OVERRUN_OUTPUT: "element overruns output",
    ERR_BAD_OFFSET: "zero copy offset or offset before block start",
    ERR_LITERAL_OVERRUN: "literal overruns input",
}

WINDOW = 32  # bytes the kernel's parser warp decodes speculatively at once
IMAGE = 65536  # widest row the record executor decodes in shared memory
CHUNK = 4096  # compressed bytes of a wider row a warp walks at once
NARROW_CHUNK = 512  # ... of a row of at most IMAGE bytes
LEAP = 64  # a speculative walk's tag leaving its chunk this far early ...
RESTARTS = 4  # ... starts the walk again after it, this often at most

# kernel launches made by decode_blocks (one per CUDA call)
launches = 0


def _select(conds, vals, default):
    """jnp.select: the value of the first true condition, else default."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def _word(b1, b2, b3, b4):
    """b1 | b2 << 8 | b3 << 16 | b4 << 24 as wrapping int32."""
    w = (b1.to(torch.int64) | (b2.to(torch.int64) << 8)
         | (b3.to(torch.int64) << 16) | (b4.to(torch.int64) << 24))
    return w.to(torch.int32)


def _parse_positions(comp: torch.Tensor):
    """Speculative tag parse at every byte position of int32 ``[B, n]``."""
    n = comp.shape[1]
    b0 = comp
    b1, b2, b3, b4 = (shifted(b0, k) for k in (1, 2, 3, 4))
    tag = b0 & 3
    x = b0 >> 2
    lit_conds = [x < 60, x == 60, x == 61, x == 62]
    lit_hdr = _select(lit_conds, [1, 2, 3, 4], torch.full_like(x, 5))
    lit_len = _select(lit_conds, [x, b1, b1 | (b2 << 8),
                                  b1 | (b2 << 8) | (b3 << 16)],
                      _word(b1, b2, b3, b4)) + 1
    is_lit = tag == 0
    is_c1 = tag == 1
    is_c2 = tag == 2
    hdr = _select([is_lit, is_c1, is_c2], [lit_hdr, 2, 3],
                  torch.full_like(x, 5))
    out_len = _select([is_lit, is_c1], [lit_len, 4 + ((b0 >> 2) & 7)], 1 + x)
    offset = _select([is_lit, is_c1, is_c2],
                     [torch.zeros_like(b0), ((b0 & 0xE0) << 3) | b1,
                      b1 | (b2 << 8)], _word(b1, b2, b3, b4))
    pos = torch.arange(n, dtype=torch.int32, device=comp.device)[None, :]
    nxt = pos + torch.where(is_lit, lit_hdr + lit_len, hdr)
    # poison literals whose length field would overflow int32 (>= 2^30):
    # the walk sees them run past the end (ERR_OVERRUN_INPUT)
    poison = is_lit & (x == 63) & (b4 >= 0x40)
    nxt = torch.where(poison, n + 1, nxt)
    lit_src = pos + lit_hdr
    return nxt, out_len, offset, lit_src, is_lit


def _drop_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Scatter indices of JAX's ``mode="drop"`` into a buffer one slot
    wider: negative indices count from the end, as in JAX, and any index
    still outside [0, size) goes to the extra slot ``size``."""
    idx = torch.where(idx < 0, idx + size, idx)
    return torch.where((idx >= 0) & (idx < size), idx, size).to(torch.int64)


def _decode(comp, start, comp_len, dst_len, out_max: int, tag_rounds: int,
            ptr_rounds: int):
    """decode_jnp._decode_one over a batch: (out uint8 [B, out_max], err
    int32 [B])."""
    nb, cmax = comp.shape
    dev = comp.device
    i32 = torch.int32
    start = start[:, None]
    comp_len = comp_len[:, None]
    dst_len = dst_len[:, None]
    pos = torch.arange(cmax, dtype=i32, device=dev)[None, :]
    # mask bytes past comp_len so padding cannot fabricate elements
    compi = torch.where(pos < comp_len, comp.to(i32), 0)

    nxt, out_len, offset, lit_src, is_lit = _parse_positions(compi)
    nxt_c = torch.where(nxt <= comp_len, nxt, cmax)
    nxt_c = torch.maximum(nxt_c, pos + 1)
    reached = mark_orbit(nxt_c, start[:, 0], tag_rounds) & (pos < comp_len)

    # the walk must consume the input exactly
    any_reached = reached.any(dim=1, keepdim=True)
    last_pos = torch.where(reached, pos, -1).amax(dim=1, keepdim=True)
    ends_ok = any_reached & (
        nxt.gather(1, last_pos.clamp(0, cmax - 1).to(torch.int64)) == comp_len)
    ends_ok = ends_ok | ((dst_len == 0) & (start == comp_len))

    # order tags by position: tid = rank among reached
    r32 = reached.to(i32)
    tid = torch.cumsum(r32, dim=1).to(i32) - 1
    t_max = cmax // 2 + 2
    tag_pos = torch.full((nb, t_max + 1), cmax, dtype=i32, device=dev)
    tag_pos.scatter_(1, _drop_index(torch.where(reached, tid, t_max), t_max),
                     pos.expand(nb, cmax).contiguous())
    tag_pos = tag_pos[:, :t_max]
    n_tags = r32.sum(dim=1, keepdim=True)
    t_valid = torch.arange(t_max, device=dev)[None, :] < n_tags
    tp = tag_pos.clamp(0, cmax - 1).to(torch.int64)

    def g(arr, fill):
        return torch.where(t_valid, arr.gather(1, tp), fill)

    t_out = g(out_len, 0)
    t_off = g(offset, 1)
    t_lit = g(lit_src, 0)
    t_islit = g(is_lit, True)

    out_start = exclusive_cumsum(t_out)
    total = t_out.sum(dim=1, keepdim=True).to(i32)

    def any_row(m):
        return m.any(dim=1, keepdim=True)

    err = torch.zeros(nb, 1, dtype=i32, device=dev)
    err = torch.where(~ends_ok, ERR_OVERRUN_INPUT, err)
    err = torch.where(total != dst_len, ERR_SIZE_MISMATCH, err)
    err = torch.where(any_row(t_valid & (t_out > dst_len - out_start)),
                      ERR_OVERRUN_OUTPUT, err)
    err = torch.where(any_row(t_valid & ~t_islit
                              & ((t_off <= 0) | (t_off > out_start))),
                      ERR_BAD_OFFSET, err)
    err = torch.where(any_row(t_valid & t_islit
                              & (t_lit + t_out > comp_len)),
                      ERR_LITERAL_OVERRUN, err)

    # per-output-byte tag labels
    marks = torch.zeros(nb, out_max + 1, dtype=i32, device=dev)
    safe = torch.where(t_valid & (out_start < out_max), out_start, out_max)
    marks.scatter_add_(1, _drop_index(safe, out_max),
                       torch.ones_like(safe))
    tid_b = (torch.cumsum(marks[:, :out_max], dim=1) - 1).clamp(
        0, t_max - 1).to(torch.int64)

    j = torch.arange(out_max, dtype=i32, device=dev)[None, :]
    rel = j - out_start.gather(1, tid_b)
    ptr = torch.where(t_islit.gather(1, tid_b),
                      -(t_lit.gather(1, tid_b) + rel) - 1,
                      j - t_off.gather(1, tid_b))
    inside = j < dst_len
    ptr = torch.where(inside, ptr, -1)
    ptr = resolve_pointers(ptr, ptr_rounds)
    # the masked row: bytes past comp_len read as zero
    out = compi.gather(1, (-ptr - 1).clamp(0, cmax - 1).to(torch.int64))
    out = torch.where(inside, out, 0).to(torch.uint8)
    return out, err[:, 0]


def _check(comp, start, comp_len, dst_len):
    """The batch's tensors as the functions take them: int32 start,
    comp_len and dst_len ``[B]`` on ``comp``'s device."""
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] < 1:
        raise ValueError(f"comp must be uint8 [B, cmax >= 1], got "
                         f"{comp.dtype} {tuple(comp.shape)}")
    nb = comp.shape[0]
    for name, t in (("start", start), ("comp_len", comp_len),
                    ("dst_len", dst_len)):
        if tuple(t.shape) != (nb,) or t.device != comp.device:
            raise ValueError(f"{name} must be [{nb}] on {comp.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    return tuple(t.to(torch.int32) for t in (start, comp_len, dst_len))


def decode_blocks_plain(comp, start, comp_len, dst_len, out_max: int = 65536,
                        tag_rounds: int = 17, ptr_rounds: int = 17):
    """Plain torch version: JAX's program in torch ops, on ``comp``'s
    device; the round counts bound its doubling loops as JAX's do."""
    start, comp_len, dst_len = _check(comp, start, comp_len, dst_len)
    return _decode(comp, start, comp_len, dst_len, out_max, tag_rounds,
                   ptr_rounds)


def decode_blocks(comp, start, comp_len, dst_len, out_max: int = 65536,
                  tag_rounds: int = 17, ptr_rounds: int = 17):
    """Batched parallel decode on ``comp``'s device.

    comp:      uint8 [B, cmax]   padded compressed rows (element streams,
                                 no varint preamble)
    start:     int32 [B]         first element offset within each row
    comp_len:  int32 [B]         valid bytes per row
    dst_len:   int32 [B]         expected decoded length per row
    returns    (uint8 [B, out_max], int32 [B] error codes)

    CUDA tensors run the kernel, CPU tensors the plain version.
    """
    global launches
    if comp.device.type == "cpu":
        return decode_blocks_plain(comp, start, comp_len, dst_len, out_max,
                                   tag_rounds, ptr_rounds)
    start, comp_len, dst_len = _check(comp, start, comp_len, dst_len)
    if comp.device.type != "cuda":
        raise ValueError(f"unsupported device {comp.device}")
    nb, cmax = comp.shape
    if (1 << tag_rounds) < (cmax + 1) // 2 or (1 << ptr_rounds) < out_max:
        raise ValueError(
            f"tag_rounds={tag_rounds}, ptr_rounds={ptr_rounds} bound the "
            f"walk of {cmax}-byte rows into {out_max} bytes; the kernel "
            f"walks them whole")
    if comp.stride(1) != 1:
        raise ValueError("comp must be contiguous along the row")
    from snappy_tpu_torch.kernels import _build

    start, comp_len, dst_len = (t.contiguous()
                                for t in (start, comp_len, dst_len))
    dev = comp.device
    out = torch.empty(nb, out_max, dtype=torch.uint8, device=dev)
    err = torch.empty(nb, dtype=torch.int32, device=dev)
    if nb == 0:
        return out, err
    # scratch for the chunks' walks and the records (and in rows wider
    # than IMAGE the pointer rounds), as the kernels lay it out
    lib = _build.lib()
    nbytes = ctypes.c_int64(0)
    _build.check(lib.snc_decode_par_scratch(cmax, out_max, nb,
                                            ctypes.addressof(nbytes)),
                 "decode_par")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.snc_decode_par(
            comp.data_ptr(), comp.stride(0), cmax, start.data_ptr(),
            comp_len.data_ptr(), dst_len.data_ptr(), out.data_ptr(), out_max,
            err.data_ptr(), nb, scratch.data_ptr(), stream)
    _build.check(rc, "decode_par")
    launches += 1
    return out, err


def _bucket(n: int, floor: int = 256) -> int:
    """n rounded up to a power of two (>= floor), as decode_jnp buckets
    its shapes."""
    b = floor
    while b < n:
        b *= 2
    return b


def decode_block_par_to_device(comp_bytes: bytes, dst_len: int,
                               start: int = 0, device=None) -> torch.Tensor:
    """Single-block decode to a uint8 tensor ``[dst_len]`` on ``device``
    (``device.resolve``): one row of the parallel decoder, its shapes
    bucketed as ``decode_block_jnp``'s.  Raises CorruptError as the
    shared error surface does."""
    from snappy_tpu_torch.device import resolve

    dev = resolve(device)
    n = len(comp_bytes)
    cmax = _bucket(max(8, n))
    comp = np.zeros((1, cmax), dtype=np.uint8)
    comp[0, :n] = np.frombuffer(comp_bytes, dtype=np.uint8)
    out_max = _bucket(max(8, dst_len))
    # doubling rounds scale with the stream (large raw streams can have
    # more than 2^17 elements or copy-chain depth)
    rounds = max(17, cmax.bit_length() + 1, out_max.bit_length() + 1)

    def i32(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    out, err = decode_blocks(torch.from_numpy(comp).to(dev), i32(start),
                             i32(n), i32(dst_len), out_max=out_max,
                             tag_rounds=rounds, ptr_rounds=rounds)
    code = int(err[0])
    if code != ERR_NONE:
        raise CorruptError(ERR_MESSAGES.get(code, f"error {code}"))
    return out[0, :dst_len]


def decode_block_par(comp_bytes: bytes, dst_len: int, start: int = 0,
                     device=None) -> bytes:
    """Single-block convenience wrapper, ``decode_block_jnp``'s
    counterpart: ``decode_block_par_to_device``'s bytes on the host."""
    return decode_block_par_to_device(comp_bytes, dst_len, start,
                                      device).cpu().numpy().tobytes()


def edge_streams() -> list:
    """The element payloads (raw streams: varint, then elements) of the
    compressed chunks of ``tests/test_torch_framed_fuzz.py``'s sixteen
    hostile framed streams: an empty payload, a varint past the
    elements, trailing bytes, elements after a varint of 0, a literal
    past the payload, copy offset 0, a copy before the block start, and
    the good chunk they sit beside."""
    lit = b"\x0cabcd"  # a 4-byte literal element
    return [b"", put_uvarint(10) + lit, put_uvarint(4) + lit + b"xyz",
            put_uvarint(0) + lit, put_uvarint(8) + b"\x1cabc",
            put_uvarint(8) + lit + bytes([(3 << 2) | 1, 0]),
            put_uvarint(8) + lit + bytes([(3 << 2) | 2, 9, 0]),
            put_uvarint(4) + lit]


def stream_rows(streams, cmax: int):
    """Raw streams as rows of a batch (numpy): (comp uint8 [B, cmax],
    start, comp_len, dst_len int32 [B]), start after each stream's
    varint and dst_len its value (at most 2**30); a stream whose varint
    does not parse gets start 0 and dst_len 0."""
    nb = len(streams)
    comp = np.zeros((nb, cmax), np.uint8)
    start, clen, dlen = (np.zeros(nb, np.int32) for _ in range(3))
    for i, s in enumerate(streams):
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
        try:
            d, h = read_uvarint(s, 0)
        except Exception:
            d, h = 0, 0
        start[i], clen[i], dlen[i] = h, len(s), min(d, 1 << 30)
    return comp, start, clen, dlen


# ---------------------------------------------------------------------
# the kernel's decomposition on the host (tests only)


def _i32(x: int) -> int:
    """x wrapped to int32, as the JAX program's arithmetic wraps."""
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _header(hb: bytes, q: int, cmax: int):
    """The tag a header at q would be: (is_lit, hdr, ln, off, nxt,
    lit_end), int32 as the parser lane computes it."""
    b0, b1, b2, b3, b4 = hb[q : q + 5]
    tag, x = b0 & 3, b0 >> 2
    w4 = b1 | b2 << 8 | b3 << 16 | b4 << 24
    if tag == 0:
        hdr = 1 if x < 60 else x - 58
        raw = (x, b1, w4 & 0xFFFF, w4 & 0xFFFFFF, w4)[max(0, x - 59)]
        ln = _i32(raw + 1)
        nxt = _i32(q + hdr + ln)
        lit_end = nxt
        if x == 63 and b4 >= 0x40:  # a poisoned length runs past the row
            nxt = cmax + 1
        return True, hdr, ln, 0, nxt, lit_end
    hdr = (2, 3, 5)[tag - 1]
    ln = 4 + (x & 7) if tag == 1 else 1 + x
    off = (((b0 & 0xE0) << 3) | b1 if tag == 1
           else w4 & 0xFFFF if tag == 2 else _i32(w4))
    return False, hdr, ln, off, q + hdr, q + hdr


def _successor(hb: bytes, q: int, cmax: int, clen: int) -> int:
    """The walk's next position after a tag at q: its nxt where that is
    at most clen, else cmax, and at least q + 1."""
    nxt = _header(hb, q, cmax)[4]
    return max(nxt if nxt <= clen else cmax, q + 1)


def _walk_span(hb: bytes, cmax: int, clen: int, dlen: int, s: int, stop: int,
               d: int):
    """A warp's walk of the tags at positions below ``stop``, from s,
    WINDOW bytes at a time: a header speculatively at every position of
    the window, the chain of starts from its first (ending past the
    window or at ``stop``), the per-tag conditions of every start ORed, a
    record per start.  ``hb`` is padded past the row.  Returns (records,
    flags, last_nxt or None, the position after the walk, d after it,
    the tags' positions); flags is (overruns output, bad offset, literal
    overruns input)."""
    over_out = bad_off = lit_over = False
    last_nxt = None
    records, starts = [], []
    while s < stop:
        lanes = [_header(hb, s + i, cmax) for i in range(WINDOW)]
        nq = [max(el[4] if el[4] <= clen else cmax, s + i + 1)
              for i, el in enumerate(lanes)]
        p = 0
        while True:
            is_lit, hdr, ln, off, nxt, lit_end = lanes[p]
            over_out |= ln > _i32(dlen - d)
            bad_off |= not is_lit and (off <= 0 or off > d)
            lit_over |= is_lit and lit_end > clen
            records.append((d, ln, s + p + hdr if is_lit else off,
                            0 if is_lit else 1))
            starts.append(s + p)
            d = _i32(d + ln)
            last_nxt = nxt
            np_ = nq[p] - s
            if np_ >= WINDOW or nq[p] >= stop:
                break
            p = np_
        s = nq[p]
    return records, (over_out, bad_off, lit_over), last_nxt, s, d, starts


def _row_code(start, clen, dlen, d, flags, last_nxt) -> int:
    """The row's code: the last of decode_jnp's conditions that holds."""
    ends_ok = ((last_nxt is not None and last_nxt == clen)
               or (dlen == 0 and start == clen))
    err = ERR_NONE
    for cond, code in ((not ends_ok, ERR_OVERRUN_INPUT),
                       (d != dlen, ERR_SIZE_MISMATCH),
                       (flags[0], ERR_OVERRUN_OUTPUT),
                       (flags[1], ERR_BAD_OFFSET),
                       (flags[2], ERR_LITERAL_OVERRUN)):
        if cond:
            err = code
    return err


def walk_records(hb: bytes, cmax: int, start: int, clen: int, dlen: int):
    """A row's walk in one piece: one walk from clamp(start, 0, cmax)
    over the positions below lim = min(clen, cmax).  ``hb`` is the row's
    first lim bytes.  Returns (records, err); a record is (d, ln, a,
    kind): kind 0 a literal of row bytes [a, a + ln), kind 1 a copy of
    offset a."""
    lim = max(0, min(clen, cmax))
    hb = hb[:lim] + bytes(WINDOW + 5)
    records, flags, last_nxt, _, d, _ = _walk_span(
        hb, cmax, clen, dlen, min(max(start, 0), cmax), lim, 0)
    return records, _row_code(start, clen, dlen, d, flags, last_nxt)


def walk_records_chunked(hb: bytes, cmax: int, start: int, clen: int,
                         dlen: int, chunk: int = CHUNK):
    """A row's walk as the kernel splits it over chunks of ``chunk`` bytes
    (``NARROW_CHUNK`` in a row of at most IMAGE bytes, ``CHUNK`` in a
    wider one) from s0 = clamp(start, 0, cmax) to lim:

      1. a warp a chunk walks speculatively from the chunk's first byte,
         marking the tag starts it visits and keeping its exit (the
         first position at or past the chunk's end); where a tag leaves
         the chunk more than LEAP bytes before its end, its marks are
         dropped and the walk starts again at the next byte, RESTARTS
         times at most;
      2. a warp a row finds where the true walk enters each chunk:
         from the previous chunk's exit it steps tag by tag until a
         position the chunk's walk visited (from there the two walks
         agree: the chunk's exit) or the chunk's end (a walk that never
         meets the chunk's stays exact);
      3. a warp a chunk walks again from its entry, counting its tags
         and output bytes; a scan gives each chunk its first record and
         output offset;
      4. a warp a chunk walks from its entry at that offset, writing its
         records and ORing the per-tag conditions.

    Returns (records, err), walk_records' own."""
    lim = max(0, min(clen, cmax))
    hb = hb[:lim] + bytes(WINDOW + 5)
    s0 = min(max(start, 0), cmax)
    cuts = list(range(s0, lim, chunk))
    stops = [min(c + chunk, lim) for c in cuts]
    visited, exits = set(), []
    for c, stop in zip(cuts, stops):  # 1
        for again in range(RESTARTS, -1, -1):
            _, _, _, x, _, at = _walk_span(hb, cmax, clen, dlen, c, stop, 0)
            if again == 0 or at[-1] + LEAP >= stop:
                break
            c = at[-1] + 1
        visited.update(at)
        exits.append(x)
    entries, e = [], s0  # 2
    for k, stop in enumerate(stops):
        entries.append(e)
        while e < stop:
            if e in visited:
                e = exits[k]
                break
            e = _successor(hb, e, cmax, clen)
    counts = [_walk_span(hb, cmax, clen, dlen, e, stop, 0)  # 3
              for e, stop in zip(entries, stops)]
    records, flags, last_nxt, d = [], (False,) * 3, None, 0
    for (e, stop), (_, _, _, _, dk, _) in zip(zip(entries, stops),
                                              counts):  # 4
        recs, fl, ln_k, _, _, _ = _walk_span(hb, cmax, clen, dlen, e, stop, d)
        records += recs
        flags = tuple(a or b for a, b in zip(flags, fl))
        last_nxt = ln_k if ln_k is not None else last_nxt
        d = _i32(d + dk)
    return records, _row_code(start, clen, dlen, d, flags, last_nxt)


def execute_records(records, row: bytes, out: np.ndarray) -> None:
    """The writer warp: the records in order into ``out`` (uint8
    [out_max]) with its guards: writes only inside [0, out_max), a copy
    only from below d, literal bytes past ``row`` read as zero."""
    out_max = out.shape[0]
    src = np.frombuffer(row + bytes(1), np.uint8)
    for d, ln, a, kind in records:
        if d < 0 or d >= out_max or ln <= 0:
            continue
        n_w = min(ln, out_max - d)
        i = np.arange(n_w, dtype=np.int64)
        if kind == 0:
            j = a + i
            out[d : d + n_w] = np.where(j < len(row),
                                        src[np.minimum(j, len(row))], 0)
        elif 0 < a <= d:
            out[d : d + n_w] = out[d - a + (i if a >= ln else i % a)]


def resolve_records(records, row: bytes, out: np.ndarray, total: int):
    """The wide rows' resolution (a good row's records): each byte below
    min(total, out_max) its source, -1 - i for byte i of ``row`` or the
    index of an earlier output byte, found by a binary search of the
    records' output offsets; then rounds of ``p = ptr[p]`` until
    2**rounds >= out_max; then each byte from ``row`` (zero past it)."""
    out_max = out.shape[0]
    kept = min(max(total, 0), out_max)
    ptr = np.full(out_max, -1 - (1 << 31), np.int64)
    if kept:
        rec = np.array(records, np.int64).reshape(-1, 4)
        i = np.arange(kept, dtype=np.int64)
        r = rec[np.searchsorted(rec[:, 0], i, side="right") - 1]
        rel = i - r[:, 0]
        ptr[:kept] = np.where(r[:, 3] == 0, -1 - (r[:, 2] + rel),
                              r[:, 0] - r[:, 2] + rel % np.maximum(r[:, 2], 1))
    reach = 1
    while reach < out_max:
        ptr = np.where(ptr >= 0, ptr[np.maximum(ptr, 0)], ptr)
        reach <<= 1
    assert (ptr < 0).all()
    src = -1 - ptr
    padded = np.frombuffer(row + bytes(1), np.uint8)
    out[:] = np.where(src < len(row), padded[np.minimum(src, len(row))], 0)


def decode_rows_model(comp: np.ndarray, start, comp_len, dst_len,
                      out_max: int):
    """decode_blocks' result computed from the walk: per row walk_records
    then execute_records, the records in order (rows of at most IMAGE
    bytes), or the wide rows' kernels, walk_records_chunked then
    resolve_records; a row whose code is not 0 all zero.  Numpy in, numpy
    out."""
    nb, cmax = comp.shape
    out = np.zeros((nb, out_max), np.uint8)
    err = np.zeros(nb, np.int32)
    for b in range(nb):
        clen = int(comp_len[b])
        row = comp[b, : max(0, min(clen, cmax))].tobytes()
        walk = walk_records_chunked if out_max > IMAGE else walk_records
        records, err[b] = walk(row, cmax, int(start[b]), clen,
                               int(dst_len[b]))
        if err[b] != ERR_NONE:
            continue
        if out_max > IMAGE:
            resolve_records(records, row, out[b], int(dst_len[b]))
        else:
            execute_records(records, row, out[b])
    return out, err


def narrow_rows_model(comp: np.ndarray, start, comp_len, dst_len,
                      out_max: int, chunk: int = NARROW_CHUNK):
    """decode_blocks' result for rows of at most IMAGE bytes as the kernel
    schedules it: per row walk_records_chunked at ``chunk``, the records
    in the record executor's layout (kind, len, source or offset, d) and
    its rounds (``decode_pretagged.execute_records_model``), a row whose
    code is not 0 given no records and length 0, so it comes back zero.
    Numpy in, numpy out: (out uint8 [B, out_max], err int32 [B])."""
    from snappy_tpu_torch.kernels.decode_pretagged import (
        execute_records_model)

    if out_max > IMAGE:
        raise ValueError(f"out_max {out_max} is past IMAGE ({IMAGE})")
    nb, cmax = comp.shape
    err = np.zeros(nb, np.int32)
    t_max = cmax // 2 + 2
    recs = np.zeros((nb, t_max, 4), np.int32)
    n_tags = np.zeros(nb, np.int32)
    lens = np.zeros(nb, np.int32)
    for b in range(nb):
        clen = int(comp_len[b])
        row = comp[b, : max(0, min(clen, cmax))].tobytes()
        records, err[b] = walk_records_chunked(
            row, cmax, int(start[b]), clen, int(dst_len[b]), chunk)
        if err[b] != ERR_NONE:
            continue
        n_tags[b], lens[b] = len(records), dst_len[b]
        if records:
            recs[b, : len(records)] = [(kind, ln, a, d)
                                       for d, ln, a, kind in records]
    out, _ = execute_records_model(comp, recs, n_tags, lens, out_max)
    return out, err


def resync_streams() -> list:
    """Raw streams whose chunked walk does not meet the true walk inside a
    chunk: after a 600-byte literal, copy-2 tags whose three bytes each
    parse as a copy-2 tag ((3 << 2) | 2, then the offset 2 | 2 << 8), so a
    walk entered off phase reads 3-byte tags that stay off phase to the
    row's end (a chunk of NARROW_CHUNK or CHUNK bytes starts off phase);
    one such stream of 1,000 tags and one of 15,000, and the first cut
    short by a byte (its last tag runs past the stream: code 1)."""
    rng = np.random.default_rng(5)
    lit = rng.integers(0, 256, 600, np.uint8).tobytes()
    head = bytes([61 << 2]) + (len(lit) - 1).to_bytes(2, "little") + lit
    out = []
    for n in (1000, 15000):
        out.append(put_uvarint(len(lit) + 4 * n) + head
                   + bytes([(3 << 2) | 2, 2, 2]) * n)
    return out + [out[0][:-1]]
