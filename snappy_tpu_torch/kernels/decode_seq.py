"""Sequential per-block Snappy decode: the CUDA kernel and its plain version.

Counterpart of ``snappy_tpu/kernels/pallas_decode.py``.  Row ``b`` of a
uint8 ``comp [B, cmax]`` holds one element stream in bytes
``[starts[b], clens[b])`` that decodes to ``dlens[b]`` bytes.
``decode_blocks_seq`` returns ``(out uint8 [B, out_max], err int32
[B])``: ``out[b, :d]`` holds the bytes decoded before the first failing
element (all ``dlens[b]`` of them when ``err[b] == 0``), every later
byte of the row is zero, and ``err[b]`` is one of the codes below, the
JAX kernel's values for the same inputs.

Validation is the JAX kernel's ``_step_one`` to the bit: lengths and
offsets are wrapping int32 (a 4-byte literal length of 0xFFFFFFFF wraps
to 0, a 4-byte offset with its top bit set goes negative), the bounds
use subtraction forms, the first failing element decides the code and
freezes the cursors, and ``ERR_DST_SHORT`` then ``ERR_SRC_TRAIL`` are
set only when no element failed.

The caller keeps ``0 <= starts[b]``, ``clens[b] <= cmax`` and
``dlens[b] <= out_max`` (the JAX kernel reads and writes past its rows
otherwise).  The plain version raises ValueError when they do not hold;
the kernel stays inside its rows (bytes past a row read as zero, writes
past ``out_max`` are dropped).

On a CUDA tensor the wrapper launches ``csrc/seq_decode.cu`` (a parser
warp and a writer warp per block); on a CPU tensor it runs the plain
version, a serial walk over elements whose literals and copies are
tensor slice copies.  There is no other switch.  Unlike the Pallas
wrapper, any ``B`` and any widths are taken: no multiple-of-8 batch, no
128-byte rows.  ``resident_rows`` is the launch width that fills the
card.

``decode_rows_model`` is the kernel's decomposition on the host, for the
tests: ``parse_records`` (the parser warp: 32 speculative headers a
window, the chain of starts, the checks of all starts at once) and
``execute_records`` (the writer warp).
"""

from __future__ import annotations

import numpy as np
import torch

WINDOW = 32  # bytes the parser warp decodes speculatively at once

ERR_NONE = 0
ERR_LITERAL = 1
ERR_COPY = 2
ERR_DST_SHORT = 3
ERR_SRC_TRAIL = 4

ERR_MESSAGES = {
    ERR_LITERAL: "literal overruns its input or output",
    ERR_COPY: "copy overruns its output or has a bad offset",
    ERR_DST_SHORT: "decoded size differs from preamble",
    ERR_SRC_TRAIL: "element stream does not end at its payload end",
}

# kernel launches made by decode_blocks_seq (one per CUDA call)
launches = 0


def resident_rows(device, out_max: int) -> int:
    """Rows the card holds in flight at once for ``out_max``-byte rows (SMs x
    resident blocks per SM): the seq engine's launch width on a card."""
    from snappy_tpu_torch.kernels import _build

    return _build.resident_rows("snc_seq_decode_blocks_per_sm", device, out_max)


def stage_decode(comp, starts, clens, dlens, device=None):
    """The port's tensors for a batch staged as numpy arrays (the JAX
    tests' ``comp/starts/clens/dlens``): uint8 ``[B, cmax]`` and three
    int32 ``[B]`` on ``device`` (``device.resolve``: the card unless
    asked for the CPU)."""
    from snappy_tpu_torch.device import resolve

    dev = resolve(device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    return (put(comp, np.uint8), put(starts, np.int32), put(clens, np.int32),
            put(dlens, np.int32))


def _i32(x: int) -> int:
    """x wrapped to int32, as the JAX kernel's arithmetic wraps."""
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _check(comp, starts, clens, dlens, out_max: int) -> None:
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError(f"comp must be uint8 [B, cmax], got {comp.dtype} "
                         f"{tuple(comp.shape)}")
    nb = comp.shape[0]
    for name, t in (("starts", starts), ("clens", clens), ("dlens", dlens)):
        if t.dtype != torch.int32 or tuple(t.shape) != (nb,):
            raise ValueError(f"{name} must be int32 [{nb}], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != comp.device:
            raise ValueError(f"{name} on {t.device}, comp on {comp.device}")
    if out_max < 0:
        raise ValueError(f"out_max must be >= 0, got {out_max}")


def _copy_within(dst: torch.Tensor, d: int, off: int, ln: int) -> None:
    """dst[d + i] = dst[d - off + i] for i < ln, overlapping allowed: the
    first min(off, ln) bytes come from before d, then the written
    prefix (a whole number of periods) is doubled."""
    done = min(off, ln)
    dst[d : d + done] = dst[d - off : d - off + done]
    while done < ln:
        step = min(done, ln - done)
        dst[d + done : d + done + step] = dst[d : d + step]
        done += step


def _decode_row(src, dst, hb: bytes, s: int, clen: int, dlen: int) -> int:
    """Walk one element stream; returns the error code."""
    d = 0
    e = ERR_NONE
    while s < clen:
        b0, b1, b2, b3, b4 = hb[s : s + 5]
        tag = b0 & 3
        x = b0 >> 2
        if tag == 0:
            hdr = 1 if x < 60 else x - 58
            raw = (x, b1, b1 | b2 << 8, b1 | b2 << 8 | b3 << 16,
                   b1 | b2 << 8 | b3 << 16 | b4 << 24)[max(0, x - 59)]
            ln = _i32(raw + 1)
            if (hdr > clen - s or ln <= 0 or ln > dlen - d
                    or ln > clen - s - hdr):
                e = ERR_LITERAL
                break
            dst[d : d + ln] = src[s + hdr : s + hdr + ln]
            s += hdr + ln
        else:
            hdr = (2, 3, 5)[tag - 1]
            ln = 4 + (x & 7) if tag == 1 else 1 + x
            if tag == 1:
                off = ((b0 & 0xE0) << 3) | b1
            elif tag == 2:
                off = b1 | b2 << 8
            else:
                off = _i32(b1 | b2 << 8 | b3 << 16 | b4 << 24)
            if (hdr > clen - s or ln <= 0 or ln > dlen - d or off <= 0
                    or off > d):
                e = ERR_COPY
                break
            _copy_within(dst, d, off, ln)
            s += hdr
        d += ln
    if e == ERR_NONE and d != dlen:
        e = ERR_DST_SHORT
    if e == ERR_NONE and s != clen:
        e = ERR_SRC_TRAIL
    return e


def _host_bytes(row: torch.Tensor) -> bytes:
    """A row's bytes on the host, with 5 zero bytes past them (the
    widest header read at the row's end)."""
    return row.cpu().numpy().tobytes() + bytes(5)


def decode_blocks_seq_plain(comp, starts, clens, dlens, out_max: int):
    """Plain torch version: a serial walk over each row's elements.  The
    row's bytes are read once to the host for parsing (once for the
    whole batch where every row is the same bytes, a ``comp`` of row
    stride 0); literal and copy bytes move as slice copies on
    ``comp``'s device."""
    _check(comp, starts, clens, dlens, out_max)
    nb, cmax = comp.shape
    out = torch.zeros(nb, out_max, dtype=torch.uint8, device=comp.device)
    err = [0] * nb
    st, cl, dl = starts.tolist(), clens.tolist(), dlens.tolist()
    shared = _host_bytes(comp[0]) if nb and comp.stride(0) == 0 else None
    for b in range(nb):
        if st[b] < 0 or cl[b] > cmax or dl[b] > out_max:
            raise ValueError(
                f"row {b}: need 0 <= start, clen <= {cmax}, dlen <= "
                f"{out_max}; got {st[b]}, {cl[b]}, {dl[b]}")
        hb = shared if shared is not None else _host_bytes(comp[b])
        err[b] = _decode_row(comp[b], out[b], hb, st[b], cl[b], dl[b])
    return out, torch.tensor(err, dtype=torch.int32, device=comp.device)


def decode_blocks_seq(comp, starts, clens, dlens, out_max: int):
    """Decode a batch of element streams; returns ``(out uint8 [B,
    out_max], err int32 [B])``.  CUDA tensors run the kernel, CPU
    tensors the plain version.  ``comp`` may be a row-strided view
    (its pitch is ``comp.stride(0)``), one of pitch 0 too: every row is
    then the same bytes, e.g. one span of many streams, each row's
    stream at its own ``[starts[b], clens[b])``."""
    global launches
    _check(comp, starts, clens, dlens, out_max)
    if comp.device.type == "cpu":
        return decode_blocks_seq_plain(comp, starts, clens, dlens, out_max)
    if comp.device.type != "cuda":
        raise ValueError(f"unsupported device {comp.device}")
    from snappy_tpu_torch.kernels import _build

    nb, cmax = comp.shape
    if nb and cmax and comp.stride(1) != 1:
        raise ValueError("comp must be contiguous along the row")
    starts, clens, dlens = (t.contiguous() for t in (starts, clens, dlens))
    out = torch.empty(nb, out_max, dtype=torch.uint8, device=comp.device)
    err = torch.empty(nb, dtype=torch.int32, device=comp.device)
    if nb == 0:
        return out, err
    with torch.cuda.device(comp.device):
        stream = torch.cuda.current_stream(comp.device).cuda_stream
        rc = _build.lib().snc_seq_decode(
            comp.data_ptr(), comp.stride(0), cmax, starts.data_ptr(),
            clens.data_ptr(), dlens.data_ptr(), out.data_ptr(), out_max,
            err.data_ptr(), nb, stream)
    _build.check(rc, "seq_decode")
    launches += 1
    return out, err


# ---------------------------------------------------------------------
# the kernel's decomposition on the host (tests only)


def _speculate(hb: bytes, q: int):
    """The element a header at q would be: (tag, hdr, ln, off, adv), adv
    the bytes it spans in the stream."""
    b0, b1, b2, b3, b4 = hb[q : q + 5]
    tag, x = b0 & 3, b0 >> 2
    if tag == 0:
        hdr = 1 if x < 60 else x - 58
        raw = (x, b1, b1 | b2 << 8, b1 | b2 << 8 | b3 << 16,
               b1 | b2 << 8 | b3 << 16 | b4 << 24)[max(0, x - 59)]
        ln = _i32(raw + 1)
        return tag, hdr, ln, 0, hdr + ln
    hdr = (2, 3, 5)[tag - 1]
    ln = 4 + (x & 7) if tag == 1 else 1 + x
    if tag == 1:
        off = ((b0 & 0xE0) << 3) | b1
    elif tag == 2:
        off = b1 | b2 << 8
    else:
        off = _i32(b1 | b2 << 8 | b3 << 16 | b4 << 24)
    return tag, hdr, ln, off, hdr


def _fails(el, sq: int, d: int, clen: int, dlen: int) -> bool:
    """_step_one's checks of element ``el`` at stream position sq, d
    bytes decoded before it (wrapping int32 subtractions)."""
    tag, hdr, ln, off, _ = el
    room = _i32(clen - sq)
    if tag == 0:
        return (hdr > room or ln <= 0 or ln > _i32(dlen - d)
                or ln > _i32(room - hdr))
    return hdr > room or ln <= 0 or ln > _i32(dlen - d) or off <= 0 or off > d


def parse_records(hb: bytes, s: int, clen: int, dlen: int):
    """The parser warp: the stream parsed WINDOW bytes at a time.  Each
    window decodes a header speculatively at every position, follows
    the chain of starts from the first (stopping at the window's end or
    at clen), checks every start with the d the chain gives it, and
    stops the walk at the first failing start.  ``hb`` is the row's
    bytes with zeros past them.  Returns (records, s, d, err); a record
    is (d, ln, a, kind): kind 0 a literal of row bytes [a, a + ln),
    kind 1 a copy of offset a."""
    hb = hb + bytes(WINDOW + 5)
    records = []
    d, e = 0, ERR_NONE
    while s < clen:
        lanes = [_speculate(hb, s + i) for i in range(WINDOW)]
        nxt = [i + el[4] if el[4] >= 1 and i + el[4] < WINDOW else WINDOW
               for i, el in enumerate(lanes)]
        chain, p, dd = [], 0, d
        while True:
            chain.append((p, dd))
            dd = _i32(dd + lanes[p][2])
            if nxt[p] >= WINDOW or s + nxt[p] >= clen:
                break
            p = nxt[p]
        bad = next(((q, dq) for q, dq in chain
                    if _fails(lanes[q], s + q, dq, clen, dlen)), None)
        for q, dq in chain:
            if bad is not None and q == bad[0]:
                break
            tag, hdr, ln, off, _ = lanes[q]
            records.append((dq, ln, s + q + hdr if tag == 0 else off,
                            0 if tag == 0 else 1))
        if bad is not None:
            e = ERR_LITERAL if lanes[bad[0]][0] == 0 else ERR_COPY
            s, d = s + bad[0], bad[1]
            break
        s, d = s + p + lanes[p][4], dd
    if e == ERR_NONE and d != dlen:
        e = ERR_DST_SHORT
    if e == ERR_NONE and s != clen:
        e = ERR_SRC_TRAIL
    return records, s, d, e


def execute_records(records, row: bytes, out: np.ndarray) -> None:
    """The writer warp: the records in order into ``out`` (uint8
    [out_max]), literal bytes past ``row`` read as zero, writes past
    out_max dropped, a copy as out[d + i] = out[d - off + i % off]."""
    out_max = out.shape[0]
    src = np.frombuffer(row, np.uint8)
    for d, ln, a, kind in records:
        n_w = max(0, min(ln, out_max - d))
        i = np.arange(n_w)
        if kind == 0:
            j = a + i
            out[d : d + n_w] = np.where(j < len(src),
                                        src[np.minimum(j, len(src) - 1)]
                                        if len(src) else 0, 0)
        else:
            si = d - a + (i if a >= ln else i % a)
            out[d : d + n_w] = np.where(si < out_max,
                                        out[np.minimum(si, out_max - 1)], 0)


def decode_rows_model(comp: np.ndarray, starts, clens, dlens, out_max: int):
    """decode_blocks_seq's result computed as the kernel decomposes it:
    parse_records then execute_records per row.  Numpy in, numpy out."""
    nb, cmax = comp.shape
    out = np.zeros((nb, out_max), np.uint8)
    err = np.zeros(nb, np.int32)
    for b in range(nb):
        lim = max(0, min(int(clens[b]), cmax))
        row = comp[b, :lim].tobytes()
        records, _s, _d, err[b] = parse_records(row, int(starts[b]),
                                                int(clens[b]), int(dlens[b]))
        execute_records(records, row, out[b])
    return out, err
