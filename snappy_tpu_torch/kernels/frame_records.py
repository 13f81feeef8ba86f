"""Framed (.sz) records of a batch of chunk rows: the CUDA kernel and its
plain version.

No counterpart in ``snappy_tpu/kernels``: the JAX package assembles
framed records on the host.  ``frame_records(rows, lens, comp, clens,
crc)`` takes one batch of the seq engine's framed encode: ``rows`` uint8
``[B, W]`` (``W <= 65536``, any row pitch), each row's chunk in its
first ``lens[b]`` bytes; ``comp`` uint8 ``[B, cap]`` and ``clens`` int32
``[B]``, the elements from ``encode_blocks_seq``; ``crc`` int64 ``[B]``,
the chunks' CRC-32C from ``crc32c_chunks``.  It returns ``(framed
uint8 [B * (W + 8)], ends int64 [B])``: row b's record, byte-identical
to ``runtime.device_codec._framed_record``, is
``framed[ends[b - 1] : ends[b]]`` (from 0 for row 0).  A record is at
most ``W + 8`` bytes: a compressed body is taken only when it is
shorter than the chunk.  Bytes of ``framed`` past ``ends[B - 1]`` are
undefined.  Lengths are clamped to ``[0, W]`` and ``[0, cap]``.

On a CUDA tensor the wrapper launches ``csrc/frame_records.cu`` (a CTA
a row, each summing the record lengths before its own); on a CPU tensor
it runs the plain version.  There is no other switch.
"""

from __future__ import annotations

import numpy as np
import torch

from snappy_tpu_torch.spec.format import (
    CHUNK_COMPRESSED,
    CHUNK_UNCOMPRESSED,
    CRC_MASK_DELTA,
    MAX_CHUNK_UNCOMPRESSED,
)

HEADER = 8  # type byte, 3-byte length, 4-byte masked CRC

# kernel launches made by frame_records (one per CUDA call)
launches = 0


def _check(rows, lens, comp, clens, crc) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be uint8 [B, W], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    nb, width = rows.shape
    if width > MAX_CHUNK_UNCOMPRESSED:
        raise ValueError(f"row width {width} exceeds {MAX_CHUNK_UNCOMPRESSED}")
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[0] != nb:
        raise ValueError(f"comp must be uint8 [{nb}, cap], got {comp.dtype} "
                         f"{tuple(comp.shape)}")
    for name, t, dt in (("lens", lens, torch.int32),
                        ("clens", clens, torch.int32),
                        ("crc", crc, torch.int64)):
        if t.dtype != dt or tuple(t.shape) != (nb,):
            raise ValueError(f"{name} must be {dt} [{nb}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (lens, comp, clens, crc):
        if t.device != rows.device:
            raise ValueError(f"inputs on {t.device} and {rows.device}")


def layout(lens, clens, width: int, cap: int):
    """Each row's record, as numpy int64 arrays: ``(n, c, vlen, raw,
    body)``, the chunk and element lengths clamped to ``[0, width]`` and
    ``[0, cap]``, the varint's bytes, whether the chunk is stored raw
    (``spec.format.framed_chunk_type``), and the body's bytes."""
    n = lens.cpu().numpy().astype(np.int64).clip(0, width)
    c = clens.cpu().numpy().astype(np.int64).clip(0, cap)
    vlen = 1 + (n >= 128) + (n >= 16384)
    raw = vlen + c >= n - n // 8
    return n, c, vlen, raw, np.where(raw, n, vlen + c)


def frame_records_plain(rows, lens, comp, clens, crc):
    """Plain version: the record lengths and their running sum, then each
    record written in turn."""
    nb, width = rows.shape
    n, c, vlen, raw, body = layout(lens, clens, width, comp.shape[1])
    ends = np.cumsum(HEADER + body)
    x = crc.cpu().numpy().astype(np.uint64) & 0xFFFFFFFF
    masked = (((x >> 15) | (x << 17)) + CRC_MASK_DELTA) & 0xFFFFFFFF
    rows_h, comp_h = rows.cpu().numpy(), comp.cpu().numpy()
    out = np.zeros(nb * (width + HEADER), np.uint8)
    for b in range(nb):
        at = int(ends[b] - HEADER - body[b])
        blen = int(body[b]) + 4
        out[at] = CHUNK_UNCOMPRESSED if raw[b] else CHUNK_COMPRESSED
        out[at + 1 : at + 4] = np.frombuffer(blen.to_bytes(3, "little"),
                                             np.uint8)
        out[at + 4 : at + 8] = np.frombuffer(int(masked[b]).to_bytes(
            4, "little"), np.uint8)
        at += HEADER
        if raw[b]:
            out[at : at + n[b]] = rows_h[b, : n[b]]
            continue
        v = int(n[b])
        for i in range(int(vlen[b])):
            out[at + i] = (v & 0x7F) | (0x80 if i + 1 < vlen[b] else 0)
            v >>= 7
        at += int(vlen[b])
        out[at : at + c[b]] = comp_h[b, : c[b]]
    dev = rows.device
    return torch.from_numpy(out).to(dev), torch.from_numpy(ends).to(dev)


def frame_records(rows, lens, comp, clens, crc):
    """The framed records of a batch; returns ``(framed uint8 [B * (W +
    8)], ends int64 [B])``.  CUDA tensors run the kernel, CPU tensors the
    plain version.  ``rows`` and ``comp`` may be row-strided views."""
    global launches
    _check(rows, lens, comp, clens, crc)
    if rows.device.type == "cpu":
        return frame_records_plain(rows, lens, comp, clens, crc)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    from snappy_tpu_torch.kernels import _build

    nb, width = rows.shape
    cap = comp.shape[1]
    if nb and ((width and rows.stride(1) != 1)
               or (cap and comp.stride(1) != 1)):
        raise ValueError("rows and comp must be contiguous along the row")
    lens, clens, crc = lens.contiguous(), clens.contiguous(), crc.contiguous()
    dev = rows.device
    framed = torch.empty(nb * (width + HEADER), dtype=torch.uint8, device=dev)
    ends = torch.empty(nb, dtype=torch.int64, device=dev)
    if nb == 0:
        return framed, ends
    with torch.cuda.device(dev):
        rc = _build.lib().snc_frame_records(
            rows.data_ptr(), rows.stride(0), width, lens.data_ptr(),
            comp.data_ptr(), comp.stride(0), cap, clens.data_ptr(),
            crc.data_ptr(), framed.data_ptr(), ends.data_ptr(), nb,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "frame_records")
    launches += 1
    return framed, ends
