"""The framed to-device / from-device codec on PyTorch.

Counterpart of ``snappy_tpu/runtime/device_codec.py``: its flat
engines and its device LZ engine.  The engine is read from the JAX
package's variables: ``SNAPPY_TPU_FLAT=1`` (the default) runs a flat
engine, chosen by ``FLAT_MODE``; ``SNAPPY_TPU_FLAT=0`` with
``SNAPPY_TPU_HOST_PARSE=0`` runs the device LZ engine.  ``FLAT=0`` with
``HOST_PARSE=1`` is the JAX package's hybrid decode engine
(``decode_pretagged``), which is not ported: framed decode raises
SnappyError there.  Encode under ``FLAT=0`` ignores ``HOST_PARSE``.

The shared native library (``snappy_tpu.native``) does the host's part
of the flat engines: the threaded LZ walk, the matcher and the framed
assembly.  Their device part depends on ``FLAT_MODE``:

  "id" (default)  decode: the native walk decodes each chunk straight
                  into a 64 KiB row of a 520-row staging panel; the
                  device checks each chunk's CRC-32C where the bytes
                  land (``kernels.crc32c``).  encode: the device
                  computes each chunk's CRC-32C while the native
                  matcher assembles the framed records
                  (``sn_compress_framed_crc``).
  "classify"      the native stagers emit flat plans and the device
                  executes them (``kernels.decode_flat``): framed decode,
                  segmented raw decode, and the encode replay of the
                  host matcher's element.

The device LZ engine ("seq") does the LZ work on the device: each
compressed chunk's payload goes up as is and one warp decodes it
(``kernels.decode_seq``), each 64 KiB chunk goes up as is and one warp
runs the reference matcher on it (``kernels.encode_seq``), and the
chunk CRCs are computed on the device too.  Only the elements, the CRCs
and the error codes come back.  Raw-stream decode stays on the host, as
in the JAX package: a raw stream is not a set of independent blocks.

Host buffers that feed a transfer are pinned on a GPU and reused in
rounds of ``_NSETS``; each round records a CUDA event after its
transfers and the next use of its buffers waits on it, so staging a
batch never rewrites memory that an earlier asynchronous copy still
reads.  Without the native library every entry point raises.

The only host decodes are the reference's per-chunk format fallbacks
(a plan over its caps, a payload wider than ``_DECODE_CMAX``, a copy
offset past 64 KiB); ``HOST_FALLBACKS`` counts them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from snappy_tpu import native
from snappy_tpu.errors import (
    BadMagicError,
    ChecksumError,
    CorruptError,
    SnappyError,
    TooLargeError,
    UnsupportedError,
)
from snappy_tpu.spec.format import (
    CHUNK_COMPRESSED,
    CHUNK_PADDING,
    CHUNK_STREAM_ID,
    CHUNK_UNCOMPRESSED,
    MAX_BLOCK_SIZE,
    MAX_CHUNK_UNCOMPRESSED,
    MAX_UNCOMPRESSED_LEN,
    STREAM_ID_CHUNK,
    STREAM_ID_PAYLOAD,
    framed_chunk_type,
    mask_crc,
    put_uvarint,
    read_uvarint,
    unmask_crc,
)
from snappy_tpu_torch.device import resolve
from snappy_tpu_torch.kernels import encode_flat as _enc
from snappy_tpu_torch.kernels.crc32c import CHUNK as _CRC_CHUNK, crc32c_chunks
from snappy_tpu_torch.kernels.decode_flat import (
    TRIP_CAP as _F_TRIPS,
    decode_blocks_flat,
    rows_b_for,
)
from snappy_tpu_torch.kernels.decode_seq import ERR_MESSAGES, decode_blocks_seq
from snappy_tpu_torch.kernels.encode_seq import comp_width, encode_blocks_seq

# Chunks per device batch; the same variable as the JAX package's.
BATCH = int(os.environ.get("SNAPPY_TPU_BATCH", "64"))
# Device CRC-32C of every chunk; "0" checks and computes CRCs on the host.
DEVICE_CRC = os.environ.get("SNAPPY_TPU_DEVICE_CRC", "1") != "0"
# Flat engines ("1", default) or the device LZ engine ("0", with
# HOST_PARSE "0"); the same variables as the JAX package's.
FLAT = os.environ.get("SNAPPY_TPU_FLAT", "1") != "0"
HOST_PARSE = os.environ.get("SNAPPY_TPU_HOST_PARSE", "1") != "0"
# Flat engine mode: "id" (identity staging + device CRC) or "classify".
FLAT_MODE = os.environ.get("SNAPPY_TPU_FLAT_MODE", "id")

_DECODE_CMAX = 66560  # 65536 + margin: widest payload a device row takes
_ID_ROWS = 520        # 512 image rows + 8 guard rows (wide-copy slop)
_RAW_SEG = 65536      # output bytes per segment of a raw stream
_RAW_SEG_CMAX = 2 * 65536  # payload slice cap per raw segment
_NSETS = 2            # rounds of host staging buffers in flight

# per-chunk host decodes, by cause
HOST_FALLBACKS = {"plan_overflow": 0, "oversize_payload": 0, "far_offset": 0}


def _native():
    if not native.available():
        raise SnappyError(
            "the native host codec (snappy_tpu.native) is unavailable; "
            "snappy_tpu_torch needs it for staging and assembly")
    return native


def _threads() -> int:
    return min(4, os.cpu_count() or 1)


def _bucket_cmax(kmax: int) -> int:
    """Payload row width for a batch whose widest payload is kmax bytes:
    the JAX package's buckets (16,640 / 33,280 / 66,560)."""
    return next((c for c in (16640, 33280) if kmax <= c), _DECODE_CMAX)


def _decode_engine() -> str:
    """The framed decode engine: "id", "classify" or "seq"."""
    if FLAT:
        return "id" if FLAT_MODE == "id" else "classify"
    if HOST_PARSE:
        raise SnappyError(
            "the hybrid host-parse decode engine (SNAPPY_TPU_FLAT=0 with "
            "SNAPPY_TPU_HOST_PARSE=1) is not ported to snappy_tpu_torch; "
            "SNAPPY_TPU_HOST_PARSE=0 selects the device LZ engine")
    return "seq"


class _HostSet:
    """Host buffers of one in-flight batch, pinned on a GPU, plus the
    event recorded after the last transfer that reads or fills them."""

    def __init__(self, device: torch.device, shapes: dict):
        pin = device.type == "cuda"
        self.device = device
        self.t = {k: torch.empty(shape, dtype=dt, pin_memory=pin)
                  for k, (shape, dt) in shapes.items()}
        self.np = {k: v.numpy() for k, v in self.t.items()}
        self._event = None

    def record(self) -> None:
        if self.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self.device))

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()
            self._event = None


def _host_sets(device: torch.device, **shapes) -> list[_HostSet]:
    return [_HostSet(device, shapes) for _ in range(_NSETS)]


def _one_behind(items, dispatch):
    """Run ``dispatch(k, item)`` for each item and yield its result one
    step late: a caller that finishes batch k in the loop body does so
    after batch k+1's host staging and device work are queued and before
    batch k+2 is staged.  With ``_NSETS`` = 2 host sets in rotation,
    batch k+2 reuses batch k's set only after batch k was finished."""
    pending = None
    for k, item in enumerate(items):
        cur = dispatch(k, item)
        if pending is not None:
            yield pending
        pending = cur
    if pending is not None:
        yield pending


def _upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Asynchronous copy of a (pinned) host tensor to a new device tensor."""
    dev = torch.empty(host.shape, dtype=host.dtype, device=device)
    dev.copy_(host, non_blocking=True)
    return dev


def _upload_bytes(data: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)


def _crc_into(hs: _HostSet, rows: torch.Tensor, device) -> None:
    """Launch the CRC-32C of ``rows`` over the lengths in ``hs``'s pinned
    ``lens`` buffer; the values land in its pinned ``crc`` buffer."""
    n = rows.shape[0]
    crc = crc32c_chunks(rows, _upload(hs.t["lens"][:n], device))
    hs.t["crc"][:n].copy_(crc, non_blocking=True)


def _check_crcs(grp_chunks, crc_h: np.ndarray, skip=()) -> None:
    """Raise ChecksumError for the first row whose device CRC differs
    from its chunk's stored (masked) CRC."""
    for row, ch in enumerate(grp_chunks):
        if row not in skip and int(crc_h[row]) != unmask_crc(ch[3]):
            raise ChecksumError(ch[3], None)


def _chunk_lens(nb: int, cnt: int,
                cs: int = MAX_CHUNK_UNCOMPRESSED) -> np.ndarray:
    """Lengths of the cnt cs-byte chunks that hold nb bytes."""
    return np.minimum(nb - np.arange(cnt, dtype=np.int64) * cs, cs)


# ---------------------------------------------------------------------
# decode


def _scan_frames(src: bytes):
    """Parse framed chunk headers.  Returns a list of (type, payload_off,
    payload_len, crc, dst_len, elem_start) and the total output size;
    elem_start is the varint header length of a compressed payload."""
    n = len(src)
    if n < len(STREAM_ID_CHUNK) or src[: len(STREAM_ID_CHUNK)] != STREAM_ID_CHUNK:
        raise BadMagicError()
    chunks = []
    pos = len(STREAM_ID_CHUNK)
    total = 0
    while pos < n:
        if n - pos < 4:
            raise CorruptError("truncated chunk header")
        ctype = src[pos]
        body = src[pos + 1] | (src[pos + 2] << 8) | (src[pos + 3] << 16)
        pos += 4
        if n - pos < body:
            raise CorruptError("truncated chunk body")
        if ctype == CHUNK_STREAM_ID:
            if src[pos : pos + body] != STREAM_ID_PAYLOAD:
                raise BadMagicError()
            pos += body
            continue
        if ctype == CHUNK_PADDING or 0x80 <= ctype <= 0xFD:
            pos += body
            continue
        if 0x02 <= ctype <= 0x7F:
            raise UnsupportedError(ctype)
        if body < 4:
            raise CorruptError("chunk body shorter than checksum")
        crc = int.from_bytes(src[pos : pos + 4], "little")
        p_off, p_len = pos + 4, body - 4
        if ctype == CHUNK_COMPRESSED:
            dst_len, hdr = read_uvarint(src, p_off)
            if dst_len > MAX_CHUNK_UNCOMPRESSED:
                raise CorruptError("chunk decodes to more than 64KiB")
            chunks.append((ctype, p_off, p_len, crc, dst_len, hdr))
        else:
            if p_len > MAX_CHUNK_UNCOMPRESSED:
                raise CorruptError("uncompressed chunk larger than 64KiB")
            chunks.append((ctype, p_off, p_len, crc, p_len, 0))
        total += chunks[-1][4]
        pos += body
    return chunks, total


def _host_decode_chunk(src_arr, ch, out, off: int) -> None:
    """Per-chunk host decode (a format fallback) into out[off:]."""
    _, p_off, p_len, _crc, dst_len, _hdr = ch
    blob = _native().decompress(bytes(src_arr[p_off : p_off + p_len]))
    if len(blob) != dst_len:
        raise CorruptError("chunk preamble disagrees with decoded size")
    out[off : off + dst_len] = np.frombuffer(blob, dtype=np.uint8)


def _batch_arrays(chunks, grp):
    """int64 (payload offsets, payload lengths, header lengths, dst
    lengths) of a group of scanned chunks, as the native stagers take."""
    return tuple(np.array([chunks[i][f] for i in grp], np.int64)
                 for f in (1, 2, 5, 4))


def decompress_framed(data: bytes, verify_checksums: bool = True,
                      device=None) -> bytes:
    chunks, total = _scan_frames(data)
    out = np.empty(max(1, total), dtype=np.uint8)
    src_arr = np.frombuffer(data, dtype=np.uint8)
    dst_offs = []
    acc = 0
    for ch in chunks:
        dst_offs.append(acc)
        acc += ch[4]
    decode_chunk_range(src_arr, chunks, dst_offs, out, range(len(chunks)),
                       verify_checksums, device=device)
    return out[:total].tobytes()


def decode_chunk_range(src_arr, chunks, dst_offs, out, subset,
                       verify_checksums: bool = True, device=None) -> None:
    """Decode the chunk-index ``subset`` of a scanned frame index into the
    host array ``out`` at per-chunk offsets ``dst_offs``."""
    device = resolve(device)
    _native()
    engine = _decode_engine()
    subset = list(subset)
    host_checked: set = set()  # chunks whose CRC the host verifies
    all_comp = [i for i in subset if chunks[i][0] == CHUNK_COMPRESSED]
    # payloads wider than a device row are valid but rare: host decode
    host_idx = {i for i in all_comp if chunks[i][2] > _DECODE_CMAX}
    comp_idx = [i for i in all_comp if i not in host_idx]
    for i in sorted(host_idx):
        HOST_FALLBACKS["oversize_payload"] += 1
        _host_decode_chunk(src_arr, chunks[i], out, dst_offs[i])
    host_checked |= host_idx
    for i in subset:
        ch = chunks[i]
        if ch[0] == CHUNK_UNCOMPRESSED:
            out[dst_offs[i] : dst_offs[i] + ch[4]] = src_arr[ch[1] : ch[1] + ch[2]]
            host_checked.add(i)

    if comp_idx:
        use_dev_crc = verify_checksums and DEVICE_CRC
        if engine == "id":
            _decode_id_batches(src_arr, chunks, comp_idx, dst_offs, out,
                               use_dev_crc, device)
        elif engine == "seq":
            _decode_seq_batches(src_arr, chunks, comp_idx, dst_offs, out,
                                use_dev_crc, device)
        else:
            host_checked |= _decode_classify_batches(
                src_arr, chunks, comp_idx, dst_offs, out, use_dev_crc,
                device)
        if not use_dev_crc:
            host_checked.update(comp_idx)

    if verify_checksums:
        nat = _native()
        for i in subset:
            if i not in host_checked:
                continue  # verified on the device
            ch = chunks[i]
            got = mask_crc(nat.crc32c(
                out[dst_offs[i] : dst_offs[i] + ch[4]].tobytes()))
            if got != ch[3]:
                raise ChecksumError(ch[3], got)


def _id_sets(device):
    return _host_sets(
        device, panel=((BATCH, _ID_ROWS * 128), torch.uint8),
        lens=((BATCH,), torch.int32), crc=((BATCH,), torch.int64))


def _dispatch_id(src_arr, grp_chunks, hs: _HostSet, device,
                 with_crc: bool) -> torch.Tensor:
    """Id-stage one batch into ``hs``'s pinned panel, upload it, and
    launch its CRC when asked; returns the device panel."""
    ng = len(grp_chunks)
    hs.wait()
    stage_id_rows(src_arr, grp_chunks, hs.np["panel"][:ng], hs.np["lens"][:ng])
    panel = _upload(hs.t["panel"][:ng], device)
    if with_crc:
        _crc_into(hs, panel[:, :_CRC_CHUNK], device)
    hs.record()
    return panel


def _decode_id_batches(src_arr, chunks, comp_idx, dst_offs, out,
                       use_dev_crc: bool, device) -> None:
    """Id mode, host output: stage each batch with the native id walk,
    CRC it on the device, copy the verified rows out of the staging
    panel.  Batch k+1 is staged while batch k's CRC runs."""
    sets = _id_sets(device)

    def dispatch(k, base):
        grp = comp_idx[base : base + BATCH]
        hs = sets[k % _NSETS]
        _dispatch_id(src_arr, [chunks[i] for i in grp], hs, device,
                     use_dev_crc)
        return grp, hs

    for grp, hs in _one_behind(range(0, len(comp_idx), BATCH), dispatch):
        hs.wait()
        if use_dev_crc:
            _check_crcs([chunks[i] for i in grp], hs.np["crc"])
        panel = hs.np["panel"]
        for row, i in enumerate(grp):
            d = chunks[i][4]
            out[dst_offs[i] : dst_offs[i] + d] = panel[row, :d]


def _flat_dec_sets(device, rows: int, rb: int, out_width: int):
    return _host_sets(
        device, b=((rows * rb * 128,), torch.uint8),
        meta=((rows, 8 * _F_TRIPS, 128), torch.int32),
        meta_up=((rows * 8 * _F_TRIPS * 128,), torch.int32),
        starts=((rows, 8, 128), torch.int32), ntr=((rows,), torch.int32),
        lens=((rows,), torch.int32), crc=((rows,), torch.int64),
        res=((rows, out_width), torch.uint8))


def _upload_flat(hs: _HostSet, n: int, rb: int, device):
    """Upload rows [:n] of a staged flat plan.  The meta panel is cut to
    the trips the batch uses (a contiguous copy inside pinned memory), so
    the transfer skips the empty tail of the trip cap."""
    t_used = max(1, int((hs.np["ntr"][:n] & 0xFFFF).max()) if n else 1)
    size = n * 8 * t_used * 128
    hs.np["meta_up"][:size].reshape(n, 8 * t_used, 128)[...] = (
        hs.np["meta"][:n, : 8 * t_used])
    return (_upload(hs.t["b"][: n * rb * 128].view(n, rb * 128), device),
            _upload(hs.t["meta_up"][:size].view(n, 8 * t_used, 128), device),
            _upload(hs.t["starts"][:n], device),
            _upload(hs.t["ntr"][:n], device))


def _decode_classify_batches(src_arr, chunks, comp_idx, dst_offs, out,
                             use_dev_crc: bool, device) -> set:
    """Classify mode, host output: native flat plans executed by the
    flat kernel, CRC-checked on the device, fetched back.  Returns the
    chunks decoded on the host instead (plan overflow)."""
    nat = _native()
    sets = _flat_dec_sets(device, BATCH, rows_b_for(_DECODE_CMAX),
                          MAX_CHUNK_UNCOMPRESSED)
    host_decoded: set = set()

    def dispatch(k, base):
        grp = comp_idx[base : base + BATCH]
        ng = len(grp)
        # size B rows to the batch's widest payload
        rb = rows_b_for(_bucket_cmax(max(chunks[i][2] for i in grp)))
        hs = sets[k % _NSETS]
        hs.wait()
        offs64, lens64, hdrs64, dstl64 = _batch_arrays(chunks, grp)
        rc64 = np.zeros(ng, np.int64)
        bad = nat.stage_flat_dec_batch(
            src_arr, offs64, lens64, hdrs64, dstl64, rb,
            hs.np["meta"][:ng], hs.np["starts"][:ng],
            hs.np["b"][: ng * rb * 128].reshape(ng, rb * 128), rc64,
            n_threads=_threads())
        ntr = hs.np["ntr"]
        ntr[:ng] = np.maximum(rc64, 0)
        lens = hs.np["lens"]
        lens[:ng] = dstl64
        host_rows = set()
        if bad:
            for row, i in enumerate(grp):
                rc = int(rc64[row])
                if rc >= 0:
                    continue
                if rc != -5:
                    raise CorruptError("invalid chunk payload (flat stage)")
                # plan over its caps: decode this chunk on the host
                HOST_FALLBACKS["plan_overflow"] += 1
                _host_decode_chunk(src_arr, chunks[i], out, dst_offs[i])
                host_rows.add(row)
                host_decoded.add(i)
                ntr[row] = 0
                lens[row] = 0
        res = decode_blocks_flat(*_upload_flat(hs, ng, rb, device),
                                 dst_max=MAX_CHUNK_UNCOMPRESSED)
        if use_dev_crc:
            _crc_into(hs, res, device)
        hs.t["res"][:ng].copy_(res, non_blocking=True)
        hs.record()
        return grp, hs, host_rows

    for grp, hs, host_rows in _one_behind(range(0, len(comp_idx), BATCH),
                                          dispatch):
        hs.wait()
        if use_dev_crc:
            _check_crcs([chunks[i] for i in grp], hs.np["crc"], host_rows)
        res = hs.np["res"]
        for row, i in enumerate(grp):
            if row not in host_rows:
                d = chunks[i][4]
                out[dst_offs[i] : dst_offs[i] + d] = res[row, :d]
    return host_decoded


def _seq_dec_sets(device, rows: int, host_out: bool):
    """Host sets of the device LZ decode: payload rows, the per-row
    (starts, clens, dlens, CRC lengths) words, and what comes back."""
    shapes = dict(comp=((rows * _DECODE_CMAX,), torch.uint8),
                  meta=((4 * rows,), torch.int32),
                  err=((rows,), torch.int32), crc=((rows,), torch.int64))
    if host_out:
        shapes["res"] = ((rows, MAX_CHUNK_UNCOMPRESSED), torch.uint8)
    return _host_sets(device, **shapes)


def _dispatch_seq(src_arr, grp, hs: _HostSet, device, with_crc: bool,
                  host_out: bool) -> torch.Tensor:
    """Stage one batch of scanned chunks into ``hs``'s pinned payload
    rows, upload them, launch the sequential decode (and the CRC of its
    rows when asked), and queue the fetch of the error codes and CRCs
    (and with ``host_out`` the decoded rows) into ``hs``.  A compressed
    chunk's row is its payload (the element
    stream starts after the varint header); an uncompressed chunk's row
    is its data, decoded as an empty stream and copied into place on
    the device.  Returns the device rows [len(grp), 64 KiB]."""
    ng = len(grp)
    hs.wait()
    cmax = _bucket_cmax(max(ch[2] for ch in grp))
    # bytes past a payload's end are left as they are: the decoder's
    # result does not depend on them
    rows = hs.np["comp"][: ng * cmax].reshape(ng, cmax)
    meta = hs.np["meta"][: 4 * ng].reshape(4, ng)
    for row, (ctype, p_off, p_len, _crc, dst_len, hdr) in enumerate(grp):
        rows[row, :p_len] = src_arr[p_off : p_off + p_len]
        if ctype == CHUNK_COMPRESSED:
            meta[:, row] = (hdr, p_len, dst_len, dst_len)
        else:
            meta[:, row] = (0, 0, 0, dst_len)
    comp = _upload(hs.t["comp"][: ng * cmax], device).view(ng, cmax)
    meta_d = _upload(hs.t["meta"][: 4 * ng], device).view(4, ng)
    dec, err = decode_blocks_seq(comp, meta_d[0], meta_d[1], meta_d[2],
                                 out_max=MAX_CHUNK_UNCOMPRESSED)
    for row, ch in enumerate(grp):
        if ch[0] != CHUNK_COMPRESSED:
            dec[row, : ch[2]].copy_(comp[row, : ch[2]])
    if with_crc:
        hs.t["crc"][:ng].copy_(crc32c_chunks(dec, meta_d[3]),
                               non_blocking=True)
    hs.t["err"][:ng].copy_(err, non_blocking=True)
    if host_out:
        hs.t["res"][:ng].copy_(dec, non_blocking=True)
    hs.record()
    return dec


def _check_seq(grp, hs: _HostSet, with_crc: bool) -> None:
    """Raise for the first row of a finished batch that failed: its
    decode error (CorruptError), else its CRC (ChecksumError)."""
    err, crc = hs.np["err"], hs.np["crc"]
    for row, ch in enumerate(grp):
        if err[row]:
            raise CorruptError(ERR_MESSAGES.get(int(err[row]), "decode error"))
        if with_crc and int(crc[row]) != unmask_crc(ch[3]):
            raise ChecksumError(ch[3], None)


def _decode_seq_batches(src_arr, chunks, comp_idx, dst_offs, out,
                        use_dev_crc: bool, device) -> None:
    """Device LZ engine, host output: the payloads go up, the sequential
    kernel decodes and CRCs them, the decoded rows come back.  Batch k+1
    is staged while batch k runs."""
    sets = _seq_dec_sets(device, min(BATCH, len(comp_idx)), host_out=True)

    def dispatch(k, base):
        grp = [chunks[i] for i in comp_idx[base : base + BATCH]]
        hs = sets[k % _NSETS]
        _dispatch_seq(src_arr, grp, hs, device, use_dev_crc, host_out=True)
        return comp_idx[base : base + BATCH], grp, hs

    for idx, grp, hs in _one_behind(range(0, len(comp_idx), BATCH), dispatch):
        hs.wait()
        _check_seq(grp, hs, use_dev_crc)
        res = hs.np["res"]
        for row, i in enumerate(idx):
            d = chunks[i][4]
            out[dst_offs[i] : dst_offs[i] + d] = res[row, :d]


def stage_id_rows(src_arr: np.ndarray, grp, b_u8: np.ndarray,
                  dlens: np.ndarray) -> None:
    """Id-stage one group of scanned framed chunks into staging rows:
    compressed chunks decode through the threaded native id walk in
    contiguous runs, uncompressed chunks are their payload.  Fills
    dlens per row; raises CorruptError on an invalid payload."""
    nat = _native()
    comp_rows = []
    for row, ch in enumerate(grp):
        dlens[row] = ch[4]
        if ch[0] == CHUNK_COMPRESSED:
            comp_rows.append(row)
        else:  # uncompressed: the row is the payload
            _t, p_off, p_len, _c, _d, _h = ch
            b_u8[row, :p_len] = src_arr[p_off : p_off + p_len]
            b_u8[row, p_len:] = 0
    r = 0
    while r < len(comp_rows):
        r2 = r
        while (r2 + 1 < len(comp_rows)
               and comp_rows[r2 + 1] == comp_rows[r2] + 1):
            r2 += 1
        rows = comp_rows[r : r2 + 1]
        offs64, lens64, hdrs64, dstl64 = _batch_arrays(grp, rows)
        rc64 = np.zeros(len(rows), np.int64)
        bad = nat.stage_flat_dec_id_batch(
            src_arr, offs64, lens64, hdrs64, dstl64, b_u8.shape[1] // 128,
            b_u8[rows[0] : rows[0] + len(rows)], rc64,
            n_threads=_threads())
        if bad:
            raise CorruptError("invalid chunk payload (flat stage)")
        r = r2 + 1


def decompress_framed_to_device(data: bytes, verify_checksums: bool = True,
                                device=None) -> torch.Tensor:
    """Framed-stream decode to a uint8 tensor on ``device``.

    Id mode: the host id-stages each batch, the host-to-device copy
    carries the decoded bytes, each chunk's CRC-32C is checked on the
    device where the bytes land, and each batch's 64 KiB images go
    straight into one preallocated output tensor.  Only the CRC values
    come back.  Device LZ engine: the payloads go up, the sequential
    kernel decodes them and checks their CRCs on the device, and the
    decoded rows go into the output tensor the same way; only the error
    codes and CRC values come back.  Streams whose chunks are not all
    full 64 KiB rows but the last, and classify mode, decode through
    ``decompress_framed`` and upload the result."""
    chunks, total = _scan_frames(data)
    device = resolve(device)
    _native()
    uniform = total > 0 and all(
        ch[4] == _CRC_CHUNK for ch in chunks[:-1]) and all(
        ch[2] <= _DECODE_CMAX for ch in chunks if ch[0] == CHUNK_COMPRESSED)
    engine = _decode_engine()
    if not (engine in ("id", "seq") and DEVICE_CRC and uniform):
        return _upload_bytes(
            decompress_framed(data, verify_checksums, device=device), device)
    src_arr = np.frombuffer(data, np.uint8)
    out = torch.empty(total, dtype=torch.uint8, device=device)
    seq = engine == "seq"
    if seq:
        sets = _seq_dec_sets(device, min(BATCH, len(chunks)), host_out=False)
    else:
        sets = _id_sets(device)

    def dispatch(k, base):
        grp = chunks[base : base + BATCH]
        hs = sets[k % _NSETS]
        if seq:
            rows = _dispatch_seq(src_arr, grp, hs, device, verify_checksums,
                                 host_out=False)
        else:
            rows = _dispatch_id(src_arr, grp, hs, device, verify_checksums)
        # every chunk but the stream's last fills its 64 KiB row
        lo = base * _CRC_CHUNK
        nb = sum(ch[4] for ch in grp)
        full = nb // _CRC_CHUNK
        if full:
            out[lo : lo + full * _CRC_CHUNK].view(full, _CRC_CHUNK).copy_(
                rows[:full, :_CRC_CHUNK])
        if nb > full * _CRC_CHUNK:
            out[lo + full * _CRC_CHUNK : lo + nb].copy_(
                rows[full, : nb - full * _CRC_CHUNK])
        return grp, hs

    for grp, hs in _one_behind(range(0, len(chunks), BATCH), dispatch):
        hs.wait()
        if seq:
            _check_seq(grp, hs, verify_checksums)
        elif verify_checksums:
            _check_crcs(grp, hs.np["crc"])
    return out


def _decompress_raw_flat(data: bytes, dst_len: int, hdr: int,
                         device) -> torch.Tensor | None:
    """Classify-mode decode of a raw stream of any size on the device:
    64 KiB output segments planned serially on the host (the native seg
    stager carries the walk state and a 64 KiB history), executed in
    batches by the flat kernel straight into one device tensor.  Returns
    None when a segment is unplannable; raises CorruptError on invalid
    streams."""
    nat = _native()
    arr = np.frombuffer(data, np.uint8)
    rb = rows_b_for(_RAW_SEG_CMAX)
    nseg = (dst_len + _RAW_SEG - 1) // _RAW_SEG
    width = min(BATCH, nseg)
    state = np.array([hdr, 0, 0, 0, 0, 0], np.int64)
    img = np.zeros(65536 + _RAW_SEG + 64, np.uint8)
    out = torch.empty(nseg * _RAW_SEG, dtype=torch.uint8, device=device)
    out_rows = out.view(nseg, _RAW_SEG)
    sets = _flat_dec_sets(device, width, rb, 0)
    done = 0
    seg0 = 0
    k = 0
    while done < dst_len:
        hs = sets[k % _NSETS]
        k += 1
        hs.wait()
        b_rows = hs.np["b"].reshape(width, rb * 128)
        cnt = 0
        while cnt < width and done < dst_len:
            seg = min(_RAW_SEG, dst_len - done)
            g = nat.stage_flat_dec_seg(
                arr, dst_len, state, img, seg, _RAW_SEG_CMAX, rb,
                hs.np["meta"][cnt], hs.np["starts"][cnt], b_rows[cnt])
            if g is None:
                return None
            hs.np["ntr"][cnt] = g
            # slide the carry: last 64 KiB of (carry + this segment)
            img[:65536] = img[seg : seg + 65536].copy()
            done += seg
            cnt += 1
        b, meta, starts, ntrips = _upload_flat(hs, cnt, rb, device)
        hs.record()
        decode_blocks_flat(b, meta, starts, ntrips, dst_max=_RAW_SEG,
                           out=out_rows[seg0 : seg0 + cnt])
        seg0 += cnt
    if int(state[0]) != len(data) or state[3] or state[5]:
        raise CorruptError("raw stream length disagrees with preamble")
    return out[:dst_len]


def decompress(data: bytes, device=None) -> bytes:
    """Raw Snappy stream decode to host bytes.  Id mode: the native walk
    is the decode (a raw stream has no CRC for the device to check).
    Classify mode: the segmented flat engine on the device, the native
    decoder for unplannable streams.  Device LZ engine: the native
    decoder, as in the JAX package."""
    dst_len, hdr = read_uvarint(data, 0)
    nat = _native()
    if FLAT and FLAT_MODE != "id":
        got = _decompress_raw_flat(data, dst_len, hdr, resolve(device))
        if got is not None:
            return got.cpu().numpy().tobytes()
        HOST_FALLBACKS["plan_overflow"] += 1
    return nat.decompress(data)


def decompress_to_device(data: bytes, device=None) -> torch.Tensor:
    """Raw Snappy stream decode to a uint8 tensor on ``device``.

    Id mode: the native id walk decodes 64 KiB segments straight into
    pinned staging rows (resume state carries straddling tags, a rolling
    64 KiB history carries copy sources) and each batch is copied into
    one preallocated device tensor.  Classify mode: the segmented flat
    engine.  Streams with a copy offset past 64 KiB (which no real
    encoder emits) or an unplannable segment decode on the host, and so
    does every stream under the device LZ engine, as in the JAX
    package."""
    dst_len, hdr = read_uvarint(data, 0)
    device = resolve(device)
    nat = _native()
    if not FLAT:
        return _upload_bytes(nat.decompress(data), device)
    if FLAT_MODE != "id":
        got = _decompress_raw_flat(data, dst_len, hdr, device)
        if got is not None:
            return got
        HOST_FALLBACKS["plan_overflow"] += 1
        return _upload_bytes(nat.decompress(data), device)
    if dst_len == 0:
        return _upload_bytes(nat.decompress(data), device)
    arr = np.frombuffer(data, np.uint8)
    nseg = (dst_len + _RAW_SEG - 1) // _RAW_SEG
    width = min(BATCH, nseg)
    state = np.array([hdr, 0, 0, 0, 0, 0], np.int64)
    img = np.zeros(65536 + _RAW_SEG + 64, np.uint8)
    out = torch.empty(dst_len, dtype=torch.uint8, device=device)
    sets = _host_sets(device, rows=((width, _RAW_SEG), torch.uint8))
    done = 0
    k = 0
    while done < dst_len:
        hs = sets[k % _NSETS]
        k += 1
        hs.wait()
        rows = hs.np["rows"]
        lo = done
        cnt = 0
        while cnt < width and done < dst_len:
            seg = min(_RAW_SEG, dst_len - done)
            if not nat.stage_flat_dec_id_seg(arr, dst_len, state, img, seg,
                                             _RAW_SEG // 128, rows[cnt]):
                HOST_FALLBACKS["far_offset"] += 1
                return _upload_bytes(nat.decompress(data), device)
            img[:65536] = img[seg : seg + 65536].copy()
            done += seg
            cnt += 1
        out[lo:done].copy_(hs.t["rows"].view(-1)[: done - lo],
                           non_blocking=True)
        hs.record()
    if int(state[0]) != len(data) or state[3] or state[5]:
        raise CorruptError("raw stream length disagrees with preamble")
    return out


# ---------------------------------------------------------------------
# encode


def _encode_batches(data, chunk_size: int, device):
    """Yield (chunk_index, chunk_len, element_bytes) for every chunk of
    data.  Id mode with 64 KiB rows: the threaded native compressor
    emits the elements.  Otherwise the flat encode replay: the native
    stager runs the matcher and plans the element, the flat kernel emits
    it on the device (rows over the plan caps take the host emission the
    stager already made).  Batch k+1 is staged while batch k runs."""
    nat = _native()
    data = memoryview(data)
    n = len(data)
    n_chunks = (n + chunk_size - 1) // chunk_size
    bmax = 256
    while bmax < chunk_size:
        bmax *= 2
    use_id = FLAT_MODE == "id" and bmax == MAX_CHUNK_UNCOMPRESSED
    rows = min(BATCH, n_chunks)
    elem_buf = np.empty(
        (rows, nat.max_compressed_length(MAX_BLOCK_SIZE) + 8), np.uint8)
    trip_cap = _enc.ENC_TRIP_CAP
    rb = _enc.RB_ENC
    sets = None if use_id else _host_sets(
        device, b=((rows * rb * 128,), torch.uint8),
        meta=((rows, 8 * trip_cap, 128), torch.int32),
        meta_up=((rows * 8 * trip_cap * 128,), torch.int32),
        starts=((rows, 8, 128), torch.int32), ntr=((rows,), torch.int32),
        comp=((rows * _enc.ENC_DST_MAX,), torch.uint8))

    def stage(base):
        cnt = min(BATCH, n_chunks - base)
        arr = np.zeros((cnt, bmax), dtype=np.uint8)
        lens64 = np.zeros(cnt, np.int64)
        for i in range(cnt):
            off = (base + i) * chunk_size
            chunk = data[off : off + chunk_size]
            arr[i, : len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
            lens64[i] = len(chunk)
        return arr, lens64, *(np.zeros(cnt, np.int64) for _ in range(3))

    if use_id:
        for base in range(0, n_chunks, BATCH):
            arr, lens64, clens64, hdrs64, rc64 = stage(base)
            cnt = len(lens64)
            bad = nat.compress_batch(arr, lens64, elem_buf[:cnt], clens64,
                                     hdrs64, rc64, n_threads=_threads())
            if bad:  # pragma: no cover - the native compressor cannot fail
                raise SnappyError("native compressor rejected a block")
            for i in range(cnt):
                yield (base + i, int(lens64[i]),
                       elem_buf[i, int(hdrs64[i]) : int(clens64[i])].tobytes())
        return

    def dispatch(k, base):
        arr, lens64, clens64, hdrs64, rc64 = stage(base)
        cnt = len(lens64)
        hs = sets[k % _NSETS]
        hs.wait()
        bad = nat.stage_flat_enc_batch(
            arr, lens64, rb, hs.np["meta"][:cnt], hs.np["starts"][:cnt],
            hs.np["b"][: cnt * rb * 128].reshape(cnt, rb * 128),
            _enc.TAG_ROWS * 128, elem_buf[:cnt], clens64, hdrs64, rc64,
            n_threads=_threads())
        hs.np["ntr"][:cnt] = np.maximum(rc64, 0)
        fallback = {}
        if bad:
            for i in range(cnt):
                if rc64[i] < 0:  # plan over its caps: the host emission
                    HOST_FALLBACKS["plan_overflow"] += 1
                    fallback[i] = elem_buf[
                        i, int(hdrs64[i]) : int(clens64[i])].tobytes()
                    hs.np["ntr"][i] = 0
        comp = _enc.encode_blocks_flat(*_upload_flat(hs, cnt, rb, device))
        kmax = min((int(clens64.max()) + 511) & ~511, _enc.ENC_DST_MAX)
        hs.t["comp"][: cnt * kmax].view(cnt, kmax).copy_(
            comp[:, :kmax].contiguous(), non_blocking=True)
        hs.record()
        return base, lens64, hs, clens64, hdrs64, fallback, kmax

    for base, lens, hs, clens, hdrs, fallback, kmax in _one_behind(
            range(0, n_chunks, BATCH), dispatch):
        hs.wait()
        comp = hs.np["comp"][: len(lens) * kmax].reshape(len(lens), kmax)
        for i in range(len(lens)):
            blob = fallback.get(i)
            if blob is None:
                blob = comp[i, int(hdrs[i]) : int(clens[i])].tobytes()
            yield base + i, int(lens[i]), blob


def _stored(chunk_len: int, clen: int) -> bool:
    """Whether the framed format stores a chunk uncompressed, given the
    length of its element."""
    return framed_chunk_type(
        chunk_len, len(put_uvarint(chunk_len)) + clen) == CHUNK_UNCOMPRESSED


def _framed_record(chunk_len: int, elem: bytes, crc: int, raw) -> bytes:
    """One framed chunk record: the compressed body, or the chunk's bytes
    ``raw`` when the element saves under 12.5%."""
    if _stored(chunk_len, len(elem)):
        chunk_type, body = CHUNK_UNCOMPRESSED, bytes(raw)
    else:
        chunk_type, body = CHUNK_COMPRESSED, put_uvarint(chunk_len) + elem
    blen = len(body) + 4
    return (bytes((chunk_type, blen & 0xFF, (blen >> 8) & 0xFF,
                   (blen >> 16) & 0xFF))
            + mask_crc(crc).to_bytes(4, "little") + body)


def _encode_seq(src, cs: int, device, with_crc: bool):
    """Device LZ engine: yield (chunk_index, chunk_len, element, crc,
    stored) for the cs-byte chunks of ``src``, host bytes or a flat
    uint8 tensor on ``device``.

    Host bytes go up through pinned rows; a device tensor is encoded in
    place.  The sequential kernel encodes each batch of chunk rows, and
    with ``with_crc`` the CRC kernel checksums them (``crc`` is else
    None).  What comes back is each batch's lengths and CRCs, then its
    elements cut to the batch's longest; the trimmed fetch of batch k is
    queued while batch k+1 is staged, when its lengths are on the host.
    A device tensor's chunk bytes also come back (``stored``, else None)
    where the host needs them: for chunks the framed format stores
    uncompressed, and for every chunk when the host CRCs them."""
    on_dev = isinstance(src, torch.Tensor)
    n = int(src.numel()) if on_dev else len(src)
    n_chunks = -(-n // cs)
    if n_chunks == 0:
        return
    rows_n = min(BATCH, n_chunks)
    cap = comp_width(cs)
    shapes = dict(lens=((rows_n,), torch.int32), clens=((rows_n,), torch.int32),
                  crc=((rows_n,), torch.int64),
                  comp=((rows_n * cap,), torch.uint8))
    # device input: rows the host fetches; host input: pinned staging rows
    shapes["stored" if on_dev else "blocks"] = ((rows_n * cs,), torch.uint8)
    sets = _host_sets(device, **shapes)
    src_np = None if on_dev else np.frombuffer(src, np.uint8)
    pending = []

    def rows_of(lo: int, nb: int, cnt: int, hs: _HostSet) -> torch.Tensor:
        if not on_dev:
            hs.np["blocks"][:nb] = src_np[lo : lo + nb]
            return _upload(hs.t["blocks"][: cnt * cs], device).view(cnt, cs)
        if nb == cnt * cs:
            return src[lo : lo + nb].view(cnt, cs)
        rows = torch.zeros(cnt * cs, dtype=torch.uint8, device=device)
        rows[:nb] = src[lo : lo + nb]  # the stream's short last chunk
        return rows.view(cnt, cs)

    def fetch(b: dict) -> None:
        if b["kmax"] is not None:
            return
        hs, cnt, lens = b["hs"], b["cnt"], b["lens"]
        hs.wait()  # its lengths (and CRCs) are on the host
        clens = hs.np["clens"][:cnt]
        kmax = min((int(clens.max()) + 511) & ~511, cap)
        hs.t["comp"][: cnt * kmax].view(cnt, kmax).copy_(
            b["comp"][:, :kmax].contiguous(), non_blocking=True)
        if on_dev:
            b["stored"] = {i for i in range(cnt) if not with_crc or _stored(
                int(lens[i]), int(clens[i]))}
            for i in b["stored"]:
                hs.t["stored"][i * cs : i * cs + lens[i]].copy_(
                    b["rows"][i, : lens[i]], non_blocking=True)
        hs.record()
        b["kmax"] = kmax

    def dispatch(k, base):
        cnt = min(BATCH, n_chunks - base)
        lo = base * cs
        nb = min(n, lo + cnt * cs) - lo
        hs = sets[k % _NSETS]
        hs.wait()
        lens = _chunk_lens(nb, cnt, cs)
        hs.np["lens"][:cnt] = lens
        rows = rows_of(lo, nb, cnt, hs)
        if pending:
            fetch(pending.pop())
        lens_d = _upload(hs.t["lens"][:cnt], device)
        comp, clens, _err = encode_blocks_seq(rows, lens_d)  # lens are valid
        hs.t["clens"][:cnt].copy_(clens, non_blocking=True)
        if with_crc:
            hs.t["crc"][:cnt].copy_(crc32c_chunks(rows, lens_d),
                                    non_blocking=True)
        hs.record()
        b = dict(base=base, cnt=cnt, hs=hs, rows=rows, comp=comp, lens=lens,
                 kmax=None, stored=set())
        pending.append(b)
        return b

    for b in _one_behind(range(0, n_chunks, BATCH), dispatch):
        fetch(b)  # the last batch: no later dispatch queued its fetch
        hs = b["hs"]
        hs.wait()
        comp = hs.np["comp"][: b["cnt"] * b["kmax"]].reshape(b["cnt"],
                                                            b["kmax"])
        for i in range(b["cnt"]):
            ln = int(b["lens"][i])
            yield (b["base"] + i, ln, comp[i, : hs.np["clens"][i]].tobytes(),
                   int(hs.np["crc"][i]) if with_crc else None,
                   hs.np["stored"][i * cs : i * cs + ln]
                   if i in b["stored"] else None)


def compress(data: bytes, device=None) -> bytes:
    """Raw Snappy stream (per-64 KiB fragments)."""
    if len(data) > MAX_UNCOMPRESSED_LEN:
        raise TooLargeError(len(data))
    device = resolve(device)
    out = bytearray(put_uvarint(len(data)))
    if FLAT:
        for _, _, blob in _encode_batches(data, MAX_BLOCK_SIZE, device):
            out += blob
    else:
        for _, _, elem, _, _ in _encode_seq(data, MAX_BLOCK_SIZE, device,
                                            with_crc=False):
            out += elem
    return bytes(out)


def compress_framed(data: bytes, chunk_size: int = MAX_CHUNK_UNCOMPRESSED,
                    device=None) -> bytes:
    """Framed (.sz) stream.  Id mode with 64 KiB chunks: device CRCs
    plus one native matcher-and-assembly call per batch.  Device LZ
    engine: elements and CRCs from the device (``_encode_seq``).
    Otherwise chunk elements from ``_encode_batches`` with host CRCs."""
    if not 0 < chunk_size <= MAX_CHUNK_UNCOMPRESSED:
        raise ValueError(f"chunk_size must be in (0, 65536], got {chunk_size}")
    device = resolve(device)
    nat = _native()
    if (FLAT and FLAT_MODE == "id" and chunk_size == MAX_CHUNK_UNCOMPRESSED
            and len(data)):
        return _compress_framed_id(data, device)
    if FLAT:
        chunks = ((idx, ln, blob, None) for idx, ln, blob
                  in _encode_batches(data, chunk_size, device))
    else:
        chunks = ((idx, ln, elem, crc) for idx, ln, elem, crc, _
                  in _encode_seq(data, chunk_size, device, DEVICE_CRC))
    data_v = memoryview(data)
    out = bytearray(STREAM_ID_CHUNK)
    for idx, chunk_len, blob, crc in chunks:
        off = idx * chunk_size
        chunk = data_v[off : off + chunk_len]
        if crc is None:
            crc = nat.crc32c(bytes(chunk))
        out += _framed_record(chunk_len, blob, crc, chunk)
    return bytes(out)


def _crc_sets(device, rows: int, name: str):
    """Host sets for the encode CRC paths: ``name`` holds rows x 64 KiB."""
    return _host_sets(
        device, **{name: ((rows * MAX_CHUNK_UNCOMPRESSED,), torch.uint8)},
        lens=((rows,), torch.int32), crc=((rows,), torch.int64))


def _compress_framed_id(data: bytes, device) -> bytes:
    """Id-mode framed compress of host bytes: per batch the device CRCs
    the 64 KiB chunks while the native matcher and assembler
    (``sn_compress_framed_crc``) emit the previous batch's records with
    its device CRCs passed through."""
    nat = _native()
    cs = MAX_CHUNK_UNCOMPRESSED
    data_np = np.frombuffer(data, np.uint8)
    n = len(data)
    n_chunks = -(-n // cs)
    sets = _crc_sets(device, min(BATCH, n_chunks), "blocks")

    def dispatch(k, base):
        cnt = min(BATCH, n_chunks - base)
        lo = base * cs
        nb = min(n, lo + cnt * cs) - lo
        hs = None
        if DEVICE_CRC:
            hs = sets[k % _NSETS]
            hs.wait()
            hs.np["blocks"][:nb] = data_np[lo : lo + nb]
            hs.np["lens"][:cnt] = _chunk_lens(nb, cnt)
            rows = _upload(hs.t["blocks"][: cnt * cs], device).view(cnt, cs)
            _crc_into(hs, rows, device)
            hs.record()
        return lo, nb, cnt, hs

    out = bytearray(STREAM_ID_CHUNK)
    for lo, nb, cnt, hs in _one_behind(range(0, n_chunks, BATCH), dispatch):
        crcs = None
        if hs is not None:
            hs.wait()
            crcs = hs.np["crc"][:cnt].astype(np.uint32)
        out += nat.compress_framed_crc(data_np[lo : lo + nb], nb, crcs,
                                       chunk_size=cs, threads=_threads(),
                                       write_id=False)
    return bytes(out)


def _check_uint8(arr) -> None:
    if not isinstance(arr, torch.Tensor) or arr.dtype != torch.uint8:
        raise ValueError(
            f"expected a uint8 tensor, got {getattr(arr, 'dtype', type(arr))}")


def compress_framed_from_device(arr: torch.Tensor, device=None) -> bytes:
    """Compress a uint8 device tensor into a framed (.sz) stream.

    Each 64 KiB chunk's CRC-32C is computed on the device before its
    bytes leave; the device-to-host copy of batch k+1 overlaps the
    native matcher and assembler of batch k.  Byte-identical to
    ``compress_framed(bytes(arr))`` in id mode: same matcher, same CRCs.
    Device LZ engine: the tensor's chunks are encoded and CRC'd where
    they lie (``_encode_seq``); only elements and CRCs come back, plus
    the bytes of chunks stored uncompressed."""
    _check_uint8(arr)
    device = arr.device if device is None else resolve(device)
    arr = arr.to(device).reshape(-1)
    n = int(arr.numel())
    if n == 0:
        return bytes(STREAM_ID_CHUNK)
    nat = _native()
    cs = MAX_CHUNK_UNCOMPRESSED
    if not FLAT:
        out = bytearray(STREAM_ID_CHUNK)
        for _, ln, elem, crc, stored in _encode_seq(arr, cs, device,
                                                    DEVICE_CRC):
            if crc is None:
                crc = nat.crc32c(stored.tobytes())
            out += _framed_record(ln, elem, crc, stored)
        return bytes(out)
    n_chunks = -(-n // cs)
    sets = _crc_sets(device, min(BATCH, n_chunks), "rows")

    def dispatch(k, base):
        cnt = min(BATCH, n_chunks - base)
        lo = base * cs
        nb = min(n, lo + cnt * cs) - lo
        flat = arr[lo : lo + nb]
        hs = sets[k % _NSETS]
        hs.wait()
        if DEVICE_CRC:
            if nb == cnt * cs:
                rows = flat.view(cnt, cs)
            else:  # the stream's short last chunk: pad its row
                rows = torch.zeros(cnt * cs, dtype=torch.uint8, device=device)
                rows[:nb] = flat
                rows = rows.view(cnt, cs)
            hs.np["lens"][:cnt] = _chunk_lens(nb, cnt)
            _crc_into(hs, rows, device)
        hs.t["rows"][:nb].copy_(flat, non_blocking=True)
        hs.record()
        return nb, cnt, hs

    out = bytearray(STREAM_ID_CHUNK)
    for nb, cnt, hs in _one_behind(range(0, n_chunks, BATCH), dispatch):
        hs.wait()
        crcs = hs.np["crc"][:cnt].astype(np.uint32) if DEVICE_CRC else None
        out += nat.compress_framed_crc(hs.np["rows"][:nb], nb, crcs,
                                       chunk_size=cs, threads=_threads(),
                                       write_id=False)
    return bytes(out)


def compress_from_device(arr: torch.Tensor, device=None) -> bytes:
    """Raw-format counterpart of ``compress_framed_from_device``.  The raw
    format has no checksums, so the device has nothing to compute: fetch
    the tensor once, then the native encoder emits the stream.
    Byte-identical to ``compress(bytes(arr))`` in id mode.  Device LZ
    engine: the tensor's 64 KiB blocks are encoded where they lie and
    only the elements come back."""
    _check_uint8(arr)
    if not FLAT:
        device = arr.device if device is None else resolve(device)
        arr = arr.to(device).reshape(-1)
        out = bytearray(put_uvarint(int(arr.numel())))
        for _, _, elem, _, _ in _encode_seq(arr, MAX_BLOCK_SIZE, device,
                                            with_crc=False):
            out += elem
        return bytes(out)
    if device is not None:
        arr = arr.to(resolve(device))
    host = arr.reshape(-1).cpu().numpy()
    return _native().compress(memoryview(host))
