"""The framed and raw codec entry points on PyTorch.

Counterpart of ``snappy_tpu/runtime/device_codec.py``: its flat
engines, its hybrid decode engine and its portable engines, plus the
port's device LZ engine.  The engine is read from the JAX package's
variables (``SNAPPY_TPU_FLAT``, ``SNAPPY_TPU_HOST_PARSE``,
``SNAPPY_TPU_PALLAS``, ``SNAPPY_TPU_DEVICE_CRC``):

  =========================================  ==============  ==============  =============
  variables                                  framed decode   encode          native off
  =========================================  ==============  ==============  =============
  defaults (FLAT=1, PALLAS auto)             id / classify   id / classify   jnp / jnp
  FLAT=0, HOST_PARSE=1                       hybrid          seq             jnp / jnp
  FLAT=0, HOST_PARSE=0                       seq             seq             seq / seq
  PALLAS=0, HOST_PARSE=1, device CRC on      hybrid          jnp             jnp / jnp
  PALLAS=0, HOST_PARSE=0 or device CRC off   jnp             jnp             jnp / jnp
  =========================================  ==============  ==============  =============

"device CRC on" is ``verify_checksums`` with ``DEVICE_CRC``.  PALLAS
"auto" and "1" leave the port's kernel engines on; "0" turns the flat
and seq engines off and the port does what the JAX package does with
``_pallas_enabled()`` false: framed decode and encode as in the table,
raw decode through the native decoder (``decompress_to_device`` uploads
its result), and the from-device encoders on the native matcher with
device CRCs.  Under FLAT=0 with PALLAS on, raw decode is native too.

  id (default)  decode: the native walk decodes each chunk straight into
                a 64 KiB row of a 520-row staging panel; the device
                checks each chunk's CRC-32C where the bytes land
                (``kernels.crc32c``).  encode: the device computes each
                chunk's CRC-32C while the native matcher assembles the
                framed records (``sn_compress_framed_crc``).
  classify      the native stagers emit flat plans and the device
                executes them (``kernels.decode_flat``): framed decode,
                segmented raw decode, and the encode replay of the host
                matcher's element.
  seq           the device LZ engine: each compressed payload goes up as
                is and one warp decodes it (``kernels.decode_seq``), each
                64 KiB chunk goes up as is and one warp runs the
                reference matcher on it (``kernels.encode_seq``), and the
                CRCs are computed on the device too.
  hybrid        the native parser (``parse_tags``) validates each
                compressed payload and emits one record per element; the
                payload rows and the records go up, the record executor
                (``kernels.decode_pretagged``) builds the rows on the
                device and their CRCs are checked there.
  jnp           the portable engines, torch ops on the device: the
                payload rows go up and the parallel decoder
                (``kernels.decode_par``) parses, checks and decodes them;
                the parallel encoder (``kernels.encode_par``) encodes the
                chunk rows.  A row the encoder cannot certify (ok=False)
                takes the reference element (the native encoder's,
                which equals ``spec.reference``'s), and with
                ``RATIO_GUARD`` so does a row longer than it.

Host buffers that feed a transfer are pinned on a GPU and reused in
rounds of ``_NSETS``; each round records a CUDA event after its
transfers and the next use of its buffers waits on it, so staging a
batch never rewrites memory that an earlier asynchronous copy still
reads.

Without the native library ("native off": ``native.available()`` false)
the port does what the JAX package does without it, byte for byte: the
id, classify and hybrid engines need the library, so the pick is the
last column of the table (the seq engine needs none).  Every CRC the
port computes is ``crc32c_chunks`` (``_crc32c_host`` for host bytes),
the jnp encoder's reference element for ``ok=False`` rows and
``RATIO_GUARD`` is the sequential encoder's (``encode_blocks_seq``, one
launch a batch, on the rows already on the device), raw decode is one
row of the parallel decoder (``decode_block_par``), the from-device
encoders run the jnp engine on the tensor in place, and the per-chunk
host decodes take the reference decoder (``spec.reference``).

The only host decodes are the reference's per-chunk format fallbacks
(a plan over its caps, a payload wider than ``_DECODE_CMAX``, a copy
offset past 64 KiB); ``HOST_FALLBACKS`` counts them.  ``ENCODE_REPLACED``
counts the jnp encoder's rows replaced by the reference element.

Spans and counters: while a ``torch.profiler`` session records, each
entry point is a host span ``snappy.<name>`` (``utils.trace.span``) and
its phases are spans nested in it: ``snappy.scan`` (the header walk),
``snappy.alloc`` (host sets and outputs), ``snappy.stage`` (filling a
batch's pinned set), ``snappy.native`` (a threaded native call),
``snappy.enqueue`` (a batch's copies and launches), ``snappy.wait``
(blocked on a batch's event) and ``snappy.finish`` (the checks and the
assembly after it).  The id and seq engines' framed paths have every
phase; the others ``snappy.alloc`` and ``snappy.wait``, through the
shared helpers.  ``COUNTERS`` counts, always, the bytes the calls were
asked for and the bytes they copied each way, and the native calls'
wall and process CPU time.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from snappy_tpu_torch import native
from snappy_tpu_torch.errors import (
    BadMagicError,
    ChecksumError,
    CorruptError,
    SnappyError,
    TooLargeError,
    UnsupportedError,
)
from snappy_tpu_torch.spec.format import (
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
from snappy_tpu_torch.kernels import decode_par as _dpar
from snappy_tpu_torch.kernels import decode_seq as _dseq
from snappy_tpu_torch.kernels import encode_par as _epar
from snappy_tpu_torch.kernels import encode_seq as _eseq
from snappy_tpu_torch.kernels.decode_pretagged import (
    decode_blocks_pretagged,
    record_cap,
)
from snappy_tpu_torch.kernels.decode_seq import ERR_MESSAGES, decode_blocks_seq
from snappy_tpu_torch.kernels.encode_seq import comp_width, encode_blocks_seq
from snappy_tpu_torch.spec import reference as _reference
from snappy_tpu_torch.utils.trace import span

# Chunks per device batch; the same variable as the JAX package's.
BATCH = int(os.environ.get("SNAPPY_TPU_BATCH", "64"))
# Device CRC-32C of every chunk; "0" checks and computes CRCs on the host.
DEVICE_CRC = os.environ.get("SNAPPY_TPU_DEVICE_CRC", "1") != "0"
# Flat engines ("1", default), else the hybrid ("1") or device LZ ("0")
# decode engine by HOST_PARSE; the same variables as the JAX package's.
FLAT = os.environ.get("SNAPPY_TPU_FLAT", "1") != "0"
HOST_PARSE = os.environ.get("SNAPPY_TPU_HOST_PARSE", "1") != "0"
# The JAX package's kernel-engine gate: "auto" and "1" leave the flat and
# seq engines on, "0" turns them off (the hybrid and jnp engines then).
PALLAS = os.environ.get("SNAPPY_TPU_PALLAS", "auto") != "0"
# jnp encode: replace a row's element by the reference element when that
# one is shorter (one native encode per chunk, or without the native
# library one sequential-encoder launch per batch).
RATIO_GUARD = os.environ.get("SNAPPY_TPU_RATIO_GUARD", "1") != "0"
# Flat engine mode: "id" (identity staging + device CRC) or "classify".
FLAT_MODE = os.environ.get("SNAPPY_TPU_FLAT_MODE", "id")

_DECODE_CMAX = 66560  # 65536 + margin: widest payload a device row takes
_ID_ROWS = 520        # 512 image rows + 8 guard rows (wide-copy slop)
_RAW_SEG = 65536      # output bytes per segment of a raw stream
_RAW_SEG_CMAX = 2 * 65536  # payload slice cap per raw segment
_NSETS = 2            # rounds of host staging buffers in flight
# most records a payload of _DECODE_CMAX bytes holds (every element is at
# least 2 bytes), plus slack: sn_parse_tags never runs out on a valid one
_T_CAP = _DECODE_CMAX // 2 + 2

# per-chunk host decodes, by cause
HOST_FALLBACKS = {"plan_overflow": 0, "oversize_payload": 0, "far_offset": 0}
# jnp encode rows that took the reference element, by cause
ENCODE_REPLACED = {"not_ok": 0, "ratio_guard": 0}
# the uncompressed bytes of the entry points' calls; the bytes of the
# batches copied up (``_upload``, ``_upload_bytes``) and back (``_fetch``,
# ``_fetch_rows``), the native-off host CRCs' copies aside; wall and
# process CPU nanoseconds of the threaded native calls (``_native_call``),
# whose ratio over the threads is their busy share
COUNTERS = {"bytes": 0, "h2d_bytes": 0, "d2h_bytes": 0,
            "native_wall_ns": 0, "native_cpu_ns": 0}


def _entry(fn):
    """A public entry point, run inside its root span ``snappy.<name>``."""
    name = f"snappy.{fn.__name__}"

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return entry


def _native_call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a threaded native function, inside
    ``snappy.native``, its wall and process CPU time counted.  Callers
    pass ``native.<fn>`` looked up at the call."""
    t0, c0 = time.perf_counter_ns(), time.process_time_ns()
    with span("snappy.native"):
        out = fn(*args, **kwargs)
    COUNTERS["native_wall_ns"] += time.perf_counter_ns() - t0
    COUNTERS["native_cpu_ns"] += time.process_time_ns() - c0
    return out


def _native():
    if not native.available():
        raise SnappyError(
            "the native host codec (snappy_tpu_torch.native) is unavailable; "
            "snappy_tpu_torch needs it for staging and assembly")
    return native


def _threads() -> int:
    return min(4, os.cpu_count() or 1)


def _seq_width(resident, device, width: int) -> int:
    """Rows per launch of a device LZ kernel: BATCH, and on a card at
    least the rows it holds in flight (``resident(device, width)``), so
    that a launch fills every SM.  The id, classify, wave and devmatch
    engines keep BATCH."""
    return max(BATCH, resident(device, width)) if device.type == "cuda" \
        else BATCH


def _bucket_cmax(kmax: int) -> int:
    """Payload row width for a batch whose widest payload is kmax bytes:
    the JAX package's buckets (16,640 / 33,280 / 66,560)."""
    return next((c for c in (16640, 33280) if kmax <= c), _DECODE_CMAX)


def _portable_engine() -> str:
    """The engine of both directions without the native library: the
    device LZ engine where the variables pick it (PALLAS on, FLAT=0,
    HOST_PARSE=0), else "jnp", as in the JAX package, whose flat, id and
    hybrid engines all need the library."""
    return "seq" if PALLAS and not FLAT and not HOST_PARSE else "jnp"


def _decode_engine(dev_crc: bool) -> str:
    """The framed decode engine: "id", "classify", "seq", "hybrid" or
    "jnp" (the module docstring's table); ``dev_crc``: the CRCs are
    checked on the device."""
    if not native.available():
        return _portable_engine()
    if not PALLAS:
        return "hybrid" if HOST_PARSE and dev_crc else "jnp"
    if FLAT:
        return "id" if FLAT_MODE == "id" else "classify"
    return "hybrid" if HOST_PARSE else "seq"


def _encode_engine() -> str:
    """The encode engine: "flat" (id or classify), "seq" or "jnp"."""
    if not native.available():
        return _portable_engine()
    if not PALLAS:
        return "jnp"
    return "flat" if FLAT else "seq"


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
            with span("snappy.wait"):
                self._event.synchronize()
            self._event = None


def _host_sets(device: torch.device, **shapes) -> list[_HostSet]:
    with span("snappy.alloc"):
        return [_HostSet(device, shapes) for _ in range(_NSETS)]


def _release(sets: list[_HostSet]) -> None:
    """Give a call's pinned sets back, inside ``snappy.alloc``, once
    every batch that used them has been waited for: their frees are
    then counted as the call's allocation work, not left to its return."""
    with span("snappy.alloc"):
        for hs in sets:
            hs.t = hs.np = None


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
    COUNTERS["h2d_bytes"] += host.numel() * host.element_size()
    return dev


def _upload_bytes(data: bytes, device: torch.device) -> torch.Tensor:
    COUNTERS["h2d_bytes"] += len(data)
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)


def _fetch(host: torch.Tensor, dev: torch.Tensor) -> None:
    """Asynchronous copy of a device tensor into a (pinned) host tensor."""
    host.copy_(dev, non_blocking=True)
    COUNTERS["d2h_bytes"] += host.numel() * host.element_size()


def _crc_into(hs: _HostSet, rows: torch.Tensor, device) -> None:
    """Launch the CRC-32C of ``rows`` over the lengths in ``hs``'s pinned
    ``lens`` buffer; the values land in its pinned ``crc`` buffer."""
    n = rows.shape[0]
    crc = crc32c_chunks(rows, _upload(hs.t["lens"][:n], device))
    _fetch(hs.t["crc"][:n], crc)


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


_HOST_CRC_ROWS = 512  # 64 KiB rows a launch of _crc32c_host


def _crc32c_host(pieces, device=None) -> list[int]:
    """CRC-32C of each host buffer of ``pieces`` (bytes, memoryviews or
    uint8 arrays of at most 64 KiB): the native CRC, else
    ``crc32c_chunks`` on ``device`` (the kernel on a card, its plain
    version on the CPU), the pieces packed into 64 KiB rows."""
    pieces = list(pieces)
    if native.available():
        return [native.crc32c(bytes(p)) for p in pieces]
    device = resolve(device)
    out = []
    for base in range(0, len(pieces), _HOST_CRC_ROWS):
        grp = [np.frombuffer(p, np.uint8)
               for p in pieces[base : base + _HOST_CRC_ROWS]]
        rows = np.zeros((len(grp), _CRC_CHUNK), np.uint8)
        lens = np.zeros(len(grp), np.int32)
        for i, a in enumerate(grp):
            rows[i, : a.size] = a
            lens[i] = a.size
        crc = crc32c_chunks(torch.from_numpy(rows).to(device),
                            torch.from_numpy(lens).to(device))
        out += crc.cpu().tolist()
    return out


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


def _host_decompress_raw(payload: bytes) -> bytes:
    """Host decode of one raw stream: the native decoder, else the
    reference's."""
    if native.available():
        return native.decompress(payload)
    return _reference.decompress(payload)


def _host_decode_chunk(src_arr, ch, out, off: int) -> None:
    """Per-chunk host decode (a format fallback) into out[off:]."""
    _, p_off, p_len, _crc, dst_len, _hdr = ch
    blob = _host_decompress_raw(bytes(src_arr[p_off : p_off + p_len]))
    if len(blob) != dst_len:
        raise CorruptError("chunk preamble disagrees with decoded size")
    out[off : off + dst_len] = np.frombuffer(blob, dtype=np.uint8)


def _batch_arrays(chunks, grp):
    """int64 (payload offsets, payload lengths, header lengths, dst
    lengths) of a group of scanned chunks, as the native stagers take."""
    return tuple(np.array([chunks[i][f] for i in grp], np.int64)
                 for f in (1, 2, 5, 4))


@_entry
def decompress_framed(data: bytes, verify_checksums: bool = True,
                      device=None) -> bytes:
    with span("snappy.scan"):
        chunks, total = _scan_frames(data)
    COUNTERS["bytes"] += total
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
    use_dev_crc = verify_checksums and DEVICE_CRC
    engine = _decode_engine(use_dev_crc)
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
        if engine == "id":
            _decode_id_batches(src_arr, chunks, comp_idx, dst_offs, out,
                               use_dev_crc, device)
        elif engine in ("seq", "jnp"):
            _decode_seq_batches(src_arr, chunks, comp_idx, dst_offs, out,
                                use_dev_crc, device, engine)
        elif engine == "hybrid":
            _decode_hybrid_batches(src_arr, chunks, comp_idx, dst_offs, out,
                                   use_dev_crc, device)
        else:
            host_checked |= _decode_classify_batches(
                src_arr, chunks, comp_idx, dst_offs, out, use_dev_crc,
                device)
        if not use_dev_crc:
            host_checked.update(comp_idx)

    if verify_checksums:
        # the chunks not verified on the device, in stream order
        idx = [i for i in subset if i in host_checked]
        crcs = _crc32c_host((out[dst_offs[i] : dst_offs[i] + chunks[i][4]]
                             for i in idx), device)
        for i, crc in zip(idx, crcs):
            got = mask_crc(crc)
            if got != chunks[i][3]:
                raise ChecksumError(chunks[i][3], got)


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
    with span("snappy.stage"):
        stage_id_rows(src_arr, grp_chunks, hs.np["panel"][:ng],
                      hs.np["lens"][:ng])
    with span("snappy.enqueue"):
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
        with span("snappy.finish"):
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
        _fetch(hs.t["res"][:ng], res)
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
    """Host sets of the seq and jnp decodes: payload rows, the per-row
    (starts, clens, dlens, CRC lengths) words, and what comes back."""
    shapes = dict(comp=((rows * _DECODE_CMAX,), torch.uint8),
                  meta=((4 * rows,), torch.int32),
                  err=((rows,), torch.int32), crc=((rows,), torch.int64))
    if host_out:
        shapes["res"] = ((rows, MAX_CHUNK_UNCOMPRESSED), torch.uint8)
    return _host_sets(device, **shapes)


# the payload-row decoders: (comp, starts, clens, dlens, out_max=) ->
# (rows, err), and their error messages
_ROW_DECODERS = {"seq": (decode_blocks_seq, ERR_MESSAGES),
                 "jnp": (_dpar.decode_blocks, _dpar.ERR_MESSAGES)}


def _dispatch_seq(src_arr, grp, hs: _HostSet, device, with_crc: bool,
                  host_out: bool, engine: str = "seq") -> torch.Tensor:
    """Stage one batch of scanned chunks into ``hs``'s pinned payload
    rows, upload them, launch the engine's decode (the sequential kernel
    for "seq", the parallel decoder for "jnp"; and the CRC of its rows
    when asked), and queue the fetch of the error codes and CRCs (and
    with ``host_out`` the decoded rows) into ``hs``.  A compressed
    chunk's row is its payload (the element
    stream starts after the varint header); an uncompressed chunk's row
    is its data, decoded as an empty stream and copied into place on
    the device.  Returns the device rows [len(grp), 64 KiB]."""
    ng = len(grp)
    hs.wait()
    with span("snappy.stage"):
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
    with span("snappy.enqueue"):
        comp = _upload(hs.t["comp"][: ng * cmax], device).view(ng, cmax)
        meta_d = _upload(hs.t["meta"][: 4 * ng], device).view(4, ng)
        dec, err = _ROW_DECODERS[engine][0](comp, meta_d[0], meta_d[1],
                                            meta_d[2],
                                            out_max=MAX_CHUNK_UNCOMPRESSED)
        for row, ch in enumerate(grp):
            if ch[0] != CHUNK_COMPRESSED:
                dec[row, : ch[2]].copy_(comp[row, : ch[2]])
        if with_crc:
            _fetch(hs.t["crc"][:ng], crc32c_chunks(dec, meta_d[3]))
        _fetch(hs.t["err"][:ng], err)
        if host_out:
            _fetch(hs.t["res"][:ng], dec)
        hs.record()
    return dec


def _check_seq(grp, hs: _HostSet, with_crc: bool, engine: str = "seq") -> None:
    """Raise for the first row of a finished batch that failed: its
    decode error (CorruptError), else its CRC (ChecksumError)."""
    err, crc = hs.np["err"], hs.np["crc"]
    messages = _ROW_DECODERS[engine][1]
    for row, ch in enumerate(grp):
        if err[row]:
            raise CorruptError(messages.get(int(err[row]), "decode error"))
        if with_crc and int(crc[row]) != unmask_crc(ch[3]):
            raise ChecksumError(ch[3], None)


def _decode_seq_batches(src_arr, chunks, comp_idx, dst_offs, out,
                        use_dev_crc: bool, device, engine: str = "seq") -> None:
    """Device LZ engine ("seq") or jnp engine, host output: the payloads
    go up, the sequential kernel (at the card's width) or the parallel
    decoder (BATCH rows) decodes them and the CRC kernel checksums them,
    the decoded rows come back.  Batch k+1 is staged while batch k
    runs."""
    step = BATCH if engine == "jnp" else _seq_width(
        _dseq.resident_rows, device, MAX_CHUNK_UNCOMPRESSED)
    sets = _seq_dec_sets(device, min(step, len(comp_idx)), host_out=True)

    def dispatch(k, base):
        grp = [chunks[i] for i in comp_idx[base : base + step]]
        hs = sets[k % _NSETS]
        _dispatch_seq(src_arr, grp, hs, device, use_dev_crc, host_out=True,
                      engine=engine)
        return comp_idx[base : base + step], grp, hs

    for idx, grp, hs in _one_behind(range(0, len(comp_idx), step), dispatch):
        hs.wait()
        with span("snappy.finish"):
            _check_seq(grp, hs, use_dev_crc, engine)
            res = hs.np["res"]
            for row, i in enumerate(idx):
                d = chunks[i][4]
                out[dst_offs[i] : dst_offs[i] + d] = res[row, :d]


def _hybrid_sets(device, rows: int, host_out: bool):
    """Host sets of the hybrid decode: payload rows, the records (at most
    ``_T_CAP`` a row), the per-row (record counts, decoded lengths, CRC
    lengths) words, and what comes back."""
    shapes = dict(comp=((rows * _DECODE_CMAX,), torch.uint8),
                  recs=((rows * _T_CAP * 4,), torch.int32),
                  meta=((3 * rows,), torch.int32),
                  crc=((rows,), torch.int64))
    if host_out:
        shapes["res"] = ((rows, MAX_CHUNK_UNCOMPRESSED), torch.uint8)
    return _host_sets(device, **shapes)


def _parse_rows(rows: np.ndarray, grp) -> list:
    """The native parser's records of each compressed chunk of ``grp``
    (its payload staged in ``rows``), an empty array for a stored one.
    Raises CorruptError at the first payload that does not parse."""
    nat = _native()
    tmp = np.empty((_T_CAP, 4), dtype=np.int32)
    parsed = []
    for row, (ctype, _p_off, p_len, _crc, dst_len, hdr) in enumerate(grp):
        nt = 0
        if ctype == CHUNK_COMPRESSED:
            nt = nat.parse_tags(memoryview(rows[row, :p_len]), hdr, dst_len,
                                tmp)
        parsed.append(tmp[:nt].copy())
    return parsed


def _dispatch_hybrid(src_arr, grp, hs: _HostSet, device, with_crc: bool,
                     host_out: bool) -> torch.Tensor:
    """Stage one batch of scanned chunks for the hybrid engine: payload
    rows into ``hs``'s pinned rows (at the batch's bucket width), the
    native parser's records of each (padded to the batch's record cap,
    ``record_cap``), then upload them, run the record executor and, when
    asked, the CRC kernel, and queue the CRCs (and with ``host_out`` the
    rows) back into ``hs``.  A stored chunk's row is its data, executed
    as no records and copied into place on the device.  Returns the
    device rows [len(grp), 64 KiB]."""
    ng = len(grp)
    hs.wait()
    cmax = _bucket_cmax(max(ch[2] for ch in grp))
    rows = hs.np["comp"][: ng * cmax].reshape(ng, cmax)
    for row, ch in enumerate(grp):
        rows[row, : ch[2]] = src_arr[ch[1] : ch[1] + ch[2]]
    parsed = _parse_rows(rows, grp)
    t_cap = record_cap(max(len(p) for p in parsed), _T_CAP)
    recs = hs.np["recs"][: ng * t_cap * 4].reshape(ng, t_cap, 4)
    meta = hs.np["meta"][: 3 * ng].reshape(3, ng)
    for row, (p, ch) in enumerate(zip(parsed, grp)):
        recs[row, : len(p)] = p
        compressed = ch[0] == CHUNK_COMPRESSED
        meta[:, row] = (len(p), ch[4] if compressed else 0, ch[4])
    comp = _upload(hs.t["comp"][: ng * cmax], device).view(ng, cmax)
    recs_d = _upload(hs.t["recs"][: ng * t_cap * 4], device).view(
        ng, t_cap, 4)
    meta_d = _upload(hs.t["meta"][: 3 * ng], device).view(3, ng)
    dec = decode_blocks_pretagged(comp, recs_d, meta_d[0], meta_d[1],
                                  out_max=MAX_CHUNK_UNCOMPRESSED)
    for row, ch in enumerate(grp):
        if ch[0] != CHUNK_COMPRESSED:
            dec[row, : ch[2]].copy_(comp[row, : ch[2]])
    if with_crc:
        _fetch(hs.t["crc"][:ng], crc32c_chunks(dec, meta_d[2]))
    if host_out:
        _fetch(hs.t["res"][:ng], dec)
    hs.record()
    return dec


def _decode_hybrid_batches(src_arr, chunks, comp_idx, dst_offs, out,
                           use_dev_crc: bool, device) -> None:
    """Hybrid engine, host output: the native parser's records and the
    payloads go up, the record executor builds the rows and the CRC
    kernel checks them, the rows come back.  Batch k+1 is parsed and
    staged while batch k runs."""
    sets = _hybrid_sets(device, min(BATCH, len(comp_idx)), host_out=True)

    def dispatch(k, base):
        grp = [chunks[i] for i in comp_idx[base : base + BATCH]]
        hs = sets[k % _NSETS]
        _dispatch_hybrid(src_arr, grp, hs, device, use_dev_crc, host_out=True)
        return comp_idx[base : base + BATCH], grp, hs

    for idx, grp, hs in _one_behind(range(0, len(comp_idx), BATCH), dispatch):
        hs.wait()
        if use_dev_crc:
            _check_crcs(grp, hs.np["crc"])
        res = hs.np["res"]
        for row, i in enumerate(idx):
            d = chunks[i][4]
            out[dst_offs[i] : dst_offs[i] + d] = res[row, :d]


def stage_id_rows(src_arr: np.ndarray, grp, b_u8: np.ndarray,
                  dlens: np.ndarray) -> None:
    """Id-stage one group of scanned framed chunks into staging rows:
    compressed chunks decode through the threaded native id walk in
    contiguous runs, uncompressed chunks are their payload.  Fills
    dlens per row; raises CorruptError on an invalid payload.  Without
    the native library each compressed row decodes on the host
    (``_host_decode_chunk``), as in the JAX package."""
    comp_rows = []
    for row, ch in enumerate(grp):
        dlens[row] = ch[4]
        if ch[0] == CHUNK_COMPRESSED:
            comp_rows.append(row)
        else:  # uncompressed: the row is the payload
            _t, p_off, p_len, _c, _d, _h = ch
            b_u8[row, :p_len] = src_arr[p_off : p_off + p_len]
            b_u8[row, p_len:] = 0
    if not native.available():
        for row in comp_rows:
            _host_decode_chunk(src_arr, grp[row], b_u8[row], 0)
            b_u8[row, grp[row][4]:] = 0
        return
    r = 0
    while r < len(comp_rows):
        r2 = r
        while (r2 + 1 < len(comp_rows)
               and comp_rows[r2 + 1] == comp_rows[r2] + 1):
            r2 += 1
        rows = comp_rows[r : r2 + 1]
        offs64, lens64, hdrs64, dstl64 = _batch_arrays(grp, rows)
        rc64 = np.zeros(len(rows), np.int64)
        bad = _native_call(
            native.stage_flat_dec_id_batch,
            src_arr, offs64, lens64, hdrs64, dstl64, b_u8.shape[1] // 128,
            b_u8[rows[0] : rows[0] + len(rows)], rc64,
            n_threads=_threads())
        if bad:
            raise CorruptError("invalid chunk payload (flat stage)")
        r = r2 + 1


@_entry
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
    codes and CRC values come back.  Hybrid engine: the payloads and the
    native parser's records go up, the record executor builds the rows
    and their CRCs are checked there; only the CRC values come back.
    Streams whose chunks are not all full 64 KiB rows but the last, and
    the classify and jnp engines, decode through ``decompress_framed``
    and upload the result."""
    # the phases tile the call: the stream read and its path picked, the
    # buffers made, the batches, the buffers given back.  A batch's spans
    # nest in one enqueue span and one finish span, so that the profiler's
    # own time between two of them falls in a phase, not in the call
    with span("snappy.scan"):
        chunks, total = _scan_frames(data)
        uniform = total > 0 and all(
            ch[4] == _CRC_CHUNK for ch in chunks[:-1]) and all(
            ch[2] <= _DECODE_CMAX for ch in chunks
            if ch[0] == CHUNK_COMPRESSED)
        device = resolve(device)
        engine = _decode_engine(verify_checksums and DEVICE_CRC)
    if not (engine in ("id", "seq", "hybrid") and DEVICE_CRC and uniform):
        return _upload_bytes(
            decompress_framed(data, verify_checksums, device=device), device)
    COUNTERS["bytes"] += total
    with span("snappy.alloc"):
        src_arr = np.frombuffer(data, np.uint8)
        out = torch.empty(total, dtype=torch.uint8, device=device)
        seq = engine == "seq"
        if seq:
            step = _seq_width(_dseq.resident_rows, device,
                              MAX_CHUNK_UNCOMPRESSED)
            sets = _seq_dec_sets(device, min(step, len(chunks)),
                                 host_out=False)
        elif engine == "hybrid":
            step = BATCH
            sets = _hybrid_sets(device, min(step, len(chunks)),
                                host_out=False)
        else:
            step = BATCH
            sets = _id_sets(device)

    def dispatch(k, base):
        with span("snappy.enqueue"):
            grp = chunks[base : base + step]
            hs = sets[k % _NSETS]
            if seq:
                rows = _dispatch_seq(src_arr, grp, hs, device,
                                     verify_checksums, host_out=False)
            elif engine == "hybrid":
                rows = _dispatch_hybrid(src_arr, grp, hs, device,
                                        verify_checksums, host_out=False)
            else:
                rows = _dispatch_id(src_arr, grp, hs, device,
                                    verify_checksums)
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

    for grp, hs in _one_behind(range(0, len(chunks), step), dispatch):
        with span("snappy.finish"):
            hs.wait()
            if seq:
                _check_seq(grp, hs, verify_checksums)
            elif verify_checksums:
                _check_crcs(grp, hs.np["crc"])
    _release(sets)
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


@_entry
def decompress(data: bytes, device=None) -> bytes:
    """Raw Snappy stream decode to host bytes.  Id mode: the native walk
    is the decode (a raw stream has no CRC for the device to check).
    Classify mode: the segmented flat engine on the device, the native
    decoder for unplannable streams.  Every other engine: the native
    decoder, as in the JAX package.  Without the native library: one row
    of the parallel decoder on ``device``, as the JAX package's
    ``decode_block_jnp``."""
    dst_len, hdr = read_uvarint(data, 0)
    COUNTERS["bytes"] += dst_len
    if not native.available():
        return _dpar.decode_block_par(data, dst_len, start=hdr,
                                      device=resolve(device))
    nat = native
    if PALLAS and FLAT and FLAT_MODE != "id":
        got = _decompress_raw_flat(data, dst_len, hdr, resolve(device))
        if got is not None:
            return got.cpu().numpy().tobytes()
        HOST_FALLBACKS["plan_overflow"] += 1
    return nat.decompress(data)


@_entry
def decompress_to_device(data: bytes, device=None) -> torch.Tensor:
    """Raw Snappy stream decode to a uint8 tensor on ``device``.

    Id mode: the native id walk decodes 64 KiB segments straight into
    pinned staging rows (resume state carries straddling tags, a rolling
    64 KiB history carries copy sources) and each batch is copied into
    one preallocated device tensor.  Classify mode: the segmented flat
    engine.  Streams with a copy offset past 64 KiB (which no real
    encoder emits) or an unplannable segment decode on the host, and so
    does every stream under the other engines, as in the JAX package.
    Without the native library: one row of the parallel decoder on
    ``device``, the result left there."""
    dst_len, hdr = read_uvarint(data, 0)
    COUNTERS["bytes"] += dst_len
    device = resolve(device)
    if not native.available():
        return _dpar.decode_block_par_to_device(data, dst_len, start=hdr,
                                                device=device)
    nat = native
    if not (PALLAS and FLAT):
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
        COUNTERS["h2d_bytes"] += done - lo
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
        _fetch(hs.t["comp"][: cnt * kmax].view(cnt, kmax),
               comp[:, :kmax].contiguous())
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


def _native_element(chunk) -> bytes:
    """The native encoder's element of one chunk (no varint header)."""
    comp = native.compress(bytes(chunk))
    return comp[read_uvarint(comp, 0)[1] :]


def _device_rows(src: torch.Tensor, lo: int, nb: int, cnt: int, cs: int,
                 width: int) -> torch.Tensor:
    """The cnt cs-byte chunks of the flat device tensor ``src[lo:lo+nb]``
    as rows [cnt, width] (width >= cs): a view where they fill whole
    rows, else a copy, zero past each chunk's end."""
    if nb == cnt * cs and width == cs:
        return src[lo : lo + nb].view(cnt, cs)
    rows = torch.zeros(cnt, width, dtype=torch.uint8, device=src.device)
    full = nb // cs
    if full:
        rows[:full, :cs] = src[lo : lo + full * cs].view(full, cs)
    if nb > full * cs:  # the stream's short last chunk
        rows[full, : nb - full * cs] = src[lo + full * cs : lo + nb]
    return rows


def _fetch_rows(t: torch.Tensor, idx, lens) -> dict:
    """Rows ``idx`` of the 2-D tensor ``t`` (on a device), row i cut to
    its first ``lens[i]`` bytes, fetched to the host in one copy:
    {i: uint8 array}."""
    if not idx:
        return {}
    width = int(max(lens[i] for i in idx))
    got = t[torch.tensor(idx, device=t.device), :width].cpu().numpy()
    COUNTERS["d2h_bytes"] += got.nbytes
    return {i: got[j, : lens[i]] for j, i in enumerate(idx)}


def _reference_elements(b: dict, ok: np.ndarray, clens: np.ndarray):
    """The reference elements a finished jnp batch ``b`` needs: (refs,
    ref_lens), refs[i] the element of each row that takes it (ok=False,
    or with RATIO_GUARD shorter than the row's), ref_lens[i] its length
    for every row RATIO_GUARD compares.  The native encoder's, on the
    host, when the library is there; else the sequential encoder's:
    its launch's lengths (queued beside the batch under RATIO_GUARD,
    else launched here for a batch with an ok=False row), then one fetch
    of the rows that take their element."""
    cnt = len(ok)
    if native.available():
        refs = {}
        for i in range(cnt):
            if RATIO_GUARD or not ok[i]:
                refs[i] = _native_element(b["chunk"](i))
        return refs, {i: len(r) for i, r in refs.items()}
    ref = b["ref"]
    if ref is None:
        if ok.all():
            return {}, {}
        ref = encode_blocks_seq(b["rows"], b["lens_d"])
        ref_lens = ref[1].cpu().numpy()
    else:
        ref_lens = b["hs"].np["ref_clens"][: cnt].copy()
    take = [i for i in range(cnt) if not ok[i]
            or (RATIO_GUARD and ref_lens[i] < clens[i])]
    refs = {i: r.tobytes()
            for i, r in _fetch_rows(ref[0], take, ref_lens).items()}
    return refs, ref_lens


def _encode_jnp(src, chunk_size: int, device, with_crc: bool = False):
    """jnp engine: yield (chunk_index, chunk_len, element, crc, stored)
    for the chunk_size-byte chunks of ``src``, host bytes or a flat uint8
    tensor on ``device``.

    Each batch of BATCH chunk rows (``bmax`` the chunk size rounded up to
    a power of two, at least 256) goes up through pinned rows, or is cut
    from the tensor in place, and the parallel encoder
    (``kernels.encode_par``) encodes it; with ``with_crc`` the CRC kernel
    checksums the same rows (``crc`` is else None).  The lengths and
    flags come back, then the elements cut to the batch's longest.  A
    row with ok=False, and with RATIO_GUARD a row longer than the
    reference element, takes the reference element
    (``_reference_elements``; ``ENCODE_REPLACED`` counts them).
    ``stored`` is, for a device tensor with ``with_crc`` (a framed
    stream), the bytes of a chunk the framed format stores uncompressed,
    fetched once a batch; else None.  Batch k+1 is staged while batch k
    runs."""
    on_dev = isinstance(src, torch.Tensor)
    n = int(src.numel()) if on_dev else len(src)
    n_chunks = -(-n // chunk_size)
    if n_chunks == 0:
        return
    bmax = 256
    while bmax < chunk_size:
        bmax *= 2
    rows_n = min(BATCH, n_chunks)
    # without the library the guard's reference comes from the device
    guard_on_dev = RATIO_GUARD and not native.available()
    shapes = dict(lens=((rows_n,), torch.int32),
                  clens=((rows_n,), torch.int32), ok=((rows_n,), torch.bool),
                  crc=((rows_n,), torch.int64),
                  ref_clens=((rows_n,), torch.int32))
    if not on_dev:
        shapes["blocks"] = ((rows_n, bmax), torch.uint8)
        src_np = np.frombuffer(src, np.uint8)
    sets = _host_sets(device, **shapes)

    def dispatch(k, base):
        cnt = min(BATCH, n_chunks - base)
        lo = base * chunk_size
        nb = min(n, lo + cnt * chunk_size) - lo
        hs = sets[k % _NSETS]
        hs.wait()
        lens = hs.np["lens"][:cnt]
        lens[:] = _chunk_lens(nb, cnt, chunk_size)
        if on_dev:
            rows = _device_rows(src, lo, nb, cnt, chunk_size, bmax)
        else:
            blocks = hs.np["blocks"][:cnt]
            for i in range(cnt):
                off = lo + i * chunk_size
                ln = int(lens[i])
                blocks[i, :ln] = src_np[off : off + ln]
                blocks[i, ln:] = 0
            rows = _upload(hs.t["blocks"][:cnt], device)
        lens_d = _upload(hs.t["lens"][:cnt], device)
        comp, clens, ok = _epar.encode_blocks(rows, lens_d, bmax=bmax)
        _fetch(hs.t["clens"][:cnt], clens)
        _fetch(hs.t["ok"][:cnt], ok)
        if with_crc:
            _fetch(hs.t["crc"][:cnt], crc32c_chunks(rows, lens_d))
        ref = None
        if guard_on_dev:
            ref = encode_blocks_seq(rows, lens_d)
            _fetch(hs.t["ref_clens"][:cnt], ref[1])
        hs.record()

        def chunk(i):  # the host bytes of the batch's chunk i
            if on_dev:
                return rows[i, : int(hs.np["lens"][i])].cpu().numpy()
            off = lo + i * chunk_size
            return src[off : off + int(hs.np["lens"][i])]

        return dict(base=base, cnt=cnt, hs=hs, rows=rows, lens_d=lens_d,
                    comp=comp, ref=ref, chunk=chunk)

    for b in _one_behind(range(0, n_chunks, BATCH), dispatch):
        hs, cnt, comp = b["hs"], b["cnt"], b["comp"]
        hs.wait()
        clens = hs.np["clens"][:cnt].copy()
        ok = hs.np["ok"][:cnt].copy()
        lens = hs.np["lens"][:cnt].copy()
        kmax = min((int(clens.max()) + 511) & ~511, comp.shape[1])
        comp_h = comp[:, :kmax].cpu().numpy()
        COUNTERS["d2h_bytes"] += comp_h.nbytes
        refs, ref_lens = _reference_elements(b, ok, clens)
        blobs = []
        for i in range(cnt):
            if ok[i]:
                blob = comp_h[i, : int(clens[i])].tobytes()
            else:  # a hash collision: the reference element
                ENCODE_REPLACED["not_ok"] += 1
                blob = refs[i]
            if RATIO_GUARD and ref_lens[i] < len(blob):
                ENCODE_REPLACED["ratio_guard"] += 1
                blob = refs[i]
            blobs.append(blob)
        stored = {}
        if on_dev and with_crc:
            stored = _fetch_rows(
                b["rows"], [i for i in range(cnt)
                            if _stored(int(lens[i]), len(blobs[i]))], lens)
        crc = hs.np["crc"][:cnt].copy() if with_crc else None
        for i in range(cnt):
            yield (b["base"] + i, int(lens[i]), blobs[i],
                   int(crc[i]) if with_crc else None, stored.get(i))


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
    with span("snappy.alloc"):
        step = _seq_width(_eseq.resident_rows, device, cs)
        rows_n = min(step, n_chunks)
        cap = comp_width(cs)
        shapes = dict(lens=((rows_n,), torch.int32),
                      clens=((rows_n,), torch.int32),
                      crc=((rows_n,), torch.int64),
                      comp=((rows_n * cap,), torch.uint8))
        # device input: rows the host fetches; host input: pinned staging rows
        shapes["stored" if on_dev else "blocks"] = ((rows_n * cs,),
                                                    torch.uint8)
        sets = _host_sets(device, **shapes)
        src_np = None if on_dev else np.frombuffer(src, np.uint8)
    pending = []

    def rows_of(lo: int, nb: int, cnt: int, hs: _HostSet) -> torch.Tensor:
        if not on_dev:
            hs.np["blocks"][:nb] = src_np[lo : lo + nb]
            return _upload(hs.t["blocks"][: cnt * cs], device).view(cnt, cs)
        return _device_rows(src, lo, nb, cnt, cs, cs)

    def fetch(b: dict) -> None:
        if b["kmax"] is not None:
            return
        with span("snappy.enqueue"):
            hs, cnt, lens = b["hs"], b["cnt"], b["lens"]
            hs.wait()  # its lengths (and CRCs) are on the host
            clens = hs.np["clens"][:cnt]
            kmax = min((int(clens.max()) + 511) & ~511, cap)
            _fetch(hs.t["comp"][: cnt * kmax].view(cnt, kmax),
                   b["comp"][:, :kmax].contiguous())
            if on_dev:
                b["stored"] = {i for i in range(cnt)
                               if not with_crc or _stored(int(lens[i]),
                                                          int(clens[i]))}
                for i in b["stored"]:
                    _fetch(hs.t["stored"][i * cs : i * cs + lens[i]],
                           b["rows"][i, : lens[i]])
            hs.record()
        b["kmax"] = kmax

    # a batch's spans nest in one enqueue span and one finish span, so
    # that the profiler's own time between two of them falls in a phase
    def dispatch(k, base):
        with span("snappy.enqueue"):
            cnt = min(step, n_chunks - base)
            lo = base * cs
            nb = min(n, lo + cnt * cs) - lo
            hs = sets[k % _NSETS]
            hs.wait()
            with span("snappy.stage"):
                lens = _chunk_lens(nb, cnt, cs)
                hs.np["lens"][:cnt] = lens
                rows = rows_of(lo, nb, cnt, hs)
            if pending:
                fetch(pending.pop())
            lens_d = _upload(hs.t["lens"][:cnt], device)
            comp, clens, _err = encode_blocks_seq(rows, lens_d)  # valid lens
            _fetch(hs.t["clens"][:cnt], clens)
            if with_crc:
                _fetch(hs.t["crc"][:cnt], crc32c_chunks(rows, lens_d))
            hs.record()
            b = dict(base=base, cnt=cnt, hs=hs, rows=rows, comp=comp,
                     lens=lens, kmax=None, stored=set())
            pending.append(b)
        return b

    for b in _one_behind(range(0, n_chunks, step), dispatch):
        # held across the yields: the caller's assembly of each record
        # runs inside it
        with span("snappy.finish"):
            fetch(b)  # the last batch: no later dispatch queued its fetch
            hs = b["hs"]
            hs.wait()
            comp = hs.np["comp"][: b["cnt"] * b["kmax"]].reshape(b["cnt"],
                                                                b["kmax"])
            for i in range(b["cnt"]):
                ln = int(b["lens"][i])
                yield (b["base"] + i, ln,
                       comp[i, : hs.np["clens"][i]].tobytes(),
                       int(hs.np["crc"][i]) if with_crc else None,
                       hs.np["stored"][i * cs : i * cs + ln]
                       if i in b["stored"] else None)
    _release(sets)


@_entry
def compress(data: bytes, device=None) -> bytes:
    """Raw Snappy stream (per-64 KiB fragments)."""
    if len(data) > MAX_UNCOMPRESSED_LEN:
        raise TooLargeError(len(data))
    COUNTERS["bytes"] += len(data)
    device = resolve(device)
    out = bytearray(put_uvarint(len(data)))
    engine = _encode_engine()
    if engine == "flat":
        for _, _, blob in _encode_batches(data, MAX_BLOCK_SIZE, device):
            out += blob
    elif engine == "jnp":
        for _, _, blob, _, _ in _encode_jnp(data, MAX_BLOCK_SIZE, device):
            out += blob
    else:
        for _, _, elem, _, _ in _encode_seq(data, MAX_BLOCK_SIZE, device,
                                            with_crc=False):
            out += elem
    return bytes(out)


@_entry
def compress_framed(data: bytes, chunk_size: int = MAX_CHUNK_UNCOMPRESSED,
                    device=None) -> bytes:
    """Framed (.sz) stream.  Id mode with 64 KiB chunks: device CRCs
    plus one native matcher-and-assembly call per batch.  Device LZ
    engine: elements and CRCs from the device (``_encode_seq``).  jnp
    engine: elements from ``_encode_jnp`` with host CRCs, as in the JAX
    package.  Otherwise chunk elements from ``_encode_batches`` with
    host CRCs.  Without the native library every CRC comes from the CRC
    kernel, beside the jnp or seq engine's encode of the same rows."""
    if not 0 < chunk_size <= MAX_CHUNK_UNCOMPRESSED:
        raise ValueError(f"chunk_size must be in (0, 65536], got {chunk_size}")
    COUNTERS["bytes"] += len(data)
    device = resolve(device)
    engine = _encode_engine()
    if (engine == "flat" and FLAT_MODE == "id"
            and chunk_size == MAX_CHUNK_UNCOMPRESSED and len(data)):
        return _compress_framed_id(data, device)
    if engine == "flat":
        chunks = ((idx, ln, blob, None) for idx, ln, blob
                  in _encode_batches(data, chunk_size, device))
    else:
        encode = _encode_jnp if engine == "jnp" else _encode_seq
        with_crc = not native.available() or (engine == "seq" and DEVICE_CRC)
        chunks = ((idx, ln, elem, crc) for idx, ln, elem, crc, _
                  in encode(data, chunk_size, device, with_crc))
    data_v = memoryview(data)
    out = bytearray(STREAM_ID_CHUNK)
    for idx, chunk_len, blob, crc in chunks:
        off = idx * chunk_size
        chunk = data_v[off : off + chunk_len]
        if crc is None:
            crc = native.crc32c(bytes(chunk))
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
    _native()
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
        out += _native_call(native.compress_framed_crc, data_np[lo : lo + nb],
                            nb, crcs, chunk_size=cs, threads=_threads(),
                            write_id=False)
    return bytes(out)


def _check_uint8(arr) -> None:
    if not isinstance(arr, torch.Tensor) or arr.dtype != torch.uint8:
        raise ValueError(
            f"expected a uint8 tensor, got {getattr(arr, 'dtype', type(arr))}")


@_entry
def compress_framed_from_device(arr: torch.Tensor, device=None) -> bytes:
    """Compress a uint8 device tensor into a framed (.sz) stream.

    Each 64 KiB chunk's CRC-32C is computed on the device before its
    bytes leave; the device-to-host copy of batch k+1 overlaps the
    native matcher and assembler of batch k.  Byte-identical to
    ``compress_framed(bytes(arr))`` in id mode: same matcher, same CRCs.
    Device LZ engine: the tensor's chunks are encoded and CRC'd where
    they lie (``_encode_seq``); only elements and CRCs come back, plus
    the bytes of chunks stored uncompressed.  The jnp engine takes the
    id path, as the JAX package does.  Without the native library the
    jnp engine (or the seq engine, where it is picked) encodes the
    tensor's chunks in place and the CRC kernel checksums them: the
    bytes of ``compress_framed(bytes(arr))``."""
    _check_uint8(arr)
    with span("snappy.alloc"):
        device = arr.device if device is None else resolve(device)
        arr = arr.to(device).reshape(-1)
    n = int(arr.numel())
    COUNTERS["bytes"] += n
    if n == 0:
        return bytes(STREAM_ID_CHUNK)
    cs = MAX_CHUNK_UNCOMPRESSED
    engine = _encode_engine()
    if engine == "seq" or not native.available():
        encode = _encode_seq if engine == "seq" else _encode_jnp
        out = bytearray(STREAM_ID_CHUNK)
        for _, ln, elem, crc, stored in encode(
                arr, cs, device, DEVICE_CRC or not native.available()):
            if crc is None:
                crc = native.crc32c(stored.tobytes())
            out += _framed_record(ln, elem, crc, stored)
        with span("snappy.finish"):
            return bytes(out)
    n_chunks = -(-n // cs)
    sets = _crc_sets(device, min(BATCH, n_chunks), "rows")

    def dispatch(k, base):
        cnt = min(BATCH, n_chunks - base)
        lo = base * cs
        nb = min(n, lo + cnt * cs) - lo
        hs = sets[k % _NSETS]
        # the batch's spans nest in one enqueue span and one finish span
        with span("snappy.enqueue"):
            flat = arr[lo : lo + nb]
            hs.wait()
            with span("snappy.stage"):
                if DEVICE_CRC:
                    if nb == cnt * cs:
                        rows = flat.view(cnt, cs)
                    else:  # the stream's short last chunk: pad its row
                        rows = torch.zeros(cnt * cs, dtype=torch.uint8,
                                           device=device)
                        rows[:nb] = flat
                        rows = rows.view(cnt, cs)
                    hs.np["lens"][:cnt] = _chunk_lens(nb, cnt)
            if DEVICE_CRC:
                _crc_into(hs, rows, device)
            _fetch(hs.t["rows"][:nb], flat)
            hs.record()
        return nb, cnt, hs

    out = bytearray(STREAM_ID_CHUNK)
    for nb, cnt, hs in _one_behind(range(0, n_chunks, BATCH), dispatch):
        with span("snappy.finish"):
            hs.wait()
            crcs = hs.np["crc"][:cnt].astype(np.uint32) if DEVICE_CRC else None
            out += _native_call(native.compress_framed_crc,
                                hs.np["rows"][:nb], nb, crcs, chunk_size=cs,
                                threads=_threads(), write_id=False)
    _release(sets)
    with span("snappy.finish"):
        return bytes(out)


@_entry
def compress_from_device(arr: torch.Tensor, device=None) -> bytes:
    """Raw-format counterpart of ``compress_framed_from_device``.  The raw
    format has no checksums, so the device has nothing to compute: fetch
    the tensor once, then the native encoder emits the stream.
    Byte-identical to ``compress(bytes(arr))`` in id mode.  Device LZ
    engine: the tensor's 64 KiB blocks are encoded where they lie and
    only the elements come back.  The jnp engine takes the native
    encoder, as the JAX package does; without the native library it
    encodes the tensor's blocks in place (the bytes of
    ``compress(bytes(arr))``)."""
    _check_uint8(arr)
    COUNTERS["bytes"] += int(arr.numel())
    engine = _encode_engine()
    if engine == "seq" or not native.available():
        device = arr.device if device is None else resolve(device)
        arr = arr.to(device).reshape(-1)
        encode = _encode_seq if engine == "seq" else _encode_jnp
        out = bytearray(put_uvarint(int(arr.numel())))
        for _, _, elem, _, _ in encode(arr, MAX_BLOCK_SIZE, device,
                                       with_crc=False):
            out += elem
        return bytes(out)
    if device is not None:
        arr = arr.to(resolve(device))
    host = arr.reshape(-1).cpu().numpy()
    COUNTERS["d2h_bytes"] += host.nbytes
    return native.compress(memoryview(host))
