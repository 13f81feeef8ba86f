"""ctypes bindings for the port's C++ native host codec.

The port's own copy of ``snappy_tpu/native``: ``src/snappy_native.cpp``
is the same source (a fix to one copy is made in both), built with g++
on first use into ``snappy_tpu_torch/_build/snappy_native.so``, never
into or from the JAX package's build directory.  The C symbol names are
the same; ``ctypes.CDLL`` loads each library with ``RTLD_LOCAL``, so both
can live in one process.  Only the entry points the port calls are
bound here.  If the toolchain or binary is unavailable, available() is
False and the api layer skips this backend.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from snappy_tpu_torch.errors import (
    ChecksumError,
    CorruptError,
    SnappyError,
    TooLargeError,
    UnsupportedError,
)

_SRC = os.path.join(os.path.dirname(__file__), "src", "snappy_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_SO = os.path.join(_BUILD_DIR, "snappy_native.so")
_HASH_FILE = os.path.join(_BUILD_DIR, "snappy_native.sha256")

_lock = threading.Lock()
_lib = None
_tried = False

SN_OK = 0
_ERRORS = {
    -1: CorruptError,
    -2: TooLargeError,
    -3: ChecksumError,
    -4: UnsupportedError,
    -5: CorruptError,
}


def _raise(code: int):
    exc = _ERRORS.get(code, SnappyError)
    if exc is CorruptError:
        raise CorruptError("native decoder rejected input")
    if exc is ChecksumError:
        raise ChecksumError()
    if exc is UnsupportedError:
        raise UnsupportedError()
    if exc is TooLargeError:
        raise TooLargeError()
    raise SnappyError(f"native error {code}")


def _source_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _built_hash() -> str | None:
    try:
        with open(_HASH_FILE) as f:
            return f.read().strip()
    except OSError:
        return None


def _so_is_fresh() -> bool:
    """A .so is loadable only when its recorded source hash matches the
    tree — the reference's verify-before-activate discipline
    (snappy/hashes.go) applied to our own built artifact.  Round-2
    postmortem: a stale committed .so shipped a red tree; this gate makes
    that structurally impossible."""
    return os.path.exists(_SO) and _built_hash() == _source_hash()


def _build() -> str | None:
    """Build the library and record its source hash.  Processes that
    build at once (test workers on a fresh checkout) each write their own
    temporary files and rename them into place, so none loads or renames
    another's half-written file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    src_hash = _source_hash()
    tmp_so = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", _SRC, "-o", tmp_so,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
    except Exception:
        return None
    os.replace(tmp_so, _SO)
    tmp = f"{_HASH_FILE}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(src_hash + "\n")
    os.replace(tmp, _HASH_FILE)
    return _SO


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # the C++ paths allocate large scratch vectors per call; glibc
        # must not hand them back to the kernel (page faults measured at
        # ~400us here - utils/hostmem docstring)
        from snappy_tpu_torch.utils.hostmem import tune_allocator

        tune_allocator()
        so = _SO if _so_is_fresh() else _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            if _build() is None:
                return None
            lib = ctypes.CDLL(_SO)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.sn_crc32c.restype = ctypes.c_uint32
        lib.sn_crc32c.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint32]
        lib.sn_max_compressed_length.restype = ctypes.c_uint64
        lib.sn_max_compressed_length.argtypes = [ctypes.c_uint64]
        lib.sn_compress.restype = ctypes.c_int64
        lib.sn_compress.argtypes = [u8p, ctypes.c_uint64, u8p]
        lib.sn_uncompressed_length.restype = ctypes.c_int
        lib.sn_uncompressed_length.argtypes = [
            u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.sn_decompress.restype = ctypes.c_int
        lib.sn_decompress.argtypes = [u8p, ctypes.c_uint64, u8p, ctypes.c_uint64]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.sn_parse_tags.restype = ctypes.c_int64
        lib.sn_parse_tags.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
            i32p, ctypes.c_uint64,
        ]
        lib.sn_plan_waves.restype = ctypes.c_int64
        lib.sn_plan_waves.argtypes = [
            i32p, ctypes.c_uint64, i32p, ctypes.c_uint64,
        ]
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.sn_set_direct_t.restype = None
        lib.sn_set_direct_t.argtypes = [ctypes.c_int]
        lib.sn_compress_framed.restype = ctypes.c_int64
        lib.sn_compress_framed.argtypes = [
            u8p, ctypes.c_uint64, u8p, ctypes.c_uint64, ctypes.c_int,
        ]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.sn_compress_framed_crc.restype = ctypes.c_int64
        lib.sn_compress_framed_crc.argtypes = [
            u8p, ctypes.c_uint64, u8p, ctypes.c_uint64, ctypes.c_int,
            u32p, u64p, ctypes.c_int,
        ]
        lib.sn_framed_max_length.restype = ctypes.c_int64
        lib.sn_framed_max_length.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.sn_decompress_framed.restype = ctypes.c_int64
        lib.sn_decompress_framed.argtypes = [
            u8p, ctypes.c_uint64, u8p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ]
        lib.sn_framed_uncompressed_length.restype = ctypes.c_int64
        lib.sn_framed_uncompressed_length.argtypes = [
            u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.sn_emit_from_cands.restype = ctypes.c_int64
        lib.sn_emit_from_cands.argtypes = [u8p, ctypes.c_uint64, i32p, u8p]
        lib.sn_stage_flat_dec_batch.restype = ctypes.c_int64
        lib.sn_stage_flat_dec_batch.argtypes = [
            u8p, i64p, i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, i32p, i32p, u8p, i64p,
            ctypes.c_int64,
        ]
        lib.sn_stage_flat_dec_seg.restype = ctypes.c_int64
        lib.sn_stage_flat_dec_seg.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint64, i64p, u8p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, i32p, i32p, u8p,
        ]
        lib.sn_stage_flat_enc_batch.restype = ctypes.c_int64
        lib.sn_stage_flat_enc_batch.argtypes = [
            u8p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, i32p, i32p, u8p,
            ctypes.c_uint64, u8p, ctypes.c_int64, i64p, i64p, i64p,
            ctypes.c_int64,
        ]
        lib.sn_stage_flat_dec_id_batch.restype = ctypes.c_int64
        lib.sn_stage_flat_dec_id_batch.argtypes = [
            u8p, i64p, i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            u8p, i64p, ctypes.c_int64,
        ]
        lib.sn_stage_flat_dec_id_seg.restype = ctypes.c_int
        lib.sn_stage_flat_dec_id_seg.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint64, i64p, u8p,
            ctypes.c_int64, ctypes.c_int64, u8p,
        ]
        lib.sn_compress_batch.restype = ctypes.c_int64
        lib.sn_compress_batch.argtypes = [
            u8p, ctypes.c_int64, i64p, ctypes.c_int64, u8p,
            ctypes.c_int64, i64p, i64p, i64p, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_u8p(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _to_arr(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, np.uint8)


_pybytes_api = None


def _bytes_alloc(n: int):
    """Uninitialized `bytes` of exact size n plus its raw buffer
    pointer: the native decoder writes the FINAL bytes object in
    place, eliding the np.empty + .tobytes() output copy the old
    wrappers paid (measured ~70% of decode wall time at 256 MB).
    CPython C-API pattern — PyBytes_FromStringAndSize(NULL, n) then
    fill while refcount == 1, before the object is exposed."""
    global _pybytes_api
    if _pybytes_api is None:
        api = ctypes.pythonapi
        api.PyBytes_FromStringAndSize.restype = ctypes.py_object
        api.PyBytes_FromStringAndSize.argtypes = [
            ctypes.c_void_p, ctypes.c_ssize_t]
        api.PyBytes_AsString.restype = ctypes.c_void_p
        api.PyBytes_AsString.argtypes = [ctypes.py_object]
        _pybytes_api = api
    b = _pybytes_api.PyBytes_FromStringAndSize(None, n)
    p = ctypes.cast(_pybytes_api.PyBytes_AsString(b),
                    ctypes.POINTER(ctypes.c_uint8))
    return b, p


_pybytes_raw = None


def _fill_bytes_exact(cap: int, fill) -> bytes:
    """For producers whose final size is only known after the call
    (compressors): allocate a worst-case uninitialized bytes, run
    fill(ptr) -> final_len, then _PyBytes_Resize down IN PLACE
    (realloc shrink — no output copy).  The object lives as a RAW
    owned pointer until after the resize: _PyBytes_Resize requires
    refcount == 1 and may move the allocation, so no ctypes py_object
    (whose _objects would keep — and later decref — the OLD pointer)
    may wrap it before the resize is done."""
    global _pybytes_raw
    if _pybytes_raw is None:
        api = ctypes.PyDLL(None)  # pythonapi with the GIL held
        api.PyBytes_FromStringAndSize.restype = ctypes.c_void_p
        api.PyBytes_FromStringAndSize.argtypes = [
            ctypes.c_void_p, ctypes.c_ssize_t]
        api.PyBytes_AsString.restype = ctypes.c_void_p
        api.PyBytes_AsString.argtypes = [ctypes.c_void_p]
        api._PyBytes_Resize.restype = ctypes.c_int
        api._PyBytes_Resize.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_ssize_t]
        api.Py_DecRef.restype = None
        api.Py_DecRef.argtypes = [ctypes.c_void_p]
        _pybytes_raw = api
    api = _pybytes_raw
    addr = api.PyBytes_FromStringAndSize(None, cap)
    if not addr:  # pragma: no cover - allocation failure
        raise MemoryError
    try:
        p = ctypes.cast(api.PyBytes_AsString(addr),
                        ctypes.POINTER(ctypes.c_uint8))
        n = fill(p)
    except BaseException:
        api.Py_DecRef(addr)
        raise
    if n != cap:
        pv = ctypes.c_void_p(addr)
        rc = api._PyBytes_Resize(ctypes.byref(pv), n)
        if rc != 0:  # pragma: no cover - failure consumed the object
            raise MemoryError("PyBytes resize failed")
        addr = pv.value
    out = ctypes.cast(addr, ctypes.py_object).value  # increfs -> 2
    api.Py_DecRef(addr)  # release the owned raw reference -> 1
    return out


def crc32c(data: bytes, crc: int = 0) -> int:
    lib = _load()
    arr = _to_arr(data)
    return int(lib.sn_crc32c(_as_u8p(arr), len(data), crc))


def max_compressed_length(src_len: int) -> int:
    """Worst-case element size for a src_len-byte block (the capacity
    callers must give stage_flat_enc's elem_out, +8 slack)."""
    return int(_load().sn_max_compressed_length(src_len))


def compress(data: bytes) -> bytes:
    lib = _load()
    src = _to_arr(data)
    cap = int(lib.sn_max_compressed_length(len(data))) + 8

    def fill(p):
        rc = lib.sn_compress(_as_u8p(src), len(data), p)
        if rc < 0:
            _raise(rc)
        return int(rc)

    return _fill_bytes_exact(cap, fill)


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def stage_flat_dec_batch(elems_buf: np.ndarray, offs: np.ndarray,
                         lens: np.ndarray, hdrs: np.ndarray,
                         dst_lens: np.ndarray, rb: int, meta: np.ndarray,
                         starts: np.ndarray, b_rows: np.ndarray,
                         rc_out: np.ndarray, n_threads: int = 4,
                         piece_cap: int = -1) -> int:
    """Whole-batch fused decode STAGE with C++ worker threads — one
    ctypes call for B rows (the per-row Python pool paid ~30% GIL-held
    marshalling and scaled negatively).  meta: int32[B, 8*trip_cap,
    128]; rc_out: int64[B] gets the packed trip count or the row's
    negative error (BUFFER -> per-chunk fallback, CORRUPT -> raise at
    the caller).  Returns the number of negative rows."""
    lib = _load()
    B, nmr, _ = meta.shape
    trip_cap = nmr // 8
    for a in (offs, lens, hdrs, dst_lens, rc_out):
        assert a.dtype == np.int64 and a.flags.c_contiguous
    return int(lib.sn_stage_flat_dec_batch(
        _as_u8p(elems_buf), _i64p(offs), _i64p(lens), _i64p(hdrs),
        _i64p(dst_lens), B, rb, trip_cap, piece_cap, _i32p(meta),
        _i32p(starts), _as_u8p(b_rows), _i64p(rc_out), n_threads))


def stage_flat_dec_seg(element: np.ndarray, dst_total: int,
                       state: np.ndarray, img: np.ndarray, seg_len: int,
                       cmax: int, rb: int, meta: np.ndarray,
                       starts: np.ndarray, b_row: np.ndarray,
                       piece_cap: int = -1) -> int | None:
    """Segmented RAW-stream flat STAGE (see sn_stage_flat_dec_seg):
    plans ``seg_len`` output bytes of one raw element as a dependency-
    free flat plan, carrying the walk state and the rolling 64 KiB
    history in ``img`` (65536 + seg_len + 64 bytes; caller slides the
    carry between segments).  state: int64[6] {s, d, lit_src, lit_rem,
    copy_off, copy_rem}; initialize to [hdr, 0, 0, 0, 0, 0].  Returns
    packed trips, None when a cap/oversized slice forces the host
    fallback, raises on corrupt streams."""
    lib = _load()
    trip_cap = meta.shape[0] // 8
    assert state.dtype == np.int64 and state.shape == (6,)
    rc = lib.sn_stage_flat_dec_seg(
        _as_u8p(element), element.shape[0], dst_total, _i64p(state),
        _as_u8p(img), seg_len, cmax, rb, trip_cap, piece_cap,
        _i32p(meta), _i32p(starts), _as_u8p(b_row))
    if rc == -5:
        return None
    if rc < 0:
        _raise(int(rc))
    return int(rc)


def stage_flat_dec_id_seg(element: np.ndarray, dst_total: int,
                          state: np.ndarray, img: np.ndarray,
                          seg_len: int, rb: int,
                          b_row: np.ndarray) -> bool:
    """Identity seg STAGE (see sn_stage_flat_dec_id_seg): the resume
    walk decodes ``seg_len`` output bytes straight into ``b_row`` (tail
    zeroed) — no plan, the staged row IS the output segment.  Same
    state/img carry contract as stage_flat_dec_seg.  Returns True, or
    False when a >64 KiB copy offset forces the host fallback; raises
    on corrupt streams."""
    lib = _load()
    assert state.dtype == np.int64 and state.shape == (6,)
    rc = lib.sn_stage_flat_dec_id_seg(
        _as_u8p(element), element.shape[0], dst_total, _i64p(state),
        _as_u8p(img), seg_len, rb, _as_u8p(b_row))
    if rc == -5:
        return False
    if rc < 0:
        _raise(int(rc))
    return True


def stage_flat_enc_batch(blocks: np.ndarray, lens: np.ndarray, rb: int,
                         meta: np.ndarray, starts: np.ndarray,
                         b_rows: np.ndarray, tag_cap: int,
                         elem_out: np.ndarray, clens_out: np.ndarray,
                         hdrs_out: np.ndarray, rc_out: np.ndarray,
                         n_threads: int = 4, piece_cap: int = -1) -> int:
    """Whole-batch fused encode STAGE (see stage_flat_dec_batch).
    blocks: uint8[B, block_stride]; elem_out: uint8[B, elem_cap] always
    holds each row's full host element (the fallback emission when
    rc_out[i] == -5).  Returns the number of negative rows."""
    lib = _load()
    B, nmr, _ = meta.shape
    trip_cap = nmr // 8
    for a in (lens, clens_out, hdrs_out, rc_out):
        assert a.dtype == np.int64 and a.flags.c_contiguous
    return int(lib.sn_stage_flat_enc_batch(
        _as_u8p(blocks), blocks.shape[1], _i64p(lens), B, rb, trip_cap,
        piece_cap, _i32p(meta), _i32p(starts), _as_u8p(b_rows), tag_cap,
        _as_u8p(elem_out), elem_out.shape[1], _i64p(clens_out),
        _i64p(hdrs_out), _i64p(rc_out), n_threads))


def stage_flat_dec_id_batch(elems_buf: np.ndarray, offs: np.ndarray,
                            lens: np.ndarray, hdrs: np.ndarray,
                            dst_lens: np.ndarray, rb: int,
                            b_rows: np.ndarray, rc_out: np.ndarray,
                            n_threads: int = 4) -> int:
    """Whole-batch identity decode STAGE with C++ worker threads: each
    row is validated + decoded straight into its staging row at pure
    walk_stream speed (no records, no classify, no pack, no payload
    copy).  rc_out[i] gets SN_OK or the row's negative error (always
    CORRUPT-class: id staging has no caps).  Returns the number of
    negative rows."""
    lib = _load()
    B = rc_out.shape[0]
    for a in (offs, lens, hdrs, dst_lens, rc_out):
        assert a.dtype == np.int64 and a.flags.c_contiguous
    return int(lib.sn_stage_flat_dec_id_batch(
        _as_u8p(elems_buf), _i64p(offs), _i64p(lens), _i64p(hdrs),
        _i64p(dst_lens), B, rb, _as_u8p(b_rows), _i64p(rc_out),
        n_threads))


def compress_batch(blocks: np.ndarray, lens: np.ndarray,
                   elem_out: np.ndarray, clens_out: np.ndarray,
                   hdrs_out: np.ndarray, rc_out: np.ndarray,
                   n_threads: int = 4) -> int:
    """Threaded block compressor (encode half of flat v3): per-row full
    elements into elem_out rows with clen/hdr per row.  The device's
    encode-side job in v3 is the chunk CRC over the uncompressed
    blocks; the emission stays host-side.  Returns negative-row count."""
    lib = _load()
    B = rc_out.shape[0]
    for a in (lens, clens_out, hdrs_out, rc_out):
        assert a.dtype == np.int64 and a.flags.c_contiguous
    return int(lib.sn_compress_batch(
        _as_u8p(blocks), blocks.shape[1], _i64p(lens), B,
        _as_u8p(elem_out), elem_out.shape[1], _i64p(clens_out),
        _i64p(hdrs_out), _i64p(rc_out), n_threads))


def emit_from_cands(block: bytes | np.ndarray, packed: np.ndarray) -> bytes:
    """Block-body emission from device-found match candidates (see
    sn_emit_from_cands): lazily-memoized exact extension (cap 64) of
    the packed near/first pairs, greedy parse + prune — byte-exact to
    kernels.match_np.encode_block_sortmatch (tests enforce; the
    contract's copy-start-alignment pass is an identity under ML_CAP=64
    and omitted here)."""
    lib = _load()
    n = len(block)
    src = _to_arr(bytes(block)) if isinstance(block, (bytes, bytearray)) else block
    assert packed.dtype == np.int32 and packed.flags.c_contiguous
    assert packed.shape[0] >= n
    dst = np.empty(int(lib.sn_max_compressed_length(n)) + 8, np.uint8)
    rc = lib.sn_emit_from_cands(
        _as_u8p(src), n,
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _as_u8p(dst))
    if rc < 0:
        _raise(int(rc))
    return dst[:rc].tobytes()


def decompress(data: bytes) -> bytes:
    lib = _load()
    src = _to_arr(data)
    want = ctypes.c_uint64(0)
    hdr = lib.sn_uncompressed_length(_as_u8p(src), len(data), ctypes.byref(want))
    if hdr < 0:
        _raise(hdr)
    if want.value == 0:
        dst = np.empty(1, np.uint8)
        rc = lib.sn_decompress(_as_u8p(src), len(data), _as_u8p(dst), 0)
        if rc != SN_OK:
            _raise(rc)
        return b""
    out, p = _bytes_alloc(want.value)
    rc = lib.sn_decompress(_as_u8p(src), len(data), p, want.value)
    if rc != SN_OK:
        _raise(rc)
    return out


def decompress_into(data: bytes | np.ndarray, out: np.ndarray) -> int:
    """Raw-stream decode into a CALLER-OWNED uint8 buffer; returns the
    decoded length.  The zero-allocation destination path: on this
    box a fresh multi-GB output costs ~60 us/page in first-touch
    faults (mmap'd allocations can't be heap-reused), which at 1 GiB
    swamps the walk itself — production pipelines reuse buffers, and
    this entry is how (docs/performance.md r5 long-stream study)."""
    lib = _load()
    src = _to_arr(data) if isinstance(data, (bytes, bytearray)) else data
    want = ctypes.c_uint64(0)
    hdr = lib.sn_uncompressed_length(_as_u8p(src), len(src),
                                     ctypes.byref(want))
    if hdr < 0:
        _raise(hdr)
    assert out.dtype == np.uint8 and out.flags.c_contiguous
    if out.size < want.value:
        raise ValueError(f"out buffer {out.size} < decoded {want.value}")
    rc = lib.sn_decompress(_as_u8p(src), len(src), _as_u8p(out),
                           want.value)
    if rc != SN_OK:
        _raise(rc)
    return int(want.value)


def decompress_framed_into(data: bytes | np.ndarray, out: np.ndarray,
                           verify_checksums: bool = True,
                           threads: int = 0) -> int:
    """Framed-stream decode into a CALLER-OWNED uint8 buffer; returns
    the decoded length (see decompress_into for why this exists)."""
    lib = _load()
    src = _to_arr(data) if isinstance(data, (bytes, bytearray)) else data
    assert out.dtype == np.uint8 and out.flags.c_contiguous
    rc = lib.sn_decompress_framed(
        _as_u8p(src), len(src), _as_u8p(out), out.size,
        1 if verify_checksums else 0, threads)
    if rc == -5:
        # the decoder's buffer-too-small code: here it means the
        # CALLER's buffer is short, not that the stream is corrupt
        raise ValueError(
            f"out buffer {out.size} too small for the decoded stream")
    if rc < 0:
        _raise(int(rc))
    return int(rc)


def parse_tags(
    data: bytes, start: int, dst_len: int, rec: np.ndarray
) -> int:
    """Pre-parse an element stream into fixed-width records (see
    sn_parse_tags).  rec: int32[(max_tags, 4)] contiguous.  Returns the
    element count; raises on corrupt streams."""
    lib = _load()
    src = _to_arr(data)
    rc = lib.sn_parse_tags(
        _as_u8p(src), len(data), start, dst_len,
        rec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), rec.shape[0],
    )
    if rc < 0:
        _raise(int(rc))
    return int(rc)


def set_direct_t(t: int) -> None:
    """Set the flat planner's direct-gather threshold (default 32
    mirrors kernels.decode_flat.DIRECT_T; 0 sends everything through
    the mirror).  Experiments/tests only."""
    _load().sn_set_direct_t(t)


def plan_waves(rec: np.ndarray, n_tags: int, words: np.ndarray) -> int | None:
    """C++ wave-group planner (see sn_plan_waves).  rec: int32[(T,4)]
    from parse_tags; words: int32[(cap_groups, 16)] output, overwritten.
    Returns the group count, or None when the plan exceeds the cap
    (caller picks another engine).  Mirrors
    kernels.decode_wavegroup.plan_waves decision-for-decision."""
    lib = _load()
    rc = lib.sn_plan_waves(
        rec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_tags,
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), words.shape[0],
    )
    if rc == -5:
        return None
    if rc < 0:
        _raise(int(rc))
    return int(rc)


def compress_framed(data: bytes, chunk_size: int = 65536, threads: int = 0) -> bytes:
    lib = _load()
    src = _to_arr(data)
    cap = lib.sn_framed_max_length(len(data), chunk_size)
    if cap < 0:
        _raise(int(cap))

    def fill(p):
        rc = lib.sn_compress_framed(
            _as_u8p(src), len(data), p, chunk_size, threads)
        if rc < 0:
            _raise(int(rc))
        return int(rc)

    return _fill_bytes_exact(int(cap), fill)


def compress_framed_crc(src: np.ndarray, n: int,
                        crcs: np.ndarray | None,
                        chunk_size: int = 65536, threads: int = 0,
                        write_id: bool = True,
                        rec_lens: np.ndarray | None = None) -> bytes:
    """Framed compression of a contiguous uint8 buffer with OPTIONAL
    caller-supplied per-chunk raw CRC-32C values (the from-device
    path: CRCs computed on the MXU before the bytes left HBM) and an
    optional stream-id skip so per-batch calls concatenate into one
    stream.  rec_lens (uint64[nchunks], optional) receives each
    chunk's framed record length — the record-splitting contract the
    multi-host pwrite assembly uses.  Byte-identical to
    compress_framed(bytes) when crcs matches the data."""
    lib = _load()
    src = np.ascontiguousarray(src).reshape(-1)
    if n > src.nbytes:
        raise ValueError(f"n={n} exceeds source buffer ({src.nbytes})")
    n_chunks = -(-n // chunk_size) if n else 0
    cap = lib.sn_framed_max_length(n, chunk_size)
    if cap < 0:
        _raise(int(cap))
    crcp = None
    if crcs is not None:
        crcs = np.ascontiguousarray(crcs).astype(np.uint32, copy=False)
        if crcs.shape[0] < n_chunks:
            raise ValueError(
                f"crcs has {crcs.shape[0]} entries, need {n_chunks}")
        crcp = crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    rlp = None
    if rec_lens is not None:
        if rec_lens.dtype != np.uint64 or rec_lens.shape[0] < n_chunks:
            raise ValueError(
                f"rec_lens must be uint64[>={n_chunks}]")
        rlp = rec_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

    def fill(p):
        rc = lib.sn_compress_framed_crc(
            _as_u8p(src), n, p, chunk_size, threads, crcp, rlp,
            1 if write_id else 0)
        if rc < 0:
            _raise(int(rc))
        return int(rc)

    return _fill_bytes_exact(int(cap), fill)


def decompress_framed(
    data: bytes, verify_checksums: bool = True, threads: int = 0
) -> bytes:
    lib = _load()
    src = _to_arr(data)
    # header-only scan gives the exact output size (chunk headers
    # carry decoded lengths), so the decoder fills the final bytes
    # object in place — no guess-and-grow, no output copy
    want = ctypes.c_uint64(0)
    rc = lib.sn_framed_uncompressed_length(
        _as_u8p(src), len(data), ctypes.byref(want))
    if rc < 0:
        _raise(int(rc))
    if want.value == 0:
        dst = np.empty(1, np.uint8)
        rc = lib.sn_decompress_framed(
            _as_u8p(src), len(data), _as_u8p(dst), 0,
            1 if verify_checksums else 0, threads)
        if rc < 0:
            _raise(int(rc))
        return b""
    out, p = _bytes_alloc(want.value)
    rc = lib.sn_decompress_framed(
        _as_u8p(src), len(data), p, want.value,
        1 if verify_checksums else 0, threads)
    if rc < 0:
        _raise(int(rc))
    if rc != want.value:  # pragma: no cover - scan and decode agree
        from snappy_tpu_torch.errors import CorruptError

        raise CorruptError("framed scan/decode length disagreement")
    return out
