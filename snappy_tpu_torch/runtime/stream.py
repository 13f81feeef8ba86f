"""Streaming framed (.sz) reader and writer on the port's backends.

Counterpart of ``snappy_tpu/runtime/stream.py``, with the same
semantics: ``FramedWriter`` buffers whole chunks and emits framed
records on flush/close; ``FramedReader`` consumes records incrementally
and serves reads of any size.  Both route their codec work through the
port's registry (:mod:`snappy_tpu_torch.api`), so ``backend="torch"``
(the default) runs the device codec:

  writer  each ``buffer_chunks`` x 64 KiB batch is one
          ``compress_framed`` call, whose chunk CRCs the device computes
          (``kernels.crc32c``); other chunk sizes and the stream's tail
          go chunk by chunk through ``compress`` with a host CRC.
  reader  each record decodes through ``decompress``, which under
          "torch" in the id engine is the native host walk, as in the
          JAX package, with a host CRC; for ``backend`` None or
          "native" a multi-record fill is one native batched framed
          decode.

Without the native library the reader's and the writer's own CRCs run
on the CRC kernel of the default device, one launch a record, and the
records decode as the "torch" backend does without it.
"""

from __future__ import annotations

import io

from snappy_tpu_torch.errors import (
    BadMagicError,
    ChecksumError,
    CorruptError,
    UnsupportedError,
)
from snappy_tpu_torch.spec.format import (
    CHUNK_COMPRESSED,
    CHUNK_PADDING,
    CHUNK_STREAM_ID,
    CHUNK_UNCOMPRESSED,
    MAX_CHUNK_UNCOMPRESSED,
    STREAM_ID_CHUNK,
    STREAM_ID_PAYLOAD,
    framed_chunk_type,
    mask_crc,
    read_uvarint,
)
from snappy_tpu_torch import api

__all__ = ["FramedWriter", "FramedReader"]


def _crc(data: bytes) -> int:
    """A record's CRC-32C: the native CRC, else the CRC kernel on the
    default device (``device_codec._crc32c_host``)."""
    from snappy_tpu_torch.runtime.device_codec import _crc32c_host

    return _crc32c_host([data])[0]


class FramedWriter(io.RawIOBase):
    """Incremental framed compressor.

    with FramedWriter(open(path, 'wb')) as w:
        w.write(part1); w.write(part2)

    Chunks are accumulated and compressed ``buffer_chunks`` at a time
    through the backend's batched framed path (one device dispatch per
    batch instead of one per 64 KiB chunk).  Other chunk sizes use the
    per-chunk path.
    """

    def __init__(self, sink, chunk_size: int = MAX_CHUNK_UNCOMPRESSED,
                 backend: str | None = None, buffer_chunks: int = 64):
        if not 0 < chunk_size <= MAX_CHUNK_UNCOMPRESSED:
            raise ValueError("chunk_size must be in (0, 65536]")
        self._sink = sink
        self._chunk_size = chunk_size
        self._backend = backend
        self._batch_bytes = (
            buffer_chunks * chunk_size
            if chunk_size == MAX_CHUNK_UNCOMPRESSED and buffer_chunks > 1
            else chunk_size
        )
        self._buf = bytearray()
        self._wrote_header = False

    def writable(self) -> bool:
        return True

    def _header(self) -> None:
        if not self._wrote_header:
            self._sink.write(STREAM_ID_CHUNK)
            self._wrote_header = True

    def write(self, data) -> int:
        self._buf += bytes(data)
        while len(self._buf) >= self._batch_bytes:
            self._emit_batch(bytes(self._buf[: self._batch_bytes]))
            del self._buf[: self._batch_bytes]
        return len(data)

    def _emit_batch(self, data: bytes) -> None:
        """Compress a whole-chunk multiple through the backend's batched
        framed encoder and append its records (without its stream
        identifier)."""
        if len(data) <= self._chunk_size:
            self._emit(data)
            return
        self._header()
        blob = api.compress_framed(data, backend=self._backend)
        if blob[: len(STREAM_ID_CHUNK)] != STREAM_ID_CHUNK:
            raise CorruptError("backend's framed stream has no identifier")
        self._sink.write(blob[len(STREAM_ID_CHUNK):])

    def _emit(self, chunk: bytes) -> None:
        self._header()
        checksum = mask_crc(_crc(chunk))
        body = api.compress(chunk, backend=self._backend)
        ctype = framed_chunk_type(len(chunk), len(body))
        if ctype == CHUNK_UNCOMPRESSED:
            body = chunk
        blen = len(body) + 4
        self._sink.write(
            bytes((ctype, blen & 0xFF, (blen >> 8) & 0xFF, (blen >> 16) & 0xFF))
        )
        self._sink.write(checksum.to_bytes(4, "little"))
        self._sink.write(body)

    def flush(self) -> None:
        if len(self._buf) > self._chunk_size:
            whole = len(self._buf) - (len(self._buf) % self._chunk_size)
            if whole > self._chunk_size:
                self._emit_batch(bytes(self._buf[:whole]))
                del self._buf[:whole]
        while self._buf:
            chunk = bytes(self._buf[: self._chunk_size])
            del self._buf[: self._chunk_size]
            self._emit(chunk)
        self._header()
        self._sink.flush()

    def close(self) -> None:
        if not self.closed:
            self.flush()
        super().close()


class FramedReader(io.RawIOBase):
    """Incremental framed decompressor over a file-like source.

    The number of records decoded per fill follows the caller's request
    (read(1 MiB) takes 16 chunks, read(100) one), so a slow source
    (socket, pipe) blocks in proportion to what was asked.  Sources may
    return short reads.
    """

    def __init__(self, source, verify_checksums: bool = True,
                 backend: str | None = None, buffer_chunks: int = 64):
        self._src = source
        self._verify = verify_checksums
        self._backend = backend
        self._buffer_chunks = max(1, buffer_chunks)
        self._pending = b""
        self._eof = False
        self._checked_magic = False

    def readable(self) -> bool:
        return True

    def _read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            got = self._src.read(n - len(out))
            if not got:
                raise CorruptError("truncated framed stream")
            out += got
        return out

    def _next_record(self):
        """Read one data record (header + body) from the source, skipping
        stream-identifier, padding and skippable chunks; None at a clean
        end.  Checks types and sizes but does not decode."""
        while True:
            # only a 0-byte first read is a clean end
            hdr = self._src.read(4)
            if not hdr:
                return None
            while len(hdr) < 4:
                got = self._src.read(4 - len(hdr))
                if not got:
                    raise CorruptError("truncated chunk header")
                hdr += got
            ctype = hdr[0]
            blen = hdr[1] | (hdr[2] << 8) | (hdr[3] << 16)
            if not self._checked_magic and ctype != CHUNK_STREAM_ID:
                raise BadMagicError()
            if ctype == CHUNK_STREAM_ID:
                if self._read_exact(blen) != STREAM_ID_PAYLOAD:
                    raise BadMagicError()
                self._checked_magic = True
                continue
            if ctype == CHUNK_PADDING or 0x80 <= ctype <= 0xFD:
                self._read_exact(blen)
                continue
            if 0x02 <= ctype <= 0x7F:
                raise UnsupportedError(ctype)
            if blen < 4:
                raise CorruptError("chunk body shorter than checksum")
            return ctype, bytes(hdr), self._read_exact(blen)

    def _decode_record(self, ctype: int, body: bytes) -> bytes:
        stored = int.from_bytes(body[:4], "little")
        payload = body[4:]
        if ctype == CHUNK_COMPRESSED:
            # reject the declared size before decoding: a chunk claiming
            # ~4 GiB must not allocate or decode first
            dst_len, _ = read_uvarint(payload, 0)
            if dst_len > MAX_CHUNK_UNCOMPRESSED:
                raise CorruptError("chunk decodes to more than 64KiB")
            data = api.decompress(payload, backend=self._backend)
            if len(data) > MAX_CHUNK_UNCOMPRESSED:
                raise CorruptError("chunk decodes to more than 64KiB")
        else:
            if len(payload) > MAX_CHUNK_UNCOMPRESSED:
                raise CorruptError("uncompressed chunk larger than 64KiB")
            data = payload
        if self._verify:
            got = mask_crc(_crc(data))
            if got != stored:
                raise ChecksumError(stored, got)
        return data

    def _fill(self, want_chunks: int) -> bool:
        """Decode up to want_chunks records into _pending; False at a
        clean end with nothing decoded."""
        from snappy_tpu_torch import native

        want_chunks = max(1, min(want_chunks, self._buffer_chunks))
        records = []
        for _ in range(want_chunks):
            rec = self._next_record()
            if rec is None:
                break
            records.append(rec)
            if rec[0] == CHUNK_COMPRESSED:
                dst_len, _ = read_uvarint(rec[2], 4)
                if dst_len > MAX_CHUNK_UNCOMPRESSED:
                    raise CorruptError("chunk decodes to more than 64KiB")
        if not records:
            return False
        use_native = (len(records) > 1 and native.available()
                      and self._backend in (None, "native"))
        if use_native:
            blob = b"".join(
                (STREAM_ID_CHUNK,)
                + tuple(h + b for _t, h, b in records))
            self._pending = native.decompress_framed(
                blob, verify_checksums=self._verify, threads=0)
        else:
            self._pending = b"".join(
                self._decode_record(t, b) for t, _h, b in records)
        return True

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            if not self._pending:
                want = (self._buffer_chunks if n < 0 else
                        -(-(n - len(out)) // MAX_CHUNK_UNCOMPRESSED))
                if self._eof or not self._fill(want):
                    self._eof = True
                    break
            take = (len(self._pending) if n < 0
                    else min(n - len(out), len(self._pending)))
            out += self._pending[:take]
            self._pending = self._pending[take:]
        return bytes(out)
