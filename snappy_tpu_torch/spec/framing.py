"""L0 oracle for the framed (.sz) stream format (SURVEY.md §8.2).

Chunked streams: stream-identifier chunk, then per-chunk [type u8 |
len u24le | masked-crc32c u32le | payload].  The encoder falls back to an
uncompressed chunk whenever compression saves less than 1/8th of the
input — the reference framing encoder's exact rule.
"""

from __future__ import annotations

from snappy_tpu_torch.errors import (
    BadMagicError,
    ChecksumError,
    CorruptError,
    UnsupportedError,
)
from snappy_tpu_torch.spec import reference
from snappy_tpu_torch.spec.crc32c import crc32c
from snappy_tpu_torch.spec.format import (
    CHUNK_COMPRESSED,
    CHUNK_PADDING,
    CHUNK_STREAM_ID,
    CHUNK_UNCOMPRESSED,
    framed_chunk_type,
    MAX_CHUNK_UNCOMPRESSED,
    STREAM_ID_CHUNK,
    STREAM_ID_PAYLOAD,
    mask_crc,
)

__all__ = ["compress_framed", "decompress_framed"]


def _chunk_header(chunk_type: int, body_len: int) -> bytes:
    return bytes(
        (chunk_type, body_len & 0xFF, (body_len >> 8) & 0xFF, (body_len >> 16) & 0xFF)
    )


def compress_framed(src: bytes, chunk_size: int = MAX_CHUNK_UNCOMPRESSED) -> bytes:
    if not 0 < chunk_size <= MAX_CHUNK_UNCOMPRESSED:
        raise ValueError(f"chunk_size must be in (0, 65536], got {chunk_size}")
    out = bytearray(STREAM_ID_CHUNK)
    for pos in range(0, len(src), chunk_size):
        chunk = src[pos : pos + chunk_size]
        checksum = mask_crc(crc32c(chunk))
        body = reference.compress(chunk)
        # Reference framing rule: require >= 12.5% savings, else store
        # raw — the shared policy lives in format.framed_chunk_type.
        chunk_type = framed_chunk_type(len(chunk), len(body))
        if chunk_type == CHUNK_UNCOMPRESSED:
            body = chunk
        out += _chunk_header(chunk_type, len(body) + 4)
        out += bytes(
            (
                checksum & 0xFF,
                (checksum >> 8) & 0xFF,
                (checksum >> 16) & 0xFF,
                (checksum >> 24) & 0xFF,
            )
        )
        out += body
    return bytes(out)


def decompress_framed(src: bytes, verify_checksums: bool = True) -> bytes:
    if len(src) < len(STREAM_ID_CHUNK) or src[: len(STREAM_ID_CHUNK)] != STREAM_ID_CHUNK:
        raise BadMagicError()
    out = bytearray()
    pos = len(STREAM_ID_CHUNK)
    n = len(src)
    while pos < n:
        if n - pos < 4:
            raise CorruptError("truncated chunk header")
        chunk_type = src[pos]
        body_len = src[pos + 1] | (src[pos + 2] << 8) | (src[pos + 3] << 16)
        pos += 4
        if n - pos < body_len:
            raise CorruptError("truncated chunk body")
        body = src[pos : pos + body_len]
        pos += body_len
        if chunk_type == CHUNK_STREAM_ID:
            if body != STREAM_ID_PAYLOAD:
                raise BadMagicError()
            continue
        if chunk_type == CHUNK_PADDING or 0x80 <= chunk_type <= 0xFD:
            continue
        if 0x02 <= chunk_type <= 0x7F:
            raise UnsupportedError(chunk_type)
        if body_len < 4:
            raise CorruptError("chunk body shorter than checksum")
        stored = body[0] | (body[1] << 8) | (body[2] << 16) | (body[3] << 24)
        payload = body[4:]
        if chunk_type == CHUNK_COMPRESSED:
            dst_len, _ = reference.decoded_len(payload)
            if dst_len > MAX_CHUNK_UNCOMPRESSED:
                raise CorruptError("chunk decodes to more than 64KiB")
            data = reference.decompress(payload)
        else:  # CHUNK_UNCOMPRESSED
            if len(payload) > MAX_CHUNK_UNCOMPRESSED:
                raise CorruptError("uncompressed chunk larger than 64KiB")
            data = payload
        if verify_checksums:
            actual = mask_crc(crc32c(data))
            if actual != stored:
                raise ChecksumError(stored, actual)
        out += data
    return bytes(out)
