"""Snappy block-format constants and varint codec (the format ground truth).

This module is L0 of the framework (SURVEY.md §7.1): pure Python, no jax.
Everything else — the jnp kernels, the Pallas kernels, the C++ native
codec — is validated against the behavior defined here.

Format reference: SURVEY.md §8 (self-contained spec of the public Snappy
block + framed formats, stable since 2011).
"""

from __future__ import annotations

from snappy_tpu_torch.errors import CorruptError, TooLargeError

# --- Tag types (low 2 bits of the first byte of every element) -----------
TAG_LITERAL = 0x00
TAG_COPY1 = 0x01  # 1-byte offset, length 4..11, offset 1..2047
TAG_COPY2 = 0x02  # 2-byte LE offset, length 1..64, offset 1..65535
TAG_COPY4 = 0x03  # 4-byte LE offset, length 1..64

# --- Block limits --------------------------------------------------------
MAX_BLOCK_SIZE = 65536  # encoder fragments input into blocks of this size
MAX_UNCOMPRESSED_LEN = (1 << 32) - 1

# The encoder never needs to look for matches in the last INPUT_MARGIN
# bytes of a block: a match needs 4 bytes plus room to read an 8-byte
# word for the hash of the following position.
INPUT_MARGIN = 15

# Blocks shorter than this are emitted as a single literal (a copy element
# could never pay for itself): 1 tag byte + 2 offset bytes + margin.
MIN_NON_LITERAL_BLOCK_SIZE = 1 + 2 + INPUT_MARGIN  # == 18

# Hash-table parameters of the reference match finder.
MAX_TABLE_BITS = 14
MAX_TABLE_SIZE = 1 << MAX_TABLE_BITS
HASH_MUL = 0x1E35A7BD


def table_shift_and_size(block_len: int) -> tuple[int, int]:
    """Reference table sizing: smallest power of two >= block_len,
    clamped to [256, 16384]; shift = 32 - log2(table_size)."""
    shift, size = 32 - 8, 1 << 8
    while size < MAX_TABLE_SIZE and size < block_len:
        shift -= 1
        size *= 2
    return shift, size


def hash32(u: int, shift: int) -> int:
    """The reference 4-byte hash: (u * 0x1e35a7bd) >> shift, u32 math."""
    return ((u * HASH_MUL) & 0xFFFFFFFF) >> shift


def framed_chunk_type(chunk_len: int, body_len: int) -> int:
    """THE framed compressed-vs-uncompressed policy, in one place
    (VERDICT r2 weak #8: it used to live in three copies): store the
    chunk uncompressed when the compressed body (varint preamble +
    element) fails to save at least 12.5%.  body_len is the candidate
    compressed body length; chunk_len the uncompressed chunk length.
    Native sn_compress_framed mirrors this expression
    (snappy_native.cpp sn_compress_framed, `comp >= len - len / 8`);
    tests/test_spec.py pins the two sides together at the boundary."""
    if body_len >= chunk_len - chunk_len // 8:
        return CHUNK_UNCOMPRESSED
    return CHUNK_COMPRESSED


def max_encoded_len(src_len: int) -> int:
    """Worst-case compressed size bound: 32 + n + n/6 (SURVEY.md §8.1)."""
    if src_len > MAX_UNCOMPRESSED_LEN:
        raise TooLargeError(src_len)
    return 32 + src_len + src_len // 6


# --- Varint (LEB128) preamble -------------------------------------------

def put_uvarint(value: int) -> bytes:
    """Encode the uncompressed-length preamble: 7 bits per byte,
    LSB-first, 0x80 continuation."""
    if value < 0 or value > MAX_UNCOMPRESSED_LEN:
        raise TooLargeError(value)
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def read_uvarint(buf: bytes, pos: int = 0) -> tuple[int, int]:
    """Decode a uvarint at buf[pos:].  Returns (value, bytes_consumed).

    Raises CorruptError on truncation or a preamble longer than 5 bytes,
    TooLargeError if the decoded value exceeds 2**32 - 1.
    """
    value = 0
    shift = 0
    for i in range(5):
        if pos + i >= len(buf):
            raise CorruptError("truncated varint preamble")
        b = buf[pos + i]
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            if value > MAX_UNCOMPRESSED_LEN:
                raise TooLargeError(value)
            return value, i + 1
        shift += 7
    raise CorruptError("varint preamble longer than 5 bytes")


# --- Framed (.sz) stream constants (SURVEY.md §8.2) ----------------------
CHUNK_COMPRESSED = 0x00
CHUNK_UNCOMPRESSED = 0x01
CHUNK_PADDING = 0xFE
CHUNK_STREAM_ID = 0xFF
# 0x02..0x7f reserved unskippable; 0x80..0xfd reserved skippable.

STREAM_ID_PAYLOAD = b"sNaPpY"
STREAM_ID_CHUNK = bytes([CHUNK_STREAM_ID, 0x06, 0x00, 0x00]) + STREAM_ID_PAYLOAD

# A framed chunk carries at most this much uncompressed data.
MAX_CHUNK_UNCOMPRESSED = 65536
# Chunk length field is 24-bit.
MAX_CHUNK_BODY = (1 << 24) - 1

CRC_MASK_DELTA = 0xA282EAD8


def mask_crc(crc: int) -> int:
    """Snappy framing checksum mask: rotate right 15 then add delta."""
    crc &= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + CRC_MASK_DELTA) & 0xFFFFFFFF


def unmask_crc(masked: int) -> int:
    masked = (masked - CRC_MASK_DELTA) & 0xFFFFFFFF
    return ((masked >> 17) | (masked << 15)) & 0xFFFFFFFF
