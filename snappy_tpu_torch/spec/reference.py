"""L0 oracle: the reference Snappy block codec, in pure Python.

This reproduces, decision for decision, the classic greedy hash-table
encoder (the `encodeBlock` of the well-known Go implementation, which the
build's ratio target is measured against — SURVEY.md §8.1 "reference
encoder behavior") and the strict validating decoder.  It is the
MockPartition-equivalent of this framework (SURVEY.md §7.5): pure,
injectable, and the ground truth every faster path (numpy, jnp, Pallas,
C++) is tested against bit for bit.

It is deliberately written for clarity, not speed.
"""

from __future__ import annotations

from snappy_tpu_torch.errors import CorruptError, TooLargeError
from snappy_tpu_torch.spec.format import (
    INPUT_MARGIN,
    MAX_BLOCK_SIZE,
    MAX_UNCOMPRESSED_LEN,
    MIN_NON_LITERAL_BLOCK_SIZE,
    TAG_COPY1,
    TAG_COPY2,
    TAG_COPY4,
    TAG_LITERAL,
    hash32,
    max_encoded_len,
    put_uvarint,
    read_uvarint,
    table_shift_and_size,
)

__all__ = ["compress", "decompress", "decoded_len", "encode_block", "decode_block"]


def _load32(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8) | (b[i + 2] << 16) | (b[i + 3] << 24)


def _load64(b: bytes, i: int) -> int:
    lo = _load32(b, i)
    hi = _load32(b, i + 4)
    return lo | (hi << 32)


def emit_literal(out: bytearray, lit: bytes) -> None:
    """Literal element: tag 00 with the 4 length encodings (SURVEY.md §8.1)."""
    n = len(lit) - 1
    if n < 60:
        out.append((n << 2) | TAG_LITERAL)
    elif n < (1 << 8):
        out.append((60 << 2) | TAG_LITERAL)
        out.append(n)
    elif n < (1 << 16):
        out.append((61 << 2) | TAG_LITERAL)
        out += bytes((n & 0xFF, (n >> 8) & 0xFF))
    elif n < (1 << 24):
        out.append((62 << 2) | TAG_LITERAL)
        out += bytes((n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF))
    else:
        out.append((63 << 2) | TAG_LITERAL)
        out += bytes((n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF, (n >> 24) & 0xFF))
    out += lit


def emit_copy(out: bytearray, offset: int, length: int) -> None:
    """Copy emission with the reference's exact length-splitting rules:

    - while length >= 68: emit a length-64 copy2
    - if 64 < length <= 67: emit a length-60 copy2 (leaving 4..7, which
      fits a cheap copy1 when the offset allows)
    - then one copy1 (len 4..11, offset < 2048) or copy2.
    """
    while length >= 68:
        out.append((63 << 2) | TAG_COPY2)
        out += bytes((offset & 0xFF, (offset >> 8) & 0xFF))
        length -= 64
    if length > 64:
        out.append((59 << 2) | TAG_COPY2)
        out += bytes((offset & 0xFF, (offset >> 8) & 0xFF))
        length -= 60
    if length >= 12 or offset >= 2048:
        out.append(((length - 1) << 2) | TAG_COPY2)
        out += bytes((offset & 0xFF, (offset >> 8) & 0xFF))
    else:
        out.append(((offset >> 8) << 5) | ((length - 4) << 2) | TAG_COPY1)
        out.append(offset & 0xFF)


def encode_block(src: bytes) -> bytes:
    """Greedy hash-table encoder for one block (<= 64 KiB), exactly the
    reference algorithm: probe/insert with the skip heuristic, 4-byte
    match verification, match extension, and the post-match double-insert.
    Emits no copy4 tags (offsets < 64 KiB by construction)."""
    assert 0 < len(src) <= MAX_BLOCK_SIZE
    out = bytearray()
    if len(src) < MIN_NON_LITERAL_BLOCK_SIZE:
        emit_literal(out, src)
        return bytes(out)

    shift, table_size = table_shift_and_size(len(src))
    table = [0] * table_size

    s_limit = len(src) - INPUT_MARGIN
    next_emit = 0
    s = 1
    next_hash = hash32(_load32(src, s), shift)

    while True:
        skip = 32
        next_s = s
        candidate = 0
        while True:
            s = next_s
            bytes_between = skip >> 5
            next_s = s + bytes_between
            skip += bytes_between
            if next_s > s_limit:
                # emit remainder
                if next_emit < len(src):
                    emit_literal(out, src[next_emit:])
                return bytes(out)
            candidate = table[next_hash]
            table[next_hash] = s
            next_hash = hash32(_load32(src, next_s), shift)
            if _load32(src, s) == _load32(src, candidate):
                break

        emit_literal(out, src[next_emit:s])

        while True:
            base = s
            s += 4
            i = candidate + 4
            n = len(src)
            while s < n and src[i] == src[s]:
                i += 1
                s += 1
            emit_copy(out, base - candidate, s - base)
            next_emit = s
            if s >= s_limit:
                if next_emit < len(src):
                    emit_literal(out, src[next_emit:])
                return bytes(out)
            # Insert s-1 and probe s using one 8-byte load, as the
            # reference does after every copy.
            x = _load64(src, s - 1)
            prev_hash = hash32(x & 0xFFFFFFFF, shift)
            table[prev_hash] = s - 1
            curr_hash = hash32((x >> 8) & 0xFFFFFFFF, shift)
            candidate = table[curr_hash]
            table[curr_hash] = s
            if (x >> 8) & 0xFFFFFFFF != _load32(src, candidate):
                next_hash = hash32((x >> 16) & 0xFFFFFFFF, shift)
                s += 1
                break


def compress(src: bytes) -> bytes:
    """Raw Snappy stream: varint(len) + per-64KiB-fragment encodings.
    Fragments are self-contained (fresh table, offsets within fragment),
    which is what makes block-data-parallel execution valid downstream."""
    if len(src) > MAX_UNCOMPRESSED_LEN:
        raise TooLargeError(len(src))
    out = bytearray(put_uvarint(len(src)))
    pos = 0
    while pos < len(src):
        block = src[pos : pos + MAX_BLOCK_SIZE]
        pos += len(block)
        if len(block) < MIN_NON_LITERAL_BLOCK_SIZE:
            emit_literal(out, block)
        else:
            out += encode_block(block)
    return bytes(out)


def decoded_len(src: bytes) -> tuple[int, int]:
    """Parse the varint preamble: (uncompressed_length, header_bytes)."""
    return read_uvarint(src, 0)


def decode_block(src: bytes, dst_len: int, start: int = 0) -> bytes:
    """Decode the element stream src[start:] into exactly dst_len bytes,
    with the reference's full validation surface (SURVEY.md §8.3)."""
    dst = bytearray(dst_len)
    d = 0
    s = start
    n = len(src)
    while s < n:
        tag = src[s] & 0x03
        if tag == TAG_LITERAL:
            x = src[s] >> 2
            if x < 60:
                s += 1
            elif x == 60:
                s += 2
                if s > n:
                    raise CorruptError("truncated literal length")
                x = src[s - 1]
            elif x == 61:
                s += 3
                if s > n:
                    raise CorruptError("truncated literal length")
                x = src[s - 2] | (src[s - 1] << 8)
            elif x == 62:
                s += 4
                if s > n:
                    raise CorruptError("truncated literal length")
                x = src[s - 3] | (src[s - 2] << 8) | (src[s - 1] << 16)
            else:  # x == 63
                s += 5
                if s > n:
                    raise CorruptError("truncated literal length")
                x = (
                    src[s - 4]
                    | (src[s - 3] << 8)
                    | (src[s - 2] << 16)
                    | (src[s - 1] << 24)
                )
            length = x + 1
            if length > dst_len - d:
                raise CorruptError("literal overruns output")
            if length > n - s:
                raise CorruptError("literal overruns input")
            dst[d : d + length] = src[s : s + length]
            d += length
            s += length
            continue
        if tag == TAG_COPY1:
            s += 2
            if s > n:
                raise CorruptError("truncated copy1")
            length = 4 + ((src[s - 2] >> 2) & 0x07)
            offset = ((src[s - 2] & 0xE0) << 3) | src[s - 1]
        elif tag == TAG_COPY2:
            s += 3
            if s > n:
                raise CorruptError("truncated copy2")
            length = 1 + (src[s - 3] >> 2)
            offset = src[s - 2] | (src[s - 1] << 8)
        else:  # TAG_COPY4
            s += 5
            if s > n:
                raise CorruptError("truncated copy4")
            length = 1 + (src[s - 5] >> 2)
            offset = (
                src[s - 4]
                | (src[s - 3] << 8)
                | (src[s - 2] << 16)
                | (src[s - 1] << 24)
            )
        if offset <= 0:
            raise CorruptError("zero copy offset")
        if d < offset:
            raise CorruptError("copy offset before block start")
        if length > dst_len - d:
            raise CorruptError("copy overruns output")
        # Byte-at-a-time semantics: overlapping copies repeat runs.
        for _ in range(length):
            dst[d] = dst[d - offset]
            d += 1
    if d != dst_len:
        raise CorruptError("decoded size differs from preamble")
    return bytes(dst)


def decompress(src: bytes) -> bytes:
    """Decode a raw Snappy stream (varint preamble + elements)."""
    dst_len, hdr = decoded_len(src)
    return decode_block(src, dst_len, start=hdr)
