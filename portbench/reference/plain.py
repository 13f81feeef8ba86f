"""The reference encoder and framing in pure Python.

The same algorithm as ``snappy_greedy.cc`` (Snappy's greedy hash-table
block encoder, the framing format's 12.5% rule and masked CRC-32C), one
byte at a time.  It runs at about 1 MB/s, too slow for a run; the tests
hold the frozen C++ copy against it on small inputs, so the yardstick
rests on a plain reading of the algorithm.
"""

from __future__ import annotations

CHUNK = 65536
STREAM_ID = b"\xff\x06\x00\x00sNaPpY"


def _crc_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def mask_crc(c: int) -> int:
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _load32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i : i + 4], "little")


def _hash(u: int, shift: int) -> int:
    return ((u * 0x1E35A7BD) & 0xFFFFFFFF) >> shift


def _literal(out: bytearray, lit: bytes) -> None:
    n = len(lit) - 1
    if n < 60:
        out.append(n << 2)
    elif n < 256:
        out += bytes((60 << 2, n))
    else:
        out += bytes((61 << 2, n & 0xFF, n >> 8))
    out += lit


def _copy(out: bytearray, offset: int, length: int) -> None:
    while length >= 68:
        out += bytes(((63 << 2) | 2, offset & 0xFF, offset >> 8))
        length -= 64
    if length > 64:
        out += bytes(((59 << 2) | 2, offset & 0xFF, offset >> 8))
        length -= 60
    if length >= 12 or offset >= 2048:
        out += bytes((((length - 1) << 2) | 2, offset & 0xFF, offset >> 8))
    else:
        out += bytes((((offset >> 8) << 5) | ((length - 4) << 2) | 1,
                      offset & 0xFF))


def encode_block(src: bytes, table_bits: int = 14) -> bytes:
    """The element of one block of 1 to 65,536 bytes."""
    out = bytearray()
    n = len(src)
    if n < 18:
        _literal(out, src)
        return bytes(out)
    shift, size = 24, 256
    while size < (1 << table_bits) and size < n:
        shift -= 1
        size *= 2
    table = [0] * size
    s_limit = n - 15
    next_emit, s = 0, 1
    next_hash = _hash(_load32(src, s), shift)
    while True:
        skip, next_s = 32, s
        while True:
            s = next_s
            step = skip >> 5
            next_s = s + step
            skip += step
            if next_s > s_limit:
                if next_emit < n:
                    _literal(out, src[next_emit:])
                return bytes(out)
            candidate = table[next_hash]
            table[next_hash] = s
            next_hash = _hash(_load32(src, next_s), shift)
            if _load32(src, s) == _load32(src, candidate):
                break
        _literal(out, src[next_emit:s])
        while True:
            base = s
            s += 4
            i = candidate + 4
            while s < n and src[i] == src[s]:
                i += 1
                s += 1
            _copy(out, base - candidate, s - base)
            next_emit = s
            if s >= s_limit:
                if next_emit < n:
                    _literal(out, src[next_emit:])
                return bytes(out)
            table[_hash(_load32(src, s - 1), shift)] = s - 1
            cur = _load32(src, s)
            h = _hash(cur, shift)
            candidate = table[h]
            table[h] = s
            if cur != _load32(src, candidate):
                next_hash = _hash(_load32(src, s + 1), shift)
                s += 1
                break


def _uvarint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def frame(data: bytes, table_bits: int = 14) -> bytes:
    """The framed stream of ``data``."""
    out = bytearray(STREAM_ID)
    for lo in range(0, len(data), CHUNK):
        chunk = bytes(data[lo : lo + CHUNK])
        body = _uvarint(len(chunk)) + encode_block(chunk, table_bits)
        ctype = 0x00
        if len(body) >= len(chunk) - len(chunk) // 8:
            ctype, body = 0x01, chunk
        blen = len(body) + 4
        out += bytes((ctype, blen & 0xFF, (blen >> 8) & 0xFF, blen >> 16))
        out += mask_crc(crc32c(chunk)).to_bytes(4, "little") + body
    return bytes(out)
