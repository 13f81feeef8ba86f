"""CRC-32C of the torch port against the JAX package's crc32c_chunks,
the native CRC and the spec oracle.  Tolerance: 0 (bit-exact)."""

import numpy as np
import pytest
import torch

from snappy_tpu import native
from snappy_tpu.kernels.crc32c_jnp import crc32c_chunks as jax_crc32c_chunks
from snappy_tpu.spec.crc32c import _TABLE, crc32c as oracle
from snappy_tpu_torch.kernels import crc32c as kc


# the length classes of tests/test_crc_mxu.py
LENGTHS = [0, 1, 7, 255, 256, 257, 4096, 65535, 65536, 12345]


def _rows(nprng, lengths, width=kc.CHUNK):
    rows = nprng.integers(0, 256, (len(lengths), width), dtype=np.uint8)
    return rows, np.array(lengths, np.int32)


def _native_crcs(rows, lengths):
    return np.array([native.crc32c(rows[i, :n].tobytes())
                     for i, n in enumerate(lengths)], np.int64)


def test_plain_matches_jax_and_native(nprng):
    """Bytes past each length are random, as in an np.empty staging row:
    they must not reach the checksum."""
    rows, lengths = _rows(nprng, LENGTHS)
    want = _native_crcs(rows, lengths)
    jax_got = np.asarray(jax_crc32c_chunks(rows, lengths)).astype(np.int64)
    got = kc.crc32c_chunks(torch.from_numpy(rows), torch.from_numpy(lengths))
    assert got.dtype == torch.int64
    assert np.array_equal(jax_got, want)
    assert np.array_equal(got.numpy(), want)


def test_known_vectors():
    rows = np.zeros((2, kc.CHUNK), dtype=np.uint8)
    rows[0, :9] = np.frombuffer(b"123456789", np.uint8)
    rows[1, :32] = 0xFF
    got = kc.crc32c_chunks(torch.from_numpy(rows),
                           torch.tensor([9, 32], dtype=torch.int32))
    assert got.tolist() == [0xE3069283, 0x62A8AB43]


def test_pitched_panel_read_in_place(nprng):
    """The id staging panel is 520 rows of 128: the CRC reads the first
    65536 bytes of each row through a strided view, no copy."""
    panel = nprng.integers(0, 256, (5, 520 * 128), dtype=np.uint8)
    lengths = np.array([65536, 0, 1, 4097, 65535], np.int32)
    view = torch.from_numpy(panel)[:, : kc.CHUNK]
    assert view.stride(0) == 520 * 128
    got = kc.crc32c_chunks(view, torch.from_numpy(lengths))
    jax_got = np.asarray(jax_crc32c_chunks(
        np.ascontiguousarray(panel[:, : kc.CHUNK]), lengths))
    assert np.array_equal(got.numpy(), _native_crcs(panel, lengths))
    assert np.array_equal(got.numpy(), jax_got.astype(np.int64))


def test_narrow_rows(nprng):
    rows, lengths = _rows(nprng, [0, 100, 4096, 3000], width=4096)
    got = kc.crc32c_chunks(torch.from_numpy(rows), torch.from_numpy(lengths))
    assert np.array_equal(got.numpy(), _native_crcs(rows, lengths))


def gf2_mul(a: int, b: int) -> int:
    """a * b mod P in the reflected form (bit 31 is x^0), as the kernel's
    ``gf2_mul`` computes it."""
    p = 0
    for i in range(31, -1, -1):
        if (a >> i) & 1:
            p ^= b
        b = (b >> 1) ^ (0x82F63B78 if b & 1 else 0)
    return p


def _kernel_math(rows, lengths, seg_bytes, addr=0, chains=2):
    """The CUDA kernel's arithmetic on numpy, with its own constants: each
    row the start of a virtual 64 KiB row of zeros; per ``seg_bytes``
    virtual segment a raw CRC (register 0) of its real bytes: a whole
    segment at a 16-byte address (``addr`` is the row's address mod 16)
    as ``chains`` chains of words (each word xor-ed in, then four table
    steps) joined by the constant shift of a chain's length, any other
    as one chain; each segment moved to the virtual row's end by its
    GF(2) product (zshift of its last real byte), the segments xor-ed,
    the zero suffix taken back (unshift) and the CRC of ``len`` zero
    bytes folded in."""
    zshift, unshift, zero_crc = kc._kernel_constants_np()
    t = [int(x) for x in _TABLE]
    sub = seg_bytes // chains
    join = 1 << 31  # x^(8 sub): x^0 through sub zero bytes
    for _ in range(sub):
        join = t[join & 0xFF] ^ (join >> 8)

    def raw(data, words):
        c = 0
        if words:
            for at in range(0, len(data), 4):
                c ^= int.from_bytes(data[at : at + 4], "little")
                for _ in range(4):
                    c = t[c & 0xFF] ^ (c >> 8)
        else:
            for byte in data:
                c = t[(c ^ byte) & 0xFF] ^ (c >> 8)
        return c

    out = []
    for row, n in zip(rows, lengths):
        n = int(n)
        acc = 0
        for seg in range(kc.CHUNK // seg_bytes):
            p0 = seg * seg_bytes
            p1 = min(p0 + seg_bytes, n)
            if p1 <= p0:
                continue
            body = row[p0:p1].tobytes()
            if p1 - p0 == seg_bytes and (addr + p0) % 16 == 0:
                c = 0
                for j in range(chains):
                    c = gf2_mul(c, join) ^ raw(
                        body[j * sub : (j + 1) * sub], True)
            else:
                c = raw(body, False)
            acc ^= gf2_mul(int(zshift[p1]), c)
        out.append(gf2_mul(int(unshift[n]), acc) ^ int(zero_crc[n]))
    return out


@pytest.mark.parametrize("seg_bytes,addr", [(64, 0), (128, 0), (128, 3),
                                            (256, 0), (256, 8)])
def test_kernel_arithmetic_and_constants(nprng, seg_bytes, addr):
    rows, lengths = _rows(nprng, [0, 1, 15, 16, 17, 63, 64, 65, 255, 256,
                                  257, 5000, 65535, 65536])
    assert _kernel_math(rows, lengths, seg_bytes, addr) == [
        oracle(r[:n].tobytes()) for r, n in zip(rows, lengths)]


def test_kernel_constants_are_shifts():
    """zshift[n] moves a raw CRC over the CHUNK - n zero bytes after byte
    n - 1: gf2_mul(zshift[n], raw(m)) is the raw CRC of m with that many
    zero bytes appended (raw(m) = crc(m) ^ crc(len(m) zero bytes));
    unshift[n] is its inverse; zero_crc[n] is the CRC of n zero bytes."""
    zshift, unshift, zero_crc = kc._kernel_constants_np()
    msg = b"\x01\x02\x03\x04\x05"
    raw = oracle(msg) ^ oracle(bytes(len(msg)))
    for n in (0, 1, 64, 4096, 65472, kc.CHUNK - 1, kc.CHUNK):
        d = kc.CHUNK - n
        want = oracle(msg + bytes(d)) ^ oracle(bytes(len(msg) + d))
        assert gf2_mul(int(zshift[n]), raw) == want, n
        assert gf2_mul(int(unshift[n]), int(zshift[n])) == 1 << 31, n
        assert int(zero_crc[n]) == oracle(bytes(n))


def test_rejects_bad_inputs():
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        kc.crc32c_chunks(torch.zeros(2, 8, dtype=torch.int32), lens)
    with pytest.raises(ValueError):
        kc.crc32c_chunks(torch.zeros(2, kc.CHUNK + 1, dtype=torch.uint8), lens)
    with pytest.raises(ValueError):
        kc.crc32c_chunks(torch.zeros(3, 8, dtype=torch.uint8), lens)
    with pytest.raises(ValueError):
        kc.crc32c_chunks(torch.zeros(2, 8, dtype=torch.uint8, device="meta"),
                         lens)


@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_constant_orbits_equal_the_byte_walk(inverse):
    """The tables are built by doubling (_orbit): the same words as one
    register step a zero byte, forward or taken back, from any start."""
    t = [int(x) for x in _TABLE]
    top = {v >> 24: i for i, v in enumerate(t)}
    cols = kc._ZERO_BYTE_INV if inverse else kc._ZERO_BYTE
    for v0 in (1 << 31, 0xFFFFFFFF, 0x1234ABCD):
        got = kc._orbit(cols, v0, 1000)
        v = v0
        for k in range(1001):
            assert int(got[k]) == v, (v0, k)
            if inverse:
                i = top[v >> 24]
                v = (((v ^ t[i]) << 8) & 0xFFFFFFFF) | i
            else:
                v = t[v & 0xFF] ^ (v >> 8)
