"""CRC-32C of the torch port against the JAX package's crc32c_chunks,
the native CRC and the spec oracle.  Tolerance: 0 (bit-exact)."""

import numpy as np
import pytest
import torch

from snappy_tpu import native
from snappy_tpu.kernels.crc32c_jnp import crc32c_chunks as jax_crc32c_chunks
from snappy_tpu.spec.crc32c import crc32c as oracle
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


def _kernel_math(rows, lengths):
    """The CUDA kernel's arithmetic on numpy, with its own constants:
    a table CRC per 256-byte segment, each advanced through the bytes
    after it with the 2**j-byte shift columns, xor-reduced."""
    table, shifts = kc._kernel_constants_np()
    out = []
    for row, n in zip(rows, lengths):
        acc = 0
        for t in range(kc.NSEG):
            s, e = t * kc.SEG, min((t + 1) * kc.SEG, int(n))
            if s >= e:
                continue
            c = 0xFFFFFFFF
            for byte in row[s:e]:
                c = int(table[(c ^ int(byte)) & 0xFF]) ^ (c >> 8)
            c ^= 0xFFFFFFFF
            dist = int(n) - e
            for j in range(16):
                if (dist >> j) & 1:
                    c = int(np.bitwise_xor.reduce(
                        shifts[j][[(c >> i) & 1 == 1 for i in range(32)]],
                        initial=np.uint32(0)))
            acc ^= c
        out.append(acc)
    return out


def test_kernel_arithmetic_and_constants(nprng):
    rows, lengths = _rows(nprng, [0, 1, 255, 256, 257, 5000, 65535, 65536])
    assert _kernel_math(rows, lengths) == [
        oracle(r[:n].tobytes()) for r, n in zip(rows, lengths)]


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
