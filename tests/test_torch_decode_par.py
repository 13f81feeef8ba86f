"""The portable parallel decoder (``snappy_tpu_torch.kernels.decode_par``)
against the JAX package's ``decode_jnp`` on the same seeded batches:
every output byte and every error code, valid streams and hostile ones
(4-byte length and offset fields with high bytes >= 0x80 included),
and ``decode_block_par`` against ``decode_block_jnp``.  Counterpart of
``tests/test_decode_jnp.py``.  Tolerance: 0."""

import random

import numpy as np
import pytest
import torch

from conftest import make_corpus_samples
from snappy_tpu.errors import CorruptError as JCorruptError
from snappy_tpu.kernels import decode_jnp, encode_np
from snappy_tpu.spec import reference
from snappy_tpu_torch.errors import CorruptError
from snappy_tpu_torch.kernels import decode_par as dp
from snappy_tpu_torch.spec.format import put_uvarint, read_uvarint


def _both(streams, cmax: int, out_max: int):
    """The port's and JAX's (out, err) for one batch, as numpy."""
    arrs = dp.stream_rows(streams, cmax)
    out, err = dp.decode_blocks(*(torch.from_numpy(a) for a in arrs),
                                out_max=out_max)
    jout, jerr = decode_jnp.decode_blocks(*arrs, out_max=out_max)
    return (out.numpy(), err.numpy()), (np.asarray(jout), np.asarray(jerr))


def _assert_same(streams, cmax: int, out_max: int):
    (out, err), (jout, jerr) = _both(streams, cmax, out_max)
    assert out.dtype == np.uint8 and err.dtype == np.int32
    np.testing.assert_array_equal(err, jerr)
    np.testing.assert_array_equal(out, jout)
    return err


def test_corpus_batch_matches_jax(rng):
    samples = [s for s in make_corpus_samples(rng, sizes=(0, 1, 17, 1000, 4000))]
    streams = [reference.compress(s) for s in samples]
    streams += [encode_np.compress(s) for s in samples[::3]]
    err = _assert_same(streams, 4608, 4096)
    assert not err.any()


def test_one_64k_batch_matches_jax(rng):
    samples = [rng.randbytes(65536), b"A" * 65536,
               (b"the quick brown fox. " * 4000)[:65536], b""]
    streams = [reference.compress(s) for s in samples]
    (out, err), (jout, jerr) = _both(streams, 66560, 65536)
    np.testing.assert_array_equal(err, jerr)
    np.testing.assert_array_equal(out, jout)
    for i, s in enumerate(samples):
        assert out[i, : len(s)].tobytes() == s and err[i] == 0


def _hostile():
    """Streams at the edges of the element grammar: every error code,
    4-byte literal lengths and copy offsets with high bytes >= 0x80,
    a poisoned literal length, 3-byte literal lengths."""
    lit4 = b"\x0cabcd"
    return [
        b"\x05\x0cabcd",                                 # literal overruns
        b"\x0a\x24abc",
        b"\x08" + lit4 + bytes([(3 << 2) | 1, 0]),       # copy offset 0
        b"\x08" + lit4 + bytes([(3 << 2) | 2, 10, 0]),   # before the start
        b"\x05" + lit4 + bytes([(60 << 2) | 2, 1, 0]),
        b"\x03" + lit4,                                  # output overrun
        b"\x02",                                         # no elements
        b"\x05" + bytes([63 << 2, 0, 0, 0, 0x7F]) + b"abcd",  # poisoned
        b"\x05" + bytes([63 << 2, 0xFF, 0xFF, 0xFF, 0x3F]) + b"abcd",
        b"\x05" + bytes([63 << 2, 0xFF, 0xFF, 0xFF, 0xFF]) + b"abcd",
        b"\x05" + bytes([63 << 2, 3, 0, 0, 0x80]) + b"abcd",
        b"\x08" + lit4 + bytes([(3 << 2) | 3, 4, 0, 0, 0x80]),
        b"\x08" + lit4 + bytes([(3 << 2) | 3, 0xFF, 0xFF, 0xFF, 0xFF]),
        b"\x08" + lit4 + bytes([(3 << 2) | 3, 4, 0, 0, 0]),   # valid copy4
        b"\x08" + bytes([62 << 2, 3, 0, 0x80]) + b"abcd",
        b"\x04" + bytes([62 << 2, 3, 0, 0]) + b"abcd",        # valid
        b"\x07" + bytes([61 << 2, 6, 0]) + b"abcdefg",        # valid
        b"\x08" + lit4 + bytes([(3 << 2) | 3, 4, 0, 0]),      # truncated
        b"\x04" + lit4 + b"xyz",                              # trailing bytes
        b"\x00" + lit4,                                       # elements past 0
        b"\x00",
        b"",
    ]


def test_hostile_elements_match_jax():
    streams = _hostile()
    err = _assert_same(streams, 256, 256)
    assert set(err.tolist()) >= {0, 1, 2, 3, 4, 5}


def test_error_parity_fuzz(rng):
    """Sixty mutations of a valid stream (flipped, deleted and inserted
    bytes) in one batch: bytes and codes as JAX's, and accept/reject as
    the reference decoder's."""
    data = rng.randbytes(300) + b"pattern" * 60 + rng.randbytes(60)
    comp = reference.compress(data)
    muts = []
    for _ in range(60):
        m = bytearray(comp)
        for _ in range(rng.randint(1, 3)):
            op = rng.randint(0, 2)
            if op == 0 and len(m) > 1:
                m[rng.randrange(len(m))] = rng.randrange(256)
            elif op == 1 and len(m) > 2:
                del m[rng.randrange(len(m))]
            else:
                m.insert(rng.randrange(len(m) + 1), rng.randrange(256))
        muts.append(bytes(m))
    err = _assert_same(muts, 1024, 1024)
    for m, e in zip(muts, err):
        try:
            reference.decompress(m)
            ok = True
        except Exception:
            ok = False
        d = read_uvarint(m, 0)[0] if len(m) else 0
        if d <= 1024:
            assert ok == (e == 0), m.hex()


@pytest.mark.parametrize("seed", range(3))
def test_random_garbage_matches_jax(seed):
    """Random bytes after a random preamble: mostly errors of every
    kind; 4-byte fields with random high bytes."""
    r = random.Random(seed)
    streams = [put_uvarint(r.randrange(0, 600))
               + bytes(r.randrange(256) for _ in range(r.randrange(0, 120)))
               for _ in range(48)]
    _assert_same(streams, 256, 1024)


GOLDEN = [
    (b"\x1b\x20Wikipedia\x46\x09\x00", b"Wikipedia" * 3),
    (b"\x00", b""),
    (b"\x01\x00a", b"a"),
    (b"\x09\x00a" + bytes([(4 << 2) | 1, 1]), b"a" * 9),
    (b"\x08\x0cabcd" + bytes([(3 << 2) | 3, 4, 0, 0, 0]), b"abcdabcd"),
]


@pytest.mark.parametrize("stream,want", GOLDEN)
def test_decode_block_par_golden(stream, want):
    d, h = read_uvarint(stream, 0)
    got = dp.decode_block_par(stream, d, start=h, device="cpu")
    assert got == want == decode_jnp.decode_block_jnp(stream, d, start=h)


@pytest.mark.parametrize("stream", _hostile()[:8])
def test_decode_block_par_raises_as_jnp(stream):
    try:
        d, h = read_uvarint(stream, 0)
    except Exception:
        d, h = 0, 0
    with pytest.raises(CorruptError) as got:
        dp.decode_block_par(stream, d, start=h, device="cpu")
    with pytest.raises(JCorruptError) as want:
        decode_jnp.decode_block_jnp(stream, d, start=h)
    assert str(got.value) == str(want.value)


def test_large_raw_stream_many_elements():
    """More than 2^17 elements and a deep copy chain: the doubling round
    counts scale with the stream (decode_block_par), as in JAX."""
    n = 150_000
    expect = bytes(i & 0xFF for i in range(n))
    stream = put_uvarint(n) + b"".join(bytes((0, b)) for b in expect)
    got = dp.decode_block_par(stream, n, start=len(put_uvarint(n)),
                              device="cpu")
    assert got == expect
    data = b"Q" * 300_000
    s2 = reference.compress(data)
    d, h = read_uvarint(s2, 0)
    assert dp.decode_block_par(s2, d, start=h, device="cpu") == data


def test_argument_checks():
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        dp.decode_blocks(torch.zeros(2, 8, dtype=torch.int32), z, z, z)
    with pytest.raises(ValueError):
        dp.decode_blocks(torch.zeros(2, 8, dtype=torch.uint8), z[:1], z, z)
