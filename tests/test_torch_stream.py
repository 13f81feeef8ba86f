"""The port's FramedWriter/FramedReader: the 13 cases of
tests/test_stream.py, each over the port's "native" and "torch"
backends, with the writer's bytes held against the JAX package's
FramedWriter on the native host backend.  Tolerance: 0 (byte-exact)."""

import io

import numpy as np
import pytest

from snappy_tpu import native
from snappy_tpu_torch.errors import BadMagicError, ChecksumError, CorruptError
from snappy_tpu.runtime import device_codec as jdc
from snappy_tpu.runtime import stream as jstream
from snappy_tpu.spec import framing
from snappy_tpu_torch import api
from snappy_tpu_torch.runtime.stream import FramedReader, FramedWriter

BACKENDS = ("native", "torch")


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


def _write(data, step=None, **kw):
    sink = io.BytesIO()
    with FramedWriter(sink, **kw) as w:
        step = step or max(1, len(data))
        for i in range(0, len(data), step):
            w.write(data[i : i + step])
    return sink.getvalue()


def _jax_write(data, step=None, **kw):
    sink = io.BytesIO()
    with jstream.FramedWriter(sink, **kw) as w:
        step = step or max(1, len(data))
        for i in range(0, len(data), step):
            w.write(data[i : i + step])
    return sink.getvalue()


def test_writer_matches_oneshot(rng, backend):
    data = b"streaming payload " * 5000 + rng.randbytes(10000)
    blob = _write(data, 7777, backend=backend)  # odd granularity
    assert framing.decompress_framed(blob) == data
    assert blob == _jax_write(data, 7777, backend="native")


def test_reader_roundtrip(rng, backend):
    data = rng.randbytes(3000) + b"pattern" * 9000
    blob = framing.compress_framed(data)
    r = FramedReader(io.BytesIO(blob), backend=backend)
    out = bytearray()
    while True:
        got = r.read(1234)  # odd read size
        if not got:
            break
        out += got
    assert bytes(out) == data


def test_reader_read_all(rng, backend):
    data = rng.randbytes(100000)
    blob = framing.compress_framed(data)
    assert FramedReader(io.BytesIO(blob), backend=backend).read() == data


def test_empty_stream(backend):
    blob = _write(b"", backend=backend)
    assert blob == _jax_write(b"", backend="native")
    assert framing.decompress_framed(blob) == b""
    assert FramedReader(io.BytesIO(blob), backend=backend).read() == b""


def test_reader_bad_magic(backend):
    with pytest.raises(BadMagicError):
        FramedReader(io.BytesIO(b"not a stream at all"),
                     backend=backend).read()


def test_reader_checksum(rng, backend):
    data = rng.randbytes(5000)
    blob = bytearray(framing.compress_framed(data))
    blob[-1] ^= 0xFF
    with pytest.raises(ChecksumError):
        FramedReader(io.BytesIO(bytes(blob)), backend=backend).read()


def test_reader_truncated(rng, backend):
    blob = framing.compress_framed(rng.randbytes(5000))
    with pytest.raises(CorruptError):
        FramedReader(io.BytesIO(blob[:-2]), backend=backend).read()


def test_small_chunk_size(rng, backend):
    data = rng.randbytes(10000) + b"small chunks " * 500
    blob = _write(data, chunk_size=1000, backend=backend)
    assert framing.decompress_framed(blob) == data
    assert blob == _jax_write(data, chunk_size=1000, backend="native")


class _Dribble(io.RawIOBase):
    """Source that legally returns 1-byte short reads (socket-like)."""

    def __init__(self, blob: bytes):
        self._b = io.BytesIO(blob)

    def readable(self):
        return True

    def read(self, n=-1):
        return self._b.read(1 if n is None or n < 0 or n > 1 else n)


def test_reader_short_reads(rng, backend):
    # a 4-byte header arriving one byte at a time is no CorruptError
    data = rng.randbytes(20000)
    blob = framing.compress_framed(data)
    assert FramedReader(_Dribble(blob), backend=backend).read() == data


def test_reader_rejects_declared_size_before_decoding(backend):
    # a chunk declaring a ~4 GiB decoded length is rejected from the
    # varint preamble, before any decode or allocation
    from snappy_tpu.spec.format import STREAM_ID_CHUNK, put_uvarint

    body = put_uvarint((1 << 32) - 1) + b"\x00" * 10
    blen = len(body) + 4
    blob = (
        STREAM_ID_CHUNK
        + bytes((0x00, blen & 0xFF, (blen >> 8) & 0xFF, (blen >> 16) & 0xFF))
        + b"\x00\x00\x00\x00"
        + body
    )
    with pytest.raises(CorruptError):
        FramedReader(io.BytesIO(blob), backend=backend).read()


def test_writer_batched_parity(rng, backend):
    # the batched path gives the backend's one-shot framing, and the
    # JAX writer's bytes
    data = rng.randbytes(130000) + (b"compressible " * 30000)[:200000]
    blob = _write(data, 50000, backend=backend, buffer_chunks=2)
    assert framing.decompress_framed(blob) == data
    assert blob == api.compress_framed(data, backend=backend, device="cpu")
    assert blob == _jax_write(data, 50000, backend="native", buffer_chunks=2)


def test_writer_batched_device_backend(rng, backend, monkeypatch):
    # one compress_framed per buffered batch; "torch" equals the JAX
    # writer on its device backend with the id engine forced
    monkeypatch.setattr(jdc, "_pallas_cache", True)
    monkeypatch.setattr(jdc, "FLAT_MODE", "id")
    data = (b"device batch " * 40000)[:400000] + rng.randbytes(70000)
    blob = _write(data, backend=backend, buffer_chunks=4)
    assert framing.decompress_framed(blob) == data
    assert blob == _jax_write(data, backend="jnp", buffer_chunks=4)
    assert blob == native.compress_framed(data)


def test_reader_writer_fuzz(rng, backend):
    """Randomized write-slab / read-size fuzz: any write granularity in,
    any read granularity out, batched and unbatched, byte-exact."""
    nrng = np.random.default_rng(424242)
    for trial in range(6):
        n = int(nrng.integers(0, 400_000))
        data = (b"fuzz the stream " * 9000 + rng.randbytes(n))[:n]
        buf = io.BytesIO()
        w = FramedWriter(buf, backend=backend)
        i = 0
        while i < len(data):
            step = int(nrng.integers(1, 90_000))
            w.write(data[i:i + step])
            i += step
        w.close()
        src = io.BytesIO(buf.getvalue())
        r = FramedReader(src, backend=backend,
                         buffer_chunks=int(nrng.integers(1, 8)))
        got = bytearray()
        while True:
            k = int(nrng.integers(1, 200_000))
            piece = r.read(k)
            if not piece:
                break
            got += piece
        assert bytes(got) == data, trial
        assert buf.getvalue() == native.compress_framed(data), trial
