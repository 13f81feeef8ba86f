"""The torch port's codec entry points against the JAX package with its
flat engine forced, in every runtime mode of the port ("id", "classify"
and the device LZ engine "seq"), on the same inputs.  Streams must be
byte-identical, decoded bytes equal, and the same errors raised.
Tolerance: 0."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import snappy_tpu_torch
from snappy_tpu import native
from snappy_tpu.bench.corpus import make_corpus
from snappy_tpu.errors import (
    BadMagicError,
    ChecksumError,
    CorruptError,
    SnappyError,
    UnsupportedError,
)
from snappy_tpu.runtime import device_codec as jdc
from snappy_tpu.spec.crc32c import crc32c
from snappy_tpu.spec.format import mask_crc, put_uvarint
from snappy_tpu_torch.device import default_device, resolve
from snappy_tpu_torch.kernels import encode_flat as ke
from snappy_tpu_torch.kernels.decode_flat import DIRECT_T
from snappy_tpu_torch.runtime import device_codec as dc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("id", "classify", "seq")


@pytest.fixture(params=MODES)
def mode(request, monkeypatch):
    """Both packages in one runtime mode, the JAX one with its flat
    engines forced on (off the TPU it would pick the jnp engines).
    "seq" sets only the port's device LZ engine (FLAT=0, HOST_PARSE=0)
    and leaves the JAX package on its id engine: the JAX package's own
    FLAT=0 encoder is the jnp one, whose emission differs, while the
    port's is the reference encoder's, as the id engine's is."""
    monkeypatch.setattr(jdc, "_pallas_cache", True)
    if request.param == "seq":
        monkeypatch.setattr(jdc, "FLAT_MODE", "id")
        monkeypatch.setattr(dc, "FLAT", False)
        monkeypatch.setattr(dc, "HOST_PARSE", False)
    else:
        monkeypatch.setattr(jdc, "FLAT_MODE", request.param)
        monkeypatch.setattr(dc, "FLAT_MODE", request.param)
    return request.param


@pytest.fixture
def fallbacks(monkeypatch):
    counts = dict.fromkeys(dc.HOST_FALLBACKS, 0)
    monkeypatch.setattr(dc, "HOST_FALLBACKS", counts)
    return counts


def _samples(nprng):
    text = b"from the device, framed " * 9000
    return [
        b"x",
        text[:1000],
        text[:65536],
        nprng.bytes(70_000),                            # incompressible
        (text[:130_000] + nprng.bytes(1000) + bytes(40_000))[:171_000],
    ]


def _tensor(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


def test_framed_entry_points_match_jax(mode, nprng):
    for data in _samples(nprng):
        stream = dc.compress_framed(data, device="cpu")
        assert stream == jdc.compress_framed(data), len(data)
        assert stream == native.compress_framed(data), len(data)
        assert dc.decompress_framed(stream, device="cpu") == data
        on_dev = dc.decompress_framed_to_device(stream, device="cpu")
        assert on_dev.dtype == torch.uint8 and on_dev.device.type == "cpu"
        assert np.array_equal(
            on_dev.numpy(), np.asarray(jdc.decompress_framed_to_device(stream)))
        assert dc.compress_framed_from_device(on_dev) == \
            jdc.compress_framed_from_device(
                jax.device_put(np.frombuffer(data, np.uint8)))


def test_raw_entry_points_match_jax(mode, nprng):
    for data in [b""] + _samples(nprng):
        raw = dc.compress(data, device="cpu")
        assert raw == jdc.compress(data) == native.compress(data), len(data)
        assert dc.decompress(raw, device="cpu") == data
        on_dev = dc.decompress_to_device(raw, device="cpu")
        assert np.array_equal(on_dev.numpy(),
                              np.asarray(jdc.decompress_to_device(raw)))
        assert dc.compress_from_device(on_dev) == jdc.compress_from_device(
            jax.device_put(np.frombuffer(data, np.uint8)))


@pytest.mark.parametrize("chunk_size", [1024, 40_000])
def test_small_chunk_sizes(mode, nprng, chunk_size):
    data = _samples(nprng)[-1][:120_000]
    stream = dc.compress_framed(data, chunk_size=chunk_size, device="cpu")
    assert stream == jdc.compress_framed(data, chunk_size=chunk_size)
    assert dc.decompress_framed(stream, device="cpu") == data


def test_many_batches_reuse_staging(mode, nprng, monkeypatch):
    """BATCH=2 puts ~8 batches through each path, so every host staging
    set is reused several times; every byte must survive."""
    monkeypatch.setattr(dc, "BATCH", 2)
    monkeypatch.setattr(jdc, "BATCH", 2)
    data = (b"staging reuse " * 40_000 + nprng.bytes(70_000))[: 65536 * 7 + 4242]
    stream = dc.compress_framed(data, device="cpu")
    assert stream == jdc.compress_framed(data)
    assert dc.decompress_framed(stream, device="cpu") == data
    on_dev = dc.decompress_framed_to_device(stream, device="cpu")
    assert on_dev.numpy().tobytes() == data
    assert dc.compress_framed_from_device(on_dev) == stream
    raw = dc.compress(data, device="cpu")
    assert dc.decompress_to_device(raw, device="cpu").numpy().tobytes() == data
    assert dc.decompress(raw, device="cpu") == data


def _both_raise(exc, fn_port, fn_jax):
    with pytest.raises(exc):
        fn_port()
    with pytest.raises(exc):
        fn_jax()


def test_corrupt_streams(mode, nprng):
    data = (b"checksum probe " * 9000)[:131072] + nprng.bytes(3000)
    stream = dc.compress_framed(data, device="cpu")
    crc_flip = bytearray(stream)
    crc_flip[14] ^= 0x01  # CRC field of the first chunk
    for dec in ("decompress_framed", "decompress_framed_to_device"):
        _both_raise(ChecksumError,
                    lambda: getattr(dc, dec)(bytes(crc_flip), device="cpu"),
                    lambda: getattr(jdc, dec)(bytes(crc_flip)))
    # verify_checksums=False decodes the same bytes
    assert dc.decompress_framed(bytes(crc_flip), False, device="cpu") == data
    assert dc.decompress_framed_to_device(
        bytes(crc_flip), False, device="cpu").numpy().tobytes() == data
    _both_raise(CorruptError,
                lambda: dc.decompress_framed(stream[:-7], device="cpu"),
                lambda: jdc.decompress_framed(stream[:-7]))
    reserved = bytearray(stream)
    reserved[10] = 0x02  # first chunk's type: reserved unskippable
    _both_raise(UnsupportedError,
                lambda: dc.decompress_framed(bytes(reserved), device="cpu"),
                lambda: jdc.decompress_framed(bytes(reserved)))
    _both_raise(BadMagicError,
                lambda: dc.decompress_framed(b"sNaPpY" + stream, device="cpu"),
                lambda: jdc.decompress_framed(b"sNaPpY" + stream))
    raw = dc.compress(data, device="cpu")
    _both_raise(CorruptError,
                lambda: dc.decompress_to_device(raw[: len(raw) // 2],
                                                device="cpu"),
                lambda: jdc.decompress_to_device(raw[: len(raw) // 2]))
    _both_raise(CorruptError,
                lambda: dc.decompress(raw[: len(raw) // 2], device="cpu"),
                lambda: jdc.decompress(raw[: len(raw) // 2]))


def test_corrupt_payload_byte_caught_by_crc(mode):
    """A flipped literal byte still decodes to the stated length: only
    the chunk CRC (on the device in every mode) can tell."""
    data = bytes(range(256)) * 1024  # one 64 KiB chunk, compressed
    stream = bytearray(dc.compress_framed(data, device="cpu"))
    assert stream[10] == 0x00
    stream[18 + 30] ^= 0x55  # a byte of the leading literal (24..286)
    with pytest.raises(ChecksumError):
        dc.decompress_framed(bytes(stream), device="cpu")


def _frame_one_chunk(element_body: bytes, data: bytes) -> bytes:
    payload = put_uvarint(len(data)) + element_body
    body = mask_crc(crc32c(data)).to_bytes(4, "little") + payload
    return (b"\xff\x06\x00\x00sNaPpY"
            + bytes((0x00, len(body) & 255, (len(body) >> 8) & 255,
                     len(body) >> 16)) + body)


def test_broken_element_raises_corrupt(mode):
    """A copy reaching before the block start fails the decode itself
    (the native walk in the flat modes, the kernel's error code in the
    device LZ engine), whatever the CRC says."""
    data = b"abcdabcd"
    framed = _frame_one_chunk(b"\x0cabcd" + bytes([(3 << 2) | 2, 9, 0]),
                              data)
    for dec in ("decompress_framed", "decompress_framed_to_device"):
        _both_raise(CorruptError,
                    lambda: getattr(dc, dec)(framed, device="cpu"),
                    lambda: getattr(jdc, dec)(framed))


def test_hybrid_engine_not_ported(monkeypatch, nprng):
    """FLAT=0 with HOST_PARSE=1 is the JAX package's hybrid decode
    engine: the port says so instead of running another engine.  Encode
    ignores HOST_PARSE and raw decode stays on the host, as in JAX."""
    monkeypatch.setattr(dc, "FLAT", False)
    monkeypatch.setattr(dc, "HOST_PARSE", True)
    data = _samples(nprng)[-1]
    stream = native.compress_framed(data)
    for dec in (dc.decompress_framed, dc.decompress_framed_to_device):
        with pytest.raises(SnappyError, match="not ported"):
            dec(stream, device="cpu")
    assert dc.compress_framed(data, device="cpu") == stream
    raw = dc.compress(data, device="cpu")
    assert raw == native.compress(data)
    assert dc.decompress(raw, device="cpu") == data


def _one_byte_literals(n: int):
    data = (bytes(range(256)) * (n // 256 + 1))[:n]
    return b"".join(bytes((0x00, b)) for b in data), data


def test_oversize_payload_decodes_on_host(mode, fallbacks):
    elems, data = _one_byte_literals(40_000)  # payload 80003 > 66560
    framed = _frame_one_chunk(elems, data)
    assert dc.decompress_framed(framed, device="cpu") == data
    assert jdc.decompress_framed(framed) == data
    assert fallbacks["oversize_payload"] == 1
    assert dc.decompress_framed_to_device(
        framed, device="cpu").numpy().tobytes() == data


def test_plan_overflow_decodes_on_host(monkeypatch, fallbacks):
    """With the planner's direct-gather threshold at 1 byte, 33,100
    one-byte literals need more pieces than the classify trip cap holds
    (rc -5): that chunk decodes on the host, the next on the device."""
    monkeypatch.setattr(dc, "FLAT_MODE", "classify")
    elems, data = _one_byte_literals(33_100)
    tail = b"tail " * 3000
    framed = (_frame_one_chunk(elems, data)
              + dc.compress_framed(tail, device="cpu")[10:])
    native.set_direct_t(1)
    try:
        got = dc.decompress_framed(framed, device="cpu")
    finally:
        native.set_direct_t(DIRECT_T)
    assert got == data + tail
    assert fallbacks["plan_overflow"] == 1


def test_encode_plan_overflow_takes_host_emission(monkeypatch, fallbacks):
    monkeypatch.setattr(dc, "FLAT_MODE", "classify")
    monkeypatch.setattr(ke, "ENC_TRIP_CAP", 1)
    data = dict(make_corpus(1 << 20, seed=3))["xray"][:150_000]
    assert dc.compress_framed(data, device="cpu") == native.compress_framed(data)
    assert fallbacks["plan_overflow"] > 0


def test_far_copy_offset_decodes_on_host(fallbacks):
    """A format-legal copy offset past the 64 KiB carry is not
    id-stageable: the host decoder takes the stream."""
    lit = np.random.default_rng(5).bytes(70_000)
    n = len(lit) - 1
    off = 66_000
    raw = (put_uvarint(70_004)
           + bytes([63 << 2, n & 255, (n >> 8) & 255, (n >> 16) & 255, 0])
           + lit + bytes([(3 << 2) | 3, off & 255, (off >> 8) & 255,
                          (off >> 16) & 255, 0]))
    want = lit + lit[70_000 - off : 70_000 - off + 4]
    assert dc.decompress_to_device(raw, device="cpu").numpy().tobytes() == want
    assert fallbacks["far_offset"] == 1


def test_host_crc_when_device_crc_off(mode, monkeypatch):
    monkeypatch.setattr(dc, "DEVICE_CRC", False)
    data = (b"host crc " * 20_000)[:150_000]
    stream = dc.compress_framed(data, device="cpu")
    assert stream == native.compress_framed(data)
    bad = bytearray(stream)
    bad[14] ^= 0x01
    with pytest.raises(ChecksumError):
        dc.decompress_framed(bytes(bad), device="cpu")
    on_dev = dc.decompress_framed_to_device(stream, device="cpu")
    assert dc.compress_framed_from_device(on_dev) == stream


def test_from_device_shapes_and_types():
    data = (b"two rows " * 20_000)[:131_072]
    arr = _tensor(data).reshape(2, 65536)
    assert dc.compress_framed_from_device(arr) == native.compress_framed(data)
    assert dc.compress_framed_from_device(arr[:, :1]) == \
        native.compress_framed(data[::65536])  # a strided view
    assert dc.compress_framed_from_device(_tensor(b"")) == \
        native.compress_framed(b"")
    for fn in (dc.compress_framed_from_device, dc.compress_from_device):
        with pytest.raises(ValueError):
            fn(torch.zeros(8, dtype=torch.float32))
    with pytest.raises(ValueError):
        dc.compress_framed(data, chunk_size=0, device="cpu")


def test_native_required(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(SnappyError):
        dc.compress_framed(b"abc", device="cpu")
    with pytest.raises(SnappyError):
        dc.decompress_to_device(b"\x03abc", device="cpu")


def test_public_api_and_device_pick(nprng):
    assert default_device() == torch.device(
        "cuda:0" if torch.cuda.is_available() else "cpu")
    assert resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve("meta")
    data = _samples(nprng)[-1]
    st = snappy_tpu_torch
    assert st.ChecksumError is ChecksumError
    stream = st.compress_framed(data, device="cpu")
    assert st.decompress_framed(stream, device="cpu") == data
    arr = st.decompress_framed_to_device(stream, device="cpu")
    assert st.compress_framed_from_device(arr) == stream
    raw = st.compress(data, device="cpu")
    assert st.decompress(raw, device="cpu") == data
    assert torch.equal(st.decompress_to_device(raw, device="cpu"), arr)
    assert st.compress_from_device(arr) == raw
    with pytest.raises(AttributeError):
        st.no_such_name


def test_port_imports_no_jax():
    """The port runs a round trip in a fresh interpreter without ever
    importing jax (the GPU machine has none)."""
    code = (
        "import sys, snappy_tpu_torch as st\n"
        "d = bytes(range(256)) * 900\n"
        "s = st.compress_framed(d, device='cpu')\n"
        "assert st.decompress_framed(s, device='cpu') == d\n"
        "t = st.decompress_framed_to_device(s, device='cpu')\n"
        "assert st.compress_framed_from_device(t) == s\n"
        "assert st.decompress(st.compress(d, device='cpu'), device='cpu') == d\n"
        "from snappy_tpu_torch.runtime import device_codec as dc\n"
        "dc.FLAT, dc.HOST_PARSE = False, False\n"
        "assert st.decompress_framed(st.compress_framed(d, device='cpu'),\n"
        "                            device='cpu') == d\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
