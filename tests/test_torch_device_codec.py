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
from snappy_tpu import errors as jerr
from snappy_tpu.bench.corpus import make_corpus
from snappy_tpu_torch import native
from snappy_tpu_torch.errors import (
    BadMagicError,
    ChecksumError,
    CorruptError,
    UnsupportedError,
)
from snappy_tpu.runtime import device_codec as jdc
from snappy_tpu.spec.crc32c import crc32c
from snappy_tpu.spec.format import mask_crc, put_uvarint
from snappy_tpu_torch.device import default_device, resolve
from snappy_tpu_torch.kernels import decode_seq as kds
from snappy_tpu_torch.kernels import encode_flat as ke
from snappy_tpu_torch.kernels import encode_seq as kes
from snappy_tpu_torch.kernels.decode_flat import DIRECT_T
from snappy_tpu_torch.runtime import device_codec as dc
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

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


def test_seq_width_fills_the_card_on_cuda_only():
    """The seq engine launches max(BATCH, the card's resident rows) rows
    on a CUDA device and BATCH elsewhere; resident_rows needs a card."""
    def resident(dev, width):
        assert width == 65536
        return 396

    assert dc._seq_width(resident, torch.device("cpu"), 65536) == dc.BATCH
    assert dc._seq_width(resident, torch.device("cuda", 0), 65536) == \
        max(dc.BATCH, 396)
    assert dc._seq_width(lambda d, w: 8, torch.device("cuda", 0),
                         65536) == dc.BATCH
    for mod in (kds, kes):
        with pytest.raises(ValueError):
            mod.resident_rows("cpu", 65536)


@pytest.mark.parametrize("width", [3, 5])
def test_seq_engine_at_a_wide_launch_width(nprng, monkeypatch, width):
    """The seq engine's batching at a launch width other than BATCH (as
    on a card, where it is the resident rows), the last batch ragged:
    streams equal native.compress_framed and every byte comes back."""
    monkeypatch.setattr(dc, "FLAT", False)
    monkeypatch.setattr(dc, "HOST_PARSE", False)
    monkeypatch.setattr(dc, "_seq_width", lambda *a: width)
    data = (b"launch width " * 40_000 + nprng.bytes(70_000))[: 65536 * 11 + 77]
    stream = dc.compress_framed(data, device="cpu")
    assert stream == native.compress_framed(data)
    assert dc.decompress_framed(stream, device="cpu") == data
    on_dev = dc.decompress_framed_to_device(stream, device="cpu")
    assert on_dev.numpy().tobytes() == data
    assert dc.compress_framed_from_device(on_dev) == stream
    assert dc.compress(data, device="cpu") == native.compress(data)


@pytest.mark.parametrize("width", [3, 5])
@pytest.mark.parametrize("path", ["seq", "seq, host CRCs", "id"])
def test_framed_records_written_on_the_device(nprng, monkeypatch, width,
                                              path):
    """The seq engine with device CRCs writes every framed record on the
    device (``frame_records``), at launch widths other than BATCH, the
    last batch ragged; the seq engine with host CRCs and the id engine
    assemble them on the host.  Every stream equals
    native.compress_framed, stored chunks and short last chunks too."""
    if path != "id":
        monkeypatch.setattr(dc, "FLAT", False)
        monkeypatch.setattr(dc, "HOST_PARSE", False)
        monkeypatch.setattr(dc, "_seq_width", lambda *a: width)
    monkeypatch.setattr(dc, "DEVICE_CRC", path != "seq, host CRCs")
    data = (b"framed on the device " * 30_000 + nprng.bytes(70_000)
            + b"tail" * 30)[: 65536 * 10 + 120]
    n_chunks = -(-len(data) // 65536)
    want = native.compress_framed(data)
    before = dc.FRAMED["device_framed_chunks"]
    assert dc.compress_framed_from_device(_tensor(data)) == want
    assert dc.compress_framed(data, device="cpu") == want
    moved = dc.FRAMED["device_framed_chunks"] - before
    assert moved == (2 * n_chunks if path == "seq" else 0)


@pytest.mark.parametrize("call", ["from_device", "host bytes"])
def test_framed_records_pin_a_batch_not_the_stream(nprng, monkeypatch, call):
    """The seq engine's framed encode with device CRCs asks for the same
    pinned memory (every allocation made with a ``pin_memory`` argument,
    pinned on a GPU) for 6 chunks as for 40: its host sets, a launch's
    rows each, and no buffer of the stream's size."""
    monkeypatch.setattr(dc, "FLAT", False)
    monkeypatch.setattr(dc, "HOST_PARSE", False)
    monkeypatch.setattr(dc, "DEVICE_CRC", True)
    monkeypatch.setattr(dc, "_seq_width", lambda *a: 3)
    empty, asked = torch.empty, []

    def spy(*args, **kwargs):
        t = empty(*args, **kwargs)
        if "pin_memory" in kwargs:
            asked[-1] += t.numel() * t.element_size()
        return t

    monkeypatch.setattr(torch, "empty", spy)
    for k in (6, 40):
        data = (b"pinned by the batch " * 4000 + nprng.bytes(40_000)) * k
        data = data[: 65536 * k - 77]
        asked.append(0)
        out = (dc.compress_framed_from_device(_tensor(data))
               if call == "from_device"
               else dc.compress_framed(data, device="cpu"))
        assert out == native.compress_framed(data)
    staged = 3 * 65536 if call == "host bytes" else 0
    assert asked == [dc._NSETS * (3 * (4 + 8 + 65536 + 8) + staged)] * 2


def _both_raise(exc, fn_port, fn_jax):
    """fn_port raises the port's class exc, fn_jax the JAX package's."""
    with pytest.raises(exc):
        fn_port()
    with pytest.raises(getattr(jerr, exc.__name__)):
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


def test_hybrid_engine_decodes_like_jax(monkeypatch, nprng):
    """FLAT=0 with HOST_PARSE=1 is the hybrid decode engine: framed
    decode, to the host and to the device, gives the JAX hybrid engine's
    bytes; encode stays on the device LZ engine (native's stream) and
    raw decode on the host."""
    monkeypatch.setattr(dc, "FLAT", False)
    monkeypatch.setattr(dc, "HOST_PARSE", True)
    monkeypatch.setattr(jdc, "_pallas_cache", False)
    monkeypatch.setattr(jdc, "HOST_PARSE", True)
    for data in _samples(nprng)[1:]:
        stream = native.compress_framed(data)
        want = jdc.decompress_framed(stream)
        assert want == data
        assert dc.decompress_framed(stream, device="cpu") == want
        assert dc.decompress_framed_to_device(
            stream, device="cpu").numpy().tobytes() == want
    assert dc.compress_framed(data, device="cpu") == stream
    raw = dc.compress(data, device="cpu")
    assert raw == native.compress(data)
    assert dc.decompress(raw, device="cpu") == data


PORTABLE = ("hybrid", "jnp")


@pytest.fixture(params=PORTABLE)
def portable(request, monkeypatch, fallbacks):
    """Both packages with their kernel engines off (SNAPPY_TPU_PALLAS=0:
    the port's PALLAS, JAX's _pallas_cache), so framed decode runs the
    hybrid engine ("hybrid", HOST_PARSE=1) or the jnp decoder ("jnp",
    HOST_PARSE=0), and encode the jnp encoder with RATIO_GUARD."""
    monkeypatch.setattr(jdc, "_pallas_cache", False)
    monkeypatch.setattr(dc, "PALLAS", False)
    hybrid = request.param == "hybrid"
    monkeypatch.setattr(jdc, "HOST_PARSE", hybrid)
    monkeypatch.setattr(dc, "HOST_PARSE", hybrid)
    counts = dict.fromkeys(dc.ENCODE_REPLACED, 0)
    monkeypatch.setattr(dc, "ENCODE_REPLACED", counts)
    return request.param


def test_portable_engines_match_jax(portable, nprng):
    """Every entry point byte for byte as the JAX package's with its
    kernel engines off: the jnp encoder's framed and raw streams (not
    native's), the hybrid or jnp framed decode, native raw decode and the
    native matcher with device CRCs for the from-device encoders."""
    for data in _samples(nprng):
        stream = dc.compress_framed(data, device="cpu")
        assert stream == jdc.compress_framed(data), len(data)
        assert dc.decompress_framed(stream, device="cpu") == data
        assert jdc.decompress_framed(stream) == data
        on_dev = dc.decompress_framed_to_device(stream, device="cpu")
        assert on_dev.numpy().tobytes() == data
        assert dc.compress_framed_from_device(on_dev) == \
            jdc.compress_framed_from_device(
                jax.device_put(np.frombuffer(data, np.uint8)))
        raw = dc.compress(data, device="cpu")
        assert raw == jdc.compress(data), len(data)
        assert dc.decompress(raw, device="cpu") == data
        assert dc.decompress_to_device(raw, device="cpu").numpy().tobytes() \
            == data
        assert dc.compress_from_device(on_dev) == native.compress(data)
    assert dc.ENCODE_REPLACED == {"not_ok": 0, "ratio_guard": 0}


@pytest.mark.parametrize("chunk_size", [1024, 40_000])
def test_portable_small_chunk_sizes(portable, nprng, chunk_size):
    data = _samples(nprng)[-1][:120_000]
    stream = dc.compress_framed(data, chunk_size=chunk_size, device="cpu")
    assert stream == jdc.compress_framed(data, chunk_size=chunk_size)
    assert dc.decompress_framed(stream, device="cpu") == data


def test_portable_corrupt_streams(portable, nprng, monkeypatch):
    """The JAX package's error classes, at BATCH 2 (two batches)."""
    monkeypatch.setattr(dc, "BATCH", 2)
    monkeypatch.setattr(jdc, "BATCH", 2)
    data = (nprng.bytes(300) + (b"checksum probe " * 9000)[:131072]
            + nprng.bytes(3000))
    stream = native.compress_framed(data)
    crc_flip = bytearray(stream)
    crc_flip[14] ^= 0x01
    for dec in ("decompress_framed", "decompress_framed_to_device"):
        _both_raise(ChecksumError,
                    lambda: getattr(dc, dec)(bytes(crc_flip), device="cpu"),
                    lambda: getattr(jdc, dec)(bytes(crc_flip)))
        _both_raise(ChecksumError,
                    lambda: getattr(dc, dec)(flip_payload(stream),
                                             device="cpu"),
                    lambda: getattr(jdc, dec)(flip_payload(stream)))
        _both_raise(CorruptError,
                    lambda: getattr(dc, dec)(stream[:-7], device="cpu"),
                    lambda: getattr(jdc, dec)(stream[:-7]))
        framed = _frame_one_chunk(b"\x0cabcd" + bytes([(3 << 2) | 2, 9, 0]),
                                  b"abcdabcd")
        _both_raise(CorruptError,
                    lambda: getattr(dc, dec)(framed, device="cpu"),
                    lambda: getattr(jdc, dec)(framed))
    assert dc.decompress_framed(bytes(crc_flip), False, device="cpu") == data
    assert jdc.decompress_framed(bytes(crc_flip), False) == data


def flip_payload(stream: bytes) -> bytes:
    """The first compressed chunk's stream with a byte of its leading
    literal flipped: it still decodes, to the wrong bytes."""
    assert stream[10] == 0x00
    bad = bytearray(stream)
    bad[18 + 30] ^= 0x55
    return bytes(bad)


def _literal_element(chunk: bytes) -> bytes:
    """One literal holding the whole chunk: a valid element longer than
    any the encoders emit for compressible data."""
    from snappy_tpu_torch.spec import reference

    out = bytearray()
    reference.emit_literal(out, chunk)
    return bytes(out)


@pytest.mark.parametrize("guard", [True, False])
def test_jnp_encode_replacements(monkeypatch, guard):
    """The jnp encoder's host fallbacks: a row with ok=False takes the
    native element; with RATIO_GUARD a row longer than the native element
    does too (here every row is made an all-literal element), without it
    the long element stays and still decodes."""
    monkeypatch.setattr(dc, "PALLAS", False)
    monkeypatch.setattr(dc, "RATIO_GUARD", guard)
    counts = dict.fromkeys(dc.ENCODE_REPLACED, 0)
    monkeypatch.setattr(dc, "ENCODE_REPLACED", counts)
    data = (b"replace me " * 20_000)[:200_000]
    real = dc._epar.encode_blocks

    def spoiled(block, n, bmax):
        comp, clen, ok = real(block, n, bmax=bmax)
        for i in range(block.shape[0]):
            lit = _literal_element(block[i, : int(n[i])].numpy().tobytes())
            comp[i, : len(lit)] = torch.frombuffer(bytearray(lit),
                                                   dtype=torch.uint8)
            clen[i] = len(lit)
        ok[0] = False
        return comp, clen, ok

    monkeypatch.setattr(dc._epar, "encode_blocks", spoiled)
    stream = dc.compress_framed(data, device="cpu")
    n_chunks = -(-len(data) // 65536)
    batches = -(-n_chunks // dc.BATCH)
    assert counts["not_ok"] == batches
    if guard:
        assert stream == native.compress_framed(data)
        assert counts["ratio_guard"] == n_chunks - batches
    else:
        assert stream != native.compress_framed(data)
        assert counts["ratio_guard"] == 0
    assert native.decompress_framed(stream) == data


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


# ---------------------------------------------------------------------
# the seq engine's decode batches: a span of the stream each


@pytest.fixture
def seq_engine(monkeypatch):
    """The port on its device LZ engine (FLAT=0, HOST_PARSE=0), the JAX
    package on its id engine (the "seq" mode of ``mode``)."""
    monkeypatch.setattr(jdc, "_pallas_cache", True)
    monkeypatch.setattr(jdc, "FLAT_MODE", "id")
    monkeypatch.setattr(dc, "FLAT", False)
    monkeypatch.setattr(dc, "HOST_PARSE", False)


def _records(stream: bytes) -> list:
    """A framed stream's chunks after its stream identifier, each with
    its 4-byte header."""
    out, pos = [], 10
    while pos < len(stream):
        body = int.from_bytes(stream[pos + 1 : pos + 4], "little")
        out.append(stream[pos : pos + 4 + body])
        pos += 4 + body
    return out


def _chunk(ctype: int, body: bytes) -> bytes:
    return bytes((ctype,)) + len(body).to_bytes(3, "little") + body


def _stored_mix(nprng) -> bytes:
    """Five chunks: compressed, stored, compressed, stored, and a short
    stored last chunk."""
    text = b"a span of the stream " * 4000
    return (text[:65536] + nprng.bytes(65536) + text[5:65541]
            + nprng.bytes(65536) + nprng.bytes(1000))


def _decodes_like_jax(stream: bytes, want: bytes) -> None:
    """Both packages' framed decodes give ``want``, to the host and to
    the device."""
    assert jdc.decompress_framed(stream) == want
    assert dc.decompress_framed(stream, device="cpu") == want
    assert np.asarray(jdc.decompress_framed_to_device(stream)).tobytes() \
        == want
    assert dc.decompress_framed_to_device(
        stream, device="cpu").numpy().tobytes() == want


@pytest.mark.parametrize("width", [None, 2])
def test_seq_span_stored_chunks(seq_engine, nprng, monkeypatch, width):
    """Stored chunks mid-batch and a short stored last chunk: their rows
    are copied from the batch's span into place in one gather; at the
    engine's width (one batch) and at 2 rows a launch (three)."""
    if width:
        monkeypatch.setattr(dc, "_seq_width", lambda *a: width)
    data = _stored_mix(nprng)
    stream = native.compress_framed(data)
    assert [r[0] for r in _records(stream)] == [0, 1, 0, 1, 1]
    before = dict(dc.SEQ_STAGING)
    _decodes_like_jax(stream, data)
    # the host decode takes the two compressed chunks, the device decode
    # all five; no padded row
    assert dc.SEQ_STAGING["span_rows"] - before["span_rows"] == 2 + 5
    assert dc.SEQ_STAGING["padded_rows"] == before["padded_rows"]


def test_seq_span_with_chunks_between_payloads(seq_engine, nprng,
                                               monkeypatch):
    """Padding, skippable and repeated stream-identifier chunks between
    the payloads lie inside a batch's span; a padding chunk wider than
    the pinned buffer (5 rows x 66,560 B) ends a batch early."""
    data = _stored_mix(nprng)
    recs = _records(native.compress_framed(data))
    big = dc._DECODE_CMAX * len(recs) + 1
    extra = [_chunk(0xFE, bytes(300)), _chunk(0x80, nprng.bytes(77)),
             bytes(dc.STREAM_ID_CHUNK), _chunk(0xFE, bytes(big))]
    stream = bytes(dc.STREAM_ID_CHUNK) + b"".join(
        r + (extra[i] if i < len(extra) else b"")
        for i, r in enumerate(recs))
    widths = []
    real = dc._dispatch_seq

    def spy(src_arr, tab, *args, **kwargs):
        widths.append(tab.shape[1])
        return real(src_arr, tab, *args, **kwargs)

    monkeypatch.setattr(dc, "_dispatch_seq", spy)
    _decodes_like_jax(stream, data)
    # host decode: the compressed chunks 0 and 2 (the wide padding lies
    # after chunk 3); device decode: chunks 0-3, then chunk 4
    assert widths == [2, 4, 1]


@pytest.mark.parametrize("rows", [[0], [2], [4], [0, 2, 4]])
def test_seq_span_crc_flips(seq_engine, nprng, rows):
    """A CRC flipped in the first, a middle or the last row of a batch
    raises ChecksumError from both packages; verify_checksums=False
    decodes the bytes."""
    data = _stored_mix(nprng)
    recs = [bytearray(r) for r in _records(native.compress_framed(data))]
    for r in rows:
        recs[r][4] ^= 0x01
    stream = bytes(dc.STREAM_ID_CHUNK) + b"".join(map(bytes, recs))
    for dec in ("decompress_framed", "decompress_framed_to_device"):
        _both_raise(ChecksumError,
                    lambda: getattr(dc, dec)(stream, device="cpu"),
                    lambda: getattr(jdc, dec)(stream))
    assert dc.decompress_framed(stream, False, device="cpu") == data


def test_seq_span_decode_error_before_crc_error(seq_engine, nprng):
    """A row whose element stream fails (a copy before the block start)
    ahead of a later row with a flipped CRC raises CorruptError, from
    both packages."""
    data = _stored_mix(nprng)
    recs = [bytearray(r) for r in _records(native.compress_framed(data))]
    hdr = len(put_uvarint(65536))
    recs[2][8 + hdr] = (3 << 2) | 2  # chunk 2's first element: a copy
    recs[3][4] ^= 0x01
    stream = bytes(dc.STREAM_ID_CHUNK) + b"".join(map(bytes, recs))
    for dec in ("decompress_framed", "decompress_framed_to_device"):
        _both_raise(CorruptError,
                    lambda: getattr(dc, dec)(stream, device="cpu"),
                    lambda: getattr(jdc, dec)(stream))


def test_jnp_engine_stages_padded_rows(monkeypatch, nprng):
    """The jnp engine keeps its padded payload rows (counted as such)
    and decodes as the JAX package does."""
    monkeypatch.setattr(dc, "PALLAS", False)
    monkeypatch.setattr(dc, "HOST_PARSE", False)
    monkeypatch.setattr(jdc, "_pallas_cache", False)
    monkeypatch.setattr(jdc, "HOST_PARSE", False)
    data = _stored_mix(nprng)
    stream = native.compress_framed(data)
    before = dict(dc.SEQ_STAGING)
    _decodes_like_jax(stream, data)
    assert dc.SEQ_STAGING["padded_rows"] - before["padded_rows"] == 2 * 2
    assert dc.SEQ_STAGING["span_rows"] == before["span_rows"]
