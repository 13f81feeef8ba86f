"""Corruption, truncation and hostile-stream sweeps through the torch
port's framed decode entry points, against the JAX package's id engine
(flat engine forced), outcome for outcome: the same decoded bytes, or
an error of the same class.  Messages are not compared: they differ
between engines, in the JAX package too.  No mutation may return wrong
bytes.

Counterpart of ``tests/test_framed_fuzz.py``: the port's engines are
id, classify and the device LZ engine "seq" against the JAX id engine,
and the hybrid and jnp engines (SNAPPY_TPU_PALLAS=0) against the JAX
package's own with its kernel engines off.  On the CPU the kernels'
plain versions run;
``tests/test_torch_cuda.py::test_mutation_sweep_on_card`` sends mutated
streams through the kernels on the card."""

import random

import pytest
import torch

from snappy_tpu import errors as jerr
from snappy_tpu.runtime import device_codec as jdc
from snappy_tpu.spec.crc32c import crc32c
from snappy_tpu.spec.format import mask_crc, put_uvarint
from snappy_tpu_torch import errors as perr
from snappy_tpu_torch.runtime import device_codec as dc
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ENTRIES = ("decompress_framed", "decompress_framed_to_device")
HEADER = b"\xff\x06\x00\x00sNaPpY"


@pytest.fixture(params=("id", "classify", "seq", "hybrid", "jnp"))
def engine(request, monkeypatch):
    """The port in one runtime engine.  id, classify, seq: the JAX
    package on its id engine with the flat engine forced (off the TPU it
    would pick the jnp engines; its own FLAT=0 engines are not the
    port's).  hybrid, jnp: both packages with their kernel engines off
    (JAX's _pallas_cache, the port's PALLAS), HOST_PARSE on or off."""
    if request.param in ("hybrid", "jnp"):
        monkeypatch.setattr(jdc, "_pallas_cache", False)
        monkeypatch.setattr(dc, "PALLAS", False)
        for mod in (jdc, dc):
            monkeypatch.setattr(mod, "HOST_PARSE", request.param == "hybrid")
        return request.param
    monkeypatch.setattr(jdc, "_pallas_cache", True)
    monkeypatch.setattr(jdc, "FLAT_MODE", "id")
    if request.param == "seq":
        monkeypatch.setattr(dc, "FLAT", False)
        monkeypatch.setattr(dc, "HOST_PARSE", False)
    else:
        monkeypatch.setattr(dc, "FLAT_MODE", request.param)
    return request.param


def _outcome(fn, errors):
    """("ok", bytes) of fn(), or ("error", class name) of what it raised
    from ``errors`` (any other exception propagates)."""
    try:
        out = fn()
    except errors.SnappyError as e:
        return "error", type(e).__name__
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy().tobytes()
    return "ok", bytes(out)


def _check(stream: bytes, device="cpu", verify=True, data=None):
    """Every port entry point gives JAX's outcome for ``stream``; with
    ``data``, an ok outcome must be ``data`` itself."""
    want = _outcome(lambda: jdc.decompress_framed(stream, verify), jerr)
    if data is not None and want[0] == "ok":
        assert want[1] == data
    for entry in ENTRIES:
        got = _outcome(lambda: getattr(dc, entry)(stream, verify,
                                                  device=device), perr)
        assert got == want, (entry, verify, got[0], want[0],
                             got[1] if got[0] == "error" else len(got[1]),
                             want[1] if want[0] == "error" else len(want[1]))


def _mutations(framed: bytes, rng: random.Random, n: int):
    """The JAX sweep's mutations: flip a byte, truncate, splice a run of
    garbage, in turn."""
    for k in range(n):
        mut = bytearray(framed)
        kind = k % 3
        if kind == 0:
            i = rng.randrange(len(mut))
            mut[i] ^= rng.randrange(1, 256)
        elif kind == 1:
            mut = mut[: rng.randrange(1, len(mut))]
        else:
            i = rng.randrange(len(mut))
            n_run = min(len(mut) - i, rng.randrange(1, 64))
            mut[i : i + n_run] = rng.randbytes(n_run)
        yield bytes(mut)


@pytest.fixture
def corpus(rng):
    """Two chunks: a compressible 64 KiB one and a stored one."""
    data = (b"fuzz corpus line " * 5000)[:70000] + rng.randbytes(40000)
    return data, jdc.compress_framed(data)


@pytest.mark.parametrize("part", range(3))
def test_mutation_sweep(engine, corpus, part):
    """Mutations 30 * part .. 30 * part + 29 of the sweep (seeded per
    part), through both entry points, checksums verified."""
    data, framed = corpus
    for mut in _mutations(framed, random.Random(7000 + part), 30):
        _check(mut, data=data)


def test_mutation_sweep_no_checksums(engine, corpus):
    """verify_checksums=False: the CRC no longer catches a flipped
    payload byte, so only the structure decides; the outcome still
    matches JAX's."""
    data, framed = corpus
    for mut in _mutations(framed, random.Random(7100), 24):
        _check(mut, verify=False)


def _chunk(ctype: int, body: bytes) -> bytes:
    n = len(body)
    return bytes((ctype, n & 255, (n >> 8) & 255, n >> 16)) + body


def _compressed(payload: bytes, data: bytes) -> bytes:
    """A compressed chunk whose CRC is data's (the decode, not the CRC,
    must catch a broken payload)."""
    return _chunk(0x00, mask_crc(crc32c(data)).to_bytes(4, "little")
                  + payload)


def _stored(data: bytes) -> bytes:
    return _chunk(0x01, mask_crc(crc32c(data)).to_bytes(4, "little") + data)


LIT = b"\x0cabcd"  # a 4-byte literal element
GOOD = _compressed(put_uvarint(4) + LIT, b"abcd")


def _hostile_streams() -> dict:
    """Sixteen hand-made framed streams, each at one edge of the format."""
    return {
        "empty compressed payload": HEADER + _compressed(b"", b""),
        "payload shorter than its varint": HEADER + _compressed(
            put_uvarint(10) + LIT, b"abcd"),
        "trailing bytes after the element": HEADER + _compressed(
            put_uvarint(4) + LIT + b"xyz", b"abcd"),
        "varint 0 then an element": HEADER + _compressed(
            put_uvarint(0) + LIT, b""),
        "literal past the payload end": HEADER + _compressed(
            put_uvarint(8) + b"\x1cabc", b"abc"),
        "copy offset 0": HEADER + _compressed(
            put_uvarint(8) + LIT + bytes([(3 << 2) | 1, 0]), b"abcdabcd"),
        "copy before the block start": HEADER + _compressed(
            put_uvarint(8) + LIT + bytes([(3 << 2) | 2, 9, 0]), b"abcdabcd"),
        "padding chunk between chunks": HEADER + GOOD + _chunk(0xFE, bytes(9))
        + GOOD,
        "skippable chunk": HEADER + _chunk(0x80, b"skip me") + GOOD,
        "stream identifier again": HEADER + GOOD + HEADER + GOOD,
        "bad stream identifier later": HEADER + GOOD + b"\xff\x06\x00\x00sNaPpX",
        "reserved unskippable chunk": HEADER + _chunk(0x02, b"????") + GOOD,
        "stored chunk over 64 KiB": HEADER + _stored(bytes(65537)),
        "compressed body under 4 bytes": HEADER + _chunk(0x00, b"\x01\x02"),
        "stored body under 4 bytes": HEADER + _chunk(0x01, b"\x01"),
        "truncated chunk header": HEADER + GOOD + b"\x00\x05\x00",
    }


@pytest.mark.parametrize("verify", [True, False])
@pytest.mark.parametrize("name", sorted(_hostile_streams()))
def test_hostile_streams(engine, name, verify):
    _check(_hostile_streams()[name], verify=verify)


def test_hostile_streams_cover_every_error_class():
    outcomes = {_outcome(lambda s=s: jdc.decompress_framed(s), jerr)[1]
                for s in _hostile_streams().values()}
    outcomes = {o for o in outcomes if isinstance(o, str)}
    assert {"BadMagicError", "CorruptError", "UnsupportedError"} <= outcomes
