"""The port without its native library against the JAX package without
its own: both packages' ``native.available()`` return False and every
public function of both native modules raises, so a path that still
calls the library fails here instead of quietly using it.  The port's
pure-Python CRC and reference encoder raise too: without the library
every CRC is the CRC kernel's (its plain version on the CPU) and the
jnp encoder's reference element the sequential encoder's.

Off the TPU the JAX package then takes its jnp engines, its host CRC and
its ``_oracle_block`` guard; the port its jnp engines (the seq engine
under FLAT=0 HOST_PARSE=0).  Each of the eight codec entry points, the
streams, the checkpoint, the CLI and the two degrading mesh forms give
the JAX package's bytes; broken streams raise the same error class; the
native-only mesh stagers raise in both.  Inputs stay at 256 KiB or less
a case (the JAX package's host CRC and oracle run at about 1.6 MB/s
here): a few 64 KiB chunks, a ragged tail, a stored chunk, an empty
stream.  Tolerance: byte equality."""

import importlib
import io

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import snappy_tpu.native as jnative
from snappy_tpu import checkpoint as jckpt
from snappy_tpu import errors as jerr
from snappy_tpu.cli.main import main as jax_main
from snappy_tpu.dist import mesh as jmesh
from snappy_tpu.runtime import device_codec as jdc
from snappy_tpu.runtime import stream as jstream
from snappy_tpu_torch import checkpoint as ckpt
from snappy_tpu_torch import errors as perr
from snappy_tpu_torch import native
from snappy_tpu_torch.cli.main import main
from snappy_tpu_torch.dist import mesh as tmesh
from snappy_tpu_torch.kernels import encode_par as kep
from snappy_tpu_torch.runtime import device_codec as dc
from snappy_tpu_torch.runtime import stream as tstream
from snappy_tpu_torch.spec import framing as pframing
from snappy_tpu_torch.spec import reference as pref
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

# the module, which the package's crc32c function shadows
pcrc = importlib.import_module("snappy_tpu_torch.spec.crc32c")

ENCODERS = ("compress_framed", "compress", "compress_framed_from_device",
            "compress_from_device")
DECODERS = ("decompress_framed", "decompress_framed_to_device",
            "decompress", "decompress_to_device")


class NativeCalled(RuntimeError):
    """A native function was called with the library switched off."""


def _switch_off(monkeypatch, module, calls: list) -> None:
    """``module.available()`` False and every public function of the
    module raising NativeCalled (its name appended to ``calls``)."""
    for name in dir(module):
        fn = getattr(module, name)
        if (name.startswith("_") or not callable(fn)
                or getattr(fn, "__module__", None) != module.__name__):
            continue

        def raiser(*args, _name=name, **kwargs):
            calls.append(f"{module.__name__}.{_name}")
            raise NativeCalled(_name)

        monkeypatch.setattr(module, name, raiser)
    monkeypatch.setattr(module, "available", lambda: False)


def _forbid(monkeypatch, module, name: str, calls: list) -> None:
    def raiser(*args, **kwargs):
        calls.append(f"{module.__name__}.{name}")
        raise AssertionError(f"{name} called on a chunk")

    monkeypatch.setattr(module, name, raiser)


@pytest.fixture(scope="module")
def streams():
    """The reference encoder's framed and raw streams of each input
    (the port's ``spec``), made before ``off`` forbids it."""
    return {name: (pframing.compress_framed(data), pref.compress(data))
            for name, data in _inputs().items()}


@pytest.fixture
def off(monkeypatch, streams):
    """Both native libraries off, the port's pure-Python CRC and
    reference encoder forbidden, the JAX package on its off-TPU engines.
    Yields the list of forbidden calls made; a test that ends with one
    in it fails."""
    calls: list = []
    _switch_off(monkeypatch, native, calls)
    _switch_off(monkeypatch, jnative, calls)
    _forbid(monkeypatch, pcrc, "crc32c", calls)
    _forbid(monkeypatch, pref, "encode_block", calls)
    monkeypatch.setattr(jdc, "_pallas_cache", False)
    counts = dict.fromkeys(dc.ENCODE_REPLACED, 0)
    monkeypatch.setattr(dc, "ENCODE_REPLACED", counts)
    yield calls
    assert calls == [], calls


def _inputs() -> dict:
    """Three full 64 KiB chunks (text; text into random; random, which
    the framed format stores) and a ragged 17,392-byte tail; a chunk of
    text; one byte; nothing."""
    rng = np.random.default_rng(1234)
    text = b"native off, on the card: " * 6000
    return {
        "mixed": text[:120_000] + rng.bytes(80_000) + text[:14_000],
        "text": text[:40_000],
        "one": b"x",
        "empty": b"",
    }


def _stored_at(stream: bytes, k: int) -> int:
    """The offset of byte k of the first stored chunk's payload."""
    chunks, _ = dc._scan_frames(stream)
    return next(ch for ch in chunks if ch[0] == 1)[1] + k


def _tensor(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


def _host(x) -> bytes:
    if isinstance(x, (torch.Tensor, jax.Array)):
        return np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                          else x).tobytes()
    return bytes(x)


def _port(name: str, arg):
    fn = getattr(dc, name)
    if name.endswith("from_device"):
        return fn(_tensor(arg))
    return fn(arg, device="cpu")


def _jax(name: str, arg):
    fn = getattr(jdc, name)
    if name.endswith("from_device"):
        return fn(jax.device_put(np.frombuffer(arg, np.uint8)))
    return fn(arg)


@pytest.mark.parametrize("entry", ENCODERS)
def test_encoders_match_jax(off, entry):
    """Each encoder's stream equals the JAX package's, and decodes."""
    framed = "framed" in entry
    for name, data in _inputs().items():
        got = _port(entry, data)
        assert got == _jax(entry, data), (entry, name)
        back = (dc.decompress_framed(got, device="cpu") if framed
                else pref.decompress(got))
        assert back == data, (entry, name)
    assert dc.ENCODE_REPLACED == {"not_ok": 0, "ratio_guard": 0}


@pytest.mark.parametrize("entry", DECODERS)
def test_decoders_match_jax(off, streams, entry):
    """Each decoder's bytes equal the JAX package's on the reference
    encoder's streams; the to-device forms return uint8 tensors."""
    framed = "framed" in entry
    for name, data in _inputs().items():
        stream = streams[name][0 if framed else 1]
        got = _port(entry, stream)
        if entry.endswith("to_device"):
            assert got.dtype == torch.uint8 and got.device.type == "cpu"
        assert _host(got) == _host(_jax(entry, stream)) == data, (entry, name)


def test_native_not_required(off):
    """The calls that raised SnappyError without the native library
    before the port degraded as the JAX package does: a framed compress
    and a raw decode to the device, now the JAX package's bytes."""
    assert dc.compress_framed(b"abc", device="cpu") == \
        jdc.compress_framed(b"abc")
    got = dc.decompress_to_device(b"\x03\x08abc", device="cpu")
    assert got.numpy().tobytes() == _host(
        jdc.decompress_to_device(b"\x03\x08abc")) == b"abc"


def _outcome(fn, errors):
    """("ok", bytes) of fn(), or ("error", class name) of what it raised
    from ``errors`` (any other exception propagates)."""
    try:
        return "ok", _host(fn())
    except errors.SnappyError as e:
        return "error", type(e).__name__


def _broken(stream: bytes, kind: str, lo: int) -> bytes:
    """``stream`` flipped, truncated or spliced at fixed places past
    byte ``lo`` (the raw preamble stays whole: a spliced length could
    ask either package for gigabytes)."""
    mut = bytearray(stream)
    mid = lo + (len(mut) - lo) // 2
    if kind == "flipped":
        mut[mid] ^= 0x5A
    elif kind == "truncated":
        mut = mut[:mid]
    else:
        mut[mid : mid + 40] = bytes(range(7, 47))
    return bytes(mut)


@pytest.mark.parametrize("kind", ["flipped", "truncated", "spliced"])
def test_broken_streams_raise_like_jax(off, streams, kind):
    """A flipped, truncated and spliced stream, framed and raw, at a few
    places each: every decoder gives the JAX package's outcome."""
    framed, raw = streams["mixed"]
    outcomes = set()
    for lo in (20, 65_000, 130_000):
        for entry in DECODERS:
            base = framed if "framed" in entry else raw
            bad = _broken(base, kind, min(lo, len(base) - 50))
            want = _outcome(lambda: _jax(entry, bad), jerr)
            got = _outcome(lambda: _port(entry, bad), perr)
            assert got == want, (entry, lo, got[0], want[0])
            outcomes.add(want[0])
    assert "error" in outcomes


def test_flipped_payload_byte_raises_checksum_error(off, streams):
    """A flipped byte in a stored chunk decodes: the CRC kernel's check
    raises ChecksumError with the JAX package's stored and computed
    values."""
    fr = bytearray(streams["mixed"][0])
    fr[_stored_at(bytes(fr), 100)] ^= 1
    with pytest.raises(perr.ChecksumError) as got:
        dc.decompress_framed(bytes(fr), device="cpu")
    with pytest.raises(jerr.ChecksumError) as want:
        jdc.decompress_framed(bytes(fr))
    assert (got.value.expected, got.value.actual) == \
        (want.value.expected, want.value.actual)
    assert got.value.actual is not None


def test_streams_match_jax(off):
    """FramedWriter (batches through compress_framed, the tail through
    compress with the record's CRC on the kernel) and FramedReader
    (each record through decompress) against the JAX package's streams
    on its jnp backend."""
    data = _inputs()["mixed"]
    sinks = []
    for mod, backend in ((tstream, "torch"), (jstream, "jnp")):
        sink = io.BytesIO()
        with mod.FramedWriter(sink, backend=backend) as w:
            for i in range(0, len(data), 50_000):
                w.write(data[i : i + 50_000])
        sinks.append(sink.getvalue())
    assert sinks[0] == sinks[1]
    r = tstream.FramedReader(io.BytesIO(sinks[0]), backend="torch")
    assert r.read(70_000) + r.read() == data
    bad = bytearray(sinks[0])
    bad[_stored_at(sinks[0], 5)] ^= 1
    with pytest.raises(perr.ChecksumError):
        tstream.FramedReader(io.BytesIO(bytes(bad)), backend="torch").read()
    with pytest.raises(jerr.ChecksumError):
        jstream.FramedReader(io.BytesIO(bytes(bad)), backend="jnp").read()


def test_checkpoint_matches_jax(off):
    """save_array / load_array: the JAX package's bytes, loaded back to
    the device and to the host."""
    rng = np.random.default_rng(7)
    arr = np.concatenate([np.zeros(20_000, np.float32),
                          rng.standard_normal(30_000).astype(np.float32)])
    blob = ckpt.save_array(torch.from_numpy(arr))
    assert blob == jckpt.save_array(jax.device_put(arr))
    for to_device in (True, False):
        back = ckpt.load_array(blob, to_device=to_device)
        assert back.dtype == torch.float32
        np.testing.assert_array_equal(back.cpu().numpy(), arr)


def test_cli_matches_jax(off, tmp_path):
    """The CLI's compress and decompress on the "torch" backend write the
    JAX CLI's files on its jnp backend."""
    src = tmp_path / "data.bin"
    src.write_bytes(_inputs()["mixed"])
    outs = {}
    for who, fn, backend in (("port", main, "torch"),
                             ("jax", jax_main, "jnp")):
        sz = tmp_path / f"{who}.sz"
        assert fn(["compress", str(src), "-o", str(sz), "-q",
                   "--backend", backend]) == 0
        dec = tmp_path / f"{who}.out"
        assert fn(["decompress", str(sz), "-o", str(dec), "-q",
                   "--backend", backend]) == 0
        outs[who] = (sz.read_bytes(), dec.read_bytes())
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == src.read_bytes()


@pytest.fixture
def meshes():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 jax devices")
    return jmesh.make_mesh(2), tmesh.make_mesh(devices=["cpu"] * 2)


def test_sharded_decompress_framed_to_device(off, streams, meshes):
    """The mesh loader: its id stager decodes each chunk on the host
    (the reference decoder; the JAX package's np decoder), the rows and
    lengths equal the JAX package's; a flipped stored byte raises
    ChecksumError in both."""
    jm, tm = meshes
    fr = streams["mixed"][0]
    rows, dlens, b = tmesh.sharded_decompress_framed_to_device(tm, fr)
    jrows, jdlens, jb = jmesh.sharded_decompress_framed_to_device(jm, fr)
    assert b == jb == 4 and rows.shape == (4, 65536)
    np.testing.assert_array_equal(dlens, jdlens)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    bad = bytearray(fr)
    bad[_stored_at(fr, 7)] ^= 1
    with pytest.raises(perr.ChecksumError):
        tmesh.sharded_decompress_framed_to_device(tm, bytes(bad))
    with pytest.raises(jerr.ChecksumError):
        jmesh.sharded_decompress_framed_to_device(jm, bytes(bad))


@pytest.mark.parametrize("case", ["loader", "short_middle"])
def test_sharded_encode_rows_to_chunks(off, streams, meshes, case):
    """From-device encode over the mesh: each shard's chunks take the
    sequential encoder's element (the JAX package's per-chunk oracle),
    their CRCs the shard's CRC launch; records and stream equal JAX's."""
    jm, tm = meshes
    data = _inputs()["mixed"]
    if case == "loader":
        rows, lens, _ = tmesh.sharded_decompress_framed_to_device(
            tm, streams["mixed"][0])
        host = rows.numpy()
    else:
        lens = np.array([65536, 1000, 65536], np.int32)
        host = np.zeros((4, 65536), np.uint8)
        for i, ln in enumerate(lens):
            host[i, :ln] = np.frombuffer(data[i * 60_000 : i * 60_000 + ln],
                                         np.uint8)
        rows = torch.from_numpy(host)
    jrows = jax.device_put(host, NamedSharding(jm, P("d")))
    recs = tmesh.sharded_encode_rows_to_chunks(tm, rows, lens)
    assert recs == jmesh.sharded_encode_rows_to_chunks(jm, jrows, lens)
    fr = tmesh.sharded_compress_framed_from_device(tm, rows, lens)
    assert fr == jmesh.sharded_compress_framed_from_device(jm, jrows, lens)
    want = b"".join(host[i, :ln].tobytes() for i, ln in enumerate(lens))
    assert dc.decompress_framed(fr, device="cpu") == want


@pytest.mark.parametrize("stager", ["stage_flat_dec_batch",
                                    "stage_flat_enc_batch",
                                    "stage_dec_id_batch"])
def test_native_only_stagers_raise(off, stager):
    """The flat and id stagers need the native library in both packages:
    the port raises SnappyError, the JAX package its library's error."""
    arg = [b"\x03\x08abc" if stager != "stage_flat_enc_batch" else b"abc"]
    with pytest.raises(perr.SnappyError):
        getattr(tmesh, stager)(arg)
    with pytest.raises(NativeCalled):
        getattr(jmesh, stager)(arg)
    off.clear()  # the JAX stager's call was the point


@pytest.mark.parametrize("flat,host_parse,pallas,engine", [
    (True, True, True, "jnp"), (False, True, True, "jnp"),
    (False, False, True, "seq"), (True, True, False, "jnp"),
    (True, False, False, "jnp")])
def test_engine_pick(off, streams, monkeypatch, flat, host_parse, pallas,
                     engine):
    """The module docstring's "native off" column: jnp whatever FLAT,
    FLAT_MODE or HOST_PARSE say, but the seq engine under FLAT=0
    HOST_PARSE=0, which needs no native call either: its streams are the
    reference encoder's (the port's ``spec.framing``) and decode."""
    monkeypatch.setattr(dc, "FLAT", flat)
    monkeypatch.setattr(dc, "HOST_PARSE", host_parse)
    monkeypatch.setattr(dc, "PALLAS", pallas)
    for mode in ("id", "classify"):
        monkeypatch.setattr(dc, "FLAT_MODE", mode)
        assert dc._decode_engine(True) == dc._decode_engine(False) == engine
        assert dc._encode_engine() == engine
    if engine == "seq":
        data = _inputs()["mixed"]
        want = streams["mixed"][0]
        fr = dc.compress_framed(data, device="cpu")
        assert fr == want
        assert dc.compress_framed_from_device(_tensor(data)) == want
        assert dc.decompress_framed(fr, device="cpu") == data
        assert dc.decompress_framed_to_device(
            fr, device="cpu").numpy().tobytes() == data


@pytest.mark.parametrize("guard", [True, False])
def test_rows_not_certified_take_the_reference(off, streams, monkeypatch,
                                               guard):
    """A row the jnp encoder cannot certify (ok=False) takes the
    sequential encoder's element, with RATIO_GUARD on (launched beside
    the encoder) and off (launched for the batch then), counted in
    ENCODE_REPLACED["not_ok"]: the stream is the reference encoder's."""
    real = kep.encode_blocks

    def uncertified(*args, **kwargs):
        comp, clens, ok = real(*args, **kwargs)
        return comp, clens, torch.zeros_like(ok)

    monkeypatch.setattr(kep, "encode_blocks", uncertified)
    monkeypatch.setattr(dc, "RATIO_GUARD", guard)
    data = _inputs()["mixed"]
    assert dc.compress(data, device="cpu") == streams["mixed"][1]
    assert dc.ENCODE_REPLACED == {"not_ok": 4, "ratio_guard": 0}


def test_ratio_guard_takes_the_shorter_reference(off, streams, monkeypatch):
    """RATIO_GUARD: a row whose element is longer than the reference
    element takes the reference's, fetched from the sequential encoder's
    launch.  The jnp encoder here emits every row as one literal: the
    three compressible rows take the reference element, the random row
    keeps its own (the reference's is as long), and the stream is the
    reference encoder's."""
    def literal_only(rows, lens, bmax):
        elems = []
        for row, n in zip(rows.cpu().numpy(), lens.tolist()):
            out = bytearray()
            pref.emit_literal(out, row[:n].tobytes())
            elems.append(bytes(out))
        comp = np.zeros((len(elems), bmax + 8), np.uint8)
        for i, e in enumerate(elems):
            comp[i, : len(e)] = np.frombuffer(e, np.uint8)
        return (torch.from_numpy(comp).to(rows.device),
                torch.tensor([len(e) for e in elems], dtype=torch.int32,
                             device=rows.device),
                torch.ones(len(elems), dtype=torch.bool, device=rows.device))

    monkeypatch.setattr(kep, "encode_blocks", literal_only)
    assert dc.compress(_inputs()["mixed"], device="cpu") == \
        streams["mixed"][1]
    assert dc.ENCODE_REPLACED == {"not_ok": 0, "ratio_guard": 3}
