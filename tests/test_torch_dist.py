"""The port's mesh codec (``snappy_tpu_torch.dist.mesh``) against the JAX
package's (``snappy_tpu.dist.mesh``): the same seeded numpy inputs go
through JAX on its virtual 8-device CPU mesh (tests/conftest.py) and the
port on ``make_mesh(devices=["cpu"] * 8)``, where each shard runs the
kernels' plain versions.  The cases of tests/test_dist.py's flat and id
engines, plus the layout, the from-device encode and the match finder.
Tolerance: 0 (byte-exact: outputs, error vectors and framed bytes are
integers)."""

import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from snappy_tpu.dist import mesh as jmesh
from snappy_tpu.errors import SnappyError as JSnappyError
from snappy_tpu.runtime import device_codec as jdc
from snappy_tpu_torch import native
from snappy_tpu_torch.dist import mesh as tmesh
from snappy_tpu_torch.errors import ChecksumError, CorruptError, SnappyError
from snappy_tpu_torch.kernels import match as km
from snappy_tpu.kernels import encode_np
from snappy_tpu.spec import reference
from snappy_tpu.spec.format import read_uvarint


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 jax devices")
    return jmesh.make_mesh(8), tmesh.make_mesh(devices=["cpu"] * 8)


@pytest.fixture
def rng():
    return random.Random(1234)


def _mk_batch(rng, n_blocks, bmax):
    """tests/test_dist.py's batch: text, random and run-length rows."""
    blocks = np.zeros((n_blocks, bmax), dtype=np.uint8)
    lens = np.zeros(n_blocks, dtype=np.int32)
    for i in range(n_blocks):
        kind = i % 3
        if kind == 0:
            row = (b"mesh sharded block data " * 60)[: bmax - i]
        elif kind == 1:
            row = rng.randbytes(bmax // 2 + i)
        else:
            row = b"R" * (bmax // 3)
        blocks[i, : len(row)] = np.frombuffer(row, dtype=np.uint8)
        lens[i] = len(row)
    return blocks, lens


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            assert x == y
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("rows,n", [(8, 8), (16, 8), (6, 2), (9, 3), (4, 1)])
def test_layout_matches_named_sharding(rows, n):
    """Shard k of ``shard_rows`` holds the rows JAX's P("d") puts on
    device k, and ``numpy()`` joins them back in order."""
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} jax devices")
    x = np.arange(rows * 5, dtype=np.int32).reshape(rows, 5)
    jarr = jax.device_put(x, NamedSharding(jmesh.make_mesh(n), P("d")))
    want = sorted((s.index[0].start or 0, np.asarray(s.data))
                  for s in jarr.addressable_shards)
    sr = tmesh.shard_rows(tmesh.make_mesh(devices=["cpu"] * n), x)
    assert sr.shape == x.shape and sr.dtype == torch.int32
    for (_start, data), shard in zip(want, sr.shards):
        np.testing.assert_array_equal(shard.numpy(), data)
    np.testing.assert_array_equal(sr.numpy(), x)
    # laying it out again over another mesh keeps the rows
    other = tmesh.shard_rows(tmesh.make_mesh(devices=["cpu"] * 1), sr)
    np.testing.assert_array_equal(other.numpy(), x)


@pytest.mark.parametrize("b", [1, 7, 8, 12, 16])
def test_pad_to_mesh_matches(meshes, b):
    jm, tm = meshes
    a = np.arange(b * 3, dtype=np.int32).reshape(b, 3)
    c = np.arange(b, dtype=np.uint32)
    (ja, jc), jb = jmesh._pad_to_mesh(jm, a, c)
    (ta, tc), tb = tmesh._pad_to_mesh(tm, a, c)
    assert jb == tb == b
    _equal((ja, jc), (ta, tc))


def test_make_mesh(monkeypatch):
    m = tmesh.make_mesh(devices=["cpu", "cpu"])
    assert m.size == 2 and m.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        tmesh.make_mesh(devices=[])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()  # never falls back to the CPU
    with pytest.raises(ValueError, match="do not split"):
        tmesh.shard_rows(m, np.zeros((3, 4), np.uint8))


@pytest.mark.parametrize("n_blocks", [16, 13])
def test_sharded_encode_matches_jax(rng, meshes, n_blocks):
    """tests/test_dist.py's sharded encode (13 blocks: padded to the
    mesh): emissions, lengths and flags equal JAX's and encode_np's."""
    jm, tm = meshes
    bmax = 2048
    blocks, lens = _mk_batch(rng, n_blocks, bmax)
    got = tmesh.sharded_encode(tm, blocks, lens, bmax)
    want = jmesh.sharded_encode(jm, blocks, lens, bmax)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    comp, clen, ok = got
    assert ok.all()
    for i in range(n_blocks):
        assert comp[i, : clen[i]].tobytes() == encode_np.encode_block_np(
            blocks[i, : lens[i]].tobytes())


def test_roundtrip_step_matches_jax(rng, meshes):
    """The encode -> scan -> decode step: all seven results equal JAX's;
    ok everywhere, no error, match, offsets the exclusive scan."""
    jm, tm = meshes
    bmax = 2048
    blocks, lens = _mk_batch(rng, 16, bmax)
    got = tmesh.roundtrip_step(tm, blocks, lens, bmax)
    want = jmesh.roundtrip_step(jm, blocks, lens, bmax)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    comp, clen, ok, offsets, out, err, match = got
    assert isinstance(comp, tmesh.ShardedRows) and len(comp.shards) == 8
    assert offsets.device == tm.devices[0] and bool(match)
    cl = np.asarray(clen)
    assert np.asarray(ok).all() and not np.asarray(err).any()
    assert (offsets.numpy() == np.cumsum(cl) - cl).all()


def test_sharded_decode_matches_jax(rng, meshes):
    jm, tm = meshes
    samples = [rng.randbytes(500), b"Q" * 1500, (b"ab" * 900)[:1800]] * 4
    samples += [b"", b"\x01\x00"]  # an empty block, a broken element
    cmax = 2048
    B = len(samples)
    comp = np.zeros((B, cmax), dtype=np.uint8)
    starts = np.zeros(B, dtype=np.int32)
    clens = np.zeros(B, dtype=np.int32)
    dlens = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(samples):
        c = reference.compress(s) if i < B - 1 else b"\x04\x0cab"
        comp[i, : len(c)] = np.frombuffer(c, dtype=np.uint8)
        d, h = read_uvarint(c, 0)
        starts[i], clens[i], dlens[i] = h, len(c), d
    out, err = tmesh.sharded_decode(tm, comp, starts, clens, dlens,
                                    out_max=2048)
    jout, jerr = jmesh.sharded_decode(jm, comp, starts, clens, dlens,
                                      out_max=2048)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(err, jerr)
    assert (err[:-1] == 0).all() and err[-1] != 0
    for i, s in enumerate(samples[:-1]):
        assert out[i, : len(s)].tobytes() == s


def test_sharded_flat_engines_bit_exact(rng, meshes):
    """The flat engines sharded over the mesh: the stagers' arrays, the
    device emission and the decode with its CRC flags equal JAX's, the
    emission equals the host encoder, and 1 or 8 shards give the same
    bytes."""
    jm, tm = meshes
    blocks = [
        (b"sharded flat engine block " * 80)[:2048],
        rng.randbytes(2048),
        b"Q" * 1500,
        (b"ab" * 2000)[:1400],
        rng.randbytes(50) + b"x" * 900,
        b"",
    ]
    est = tmesh.stage_flat_enc_batch(blocks)
    _equal(est, jmesh.stage_flat_enc_batch(blocks))
    eb, emeta, efst, entr, clens, _hdrs, elems = est
    emis = tmesh.sharded_encode_flat(tm, eb, emeta, efst, entr)
    np.testing.assert_array_equal(
        emis, jmesh.sharded_encode_flat(jm, eb, emeta, efst, entr))
    for i, blk in enumerate(blocks):
        assert emis[i, : clens[i]].tobytes() == elems[i] == native.compress(blk)

    dst = tmesh.stage_flat_dec_batch(elems)
    _equal(dst, jmesh.stage_flat_dec_batch(elems))
    out8, err8 = tmesh.sharded_decode_flat(tm, *dst, out_max=65536)
    jout, jerr = jmesh.sharded_decode_flat(jm, *dst, out_max=65536)
    np.testing.assert_array_equal(out8, jout)
    np.testing.assert_array_equal(err8, jerr)
    assert (err8 == 0).all()
    out1, err1 = tmesh.sharded_decode_flat(
        tmesh.make_mesh(devices=["cpu"]), *dst, out_max=65536)
    assert (err1 == 0).all() and (out1 == out8).all()
    for i, blk in enumerate(blocks):
        assert out8[i, : len(blk)].tobytes() == blk


def test_sharded_flat_decode_crc_flags_corruption(rng, meshes):
    """A wrong expected CRC on one shard surfaces as err 100 on that row
    only, as in JAX; a narrower output skips the CRC, as in JAX."""
    jm, tm = meshes
    blocks = [rng.randbytes(1024) for _ in range(8)]
    elems = [native.compress(b) for b in blocks]
    db, dmeta, dfst, dntr, dlens, want = tmesh.stage_flat_dec_batch(elems)
    want = want.copy()
    want[3] ^= 0xDEAD
    for out_max in (65536, 2048):
        args = (db, dmeta, dfst, dntr, dlens, want)
        out, err = tmesh.sharded_decode_flat(tm, *args, out_max=out_max)
        jout, jerr = jmesh.sharded_decode_flat(jm, *args, out_max=out_max)
        np.testing.assert_array_equal(out, jout)
        np.testing.assert_array_equal(err, jerr)
    out, err = tmesh.sharded_decode_flat(tm, db, dmeta, dfst, dntr, dlens,
                                         want, out_max=65536)
    assert err[3] == 100 and (np.delete(err, 3) == 0).all()


def test_stagers_reject_what_jax_rejects(meshes):
    bad = native.compress(b"abcd" * 300)[:-7]  # an element cut short
    with pytest.raises(CorruptError):
        tmesh.stage_dec_id_batch([bad])
    with pytest.raises(JSnappyError):
        jmesh.stage_dec_id_batch([bad])
    with pytest.raises(SnappyError):
        tmesh.stage_flat_dec_batch([bad])


def test_sharded_id_decode_and_enc_crc(rng, meshes):
    """The id engine over the mesh: staged images and CRC flags equal
    JAX's, 12 blocks (not a mesh multiple) give the same bytes on 1 and
    8 shards, a flipped staged byte flags its row only, and the encode
    side's CRCs equal JAX's and the host's."""
    jm, tm = meshes
    bmax = 4096
    blocks, lens = _mk_batch(rng, 12, bmax)
    raw = [blocks[i, : lens[i]].tobytes() for i in range(12)]
    elems = [native.compress(b) for b in raw]

    staged = tmesh.stage_dec_id_batch(elems)
    _equal(staged, jmesh.stage_dec_id_batch(elems))
    ib, idlens, iwant = staged
    out8, err8 = tmesh.sharded_decode_id(tm, ib, idlens, iwant)
    jout, jerr = jmesh.sharded_decode_id(jm, ib, idlens, iwant)
    np.testing.assert_array_equal(out8, jout)
    np.testing.assert_array_equal(err8, jerr)
    assert out8.shape == (12, 65536) and (err8 == 0).all()
    out1, err1 = tmesh.sharded_decode_id(
        tmesh.make_mesh(devices=["cpu"]), ib, idlens, iwant)
    assert (out8 == out1).all() and (err1 == 0).all()
    for i, b in enumerate(raw):
        assert out8[i, : len(b)].tobytes() == b

    ib_bad = ib.copy()
    ib_bad[3, 100] ^= 0xFF
    _, errb = tmesh.sharded_decode_id(tm, ib_bad, idlens, iwant)
    _, jerrb = jmesh.sharded_decode_id(jm, ib_bad, idlens, iwant)
    np.testing.assert_array_equal(errb, jerrb)
    assert errb[3] == 100 and (np.delete(errb, 3) == 0).all()

    blocks64 = np.zeros((12, 65536), np.uint8)
    blocks64[:, :bmax] = blocks
    crcs = tmesh.sharded_crc(tm, blocks64, lens)
    assert crcs.dtype == np.uint32
    np.testing.assert_array_equal(crcs, jmesh.sharded_crc(jm, blocks64, lens))
    for i, b in enumerate(raw):
        assert int(crcs[i]) == native.crc32c(b)


def _stream(rng, n=170_000):
    return (b"sharded loader " * 9000)[:100_000] + rng.randbytes(n - 100_000)


def test_sharded_framed_to_device_loader(rng, meshes):
    """The mesh data loader: rows, lengths and counts equal JAX's on 8
    shards and on 1; a flipped payload byte never decodes."""
    jm, tm = meshes
    data = _stream(rng)
    fr = native.compress_framed(data)
    rows8, dlens, b = tmesh.sharded_decompress_framed_to_device(tm, fr)
    jrows, jdlens, jb = jmesh.sharded_decompress_framed_to_device(jm, fr)
    assert isinstance(rows8, tmesh.ShardedRows) and rows8.mesh is tm
    assert b == jb == 3 and rows8.shape == (8, 65536)
    np.testing.assert_array_equal(dlens, jdlens)
    np.testing.assert_array_equal(rows8.numpy(), np.asarray(jrows))
    got = rows8.numpy()
    assert b"".join(got[i, : dlens[i]].tobytes() for i in range(b)) == data
    rows1, dlens1, b1 = tmesh.sharded_decompress_framed_to_device(
        tmesh.make_mesh(devices=["cpu"]), fr)
    assert b1 == b and (dlens1 == dlens).all()
    assert (rows1.numpy()[:b] == got[:b]).all()

    # a chunk range: the rows of those chunks only
    rows_r, dl_r, b_r = tmesh.sharded_decompress_framed_to_device(
        tm, fr, chunk_range=(1, 2))
    jr, jdl, jb_r = jmesh.sharded_decompress_framed_to_device(
        jm, fr, chunk_range=(1, 2))
    assert b_r == jb_r == 2
    np.testing.assert_array_equal(dl_r, jdl)
    np.testing.assert_array_equal(rows_r.numpy(), np.asarray(jr))

    bad = bytearray(fr)
    bad[40] ^= 0xFF  # the first chunk's first payload byte
    with pytest.raises((ChecksumError, CorruptError)):
        tmesh.sharded_decompress_framed_to_device(tm, bytes(bad))


def test_loader_checksum_error(meshes):
    """A flipped byte that still decodes is caught by the shard's CRC."""
    _, tm = meshes
    # an incompressible chunk is stored: flip a byte of its payload
    fr = bytearray(native.compress_framed(np.random.default_rng(5).integers(
        0, 256, 100_000, dtype=np.uint8).tobytes()))
    fr[10 + 8 + 5] ^= 1  # stream id, chunk header and CRC, 5 bytes in
    with pytest.raises(ChecksumError):
        tmesh.sharded_decompress_framed_to_device(tm, bytes(fr))
    rows, _, _ = tmesh.sharded_decompress_framed_to_device(
        tm, bytes(fr), verify_checksums=False)
    assert rows.shape == (8, 65536)


@pytest.mark.parametrize("case", ["loader", "short_middle", "padded", "empty"])
def test_sharded_compress_framed_from_device(rng, meshes, case):
    """From-device encode over the mesh: the stream and the per-chunk
    records equal JAX's; the loader's rows come back as their stream."""
    jm, tm = meshes
    data = _stream(rng, 200_000)
    if case == "loader":
        rows, lens, _ = tmesh.sharded_decompress_framed_to_device(
            tm, native.compress_framed(data))
        host = rows.numpy()
    else:
        n = {"short_middle": 5, "padded": 3, "empty": 0}[case]
        host = np.zeros((8 if n else 0, 65536), np.uint8)
        lens = np.array([65536, 1000, 65536, 70, 33][:n], np.int32)
        if case == "padded":
            lens = np.array([65536, 65536, 4000], np.int32)
        for i, ln in enumerate(lens):
            host[i, :ln] = np.frombuffer(data[i * 3000 : i * 3000 + ln]
                                         .ljust(ln, b"z"), np.uint8)
        rows = torch.from_numpy(host)
    jrows = jax.device_put(host, NamedSharding(jm, P("d")))
    fr = tmesh.sharded_compress_framed_from_device(tm, rows, lens)
    assert fr == jmesh.sharded_compress_framed_from_device(jm, jrows, lens)
    recs = tmesh.sharded_encode_rows_to_chunks(tm, rows, lens)
    assert recs == jmesh.sharded_encode_rows_to_chunks(jm, jrows, lens)
    assert len(recs) == len(lens)
    if case == "loader":
        assert fr == native.compress_framed(data)
    want = b"".join(host[i, :ln].tobytes() for i, ln in enumerate(lens))
    assert native.decompress_framed(fr) == want


def test_from_device_rejects_bad_rows(meshes):
    _, tm = meshes
    with pytest.raises(ValueError):
        tmesh.sharded_compress_framed_from_device(
            tm, torch.zeros(8, 4096, dtype=torch.uint8), [10])
    with pytest.raises(ValueError):
        tmesh.sharded_compress_framed_from_device(
            tm, torch.zeros(8, 65536, dtype=torch.uint8), [1] * 9)


def test_sharded_match(rng, meshes):
    """The match finder over the mesh: candidates equal JAX's (its
    kernel in interpret mode) and the port's own unsharded finder."""
    jm, tm = meshes
    blocks = [(b"match me " * 500)[:3000], rng.randbytes(4096), b"",
              b"abcabcabd" * 300]
    got = tmesh.sharded_match(tm, blocks)
    assert got.shape == (4, 4096) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jmesh.sharded_match(jm, blocks))
    np.testing.assert_array_equal(
        got, km.find_candidates_device(blocks, 4096, device="cpu"))
    np.testing.assert_array_equal(
        tmesh.sharded_match(tmesh.make_mesh(devices=["cpu"] * 3), blocks), got)


def test_jax_id_engine_stream_is_native(rng, monkeypatch):
    """The loader tests decode native.compress_framed streams: with its
    id engine forced, the JAX package writes the same stream."""
    monkeypatch.setattr(jdc, "_pallas_cache", True)
    monkeypatch.setattr(jdc, "FLAT_MODE", "id")
    data = _stream(rng)
    assert jdc.compress_framed(data) == native.compress_framed(data)
