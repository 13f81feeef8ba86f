"""CUDA kernels of the torch port on the card: each kernel against its
plain PyTorch version and the native codec, and the main path through
the kernels in every runtime mode.  Tolerance: 0 (bit-exact).

This file imports no jax, so it runs where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(tests/conftest.py imports jax).  Without a GPU every test skips."""

import numpy as np
import pytest
import torch

from snappy_tpu_torch import native
from snappy_tpu_torch.bench.corpus import make_corpus
from snappy_tpu.kernels import match_np
from snappy_tpu_torch.kernels import crc32c as kc
from snappy_tpu_torch.spec.format import put_uvarint, read_uvarint
from snappy_tpu_torch.kernels import decode_flat as kf
from snappy_tpu_torch.kernels import decode_pretagged as kp
from snappy_tpu_torch.kernels import decode_seq as kds
from snappy_tpu_torch.kernels import decode_wavegroup as kw
from snappy_tpu_torch.kernels import encode_flat as ke
from snappy_tpu_torch.kernels import encode_seq as kes
from snappy_tpu_torch.kernels import frame_records as kfr
from snappy_tpu_torch.kernels import match as km
from snappy_tpu_torch.runtime import device_codec as dc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda:0")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _corpus(seed, total=2 << 20):
    return b"".join(d for _, d in make_corpus(total, seed=seed))


def _native_crcs(rows, lengths):
    return np.array([native.crc32c(rows[i, :n].tobytes())
                     for i, n in enumerate(lengths)], np.int64)


def test_crc_kernel_matches_plain_and_native(cuda_device, rng):
    lengths = np.array([0, 1, 7, 255, 256, 257, 4096, 65535, 65536, 12345]
                       + list(rng.integers(0, 65537, 54)), np.int32)
    rows = rng.integers(0, 256, (len(lengths), kc.CHUNK), dtype=np.uint8)
    rows_d = torch.from_numpy(rows).to(cuda_device)
    lens_d = torch.from_numpy(lengths).to(cuda_device)
    before = kc.launches
    got = kc.crc32c_chunks(rows_d, lens_d)
    torch.cuda.synchronize()
    assert kc.launches == before + 1
    assert torch.equal(got, kc.crc32c_chunks_plain(rows_d, lens_d))
    assert np.array_equal(got.cpu().numpy(), _native_crcs(rows, lengths))


def test_crc_kernel_pitched_and_unaligned(cuda_device, rng):
    panel = rng.integers(0, 256, (9, 520 * 128), dtype=np.uint8)
    lengths = np.array([65536, 0, 1, 15, 16, 17, 4097, 65535, 300], np.int32)
    panel_d = torch.from_numpy(panel).to(cuda_device)
    lens_d = torch.from_numpy(lengths).to(cuda_device)
    for off in (0, 3):  # 16-byte loads, then the byte path
        view = panel_d[:, off : off + kc.CHUNK]
        got = kc.crc32c_chunks(view, lens_d)
        want = _native_crcs(panel[:, off:], lengths)
        assert np.array_equal(got.cpu().numpy(), want), off
    with pytest.raises(ValueError):
        kc.crc32c_chunks(panel_d[:, : kc.CHUNK : 2], lens_d)


_CRC_EDGE = [0, 1, 15, 16, 17, 255, 256, 257, 65535, 65536]


@pytest.mark.parametrize("nrows", [1, 64, 395, 396, 397])
def test_crc_kernel_widths_and_edge_lengths(cuda_device, rng, nrows):
    """The clustered CRC at one row, the id engine's 64 and the seq
    engine's 396 +- 1 rows: every edge length (the empty row, a partial
    first segment, 16-byte boundaries, a full row) and random lengths,
    bytes past each length random (they must not reach the checksum)."""
    lengths = np.array((_CRC_EDGE * (nrows // len(_CRC_EDGE) + 1))[:nrows],
                       np.int32)
    lengths[len(_CRC_EDGE) :] = rng.integers(0, 65537, max(
        0, nrows - len(_CRC_EDGE)))
    if nrows == 1:
        lengths[0] = 4096
    rows = rng.integers(0, 256, (nrows, kc.CHUNK), dtype=np.uint8)
    rows_d = torch.from_numpy(rows).to(cuda_device)
    lens_d = torch.from_numpy(lengths).to(cuda_device)
    got = kc.crc32c_chunks(rows_d, lens_d)
    torch.cuda.synchronize()
    assert torch.equal(got, kc.crc32c_chunks_plain(rows_d, lens_d))
    assert np.array_equal(got.cpu().numpy(), _native_crcs(rows, lengths))


@pytest.mark.parametrize("width,off", [(4096, 0), (4096, 5), (1000, 1),
                                       (65536, 7), (65536, 15)])
def test_crc_kernel_narrow_and_unaligned(cuda_device, rng, width, off):
    """Rows narrower than 64 KiB (lengths clamped to the width, negative
    ones to 0) read through a pitched view at every base alignment."""
    lengths = np.array([0, 1, 15, 16, 17, 255, 256, 257, width - 1, width,
                        width + 100, -5], np.int32)
    pitch = width + 40
    buf = rng.integers(0, 256, (len(lengths), pitch + 16), dtype=np.uint8)
    view = torch.from_numpy(buf).to(cuda_device)[:, off : off + width]
    got = kc.crc32c_chunks(view, torch.from_numpy(lengths).to(cuda_device))
    torch.cuda.synchronize()
    clamped = np.clip(lengths, 0, width)
    assert np.array_equal(got.cpu().numpy(),
                          _native_crcs(buf[:, off:], clamped))
    assert int(got.min()) >= 0 and int(got.max()) < 2**32


def _decode_plans(data, nb):
    fr = native.compress_framed(data)
    chunks, _ = dc._scan_frames(fr)
    comp = [c for c in chunks if c[0] == 0][:nb]
    n = len(comp)
    rb = kf.rows_b_for(66560)
    b_u8 = np.empty((n, rb * 128), np.uint8)
    meta = np.empty((n, 8 * kf.TRIP_CAP, 128), np.int32)
    starts = np.zeros((n, 8, 128), np.int32)
    rc = np.zeros(n, np.int64)
    arrs = [np.array([c[f] for c in comp], np.int64) for f in (1, 2, 5, 4)]
    native.stage_flat_dec_batch(np.frombuffer(fr, np.uint8), *arrs, rb,
                                meta, starts, b_u8, rc)
    want = [native.decompress(fr[c[1]:c[1] + c[2]]) for c in comp]
    return b_u8, meta, starts, np.maximum(rc, 0).astype(np.int32), rc, want


def test_flat_kernel_matches_plain_decode(cuda_device):
    b_u8, meta, starts, ntr, rc, want = _decode_plans(_corpus(15), 24)
    plan = kf.plan_from_numpy(b_u8, meta, starts, ntr, cuda_device)
    before = kf.launches
    got = kf.decode_blocks_flat(*plan, dst_max=65536)
    torch.cuda.synchronize()
    assert kf.launches == before + 1
    assert torch.equal(got, kf.decode_blocks_flat_plain(*plan, dst_max=65536))
    got_h = got.cpu().numpy()
    for i, w in enumerate(want):
        if rc[i] >= 0:
            assert got_h[i, : len(w)].tobytes() == w
    out = torch.full((len(want) + 2, 65536), 9, dtype=torch.uint8,
                     device=cuda_device)
    kf.decode_blocks_flat(*plan, dst_max=65536, out=out[1:-1])
    assert torch.equal(out[1:-1], got)
    assert int(out[0].min()) == 9 and int(out[-1].min()) == 9


def test_flat_kernel_matches_plain_encode(cuda_device):
    data = _corpus(16)
    n = 8
    blocks = np.frombuffer(data[: n * 65536], np.uint8).reshape(n, 65536)
    b_u8 = np.empty((n, ke.RB_ENC * 128), np.uint8)
    meta = np.empty((n, 8 * ke.ENC_TRIP_CAP, 128), np.int32)
    starts = np.zeros((n, 8, 128), np.int32)
    elem = np.empty((n, native.max_compressed_length(65536) + 8), np.uint8)
    clens, hdrs, rc = (np.zeros(n, np.int64) for _ in range(3))
    native.stage_flat_enc_batch(blocks, np.full(n, 65536, np.int64),
                                ke.RB_ENC, meta, starts, b_u8,
                                ke.TAG_ROWS * 128, elem, clens, hdrs, rc)
    plan = kf.plan_from_numpy(b_u8, meta, starts,
                              np.maximum(rc, 0).astype(np.int32), cuda_device)
    got = ke.encode_blocks_flat(*plan)
    assert torch.equal(got, ke.encode_blocks_flat_plain(*plan))
    got_h = got.cpu().numpy()
    for i in range(n):
        if rc[i] >= 0:
            assert got_h[i, : clens[i]].tobytes() == elem[i, : clens[i]].tobytes()


def _encode_plans(data, n):
    blocks = np.frombuffer(data[: n * 65536], np.uint8).reshape(n, 65536)
    b_u8 = np.empty((n, ke.RB_ENC * 128), np.uint8)
    meta = np.empty((n, 8 * ke.ENC_TRIP_CAP, 128), np.int32)
    starts = np.zeros((n, 8, 128), np.int32)
    elem = np.empty((n, native.max_compressed_length(65536) + 8), np.uint8)
    clens, hdrs, rc = (np.zeros(n, np.int64) for _ in range(3))
    native.stage_flat_enc_batch(blocks, np.full(n, 65536, np.int64),
                                ke.RB_ENC, meta, starts, b_u8,
                                ke.TAG_ROWS * 128, elem, clens, hdrs, rc)
    return b_u8, meta, starts, np.maximum(rc, 0).astype(np.int32)


@pytest.mark.parametrize("kind", ["decode", "encode"])
def test_flat_kernel_trip_counts_and_clamp(cuda_device, kind):
    """Decode and encode-replay plans at the runtime's shape (meta cut to
    the used trips) and at the full trip cap, with rows of ntrips 0,
    ntrips past the cap (the cap runs), the aligned-trip high half set,
    and a hand-made piece whose subpanel starts past the compose clamp."""
    if kind == "decode":
        b_u8, meta, starts, ntr, _rc, _want = _decode_plans(_corpus(27), 12)
        dst, out_rows = 65536, kf.OUT_ROWS
    else:
        b_u8, meta, starts, ntr = _encode_plans(_corpus(28), 12)
        dst, out_rows = ke.ENC_DST_MAX, ke.OUT_ROWS_ENC
    ntr = ntr.copy()
    cap = meta.shape[1] // 8
    for i, n in enumerate(ntr & 0xFFFF):  # staging leaves unused trips as
        meta[i, 8 * n :] = 0               # they were: make them empty
    ntr[0] = 0
    ntr[1] = cap + 5
    ntr[2] |= 3 << 16
    # row 3: one piece at destination row Dq + 5, Dq past out_rows - 128
    meta[3], starts[3], ntr[3] = 0, 0, 1
    dq = out_rows - 128 + 40
    meta[3, 0, 5] = 9 | (17 << 7)
    meta[3, 4, 5] = 3 | (99 << 7) | (5 << 14) | kf._VALID
    starts[3, 0, 0] = 200 | (dq << 10) | (17 << 20)
    used = max(1, int(np.delete(ntr & 0xFFFF, 1).max()))
    for m in (meta, np.ascontiguousarray(meta[:, : 8 * used])):
        plan = kf.plan_from_numpy(b_u8, m, starts, ntr, cuda_device)
        got = kf.decode_blocks_flat(*plan, dst_max=dst, out_rows=out_rows)
        torch.cuda.synchronize()
        assert torch.equal(got, kf.decode_blocks_flat_plain(
            *plan, dst_max=dst, out_rows=out_rows))
        assert not got[0].any()
        row3 = got[3].cpu().numpy()
        src = (200 + 9) * 128 + (128 - 17)
        want = np.zeros(dst, np.uint8)
        at = (dq + 5) * 128
        if at < dst:
            want[at + 3 : at + 103] = b_u8[3, src + 3 : src + 103][
                : max(0, dst - at - 3)]
        assert np.array_equal(row3, want)


@pytest.mark.parametrize("dst_max", [65536, 65535, 4097, 8193])
def test_flat_kernel_out_view_odd_length(cuda_device, dst_max):
    """out= a row-strided view of a larger buffer at an odd base and an
    odd pitch, and dst_max not a multiple of 16 or of the slab: bytes past
    dst_max are dropped and the buffer around the view is untouched."""
    b_u8, meta, starts, ntr, _rc, _want = _decode_plans(_corpus(29), 9)
    plan = kf.plan_from_numpy(b_u8, meta, starts, ntr, cuda_device)
    nb = b_u8.shape[0]
    buf = torch.full((nb + 2, dst_max + 21), 9, dtype=torch.uint8,
                     device=cuda_device)
    view = buf[1:-1, 3 : 3 + dst_max]
    res = kf.decode_blocks_flat(*plan, dst_max=dst_max, out=view)
    torch.cuda.synchronize()
    assert res.data_ptr() == view.data_ptr()
    assert torch.equal(view, kf.decode_blocks_flat_plain(*plan,
                                                         dst_max=dst_max))
    assert int(buf[0].min()) == 9 and int(buf[-1].min()) == 9
    assert int(buf[1:-1, :3].min()) == 9
    assert int(buf[1:-1, 3 + dst_max :].min()) == 9


def _seq_rows(streams, cmax):
    """(comp, starts, clens, dlens) numpy rows of raw streams."""
    comp = np.zeros((len(streams), cmax), np.uint8)
    starts, clens, dlens = (np.zeros(len(streams), np.int32) for _ in range(3))
    for i, c in enumerate(streams):
        dlens[i], starts[i] = read_uvarint(c, 0)
        comp[i, : len(c)] = np.frombuffer(c, np.uint8)
        clens[i] = len(c)
    return comp, starts, clens, dlens


# corrupt element streams, one per error code, and the 4-byte-field forms
_BAD_STREAMS = [
    b"\x05\x0cabcd",                                   # ERR_DST_SHORT
    b"\x08\x0cabcd" + bytes([(3 << 2) | 2, 10, 0]),     # ERR_COPY
    b"\x0a\x24abc",                                    # ERR_LITERAL
    put_uvarint(10) + bytes([63 << 2, 255, 255, 255, 127]) + b"abc",
    put_uvarint(8) + b"\x0cabcd" + bytes([(3 << 2) | 3, 1, 0, 0, 128]),
    put_uvarint(8) + b"\x0cabcd" + bytes([(3 << 2) | 3, 4, 0, 0, 0]),
    put_uvarint(8) + b"\x0cabcd" + bytes([(3 << 2) | 2]),
]


@pytest.mark.parametrize("cmax,out_max", [(66560, 65536), (100_003, 99_999)])
def test_seq_decode_kernel_matches_plain(cuda_device, rng, cmax, out_max):
    """Corpus rows and corrupt rows; shared-memory rows (66,560) and rows
    too wide for it (device-memory path); a row-strided view."""
    data = _corpus(18, 16 << 16)
    blocks = [data[i << 16 : (i + 1) << 16] for i in range(16)]
    blocks += [bytes(65536), rng.bytes(65536), b""]
    streams = [native.compress(b) for b in blocks] + _BAD_STREAMS + [b"\x00"]
    comp, starts, clens, dlens = _seq_rows(streams, cmax + 5)
    starts[-1] = clens[-1] + 3  # ERR_SRC_TRAIL
    c, st, cl, dl = kds.stage_decode(comp, starts, clens, dlens, cuda_device)
    before = kds.launches
    out, err = kds.decode_blocks_seq(c[:, :cmax], st, cl, dl, out_max)
    torch.cuda.synchronize()
    assert kds.launches == before + 1
    pout, perr = kds.decode_blocks_seq_plain(c[:, :cmax], st, cl, dl, out_max)
    assert torch.equal(err, perr) and torch.equal(out, pout)
    assert set(err.tolist()) == {0, 1, 2, 3, 4}
    out_h = out.cpu().numpy()
    for i, b in enumerate(blocks):
        assert out_h[i, : len(b)].tobytes() == b


@pytest.mark.parametrize("wide", [False, True])
def test_seq_decode_kernel_on_a_span_view(cuda_device, rng, wide):
    """The seq engine's layout: one span of the stream (8 non-zero bytes,
    a chunk's header and CRC, before each payload) read as rows of
    stride 0, row b's stream at [rel + hdr, rel + len), against the
    plain version on padded rows (stale bytes past each stream): corpus
    rows, every error code, headers cut at the payload end; the distinct
    rows once, and cycled to the engine's width."""
    data = _corpus(23, 12 << 16)
    blocks = [data[i << 16 : (i + 1) << 16] for i in range(12)]
    blocks += [bytes(65536), rng.bytes(65536), b""]
    streams = [native.compress(b) for b in blocks] + _BAD_STREAMS
    streams.append(b"\x00\x0cabcd")  # ERR_SRC_TRAIL: start past its end
    comp, starts, clens, dlens = _seq_rows(streams, 66560)
    comp[:, :] = 0xA5
    for i, c in enumerate(streams):
        comp[i, : len(c)] = np.frombuffer(c, np.uint8)
    starts[-1] = clens[-1] + 2
    idx = np.arange(len(streams))
    if wide:
        idx = _wide_rows(kds.resident_rows(cuda_device, 65536) + 5,
                         len(streams))
    gap = bytes([0x01, 0x31, 0x02, 0x07, 0xD7, 0x9E, 0xFF, 0x01])
    span, rel = bytearray(), []
    for i in idx:
        span += gap
        rel.append(len(span))
        span += streams[i]
    rel = np.array(rel, np.int32)
    flat = torch.frombuffer(span, dtype=torch.uint8).to(cuda_device)
    _, st, cl, dl = kds.stage_decode(comp[idx], starts[idx] + rel,
                                     clens[idx] + rel, dlens[idx],
                                     cuda_device)
    before = kds.launches
    out, err = kds.decode_blocks_seq(flat.expand(len(idx), len(span)), st,
                                     cl, dl, 65536)
    torch.cuda.synchronize()
    assert kds.launches == before + 1
    pout, perr = kds.decode_blocks_seq_plain(
        *kds.stage_decode(comp, starts, clens, dlens, cuda_device), 65536)
    sel = torch.from_numpy(idx).to(cuda_device)
    assert torch.equal(err, perr[sel]) and torch.equal(out, pout[sel])
    assert set(err.tolist()) == {0, 1, 2, 3, 4}
    out_h = out.cpu().numpy()
    for r, i in enumerate(idx[: len(blocks)]):
        assert out_h[r, : len(blocks[i])].tobytes() == blocks[i]


def test_seq_engine_spans_on_card(cuda_device, rng, monkeypatch):
    """The seq engine's to-device decode on the card: stored chunks
    mid-batch and a short stored last one, skippable and padding chunks
    between payloads, two padding chunks wider together than the pinned
    buffer (an early batch end); every row a span row; a decode error
    ahead of a CRC error raises CorruptError, a flipped last CRC
    ChecksumError."""
    monkeypatch.setattr(dc, "FLAT", False)
    monkeypatch.setattr(dc, "HOST_PARSE", False)
    text = _corpus(24, 6 << 16)
    data = (text[: 3 << 16] + rng.bytes(65536) + text[3 << 16 :]
            + rng.bytes(65536) + rng.bytes(999))
    stream = native.compress_framed(data)
    recs, pos = [], 10
    while pos < len(stream):
        body = int.from_bytes(stream[pos + 1 : pos + 4], "little")
        recs.append(bytearray(stream[pos : pos + 4 + body]))
        pos += 4 + body
    assert [r[0] for r in recs].count(1) >= 3 and recs[-1][0] == 1

    def pad(ctype, n):
        return bytes((ctype,)) + n.to_bytes(3, "little") + bytes(n)

    wide = pad(0xFE, (1 << 24) - 1) * 2
    extra = {1: pad(0x80, 100), 2: pad(0xFE, 3), 4: wide}
    framed = lambda: stream[:10] + b"".join(  # noqa: E731
        bytes(r) + extra.get(i, b"") for i, r in enumerate(recs))
    before = dict(dc.SEQ_STAGING)
    got = dc.decompress_framed_to_device(framed(), device=cuda_device)
    assert got.cpu().numpy().tobytes() == data
    assert dc.SEQ_STAGING["span_rows"] - before["span_rows"] == len(recs)
    assert dc.SEQ_STAGING["padded_rows"] == before["padded_rows"]
    recs[-1][4] ^= 0x01
    with pytest.raises(dc.ChecksumError):
        dc.decompress_framed_to_device(framed(), device=cuda_device)
    hdr = len(put_uvarint(65536))
    assert recs[2][0] == 0
    recs[2][8 + hdr] = (3 << 2) | 2  # a copy before the block start
    with pytest.raises(dc.CorruptError):
        dc.decompress_framed_to_device(framed(), device=cuda_device)


def test_seq_encode_kernel_matches_plain(cuda_device, rng):
    data = _corpus(19, 16 << 16)
    samples = [data[i << 16 : (i + 1) << 16] for i in range(16)]
    samples += [b"", b"x" * 17, b"x" * 18, bytes(65536), b"ab" * 32768,
                rng.bytes(65536), rng.bytes(4097)]
    width = 65536 + 100  # wider than a block: rows past 64 KiB are ERR_LEN
    blocks = np.zeros((len(samples) + 1, width), np.uint8)
    lens = np.array([len(s) for s in samples] + [65537], np.int32)
    for i, s in enumerate(samples):
        blocks[i, : len(s)] = np.frombuffer(s, np.uint8)
    b, l = kes.stage_encode(blocks, lens, cuda_device)
    before = kes.launches
    comp, clens, err = kes.encode_blocks_seq(b, l)
    torch.cuda.synchronize()
    assert kes.launches == before + 1
    pcomp, pclens, perr = kes.encode_blocks_seq_plain(b, l)
    assert torch.equal(comp, pcomp) and torch.equal(clens, pclens)
    assert torch.equal(err, perr) and err.tolist()[-1] == kes.ERR_LEN
    comp_h, clens_h = comp.cpu().numpy(), clens.cpu().numpy()
    for i, s in enumerate(samples):
        nat = native.compress(s)
        assert comp_h[i, : clens_h[i]].tobytes() == nat[read_uvarint(nat, 0)[1] :]


def _wide_rows(n_rows, distinct):
    """Row indices of a launch n_rows wide that cycles over the distinct
    rows (every kind of row lands on many SMs and in many batches)."""
    return np.arange(n_rows) % distinct


@pytest.mark.parametrize("extra", [0, 1])
def test_seq_decode_kernel_at_engine_width(cuda_device, rng, extra):
    """The redesigned decoder at the seq engine's launch width (the
    card's resident rows, > 132) and at a width that is not a multiple
    of it: corpus rows, hostile rows (every error code, the int32 wrap
    rows), an empty stream (a stored chunk's row), incompressible and
    all-zero chunks.  The plain version runs once per distinct row; the
    wide launch must give each row the same bytes and code."""
    resident = kds.resident_rows(cuda_device, 65536)
    assert resident > 132
    width = resident + extra * (resident // 3 + 7)
    data = _corpus(21, 24 << 16)
    blocks = [data[i << 16 : (i + 1) << 16] for i in range(24)]
    blocks += [bytes(65536), rng.bytes(65536), b""]
    streams = [native.compress(b) for b in blocks] + _BAD_STREAMS + [b"\x00"]
    comp, starts, clens, dlens = _seq_rows(streams, 66560)
    starts[-1] = clens[-1] + 3  # ERR_SRC_TRAIL
    idx = _wide_rows(width, len(streams))
    c, st, cl, dl = kds.stage_decode(comp[idx], starts[idx], clens[idx],
                                     dlens[idx], cuda_device)
    out, err = kds.decode_blocks_seq(c, st, cl, dl, 65536)
    pout, perr = kds.decode_blocks_seq_plain(
        *kds.stage_decode(comp, starts, clens, dlens, cuda_device), 65536)
    torch.cuda.synchronize()
    sel = torch.from_numpy(idx).to(cuda_device)
    assert torch.equal(err, perr[sel]) and torch.equal(out, pout[sel])
    assert set(err.tolist()) == {0, 1, 2, 3, 4}
    out_h = out.cpu().numpy()
    for r in range(len(blocks)):
        assert out_h[r, : len(blocks[r])].tobytes() == blocks[r]


@pytest.mark.parametrize("extra", [0, 1])
def test_seq_encode_kernel_at_engine_width(cuda_device, rng, extra):
    """The redesigned encoder at the seq engine's launch width and at a
    width that is not a multiple of it: corpus rows, short edge rows,
    stored-size (incompressible), all-zero and run-length chunks (a long
    record stream through the matcher's ring), and an out-of-range
    length (ERR_LEN)."""
    resident = kes.resident_rows(cuda_device, 65536)
    assert resident > 132
    width = resident + extra * (resident // 3 + 7)
    data = _corpus(22, 24 << 16)
    samples = [data[i << 16 : (i + 1) << 16] for i in range(24)]
    samples += [b"", b"x" * 17, b"x" * 18, b"y" * 50, bytes(65536),
                b"ab" * 32768, rng.bytes(65536), rng.bytes(1000) + b"z" * 3000,
                (rng.bytes(40) * 1700)[:65536]]
    blocks = np.zeros((len(samples) + 1, 65536), np.uint8)
    lens = np.array([len(s) for s in samples] + [-1], np.int32)
    for i, s in enumerate(samples):
        blocks[i, : len(s)] = np.frombuffer(s, np.uint8)
    idx = _wide_rows(width, len(lens))
    comp, clens, err = kes.encode_blocks_seq(
        *kes.stage_encode(blocks[idx], lens[idx], cuda_device))
    pcomp, pclens, perr = kes.encode_blocks_seq_plain(
        *kes.stage_encode(blocks, lens, cuda_device))
    torch.cuda.synchronize()
    sel = torch.from_numpy(idx).to(cuda_device)
    assert torch.equal(comp, pcomp[sel]) and torch.equal(clens, pclens[sel])
    assert torch.equal(err, perr[sel]) and int(err[len(samples)]) == kes.ERR_LEN
    comp_h, clens_h = comp.cpu().numpy(), clens.cpu().numpy()
    for i, s in enumerate(samples):
        nat = native.compress(s)
        assert comp_h[i, : clens_h[i]].tobytes() == nat[read_uvarint(nat, 0)[1] :]


@pytest.mark.parametrize("row_off,comp_off", [(0, 0), (5, 3)])
def test_frame_records_kernel_matches_plain(cuda_device, rng, row_off,
                                            comp_off):
    """The framed-record kernel on a batch of the seq engine's width (the
    card's resident rows): corpus chunks, incompressible (stored) chunks,
    short chunks of each varint width, and four rows' element lengths
    set at the 12.5% boundary; the chunk rows and the elements at the
    runtime's alignment and at odd byte offsets.  Equal to the plain
    version and to the host's ``_framed_record`` a row; one launch."""
    width = kes.resident_rows(cuda_device, 65536)
    data = _corpus(23, 64 << 16)
    samples = [data[i << 16 : (i + 1) << 16] for i in range(64)]
    samples += [rng.bytes(65536), rng.bytes(65536), rng.bytes(100),
                rng.bytes(10_000), b"q" * 100, b"w" * 10_000, b"e" * 16384,
                rng.bytes(1), data[:127], data[:16383], data[:16384]]
    idx = _wide_rows(width, len(samples))
    lens = np.array([len(samples[i]) for i in idx], np.int32)
    host = np.zeros((width, 65536), np.uint8)
    for r, i in enumerate(idx):
        host[r, : lens[r]] = np.frombuffer(samples[i], np.uint8)
    aligned = torch.from_numpy(host).to(cuda_device)
    flat = torch.zeros(row_off + width * 65536, dtype=torch.uint8,
                       device=cuda_device)
    flat[row_off:] = aligned.reshape(-1)
    rows = flat[row_off:].view(width, 65536)
    lens_d = torch.from_numpy(lens).to(cuda_device)
    comp, clens, _err = kes.encode_blocks_seq(aligned, lens_d)
    crc = kc.crc32c_chunks(aligned, lens_d)
    for r, below in enumerate((0, 1, 0, 1)):  # 64 KiB corpus rows
        clens[r] = 65536 - 65536 // 8 - 3 - below
    comp = comp[:, comp_off:]
    before = kfr.launches
    framed, ends = kfr.frame_records(rows, lens_d, comp, clens, crc)
    torch.cuda.synchronize()
    assert kfr.launches == before + 1
    pframed, pends = kfr.frame_records_plain(rows, lens_d, comp, clens, crc)
    total = int(ends[-1])
    assert torch.equal(ends, pends)
    assert torch.equal(framed[:total], pframed[:total])
    comp_h, clens_h, crc_h = (t.cpu().numpy() for t in (comp, clens, crc))
    recs = [dc._framed_record(int(lens[r]), comp_h[r, : clens_h[r]].tobytes(),
                              int(crc_h[r]), host[r, : lens[r]])
            for r in range(width)]
    assert [rec[0] for rec in recs[:4]] == [1, 0, 1, 0]
    assert {rec[0] for rec in recs} == {0, 1}
    assert framed[:total].cpu().numpy().tobytes() == b"".join(recs)


@pytest.mark.parametrize("mode", ["id", "classify", "seq"])
def test_main_path_through_kernels(cuda_device, mode, monkeypatch, rng):
    if mode == "seq":
        monkeypatch.setattr(dc, "FLAT", False)
        monkeypatch.setattr(dc, "HOST_PARSE", False)
    else:
        monkeypatch.setattr(dc, "FLAT_MODE", mode)
    monkeypatch.setattr(dc, "BATCH", 8)
    data = _corpus(17, 3 << 20) + rng.bytes(100_000)
    crc0, flat0 = kc.launches, kf.launches
    seq0 = kds.launches, kes.launches, kfr.launches
    stream = dc.compress_framed(data, device=cuda_device)
    assert stream == native.compress_framed(data)
    arr = dc.decompress_framed_to_device(stream, device=cuda_device)
    assert arr.is_cuda and arr.cpu().numpy().tobytes() == data
    assert dc.compress_framed_from_device(arr) == stream
    assert dc.decompress_framed(stream, device=cuda_device) == data
    raw = native.compress(data)
    assert torch.equal(dc.decompress_to_device(raw, device=cuda_device), arr)
    assert dc.decompress(raw, device=cuda_device) == data
    assert dc.compress(data, device=cuda_device) == raw
    assert kc.launches > crc0
    if mode == "classify":
        assert kf.launches > flat0
    if mode == "seq":
        assert kds.launches > seq0[0] and kes.launches > seq0[1]
        assert kfr.launches > seq0[2]  # the records written on the card
        broken = bytearray(stream)
        chunks, _ = dc._scan_frames(stream)
        _t, p_off, _l, _c, _d, hdr = next(c for c in chunks if c[0] == 0)
        broken[p_off + hdr] = (3 << 2) | 2  # a copy before the block start
        with pytest.raises(dc.CorruptError):
            dc.decompress_framed_to_device(bytes(broken), device=cuda_device)
    bad = bytearray(stream)
    bad[14] ^= 0x01
    with pytest.raises(dc.ChecksumError):
        dc.decompress_framed_to_device(bytes(bad), device=cuda_device)


def _blocks(data):
    return [data[i << 16 : (i + 1) << 16] for i in range(len(data) >> 16)]


@pytest.mark.parametrize("cmax,out_max", [(None, 65536), (100_003, 99_999)])
def test_wavegroup_kernel_matches_plain(cuda_device, rng, cmax, out_max):
    """Corpus and edge rows; shared-memory rows and rows too wide for it
    (device-memory path) read through a row-strided view."""
    blocks = _blocks(_corpus(20, 16 << 16))
    blocks += [bytes(65536), b"ab" * 32768, rng.bytes(65536), b"", b"x"]
    comp, words, ng = kw.stage_waves([native.compress(b) for b in blocks],
                                     device=cuda_device)
    if cmax is not None:
        wide = torch.zeros(len(blocks), cmax + 7, dtype=torch.uint8,
                           device=cuda_device)
        wide[:, : comp.shape[1]] = comp
        comp = wide[:, :cmax]
    before = kw.launches
    out = kw.decode_blocks_wavegroup(comp, words, ng, out_max)
    torch.cuda.synchronize()
    assert kw.launches == before + 1
    assert torch.equal(out, kw.decode_blocks_wavegroup_plain(comp, words, ng,
                                                             out_max))
    out_h = out.cpu().numpy()
    for i, b in enumerate(blocks):
        assert out_h[i, : len(b)].tobytes() == b
        assert not out_h[i, len(b) :].any()


def test_wavegroup_kernel_stays_in_its_rows(cuda_device, rng):
    """Random words break every invariant, and ngroups run past the plan
    and below 0: the kernel still runs to its end without a memory
    fault, and rows with no group to run stay zero."""
    comp = torch.from_numpy(rng.integers(0, 256, (6, 3000), dtype=np.uint8))
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (6, 4, 128),
                                          dtype=np.int64).astype(np.int32))
    ng = torch.tensor([0, 1, 32, 33, -5, 2**30], dtype=torch.int32)
    out = kw.decode_blocks_wavegroup(comp.to(cuda_device),
                                     words.to(cuda_device),
                                     ng.to(cuda_device), 1000)
    torch.cuda.synchronize()
    assert out.shape == (6, 1000)
    assert not out[0].any() and not out[4].any()  # no groups run


@pytest.mark.parametrize("home", [True, False])
def test_match_kernel_matches_plain(cuda_device, rng, home):
    blocks = _blocks(_corpus(21, 16 << 16))
    blocks += [b"", b"abc", b"abcd", bytes(65536), rng.bytes(65536),
               bytes(range(256)) * 256, rng.bytes(30001)]
    w, n = km.stage_words(blocks)
    w_d, n_d = torch.from_numpy(w).to(cuda_device), torch.from_numpy(n).to(
        cuda_device)
    before = km.launches
    got = km.find_candidates(w_d, n_d, home=home)
    torch.cuda.synchronize()
    assert km.launches == before + 1
    assert torch.equal(got, km.find_candidates_plain(w_d, n_d, home=home))
    cands = got.cpu().numpy()
    if not home:
        cands = km.scatter_home(cands)
    cands = cands.reshape(len(blocks), -1)
    for i in (0, 15, *range(16, len(blocks))):
        assert np.array_equal(cands[i], match_np.find_candidates(blocks[i])), i
    # 4,096 slots: a block filling them exactly (the v-word wrap)
    small = [rng.bytes(4096), (b"wrap" * 1024), b"abcabcabc"]
    w, n = km.stage_words(small, 4096)
    w_d, n_d = torch.from_numpy(w).to(cuda_device), torch.from_numpy(n).to(
        cuda_device)
    assert torch.equal(km.find_candidates(w_d, n_d, home=home),
                       km.find_candidates_plain(w_d, n_d, home=home))


@pytest.mark.parametrize("delta", [-1, 1])
def test_wavegroup_kernel_at_resident_width(cuda_device, rng, delta):
    """The redesigned wave kernel at the card's resident rows minus and
    plus one: corpus rows and stored-like (random) rows mixed in one
    launch, with edge rows, each row cycled from a distinct set and
    compared with the plain version of that set."""
    width = kw.resident_rows(cuda_device, 65536) + delta
    blocks = _blocks(_corpus(25, 12 << 16))
    blocks += [rng.bytes(65536), bytes(65536), b"ab" * 32768, rng.bytes(65536),
               b"", b"x", rng.bytes(30000) + bytes(35536)]
    idx = _wide_rows(width, len(blocks))
    streams = [native.compress(b) for b in blocks]
    comp, words, ng = kw.stage_waves([streams[i] for i in idx],
                                     device=cuda_device)
    before = kw.launches
    out = kw.decode_blocks_wavegroup(comp, words, ng, 65536)
    torch.cuda.synchronize()
    assert kw.launches == before + 1
    pout = kw.decode_blocks_wavegroup_plain(
        *kw.stage_waves(streams, device=cuda_device), 65536)
    assert torch.equal(out, pout[torch.from_numpy(idx).to(cuda_device)])
    out_h = out.cpu().numpy()
    for r in range(len(blocks)):
        assert out_h[r, : len(blocks[r])].tobytes() == blocks[r]
        assert not out_h[r, len(blocks[r]) :].any()


@pytest.mark.parametrize("home", [True, False])
@pytest.mark.parametrize("delta", [-1, 1])
def test_match_kernel_at_resident_width(cuda_device, rng, home, delta):
    """The redesigned match kernel at the card's resident blocks minus and
    plus one, in both routes: corpus blocks and edge blocks (exact 64 KiB
    blocks whose last words wrap, all-equal, short) cycled from a
    distinct set and compared with the plain version of that set."""
    width = km.resident_rows(cuda_device) + delta
    blocks = _blocks(_corpus(26, 12 << 16))
    blocks += [b"", b"abc", b"abcd", bytes(65536), rng.bytes(65536),
               bytes(range(256)) * 256, rng.bytes(30001), b"wrap" * 16384]
    idx = _wide_rows(width, len(blocks))
    w, n = km.stage_words(blocks)
    w_d, n_d = torch.from_numpy(w).to(cuda_device), torch.from_numpy(n).to(
        cuda_device)
    sel = torch.from_numpy(idx).to(cuda_device)
    before = km.launches
    got = km.find_candidates(w_d[sel], n_d[sel], home=home)
    torch.cuda.synchronize()
    assert km.launches == before + 1
    assert torch.equal(got, km.find_candidates_plain(w_d, n_d, home=home)[sel])


def test_blocks_per_sm_entries(cuda_device):
    """Both new width queries report at least one resident block an SM,
    and resident_rows is SMs times that."""
    import ctypes

    from snappy_tpu_torch.kernels import _build

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for entry, width, rows in (
            ("snc_match_blocks_per_sm", km.BMAX, km.resident_rows(cuda_device)),
            ("snc_wavegroup_blocks_per_sm", 65536,
             kw.resident_rows(cuda_device, 65536))):
        n = ctypes.c_int(0)
        _build.check(getattr(_build.lib(), entry)(width, ctypes.addressof(n)),
                     entry)
        assert n.value >= 1, entry
        assert rows == sms * n.value, entry


def test_seq_stagers_default_to_the_card(cuda_device):
    comp = np.zeros((2, 16), np.uint8)
    staged = kds.stage_decode(comp, [0, 0], [0, 0], [0, 0])
    assert all(t.device == cuda_device for t in staged)
    staged = kes.stage_encode(comp, [16, 3])
    assert all(t.device == cuda_device for t in staged)
    staged = kes.stage_encode(comp, [16, 3], device="cpu")
    assert all(t.device.type == "cpu" for t in staged)


def test_stage_waves_defaults_to_the_card(cuda_device):
    staged = kw.stage_waves([native.compress(b"abc" * 1000)])
    assert all(t.device == cuda_device for t in staged)
    staged = kw.stage_waves([native.compress(b"abc" * 1000)], device="cpu")
    assert all(t.device.type == "cpu" for t in staged)


def test_wave_engine(cuda_device):
    """The wave engine of chip_smoke.py at its width (the card's resident
    rows a launch) over one and a half launches of corpus blocks:
    native.compress streams, stage_waves, compared on the device."""
    width = kw.resident_rows(cuda_device, 65536)
    nblk = width + width // 2
    data = _corpus(22, nblk << 16)
    blocks = _blocks(data)
    streams = [native.compress(b) for b in blocks]
    ref = torch.frombuffer(bytearray(data[: len(blocks) << 16]),
                           dtype=torch.uint8).to(cuda_device).view(-1, 65536)
    before = kw.launches
    for lo in range(0, len(blocks), width):
        staged = kw.stage_waves(streams[lo : lo + width])
        assert staged is not None
        out = kw.decode_blocks_wavegroup(*staged, 65536)
        assert torch.equal(out, ref[lo : lo + width])
    assert kw.launches == before + -(-len(blocks) // width)


def test_devmatch_engine(cuda_device):
    """The devmatch engine of chip_smoke.py at its width (the card's
    resident blocks a launch) over one and a half launches: candidates on
    the card, emission on the host, every emission decoding to its block,
    and the total smaller than the native encoder's bodies."""
    width = km.resident_rows(cuda_device)
    blocks = _blocks(_corpus(23, (width + width // 2) << 16))
    before = km.launches
    emitted = ref = 0
    for lo in range(0, len(blocks), width):
        batch = blocks[lo : lo + width]
        cands = km.find_candidates_device(batch, device=cuda_device)
        for blk, c in zip(batch, cands):
            body = native.emit_from_cands(blk, np.ascontiguousarray(c))
            assert native.decompress(put_uvarint(len(blk)) + body) == blk
            emitted += len(body)
            ref += len(native.compress(blk)) - len(put_uvarint(len(blk)))
    assert km.launches == before + -(-len(blocks) // width)
    assert emitted < ref


@pytest.mark.parametrize("mode", ["id", "seq"])
def test_checkpoint_on_card(cuda_device, mode, monkeypatch):
    """save_pytree / load_pytree of a GPT-2-shaped state on the card: the
    CRC kernel runs in both directions (and the sequential kernels under
    the device LZ engine), each stream after its manifest is
    native.compress_framed of the tensor's bytes, and a flipped payload
    byte and a truncated container raise."""
    from snappy_tpu_torch import checkpoint as ck

    if mode == "seq":
        monkeypatch.setattr(dc, "FLAT", False)
        monkeypatch.setattr(dc, "HOST_PARSE", False)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    d = 128
    state = {"wte.weight": torch.randn(700, d, generator=g,
                                       device=cuda_device) * 0.02,
             "h.0.mlp.c_fc.weight": torch.randn(d, 4 * d, generator=g,
                                                device=cuda_device) * 0.02,
             "h.0.ln_1.weight": torch.ones(d, device=cuda_device),
             "h.0.ln_1.bias": torch.zeros(d, device=cuda_device),
             "half": torch.ones(3000, device=cuda_device).to(torch.bfloat16)}
    before = kc.launches, kes.launches
    blob = ck.save_pytree(state)
    assert kc.launches > before[0]
    if mode == "seq":
        assert kes.launches > before[1]
    for name, lo, hi in ck.container_entries(blob):
        entry = blob[lo:hi]
        n = int.from_bytes(entry[11:14], "little")
        raw = state[name].reshape(-1).view(torch.uint8).cpu().numpy()
        assert entry[:10] + entry[14 + n:] == native.compress_framed(
            raw.tobytes()), name
    before = kc.launches, kds.launches
    back = ck.load_pytree(blob)
    torch.cuda.synchronize()
    assert kc.launches > before[0]
    if mode == "seq":
        assert kds.launches > before[1]
    for k, v in state.items():
        assert back[k].is_cuda and torch.equal(back[k], v), k
    _n, lo, hi = ck.container_entries(blob)[-1]  # "wte.weight"
    chunks, _ = dc._scan_frames(blob[lo:hi])
    _t, p_off, p_len, _c, _d, _h = next(c for c in chunks if c[0] == 1)
    bad = bytearray(blob)
    bad[lo + p_off + p_len // 2] ^= 0x40  # a byte of a stored chunk
    with pytest.raises(dc.ChecksumError):
        ck.load_pytree(bytes(bad))
    with pytest.raises(dc.CorruptError):
        ck.load_pytree(blob[: len(blob) // 2])


def test_stream_writer_on_card(cuda_device):
    """FramedWriter(backend="torch") on the card: one CRC launch per
    buffered batch, the bytes of native.compress_framed; FramedReader
    gives the input back."""
    import io

    from snappy_tpu_torch.runtime.stream import FramedReader, FramedWriter

    data = _corpus(24, 3 << 20) + b"tail" * 999
    sink = io.BytesIO()
    before = kc.launches
    with FramedWriter(sink, backend="torch", buffer_chunks=8) as w:
        for i in range(0, len(data), 1 << 20):
            w.write(data[i : i + (1 << 20)])
    assert kc.launches - before >= (len(data) >> 16) // 8
    assert sink.getvalue() == native.compress_framed(data)
    r = FramedReader(io.BytesIO(sink.getvalue()), backend="torch")
    got = bytearray()
    while piece := r.read(1 << 20):
        got += piece
    assert bytes(got) == data


def _outcome(fn):
    """("ok", bytes) of fn(), or ("error", class name) of its SnappyError."""
    from snappy_tpu_torch.errors import SnappyError

    try:
        out = fn()
    except SnappyError as e:
        return "error", type(e).__name__
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy().tobytes()
    return "ok", bytes(out)


@pytest.mark.parametrize("mode", ["classify", "seq"])
def test_mutation_sweep_on_card(cuda_device, mode, monkeypatch):
    """tests/test_torch_framed_fuzz.py's flip / truncate / splice sweep
    through the kernels on the card (flat_exec and crc32c_rows in the
    classify engine, seq_decode and crc32c_rows in the device LZ engine),
    both framed entry points: each outcome (bytes, or error class) is the
    CPU run's (the plain versions) and the native decoder's, and no
    mutation gives wrong bytes."""
    import random

    if mode == "seq":
        monkeypatch.setattr(dc, "FLAT", False)
        monkeypatch.setattr(dc, "HOST_PARSE", False)
    else:
        monkeypatch.setattr(dc, "FLAT_MODE", mode)
    monkeypatch.setattr(dc, "BATCH", 8)
    rng = random.Random(7200)
    data = (b"fuzz corpus line " * 9000)[:140000] + rng.randbytes(30000)
    framed = native.compress_framed(data)
    before = (kc.launches, kf.launches, kds.launches)
    for k in range(30):
        mut = bytearray(framed)
        if k % 3 == 0:
            mut[rng.randrange(len(mut))] ^= rng.randrange(1, 256)
        elif k % 3 == 1:
            mut = mut[: rng.randrange(1, len(mut))]
        else:
            i = rng.randrange(len(mut))
            n = min(len(mut) - i, rng.randrange(1, 64))
            mut[i : i + n] = rng.randbytes(n)
        mut = bytes(mut)
        want = _outcome(lambda: native.decompress_framed(mut))
        for entry in ("decompress_framed", "decompress_framed_to_device"):
            on_card = _outcome(lambda: getattr(dc, entry)(
                mut, device=cuda_device))
            on_cpu = _outcome(lambda: getattr(dc, entry)(mut, device="cpu"))
            assert on_card == on_cpu, (k, entry)
            assert on_card[0] == want[0], (k, entry)
            if on_card[0] == "ok":
                assert on_card[1] == data, (k, entry)
    assert kc.launches > before[0]
    if mode == "seq":
        assert kds.launches > before[2]
    else:
        assert kf.launches > before[1]


def test_make_mesh_takes_the_local_cards(cuda_device):
    from snappy_tpu_torch.dist import mesh as dm

    mesh = dm.make_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i)
                                 for i in range(torch.cuda.device_count()))
    assert dm.make_mesh(1).devices == (cuda_device,)


def test_dist_forms_on_card(cuda_device):
    """Every per-shard form of dist.mesh on two shards of the card
    against the same form on the 8-shard CPU mesh (the plain versions),
    and the launches they made: crc32c_rows, flat_exec and match_cands."""
    from snappy_tpu_torch.dist import mesh as dm

    card = dm.make_mesh(devices=[cuda_device] * 2)
    cpu8 = dm.make_mesh(devices=["cpu"] * 8)
    data = _corpus(21, 1 << 20)
    fr = native.compress_framed(data)
    before = (kc.launches, kf.launches, km.launches)

    rows, dlens, b = dm.sharded_decompress_framed_to_device(card, fr)
    rows_c, dlens_c, b_c = dm.sharded_decompress_framed_to_device(cpu8, fr)
    assert all(s.device == cuda_device for s in rows.shards)
    assert b == b_c and (dlens == dlens_c).all()
    np.testing.assert_array_equal(rows.numpy(), rows_c.numpy())
    assert dm.sharded_compress_framed_from_device(card, rows, dlens) == fr
    assert (dm.sharded_encode_rows_to_chunks(card, rows, dlens)
            == dm.sharded_encode_rows_to_chunks(cpu8, rows_c, dlens_c))

    blocks = [data[i << 16 : (i + 1) << 16] for i in range(5)] + [
        data[:3000], b""]
    elems = [native.compress(blk) for blk in blocks]
    staged = dm.stage_flat_dec_batch(elems)
    for got, want in zip(dm.sharded_decode_flat(card, *staged, out_max=65536),
                         dm.sharded_decode_flat(cpu8, *staged, out_max=65536)):
        np.testing.assert_array_equal(got, want)
    enc = dm.stage_flat_enc_batch(blocks)[:4]
    np.testing.assert_array_equal(dm.sharded_encode_flat(card, *enc),
                                  dm.sharded_encode_flat(cpu8, *enc))
    ids = dm.stage_dec_id_batch(elems)
    for got, want in zip(dm.sharded_decode_id(card, *ids),
                         dm.sharded_decode_id(cpu8, *ids)):
        np.testing.assert_array_equal(got, want)
    blocks64 = ids[0][:, :65536].copy()
    np.testing.assert_array_equal(dm.sharded_crc(card, blocks64, ids[1]),
                                  dm.sharded_crc(cpu8, blocks64, ids[1]))
    np.testing.assert_array_equal(dm.sharded_match(card, blocks[:3], 65536),
                                  dm.sharded_match(cpu8, blocks[:3], 65536))
    assert kc.launches > before[0]
    assert kf.launches > before[1]
    assert km.launches > before[2]


def _sharded_save(mesh, data, monkeypatch):
    """``compress_framed_from_device`` of ``data``'s chunk rows laid out
    over ``mesh`` against the native stream, the single-tensor path and
    the CPU mesh; every shard's card made its CRC launch, and its rows
    came back from it."""
    from snappy_tpu_torch.dist import mesh as dm

    monkeypatch.setattr(dm, "SHARDS", {"d2h_bytes": [], "crc_launches": []})
    n, cs, size = len(data), 65536, mesh.size
    b = -(-n // cs)
    host = np.zeros((-(-b // size) * size, cs), np.uint8)
    host.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
    lens = np.minimum(n - np.arange(b) * cs, cs).astype(np.int32)
    rows = dm.shard_rows(mesh, torch.from_numpy(host))
    assert [s.device for s in rows.shards] == list(mesh.devices)
    before = kc.launches
    got = dc.compress_framed_from_device(rows, lens)
    want = native.compress_framed(data)
    assert got == want
    assert kc.launches - before >= size
    assert all(dm.SHARDS["crc_launches"])
    per = host.shape[0] // size
    assert dm.SHARDS["d2h_bytes"] == [
        int(lens[k * per : (k + 1) * per].sum())
        + 8 * lens[k * per : (k + 1) * per].size for k in range(size)]
    flat = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    assert dc.compress_framed_from_device(flat.to(mesh.devices[0])) == want
    cpu = dm.shard_rows(dm.make_mesh(devices=["cpu"] * size), rows.cpu())
    assert dc.compress_framed_from_device(cpu, lens) == want
    # a short middle row on every card: a record a row, in row order
    lens2 = lens.copy()
    lens2[1 :: per] = 4097
    assert (dm.sharded_encode_rows_to_chunks(mesh, rows, lens2)
            == dm.sharded_encode_rows_to_chunks(cpu.mesh, cpu, lens2))


def test_sharded_save_on_four_shards_of_the_card(cuda_device, monkeypatch):
    from snappy_tpu_torch.dist import mesh as dm

    data = _corpus(23, 3 << 20)[: (3 << 20) - 12345]
    _sharded_save(dm.make_mesh(devices=[cuda_device] * 4), data, monkeypatch)


def test_sharded_save_on_four_cards(cuda_device, monkeypatch):
    """``make_mesh(4)``: a shard on each of cuda:0-cuda:3, each launching
    its CRC on its own card."""
    from snappy_tpu_torch.dist import mesh as dm

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA GPUs")
    mesh = dm.make_mesh(4)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    data = _corpus(24, 9 << 20)[: (9 << 20) - 999]
    _sharded_save(mesh, data, monkeypatch)


def test_multihost_entry_points_on_card(cuda_device):
    """The multi-host device entry points default to the card's mesh;
    two simulated hosts' records assemble into the single stream."""
    from snappy_tpu_torch.dist import multihost as mh

    data = _corpus(22, 1 << 20)
    fr = native.compress_framed(data)
    out = bytearray(fr[:10])
    for pid in range(2):
        rows, dlens, lo, cnt = mh.host_decompress_framed_to_device(fr, pid, 2)
        assert all(s.device.type == "cuda" for s in rows.shards)
        bodies, lengths = mh.host_compress_framed_from_device(rows, dlens)
        assert len(bodies) == cnt and mh.gather_lengths(lengths) is lengths
        out += b"".join(bodies)
    assert bytes(out) == fr
    before = kc.launches
    bodies, _ = mh.host_compress_framed(data, 0)
    assert fr[:10] + b"".join(bodies) == fr and kc.launches > before


def _framed_payloads(data):
    """(payloads, element starts, decoded lengths) of the compressed
    chunks of native.compress_framed(data)."""
    fr = native.compress_framed(data)
    chunks, _ = dc._scan_frames(fr)
    comp = [ch for ch in chunks if ch[0] == 0]
    return ([fr[ch[1] : ch[1] + ch[2]] for ch in comp],
            [ch[5] for ch in comp], [ch[4] for ch in comp])


@pytest.mark.parametrize("out_max", [65536, 4097, 99_999])
def test_pretagged_kernel_matches_plain(cuda_device, out_max):
    """The record executor on a runtime-shaped batch (64 corpus chunks,
    the parser's records, the bucket of the widest payload) and on
    hand-made streams (a run-length chain, copies shorter than their
    offset), against its plain version on the same card tensors; rows
    wider than the shared image (99,999) run in device memory."""
    from snappy_tpu_torch.kernels import decode_pretagged as kp

    payloads, starts, dlens = _framed_payloads(_corpus(23, 4 << 20))
    payloads, starts, dlens = payloads[:62], starts[:62], dlens[:62]
    lit = bytes(range(200))
    for body, d in ((b"\x00a" + bytes([(59 << 2) | 2, 1, 0]) * 50, 3001),
                    (bytes([61 << 2, 199, 0]) + lit
                     + bytes([(63 << 2) | 2, 3, 0]) * 9, 776)):
        payloads.append(put_uvarint(d) + body)
        starts.append(len(put_uvarint(d)))
        dlens.append(d)
    args = kp.stage_records(payloads, starts, dlens, device=cuda_device)
    before = kp.launches
    got = kp.decode_blocks_pretagged(*args, out_max=out_max)
    torch.cuda.synchronize()
    assert kp.launches == before + 1
    assert torch.equal(got, kp.decode_blocks_pretagged_plain(
        *args, out_max=out_max))
    for i, p in enumerate(payloads):
        want = native.decompress(p)[:out_max]
        assert got[i, : len(want)].cpu().numpy().tobytes() == want


@pytest.mark.parametrize("name", sorted(kp.edge_cases()))
def test_pretagged_kernel_hand_made_records(cuda_device, name):
    """The record executor on each hand-made record set (offset-1 runs,
    chains, sources across group and tile boundaries, a 5,000-byte
    literal, no records, dst_len short, out_max short, a 99,999-byte row,
    a payload too wide to stage) against its plain version on the card and
    the schedule's CPU model."""
    comp, recs, nt, dl, out_max = kp.edge_cases()[name]
    args = [torch.from_numpy(a).to(cuda_device) for a in (comp, recs, nt, dl)]
    before = kp.launches
    got = kp.decode_blocks_pretagged(*args, out_max=out_max)
    torch.cuda.synchronize()
    assert kp.launches == before + 1
    assert torch.equal(got, kp.decode_blocks_pretagged_plain(
        *args, out_max=out_max))
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        kp.execute_records_model(comp, recs, nt, dl, out_max)[0])


@pytest.mark.parametrize("out_max", [65536, 99_999])
def test_pretagged_kernel_unaligned_rows(cuda_device, out_max):
    """Records 4 bytes off a 16-byte boundary and payload rows at an odd
    pitch take the kernel's plain loads instead of its bulk copies."""
    cases = kp.edge_cases()
    comp, recs, nt, dl, _ = cases["straddle"]
    flat = torch.zeros(recs.size + 1, dtype=torch.int32, device=cuda_device)
    recs_d = flat[1:].view(recs.shape)
    recs_d.copy_(torch.from_numpy(recs))
    assert recs_d.data_ptr() % 16 == 4
    wide = torch.zeros(1, comp.shape[1] + 3, dtype=torch.uint8,
                       device=cuda_device)
    comp_d = wide[:, 1 : 1 + comp.shape[1]]
    comp_d.copy_(torch.from_numpy(comp))
    args = (comp_d, recs_d, torch.from_numpy(nt).to(cuda_device),
            torch.from_numpy(dl).to(cuda_device))
    got = kp.decode_blocks_pretagged(*args, out_max=out_max)
    torch.cuda.synchronize()
    assert torch.equal(got, kp.decode_blocks_pretagged_plain(
        *args, out_max=out_max))


def test_hybrid_engine_on_card(cuda_device, monkeypatch):
    """FLAT=0 with HOST_PARSE=1: framed decode to the host and to the
    card through the record executor and the CRC kernel, against the
    native codec; a flipped payload byte raises ChecksumError, a broken
    element CorruptError."""
    from snappy_tpu_torch.kernels import decode_pretagged as kp

    monkeypatch.setattr(dc, "FLAT", False)
    monkeypatch.setattr(dc, "HOST_PARSE", True)
    # a leading 300-byte literal, then the corpus
    data = np.random.default_rng(24).bytes(300) + _corpus(24, 8 << 20)
    fr = native.compress_framed(data)
    before = (kp.launches, kc.launches)
    assert dc.decompress_framed(fr, device=cuda_device) == data
    arr = dc.decompress_framed_to_device(fr, device=cuda_device)
    assert arr.device == cuda_device
    assert arr.cpu().numpy().tobytes() == data
    assert kp.launches > before[0] and kc.launches > before[1]
    bad = bytearray(fr)
    bad[18 + 30] ^= 0x55  # a byte of the first chunk's leading literal
    for fn in (dc.decompress_framed, dc.decompress_framed_to_device):
        with pytest.raises(dc.ChecksumError):
            fn(bytes(bad), device=cuda_device)
    from snappy_tpu_torch.spec.crc32c import crc32c
    from snappy_tpu_torch.spec.format import mask_crc

    payload = put_uvarint(8) + b"\x0cabcd" + bytes([(3 << 2) | 2, 9, 0])
    body = mask_crc(crc32c(b"abcdabcd")).to_bytes(4, "little") + payload
    broken = (fr[:10] + bytes((0, len(body), 0, 0)) + body)
    for fn in (dc.decompress_framed, dc.decompress_framed_to_device):
        with pytest.raises(dc.CorruptError):  # copy before the block start
            fn(broken, device=cuda_device)


def test_portable_codec_on_card_matches_cpu(cuda_device):
    """decode_par and encode_par on the card against their CPU results
    on the same batches (bytes, lengths, flags, error codes)."""
    from snappy_tpu_torch.kernels import decode_par as dp
    from snappy_tpu_torch.kernels import encode_par as ep

    data = _corpus(25, 1 << 20)
    blocks = [data[i << 16 : (i + 1) << 16] for i in range(6)] + [
        data[:3000], b"\xff" * 5000, b""]
    arr = np.zeros((len(blocks), 65536), np.uint8)
    lens = np.array([len(b) for b in blocks], np.int32)
    for i, b in enumerate(blocks):
        arr[i, : len(b)] = np.frombuffer(b, np.uint8)
    cpu = ep.encode_blocks(torch.from_numpy(arr), torch.from_numpy(lens))
    card = ep.encode_blocks(torch.from_numpy(arr).to(cuda_device),
                            torch.from_numpy(lens).to(cuda_device))
    for c, g in zip(cpu, card):
        assert g.device == cuda_device and torch.equal(c, g.cpu())
    comp, clen, _ok = cpu
    args = (comp, torch.zeros(len(blocks), dtype=torch.int32), clen,
            torch.from_numpy(lens))
    out_c, err_c = dp.decode_blocks(*args)
    out_g, err_g = dp.decode_blocks(*(a.to(cuda_device) for a in args))
    assert torch.equal(out_c, out_g.cpu()) and torch.equal(err_c, err_g.cpu())
    assert not err_c.any()
    for i, b in enumerate(blocks):
        assert out_c[i, : len(b)].numpy().tobytes() == b


def test_jnp_engines_on_card(cuda_device, monkeypatch):
    """SNAPPY_TPU_PALLAS=0: the jnp encoder's framed stream on the card
    equals the CPU's and round-trips; the jnp decoder (HOST_PARSE=0) and
    the hybrid engine decode it on the card."""
    monkeypatch.setattr(dc, "PALLAS", False)
    data = _corpus(26, 2 << 20)
    fr = dc.compress_framed(data, device=cuda_device)
    assert fr == dc.compress_framed(data, device="cpu")
    assert native.decompress_framed(fr) == data
    for host_parse in (False, True):
        monkeypatch.setattr(dc, "HOST_PARSE", host_parse)
        assert dc.decompress_framed(fr, device=cuda_device) == data


def test_mesh_codec_forms_on_card(cuda_device):
    """sharded_encode, sharded_decode and roundtrip_step on two shards of
    the card against the two-shard CPU mesh."""
    from snappy_tpu_torch.dist import mesh as dm

    card = dm.make_mesh(devices=[cuda_device] * 2)
    cpu2 = dm.make_mesh(devices=["cpu"] * 2)
    bmax = 1024
    rng = np.random.default_rng(0)
    blocks = np.zeros((16, bmax), np.uint8)
    lens = np.zeros(16, np.int32)
    for i in range(16):
        row = ((b"sharded snappy block " * 50)[:bmax],
               rng.integers(0, 256, bmax, dtype=np.uint8).tobytes(),
               b"Z" * (bmax // 2))[i % 3]
        blocks[i, : len(row)] = np.frombuffer(row, np.uint8)
        lens[i] = len(row)
    enc = dm.sharded_encode(card, blocks, lens, bmax)
    for g, w in zip(enc, dm.sharded_encode(cpu2, blocks, lens, bmax)):
        np.testing.assert_array_equal(g, w)
    comp, clen, ok = enc
    assert ok.all()
    dec_args = (comp, np.zeros(16, np.int32), clen, lens)
    for g, w in zip(dm.sharded_decode(card, *dec_args, out_max=bmax),
                    dm.sharded_decode(cpu2, *dec_args, out_max=bmax)):
        np.testing.assert_array_equal(g, w)
    got = dm.roundtrip_step(card, blocks, lens, bmax)
    want = dm.roundtrip_step(cpu2, blocks, lens, bmax)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.cpu() if torch.is_tensor(g)
                                                 else g),
                                      np.asarray(w))
    assert bool(got[6]) and not np.asarray(got[5]).any()


def test_no_native_path_on_card(cuda_device, monkeypatch):
    """Without the native library the framed and raw codec runs on the
    card: every CRC on the CRC kernel, the guard's reference element on
    the sequential encoder, no native function called; the streams are
    ``encode_np``'s emission (the JAX package's jnp encoder and guard),
    framed with the native CRCs computed beforehand."""
    from snappy_tpu_torch.kernels.encode_np import encode_block_np
    from snappy_tpu_torch.spec.format import STREAM_ID_CHUNK

    data = _corpus(19, 1 << 20)
    chunks = [data[i : i + 65536] for i in range(0, len(data), 65536)]
    elems = [encode_block_np(c) for c in chunks]
    want = bytes(STREAM_ID_CHUNK) + b"".join(
        dc._framed_record(len(c), e, native.crc32c(c), c)
        for c, e in zip(chunks, elems))
    want_raw = put_uvarint(len(data)) + b"".join(elems)
    called = []
    for name in dir(native):
        fn = getattr(native, name)
        if (not name.startswith("_") and callable(fn)
                and getattr(fn, "__module__", None) == native.__name__):
            monkeypatch.setattr(native, name,
                                lambda *a, _n=name, **k: called.append(_n))
    monkeypatch.setattr(native, "available", lambda: False)
    crc0, enc0 = kc.launches, kes.launches
    fr = dc.compress_framed(data, device=cuda_device)
    assert fr == want
    assert kc.launches > crc0 and kes.launches > enc0
    assert dc.decompress_framed(fr, device=cuda_device) == data
    arr = dc.decompress_framed_to_device(fr, device=cuda_device)
    assert arr.device == cuda_device
    assert dc.compress_framed_from_device(arr) == want
    raw = dc.compress(data, device=cuda_device)
    assert raw == want_raw
    arr = dc.decompress_to_device(raw, device=cuda_device)
    assert arr.device == cuda_device
    assert arr.cpu().numpy().tobytes() == data
    assert dc.compress_from_device(arr) == want_raw
    assert called == []


def _par_plain_raises(monkeypatch):
    """Make the parallel engines' plain versions (their torch-ops bodies)
    raise, so a call that reaches them fails."""
    from snappy_tpu_torch.kernels import decode_par as dp
    from snappy_tpu_torch.kernels import encode_par as ep

    def raiser(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for mod, name in ((dp, "_decode"), (dp, "decode_blocks_plain"),
                      (ep, "encode_blocks_plain"), (ep, "_find_matches"),
                      (ep, "_emit")):
        monkeypatch.setattr(mod, name, raiser)


def _decode_par_rows():
    """Corpus chunks, the corrupt raw streams of chip_smoke, the fuzz
    payloads and random garbage, each set as (streams, cmax, out_max)."""
    from chip_smoke import _bad_streams
    from snappy_tpu_torch.kernels import decode_par as dp
    from snappy_tpu_torch.kernels import encode_par as ep

    data = _corpus(31, 1 << 20)
    rng = np.random.default_rng(31)
    garbage = [bytes([int(rng.integers(0, 128))]) + rng.integers(
        0, 256, int(rng.integers(0, 120)), np.uint8).tobytes()
        for _ in range(96)]
    # element streams of 2**17-byte blocks with copy-4 elements (the
    # plain encoder on the host), and one cut short
    blocks = [ep.wide_block(31), ep.wide_block(32)]
    comp, clen, _ = ep.encode_blocks_plain(*(torch.from_numpy(a) for a in
                                             ep.stage_blocks(blocks, 1 << 17)),
                                           1 << 17)
    copy4 = [put_uvarint(len(b)) + comp[i, : clen[i]].numpy().tobytes()
             for i, b in enumerate(blocks)]
    # long garbage: several 4 KiB chunks of the wide rows' walk a row
    long_garbage = [bytes([int(rng.integers(0, 128))]) + rng.integers(
        0, 256, int(rng.integers(0, 20000)), np.uint8).tobytes()
        for _ in range(32)]
    return {"corpus": ([native.compress(data[i << 16 : (i + 1) << 16])
                        for i in range(12)], 66560, 65536),
            "hostile": (_bad_streams() + dp.edge_streams(), 256, 256),
            "garbage": (garbage, 256, 1024),
            "wide rows": ([native.compress(data[:99_999]),
                           native.compress(b"w" * 99_999)], 1 << 17, 99_999),
            "copy-4 rows": (copy4 + [copy4[0][:-3]], 1 << 17, 1 << 17),
            "wide garbage": (long_garbage + [native.compress(data[:100_000])],
                             65536, 1 << 17),
            "resync": (dp.resync_streams(), 46080, 65536),
            "resync wide": (dp.resync_streams(), 46080, 1 << 17)}


@pytest.mark.parametrize("name", ["corpus", "hostile", "garbage",
                                  "wide rows", "copy-4 rows",
                                  "wide garbage", "resync", "resync wide"])
def test_decode_par_kernel_matches_plain(cuda_device, monkeypatch, name):
    """csrc/decode_par.cu against decode_par's plain version on the same
    card tensors: every error code, the bytes of every good row, every
    row with an error all zero; the plain body made to raise while the
    kernel runs.  Rows of at most 64 KiB take the chunked walk and the
    record executor, wider rows ("wide rows", "copy-4 rows", "wide
    garbage", "resync wide") the chunked walk and the pointer path;
    "resync" rows are walked in chunks that the true walk enters off
    phase and never meets (``decode_par.resync_streams``)."""
    from snappy_tpu_torch.kernels import decode_par as dp
    from snappy_tpu_torch.kernels import encode_par as ep

    streams, cmax, out_max = _decode_par_rows()[name]
    args = [torch.from_numpy(a).to(cuda_device)
            for a in dp.stream_rows(streams, cmax)]
    pout, perr = dp.decode_blocks_plain(*args, out_max=out_max)
    _par_plain_raises(monkeypatch)
    before = dp.launches
    out, err = dp.decode_blocks(*args, out_max=out_max)
    torch.cuda.synchronize()
    assert dp.launches == before + 1 and out.device == cuda_device
    assert torch.equal(err, perr)
    good = perr == 0
    assert torch.equal(out[good], pout[good])
    assert not out[~good].any()
    if name in ("corpus", "wide rows"):
        assert not err.any()
    if name.startswith("resync"):
        assert err.tolist() == [0, 0, dp.ERR_OVERRUN_INPUT]
    if name == "copy-4 rows":
        assert err.tolist() == [0, 0, dp.ERR_SIZE_MISMATCH]
        for i, seed in enumerate((31, 32)):
            assert out[i].cpu().numpy().tobytes() == ep.wide_block(seed)


def test_decode_par_kernel_round_counts(cuda_device):
    """On the card the round counts must bound nothing: fewer raise
    ValueError; decode_block_par's scaled counts decode a 1 MiB raw
    stream in one row."""
    from snappy_tpu_torch.kernels import decode_par as dp

    args = [torch.from_numpy(a).to(cuda_device)
            for a in dp.stream_rows([native.compress(b"abc" * 99)], 256)]
    with pytest.raises(ValueError):
        dp.decode_blocks(*args, out_max=1024, tag_rounds=3)
    with pytest.raises(ValueError):
        dp.decode_blocks(*args, out_max=1024, ptr_rounds=9)
    out, err = dp.decode_blocks(*args, out_max=1024, tag_rounds=7,
                                ptr_rounds=10)
    assert int(err[0]) == 0 and out[0, :297].cpu().numpy().tobytes() == \
        b"abc" * 99
    data = _corpus(32, 1 << 20)
    raw = native.compress(data)
    dlen, hdr = read_uvarint(raw, 0)
    got = dp.decode_block_par_to_device(raw, dlen, start=hdr,
                                        device=cuda_device)
    assert got.device == cuda_device
    assert got.cpu().numpy().tobytes() == data


@pytest.mark.parametrize("bmax", [8192, 65536, 1 << 17])
def test_encode_par_kernel_matches_plain(cuda_device, monkeypatch, bmax):
    """csrc/encode_par.cu against encode_par's plain version on the same
    card tensors: every byte, length and flag, on corpus blocks, the
    hostile blocks (a run, a period-3 pattern, random bytes, a lazy
    chain, all-0xFF, 1-3 bytes, empty) and, at 2**17, the wide block
    (copy-4 elements); the plain body made to raise while the kernels
    run.  Every row decodes back to its block, on the host and, at
    2**17, with decode_par's kernel on the card."""
    from snappy_tpu_torch.kernels import decode_par as dp
    from snappy_tpu_torch.kernels import encode_par as ep
    from snappy_tpu_torch.spec import reference

    data = _corpus(33, 1 << 20)
    blocks = [data[i * bmax : i * bmax + bmax] for i in range(4)]
    blocks += [data[5 : 5 + bmax // 3], data[:17]]
    blocks += [b[:bmax] for b in ep.edge_blocks(33).values()]
    if bmax == 1 << 17:
        blocks.append(ep.wide_block(33))
    arr, lens = ep.stage_blocks(blocks, bmax)
    b, n = (torch.from_numpy(x).to(cuda_device) for x in (arr, lens))
    want = ep.encode_blocks_plain(b, n, bmax)
    _par_plain_raises(monkeypatch)
    before = ep.launches
    got = ep.encode_blocks(b, n, bmax)
    torch.cuda.synchronize()
    assert ep.launches == before + 1
    for g, w in zip(got, want):
        assert g.device == cuda_device and torch.equal(g, w)
    assert bool(want[2].all())
    comp, clen = got[0].cpu().numpy(), got[1].cpu().numpy()
    streams = [put_uvarint(len(blk)) + comp[i, : clen[i]].tobytes()
               for i, blk in enumerate(blocks)]
    for stream, blk in zip(streams, blocks):
        assert reference.decompress(stream) == blk
    if bmax == 1 << 17:
        rows = dp.stream_rows(streams, ep.derived_sizes(bmax)[2] + 8)
        out, err = dp.decode_blocks(*(torch.from_numpy(a).to(cuda_device)
                                      for a in rows), out_max=bmax)
        assert not err.any()
        for i, blk in enumerate(blocks):
            assert out[i, : len(blk)].cpu().numpy().tobytes() == blk


@pytest.mark.parametrize("bmax", [65536, 1 << 17])
def test_encode_par_kernel_resync_blocks(cuda_device, monkeypatch, bmax):
    """csrc/encode_par.cu against its plain version on the hand-made
    blocks whose walks do not meet inside a chunk
    (``encode_par.resync_blocks``: every copy 4 bytes with the true walk
    off the chunks' phase, and a copy across two chunk ends), each
    alone and all at once: the same bytes, lengths and flags, and every
    row decodes back."""
    from snappy_tpu_torch.kernels import encode_par as ep
    from snappy_tpu_torch.spec import reference

    blocks = list(ep.resync_blocks(35, 65536).values())
    if bmax == 1 << 17:
        blocks.append(b"".join(blocks))
    arr, lens = ep.stage_blocks(blocks, bmax)
    b, n = (torch.from_numpy(x).to(cuda_device) for x in (arr, lens))
    want = ep.encode_blocks_plain(b, n, bmax)
    _par_plain_raises(monkeypatch)
    got = ep.encode_blocks(b, n, bmax)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    comp, clen = got[0].cpu().numpy(), got[1].cpu().numpy()
    for i, blk in enumerate(blocks):
        assert reference.decode_block(comp[i, : clen[i]].tobytes(),
                                      len(blk)) == blk


def test_par_engines_on_card_reach_no_plain_version(cuda_device,
                                                    monkeypatch):
    """SNAPPY_TPU_PALLAS=0 with HOST_PARSE=0: the jnp engines' framed
    encode and decode on the card run the two kernels and never a
    plain version; the stream round-trips."""
    from snappy_tpu_torch.kernels import decode_par as dp
    from snappy_tpu_torch.kernels import encode_par as ep

    data = _corpus(34, 2 << 20)
    monkeypatch.setattr(dc, "PALLAS", False)
    monkeypatch.setattr(dc, "HOST_PARSE", False)
    _par_plain_raises(monkeypatch)
    d0, e0 = dp.launches, ep.launches
    fr = dc.compress_framed(data, device=cuda_device)
    assert native.decompress_framed(fr) == data
    assert dc.decompress_framed(fr, device=cuda_device) == data
    assert dp.launches > d0 and ep.launches > e0
