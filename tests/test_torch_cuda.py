"""CUDA kernels of the torch port on the card: each kernel against its
plain PyTorch version and the native codec, and the main path through
the kernels in every runtime mode.  Tolerance: 0 (bit-exact).

This file imports no jax, so it runs where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(tests/conftest.py imports jax).  Without a GPU every test skips."""

import numpy as np
import pytest
import torch

from snappy_tpu import native
from snappy_tpu.bench.corpus import make_corpus
from snappy_tpu.kernels import match_np
from snappy_tpu_torch.kernels import crc32c as kc
from snappy_tpu.spec.format import put_uvarint, read_uvarint
from snappy_tpu_torch.kernels import decode_flat as kf
from snappy_tpu_torch.kernels import decode_seq as kds
from snappy_tpu_torch.kernels import decode_wavegroup as kw
from snappy_tpu_torch.kernels import encode_flat as ke
from snappy_tpu_torch.kernels import encode_seq as kes
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
    seq0 = kds.launches, kes.launches
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


def test_wave_engine(cuda_device):
    """The wave engine of chip_smoke.py at 2 MiB: native.compress
    streams, stage_waves, launches of 8 rows, compared on the device."""
    data = _corpus(22)
    blocks = _blocks(data)
    streams = [native.compress(b) for b in blocks]
    ref = torch.frombuffer(bytearray(data[: len(blocks) << 16]),
                           dtype=torch.uint8).to(cuda_device).view(-1, 65536)
    before = kw.launches
    for lo in range(0, len(blocks), 8):
        staged = kw.stage_waves(streams[lo : lo + 8])
        assert staged is not None
        out = kw.decode_blocks_wavegroup(
            *(t.to(cuda_device) for t in staged), 65536)
        assert torch.equal(out, ref[lo : lo + 8])
    assert kw.launches == before + (len(blocks) + 7) // 8


def test_devmatch_engine(cuda_device):
    """The devmatch engine of chip_smoke.py at 2 MiB: candidates on the
    card, emission on the host, every emission decoding to its block,
    and the total smaller than the native encoder's bodies."""
    blocks = _blocks(_corpus(23))
    before = km.launches
    emitted = ref = 0
    for lo in range(0, len(blocks), 8):
        batch = blocks[lo : lo + 8]
        cands = km.find_candidates_device(batch, device=cuda_device)
        for blk, c in zip(batch, cands):
            body = native.emit_from_cands(blk, np.ascontiguousarray(c))
            assert native.decompress(put_uvarint(len(blk)) + body) == blk
            emitted += len(body)
            ref += len(native.compress(blk)) - len(put_uvarint(len(blk)))
    assert km.launches == before + (len(blocks) + 7) // 8
    assert emitted < ref
