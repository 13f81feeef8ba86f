"""CUDA kernels of the torch port on the card: each kernel against its
plain PyTorch version and the native codec, and the main path through
both kernels.  Tolerance: 0 (bit-exact).

This file imports no jax, so it runs where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(tests/conftest.py imports jax).  Without a GPU every test skips."""

import numpy as np
import pytest
import torch

from snappy_tpu import native
from snappy_tpu.bench.corpus import make_corpus
from snappy_tpu_torch.kernels import crc32c as kc
from snappy_tpu_torch.kernels import decode_flat as kf
from snappy_tpu_torch.kernels import encode_flat as ke
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


@pytest.mark.parametrize("mode", ["id", "classify"])
def test_main_path_through_kernels(cuda_device, mode, monkeypatch, rng):
    monkeypatch.setattr(dc, "FLAT_MODE", mode)
    monkeypatch.setattr(dc, "BATCH", 8)
    data = _corpus(17, 3 << 20) + rng.bytes(100_000)
    crc0, flat0 = kc.launches, kf.launches
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
    bad = bytearray(stream)
    bad[14] ^= 0x01
    with pytest.raises(dc.ChecksumError):
        dc.decompress_framed_to_device(bytes(bad), device=cuda_device)
