"""Flat-plan executor of the torch port against the JAX package's
Pallas kernel (interpret mode) and numpy contracts, on identical plans
staged by the shared native library and carried over with
plan_from_numpy.  Tolerance: 0 (byte-exact)."""

import numpy as np
import pytest
import torch

import snappy_tpu.kernels.decode_flat as jdf
import snappy_tpu.kernels.encode_flat as jef
from snappy_tpu import native
from snappy_tpu.bench.corpus import make_corpus
from snappy_tpu_torch.kernels import decode_flat as kf
from snappy_tpu_torch.kernels import encode_flat as ke
from snappy_tpu_torch.runtime.device_codec import _scan_frames


def _corpus(seed, total=640 * 1024):
    return b"".join(d for _, d in make_corpus(total, seed=seed))


def _decode_plans(data: bytes, nb: int):
    """Native decode plans (stage_flat_dec_batch) of the first nb
    compressed chunks of data's framed stream, with the chunks' bytes."""
    fr = native.compress_framed(data)
    chunks, _ = _scan_frames(fr)
    comp = [c for c in chunks if c[0] == 0][:nb]
    n = len(comp)
    rb = kf.rows_b_for(66560)
    b_u8 = np.empty((n, rb * 128), np.uint8)
    meta = np.empty((n, 8 * kf.TRIP_CAP, 128), np.int32)
    starts = np.zeros((n, 8, 128), np.int32)
    rc = np.zeros(n, np.int64)
    arrs = [np.array([c[f] for c in comp], np.int64) for f in (1, 2, 5, 4)]
    assert native.stage_flat_dec_batch(np.frombuffer(fr, np.uint8), *arrs,
                                       rb, meta, starts, b_u8, rc) == 0
    want = [native.decompress(fr[c[1]:c[1] + c[2]]) for c in comp]
    return b_u8, meta, starts, rc.astype(np.int32), want


def _encode_plans(data: bytes, nb: int):
    n = min(nb, len(data) // 65536)
    blocks = np.frombuffer(data[: n * 65536], np.uint8).reshape(n, 65536)
    b_u8 = np.empty((n, ke.RB_ENC * 128), np.uint8)
    meta = np.empty((n, 8 * ke.ENC_TRIP_CAP, 128), np.int32)
    starts = np.zeros((n, 8, 128), np.int32)
    elem = np.empty((n, native.max_compressed_length(65536) + 8), np.uint8)
    clens, hdrs, rc = (np.zeros(n, np.int64) for _ in range(3))
    assert native.stage_flat_enc_batch(
        blocks, np.full(n, 65536, np.int64), ke.RB_ENC, meta, starts, b_u8,
        ke.TAG_ROWS * 128, elem, clens, hdrs, rc) == 0
    want = [elem[i, : clens[i]].tobytes() for i in range(n)]
    return b_u8, meta, starts, rc.astype(np.int32), want


def _trips(meta, ntr):
    """meta cut to the batch's trips: the JAX interpret kernel then
    walks no empty trip rows (the runtime's _flat_trim does the same)."""
    t = max(1, int((ntr & 0xFFFF).max()))
    return np.ascontiguousarray(meta[:, : 8 * t])


def test_constants_match_reference():
    for name in ("VEC", "NSUB", "PANEL", "W_ROWS", "PAT_ROWS", "OUT_ROWS",
                 "TRIP_CAP", "DIRECT_T", "_VALID"):
        assert getattr(kf, name) == getattr(jdf, name), name
    for name in ("SRC_SPAN", "TAG_ROWS", "ENC_TRIP_CAP", "RB_ENC",
                 "OUT_ROWS_ENC", "ENC_DST_MAX"):
        assert getattr(ke, name) == getattr(jef, name), name
    for c in (0, 1, 127, 128, 16640, 33280, 66560, 131072):
        assert kf.rows_b_for(c) == jdf.rows_b_for(c)
        assert kf.mirror_base_for(c) == jdf.mirror_base_for(c)


def test_decode_plans_match_jax_kernel_and_contract():
    b_u8, meta, starts, ntr, want = _decode_plans(_corpus(11), 6)
    # the compose clamp: some subpanel starts past row out_rows - 128
    used = [(starts[i].reshape(-1)[: 4 * (ntr[i] & 0xFFFF)] >> 10) & 1023
            for i in range(len(ntr))]
    assert max(int(u.max()) for u in used) > kf.OUT_ROWS - 128
    got = kf.decode_blocks_flat(*kf.plan_from_numpy(b_u8, meta, starts, ntr,
                                                    "cpu"), dst_max=65536)
    ref = np.asarray(jdf.decode_blocks_flat(
        b_u8, _trips(meta, ntr), starts, ntr, dst_max=65536, interpret=True))
    assert np.array_equal(got.numpy(), ref)
    for i, w in enumerate(want):
        assert got[i, : len(w)].numpy().tobytes() == w
        np_out = kf.execute_flat_np(meta[i], starts[i], int(ntr[i]), b_u8[i],
                                    65536)
        assert np.array_equal(np_out, jdf.execute_flat_np(
            meta[i], starts[i], int(ntr[i]), b_u8[i], 65536))
        assert np.array_equal(got[i].numpy(), np_out)


def test_encode_plans_match_jax_kernel_and_contract():
    data = _corpus(12)
    b_u8, meta, starts, ntr, want = _encode_plans(data, 4)
    got = ke.encode_blocks_flat(*kf.plan_from_numpy(b_u8, meta, starts, ntr,
                                                    "cpu"))
    assert got.shape == (len(want), ke.ENC_DST_MAX)
    ref = np.asarray(jef.encode_blocks_flat(
        b_u8, _trips(meta, ntr), starts, ntr, interpret=True))
    assert np.array_equal(got.numpy(), ref)
    plain = ke.encode_blocks_flat_plain(*kf.plan_from_numpy(
        b_u8, meta, starts, ntr, "cpu"))
    assert torch.equal(got, plain)
    for i, w in enumerate(want):
        assert got[i, : len(w)].numpy().tobytes() == w
        assert ke.replay_enc_np(meta[i], starts[i], int(ntr[i]), b_u8[i],
                                len(w)).tobytes() == w


def _one_piece_plan(dq: int, drel: int, rot: int, out_rows: int):
    """One valid piece: 100 bytes at lane 3 of destination row dq+drel,
    read from a random B buffer at source phase rot.  A rot-0 piece
    rides an aligned trip (ntrips' high half), as pack_trips packs it."""
    rng = np.random.default_rng(dq * 7 + rot)
    b_u8 = rng.integers(0, 256, (1, 1040 * 128), dtype=np.uint8)
    meta = np.zeros((1, 8, 128), np.int32)
    starts = np.zeros((1, 8, 128), np.int32)
    qrel, dphi, lenm1 = 9, 3, 99
    meta[0, 0, 5] = qrel | (rot << 7)
    meta[0, 4, 5] = dphi | (lenm1 << 7) | (drel << 14) | kf._VALID
    starts[0, 0, 0] = 200 | (dq << 10) | (rot << 20)
    return b_u8, meta, starts, np.array([1 | ((rot == 0) << 16)], np.int32)


@pytest.mark.parametrize("dq,drel,rot,out_rows", [
    (500, 5, 0, 520),    # Dq past out_rows - 128: D clamps to 392
    (390, 100, 17, 520),  # just below the clamp, rotated source
    (600, 30, 64, 640),   # the encode panel's clamp
])
def test_compose_clamp(dq, drel, rot, out_rows):
    b_u8, meta, starts, ntr = _one_piece_plan(dq, drel, rot, out_rows)
    dst_max = out_rows * 128
    got = kf.decode_blocks_flat(*kf.plan_from_numpy(b_u8, meta, starts, ntr,
                                                    "cpu"),
                                dst_max=dst_max, out_rows=out_rows)
    ref = np.asarray(jdf.decode_blocks_flat(
        b_u8, meta, starts, ntr, dst_max=dst_max, out_rows=out_rows,
        interpret=True))
    assert np.array_equal(got.numpy(), ref)
    phi = (128 - rot) & 127
    src = (200 + 9) * 128 + phi
    dst = (dq + drel) * 128
    want = np.zeros(dst_max, np.uint8)
    want[dst + 3 : dst + 103] = b_u8[0, src + 3 : src + 103]
    assert np.array_equal(got[0].numpy(), want)


def test_out_argument_and_empty_rows():
    """out= writes rows of a larger buffer; rows with ntrips 0 come out
    zero; ntrips' high half (aligned-trip count) is ignored."""
    b_u8, meta, starts, ntr, want = _decode_plans(_corpus(13, 256 * 1024), 3)
    ntr = ntr.copy()
    ntr[1] = 0
    big = torch.full((5, 65536), 7, dtype=torch.uint8)
    res = kf.decode_blocks_flat(*kf.plan_from_numpy(b_u8, meta, starts, ntr,
                                                    "cpu"),
                                dst_max=65536, out=big[1:4])
    assert res.data_ptr() == big[1].data_ptr()
    assert big[1, : len(want[0])].numpy().tobytes() == want[0]
    assert int(big[2].max()) == 0
    assert big[3, : len(want[2])].numpy().tobytes() == want[2]
    assert int(big[0].min()) == 7 and int(big[4].min()) == 7


def test_plan_from_numpy_types():
    b_u8, meta, starts, ntr, _ = _decode_plans(_corpus(14, 128 * 1024), 1)
    b, m, s, n = kf.plan_from_numpy(b_u8, meta, starts, ntr.astype(np.int64),
                                    "cpu")
    assert (b.dtype, m.dtype, s.dtype, n.dtype) == (
        torch.uint8, torch.int32, torch.int32, torch.int32)
    with pytest.raises(ValueError):
        kf.decode_blocks_flat(b, m[:, :7], s, n, dst_max=65536)
    with pytest.raises(ValueError):
        kf.decode_blocks_flat(b.to(torch.int32), m, s, n, dst_max=65536)
