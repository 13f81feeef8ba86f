"""The portable parallel encoder (``snappy_tpu_torch.kernels.encode_par``)
and its helpers (``kernels.common_par``) against the JAX package's
``encode_jnp`` / ``common_jnp`` and the numpy reference ``encode_np`` on
the same seeded blocks: every emitted byte, every length and every ok
flag; tiny blocks, mixed lengths, one 64 KiB batch, and the mod-2^32
hash arithmetic held against numpy uint32 on all-0xFF blocks.
Counterpart of ``tests/test_encode_jnp.py``.  Tolerance: 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_corpus_samples
from snappy_tpu.kernels import common_jnp, encode_jnp, encode_np
from snappy_tpu.spec import reference
from snappy_tpu_torch.kernels import common_par as cp
from snappy_tpu_torch.kernels import encode_np as tnp
from snappy_tpu_torch.kernels import encode_par as ep


def _batch(samples, bmax):
    arr = np.zeros((len(samples), bmax), np.uint8)
    lens = np.zeros(len(samples), np.int32)
    for i, s in enumerate(samples):
        arr[i, : len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return arr, lens


def _assert_same(samples, bmax):
    """The port's (comp, comp_len, ok) equal JAX's, and each row's
    element equals both numpy references'."""
    arr, lens = _batch(samples, bmax)
    comp, clen, ok = ep.encode_blocks(torch.from_numpy(arr),
                                      torch.from_numpy(lens), bmax=bmax)
    jc, jl, jo = (np.asarray(x) for x in encode_jnp.encode_blocks(
        arr, lens, bmax=bmax))
    assert comp.dtype == torch.uint8 and clen.dtype == torch.int32
    assert comp.shape == jc.shape == (len(samples), ep.derived_sizes(bmax)[2])
    np.testing.assert_array_equal(clen.numpy(), jl)
    np.testing.assert_array_equal(ok.numpy(), jo)
    np.testing.assert_array_equal(comp.numpy(), jc)
    assert ok.all()
    for i, s in enumerate(samples):
        blob = comp[i, : int(clen[i])].numpy().tobytes()
        if s:
            assert blob == encode_np.encode_block_np(s) == \
                tnp.encode_block_np(s)
            assert reference.decode_block(blob, len(s)) == s
        else:
            assert blob == b""


def test_identical_to_jax_and_numpy(rng):
    samples = [s for s in make_corpus_samples(rng, sizes=(4, 17, 64, 1000,
                                                          4096)) if s]
    _assert_same(samples, 8192)


def test_tiny_blocks():
    _assert_same([(b"abcab" * 6)[:n] for n in range(1, 24)], 256)


def test_batch_mixed_lengths(rng):
    _assert_same([rng.randbytes(100), b"x" * 3000, b"", rng.randbytes(4095)],
                 4096)


def test_one_64k_batch(rng):
    _assert_same([rng.randbytes(65536),
                  (b"the quick brown fox. " * 4000)[:65536], b"A" * 65536,
                  bytes(rng.choices(range(8), k=65536))], 65536)


def test_all_ff_blocks_and_the_sort_tie(rng):
    """All-0xFF words are 0xFFFFFFFF, whose sort key ties with the key of
    an invalid position: the stable sort must keep JAX's order."""
    _assert_same([b"\xff" * 3000, b"\xff" * 7 + b"\x00" * 3 + b"\xff" * 200,
                  (b"\xff\xfe" * 900)[:1777], b"\xff" * 4,
                  bytes(2000) + b"\xff" * 9], 4096)


def test_mul32_and_prefix_hashes_vs_uint32(nprng):
    """The mod-2^32 products and prefix hashes equal numpy's uint32
    arithmetic, all-0xFF blocks (the largest terms) included."""
    a = nprng.integers(0, 1 << 32, 5000, dtype=np.uint64)
    b = nprng.integers(0, 1 << 32, 5000, dtype=np.uint64)
    a[:3] = b[:3] = 0xFFFFFFFF
    want = (a.astype(np.uint32) * b.astype(np.uint32)).astype(np.int64)
    got = cp.mul32(torch.from_numpy(a.astype(np.int64)),
                   torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)

    pa, ipa, pb, ipb = cp._pow_tables()
    for blk in (np.full(4096, 0xFF, np.uint8),
                nprng.integers(0, 256, 4096, dtype=np.uint8)):
        ha, hb = cp.prefix_hashes(torch.from_numpy(blk[None, :]))
        for got_h, pw in ((ha, pa), (hb, pb)):
            h = np.zeros(blk.size + 1, np.uint32)  # Horner, in uint32
            with np.errstate(over="ignore"):
                for i, x in enumerate(blk.astype(np.uint32)):
                    h[i + 1] = h[i] * pw[1] + x
            np.testing.assert_array_equal(got_h[0].numpy(), h.astype(np.int64))
        jha, jhb = common_jnp.prefix_hashes(jnp.asarray(blk))
        np.testing.assert_array_equal(ha[0].numpy(), np.asarray(jha))
        np.testing.assert_array_equal(hb[0].numpy(), np.asarray(jhb))
    for k, t in enumerate(common_jnp._pow_tables()):
        np.testing.assert_array_equal(cp._pow_tables()[k], t)


def test_doubling_helpers_match_jax(nprng):
    """mark_orbit, mark_orbits2 (fixed round counts here, early exit in
    JAX), resolve_pointers and the 4-gram words against common_jnp."""
    B, size = 6, 300
    pos = np.arange(size)
    nxt = np.minimum(pos + nprng.integers(1, 9, (B, size)), size).astype(
        np.int32)
    start = nprng.integers(0, 5, B).astype(np.int32)
    want = np.asarray(jax.vmap(lambda n, s: common_jnp.mark_orbit(n, s, 17))(
        nxt, start))
    got = cp.mark_orbit(torch.from_numpy(nxt), torch.from_numpy(start), 17)
    np.testing.assert_array_equal(got.numpy(), want)

    nxt2 = np.stack([nxt, np.minimum(pos + 1 + (pos % 3), size).astype(
        np.int32)[None].repeat(B, 0)], axis=1)
    want2 = np.asarray(jax.vmap(
        lambda n: common_jnp.mark_orbits2(n, jnp.int32(1), 17))(nxt2))
    got2 = cp.mark_orbits2(torch.from_numpy(nxt2), 1, 17)
    np.testing.assert_array_equal(got2.numpy(), want2)

    ptr = np.where(nprng.random((B, size)) < 0.3,
                   -nprng.integers(1, 50, (B, size)),
                   nprng.integers(0, size, (B, size))).astype(np.int32)
    ptr = np.where(ptr >= pos, -1, ptr).astype(np.int32)  # point backwards
    want3 = np.asarray(jax.vmap(lambda p: common_jnp.resolve_pointers(p, 17))(
        ptr))
    np.testing.assert_array_equal(
        cp.resolve_pointers(torch.from_numpy(ptr), 17).numpy(), want3)

    blk = nprng.integers(0, 256, (B, 64), dtype=np.uint8)
    want4 = np.asarray(jax.vmap(common_jnp.bytes_to_u32_words)(blk))
    np.testing.assert_array_equal(
        cp.bytes_to_u32_words(torch.from_numpy(blk)).numpy(),
        want4.astype(np.int64))


def test_encode_block_par_wrapper(rng):
    assert ep.encode_block_par(b"", device="cpu") == b""
    for s in (b"a", rng.randbytes(700), b"wrapper " * 300):
        assert ep.encode_block_par(s, device="cpu") == tnp.encode_block_np(s)
    s = b"wrapper " * 100
    assert ep.encode_block_par(s, device="cpu") == \
        encode_jnp.encode_block_jnp(s)
    with pytest.raises(ValueError):
        ep.encode_blocks(torch.zeros(1, 8, dtype=torch.uint8),
                         torch.zeros(1, dtype=torch.int32), bmax=16)
