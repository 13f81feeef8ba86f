"""Match finder of the torch port against the JAX package's Pallas kernel
(interpret mode) and the numpy contract ``match_np.find_candidates``, in
both routes, and the native emission built on its candidates.
Tolerance: 0 (bit-exact int32 patterns)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappy_tpu import native
from snappy_tpu.kernels import match_np, pallas_match
from snappy_tpu.spec import reference as oracle
from snappy_tpu_torch.kernels import match as km

SLOTS = 4096


def _blocks():
    """test_match.py's parity cases cut to 4,096 slots, plus the empty
    and the 4-byte block; "random" fills its slots exactly."""
    rng = np.random.default_rng(1234)
    return {
        "text": (b"the quick brown fox jumps " * 600)[:4000],
        "random": rng.bytes(SLOTS),
        "lowent": bytes(rng.integers(97, 102, 3000, dtype=np.uint8)),
        "tiny": b"abcabcabc",
        "empty": b"",
        "4B": b"abcd",
    }


def _staged(blocks, slots=SLOTS):
    w, n = km.stage_words(blocks, slots)
    return torch.from_numpy(w), torch.from_numpy(n)


def test_plain_matches_jax_kernel():
    cases = _blocks()
    blocks = list(cases.values())
    jax_got = pallas_match.find_candidates_device(blocks, interpret=True,
                                                  slots=SLOTS)
    got = km.find_candidates_device(blocks, slots=SLOTS, device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(blocks), SLOTS)
    for i, name in enumerate(cases):
        assert np.array_equal(got[i], jax_got[i]), name
        ref = match_np.find_candidates(blocks[i]).astype(np.int32)[:SLOTS]
        assert np.array_equal(got[i], ref), name


def test_plain_matches_jax_kernel_full_block():
    blk = np.random.default_rng(99).bytes(40000) + b"tail" * 6000
    jax_got = pallas_match.find_candidates_device([blk], interpret=True)
    got = km.find_candidates_device([blk], device="cpu")
    assert got.shape == (1, match_np.BMAX)
    assert np.array_equal(got, jax_got)
    assert np.array_equal(got[0], match_np.find_candidates(blk))


def test_raw_pairs_match_jax_including_the_wrap():
    """home=False returns the JAX kernel's sorted pairs word for word.
    "random" fills all 4,096 slots, so the v-words of its last three
    positions wrap round to bytes 0-2 (match_np.vwords reads zeros
    there): their places in the sorted order follow the kernel."""
    cases = _blocks()
    blocks = [cases["random"], cases["text"], cases["empty"]]
    w, n = _staged(blocks)
    pairs = km.find_candidates(w, n, home=False)
    assert pairs.shape == (3, 2 * SLOTS // 128, 128)
    jpairs = np.asarray(pallas_match._match_jit(
        jnp.asarray(w.numpy()), jnp.asarray(n.numpy()), interpret=True,
        group=1, home=False))
    assert np.array_equal(pairs.numpy(), jpairs)
    # the wrap matters: zero-padded words would sort the tail elsewhere
    keys = pairs.numpy()[0, : SLOTS // 128].reshape(-1)
    v_np = match_np.vwords(blocks[0], SLOTS).astype(np.int64)
    posk = np.where(np.arange(SLOTS) < SLOTS - 3, np.arange(SLOTS),
                    np.arange(SLOTS) + match_np.BIG)
    assert not np.array_equal(keys, np.lexsort((posk, v_np)))


def test_scatter_home_equals_home_route():
    blocks = list(_blocks().values())
    w, n = _staged(blocks)
    home = km.find_candidates(w, n).numpy().reshape(len(blocks), SLOTS)
    pairs = km.find_candidates(w, n, home=False).numpy()
    assert np.array_equal(km.scatter_home(pairs), home)
    assert np.array_equal(
        km.find_candidates_device(blocks, slots=SLOTS, home=False,
                                  device="cpu"), home)


def test_packed_values_are_int32_bit_patterns():
    """A first occurrence at or past 32,768 shifted by 16 is a negative
    int32, and so is NONE16 | NONE16 << 16 (-1)."""
    p = 33000
    blk = bytes(p) + b"WXYZ" + b"WXYZ"
    w, n = _staged([blk], match_np.BMAX)
    got = km.find_candidates(w, n).reshape(-1)
    assert got.dtype == torch.int32
    want = np.uint32(p | p << 16).view(np.int32)
    assert want < 0 and got[p + 4].item() == want
    assert got[p].item() == -1  # no earlier "WXYZ"
    assert (got[len(blk) - 3 :] == -1).all()  # past npos
    assert np.array_equal(got.numpy(), match_np.find_candidates(blk))


def test_native_emission_from_port_candidates():
    rng = np.random.default_rng(5)
    blocks = [b"", b"abc", b"abcabcabc", rng.bytes(3000),
              (b"the quick brown fox jumps over the lazy dog " * 200)[:6000],
              bytes(rng.integers(97, 102, 5000, dtype=np.uint8))]
    got = km.find_candidates_device(blocks, slots=8192, device="cpu")
    for blk, packed in zip(blocks, got):
        packed = np.ascontiguousarray(packed)
        body = native.emit_from_cands(blk, packed)
        assert body == match_np.encode_block_sortmatch(blk, packed)
        if blk:
            assert oracle.decode_block(body, len(blk)) == blk
        else:
            assert body == b""


def test_argument_checks():
    w, n = _staged([b"abcd"])
    for bad in (w.long(), w.reshape(1, -1, 64), w[:, :4]):
        with pytest.raises(ValueError):
            km.find_candidates(bad, n)
    with pytest.raises(ValueError):  # 2**17 slots: positions need 17 bits
        km.find_candidates(torch.zeros(1, 256, 128, dtype=torch.int32), n)
    with pytest.raises(ValueError):
        km.find_candidates(w, n.long())
    assert km.find_candidates(w[:0], n[:0]).shape == (0, SLOTS // 128, 128)
