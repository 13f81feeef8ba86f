"""Sequential per-block encoder of the torch port against the JAX
package's Pallas kernel (interpret mode), the reference encoder and the
native codec, on identical batches carried over with ``stage_encode``.
The emission must be byte-identical to ``spec.reference.encode_block``.
Tolerance: 0 (byte-exact)."""

import numpy as np
import pytest
import torch

from snappy_tpu import native
from snappy_tpu.kernels.pallas_encode import ELANES, encode_blocks_pallas
from snappy_tpu.spec import reference
from snappy_tpu.spec.format import max_encoded_len, read_uvarint
from snappy_tpu_torch.kernels import decode_seq as kd
from snappy_tpu_torch.kernels import encode_seq as ke


def _stage(samples, bmax):
    """tests/test_pallas_encode.py's staging, padded to ELANES rows."""
    samples = list(samples)
    while len(samples) % ELANES:
        samples.append(b"")
    blocks = np.zeros((len(samples), bmax), np.uint8)
    lens = np.zeros(len(samples), np.int32)
    for i, d in enumerate(samples):
        blocks[i, : len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return samples, blocks, lens


def _check(samples, bmax):
    """Encode with both packages; every row must be the reference
    emission, and the port's rows zero past it."""
    samples, blocks, lens = _stage(samples, bmax)
    jc, jl, je = encode_blocks_pallas(blocks, lens, bmax=bmax, interpret=True)
    jc, jl = np.asarray(jc), np.asarray(jl)
    comp, clens, err = ke.encode_blocks_seq(
        *ke.stage_encode(blocks, lens, "cpu"))
    comp, clens = comp.numpy(), clens.numpy()
    assert comp.shape[1] >= max_encoded_len(bmax)
    assert not err.any() and not np.asarray(je).any()
    assert np.array_equal(clens, jl)
    for i, d in enumerate(samples):
        want = reference.encode_block(d) if d else b""
        assert comp[i, : clens[i]].tobytes() == want, f"row {i} len={len(d)}"
        assert jc[i, : jl[i]].tobytes() == want
        assert not comp[i, clens[i] :].any()
    return samples, comp, clens


def test_emission_matrix(rng):
    samples = [
        b"Wikipedia" * 3,
        b"a" * 5000,                      # RLE -> long match, chopping loop
        rng.randbytes(4000),              # incompressible, skip heuristic
        (b"abcdefgh" * 600)[:4500],
        b"",                              # empty
        b"x" * 17,                        # below MIN_NON_LITERAL
        b"x" * 18,                        # at the boundary
        rng.randbytes(100) + b"yz" * 1500,
        bytes(8000),                      # zeros
    ]
    _check(samples, 8192)


def test_full_blocks(rng):
    from conftest import make_corpus_samples

    samples = [s[:65536] for s in make_corpus_samples(rng, sizes=(65536,))]
    samples += [bytes(65536), rng.randbytes(65536), (b"ab" * 40000)[:65536]]
    _, comp, clens = _check(samples, 65536)
    for i, s in enumerate(samples):  # the native matcher's element too
        nat = native.compress(s)
        assert comp[i, : clens[i]].tobytes() == nat[read_uvarint(nat, 0)[1] :]


def test_boundary_sizes(rng):
    samples = [(b"pattern!" * 600)[: n // 2] + rng.randbytes(n - n // 2)
               for n in (1, 17, 18, 19, 127, 128, 129, 255, 256, 4095, 4096)]
    _check(samples, 4096)


def test_roundtrip_through_seq_decoder(rng):
    """Seq encode -> seq decode on the port alone, odd batch and widths
    (no Mosaic shape rules), including a row-strided block view."""
    samples = [(b"roundtrip " * 1000)[:8000], rng.randbytes(3000),
               b"z" * 7000, b"", b"q" * 18]
    bmax = 8003
    wide = np.zeros((len(samples), bmax + 7), np.uint8)
    lens = np.array([len(s) for s in samples], np.int32)
    for i, s in enumerate(samples):
        wide[i, : len(s)] = np.frombuffer(s, np.uint8)
    blocks, lens_t = ke.stage_encode(wide, lens, "cpu")
    comp, clens, err = ke.encode_blocks_seq(blocks[:, :bmax], lens_t)
    assert comp.shape[1] == ke.comp_width(bmax) and not err.any()
    starts = torch.zeros(len(samples), dtype=torch.int32)
    out, derr = kd.decode_blocks_seq(comp, starts, clens, lens_t, bmax)
    assert not derr.any()
    for i, s in enumerate(samples):
        assert out[i, : len(s)].numpy().tobytes() == s


def test_length_outside_the_row():
    blocks, lens = ke.stage_encode(np.full((3, 64), 7, np.uint8), [64, 65, -1],
                                   "cpu")
    comp, clens, err = ke.encode_blocks_seq(blocks, lens)
    assert err.tolist() == [ke.ERR_NONE, ke.ERR_LEN, ke.ERR_LEN]
    assert clens.tolist()[1:] == [0, 0] and not comp[1:].any()
    with pytest.raises(ValueError):
        ke.encode_blocks_seq(blocks, lens.long())
