"""Wave-group decoder of the torch port against the JAX package: the
planner word for word (Python and native), the plain decode against the
Pallas kernel (interpret mode) on ``[:dlen]`` and against
``execute_waves_np`` on the whole row, and the plan checks.  Tolerance:
0 (byte-exact)."""

import os

import numpy as np
import pytest
import torch

from snappy_tpu import native
from snappy_tpu.bench.corpus import make_corpus
from snappy_tpu.kernels import decode_wavegroup as jw
from snappy_tpu.spec import reference
from snappy_tpu.spec.format import read_uvarint
from snappy_tpu_torch.kernels import decode_wavegroup as kw

_README = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "README.md")
_TMP = np.empty((34000, 4), np.int32)


def _samples(rng):
    """tests/test_wavegroup.py's samples."""
    with open(_README, "rb") as f:
        text = f.read()
    return [
        b"Wikipedia" * 3,
        b"a" * 5000,                      # offset-1 RLE -> doubling pieces
        b"ab" * 8000,                     # offset-2 RLE
        rng.randbytes(4000),              # literal-only
        (b"abcdefgh" * 600)[:4500],
        bytes(6000),
        rng.randbytes(50) + b"Q" * 3000 + rng.randbytes(50),
        (text * 3)[:16384],
    ]


def _records(stream: bytes) -> int:
    dlen, h = read_uvarint(stream, 0)
    return native.parse_tags(stream, h, dlen, _TMP)


def _corpus_blocks(n=2, seed=23):
    data = b"".join(d for _, d in make_corpus(n << 16, seed=seed))
    return [data[i << 16 : (i + 1) << 16] for i in range(n)]


def test_planner_matches_jax_and_native(rng):
    for data in _samples(rng) + [rng.randbytes(30000)]:
        nt = _records(reference.compress(data))
        words, g = kw.plan_waves(_TMP, nt)
        jwords, jg = jw.plan_waves(_TMP, nt)
        assert g == jg and np.array_equal(words, jwords)
        cwords = np.zeros((16384, 16), np.int32)
        assert native.plan_waves(_TMP, nt, cwords) == g
        assert np.array_equal(cwords[:g], words[:g])
        assert np.array_equal(kw.pack_plan(words, g, 8192),
                              jw.pack_plan(jwords, jg, 8192))


def test_cap_overflow_gives_none():
    stream = reference.compress(bytes(range(256)) * 8)
    assert kw.plan_waves(_TMP, _records(stream), cap_groups=1) is None
    ok = reference.compress(b"tiny")
    assert kw.stage_waves([ok, stream], g_cap=4, device="cpu") is None
    comp, words, ng = kw.stage_waves([ok, stream], g_cap=8192,
                                     device="cpu")
    assert ng.tolist()[0] == 1 and ng.tolist()[1] > 4


def test_plain_matches_jax_kernel_and_np_replay(rng):
    """The JAX test's samples plus two 64 KiB corpus blocks, staged once
    with stage_waves and fed to both packages."""
    samples = _samples(rng) + _corpus_blocks()
    streams = [native.compress(s) for s in samples]
    comp, words, ng = kw.stage_waves(streams, device="cpu")
    assert comp.shape[1] % 128 == 0 and words.shape[1] * 8 >= int(ng.max())
    out = kw.decode_blocks_wavegroup(comp, words, ng, 65536).numpy()
    jout = np.asarray(jw.decode_blocks_wavegroup(
        comp.numpy(), words.numpy(), ng.numpy(), out_max=65536,
        interpret=True))
    plan = words.numpy().reshape(len(samples), -1, 16)
    for i, s in enumerate(samples):
        assert out[i, : len(s)].tobytes() == s, i
        assert np.array_equal(out[i, : len(s)], jout[i, : len(s)]), i
        want = jw.execute_waves_np(plan[i], int(ng[i]), comp[i].numpy(), 65536)
        assert np.array_equal(out[i], want), i
        assert not out[i, len(s) :].any()


def test_uneven_batch_and_widths(rng):
    """3 rows, a comp row view narrower than its pitch and no multiple of
    128, an out_max that is no multiple of 128, a plan wider than any
    row needs."""
    samples = [b"x" * 700 + rng.randbytes(77), rng.randbytes(5), b""]
    streams = [reference.compress(s) for s in samples]
    comp, words, ng = kw.stage_waves(streams, device="cpu")
    cmax = max(len(s) for s in streams) + 3
    wide = torch.cat([words, torch.zeros_like(words)], 1)
    out = kw.decode_blocks_wavegroup(comp[:, :cmax], wide, ng, 801)
    assert out.shape == (3, 801)
    for i, s in enumerate(samples):
        assert out[i, : len(s)].numpy().tobytes() == s
        assert not out[i, len(s) :].any()
    empty = kw.decode_blocks_wavegroup(comp[:0], words[:0], ng[:0], 16)
    assert empty.shape == (0, 16)


def _plan_of(data: bytes):
    comp, words, ng = kw.stage_waves([reference.compress(data)], device="cpu")
    return comp, words.clone(), ng


def _slot(words, g, k):
    """The two words of slot k of group g (a view into ``words``)."""
    return words.view(-1, 16)[g, 2 * k : 2 * k + 2]


def _break(words, ng, comp, how):
    # a group with two used slots ("ab" * 800 plans 128-byte copies from
    # byte 0 at 128, 256, ...)
    multi = int((words.view(-1, 16)[:, 3] >> 17).nonzero()[0])
    if how == "len_over_128":
        w = _slot(words, 0, 0)
        w[1] = (w[1] & ((1 << 17) - 1)) | (129 << 17)
    elif how == "copy_source_in_group":
        # a copy piece that reads its own group's output
        w = _slot(words, 1, 0)
        d0 = int(w[1]) & ((1 << 17) - 1)
        w[0] = d0 | (1 << 17)
    elif how == "tiling_gap":
        w = _slot(words, multi, 1)
        w[1] += 1
    elif how == "span":
        w = _slot(words, multi, 1)
        w[1] = (w[1] & ~((1 << 17) - 1)) | (int(w[1]) & ((1 << 17) - 1)) + 1024
    elif how == "comp_source_past_row":
        w = _slot(words, 0, 0)
        w[0] = comp.shape[1] - 1
    elif how == "ngroups_past_plan":
        ng[0] = words.shape[1] * 8 + 1
    elif how == "negative_ngroups":
        ng[0] = -1
    return words, ng


@pytest.mark.parametrize("how", [
    "len_over_128", "copy_source_in_group", "tiling_gap", "span",
    "comp_source_past_row", "ngroups_past_plan", "negative_ngroups"])
def test_plan_invariants_raise(how):
    comp, words, ng = _plan_of(b"ab" * 800)
    assert int(ng[0]) >= 2
    kw.decode_blocks_wavegroup(comp, words, ng, 1600)  # the plan is valid
    words, ng = _break(words, ng, comp, how)
    with pytest.raises(ValueError):
        kw.decode_blocks_wavegroup(comp, words, ng, 1600)


def test_out_max_and_argument_checks():
    comp, words, ng = _plan_of(b"abc" * 100)
    with pytest.raises(ValueError):  # the plan writes 300 bytes
        kw.decode_blocks_wavegroup(comp, words, ng, 299)
    with pytest.raises(ValueError):
        kw.decode_blocks_wavegroup(comp.int(), words, ng, 300)
    with pytest.raises(ValueError):
        kw.decode_blocks_wavegroup(comp, words.view(1, -1, 16), ng, 300)
    with pytest.raises(ValueError):
        kw.decode_blocks_wavegroup(comp, words, ng.long(), 300)
    with pytest.raises(ValueError):
        kw.decode_blocks_wavegroup(comp, words, ng, -1)
    out = kw.decode_blocks_wavegroup(comp, words, ng, 300)
    assert out[0].numpy().tobytes() == b"abc" * 100
