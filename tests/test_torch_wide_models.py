"""The decompositions of the redesigned match and wave-group kernels, run
on the host (``match.find_candidates_model``: four LSD passes whose bases
are one byte histogram, per-warp offsets, then runs and heads;
``decode_wavegroup.wavegroup_model``: a row per warp, eight groups of
plan words four loads at a time, each group's loads before its stores), held against the
plain versions and the match model also against the JAX package's
``match_np.find_candidates``.  Tolerance: 0 (bit-exact)."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from snappy_tpu.kernels import match_np
from snappy_tpu_torch import native
from snappy_tpu_torch.kernels import decode_wavegroup as kw
from snappy_tpu_torch.kernels import match as km

SETTINGS = settings(max_examples=25, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])

_WORDS = [b"the ", b"snappy ", b"group ", b"word ", b"\n", b"of ", b"GPU "]


@st.composite
def blocks(draw, max_size=4096):
    kind = draw(st.sampled_from(["random", "text", "runs", "equal"]))
    if kind == "random":
        return draw(st.binary(max_size=max_size))
    if kind == "text":
        words = draw(st.lists(st.sampled_from(_WORDS), max_size=max_size // 4))
        return b"".join(words)[:max_size]
    if kind == "runs":
        runs = draw(st.lists(st.tuples(st.integers(0, 255),
                                       st.integers(1, 300)), max_size=30))
        return b"".join(bytes([b]) * n for b, n in runs)[:max_size]
    return bytes([draw(st.integers(0, 255))]) * draw(st.integers(0, max_size))


def _match_all_ways(blks, slots):
    """(model, plain) candidates in both routes for blocks in ``slots``."""
    w, n = km.stage_words(blks, slots)
    for home in (True, False):
        model = km.find_candidates_model(w, n, home)
        plain = km.find_candidates_plain(torch.from_numpy(w),
                                         torch.from_numpy(n), home).numpy()
        assert np.array_equal(model, plain), home
    return km.find_candidates_model(w, n).reshape(len(blks), slots)


@SETTINGS
@given(st.lists(blocks(), min_size=1, max_size=3),
       st.sampled_from([4096, 8192]))
def test_match_model_matches_plain(blks, slots):
    _match_all_ways(blks, slots)


def test_match_model_full_blocks_and_match_np():
    """64 KiB slots: an all-equal block, random and text blocks filling
    their slots exactly (the last words wrap), short blocks; the home
    route equals match_np.find_candidates of each block."""
    rng = np.random.default_rng(6)
    blks = [bytes(65536), b"\x07" * 65536, rng.bytes(65536),
            (b"the quick brown fox " * 3300)[:65536], b"", b"abc", b"abcd",
            rng.bytes(40000) + b"tail" * 6000, bytes(range(256)) * 256]
    got = _match_all_ways(blks, km.BMAX)
    for i, blk in enumerate(blks):
        assert np.array_equal(got[i], match_np.find_candidates(blk)), i


def test_match_model_passes_share_one_histogram():
    """Every pass's digits are the block's bytes, rotated: the counts of
    digit k over all positions equal the byte histogram."""
    rng = np.random.default_rng(7)
    blk = np.frombuffer(rng.bytes(4096), np.uint8)
    hist = np.bincount(blk, minlength=256)
    for k in range(4):
        digits = blk[(np.arange(4096) + k) & 4095]
        assert np.array_equal(np.bincount(digits, minlength=256), hist)
    order = km._sort_model(blk)
    assert np.array_equal(np.sort(order), np.arange(4096))


def _staged(streams):
    comp, words, ng = kw.stage_waves(streams, device="cpu")
    return comp, words, ng


def _wave_both(comp, words, ng, out_max):
    model = kw.wavegroup_model(comp.numpy(), words.numpy(), ng.numpy(),
                               out_max)
    plain = kw.decode_blocks_wavegroup_plain(comp, words, ng, out_max).numpy()
    assert np.array_equal(model, plain)
    return model


@SETTINGS
@given(st.lists(blocks(max_size=6000), min_size=1, max_size=4))
def test_wave_model_matches_plain(datas):
    """Rows of one batch whose streams (and so cmax) differ."""
    out = _wave_both(*_staged([native.compress(d) for d in datas]), 6000)
    for i, d in enumerate(datas):
        assert out[i, : len(d)].tobytes() == d


def test_wave_model_mixed_rows():
    """Stored-like (random), offset-1 chains, offset-2 runs and text rows
    in one batch: the rows' cmax differ, plans of 1 to hundreds of
    groups."""
    rng = np.random.default_rng(8)
    datas = [rng.bytes(20000), b"a" * 20000, b"ab" * 9000,
             (b"the quick brown fox " * 900)[:17000], b"", b"x"]
    out = _wave_both(*_staged([native.compress(d) for d in datas]), 20000)
    for i, d in enumerate(datas):
        assert out[i, : len(d)].tobytes() == d


def _chain_plan(n_groups):
    """An offset-1 chain of 1-byte copies: each copy's source is its own
    group's first byte's predecessor, so every copy takes a group of its
    own (n_groups groups, one slot used)."""
    recs = np.zeros((n_groups, 4), np.int32)
    recs[0] = (0, 1, 0, 0)  # one literal byte from comp[0]
    for t in range(1, n_groups):
        recs[t] = (1, 1, 1, t)  # copy of offset 1 to out[t]
    words, g = kw.plan_waves(recs, n_groups)
    assert g == n_groups
    return words, g


@pytest.mark.parametrize("n_groups", [1, 2, 3, 7, 8, 9, 33, 8191, 8192])
def test_wave_model_long_offset1_chains(n_groups):
    """Plans of up to WAVE_G_CAP groups, and counts around the kernel's
    loads of eight groups' words (the last load partly used)."""
    words, g = _chain_plan(n_groups)
    packed = kw.pack_plan(words, g, -(-g // 8) * 8)
    comp = torch.full((1, 128), ord("z"), dtype=torch.uint8)
    out = _wave_both(comp, torch.from_numpy(packed)[None],
                     torch.tensor([g], dtype=torch.int32), n_groups + 5)
    assert out[0, :n_groups].tobytes() == b"z" * n_groups
    assert not out[0, n_groups:].any()


def test_wave_model_hostile_plan_stays_in_rows():
    """Random plan words and group counts past the plan or below 0: the
    model (the kernel's decomposition) runs to its end inside its rows,
    and rows with no group to run stay zero."""
    rng = np.random.default_rng(9)
    comp = rng.integers(0, 256, (4, 700), dtype=np.uint8)
    words = rng.integers(-2**31, 2**31, (4, 2, 128),
                         dtype=np.int64).astype(np.int32)
    out = kw.wavegroup_model(comp, words, np.array([0, 5, 99, -3]), 500)
    assert out.shape == (4, 500)
    assert not out[0].any() and not out[3].any()
