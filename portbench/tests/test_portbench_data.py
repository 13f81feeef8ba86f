"""The generator of the Silesia mix and the frozen reference encoder."""

import json
import os

import numpy as np
import pytest

from portbench import corpus, reference, run
from portbench.reference import plain

TRAFFIC = {"objects": [["dickens", 61439], ["nci", 126975], ["x-ray", 61439],
                       ["dickens", 126975]]}


def test_the_same_seed_makes_the_same_pool():
    a = corpus.make_pool(TRAFFIC, 2**31 + 77)
    b = corpus.make_pool(TRAFFIC, 2**31 + 77, threads=1)
    c = corpus.make_pool(TRAFFIC, 2**31 + 78)
    assert [x.size for x in a] == [n for _, n in corpus.pool_objects(TRAFFIC)] == [
        61439, 126975, 61439, 126975]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert not np.array_equal(a[0], a[3][: a[0].size])  # each object has its own seed


def test_objects_are_made_in_segments_of_their_own():
    """An object longer than a segment is its segments in order, each
    from its own seed, so threads make it alike."""
    n = corpus.SEGMENT + 5000
    whole = corpus.make_kind("samba", n, 3)
    assert whole.size == n
    assert np.array_equal(whole[: corpus.SEGMENT], corpus._segment("samba", n, 3, 0))
    assert np.array_equal(whole[corpus.SEGMENT:], corpus._segment("samba", n, 3, 1))


def test_call_order_is_a_seeded_permutation_each_pass():
    o = corpus.call_order(16, 5, 0)
    assert sorted(o) == list(range(16))
    assert list(o) == list(corpus.call_order(16, 5, 0))
    assert list(o) != list(corpus.call_order(16, 6, 0))
    assert list(o) != list(corpus.call_order(16, 5, 1))


@pytest.mark.parametrize("call", ["load", "save"])
def test_the_pool_is_silesia_at_its_published_sizes(call):
    """Each mix's pool is Silesia's twelve files, one object each, of
    its kind and at its published size: each kind's share of the bytes
    is the file's share of the corpus's 211,938,580 B."""
    traffic = json.load(open(os.path.join(run.ROOT, "portbench", "traffic",
                                          f"{call}.json")))
    objects = corpus.pool_objects(traffic)
    assert dict(objects) == corpus.SILESIA and len(objects) == 12
    total = sum(n for _, n in objects)
    assert total == 211_938_580
    share = {k: n / total for k, n in objects}
    assert share["mozilla"] == pytest.approx(0.2417, abs=1e-4)
    assert share["nci"] == pytest.approx(0.1583, abs=1e-4)
    assert share["xml"] == pytest.approx(0.0252, abs=1e-4)
    assert set(corpus.KINDS) == set(corpus.SILESIA) == set(corpus.RATIO)


@pytest.mark.parametrize("kind", sorted(corpus.KINDS))
def test_each_kind_frames_at_its_ratio(kind):
    """Each kind's framed ratio with the reference encoder lies in its
    band (``corpus.RATIO``) on two seeds, 2 MiB each."""
    want, band = corpus.RATIO[kind]
    for seed in (1, 2**31 + 3):
        data = corpus.make_kind(kind, 2 << 20, seed)
        assert data.size == 2 << 20 and data.dtype == np.uint8
        got = len(reference.frame(data)[0]) / data.size
        assert abs(got - want) <= band, (kind, seed, got)


def test_only_the_incompressible_kinds_are_stored():
    """The framing stores a chunk that saves under 12.5%: every chunk of
    sao and x-ray, as Snappy saves little on them, and none of the
    other kinds, mr's scan among them."""
    for kind in corpus.KINDS:
        stream = reference.frame(corpus.make_kind(kind, 1 << 20, 9))[0]
        stored = {ctype == 1 for ctype, _, _ in reference.records(stream)}
        assert stored == {kind in ("sao", "x-ray")}, kind


def _inputs():
    rng = np.random.default_rng(9)
    mix = np.concatenate([corpus.make_kind(k, 30_000, 11) for k in sorted(corpus.KINDS)])
    return {
        "empty": np.zeros(0, np.uint8),
        "one": np.array([7], np.uint8),
        "17": mix[:17], "18": mix[:18],
        "chunk": mix[:65536], "chunk+1": mix[:65537],
        "mix": mix[:200_000],
        "noise": rng.integers(0, 256, 70_000, dtype=np.uint8),
        "zeros": np.zeros(140_000, np.uint8),
        "period3": np.tile(np.array([1, 2, 3], np.uint8), 30_000),
    }


@pytest.mark.parametrize("name", list(_inputs()))
def test_frozen_encoder_equals_the_plain_one(name):
    data = _inputs()[name]
    stream, elem = reference.frame(data, threads=3)
    assert stream == plain.frame(data.tobytes())
    assert stream == reference.frame(data, threads=1)[0]
    assert len(elem) == len(reference.records(stream))


def test_element_lengths_and_records():
    data = corpus.make_kind("webster", 200_000, 4)
    stream, elem = reference.frame(data)
    recs = reference.records(stream)
    assert [r[0] for r in recs] and all(t in (0, 1) for t, _, _ in recs)
    for c, (ctype, off, blen) in enumerate(recs):
        if ctype == 0:  # body: CRC, length varint, element
            chunk_len = min(65536, data.size - c * 65536)
            varint = len(plain._uvarint(chunk_len))
            assert blen == 4 + varint + elem[c]


def test_control_table_changes_the_bytes_not_the_format():
    data = corpus.make_kind("dickens", 300_000, 5)
    ref = reference.frame(data)[0]
    ctl = reference.frame(data, table_bits=12)[0]
    assert ctl != ref
    assert ctl == plain.frame(data.tobytes(), table_bits=12)
    with pytest.raises(ValueError):
        reference.frame(data, table_bits=15)
