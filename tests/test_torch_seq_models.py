"""The decompositions of the redesigned sequential kernels, run on the host
(``decode_seq.decode_rows_model``: parse to records, then execute them;
``encode_seq.encode_block_model``: the matcher's records, handed over in
ring slots, then emitted), held against the serial plain versions on
random, text-like, run-heavy and hostile inputs, with the queue-3 int32
error rows.  Tolerance: 0 (byte-exact, error codes equal)."""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from snappy_tpu.spec import reference as jreference
from snappy_tpu_torch import native
from snappy_tpu_torch.kernels import decode_seq as kds
from snappy_tpu_torch.kernels import encode_seq as kes
from snappy_tpu_torch.spec.format import put_uvarint, read_uvarint

SETTINGS = settings(max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])

_WORDS = [b"the ", b"snappy ", b"block ", b"copy ", b"literal ", b"\n",
          b"offset ", b"of ", b"a ", b"GPU "]


@st.composite
def blocks(draw, max_size=6000):
    kind = draw(st.sampled_from(["random", "text", "runs", "mixed"]))
    if kind == "random":
        return draw(st.binary(max_size=max_size))
    if kind == "text":
        words = draw(st.lists(st.sampled_from(_WORDS), max_size=max_size // 5))
        return b"".join(words)[:max_size]
    if kind == "runs":
        runs = draw(st.lists(st.tuples(st.integers(0, 255), st.integers(1, 400)),
                             max_size=40))
        return b"".join(bytes([b]) * n for b, n in runs)[:max_size]
    parts = draw(st.lists(st.one_of(st.binary(max_size=200),
                                    st.sampled_from(_WORDS)), max_size=60))
    return b"".join(parts)[:max_size]


def _plain_decode(streams, starts=None, out_max=65536):
    """(model, plain) results for raw streams in rows of one batch."""
    nb = len(streams)
    cmax = max(len(s) for s in streams) + 8
    comp = np.zeros((nb, cmax), np.uint8)
    st_, cl, dl = (np.zeros(nb, np.int32) for _ in range(3))
    for i, c in enumerate(streams):
        try:
            d, h = read_uvarint(c, 0)
        except Exception:  # a broken preamble: the element stream from 0
            d, h = len(c), 0
        dl[i], st_[i] = min(d, out_max), h
        comp[i, : len(c)] = np.frombuffer(c, np.uint8)
        cl[i] = len(c)
    if starts is not None:
        st_[:] = starts
    model = kds.decode_rows_model(comp, st_, cl, dl, out_max)
    pout, perr = kds.decode_blocks_seq_plain(
        *kds.stage_decode(comp, st_, cl, dl, "cpu"), out_max)
    return model, (pout.numpy(), perr.numpy())


def _assert_same(model, plain):
    assert np.array_equal(model[1], plain[1]), (model[1], plain[1])
    assert np.array_equal(model[0], plain[0])


@SETTINGS
@given(st.lists(blocks(), min_size=1, max_size=4))
def test_decode_model_valid_streams(datas):
    streams = [native.compress(d) for d in datas]
    model, plain = _plain_decode(streams, out_max=8192)
    _assert_same(model, plain)
    for i, d in enumerate(datas):
        assert model[1][i] == 0 and model[0][i, : len(d)].tobytes() == d


@SETTINGS
@given(blocks(max_size=3000), st.lists(st.tuples(st.integers(0, 10_000),
                                                  st.integers(0, 255)),
                                        min_size=1, max_size=6))
def test_decode_model_mutated_streams(data, flips):
    """Valid streams with bytes overwritten: every error code shows up."""
    s = bytearray(native.compress(data))
    for pos, val in flips:
        s[pos % len(s)] = val
    _assert_same(*_plain_decode([bytes(s)], out_max=4096))


_TAGS = st.sampled_from([0x00, 0x04, 60 << 2, 61 << 2, 62 << 2, 63 << 2,
                         0x01, 0x05, 0xE1, 0x02, 0xFE, 0x03, 0xFF])


@SETTINGS
@given(st.integers(0, 3000), st.lists(st.one_of(_TAGS, st.integers(0, 255)),
                                      max_size=200), st.integers(0, 40))
def test_decode_model_hostile_streams(dlen, body, start):
    """Arbitrary element bytes, tag bytes of every kind, 4-byte fields
    with the top bit set, and starts past the payload end."""
    stream = put_uvarint(dlen) + bytes(body)
    hdr = len(put_uvarint(dlen))
    _assert_same(*_plain_decode([stream], starts=[min(hdr + start, hdr + 400)],
                                out_max=4096))


def _lit4(n):  # a literal header with a 4-byte length field n - 1
    return bytes([63 << 2]) + (n - 1 & 0xFFFFFFFF).to_bytes(4, "little")


# the queue-3 int32 rows: wrapping lengths and offsets, one per code
_INT32_ROWS = [
    put_uvarint(10) + _lit4(0) + b"abc",                 # length wraps to 0
    put_uvarint(10) + _lit4(0x80000000) + b"abc",        # length negative
    put_uvarint(10) + _lit4(0x7FFFFFFF) + b"abc",        # past the payload
    put_uvarint(8) + b"\x0cabcd" + bytes([(3 << 2) | 3, 1, 0, 0, 128]),
    put_uvarint(8) + b"\x0cabcd" + bytes([(3 << 2) | 3, 4, 0, 0, 0]),
    put_uvarint(8) + b"\x0cabcd" + bytes([(3 << 2) | 3, 0, 0, 0, 0]),
    put_uvarint(8) + b"\x0cabcd" + bytes([(3 << 2) | 2]),
    put_uvarint(8) + b"\x0cabcd" + bytes([(3 << 2) | 2, 10, 0]),
    put_uvarint(5) + b"\x0cabcd",
    put_uvarint(4) + b"\x0cabcd\x00",
    put_uvarint(70) + b"\x00a" + bytes([(63 << 2) | 2, 1, 0]) * 2,
]


def test_decode_model_int32_rows():
    model, plain = _plain_decode(_INT32_ROWS, out_max=256)
    _assert_same(model, plain)
    assert set(plain[1].tolist()) == {0, 1, 2, 3}
    # a start past the payload end: the walk never starts (ERR_SRC_TRAIL)
    model, plain = _plain_decode([b"\x00\x00"], starts=[5], out_max=16)
    _assert_same(model, plain)
    assert plain[1].tolist() == [kds.ERR_SRC_TRAIL]


@pytest.mark.parametrize("window_end", range(26, 38))
def test_decode_model_elements_across_windows(window_end):
    """Elements that start at and straddle the parser's 32-byte window
    edge (a header at 31, a 4-byte field cut by the edge)."""
    lead = b"\x00x" * ((window_end - 1) // 2)
    lit = bytes([61 << 2, 9, 0]) + bytes(range(10))
    body = lead + lit + bytes([(3 << 2) | 3, 5, 0, 0, 0]) + b"\x01\x09"[:1]
    stream = put_uvarint(len(lead) // 2 + 10 + 4 + 2) + body
    _assert_same(*_plain_decode([stream, stream[:-1], stream + b"\x00"],
                                out_max=512))


@SETTINGS
@given(blocks())
def test_encode_model_matches_plain(data):
    got = kes.encode_block_model(data)
    comp, clens, err = kes.encode_blocks_seq_plain(*kes.stage_encode(
        np.frombuffer(data.ljust(max(len(data), 1), b"\x00"), np.uint8)[None],
        np.array([len(data)], np.int32), "cpu"))
    assert err.tolist() == [0]
    assert got == comp[0, : int(clens[0])].numpy().tobytes()
    assert got == (jreference.encode_block(data) if data else b"")


@pytest.mark.parametrize("n", [17, 18, 19, 33, 47, 48, 49, 64, 65, 1000, 65536])
def test_encode_model_edges(n):
    """Block lengths around MIN_NON_LITERAL and a ring slot's worth of
    records, on incompressible, periodic and colliding-hash inputs."""
    rng = np.random.default_rng(n)
    for data in (rng.bytes(n), (b"abcdefgh" * n)[:n],
                 bytes(rng.integers(0, 2, n, dtype=np.uint8) * 0x55),
                 (rng.bytes(40) * (n // 40 + 1))[:n]):
        assert kes.encode_block_model(data) == jreference.encode_block(data)


def test_encode_model_records_span_ring_slots():
    """A corpus block's records fill many ring slots; the model and the
    reference agree on it, and the records rebuild the block."""
    from snappy_tpu_torch.bench.corpus import make_corpus

    data = b"".join(d for _, d in make_corpus(1 << 18, seed=20260816))[:65536]
    recs = kes.match_records(data)
    assert len(recs) > 4 * kes.RECS
    assert kes.encode_block_model(data) == jreference.encode_block(data)
    out = bytearray()
    for a, length, is_copy in recs:
        if is_copy:
            for _ in range(length):
                out.append(out[-a])
        else:
            out += data[a : a + length]
    assert bytes(out) == data
