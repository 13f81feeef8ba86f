"""Sequential per-block decoder of the torch port against the JAX
package's Pallas kernel (interpret mode) and the reference decoder, on
identical batches carried over with ``stage_decode``.  Error codes are
compared on every row, code for code; decoded bytes on the rows that
decode (the JAX kernel leaves bytes past dlen unspecified, the port
zeroes them).  Tolerance: 0 (byte-exact)."""

import numpy as np
import pytest
import torch

from snappy_tpu import native
from snappy_tpu.bench.corpus import make_corpus
from snappy_tpu.errors import CorruptError
from snappy_tpu.kernels import encode_np
from snappy_tpu.kernels.pallas_decode import LANES, decode_blocks_pallas
from snappy_tpu.spec import reference
from snappy_tpu.spec.format import put_uvarint, read_uvarint
from snappy_tpu_torch.kernels import decode_seq as kd


def _stage(streams, cmax):
    """tests/test_pallas_decode.py's staging: one raw stream per row,
    the element stream starting after its varint header, padded with
    empty streams to a multiple of LANES rows."""
    streams = list(streams)
    while len(streams) % LANES:
        streams.append(b"\x00")
    nb = len(streams)
    comp = np.zeros((nb, cmax), np.uint8)
    starts, clens, dlens = (np.zeros(nb, np.int32) for _ in range(3))
    for i, c in enumerate(streams):
        d, h = read_uvarint(c, 0)
        comp[i, : len(c)] = np.frombuffer(c, np.uint8)
        starts[i], clens[i], dlens[i] = h, len(c), d
    return comp, starts, clens, dlens


def _agree(staged, out_max, apart=()):
    """Decode one staged batch with both packages; assert they agree on
    every row but those in ``apart``, and return the port's (out, err)
    and the JAX err as numpy."""
    jo, je = decode_blocks_pallas(*staged, out_max=out_max, interpret=True)
    jo, je = np.asarray(jo), np.asarray(je)
    po, pe = kd.decode_blocks_seq(*kd.stage_decode(*staged, device="cpu"),
                                  out_max)
    po, pe = po.numpy(), pe.numpy()
    rows = [i for i in range(len(pe)) if i not in apart]
    assert np.array_equal(pe[rows], je[rows]), (pe, je)
    dlens = staged[3]
    for i in np.flatnonzero(pe == 0):
        if i not in apart:
            assert np.array_equal(po[i, : dlens[i]], jo[i, : dlens[i]]), i
        assert not po[i, dlens[i] :].any(), f"row {i} past dlen"
    return po, pe, je


def _reference_accepts(stream: bytes) -> bool:
    d, h = read_uvarint(stream, 0)
    try:
        reference.decode_block(stream, d, start=h)
    except CorruptError:
        return False
    return True


def test_roundtrip_matrix(rng):
    samples = [
        b"Wikipedia" * 3,
        b"a" * 5000,                      # offset-1 RLE
        rng.randbytes(4000),              # literal-only
        (b"abcdefgh" * 600)[:4500],       # short period
        (b"0123456789abcdef" * 64 + b"X") * 5,  # >=128 offsets
        b"",                              # empty
        rng.randbytes(3) + b"zz" * 2000,  # mixed
    ]
    out, err, _ = _agree(_stage([reference.compress(s) for s in samples], 8192),
                      8192)
    assert not err.any()
    for i, s in enumerate(samples):
        assert out[i, : len(s)].tobytes() == s, f"row {i}"


def _lit(body: bytes) -> bytes:
    return bytes([(len(body) - 1) << 2]) + body


# (stream, code); dlen and the element stream come from the stream
ERROR_CASES = [
    (b"\x05\x0cabcd", kd.ERR_DST_SHORT),
    (b"\x08" + _lit(b"abcd") + bytes([(3 << 2) | 1, 0]), kd.ERR_COPY),
    (b"\x08" + _lit(b"abcd") + bytes([(3 << 2) | 2, 10, 0]), kd.ERR_COPY),
    (b"\x05" + _lit(b"abcd") + bytes([(60 << 2) | 2, 1, 0]), kd.ERR_COPY),
    (b"\x0a\x24abc", kd.ERR_LITERAL),
    # int32 wrap: a 4-byte literal length of 0xFFFFFFFF wraps to 0 ...
    (put_uvarint(10) + bytes([63 << 2, 255, 255, 255, 255]) + b"abc",
     kd.ERR_LITERAL),
    # ... 0x7FFFFFFF + 1 to INT_MIN, and 0x7FFFFFFE + 1 overruns dlen
    (put_uvarint(10) + bytes([63 << 2, 255, 255, 255, 127]) + b"abc",
     kd.ERR_LITERAL),
    (put_uvarint(10) + bytes([63 << 2, 254, 255, 255, 127]) + b"abc",
     kd.ERR_LITERAL),
    # a 4-byte offset with its top bit set is negative; 2**31-1 is > d
    (put_uvarint(8) + _lit(b"abcd") + bytes([(3 << 2) | 3, 1, 0, 0, 128]),
     kd.ERR_COPY),
    (put_uvarint(8) + _lit(b"abcd") + bytes([(3 << 2) | 3, 255, 255, 255, 127]),
     kd.ERR_COPY),
    # headers cut at the payload end
    (put_uvarint(8) + _lit(b"abcd") + bytes([(3 << 2) | 2]), kd.ERR_COPY),
    (put_uvarint(300) + bytes([61 << 2, 43]), kd.ERR_LITERAL),
    # elements past dlen; the first failing element decides
    (put_uvarint(4) + _lit(b"abcd") + _lit(b"z"), kd.ERR_LITERAL),
    (put_uvarint(9) + _lit(b"abcd") + bytes([(0 << 2) | 1, 0])
     + _lit(b"z"), kd.ERR_COPY),
    # valid: an empty stream, an overlapping copy
    (put_uvarint(0), kd.ERR_NONE),
    (put_uvarint(40) + _lit(b"ab") + bytes([(37 << 2) | 2, 2, 0]), kd.ERR_NONE),
]

# Valid streams with a 4-byte field, which the reference and the native
# codec decode.  The JAX kernel takes the field's last byte from s+1
# instead of s+4 (pallas_decode.py:116, ``b4 = u1 & 255`` of the word
# at s+1) and rejects them; the port reads s+4 (ROADMAP queue 3).
FOUR_BYTE_FIELDS = [
    (put_uvarint(8) + _lit(b"abcd") + bytes([(3 << 2) | 3, 4, 0, 0, 0]),
     kd.ERR_COPY),
    (put_uvarint(4) + bytes([63 << 2, 3, 0, 0, 0]) + b"abcd", kd.ERR_LITERAL),
]


def test_error_codes():
    streams = [s for s, _ in ERROR_CASES + FOUR_BYTE_FIELDS]
    staged = _stage(streams + [b"\x00"], 1024)
    # ERR_SRC_TRAIL: an element stream that starts past its payload end
    trail = len(streams)
    staged[1][trail] = staged[2][trail] + 2
    apart = range(len(ERROR_CASES), trail)
    out, err, jax_err = _agree(staged, 1024, apart)
    want = [code for _, code in ERROR_CASES]
    want += [kd.ERR_NONE] * len(FOUR_BYTE_FIELDS) + [kd.ERR_SRC_TRAIL]
    assert err[: len(want)].tolist() == want
    assert set(want) == {kd.ERR_NONE, *kd.ERR_MESSAGES}
    for s, code in ERROR_CASES:
        assert _reference_accepts(s) == (code == kd.ERR_NONE), s
    for row, (s, jax_code) in zip(apart, FOUR_BYTE_FIELDS):
        assert jax_err[row] == jax_code
        d = staged[3][row]
        assert out[row, :d].tobytes() == reference.decompress(s)


def test_agreement_with_oracle_fuzz(rng):
    """Valid streams from both host encoders, and the same streams with
    1-3 bytes changed: every row agrees with JAX code for code, with the
    reference on acceptance, and on the bytes of every accepted row."""
    samples = [rng.randbytes(rng.randint(1, 3000)) for _ in range(4)]
    samples += [(b"word " * 1000)[: rng.randint(100, 4000)] for _ in range(4)]
    streams = [reference.compress(s) for s in samples[:4]]
    streams += [encode_np.compress(s) for s in samples[4:]]
    mutated = []
    for k in range(24):
        bad = bytearray(streams[k % len(streams)])
        _, h = read_uvarint(bytes(bad), 0)
        for _ in range(rng.randint(1, 3)):
            bad[rng.randrange(h, len(bad))] = rng.randrange(256)
        mutated.append(bytes(bad))
    out, err, _ = _agree(_stage(streams + mutated, 8192), 8192)
    assert not err[: len(streams)].any()
    for i, s in enumerate(samples):
        assert out[i, : len(s)].tobytes() == s
    for k, m in enumerate(mutated):
        row = len(streams) + k
        assert _reference_accepts(m) == (err[row] == 0), k
        if err[row] == 0:
            d, h = read_uvarint(m, 0)
            assert out[row, :d].tobytes() == reference.decode_block(m, d, h)
    assert err[len(streams) :].any()  # the mutations did break some rows


def test_corpus_rows():
    """Full 64 KiB geometry: corpus chunks as the native encoder emits
    them, in the runtime's row width (66,560)."""
    data = b"".join(d for _, d in make_corpus(1 << 20, seed=5))
    samples = [data[k * 65536 : (k + 1) * 65536] for k in (1, 6, 13)]
    samples += [bytes(65536), np.random.default_rng(3).bytes(65536)]
    out, err, _ = _agree(_stage([native.compress(s) for s in samples], 66560),
                      65536)
    assert not err.any()
    for i, s in enumerate(samples):
        assert out[i, : len(s)].tobytes() == s, f"row {i}"


def test_boundary_alignment(rng):
    """Sizes straddling the JAX kernel's 128-byte rows."""
    samples = [rng.randbytes(n // 2) + b"Q" * (n - n // 2)
               for n in (1, 127, 128, 129, 255, 256, 257, 4095, 4096, 4097)]
    out, err, _ = _agree(_stage([reference.compress(s) for s in samples], 8192),
                      8192)
    assert not err.any()
    for i, s in enumerate(samples):
        assert out[i, : len(s)].tobytes() == s, f"len={len(s)}"


def test_any_batch_and_row_width(rng):
    """No Mosaic shape rules: 3 rows, widths that are no multiple of 128
    (a row exactly as wide as its stream, whose last header is cut at
    the row end), a row-strided view, against the reference."""
    good = reference.compress(rng.randbytes(50) + b"xy" * 300)
    cut = put_uvarint(8) + _lit(b"abcd") + bytes([(3 << 2) | 2])
    streams = [good, cut, reference.compress(b"tail" * 9)]
    width = max(len(s) for s in streams) + 3
    comp = np.zeros((3, width + 5), np.uint8)
    starts, clens, dlens = (np.zeros(3, np.int32) for _ in range(3))
    for i, s in enumerate(streams):
        dlens[i], starts[i] = read_uvarint(s, 0)
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
        clens[i] = len(s)
    c, st, cl, dl = kd.stage_decode(comp, starts, clens, dlens,
                                    device="cpu")
    out, err = kd.decode_blocks_seq(c[:, :width], st, cl, dl, 701)
    assert err.tolist() == [kd.ERR_NONE, kd.ERR_COPY, kd.ERR_NONE]
    for i in (0, 2):
        assert out[i, : dlens[i]].numpy().tobytes() == reference.decompress(
            streams[i])
    assert out[1, :4].numpy().tobytes() == b"abcd" and not out[1, 4:].any()
    tight = torch.from_numpy(comp[1:2, : len(cut)].copy())
    _, err = kd.decode_blocks_seq(tight, st[1:2], cl[1:2], dl[1:2], 8)
    assert err.tolist() == [kd.ERR_COPY]


def test_plain_contract():
    c, st, cl, dl = kd.stage_decode(np.zeros((1, 16), np.uint8),
                                    [0], [0], [0], device="cpu")
    with pytest.raises(ValueError):
        kd.decode_blocks_seq(c, st - 1, cl, dl, 16)   # start < 0
    with pytest.raises(ValueError):
        kd.decode_blocks_seq(c, st, cl + 17, dl, 16)  # clen > cmax
    with pytest.raises(ValueError):
        kd.decode_blocks_seq(c, st, cl, dl + 17, 16)  # dlen > out_max
    with pytest.raises(ValueError):
        kd.decode_blocks_seq(c, st.long(), cl, dl, 16)
    with pytest.raises(ValueError):
        kd.decode_blocks_seq(c.int(), st, cl, dl, 16)
    assert kd.decode_blocks_seq(c, st, cl, dl, 16)[1].tolist() == [0]


# streams of a span test: (stream, code); the header-cut rows' bytes past
# their payload are the next chunk's header, non-zero
SPAN_ROWS = [
    (reference.compress(b"span " * 700), kd.ERR_NONE),
    (b"\x0a\x24abc", kd.ERR_LITERAL),
    (put_uvarint(8) + _lit(b"abcd") + bytes([(3 << 2) | 2, 10, 0]),
     kd.ERR_COPY),
    (b"\x05\x0cabcd", kd.ERR_DST_SHORT),
    (put_uvarint(8) + _lit(b"abcd") + bytes([(3 << 2) | 2]), kd.ERR_COPY),
    (put_uvarint(300) + bytes([61 << 2, 43]), kd.ERR_LITERAL),
    (put_uvarint(0), kd.ERR_NONE),
    (reference.compress(bytes(range(256)) * 9), kd.ERR_NONE),
    (b"\x00\x0cabcd", kd.ERR_SRC_TRAIL),  # its start moved past its end
]


def _span_and_rows(streams, gap: bytes, trail: int):
    """The streams laid out as the seq engine stages a batch, and as
    padded rows: one span (``gap`` before each stream, as a chunk's
    header and CRC) read as rows of stride 0, each row's element stream
    at ``[rel + hdr, rel + len)``; and a row each, its stream at 0 and
    stale bytes (0xA5) past it.  Row ``trail``'s start is put 2 bytes
    past its end (a varint header longer than its payload)."""
    nb = len(streams)
    span, rel = bytearray(), []
    for s in streams:
        span += gap
        rel.append(len(span))
        span += s
    rows = np.full((nb, max(map(len, streams)) + 7), 0xA5, np.uint8)
    starts, clens, dlens = (np.zeros(nb, np.int32) for _ in range(3))
    for i, s in enumerate(streams):
        dlens[i], starts[i] = read_uvarint(s, 0)
        rows[i, : len(s)] = np.frombuffer(s, np.uint8)
        clens[i] = len(s)
    starts[trail] = clens[trail] + 2
    rel = np.array(rel, np.int32)
    flat = torch.frombuffer(bytearray(span), dtype=torch.uint8)
    as_span = (flat.expand(nb, len(span)), *(torch.from_numpy(a) for a in (
        starts + rel, clens + rel, dlens)))
    as_rows = kd.stage_decode(rows, starts, clens, dlens, device="cpu")
    return as_span, as_rows


def test_span_view_decodes_as_padded_rows():
    """A stride-0 view of one span gives the padded rows' bytes and
    codes, row for row: valid rows, every error code, and headers cut
    at the payload end with the next chunk's non-zero bytes after them."""
    streams = [s for s, _ in SPAN_ROWS]
    gap = b"\x01\x31\x02\x07\xd7\x9e\xff\x01"  # a chunk header, a CRC
    as_span, as_rows = _span_and_rows(streams, gap, trail=len(streams) - 1)
    assert as_span[0].stride(0) == 0
    out_s, err_s = kd.decode_blocks_seq(*as_span, 4096)
    out_r, err_r = kd.decode_blocks_seq(*as_rows, 4096)
    assert err_s.tolist() == [code for _, code in SPAN_ROWS]
    assert torch.equal(err_s, err_r) and torch.equal(out_s, out_r)
    assert set(err_s.tolist()) == {kd.ERR_NONE, *kd.ERR_MESSAGES}
    assert out_s[0, :3500].numpy().tobytes() == b"span " * 700


def test_plain_version_reads_a_span_once(monkeypatch):
    """The plain version turns a stride-0 comp to host bytes once for
    the batch, padded rows once a row."""
    streams = [s for s, _ in SPAN_ROWS]
    as_span, as_rows = _span_and_rows(streams, bytes(8), trail=0)
    reads = []
    real = kd._host_bytes

    def counted(row):
        reads.append(row.numel())
        return real(row)

    monkeypatch.setattr(kd, "_host_bytes", counted)
    kd.decode_blocks_seq(*as_span, 4096)
    assert reads == [as_span[0].shape[1]]
    reads.clear()
    kd.decode_blocks_seq(*as_rows, 4096)
    assert reads == [as_rows[0].shape[1]] * len(streams)
