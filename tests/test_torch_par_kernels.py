"""The host models of the parallel engines' CUDA kernels
(``decode_par.decode_rows_model``, ``encode_par.encode_blocks_model``:
each kernel's decomposition in numpy) against the JAX package's
``decode_jnp.decode_blocks`` / ``encode_jnp.encode_blocks`` on the CPU
and against the port's plain versions, on the same seeded inputs:
``make_corpus`` chunks of 4-16 KiB, the hostile decode rows (the element
payloads of ``test_torch_framed_fuzz``'s hostile framed streams and
``chip_smoke``'s corrupt raw streams) and the hostile encode blocks.
Tolerance: none.  Decode: every code equal, bytes equal where the code
is 0 (a row with an error is all zero from the kernel; its bytes from
the plain version are what its gather gives).  Encode: every byte,
length and ok flag equal."""

import numpy as np
import pytest
import torch

from chip_smoke import _bad_streams
from snappy_tpu.kernels import decode_jnp, encode_jnp
from snappy_tpu_torch.bench.corpus import make_corpus
from snappy_tpu_torch.kernels import common_par as cp
from snappy_tpu_torch.kernels import decode_par as dp
from snappy_tpu_torch.kernels import encode_par as ep
from snappy_tpu_torch.spec import reference
from snappy_tpu_torch.spec.format import put_uvarint
from test_torch_framed_fuzz import _hostile_streams
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _chunks(seed: int, sizes) -> list:
    """make_corpus(seed) cut into consecutive chunks of ``sizes``."""
    data = b"".join(d for _, d in make_corpus(sum(sizes), seed=seed))
    out, at = [], 0
    for s in sizes:
        out.append(data[at : at + s])
        at += s
    return out


def _framed_payloads(stream: bytes) -> list:
    """The payloads (after the CRC) of a framed stream's compressed
    chunks, up to the first chunk that does not fit."""
    out, at = [], 10
    while at + 4 <= len(stream):
        kind = stream[at]
        ln = int.from_bytes(stream[at + 1 : at + 4], "little")
        body = stream[at + 4 : at + 4 + ln]
        if len(body) < ln:
            break
        if kind == 0x00 and ln >= 4:
            out.append(body[4:])
        at += 4 + ln
    return out


def _hostile_rows() -> list:
    return _bad_streams() + dp.edge_streams()


def _decode_three(streams, cmax: int, out_max: int):
    """(model, plain, JAX) (out, err) of one batch, as numpy."""
    arrs = dp.stream_rows(streams, cmax)
    model = dp.decode_rows_model(*arrs, out_max)
    out, err = dp.decode_blocks(*(torch.from_numpy(a) for a in arrs),
                                out_max=out_max)
    jout, jerr = decode_jnp.decode_blocks(*arrs, out_max=out_max)
    return model, (out.numpy(), err.numpy()), (np.asarray(jout),
                                                np.asarray(jerr))


def _assert_decode_same(streams, cmax: int, out_max: int):
    (mo, me), (po, pe), (jo, je) = _decode_three(streams, cmax, out_max)
    np.testing.assert_array_equal(me, je)
    np.testing.assert_array_equal(me, pe)
    good = me == 0
    np.testing.assert_array_equal(mo[good], jo[good])
    np.testing.assert_array_equal(mo[good], po[good])
    assert not mo[~good].any()
    return me, mo


def test_edge_streams_are_the_fuzz_payloads():
    """decode_par.edge_streams (what chip_smoke runs) are the element
    payloads of the sixteen hostile framed streams."""
    got = set()
    for s in _hostile_streams().values():
        got.update(_framed_payloads(s))
    assert got == set(dp.edge_streams())


def test_decode_model_corpus_chunks():
    chunks = _chunks(20260816, [4096, 16384, 9000, 5000])
    streams = [reference.compress(c) for c in chunks]
    err, mo = _assert_decode_same(streams, 16640, 16384)
    assert not err.any()
    for i, c in enumerate(chunks):
        assert mo[i, : len(c)].tobytes() == c and not mo[i, len(c):].any()


def test_decode_model_hostile_rows():
    """The corrupt raw streams (the int32 wrap cases of 4-byte fields
    among them) and the fuzz payloads: every code as JAX's, codes 2-5
    among them (1 only where the size matches, as in the garbage)."""
    err, _ = _assert_decode_same(_hostile_rows(), 256, 256)
    assert set(err.tolist()) >= {0, 2, 3, 4, 5}


@pytest.mark.parametrize("seed", range(2))
def test_decode_model_random_garbage(seed):
    """Random bytes after a random preamble, every byte a possible
    header: mostly errors, several at once in a row."""
    rng = np.random.default_rng(seed)
    streams = [bytes([int(rng.integers(0, 128))])
               + rng.integers(0, 256, int(rng.integers(0, 120)),
                              np.uint8).tobytes() for _ in range(64)]
    _assert_decode_same(streams, 256, 256)


def test_decode_model_windows_and_clamps():
    """Rows where the walk starts past cmax or before 0, comp_len past
    cmax or negative, dst_len past out_max, and a literal read from
    bytes past comp_len: as the plain version's (JAX's walk)."""
    good = reference.compress(b"window edges " * 40)
    arrs = dp.stream_rows([good] * 6, 1024)
    comp, start, clen, dlen = arrs
    start[1], start[2] = 2000, -3
    clen[3], clen[4] = 5000, -1
    dlen[5] = 400  # out_max 256 cuts the row, err stays 0 in both
    (mo, me) = dp.decode_rows_model(*arrs, 256)
    out, err = dp.decode_blocks(*(torch.from_numpy(a) for a in arrs),
                                out_max=256)
    np.testing.assert_array_equal(me, err.numpy())
    good_rows = me == 0
    np.testing.assert_array_equal(mo[good_rows], out.numpy()[good_rows])


def _encode_three(blocks, bmax: int, with_jax: bool = True):
    arr, lens = ep.stage_blocks(blocks, bmax)
    model = ep.encode_blocks_model(arr, lens, bmax)
    plain = tuple(x.numpy() for x in ep.encode_blocks(
        torch.from_numpy(arr), torch.from_numpy(lens), bmax=bmax))
    jax_out = (tuple(np.asarray(x) for x in encode_jnp.encode_blocks(
        arr, lens, bmax=bmax)) if with_jax else plain)
    return model, plain, jax_out


def _assert_encode_same(blocks, bmax: int, with_jax: bool = True):
    model, plain, jax_out = _encode_three(blocks, bmax, with_jax)
    for m, p, j in zip(model, plain, jax_out):
        np.testing.assert_array_equal(m, p)
        np.testing.assert_array_equal(m, j)
    return model


def test_encode_model_corpus_chunks():
    # nine rows, as the hostile blocks': one JAX compile serves both
    chunks = _chunks(20260817, [4096, 16384, 9000, 12000, 5000, 7, 2000,
                                700, 4000])
    comp, clen, ok = _assert_encode_same(chunks, 16384)
    assert ok.all()
    for i, c in enumerate(chunks):
        assert reference.decode_block(comp[i, : clen[i]].tobytes(),
                                      len(c)) == c


def test_encode_model_hostile_blocks():
    """A 16 KiB run, a period-3 pattern, random bytes, a lazy chain,
    all-0xFF words (the sort key's tie), 1-3 bytes and an empty block
    (chip_smoke runs them at 64 KiB)."""
    blocks = list(ep.edge_blocks(20260816, 16384).values())
    comp, clen, ok = _assert_encode_same(blocks, 16384)
    assert ok.all()
    for i, b in enumerate(blocks):
        assert reference.decode_block(comp[i, : clen[i]].tobytes(),
                                      len(b)) == b


def test_lazy_chain_block_defers_along_its_chain():
    """The lazy-chain block has the shape it is named for: along its
    chain the best match grows by 2 or more a position, so the lazy walk
    defers there, over 200 positions in a row."""
    blk = np.frombuffer(ep.lazy_chain_block(65536, 3), np.uint8)
    c1, c2, c3 = ep.candidates_model(blk, len(blk))

    def best(q):
        return max((ep._lcp(blk, q, int(c), len(blk) - q)
                    for c in (c1[q], c2[q], c3[q]) if c >= 0), default=0)

    ml = [best(q) for q in range(len(c1))]
    grows = [ml[q + 1] > ml[q] + 1 >= 5 for q in range(len(ml) - 1)]
    run = longest = 0
    for g in grows:
        run = run + 1 if g else 0
        longest = max(longest, run)
    assert longest > 200


def _elements(stream: bytes) -> list:
    """The (tag, header size) of each element of an element stream."""
    out, at = [], 0
    while at < len(stream):
        tag, x = stream[at] & 3, stream[at] >> 2
        if tag == 0:
            hdr = 1 if x < 60 else x - 58
            ln = (x if x < 60 else int.from_bytes(stream[at + 1 : at + hdr],
                                                  "little")) + 1
            at += hdr + ln
        else:
            hdr = (2, 3, 5)[tag - 1]
            at += hdr
        out.append((tag, hdr))
    return out


def test_encode_model_wide_row():
    """bmax = 2**17, one 2**17-byte block, against the plain version
    (JAX's encode_blocks stops one power short of this width: its
    tables hold 2**17 powers, the hash needs 2**17 + 1).  The block
    repeats 4 KiB 70,096 bytes back: those copies are copy-4 elements,
    and the stream decodes back to the block."""
    block = ep.wide_block(20260816)
    comp, clen, ok = _assert_encode_same([block], 1 << 17, with_jax=False)
    stream = comp[0, : clen[0]].tobytes()
    assert ok[0] and sum(t == 3 for t, _ in _elements(stream)) >= 64
    assert reference.decode_block(stream, len(block)) == block


def test_decode_model_wide_rows():
    """Rows wider than the kernel's shared image (out_max = 2**17): the
    chunked walk (``walk_records_chunked``) and the records resolved as
    per-byte pointers (``resolve_records``), against the plain version
    and JAX: two encodings of wide blocks
    (copy-4 elements among them), a reference stream of 99,999 corpus
    bytes and of one repeated byte, and a truncated row."""
    blocks = [ep.wide_block(20260816), ep.wide_block(33)[:100_000]]
    comp, clen, _ = ep.encode_blocks_model(*ep.stage_blocks(blocks, 1 << 17),
                                           1 << 17)
    streams = [put_uvarint(len(b)) + comp[i, : clen[i]].tobytes()
               for i, b in enumerate(blocks)]
    blocks += [_chunks(20260818, [99_999])[0], b"w" * 99_999]
    streams += [reference.compress(b) for b in blocks[2:]]
    err, mo = _assert_decode_same(streams + [streams[0][:-3]], 1 << 17,
                                  1 << 17)
    assert err.tolist() == [0, 0, 0, 0, dp.ERR_SIZE_MISMATCH]
    for i, b in enumerate(blocks):
        assert mo[i, : len(b)].tobytes() == b and not mo[i, len(b):].any()


def test_pow_table_past_jax_tables():
    """pow_table's 2**17 + 1 powers: JAX's 2**17, then one more of the
    same multiplier, each inverse the power's inverse."""
    n = (1 << 17) + 1
    for k in (0, 2):
        pw = cp.pow_table(k, n, "cpu").numpy()
        ipw = cp.pow_table(k + 1, n, "cpu").numpy()
        np.testing.assert_array_equal(pw[:-1], cp._pow_tables()[k])
        assert pw[-1] == (int(pw[-2]) * int(pw[1])) % (1 << 32)
        assert (int(pw[-1]) * int(ipw[-1])) % (1 << 32) == 1


def test_candidates_model_against_sorted_order(rng):
    """The radix passes with their per-warp offsets give the stable
    (word, position) order's neighbours and run heads."""
    blk = np.frombuffer(bytes(rng.choices(range(4), k=5000)), np.uint8)
    c1, c2, c3 = ep.candidates_model(blk, len(blk))
    b = blk.astype(np.int64)
    word = b[:-3] | b[1:-2] << 8 | b[2:-1] << 16 | b[3:] << 24
    order = np.argsort(word, kind="stable")
    for f in range(1, len(order)):
        p, w = order[f], word[order[f]]
        same = word[order[f - 1]] == w
        assert c1[p] == (order[f - 1] if same else -1)
        if same:
            assert c3[p] == order[np.searchsorted(word[order], w)]
            assert c2[p] == (order[f - 2] if f >= 2
                             and word[order[f - 2]] == w else -1)


@pytest.mark.parametrize("chunk", [7, 64])
def test_chunked_walk_is_the_walk(chunk):
    """The wide rows' walk split over chunks (speculative walks, entries,
    counts, records) gives the single walk's records and code, on chunks
    small enough that many speculative walks start inside a tag: a
    corpus stream, the hostile rows, random garbage, and starts and
    comp_len moved off the stream."""
    rng = np.random.default_rng(chunk)
    streams = [reference.compress(_chunks(20260819, [6000])[0])]
    streams += _hostile_rows()
    streams += [bytes([int(rng.integers(0, 128))]) + rng.integers(
        0, 256, int(rng.integers(0, 600)), np.uint8).tobytes()
        for _ in range(24)]
    comp, start, clen, dlen = dp.stream_rows(streams, 8192)
    for b in range(len(streams)):
        for st, cl in ((int(start[b]), int(clen[b])),
                       (int(start[b]) + 3, int(clen[b])),
                       (-2, int(clen[b]) + 5)):
            row = comp[b, : max(0, min(cl, 8192))].tobytes()
            want = dp.walk_records(row, 8192, st, cl, int(dlen[b]))
            assert dp.walk_records_chunked(row, 8192, st, cl, int(dlen[b]),
                                           chunk) == want


def _walk_blocks() -> dict:
    """The blocks the chunked parse is held on: corpus chunks, every
    edge_blocks entry (the lazy chain among them), wide_block and the
    hand-made blocks whose walks do not meet inside a chunk."""
    chunks = _chunks(20260820, [16384, 9000, 4096])
    blocks = {f"corpus {i}": c for i, c in enumerate(chunks)}
    blocks.update(ep.edge_blocks(20260816, 16384))
    blocks["wide block"] = ep.wide_block(20260816)
    blocks.update(ep.resync_blocks(20260816, 16384))
    return blocks


@pytest.mark.parametrize("chunk", [64, 1024, ep.PARSE_CHUNK])
def test_chunked_parse_is_the_walk(chunk):
    """walk_model_chunked (the parse kernel's speculative walks, true
    entries and copy list) gives walk_model's copies, greedy and lazy,
    on every block of _walk_blocks; on the hand-made blocks the true walk
    walks chunks itself, meeting no speculative walk there."""
    alone = {}
    for name, b in _walk_blocks().items():
        blk = np.frombuffer(b, np.uint8)
        entries = ep.entries_model(blk, len(blk),
                                   ep.candidates_model(blk, len(blk)))
        for lazy in (False, True):
            meets = []
            assert ep.walk_model_chunked(blk, len(blk), entries, lazy, chunk,
                                         meets) == \
                ep.walk_model(blk, len(blk), entries, lazy), (name, lazy)
            alone[name, lazy] = sum(m is None for m in meets)
    for name in ep.resync_blocks(0, 4096):
        assert alone[name, False] > 0 and alone[name, True] > 0, name


def test_resync_blocks_take_four_byte_copies():
    """The off-phase block is what its name says: every copy of both
    walks is 4 bytes, the first at position 257 (phase 1, every chunk's
    first position phase 0); the crossing block holds a copy of 2,600
    bytes or more across two chunk ends of PARSE_CHUNK."""
    blocks = ep.resync_blocks(20260816, 16384)
    for name, b in blocks.items():
        blk = np.frombuffer(b, np.uint8)
        entries = ep.entries_model(blk, len(blk),
                                   ep.candidates_model(blk, len(blk)))
        copies = ep.walk_model(blk, len(blk), entries, False)
        if name == "4-byte matches off phase":
            assert copies[0][0] == 257
            assert {ln for _, ln, _ in copies} == {4}
        else:
            pos, ln, _ = max(copies, key=lambda c: c[1])
            assert ln >= 2600 and (pos + ln) // ep.PARSE_CHUNK \
                - pos // ep.PARSE_CHUNK >= 2 and (pos + ln) % 4 == 2


@pytest.mark.parametrize("rows", ["corpus", "hostile", "resync"])
def test_narrow_model_is_the_row_model(rows):
    """narrow_rows_model (the chunked walk at NARROW_CHUNK, then the
    record executor's rounds) gives decode_rows_model's codes and bytes
    and the plain version's, on corpus rows, the hostile rows (the fuzz
    payloads among them) and the streams whose chunked walks do not meet
    (resync_streams)."""
    if rows == "corpus":
        chunks = _chunks(20260821, [4096, 16384, 9000, 65536])
        streams, cmax = [reference.compress(c) for c in chunks], 66560
    elif rows == "hostile":
        streams, cmax = _hostile_rows(), 256
    else:
        streams, cmax = dp.resync_streams(), 46080
    arrs = dp.stream_rows(streams, cmax)
    mo, me = dp.decode_rows_model(*arrs, 65536)
    no, ne = dp.narrow_rows_model(*arrs, 65536)
    po, pe = dp.decode_blocks(*(torch.from_numpy(a) for a in arrs),
                              out_max=65536)
    np.testing.assert_array_equal(ne, me)
    np.testing.assert_array_equal(ne, pe.numpy())
    good = me == 0
    np.testing.assert_array_equal(no[good], mo[good])
    np.testing.assert_array_equal(no[good], po.numpy()[good])
    assert not no[~good].any()
    if rows != "hostile":
        assert me.tolist() == [0] * (len(streams) - (rows == "resync")) \
            + [dp.ERR_OVERRUN_INPUT] * (rows == "resync")


@pytest.mark.parametrize("chunk", [dp.NARROW_CHUNK, dp.CHUNK])
def test_resync_streams_walk_chunks_alone(chunk):
    """In resync_streams the true walk enters chunks off phase and meets
    no tag start of the chunk's speculative walk there, and the chunked
    walk still gives the single walk's records and code."""
    comp, start, clen, dlen = dp.stream_rows(dp.resync_streams(), 46080)
    alone = 0
    for b in range(comp.shape[0]):
        row = comp[b, : clen[b]].tobytes()
        args = (46080, int(start[b]), int(clen[b]), int(dlen[b]))
        assert dp.walk_records_chunked(row, *args, chunk) == \
            dp.walk_records(row, *args)
        padded = row + bytes(dp.WINDOW + 5)
        true = set(dp._walk_span(padded, 46080, int(clen[b]), int(dlen[b]),
                                 int(start[b]), int(clen[b]), 0)[5])
        for c in range(int(start[b]), int(clen[b]), chunk):
            stop = min(c + chunk, int(clen[b]))
            spec = dp._walk_span(padded, 46080, int(clen[b]), int(dlen[b]),
                                 c, stop, 0)[5]
            mine = {t for t in true if c <= t < stop}
            alone += bool(mine) and not mine & set(spec)
    assert alone >= 2
