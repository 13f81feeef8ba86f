"""The hybrid decode's device half (``snappy_tpu_torch.kernels.
decode_pretagged``) against the JAX package's ``decode_blocks_pretagged``
on records from the port's ``native.parse_tags``, at the three payload
row widths the runtime uses (16,640 / 33,280 / 66,560 bytes), with
run-length chains and overlapping copies.  On the CPU the wrapper runs
its plain version; the kernel's schedule (literals first, copies in
groups of 32 run in rounds once their producers are done) is held here
through
``decode_pretagged.execute_records_model``, on corpus chunks and on the
hand-made record sets of ``decode_pretagged.edge_cases``, against the
plain version, JAX and ``decode_seq.execute_records`` (the records in
order); on the card by ``tests/test_torch_cuda.py``.  Counterpart of
``tests/test_pretagged.py``.  Tolerance: 0 (bytes)."""

import numpy as np
import pytest
import torch

from snappy_tpu.kernels.decode_pretagged import decode_blocks_pretagged as jdec
from snappy_tpu_torch import native
from snappy_tpu_torch.errors import CorruptError
from snappy_tpu_torch.kernels import decode_pretagged as kp
from snappy_tpu_torch.kernels.decode_seq import execute_records
from snappy_tpu_torch.spec import reference
from snappy_tpu_torch.spec.format import put_uvarint, read_uvarint

OUT_MAX = 65536


def stage(streams, cmax: int, t_cap: int = 2048):
    """(comp, recs, ntags, dlens) numpy arrays of raw snappy streams, as
    the hybrid engine stages a batch: payload rows of width cmax, the
    parser's records padded to t_cap (2048 doubled up to the most any row
    needs)."""
    parsed = []
    for s in streams:
        d, h = read_uvarint(s, 0)
        tmp = np.zeros((cmax // 2 + 2, 4), np.int32)
        nt = native.parse_tags(s, h, d, tmp)
        parsed.append((tmp[:nt].copy(), d))
    while t_cap < max(len(p) for p, _ in parsed):
        t_cap *= 2
    B = len(streams)
    comp = np.zeros((B, cmax), np.uint8)
    recs = np.zeros((B, t_cap, 4), np.int32)
    ntags = np.zeros(B, np.int32)
    dlens = np.zeros(B, np.int32)
    for i, (s, (p, d)) in enumerate(zip(streams, parsed)):
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
        recs[i, : len(p)] = p
        ntags[i], dlens[i] = len(p), d
    return comp, recs, ntags, dlens


def _in_order(comp, recs, ntags, dlens, out_max):
    """Each row's records executed one after another (the writer warp of
    csrc/seq_decode.cu), zeros from min(dst_len, out_max)."""
    out = np.zeros((comp.shape[0], out_max), np.uint8)
    for b in range(comp.shape[0]):
        rec = [(int(d), int(ln), int(a), 0 if kind == 0 else 1)
               for kind, ln, a, d in recs[b, : ntags[b]]]
        execute_records(rec, comp[b].tobytes(), out[b])
        out[b, max(0, min(int(dlens[b]), out_max)):] = 0
    return out


def _model(comp, recs, ntags, out_max, dlens=None):
    """The kernel's schedule on the host (execute_records_model)."""
    if dlens is None:
        dlens = np.full(comp.shape[0], out_max, np.int32)
    return kp.execute_records_model(comp, recs, ntags, dlens, out_max)[0]


def _samples(nprng, cmax: int):
    """Streams whose payloads fit a cmax-wide row, at least one needing
    it: run-length chains (offset-1 copies), overlapping copies (offset
    < length), text, random literals, an empty block."""
    text = b"pretagged records, overlapping copies " * 2000
    periodic = (nprng.bytes(7) * 10000)[:65536]
    raw_n = {16640: 16000, 33280: 33000, 66560: 65536}[cmax]
    data = [b"A" * 65536, periodic, text[:65536], b"", b"ab" + b"c" * 5000,
            nprng.bytes(raw_n), nprng.bytes(raw_n // 3) + b"Z" * 20000]
    streams = [reference.compress(d) for d in data]
    assert max(len(s) for s in streams) <= cmax
    return data, streams


@pytest.mark.parametrize("cmax", [16640, 33280, 66560])
def test_plain_matches_jax(nprng, cmax):
    data, streams = _samples(nprng, cmax)
    comp, recs, ntags, dlens = stage(streams, cmax)
    want = np.asarray(jdec(comp, recs, ntags, dlens, out_max=OUT_MAX))
    got = kp.decode_blocks_pretagged(
        *(torch.from_numpy(a) for a in (comp, recs, ntags, dlens)),
        out_max=OUT_MAX)
    assert got.dtype == torch.uint8 and got.shape == (len(data), OUT_MAX)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_model(comp, recs, ntags, OUT_MAX, dlens),
                                  want)
    for i, d in enumerate(data):
        assert got[i, : len(d)].numpy().tobytes() == d
        assert not got[i, len(d):].any()


def test_hand_made_streams(nprng):
    """Element streams built by hand: a run-length chain of offset-1
    copies, copies whose offset is shorter than their length, a 2-byte
    and a 4-byte offset, literals with 1- to 3-byte length fields."""
    lit = nprng.bytes(300)
    body = (bytes([61 << 2, 43, 1]) + lit               # 300-byte literal
            + bytes([(59 << 2) | 2, 1, 0])              # copy off 1, len 60
            + bytes([(7 << 2) | 1, 3])                  # copy off 3, len 11
            + bytes([(63 << 2) | 2, 44, 1])             # copy off 300, len 64
            + bytes([(31 << 2) | 3, 2, 0, 0, 0])        # copy off 2, len 32
            + bytes([60 << 2, 9]) + lit[:10])           # 10-byte literal
    want = bytearray(lit)
    for off, ln in ((1, 60), (3, 11), (300, 64), (2, 32)):
        for _ in range(ln):
            want.append(want[-off])
    want += lit[:10]
    stream = put_uvarint(len(want)) + body
    assert reference.decompress(stream) == bytes(want)
    comp, recs, ntags, dlens = stage([stream, b"\x00"], 16640)
    got = kp.decode_blocks_pretagged(
        *(torch.from_numpy(a) for a in (comp, recs, ntags, dlens)),
        out_max=1024)
    assert got[0, : len(want)].numpy().tobytes() == bytes(want)
    assert not got[0, len(want):].any() and not got[1].any()
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdec(comp, recs, ntags, dlens, out_max=1024)))


def test_stage_records_is_the_runtime_staging(nprng):
    """The helper stages what the hybrid engine stages: the bucket of the
    widest payload, records padded to the 2048-doubled cap."""
    data, streams = _samples(nprng, 33280)
    heads = [read_uvarint(s, 0) for s in streams]
    got = kp.stage_records(streams, [h for _, h in heads],
                           [d for d, _ in heads], device="cpu")
    want = stage(streams, 33280)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_parse_tags_rejects_what_jax_rejects():
    rec = np.zeros((64, 4), np.int32)
    for stream in (b"\x05\x0cabcd", b"\x08\x0cabcd" + bytes([(3 << 2) | 1, 0])):
        dlen, hdr = read_uvarint(stream, 0)
        with pytest.raises(CorruptError):
            native.parse_tags(stream, hdr, dlen, rec)


def test_wrapper_checks_its_arguments():
    comp = torch.zeros(2, 16, dtype=torch.uint8)
    recs = torch.zeros(2, 4, 4, dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    for bad in ((comp.int(), recs, n, n), (comp, recs[:, :, :3], n, n),
                (comp, recs, n[:1], n), (comp, recs, n, n.long())):
        with pytest.raises(ValueError):
            kp.decode_blocks_pretagged(*bad, out_max=16)
    assert not kp.decode_blocks_pretagged(comp, recs, n, n, out_max=16).any()


EDGE = kp.edge_cases()


@pytest.mark.parametrize("name", sorted(EDGE))
def test_model_on_hand_made_records(name):
    """The kernel's schedule (execute_records_model) byte for byte against
    the plain version, JAX and the records in order on each hand-made set;
    each group of copies takes at least one round and at most one a copy,
    and a chain of copies that each read the copy before takes one a
    copy."""
    comp, recs, nt, dl, out_max = EDGE[name]
    got, rounds = kp.execute_records_model(comp, recs, nt, dl, out_max)
    want = np.asarray(jdec(comp, recs, nt, dl, out_max=out_max))
    plain = kp.decode_blocks_pretagged(
        *(torch.from_numpy(a) for a in (comp, recs, nt, dl)),
        out_max=out_max).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(_in_order(comp, recs, nt, dl, out_max),
                                  want)
    lim = min(int(dl[0]), out_max)
    assert got.shape == (1, out_max) and not got[0, lim:].any()
    # the copies of each tile, as the kernel groups them
    live = recs[0, : nt[0]]
    n_copies = [int(((live[b : b + kp.TILE, 0] != 0)
                     & (live[b : b + kp.TILE, 3] < lim)).sum())
                for b in range(0, int(nt[0]), kp.TILE)]
    sizes = [min(32, n - g) for n in n_copies for g in range(0, n, 32)]
    assert len(rounds[0]) == len(sizes)
    assert all(1 <= r <= s for r, s in zip(rounds[0], sizes))
    if name in ("offset1_run", "chain", "far_payload"):
        assert rounds[0].tolist() == sizes


def test_group_waits():
    """A lane waits on the lanes below it whose outputs meet its sources,
    never on itself or a later lane."""
    d = np.array([0, 4, 8, 12, 100, 104])
    n = np.array([4, 4, 4, 4, 4, 4])
    a = np.array([0, 4, 6, 12, 99, 50])
    # lane 1 reads [0, 4) (lane 0); lane 2 reads [2, 6) (lanes 0, 1); lane
    # 3 reads [0, 4) (lane 0); lane 4 reads [1, 5) (lanes 0, 1); lane 5
    # reads [54, 58) (none); lane 0 writes zeros (none)
    assert kp.group_waits(d, n, a).tolist() == [0, 1, 3, 1, 3, 0]
    # a source inside the lane's own output is out of contract: capped
    assert kp.group_waits([0, 4], [4, 8], [0, 1]).tolist() == [0, 1]


@pytest.mark.parametrize("profile", ["dickens", "xml", "samba", "osdb",
                                     "mozilla"])
def test_model_on_corpus_chunks(profile):
    """The schedule on the parser's records of corpus chunks (make_corpus,
    seeded, 4 MiB: up to 4 compressed chunks of one profile, staged as the
    hybrid engine stages them) against the plain version, JAX and the
    decoded bytes; text needs several rounds a group, never more than one
    a copy."""
    from snappy_tpu_torch.bench.corpus import make_corpus
    from snappy_tpu_torch.runtime import device_codec as dc

    data = dict(make_corpus(4 << 20, seed=20260816))[profile]
    fr = native.compress_framed(data)
    chunks, _ = dc._scan_frames(fr)
    comp_chunks = [ch for ch in chunks if ch[0] == 0][:4]
    assert comp_chunks, profile
    args = kp.stage_records([fr[ch[1] : ch[1] + ch[2]] for ch in comp_chunks],
                            [ch[5] for ch in comp_chunks],
                            [ch[4] for ch in comp_chunks], device="cpu")
    got, rounds = kp.execute_records_model(*args, out_max=OUT_MAX)
    want = np.asarray(jdec(*(a.numpy() for a in args), out_max=OUT_MAX))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        kp.decode_blocks_pretagged(*args, out_max=OUT_MAX).numpy(), want)
    for i, ch in enumerate(comp_chunks):
        assert got[i, : ch[4]].tobytes() == native.decompress(
            fr[ch[1] : ch[1] + ch[2]])
    allr = np.concatenate(rounds)
    assert allr.min() >= 1 and allr.max() <= 32
    if profile == "dickens":
        assert allr.mean() > 2
