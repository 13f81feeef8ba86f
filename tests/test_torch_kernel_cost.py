"""``snappy_tpu_torch.bench.kernel_cost.kernel_bytes``, the bytes behind
each bound that ``chip_smoke.py`` and the profilers print: for the jnp
engines' batches (``decode_par.decode_blocks``, ``encode_par.
encode_blocks``) and the record executor, the bytes of the inputs the
function reads plus the bytes of the outputs it returns, on small seeded
batches run on the CPU.  Tolerance: 0 (byte counts)."""

import numpy as np
import pytest
import torch

from snappy_tpu_torch.bench.kernel_cost import keep, kernel_bytes
from snappy_tpu_torch.kernels import decode_par as dp
from snappy_tpu_torch.kernels import decode_pretagged as kp
from snappy_tpu_torch.kernels import encode_par as ep


def _blocks(seed: int, nb: int, bmax: int):
    rng = np.random.default_rng(seed)
    words = [rng.bytes(int(rng.integers(2, 9))) for _ in range(40)]
    blocks = np.zeros((nb, bmax), np.uint8)
    lens = rng.integers(1, bmax + 1, nb).astype(np.int32)
    for i, n in enumerate(lens):
        text = b" ".join(words[j] for j in rng.integers(0, 40, bmax))[:n]
        blocks[i, :n] = np.frombuffer(text, np.uint8)
    return torch.from_numpy(blocks), torch.from_numpy(lens)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("nb,bmax", [(3, 1024), (5, 4096)])
def test_encode_blocks_bytes(nb, bmax):
    """The blocks' bytes and lengths read, the element rows, lengths and
    flags written (``encode_par.encode_blocks``' outputs)."""
    blocks, lens = _blocks(nb, nb, bmax)
    outs = ep.encode_blocks(blocks, lens, bmax)
    assert kernel_bytes("encode_blocks", (blocks, lens)) == (
        int(lens.sum()) + _nbytes(lens) + _nbytes(*outs))


@pytest.mark.parametrize("out_max", [1024, 4096])
def test_decode_blocks_bytes(out_max):
    """Each row's element stream (from its start to its length) and the
    three int32 words a row read, the rows and error codes written."""
    blocks, lens = _blocks(7, 4, 1024)
    comp, clen, ok = ep.encode_blocks(blocks, lens, 1024)
    assert bool(ok.all())
    start = torch.zeros(4, dtype=torch.int32)
    args = (comp, start, clen, lens)
    outs = dp.decode_blocks(*args, out_max=out_max)
    assert torch.equal(outs[0][:, :1024], blocks) or out_max < 1024
    assert kernel_bytes("decode_blocks", args, out_max) == (
        int((clen - start).sum()) + 3 * _nbytes(start) + _nbytes(*outs))


def test_decode_pretagged_bytes():
    """16 bytes a record, the payload bytes the literals read, the two
    int32 words a row read, the rows written."""
    comp, recs, nt, dl, out_max = kp.edge_cases()["straddle"]
    args = tuple(torch.from_numpy(a) for a in (comp, recs, nt, dl))
    live = recs[0, : nt[0]]
    lit = int(live[live[:, 0] == 0, 1].sum())
    out = kp.decode_blocks_pretagged(*args, out_max=out_max)
    assert kernel_bytes("decode_pretagged", args, out_max) == (
        16 * int(nt[0]) + lit + _nbytes(args[2], args[3]) + _nbytes(out))


def test_frame_records_bytes():
    """Each record's body read (the stored chunk or the element), a
    length, an element length and a CRC a row; the records and an end
    offset a row written."""
    from snappy_tpu_torch.kernels import frame_records as kfr

    blocks, lens = _blocks(11, 4, 1024)
    comp = torch.zeros(4, 1400, dtype=torch.uint8)
    clens = torch.tensor([10, 1000, 1023, 0], dtype=torch.int32)
    crc = torch.zeros(4, dtype=torch.int64)
    args = (blocks, lens, comp, clens, crc)
    framed, ends = kfr.frame_records(*args)
    _n, _c, vlen, raw, _body = kfr.layout(lens, clens, 1024, 1400)
    bodies = sum(int(lens[i]) if raw[i] else int(clens[i]) for i in range(4))
    assert raw.any() and not raw.all()
    assert kernel_bytes("frame_records", args) == (
        bodies + _nbytes(lens, clens, crc) + int(ends[-1]) + _nbytes(ends))


def test_keep_copies_a_span_view_as_one_row():
    """A recorded launch's arguments: a row-stride-0 view (the seq
    engine's span) kept as one copy of its row, expanded again; other
    tensors copied whole; anything else as it is.  The seq decode bytes
    of the kept span are the span's."""
    span = torch.arange(40, dtype=torch.int32).to(torch.uint8)
    view = span.expand(5, 40)
    kept = keep(view)
    assert kept.stride() == (0, 1) and torch.equal(kept, view)
    assert kept.untyped_storage().nbytes() == 40
    span[0] = 99  # the runtime reuses its buffers
    assert int(kept[3, 0]) == 0
    rows = torch.ones(3, 8, dtype=torch.uint8)
    kept_rows = keep(rows)
    assert torch.equal(kept_rows, rows) and \
        kept_rows.data_ptr() != rows.data_ptr()
    assert keep(7) == 7
    st, cl = torch.tensor([1, 11, 21, 30, 0], dtype=torch.int32), \
        torch.tensor([10, 20, 30, 40, 0], dtype=torch.int32)
    assert kernel_bytes("seq_decode", (kept, st, cl, cl), 64) == \
        kernel_bytes("seq_decode", (view, st, cl, cl), 64) == \
        9 + 9 + 9 + 10 + 12 * 5 + 5 * (64 + 4)
