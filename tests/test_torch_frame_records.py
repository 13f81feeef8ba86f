"""The framed-record kernel's plain version (``kernels.frame_records``)
against the runtime's host assembly, ``_framed_record`` a chunk, over
the same rows: chunk types at and around the 12.5% boundary, the three
varint widths, one-row and mixed batches.  The CUDA kernel is held
against this plain version on the card (``test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from snappy_tpu_torch.kernels import frame_records as kfr
from snappy_tpu_torch.runtime.device_codec import _framed_record
from snappy_tpu_torch.spec.format import CHUNK_COMPRESSED, CHUNK_UNCOMPRESSED
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CS = 65536
CAP = CS + CS // 6 + 48  # wider than any element of a 64 KiB chunk


def _at_boundary(n: int, below: int) -> int:
    """The element length whose body (varint + element) is ``below``
    bytes short of saving 12.5% of an n-byte chunk: 0 is the first
    length stored raw, 1 the last one compressed."""
    vlen = 1 + (n >= 128) + (n >= 16384)
    return n - n // 8 - vlen - below


# (chunk length, element length, stored) of each row of a batch
CASES = {
    "stored row": [(CS, CS + 9, True)],
    "compressible row": [(CS, 1000, False)],
    "stored at the boundary": [(CS, _at_boundary(CS, 0), True)],
    "compressed a byte below it": [(CS, _at_boundary(CS, 1), False)],
    "1-byte varint": [(CS, 700, False), (100, 20, False)],
    "1-byte varint at the boundary": [(100, _at_boundary(100, 0), True),
                                      (100, _at_boundary(100, 1), False)],
    "2-byte varint": [(CS, 700, False), (16383, 4000, False)],
    "2-byte varint, stored": [(CS, 700, False), (200, 190, True)],
    "3-byte varint": [(CS, 12, False), (16384, 2, False)],
    "one row": [(777, 100, False)],
    "mixed batch": [(CS, 900, False), (CS, CS + 9, True),
                    (CS, _at_boundary(CS, 0), True),
                    (CS, _at_boundary(CS, 1), False), (CS, 3, False),
                    (5000, 4990, True), (127, 5, False), (1, 2, True)],
}


def _batch(rows_spec, seed: int):
    rng = np.random.default_rng(seed)
    nb = len(rows_spec)
    rows = rng.integers(0, 256, (nb, CS), np.uint8)
    comp = rng.integers(0, 256, (nb, CAP), np.uint8)
    lens = np.array([n for n, _, _ in rows_spec], np.int32)
    clens = np.array([c for _, c, _ in rows_spec], np.int32)
    crc = rng.integers(0, 1 << 32, nb, np.int64)
    return rows, lens, comp, clens, crc


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_equals_the_host_records(name):
    spec = CASES[name]
    rows, lens, comp, clens, crc = _batch(spec, seed=len(name))
    want = [_framed_record(int(n), comp[i, :c].tobytes(), int(crc[i]),
                           rows[i, :n])
            for i, (n, c, _) in enumerate(spec)]
    assert [r[0] for r in want] == [
        CHUNK_UNCOMPRESSED if s else CHUNK_COMPRESSED for _, _, s in spec]
    before = kfr.launches
    framed, ends = kfr.frame_records(*map(torch.from_numpy,
                                          (rows, lens, comp, clens, crc)))
    assert kfr.launches == before  # the plain version: no launch
    assert framed.dtype == torch.uint8 and framed.shape == (len(spec) * (CS + 8),)
    assert ends.tolist() == np.cumsum([len(r) for r in want]).tolist()
    assert framed[: int(ends[-1])].numpy().tobytes() == b"".join(want)


def test_strided_rows_and_clamped_lengths():
    """Rows and elements as column slices (a row pitch wider than the
    row), and lengths past the rows' ends taken at the ends."""
    rows, lens, comp, clens, crc = _batch([(CS, 500, False)] * 3, seed=5)
    rows_v = torch.from_numpy(rows)[:, 3:3000]
    comp_v = torch.from_numpy(comp)[:, 1:400]
    lens_t = torch.tensor([2997, 5000, 10], dtype=torch.int32)
    clens_t = torch.tensor([50, 500, 9], dtype=torch.int32)
    framed, ends = kfr.frame_records(rows_v, lens_t, comp_v, clens_t,
                                     torch.from_numpy(crc))
    want = b"".join(_framed_record(
        n, comp[i, 1 : 1 + c].tobytes(), int(crc[i]), rows[i, 3 : 3 + n])
        for i, (n, c) in enumerate([(2997, 50), (2997, 399), (10, 9)]))
    assert framed.shape == (3 * (2997 + 8),)
    assert framed[: int(ends[-1])].numpy().tobytes() == want


@pytest.mark.parametrize("bad", ["rows dtype", "wide rows", "lens dtype",
                                 "comp rows", "crc shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    rows = torch.zeros(2, 64, dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    comp = torch.zeros(2, 96, dtype=torch.uint8)
    clens = torch.zeros(2, dtype=torch.int32)
    crc = torch.zeros(2, dtype=torch.int64)
    args = dict(rows=rows, lens=lens, comp=comp, clens=clens, crc=crc)
    args.update({"rows dtype": dict(rows=rows.to(torch.int32)),
                 "wide rows": dict(rows=torch.zeros(2, CS + 1,
                                                    dtype=torch.uint8)),
                 "lens dtype": dict(lens=lens.to(torch.int64)),
                 "comp rows": dict(comp=comp[:1]),
                 "crc shape": dict(crc=crc[:1])}[bad])
    with pytest.raises(ValueError):
        kfr.frame_records(**args)
