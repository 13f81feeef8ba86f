"""The framed encode of chunk rows sharded over a mesh, through the
port's one from-device entry point: ``compress_framed_from_device(rows,
lens)`` with ``rows`` a ``dist.mesh.ShardedRows`` on a CPU mesh of four
shards, held byte for byte against the benchmark's plain reference
(``portbench/reference/plain.py``, the greedy encoder one byte at a
time) and against the entry point's single-tensor path, in the id and
the seq engines as ``portbench/configs/silesia-{id,seq}.json`` set
them; the multi-host records, the per-card counters and the spans."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import trace as tr
from portbench.reference import plain
from snappy_tpu_torch import api
from snappy_tpu_torch.dist import mesh as dm
from snappy_tpu_torch.dist import multihost as mh
from snappy_tpu_torch.runtime import device_codec as dc
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CS = 65536
CARDS = 4
VARIABLES = {"SNAPPY_TPU_FLAT": "FLAT", "SNAPPY_TPU_HOST_PARSE": "HOST_PARSE",
             "SNAPPY_TPU_DEVICE_CRC": "DEVICE_CRC", "SNAPPY_TPU_PALLAS": "PALLAS"}


@pytest.fixture
def engine(request, monkeypatch):
    """The runtime set as the benchmark's configuration of this engine
    sets it."""
    with open(os.path.join(REPO, "portbench", "configs",
                           f"silesia-{request.param}.json")) as f:
        env = json.load(f)["env"]
    for var, attr in VARIABLES.items():
        monkeypatch.setattr(dc, attr, env[var] != "0")
    monkeypatch.setattr(dc, "FLAT_MODE", env["SNAPPY_TPU_FLAT_MODE"])
    return request.param


@pytest.fixture
def mesh():
    return dm.make_mesh(devices=["cpu"] * CARDS)


@pytest.fixture
def shards(monkeypatch):
    """``dist.mesh.SHARDS`` emptied for the test."""
    fresh = {"d2h_bytes": [], "crc_launches": []}
    monkeypatch.setattr(dm, "SHARDS", fresh)
    return fresh


def _text(rng, n: int) -> bytes:
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)), np.uint8))
             for _ in range(200)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, 200, n // 3 + 1))
    return text[:n]


# the objects by case, each made from a generator seeded by its case
OBJECTS = {
    "empty": lambda rng: b"",
    "one_byte": lambda rng: b"x",
    "one_chunk": lambda rng: _text(rng, CS),
    # two rows: the mesh's last two shards hold only padding
    "two_chunks": lambda rng: _text(rng, CS + 3000),
    "nine_chunks_short_last": lambda rng: _text(rng, 8 * CS + 12345),
    # an incompressible chunk, stored raw, between compressible ones
    "stored_between": lambda rng: (_text(rng, 2 * CS) + rng.bytes(CS)
                                   + _text(rng, CS + 77)),
}


def _object(case: str) -> bytes:
    return OBJECTS[case](np.random.default_rng(sorted(OBJECTS).index(case)))


def _lay_out(mesh, data: bytes):
    """(rows, lens): ``data``'s chunk rows over the mesh, the row count
    padded to a multiple of the mesh size, and each real row's bytes."""
    b = -(-len(data) // CS)
    rows = np.zeros((-(-b // CARDS) * CARDS, CS), np.uint8)
    rows.reshape(-1)[: len(data)] = np.frombuffer(data, np.uint8)
    lens = np.minimum(len(data) - np.arange(b) * CS, CS).astype(np.int32)
    return dm.shard_rows(mesh, torch.from_numpy(rows)), lens


def _single(data: bytes) -> bytes:
    return dc.compress_framed_from_device(
        torch.from_numpy(np.frombuffer(data, np.uint8).copy()))


@pytest.mark.parametrize("engine", ["id", "seq"], indirect=True)
@pytest.mark.parametrize("case", sorted(OBJECTS))
def test_sharded_stream_is_the_plain_reference(engine, mesh, case):
    data = _object(case)
    rows, lens = _lay_out(mesh, data)
    assert all(s.device == torch.device("cpu") for s in rows.shards)
    want = plain.frame(data)
    got = dc.compress_framed_from_device(rows, lens)
    assert got == want
    assert got == _single(data)
    assert api.compress_framed_from_device(rows, lens) == want
    assert dm.sharded_compress_framed_from_device(mesh, rows, lens) == want


@pytest.mark.parametrize("engine", ["id", "seq"], indirect=True)
def test_a_short_middle_row_is_a_chunk_of_its_own(engine, mesh):
    """Rows shorter than a chunk in the middle of a shard: each row is
    one chunk, so the stream is each row's own record in row order."""
    rng = np.random.default_rng(11)
    lens = np.array([CS, 1000, CS, 70, 33, CS, 0, 5], np.int32)
    host = np.zeros((8, CS), np.uint8)
    for i, ln in enumerate(lens):
        host[i, :ln] = np.frombuffer(_text(rng, int(ln)), np.uint8)
    rows = dm.shard_rows(mesh, torch.from_numpy(host))
    pieces = [host[i, :ln].tobytes() for i, ln in enumerate(lens)]
    want = plain.STREAM_ID + b"".join(plain.frame(p)[len(plain.STREAM_ID):]
                                      for p in pieces)
    assert dc.compress_framed_from_device(rows, lens) == want
    assert want == plain.STREAM_ID + b"".join(
        _single(p)[len(plain.STREAM_ID):] for p in pieces)
    recs = dm.sharded_encode_rows_to_chunks(mesh, rows, lens)
    assert len(recs) == len(lens) and recs[6] == b""
    assert plain.STREAM_ID + b"".join(recs) == want


def test_multihost_records_join_into_the_stream(mesh):
    data = _object("nine_chunks_short_last")
    rows, lens = _lay_out(mesh, data)
    bodies, lengths = mh.host_compress_framed_from_device(rows, lens)
    assert len(bodies) == len(lens)
    assert list(lengths) == [len(b) for b in bodies]
    assert plain.STREAM_ID + b"".join(bodies) == plain.frame(data)


def test_rejects_what_is_not_sharded_rows(mesh):
    rows, lens = _lay_out(mesh, b"abc")
    with pytest.raises(ValueError):
        dc.compress_framed_from_device(rows.cpu(), lens)
    with pytest.raises(ValueError):
        dc.compress_framed_from_device(rows, [3] * 5)
    with pytest.raises(ValueError):
        dc.compress_framed_from_device(rows, [CS + 1])
    with pytest.raises(ValueError):
        dc.compress_framed_from_device(rows, lens, device="cpu")


@pytest.mark.parametrize("engine", ["id"], indirect=True)
def test_shards_count_each_cards_bytes(engine, mesh, shards):
    """Nine rows over four shards of three: each card's rows and CRC
    values, one CRC launch a shard with rows, none on the shard of
    padding; the runtime's counters count the same calls."""
    data = _object("nine_chunks_short_last")
    rows, lens = _lay_out(mesh, data)
    before = dict(dc.COUNTERS)
    dc.compress_framed_from_device(rows, lens)
    per_shard = [int(lens[k * 3 : (k + 1) * 3].sum()) for k in range(CARDS)]
    assert shards["d2h_bytes"] == [n + 8 * 3 if n else 0 for n in per_shard]
    assert shards["crc_launches"] == [1, 1, 1, 0]
    assert dc.COUNTERS["bytes"] - before["bytes"] == len(data)
    assert (dc.COUNTERS["d2h_bytes"] - before["d2h_bytes"]
            == sum(shards["d2h_bytes"]))


@pytest.mark.parametrize("engine", ["id"], indirect=True)
def test_sharded_spans_nest_under_the_root(engine, mesh):
    data = _object("nine_chunks_short_last")
    rows, lens = _lay_out(mesh, data)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = dc.compress_framed_from_device(rows, lens)
    assert out == plain.frame(data)
    _, spans = tr.kineto_events(prof)
    snappy = [s for s in spans if s[0].startswith("snappy.")]
    (root,) = [s for s in snappy if s[0] == "snappy.compress_framed_from_device"]
    names = {s[0] for s in snappy if s is not root}
    assert {"snappy.shard_fetch", "snappy.native", "snappy.alloc",
            "snappy.stage", "snappy.enqueue", "snappy.finish"} <= names
    for _name, s, e in snappy:
        assert root[1] <= s <= e <= root[2]
    # one fetch span a shard with rows (no event on the CPU to wait on)
    assert sum(n == "snappy.shard_fetch" for n, _, _ in snappy) == 3


@pytest.mark.parametrize("engine", ["seq"], indirect=True)
def test_seq_engine_keeps_its_crcs_on_the_cards(engine, mesh, shards,
                                                monkeypatch):
    """``SNAPPY_TPU_DEVICE_CRC=0`` leaves the seq engine's encode on the
    cards: each card with rows launches its CRC and writes its records,
    and only each record and its 8-byte end offset come back."""
    monkeypatch.setattr(dc, "DEVICE_CRC", False)
    data = _object("stored_between")
    rows, lens = _lay_out(mesh, data)
    want = plain.frame(data)
    assert dc.compress_framed_from_device(rows, lens) == want
    # five rows, two a shard: the last shard holds only padding
    assert shards["crc_launches"] == [1, 1, 1, 0]
    recs = dm.split_records(want, len(plain.STREAM_ID))
    assert shards["d2h_bytes"] == [
        sum(len(r) + 8 for r in recs[2 * k : 2 * k + 2]) for k in range(CARDS)]
