"""The port's runtime spans and counters (``utils.trace.span``,
``runtime.device_codec.COUNTERS``) on the four paths that the benchmark
measures: the framed decode to the device and the framed encode from
the device, each in the id and the seq engine as
``portbench/configs/silesia-{id,seq}.json`` set them.

On the CPU no batch records an event, so no ``snappy.wait`` span
appears; every other phase span does.  The counters are checked to the
byte against the stream's layout: the rows each engine sends up and
the words it brings back."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import trace as tr
from snappy_tpu_torch.runtime import device_codec as dc
from snappy_tpu_torch.spec.format import read_uvarint
from snappy_tpu_torch.utils import trace
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CS = 65536
ENTRY = {"load": "snappy.decompress_framed_to_device",
         "save": "snappy.compress_framed_from_device"}
PHASES = {"snappy.scan", "snappy.alloc", "snappy.stage", "snappy.native",
          "snappy.enqueue", "snappy.wait", "snappy.finish"}
# the phases each path shows on the CPU
EXPECTED = {("id", "load"): {"scan", "alloc", "stage", "native", "enqueue",
                             "finish"},
            ("seq", "load"): {"scan", "alloc", "stage", "enqueue", "finish"},
            ("id", "save"): {"alloc", "stage", "native", "enqueue", "finish"},
            ("seq", "save"): {"alloc", "stage", "enqueue", "finish"}}
# the runtime's module variables, by the configuration's environment
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


def _data() -> bytes:
    """Eleven chunks, two batches at the tests' BATCH of 8: text, one
    incompressible chunk and a short last chunk (both stored raw)."""
    rng = np.random.default_rng(7)
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)), np.uint8))
             for _ in range(300)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, 300, 140_000))
    return text[: 6 * CS] + rng.bytes(CS) + text[6 * CS : 9 * CS + 1000]


DATA = _data()
assert -(-len(DATA) // CS) == 11


def _call(path, data):
    engine, call = path
    if call == "load":
        stream = dc.compress_framed(data, device="cpu")
        return lambda: dc.decompress_framed_to_device(stream, device="cpu")
    tensor = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    return lambda: dc.compress_framed_from_device(tensor)


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    got = [trace.span("snappy.stage"), trace.span("snappy.finish")]
    assert got[0] is got[1] is trace._OFF
    with got[0]:
        pass
    out = dc.compress_framed(DATA[:1000], device="cpu")
    assert dc.decompress_framed(out, device="cpu") == DATA[:1000]


def test_span_under_a_profiler_is_a_user_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("snappy.stage"):
            with trace.span("snappy.native"):
                pass
    _, spans = tr.kineto_events(prof)
    (outer,) = [s for s in spans if s[0] == "snappy.stage"]
    (inner,) = [s for s in spans if s[0] == "snappy.native"]
    assert outer[1] <= inner[1] <= inner[2] <= outer[2]


@pytest.mark.parametrize("engine", ["id", "seq"], indirect=True)
@pytest.mark.parametrize("call", ["load", "save"])
def test_each_path_nests_its_phases_in_its_entry(engine, call):
    path = (engine, call)
    run = _call(path, DATA)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    if call == "load":
        assert bytes(out.numpy()) == DATA
    _, spans = tr.kineto_events(prof)
    snappy = [s for s in spans if s[0].startswith("snappy.")]
    (root,) = [s for s in snappy if s[0] == ENTRY[call]]
    phases = [s for s in snappy if s is not root]
    assert {n.split(".", 1)[1] for n, _, _ in phases} == EXPECTED[path]
    assert {n for n, _, _ in phases} <= PHASES
    for _name, s, e in phases:
        assert root[1] <= s <= e <= root[2]
    # at most a few spans a batch, never one a chunk
    assert len(phases) <= 8 * 2 + 2


def _framed_records(stream: bytes):
    """(chunk type, body length, element length) of each data chunk of a
    framed stream."""
    out, pos = [], 10  # the stream identifier
    while pos < len(stream):
        ctype = stream[pos]
        blen = int.from_bytes(stream[pos + 1 : pos + 4], "little")
        body = stream[pos + 8 : pos + 4 + blen]
        elem = blen - 4 - read_uvarint(body, 0)[1] if ctype == 0 else None
        out.append((ctype, blen, elem))
        pos += 4 + blen
    return out


def _expected(path, data: bytes) -> dict:
    """The bytes each path sends up and brings back, from the layout:
    the id decode sends a 66,560-byte panel row and a 4-byte length a
    chunk and brings back an 8-byte CRC; the seq decode sends the span
    of the stream that holds each batch's payloads (its first payload's
    start to its last payload's end, the chunk headers between them
    included) and six 4-byte words a row, and brings back an 8-byte CRC
    and a 4-byte error code; the id encode sends a length and brings back the chunk
    and its CRC; the seq encode sends a length and brings back its
    record's 8-byte end offset, and the records themselves."""
    eng, call = path
    stream = dc.compress_framed(data, device="cpu")
    recs = _framed_records(stream)
    n, k = len(data), len(recs)
    batches = [range(b, min(b + dc.BATCH, k)) for b in range(0, k, dc.BATCH)]
    if (eng, call) == ("id", "load"):
        return dict(h2d=k * (520 * 128 + 4), d2h=k * 8)
    if (eng, call) == ("id", "save"):
        return dict(h2d=k * 4, d2h=n + k * 8)
    if call == "load":
        # a payload starts 8 bytes into its chunk: 4 of header, 4 of CRC
        starts = np.cumsum([10] + [4 + r[1] for r in recs[:-1]]) + 8
        ends = starts + [r[1] - 4 for r in recs]
        h2d = sum(int(ends[b[-1]] - starts[b[0]]) + 24 * len(b)
                  for b in batches)
        return dict(h2d=h2d, d2h=k * 12)
    return dict(h2d=k * 4, d2h=k * 8 + len(stream) - 10)


@pytest.mark.parametrize("engine", ["id", "seq"], indirect=True)
@pytest.mark.parametrize("call", ["load", "save"])
def test_counters_move_by_the_bytes_of_the_layout(engine, call):
    path = (engine, call)
    want = _expected(path, DATA)
    assert [i for i, r in enumerate(_framed_records(
        dc.compress_framed(DATA, device="cpu"))) if r[0] == 1] == [6, 10]
    run = _call(path, DATA)
    before = dict(dc.COUNTERS)
    out = run()
    moved = {k: dc.COUNTERS[k] - before[k] for k in before}
    if call == "save":
        assert out == dc.compress_framed(DATA, device="cpu")
    assert moved["bytes"] == len(DATA)
    assert moved["h2d_bytes"] == want["h2d"]
    assert moved["d2h_bytes"] == want["d2h"]
    if engine == "id":
        assert moved["native_wall_ns"] > 0 and moved["native_cpu_ns"] > 0
    else:
        assert moved["native_wall_ns"] == moved["native_cpu_ns"] == 0
