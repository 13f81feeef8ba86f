"""The readers of the port's runtime spans and counters: self time, each
new per-layer metric on a synthetic ``Context``, and None where the
port has no such span or counter (as at a parent commit without them)."""

import types

import pytest

from portbench import run, spans

MS = 10**6  # ns
PHASE_READERS = ["scan_ms_per_GB", "alloc_ms_per_GB", "stage_ms_per_GB",
                 "enqueue_ms_per_GB", "wait_ms_per_GB", "finish_ms_per_GB"]
COUNTER_READERS = ["copy_bytes_per_byte", "native_busy_pct"]

# one call of 100 ms, two batches; the window is [0, 100 ms)
SPANS = [("call", 0, 100 * MS),
         ("snappy.decompress_framed_to_device", 1 * MS, 99 * MS),
         ("snappy.scan", 1 * MS, 3 * MS),
         ("snappy.alloc", 3 * MS, 4 * MS),
         ("snappy.stage", 4 * MS, 20 * MS),
         ("snappy.native", 5 * MS, 15 * MS),
         ("native.stage_flat_dec_id_batch", 5 * MS, 15 * MS),
         ("snappy.enqueue", 20 * MS, 30 * MS),
         ("snappy.wait", 22 * MS, 26 * MS),
         ("snappy.stage", 30 * MS, 40 * MS),
         ("snappy.enqueue", 40 * MS, 45 * MS),
         ("snappy.wait", 45 * MS, 60 * MS),
         ("snappy.finish", 60 * MS, 70 * MS),
         ("snappy.wait", 70 * MS, 80 * MS),
         ("snappy.finish", 80 * MS, 98 * MS),
         ("snappy.native", 85 * MS, 95 * MS)]
# ms each reader sees in SPANS (over 0.5 GB: twice that a GB)
WANT_MS = {"scan_ms_per_GB": 2, "alloc_ms_per_GB": 1,
           "stage_ms_per_GB": (16 - 10) + 10, "enqueue_ms_per_GB": (10 - 4) + 5,
           "wait_ms_per_GB": 4 + 15 + 10, "finish_ms_per_GB": 10 + (18 - 10)}


def _ctx(span_list, lo=0, hi=100 * MS, gb=0.5):
    return run.Context(gb=gb, spans=span_list, lo=lo, hi=hi, device=[],
                       launches={}, native=None, calls_per_object=[],
                       refs=[])


def _runtime(monkeypatch, counters, threads=4):
    fake = types.SimpleNamespace(COUNTERS=counters, _threads=lambda: threads)
    monkeypatch.setattr(spans, "runtime", lambda: fake)


def test_self_time_takes_away_the_union_of_nested_spans():
    # the stage's native call and the native wrapper in it overlap: their
    # union (10 ms), not their sum, leaves the stage
    assert spans.self_ns(SPANS, "snappy.stage", 0, 100 * MS) == 16 * MS
    assert spans.self_ns(SPANS, "snappy.decompress_framed_to_device",
                         0, 100 * MS) == (98 - 97) * MS
    assert spans.self_ns(SPANS, "call", 0, 100 * MS) == 2 * MS
    assert spans.self_ns(SPANS, "snappy.wait", 0, 100 * MS) == 29 * MS
    assert spans.self_ns(SPANS, "snappy.nothing", 0, 100 * MS) is None


def test_self_time_is_clipped_to_the_window():
    # the window [10, 35) ms holds 10 ms of the first stage, 5 of them
    # in its native call, and 5 ms of the second stage
    assert spans.self_ns(SPANS, "snappy.stage", 10 * MS, 35 * MS) == 10 * MS
    assert spans.self_ns(SPANS, "snappy.finish", 0, 50 * MS) is None
    assert spans.total_ns(SPANS, "snappy.wait", 0, 50 * MS) == (4 + 5) * MS


def test_total_time_counts_overlapping_spans_once():
    got = [("snappy.alloc", 0, 4 * MS), ("snappy.alloc", 2 * MS, 6 * MS)]
    assert spans.total_ns(got, "snappy.alloc", 0, 10 * MS) == 6 * MS
    assert spans.total_ns(got, "snappy.scan", 0, 10 * MS) is None


@pytest.mark.parametrize("name", PHASE_READERS)
def test_each_phase_reader(name):
    reader = run.load_module("metrics", name)
    assert reader.read(_ctx(SPANS)) == pytest.approx(2 * WANT_MS[name])
    assert reader.read(_ctx(SPANS, gb=0)) is None


@pytest.mark.parametrize("name", PHASE_READERS)
def test_each_phase_reader_reads_nothing_without_the_ports_spans(name):
    """The parent commit's trace: the benchmark's spans alone."""
    reader = run.load_module("metrics", name)
    bare = [s for s in SPANS if not s[0].startswith("snappy.")]
    assert reader.read(_ctx(bare)) is None


def test_copy_bytes_per_byte(monkeypatch):
    reader = run.load_module("metrics", "copy_bytes_per_byte")
    _runtime(monkeypatch, {"bytes": 1000, "h2d_bytes": 1016, "d2h_bytes": 4,
                           "native_wall_ns": 0, "native_cpu_ns": 0})
    assert reader.read(_ctx([])) == pytest.approx(1.02)
    _runtime(monkeypatch, {"bytes": 0, "h2d_bytes": 0, "d2h_bytes": 0,
                           "native_wall_ns": 0, "native_cpu_ns": 0})
    assert reader.read(_ctx([])) is None


def test_native_busy_pct(monkeypatch):
    reader = run.load_module("metrics", "native_busy_pct")
    # 4 threads for 10 ms of wall time: 40 ms of CPU is 100%
    _runtime(monkeypatch, {"bytes": 1, "h2d_bytes": 0, "d2h_bytes": 0,
                           "native_wall_ns": 10 * MS, "native_cpu_ns": 30 * MS})
    assert reader.read(_ctx([])) == pytest.approx(75.0)
    _runtime(monkeypatch, {"bytes": 1, "h2d_bytes": 0, "d2h_bytes": 0,
                           "native_wall_ns": 0, "native_cpu_ns": 0})
    assert reader.read(_ctx([])) is None  # no native call: the seq engine


@pytest.mark.parametrize("name", COUNTER_READERS)
def test_each_counter_reader_reads_nothing_without_the_ports_counters(
        monkeypatch, name):
    reader = run.load_module("metrics", name)
    monkeypatch.setattr(spans, "runtime", lambda: None)
    assert reader.read(_ctx([])) is None


def test_runtime_is_found_only_with_its_counters(monkeypatch):
    module = spans.runtime()
    assert module is not None and set(module.COUNTERS) == {
        "bytes", "h2d_bytes", "d2h_bytes", "native_wall_ns", "native_cpu_ns"}
    assert spans.counters() == module.COUNTERS
    assert spans.counters() is not module.COUNTERS
    monkeypatch.setattr(spans, "RUNTIME", "portbench.cost")  # no COUNTERS
    assert spans.runtime() is None and spans.counters() is None
    monkeypatch.setattr(spans, "RUNTIME", "portbench.no_such_module")
    assert spans.runtime() is None
