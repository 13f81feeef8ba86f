"""The metric arithmetic: the end-to-end metrics of a window, the
reduction of device records and spans, the rooflines, and the check of
forbidden modules."""

import sys
import types

import numpy as np
import pytest

from portbench import corpus, cost, reference, run, trace


def test_end_to_end_takes_all_bytes_over_the_whole_window():
    durations = [0.010] * 95 + [0.100] * 5
    got = run.end_to_end(durations, done_bytes=3_000_000_000, window_s=2.5,
                         cpu_s=6.0, setup_s=12.0)
    assert got["GBps"] == pytest.approx(3.0 / 2.5)
    assert got["host_core_s_per_GB"] == pytest.approx(2.0)
    assert got["setup_s"] == 12.0
    # the 95th percentile over all 100 calls, linear between ranks 94 and 95
    assert got["call_p95_ms"] == pytest.approx(
        float(np.percentile(durations, 95)) * 1e3)
    assert 10.0 < got["call_p95_ms"] <= 100.0


def test_union_busy_and_idle():
    recs = [("kernel", "a", 0, 10), ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 5, 20),
            ("kernel", "b", 40, 50), ("kernel", "c", 90, 120)]
    assert trace.union([(s, e) for _, _, s, e in recs]) == [(0, 20), (40, 50), (90, 120)]
    assert trace.busy_ns(recs, 0, 100) == 20 + 10 + 10
    spans = [("call", 0, 100), ("native.compress_framed_crc", 55, 85)]
    gaps = trace.idle_gaps(recs, spans, 0, 100)
    assert gaps[0] == ["native.compress_framed_crc", 40e-9]
    assert gaps[1] == ["call", 20e-9]
    assert trace.idle_gaps(recs, [], 0, 100)[0][0] == "outside any call"
    assert trace.copy_ns(recs) == 15
    ops = trace.device_ops(recs)
    assert ops[0] == ["c", 30e-9] and ["Memcpy HtoD (Pinned -> Device)", 15e-9] in ops


def test_kernel_names_and_kinds():
    assert trace.short_name(
        "void seq_decode_kernel<true>(unsigned char const*, long)") == "seq_decode_kernel"
    assert trace.short_name("(anonymous namespace)::crc32c_rows_kernel(int)") == "crc32c_rows_kernel"
    assert trace.kind_of("Memcpy DtoH (Device -> Pinned)") == "gpu_memcpy"
    assert trace.kind_of("Memset (Device)") == "gpu_memset"
    assert trace.kind_of("crc32c_rows_kernel") == "kernel"


def _ctx(records, launches, hbm=1e9):
    return run.Context(device=records, launches=launches, hbm_bytes_per_s=hbm,
                       calls_per_object=[3, 1],
                       refs=[types.SimpleNamespace(size=100),
                             types.SimpleNamespace(size=400)])


def _size(ref):
    return ref.size


def test_roofline_is_record_mean_times_launches():
    """Ten launches of 1 us each, of which the profiler kept four: the
    card time is 10 us, not the 4 us that the records sum to."""
    recs = [("kernel", "crc32c_rows_kernel", i * 10, i * 10 + 1000) for i in range(4)]
    ctx = _ctx(recs, {"crc32c": 10})
    assert ctx.window_bytes(_size) == 3 * 100 + 400
    # 700 B at 1e9 B/s = 0.7 us, over 10 x 1 us
    assert cost.roofline_pct(ctx, "crc32c_rows_kernel", "crc32c",
                             _size) == pytest.approx(7.0)


def test_roofline_reads_nothing_without_records_launches_or_peak():
    recs = [("kernel", "crc32c_rows_kernel", 0, 1000)]
    assert cost.roofline_pct(_ctx([], {"crc32c": 3}), "crc32c_rows_kernel",
                             "crc32c", _size) is None
    assert cost.roofline_pct(_ctx(recs, {"crc32c": 0}), "crc32c_rows_kernel",
                             "crc32c", _size) is None
    assert cost.roofline_pct(_ctx(recs, {"crc32c": 1}, hbm=None),
                             "crc32c_rows_kernel", "crc32c", _size) is None


def test_kernel_bytes_come_from_the_reference_framing():
    """The rooflines' bytes, from an object's reference stream: the CRC
    reads every byte and writes 4 a chunk; the device decoder reads each
    compressed chunk's payload and writes its bytes, and skips stored
    chunks; the device encoder reads every byte and writes the
    elements."""
    data = np.concatenate([corpus.make_kind("dickens", 65536, 1),
                           corpus.make_kind("x-ray", 65536, 1),
                           corpus.make_kind("xml", 1000, 1)])
    ref = reference.framed(data)
    kinds = [t for t, _, _ in ref.records]
    assert kinds == [0, 1, 0]
    read = {name: run.load_module("metrics", name).needed_bytes for name in (
        "crc32c_rows_roofline", "seq_decode_roofline", "seq_encode_roofline")}
    assert read["crc32c_rows_roofline"](ref) == data.size + 12
    payload = [blen - 4 for t, _, blen in ref.records]
    assert read["seq_decode_roofline"](ref) == payload[0] + 65536 + payload[2] + 1000
    assert read["seq_encode_roofline"](ref) == data.size + int(ref.elem.sum())


def test_metric_readers():
    recs = [("kernel", "k", 0, 50), ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 50, 100)]
    ctx = run.Context(gb=0.5, launches={"crc32c": 4, "decode_seq": 1}, device=recs,
                      native=types.SimpleNamespace(seconds=0.25, calls=3), lo=0, hi=400)
    read = {name: run.load_module("metrics", name).read for name in (
        "launches_per_GB", "native_ms_per_GB", "copy_ms_per_GB", "device_idle_pct")}
    assert read["launches_per_GB"](ctx) == pytest.approx(10.0)
    assert read["native_ms_per_GB"](ctx) == pytest.approx(500.0)
    assert read["copy_ms_per_GB"](ctx) == pytest.approx(50 / 1e6 / 0.5)
    assert read["device_idle_pct"](ctx) == pytest.approx(75.0)
    ctx.native = types.SimpleNamespace(seconds=0.0, calls=0)
    assert read["native_ms_per_GB"](ctx) is None


def test_native_spans_wrap_and_restore():
    mod = types.ModuleType("fake_native")
    exec("def outer(x):\n    return inner(x) + 1\n"
         "def inner(x):\n    return x * 2\n"
         "def available():\n    return True\n", mod.__dict__)
    for fn in (mod.outer, mod.inner, mod.available):
        fn.__module__ = mod.__name__
    from contextlib import nullcontext

    spans = trace.NativeSpans(mod, lambda label: nullcontext())
    assert mod.outer(3) == 7
    assert spans.calls == 1  # the nested call counts inside the outer one
    assert mod.available.__name__ == "available" and "available" not in spans._saved
    spans.remove()
    assert not hasattr(mod.outer, "__wrapped__")


def test_sampled_calls_cover_every_object_across_the_window():
    s = run.sampled_calls(12, 2**31 + 1, 400)
    assert len(s) == 12 * run.KEPT_PER_OBJECT
    assert {j for _, j in s} == set(range(12))
    assert all(0 <= p < 400 for p, _ in s)
    assert max(p for p, _ in s) > 200  # not only the window's first passes
    assert s == run.sampled_calls(12, 2**31 + 1, 400) != run.sampled_calls(12, 7, 400)
    # a window of one pass keeps each object's answer once
    assert run.sampled_calls(12, 5, 1) == {(0, j) for j in range(12)}


def test_the_sample_is_drawn_from_passes_the_window_reaches():
    """Half the passes that the warm pass's pace fits into the window,
    and at least one."""
    assert run.passes_in_window(51, 0.25) == 102
    assert run.passes_in_window(0.5, 2.0) == 1


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    base = set(run.forbidden_modules())
    for name in ("snappy_tpu_torch", "snappy_tpu_torch.api", "jaxtyping_like",
                 "snappy_tpux"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(run.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "snappy_tpu.spec", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert set(run.forbidden_modules()) - base == {"jaxlib", "snappy_tpu.spec"}
