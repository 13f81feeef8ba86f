"""The traced run's readings: spans around the port's calls, the
profiler's device records, and what the reduction of both gives.

The benchmark sets its own spans, in the traced run only: ``call``
around each timed call, and ``native.<fn>`` around each call into the
port's ``native`` module, whose functions the runtime reaches through
module attribute lookups, so a wrapper set on the attribute sees every
call.  Every other user annotation on the host (``record_function``),
such as a span the port may set itself, is read as a span too, so that
a metric that reads it is a new file of ``portbench/metrics/`` alone.
"""

from __future__ import annotations

import functools
import statistics
import time

class NativeSpans:
    """Wrappers on the public functions of the port's ``native`` module:
    wall time inside the outermost of them, and a profiler span each."""

    def __init__(self, native, record_function):
        self.native = native
        self.seconds = 0.0
        self.calls = 0
        self._depth = 0
        self._saved = {}
        for name, fn in list(vars(native).items()):
            if (callable(fn) and not name.startswith("_") and name != "available"
                    and getattr(fn, "__module__", None) == native.__name__):
                self._saved[name] = fn
                setattr(native, name, self._wrap(name, fn, record_function))

    def _wrap(self, name, fn, record_function):
        label = f"native.{name}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            self._depth += 1
            t0 = time.perf_counter()
            try:
                with record_function(label):
                    return fn(*args, **kwargs)
            finally:
                self._depth -= 1
                if self._depth == 0:
                    self.seconds += time.perf_counter() - t0
                    self.calls += 1

        return wrapper

    def remove(self) -> None:
        for name, fn in self._saved.items():
            setattr(self.native, name, fn)


def short_name(name: str) -> str:
    """A kernel's function name without namespace, template arguments
    and parameters; other device records keep their names."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].split("::")[-1]
    return name.split()[-1] if name.split() else name


def kind_of(name: str) -> str:
    """A device record's kind by its name: a copy, a memset or a kernel."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def kineto_events(prof):
    """(device records, host spans) of a finished ``torch.profiler``
    run: device records as (kind, name, start_ns, end_ns), every user
    annotation on the host as (name, start_ns, end_ns).  The
    annotations' copies on the device's timeline are not device work
    and are left out."""
    from torch.autograd import DeviceType

    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.device_type(), e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    spans = [(name, s, e) for name, s, e, dev, user in events
             if user and dev == DeviceType.CPU]
    names = {name for name, _, _ in spans}
    device = [(kind_of(name), name, s, e) for name, s, e, dev, user in events
              if dev == DeviceType.CUDA and not user and name not in names]
    return device, spans


def union(intervals) -> list[tuple[int, int]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def window(spans) -> tuple[int, int] | None:
    """The traced window: the first ``call`` span's start to the last
    one's end."""
    calls = [(s, e) for name, s, e in spans if name == "call"]
    if not calls:
        return None
    return min(s for s, _ in calls), max(e for _, e in calls)


def busy_ns(device, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) in which some device record runs."""
    return sum(e - s for s, e in clip(union((s, e) for _, _, s, e in device),
                                      lo, hi))


def kernel_mean_s(device, key: str) -> float | None:
    """The mean seconds of the kernel records whose name holds ``key``;
    the profiler drops some records, so a card time is this mean times
    the launches counted, never the records' sum."""
    durs = [e - s for kind, name, s, e in device
            if kind == "kernel" and key in name]
    return statistics.fmean(durs) / 1e9 if durs else None


def copy_ns(device, directions=("HtoD", "DtoH")) -> int:
    return sum(e - s for kind, name, s, e in device
               if kind == "gpu_memcpy" and any(d in name for d in directions))


def device_ops(device, top: int = 10) -> list:
    """[[name, seconds], ...]: the device records' time by name, most
    first."""
    by = {}
    for _, name, s, e in device:
        key = short_name(name)
        by[key] = by.get(key, 0) + (e - s)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(device, spans, lo: int, hi: int, top: int = 10) -> list:
    """[[name, seconds], ...]: the longest stretches of [lo, hi) in
    which no device record runs, each named by the innermost span the
    host was in at its middle (``call``, ``native.<fn>``), or ``outside
    any call``."""
    busy = clip(union((s, e) for _, _, s, e in device), lo, hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        mid = (s + e) // 2
        inside = [(ss, name) for name, ss, ee in spans if ss <= mid < ee]
        out.append([max(inside)[1] if inside else "outside any call",
                    (e - s) / 1e9])
    return out
