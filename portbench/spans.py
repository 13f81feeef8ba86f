"""Readings of the port's own spans and counters, for the per-layer
metrics of its runtime, copies and host codec.

While a profiler records, the port's runtime
(``snappy_tpu_torch.runtime.device_codec``) sets a root span
``snappy.<entry>`` around each entry point and phase spans inside it
(``snappy.scan``, ``.alloc``, ``.stage``, ``.native``, ``.enqueue``,
``.wait``, ``.finish``); they reach a reader as ``Context.spans``, with
the benchmark's own ``call`` and ``native.<fn>``.  Always, it counts
bytes and native time in ``device_codec.COUNTERS``.  A port without
them reads nothing here: no span of the name, and ``counters()`` None.
"""

from __future__ import annotations

import importlib

from portbench import trace

RUNTIME = "snappy_tpu_torch.runtime.device_codec"


def total_ns(spans, name: str, lo: int, hi: int) -> int | None:
    """Nanoseconds of [lo, hi) inside some span called ``name``; None
    where no such span reaches into the window."""
    got = trace.clip(trace.union((s, e) for n, s, e in spans if n == name),
                     lo, hi)
    return sum(e - s for s, e in got) if got else None


def self_ns(spans, name: str, lo: int, hi: int) -> int | None:
    """A layer's self time: nanoseconds of [lo, hi) inside spans called
    ``name`` less the union of the spans nested in each of them (any
    span that lies within it, whatever its name).  None where no such
    span reaches into the window."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    children = {}  # span index -> the intervals of its direct children
    stack = []
    for i in order:
        _, s, e = spans[i]
        while stack and spans[stack[-1]][2] <= s:
            stack.pop()
        if stack and e <= spans[stack[-1]][2]:
            children.setdefault(stack[-1], []).append((s, e))
        stack.append(i)
    out, found = 0, False
    for i, (n, s, e) in enumerate(spans):
        if n != name or min(e, hi) <= max(s, lo):
            continue
        found = True
        s, e = max(s, lo), min(e, hi)
        inner = trace.clip(trace.union(children.get(i, [])), s, e)
        out += (e - s) - sum(ce - cs for cs, ce in inner)
    return out if found else None


def ms_per_gb(ctx, ns: int | None) -> float | None:
    """``ns`` as milliseconds a GB the window completed; None where
    there is nothing to divide."""
    if ns is None or not ctx.gb:
        return None
    return ns / 1e6 / ctx.gb


def runtime():
    """The port's runtime module, where it has ``COUNTERS``; else None."""
    try:
        module = importlib.import_module(RUNTIME)
    except ImportError:
        return None
    return module if isinstance(getattr(module, "COUNTERS", None), dict) else None


def counters() -> dict | None:
    """A copy of the runtime's ``COUNTERS`` (over the whole process: the
    warm pass, the window and the load cells' CRC-flip calls), or None
    where the port has none."""
    module = runtime()
    return dict(module.COUNTERS) if module is not None else None
