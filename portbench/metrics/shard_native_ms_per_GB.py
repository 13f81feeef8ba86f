"""Wall milliseconds a GB of the native matcher and assembler in the
sharded calls: the port's ``snappy.native`` spans in the traced window
that lie inside a root span ``snappy.compress_framed_from_device`` in
which some ``snappy.shard_fetch`` span lies (a call on sharded rows).
None where no call of the window was sharded."""

import bisect

from portbench import spans, trace

ROOT = "snappy.compress_framed_from_device"


def _owner(roots, starts, s: int, e: int):
    """The index of the root span (roots sorted, not overlapping) that
    holds [s, e), or None."""
    i = bisect.bisect_right(starts, s) - 1
    return i if i >= 0 and e <= roots[i][1] else None


def read(ctx):
    of = {ROOT: [], "snappy.shard_fetch": [], "snappy.native": []}
    for name, s, e in ctx.spans:
        if name in of:
            of[name].append((s, e))
    roots = sorted(of[ROOT])
    starts = [s for s, _ in roots]
    sharded = {_owner(roots, starts, s, e) for s, e in of["snappy.shard_fetch"]}
    sharded.discard(None)
    if not sharded:
        return None
    got = trace.clip(trace.union(
        (s, e) for s, e in of["snappy.native"]
        if _owner(roots, starts, s, e) in sharded), ctx.lo, ctx.hi)
    return spans.ms_per_gb(ctx, sum(e - s for s, e in got))
