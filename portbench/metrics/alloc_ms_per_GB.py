"""Wall milliseconds a GB in the port's allocations, its ``snappy.alloc``
spans in the traced window: the pinned host sets made anew each call and
given back at its end, and a decode's output tensor."""

from portbench import spans


def read(ctx):
    return spans.ms_per_gb(ctx, spans.total_ns(ctx.spans, "snappy.alloc",
                                               ctx.lo, ctx.hi))
