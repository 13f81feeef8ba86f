"""Wall milliseconds a GB the calling thread blocks on the card, the
port's ``snappy.wait`` spans in the traced window (a batch's event
synchronised while it was pending)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_gb(ctx, spans.total_ns(ctx.spans, "snappy.wait",
                                               ctx.lo, ctx.hi))
