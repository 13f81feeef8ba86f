"""Wall milliseconds a GB the host takes to hand work to the card, the
self time of the port's ``snappy.enqueue`` spans in the traced window: a
batch's uploads, launches, copies back and event, less the spans nested
in them (the batch's staging, the waits for a host set)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_gb(ctx, spans.self_ns(ctx.spans, "snappy.enqueue",
                                              ctx.lo, ctx.hi))
