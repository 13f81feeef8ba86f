"""Wall milliseconds a GB of host work after a batch's device work, the
self time of the port's ``snappy.finish`` spans in the traced window:
CRC and error checks and the records' assembly (the seq encode's
consumer loop included), less the spans nested in them (the wait for the
batch, the id encode's native matcher call)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_gb(ctx, spans.self_ns(ctx.spans, "snappy.finish",
                                              ctx.lo, ctx.hi))
