"""Wall milliseconds a GB in the port's host staging, the self time of
its ``snappy.stage`` spans in the traced window: filling a batch's
pinned set, less the native calls nested in it (``snappy.native``, the
id walk)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_gb(ctx, spans.self_ns(ctx.spans, "snappy.stage",
                                              ctx.lo, ctx.hi))
