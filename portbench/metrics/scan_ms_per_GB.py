"""Wall milliseconds a GB in the port's header walk, its ``snappy.scan``
spans in the traced window (``_scan_frames``, the check that every chunk
fills its row and the path picked, once a decode call)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_gb(ctx, spans.total_ns(ctx.spans, "snappy.scan",
                                               ctx.lo, ctx.hi))
