"""Wall milliseconds a GB in which a shard's rows leave their card, the
self time of the port's ``snappy.shard_fetch`` spans in the traced
window: a batch's copy from its card into the host's pinned staging
queued, and the wait for it to land (the batch's CRC launched before it
on the same stream), less any span nested in them.  None where the
port has no such span (a parent without the sharded encode)."""

from portbench import spans


def read(ctx):
    return spans.ms_per_gb(ctx, spans.self_ns(ctx.spans, "snappy.shard_fetch",
                                              ctx.lo, ctx.hi))
