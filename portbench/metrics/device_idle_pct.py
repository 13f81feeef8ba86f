"""The share of the traced window (first call's start to last call's
end) in which the card runs no kernel, copy or memset: the union of the
profiler's device records, subtracted.  The profiler drops some records,
so this reads at or above the true idle share."""

from portbench import trace


def read(ctx):
    if not ctx.device or ctx.hi <= ctx.lo:
        return None
    return 100.0 * (1.0 - trace.busy_ns(ctx.device, ctx.lo, ctx.hi)
                    / (ctx.hi - ctx.lo))
