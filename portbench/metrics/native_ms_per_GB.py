"""Wall milliseconds inside the port's ``native`` module functions a GB,
as the runtime calls them (the benchmark's wrappers on the module's
attributes, outermost calls only).  None where the run made no call."""


def read(ctx):
    if ctx.native is None or not ctx.native.calls or not ctx.gb:
        return None
    return ctx.native.seconds * 1e3 / ctx.gb
