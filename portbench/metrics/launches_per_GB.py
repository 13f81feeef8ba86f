"""Kernel launches a GB: the ``launches`` counters of every kernel module
of ``snappy_tpu_torch.kernels`` summed over the window, over the GB the
window completed.  How well the runtime batches."""


def read(ctx):
    return sum(ctx.launches.values()) / ctx.gb if ctx.gb else None
