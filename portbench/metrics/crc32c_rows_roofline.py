"""``crc32c_rows_kernel``'s share of its roofline: the least time, the
bytes the cell's own data needs of it over the card's memory rate,
divided by its card time, the mean of its profiler records times the
launches that ``kernels.crc32c`` counted in the window."""

from portbench import cost


def needed_bytes(ref) -> int:
    """Each uncompressed byte read once, and 4 bytes a chunk written."""
    return ref.size + 4 * len(ref.records)


def read(ctx):
    return cost.roofline_pct(ctx, "crc32c_rows_kernel", "crc32c", needed_bytes)
