"""``seq_encode_kernel``'s share of its roofline: the least time, the
bytes the cell's own data needs of it over the card's memory rate,
divided by its card time, the mean of its profiler records times the
launches that ``kernels.encode_seq`` counted in the window."""

from portbench import cost


def needed_bytes(ref) -> int:
    """Each chunk read once, and its element (the reference's) written
    once."""
    return ref.size + int(ref.elem.sum())


def read(ctx):
    return cost.roofline_pct(ctx, "seq_encode_kernel", "encode_seq", needed_bytes)
