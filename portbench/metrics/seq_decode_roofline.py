"""``seq_decode_kernel``'s share of its roofline: the least time, the
bytes the cell's own data needs of it over the card's memory rate,
divided by its card time, the mean of its profiler records times the
launches that ``kernels.decode_seq`` counted in the window."""

from portbench import cost, reference


def needed_bytes(ref) -> int:
    """Each compressed chunk's payload (its body less the CRC) read
    once, and that chunk's uncompressed bytes written once; stored
    chunks are not the decoder's."""
    out = 0
    for c, (ctype, _, blen) in enumerate(ref.records):
        if ctype == 0x00:
            out += blen - 4 + min(reference.CHUNK, ref.size - c * reference.CHUNK)
    return out


def read(ctx):
    return cost.roofline_pct(ctx, "seq_decode_kernel", "decode_seq", needed_bytes)
