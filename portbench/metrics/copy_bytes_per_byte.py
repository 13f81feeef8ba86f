"""Bytes the port copies between host and card for each uncompressed
byte of its calls: (``h2d_bytes`` + ``d2h_bytes``) / ``bytes`` of the
runtime's ``COUNTERS``.  The counters run over the whole process: the
warm pass (the same traffic) and, in the load cells, the three CRC-flip
calls after the window (under 2% of the calls) are counted too.  None
where the port has no counters."""

from portbench import spans


def read(ctx):
    c = spans.counters()
    if not c or not c.get("bytes"):
        return None
    return (c["h2d_bytes"] + c["d2h_bytes"]) / c["bytes"]
