"""Bytes the cards of a mesh copied to the host for each uncompressed
byte of the port's calls: the sum over mesh positions of
``snappy_tpu_torch.dist.mesh.SHARDS["d2h_bytes"]`` (each shard's rows
and CRC values fetched by the sharded from-device encode) over
``bytes`` of the runtime's ``COUNTERS``.  Both run over the whole
process, the warm pass included.  None where the port has no such
counters or no sharded call copied anything."""

import importlib

from portbench import spans


def read(ctx):
    c = spans.counters()
    try:
        mesh = importlib.import_module("snappy_tpu_torch.dist.mesh")
    except ImportError:
        return None
    d2h = getattr(mesh, "SHARDS", {}).get("d2h_bytes")
    if not c or not c.get("bytes") or not d2h or not sum(d2h):
        return None
    return sum(d2h) / c["bytes"]
