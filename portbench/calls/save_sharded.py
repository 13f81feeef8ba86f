"""A writer's call over a four-card host: an object held as 64 KiB chunk
rows sharded over four devices in, its framed ``.sz`` stream as
``bytes`` out.

Set-up builds the mesh, the host's four cards (``make_mesh(4)``, which
raises with fewer) or four CPU shards when the run is on the CPU, and
lays each object of the pool out over it once: its chunks as rows of
65,536 B, the row count padded to a multiple of four with zero-length
rows, cut into four contiguous row ranges, range k on device k (the
layout that ``sharded_decompress_framed_to_device`` returns).  A call
hands the port the rows and their lengths.

The answers compared are the streams of the sampled calls, as in
``calls/save.py``, against the reference encoder's stream of the whole
object: byte identity whichever card holds a chunk.  Besides,
``cards_idle`` counts the cards of the mesh on which the port made no
CRC launch over the window (``dist.mesh.SHARDS["crc_launches"]``, read
when the warm pass has ended and after the window).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.calls import save

ENTRY = "compress_framed_from_device"
CARDS = 4
CHUNK = 65536


def _mesh_module():
    from snappy_tpu_torch.dist import mesh

    return mesh


def _crc_launches(mesh_module, size: int) -> list[int]:
    """Each mesh position's CRC launches so far; zeros where the port
    counts none."""
    counts = list(getattr(mesh_module, "SHARDS", {}).get("crc_launches", []))
    return (counts + [0] * size)[:size]


class Session(save.Session):
    def __init__(self, pool, device, threads: int = 8):
        self.pool = pool
        self.device = device
        self.threads = threads
        dm = _mesh_module()
        self.mesh = (dm.make_mesh(CARDS) if device.type == "cuda"
                     else dm.make_mesh(devices=[device] * CARDS))
        self.tensors = [self._lay_out(dm, d) for d in pool]
        self.refs = None
        self.kept = []  # (object, arena offset, stream length)
        self.calls = 0
        self.at_window = None

    def _lay_out(self, dm, data: np.ndarray):
        """(rows, lens): the object's chunk rows over the mesh, and the
        valid bytes of each real row."""
        b = -(-data.size // CHUNK)
        rows = np.zeros((-(-b // CARDS) * CARDS, CHUNK), np.uint8)
        rows.reshape(-1)[: data.size] = data
        lens = np.minimum(data.size - np.arange(b, dtype=np.int64) * CHUNK,
                          CHUNK).astype(np.int32)
        return dm.shard_rows(self.mesh, torch.from_numpy(rows)), lens

    def call(self, entry, j: int):
        if self.calls == len(self.pool):  # the warm pass has ended
            self.at_window = _crc_launches(_mesh_module(), self.mesh.size)
        self.calls += 1
        rows, lens = self.tensors[j]
        return entry(rows, lens)

    def compare(self, entry, errors) -> dict:
        """``calls/save.py``'s numbers, and ``cards_idle``."""
        now = _crc_launches(_mesh_module(), self.mesh.size)
        start = self.at_window or [0] * self.mesh.size
        checks = super().compare(entry, errors)
        checks["cards_idle"] = (sum(1 for a, b in zip(start, now) if b <= a), 0)
        return checks
