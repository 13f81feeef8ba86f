"""A writer's call: a uint8 tensor in device memory in, its framed
``.sz`` stream as ``bytes`` out.

Set-up uploads each object of the pool once.  The answers compared are
the streams of the sampled calls, copied into a host arena once each
call's timing has ended, against the reference encoder's streams of the
same objects (``portbench.reference``, framed once the window has
closed): the port's contract is byte identity with the greedy encoder,
its chunk types, elements and masked CRCs.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference

ENTRY = "compress_framed_from_device"


class Session:
    def __init__(self, pool, device, threads: int = 8):
        self.pool = pool
        self.device = device
        self.threads = threads
        self.tensors = [torch.from_numpy(d.copy()).to(device) for d in pool]
        self.refs = None
        self.kept = []  # (object, arena offset, stream length)

    def reserve(self, per_object: int) -> None:
        """Host room, touched now, for ``per_object`` streams of every
        object: a kept stream is copied there and let go, so that the
        heap a call sees does not depend on the sample."""
        size = per_object * sum(reference.lib().pb_frame_bound(d.size)
                                for d in self.pool)
        self.arena = np.empty(size, np.uint8)
        self.arena.fill(0)
        self._used = 0

    def call(self, entry, j: int):
        return entry(self.tensors[j])

    def keep(self, j: int, out) -> None:
        n = len(out)
        self.arena[self._used : self._used + n] = np.frombuffer(out, np.uint8)
        self.kept.append((j, self._used, n))
        self._used += n

    def compare(self, entry, errors) -> dict:
        """{name: (value, limit)} of the numbers that decide ``correct``."""
        self.tensors = None
        self.refs = [reference.framed(d, threads=self.threads) for d in self.pool]
        bad = 0
        for j, off, n in self.kept:
            a = self.arena[off : off + n]
            b = np.frombuffer(self.refs[j].stream, np.uint8)
            n = min(a.size, b.size)
            bad += int(np.count_nonzero(a[:n] != b[:n])) + abs(a.size - b.size)
        checked = {j for j, _, _ in self.kept}
        self.arena = None
        return {"bad_bytes": (bad, 0),
                "objects_unchecked": (len(self.pool) - len(checked), 0)}
