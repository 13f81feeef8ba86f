"""A loader's call: a framed ``.sz`` stream in pageable host memory in,
the decoded and CRC-checked bytes in device memory out.

Set-up frames each object of the pool with the benchmark's reference
encoder (``portbench.reference``), never the port's, so a change to the
port's encoder cannot change these inputs.  The answers compared are the
device bytes of the sampled calls, copied into an arena on the device
once each call's timing has ended, against the bytes the benchmark made.
After the window, streams with one chunk's CRC flipped go through the
same call, each of which has to raise ``ChecksumError``: the guarantee
that ``verify_checksums`` gives for every chunk.  The flips are the
first chunk of the smallest object, and the middle and last chunks of
the largest, which lie in other batches of the call.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference

ENTRY = "decompress_framed_to_device"


class Session:
    def __init__(self, pool, device, threads: int = 8):
        self.pool = pool
        self.device = device
        self.refs = [reference.framed(data, threads=threads) for data in pool]
        self.streams = [r.stream for r in self.refs]
        self.kept = []  # (object, arena offset, output length)

    def reserve(self, per_object: int) -> None:
        """Room on the device for ``per_object`` outputs of every
        object, whatever the sample."""
        self.arena = torch.empty(per_object * sum(d.size for d in self.pool),
                                 dtype=torch.uint8, device=self.device)
        self._used = 0

    def call(self, entry, j: int):
        out = entry(self.streams[j], verify_checksums=True, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def keep(self, j: int, out) -> None:
        n = min(int(out.numel()), self.pool[j].size)
        self.arena[self._used : self._used + n].copy_(out.reshape(-1)[:n])
        self.kept.append((j, self._used, int(out.numel())))
        self._used += n

    def compare(self, entry, errors) -> dict:
        """{name: (value, limit)} of the numbers that decide ``correct``."""
        bad = 0
        for j, off, got_len in self.kept:
            want = self.pool[j]
            n = min(got_len, want.size)
            got = self.arena[off : off + n].cpu().numpy()
            bad += int(np.count_nonzero(got != want[:n])) + abs(got_len - want.size)
        checked = {j for j, _, _ in self.kept}
        self.arena = None
        small = min(range(len(self.pool)), key=lambda i: self.pool[i].size)
        large = max(range(len(self.pool)), key=lambda i: self.pool[i].size)
        n_large = len(self.refs[large].records)
        return {"bad_bytes": (bad, 0),
                "objects_unchecked": (len(self.pool) - len(checked), 0),
                "corrupt_first_accepted": (self._accepted(entry, errors, small, 0), 0),
                "corrupt_middle_accepted": (
                    self._accepted(entry, errors, large, n_large // 2), 0),
                "corrupt_last_accepted": (
                    self._accepted(entry, errors, large, n_large - 1), 0)}

    def _accepted(self, entry, errors, j: int, chunk: int) -> int:
        """1 where object ``j``'s stream with chunk ``chunk``'s CRC
        flipped decodes without ``ChecksumError``."""
        bad = bytearray(self.streams[j])
        bad[self.refs[j].records[chunk][1]] ^= 1
        try:
            entry(bytes(bad), verify_checksums=True, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except errors.ChecksumError:
            return 0
        return 1
