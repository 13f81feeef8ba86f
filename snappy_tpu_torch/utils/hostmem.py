"""Host memory tuning for high-throughput paths.

This build environment (and some production sandboxes) has extreme
page-fault latency (~400us/page measured), which caps any allocate-and-
fill workload at ~10 MB/s.  Disabling glibc's mmap-based large
allocations and heap trimming keeps freed pages resident, so repeated
large buffers run at memory speed after one warmup.

Called by the native backend, the runtime, and bench.py.  Safe no-op on
non-glibc platforms.
"""

from __future__ import annotations

import ctypes

_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4

_done = False


def tune_allocator() -> bool:
    """Disable glibc mmap allocations + trimming (idempotent)."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_MAX, 0)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, 2**31 - 1)
        _done = bool(ok1 and ok2)
    except OSError:
        _done = False
    return _done


def warm_heap(nbytes: int) -> None:
    """Pre-fault a contiguous heap region so later allocations reuse it."""
    import numpy as np

    tune_allocator()
    buf = np.empty(nbytes, dtype=np.uint8)
    buf[::4096] = 0
    del buf
