"""Progress meters (the reference's progress.Meter capability,
progress/progress.go:30-54): an injectable interface, a tty text meter
with live GB/s, and a null meter.  The CLI wires these to the codec's
per-batch callbacks; tests inject a recording meter."""

from __future__ import annotations

import os
import sys
import time


class Meter:
    """Interface: Start/Set/Finish, mirroring the reference Meter."""

    def start(self, label: str, total: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def set(self, done: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def finish(self) -> None:  # pragma: no cover
        raise NotImplementedError


class NullMeter(Meter):
    def start(self, label: str, total: int) -> None:
        pass

    def set(self, done: int) -> None:
        pass

    def finish(self) -> None:
        pass


class TextMeter(Meter):
    """Single-line tty meter with throughput (writes to stderr)."""

    def __init__(self, stream=None):
        self._stream = stream or sys.stderr
        self._label = ""
        self._total = 0
        self._t0 = 0.0
        self._last = 0.0

    def start(self, label: str, total: int) -> None:
        self._label = label
        self._total = max(total, 1)
        self._t0 = time.perf_counter()
        self._last = 0.0

    def set(self, done: int) -> None:
        now = time.perf_counter()
        if now - self._last < 0.1 and done < self._total:
            return
        self._last = now
        pct = 100.0 * done / self._total
        dt = max(now - self._t0, 1e-9)
        rate = done / dt / 1e9
        self._stream.write(
            f"\r{self._label}: {pct:5.1f}%  {rate:6.3f} GB/s"
        )
        self._stream.flush()

    def finish(self) -> None:
        self._stream.write("\n")
        self._stream.flush()


def default_meter() -> Meter:
    """tty autodetect, as the reference does (progress/progress.go:182-199)."""
    try:
        if os.isatty(sys.stderr.fileno()):
            return TextMeter()
    except (OSError, ValueError):
        pass
    return NullMeter()
