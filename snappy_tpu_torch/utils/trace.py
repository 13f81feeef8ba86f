"""Spans of the port's runtime, for an operator's own ``torch.profiler``.

``span(name)`` is a context manager: while a torch profiler records on
the calling thread it is ``torch.profiler.record_function(name)``, a
host user annotation in the same trace and on the same clock as the
device's records; otherwise it is one shared no-op, so that a span on a
path costs a flag check when no profiler runs.  There is no switch and
no exporter of its own: the profiler session is both.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
