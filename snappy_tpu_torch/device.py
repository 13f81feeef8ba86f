"""The one device pick of the port.

Every entry point takes ``device=``; ``None`` means :func:`default_device`:
``cuda:0`` when PyTorch sees a GPU, else ``cpu``.  On ``cuda`` the
kernels run; on ``cpu`` their plain versions do.  There is no other
switch between the two.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    return torch.device("cuda:0" if torch.cuda.is_available() else "cpu")


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or the default pick for None."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
