"""Public API of the port: the codec entry points of ``snappy_tpu.api``
on PyTorch.

Bytes in and bytes out for the raw and framed formats, plus the
to-device / from-device matrix that takes and returns uint8
``torch.Tensor``s.  Every function takes ``device=``; ``None`` is the
pick of :mod:`snappy_tpu_torch.device` (``cuda:0`` when there is a GPU,
else ``cpu``), and for the from-device functions the tensor's own
device.
"""

from __future__ import annotations

import torch

from snappy_tpu_torch.runtime import device_codec


def compress(data: bytes, *, device=None) -> bytes:
    """Compress bytes into the raw Snappy block format."""
    return device_codec.compress(data, device=device)


def decompress(data: bytes, *, device=None) -> bytes:
    """Decompress a raw Snappy block-format stream."""
    return device_codec.decompress(data, device=device)


def compress_framed(data: bytes, *, device=None) -> bytes:
    """Compress bytes into the framed (.sz) stream format."""
    return device_codec.compress_framed(data, device=device)


def decompress_framed(data: bytes, verify_checksums: bool = True, *,
                      device=None) -> bytes:
    """Decompress a framed (.sz) stream."""
    return device_codec.decompress_framed(data, verify_checksums,
                                          device=device)


def decompress_to_device(data: bytes, *, device=None) -> torch.Tensor:
    """Decompress a raw Snappy stream into a uint8 tensor on the device."""
    return device_codec.decompress_to_device(data, device=device)


def decompress_framed_to_device(data: bytes, verify_checksums: bool = True,
                                *, device=None) -> torch.Tensor:
    """Decompress a framed (.sz) stream into a uint8 tensor on the
    device, each chunk's CRC-32C checked there."""
    return device_codec.decompress_framed_to_device(
        data, verify_checksums, device=device)


def compress_framed_from_device(arr: torch.Tensor, *, device=None) -> bytes:
    """Compress a uint8 device tensor into a framed (.sz) stream, each
    chunk's CRC-32C computed on the device.  Byte-identical to
    ``compress_framed(bytes(arr))``."""
    return device_codec.compress_framed_from_device(arr, device=device)


def compress_from_device(arr: torch.Tensor, *, device=None) -> bytes:
    """Compress a uint8 device tensor into a raw Snappy stream.
    Byte-identical to ``compress(bytes(arr))``."""
    return device_codec.compress_from_device(arr, device=device)
