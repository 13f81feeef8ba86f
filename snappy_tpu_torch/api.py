"""Public API of the port: the codec entry points of ``snappy_tpu.api``
on PyTorch, with the port's own backend registry.

Bytes in and bytes out for the raw and framed formats route through a
registry of interchangeable backends, selectable per call
(``backend=``) or through ``SNAPPY_TPU_BACKEND``:

  "torch"   the port's device codec (``runtime.device_codec``), in the
            role that "jnp" plays in the JAX package; the default
  "native"  the port's copy of the C++ host codec (``native``)
  "np"      ``kernels.encode_np`` and the oracle's decoder
  "oracle"  the pure-Python reference (``spec``)
  "auto"    the JAX package's preference: "native", else "oracle"

The registry is the port's own: ``snappy_tpu.api`` registers "jnp" and
so imports jax on its first call.  Unlike the JAX package, whose
default is "auto", a call with neither ``backend=`` nor
``SNAPPY_TPU_BACKEND`` runs "torch", so the port's entry points keep
running on the device.  ``device=`` reaches "torch" only; the host
backends ignore it.

The to-device / from-device matrix takes and returns uint8
``torch.Tensor``s and always runs the device codec.  ``device=None`` is
the pick of :mod:`snappy_tpu_torch.device` (``cuda:0`` when there is a
GPU, else ``cpu``), and for the from-device functions the tensor's own
device.
"""

from __future__ import annotations

import functools
import os
from typing import Callable

import numpy as np
import torch

from snappy_tpu_torch.runtime import device_codec

_BACKENDS: dict[str, dict[str, Callable]] = {}

DEFAULT_BACKEND = "torch"
_PREFERENCE = ("native", "oracle")  # "auto", as in the JAX package


def register_backend(name: str, **fns: Callable) -> None:
    _BACKENDS.setdefault(name, {}).update(fns)


def available_backends() -> list[str]:
    _ensure_default_backends()
    return sorted(_BACKENDS)


def _ensure_default_backends() -> None:
    if "oracle" not in _BACKENDS:
        from snappy_tpu_torch.spec import framing, reference

        register_backend(
            "oracle",
            compress=reference.compress,
            decompress=reference.decompress,
            compress_framed=framing.compress_framed,
            decompress_framed=framing.decompress_framed,
        )
    if "np" not in _BACKENDS:
        from snappy_tpu_torch.kernels import encode_np
        from snappy_tpu_torch.spec import framing, reference

        register_backend(
            "np",
            compress=encode_np.compress,
            decompress=reference.decompress,
            compress_framed=framing.compress_framed,
            decompress_framed=framing.decompress_framed,
        )
    if "native" not in _BACKENDS:
        from snappy_tpu_torch import native

        if native.available():
            register_backend(
                "native",
                compress=native.compress,
                decompress=native.decompress,
                compress_framed=native.compress_framed,
                decompress_framed=native.decompress_framed,
            )
    if "torch" not in _BACKENDS:
        register_backend(
            "torch",
            compress=device_codec.compress,
            decompress=device_codec.decompress,
            compress_framed=device_codec.compress_framed,
            decompress_framed=device_codec.decompress_framed,
        )


def _resolve(op: str, backend: str | None, device=None) -> Callable:
    """The function of backend ``backend`` (None: ``SNAPPY_TPU_BACKEND``,
    else "torch") for ``op``; "torch" gets ``device`` bound."""
    _ensure_default_backends()
    name = backend or os.environ.get("SNAPPY_TPU_BACKEND") or DEFAULT_BACKEND
    if name == "auto":
        name = next((c for c in _PREFERENCE
                     if op in _BACKENDS.get(c, ())), None)
        if name is None:
            raise RuntimeError(f"no backend provides {op!r}")
    try:
        fn = _BACKENDS[name][op]
    except KeyError:
        raise ValueError(
            f"backend {name!r} does not provide {op!r}; available: "
            f"{sorted(b for b, ops in _BACKENDS.items() if op in ops)}"
        ) from None
    return functools.partial(fn, device=device) if name == "torch" else fn


def compress(data: bytes, *, backend: str | None = None,
             device=None) -> bytes:
    """Compress bytes into the raw Snappy block format."""
    return _resolve("compress", backend, device)(data)


def decompress(data: bytes, *, backend: str | None = None,
               device=None) -> bytes:
    """Decompress a raw Snappy block-format stream."""
    return _resolve("decompress", backend, device)(data)


def compress_framed(data: bytes, *, backend: str | None = None,
                    device=None) -> bytes:
    """Compress bytes into the framed (.sz) stream format."""
    return _resolve("compress_framed", backend, device)(data)


def decompress_framed(data: bytes, verify_checksums: bool = True, *,
                      backend: str | None = None, device=None) -> bytes:
    """Decompress a framed (.sz) stream."""
    return _resolve("decompress_framed", backend, device)(
        data, verify_checksums)


def _copy_into(blob: bytes, out) -> int:
    if out.size < len(blob):
        raise ValueError(f"out buffer {out.size} < decoded {len(blob)}")
    out[: len(blob)] = np.frombuffer(blob, np.uint8)
    return len(blob)


def _host_backend() -> str:
    """The backend of the into-entries without the native library:
    ``SNAPPY_TPU_BACKEND``, else "auto", as in the JAX package."""
    return os.environ.get("SNAPPY_TPU_BACKEND") or "auto"


def decompress_into(data: bytes, out) -> int:
    """Decompress a raw Snappy stream into a caller-owned uint8 numpy
    buffer; returns the decoded length.  The native decoder writes in
    place; without it, ``SNAPPY_TPU_BACKEND`` (else "auto") decodes and
    the bytes are copied in."""
    from snappy_tpu_torch import native

    if native.available():
        return native.decompress_into(data, out)
    return _copy_into(decompress(data, backend=_host_backend()), out)


def decompress_framed_into(data: bytes, out,
                           verify_checksums: bool = True) -> int:
    """Decompress a framed (.sz) stream into a caller-owned uint8 numpy
    buffer; returns the decoded length (see decompress_into)."""
    from snappy_tpu_torch import native

    if native.available():
        return native.decompress_framed_into(
            data, out, verify_checksums=verify_checksums)
    return _copy_into(
        decompress_framed(data, verify_checksums, backend=_host_backend()),
        out)


def decompress_to_device(data: bytes, *, device=None) -> torch.Tensor:
    """Decompress a raw Snappy stream into a uint8 tensor on the device."""
    return device_codec.decompress_to_device(data, device=device)


def decompress_framed_to_device(data: bytes, verify_checksums: bool = True,
                                *, device=None) -> torch.Tensor:
    """Decompress a framed (.sz) stream into a uint8 tensor on the
    device, each chunk's CRC-32C checked there."""
    return device_codec.decompress_framed_to_device(
        data, verify_checksums, device=device)


def compress_framed_from_device(arr, lens=None, *, device=None) -> bytes:
    """Compress a uint8 device tensor into a framed (.sz) stream, each
    chunk's CRC-32C computed on the device.  Byte-identical to
    ``compress_framed(bytes(arr))``.

    With ``lens``, ``arr`` is a ``dist.mesh.ShardedRows`` of 64 KiB chunk
    rows laid out over several devices (as
    ``dist.mesh.sharded_decompress_framed_to_device`` returns them) and
    ``lens`` the valid bytes of its first ``len(lens)`` rows: each shard
    is encoded on its own device, and the stream holds the rows' chunks
    in row order, the bytes of ``compress_framed`` of the rows' bytes
    where every row but the last is a full chunk."""
    return device_codec.compress_framed_from_device(arr, lens, device=device)


def compress_from_device(arr: torch.Tensor, *, device=None) -> bytes:
    """Compress a uint8 device tensor into a raw Snappy stream.
    Byte-identical to ``compress(bytes(arr))``."""
    return device_codec.compress_from_device(arr, device=device)
