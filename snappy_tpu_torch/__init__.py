"""snappy_tpu_torch: the Snappy codec of ``snappy_tpu`` on PyTorch and CUDA.

A port beside the JAX package, which stays the reference.  It imports
``torch`` and never ``jax``; from ``snappy_tpu`` it uses only the
JAX-free modules: ``spec`` (the oracle and the format), ``errors``,
``native`` (the C++ host codec), ``bench.corpus`` and
``utils.hostmem``.

Layers:
  device.py   the one device pick (``cuda:0`` when present, else ``cpu``)
  kernels/    hand-written CUDA kernels (``csrc/``), built with nvcc at
              first use, each beside its plain PyTorch version
  runtime/    batching, pinned host staging, the framed codec
  api.py      the public entry points

Public API: compress / decompress (raw block format), compress_framed /
decompress_framed (framed .sz format), decompress_to_device /
decompress_framed_to_device (stream -> device tensor) and
compress_from_device / compress_framed_from_device (device tensor ->
stream; the framed form computes each chunk's CRC-32C on the device).
"""

from snappy_tpu.errors import (
    BadMagicError,
    ChecksumError,
    CorruptError,
    SnappyError,
    TooLargeError,
    UnsupportedError,
)

__version__ = "0.5.0"  # the distribution's version (pyproject.toml)

__all__ = [
    "SnappyError",
    "CorruptError",
    "ChecksumError",
    "TooLargeError",
    "UnsupportedError",
    "BadMagicError",
    "compress",
    "decompress",
    "compress_framed",
    "decompress_framed",
    "decompress_to_device",
    "decompress_framed_to_device",
    "compress_framed_from_device",
    "compress_from_device",
    "__version__",
]

_API = frozenset(__all__[6:-1])


def __getattr__(name):
    # lazy: `import snappy_tpu_torch` loads neither torch nor the codec
    if name in _API:
        from snappy_tpu_torch import api

        return getattr(api, name)
    raise AttributeError(f"module 'snappy_tpu_torch' has no attribute {name!r}")
