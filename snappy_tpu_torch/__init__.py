"""snappy_tpu_torch: the Snappy codec of ``snappy_tpu`` on PyTorch and CUDA.

A port beside the JAX package, which stays the reference.  It imports
``torch`` and never ``jax``, and nothing of ``snappy_tpu``: it keeps its
own copies of the JAX package's JAX-free modules, ``spec`` (the oracle
and the format), ``errors``, ``native`` (the C++ host codec, built into
``snappy_tpu_torch/_build/``), ``kernels/encode_np.py`` (the "np"
backend), ``bench/corpus.py``, ``utils`` (``hostmem``, ``progress``,
``log``) and the file helpers of ``cli/main.py``.  A fix to one copy
is made in both.

Layers:
  device.py   the one device pick (``cuda:0`` when present, else ``cpu``)
  kernels/    hand-written CUDA kernels (``csrc/``), built with nvcc at
              first use, each beside its plain PyTorch version
  runtime/    batching, pinned host staging, the framed codec, and the
              streaming FramedReader / FramedWriter
  api.py      the public entry points and the backend registry
  checkpoint  tensors and state dicts as framed streams
  dist/       chunks sharded over a mesh of devices, and per-process
              chunk ranges over ``torch.distributed`` (gloo)
              (``python -m snappy_tpu_torch.dist.multihost``)
  cli/        the ``tpusnappy-torch`` tool (``python -m snappy_tpu_torch``)

Public API: compress / decompress (raw block format), compress_framed /
decompress_framed (framed .sz format), decompress_to_device /
decompress_framed_to_device (stream -> device tensor) and
compress_from_device / compress_framed_from_device (device tensor ->
stream; the framed form computes each chunk's CRC-32C on the device),
decompress_into / decompress_framed_into (into a caller's numpy buffer),
FramedReader / FramedWriter and the ``checkpoint`` module.
"""

from snappy_tpu_torch.errors import (
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
    "decompress_into",
    "decompress_framed_into",
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
    if name in ("FramedReader", "FramedWriter"):
        from snappy_tpu_torch.runtime import stream

        return getattr(stream, name)
    if name == "checkpoint":
        import importlib

        return importlib.import_module("snappy_tpu_torch.checkpoint")
    raise AttributeError(f"module 'snappy_tpu_torch' has no attribute {name!r}")
