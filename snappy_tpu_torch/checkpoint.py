"""Tensor checkpoints over the port's to-device / from-device paths.

Counterpart of ``snappy_tpu/checkpoint.py``, writing the same bytes.
``save_array`` compresses a tensor's bytes with
``compress_framed_from_device`` (each chunk's CRC-32C computed on the
device before a byte leaves it); ``load_array`` lands them on the
device with ``decompress_framed_to_device`` (each CRC checked where the
bytes land).

Format: a standard framed (.sz) stream, which any framed decoder turns
back into the tensor's bytes, with one skippable chunk (type 0x80) right
after the stream identifier that holds the manifest
``{"dtype", "shape", "v": 1}`` as ``json.dumps(sort_keys=True)``.  The
dtype is written by name in numpy's spelling ("float32", "bfloat16",
"bool"), never as ``torch.float32``; :data:`DTYPES` maps the names to
torch dtypes, and a name outside it fails the load.

Several tensors go in one container (``save_pytree`` / ``load_pytree``
over a flat name -> tensor mapping): ``SNPCKPT1``, a ``<I`` count, then
per tensor, in name order, a ``<I`` name length, the UTF-8 name, a
``<Q`` blob length and a ``save_array`` blob.

Where the JAX package raises other errors, a truncated container and a
malformed manifest raise ``CorruptError`` here; ``load_array`` with
``to_device=False`` returns a CPU tensor, not a numpy array (numpy has
no bfloat16).
"""

from __future__ import annotations

import json
import math
import struct

import numpy as np
import torch

from snappy_tpu_torch.errors import CorruptError
from snappy_tpu_torch.spec.format import STREAM_ID_CHUNK
from snappy_tpu_torch.device import resolve
from snappy_tpu_torch.dist.mesh import ShardedRows
from snappy_tpu_torch.runtime.device_codec import (
    compress_framed_from_device,
    decompress_framed,
    decompress_framed_to_device,
)

__all__ = [
    "save_array",
    "load_array",
    "save_pytree",
    "load_pytree",
    "CHUNK_META",
    "DTYPES",
]

CHUNK_META = 0x80  # the first skippable chunk type
_CONTAINER_MAGIC = b"SNPCKPT1"

# manifest dtype names (numpy's spelling, as the JAX package writes them)
DTYPES = {
    name: getattr(torch, name)
    for name in ("float64", "float32", "float16", "bfloat16", "int64",
                 "int32", "int16", "int8", "uint8", "bool", "complex64",
                 "complex128", "uint16", "uint32", "uint64")
    if hasattr(torch, name)
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def _meta_chunk(meta: dict) -> bytes:
    payload = json.dumps(meta, sort_keys=True).encode()
    n = len(payload)
    if n > 0xFFFFFF:  # pragma: no cover - manifests are tiny
        raise ValueError("manifest too large")
    return bytes((CHUNK_META, n & 0xFF, (n >> 8) & 0xFF,
                  (n >> 16) & 0xFF)) + payload


def _split_meta(data: bytes):
    """The manifest of a save_array stream, or None when no manifest
    chunk follows the stream identifier.  Raises CorruptError when the
    manifest chunk is there but is not a version-1 manifest with a known
    dtype and a shape of non-negative ints."""
    pos = len(STREAM_ID_CHUNK)
    if (data[:pos] != STREAM_ID_CHUNK or len(data) < pos + 4
            or data[pos] != CHUNK_META):
        return None
    n = data[pos + 1] | (data[pos + 2] << 8) | (data[pos + 3] << 16)
    if len(data) < pos + 4 + n:
        raise CorruptError("truncated checkpoint manifest")
    try:
        meta = json.loads(bytes(data[pos + 4:pos + 4 + n]).decode())
    except (UnicodeDecodeError, json.JSONDecodeError):
        raise CorruptError("unreadable checkpoint manifest") from None
    shape = meta.get("shape") if isinstance(meta, dict) else None
    if (not isinstance(meta, dict) or meta.get("v") != 1
            or meta.get("dtype") not in DTYPES or not isinstance(shape, list)
            or not all(type(d) is int and d >= 0 for d in shape)):
        raise CorruptError(f"malformed checkpoint manifest {meta!r}"[:200])
    return meta


def _array_parts(arr) -> list:
    """save_array's stream as [stream identifier, manifest chunk, a view
    of the records], so that a container joins it in one copy."""
    if isinstance(arr, ShardedRows):  # its shards, joined on the first's device
        dev = arr.shards[0].device
        arr = torch.cat([s.to(dev) for s in arr.shards])
    t = torch.as_tensor(arr)
    if t.dtype not in _NAMES:
        raise ValueError(f"no checkpoint name for dtype {t.dtype}")
    if t.device.type == "cpu":
        t = t.to(resolve(None))
    meta = {"v": 1, "dtype": _NAMES[t.dtype], "shape": list(t.shape)}
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    fr = compress_framed_from_device(flat)
    head = len(STREAM_ID_CHUNK)
    return [fr[:head], _meta_chunk(meta), memoryview(fr)[head:]]


def save_array(arr) -> bytes:
    """Serialize a tensor: its bytes (``view(torch.uint8)``, so int8 and
    bool are stored as their byte values) go through
    ``compress_framed_from_device``, with the manifest in a skippable
    chunk.  A CPU tensor (or array-like) moves to the default device
    first (``cuda:0`` when there is a GPU), as ``jnp.asarray`` does in
    the JAX package.  A ``dist.mesh.ShardedRows`` is saved as the batch
    its shards make, joined in shard order: the same bytes as the
    gathered tensor's."""
    return b"".join(_array_parts(arr))


def load_array(data: bytes, to_device: bool = True) -> torch.Tensor:
    """Load a tensor saved by save_array (or by the JAX package's).
    ``to_device=True`` lands the bytes on the default device through
    ``decompress_framed_to_device`` (CRCs checked there); False decodes
    on the host and returns a CPU tensor."""
    meta = _split_meta(data)
    if meta is None:
        raise CorruptError("missing checkpoint manifest")
    dtype = DTYPES[meta["dtype"]]
    shape = tuple(meta["shape"])
    want = math.prod(shape) * dtype.itemsize
    if to_device:
        u8 = decompress_framed_to_device(data)
    else:
        u8 = torch.from_numpy(np.frombuffer(
            decompress_framed(data), np.uint8).copy())
    if int(u8.numel()) != want:
        raise CorruptError("checkpoint size disagrees with manifest")
    if not want:  # an empty uint8 tensor may have stride 0: no view
        return torch.empty(shape, dtype=dtype, device=u8.device)
    if dtype == torch.bool:  # any non-zero byte is True, as in JAX
        return u8.to(torch.bool).reshape(shape)
    return u8.view(dtype).reshape(shape)


def save_pytree(tree: dict) -> bytes:
    """Serialize a flat name -> tensor mapping as one container (names
    sorted; each entry a self-contained save_array stream).  The
    container is joined once at the end: one host copy of the streams."""
    items = sorted(tree.items())
    parts = [_CONTAINER_MAGIC, struct.pack("<I", len(items))]
    for name, arr in items:
        nb = name.encode()
        blob = _array_parts(arr)
        parts += [struct.pack("<I", len(nb)), nb,
                  struct.pack("<Q", sum(len(p) for p in blob)), *blob]
    return b"".join(parts)


def container_entries(data: bytes) -> list[tuple[str, int, int]]:
    """(name, start, end) of each save_array blob of a container, with
    the whole container checked before anything is decoded: a bad magic,
    a truncated field or blob, or trailing bytes raise CorruptError."""
    if data[:8] != _CONTAINER_MAGIC:
        raise CorruptError("not a snappy_tpu checkpoint container")

    def field(fmt: str, pos: int) -> int:
        if pos + struct.calcsize(fmt) > len(data):
            raise CorruptError("truncated checkpoint container")
        return struct.unpack_from(fmt, data, pos)[0]

    n = field("<I", 8)
    pos = 12
    entries = []
    for _ in range(n):
        nl = field("<I", pos)
        pos += 4
        if pos + nl > len(data):
            raise CorruptError("truncated checkpoint container")
        try:
            name = bytes(data[pos:pos + nl]).decode()
        except UnicodeDecodeError:
            raise CorruptError("unreadable checkpoint entry name") from None
        bl = field("<Q", pos + nl)
        pos += nl + 8
        if pos + bl > len(data):
            raise CorruptError("truncated checkpoint container")
        entries.append((name, pos, pos + bl))
        pos += bl
    if pos != len(data):
        raise CorruptError("trailing bytes after checkpoint container")
    return entries


def load_pytree(data: bytes, to_device: bool = True) -> dict:
    """Load a container written by save_pytree (or by the JAX package's);
    each entry is read in place, through a view of ``data``."""
    view = memoryview(data)
    return {name: load_array(view[lo:hi], to_device)
            for name, lo, hi in container_entries(data)}
