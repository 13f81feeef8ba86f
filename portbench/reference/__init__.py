"""The benchmark's reference: Snappy's greedy encoder and the framing
format, frozen in ``snappy_greedy.cc`` and bound with ctypes.

The library is built with g++ at first use into ``portbench/_build/``,
a fixed directory inside the checkout, and rebuilt only when the
source's sha256 changes; so only a checkout's first run pays for it.
Nothing here imports the port: the load cells' input streams and the
save cells' expected streams come from this copy alone.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "snappy_greedy.cc")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
SO = os.path.join(BUILD_DIR, "snappy_greedy.so")
_HASH = SO + ".sha256"
CHUNK = 65536
STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
TABLE_BITS = 14  # the reference's hash table: 2**14 entries at most

_lock = threading.Lock()
_lib = None


def _source_hash() -> str:
    with open(SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build(src_hash: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-pthread", SRC, "-o", tmp],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, SO)
    with open(_HASH + ".tmp", "w") as f:
        f.write(src_hash + "\n")
    os.replace(_HASH + ".tmp", _HASH)


def lib():
    """The loaded library, built first where it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            src_hash = _source_hash()
            try:
                with open(_HASH) as f:
                    fresh = f.read().strip() == src_hash and os.path.exists(SO)
            except OSError:
                fresh = False
            if not fresh:
                _build(src_hash)
            loaded = ctypes.CDLL(SO)
            loaded.pb_frame_bound.restype = ctypes.c_uint64
            loaded.pb_frame_bound.argtypes = [ctypes.c_uint64]
            loaded.pb_frame.restype = ctypes.c_int64
            loaded.pb_frame.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                        ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int]
            _lib = loaded
        return _lib


def frame(data: np.ndarray, threads: int = 4,
          table_bits: int = TABLE_BITS) -> tuple[bytes, np.ndarray]:
    """The framed stream of ``data`` (uint8) and each chunk's element
    length (its tags, without the length varint)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.size
    out = np.empty(lib().pb_frame_bound(n), np.uint8)
    elem = np.zeros(-(-n // CHUNK), np.int32)
    got = lib().pb_frame(data.ctypes.data, n, out.ctypes.data,
                         elem.ctypes.data, threads, table_bits)
    if got < 0:
        raise ValueError(f"table_bits must be 8..14, got {table_bits}")
    return out[:got].tobytes(), elem


def records(stream: bytes) -> list[tuple[int, int, int]]:
    """(chunk type, offset of the CRC, body length) of each chunk of a
    stream that ``frame`` made."""
    out, pos = [], len(STREAM_ID)
    while pos < len(stream):
        blen = int.from_bytes(stream[pos + 1 : pos + 4], "little")
        out.append((stream[pos], pos + 4, blen))
        pos += 4 + blen
    return out


class Framed:
    """An object's reference framing: its size, its stream, and each
    chunk's element length; what the per-layer metrics count bytes
    from."""

    def __init__(self, size: int, stream: bytes, elem: np.ndarray):
        self.size, self.stream, self.elem = size, stream, elem

    @functools.cached_property
    def records(self) -> list[tuple[int, int, int]]:
        return records(self.stream)


def framed(data: np.ndarray, threads: int = 4) -> Framed:
    """``frame`` of ``data``, kept with its size."""
    return Framed(int(data.size), *frame(data, threads=threads))
