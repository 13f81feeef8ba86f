"""Build and load the CUDA kernels of ``snappy_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc``, one process per
source, all started together, and linked into one shared library with
a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <source>.o snappy_tpu_torch/csrc/<source>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o snappy_tpu_torch/_build/libsnappy_cuda.so *.o

The library is rebuilt only when the sources' sha256 changes (the
verify-before-activate rule of ``snappy_tpu/native``).  Unlike
``snappy_tpu.native._build``, which returns None, a failed build raises
with nvcc's output: a wrapper handed a CUDA tensor has no other way to
run.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into a ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SO = os.path.join(BUILD_DIR, "libsnappy_cuda.so")
_HASH_FILE = os.path.join(BUILD_DIR, "source.sha256")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib = None
# seconds the last build took in this process (None: loaded a fresh .so)
build_seconds: float | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()


def _is_fresh(src_hash: str) -> bool:
    try:
        with open(_HASH_FILE) as f:
            return os.path.exists(SO) and f.read().strip() == src_hash
    except OSError:
        return False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel, wait for all, raise on any failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{err}{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _build(src_hash: str) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in sources()]
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                   "-fPIC", "-c", "-o", obj, src]
                  for src, obj in zip(sources(), objs)])
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", f"{SO}.{tag}", *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(f"{SO}.{tag}", SO)
    with open(_HASH_FILE + ".tmp", "w") as f:
        f.write(src_hash + "\n")
    os.replace(_HASH_FILE + ".tmp", _HASH_FILE)
    build_seconds = time.perf_counter() - t0


def _declare(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.snc_crc32c_rows.restype = ctypes.c_int
    lib.snc_crc32c_rows.argtypes = [p, i64, i32, p, p, p, p, i32, p]
    lib.snc_flat_exec.restype = ctypes.c_int
    lib.snc_flat_exec.argtypes = [p, i64, p, i32, p, p, p, i64, i64, i32,
                                  i32, p]
    lib.snc_seq_decode.restype = ctypes.c_int
    lib.snc_seq_decode.argtypes = [p, i64, i32, p, p, p, p, i32, p, i32, p]
    lib.snc_seq_encode.restype = ctypes.c_int
    lib.snc_seq_encode.argtypes = [p, i64, i32, p, p, i32, p, p, i32, p]
    lib.snc_wavegroup.restype = ctypes.c_int
    lib.snc_wavegroup.argtypes = [p, i64, i32, p, i32, p, p, i32, i32, p]
    lib.snc_match_cands.restype = ctypes.c_int
    lib.snc_match_cands.argtypes = [p, p, i32, i32, p, p, i32, p]
    lib.snc_error_string.restype = ctypes.c_char_p
    lib.snc_error_string.argtypes = [ctypes.c_int]


def lib():
    """The loaded kernel library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            src_hash = _source_hash()
            if not _is_fresh(src_hash):
                _build(src_hash)
            loaded = ctypes.CDLL(SO)
            _declare(loaded)
            _lib = loaded
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib().snc_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
