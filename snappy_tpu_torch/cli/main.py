"""The ``tpusnappy-torch`` tool: the ``tpusnappy`` CLI on the port.

Counterpart of ``snappy_tpu/cli/main.py`` with the ``compress``,
``decompress``, ``verify`` and ``info`` subcommands and their options
(``--backend``, ``--format``, ``--verify``, ``-`` for stdin/stdout).
Codec calls go through the port's registry (:mod:`snappy_tpu_torch.api`,
default backend "torch"); files above ``SNAPPY_TPU_STREAM_THRESHOLD``
bytes and pipes stream through the port's ``FramedReader`` /
``FramedWriter`` in slabs.  Output files are written atomically (tmp,
fsync, rename); exit codes follow ``snappy_tpu_torch.errors.exit_code_for``
(the same codes as ``snappy_tpu``'s).
``info`` reads a checkpoint manifest with the port's parser.

    python -m snappy_tpu_torch compress big.bin --backend torch
    python -m snappy_tpu_torch decompress big.bin.sz -o big.out
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import tempfile
import time

from snappy_tpu_torch.errors import CorruptError, SnappyError, exit_code_for
from snappy_tpu_torch.spec.format import STREAM_ID_CHUNK

PROG = "tpusnappy-torch"
# Files above this size stream through FramedWriter/FramedReader in
# slabs of _SLAB bytes (bounded memory at any size).
STREAM_THRESHOLD = int(os.environ.get("SNAPPY_TPU_STREAM_THRESHOLD",
                                      str(64 << 20)))
_SLAB = 16 << 20


# _read, _atomic_write, _emit, _detect_format and _make_meter are copies
# of snappy_tpu/cli/main.py's helpers


def _read(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + rename in the destination directory (the reference's
    helpers.AtomicWriteFile pattern)."""
    fd, tmp = _tmp_beside(path)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        _unlink_quietly(tmp)
        raise


def _emit(path: str | None, data: bytes) -> None:
    if path is None or path == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        _atomic_write(path, data)


def _detect_format(data: bytes) -> str:
    return "framed" if data.startswith(STREAM_ID_CHUNK) else "raw"


def _make_meter(args):
    from snappy_tpu_torch.utils.progress import NullMeter, default_meter

    if getattr(args, "quiet", False):
        return NullMeter()
    return default_meter()


def _say(msg: str) -> None:
    print(f"{PROG}: {msg}", file=sys.stderr)


def _tmp_beside(dest: str) -> tuple[int, str]:
    d = os.path.dirname(os.path.abspath(dest)) or "."
    return tempfile.mkstemp(prefix=".tpusnappy-", dir=d)


def _unlink_quietly(path: str | None) -> None:
    if path is not None:
        try:
            os.unlink(path)
        except OSError:
            pass


def _stream_compress(args, meter) -> int:
    """Slab-streamed framed compression: bounded memory at any input
    size, atomic output, optional streamed verify."""
    from snappy_tpu_torch.runtime.stream import FramedReader, FramedWriter

    total = os.path.getsize(args.file)
    dest = args.output or (args.file + ".sz")
    fd, tmp = _tmp_beside(dest)
    t0 = time.perf_counter()
    try:
        done = 0
        meter.start(f"compress {os.path.basename(args.file)}", total)
        with os.fdopen(fd, "wb") as sink, open(args.file, "rb") as src:
            with FramedWriter(sink, backend=args.backend) as w:
                while True:
                    slab = src.read(_SLAB)
                    if not slab:
                        break
                    w.write(slab)
                    done += len(slab)
                    meter.set(done)
                sink.flush()
                os.fsync(sink.fileno())
        meter.finish()
        out_size = os.path.getsize(tmp)
        if args.verify:
            meter.start("verify", total)
            done = 0
            with open(tmp, "rb") as comp, open(args.file, "rb") as orig:
                r = FramedReader(comp, backend=args.backend)
                while True:
                    got = r.read(_SLAB)
                    want = orig.read(len(got)) if got else orig.read(1)
                    if got != want:
                        _say("verification failed: round-trip mismatch")
                        return 1
                    if not got:
                        break
                    done += len(got)
                    meter.set(done)
            meter.finish()
        os.replace(tmp, dest)
        tmp = None
    finally:
        _unlink_quietly(tmp)
    if not args.quiet:
        dt = time.perf_counter() - t0
        ratio = total / max(out_size, 1)
        print(
            f"{args.file}: {total} -> {out_size} bytes "
            f"({ratio:.2f}x, {total / 1e9 / max(dt, 1e-9):.3f} GB/s, streamed)"
            + (", verified" if args.verify else ""),
            file=sys.stderr,
        )
    return 0


def _stream_decompress(args, dest, meter) -> int:
    from snappy_tpu_torch.runtime.stream import FramedReader

    total = os.path.getsize(args.file)
    fd, tmp = _tmp_beside(dest)
    t0 = time.perf_counter()
    out_size = 0
    try:
        meter.start(f"decompress {os.path.basename(args.file)}", total)
        with os.fdopen(fd, "wb") as sink, open(args.file, "rb") as src:
            r = FramedReader(src, backend=args.backend)
            while True:
                blob = r.read(_SLAB)
                if not blob:
                    break
                sink.write(blob)
                out_size += len(blob)
                meter.set(min(src.tell(), total))
            sink.flush()
            os.fsync(sink.fileno())
        meter.finish()
        os.replace(tmp, dest)
        tmp = None
    finally:
        _unlink_quietly(tmp)
    if not args.quiet:
        dt = time.perf_counter() - t0
        print(
            f"{args.file}: {total} -> {out_size} bytes "
            f"({out_size / 1e9 / max(dt, 1e-9):.3f} GB/s, streamed)",
            file=sys.stderr,
        )
    return 0


def _pipe_compress(args) -> int:
    """stdin -> framed stdout in slabs (bounded memory on pipes)."""
    from snappy_tpu_torch.runtime.stream import FramedWriter

    if args.verify:
        _say("--verify cannot re-read a pipe")
        return 2
    done = 0
    with FramedWriter(sys.stdout.buffer, backend=args.backend) as w:
        while True:
            slab = sys.stdin.buffer.read(_SLAB)
            if not slab:
                break
            w.write(slab)
            done += len(slab)
    sys.stdout.buffer.flush()
    if not args.quiet:
        print(f"-: {done} bytes compressed (streamed)", file=sys.stderr)
    return 0


class _Chained(io.RawIOBase):
    """A source that serves ``first`` and then reads ``rest``."""

    def __init__(self, first: bytes, rest):
        self._first = first
        self._rest = rest

    def read(self, n=-1):
        if self._first:
            if n < 0 or n >= len(self._first):
                out, self._first = self._first, b""
                return out
            out, self._first = self._first[:n], self._first[n:]
            return out
        return self._rest.read(n)


def _pipe_decompress(args) -> int:
    """stdin -> stdout in slabs (bounded memory on pipes for framed
    input; a raw stream needs the whole stream and is read at once)."""
    from snappy_tpu_torch import api
    from snappy_tpu_torch.runtime.stream import FramedReader

    head = sys.stdin.buffer.read(len(STREAM_ID_CHUNK))
    fmt = args.format
    if fmt == "auto":
        fmt = "framed" if head == STREAM_ID_CHUNK else "raw"
    if fmt == "raw":
        out = api.decompress(head + sys.stdin.buffer.read(),
                             backend=args.backend)
        sys.stdout.buffer.write(out)
        sys.stdout.buffer.flush()
        if not args.quiet:
            print(f"-: {len(out)} bytes decompressed", file=sys.stderr)
        return 0
    r = FramedReader(_Chained(head, sys.stdin.buffer), backend=args.backend)
    done = 0
    while True:
        piece = r.read(_SLAB)
        if not piece:
            break
        sys.stdout.buffer.write(piece)
        done += len(piece)
    sys.stdout.buffer.flush()
    if not args.quiet:
        print(f"-: {done} bytes decompressed (streamed)", file=sys.stderr)
    return 0


def cmd_compress(args) -> int:
    from snappy_tpu_torch import api

    meter = _make_meter(args)
    if args.format == "framed" and args.file == "-" and args.output in (
            None, "-"):
        return _pipe_compress(args)
    if (
        args.format == "framed"
        and args.file != "-"
        and args.output != "-"
        and os.path.isfile(args.file)
        and os.path.getsize(args.file) > STREAM_THRESHOLD
    ):
        return _stream_compress(args, meter)
    data = _read(args.file)
    t0 = time.perf_counter()
    meter.start(f"compress {os.path.basename(args.file)}", max(len(data), 1))
    if args.format == "raw":
        out = api.compress(data, backend=args.backend)
    else:
        out = api.compress_framed(data, backend=args.backend)
    meter.set(len(data))
    meter.finish()
    dt = time.perf_counter() - t0
    if args.verify:
        back = (
            api.decompress(out, backend=args.backend)
            if args.format == "raw"
            else api.decompress_framed(out, backend=args.backend)
        )
        if back != data:
            _say("verification failed: round-trip mismatch")
            return 1
    dest = args.output or (args.file + (".snappy" if args.format == "raw" else ".sz"))
    _emit(dest if args.output != "-" else "-", out)
    if not args.quiet:
        ratio = len(data) / max(len(out), 1)
        print(
            f"{args.file}: {len(data)} -> {len(out)} bytes "
            f"({ratio:.2f}x, {len(data) / 1e9 / max(dt, 1e-9):.3f} GB/s)"
            + (", verified" if args.verify else ""),
            file=sys.stderr,
        )
    return 0


def cmd_decompress(args) -> int:
    from snappy_tpu_torch import api

    meter = _make_meter(args)
    dest = args.output
    if dest is None:
        for suffix in (".snappy", ".sz"):
            if args.file.endswith(suffix):
                dest = args.file[: -len(suffix)]
                break
        else:
            dest = "-"
    if (args.file == "-" and dest == "-"
            and args.format in ("auto", "framed")):
        return _pipe_decompress(args)
    if (
        args.file != "-"
        and dest != "-"
        and os.path.isfile(args.file)
        and os.path.getsize(args.file) > STREAM_THRESHOLD
    ):
        with open(args.file, "rb") as f:
            head = f.read(10)
        fmt = args.format if args.format != "auto" else _detect_format(head)
        if fmt == "framed":
            return _stream_decompress(args, dest, meter)
    data = _read(args.file)
    fmt = args.format if args.format != "auto" else _detect_format(data)
    t0 = time.perf_counter()
    meter.start(f"decompress {os.path.basename(args.file)}", max(len(data), 1))
    if fmt == "raw":
        out = api.decompress(data, backend=args.backend)
    else:
        out = api.decompress_framed(data, backend=args.backend)
    meter.set(len(data))
    meter.finish()
    dt = time.perf_counter() - t0
    _emit(dest, out)
    if not args.quiet:
        print(
            f"{args.file}: {len(data)} -> {len(out)} bytes "
            f"({len(out) / 1e9 / max(dt, 1e-9):.3f} GB/s)",
            file=sys.stderr,
        )
    return 0


def cmd_verify(args) -> int:
    """Integrity check without writing output: each framed chunk's CRC
    (full decode for a raw stream), optionally a sha-512 of the decoded
    bytes."""
    from snappy_tpu_torch import api

    data = _read(args.file)
    fmt = _detect_format(data)
    try:
        if fmt == "framed":
            out = api.decompress_framed(data, backend=args.backend)
        else:
            out = api.decompress(data, backend=args.backend)
    except SnappyError as e:
        print(f"{args.file}: FAILED: {e}", file=sys.stderr)
        return exit_code_for(e)
    print(f"{args.file}: OK ({fmt}, {len(data)} -> {len(out)} bytes)")
    if args.digest:
        import hashlib

        print(f"sha512(uncompressed) = {hashlib.sha512(out).hexdigest()}")
    return 0


def cmd_info(args) -> int:
    """Stream structure report, with a checkpoint's manifest."""
    from snappy_tpu_torch.spec.format import (
        CHUNK_COMPRESSED,
        CHUNK_PADDING,
        CHUNK_STREAM_ID,
        CHUNK_UNCOMPRESSED,
        read_uvarint,
    )
    from snappy_tpu_torch.checkpoint import _split_meta

    data = _read(args.file)
    fmt = _detect_format(data)
    if fmt == "raw":
        dst_len, _hdr = read_uvarint(data, 0)
        print("format:            raw snappy block stream")
        print(f"compressed size:   {len(data)}")
        print(f"uncompressed size: {dst_len}")
        print(f"ratio:             {dst_len / max(len(data), 1):.3f}")
        return 0
    pos = len(STREAM_ID_CHUNK)
    counts = {"compressed": 0, "uncompressed": 0, "padding/skippable": 0}
    total_out = 0
    while pos + 4 <= len(data):
        ctype = data[pos]
        body = data[pos + 1] | (data[pos + 2] << 8) | (data[pos + 3] << 16)
        pos += 4 + body
        if ctype == CHUNK_COMPRESSED:
            counts["compressed"] += 1
            dlen, _ = read_uvarint(data, pos - body + 4)
            total_out += dlen
        elif ctype == CHUNK_UNCOMPRESSED:
            counts["uncompressed"] += 1
            total_out += body - 4
        elif (ctype in (CHUNK_PADDING, CHUNK_STREAM_ID)
              or 0x80 <= ctype <= 0xFD):
            counts["padding/skippable"] += 1
    print("format:            framed (.sz)")
    print(f"compressed size:   {len(data)}")
    print(f"uncompressed size: {total_out}")
    print(f"ratio:             {total_out / max(len(data), 1):.3f}")
    for k, v in counts.items():
        print(f"{k + ' chunks:':<19}{v}")
    try:
        meta = _split_meta(data)
    except CorruptError:  # a foreign skippable chunk, not a manifest
        meta = None
    if meta is not None:
        print(f"checkpoint:        dtype={meta['dtype']} "
              f"shape={meta['shape']} (snappy_tpu_torch.checkpoint)")
    return 0


def main(argv=None) -> int:
    from snappy_tpu_torch.utils.hostmem import tune_allocator

    tune_allocator()
    p = argparse.ArgumentParser(
        prog=PROG, description="Snappy codec on PyTorch and CUDA"
    )
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "--backend", default=None,
        help="codec backend: torch (the device codec; the default), "
             "native (C++ host), np, oracle, auto (native, else oracle)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="compress a file", parents=[common])
    c.add_argument("file")
    c.add_argument("-o", "--output", default=None)
    c.add_argument("--format", choices=("raw", "framed"), default="framed")
    c.add_argument("--verify", action="store_true", help="decode-after-encode check")
    c.add_argument("-q", "--quiet", action="store_true")
    c.set_defaults(fn=cmd_compress)

    d = sub.add_parser("decompress", help="decompress a file", parents=[common])
    d.add_argument("file")
    d.add_argument("-o", "--output", default=None)
    d.add_argument("--format", choices=("auto", "raw", "framed"), default="auto")
    d.add_argument("-q", "--quiet", action="store_true")
    d.set_defaults(fn=cmd_decompress)

    v = sub.add_parser("verify", help="integrity-check a stream", parents=[common])
    v.add_argument("file")
    v.add_argument("--digest", action="store_true",
                   help="print sha-512 of the decoded bytes")
    v.set_defaults(fn=cmd_verify)

    i = sub.add_parser("info", help="describe a stream", parents=[common])
    i.add_argument("file")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except SnappyError as e:
        from snappy_tpu_torch.utils.log import log_error

        log_error(e, context=args.cmd)
        _say(str(e))
        return exit_code_for(e)
    except FileNotFoundError as e:
        _say(str(e))
        return 2


if __name__ == "__main__":
    sys.exit(main())
