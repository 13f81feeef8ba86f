"""Multi-host data-parallel codec over ``torch.distributed``.

Counterpart of ``snappy_tpu/dist/multihost.py``.  Each process owns a
contiguous range of 64 KiB chunks and compresses or decompresses them
on its device; the only traffic between processes is the all-gather of
per-chunk record lengths on compress, so that every process can compute
its global output offset (an exclusive scan) for its writes.  Parity
with single-process output is structural: block encodings are position
independent.

Run one process per host (or several sharing a card):

    python -m snappy_tpu_torch.dist.multihost --coordinator HOST:PORT \\
        --num-processes N --process-id I compress IN OUT

Every process writes its own chunk range into OUT at its global offset
(os.pwrite; ranges are disjoint) and prints one JSON stats line.  The
process group is gloo on CPU tensors: the collective moves host int64
lengths, and NCCL refuses two ranks on one GPU.
"""

from __future__ import annotations

import numpy as np

from snappy_tpu_torch.spec.format import MAX_CHUNK_UNCOMPRESSED

__all__ = [
    "plan_ranges",
    "plan_chunk_ranges",
    "host_compress_framed",
    "host_decompress_framed",
    "host_decompress_framed_to_device",
    "host_compress_framed_from_device",
    "gather_lengths",
    "main",
]


def plan_ranges(total_bytes: int, num_hosts: int,
                chunk_size: int = MAX_CHUNK_UNCOMPRESSED):
    """Split a stream into per-host contiguous chunk ranges (balanced to
    within one chunk).  Returns [(chunk_start, chunk_count), ...]."""
    n_chunks = (total_bytes + chunk_size - 1) // chunk_size if total_bytes else 0
    return plan_chunk_ranges(n_chunks, num_hosts)


def plan_chunk_ranges(n_chunks: int, num_hosts: int):
    """Contiguous per-host ranges over an existing chunk list (balanced
    to within one chunk).  Returns [(first_chunk, count), ...]."""
    base = n_chunks // num_hosts
    extra = n_chunks % num_hosts
    out = []
    start = 0
    for h in range(num_hosts):
        cnt = base + (1 if h < extra else 0)
        out.append((start, cnt))
        start += cnt
    return out


def host_decompress_framed(src: bytes, process_id: int, num_processes: int,
                           verify_checksums: bool = True, device=None):
    """Decompress this host's chunk range of a framed stream on
    ``device`` (the card by default).

    Every host scans the frame index locally (headers carry each chunk's
    decoded size, so global output offsets are an exclusive scan with no
    collective: decompress moves nothing between hosts).  Returns
    (out_offset, local_bytes, total_len, stats) where stats carries the
    per-host GB/s."""
    import time

    from snappy_tpu_torch.runtime import device_codec

    t0 = time.perf_counter()
    chunks, total = device_codec._scan_frames(src)
    lo, cnt = plan_chunk_ranges(len(chunks), num_processes)[process_id]

    # global output offsets: exclusive scan over decoded sizes
    g_offs = np.cumsum([0] + [ch[4] for ch in chunks]).tolist()
    out_base = g_offs[lo] if cnt else total
    local_total = g_offs[lo + cnt] - out_base if cnt else 0
    local_offs = [o - out_base for o in g_offs]
    out = np.empty(max(1, local_total), dtype=np.uint8)
    device_codec.decode_chunk_range(
        np.frombuffer(src, dtype=np.uint8), chunks, local_offs, out,
        range(lo, lo + cnt), verify_checksums, device=device)
    dt = time.perf_counter() - t0
    stats = {
        "host": process_id,
        "chunks": cnt,
        "bytes": local_total,
        "seconds": round(dt, 4),
        "gbs": round(local_total / 1e9 / dt, 4) if dt > 0 else None,
    }
    return out_base, out[:local_total].tobytes(), total, stats


def host_decompress_framed_to_device(src: bytes, process_id: int,
                                     num_processes: int, mesh=None,
                                     verify_checksums: bool = True):
    """Decompress this host's chunk range of a framed stream straight
    onto its local devices (the multi-host data loader): every host
    scans the frame index locally and id-stages only its contiguous
    chunk range; the rows land sharded over the local mesh with each
    chunk's CRC-32C checked on its device, and no collective.

    Returns (rows, dst_lens, lo, cnt): rows a ``ShardedRows`` of
    uint8[cnt_padded, 65536] over ``mesh`` (default: ``make_mesh()``,
    every local card), row i = global chunk lo + i with dst_lens[i]
    valid bytes.  Single-device form: decompress_framed_to_device."""
    from snappy_tpu_torch.dist import mesh as dmesh
    from snappy_tpu_torch.runtime import device_codec

    if mesh is None:
        mesh = dmesh.make_mesh()
    chunks, _total = device_codec._scan_frames(src)
    lo, cnt = plan_chunk_ranges(len(chunks), num_processes)[process_id]
    rows, dlens, b = dmesh.sharded_decompress_framed_to_device(
        mesh, src, verify_checksums, chunk_range=(lo, cnt))
    return rows, dlens[:b], lo, cnt


def host_compress_framed_from_device(rows, lens: np.ndarray, mesh=None):
    """Encode this host's device-resident chunk rows into framed chunk
    records through the runtime's ``compress_framed_from_device`` of
    sharded rows (each shard on its own card, each chunk's CRC-32C there
    before the rows leave it, the local native matcher framing), and the
    caller assembles as with host_compress_framed: all-gather the
    lengths (the one collective), exclusive-scan offsets, pwrite
    disjoint ranges.  Returns (bodies, lengths).

    rows: uint8[B, 65536], a ``ShardedRows`` (as
    host_decompress_framed_to_device returns) or a tensor, laid out over
    ``mesh`` (default: the rows' own mesh, else ``make_mesh()``); lens:
    valid bytes per row.  Rows in, records out, byte-identical to the
    host-bytes path."""
    from snappy_tpu_torch.dist import mesh as dmesh

    if mesh is None:
        mesh = (rows.mesh if isinstance(rows, dmesh.ShardedRows)
                else dmesh.make_mesh())
    bodies = dmesh.sharded_encode_rows_to_chunks(mesh, rows, lens)
    lengths = np.array([len(b) for b in bodies], dtype=np.int64)
    return bodies, lengths


def _world() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def gather_lengths(local_lengths: np.ndarray) -> np.ndarray:
    """All-gather per-chunk record lengths across processes (the single
    collective of the codec).  Without a process group, or with one
    process: the identity.

    Processes own different chunk counts (balanced within one) and
    ``all_gather`` needs one shape, so the counts go first and the
    lengths follow padded to the largest count: two gloo all-gathers of
    CPU int64 tensors."""
    if _world() == 1:
        return local_lengths
    import torch
    import torch.distributed as dist

    n = _world()
    local = torch.from_numpy(np.asarray(local_lengths, dtype=np.int64).copy())
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(counts, torch.tensor([len(local)], dtype=torch.int64))
    counts = [int(c) for c in counts]
    padded = torch.zeros(max(1, *counts), dtype=torch.int64)
    padded[: len(local)] = local
    gathered = [torch.zeros_like(padded) for _ in range(n)]
    dist.all_gather(gathered, padded)
    return np.concatenate([g[:c].numpy() for g, c in zip(gathered, counts)])


def host_compress_framed(data_local: bytes, chunk_start: int,
                         chunk_size: int = MAX_CHUNK_UNCOMPRESSED,
                         device=None):
    """Compress this host's chunk range on ``device`` (the card by
    default); returns (bodies, lengths) where bodies[i] is the full
    framed chunk record (header, CRC and payload) of global chunk
    chunk_start + i.

    The caller all-gathers lengths, computes offsets with an exclusive
    scan, and writes bodies at offset 10 + sum(lengths of prior chunks)
    (10 = the stream-identifier chunk, written by host 0).  The records
    are those of ``compress_framed`` in the runtime's engine (id: the
    CRCs on the device, the native matcher on the host)."""
    from snappy_tpu_torch.dist.mesh import split_records
    from snappy_tpu_torch.runtime import device_codec
    from snappy_tpu_torch.spec.format import STREAM_ID_CHUNK

    fr = device_codec.compress_framed(data_local, chunk_size, device=device)
    bodies = split_records(fr, len(STREAM_ID_CHUNK))
    lengths = np.array([len(b) for b in bodies], dtype=np.int64)
    return bodies, lengths


# ---------------------------------------------------------------------
# CLI entry point (one process per host)

def _ensure_outfile(path: str, size: int, process_id: int) -> None:
    """Rank 0 sizes the output file, everyone meets at a barrier, then
    every rank idempotently re-ensures it locally (covers hosts without
    a shared filesystem).  Disjoint pwrite ranges make the parallel
    writes safe."""
    import os

    if process_id == 0:
        with open(path, "wb") as f:
            f.truncate(size)
    if _world() > 1:
        import torch.distributed as dist

        dist.barrier()
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        if os.fstat(fd).st_size < size:
            os.ftruncate(fd, size)
    finally:
        os.close(fd)


def _pwrite(path: str, pieces) -> None:
    """Write each (bytes, offset) of ``pieces`` into ``path``."""
    import os

    fd = os.open(path, os.O_RDWR)
    try:
        for blob, off in pieces:
            if blob:
                os.pwrite(fd, blob, off)
    finally:
        os.close(fd)


def main(argv=None) -> int:
    import argparse
    import json
    import time

    import torch

    from snappy_tpu_torch.device import resolve
    from snappy_tpu_torch.dist.mesh import init_distributed
    from snappy_tpu_torch.spec.format import STREAM_ID_CHUNK

    p = argparse.ArgumentParser(
        prog="python -m snappy_tpu_torch.dist.multihost",
        description="Multi-host data-parallel framed snappy codec: run "
        "one process per host; each owns a contiguous chunk range and "
        "writes it into OUT at its global offset.",
    )
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="torch.distributed rendezvous address "
                        "(required when --num-processes > 1)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--chunk-size", type=int, default=MAX_CHUNK_UNCOMPRESSED)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: the current card), cuda:N, or "
                        "cpu (the kernels' plain versions)")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds the rendezvous and each collective may "
                        "wait for a peer")
    p.add_argument("--no-verify", action="store_true",
                   help="skip CRC verification on decompress")
    p.add_argument("command", choices=("compress", "decompress"))
    p.add_argument("infile")
    p.add_argument("outfile")
    args = p.parse_args(argv)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        p.error(f"--device {args.device}: no CUDA device visible to torch")
    try:
        dev = resolve(args.device)
    except (RuntimeError, ValueError) as e:
        p.error(f"--device {args.device}: {e}")
    if args.num_processes > 1:
        if not args.coordinator:
            p.error("--coordinator is required when --num-processes > 1")
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, timeout=args.timeout)
    try:
        pid, nproc = args.process_id, args.num_processes
        with open(args.infile, "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        if args.command == "compress":
            start, cnt = plan_ranges(len(data), nproc, args.chunk_size)[pid]
            lo = start * args.chunk_size
            hi = min(len(data), (start + cnt) * args.chunk_size)
            bodies, lengths = host_compress_framed(
                data[lo:hi], start, args.chunk_size, device=dev)
            t1 = time.perf_counter()
            all_lengths = gather_lengths(lengths)
            gather_s = time.perf_counter() - t1
            blob = b"".join(bodies)
            off = len(STREAM_ID_CHUNK) + int(all_lengths[:start].sum())
            total_out = len(STREAM_ID_CHUNK) + int(all_lengths.sum())
            _ensure_outfile(args.outfile, total_out, pid)
            _pwrite(args.outfile, [(STREAM_ID_CHUNK if pid == 0 else b"", 0),
                                   (blob, off)])
            dt = time.perf_counter() - t0
            stats = {
                "host": pid, "command": "compress", "chunks": cnt,
                "bytes_in": hi - lo, "bytes_out": len(blob),
                "seconds": round(dt, 4),
                "gbs": round((hi - lo) / 1e9 / dt, 4) if dt > 0 else None,
                "gather_seconds": round(gather_s, 6),
            }
        else:
            base, blob, total, stats = host_decompress_framed(
                data, pid, nproc, verify_checksums=not args.no_verify,
                device=dev)
            _ensure_outfile(args.outfile, total, pid)
            _pwrite(args.outfile, [(blob, base)])
            stats = dict(stats, command="decompress")
        print(json.dumps(dict(stats, device=str(dev))), flush=True)
    finally:
        if _world() > 1:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
