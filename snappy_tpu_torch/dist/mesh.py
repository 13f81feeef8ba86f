"""Mesh construction and the sharded batch codec on PyTorch (several
devices of one process, and the multi-host entry points' local part).

Counterpart of ``snappy_tpu/dist/mesh.py``.  JAX lays a batch out over
a 1-D mesh with ``NamedSharding(mesh, P("d"))`` and lets ``shard_map``
run each device's part; here the layout is explicit:

  - ``Mesh`` is a tuple of ``torch.device``s, in shard order.
  - ``ShardedRows`` holds a batch cut on its first axis: shard k is rows
    ``[k*B/n, (k+1)*B/n)`` of the batch, padded to a multiple of the mesh
    size with zero rows, on ``mesh.devices[k]``, as ``P("d")`` lays them
    out.  The sharded forms return it where JAX returns a sharded array.
  - Each form runs its shard's work on the shard's device through the
    port's kernel wrappers (``crc32c_chunks``, ``decode_blocks_flat``,
    ``find_candidates``) or its parallel codec in torch ops
    (``encode_par.encode_blocks``, ``decode_par.decode_blocks``), which
    run on the tensor's device: a shard on ``cuda:1`` runs on
    ``cuda:1``, a shard on the CPU runs the plain versions.  Shards are
    independent chunks, so no form but ``roundtrip_step`` combines
    shards; per-block lengths come back to the host and outputs are
    assembled in block order, never in device order.
  - ``roundtrip_step`` has the one cross-shard result: the exclusive
    scan of the compressed lengths and the all-shards match flag, for
    which the per-shard lengths and flags go to the mesh's first device.
  - The from-device encode forms are the runtime's
    ``compress_framed_from_device`` of a ``ShardedRows`` and its rows'
    lengths: each shard goes through the engine's single-card path on its
    own device (``framed_parts`` cuts the shards into its inputs;
    ``SHARDS`` counts each mesh position's copies and CRC launches).
  - Without the native library the loader's id stager decodes each chunk
    on the host (``device_codec.stage_id_rows``), the from-device encode
    forms take the sequential encoder's element (``encode_blocks_seq``,
    the seq engine's path), and the flat and id stagers raise, as the
    JAX package's need its library too.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch

from snappy_tpu_torch import native
from snappy_tpu_torch.device import resolve
from snappy_tpu_torch.errors import ChecksumError
from snappy_tpu_torch.kernels import decode_par as _dpar
from snappy_tpu_torch.kernels import encode_par as _epar
from snappy_tpu_torch.kernels import match as _match
from snappy_tpu_torch.kernels.crc32c import CHUNK, crc32c_chunks
from snappy_tpu_torch.kernels.decode_flat import (
    TRIP_CAP,
    decode_blocks_flat,
    mirror_base_for,
    rows_b_for,
)
from snappy_tpu_torch.kernels.encode_flat import (
    ENC_TRIP_CAP,
    RB_ENC,
    TAG_ROWS,
    encode_blocks_flat,
)
from snappy_tpu_torch.runtime.device_codec import (
    _ID_ROWS,
    _native,
    _scan_frames,
    stage_id_rows,
)
from snappy_tpu_torch.spec.format import (
    STREAM_ID_CHUNK,
    read_uvarint,
    unmask_crc,
)

__all__ = [
    "Mesh",
    "ShardedRows",
    "make_mesh",
    "init_distributed",
    "shard_rows",
    "sharded_encode",
    "sharded_decode",
    "roundtrip_step",
    "sharded_decode_flat",
    "sharded_encode_flat",
    "sharded_decode_id",
    "sharded_decompress_framed_to_device",
    "sharded_compress_framed_from_device",
    "sharded_encode_rows_to_chunks",
    "framed_parts",
    "split_records",
    "SHARDS",
    "sharded_crc",
    "sharded_match",
    "stage_flat_dec_batch",
    "stage_flat_enc_batch",
    "stage_dec_id_batch",
]

ERR_CRC = 100  # the error code of a row whose device CRC-32C mismatched


class Mesh:
    """A 1-D mesh ("d"): the devices that hold a batch's shards, in
    shard order.  A device may appear more than once; each appearance
    holds its own shard."""

    def __init__(self, devices):
        self.devices = tuple(resolve(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over ``devices``, or over the local cards ``cuda:0 ..
    cuda:{n-1}`` (the first ``n_devices`` of them when given).  With no
    ``devices`` and no card, or fewer cards than ``n_devices``, it
    raises: it never falls back to the CPU.

    ``devices`` may name any devices, repeats included: ``["cpu"] * 8``
    is the 8-shard mesh the tests run on the CPU, and ``["cuda:0"] * 2``
    is a real two-shard split on a machine with one card (repeats exist
    because the H100 machine this port is measured on has one card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device visible to torch; pass devices= "
                "to build a mesh of other devices (e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if n_devices > len(devices):
                raise RuntimeError(f"make_mesh: {n_devices} cards asked "
                                   f"for, {len(devices)} visible")
            devices = devices[:n_devices]
    return Mesh(devices)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout: float = 300.0,
) -> None:
    """Multi-host runtime init: one ``torch.distributed`` process group
    over gloo, its rendezvous at ``tcp://coordinator_address`` (or the
    ``MASTER_ADDR`` / ``MASTER_PORT`` environment when None).  Call once
    per process.  ``timeout`` (seconds) bounds the rendezvous and every
    collective, so a lost peer fails instead of hanging.

    Gloo, not NCCL: the codec's one collective moves host int64 lengths
    (``multihost.gather_lengths``), and NCCL refuses two ranks on one
    GPU, which is how several processes share a one-card machine."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo",
        init_method=("env://" if coordinator_address is None
                     else f"tcp://{coordinator_address}"),
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=timedelta(seconds=timeout),
    )


def _pad_to_mesh(mesh: Mesh, *arrays):
    """Pad the batch axis to a multiple of the mesh size (padding rows are
    zero-length blocks, which the kernels treat as empty)."""
    n = mesh.size
    b = arrays[0].shape[0]
    rem = (-b) % n
    if rem == 0:
        return arrays, b
    padded = tuple(
        np.concatenate([a, np.zeros((rem,) + a.shape[1:], a.dtype)]) for a in arrays
    )
    return padded, b


class ShardedRows:
    """A batch cut on its first axis over ``mesh``: ``shards[k]`` holds
    rows ``[k*B/n, (k+1)*B/n)`` on ``mesh.devices[k]`` (``B`` a multiple
    of the mesh size)."""

    def __init__(self, mesh: Mesh, shards):
        self.mesh = mesh
        self.shards = tuple(shards)
        if len(self.shards) != mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{mesh.size}")
        first = self.shards[0]
        for s, dev in zip(self.shards, mesh.devices):
            if s.device != dev or s.shape != first.shape or s.dtype != first.dtype:
                raise ValueError("shards must have one shape and dtype and "
                                 "lie on their mesh devices")

    @property
    def shape(self) -> tuple:
        s = self.shards[0].shape
        return (s[0] * len(self.shards),) + tuple(s[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def cpu(self) -> torch.Tensor:
        """The whole batch on the host: the shards joined in index order."""
        return torch.cat([s.cpu() for s in self.shards])

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def shard_rows(mesh: Mesh, rows) -> ShardedRows:
    """``rows`` (a numpy array, a tensor or a ``ShardedRows``) laid out
    over ``mesh`` as ``P("d")``: the counterpart of ``jax.device_put(rows,
    NamedSharding(mesh, P("d")))``.  Rows already laid out so come back
    as they are; rows that already lie on a shard's device are not
    copied.  The row count must be a multiple of the mesh size."""
    if isinstance(rows, ShardedRows):
        if rows.mesh.devices == mesh.devices:
            return rows
        pieces = rows.shards
    else:
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(np.ascontiguousarray(rows))
        pieces = (rows,)
    total = sum(p.shape[0] for p in pieces)
    if total % mesh.size:
        raise ValueError(f"{total} rows do not split over a mesh of "
                         f"{mesh.size}")
    per = total // mesh.size
    shards = []
    for k, dev in enumerate(mesh.devices):
        lo, hi, start, parts = k * per, (k + 1) * per, 0, []
        for p in pieces:
            a, b = max(lo - start, 0), min(hi - start, p.shape[0])
            if a < b:
                parts.append(p[a:b].to(dev))
            start += p.shape[0]
        if not parts:  # an empty batch
            parts = [pieces[0][:0].to(dev)]
        shards.append(parts[0] if len(parts) == 1 else torch.cat(parts))
    return ShardedRows(mesh, shards)


def _shards(mesh: Mesh, *arrays):
    """Per shard, the tuple of each array's shard."""
    return zip(*(shard_rows(mesh, a).shards for a in arrays))


def _host(parts, b: int) -> np.ndarray:
    """Per-shard device results joined in shard order on the host,
    without the padding rows."""
    return np.concatenate([p.cpu().numpy() for p in parts])[:b]


def _crc_flags(rows, dlens, want) -> torch.Tensor:
    """int32 per row: ERR_CRC where the CRC-32C of the row's first
    ``dlens`` bytes is not ``want`` (int64), else 0; rows of length 0
    (padding) are exempt."""
    crc = crc32c_chunks(rows, dlens)
    bad = (crc != want) & (dlens > 0)
    return torch.where(bad, ERR_CRC, 0).to(torch.int32)


def _threads() -> int:
    return min(4, os.cpu_count() or 1)


def _check_rows(rc: np.ndarray, what: str | None = None) -> None:
    """Raise for the first row a native batch stager rejected: a
    ``what`` row past the flat plan caps (-5) ValueError, else the
    native error."""
    for i in np.nonzero(rc < 0)[0]:
        if what and rc[i] == -5:
            raise ValueError(f"{what} {i} overflows the flat plan caps")
        native._raise(int(rc[i]))


def _elements(elems: list[bytes]):
    """(concatenated buffer, offsets, lengths, header lengths, decoded
    lengths) of raw elements, as the native batch stagers take them."""
    _native()
    heads = [read_uvarint(e, 0) for e in elems]
    lens = np.array([len(e) for e in elems], np.int64)
    buf = np.frombuffer(b"".join(elems), np.uint8)
    dlens = np.array([d for d, _ in heads], np.int64)
    hdrs = np.array([h for _, h in heads], np.int64)
    return buf, np.cumsum(lens) - lens, lens, hdrs, dlens


def sharded_encode(mesh: Mesh, blocks: np.ndarray, lens: np.ndarray,
                   bmax: int):
    """The parallel encoder (``encode_par``) data-parallel over the mesh:
    a [B, bmax] batch, padded to a mesh multiple, each shard encoded on
    its device with no collective.  Returns host numpy (comp, comp_len,
    ok)."""
    (blocks, lens), b = _pad_to_mesh(mesh, blocks, lens)
    res = [_epar.encode_blocks(blk, ln, bmax=bmax)
           for blk, ln in _shards(mesh, blocks, lens)]
    return tuple(_host([r[i] for r in res], b) for i in range(3))


def sharded_decode(mesh: Mesh, comp: np.ndarray, start: np.ndarray,
                   comp_len: np.ndarray, dst_len: np.ndarray, out_max: int):
    """The parallel decoder (``decode_par``) data-parallel over the mesh:
    a padded compressed batch, each shard decoded on its device with no
    collective.  Returns host numpy (out [B, out_max], err [B])."""
    (comp, start, comp_len, dst_len), b = _pad_to_mesh(
        mesh, comp, start, comp_len, dst_len)
    res = [_dpar.decode_blocks(*parts, out_max=out_max)
           for parts in _shards(mesh, comp, start, comp_len, dst_len)]
    return _host([o for o, _ in res], b), _host([e for _, e in res], b)


def roundtrip_step(mesh: Mesh, blocks, lens, bmax: int):
    """The encode -> scan -> decode pipeline over the mesh
    (``_roundtrip_jit``'s step): each shard's device encodes its blocks
    in parallel, decodes the element streams it produced and checks them
    against its blocks.  The per-shard compressed lengths and match flags
    then go to the mesh's first device, where the exclusive scan of the
    lengths (the offsets a framed assembler uses) and the all-shards
    match flag are computed.  ``blocks`` [B, bmax] and ``lens`` [B], B a
    mesh multiple.

    Returns (comp, clen, ok, offsets, out, err, match): comp, clen, ok,
    out and err as ``ShardedRows`` over the mesh, offsets an int32 [B]
    tensor and match a bool scalar tensor on the first device."""
    blocks, lens = shard_rows(mesh, blocks), shard_rows(mesh, lens)
    parts = []
    for blk, ln in zip(blocks.shards, lens.shards):
        ln = ln.to(torch.int32)
        comp, clen, ok = _epar.encode_blocks(blk, ln, bmax=bmax)
        out, err = _dpar.decode_blocks(comp, torch.zeros_like(clen), clen,
                                       ln, out_max=bmax)
        inside = (torch.arange(bmax, device=blk.device)[None, :]
                  < ln[:, None])
        match = torch.where(inside, out == blk, True).all()
        parts.append((comp, clen, ok, out, err, match))
    first = mesh.devices[0]
    clen_all = torch.cat([p[1].to(first) for p in parts])
    offsets = torch.cumsum(clen_all, 0).to(torch.int32) - clen_all
    match = torch.stack([p[5].to(first) for p in parts]).all()

    def sharded(i):
        return ShardedRows(mesh, [p[i] for p in parts])

    return (sharded(0), sharded(1), sharded(2), offsets, sharded(3),
            sharded(4), match)


def stage_flat_dec_batch(elems: list[bytes], cmax: int | None = None):
    """Host half of the flat decode engine for a block batch: the
    threaded native stager plans each element and assembles its B row.
    Returns (b_u8, meta, fstarts, ntrips, dst_lens, want_crc) ready for
    sharded_decode_flat; want_crc is the CRC-32C of each staged output
    image (in production it rides the chunk header).  Raises ValueError
    when an element overflows the flat caps."""
    B = len(elems)
    cmax = cmax or max((len(e) for e in elems), default=1)
    rb = rows_b_for(cmax)
    b_u8 = np.zeros((B, rb * 128), np.uint8)
    meta = np.zeros((B, 8 * TRIP_CAP, 128), np.int32)
    fstarts = np.zeros((B, 8, 128), np.int32)
    rc = np.zeros(B, np.int64)
    dlens = np.zeros(B, np.int64)
    if B:
        buf, offs, lens, hdrs, dlens = _elements(elems)
        native.stage_flat_dec_batch(buf, offs, lens, hdrs, dlens, rb, meta,
                                    fstarts, b_u8, rc, n_threads=_threads())
        _check_rows(rc, "element")
    want = np.zeros(B, np.uint32)
    for i, e in enumerate(elems):
        mb = mirror_base_for(len(e))
        want[i] = native.crc32c(b_u8[i, mb : mb + dlens[i]].tobytes())
    return (b_u8, meta, fstarts, rc.astype(np.int32), dlens.astype(np.int32),
            want)


def stage_flat_enc_batch(blocks: list[bytes]):
    """Host half of the flat encode engine for a block batch (the
    matcher is the planning pass).  Returns (b_u8, meta, fstarts,
    ntrips, clens, hdrs, elems) where elems are the host emissions the
    device replay must equal byte for byte."""
    nat = _native()
    B = len(blocks)
    bmax = max((len(b) for b in blocks), default=1) or 1
    arr = np.zeros((B, bmax), np.uint8)
    for i, blk in enumerate(blocks):
        arr[i, : len(blk)] = np.frombuffer(blk, np.uint8)
    lens = np.array([len(b) for b in blocks], np.int64)
    b_u8 = np.zeros((B, RB_ENC * 128), np.uint8)
    meta = np.zeros((B, 8 * ENC_TRIP_CAP, 128), np.int32)
    fstarts = np.zeros((B, 8, 128), np.int32)
    elem = np.empty((B, nat.max_compressed_length(bmax) + 8), np.uint8)
    clens, hdrs, rc = (np.zeros(B, np.int64) for _ in range(3))
    if B:
        nat.stage_flat_enc_batch(arr, lens, RB_ENC, meta, fstarts, b_u8,
                                 TAG_ROWS * 128, elem, clens, hdrs, rc,
                                 n_threads=_threads())
        _check_rows(rc, "block")
    elems = [elem[i, : clens[i]].tobytes() for i in range(B)]
    return (b_u8, meta, fstarts, rc.astype(np.int32), clens.astype(np.int32),
            hdrs.astype(np.int32), elems)


def _cut_trips(meta: np.ndarray, ntrips: np.ndarray) -> np.ndarray:
    """The meta panel cut to the trips some row runs: the executor reads
    no trip past a row's count, so the rest of the cap need not move."""
    t = max(1, int((ntrips & 0xFFFF).max(initial=0)))
    return meta[:, : 8 * min(t, meta.shape[1] // 8)]


def sharded_decode_flat(
    mesh: Mesh,
    b_u8: np.ndarray,
    meta: np.ndarray,
    fstarts: np.ndarray,
    ntrips: np.ndarray,
    dst_lens: np.ndarray,
    want_crc: np.ndarray,
    out_max: int,
):
    """The flat decode engine data-parallel over the mesh: host-staged
    plans are cut on the block axis, and each shard's device runs the
    flat executor and, for 64 KiB rows, the CRC-32C of its rows, with no
    collective.  b_u8: uint8[B, rb*128] staged rows (stage_flat_dec_batch);
    padding rows (a batch that is not a mesh multiple) carry empty plans
    and dst_len 0.  Returns host (out[B, out_max], err[B]) where err 100
    marks a CRC mismatch."""
    use_crc = out_max == CHUNK  # the CRC is of whole 64 KiB rows
    (b_u8, meta, fstarts, ntrips, dst_lens, want), b = _pad_to_mesh(
        mesh, b_u8, _cut_trips(meta, ntrips), fstarts, ntrips, dst_lens,
        want_crc.astype(np.int64))
    outs, errs = [], []
    for bu, me, fs, nt, dl, w in _shards(mesh, b_u8, meta, fstarts, ntrips,
                                         dst_lens, want):
        out = decode_blocks_flat(bu, me, fs, nt, dst_max=out_max)
        outs.append(out)
        errs.append(_crc_flags(out, dl, w) if use_crc
                    else torch.zeros_like(dl))
    return _host(outs, b), _host(errs, b)


def sharded_encode_flat(
    mesh: Mesh,
    b_u8: np.ndarray,
    meta: np.ndarray,
    fstarts: np.ndarray,
    ntrips: np.ndarray,
):
    """The flat encode engine data-parallel over the mesh: each shard's
    device emits its blocks' compressed elements from host-staged plans
    (stage_flat_enc_batch), with no collective.  Returns host
    uint8[B, OUT_ROWS_ENC*128] emissions (callers slice with the
    planner's clens)."""
    (b_u8, meta, fstarts, ntrips), b = _pad_to_mesh(
        mesh, b_u8, _cut_trips(meta, ntrips), fstarts, ntrips)
    return _host([encode_blocks_flat(*parts) for parts in
                  _shards(mesh, b_u8, meta, fstarts, ntrips)], b)


def stage_dec_id_batch(elems: list[bytes]):
    """Host half of the id engine for a block batch: the threaded native
    walk validates each element and decodes it straight into its
    staging row.  Returns (b_u8, dst_lens, want_crc); in production the
    expected CRC rides the chunk header, here it is computed from the
    staged image."""
    B = len(elems)
    b_u8 = np.zeros((B, _ID_ROWS * 128), np.uint8)
    dlens = np.zeros(B, np.int64)
    if B:
        buf, offs, lens, hdrs, dlens = _elements(elems)
        rc = np.zeros(B, np.int64)
        native.stage_flat_dec_id_batch(buf, offs, lens, hdrs, dlens,
                                       _ID_ROWS, b_u8, rc,
                                       n_threads=_threads())
        _check_rows(rc)
    want = np.array([native.crc32c(b_u8[i, : dlens[i]].tobytes())
                     for i in range(B)], np.uint32)
    return b_u8, dlens.astype(np.int32), want


def _id_local(panel, dlens, want, with_crc: bool = True):
    """One shard of the id engine: the 64 KiB images of its staged
    520-row panels, and their CRC flags."""
    out = panel[:, :CHUNK].contiguous()
    flags = _crc_flags(out, dlens, want) if with_crc else None
    return out, flags


def sharded_decode_id(
    mesh: Mesh,
    b_u8: np.ndarray,
    dst_lens: np.ndarray,
    want_crc: np.ndarray,
):
    """The id decode engine data-parallel over the mesh: each shard's
    device takes the 64 KiB images of its staged rows and checks each
    row's CRC-32C, with no collective.  Padding rows carry dst_len 0 and
    are CRC-exempt.  Returns host (out[B, 65536], err[B]) where err 100
    marks a CRC mismatch."""
    (b_u8, dst_lens, want), b = _pad_to_mesh(
        mesh, b_u8, dst_lens, want_crc.astype(np.int64))
    res = [_id_local(*parts) for parts in _shards(mesh, b_u8, dst_lens, want)]
    return _host([o for o, _ in res], b), _host([e for _, e in res], b)


def sharded_decompress_framed_to_device(
    mesh: Mesh, data: bytes, verify_checksums: bool = True,
    chunk_range: tuple[int, int] | None = None,
):
    """Stream-level data-loader entry (the id engine over the mesh):
    scan a framed stream, id-stage every chunk on the host (threaded
    native walk), and land the decompressed bytes sharded over the mesh,
    one 64 KiB image row per chunk, each chunk's CRC-32C checked on its
    shard's device with no collective.  Only the error flags come back;
    the rows stay on the devices.

    Returns (rows, dst_lens, b): rows is a ``ShardedRows`` of
    uint8[B_padded, 65536], dst_lens int32[b] each row's valid byte
    count, b the real chunk count.  The single-device flattening form
    is ``runtime.device_codec.decompress_framed_to_device``.
    ``chunk_range=(lo, cnt)`` stages only that chunk range: the
    multi-host loader gives each process its own."""
    chunks, _total = _scan_frames(data)
    if chunk_range is not None:  # multi-host: this process's range only
        lo, cnt = chunk_range
        chunks = chunks[lo:lo + cnt]
    src_arr = np.frombuffer(data, np.uint8)
    B = len(chunks)
    b_u8 = np.zeros((max(B, 1), _ID_ROWS * 128), np.uint8)
    dlens = np.zeros(max(B, 1), np.int32)
    want = np.zeros(max(B, 1), np.int64)
    stage_id_rows(src_arr, chunks, b_u8, dlens)
    want[:B] = [unmask_crc(ch[3]) for ch in chunks]
    (b_u8, dlens_p, want), b = _pad_to_mesh(mesh, b_u8, dlens, want)
    res = [_id_local(*parts, with_crc=verify_checksums)
           for parts in _shards(mesh, b_u8, dlens_p, want)]
    if verify_checksums:
        err = _host([e for _, e in res], B)  # tiny copy; the rows stay put
        for i in np.nonzero(err == ERR_CRC)[0]:
            raise ChecksumError(chunks[int(i)][3], None)
    return ShardedRows(mesh, [o for o, _ in res]), dlens[:B], min(B, b)


# per position in a mesh, over the process: the bytes each shard's card
# copied to the host and the CRC launches made on it, by the sharded
# from-device encode (``framed_parts``' tallies); the lists grow to the
# widest mesh that encoded
SHARDS = {"d2h_bytes": [], "crc_launches": []}


def _tally(k: int):
    """The counter of mesh position ``k``: ``tally(d2h_bytes,
    crc_launches)`` adds to ``SHARDS``."""
    def tally(d2h_bytes: int, crc_launches: int) -> None:
        SHARDS["d2h_bytes"][k] += d2h_bytes
        SHARDS["crc_launches"][k] += crc_launches
    return tally


def framed_parts(rows: ShardedRows, lens):
    """The pieces of the sharded from-device encode: (parts, total).

    ``rows`` is a ``ShardedRows`` of uint8 [B, 65536] and ``lens`` the
    valid bytes of rows [:len(lens)]; the rest are padding.  Each shard's
    real rows are cut into runs that end at a row shorter than a chunk,
    so that every row of a run but its last is a full chunk and the
    run's bytes, its rows joined, are its rows' chunks.  A part is
    (device, flat, tally): the run's bytes as one flat view of the shard
    (no copy), the shard's device, and the counter of its mesh position
    in ``SHARDS``.  Parts come in row order; a row of length 0 gives no
    chunk.  ``total`` is the bytes of every row."""
    if not isinstance(rows, ShardedRows):
        raise ValueError(f"sharded rows must be a ShardedRows, got "
                         f"{type(rows).__name__}")
    lens = np.asarray(lens, np.int64).reshape(-1)
    B, b = rows.shape[0], lens.size
    if (rows.dtype != torch.uint8 or len(rows.shape) != 2
            or rows.shape[1] != CHUNK or b > B):
        raise ValueError(f"rows must be uint8 [B, {CHUNK}] with B >= {b}, "
                         f"got {rows.dtype} {tuple(rows.shape)}")
    if b and (lens.min() < 0 or lens.max() > CHUNK):
        raise ValueError(f"row lengths must lie in [0, {CHUNK}]")
    for counts in SHARDS.values():
        counts.extend([0] * (rows.mesh.size - len(counts)))
    per = B // rows.mesh.size
    parts = []
    for k, (shard, dev) in enumerate(zip(rows.shards, rows.mesh.devices)):
        ln = lens[k * per : min((k + 1) * per, b)]
        tally = _tally(k)
        start = 0
        for end in list(np.nonzero(ln < CHUNK)[0] + 1) + [ln.size]:
            nb = int(ln[start:end].sum())
            if nb:
                parts.append((dev, shard[start:end].reshape(-1)[:nb], tally))
            start = end
    return parts, int(lens.sum())


def split_records(stream: bytes, pos: int = 0) -> list[bytes]:
    """The chunk records of a framed stream from ``pos`` on (header,
    masked CRC and payload each)."""
    recs = []
    while pos < len(stream):
        end = pos + 4 + int.from_bytes(stream[pos + 1 : pos + 4], "little")
        recs.append(stream[pos:end])
        pos = end
    return recs


def sharded_compress_framed_from_device(mesh: Mesh, rows, lens) -> bytes:
    """Stream-level from-device encode over the mesh (the encode half of
    the data loader; sharded_decompress_framed_to_device's (rows,
    dst_lens, b) go straight in): chunk rows lying sharded on the
    devices become one framed stream, through the runtime's
    ``compress_framed_from_device`` of the rows and their lengths.  Each
    shard is encoded on its own device, each chunk's CRC-32C there with
    no collective; assembly is in chunk order.

    rows: uint8[B, 65536] (a ``ShardedRows``, laid out again over
    ``mesh`` if it is on another, or a tensor or array; B a mesh
    multiple, as the loader returns).  lens: int[b] valid bytes per
    row, b <= B; rows past b are padding and emit nothing.
    Byte-identical to compress_framed of the rows' bytes."""
    from snappy_tpu_torch.runtime.device_codec import (
        compress_framed_from_device,
    )

    return compress_framed_from_device(shard_rows(mesh, rows), lens)


def sharded_encode_rows_to_chunks(mesh: Mesh, rows, lens) -> list[bytes]:
    """From-device encode to per-chunk framed records (header, masked
    CRC and payload; no stream identifier): the composable form, one
    entry a row of ``lens`` (b"" for a row of length 0).
    sharded_compress_framed_from_device prepends the stream identifier
    for a whole stream; multihost.host_compress_framed_from_device
    all-gathers the record lengths and writes records at global
    offsets."""
    recs = iter(split_records(sharded_compress_framed_from_device(
        mesh, rows, lens), len(STREAM_ID_CHUNK)))
    return [next(recs) if ln else b"" for ln in np.asarray(lens).reshape(-1)]


def sharded_crc(mesh: Mesh, blocks: np.ndarray, lens: np.ndarray):
    """Encode-side device work of the id engine: the CRC-32C of each
    uncompressed block (uint8[B, 65536]) on its shard's device, no
    collective.  Returns host uint32[B]."""
    (blocks, lens), b = _pad_to_mesh(mesh, blocks, lens)
    return _host([crc32c_chunks(*parts) for parts in
                  _shards(mesh, blocks, lens)], b).astype(np.uint32)


def sharded_match(mesh: Mesh, blocks: list[bytes],
                  slots: int = 4096) -> np.ndarray:
    """Device match finder data-parallel over the mesh: each shard's
    device sorts its blocks' (v-word, position) panels (``kernels.match``,
    ``home=False``) and ships the sorted (position, packed) pairs; the
    host scatters them home.  No collective: candidate search is per
    block.  Returns int32[B, slots] packed candidates."""
    w_i32, npos = _match.stage_words(blocks, slots)
    (w_i32, npos), b = _pad_to_mesh(mesh, w_i32, npos)
    pairs = [_match.find_candidates(w, n, home=False)
             for w, n in _shards(mesh, w_i32, npos)]
    return _match.scatter_home(_host(pairs, b))
