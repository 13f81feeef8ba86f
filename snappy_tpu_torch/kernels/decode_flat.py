"""Flat-plan executor: the CUDA kernel, its plain version, and the
JAX-free plan helpers.

Counterpart of ``snappy_tpu/kernels/decode_flat.py``.  The host (the
shared native stagers) resolves every output byte of a block to a
dependency-free source and packs the pieces into trips; the device
runs the plan.  The contract is the JAX package's ``execute_flat_np``
(copied here): each valid piece copies ``lenm1 + 1 <= 128`` bytes from
``B[(S + qrel) * 128 + phi + l]`` to ``out[(D + drel) * 128 + l]``.

``decode_blocks_flat`` launches ``csrc/flat_exec.cu`` on a CUDA tensor
and runs the plain torch gather/scatter on a CPU tensor.  The kernel
takes the uint8 B buffer as staged (no int32 pre-cast) and builds each
8 KiB slab of an output row in shared memory, written out once (zeros
where no piece writes).
"""

from __future__ import annotations

import numpy as np
import torch

VEC = 128
NSUB = 4             # subpanels per trip
PANEL = NSUB * VEC   # pieces per trip
W_ROWS = 128         # source window rows per subpanel
PAT_ROWS = 512       # mirror rows: a full 64 KiB output image
OUT_ROWS = 520       # 64 KiB output + slack, multiple of 8
TRIP_CAP = 48        # trips per block (host fallback past this)
DIRECT_T = 4096      # planner threshold for direct payload gathers

# B-word valid bit: pad lanes have it clear and write nothing
_VALID = 1 << 21

# kernel launches made by decode_blocks_flat (one per CUDA call)
launches = 0


def rows_b_for(cmax: int) -> int:
    """Rows of the B buffer for a compressed row width: one zero pad row
    + payload rows + mirror + one guard row, rounded to 8 rows."""
    r = 1 + (cmax + VEC - 1) // VEC + PAT_ROWS + 1
    return (r + 7) & ~7


def mirror_base_for(clen: int) -> int:
    """B byte address of mirror[0]: first row boundary past the payload."""
    return (VEC + clen + VEC - 1) & ~(VEC - 1)


def execute_flat_np(meta: np.ndarray, starts: np.ndarray, n_trips: int,
                    b_bytes: np.ndarray, dst_len: int,
                    out_rows: int = OUT_ROWS) -> np.ndarray:
    """Numpy contract: replay a packed plan piece by piece (disjoint
    writes).  n_trips may carry the aligned-trip count in its high bits."""
    out = np.zeros(out_rows * VEC, dtype=np.uint8)
    for t in range(n_trips & 0xFFFF):
        for s in range(NSUB):
            w = int(starts[t >> 5, (t & 31) * 4 + s])
            S = w & 1023
            Dq = (w >> 10) & 1023
            # clamp the compose window to the panel; drel shifts by the
            # clamp amount
            D = min(Dq, out_rows - VEC)
            for k in range(VEC):
                a = int(meta[2 * NSUB * t + s, k])
                bw = int(meta[2 * NSUB * t + NSUB + s, k])
                if not (bw & _VALID):
                    continue
                qrel = a & 127
                rot = (a >> 7) & 127
                dphi = bw & 127
                lnm1 = (bw >> 7) & 127
                drel = ((bw >> 14) & 127) + (Dq - D)
                phi = (VEC - rot) & (VEC - 1)
                base = (S + qrel) * VEC + phi
                for l in range(dphi, dphi + lnm1 + 1):
                    out[(D + drel) * VEC + l] = b_bytes[base + l]
    return out[:dst_len]


def plan_from_numpy(b_u8: np.ndarray, meta: np.ndarray, starts: np.ndarray,
                    ntrips: np.ndarray, device) -> tuple[torch.Tensor, ...]:
    """The port's tensors for a plan the shared native stagers filled:
    uint8 B ``[B, rb*128]``, int32 meta ``[B, 8*trip_cap, 128]``, int32
    starts ``[B, 8, 128]`` and int32 ntrips ``[B]`` on ``device``."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    nb = b_u8.shape[0]
    return (put(b_u8.reshape(nb, -1), np.uint8), put(meta, np.int32),
            put(starts, np.int32), put(ntrips, np.int32))


def _check_plan(b_u8, meta, starts, ntrips) -> None:
    nb = b_u8.shape[0]
    if b_u8.dtype != torch.uint8 or b_u8.dim() != 2:
        raise ValueError(f"B must be uint8 [B, rb*128], got {b_u8.dtype} "
                         f"{tuple(b_u8.shape)}")
    if (meta.dtype != torch.int32 or meta.dim() != 3
            or meta.shape[0] != nb or meta.shape[2] != VEC
            or meta.shape[1] % (2 * NSUB)):
        raise ValueError(f"meta must be int32 [B, 8*trip_cap, 128], got "
                         f"{meta.dtype} {tuple(meta.shape)}")
    if starts.dtype != torch.int32 or tuple(starts.shape) != (nb, 8, VEC):
        raise ValueError(f"starts must be int32 [B, 8, 128], got "
                         f"{starts.dtype} {tuple(starts.shape)}")
    if ntrips.dtype != torch.int32 or tuple(ntrips.shape) != (nb,):
        raise ValueError(f"ntrips must be int32 [B], got {ntrips.dtype} "
                         f"{tuple(ntrips.shape)}")
    if meta.shape[1] // (2 * NSUB) > 8 * VEC // NSUB:
        raise ValueError("trip_cap exceeds the starts-plane capacity")
    devs = {t.device for t in (b_u8, meta, starts, ntrips)}
    if len(devs) != 1:
        raise ValueError(f"plan tensors on several devices: {devs}")


def decode_blocks_flat_plain(b_u8, meta, starts, ntrips, dst_max: int,
                             out_rows: int = OUT_ROWS) -> torch.Tensor:
    """Plain torch version: one vectorised gather/scatter of every
    (piece, lane) pair the plan marks valid."""
    dev = b_u8.device
    nb, nbytes = b_u8.shape
    out = torch.zeros(nb, dst_max, dtype=torch.uint8, device=dev)
    trip_cap = meta.shape[1] // (2 * NSUB)
    n = (ntrips.to(torch.int64) & 0xFFFF).clamp(max=trip_cap)
    t_used = int(n.max()) if nb else 0
    if t_used == 0 or dst_max == 0:
        return out
    m = meta.to(torch.int64).reshape(nb, trip_cap, 2, NSUB, VEC)[:, :t_used]
    a_w, b_w = m[:, :, 0], m[:, :, 1]                     # [nb, T, 4, 128]
    # trip t subpanel s lives at starts[t >> 5, (t & 31) * 4 + s], i.e.
    # at flat index 4 * t + s of the [8 * 128] plane
    st = starts.to(torch.int64).reshape(nb, 8 * VEC)[:, : NSUB * t_used]
    st = st.reshape(nb, t_used, NSUB)
    S = st & 1023
    Dq = (st >> 10) & 1023
    D = Dq.clamp(max=out_rows - VEC)
    t_idx = torch.arange(t_used, device=dev)
    valid = ((b_w & _VALID) != 0) & (t_idx[None, :] < n[:, None])[..., None, None]
    qrel = a_w & 127
    rot = (a_w >> 7) & 127
    dphi = b_w & 127
    lnm1 = (b_w >> 7) & 127
    drel = ((b_w >> 14) & 127) + (Dq - D)[..., None]
    phi = (VEC - rot) & (VEC - 1)
    src0 = (S[..., None] + qrel) * VEC + phi
    dst0 = (D[..., None] + drel) * VEC
    lane = torch.arange(VEC, device=dev)
    sel = (valid[..., None] & (lane >= dphi[..., None])
           & (lane <= (dphi + lnm1)[..., None]))             # [nb, T, 4, 128, 128]
    src = (src0[..., None] + lane)[sel]
    dst = (dst0[..., None] + lane)[sel]
    row = torch.arange(nb, device=dev).reshape(nb, 1, 1, 1, 1).expand_as(sel)[sel]
    keep = dst < dst_max
    src, dst, row = src[keep], dst[keep], row[keep]
    inside = src < nbytes
    vals = b_u8.reshape(-1)[row * nbytes + src.clamp(max=nbytes - 1)]
    vals = torch.where(inside, vals, torch.zeros((), dtype=torch.uint8, device=dev))
    out.view(-1)[row * dst_max + dst] = vals
    return out


def decode_blocks_flat(b_u8, meta, starts, ntrips, dst_max: int,
                       out_rows: int = OUT_ROWS,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Execute packed flat plans; returns uint8 ``[B, dst_max]``.

    b_u8: uint8 ``[B, rb*128]`` as staged; meta: int32 ``[B,
    8*trip_cap, 128]``; starts: int32 ``[B, 8, 128]``; ntrips: int32
    ``[B]``.  ``out_rows`` sizes the compose panel (its clamp); bytes
    at or past ``dst_max`` are dropped.  ``out``, when given, is a uint8
    ``[B, dst_max]`` tensor (row stride free) that receives the result,
    so a caller can decode straight into a larger device buffer."""
    global launches
    _check_plan(b_u8, meta, starts, ntrips)
    nb = b_u8.shape[0]
    if out is not None and (out.dtype != torch.uint8
                            or tuple(out.shape) != (nb, dst_max)
                            or out.device != b_u8.device):
        raise ValueError(f"out must be uint8 [{nb}, {dst_max}] on "
                         f"{b_u8.device}")
    if b_u8.device.type == "cpu":
        res = decode_blocks_flat_plain(b_u8, meta, starts, ntrips, dst_max,
                                       out_rows)
        if out is None:
            return res
        out.copy_(res)
        return out
    if b_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {b_u8.device}")
    from snappy_tpu_torch.kernels import _build

    dev = b_u8.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return decode_blocks_flat(b_u8, meta, starts, ntrips, dst_max,
                                      out_rows, out)
    b_u8, meta, starts, ntrips = (t if t.is_contiguous() else t.contiguous()
                                  for t in (b_u8, meta, starts, ntrips))
    if out is None:
        out = torch.empty(nb, dst_max, dtype=torch.uint8, device=dev)
    elif nb and dst_max and out.stride(1) != 1:
        raise ValueError("out must be contiguous along the row")
    if nb == 0 or dst_max == 0:
        return out
    rc = _build.lib().snc_flat_exec(
        b_u8.data_ptr(), b_u8.shape[1], meta.data_ptr(),
        meta.shape[1] // (2 * NSUB), starts.data_ptr(), ntrips.data_ptr(),
        out.data_ptr(), out.stride(0), dst_max, out_rows, nb,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flat_exec")
    launches += 1
    return out
