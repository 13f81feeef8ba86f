"""Hybrid decode's device half: bytes from host-parsed records.  The CUDA
kernel and its plain version.

Counterpart of ``snappy_tpu/kernels/decode_pretagged.py``.  The host
walks each element stream (``native.parse_tags``, the port's copy of
``sn_parse_tags``) and hands the device validated records, one per
element: ``recs[b, t] = (kind, out_len, arg, out_start)``, kind 0 a
literal of payload bytes ``comp[b, arg : arg + out_len]``, any other
kind a copy of offset ``arg``; ``out_start`` is the element's first
output byte.  ``decode_blocks_pretagged(comp, recs, n_tags, dst_len,
out_max)`` returns uint8 ``[B, out_max]``: row b holds its first
``dst_len[b]`` decoded bytes, then zeros.

On a CUDA tensor the wrapper launches ``csrc/pretagged.cu``: a CTA per
row executes the row's records into a shared-memory image of the output
row, as the writer warp of ``csrc/seq_decode.cu`` executes its parser's
records (each tile of records: its literals at once, a warp per record,
then its copies in order).  On a CPU tensor it runs the plain version, the
JAX function in torch ops: per-byte record labels from ``out_start``,
one source pointer per output byte, pointer doubling
(``resolve_pointers``) until every pointer names a payload byte, one
gather.  There is no other switch.  On the records ``parse_tags`` emits
the two agree byte for byte; on other records neither is defined.
"""

from __future__ import annotations

import torch

from snappy_tpu_torch.kernels.common_par import resolve_pointers

__all__ = ["decode_blocks_pretagged", "decode_blocks_pretagged_plain",
           "record_cap", "stage_records"]

# kernel launches made by decode_blocks_pretagged (one per CUDA call)
launches = 0


def record_cap(most: int, limit: int) -> int:
    """Records a row of a batch whose fullest row holds ``most``: 2048
    doubled until it holds them, at most ``limit`` (the JAX runtime's
    buckets, which bound the record executor's shapes)."""
    cap = 2048
    while cap < most:
        cap *= 2
    return min(cap, limit)


def stage_records(payloads, starts, dst_lens, device=None):
    """A batch as the hybrid engine stages it, for tests and
    measurements: payload rows at the JAX package's bucket width (16,640
    / 33,280 / 66,560 bytes, the widest payload's), the native parser's
    records padded to 2048 doubled up to the most any row needs, record
    counts and decoded lengths.  ``payloads[i]`` is a compressed chunk's
    payload, its element stream starting at ``starts[i]``.  Returns
    (comp, recs, n_tags, dst_len) tensors on ``device`` (the card unless
    asked for the CPU); raises CorruptError on a payload that does not
    parse."""
    import numpy as np

    from snappy_tpu_torch import native
    from snappy_tpu_torch.device import resolve

    widest = max((len(p) for p in payloads), default=0)
    cmax = next((c for c in (16640, 33280, 66560) if widest <= c), widest)
    tmp = np.empty((cmax // 2 + 2, 4), np.int32)
    parsed = []
    for p, s, d in zip(payloads, starts, dst_lens):
        nt = native.parse_tags(p, int(s), int(d), tmp)
        parsed.append(tmp[:nt].copy())
    # capped as the runtime caps it: the records of its widest row
    t_cap = record_cap(max((len(r) for r in parsed), default=0),
                       max(cmax, 66560) // 2 + 2)
    nb = len(payloads)
    comp = np.zeros((nb, cmax), np.uint8)
    recs = np.zeros((nb, t_cap, 4), np.int32)
    for i, (p, r) in enumerate(zip(payloads, parsed)):
        comp[i, : len(p)] = np.frombuffer(p, np.uint8)
        recs[i, : len(r)] = r
    dev = resolve(device)
    return (torch.from_numpy(comp).to(dev), torch.from_numpy(recs).to(dev),
            torch.tensor([len(r) for r in parsed], dtype=torch.int32,
                         device=dev),
            torch.tensor([int(d) for d in dst_lens], dtype=torch.int32,
                         device=dev))


def _check(comp, recs, n_tags, dst_len, out_max: int) -> None:
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError(f"comp must be uint8 [B, cmax], got {comp.dtype} "
                         f"{tuple(comp.shape)}")
    nb = comp.shape[0]
    if (recs.dtype != torch.int32 or recs.dim() != 3 or recs.shape[0] != nb
            or recs.shape[2] != 4 or recs.shape[1] < 1):
        raise ValueError(f"recs must be int32 [{nb}, T >= 1, 4], got "
                         f"{recs.dtype} {tuple(recs.shape)}")
    for name, t in (("n_tags", n_tags), ("dst_len", dst_len)):
        if t.dtype != torch.int32 or tuple(t.shape) != (nb,):
            raise ValueError(f"{name} must be int32 [{nb}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("recs", recs), ("n_tags", n_tags), ("dst_len", dst_len)):
        if t.device != comp.device:
            raise ValueError(f"{name} on {t.device}, comp on {comp.device}")
    if out_max < 0:
        raise ValueError(f"out_max must be >= 0, got {out_max}")


def decode_blocks_pretagged_plain(comp, recs, n_tags, dst_len,
                                  out_max: int = 65536,
                                  ptr_rounds: int = 17) -> torch.Tensor:
    """Plain torch version: ``decode_pretagged._decode_one`` batched."""
    _check(comp, recs, n_tags, dst_len, out_max)
    nb, cmax = comp.shape
    t_max = recs.shape[1]
    dev = comp.device
    kind, out_len, arg, out_start = recs.unbind(2)
    del out_len
    t_valid = torch.arange(t_max, device=dev)[None, :] < n_tags[:, None]
    safe = torch.where(t_valid & (out_start < out_max) & (out_start >= 0),
                       out_start, out_max).to(torch.int64)
    marks = torch.zeros(nb, out_max + 1, dtype=torch.int32, device=dev)
    marks.scatter_add_(1, safe, torch.ones_like(recs[..., 0]))
    tid_b = (torch.cumsum(marks[:, :out_max], dim=1) - 1).clamp(0, t_max - 1)
    j = torch.arange(out_max, dtype=torch.int32, device=dev)[None, :]
    rel = j - out_start.gather(1, tid_b)
    a_b = arg.gather(1, tid_b)
    ptr = torch.where(kind.gather(1, tid_b) == 0, -(a_b + rel) - 1, j - a_b)
    inside = j < dst_len[:, None]
    ptr = torch.where(inside, ptr, -1)
    ptr = resolve_pointers(ptr, ptr_rounds)
    src = (-ptr - 1).clamp(0, max(cmax - 1, 0)).to(torch.int64)
    out = comp.gather(1, src) if cmax else torch.zeros(
        nb, out_max, dtype=torch.uint8, device=dev)
    return torch.where(inside, out, torch.zeros((), dtype=torch.uint8,
                                                device=dev))


def decode_blocks_pretagged(comp, recs, n_tags, dst_len,
                            out_max: int = 65536,
                            ptr_rounds: int = 17) -> torch.Tensor:
    """Decode a batch from host-parsed records; returns uint8 ``[B,
    out_max]``.  CUDA tensors run the kernel (which needs no doubling
    rounds: ``ptr_rounds`` is the plain version's), CPU tensors the
    plain version.  ``comp`` may be a row-strided view."""
    global launches
    _check(comp, recs, n_tags, dst_len, out_max)
    if comp.device.type == "cpu":
        return decode_blocks_pretagged_plain(comp, recs, n_tags, dst_len,
                                             out_max, ptr_rounds)
    if comp.device.type != "cuda":
        raise ValueError(f"unsupported device {comp.device}")
    from snappy_tpu_torch.kernels import _build

    nb, cmax = comp.shape
    if nb and cmax and comp.stride(1) != 1:
        raise ValueError("comp must be contiguous along the row")
    recs, n_tags, dst_len = (t.contiguous() for t in (recs, n_tags, dst_len))
    out = torch.empty(nb, out_max, dtype=torch.uint8, device=comp.device)
    if nb == 0:
        return out
    with torch.cuda.device(comp.device):
        stream = torch.cuda.current_stream(comp.device).cuda_stream
        rc = _build.lib().snc_pretagged(
            comp.data_ptr(), comp.stride(0), cmax, recs.data_ptr(),
            recs.shape[1], n_tags.data_ptr(), dst_len.data_ptr(),
            out.data_ptr(), out_max, nb, stream)
    _build.check(rc, "pretagged")
    launches += 1
    return out
