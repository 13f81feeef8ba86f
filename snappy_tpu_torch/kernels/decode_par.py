"""Parallel Snappy decoder in torch ops: the portable decode engine.

Counterpart of ``snappy_tpu/kernels/decode_jnp.py`` (an XLA program, not
a Pallas kernel), the same program in torch ops on the tensor's device:
speculative tag parse at every byte position -> orbit marking by pointer
doubling -> one source pointer per output byte -> pointer-doubling copy
resolution -> one gather.  Each row of a padded ``[B, cmax]`` batch is
one independent element stream; the ``[B]`` axis stands in for ``vmap``.

Validation does not raise on the device: each row gets an error code
(0 = OK, the codes below are ``decode_jnp``'s, not ``decode_seq``'s),
and the host maps codes to CorruptError.  Lengths, offsets and sums are
int32 and wrap as JAX's do, so hostile 4-byte fields give JAX's codes.
Gathers clip their indices explicitly, as the JAX program does, and
scatters with JAX's ``mode="drop"`` write into one extra slot that is
cut off afterwards.  The doubling loops run their full round counts
(``common_par``).
"""

from __future__ import annotations

import numpy as np
import torch

from snappy_tpu_torch.errors import CorruptError
from snappy_tpu_torch.kernels.common_par import (
    exclusive_cumsum,
    mark_orbit,
    resolve_pointers,
    shifted,
)

__all__ = ["decode_block_par", "decode_blocks", "ERR_NONE", "ERR_MESSAGES"]

ERR_NONE = 0
ERR_OVERRUN_INPUT = 1
ERR_SIZE_MISMATCH = 2
ERR_OVERRUN_OUTPUT = 3
ERR_BAD_OFFSET = 4
ERR_LITERAL_OVERRUN = 5

ERR_MESSAGES = {
    ERR_OVERRUN_INPUT: "element overruns input",
    ERR_SIZE_MISMATCH: "decoded size differs from preamble",
    ERR_OVERRUN_OUTPUT: "element overruns output",
    ERR_BAD_OFFSET: "zero copy offset or offset before block start",
    ERR_LITERAL_OVERRUN: "literal overruns input",
}


def _select(conds, vals, default):
    """jnp.select: the value of the first true condition, else default."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def _word(b1, b2, b3, b4):
    """b1 | b2 << 8 | b3 << 16 | b4 << 24 as wrapping int32."""
    w = (b1.to(torch.int64) | (b2.to(torch.int64) << 8)
         | (b3.to(torch.int64) << 16) | (b4.to(torch.int64) << 24))
    return w.to(torch.int32)


def _parse_positions(comp: torch.Tensor):
    """Speculative tag parse at every byte position of int32 ``[B, n]``."""
    n = comp.shape[1]
    b0 = comp
    b1, b2, b3, b4 = (shifted(b0, k) for k in (1, 2, 3, 4))
    tag = b0 & 3
    x = b0 >> 2
    lit_conds = [x < 60, x == 60, x == 61, x == 62]
    lit_hdr = _select(lit_conds, [1, 2, 3, 4], torch.full_like(x, 5))
    lit_len = _select(lit_conds, [x, b1, b1 | (b2 << 8),
                                  b1 | (b2 << 8) | (b3 << 16)],
                      _word(b1, b2, b3, b4)) + 1
    is_lit = tag == 0
    is_c1 = tag == 1
    is_c2 = tag == 2
    hdr = _select([is_lit, is_c1, is_c2], [lit_hdr, 2, 3],
                  torch.full_like(x, 5))
    out_len = _select([is_lit, is_c1], [lit_len, 4 + ((b0 >> 2) & 7)], 1 + x)
    offset = _select([is_lit, is_c1, is_c2],
                     [torch.zeros_like(b0), ((b0 & 0xE0) << 3) | b1,
                      b1 | (b2 << 8)], _word(b1, b2, b3, b4))
    pos = torch.arange(n, dtype=torch.int32, device=comp.device)[None, :]
    nxt = pos + torch.where(is_lit, lit_hdr + lit_len, hdr)
    # poison literals whose length field would overflow int32 (>= 2^30):
    # the walk sees them run past the end (ERR_OVERRUN_INPUT)
    poison = is_lit & (x == 63) & (b4 >= 0x40)
    nxt = torch.where(poison, n + 1, nxt)
    lit_src = pos + lit_hdr
    return nxt, out_len, offset, lit_src, is_lit


def _drop_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Scatter indices of JAX's ``mode="drop"`` into a buffer one slot
    wider: negative indices count from the end, as in JAX, and any index
    still outside [0, size) goes to the extra slot ``size``."""
    idx = torch.where(idx < 0, idx + size, idx)
    return torch.where((idx >= 0) & (idx < size), idx, size).to(torch.int64)


def _decode(comp, start, comp_len, dst_len, out_max: int, tag_rounds: int,
            ptr_rounds: int):
    """decode_jnp._decode_one over a batch: (out uint8 [B, out_max], err
    int32 [B])."""
    nb, cmax = comp.shape
    dev = comp.device
    i32 = torch.int32
    start = start[:, None]
    comp_len = comp_len[:, None]
    dst_len = dst_len[:, None]
    pos = torch.arange(cmax, dtype=i32, device=dev)[None, :]
    # mask bytes past comp_len so padding cannot fabricate elements
    compi = torch.where(pos < comp_len, comp.to(i32), 0)

    nxt, out_len, offset, lit_src, is_lit = _parse_positions(compi)
    nxt_c = torch.where(nxt <= comp_len, nxt, cmax)
    nxt_c = torch.maximum(nxt_c, pos + 1)
    reached = mark_orbit(nxt_c, start[:, 0], tag_rounds) & (pos < comp_len)

    # the walk must consume the input exactly
    any_reached = reached.any(dim=1, keepdim=True)
    last_pos = torch.where(reached, pos, -1).amax(dim=1, keepdim=True)
    ends_ok = any_reached & (
        nxt.gather(1, last_pos.clamp(0, cmax - 1).to(torch.int64)) == comp_len)
    ends_ok = ends_ok | ((dst_len == 0) & (start == comp_len))

    # order tags by position: tid = rank among reached
    r32 = reached.to(i32)
    tid = torch.cumsum(r32, dim=1).to(i32) - 1
    t_max = cmax // 2 + 2
    tag_pos = torch.full((nb, t_max + 1), cmax, dtype=i32, device=dev)
    tag_pos.scatter_(1, _drop_index(torch.where(reached, tid, t_max), t_max),
                     pos.expand(nb, cmax).contiguous())
    tag_pos = tag_pos[:, :t_max]
    n_tags = r32.sum(dim=1, keepdim=True)
    t_valid = torch.arange(t_max, device=dev)[None, :] < n_tags
    tp = tag_pos.clamp(0, cmax - 1).to(torch.int64)

    def g(arr, fill):
        return torch.where(t_valid, arr.gather(1, tp), fill)

    t_out = g(out_len, 0)
    t_off = g(offset, 1)
    t_lit = g(lit_src, 0)
    t_islit = g(is_lit, True)

    out_start = exclusive_cumsum(t_out)
    total = t_out.sum(dim=1, keepdim=True).to(i32)

    def any_row(m):
        return m.any(dim=1, keepdim=True)

    err = torch.zeros(nb, 1, dtype=i32, device=dev)
    err = torch.where(~ends_ok, ERR_OVERRUN_INPUT, err)
    err = torch.where(total != dst_len, ERR_SIZE_MISMATCH, err)
    err = torch.where(any_row(t_valid & (t_out > dst_len - out_start)),
                      ERR_OVERRUN_OUTPUT, err)
    err = torch.where(any_row(t_valid & ~t_islit
                              & ((t_off <= 0) | (t_off > out_start))),
                      ERR_BAD_OFFSET, err)
    err = torch.where(any_row(t_valid & t_islit
                              & (t_lit + t_out > comp_len)),
                      ERR_LITERAL_OVERRUN, err)

    # per-output-byte tag labels
    marks = torch.zeros(nb, out_max + 1, dtype=i32, device=dev)
    safe = torch.where(t_valid & (out_start < out_max), out_start, out_max)
    marks.scatter_add_(1, _drop_index(safe, out_max),
                       torch.ones_like(safe))
    tid_b = (torch.cumsum(marks[:, :out_max], dim=1) - 1).clamp(
        0, t_max - 1).to(torch.int64)

    j = torch.arange(out_max, dtype=i32, device=dev)[None, :]
    rel = j - out_start.gather(1, tid_b)
    ptr = torch.where(t_islit.gather(1, tid_b),
                      -(t_lit.gather(1, tid_b) + rel) - 1,
                      j - t_off.gather(1, tid_b))
    inside = j < dst_len
    ptr = torch.where(inside, ptr, -1)
    ptr = resolve_pointers(ptr, ptr_rounds)
    # the masked row: bytes past comp_len read as zero
    out = compi.gather(1, (-ptr - 1).clamp(0, cmax - 1).to(torch.int64))
    out = torch.where(inside, out, 0).to(torch.uint8)
    return out, err[:, 0]


def decode_blocks(comp, start, comp_len, dst_len, out_max: int = 65536,
                  tag_rounds: int = 17, ptr_rounds: int = 17):
    """Batched parallel decode on ``comp``'s device.

    comp:      uint8 [B, cmax]   padded compressed rows (element streams,
                                 no varint preamble)
    start:     int32 [B]         first element offset within each row
    comp_len:  int32 [B]         valid bytes per row
    dst_len:   int32 [B]         expected decoded length per row
    returns    (uint8 [B, out_max], int32 [B] error codes)
    """
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] < 1:
        raise ValueError(f"comp must be uint8 [B, cmax >= 1], got "
                         f"{comp.dtype} {tuple(comp.shape)}")
    nb = comp.shape[0]
    for name, t in (("start", start), ("comp_len", comp_len),
                    ("dst_len", dst_len)):
        if tuple(t.shape) != (nb,) or t.device != comp.device:
            raise ValueError(f"{name} must be [{nb}] on {comp.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    start, comp_len, dst_len = (t.to(torch.int32)
                                for t in (start, comp_len, dst_len))
    return _decode(comp, start, comp_len, dst_len, out_max, tag_rounds,
                   ptr_rounds)


def _bucket(n: int, floor: int = 256) -> int:
    """n rounded up to a power of two (>= floor), as decode_jnp buckets
    its shapes."""
    b = floor
    while b < n:
        b *= 2
    return b


def decode_block_par_to_device(comp_bytes: bytes, dst_len: int,
                               start: int = 0, device=None) -> torch.Tensor:
    """Single-block decode to a uint8 tensor ``[dst_len]`` on ``device``
    (``device.resolve``): one row of the parallel decoder, its shapes
    bucketed as ``decode_block_jnp``'s.  Raises CorruptError as the
    shared error surface does."""
    from snappy_tpu_torch.device import resolve

    dev = resolve(device)
    n = len(comp_bytes)
    cmax = _bucket(max(8, n))
    comp = np.zeros((1, cmax), dtype=np.uint8)
    comp[0, :n] = np.frombuffer(comp_bytes, dtype=np.uint8)
    out_max = _bucket(max(8, dst_len))
    # doubling rounds scale with the stream (large raw streams can have
    # more than 2^17 elements or copy-chain depth)
    rounds = max(17, cmax.bit_length() + 1, out_max.bit_length() + 1)

    def i32(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    out, err = decode_blocks(torch.from_numpy(comp).to(dev), i32(start),
                             i32(n), i32(dst_len), out_max=out_max,
                             tag_rounds=rounds, ptr_rounds=rounds)
    code = int(err[0])
    if code != ERR_NONE:
        raise CorruptError(ERR_MESSAGES.get(code, f"error {code}"))
    return out[0, :dst_len]


def decode_block_par(comp_bytes: bytes, dst_len: int, start: int = 0,
                     device=None) -> bytes:
    """Single-block convenience wrapper, ``decode_block_jnp``'s
    counterpart: ``decode_block_par_to_device``'s bytes on the host."""
    return decode_block_par_to_device(comp_bytes, dst_len, start,
                                      device).cpu().numpy().tobytes()
