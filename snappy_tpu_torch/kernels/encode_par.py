"""Parallel Snappy block encoder: the CUDA kernels and their plain
version, the portable encode engine.

Counterpart of ``snappy_tpu/kernels/encode_jnp.py`` (an XLA program, not
a Pallas kernel).  ``encode_blocks(block uint8 [B, bmax], n [B], bmax)``
returns ``(comp uint8 [B, emax], comp_len int32 [B], ok bool [B])``:
``comp[b, :comp_len[b]]`` is block b's element stream (no varint
preamble), the rest of the row zero, ``emax`` from ``derived_sizes``;
rows with ok=False are re-encoded on the host.  The emission is
``kernels/encode_np.py``'s, which states the contract, and so
``encode_jnp``'s byte for byte.

On a CUDA tensor the wrapper launches ``csrc/encode_par.cu``: a
candidate kernel (a stable radix sort of each block's positions by
4-byte word, a cluster of two CTAs of 32 warps a block), a parse kernel
(a CTA a block and walk kind, greedy and lazy: speculative walks a chunk
of ``PARSE_CHUNK`` positions a thread, on exact match lengths compared
on demand by the warp, the true walk's entry into each chunk where it
meets a speculative walk, the copy list, prune and shift with the whole
CTA) and an emission kernel (a CTA a block, the smaller parse).  On a
CPU tensor it runs the plain version, ``encode_blocks_plain``, JAX's
program in torch ops with the ``[B]`` batch axis in place of ``vmap``.
There is no other switch.  Per block the plain version runs

  1. match finding: 4-gram words -> stable sort -> candidates {prev1,
     prev2, first occurrence} -> unbounded match length by paired
     Rabin-Karp prefix hashes and a 17-step binary search
  2. parse: greedy and lazy successor walks marked by pointer doubling,
     two simultaneous-drop prune passes, the start-shift pass; per block
     the smaller emission wins
  3. emission: elements -> chop atoms -> per-byte formulas
  4. exact verification of every copy byte; a block that fails (a hash
     collision) reports ok=False and the host re-encodes it.

The hashes are uint32 values held in int64 (``common_par.mul32`` for
their products); the sort key keeps JAX's tie of an invalid position
(0x7FFFFFFF) with the word 0xFFFFFFFF, under a stable sort.  The
kernels compare bytes instead of hashes, so they are ok wherever the
plain version is and differ from it only where its hashes collide
(~2^-64 a compare).  Both take a length outside ``[0, bmax]`` as the
contract does not: the kernels clamp it.  An offset of 65,536 or more
(only in a block longer than 64 KiB, ``bmax = 2**17``, a width JAX's
function does not run) is emitted by both in ``encode_np``'s chop atoms,
each a copy-4 (tag 3, a 4-byte offset), and costed so in the prune,
the shift and the choice of walk.

``encode_blocks_model`` is the kernels' decomposition on the host, for
the tests: the radix passes with their per-warp counts and run heads,
the walks on exact lengths (``walk_model``; ``walk_model_chunked`` the
parse kernel's chunked form of each walk), prune, shift and emission.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from snappy_tpu_torch.kernels.common_par import (
    MASK32,
    bytes_to_u32_words,
    exclusive_cumsum,
    mark_orbits2,
    mul32,
    pow_table,
    prefix_hashes,
    shifted,
)
from snappy_tpu_torch.kernels.encode_np import _copy_cost, _lit_cost
from snappy_tpu_torch.spec import reference

__all__ = ["encode_blocks", "encode_blocks_plain", "encode_block_par",
           "encode_blocks_model", "walk_model_chunked", "derived_sizes"]

_I32MAX = 0x7FFFFFFF
I32 = torch.int32

COPY4_OFFSET = 1 << 16  # the least offset a copy-2 cannot hold
CAND_WARPS = 64   # warps of the candidate kernel's cluster (sort chunks)
CAP = 64          # bytes of a match the candidate kernel measures
LCP_STEP = 128    # bytes a walk warp compares a step (4 a lane)
PARSE_CHUNK = 256  # positions a speculative walk of the parse kernel covers

# kernel launches made by encode_blocks (one per CUDA call)
launches = 0


def derived_sizes(bmax: int) -> tuple[int, int, int]:
    """(cp_max, atom_max, emax): most copies, chop atoms and element
    bytes a ``bmax``-byte block can have (encode_jnp's sizes)."""
    cp_max = bmax // 4 + 2
    atom_max = cp_max + bmax // 64 + bmax // 65 + cp_max + 8
    emax = bmax + bmax // 6 + 64
    return cp_max, atom_max, emax


def _lit_cost_v(r):
    """Literal emission cost of r bytes; r == 0 costs 0."""
    extras = ((r - 1 >= 60).to(I32) + (r - 1 >= 256).to(I32)
              + (r - 1 >= 65536).to(I32))
    return torch.where(r > 0, r + 1 + extras, 0)


def _copy_chops(off, length):
    """Reference chopping of a copy: (c64, e60, remf, cost).  An offset
    of 65,536 or more takes the same atoms, each a 5-byte copy-4."""
    c64 = torch.where(length >= 68, torch.div(length - 68, 64,
                                              rounding_mode="floor") + 1, 0)
    rem1 = length - 64 * c64
    e60 = (rem1 > 64).to(I32)
    remf = rem1 - 60 * e60
    final_cost = torch.where((remf >= 12) | (off >= 2048), 3, 2)
    cost = torch.where(off >= COPY4_OFFSET, 5 * (c64 + e60 + 1),
                       3 * c64 + 3 * e60 + final_cost)
    return c64, e60, remf, torch.where(length >= 4, cost, 0)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...]] for x ``[B, m]`` and any ``idx [B, ...]``."""
    nb = x.shape[0]
    return x.gather(1, idx.reshape(nb, -1).to(torch.int64)).reshape(idx.shape)


def _scatter(base: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
             reduce: str | None = None) -> torch.Tensor:
    """JAX's ``base.at[idx].set / max (src, mode="drop")`` per row: the
    write goes into a buffer one slot wider, indices outside [0, m) land
    in the extra slot, which is cut off."""
    nb, m = base.shape
    buf = torch.cat([base, base[:, :1]], dim=1)
    idx = torch.where((idx >= 0) & (idx < m), idx, m).to(torch.int64)
    src = src.expand(idx.shape).to(base.dtype).contiguous()
    if reduce is None:
        buf.scatter_(1, idx, src)
    else:
        buf.scatter_reduce_(1, idx, src, reduce=reduce, include_self=True)
    return buf[:, :m]


def _find_matches(block, n, bmax: int):
    """Best candidate and certified match length per position: int32
    ``[B, bmax]`` each.  ``n`` is int32 ``[B, 1]``."""
    nb = block.shape[0]
    dev = block.device
    w = bytes_to_u32_words(block)
    pos = torch.arange(bmax, dtype=I32, device=dev)[None, :]
    valid = pos < n - 3

    # bitcast(w ^ 0x80000000) to int32 is w - 2^31; invalid positions
    # take 0x7FFFFFFF, the key of the word 0xFFFFFFFF, as in JAX
    skey = torch.where(valid, w - (1 << 31), _I32MAX)
    sv, order = torch.sort(skey, dim=1, stable=True)
    order = order.to(I32)
    f1 = torch.zeros(nb, 1, dtype=torch.bool, device=dev)
    same1 = torch.cat([f1, sv[:, 1:] == sv[:, :-1]], dim=1)
    same2 = torch.cat([f1, f1, sv[:, 2:] == sv[:, :-2]], dim=1)
    grp_start = torch.where(~same1, pos.expand(nb, bmax), 0)
    grp_start = torch.cummax(grp_start, dim=1).values
    first_sorted = _gather(order, grp_start)

    z = torch.zeros(nb, 1, dtype=I32, device=dev)
    prev1_s = torch.where(same1, torch.cat([z, order], dim=1)[:, :bmax], -1)
    prev2_s = torch.where(same2, torch.cat([z, z, order], dim=1)[:, :bmax], -1)
    first_s = torch.where(same1, first_sorted, -1)

    oi = order.to(torch.int64)

    def unsort(x):
        return torch.zeros(nb, bmax, dtype=I32, device=dev).scatter_(1, oi, x)

    C = torch.stack([unsort(prev1_s), unsort(prev2_s), unsort(first_s)],
                    dim=1)  # [B, 3, bmax]

    # normalized hashes G[i] = H[i] * R^-i: substring equality
    # [p, p+m) == [c, c+m)  <=>  G[p+m] - G[p] == R^(c-p) (G[c+m] - G[c])
    ha, hb = prefix_hashes(block)
    ripa = pow_table(1, bmax + 1, dev)
    ripb = pow_table(3, bmax + 1, dev)
    ga = mul32(ha, ripa[None, :])
    gb = mul32(hb, ripb[None, :])

    maxm = (n - pos).clamp(min=0)  # [B, bmax]
    CV = valid[:, None, :] & (C >= 0) & (C < (n - 3)[:, :, None])
    CC = C.clamp(0, bmax - 1)
    pos3 = pos[:, None, :].expand(nb, 3, bmax)
    maxm3 = maxm[:, None, :].expand(nb, 3, bmax)
    g0p_a = ga[:, None, :bmax]
    g0p_b = gb[:, None, :bmax]
    g0c_a = _gather(ga, CC)
    g0c_b = _gather(gb, CC)
    dist = (pos3 - CC).clamp(0, bmax).to(torch.int64)
    fac_a = ripa[dist]
    fac_b = ripb[dist]

    lo = torch.full((nb, 3, bmax), 4, dtype=I32, device=dev)
    for i in range(17):
        trial = lo + (1 << (16 - i))
        ok = (trial <= maxm3) & CV
        t = torch.minimum(trial, maxm3)
        ip = (pos3 + t).clamp(0, bmax)
        ic = (CC + t).clamp(0, bmax)
        eq_a = ((_gather(ga, ip) - g0p_a) & MASK32) == mul32(
            fac_a, (_gather(ga, ic) - g0c_a) & MASK32)
        eq_b = ((_gather(gb, ip) - g0p_b) & MASK32) == mul32(
            fac_b, (_gather(gb, ic) - g0c_b) & MASK32)
        lo = torch.where(eq_a & eq_b & ok, trial, lo)
    ml3 = torch.where(CV, lo, 0)

    best_c = torch.full((nb, bmax), -1, dtype=I32, device=dev)
    best_l = torch.zeros(nb, bmax, dtype=I32, device=dev)
    for k in range(3):
        c, mlk, cvalid = C[:, k], ml3[:, k], CV[:, k]
        better = mlk > best_l
        tie = (mlk == best_l) & (c > best_c) & cvalid
        upd = better | tie
        best_c = torch.where(upd, c, best_c)
        best_l = torch.where(upd, mlk, best_l)
    best_l = torch.where(best_c >= 0, best_l, 0)
    return best_c, best_l


def _parse_masks(ml, n, bmax: int):
    """Taken-copy masks of the greedy and the lazy walk, one fused orbit
    loop."""
    pos = torch.arange(bmax, dtype=I32, device=ml.device)[None, :]
    ml_next = shifted(ml, 1)
    takeable_g = (ml >= 4) & (pos >= 1) & (pos < n)
    defer = ml_next > ml + 1
    takeable_l = takeable_g & ~defer
    nxt_g = (pos + torch.where(takeable_g, ml, 1)).clamp(max=bmax)
    nxt_l = (pos + torch.where(takeable_l, ml, 1)).clamp(max=bmax)
    marks = mark_orbits2(torch.stack([nxt_g, nxt_l], dim=1), 1, 17)
    return marks[:, 0] & takeable_g, marks[:, 1] & takeable_l


def _compact(keep, vals, fills, cp_max: int):
    """Rows' kept entries moved to the front: the arrays of ``vals`` at
    the ranks of ``keep``, ``fills`` elsewhere, and the kept count."""
    nb = keep.shape[0]
    dev = keep.device
    ci = torch.cumsum(keep.to(I32), dim=1).to(I32) - 1
    tgt = torch.where(keep, ci, cp_max)
    out = [_scatter(torch.full((nb, cp_max), f, dtype=I32, device=dev), tgt, v)
           for v, f in zip(vals, fills)]
    return (*out, keep.to(I32).sum(dim=1, keepdim=True).to(I32))


def _parse(taken, cand, ml, n, bmax: int, cp_max: int):
    """Compaction, prune, alignment and size for one strategy's taken
    mask."""
    nb = taken.shape[0]
    dev = taken.device
    pos = torch.arange(bmax, dtype=I32, device=dev)[None, :].expand(nb, bmax)
    cpos, clen, coff, nc = _compact(taken, (pos, ml, pos - cand),
                                    (bmax, 0, 1), cp_max)
    kidx = torch.arange(cp_max, dtype=I32, device=dev)[None, :]
    z = torch.zeros(nb, 1, dtype=I32, device=dev)
    full_b = torch.full((nb, 1), bmax, dtype=I32, device=dev)
    for _ in range(2):  # simultaneous-drop prune passes
        cvalid = kidx < nc
        pend = torch.where(cvalid, cpos + clen, bmax)
        prev_end = torch.cat([z, pend], dim=1)[:, :cp_max]
        a = torch.where(cvalid, cpos - prev_end, 0)
        next_start = torch.cat([cpos[:, 1:], full_b], dim=1)
        next_start = torch.where(kidx + 1 < nc, next_start, n)
        b_gap = torch.where(cvalid, next_start - pend, 0)
        prev_is_copy = (a == 0) & (kidx > 0)
        next_is_copy = (b_gap == 0) & (kidx + 1 < nc)
        ccost = _copy_chops(coff, clen)[3]
        elig = (cvalid & ~prev_is_copy & ~next_is_copy
                # <= (not <): tied drops merge literals (encode_np._prune)
                & (_lit_cost_v(a + clen + b_gap)
                   <= _lit_cost_v(a) + ccost + _lit_cost_v(b_gap)))
        keep = cvalid & ~elig
        cpos, clen, coff, nc = _compact(keep, (cpos, clen, coff),
                                        (bmax, 0, 1), cp_max)

    # start-shift alignment (encode_np._shift_starts)
    cvalid = kidx < nc
    prev_end0 = torch.cat([z, torch.where(cvalid, cpos + clen, bmax)],
                          dim=1)[:, :cp_max]
    a0 = torch.where(cvalid, cpos - prev_end0, 0)
    ccost0 = _copy_chops(coff, clen)[3]
    best_d = torch.zeros(nb, cp_max, dtype=I32, device=dev)
    best_cost = _lit_cost_v(a0) + ccost0
    for d in (1, 2, 3):
        ok = cvalid & (clen - d >= 4)
        cost = _lit_cost_v(a0 + d) + _copy_chops(coff, clen - d)[3]
        upd = ok & (cost < best_cost)
        best_d = torch.where(upd, d, best_d)
        best_cost = torch.where(upd, cost, best_cost)
    cpos = torch.where(cvalid, cpos + best_d, cpos)
    clen = torch.where(cvalid, clen - best_d, clen)

    pend = torch.where(cvalid, cpos + clen, 0)
    prev_end = torch.cat([z, torch.where(cvalid, cpos + clen, bmax)],
                         dim=1)[:, :cp_max]
    a = torch.where(cvalid, cpos - prev_end, 0)
    ccost = _copy_chops(coff, clen)[3]
    covered_end = torch.where(cvalid, pend, 0).amax(dim=1, keepdim=True)
    tail = n - covered_end
    total = (torch.where(cvalid, _lit_cost_v(a) + ccost, 0).sum(
        dim=1, keepdim=True) + _lit_cost_v(tail)).to(I32)
    return cpos, clen, coff, nc, total


def _emit(block, n, cpos, clen, coff, nc, bmax: int, cp_max: int,
          atom_max: int, emax: int):
    """Elements -> atoms -> bytes.  Elements are, in order: for each copy
    k an optional literal gap then the copy's chop atoms; finally an
    optional tail literal (owner id 2 * cp_max)."""
    nb = block.shape[0]
    dev = block.device
    kidx = torch.arange(cp_max, dtype=I32, device=dev)[None, :]
    z = torch.zeros(nb, 1, dtype=I32, device=dev)
    cvalid = kidx < nc
    pend_raw = cpos + clen
    prev_end = torch.cat([z, torch.where(cvalid, pend_raw, bmax)],
                         dim=1)[:, :cp_max]
    a = torch.where(cvalid, cpos - prev_end, 0)  # literal gap before copy k
    lit_start = torch.where(cvalid, prev_end, 0)
    covered_end = torch.where(cvalid, pend_raw, 0).amax(dim=1, keepdim=True)
    tail_len = n - covered_end

    c64, e60, remf, _ = _copy_chops(coff, clen)
    natoms_copy = torch.where(cvalid, c64 + e60 + 1, 0)
    natoms_lit = torch.where(cvalid & (a > 0), 1, 0).to(I32)
    pair_atoms = natoms_lit + natoms_copy
    pair_base = exclusive_cumsum(pair_atoms)
    total_pair_atoms = pair_atoms.sum(dim=1, keepdim=True).to(I32)
    tail_atoms = torch.where(tail_len > 0, 1, 0).to(I32)
    total_atoms = total_pair_atoms + tail_atoms

    # owner ids: even = literal element k/2, odd = copy element k//2
    owner = torch.full((nb, atom_max), -1, dtype=I32, device=dev)
    owner = _scatter(owner, torch.where(cvalid & (natoms_lit > 0), pair_base,
                                        atom_max), 2 * kidx, "amax")
    owner = _scatter(owner, torch.where(cvalid, pair_base + natoms_lit,
                                        atom_max), 2 * kidx + 1, "amax")
    owner = _scatter(owner, torch.where(tail_atoms > 0, total_pair_atoms,
                                        atom_max),
                     torch.full((nb, 1), 2 * cp_max, dtype=I32, device=dev),
                     "amax")
    owner = torch.cummax(owner, dim=1).values
    aidx = torch.arange(atom_max, dtype=I32, device=dev)[None, :]
    atom_valid = aidx < total_atoms
    owner = owner.clamp(0, 2 * cp_max)

    k = owner >> 1
    is_copy_atom = (owner & 1) == 1
    is_tail = owner == 2 * cp_max
    kc = k.clamp(0, cp_max - 1)

    # per-atom literal info
    lit_len_at = torch.where(is_tail, tail_len, _gather(a, kc))
    lit_src_at = torch.where(is_tail, covered_end, _gather(lit_start, kc))
    lit_extra = ((lit_len_at - 1 >= 60).to(I32) + (lit_len_at - 1 >= 256).to(I32)
                 + (lit_len_at - 1 >= 65536).to(I32))
    lit_hdr = 1 + lit_extra

    # per-atom copy info
    nl_k = _gather(natoms_lit, kc)
    copy_base = _gather(pair_base, kc) + nl_k
    arel = aidx - copy_base
    c64_k, e60_k = _gather(c64, kc), _gather(e60, kc)
    alen = torch.where(arel < c64_k, 64,
                       torch.where((e60_k == 1) & (arel == c64_k), 60,
                                   _gather(remf, kc)))
    afinal = arel == _gather(natoms_copy, kc) - 1
    off_at = _gather(coff, kc)
    copy1 = afinal & (alen < 12) & (off_at < 2048)
    copy4 = off_at >= COPY4_OFFSET
    copy_size = torch.where(copy1, 2, torch.where(copy4, 5, 3))

    asize = torch.where(atom_valid, torch.where(is_copy_atom, copy_size,
                                                lit_hdr + lit_len_at), 0)
    abase = exclusive_cumsum(asize)
    total_len = asize.sum(dim=1, keepdim=True).to(I32)

    # per-byte atom labels
    bidx = torch.arange(emax, dtype=I32, device=dev)[None, :]
    seed = _scatter(torch.zeros(nb, emax, dtype=I32, device=dev),
                    torch.where(atom_valid & (asize > 0), abase, emax),
                    torch.ones((), dtype=I32, device=dev), "sum")
    batom = (torch.cumsum(seed, dim=1).to(I32) - 1).clamp(0, atom_max - 1)
    brel = bidx - _gather(abase, batom)

    b_is_copy = _gather(is_copy_atom, batom)
    b_copy1 = _gather(copy1, batom)
    b_copy4 = _gather(copy4, batom)
    b_alen = _gather(alen, batom)
    b_off = _gather(off_at, batom)
    b_lit_len = _gather(lit_len_at, batom)
    b_lit_extra = _gather(lit_extra, batom)
    b_lit_hdr = _gather(lit_hdr, batom)
    b_lit_src = _gather(lit_src_at, batom)

    copy_val = torch.where(
        b_copy1,
        torch.where(brel == 0,
                    ((b_off >> 8) << 5) | ((b_alen - 4) << 2) | 1,
                    b_off & 255),
        torch.where(brel == 0, ((b_alen - 1) << 2) | (2 + b_copy4.to(I32)),
                    (b_off >> (8 * (brel - 1).clamp(0, 3))) & 255))
    lit_tag = torch.where(b_lit_extra == 0, (b_lit_len - 1) << 2,
                          (59 + b_lit_extra) << 2)
    lit_hdr_val = torch.where(
        brel == 0, lit_tag,
        ((b_lit_len - 1) >> (8 * (brel - 1).clamp(0, 3))) & 255)
    lit_data = _gather(block, (b_lit_src + brel - b_lit_hdr).clamp(
        0, bmax - 1)).to(I32)
    lit_val = torch.where(brel < b_lit_hdr, lit_hdr_val, lit_data)

    val = torch.where(b_is_copy, copy_val, lit_val)
    comp = torch.where(bidx < total_len, val, 0).to(torch.uint8)
    return comp, total_len


def _verify(block, n, cpos, clen, coff, nc, bmax: int, cp_max: int):
    """Exact byte equality of every copy (the hash certificate's check);
    bool ``[B, 1]``."""
    nb = block.shape[0]
    dev = block.device
    kidx = torch.arange(cp_max, dtype=I32, device=dev)[None, :]
    cvalid = kidx < nc
    pos = torch.arange(bmax, dtype=I32, device=dev)[None, :]
    seed = _scatter(torch.full((nb, bmax), -1, dtype=I32, device=dev),
                    torch.where(cvalid, cpos.clamp(0, bmax - 1), bmax),
                    kidx.expand(nb, cp_max), "amax")
    ownr = torch.cummax(seed, dim=1).values.clamp(0, cp_max - 1)
    cp_o = _gather(cpos, ownr)
    covered = ((seed.amax(dim=1, keepdim=True) >= 0) & (pos >= cp_o)
               & (pos < cp_o + _gather(clen, ownr)) & (pos < n))
    src = pos - _gather(coff, ownr)
    eq = _gather(block, src.clamp(0, bmax - 1)) == block
    struct_ok = (~cvalid | ((coff >= 1) & (coff <= cpos) & (clen >= 4))).all(
        dim=1, keepdim=True)
    return (~covered | (eq & (src >= 0))).all(dim=1, keepdim=True) & struct_ok


def _check(block: torch.Tensor, n: torch.Tensor, bmax: int) -> None:
    if block.dtype != torch.uint8 or block.dim() != 2 or block.shape[1] != bmax:
        raise ValueError(f"block must be uint8 [B, {bmax}], got {block.dtype} "
                         f"{tuple(block.shape)}")
    if bmax < 4 or bmax > 1 << 17:
        raise ValueError(f"bmax must be in [4, 2**17], got {bmax}")
    nb = block.shape[0]
    if tuple(n.shape) != (nb,) or n.device != block.device:
        raise ValueError(f"n must be [{nb}] on {block.device}")


def encode_blocks_plain(block: torch.Tensor, n: torch.Tensor,
                        bmax: int = 65536):
    """Plain torch version: JAX's program in torch ops, on ``block``'s
    device."""
    _check(block, n, bmax)
    cp_max, atom_max, emax = derived_sizes(bmax)
    n = n.to(I32)[:, None]
    cand, ml = _find_matches(block, n, bmax)
    taken_g, taken_l = _parse_masks(ml, n, bmax)
    g = _parse(taken_g, cand, ml, n, bmax, cp_max)
    lz = _parse(taken_l, cand, ml, n, bmax, cp_max)
    use_lazy = lz[4] < g[4]
    cpos, clen, coff, nc = (torch.where(use_lazy, lz[i], g[i])
                            for i in range(4))
    ok = _verify(block, n, cpos, clen, coff, nc, bmax, cp_max)
    comp, total_len = _emit(block, n, cpos, clen, coff, nc, bmax, cp_max,
                            atom_max, emax)
    ok = ok & (total_len <= emax)
    return comp, total_len[:, 0], ok[:, 0]


def encode_blocks(block: torch.Tensor, n: torch.Tensor, bmax: int = 65536):
    """Batched parallel encode on ``block``'s device.

    block: uint8 [B, bmax] padded blocks; n: int [B] valid lengths.
    Returns (comp uint8 [B, emax], comp_len int32 [B], ok bool [B]); rows
    with ok=False must be re-encoded on the host.  The output is the
    element stream only (no varint preamble).  CUDA tensors run the
    kernels, CPU tensors the plain version.
    """
    global launches
    if block.device.type == "cpu":
        return encode_blocks_plain(block, n, bmax)
    _check(block, n, bmax)
    if block.device.type != "cuda":
        raise ValueError(f"unsupported device {block.device}")
    if block.stride(1) != 1:
        raise ValueError("block must be contiguous along the row")
    from snappy_tpu_torch.kernels import _build

    nb = block.shape[0]
    cp_max, _atom_max, emax = derived_sizes(bmax)
    dev = block.device
    n = n.to(I32).contiguous()
    comp = torch.empty(nb, emax, dtype=torch.uint8, device=dev)
    comp_len = torch.empty(nb, dtype=I32, device=dev)
    ok = torch.empty(nb, dtype=torch.bool, device=dev)
    if nb == 0:
        return comp, comp_len, ok
    # scratch: the sort's order buffers, each position's candidate entry,
    # the speculative walks' copies and each walk kind's copy lists, as
    # the kernels lay it out
    lib = _build.lib()
    nbytes = ctypes.c_int64(0)
    _build.check(lib.snc_encode_par_scratch(bmax, cp_max, nb,
                                            ctypes.addressof(nbytes)),
                 "encode_par")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.snc_encode_par(
            block.data_ptr(), block.stride(0), bmax, n.data_ptr(),
            scratch.data_ptr(), cp_max, comp.data_ptr(), emax,
            comp_len.data_ptr(), ok.data_ptr(), nb, stream)
    _build.check(rc, "encode_par")
    launches += 1
    return comp, comp_len, ok


def encode_block_par(block: bytes, bmax: int | None = None,
                     device=None) -> bytes:
    """Single-block convenience wrapper, ``encode_block_jnp``'s
    counterpart: the element stream of ``block`` (the reference
    encoder's on a hash collision)."""
    from snappy_tpu_torch.device import resolve

    n = len(block)
    if n == 0:
        return b""
    if bmax is None:
        bmax = 256
        while bmax < n:
            bmax *= 2
    dev = resolve(device)
    arr = np.zeros((1, bmax), dtype=np.uint8)
    arr[0, :n] = np.frombuffer(block, dtype=np.uint8)
    comp, total_len, ok = encode_blocks(
        torch.from_numpy(arr).to(dev),
        torch.tensor([n], dtype=I32, device=dev), bmax=bmax)
    if not bool(ok[0]):  # pragma: no cover - hash collision fallback
        return reference.encode_block(block)
    return comp[0, : int(total_len[0])].cpu().numpy().tobytes()


def lazy_chain_block(size: int, seed: int) -> bytes:
    """A block whose lazy walk defers along a chain of growing matches:
    for k < K, S[k : k + 8 + 2k] and a byte unlike the next of S, then S
    itself, so position k of S matches 8 + 2k bytes (ml[p + 1] = ml[p] +
    2), then random bytes to ``size``.  K as large as fits."""
    rng = np.random.default_rng(seed)
    k_max = 1
    while (k_max + 1) * 9 + (k_max + 1) * k_max + 3 * (k_max + 1) + 8 <= size:
        k_max += 1
    s = rng.integers(0, 256, 3 * k_max + 8, dtype=np.uint8).tobytes()
    parts = [s[k : 3 * k + 8] + bytes([s[3 * k + 8] ^ 0x5A])
             for k in range(k_max)]
    blob = b"".join(parts) + s
    return blob + rng.integers(0, 256, size - len(blob), np.uint8).tobytes()


def edge_blocks(seed: int, size: int = 65536) -> dict:
    """Hostile blocks of up to ``size`` bytes by name: a run, a period-3
    pattern, random bytes, a lazy chain (``lazy_chain_block``), all-0xFF
    (the sort key's tie), 1-3 bytes and an empty block."""
    rng = np.random.default_rng(seed)
    return {"run": b"\x07" * size,
            "period 3": (b"abc" * (size // 3 + 1))[:size],
            "random": rng.integers(0, 256, size, np.uint8).tobytes(),
            "lazy chain": lazy_chain_block(size, seed),
            "all 0xff": b"\xff" * size,
            "1 byte": b"q", "2 bytes": b"qr", "3 bytes": b"qrs", "empty": b""}


def wide_block(seed: int) -> bytes:
    """A block of 2**17 bytes for a ``bmax = 2**17`` row: 4 KiB of
    random bytes R, text with repeats nearer than 64 KiB, R again 70,096
    bytes after the first (its copies need copy-4 elements), random
    bytes, a run."""
    rng = np.random.default_rng(seed)
    far = rng.integers(0, 256, 4096, np.uint8).tobytes()
    text = b"".join(b"the %d-th line of a wide block; " % int(i)
                    for i in rng.integers(0, 500, 2100))[:66000]
    rnd = rng.integers(0, 256, 26000, np.uint8).tobytes()
    return (far + text + far + rnd + b"z" * 40000)[: 1 << 17]


def stage_blocks(blocks, bmax: int):
    """Blocks as a batch (numpy): (block uint8 [B, bmax], n int32 [B])."""
    arr = np.zeros((len(blocks), bmax), np.uint8)
    lens = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        arr[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return arr, lens


# ---------------------------------------------------------------------
# the kernel's decomposition on the host (tests only)


def candidates_model(blk: np.ndarray, n: int):
    """The candidate kernel: the positions below npos = n - 3 stably
    radix-sorted by their 4-byte word in four LSD passes whose digits are
    the bytes p + k, each pass counted per warp over CAND_WARPS chunks of
    sorted indices and scattered at digit-major, warp-minor offsets; then
    the run heads of the sorted order (a head's index carried across the
    warps' chunks) give each position its nearest and second nearest
    previous position with the same word and the first (-1: none).
    Returns (c1, c2, c3) int64 [npos]."""
    npos = max(0, n - 3)
    if npos == 0:
        e = np.zeros(0, np.int64)
        return e, e, e
    b = np.zeros(npos + 4, np.int64)
    b[:npos + 3] = blk[:npos + 3]
    chunk = (npos + 32 * CAND_WARPS - 1) // (32 * CAND_WARPS) * 32
    order = np.arange(npos, dtype=np.int64)
    idx = np.arange(npos, dtype=np.int64)
    warp = idx // chunk
    for k in range(4):
        digit = b[order + k]
        cnt = np.zeros((CAND_WARPS, 256), np.int64)
        np.add.at(cnt, (warp, digit), 1)
        flat = cnt.T.reshape(-1)  # digit-major, warp-minor
        start = (np.cumsum(flat) - flat).reshape(256, CAND_WARPS).T
        # each element's rank among the equal digits before it in its warp
        key = digit * CAND_WARPS + warp
        srt = np.argsort(key, kind="stable")
        first = np.searchsorted(key[srt], key[srt], side="left")
        rank = np.empty(npos, np.int64)
        rank[srt] = np.arange(npos) - first
        new = np.empty(npos, np.int64)
        new[start[warp, digit] + rank] = order
        order = new
    word = b[order] | b[order + 1] << 8 | b[order + 2] << 16 | b[order + 3] << 24
    head = np.ones(npos, bool)
    head[1:] = word[1:] != word[:-1]
    # each warp's last head, carried into the later warps' chunks
    last = [int(np.max(np.where(head[w * chunk : (w + 1) * chunk],
                                idx[w * chunk : (w + 1) * chunk], -1),
                       initial=-1)) for w in range(CAND_WARPS)]
    carry = np.maximum.accumulate([-1] + last[:-1])
    hidx = np.maximum(np.maximum.accumulate(np.where(head, idx, -1)),
                      carry[warp])
    c1 = np.full(npos, -1, np.int64)
    c2 = np.full(npos, -1, np.int64)
    c3 = np.full(npos, -1, np.int64)
    same1 = ~head
    c1[order[same1]] = order[idx[same1] - 1]
    same2 = np.zeros(npos, bool)
    same2[2:] = word[2:] == word[:-2]
    c2[order[same2]] = order[idx[same2] - 2]
    c3[order[same1]] = order[hidx[same1]]
    return c1, c2, c3


def _lcp(blk: np.ndarray, q: int, c: int, limit: int, start: int = 4,
         step: int = LCP_STEP) -> int:
    """The match length of positions q and c (their first ``start`` bytes
    equal), at most ``limit``, compared ``step`` bytes at a time."""
    off = start
    while off < limit:
        m = min(step, limit - off)
        ne = np.flatnonzero(blk[q + off : q + off + m]
                            != blk[c + off : c + off + m])
        if len(ne):
            return off + int(ne[0])
        off += step
    return limit


def entries_model(blk: np.ndarray, n: int, cands):
    """The candidate kernel's last step, a thread a position: each
    candidate's match measured up to CAP bytes; the entry is the best
    (length, candidate) (the longest, on a tie the nearest), or, where a
    match reaches CAP short of the block's end, "long": the candidates
    that reached it, for the walk to measure whole.  Returns (best_len,
    best_cand, long_cands): int64 [npos], [npos], [npos, 3] (-1 where a
    candidate did not reach CAP; all -1 where the entry is not long);
    best_len is 0 where there is no candidate."""
    npos = len(cands[0])
    best_len = np.zeros(npos, np.int64)
    best_cand = np.full(npos, -1, np.int64)
    long_cands = np.full((npos, 3), -1, np.int64)
    b = np.zeros(n + CAP + 4, np.int64)
    b[:n] = blk[:n]
    j = np.arange(CAP)
    for lo in range(0, npos, 8192):  # positions a slice, to bound memory
        q = np.arange(lo, min(npos, lo + 8192))
        room = n - q
        lim = np.minimum(room, CAP)
        lens = []
        for k in range(3):
            c = cands[k][q]
            cc = np.maximum(c, 0)
            stop = ((b[q[:, None] + j] != b[cc[:, None] + j])
                    | (j[None, :] >= lim[:, None]))
            stop[:, :4] = False
            ln = np.where(stop.any(1), stop.argmax(1), CAP)
            lens.append(np.where(c >= 0, np.minimum(ln, lim), 0))
        lens = np.stack(lens, 1)
        bl = lens.max(1)
        first = lens.argmax(1)  # the nearest of the longest
        best_len[q] = bl
        best_cand[q] = np.stack([cands[k][q] for k in range(3)], 1)[
            np.arange(len(q)), first]
        is_long = (bl == CAP) & (room > CAP)
        keep = is_long[:, None] & (lens == CAP)
        long_cands[q] = np.where(keep, np.stack([cands[k][q] for k in
                                                 range(3)], 1), -1)
    return best_len, best_cand, long_cands


def _walk_steps(blk: np.ndarray, n: int, entries, lazy: bool):
    """A walk's three moves over the entries: ``nxt(p, lim)``, the first
    position in [p, lim) with a candidate (else lim); ``step(q)``, the
    copy (pos, len, off) the walk takes at candidate position q, or None
    where the lazy walk defers to q + 1; ``opens(q, b)``, whether that
    step measures a long entry's candidate up to b (a speculative walk of
    a chunk ending at b then stops: the step depends on bytes past b).  A
    long entry's candidates are measured whole, from CAP on, LCP_STEP
    bytes a step; the best is the longest, on a tie the later."""
    best_len, best_cand, long_cands = entries
    npos = len(best_len)

    def lengths(q):
        return [(_lcp(blk, q, int(c), n - q, start=CAP), int(c))
                for c in long_cands[q] if c >= 0]

    def is_long(q):
        return q < npos and best_len[q] > 0 and long_cands[q].max() >= 0

    def best(q):
        if q >= npos or best_len[q] == 0:
            return 0, -1
        if not is_long(q):
            return int(best_len[q]), int(best_cand[q])
        bl, bc = 0, -1
        for ln, c in lengths(q):
            if ln > bl or (ln == bl and c > bc):
                bl, bc = ln, c
        return bl, bc

    has = np.flatnonzero(best_len > 0)

    def nxt(p, lim):
        i = np.searchsorted(has, p)
        return min(int(has[i]), lim) if i < len(has) else lim

    def step(q):
        ln, c = best(q)
        if lazy and best(q + 1)[0] > ln + 1:
            return None
        return q, ln, q - c

    def opens(q, b):
        return any(is_long(r) and any(ln >= b - r for ln, _ in lengths(r))
                   for r in ((q, q + 1) if lazy else (q,)))

    return nxt, step, opens


def walk_model(blk: np.ndarray, n: int, entries, lazy: bool):
    """A walk: from position 1, the next position with a candidate, its
    best candidate, taken, or for the lazy walk deferred when the next
    position's match is longer by 2 or more (``_walk_steps``).  Returns
    the copies [(pos, len, off)]."""
    nxt, step, _ = _walk_steps(blk, n, entries, lazy)
    npos = len(entries[0])
    copies = []
    p = 1
    while p < n:
        q = nxt(p, npos)
        if q >= npos:
            break
        c = step(q)
        if c is None:
            p = q + 1
            continue
        copies.append(c)
        p = q + c[1]
    return copies


def walk_model_chunked(blk: np.ndarray, n: int, entries, lazy: bool,
                       chunk: int = PARSE_CHUNK, meets: list | None = None):
    """One walk as the parse kernel splits it over chunks of ``chunk``
    positions (the chunk k: [k * chunk, (k + 1) * chunk) cut at npos):

      1. a speculative walk a chunk, from its first position (1 for chunk
         0): every state it stands on marked (the positions from each
         state to the next candidate), its copies kept, and its exit, the
         first state at or past the chunk's end; it measures no match past
         the chunk's end, so where a step would (``opens``) it stops open
         at that state, its exit unknown;
      2. the true entries in chunk order: from the previous chunk's true
         exit (1 for chunk 0) the true walk steps until it stands on a
         marked state of the chunk, where it meets the speculative walk:
         from there the two are one walk, and the chunk's exit is the
         speculative walk's (where that stopped open, the true walk walks
         on from the open state to the chunk's end: the tail); a walk
         that meets no marked state steps to the chunk's end itself.
         Each chunk's walk from the previous chunk's speculative exit (its
         link) is taken first, all chunks at once (none after an open
         chunk); the true walk takes a chunk's link where it arrives at
         that exit, and walks the chunk itself elsewhere;
      3. the copy list: per chunk the true walk's own copies, the
         speculative copies from the meeting state on, the tail.

    Returns walk_model's copies.  ``meets``, if given, gets for each
    chunk the true walk stands in the state where the walks met, or None
    where they never met (the true walk walked the chunk itself)."""
    nxt, step, opens = _walk_steps(blk, n, entries, lazy)
    npos = len(entries[0])
    nck = -(-npos // chunk)

    def walk(p, k, marks=None):
        """A true walk from p through chunk k, until a state of marks:
        (its copies, the state where it met them or None, the exit)."""
        b = min((k + 1) * chunk, npos)
        own = []
        while p < b:
            if marks is not None and p in marks:
                return own, p, None
            q = nxt(p, b)
            if q != p:
                p = q
                continue
            c = step(q)
            if c is None:
                p = q + 1
                continue
            own.append(c)
            p = q + c[1]
        return own, None, p

    spec = []
    for k in range(nck):  # 1
        b = min((k + 1) * chunk, npos)
        p = 1 if k == 0 else k * chunk
        copies, states, open_ = [], set(), None
        while p < b:
            q = nxt(p, b)
            states.update(range(p, min(q, b - 1) + 1))
            if q >= b:
                p = q
                break
            if opens(q, b):
                open_, p = q, None
                break
            c = step(q)
            if c is None:
                p = q + 1
                continue
            copies.append(c)
            p = q + c[1]
        spec.append((copies, states, p, open_))

    def meet(p, k):
        """The true walk from p into chunk k to its meeting with the
        speculative walk (exit None where that walk stopped open)."""
        own, met, x = walk(p, k, spec[k][1])
        return own, met, spec[k][2] if met is not None else x

    starts = ([1] + [x for _, _, x, _ in spec])[:nck]
    links = [meet(e0, k) if e0 is not None else None  # 2
             for k, e0 in enumerate(starts)]
    out, e = [], 1
    for k in range(nck):
        entered = e < min((k + 1) * chunk, npos)
        own, met, x = (links[k] if links[k] is not None and e == starts[k]
                       else meet(e, k))
        out += own  # 3
        if met is not None:
            out += [c for c in spec[k][0] if c[0] >= met]
            if spec[k][3] is not None:
                tail, _, x = walk(spec[k][3], k)
                out += tail
        e = x
        if meets is not None and entered:
            meets.append(met)
    return out


def copy_cost(off: int, ln: int) -> int:
    """``encode_np._copy_cost``, and 5 bytes an atom for an offset of
    65,536 or more (copy-4 atoms)."""
    if off < COPY4_OFFSET:
        return _copy_cost(off, ln)
    atoms = 1 + (ln >= 68) * ((ln - 68) // 64 + 1)
    return 5 * (atoms + (ln - 64 * (atoms - 1) > 64))


def emit_copy(out: bytearray, off: int, ln: int) -> None:
    """``reference.emit_copy``, whose chopping an offset of 65,536 or
    more keeps with every atom a copy-4."""
    if off < COPY4_OFFSET:
        reference.emit_copy(out, off, ln)
        return
    tail = bytearray()
    reference.emit_copy(tail, 1 << 11, ln)  # copy-2 atoms of the chopping
    for i in range(0, len(tail), 3):
        out.append(tail[i] | 3)
        out += off.to_bytes(4, "little")


def prune_model(copies, n: int):
    """Two simultaneous-drop passes over the warp's copy list: a copy
    with no copy beside it drops when the merged literal costs no more
    than the literals around it and the copy."""
    for _ in range(2):
        keep = []
        for k, (pos, ln, off) in enumerate(copies):
            prev_end = copies[k - 1][0] + copies[k - 1][1] if k else 0
            nxt = copies[k + 1][0] if k + 1 < len(copies) else n
            a, bg = pos - prev_end, nxt - pos - ln
            elig = (not (a == 0 and k > 0)
                    and not (bg == 0 and k + 1 < len(copies))
                    and _lit_cost(a + ln + bg)
                    <= _lit_cost(a) + copy_cost(off, ln) + _lit_cost(bg))
            if not elig:
                keep.append((pos, ln, off))
        copies = keep
    return copies


def shift_model(copies, n: int):
    """The start shift of each copy (1-3 bytes into its literal where
    that is cheaper) and the emission's size."""
    out, total, prev_end = [], 0, 0
    for pos, ln, off in copies:
        a0 = pos - prev_end
        best_d, best = 0, _lit_cost(a0) + copy_cost(off, ln)
        for d in (1, 2, 3):
            if ln - d < 4:
                break
            cost = _lit_cost(a0 + d) + copy_cost(off, ln - d)
            if cost < best:
                best_d, best = d, cost
        out.append((pos + best_d, ln - best_d, off))
        total += best
        prev_end = pos + ln
    return out, total + _lit_cost(n - prev_end)


def emit_model(blk: np.ndarray, n: int, copies) -> bytes:
    """The emission: per copy its gap literal and chop atoms, then the
    tail literal (the reference's element encodings)."""
    out = bytearray()
    prev_end = 0
    for pos, ln, off in copies:
        if pos > prev_end:
            reference.emit_literal(out, blk[prev_end:pos].tobytes())
        emit_copy(out, off, ln)
        prev_end = pos + ln
    if n > prev_end:
        reference.emit_literal(out, blk[prev_end:n].tobytes())
    return bytes(out)


def encode_blocks_model(block: np.ndarray, n, bmax: int):
    """encode_blocks' result computed as the kernel decomposes it: the
    candidate pass (the sort, then the entries of matches measured up to
    CAP bytes), the greedy and the lazy walk on exact lengths,
    prune and shift per walk, the smaller emission (greedy on a tie).
    Numpy in, numpy out: (comp uint8 [B, emax], comp_len int32 [B], ok
    bool [B])."""
    emax = derived_sizes(bmax)[2]
    nb = block.shape[0]
    comp = np.zeros((nb, emax), np.uint8)
    clen = np.zeros(nb, np.int32)
    ok = np.zeros(nb, bool)
    for i in range(nb):
        m = min(max(int(n[i]), 0), bmax)
        blk = np.asarray(block[i], np.uint8)
        entries = entries_model(blk, m, candidates_model(blk, m))
        parses = [shift_model(prune_model(walk_model(blk, m, entries, lazy),
                                          m), m) for lazy in (False, True)]
        copies, total = min(parses, key=lambda pt: pt[1])
        blob = emit_model(blk, m, copies)
        assert len(blob) == total
        comp[i, : min(total, emax)] = np.frombuffer(blob[:emax], np.uint8)
        clen[i], ok[i] = total, total <= emax
    return comp, clen, ok


def _four_byte_matches(rng, head: bytes, size: int) -> bytearray:
    """``head`` then bytes over the alphabet 0-3 to ``size``, each chosen
    so that no position's candidates (the nearest, the second nearest and
    the first earlier position with its word) match it past 4 bytes."""
    out = bytearray(head)
    seen: dict = {}
    for p in range(len(out) - 4):
        seen.setdefault(bytes(out[p : p + 4]), []).append(p)
    for i in range(len(out), size):
        p = i - 4
        forbid = set()
        if p >= 0:
            w = bytes(out[p:i])
            at = seen.setdefault(w, [])
            forbid = {out[c + 4] for c in {at[0], *at[-2:]}} if at else set()
            at.append(p)
        out.append(int(rng.choice([x for x in range(4) if x not in forbid])))
    return out


def _de_bruijn4() -> bytes:
    """Every word of 4 bytes over the alphabet 0-3 once: 259 bytes."""
    seq, a = [], [0] * 5

    def db(t, p):
        if t > 4:
            if 4 % p == 0:
                seq.extend(a[1 : p + 1])
            return
        a[t] = a[t - p]
        db(t + 1, p)
        for j in range(a[t - p] + 1, 4):
            a[t] = j
            db(t + 1, t)

    db(1, 1)
    return bytes(seq + seq[:3])


def resync_blocks(seed: int, size: int = 65536) -> dict:
    """Hand-made blocks whose walks do not meet inside a chunk, by name.
    "4-byte matches off phase": one byte, every word of 4 bytes over 4
    values once, then bytes over those values chosen so that every
    position's candidates match it exactly 4 bytes: each walk takes copies
    of 4 and keeps its phase mod 4, the true walk at phase 1 from position
    257, every chunk's speculative walk at phase 0 from its first
    position, so none meets the true walk; "crossing match": the same with
    2,600 random bytes at 1/8 of the block, repeated from 1,024 k + 902
    (k = size // 3072): one copy across two chunk ends of 1 KiB (ten of
    PARSE_CHUNK) that ends at phase 2.  ``size`` at least 4,096."""
    rng = np.random.default_rng(seed)
    head = b"\x09" + _de_bruijn4()
    off = bytes(_four_byte_matches(rng, head, size))
    far = rng.integers(0, 256, 2600, np.uint8).tobytes()
    cross = _four_byte_matches(rng, head, size // 8) + far
    cross = _four_byte_matches(rng, cross, size // 3072 * 1024 + 902) + far
    cross = _four_byte_matches(rng, cross, size)
    return {"4-byte matches off phase": off, "crossing match": bytes(cross)}
