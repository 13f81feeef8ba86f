"""Parallel Snappy block encoder in torch ops: the portable encode engine.

Counterpart of ``snappy_tpu/kernels/encode_jnp.py`` (an XLA program, not
a Pallas kernel), the same program in torch ops on the tensor's device,
with the ``[B]`` batch axis in place of ``vmap``.  Per block:

  1. match finding: 4-gram words -> stable sort -> candidates {prev1,
     prev2, first occurrence} -> unbounded match length by paired
     Rabin-Karp prefix hashes and a 17-step binary search
  2. parse: greedy and lazy successor walks marked by pointer doubling,
     two simultaneous-drop prune passes, the start-shift pass; per block
     the smaller emission wins
  3. emission: elements -> chop atoms -> per-byte formulas
  4. exact verification of every copy byte; a block that fails (a hash
     collision) reports ok=False and the host re-encodes it.

The emission is byte-identical to ``encode_jnp``'s and so to
``kernels/encode_np.py``'s, which states the contract.  The hashes are
uint32 values held in int64 (``common_par.mul32`` for their products);
the sort key keeps JAX's tie of an invalid position (0x7FFFFFFF) with the
word 0xFFFFFFFF, under a stable sort.
"""

from __future__ import annotations

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

__all__ = ["encode_blocks", "encode_block_par", "derived_sizes"]

_I32MAX = 0x7FFFFFFF
I32 = torch.int32


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
    """Reference chopping of a copy: (c64, e60, remf, cost)."""
    c64 = torch.where(length >= 68, torch.div(length - 68, 64,
                                              rounding_mode="floor") + 1, 0)
    rem1 = length - 64 * c64
    e60 = (rem1 > 64).to(I32)
    remf = rem1 - 60 * e60
    final_cost = torch.where((remf >= 12) | (off >= 2048), 3, 2)
    cost = 3 * c64 + 3 * e60 + final_cost
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
    copy_size = torch.where(copy1, 2, 3)

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
        torch.where(brel == 0, ((b_alen - 1) << 2) | 2,
                    torch.where(brel == 1, b_off & 255, (b_off >> 8) & 255)))
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


def encode_blocks(block: torch.Tensor, n: torch.Tensor, bmax: int = 65536):
    """Batched parallel encode on ``block``'s device.

    block: uint8 [B, bmax] padded blocks; n: int [B] valid lengths.
    Returns (comp uint8 [B, emax], comp_len int32 [B], ok bool [B]); rows
    with ok=False must be re-encoded on the host (a hash collision).  The
    output is the element stream only (no varint preamble).
    """
    if block.dtype != torch.uint8 or block.dim() != 2 or block.shape[1] != bmax:
        raise ValueError(f"block must be uint8 [B, {bmax}], got {block.dtype} "
                         f"{tuple(block.shape)}")
    if bmax < 4 or bmax > 1 << 17:
        raise ValueError(f"bmax must be in [4, 2**17], got {bmax}")
    nb = block.shape[0]
    if tuple(n.shape) != (nb,) or n.device != block.device:
        raise ValueError(f"n must be [{nb}] on {block.device}")
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


def encode_block_par(block: bytes, bmax: int | None = None,
                     device=None) -> bytes:
    """Single-block convenience wrapper, ``encode_block_jnp``'s
    counterpart: the element stream of ``block`` (the reference
    encoder's on a hash collision)."""
    from snappy_tpu_torch.device import resolve
    from snappy_tpu_torch.spec import reference

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
