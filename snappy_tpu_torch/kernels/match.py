"""Device match finding: the CUDA kernel and its plain version.

Counterpart of ``snappy_tpu/kernels/pallas_match.py``; the contract is
``snappy_tpu/kernels/match_np.py:find_candidates``.  For every position
``p`` of a block, with ``v[p]`` the little-endian 4-byte word at ``p``,
the candidates are the nearest previous and the first position ``q <
p`` with ``v[q] == v[p]``, packed as the int32 bit pattern of ``near |
first << 16`` (``NONE16`` where there is none); positions ``p >=
npos`` (no whole word in the block) are never candidates and pack
``NONE16 | NONE16 << 16``, which is -1 as an int32.

``find_candidates(words, npos, home=True)`` takes the JAX layout:
``words`` int32 ``[B, slots/512, 128]`` (``stage_words``: each block's
bytes zero-padded to ``slots`` and viewed as int32), ``npos`` int32
``[B]``.  With ``home=True`` it returns the packed candidates in
position order, int32 ``[B, slots/128, 128]``; with ``home=False`` the
sorted pairs of the JAX kernel, int32 ``[B, 2*slots/128, 128]``: the
first half holds the positions in ``(v, position)`` order, the second
the packed value of each, and ``scatter_home`` puts them in position
order on the host.  ``slots`` is a power of two in ``[4096, BMAX]``.

The words are the JAX kernel's to the bit: the word at position ``p``
takes bytes ``(p + j) mod slots``, so the last three positions wrap
round to the block's first bytes where ``match_np.vwords`` reads zeros.
The candidates do not change (those positions are invalid), but the
order of the ``home=False`` pairs does when a block fills its slots.

On a CUDA tensor the wrapper launches ``csrc/match.cu`` (a stable radix
sort of the positions by ``v`` in one CTA per block, in shared memory
and registers); on a CPU tensor it runs the plain version
(``torch.sort`` of int64 keys ``v << 21 | position key``).  There is no
other switch.  ``resident_rows`` is the launch width that fills the
card.

``find_candidates_model`` is the kernel's decomposition on the host, for
the tests: four LSD passes whose digits are the block's bytes, so one
byte histogram gives every pass's bases; per-warp counts, taken for
the next pass as each scatter places its elements, scanned
digit-major, warp-minor; equal digits ranked in order within a warp.
"""

from __future__ import annotations

import numpy as np
import torch

# the constants of snappy_tpu/kernels/match_np.py
BMAX = 65536     # block slots the kernel sorts (pow2, = max block)
NONE16 = 0xFFFF  # packed "no candidate" sentinel
BIG = 1 << 20    # pos key for invalid (tail) slots

__all__ = ["find_candidates", "find_candidates_plain",
           "find_candidates_device", "find_candidates_model",
           "resident_rows", "stage_words", "scatter_home"]

VEC = 128
WARPS = 32  # warps of the kernel's CTA; each owns slots/32 sorted indices

# kernel launches made by find_candidates (one per CUDA call)
launches = 0


def resident_rows(device, slots: int = BMAX) -> int:
    """Blocks the card holds in flight at once for ``slots``-byte blocks
    (SMs x resident CTAs per SM): the devmatch engine's launch width."""
    from snappy_tpu_torch.kernels import _build

    return _build.resident_rows("snc_match_blocks_per_sm", device, slots)


def stage_words(blocks: list[bytes],
                slots: int = BMAX) -> tuple[np.ndarray, np.ndarray]:
    """(w_i32[B,slots/512,128], npos[B]) host staging for a batch:
    each block's bytes zero-padded to ``slots`` and viewed as int32
    words.  slots: power of two >= 4096 (>= every block length);
    smaller sorts for tests, BMAX in production."""
    B = len(blocks)
    assert slots >= 4096 and slots & (slots - 1) == 0
    w = np.zeros((B, slots), np.uint8)
    npos = np.zeros(B, np.int32)
    for i, blk in enumerate(blocks):
        b = np.frombuffer(bytes(blk), np.uint8)
        assert len(b) <= slots
        w[i, : len(b)] = b
        npos[i] = max(len(b) - 3, 0)
    return w.view(np.int32).reshape(B, slots // 512, VEC), npos


def scatter_home(pairs: np.ndarray) -> np.ndarray:
    """Host half of the home=False route: (position, packed) pairs in
    sorted order -> packed candidates in position order.  pairs:
    int32[B, 2*rows_v, VEC]; one vectorized scatter per block."""
    B, two_rows, _ = pairs.shape
    half = two_rows // 2
    key = pairs[:, :half].reshape(B, -1)
    val = pairs[:, half:].reshape(B, -1)
    out = np.empty_like(val)
    for b in range(B):
        out[b, key[b]] = val[b]
    return out


def _check(words, npos) -> int:
    """The block width ``slots`` of a valid batch; raises ValueError."""
    if words.dtype != torch.int32 or words.dim() != 3 or words.shape[2] != VEC:
        raise ValueError(f"words must be int32 [B, slots/512, 128], got "
                         f"{words.dtype} {tuple(words.shape)}")
    nb, rows_w, _ = words.shape
    slots = rows_w * 4 * VEC
    if slots < 4096 or slots > BMAX or slots & (slots - 1):
        raise ValueError(f"slots must be a power of two in [4096, {BMAX}], "
                         f"got {slots}")
    if npos.dtype != torch.int32 or tuple(npos.shape) != (nb,):
        raise ValueError(f"npos must be int32 [{nb}], got {npos.dtype} "
                         f"{tuple(npos.shape)}")
    if npos.device != words.device:
        raise ValueError(f"npos on {npos.device}, words on {words.device}")
    return slots


def find_candidates_plain(words, npos, home: bool = True):
    """Plain torch version: v-words by rolling the bytes, one sort of
    ``v << 21 | position key`` per block, the predecessor and the run
    head in sorted order."""
    slots = _check(words, npos)
    nb = words.shape[0]
    dev = words.device
    blk = words.reshape(nb, slots // 4).contiguous().view(torch.uint8).long()
    v = blk.clone()
    for k in (1, 2, 3):  # byte p + k, wrapping round as the JAX kernel
        v |= torch.roll(blk, -k, 1) << (8 * k)
    pos = torch.arange(slots, device=dev)
    posk = torch.where(pos < npos.long()[:, None], pos, pos + BIG)
    skey, _ = torch.sort((v << 21) | posk, dim=1)
    sv, sp = skey >> 21, skey & ((1 << 21) - 1)
    same_prev = torch.zeros_like(sv, dtype=torch.bool)
    same_prev[:, 1:] = sv[:, 1:] == sv[:, :-1]
    prev = torch.full_like(sp, BIG)
    prev[:, 1:] = sp[:, :-1]
    near = torch.where(same_prev & (prev < BIG), prev, NONE16)
    heads, _ = torch.cummax(torch.where(same_prev, 0, pos.expand(nb, -1)), 1)
    head_p = sp.gather(1, heads)
    first = torch.where(same_prev & (head_p < BIG), head_p, NONE16)
    valid = sp < BIG
    packed = torch.where(valid, near | (first << 16), 0xFFFFFFFF)
    packed = torch.where(packed >= 1 << 31, packed - (1 << 32),
                         packed).to(torch.int32)
    true_pos = sp & (BIG - 1)
    if home:
        out = torch.empty(nb, slots, dtype=torch.int32, device=dev)
        out.scatter_(1, true_pos, packed)
        return out.reshape(nb, slots // VEC, VEC)
    return torch.cat([true_pos.to(torch.int32), packed], 1).reshape(
        nb, 2 * slots // VEC, VEC)


def find_candidates(words, npos, home: bool = True):
    """Packed candidates of a batch (module docstring).  CUDA tensors run
    the kernel, CPU tensors the plain version."""
    global launches
    slots = _check(words, npos)
    if words.device.type == "cpu":
        return find_candidates_plain(words, npos, home)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    from snappy_tpu_torch.kernels import _build

    nb = words.shape[0]
    words, npos = words.contiguous(), npos.contiguous()
    if words.data_ptr() % 16:  # the kernel stages blocks with 16-byte loads
        words = words.clone()
    rows = slots // VEC * (1 if home else 2)
    out = torch.empty(nb, rows, VEC, dtype=torch.int32, device=words.device)
    if nb == 0:
        return out
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = _build.lib().snc_match_cands(
            words.data_ptr(), npos.data_ptr(), slots, int(home),
            out.data_ptr(), nb, stream)
    _build.check(rc, "match_cands")
    launches += 1
    return out


def find_candidates_device(blocks: list[bytes], slots: int = BMAX,
                           home: bool = True, device=None) -> np.ndarray:
    """int32[B, slots] packed candidates (match_np.find_candidates
    contract) for a list of blocks, computed on ``device``.  home=False
    ships the sorted (position, packed) pairs back and scatters them on
    the host: the same result."""
    from snappy_tpu_torch.device import resolve

    dev = resolve(device)
    w_i32, npos = stage_words(blocks, slots)
    out = find_candidates(torch.from_numpy(w_i32).to(dev),
                          torch.from_numpy(npos).to(dev), home)
    out = out.cpu().numpy()
    if home:
        return out.reshape(len(blocks), slots)
    return scatter_home(out)


# ---------------------------------------------------------------------
# the kernel's decomposition on the host (tests only)


def _sort_model(blk: np.ndarray) -> np.ndarray:
    """The kernel's four LSD passes over one block's bytes (uint8
    [slots]): the sorted order of the positions, as int64 [slots]."""
    slots = blk.shape[0]
    mask = slots - 1
    chunk = slots // WARPS
    # pass 0's per-warp counts: the bytes of each warp's chunk; they add
    # up to the byte histogram, which is every pass's digit totals (the
    # digits of pass k are bytes (p + k) mod slots for every p)
    counts = np.stack([np.bincount(blk[w * chunk : (w + 1) * chunk],
                                   minlength=256) for w in range(WARPS)])
    total = counts.sum(0)
    base = np.cumsum(total) - total
    order = np.arange(slots)
    for k in range(4):
        d = blk[(order + k) & mask].astype(np.int64).reshape(WARPS, chunk)
        # start offsets, digit-major, warp-minor
        start = base[None, :] + np.cumsum(counts, 0) - counts
        # a warp walks its sorted indices 32 at a time; equal digits take
        # the next places in lane order: the rank among earlier equal
        # digits of its chunk
        srt = np.argsort(d, axis=1, kind="stable")
        ds = np.take_along_axis(d, srt, 1)
        rank = np.empty_like(d)
        for w in range(WARPS):
            rank[w, srt[w]] = np.arange(chunk) - np.searchsorted(ds[w], ds[w])
        at = (np.take_along_axis(start, d, 1) + rank).reshape(-1)
        new = np.empty(slots, np.int64)
        new[at] = order
        # the scatter counts the next pass's digits by the warp that will
        # own each element's new index
        counts = np.zeros((WARPS, 256), np.int64)
        np.add.at(counts, (at // chunk, blk[(order + k + 1) & mask]), 1)
        order = new
    return order


def find_candidates_model(words: np.ndarray, npos: np.ndarray,
                          home: bool = True) -> np.ndarray:
    """find_candidates's result computed as the kernel decomposes it:
    the four passes of ``_sort_model``, then each sorted element's
    predecessor and run head.  Numpy in (``stage_words``' arrays), numpy
    out, the layouts of find_candidates."""
    nb = words.shape[0]
    slots = words.shape[1] * 4 * VEC
    blks = np.ascontiguousarray(words).view(np.uint8).reshape(nb, slots)
    pos = np.arange(slots)
    out = np.empty((nb, slots if home else 2 * slots), np.uint32)
    for b in range(nb):
        blk = blks[b]
        order = _sort_model(blk)
        v = np.zeros(slots, np.uint32)
        for j in range(4):
            v |= blk[(pos + j) & (slots - 1)].astype(np.uint32) << (8 * j)
        sv = v[order]
        head = np.ones(slots, bool)
        head[1:] = sv[1:] != sv[:-1]
        head_idx = np.maximum.accumulate(np.where(head, pos, 0))
        prev = np.concatenate([[0], order[:-1]])
        first = order[head_idx]
        ok = order < npos[b]
        near = np.where(~head & (prev < npos[b]), prev, NONE16)
        first = np.where(~head & (first < npos[b]), first, NONE16)
        packed = np.where(ok, near | (first << 16), 0xFFFFFFFF)
        if home:
            out[b, order] = packed
        else:
            out[b, :slots] = order
            out[b, slots:] = packed
    return out.view(np.int32).reshape(nb, -1, VEC)
