"""Shared helpers of the parallel decoder and encoder: byte shifting,
scans, pointer doubling, and the Rabin-Karp hash constants.

Counterpart of ``snappy_tpu/kernels/common_jnp.py``, with the leading
``[B]`` batch axis in place of ``vmap``: every function works on the
last axis of ``[B, n]`` tensors, on whatever device they lie.

The JAX helpers compute the hashes in uint32 with wraparound; PyTorch
has no general uint32 arithmetic, so here a uint32 value is an int64
in ``[0, 2**32)`` and every product of two such values goes through
:func:`mul32` (one factor split into 16-bit halves, so no int64 product
passes 2**49).

The JAX doubling loops exit early once a round changes nothing; these
run their full ``rounds`` instead.  The answer is the same: a round
that adds no mark (or resolves no pointer) is a fixed point of every
later round, and the fixed count needs no device-to-host read per round.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# the two odd multipliers of the paired u32 rolling hash (common_jnp's)
R_A = np.uint32(0x01000193)  # FNV-32 prime
R_B = np.uint32(0x85EBCA77)  # Murmur3 c1 (odd)

_MAX_POW = 1 << 17  # covers any block this port hashes
MASK32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _pow_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """R^i and R^-i mod 2^32 for both multipliers (uint32)."""
    out = []
    for r in (R_A, R_B):
        pw = np.empty(_MAX_POW, dtype=np.uint32)
        pw[0] = 1
        with np.errstate(over="ignore"):
            np.multiply.accumulate(np.full(_MAX_POW - 1, r, dtype=np.uint32),
                                   out=pw[1:])
            x = r
            for _ in range(5):  # Newton: x = r^-1 mod 2^32
                x = x * (np.uint32(2) - r * x)
            ipw = np.empty(_MAX_POW, dtype=np.uint32)
            ipw[0] = 1
            np.multiply.accumulate(np.full(_MAX_POW - 1, x, dtype=np.uint32),
                                   out=ipw[1:])
        out += [pw, ipw]
    return tuple(out)  # type: ignore[return-value]


_table_cache: dict = {}


def pow_table(k: int, n: int, device) -> torch.Tensor:
    """Entry ``k`` of :func:`_pow_tables` (0: R_A^i, 1: R_A^-i, 2: R_B^i,
    3: R_B^-i), its first ``n`` values as int64 on ``device``."""
    key = (k, n, str(device))
    if key not in _table_cache:
        t = _pow_tables()[k]
        if n > len(t):
            # a 2**17-byte block hashes 2**17 + 1 prefixes: the powers
            # go on past JAX's tables (whose encoder stops one short)
            step = np.full(n - len(t), t[1], dtype=np.uint32)
            with np.errstate(over="ignore"):
                step[0] = t[-1] * t[1]
                t = np.concatenate([t, np.multiply.accumulate(step)])
        _table_cache[key] = torch.from_numpy(
            t[:n].astype(np.int64)).to(device)
    return _table_cache[key]


def mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` of int64 tensors holding values in ``[0,
    2**32)``, exact: b is split into 16-bit halves."""
    lo = b & 0xFFFF
    hi = b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def prefix_hashes(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """H[:, i] = hash of b[:, :i] for both multipliers, via the closed
    form H[i] = Rinv^{n-i} * cumsum(b[j] * R^{n-1-j}); ``b`` uint8 ``[B,
    n]``.  Returns (Ha, Hb), int64 ``[B, n + 1]`` holding uint32 values."""
    nb, n = b.shape
    dev = b.device
    b64 = b.to(torch.int64)
    out = []
    for k in (0, 2):
        rp = pow_table(k, n + 1, dev)
        rip = pow_table(k + 1, n + 1, dev)
        weighted = b64 * rp[:n].flip(0)  # < 2**40 a term
        s = torch.cat([torch.zeros(nb, 1, dtype=torch.int64, device=dev),
                       torch.cumsum(weighted, dim=1) & MASK32], dim=1)
        out.append(mul32(s, rip.flip(0)))
    return out[0], out[1]


def shifted(b: torch.Tensor, k: int, fill=0) -> torch.Tensor:
    """b shifted left by k along the last axis: out[..., i] = b[..., i+k],
    ``fill`` past the end."""
    if k == 0:
        return b
    pad = torch.full(b.shape[:-1] + (k,), fill, dtype=b.dtype, device=b.device)
    return torch.cat([b[..., k:], pad], dim=-1)


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis, in x's dtype (int32
    wraps as it does in JAX)."""
    c = torch.cumsum(x, dim=-1).to(x.dtype)
    return torch.cat([torch.zeros_like(x[..., :1]), c[..., :-1]], dim=-1)


def _start_index(start, nb: int, size: int, device) -> torch.Tensor:
    """``start`` (an int or a ``[B]`` tensor) clipped to [0, size] as an
    int64 ``[B, 1]`` index."""
    s = torch.as_tensor(start, device=device).to(torch.int64)
    return s.expand(nb).reshape(nb, 1).clamp(0, size)


def _spread(mark: torch.Tensor, jump: torch.Tensor) -> torch.Tensor:
    """One marking round: mark[jump[p]] |= mark[p] (int32 0/1 marks)."""
    return (mark + torch.zeros_like(mark).scatter_add_(1, jump, mark)).clamp(max=1)


def mark_orbit(nxt: torch.Tensor, start, rounds: int) -> torch.Tensor:
    """Boolean ``[B, size]`` mask of positions reachable from ``start`` by
    iterating the successor function ``nxt`` (``[B, size]``, values
    ``> p`` with ``size`` the absorbing sentinel) by pointer doubling,
    ``rounds`` rounds."""
    nb, size = nxt.shape
    dev = nxt.device
    jump = torch.cat([nxt.to(torch.int64).clamp(0, size),
                      torch.full((nb, 1), size, dtype=torch.int64, device=dev)],
                     dim=1)
    mark = torch.zeros(nb, size + 1, dtype=torch.int32, device=dev)
    mark.scatter_(1, _start_index(start, nb, size, dev), 1)
    for _ in range(rounds):
        # unmarked positions jump to the absorbing slot, as JAX's
        # where(mark, jump, size)
        mark = _spread(mark, torch.where(mark > 0, jump, size))
        jump = jump.gather(1, jump)
    return mark[:, :size] > 0


def mark_orbits2(nxt2: torch.Tensor, start, rounds: int) -> torch.Tensor:
    """mark_orbit for TWO successor functions in one doubling loop.
    ``nxt2``: ``[B, 2, size]`` with values in [p+1, size].  The two rows
    lie flat with one absorbing slot after each, so jumps cannot leak
    from one to the other; returns bool ``[B, 2, size]``."""
    nb, _, size = nxt2.shape
    dev = nxt2.device
    w = size + 1
    flat = nxt2.to(torch.int64).clamp(0, size) + torch.tensor(
        [[0], [w]], dtype=torch.int64, device=dev)
    sent = torch.full((nb, 1), size, dtype=torch.int64, device=dev)
    jump = torch.cat([flat[:, 0], sent, flat[:, 1], sent + w], dim=1)
    mark = torch.zeros(nb, 2 * w, dtype=torch.int32, device=dev)
    s = _start_index(start, nb, size, dev)
    mark.scatter_(1, s, 1)
    mark.scatter_(1, s + w, 1)
    for _ in range(rounds):
        mark = _spread(mark, torch.where(mark > 0, jump, size))
        jump = jump.gather(1, jump.clamp(0, 2 * w - 1))
    return torch.stack([mark[:, :size], mark[:, w : w + size]], dim=1) > 0


def resolve_pointers(ptr: torch.Tensor, rounds: int) -> torch.Tensor:
    """Pointer doubling along the last axis for ``rounds`` rounds:
    negative entries are terminal, non-negative entries chase
    ptr[ptr]."""
    n = ptr.shape[-1]
    for _ in range(rounds):
        chased = ptr.gather(-1, ptr.clamp(0, n - 1).to(torch.int64))
        ptr = torch.where(ptr >= 0, chased, ptr)
    return ptr


def bytes_to_u32_words(b: torch.Tensor) -> torch.Tensor:
    """Little-endian 4-gram value at every position of uint8 ``[B, n]``
    (zeros past the end), as int64 in ``[0, 2**32)``."""
    b64 = b.to(torch.int64)
    return (b64 | (shifted(b64, 1) << 8) | (shifted(b64, 2) << 16)
            | (shifted(b64, 3) << 24))
