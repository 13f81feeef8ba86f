"""Wave-group decode: the CUDA kernel and its plain version.

Counterpart of ``snappy_tpu/kernels/decode_wavegroup.py``.  The host
parses a raw stream into tag records (``native.parse_tags``) and plans
them into groups of up to ``SLOTS`` independent copies of at most 128
bytes (``plan_waves`` / ``native.plan_waves``); the device runs the
groups in order.  A slot is two int32 words, ``src | is_out << 17`` and
``dst | len << 17``: it copies ``len`` bytes to ``out[dst:]`` from
``comp[src:]`` (a literal piece) or from ``out[src:]`` (a copy piece),
and an empty slot has ``len == 0``.

``decode_blocks_wavegroup(comp, words, ngroups, out_max)`` takes the
JAX layout as it is: ``comp`` uint8 ``[B, cmax]``, ``words`` int32
``[B, G/8, 128]`` (``pack_plan``: group ``g`` is lanes ``(g % 8) * 16
..+15`` of row ``g // 8``), ``ngroups`` int32 ``[B]``, and returns
uint8 ``[B, out_max]``: the bytes the plan writes, zero everywhere
else.  Any ``B``, ``cmax``, ``out_max`` and ``G`` (a multiple of 8)
are taken.

Plans are held to the planner's invariants, which make every order of
execution within a group give the same bytes: a used slot copies 1-128
bytes, its destination lies in ``[d0, d0 + SPAN_BYTES]`` with ``d0``
the destination of the group's slot 0, a copy piece's source ends at or
before ``d0`` (so it reads bytes of earlier groups only), a literal
piece's source lies inside ``comp``'s row, and the destinations of all
used slots, in group-then-slot order, tile ``[0, total)`` with
``total <= out_max``.  The plain version raises ValueError on a plan
that breaks one (as ``decode_seq`` does for its bounds).  The JAX
kernel reads a copy source from the output as it stood before the group
and leaves bytes past the plan unspecified; the port zeroes them, so
compare with JAX on ``out[:, :dlen]``.  The CUDA kernel does not check;
it stays inside its rows whatever the plan (bytes past a row read as
zero, writes past it are dropped).

On a CUDA tensor the wrapper launches ``csrc/wavegroup.cu``; on a CPU
tensor it runs the plain version.  There is no other switch.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "SLOTS",
    "SPAN_BYTES",
    "WAVE_G_CAP",
    "plan_waves",
    "execute_waves_np",
    "pack_plan",
    "stage_waves",
    "decode_blocks_wavegroup",
    "decode_blocks_wavegroup_plain",
]

SLOTS = 8
WAVE_G_CAP = 8192   # groups per row the staging plans at most
SPAN_BYTES = 1024   # output span of one group (the JAX kernel's window)
VEC = 128

_M17 = (1 << 17) - 1

# kernel launches made by decode_blocks_wavegroup (one per CUDA call)
launches = 0


def plan_waves(recs: np.ndarray, n_tags: int, cap_groups: int | None = None):
    """Plan wave groups from sn_parse_tags records.

    recs: int32[T, 4] rows (kind, out_len, offset|lit_src, out_start).
    Returns (words int32[G, SLOTS*2], n_groups) or None if the plan
    exceeds cap_groups (caller falls back to another engine).
    Empty slots have len 0 (masks select nothing).
    """
    groups: list[list[tuple[int, int, int, int]]] = []
    cur: list[tuple[int, int, int, int]] = []
    d0 = 0

    def flush():
        nonlocal cur
        if cur:
            groups.append(cur)
            cur = []

    def admit(src: int, dst: int, ln: int, is_out: int):
        nonlocal cur, d0
        need_new = (
            len(cur) == SLOTS
            or (is_out and src + ln > d0)
            or (dst + ln - d0 > SPAN_BYTES)
        )
        if need_new or not cur:
            flush()
            d0 = dst
        cur.append((src, dst, ln, is_out))

    for t in range(n_tags):
        kind, out_len, arg, out_start = (
            int(recs[t, 0]), int(recs[t, 1]), int(recs[t, 2]), int(recs[t, 3])
        )
        if kind == 0:  # literal from comp at arg
            pos = 0
            while pos < out_len:
                ln = min(128, out_len - pos)
                admit(arg + pos, out_start + pos, ln, 0)
                pos += ln
        else:  # copy with offset arg
            off = arg
            d = out_start
            remaining = out_len
            cur_off = off
            while remaining > 0:
                ln = min(cur_off, remaining, 128)
                admit(d - cur_off, d, ln, 1)
                d += ln
                remaining -= ln
                cur_off += ln
        if cap_groups is not None and len(groups) > cap_groups:
            return None
    flush()
    if cap_groups is not None and len(groups) > cap_groups:
        return None

    g = len(groups)
    words = np.zeros((max(g, 1), SLOTS * 2), dtype=np.int32)
    for gi, grp in enumerate(groups):
        for k, (src, dst, ln, is_out) in enumerate(grp):
            words[gi, 2 * k] = src | (is_out << 17)
            words[gi, 2 * k + 1] = dst | (ln << 17)
    return words, g


def execute_waves_np(words: np.ndarray, n_groups: int, comp: np.ndarray,
                     dst_len: int) -> np.ndarray:
    """Numpy contract for the kernel: replay a plan exactly as the
    pallas kernel does (group-ordered, slot-ordered composition)."""
    out = np.zeros(dst_len + 2 * 128, dtype=np.uint8)
    for g in range(n_groups):
        for k in range(SLOTS):
            w1 = int(words[g, 2 * k])
            w2 = int(words[g, 2 * k + 1])
            ln = w2 >> 17
            if ln == 0:
                continue
            src = w1 & _M17
            is_out = (w1 >> 17) & 1
            dst = w2 & _M17
            buf = out if is_out else comp
            out[dst : dst + ln] = buf[src : src + ln]
    return out[:dst_len]


def pack_plan(words: np.ndarray, n_groups: int, g_cap: int) -> np.ndarray:
    """Pack a [G, SLOTS*2] plan into the kernel's row layout:
    group g lives at row g//8, lanes (g%8)*16 .. +15 of a
    [g_cap//8, 128] int32 array."""
    assert g_cap % 8 == 0 and n_groups <= g_cap
    out = np.zeros((g_cap // 8, VEC), dtype=np.int32)
    flat = out.reshape(g_cap, 16)
    flat[:n_groups] = words[:n_groups]
    return out


def stage_waves(streams, g_cap: int = WAVE_G_CAP, device="cpu"):
    """``(comp, words, ngroups)`` for a batch of raw Snappy streams, or
    None when any stream's plan needs more than ``g_cap`` groups (never
    a truncated plan).  Each stream is parsed (``native.parse_tags``)
    and planned (``native.plan_waves``); ``comp`` holds the streams
    whole (the records address them from byte 0) in rows as wide as the
    longest, rounded up to 128 bytes, and ``words`` is as wide as the
    batch's largest plan, rounded up to 8 groups.  Raises on a corrupt
    stream.  The native calls release the GIL, so batches stage in
    parallel from a thread pool."""
    from snappy_tpu import native
    from snappy_tpu.spec.format import read_uvarint

    nb = len(streams)
    cmax = max([len(s) for s in streams] + [1])
    cmax = -(-cmax // VEC) * VEC
    rec = np.empty((cmax // 2 + 2, 4), np.int32)
    plan = np.zeros((g_cap, 2 * SLOTS), np.int32)
    comp = np.zeros((nb, cmax), np.uint8)
    ngroups = np.zeros(nb, np.int32)
    plans = []
    for i, s in enumerate(streams):
        dlen, hdr = read_uvarint(s, 0)
        nt = native.parse_tags(s, hdr, dlen, rec)
        g = native.plan_waves(rec, nt, plan)
        if g is None:
            return None
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
        ngroups[i] = g
        plans.append(plan[:g].copy())
    width = max(-(-int(ngroups.max(initial=0)) // 8) * 8, 8)
    words = np.zeros((nb, width, 2 * SLOTS), np.int32)
    for i, p in enumerate(plans):
        words[i, : len(p)] = p

    def put(a):
        return torch.from_numpy(a).to(device)

    return put(comp), put(words.reshape(nb, width // 8, VEC)), put(ngroups)


def _check(comp, words, ngroups, out_max: int) -> None:
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError(f"comp must be uint8 [B, cmax], got {comp.dtype} "
                         f"{tuple(comp.shape)}")
    nb = comp.shape[0]
    if (words.dtype != torch.int32 or words.dim() != 3
            or words.shape[0] != nb or words.shape[2] != VEC):
        raise ValueError(f"words must be int32 [{nb}, G/8, 128], got "
                         f"{words.dtype} {tuple(words.shape)}")
    if ngroups.dtype != torch.int32 or tuple(ngroups.shape) != (nb,):
        raise ValueError(f"ngroups must be int32 [{nb}], got "
                         f"{ngroups.dtype} {tuple(ngroups.shape)}")
    for name, t in (("words", words), ("ngroups", ngroups)):
        if t.device != comp.device:
            raise ValueError(f"{name} on {t.device}, comp on {comp.device}")
    if out_max < 0:
        raise ValueError(f"out_max must be >= 0, got {out_max}")


def _slots(words):
    """(src, is_out, dst, ln) int64 [B, G, SLOTS] of a [B, G/8, 128]
    plan (ln read as the unsigned top 15 bits, as the JAX kernel does)."""
    nb, rows, _ = words.shape
    w = words.reshape(nb, rows * 8, SLOTS, 2).long() & 0xFFFFFFFF
    w1, w2 = w[..., 0], w[..., 1]
    return w1 & _M17, (w1 >> 17) & 1, w2 & _M17, w2 >> 17


def _check_plan(src, is_out, dst, ln, ngroups, cmax: int, out_max: int):
    """Raise ValueError unless every row's plan keeps the invariants of
    the module docstring."""
    nb, ncap = ln.shape[:2]
    ng = ngroups.long()
    if bool((ng < 0).any()) or bool((ng > ncap).any()):
        raise ValueError(f"ngroups must lie in [0, {ncap}], got "
                         f"{ngroups.tolist()}")
    gidx = torch.arange(ncap, device=ln.device)
    live = gidx[None, :, None] < ng[:, None, None]
    used = live & (ln > 0)
    d0 = dst[:, :, :1]
    bad = used & ((ln > 128) | (dst < d0) | (dst + ln - d0 > SPAN_BYTES))
    bad |= used & (is_out == 1) & (src + ln > d0)
    bad |= used & (is_out == 0) & (src + ln > cmax)
    ln_live = torch.where(live, ln, 0).reshape(nb, ncap * SLOTS)
    at = (torch.cumsum(ln_live, 1) - ln_live).reshape(ln.shape)
    bad |= used & (dst != at)
    if bool(bad.any()):
        b, g, k = (int(x) for x in bad.nonzero()[0])
        raise ValueError(
            f"row {b}, group {g}, slot {k}: plan breaks the planner's "
            f"invariants (src {int(src[b, g, k])}, is_out "
            f"{int(is_out[b, g, k])}, dst {int(dst[b, g, k])}, len "
            f"{int(ln[b, g, k])})")
    total = ln_live.sum(1)
    if bool((total > out_max).any()):
        raise ValueError(f"plans write {total.tolist()} bytes, out_max is "
                         f"{out_max}")


def decode_blocks_wavegroup_plain(comp, words, ngroups, out_max: int):
    """Plain torch version: checks the plan, then runs group index g of
    every row at once (one gather of all slots' sources, then one
    scatter), g = 0, 1, ... up to the largest ``ngroups``."""
    _check(comp, words, ngroups, out_max)
    nb, cmax = comp.shape
    src, is_out, dst, ln = _slots(words)
    _check_plan(src, is_out, dst, ln, ngroups, cmax, out_max)
    dev = comp.device
    # column out_max takes the writes of unused lanes
    out = torch.zeros(nb, out_max + 1, dtype=torch.uint8, device=dev)
    comp_z = torch.cat([comp, torch.zeros(nb, 1, dtype=torch.uint8,
                                          device=dev)], 1)
    lane = torch.arange(VEC, device=dev)
    ng = ngroups.long()
    for g in range(int(ng.max()) if nb else 0):
        on = (ng > g)[:, None, None] & (lane < ln[:, g, :, None])
        s = (src[:, g, :, None] + lane).reshape(nb, -1)
        d = torch.where(on, dst[:, g, :, None] + lane, out_max).reshape(nb, -1)
        from_out = out.gather(1, s.clamp(max=out_max))
        from_comp = comp_z.gather(1, s.clamp(max=cmax))
        val = torch.where(is_out[:, g, :, None].bool().expand(-1, -1, VEC)
                          .reshape(nb, -1), from_out, from_comp)
        out.scatter_(1, d, val)
    return out[:, :out_max].contiguous()


def decode_blocks_wavegroup(comp, words, ngroups, out_max: int):
    """Run a batch of wave plans; returns uint8 ``[B, out_max]``.  CUDA
    tensors run the kernel, CPU tensors the plain version.  ``comp``
    may be a row-strided view (its pitch is ``comp.stride(0)``)."""
    global launches
    _check(comp, words, ngroups, out_max)
    if comp.device.type == "cpu":
        return decode_blocks_wavegroup_plain(comp, words, ngroups, out_max)
    if comp.device.type != "cuda":
        raise ValueError(f"unsupported device {comp.device}")
    from snappy_tpu_torch.kernels import _build

    nb, cmax = comp.shape
    if nb and cmax and comp.stride(1) != 1:
        raise ValueError("comp must be contiguous along the row")
    words, ngroups = words.contiguous(), ngroups.contiguous()
    out = torch.empty(nb, out_max, dtype=torch.uint8, device=comp.device)
    if nb == 0:
        return out
    with torch.cuda.device(comp.device):
        stream = torch.cuda.current_stream(comp.device).cuda_stream
        rc = _build.lib().snc_wavegroup(
            comp.data_ptr(), comp.stride(0), cmax, words.data_ptr(),
            words.shape[1] * 8, ngroups.data_ptr(), out.data_ptr(), out_max,
            nb, stream)
    _build.check(rc, "wavegroup")
    launches += 1
    return out
