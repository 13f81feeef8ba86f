"""Hybrid decode's device half: bytes from host-parsed records.  The CUDA
kernel, its plain version and a CPU model of the kernel's schedule.

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
row, its warps specialised.  A loader warp brings the payload row and
tiles of ``TILE`` records into shared memory (bulk asynchronous copies
through a ring of slots); two literal warps write the tiles' literals
into a shared-memory image of the row, compact each tile's copies and
give each copy its wait mask (``group_waits``: its producers among the
copies of its group of 32); a copy warp runs each group, a lane a copy,
in rounds: the copies whose producers are done run at once.
``execute_records_model`` runs that schedule in numpy and counts each
group's rounds.  On a CPU tensor the wrapper runs the plain version,
the JAX function in torch ops: per-byte record labels from
``out_start``, one source pointer per output byte, pointer doubling
(``resolve_pointers``) until every pointer names a payload byte, one
gather.  There is no other switch.  On the records ``parse_tags`` emits
the three agree byte for byte; on other records none is defined.
"""

from __future__ import annotations

import numpy as np
import torch

from snappy_tpu_torch.kernels.common_par import resolve_pointers

__all__ = ["decode_blocks_pretagged", "decode_blocks_pretagged_plain",
           "edge_cases", "execute_records_model", "group_waits",
           "record_cap", "stage_records"]

# records a ring slot of csrc/pretagged.cu (its kTile): the unit of the
# literal-first order and of the copy groups
TILE = 512

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


def group_waits(d, n, a) -> np.ndarray:
    """Each lane's wait mask in a group of at most 32 compacted copies (in
    stream order: starts ``d``, lengths ``n``, offsets ``a``, 0 for a copy
    that writes zeros), as the kernel's literal warps compute it: bit i set
    for the lanes i below the lane whose outputs ``[d_i, d_i + n_i)`` meet
    its sources ``[d - a, d - a + min(a, n))``, found by two binary
    searches over the group's starts and ends (both increase along a
    parsed row), the upper end capped at the lane itself."""
    d, n, a = (np.asarray(x, np.int64) for x in (d, n, a))
    big = np.iinfo(np.int32).max
    starts = np.full(32, big, np.int64)
    ends = np.full(32, big, np.int64)
    starts[: len(d)] = d
    ends[: len(d)] = d + n
    waits = np.zeros(len(d), np.int64)
    for j in np.flatnonzero(a != 0):
        sl = d[j] - a[j]
        sh = sl + min(a[j], n[j])
        hi = lo = 0
        for step in (16, 8, 4, 2, 1):
            if starts[hi + step - 1] < sh:
                hi += step
            if ends[lo + step - 1] <= sl:
                lo += step
        hi = min(hi, j)
        if lo < hi:
            waits[j] = (1 << hi) - (1 << lo)
    return waits


def execute_records_model(comp, recs, n_tags, dst_len, out_max: int = 65536,
                          group: int = 32):
    """``csrc/pretagged.cu``'s schedule in numpy: the row's literals
    written first (the kernel's literal warps write a tile's literals
    before its copies reach the copy warp; a copy never reads a later
    literal), then per tile of ``TILE`` records the tile's copies,
    compacted and taken ``group`` at a time, a lane each, in rounds: a
    pending copy runs once the copies of its wait mask (``group_waits``,
    its producers in the group) are done, and the copies of a round run at
    once, each reading only bytes that are final.  Records outside the row
    (start past ``min(dst_len, out_max)``, or no length) are dropped, a
    copy's length is cut at the row's end, a copy with an offset outside
    ``[1, d]`` writes zeros and waits for nothing, a literal byte past the
    payload row reads as zero.

    ``comp`` uint8 [B, cmax], ``recs`` int32 [B, T, 4], ``n_tags`` and
    ``dst_len`` int32 [B] (numpy or CPU tensors); ``group`` at most 32 (a
    warp).  Returns (uint8 [B, out_max] numpy rows, a list of B int
    arrays: the rounds each group of the row took, in order)."""
    if not 1 <= group <= 32:
        raise ValueError(f"group must be in [1, 32], got {group}")
    comp, recs, n_tags, dst_len = (
        t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        for t in (comp, recs, n_tags, dst_len))
    nb, cmax = comp.shape
    t_max = recs.shape[1]
    out = np.zeros((nb, out_max), np.uint8)
    rounds = []
    for b in range(nb):
        nt = min(max(int(n_tags[b]), 0), t_max)
        lim = max(0, min(int(dst_len[b]), out_max))
        o = out[b]
        kind, ln, a, d = recs[b, :nt].astype(np.int64).T
        valid = (d >= 0) & (d < lim) & (ln > 0)
        n_w = np.where(valid, np.minimum(ln, lim - d), 0)
        for r in np.flatnonzero(valid & (kind == 0)):
            si = a[r] + np.arange(n_w[r])
            inside = (si >= 0) & (si < cmax)
            o[d[r] : d[r] + n_w[r]] = np.where(
                inside, comp[b, np.clip(si, 0, max(cmax - 1, 0))]
                if cmax else 0, 0)
        row_rounds = []
        is_copy = valid & (kind != 0)
        for base in range(0, nt, TILE):
            cp = base + np.flatnonzero(is_copy[base : base + TILE])
            cd, cn = d[cp], n_w[cp]
            ca = np.where((a[cp] <= 0) | (a[cp] > cd), 0, a[cp])
            for g in range(0, len(cp), group):
                gd, gn, ga = (x[g : g + group] for x in (cd, cn, ca))
                wait = group_waits(gd, gn, ga)
                pending = np.ones(len(gd), bool)
                n_rounds = 0
                while pending.any():
                    pend = sum(1 << int(j) for j in np.flatnonzero(pending))
                    ready = pending & ((wait & pend) == 0)
                    for j in np.flatnonzero(ready):
                        dj, nj, aj = int(gd[j]), int(gn[j]), int(ga[j])
                        o[dj : dj + nj] = (o[dj - aj + np.arange(nj) % aj]
                                           if aj else 0)
                    pending &= ~ready
                    n_rounds += 1
                row_rounds.append(n_rounds)
        o[lim:] = 0
        rounds.append(np.array(row_rounds, np.int64))
    return out, rounds


def edge_cases(seed: int = 0) -> dict:
    """Hand-made record sets for the kernel's schedule, for tests and
    ``chip_smoke.py``: {name: (comp, recs, n_tags, dst_len, out_max)},
    numpy arrays of one row, records as ``native.parse_tags`` lays them
    out (in stream order, covering ``[0, dst_len)``).

    - ``offset1_run``: a byte, then 200 copies of offset 1 (each reads the
      last byte of the one before: a round a copy);
    - ``chain``: 700 copies, each reading exactly the previous copy's
      output, across a tile boundary;
    - ``straddle``: 1,500 records of short literals and copies whose
      sources reach back over group and tile boundaries;
    - ``long_literal``: a 5,000-byte literal (the warp's path), literals of
      40, 33 and 32 bytes, copies of it;
    - ``no_records``: ``n_tags = 0`` and ``dst_len = 0`` over records that
      would write (a stored chunk's row in the hybrid engine);
    - ``dst_short``: ``dst_len`` ends inside a copy, short of the records'
      end;
    - ``out_max_short``: ``out_max`` (1,000, not a multiple of 16) short
      of ``dst_len``, an odd payload width;
    - ``wide_99999``: a 99,999-byte row (built in device memory by the
      kernel) from a 70,016-byte payload;
    - ``far_payload``: a 150,000-byte payload row (too wide to stage in
      shared memory) whose literals come from its far end."""
    rng = np.random.default_rng(seed)

    def build(steps, cmax=None, dst_len=None, out_max=65536, n_tags=None,
              t_cap=None):
        payload, recs, d = bytearray(), [], 0
        for step in steps:
            if isinstance(step, (bytes, bytearray)):
                recs.append((0, len(step), len(payload), d))
                payload += step
                d += len(step)
            else:
                off, ln = step
                recs.append((1, ln, off, d))
                d += ln
        cmax = len(payload) if cmax is None else cmax
        comp = np.zeros((1, cmax), np.uint8)
        comp[0, : len(payload)] = np.frombuffer(bytes(payload), np.uint8)
        arr = np.zeros((1, t_cap or max(len(recs), 1), 4), np.int32)
        arr[0, : len(recs)] = np.array(recs, np.int32).reshape(-1, 4)
        nt = len(recs) if n_tags is None else n_tags
        return (comp, arr, np.array([nt], np.int32),
                np.array([d if dst_len is None else dst_len], np.int32),
                out_max)

    def pad16(n):
        return (n + 15) & ~15

    cases = {}
    cases["offset1_run"] = build([b"x"] + [(1, 64)] * 200, cmax=16)
    chain, prev = [bytes(rng.integers(0, 256, 8, np.uint8))], 8
    for k in range(700):
        ln = 4 + k % 13
        chain.append((prev, ln))
        prev = ln
    cases["chain"] = build(chain, cmax=16)
    steps, d, plen = [], 0, 0
    for k in range(1500):
        if d < 8 or k % 5 == 0:
            lit = bytes(rng.integers(0, 256, int(rng.integers(1, 21)),
                                     np.uint8))
            steps.append(lit)
            d, plen = d + len(lit), plen + len(lit)
        else:
            ln = int(rng.integers(4, 65))
            steps.append((int(rng.integers(1, min(d, 300) + 1)), ln))
            d += ln
    cases["straddle"] = build(steps, cmax=pad16(plen))
    big = bytes(rng.integers(0, 256, 5000, np.uint8))
    cases["long_literal"] = build(
        [big] + [(4999, 64)] * 10 + [big[:40], big[7:40], big[9:41]]
        + [(33, 20), (5000, 64)], cmax=pad16(5000 + 40 + 33 + 32))
    straddle = cases["straddle"]
    recs_nr = straddle[1].copy()
    cases["no_records"] = (straddle[0].copy(), recs_nr,
                           np.array([0], np.int32), np.array([0], np.int32),
                           65536)
    cases["dst_short"] = build(steps, cmax=pad16(plen),
                               dst_len=int(straddle[3][0]) - 37)
    cases["out_max_short"] = build(steps[:400], dst_len=3000, out_max=1000)
    wide = bytes(rng.integers(0, 256, 70000, np.uint8))
    wide_steps = [wide[:40000], (1, 64), (300, 64), wide[40000:]]
    left = 99_999 - (70000 + 128)
    while left > 0:
        ln = min(64, left)
        wide_steps.append((int(rng.integers(1, 70000)), ln))
        left -= ln
    cases["wide_99999"] = build(wide_steps, cmax=70016, out_max=99_999)
    far = bytearray(rng.integers(0, 256, 150_000, np.uint8).tobytes())
    comp, recs, nt, dl, om = build(
        [b"?" * 16] + [(16, 48)] * 40 + [bytes(30)], cmax=150_000)
    # point the literals at the far end of the row
    comp[0] = np.frombuffer(bytes(far), np.uint8)
    recs[0, 0, 2] = 149_000
    recs[0, -1, 2] = 149_960
    cases["far_payload"] = (comp, recs, nt, dl, om)
    return cases


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
