"""What a kernel launch costs and the least it could cost: the helpers
that ``chip_smoke.py`` and the profilers of this folder share.

- ``kernel_bytes``: the bytes a kernel's function must move for one
  launch's arguments, so its bound is ``kernel_bytes / HBM_BYTES_PER_S``;
- ``profiled``: the profiler's kernel records of a call, counted, and
  their mean: a card time that stays right when the profiler drops
  records, as it does now and then (the sum of every device interval
  over the launches, its ``device_ms_per_call``, then reads low);
- ``kernel_split``: every kernel a call launches, by name, its records
  and their mean (what sets the pace of a function of several kernels);
- ``replay``: CUDA-event and host-clock time of launches run back to back;
- ``keep``: a launch's argument copied for a later replay.

Imports torch and the port's kernel modules only inside the functions,
so a profiler that runs another checkout's package (``--root``) loads
this file by path and measures that package with it.
"""

from __future__ import annotations

import time

# H100 SXM device memory rate (NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def flat_copied_bytes(b_u8, meta, starts, ntrips, dst_max: int,
                      out_rows: int) -> int:
    """Bytes of B that a flat plan's valid pieces copy to ``[0,
    dst_max)``: each piece's lanes whose destination lies before
    ``dst_max`` and whose source lies inside B (a source past B gives 0,
    read from nowhere).  The arithmetic of ``decode_blocks_flat_plain``,
    counted per piece rather than per byte."""
    import torch

    from snappy_tpu_torch.kernels import decode_flat as kf

    nb, nbytes = b_u8.shape
    trip_cap = meta.shape[1] // (2 * kf.NSUB)
    n = (ntrips.to(torch.int64) & 0xFFFF).clamp(max=trip_cap)
    t_used = int(n.max()) if nb else 0
    if t_used == 0:
        return 0
    m = meta.to(torch.int64).reshape(nb, trip_cap, 2, kf.NSUB, kf.VEC)
    a_w, b_w = m[:, :t_used, 0], m[:, :t_used, 1]
    st = starts.to(torch.int64).reshape(nb, 8 * kf.VEC)[:, : kf.NSUB * t_used]
    st = st.reshape(nb, t_used, kf.NSUB)
    S = st & 1023
    Dq = (st >> 10) & 1023
    D = Dq.clamp(max=out_rows - kf.VEC)
    t_idx = torch.arange(t_used, device=b_u8.device)
    valid = (((b_w & kf._VALID) != 0)
             & (t_idx[None, :] < n[:, None])[..., None, None])
    phi = (kf.VEC - ((a_w >> 7) & 127)) & (kf.VEC - 1)
    src0 = (S[..., None] + (a_w & 127)) * kf.VEC + phi
    dst0 = (D[..., None] + ((b_w >> 14) & 127) + (Dq - D)[..., None]) * kf.VEC
    dphi = b_w & 127
    length = ((b_w >> 7) & 127) + 1
    # lanes dphi .. dphi + length - 1 while dst0 + lane < dst_max and
    # src0 + lane < nbytes
    room = torch.minimum(dst_max - dst0, nbytes - src0) - dphi
    return int(torch.where(valid, room.clamp(min=0).minimum(length), 0).sum())


def keep(x):
    """A copy of a recorded launch's argument (the runtime reuses its
    buffers), for its replay: a tensor's values in a new tensor of its
    shape, a view of row stride 0 (the seq engine's span of a batch)
    still one, over one copy of its row; anything else as it is."""
    import torch

    if not torch.is_tensor(x):
        return x
    if x.dim() == 2 and x.shape[0] and x.stride(0) == 0:
        return x[0].clone().expand(x.shape)
    return x.clone()


def kernel_bytes(name: str, args, out_max: int = 65536,
                 out_rows: int = 520) -> int:
    """Bytes a kernel's function must move for ``args`` (its wrapper's
    positional arguments): each input byte the result depends on read
    once, each output byte written once.  Rows count their stream or
    block lengths, not their padded widths, a flat plan the B bytes
    its pieces copy, and host-parsed records (``decode_pretagged``) the
    payload bytes their literals read plus 16 bytes a record; outputs
    count whole rows, which the functions
    define (zeros after the data).  ``decode_blocks`` and
    ``encode_blocks`` are the jnp engines' batches (``decode_par``,
    ``encode_par``: ``csrc/decode_par.cu``'s kernels and the record
    executor, ``csrc/encode_par.cu``'s three; the bytes are the
    function's, not the kernels' scratch): a decode reads each row's element
    stream and writes its rows and error codes, an encode reads each
    block and writes its element row (``encode_par.derived_sizes``'
    ``emax`` wide), length and flag.  ``frame_records`` reads each
    record's body (the stored chunk or the element), a length, an
    element length and a CRC a row, and writes the records and an end
    offset a row.
    ``out_max`` is the output row's bytes (the flat kernel's
    ``dst_max``), ``out_rows`` the flat kernel's compose panel."""
    import torch

    from snappy_tpu_torch.kernels import decode_flat as kf
    from snappy_tpu_torch.kernels import encode_seq as kes
    from snappy_tpu_torch.kernels import match as km

    nb = args[0].shape[0]
    if name == "crc32c_rows":
        rows, lens = args
        return int(lens.sum()) + _nbytes(lens) + 8 * nb
    if name == "flat_exec":
        b_u8, meta, starts, ntrips = args
        trips = int((ntrips & 0xFFFF).sum())
        per_trip = 2 * kf.NSUB * kf.VEC * 4 + kf.NSUB * 4
        return flat_copied_bytes(*args, out_max, out_rows) \
            + trips * per_trip + _nbytes(ntrips) + nb * out_max
    if name == "seq_decode":
        comp, starts, clens, dlens = args
        used = clens.clamp(0, comp.shape[1]) - starts.clamp(0, comp.shape[1])
        return int(used.clamp(min=0).sum()) + 12 * nb + nb * (out_max + 4)
    if name == "seq_encode":
        blocks, lens = args
        return int(lens.sum()) + 4 * nb \
            + nb * (kes.comp_width(blocks.shape[1]) + 8)
    if name == "wavegroup":
        comp, words, ngroups = args
        # a row's stream ends at its last nonzero byte (or a few bytes on)
        idx = torch.arange(1, comp.shape[1] + 1, device=comp.device)
        used = ((comp != 0) * idx).amax(dim=1)
        return int(used.sum()) + int(ngroups.sum()) * 16 * 4 \
            + _nbytes(ngroups) + nb * out_max
    if name == "decode_pretagged":
        comp, recs, n_tags, dst_len = args
        valid = (torch.arange(recs.shape[1], device=recs.device)[None, :]
                 < n_tags[:, None])
        # the payload bytes the literal records read, 16 B a record
        lit = torch.where(valid & (recs[..., 0] == 0), recs[..., 1], 0)
        return int(lit.sum()) + 16 * int(n_tags.sum()) \
            + _nbytes(n_tags) + _nbytes(dst_len) + nb * out_max
    if name == "decode_blocks":
        comp, start, comp_len, dst_len = args
        cmax = comp.shape[1]
        used = comp_len.clamp(0, cmax) - start.clamp(0, cmax)
        return int(used.clamp(min=0).sum()) + 12 * nb + nb * (out_max + 4)
    if name == "encode_blocks":
        from snappy_tpu_torch.kernels import encode_par as ep

        block, n = args
        emax = ep.derived_sizes(block.shape[1])[2]
        return int(n.sum()) + 4 * nb + nb * (emax + 4 + 1)
    if name == "frame_records":
        from snappy_tpu_torch.kernels import frame_records as kfr

        rows, lens, comp, clens, crc = args
        n, c, _vlen, raw, body = kfr.layout(lens, clens, rows.shape[1],
                                             comp.shape[1])
        return int(n[raw].sum() + c[~raw].sum()) + 16 * nb \
            + int((kfr.HEADER + body).sum()) + 8 * nb
    if name == "match_cands":
        words, npos = args
        return _nbytes(words) + _nbytes(npos) + nb * km._check(*args) * 4
    raise KeyError(name)


def profiled(fn, reps: int, key, tries: int = 3) -> dict:
    """The profiler's device records over ``reps`` calls of ``fn`` (after
    one warm-up call): how many kernel records name ``key`` (one a launch
    when none was lost), their mean milliseconds, and every device
    interval's milliseconds a call.  ``key`` may be a tuple, a call's
    kernels: then the records are the fewest of any one kernel and the
    mean is the sum of each kernel's mean.  A profiled run that recorded
    no record of a key (device tracing is not always given to a process)
    is run again, up to ``tries`` runs."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    keys = (key,) if isinstance(key, str) else tuple(key)
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        mine = [[e.time_range.elapsed_us() for e in evs if k in e.name]
                for k in keys]
        if all(mine):
            break
    return {"launches": reps, "kernel_records": min(len(m) for m in mine),
            "kernel_ms_mean": (sum(statistics.fmean(m) for m in mine) / 1e3
                               if all(mine) else None),
            "device_ms_per_call": (sum(e.time_range.elapsed_us()
                                       for e in evs) / reps / 1e3
                                   if evs else None)}


def kernel_split(fn, reps: int, tries: int = 3) -> dict:
    """Every kernel a call of ``fn`` launches, by name: the profiler's
    records of it over ``reps`` calls (after one warm-up call) and their
    mean milliseconds, ``{name: [records, mean_ms]}``.  A name is the
    kernel's function name without its namespace and arguments.  A
    profiled run that recorded no kernel is run again, up to ``tries``
    runs."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name: dict = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            name = name.split()[-1] if name.split() else e.name
            by_name.setdefault(name, []).append(
                e.time_range.elapsed_us())
        if by_name:
            break
    return {k: [len(v), statistics.fmean(v) / 1e3]
            for k, v in sorted(by_name.items())}


def replay(launches, reps: int = 3) -> list:
    """[(event seconds, host seconds), ...] of ``reps`` back-to-back runs
    of ``launches``: CUDA events around each run, and the host clock
    around its loop before the closing sync (what issuing the launches
    costs the calling thread)."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        for launch in launches:
            launch()
        host = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        out.append((start.elapsed_time(end) / 1e3, host))
    return out
