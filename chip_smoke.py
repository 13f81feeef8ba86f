"""Chip smoke test of snappy_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels (nvcc, sm_90a, one process per
source) and the port's native host codec (g++) from the sources, checks
each kernel bit for bit against its plain PyTorch version at the main
path's shapes (the sequential, wave-group and match kernels also at
their engine's launch width, the card's resident rows, with hostile or
edge rows; the framed-record kernel at the seq engine's width, phase
6b, against its plain version and the host's records), drives the
framed to-device / from-device path through the public entry points in each runtime engine (id: 256 MiB, classify:
64 MiB, the device LZ engine "seq": 256 MiB of the seeded benchmark
corpus) against the native codec, drives the two standalone engines
over 256 MiB of the same corpus (the wave-group decoder "wave" and the
device match finder "devmatch"), shows through the launch counters,
reset before each engine's run and read after it, that each run went
through its kernels, times each kernel against its plain version, then
saves and loads a state dict with GPT-2 medium's tensor shapes through
the checkpoint API (id and seq engines; phase 15) and drives the
streaming reader and writer and the CLI over 256 MiB of the corpus
(phase 16), and drives ``dist``, the mesh and multi-host codec, over
1 GiB of the corpus (phase 17): the mesh forms on every local card and
on two shards of the card, then two processes on the card over gloo
(the multihost CLI, and the device entry points with the length
all-gather), each output against its single-device or single-process
counterpart; and drives the hybrid decode engine, the portable (jnp)
engines and the mesh forms that run them (phase 18: the record executor
against its plain version, the hybrid engine over 256 MiB, the jnp
engines over 256 MiB on the parallel decoder's and encoder's kernels,
each held against its plain version on a 64-row batch and hostile rows,
sharded_encode / sharded_decode / roundtrip_step on the local cards and
on two shards of the card); and drives the port
without its native library (phase 19, in a child interpreter whose
``native.available()`` is False and whose native functions, pure-Python
CRC and reference encoder raise: the eight codec entry points over
64 MiB framed and 4 MiB raw, the streams over 8 MiB and phase 15's
GPT-2 medium checkpoint, each stream against the reference that
``encode_np``'s emission gives, beside the host native codec).
Every check raises on failure (nothing is caught), so any failure exits
non-zero; without a GPU it exits non-zero before printing any result.

The last two lines are one JSON object per line: the kernel table
(each kernel's launches over the counted runs, max_abs_err, ms (CUDA
events around back-to-back wrapper calls), device_ms (the mean of the
kernel's own torch.profiler records, device_records [records,
launches]) and plain_ms at its main-path shape of ``rows`` rows,
bound_ms = its bytes over 3.35 TB/s, library_ms null), then
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    "crc32c_rows": {
        "source": "snappy_tpu_torch/csrc/crc32c.cu",
        "replaces": "snappy_tpu/kernels/crc32c_jnp.py:102",
    },
    "flat_exec": {
        "source": "snappy_tpu_torch/csrc/flat_exec.cu",
        "replaces": "snappy_tpu/kernels/decode_flat.py:439",
    },
    "seq_decode": {
        "source": "snappy_tpu_torch/csrc/seq_decode.cu",
        "replaces": "snappy_tpu/kernels/pallas_decode.py:221",
    },
    "seq_encode": {
        "source": "snappy_tpu_torch/csrc/seq_encode.cu",
        "replaces": "snappy_tpu/kernels/pallas_encode.py:193",
    },
    "wavegroup": {
        "source": "snappy_tpu_torch/csrc/wavegroup.cu",
        "replaces": "snappy_tpu/kernels/decode_wavegroup.py:178",
    },
    "match_cands": {
        "source": "snappy_tpu_torch/csrc/match.cu",
        "replaces": "snappy_tpu/kernels/pallas_match.py:125",
    },
    "decode_pretagged": {
        "source": "snappy_tpu_torch/csrc/pretagged.cu",
        "replaces": "snappy_tpu/kernels/decode_pretagged.py:56",
    },
    "decode_par": {
        "source": "snappy_tpu_torch/csrc/decode_par.cu",
        "replaces": "snappy_tpu/kernels/decode_jnp.py:174",
    },
    "encode_par": {
        "source": "snappy_tpu_torch/csrc/encode_par.cu",
        "replaces": "snappy_tpu/kernels/encode_jnp.py:397",
    },
    # none: the JAX package assembles framed records on the host
    "frame_records": {
        "source": "snappy_tpu_torch/csrc/frame_records.cu",
        "replaces": None,
    },
}
# a substring of each CUDA kernel's name in the profiler's records: each
# function's row by its name, a function of several kernels (the parallel
# engines': its card time their means summed) by the tuple of its
# kernels' keys, and each of those kernels by its own name.  decode_par's
# rows of at most 64 KiB end in pretagged.cu's executor; its wider rows'
# pointer kernels are timed by snappy_tpu_torch/bench/walk_profile.py.
PAR_KERNELS = {
    "encode_par": ("encode_cands_kernel", "encode_parse_kernel",
                   "encode_emit_kernel"),
    "decode_par": ("decode_par_spec_kernel", "decode_par_entry_kernel",
                   "decode_par_count_kernel", "decode_par_scan_kernel",
                   "decode_par_emit_kernel", "decode_par_finish_kernel",
                   "pretagged_kernel")}
PROFILER_KEYS = {"crc32c_rows": "crc32c_rows", "flat_exec": "flat_exec",
                 "seq_decode": "seq_decode", "seq_encode": "seq_encode",
                 "wavegroup": "wavegroup", "match_cands": "match_kernel",
                 "decode_pretagged": "pretagged",
                 "frame_records": "frame_records", **PAR_KERNELS,
                 **{k: k for ks in PAR_KERNELS.values() for k in ks}}
SEQ_ROWS = 64  # rows of the seq, wave and match checks and timings before
               # their engines launched at the card's resident rows


def log(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, iters: int, warm: bool = True) -> float:
    """Mean device milliseconds of fn() over iters launches (CUDA
    events, after a warm-up call unless warm is False)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn):
    """(result, seconds) of fn() on the host clock, ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def corpus_bytes(total: int, seed: int) -> bytes:
    from snappy_tpu_torch.bench.corpus import make_corpus

    return b"".join(d for _, d in make_corpus(total, seed=seed))


def crc_phase(card, dev, seed):
    """Phase 3: the CRC kernel against its plain version and the native
    CRC, including a 520-row panel read in place, and against its plain
    version at the seq engine's launch widths."""
    from snappy_tpu_torch import native
    from snappy_tpu_torch.kernels import crc32c as kc
    from snappy_tpu_torch.kernels import decode_seq as kds
    from snappy_tpu_torch.kernels import encode_seq as kes
    from snappy_tpu_torch.runtime import device_codec as dc

    rng = np.random.default_rng(seed)
    nb = 256
    fixed = [0, 1, 255, 256, 257, 4096, 65535, 65536]
    lengths = np.array(
        fixed + list(rng.integers(0, 65537, nb - len(fixed))), np.int32)
    rows = rng.integers(0, 256, (nb, kc.CHUNK), dtype=np.uint8)
    want = np.array([native.crc32c(rows[i, :n].tobytes())
                     for i, n in enumerate(lengths)], np.int64)
    rows_d = torch.from_numpy(rows).to(dev)
    lens_d = torch.from_numpy(lengths).to(dev)
    got = kc.crc32c_chunks(rows_d, lens_d)
    plain = kc.crc32c_chunks_plain(rows_d, lens_d)
    torch.cuda.synchronize()
    err = int((got - plain).abs().max())
    assert np.array_equal(got.cpu().numpy(), want), "CRC kernel != native"
    assert np.array_equal(plain.cpu().numpy(), want), "CRC plain != native"

    panel = rng.integers(0, 256, (64, 520 * 128), dtype=np.uint8)
    plens = np.array([65536] * 60 + [0, 1, 4097, 65535], np.int32)
    pwant = np.array([native.crc32c(panel[i, :n].tobytes())
                      for i, n in enumerate(plens)], np.int64)
    panel_d = torch.from_numpy(panel).to(dev)
    view = panel_d[:, :kc.CHUNK]
    assert view.stride(0) == 520 * 128
    pgot = kc.crc32c_chunks(view, torch.from_numpy(plens).to(dev))
    torch.cuda.synchronize()
    assert np.array_equal(pgot.cpu().numpy(), pwant), "pitched CRC"

    # the seq engine's launch widths (decode, encode): more clusters than
    # the card holds at once
    widths = [dc._seq_width(kds.resident_rows, dev, kc.CHUNK),
              dc._seq_width(kes.resident_rows, dev, kc.CHUNK)]
    wide = torch.from_numpy(rng.integers(0, 256, (max(widths), kc.CHUNK),
                                         dtype=np.uint8)).to(dev)
    for w in widths:
        wl = np.array(fixed + list(rng.integers(0, 65537, w - len(fixed))),
                      np.int32)
        wl_d = torch.from_numpy(wl).to(dev)
        wgot = kc.crc32c_chunks(wide[:w], wl_d)
        wplain = kc.crc32c_chunks_plain(wide[:w], wl_d)
        torch.cuda.synchronize()
        err = max(err, int((wgot - wplain).abs().max()))
        assert torch.equal(wgot, wplain), f"CRC kernel != plain at {w} rows"
    log(card, f"crc32c: {nb} rows + 64 pitched rows bit-exact vs plain "
              f"and native.crc32c, {widths[0]} / {widths[1]} rows (the seq "
              f"engine's widths) vs plain (max_abs_err {err})")
    return err


def _stage_decode_plans(data: bytes, nb: int):
    """Native flat decode plans (stage_flat_dec_batch) for the first nb
    chunks of native.compress_framed(data)."""
    from snappy_tpu_torch import native
    from snappy_tpu_torch.kernels import decode_flat as kf
    from snappy_tpu_torch.runtime.device_codec import _scan_frames

    fr = native.compress_framed(data)
    chunks, _ = _scan_frames(fr)
    comp = [c for c in chunks if c[0] == 0 and c[2] <= 66560][:nb]
    src = np.frombuffer(fr, np.uint8)
    rb = kf.rows_b_for(66560)
    n = len(comp)
    b_u8 = np.empty((n, rb * 128), np.uint8)
    meta = np.empty((n, 8 * kf.TRIP_CAP, 128), np.int32)
    starts = np.zeros((n, 8, 128), np.int32)
    rc = np.zeros(n, np.int64)
    arrs = [np.array([c[f] for c in comp], np.int64) for f in (1, 2, 5, 4)]
    native.stage_flat_dec_batch(src, *arrs, rb, meta, starts, b_u8, rc)
    ntr = np.maximum(rc, 0).astype(np.int32)
    return b_u8, meta, starts, ntr, rc, fr, comp


def _stage_encode_plans(data: bytes, nb: int):
    from snappy_tpu_torch import native
    from snappy_tpu_torch.kernels import encode_flat as ke

    n = min(nb, len(data) // 65536)
    blocks = np.frombuffer(data[: n * 65536], np.uint8).reshape(n, 65536)
    lens = np.full(n, 65536, np.int64)
    b_u8 = np.empty((n, ke.RB_ENC * 128), np.uint8)
    meta = np.empty((n, 8 * ke.ENC_TRIP_CAP, 128), np.int32)
    starts = np.zeros((n, 8, 128), np.int32)
    elem = np.empty((n, native.max_compressed_length(65536) + 8), np.uint8)
    clens, hdrs, rc = (np.zeros(n, np.int64) for _ in range(3))
    native.stage_flat_enc_batch(blocks, lens, ke.RB_ENC, meta, starts, b_u8,
                                ke.TAG_ROWS * 128, elem, clens, hdrs, rc)
    ntr = np.maximum(rc, 0).astype(np.int32)
    return b_u8, meta, starts, ntr, elem, clens, hdrs, rc


def flat_phase(card, dev, data):
    """Phase 4: the flat kernel against its plain version on real native
    plans, decode (out_rows 520) and encode (out_rows 640)."""
    from snappy_tpu_torch import native
    from snappy_tpu_torch.kernels import decode_flat as kf
    from snappy_tpu_torch.kernels import encode_flat as ke

    b_u8, meta, starts, ntr, rc_d, fr_src, comp = _stage_decode_plans(data, 64)
    plan = kf.plan_from_numpy(b_u8, meta, starts, ntr, dev)
    got = kf.decode_blocks_flat(*plan, dst_max=65536)
    plain = kf.decode_blocks_flat_plain(*plan, dst_max=65536)
    torch.cuda.synchronize()
    err_d = int((got.to(torch.int16) - plain.to(torch.int16)).abs().max())
    assert torch.equal(got, plain), "flat decode kernel != plain"
    got_h = got.cpu().numpy()
    for row, c in enumerate(comp):
        if rc_d[row] < 0:  # plan over its caps: the runtime decodes on host
            continue
        want = native.decompress(fr_src[c[1]:c[1] + c[2]])
        assert got_h[row, :c[4]].tobytes() == want, f"decode row {row}"
    clamp = int((((starts >> 10) & 1023) > kf.OUT_ROWS - 128).sum())

    eb, em, es, entr, elem, clens, hdrs, rc = _stage_encode_plans(data, 64)
    eplan = kf.plan_from_numpy(eb, em, es, entr, dev)
    egot = ke.encode_blocks_flat(*eplan)
    eplain = ke.encode_blocks_flat_plain(*eplan)
    torch.cuda.synchronize()
    err_e = int((egot.to(torch.int16) - eplain.to(torch.int16)).abs().max())
    assert torch.equal(egot, eplain), "flat encode kernel != plain"
    egot_h = egot.cpu().numpy()
    for i in range(len(entr)):
        if rc[i] >= 0:
            assert (egot_h[i, hdrs[i]:clens[i]].tobytes()
                    == elem[i, hdrs[i]:clens[i]].tobytes()), f"enc row {i}"
    # the runtime's shape (device_codec._upload_flat): meta cut to the
    # trips the batch uses, B rows bucketed to its widest payload
    rplan = runtime_plan(plan, max(c[2] for c in comp))
    rgot = kf.decode_blocks_flat(*rplan, dst_max=65536)
    torch.cuda.synchronize()
    assert torch.equal(rgot, got), "flat decode, runtime shape != full shape"
    log(card, f"flat_exec: {len(comp)} decode plans (trips "
              f"{int((ntr & 0xFFFF).min())}-{int((ntr & 0xFFFF).max())}, {clamp} "
              f"subpanel words past the clamp row) and {len(entr)} encode "
              f"plans byte-identical to plain and to the native codec "
              f"(max_abs_err {max(err_d, err_e)}); the decode plans in the "
              f"runtime's shape (meta {rplan[1].shape[1] // 8} of "
              f"{kf.TRIP_CAP} trips, B {rplan[0].shape[1]} of "
              f"{plan[0].shape[1]} bytes) give the same rows")
    return max(err_d, err_e), plan, rplan, eplan


def runtime_plan(plan, kmax: int):
    """``plan`` as device_codec uploads it: meta cut to the trips the
    batch uses (_upload_flat), B rows cut to the bucket of its widest
    payload ``kmax`` (_bucket_cmax), both contiguous."""
    from snappy_tpu_torch.kernels import decode_flat as kf
    from snappy_tpu_torch.runtime import device_codec as dc

    b_u8, meta, starts, ntr = plan
    used = max(1, int((ntr & 0xFFFF).max()))
    rb = kf.rows_b_for(dc._bucket_cmax(kmax))
    return (b_u8[:, : rb * 128].contiguous(),
            meta[:, : 8 * used].contiguous(), starts, ntr)


def _counters():
    from snappy_tpu_torch.kernels import crc32c as kc
    from snappy_tpu_torch.kernels import decode_flat as kf
    from snappy_tpu_torch.kernels import decode_par as dp
    from snappy_tpu_torch.kernels import decode_pretagged as kp
    from snappy_tpu_torch.kernels import decode_seq as kds
    from snappy_tpu_torch.kernels import decode_wavegroup as kw
    from snappy_tpu_torch.kernels import encode_par as ep
    from snappy_tpu_torch.kernels import encode_seq as kes
    from snappy_tpu_torch.kernels import frame_records as kfr
    from snappy_tpu_torch.kernels import match as km

    return {"crc32c_rows": kc, "flat_exec": kf, "seq_decode": kds,
            "seq_encode": kes, "wavegroup": kw, "match_cands": km,
            "decode_pretagged": kp, "decode_par": dp, "encode_par": ep,
            "frame_records": kfr}


def _counter_modules() -> dict:
    """Kernel name -> the module that counts its launches, by name."""
    return {k: m.__name__ for k, m in _counters().items()}


def _bad_streams() -> list:
    """Corrupt element streams (raw format), one or more per error code
    of the sequential decoder, with its int32 wrap cases."""
    from snappy_tpu_torch.spec.format import put_uvarint

    lit = b"\x0cabcd"  # a 4-byte literal
    return [
        b"\x05" + lit,                                          # dst short
        b"\x08" + lit + bytes([(3 << 2) | 2, 10, 0]),           # copy < 0
        b"\x08" + lit + bytes([(3 << 2) | 1, 0]),               # offset 0
        b"\x0a\x24abc",                                        # literal > src
        put_uvarint(10) + bytes([63 << 2, 255, 255, 255, 255]) + b"abc",
        put_uvarint(10) + bytes([63 << 2, 255, 255, 255, 127]) + b"abc",
        put_uvarint(8) + lit + bytes([(3 << 2) | 3, 1, 0, 0, 128]),
        put_uvarint(8) + lit + bytes([(3 << 2) | 3, 4, 0, 0, 0]),  # valid
        put_uvarint(8) + lit + bytes([(3 << 2) | 2]),            # cut header
        b"\x00",                                                # src trail
    ]


def _spread(full: bytes, n: int, phase: float) -> list:
    """n 64 KiB blocks taken evenly across the corpus ``full`` (every
    kind of data in it), starting ``phase`` of a stride in."""
    nblk = len(full) >> 16
    step = nblk / n
    return [full[int(i * step + phase * step) << 16 :
                 (int(i * step + phase * step) + 1) << 16] for i in range(n)]


def seq_decode_phase(card, dev, data, full):
    """Phase 5: the sequential decode kernel against its plain version and the
    native decoder, twice: SEQ_ROWS corpus chunks (PRs 2-4's shape) and a
    launch at the seq engine's width (the card's resident rows) of corpus
    chunks taken across the 256 MiB corpus; each as native.compress emits
    them in the runtime's 66,560-byte rows, plus an all-zero chunk, a
    random one, an empty stream (a stored chunk's row) and corrupt rows
    hitting every error code (err vectors compared too).  The wide launch
    also as the seq engine stages a batch: the streams laid out as one
    span, 8 non-zero bytes (a chunk's header and CRC) before each, read
    as rows of stride 0, each row's stream at ``[rel + hdr, rel +
    len)``; the kernel there must equal the plain version on the padded
    rows, out and err.  Returns the largest difference, the SEQ_ROWS
    arguments, the wide span arguments (the main path's layout), and the
    plain version's seconds on the wide launch."""
    from snappy_tpu_torch import native
    from snappy_tpu_torch.spec.format import read_uvarint
    from snappy_tpu_torch.kernels import decode_seq as kds

    rng = np.random.default_rng(10)
    extra = [bytes(65536), rng.bytes(65536), b""]
    width = kds.resident_rows(dev, 65536)
    runs = {}
    for name, blocks in (
            ("64", [data[i << 16 : (i + 1) << 16] for i in range(SEQ_ROWS)]),
            ("wide", _spread(full, width - len(extra) - len(_bad_streams()),
                             0.25) + extra)):
        streams = [native.compress(b) for b in blocks] + _bad_streams()
        nb = len(streams)
        comp = np.zeros((nb, 66560), np.uint8)
        starts, clens, dlens = (np.zeros(nb, np.int32) for _ in range(3))
        for i, c in enumerate(streams):
            dlens[i], starts[i] = read_uvarint(c, 0)
            comp[i, : len(c)] = np.frombuffer(c, np.uint8)
            clens[i] = len(c)
        starts[-1] = clens[-1] + 3  # an element stream past its payload end
        args = kds.stage_decode(comp, starts, clens, dlens, dev)
        out, err = kds.decode_blocks_seq(*args, 65536)
        (pout, perr), plain_s = timed(
            lambda: kds.decode_blocks_seq_plain(*args, 65536))
        max_err = max(
            int((out.to(torch.int16) - pout.to(torch.int16)).abs().max()),
            int((err - perr).abs().max()))
        assert torch.equal(out, pout) and torch.equal(err, perr), \
            f"seq decode kernel != plain ({name})"
        codes = err.cpu().numpy()
        assert set(codes.tolist()) == {0, 1, 2, 3, 4}, codes
        out_h = out.cpu().numpy()
        for i, b in enumerate(blocks):
            assert codes[i] == 0 and out_h[i, : len(b)].tobytes() == b, i
        nbad = nb - len(blocks)
        log(card, f"seq_decode [{nb} rows]: {len(blocks)} rows (corpus"
                  f"{', zero, random, empty' if name == 'wide' else ''}) "
                  f"byte-identical to plain and native.decompress, {nbad} "
                  f"corrupt rows with err {codes[-nbad:].tolist()} equal to "
                  f"plain (max_abs_err {max_err}); plain {plain_s:.3f} s")
        if name == "wide":
            args, span_err = _seq_span_check(card, dev, streams, starts,
                                             clens, dlens, pout, perr)
            max_err = max(max_err, span_err)
        runs[name] = (max_err, args, plain_s)
    wide = runs["wide"][1]
    return (max(r[0] for r in runs.values()),
            tuple(t[:SEQ_ROWS] for t in runs["64"][1]), wide,
            runs["wide"][2])


def _seq_span_check(card, dev, streams, starts, clens, dlens, pout, perr):
    """seq_decode_phase's wide streams as one span of stride-0 rows, the
    kernel there against the plain version's ``pout``/``perr`` on the
    padded rows.  Returns the span arguments and the largest
    difference."""
    from snappy_tpu_torch.kernels import decode_seq as kds

    gap = bytes([0x01, 0x31, 0x02, 0x07, 0xD7, 0x9E, 0xFF, 0x01])
    span, rel = bytearray(), []
    for c in streams:
        span += gap
        rel.append(len(span))
        span += c
    rel = np.array(rel, np.int32)
    nb = len(streams)
    flat = torch.frombuffer(span, dtype=torch.uint8).to(dev)
    _, st, cl, dl = kds.stage_decode(np.zeros((1, 1), np.uint8),
                                     starts + rel, clens + rel, dlens, dev)
    args = (flat.expand(nb, len(span)), st, cl, dl)
    out, err = kds.decode_blocks_seq(*args, 65536)
    max_err = max(
        int((out.to(torch.int16) - pout.to(torch.int16)).abs().max()),
        int((err - perr).abs().max()))
    assert torch.equal(out, pout) and torch.equal(err, perr), \
        "seq decode kernel on a span != plain on padded rows"
    log(card, f"seq_decode [{nb} rows] on one {len(span)}-byte span "
              f"(stride-0 rows, 8 non-zero bytes before each stream): out "
              f"and err equal to plain on the padded rows (max_abs_err "
              f"{max_err})")
    return args, max_err


def seq_encode_phase(card, dev, data, full):
    """Phase 6: the sequential encode kernel against its plain version and the
    native encoder, twice: SEQ_ROWS corpus chunks (PRs 2-4's shape) and a
    launch at the seq engine's width of corpus chunks taken across the
    256 MiB corpus, plus edge rows (empty, 17 and 18 bytes, zeros,
    run-length, random).  Returns as seq_decode_phase does."""
    from snappy_tpu_torch import native
    from snappy_tpu_torch.spec.format import read_uvarint
    from snappy_tpu_torch.kernels import encode_seq as kes

    rng = np.random.default_rng(11)
    extra = [b"", b"x" * 17, b"x" * 18, bytes(65536), b"ab" * 32768,
             rng.bytes(65536), rng.bytes(1000) + b"z" * 3000]
    width = kes.resident_rows(dev, 65536)
    runs = {}
    for name, samples in (
            ("64", [data[i << 16 : (i + 1) << 16] for i in range(SEQ_ROWS)]),
            ("wide", _spread(full, width - len(extra), 0.75))):
        samples = samples + extra
        blocks = np.zeros((len(samples), 65536), np.uint8)
        lens = np.array([len(s) for s in samples], np.int32)
        for i, s in enumerate(samples):
            blocks[i, : len(s)] = np.frombuffer(s, np.uint8)
        args = kes.stage_encode(blocks, lens, dev)
        comp, clens, err = kes.encode_blocks_seq(*args)
        (pcomp, pclens, perr), plain_s = timed(
            lambda: kes.encode_blocks_seq_plain(*args))
        max_err = max(
            int((comp.to(torch.int16) - pcomp.to(torch.int16)).abs().max()),
            int((clens - pclens).abs().max()), int((err - perr).abs().max()))
        assert torch.equal(comp, pcomp) and torch.equal(clens, pclens) \
            and torch.equal(err, perr), f"seq encode kernel != plain ({name})"
        comp_h, clens_h = comp.cpu().numpy(), clens.cpu().numpy()
        for i, s in enumerate(samples):
            nat = native.compress(s)
            assert comp_h[i, : clens_h[i]].tobytes() == \
                nat[read_uvarint(nat, 0)[1] :], f"encode row {i} ({name})"
        log(card, f"seq_encode [{len(samples)} rows]: "
                  f"{len(samples) - len(extra)} corpus rows and {len(extra)} "
                  f"edge rows byte-identical to plain and native.compress "
                  f"(max_abs_err {max_err}); plain {plain_s:.3f} s")
        runs[name] = (max_err, args, plain_s)
    return (max(r[0] for r in runs.values()),
            tuple(t[:SEQ_ROWS] for t in runs["64"][1]), runs["wide"][1],
            runs["wide"][2])


def frame_phase(card, dev, full):
    """Phase 6b: the framed-record kernel against its plain version and
    the host's records (``device_codec._framed_record``) at the seq
    engine's width, the card's resident rows: 64 KiB corpus chunks taken
    across the corpus, incompressible (stored) chunks, short chunks of
    each varint width (1, 2 and 3 bytes), and four corpus rows' element
    lengths set at the 12.5% boundary (stored at it, compressed one byte
    under), once with the chunk rows and elements where the runtime
    holds them and once at odd byte offsets.  Every comparison is exact.
    Returns (max_abs_err, the aligned launch's arguments, the plain
    version's seconds there)."""
    from snappy_tpu_torch.kernels import crc32c as kc
    from snappy_tpu_torch.kernels import encode_seq as kes
    from snappy_tpu_torch.kernels import frame_records as kfr
    from snappy_tpu_torch.runtime import device_codec as dc

    rng = np.random.default_rng(13)
    extra = [rng.bytes(65536), rng.bytes(65536), rng.bytes(100),
             rng.bytes(10_000), b"q" * 100, b"w" * 10_000, b"e" * 16384,
             rng.bytes(1), full[:127], full[:16383], full[:16384]]
    width = dc._seq_width(kes.resident_rows, dev, 65536)
    samples = _spread(full, width - len(extra), 0.25) + extra
    lens = np.array([len(s) for s in samples], np.int32)
    host = np.zeros((width, 65536), np.uint8)
    for i, s in enumerate(samples):
        host[i, : len(s)] = np.frombuffer(s, np.uint8)
    rows, lens_d = kes.stage_encode(host, lens, dev)
    comp, clens, _err = kes.encode_blocks_seq(rows, lens_d)
    crc = kc.crc32c_chunks(rows, lens_d)
    for r, below in enumerate((0, 1, 0, 1)):  # 64 KiB corpus rows
        clens[r] = 65536 - 65536 // 8 - 3 - below
    comp_h, clens_h, crc_h = (t.cpu().numpy() for t in (comp, clens, crc))
    recs = [dc._framed_record(int(lens[r]), comp_h[r, : clens_h[r]].tobytes(),
                              int(crc_h[r]), host[r, : lens[r]])
            for r in range(width)]
    kinds = [rec[0] for rec in recs]
    assert kinds[:4] == [1, 0, 1, 0], f"boundary rows framed as {kinds[:4]}"
    want = b"".join(recs)
    max_err, plain_s = 0, None
    for name, row_off, comp_off in (("aligned", 0, 0), ("odd", 5, 3)):
        flat = torch.zeros(row_off + width * 65536, dtype=torch.uint8,
                           device=dev)
        flat[row_off:] = rows.reshape(-1)
        comp_o = torch.zeros((width, comp.shape[1] + comp_off),
                             dtype=torch.uint8, device=dev)
        comp_o[:, comp_off:] = comp
        args = (flat[row_off:].view(width, 65536), lens_d,
                comp_o[:, comp_off:], clens, crc)
        before = kfr.launches
        framed, ends = kfr.frame_records(*args)
        torch.cuda.synchronize()
        assert kfr.launches == before + 1, "frame_records: not one launch"
        (pframed, pends), secs = timed(lambda: kfr.frame_records_plain(*args))
        total = int(pends[-1])
        max_err = max(max_err, int((ends - pends).abs().max()), int(
            (framed[:total].to(torch.int16)
             - pframed[:total].to(torch.int16)).abs().max()))
        assert torch.equal(ends, pends) and torch.equal(
            framed[:total], pframed[:total]), f"frame_records != plain ({name})"
        assert framed[:total].cpu().numpy().tobytes() == want, \
            f"frame_records != _framed_record ({name})"
        if name == "aligned":
            main_args, plain_s = (rows, lens_d, comp, clens, crc), secs
    log(card, f"frame_records [{width} rows]: {width - len(extra)} corpus "
              f"rows and {len(extra)} edge rows, {kinds.count(1)} stored and "
              f"{kinds.count(0)} compressed, the first four at the 12.5% "
              f"boundary; aligned and at odd offsets byte-identical to plain "
              f"and _framed_record (max_abs_err {max_err}), {len(want)} B "
              f"of records; plain {plain_s:.3f} s")
    return max_err, main_args, plain_s


def wave_phase(card, dev, data, full):
    """Phase 7: the wave-group kernel against its plain version and the
    input bytes, twice: SEQ_ROWS corpus chunks (the first port's width)
    and a
    launch at the wave engine's width (the card's resident rows) of
    chunks taken across the 256 MiB corpus, stored-like and compressible
    rows mixed; each as native.compress emits them, planned natively
    (stage_waves), plus edge rows (zeros, run-length, random, empty).
    Returns the largest difference, the SEQ_ROWS arguments and the wide
    arguments."""
    from snappy_tpu_torch import native
    from snappy_tpu_torch.kernels import decode_wavegroup as kw

    rng = np.random.default_rng(12)
    extra = [bytes(65536), b"ab" * 32768, rng.bytes(65536), b""]
    width = kw.resident_rows(dev, 65536)
    runs = {}
    for name, blocks in (
            ("64", [data[i << 16 : (i + 1) << 16] for i in range(SEQ_ROWS)]),
            ("wide", _spread(full, width - len(extra), 0.5))):
        ncorp = len(blocks)
        blocks = blocks + extra
        staged = kw.stage_waves([native.compress(b) for b in blocks],
                                device=dev)
        assert staged is not None, "a wave plan over WAVE_G_CAP"
        out = kw.decode_blocks_wavegroup(*staged, 65536)
        plain = kw.decode_blocks_wavegroup_plain(*staged, 65536)
        torch.cuda.synchronize()
        max_err = int((out.to(torch.int16) - plain.to(torch.int16)).abs().max())
        assert torch.equal(out, plain), f"wavegroup kernel != plain ({name})"
        out_h = out.cpu().numpy()
        for i, b in enumerate(blocks):
            assert out_h[i, : len(b)].tobytes() == b, (name, i)
            assert not out_h[i, len(b) :].any(), (name, i)
        ng = staged[2].cpu().numpy()
        log(card, f"wavegroup [{len(blocks)} rows]: {ncorp} corpus rows "
                  f"({int(ng[:ncorp].min())}-{int(ng[:ncorp].max())} groups) "
                  f"and {len(extra)} edge rows ({ng[ncorp:].tolist()} groups) "
                  f"byte-identical to plain and to the input (max_abs_err "
                  f"{max_err})")
        runs[name] = (max_err, staged)
    return (max(r[0] for r in runs.values()),
            tuple(t[:SEQ_ROWS] for t in runs["64"][1]), runs["wide"][1])


def match_phase(card, dev, data, full):
    """Phase 8: the match kernel against its plain version in both
    routes (home and sorted pairs), twice: SEQ_ROWS corpus chunks (the
    first port's width) and a launch at the devmatch engine's width (the card's
    resident blocks) of chunks taken across the 256 MiB corpus; each with
    edge blocks (empty, 3 B, 4 B, zeros, all-equal, random, and exact 64
    KiB blocks, whose last v-words wrap round).  The CPU tests hold the
    plain version against the JAX package's match_np.find_candidates.
    Returns as wave_phase does."""
    from snappy_tpu_torch.kernels import match as km

    rng = np.random.default_rng(13)
    extra = [b"", b"abc", b"abcd", bytes(65536), b"\x07" * 65536,
             rng.bytes(65536), bytes(range(256)) * 256, rng.bytes(40000)]
    width = km.resident_rows(dev)
    runs = {}
    for name, blocks in (
            ("64", [data[i << 16 : (i + 1) << 16] for i in range(SEQ_ROWS)]),
            ("wide", _spread(full, width - len(extra), 0.625))):
        ncorp = len(blocks)
        w, n = km.stage_words(blocks + extra)
        args = (torch.from_numpy(w).to(dev), torch.from_numpy(n).to(dev))
        max_err = 0
        for home in (True, False):
            got = km.find_candidates(*args, home=home)
            plain = km.find_candidates_plain(*args, home=home)
            torch.cuda.synchronize()
            max_err = max(max_err, int((got.long() - plain.long()).abs().max()))
            assert torch.equal(got, plain), \
                f"match kernel != plain (home={home}, {name})"
        log(card, f"match_cands [{ncorp + len(extra)} blocks]: {ncorp} corpus "
                  f"blocks and {len(extra)} edge blocks bit-exact to plain in "
                  f"both routes (max_abs_err {max_err})")
        runs[name] = (max_err, args)
    return (max(r[0] for r in runs.values()),
            tuple(t[:SEQ_ROWS] for t in runs["64"][1]), runs["wide"][1])


def join_waves(pieces):
    """One launch's (comp, words, ngroups) from stage_waves results of
    consecutive rows (on one device): every row padded with zeros to the
    widest comp row and the widest plan of the launch."""
    dev = pieces[0][0].device
    nb = sum(p[0].shape[0] for p in pieces)
    cmax = max(p[0].shape[1] for p in pieces)
    gw = max(p[1].shape[1] for p in pieces)
    comp = torch.zeros(nb, cmax, dtype=torch.uint8, device=dev)
    words = torch.zeros(nb, gw, pieces[0][1].shape[2], dtype=torch.int32,
                        device=dev)
    lo = 0
    for c, w, _ng in pieces:
        comp[lo : lo + c.shape[0], : c.shape[1]] = c
        words[lo : lo + w.shape[0], : w.shape[1]] = w
        lo += c.shape[0]
    return comp, words, torch.cat([p[2] for p in pieces])


def break_element(fr: bytes) -> bytes:
    """fr with the first element of its first compressed chunk made a
    copy that reaches before the block start."""
    from snappy_tpu_torch.runtime.device_codec import _scan_frames

    chunks, _ = _scan_frames(fr)
    _t, p_off, _l, _c, _d, hdr = next(c for c in chunks if c[0] == 0)
    bad = bytearray(fr)
    bad[p_off + hdr : p_off + hdr + 3] = bytes([(3 << 2) | 2, 1, 0])
    return bytes(bad)


def flip_payload_byte(fr: bytes) -> bytes:
    """fr with one payload byte of a middle chunk changed such that the
    chunk still decodes to its stated length: only its CRC can tell."""
    from snappy_tpu_torch import native
    from snappy_tpu_torch.errors import SnappyError
    from snappy_tpu_torch.runtime.device_codec import _scan_frames

    chunks, _ = _scan_frames(fr)
    for ctype, p_off, p_len, _crc, dst_len, hdr in chunks[len(chunks) // 2:]:
        if ctype == 1:  # uncompressed: any byte
            bad = bytearray(fr)
            bad[p_off + p_len // 2] ^= 0x40
            return bytes(bad)
        for pos in range(p_off + p_len - 1, p_off + hdr, -1):
            bad = bytearray(fr)
            bad[pos] ^= 0x40
            try:
                blob = native.decompress(bytes(bad[p_off:p_off + p_len]))
            except SnappyError:  # the flip broke the tag structure
                continue
            if len(blob) == dst_len:
                return bytes(bad)
    raise AssertionError("no payload byte to flip")


def expect_raise(exc, fn, what: str) -> None:
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"{what} not caught")


def counted(card, name: str, fn):
    """Run fn() on the host clock (ending in a sync) with every launch
    counter set to 0 just before and read just after; returns (result,
    seconds, counts)."""
    mods = _counters()
    for m in mods.values():
        m.launches = 0
    res, secs = timed(fn)
    counts = {k: m.launches for k, m in mods.items()}
    log(card, f"{name}: {secs:.4f} s, kernel launches {counts}")
    return res, secs, counts


def main_path(card, dev, full, id_mib, classify_mib, seq_mib, wave_mib,
              devmatch_mib):
    """Phases 9-13 through the public entry points, one engine at a time
    with the launch counters set to 0 just before its run and read just
    after, on the corpus ``full``.  Returns the rates and each engine's
    launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    import snappy_tpu_torch as st
    from snappy_tpu_torch import native
    from snappy_tpu_torch.spec import framing
    from snappy_tpu_torch.spec.format import put_uvarint
    from snappy_tpu_torch.kernels import decode_seq as kds
    from snappy_tpu_torch.kernels import decode_wavegroup as kw
    from snappy_tpu_torch.kernels import encode_seq as kes
    from snappy_tpu_torch.kernels import match as km
    from snappy_tpu_torch.runtime import device_codec as dc

    mods = _counters()
    rates = {}

    def run(name, nbytes, fn):
        """Time one call; log its rate and the kernel launches it made."""
        before = {k: m.launches for k, m in mods.items()}
        res, secs = timed(fn)
        rates[name] = nbytes / secs / 1e9
        made = {k: m.launches - before[k] for k, m in mods.items()
                if m.launches > before[k]}
        log(card, f"{name}: {nbytes} B in {secs:.4f} s = "
                  f"{rates[name]:.3f} GB/s (launches: {made})")
        return res

    # the standalone engines' 64 KiB blocks (the corpus may end a few
    # bytes short of its size) and their native.compress streams (the
    # wave engine's input; the devmatch size reference)
    blocks = [full[i << 16 : (i + 1) << 16]
              for i in range(max(wave_mib, devmatch_mib) << 4)]
    with ThreadPoolExecutor(4) as pool:
        streams = list(pool.map(native.compress, blocks))

    def id_engine():
        # phase 9: id mode at a real loader size
        data = full[: id_mib << 20]
        n = len(data)
        ref = run("host native.compress_framed", n,
                  lambda: native.compress_framed(data, threads=4))
        run("host native.decompress_framed", n,
            lambda: native.decompress_framed(ref, threads=4))
        fr = run("id.compress_framed", n,
                 lambda: st.compress_framed(data, device=dev))
        assert fr == ref, "id compress_framed != native.compress_framed"
        arr = run("id.decompress_framed_to_device", n,
                  lambda: st.decompress_framed_to_device(fr, device=dev))
        assert arr.device == dev and arr.numel() == n
        assert torch.equal(arr, torch.frombuffer(
            bytearray(data), dtype=torch.uint8).to(dev)), \
            "decompress_framed_to_device != input"
        fr2 = run("id.compress_framed_from_device", n,
                  lambda: st.compress_framed_from_device(arr))
        assert fr2 == ref, "compress_framed_from_device != native stream"
        raw = native.compress(data)
        arr2 = run("id.decompress_to_device", n,
                   lambda: st.decompress_to_device(raw, device=dev))
        assert torch.equal(arr2, arr), "decompress_to_device != input"
        out = run("id.decompress_framed", n,
                  lambda: st.decompress_framed(fr, device=dev))
        assert out == data, "id decompress_framed != input"
        del arr, arr2, out
        expect_raise(st.ChecksumError, lambda: st.decompress_framed_to_device(
            flip_payload_byte(fr), device=dev), "id: flipped payload byte")
        log(card, "id: flipped payload byte raised ChecksumError")
        small = data[:300_000]
        assert framing.decompress_framed(
            st.compress_framed(small, device=dev)) == small, "spec oracle"

    def classify_engine():
        # phase 10: classify mode
        dc.FLAT_MODE = "classify"
        data = full[: classify_mib << 20]
        n = len(data)
        ref = native.compress_framed(data)
        out = run("classify.decompress_framed", n,
                  lambda: st.decompress_framed(ref, device=dev))
        assert out == data, "classify decompress_framed != input"
        fr = run("classify.compress_framed", n,
                 lambda: st.compress_framed(data, device=dev))
        assert fr == ref, "classify compress_framed != native.compress_framed"
        raw = native.compress(data)
        out = run("classify.decompress", n,
                  lambda: st.decompress(raw, device=dev))
        assert out == data, "classify raw decompress != input"
        dc.FLAT_MODE = "id"

    def seq_engine():
        # phase 11: the device LZ engine (SNAPPY_TPU_FLAT=0,
        # SNAPPY_TPU_HOST_PARSE=0): the card decodes and encodes
        dc.FLAT, dc.HOST_PARSE = False, False
        data = full[: seq_mib << 20]
        n = len(data)
        ref = native.compress_framed(data, threads=4)
        raw_ref = native.compress(data)
        log(card, f"seq engine launch width: seq_decode "
                  f"{dc._seq_width(kds.resident_rows, dev, 65536)} rows, "
                  f"seq_encode {dc._seq_width(kes.resident_rows, dev, 65536)}"
                  f" rows (SMs x resident blocks per SM; BATCH {dc.BATCH})")
        fr = run("seq.compress_framed", n,
                 lambda: st.compress_framed(data, device=dev))
        assert fr == ref, "seq compress_framed != native.compress_framed"
        arr = run("seq.decompress_framed_to_device", n,
                  lambda: st.decompress_framed_to_device(fr, device=dev))
        assert arr.device == dev and torch.equal(arr, torch.frombuffer(
            bytearray(data), dtype=torch.uint8).to(dev)), \
            "seq decompress_framed_to_device != input"
        fr2 = run("seq.compress_framed_from_device", n,
                  lambda: st.compress_framed_from_device(arr))
        assert fr2 == ref, "seq compress_framed_from_device != native stream"
        out = run("seq.decompress_framed", n,
                  lambda: st.decompress_framed(fr, device=dev))
        assert out == data, "seq decompress_framed != input"
        raw = run("seq.compress", n, lambda: st.compress(data, device=dev))
        assert raw == raw_ref, "seq compress != native.compress"
        raw2 = run("seq.compress_from_device", n,
                   lambda: st.compress_from_device(arr))
        assert raw2 == raw_ref, "seq compress_from_device != native.compress"
        del arr, out
        expect_raise(st.ChecksumError, lambda: st.decompress_framed_to_device(
            flip_payload_byte(fr), device=dev), "seq: flipped payload byte")
        expect_raise(st.CorruptError, lambda: st.decompress_framed_to_device(
            break_element(fr), device=dev), "seq: broken element")
        expect_raise(st.CorruptError, lambda: st.decompress_framed(
            break_element(fr), device=dev), "seq: broken element (host out)")
        log(card, "seq: flipped payload byte raised ChecksumError, broken "
                  "element raised CorruptError")
        dc.FLAT, dc.HOST_PARSE = True, True

    # per standalone engine: bytes, staging and whole-call seconds, and
    # its launches' arguments, replayed back to back once the run's
    # counts are read (events around launches inside the run would add
    # the host's gaps: the launching thread shares the GIL with the
    # staging or emitting threads)
    replays = {}

    def wave_engine():
        # phase 12: the wave-group decoder: every block's native.compress
        # stream parsed and planned on the host (stage_waves of 64-row
        # pieces, 4 threads; each piece copied to the card as it comes and
        # the pieces joined there), the plans run on the card in launches
        # of the card's resident rows
        width = kw.resident_rows(dev, 65536)
        log(card, f"wave engine launch width: {width} rows (SMs x resident "
                  f"one-warp CTAs per SM)")
        nblk = wave_mib << 4
        n = sum(len(b) for b in blocks[:nblk])
        ref = torch.zeros(nblk << 16, dtype=torch.uint8)
        ref[:n] = torch.frombuffer(bytearray(full[:n]), dtype=torch.uint8)
        ref = ref.to(dev).view(nblk, 65536)

        def stage(lo):
            t0 = time.perf_counter()
            staged = kw.stage_waves(streams[lo : min(lo + SEQ_ROWS, nblk)],
                                    device="cpu")
            return staged, time.perf_counter() - t0

        outs, groups, launched, pieces, stage_s = [], [], [], [], 0.0

        def launch():
            args = join_waves(pieces)
            outs.append(kw.decode_blocks_wavegroup(*args, 65536))
            launched.append(args)
            groups.append(args[2])
            pieces.clear()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            for staged, secs in pool.map(stage, range(0, nblk, SEQ_ROWS)):
                assert staged is not None, "a wave plan over WAVE_G_CAP"
                stage_s += secs
                if sum(p[0].shape[0] for p in pieces) + staged[0].shape[0] \
                        > width:
                    launch()
                pieces.append(tuple(t.to(dev) for t in staged))
            launch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        replays["wave"] = (n, stage_s, wall, [
            lambda a=a: kw.decode_blocks_wavegroup(*a, 65536)
            for a in launched])
        assert torch.equal(torch.cat(outs), ref), "wave decode != input"
        ng = torch.cat(groups)
        log(card, f"wave: {nblk} blocks in {len(launched)} launches "
                  f"({[a[0].shape[0] for a in launched]} rows) byte-identical "
                  f"to the input, 0 plans over the cap of {kw.WAVE_G_CAP}, "
                  f"{int(ng.min())}-{int(ng.max())} groups per block (mean "
                  f"{float(ng.float().mean()):.1f})")

    def devmatch_engine():
        # phase 13: the device match finder: stage_words, the kernel
        # (home route) in launches of the card's resident blocks, D2H,
        # then native.emit_from_cands in 4 threads
        width = km.resident_rows(dev)
        log(card, f"devmatch engine launch width: {width} blocks (SMs x "
                  f"resident CTAs per SM)")
        nblk = devmatch_mib << 4
        n = sum(len(b) for b in blocks[:nblk])

        def emit(lo, cands):
            return [native.emit_from_cands(blocks[lo + i], cands[i])
                    for i in range(len(cands))]

        bodies, launched, stage_s = [], [], 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            futs = []
            for lo in range(0, nblk, width):
                t1 = time.perf_counter()
                w, npos = km.stage_words(blocks[lo : min(lo + width, nblk)])
                stage_s += time.perf_counter() - t1
                args = tuple(torch.from_numpy(a).to(dev) for a in (w, npos))
                cands = km.find_candidates(*args)
                launched.append(args)
                futs.append(pool.submit(
                    emit, lo, cands.cpu().numpy().reshape(len(w), -1)))
            for f in futs:
                bodies += f.result()
        wall = time.perf_counter() - t0
        replays["devmatch"] = (n, stage_s, wall, [
            lambda a=a: km.find_candidates(*a) for a in launched])

        def check(i):
            blk = blocks[i]
            return native.decompress(put_uvarint(len(blk)) + bodies[i]) == blk

        with ThreadPoolExecutor(4) as pool:
            assert all(pool.map(check, range(nblk))), "devmatch emission"
        emitted = sum(len(b) for b in bodies)
        ref = sum(len(s) - len(put_uvarint(len(b)))
                  for s, b in zip(streams[:nblk], blocks))
        log(card, f"devmatch: {nblk} emissions decode to their blocks; "
                  f"emitted {emitted} B against {ref} B of native.compress "
                  f"bodies ({(emitted - ref) / ref * 100:+.3f}%)")

    counts = {name: counted(card, f"{name} run", fn)[2] for name, fn in (
        ("id", id_engine), ("classify", classify_engine),
        ("seq", seq_engine), ("wave", wave_engine),
        ("devmatch", devmatch_engine))}
    for eng, kernels in (("id", ["crc32c_rows"]), ("classify", ["flat_exec"]),
                         ("seq", ["seq_decode", "seq_encode", "crc32c_rows",
                                  "frame_records"]),
                         ("wave", ["wavegroup"]),
                         ("devmatch", ["match_cands"])):
        for name in kernels:
            assert counts[eng][name] > 0, f"{name} never launched in {eng}"
    replays.update(seq_launches(dev, full[: seq_mib << 20]))
    for name, (n, stage_s, wall, launches) in replays.items():
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for launch in launches:
            launch()
        end.record()
        torch.cuda.synchronize()
        kern_s = start.elapsed_time(end) / 1e3
        rates[f"{name}.kernel"] = n / kern_s / 1e9
        if wall is None:  # a seq-engine call: its rate is phase 11's line
            log(card, f"{name}: {n} B; its {len(launches)} launches "
                      f"({stage_s}) replayed back to back {kern_s:.4f} s = "
                      f"{rates[f'{name}.kernel']:.3f} GB/s kernel-only")
            continue
        rates[f"{name}.call"] = n / wall / 1e9
        log(card, f"{name}: {n} B; staging {stage_s:.4f} s (sum over "
                  f"threads); its {len(launches)} launches replayed back to "
                  f"back {kern_s:.4f} s = {rates[f'{name}.kernel']:.3f} GB/s "
                  f"kernel-only; whole call {wall:.4f} s = "
                  f"{rates[f'{name}.call']:.3f} GB/s")
    return rates, counts


def seq_launches(dev, data: bytes) -> dict:
    """The seq engine's kernel launches for ``compress_framed(data)`` and
    ``decompress_framed_to_device`` of its stream, recorded (arguments
    copied by ``kernel_cost.keep``, since the runtime reuses its staging
    tensors) in one more uncounted run of each, for main_path's
    back-to-back replay: {name: (bytes, "rows per launch", None,
    [launch, ...])}."""
    import snappy_tpu_torch as st
    from snappy_tpu_torch.kernels import decode_seq as kds
    from snappy_tpu_torch.kernels import encode_seq as kes
    from snappy_tpu_torch.bench.kernel_cost import keep
    from snappy_tpu_torch.runtime import device_codec as dc

    recorded = {"seq_decode": [], "seq_encode": []}
    real = {"seq_decode": dc.decode_blocks_seq,
            "seq_encode": dc.encode_blocks_seq}

    def recorder(name):
        def call(*args, **kwargs):
            recorded[name].append((tuple(keep(a) for a in args), kwargs))
            return real[name](*args, **kwargs)
        return call

    dc.FLAT, dc.HOST_PARSE = False, False
    dc.decode_blocks_seq = recorder("seq_decode")
    dc.encode_blocks_seq = recorder("seq_encode")
    try:
        fr = st.compress_framed(data, device=dev)
        st.decompress_framed_to_device(fr, device=dev)
    finally:
        dc.decode_blocks_seq = real["seq_decode"]
        dc.encode_blocks_seq = real["seq_encode"]
        dc.FLAT, dc.HOST_PARSE = True, True
    out = {}
    for name, fn in (("seq_decode", kds.decode_blocks_seq),
                     ("seq_encode", kes.encode_blocks_seq)):
        widths = sorted({a[0].shape[0] for a, _ in recorded[name]})
        out[f"seq.{name}"] = (
            len(data), f"{'/'.join(map(str, widths))} rows a launch", None,
            [lambda a=a, k=k, fn=fn: fn(*a, **k) for a, k in recorded[name]])
    return out


def kernel_times(card, dev, plan, rplan, eplan, seq64, seq_wide, wave,
                 match, frame):
    """Phase 14: each kernel against its plain version at the main path's
    shapes, alternating plain, kernel, kernel, plain (a serial walk's
    plain once, before the kernel).  The main path's shape ("main", the
    table's row): the CRC at BATCH rows of the id engine's pitched panel,
    the flat kernel on BATCH decode plans as the runtime uploads them
    (``rplan``: meta cut to the used trips, B rows bucketed); the
    sequential, wave and match kernels at their engine's width (the card's
    resident rows; ``wave`` and ``match``: the 64-row and wide arguments;
    the sequential decode on phase 5's span of stride-0 rows, as the seq
    engine stages a batch; the sequential plain times at the width are
    phases 5-6's single call on the same streams), the framed-record kernel on phase 6b's aligned
    batch at the seq engine's width (``frame``: its arguments and its
    plain version's ms there).  Besides: the CRC at one row (a 4 KiB and a
    64 KiB length, a checkpoint tensor's call) and at the seq engine's
    width, the flat kernel on the same plans at the full trip cap and
    the widest B rows (``plan``, as phase 4 stages them) and on BATCH
    encode-replay plans, and the sequential, wave and match kernels at
    SEQ_ROWS rows.
    Each kernel's time two ways: ``ms``, CUDA events around back-to-back
    calls of its wrapper (the host's time between launches included);
    ``device_ms``, the card's own time: the mean of the kernel's own
    torch.profiler records (``bench.kernel_cost.profiled``), their count
    beside the launches in ``records``.  Its bound: its bytes
    (``bench.kernel_cost.kernel_bytes``) over the card's memory rate; the
    integer and byte work per byte is far under the card's operation
    rates, so bytes bound all seven.  Returns {name or name.label: ms,
    device_ms, records, plain_ms, bound_ms, rows}, the plain name at the
    main path's shape."""
    from snappy_tpu_torch.bench.kernel_cost import (HBM_BYTES_PER_S,
                                                    kernel_bytes, profiled)
    from snappy_tpu_torch.kernels import crc32c as kc
    from snappy_tpu_torch.kernels import decode_flat as kf
    from snappy_tpu_torch.kernels import decode_seq as kds
    from snappy_tpu_torch.kernels import decode_wavegroup as kw
    from snappy_tpu_torch.kernels import encode_seq as kes
    from snappy_tpu_torch.kernels import frame_records as kfr
    from snappy_tpu_torch.kernels import match as km
    from snappy_tpu_torch.runtime import device_codec as dc

    rng = np.random.default_rng(7)
    seq_rows = dc._seq_width(kds.resident_rows, dev, 65536)
    panel = torch.from_numpy(rng.integers(
        0, 256, (max(dc.BATCH, seq_rows), 520 * 128), dtype=np.uint8)).to(dev)
    rows = panel[: dc.BATCH, :kc.CHUNK]
    lens = torch.full((dc.BATCH,), kc.CHUNK, dtype=torch.int32, device=dev)
    wide = panel[:seq_rows, :kc.CHUNK].contiguous()  # the decoded rows
    wide_lens = torch.full((seq_rows,), kc.CHUNK, dtype=torch.int32,
                           device=dev)
    one = wide[:1]
    out = {}
    fns = {
        "crc32c_rows": (kc.crc32c_chunks, kc.crc32c_chunks_plain, {}),
        "flat_exec": (kf.decode_blocks_flat, kf.decode_blocks_flat_plain,
                      {"dst_max": 65536}),
        "seq_decode": (kds.decode_blocks_seq, kds.decode_blocks_seq_plain,
                       {"out_max": 65536}),
        "seq_encode": (kes.encode_blocks_seq, kes.encode_blocks_seq_plain, {}),
        "wavegroup": (kw.decode_blocks_wavegroup,
                      kw.decode_blocks_wavegroup_plain, {"out_max": 65536}),
        "match_cands": (km.find_candidates, km.find_candidates_plain, {}),
        "frame_records": (kfr.frame_records, kfr.frame_records_plain, {}),
    }
    enc_kw = {"dst_max": 81920, "out_rows": 640}
    # (name, shape label, args, kernel iters, plain iters or a plain ms,
    #  keyword arguments other than the kernel's own)
    runs = [("crc32c_rows", "main", (rows, lens), 200, 5, None),
            ("crc32c_rows", "1 row 4 KiB",
             (one, torch.tensor([4096], dtype=torch.int32, device=dev)),
             200, 5, None),
            ("crc32c_rows", "1 row 64 KiB", (one, wide_lens[:1]), 200, 5,
             None),
            ("crc32c_rows", "seq width", (wide, wide_lens), 100, 2, None),
            ("flat_exec", "main", rplan, 200, 5, None),
            ("flat_exec", "full trip cap", plan, 200, 5, None),
            ("flat_exec", "encode replay", eplan, 200, 5, enc_kw),
            ("seq_decode", "64", seq64["seq_decode"], 20, 1, None),
            ("seq_decode", "main", seq_wide["seq_decode"][0], 10,
             seq_wide["seq_decode"][1], None),
            ("seq_encode", "64", seq64["seq_encode"], 20, 1, None),
            ("seq_encode", "main", seq_wide["seq_encode"][0], 10,
             seq_wide["seq_encode"][1], None),
            ("wavegroup", "64", wave[0], 50, 2, None),
            ("wavegroup", "main", wave[1], 20, 2, None),
            ("match_cands", "64", match[0], 50, 5, None),
            ("match_cands", "main", match[1], 20, 3, None),
            ("frame_records", "main", frame[0], 200, frame[1], None)]
    for name, shape, args, k_iters, plain_it, kw_over in runs:
        kern_fn, plain_fn, kw_args = fns[name]
        kw_args = kw_over or kw_args
        kern = lambda: kern_fn(*args, **kw_args)  # noqa: E731
        plain = lambda: plain_fn(*args, **kw_args)  # noqa: E731
        nrows = args[0].shape[0]
        if plain_it == 1:
            # a serial walk: one call, no warm-up (seconds to minutes)
            plain_ms = time_ms(plain, 1, warm=False)
            k1 = time_ms(kern, k_iters)
            k2 = time_ms(kern, k_iters)
            plain_txt = f"plain {plain_ms:.4f} ms (one call)"
        elif isinstance(plain_it, int):
            p1 = time_ms(plain, plain_it)
            k1 = time_ms(kern, k_iters)
            k2 = time_ms(kern, k_iters)
            p2 = time_ms(plain, plain_it)
            plain_txt = f"plain {p1:.4f}/{p2:.4f} ms"
            plain_ms = min(p1, p2)
        else:
            k1 = time_ms(kern, k_iters)
            k2 = time_ms(kern, k_iters)
            plain_ms = plain_it
            plain_txt = f"plain {plain_ms:.1f} ms (phases 5-6b, one call)"
        recs = profiled(kern, min(k_iters, 50), PROFILER_KEYS[name])
        dev_ms = recs["kernel_ms_mean"]
        records = [recs["kernel_records"], recs["launches"]]
        nbytes = kernel_bytes(name, args, kw_args.get("dst_max", 65536),
                              kw_args.get("out_rows", 520))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out[name if shape == "main" else f"{name}.{shape}"] = {
            "ms": min(k1, k2), "device_ms": dev_ms, "records": records,
            "plain_ms": plain_ms, "bound_ms": bound, "rows": nrows}
        dev_txt = ("no kernel record from the profiler" if dev_ms is None
                   else f"{dev_ms:.4f} ms on the card (the mean of "
                        f"{records[0]} profiler records of {records[1]} "
                        f"launches)")
        log(card, f"{name} ({shape}) at [{nrows} rows]: kernel "
                  f"{k1:.4f}/{k2:.4f} ms a call, {dev_txt}, "
                  f"{plain_txt}; bound {bound:.4f} ms ({nbytes} B "
                  f"at {HBM_BYTES_PER_S / 1e12} TB/s)")
    return out


# published gpt2-medium (Radford et al. 2019, Table 2; the Hugging Face
# gpt2-medium model card): 24 layers, d_model 1,024, 16 heads, vocab
# 50,257, context 1,024
GPT2_MEDIUM = {"n_layer": 24, "d_model": 1024, "n_head": 16,
               "vocab": 50257, "n_ctx": 1024}


def gpt2_state(n_layer: int, dev, seed: int) -> dict:
    """A state dict with GPT-2 medium's tensor shapes and names at
    ``n_layer`` layers, values as at initialisation: weights normal(0,
    0.02) from a seeded generator on the card, LayerNorm weights ones,
    biases zeros."""
    d, vocab, ctx = (GPT2_MEDIUM[k] for k in ("d_model", "vocab", "n_ctx"))
    g = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        return torch.empty(shape, device=dev).normal_(0.0, 0.02, generator=g)

    def ones(n):
        return torch.ones(n, device=dev)

    def zeros(n):
        return torch.zeros(n, device=dev)

    state = {"wte.weight": w(vocab, d), "wpe.weight": w(ctx, d),
             "ln_f.weight": ones(d), "ln_f.bias": zeros(d)}
    for i in range(n_layer):
        p = f"h.{i}."
        state.update({
            p + "ln_1.weight": ones(d), p + "ln_1.bias": zeros(d),
            p + "attn.c_attn.weight": w(d, 3 * d),
            p + "attn.c_attn.bias": zeros(3 * d),
            p + "attn.c_proj.weight": w(d, d), p + "attn.c_proj.bias": zeros(d),
            p + "ln_2.weight": ones(d), p + "ln_2.bias": zeros(d),
            p + "mlp.c_fc.weight": w(d, 4 * d), p + "mlp.c_fc.bias": zeros(4 * d),
            p + "mlp.c_proj.weight": w(4 * d, d),
            p + "mlp.c_proj.bias": zeros(d),
        })
    return state


def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()


def checkpoint_phase(card, dev, layers: int, seed: int):
    """Phase 15: save_pytree -> load_pytree of a GPT-2-medium-shaped
    state through the public checkpoint API, in the id engine and in the
    device LZ engine, each run counted.  Returns the rates and the runs'
    launch counts."""
    from snappy_tpu_torch import native
    from snappy_tpu_torch.errors import ChecksumError, CorruptError
    from snappy_tpu_torch import checkpoint as ck
    from snappy_tpu_torch.runtime import device_codec as dc

    state = gpt2_state(layers, dev, seed)
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    mats = sorted(k for k, t in state.items() if t.dim() == 2)
    vecs = sorted(k for k, t in state.items() if t.dim() == 1)
    log(card, f"phase 15: GPT-2 medium state ({GPT2_MEDIUM}, {layers} "
              f"layers): {len(state)} tensors ({len(mats)} matrices, "
              f"{len(vecs)} vectors), "
              f"{sum(t.numel() for t in state.values())} float32 "
              f"parameters = {nbytes} B")
    rates, counts = {}, {}

    blob, secs, counts["ckpt.id.save"] = counted(
        card, "checkpoint id save_pytree", lambda: ck.save_pytree(state))
    rates["ckpt.id.save"] = nbytes / secs / 1e9
    back, secs, counts["ckpt.id.load"] = counted(
        card, "checkpoint id load_pytree(to_device=True)",
        lambda: ck.load_pytree(blob))
    rates["ckpt.id.load"] = nbytes / secs / 1e9
    for run in ("ckpt.id.save", "ckpt.id.load"):
        assert counts[run]["crc32c_rows"] > 0, f"crc32c_rows never in {run}"
    assert sorted(back) == sorted(state)
    for k, t in state.items():
        assert back[k].device == dev and back[k].dtype == t.dtype
        assert torch.equal(back[k], t), f"checkpoint round trip: {k}"
    del back
    entries = ck.container_entries(blob)
    stored = total = 0
    for name, lo, hi in entries:
        entry = blob[lo:hi]
        n = int.from_bytes(entry[11:14], "little")
        want = native.compress_framed(_tensor_bytes(state[name]), threads=4)
        assert entry[:10] + entry[14 + n:] == want, f"stream of {name}"
        chunks, _ = dc._scan_frames(want)
        stored += sum(c[0] == 1 for c in chunks)
        total += len(chunks)
    log(card, f"checkpoint id: {len(state)} tensors bit-exact after "
              f"save_pytree -> load_pytree on the card; container "
              f"{len(blob)} B; every stream after its manifest equals "
              f"native.compress_framed ({stored} of {total} chunks stored "
              f"uncompressed); save {rates['ckpt.id.save']:.3f} GB/s, load "
              f"{rates['ckpt.id.load']:.3f} GB/s")

    # the split: each tensor on its own, matrices against vectors
    split = {}
    for cls, names in (("matrices", mats), ("vectors", vecs)):
        nb = sum(state[k].numel() * 4 for k in names)
        save_s = load_s = 0.0
        for k in names:
            one, secs = timed(lambda k=k: ck.save_array(state[k]))
            save_s += secs
            got, secs = timed(lambda one=one: ck.load_array(one))
            load_s += secs
            assert torch.equal(got, state[k]), k
        split[cls] = (nb, save_s, load_s)
        rates[f"ckpt.id.save.{cls}"] = nb / save_s / 1e9
        rates[f"ckpt.id.load.{cls}"] = nb / load_s / 1e9
        log(card, f"checkpoint id, {len(names)} {cls} one call each "
                  f"({min(state[k].numel() * 4 for k in names)}-"
                  f"{max(state[k].numel() * 4 for k in names)} B): {nb} B, "
                  f"save {save_s:.4f} s = "
                  f"{rates[f'ckpt.id.save.{cls}']:.3f} GB/s "
                  f"({save_s / len(names) * 1e3:.3f} ms a call), load "
                  f"{load_s:.4f} s = {rates[f'ckpt.id.load.{cls}']:.3f} "
                  f"GB/s ({load_s / len(names) * 1e3:.3f} ms a call)")

    # a flipped payload byte and a truncated container
    name, lo, hi = next(e for e in entries if e[0] == mats[0])
    bad = bytearray(blob)
    bad[lo:hi] = flip_payload_byte(blob[lo:hi])
    expect_raise(ChecksumError, lambda: ck.load_pytree(bytes(bad)),
                 f"checkpoint: flipped payload byte in {name}")
    del bad
    for cut in (10, len(blob) // 2, len(blob) - 1):
        expect_raise(CorruptError, lambda: ck.load_pytree(blob[:cut]),
                     f"checkpoint: container cut at {cut}")
    log(card, f"checkpoint: flipped payload byte in {name} raised "
              f"ChecksumError; containers cut at 10, half and all but one "
              f"byte raised CorruptError")

    # the device LZ engine (SNAPPY_TPU_FLAT=0 SNAPPY_TPU_HOST_PARSE=0)
    from snappy_tpu_torch.kernels import decode_seq as kds
    from snappy_tpu_torch.kernels import encode_seq as kes

    log(card, f"checkpoint seq: launches of up to "
              f"{dc._seq_width(kds.resident_rows, dev, 65536)} rows "
              f"(seq_decode) and {dc._seq_width(kes.resident_rows, dev, 65536)}"
              f" rows (seq_encode), fewer for a tensor of fewer chunks")
    dc.FLAT, dc.HOST_PARSE = False, False
    blob2, secs, counts["ckpt.seq.save"] = counted(
        card, "checkpoint seq save_pytree", lambda: ck.save_pytree(state))
    rates["ckpt.seq.save"] = nbytes / secs / 1e9
    by_name = {n: (lo, hi) for n, lo, hi in entries}
    for n, lo, hi in ck.container_entries(blob2):
        ilo, ihi = by_name[n]
        assert blob2[lo:hi] == blob[ilo:ihi], f"seq stream of {n} != id"
    back, secs, counts["ckpt.seq.load"] = counted(
        card, "checkpoint seq load_pytree(to_device=True)",
        lambda: ck.load_pytree(blob2))
    rates["ckpt.seq.load"] = nbytes / secs / 1e9
    assert sorted(back) == sorted(state)
    for k, t in state.items():
        assert torch.equal(back[k], t), f"seq checkpoint round trip: {k}"
    assert counts["ckpt.seq.save"]["seq_encode"] > 0, "seq_encode in save"
    assert counts["ckpt.seq.load"]["seq_decode"] > 0, "seq_decode in load"
    dc.FLAT, dc.HOST_PARSE = True, True
    log(card, f"checkpoint seq: {len(state)} tensors bit-exact, streams equal "
              f"to the id engine's; save {rates['ckpt.seq.save']:.3f} GB/s, "
              f"load {rates['ckpt.seq.load']:.3f} GB/s")
    lo, hi = by_name["wpe.weight"]
    return rates, counts, blob[lo:hi]


# ``python -m <module> <args>`` run in a child interpreter that then
# prints, as the last line of its stderr, the device the port's default
# pick resolves to and every kernel's launch count
_CLI_CHILD = """
import importlib, json, runpy, sys
from snappy_tpu_torch import device
mods = {k: importlib.import_module(m) for k, m in %r.items()}
rc = 0
try:
    runpy.run_module(%r, run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code or 0
print(json.dumps({"device": str(device.resolve()),
                  "launches": {k: m.launches for k, m in mods.items()}}),
      file=sys.stderr, flush=True)
sys.exit(rc)
"""


def stream_phase(card, dev, data: bytes, info_blob: bytes):
    """Phase 16: the 256 MiB corpus through FramedWriter / FramedReader
    (backend "torch", 1 MiB writes and reads) and through the CLI
    (``python -m snappy_tpu_torch``, streamed above its threshold), each
    against native.compress_framed; verify on a corrupted file and info
    on a phase-15 blob.  Returns the rates and the runs' launch counts."""
    import io
    import os
    import tempfile

    from snappy_tpu_torch import native
    from snappy_tpu_torch.errors import ChecksumError, exit_code_for
    from snappy_tpu_torch import FramedReader, FramedWriter

    n = len(data)
    mib = 1 << 20
    ref = native.compress_framed(data, threads=4)
    rates, counts = {}, {}

    def write():
        sink = io.BytesIO()
        with FramedWriter(sink, backend="torch") as w:
            for i in range(0, n, mib):
                w.write(data[i : i + mib])
        return sink.getvalue()

    fr, secs, counts["stream.write"] = counted(
        card, "FramedWriter(backend='torch'), 1 MiB writes", write)
    rates["stream.write"] = n / secs / 1e9
    assert fr == ref, "FramedWriter != native.compress_framed"
    assert counts["stream.write"]["crc32c_rows"] > 0

    def read():
        r = FramedReader(io.BytesIO(fr), backend="torch")
        out = bytearray()
        while piece := r.read(mib):
            out += piece
        return bytes(out)

    got, secs, counts["stream.read"] = counted(
        card, "FramedReader(backend='torch'), 1 MiB reads", read)
    rates["stream.read"] = n / secs / 1e9
    assert got == data, "FramedReader != input"
    del got
    log(card, f"streams: {n} B, writer {rates['stream.write']:.3f} GB/s "
              f"(bytes equal native.compress_framed), reader "
              f"{rates['stream.read']:.3f} GB/s (bytes equal the input)")

    root = os.path.dirname(os.path.abspath(__file__))
    child = _CLI_CHILD % (_counter_modules(), "snappy_tpu_torch")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "corpus.bin")
        with open(src, "wb") as f:
            f.write(data)

        def cli(*args):
            """(process, seconds, own stderr, child report) of the CLI."""
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", child, *args],
                cwd=root, capture_output=True, text=True, timeout=600)
            secs = time.perf_counter() - t0
            *own, last = proc.stderr.strip().splitlines() or [""]
            try:
                report = json.loads(last)
            except ValueError:
                raise AssertionError(
                    f"CLI {args[0]}: no report: {proc.stderr[-2000:]}")
            assert report["device"] == str(dev), report
            return proc, secs, "\n".join(own).strip(), report

        # the writer's batches launch the CRC kernel; the reader's
        # records decode on the host (native walk + host CRC), as in JAX
        for name, args, out, want in (
                ("compress", ("compress", "--backend", "torch", src, "-o",
                              src + ".sz"), src + ".sz", ref),
                ("decompress", ("decompress", "--backend", "torch",
                                src + ".sz", "-o", src + ".out"),
                 src + ".out", data)):
            proc, secs, own, report = cli(*args)
            assert proc.returncode == 0, proc.stderr[-2000:]
            with open(out, "rb") as f:
                assert f.read() == want, f"CLI {name} output"
            counts[f"cli.{name}"] = report["launches"]
            if name == "compress":
                assert report["launches"]["crc32c_rows"] > 0, report
            rates[f"cli.{name}"] = n / secs / 1e9
            log(card, f"CLI {name} --backend torch on {report['device']}: "
                      f"{n} B in {secs:.4f} s = "
                      f"{rates[f'cli.{name}']:.3f} GB/s with process start, "
                      f"kernel launches {report['launches']}; its own "
                      f"line: {own}")
        with open(src + ".bad", "wb") as f:
            f.write(flip_payload_byte(ref))
        proc, _, _, _ = cli("verify", "--backend", "torch", src + ".bad")
        verify_rc = proc.returncode
        assert verify_rc == exit_code_for(ChecksumError()), \
            (verify_rc, proc.stderr[-2000:])
        with open(os.path.join(tmp, "wpe.sz"), "wb") as f:
            f.write(info_blob)
        proc, _, _, _ = cli("info", os.path.join(tmp, "wpe.sz"))
        assert proc.returncode == 0, proc.stderr[-2000:]
        shape = [GPT2_MEDIUM["n_ctx"], GPT2_MEDIUM["d_model"]]
        assert f"dtype=float32 shape={shape}" in proc.stdout, proc.stdout
        log(card, f"CLI: compress and decompress outputs byte-identical; "
                  f"verify of a corrupted file exited {verify_rc} "
                  f"(exit_code_for(ChecksumError)); info: "
                  f"{proc.stdout.strip().splitlines()[-1]}")
    return rates, counts


# one rank of the multi-host device entry points, run in a child
# interpreter: host_decompress_framed_to_device -> host_compress_framed_
# from_device -> gather_lengths -> pwrite at the gathered offset.  Its
# timings go to stdout as one JSON line; the device the port's default
# pick resolves to and every kernel's launch count to the last line of
# its stderr
_DIST_CHILD = """
import importlib, json, sys, time
import torch
from snappy_tpu_torch import device
from snappy_tpu_torch.dist import mesh as dm, multihost as mh
from snappy_tpu_torch.spec.format import STREAM_ID_CHUNK
mods = {k: importlib.import_module(m) for k, m in %r.items()}
src, out, coord = sys.argv[1:4]
nproc, pid = int(sys.argv[4]), int(sys.argv[5])
dm.init_distributed(coord, nproc, pid, timeout=300)
with open(src, "rb") as f:
    fr = f.read()
t0 = time.perf_counter()
rows, dlens, lo, cnt = mh.host_decompress_framed_to_device(fr, pid, nproc)
torch.cuda.synchronize()
t1 = time.perf_counter()
bodies, lengths = mh.host_compress_framed_from_device(rows, dlens)
t2 = time.perf_counter()
torch.distributed.barrier()  # the collective's time below, not a peer's lag
t2b = time.perf_counter()
all_lengths = mh.gather_lengths(lengths)
t3 = time.perf_counter()
head = len(STREAM_ID_CHUNK)
mh._ensure_outfile(out, head + int(all_lengths.sum()), pid)
mh._pwrite(out, [(STREAM_ID_CHUNK if pid == 0 else b"", 0),
                 (b"".join(bodies), head + int(all_lengths[:lo].sum()))])
t4 = time.perf_counter()
print(json.dumps({"host": pid, "chunks": cnt, "bytes": int(dlens.sum()),
                  "mesh": str(rows.mesh), "decode_s": t1 - t0,
                  "encode_s": t2 - t1, "wait_s": t2b - t2,
                  "gather_s": t3 - t2b,
                  "write_s": t4 - t3}), flush=True)
torch.distributed.destroy_process_group()
print(json.dumps({"device": str(device.resolve()),
                  "launches": {k: m.launches for k, m in mods.items()}}),
      file=sys.stderr, flush=True)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(code: str, args_per_rank: list, cwd: str, timeout: float = 600):
    """Run ``python -c code`` once per argument list, all at once; every
    child must exit 0 within ``timeout`` seconds.  Returns the wall
    seconds and, per rank, its last stdout line (JSON) and the report on
    its last stderr line (JSON)."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, *args], cwd=cwd,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for args in args_per_rank]
    res = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            res.append((json.loads(out.strip().splitlines()[-1]),
                        json.loads(err.strip().splitlines()[-1])))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.perf_counter() - t0, res


def _batch64(seed: int):
    """The 64 blocks of ``__graft_entry__.dryrun_multichip``'s kind
    (text, random and run-length rows of up to 1 KiB), from a seed."""
    rng = np.random.default_rng(seed)
    raw = []
    for i in range(64):
        if i % 3 == 0:
            raw.append((b"sharded snappy block " * 50)[:1024])
        elif i % 3 == 1:
            raw.append(rng.integers(0, 256, 1024, dtype=np.uint8).tobytes())
        else:
            raw.append(b"Z" * 512)
    return raw


def _batch_forms(dm, mesh, raw: list) -> dict:
    """The flat and id forms of dist.mesh and its match finder on one
    batch of blocks over ``mesh``; host results by name."""
    enc = dm.stage_flat_enc_batch(raw)
    elems = enc[6]
    res = {"enc": dm.sharded_encode_flat(mesh, *enc[:4])}
    res["flat"], res["flat_err"] = dm.sharded_decode_flat(
        mesh, *dm.stage_flat_dec_batch(elems), out_max=65536)
    ids = dm.stage_dec_id_batch(elems)
    res["id"], res["id_err"] = dm.sharded_decode_id(mesh, *ids)
    res["crc"] = dm.sharded_crc(mesh, np.ascontiguousarray(
        ids[0][:, :65536]), ids[1])
    res["match"] = dm.sharded_match(mesh, raw, slots=4096)
    res["clens"], res["elems"] = enc[4], elems
    return res


def dist_phase(card, dev, mib: int, seed: int):
    """Phase 17: dist.mesh and dist.multihost at a loader's size, ``mib``
    MiB of make_corpus(seed).  The mesh forms on every local card
    (``make_mesh()``) and on two shards of the card: the stream loader's
    rows against the single-device decompress_framed_to_device, a
    flipped payload byte, the from-device encode against
    native.compress_framed, and the 64-block flat, id and match forms
    against the same forms on the CPU (the plain versions).  Then two
    processes on the card over gloo: the multihost CLI's compress and
    decompress, and the device entry points with the length all-gather,
    each output against the single-process one.  Returns the rates and
    the runs' launch counts (the CPU comparisons launch nothing)."""
    import os
    import tempfile

    import snappy_tpu_torch as st
    from snappy_tpu_torch import native
    from snappy_tpu_torch.bench import kernel_cost
    from snappy_tpu_torch.dist import mesh as dm
    from snappy_tpu_torch.errors import ChecksumError
    from snappy_tpu_torch.kernels.crc32c import crc32c_chunks

    t0 = time.perf_counter()
    data = corpus_bytes(mib << 20, seed)
    n = len(data)
    nchunks = -(-n // 65536)
    log(card, f"phase 17: {n} B ({nchunks} chunks) of make_corpus(seed="
              f"{seed}) made in {time.perf_counter() - t0:.2f} s")
    rates, counts = {}, {}
    ref, secs = timed(lambda: native.compress_framed(data, threads=4))
    rates["dist.host native.compress_framed"] = n / secs / 1e9
    _, secs = timed(lambda: native.decompress_framed(ref, threads=4))
    rates["dist.host native.decompress_framed"] = n / secs / 1e9
    flat = st.decompress_framed_to_device(ref, device=dev)  # the reference
    want_lens = np.minimum(n - np.arange(nchunks) * 65536, 65536)
    bad = flip_payload_byte(ref)
    raw = _batch64(seed)
    on_cpu = _batch_forms(dm, dm.make_mesh(devices=["cpu"]), raw)

    for label, mesh in (("mesh1", dm.make_mesh()),
                        ("mesh2", dm.make_mesh(devices=[dev] * 2))):
        name = f"dist.{label}"
        (rows, dlens, b), secs, counts[f"{name}.decompress"] = counted(
            card, f"{name} {mesh} sharded_decompress_framed_to_device",
            lambda: dm.sharded_decompress_framed_to_device(mesh, ref))
        rates[f"{name}.decompress_framed_to_device"] = n / secs / 1e9
        assert b == nchunks and (dlens == want_lens).all()
        per = rows.shape[0] // mesh.size
        for k, (s, d) in enumerate(zip(rows.shards, mesh.devices)):
            lo, hi = k * per, min((k + 1) * per, b)
            want = flat[lo << 16 : min(hi << 16, n)]
            got = s.reshape(-1)
            assert s.device == d and torch.equal(got[: want.numel()],
                                                 want.to(d)), \
                f"{name}: shard {k} != decompress_framed_to_device"
            assert not got[want.numel():].any(), f"{name}: shard {k} tail"
        shards0 = {k: list(v) + [0] * mesh.size for k, v in dm.SHARDS.items()}
        fr2, secs, counts[f"{name}.compress"] = counted(
            card, f"{name} sharded_compress_framed_from_device",
            lambda: dm.sharded_compress_framed_from_device(mesh, rows, dlens))
        rates[f"{name}.compress_framed_from_device"] = n / secs / 1e9
        assert fr2 == ref, f"{name}: from-device stream != native"
        # each mesh position's card: its CRC launches and the bytes it
        # sent to the host in that call (dist.mesh.SHARDS)
        by_card = {k: [v[i] - shards0[k][i] for i in range(mesh.size)]
                   for k, v in dm.SHARDS.items()}
        log(card, f"{name}: per card {[str(d) for d in mesh.devices]}: CRC "
                  f"launches {by_card['crc_launches']}, D2H bytes "
                  f"{by_card['d2h_bytes']}")
        assert all(by_card["crc_launches"]) and all(by_card["d2h_bytes"]), (
            f"{name}: a card of the mesh did no work: {by_card}")
        if label == "mesh1":
            # the card's share of a loader call, and its CRC launch alone
            # (the profiler's records counted: it drops some now and then)
            busy = kernel_cost.profiled(
                lambda: dm.sharded_decompress_framed_to_device(mesh, ref), 1,
                PROFILER_KEYS["crc32c_rows"])
            lens_p = np.zeros(rows.shape[0], np.int32)
            lens_p[:b] = dlens
            crc_args = (rows.shards[0],
                        torch.from_numpy(lens_p[:per]).to(rows.shards[0].device))
            crc = kernel_cost.profiled(lambda: crc32c_chunks(*crc_args), 20,
                                       PROFILER_KEYS["crc32c_rows"])
            bound = (kernel_cost.kernel_bytes("crc32c_rows", crc_args)
                     / kernel_cost.HBM_BYTES_PER_S * 1e3)
            log(card, f"{name}: the card's time in one loader call "
                      f"{busy['device_ms_per_call']} ms (torch.profiler: "
                      f"the CRC launch and the copies; {busy['kernel_records']}"
                      f" of {mesh.size} CRC records) of "
                      f"{n / rates[f'{name}.decompress_framed_to_device'] / 1e6:.1f} "
                      f"ms; its CRC launch over {per} rows "
                      f"{crc['kernel_ms_mean']} ms on the card (the mean of "
                      f"{crc['kernel_records']} records of 20 launches), "
                      f"bound {bound:.4f} ms")
        del rows, fr2
        expect_raise(ChecksumError,
                     lambda: dm.sharded_decompress_framed_to_device(mesh, bad),
                     f"{name}: flipped payload byte")
        res, _, counts[f"{name}.batch64"] = counted(
            card, f"{name} 64-block flat, id and match forms",
            lambda: _batch_forms(dm, mesh, raw))
        for key, val in on_cpu.items():
            if isinstance(val, np.ndarray):
                assert np.array_equal(res[key], val), f"{name}: {key} != CPU"
        assert not res["flat_err"].any() and not res["id_err"].any()
        for i, blk in enumerate(raw):
            elem = res["enc"][i, : res["clens"][i]].tobytes()
            assert elem == res["elems"][i] == native.compress(blk)
            assert res["flat"][i, : len(blk)].tobytes() == blk
            assert res["id"][i, : len(blk)].tobytes() == blk
            assert int(res["crc"][i]) == native.crc32c(blk)
        for k in ("crc32c_rows", "flat_exec", "match_cands"):
            assert counts[f"{name}.batch64"][k] > 0, (name, k)
        log(card, f"{name}: {n} B, sharded decompress_framed_to_device "
                  f"{rates[f'{name}.decompress_framed_to_device']:.3f} GB/s, "
                  f"compress_framed_from_device "
                  f"{rates[f'{name}.compress_framed_from_device']:.3f} GB/s "
                  f"(host native.compress_framed "
                  f"{rates['dist.host native.compress_framed']:.3f}, "
                  f"decompress_framed "
                  f"{rates['dist.host native.decompress_framed']:.3f} GB/s); "
                  f"rows equal the single-device loader's, the stream equals "
                  f"native.compress_framed, a flipped byte raised "
                  f"ChecksumError, the 64-block forms equal the CPU's")
    del flat

    root = os.path.dirname(os.path.abspath(__file__))
    mods = _counter_modules()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "corpus.bin")
        with open(src, "wb") as f:
            f.write(data)
        cli = _CLI_CHILD % (mods, "snappy_tpu_torch.dist.multihost")
        for cmd, inp, out, want in (
                ("compress", src, src + ".sz", ref),
                ("decompress", src + ".sz", src + ".out", data)):
            port = _free_port()
            wall, res = _ranks(cli, [
                ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                 "2", "--process-id", str(i), cmd, inp, out]
                for i in range(2)], root)
            with open(out, "rb") as f:
                assert f.read() == want, f"multihost CLI {cmd} output"
            for i, (stats, report) in enumerate(res):
                assert stats["device"] == report["device"] == str(dev), (
                    stats, report)
                assert report["launches"]["crc32c_rows"] > 0, report
                counts[f"dist.cli.{cmd}.rank{i}"] = report["launches"]
            rates[f"dist.cli.{cmd}"] = n / wall / 1e9
            rates[f"dist.cli.{cmd}.ranks"] = n / max(
                s["seconds"] for s, _ in res) / 1e9
            log(card, f"multihost CLI {cmd}, 2 processes on "
                      f"{res[0][1]['device']}: {n} B, "
                      f"{rates[f'dist.cli.{cmd}']:.3f} GB/s with process "
                      f"start, {rates[f'dist.cli.{cmd}.ranks']:.3f} GB/s over "
                      f"the slower rank's call; per rank "
                      f"{[s for s, _ in res]}; launches "
                      f"{[r['launches'] for _, r in res]}; output "
                      f"byte-identical to the single-process one")
        port = _free_port()
        wall, res = _ranks(_DIST_CHILD % mods, [
            [src + ".sz", src + ".dev.sz", f"127.0.0.1:{port}", "2", str(i)]
            for i in range(2)], root)
        with open(src + ".dev.sz", "rb") as f:
            assert f.read() == ref, "multihost device entry points' stream"
        for i, (stats, report) in enumerate(res):
            assert report["device"] == str(dev), report
            assert stats["mesh"] == str(dm.make_mesh()), stats
            assert report["launches"]["crc32c_rows"] > 0, report
            counts[f"dist.devices.rank{i}"] = report["launches"]
        rates["dist.devices"] = n / wall / 1e9
        slow = max(s["decode_s"] + s["encode_s"] + s["gather_s"]
                   for s, _ in res)
        rates["dist.devices.ranks"] = n / slow / 1e9
        log(card, f"multihost device entry points, 2 processes on {dev}: "
                  f"{n} B, {rates['dist.devices']:.3f} GB/s with process "
                  f"start, {rates['dist.devices.ranks']:.3f} GB/s over the "
                  f"slower rank's decode + encode + gather; per rank "
                  f"{[s for s, _ in res]}; gather_lengths "
                  f"{[round(s['gather_s'] * 1e3, 3) for s, _ in res]} ms; "
                  f"launches {[r['launches'] for _, r in res]}; stream "
                  f"byte-identical to native.compress_framed")
    log(card, "phase 17 launches: " + json.dumps(
        {k: sum(c[k] for c in counts.values()) for k in KERNELS}))
    return rates, counts


def _dryrun_batch():
    """``__graft_entry__.dryrun_multichip``'s roundtrip batch: 16 blocks
    at bmax 1024 (text, random, run-length rows), default_rng(0)."""
    bmax = 1024
    rng = np.random.default_rng(0)
    blocks = np.zeros((16, bmax), dtype=np.uint8)
    lens = np.zeros(16, dtype=np.int32)
    for i in range(16):
        if i % 3 == 0:
            row = (b"sharded snappy block " * 50)[:bmax]
        elif i % 3 == 1:
            row = rng.integers(0, 256, bmax, dtype=np.uint8).tobytes()
        else:
            row = b"Z" * (bmax // 2)
        blocks[i, : len(row)] = np.frombuffer(row, dtype=np.uint8)
        lens[i] = len(row)
    return blocks, lens, bmax


def portable_phase(card, dev, hybrid_mib: int, jnp_mib: int, seed: int):
    """Phase 18: the hybrid decode engine, the jnp engines and the mesh
    forms that run them, on make_corpus(seed).  (a) decode_pretagged
    against its plain version on one runtime-shaped batch (the first 64
    compressed chunks, the parser's records, the bucket width), timed,
    with the profiler's count of its kernel records, and on the hand-made
    record sets of ``decode_pretagged.edge_cases``; (b) the hybrid engine
    (FLAT=0, HOST_PARSE=1) over ``hybrid_mib`` MiB beside the host's
    native.decompress_framed, with the card's busy
    share of one call and a flipped payload byte and a broken element;
    (c) the jnp engines (PALLAS=0) over ``jnp_mib`` MiB, on the
    decode_par and encode_par kernels: decode with HOST_PARSE=0,
    compress_framed with RATIO_GUARD, the first 64 chunks' emission
    against encode_np, and the kernels against their plain versions on
    that 64-row batch and on hostile rows, timed beside their bounds
    (``par_kernel_checks``); (d) sharded_encode, sharded_decode and
    roundtrip_step on make_mesh() and on two shards of the card, the dry
    run's 16 blocks and 64 corpus chunks.  Returns (rates, counts, {the
    three kernels, and "decode_par.wide": time row}, {the three kernels:
    max_abs_err})."""
    import snappy_tpu_torch as st
    from snappy_tpu_torch import native
    from snappy_tpu_torch.bench.kernel_cost import (HBM_BYTES_PER_S,
                                                    kernel_bytes, profiled)
    from snappy_tpu_torch.dist import mesh as dm
    from snappy_tpu_torch.errors import ChecksumError, CorruptError
    from snappy_tpu_torch.kernels import decode_par as dp
    from snappy_tpu_torch.kernels import decode_pretagged as kp
    from snappy_tpu_torch.kernels import encode_np as enp
    from snappy_tpu_torch.kernels import encode_par as ep
    from snappy_tpu_torch.runtime import device_codec as dc

    t0 = time.perf_counter()
    full = corpus_bytes(max(hybrid_mib, jnp_mib) << 20, seed)
    log(card, f"phase 18: {len(full)} B of make_corpus(seed={seed}) made in "
              f"{time.perf_counter() - t0:.2f} s")
    rates, counts = {}, {}

    # (a) the record executor against its plain version
    data = full[: hybrid_mib << 20]
    n = len(data)
    ref = native.compress_framed(data, threads=4)
    chunks, _ = dc._scan_frames(ref)
    first = [ch for ch in chunks if ch[0] == 0][:64]
    args = kp.stage_records([ref[ch[1] : ch[1] + ch[2]] for ch in first],
                            [ch[5] for ch in first], [ch[4] for ch in first],
                            device=dev)
    kern = kp.decode_blocks_pretagged(*args)
    plain = kp.decode_blocks_pretagged_plain(*args)
    torch.cuda.synchronize()
    err = int((kern.int() - plain.int()).abs().max())
    assert err == 0, f"decode_pretagged != plain ({err})"
    for i, ch in enumerate(first):
        assert kern[i, : ch[4]].cpu().numpy().tobytes() == \
            native.decompress(ref[ch[1] : ch[1] + ch[2]]), f"row {i}"
    p1 = time_ms(lambda: kp.decode_blocks_pretagged_plain(*args), 3)
    k1 = time_ms(lambda: kp.decode_blocks_pretagged(*args), 200)
    k2 = time_ms(lambda: kp.decode_blocks_pretagged(*args), 200)
    p2 = time_ms(lambda: kp.decode_blocks_pretagged_plain(*args), 3)
    recs = profiled(lambda: kp.decode_blocks_pretagged(*args), 50,
                    PROFILER_KEYS["decode_pretagged"])
    nbytes = kernel_bytes("decode_pretagged", args)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"ms": min(k1, k2), "device_ms": recs["kernel_ms_mean"],
           "records": [recs["kernel_records"], recs["launches"]],
           "plain_ms": min(p1, p2), "bound_ms": bound, "rows": len(first)}
    log(card, f"decode_pretagged (main) at [{len(first)} rows, "
              f"{args[0].shape[1]} B payload rows, {args[1].shape[1]} "
              f"records a row, {int(args[2].sum())} records]: max_abs_err "
              f"{err} against the plain version; kernel {k1:.4f}/{k2:.4f} ms "
              f"a call, {recs['kernel_ms_mean']} ms on the card (the mean "
              f"of {recs['kernel_records']} kernel records of "
              f"{recs['launches']} launches), plain "
              f"{p1:.4f}/{p2:.4f} ms; bound {bound:.4f} ms ({nbytes} B at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s)")
    del kern, plain, args
    # the hand-made record sets: offset-1 runs, chains, sources across
    # group and tile boundaries, a long literal, no records, dst_len and
    # out_max short, a 99,999-byte row, a payload too wide to stage
    for name, (c_np, r_np, nt_np, dl_np, om) in kp.edge_cases().items():
        eargs = [torch.from_numpy(a).to(dev)
                 for a in (c_np, r_np, nt_np, dl_np)]
        ekern = kp.decode_blocks_pretagged(*eargs, out_max=om)
        eplain = kp.decode_blocks_pretagged_plain(*eargs, out_max=om)
        assert torch.equal(ekern, eplain), f"decode_pretagged {name}"
    log(card, f"decode_pretagged: the hand-made record sets "
              f"{sorted(kp.edge_cases())} bit-exact to the plain version")

    # (b) the hybrid engine
    dc.FLAT, dc.HOST_PARSE = False, True
    try:
        _, secs = timed(lambda: native.decompress_framed(ref, threads=4))
        rates["hybrid.host native.decompress_framed"] = n / secs / 1e9
        out, secs, counts["hybrid.decompress_framed"] = counted(
            card, "hybrid decompress_framed",
            lambda: st.decompress_framed(ref, device=dev))
        rates["hybrid.decompress_framed"] = n / secs / 1e9
        assert out == data, "hybrid decompress_framed != input"
        del out
        arr, secs, counts["hybrid.decompress_framed_to_device"] = counted(
            card, "hybrid decompress_framed_to_device",
            lambda: st.decompress_framed_to_device(ref, device=dev))
        rates["hybrid.decompress_framed_to_device"] = n / secs / 1e9
        assert arr.device == dev and torch.equal(arr, torch.frombuffer(
            bytearray(data), dtype=torch.uint8).to(dev)), \
            "hybrid decompress_framed_to_device != input"
        del arr
        busy = profiled(lambda: st.decompress_framed_to_device(
            ref, device=dev), 1, PROFILER_KEYS["decode_pretagged"])
        for name in ("hybrid.decompress_framed",
                     "hybrid.decompress_framed_to_device"):
            for k in ("decode_pretagged", "crc32c_rows"):
                assert counts[name][k] > 0, f"{k} never launched in {name}"
        expect_raise(ChecksumError, lambda: st.decompress_framed(
            flip_payload_byte(ref), device=dev), "hybrid: flipped byte")
        expect_raise(CorruptError, lambda: st.decompress_framed_to_device(
            break_element(ref), device=dev), "hybrid: broken element")
        wall_ms = n / rates["hybrid.decompress_framed_to_device"] / 1e6
        log(card, f"hybrid: {n} B, decompress_framed "
                  f"{rates['hybrid.decompress_framed']:.3f} GB/s, "
                  f"decompress_framed_to_device "
                  f"{rates['hybrid.decompress_framed_to_device']:.3f} GB/s "
                  f"(host native.decompress_framed "
                  f"{rates['hybrid.host native.decompress_framed']:.3f} "
                  f"GB/s); the card busy {busy['device_ms_per_call']} ms "
                  f"(torch.profiler: kernels and copies; "
                  f"{busy['kernel_records']} of "
                  f"{counts['hybrid.decompress_framed_to_device']['decode_pretagged']}"
                  f" record-executor records) of a {wall_ms:.1f} ms "
                  f"to-device call"
                  + ("" if busy["device_ms_per_call"] is None else
                     f" = {busy['device_ms_per_call'] / wall_ms * 100:.1f}%")
                  + "; a flipped payload byte raised ChecksumError, a "
                    "broken element CorruptError")
    finally:
        dc.FLAT, dc.HOST_PARSE = True, True

    # (c) the jnp engines
    data = full[: jnp_mib << 20]
    n = len(data)
    ref = native.compress_framed(data, threads=4)
    dc.PALLAS = False
    for k in dc.ENCODE_REPLACED:
        dc.ENCODE_REPLACED[k] = 0
    try:
        dc.HOST_PARSE = False
        out, secs, counts["jnp.decompress_framed"] = counted(
            card, "jnp decompress_framed",
            lambda: st.decompress_framed(ref, device=dev))
        rates["jnp.decompress_framed"] = n / secs / 1e9
        assert out == data, "jnp decompress_framed != input"
        del out
        fr, secs, counts["jnp.compress_framed"] = counted(
            card, "jnp compress_framed",
            lambda: st.compress_framed(data, device=dev))
        rates["jnp.compress_framed"] = n / secs / 1e9
        assert native.decompress_framed(fr, threads=4) == data, \
            "jnp compress_framed does not round-trip"
    finally:
        dc.PALLAS, dc.HOST_PARSE = True, True
    blocks = [data[i << 16 : (i + 1) << 16] for i in range(64)]
    want_elems = [enp.encode_block_np(b) for b in blocks]
    arr = np.zeros((64, 65536), np.uint8)
    for i, b in enumerate(blocks):
        arr[i, : len(b)] = np.frombuffer(b, np.uint8)
    blk_d = torch.from_numpy(arr).to(dev)
    lens_d = torch.tensor([len(b) for b in blocks], dtype=torch.int32,
                          device=dev)
    comp, clen, ok = ep.encode_blocks(blk_d, lens_d)
    assert bool(ok.all()), "encode_par ok=False on the corpus"
    comp_h, clen_h = comp.cpu().numpy(), clen.cpu().numpy()
    for i, w in enumerate(want_elems):
        assert comp_h[i, : clen_h[i]].tobytes() == w, f"chunk {i} != encode_np"
    dargs = (comp, torch.zeros(64, dtype=torch.int32, device=dev), clen,
             lens_d)
    dec, derr = dp.decode_blocks(*dargs)
    assert not derr.any() and torch.equal(dec, blk_d), "decode_par != input"
    for name, made in (("jnp.decompress_framed", "decode_par"),
                       ("jnp.compress_framed", "encode_par")):
        assert counts[name][made] > 0, f"{made} never launched in {name}"
    log(card, f"jnp: {n} B, decompress_framed (HOST_PARSE=0) "
              f"{rates['jnp.decompress_framed']:.3f} GB/s, compress_framed "
              f"{rates['jnp.compress_framed']:.3f} GB/s ({len(fr)} B, "
              f"replaced rows {dict(dc.ENCODE_REPLACED)}: ok=False "
              f"'not_ok', RATIO_GUARD 'ratio_guard'); the first 64 chunks' "
              f"emission equals encode_np and decodes to them")
    par_rows, par_errs = par_kernel_checks(card, dev, blk_d, lens_d, dargs,
                                           seed)
    rates["jnp.encode_blocks.64"] = \
        64 * 65536 / par_rows["encode_par"]["ms"] / 1e6
    rates["jnp.decode_blocks.64"] = \
        int(lens_d.sum()) / par_rows["decode_par"]["ms"] / 1e6
    rates["jnp.decode_blocks.wide"] = \
        par_rows["decode_par.wide"]["bytes"] / par_rows["decode_par.wide"][
            "ms"] / 1e6
    del comp, dec, dargs

    # (d) the three mesh forms
    dblocks, dlens, dbmax = _dryrun_batch()
    results = {}
    for label, mesh in (("mesh1", dm.make_mesh()),
                        ("mesh2", dm.make_mesh(devices=[dev] * 2))):
        def forms():
            res = {"dry": [np.asarray(x.cpu() if torch.is_tensor(x) else x)
                           for x in dm.roundtrip_step(mesh, dblocks, dlens,
                                                      dbmax)],
                   "enc": dm.sharded_encode(mesh, arr, lens_d.cpu().numpy(),
                                            65536)}
            c, cl, _ = res["enc"]
            res["dec"] = dm.sharded_decode(
                mesh, c, np.zeros(64, np.int32), cl, lens_d.cpu().numpy(),
                65536)
            res["rt"] = [np.asarray(x.cpu() if torch.is_tensor(x) else x)
                         for x in dm.roundtrip_step(
                             mesh, arr, lens_d.cpu().numpy(), 65536)]
            return res

        res, secs, made = counted(card, f"{label} {mesh} sharded_encode, "
                                        f"sharded_decode, roundtrip_step",
                                  forms)
        assert made["decode_par"] > 0 and made["encode_par"] > 0, made
        for key in ("dry", "rt"):
            comp_r, clen_r, ok_r, offs, out_r, err_r, match = res[key]
            assert ok_r.all() and not err_r.any() and bool(match), (label, key)
            assert (offs == np.cumsum(clen_r) - clen_r).all(), (label, key)
        c, cl, okk = res["enc"]
        assert okk.all()
        for i, w in enumerate(want_elems):
            assert c[i, : cl[i]].tobytes() == w, (label, i)
        assert not res["dec"][1].any() and (res["dec"][0] == arr).all()
        results[label] = res
    for key in ("dry", "rt"):
        for x, y in zip(results["mesh1"][key], results["mesh2"][key]):
            assert np.array_equal(x, y), f"mesh1 != mesh2 ({key})"
    for key in ("enc", "dec"):
        for x, y in zip(results["mesh1"][key], results["mesh2"][key]):
            assert np.array_equal(x, y), f"mesh1 != mesh2 ({key})"
    log(card, "mesh forms: roundtrip_step of the dry run's 16 blocks and "
              "sharded_encode, sharded_decode and roundtrip_step of 64 "
              "corpus chunks on make_mesh() and on two shards of the card: "
              "ok, err 0, match, offsets the exclusive scan, emission equal "
              "to encode_np, the two meshes' outputs equal")
    rows = {"decode_pretagged": row, **par_rows}
    errs = {"decode_pretagged": err, **par_errs}
    return rates, counts, rows, errs


def par_kernel_checks(card, dev, blk_d, lens_d, dargs, seed: int):
    """Phase 18 (c)'s kernels: ``decode_par`` (csrc/decode_par.cu) and
    ``encode_par`` (csrc/encode_par.cu) against their plain versions on
    the jnp engines' 64-row batch (``blk_d``, ``lens_d``: the first 64
    corpus chunks; ``dargs``: their element rows), on the hostile decode
    rows (``_bad_streams``' corrupt raw streams, int32 wrap cases among
    them, and ``decode_par.edge_streams``, the element payloads of the
    fuzz tests' hostile framed streams: codes equal, bytes equal where
    the code is 0, error rows zero) and on the hostile encode blocks
    (``encode_par.edge_blocks`` at bmax 65536: a run, a period-3
    pattern, random bytes, a lazy chain, all-0xFF, 1-3 bytes, empty;
    ``encode_par.wide_block`` and a 100,000-byte cut of it at bmax
    2**17, whose encodings are decoded back by ``decode_par``'s wide-row
    path; and one row of the batch's 4 MiB raw stream, timed), and on the
    hand-made cases whose chunked walks do not meet the true walk inside
    a chunk (``encode_par.resync_blocks`` at bmax 65536 and 2**17,
    ``decode_par.resync_streams`` into 64 KiB and 2**17-byte rows).  Each
    function timed at the batch (plain, kernel, kernel, plain; events),
    its card time the sum of its kernels' profiler record means (the
    fewest records of any), each kernel's own mean and records logged
    beside it (``PAR_KERNELS``), its bound ``kernel_bytes`` over the
    memory rate; the encoder also at 64 rows of each hostile 64 KiB
    block.  Returns ({name: time row}, {name: max_abs_err})."""
    from snappy_tpu_torch import native
    from snappy_tpu_torch.bench.kernel_cost import (HBM_BYTES_PER_S,
                                                    kernel_bytes, profiled)
    from snappy_tpu_torch.kernels import decode_par as dp
    from snappy_tpu_torch.kernels import encode_par as ep
    from snappy_tpu_torch.spec.format import put_uvarint

    def diff(a, b) -> int:
        return int((a.int() - b.int()).abs().max()) if a.numel() else 0

    def enc_err(args, bmax):
        got = ep.encode_blocks(*args, bmax)
        want = ep.encode_blocks_plain(*args, bmax)
        return max(diff(g, w) for g, w in zip(got, want))

    def dec_err(args, out_max, **rounds):
        out, err = dp.decode_blocks(*args, out_max=out_max, **rounds)
        pout, perr = dp.decode_blocks_plain(*args, out_max=out_max, **rounds)
        good = perr == 0
        assert not out[~good].any(), "decode_par: a row with an error " \
                                     "is not zero"
        return max(diff(err, perr), diff(out[good], pout[good])), err

    errs = {"encode_par": enc_err((blk_d, lens_d), 65536),
            "decode_par": dec_err(dargs, 65536)[0]}
    hostile = [torch.from_numpy(a).to(dev) for a in dp.stream_rows(
        _bad_streams() + dp.edge_streams(), 256)]
    e, codes = dec_err(hostile, 256)
    errs["decode_par"] = max(errs["decode_par"], e)
    edges = ep.edge_blocks(seed)
    wide = [ep.wide_block(seed), ep.wide_block(seed)[:100_000]]
    for bmax, blocks in ((65536, list(edges.values())), (1 << 17, wide)):
        args = [torch.from_numpy(a).to(dev)
                for a in ep.stage_blocks(blocks, bmax)]
        errs["encode_par"] = max(errs["encode_par"], enc_err(args, bmax))
    # the 2**17 rows (copy-4 elements among them) decoded back by the
    # kernel's wide-row path, against the plain version and the blocks
    comp_w, clen_w, _ = (x.cpu().numpy() for x in ep.encode_blocks(
        *args, 1 << 17))
    wargs = [torch.from_numpy(a).to(dev) for a in dp.stream_rows(
        [put_uvarint(len(b)) + comp_w[i, : clen_w[i]].tobytes()
         for i, b in enumerate(wide)], ep.derived_sizes(1 << 17)[2] + 8)]
    e, wcodes = dec_err(wargs, 1 << 17)
    errs["decode_par"] = max(errs["decode_par"], e)
    wout = dp.decode_blocks(*wargs, out_max=1 << 17)[0].cpu().numpy()
    assert not wcodes.any() and all(
        wout[i, : len(b)].tobytes() == b for i, b in enumerate(wide)), \
        "decode_par: the 2**17 encodings do not decode back"
    # one row of the 64 chunks' raw stream (decode_block_par's shape)
    raw = native.compress(blk_d.cpu().numpy().tobytes())
    raw_rows = dp.stream_rows([raw], 1 << (len(raw) - 1).bit_length())
    raw_max = 64 * 65536
    rargs = [torch.from_numpy(a).to(dev) for a in raw_rows]
    # decode_block_par's round counts, which bound nothing at this size
    rounds = max(17, raw_rows[0].shape[1].bit_length() + 1,
                 raw_max.bit_length() + 1)
    rkw = {"out_max": raw_max, "tag_rounds": rounds, "ptr_rounds": rounds}
    e, rcodes = dec_err(rargs, **rkw)
    errs["decode_par"] = max(errs["decode_par"], e)
    assert not rcodes.any(), "decode_par: the raw stream's row failed"
    # the hand-made cases whose chunked walks never meet the true walk
    resync = ep.resync_blocks(seed)
    for bmax, blocks in ((65536, list(resync.values())),
                         (1 << 17, [b"".join(resync.values())])):
        args = [torch.from_numpy(a).to(dev)
                for a in ep.stage_blocks(blocks, bmax)]
        errs["encode_par"] = max(errs["encode_par"], enc_err(args, bmax))
    sargs = [torch.from_numpy(a).to(dev)
             for a in dp.stream_rows(dp.resync_streams(), 46080)]
    for out_max in (65536, 1 << 17):
        e, scodes = dec_err(sargs, out_max)
        errs["decode_par"] = max(errs["decode_par"], e)
        assert scodes.tolist() == [0, 0, dp.ERR_OVERRUN_INPUT], scodes
    log(card, f"decode_par, encode_par: max_abs_err {errs} against their "
              f"plain versions on the 64-row batch, {len(codes)} hostile "
              f"decode rows (codes {sorted(set(codes.tolist()))}), the "
              f"hostile encode blocks {sorted(edges)} + 2 rows at bmax "
              f"2**17, those 2 rows decoded back (out_max 2**17), one "
              f"{len(raw)}-byte raw stream row (out_max {raw_max}), the "
              f"hand-made blocks {sorted(resync)} (bmax 65536, and joined "
              f"at 2**17) and {len(dp.resync_streams())} resync streams "
              f"(out_max 65536 and 2**17)")
    assert errs == {"encode_par": 0, "decode_par": 0}, errs

    rows = {}
    for name, fn_name, kern, plain, args in (
            ("decode_par", "decode_blocks", dp.decode_blocks,
             dp.decode_blocks_plain, dargs),
            ("encode_par", "encode_blocks", ep.encode_blocks,
             ep.encode_blocks_plain, (blk_d, lens_d))):
        p1 = time_ms(lambda: plain(*args), 3)
        k1 = time_ms(lambda: kern(*args), 20)
        k2 = time_ms(lambda: kern(*args), 20)
        p2 = time_ms(lambda: plain(*args), 3)
        recs = profiled(lambda: kern(*args), 20, PROFILER_KEYS[name])
        nbytes = kernel_bytes(fn_name, args)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": min(k1, k2), "device_ms": recs["kernel_ms_mean"],
                      "records": [recs["kernel_records"], recs["launches"]],
                      "plain_ms": min(p1, p2), "bound_ms": bound, "rows": 64}
        own = {k: profiled(lambda: kern(*args), 20, PROFILER_KEYS[k])
               for k in PAR_KERNELS[name]}
        log(card, f"{name} (main) at [64 rows], each CUDA kernel on the "
                  f"card (ms: the mean of its profiler records; records of "
                  f"20 launches): " + json.dumps(
                      {k: [r["kernel_ms_mean"], r["kernel_records"]]
                       for k, r in own.items()}))
        log(card, f"{name} (main) at [64 rows, the first 64 corpus chunks]: "
                  f"kernel {k1:.4f}/{k2:.4f} ms a call, "
                  f"{recs['kernel_ms_mean']} ms on the card (the mean of "
                  f"{recs['kernel_records']} profiler records of "
                  f"{recs['launches']} launches), plain {p1:.4f}/{p2:.4f} "
                  f"ms; bound {bound:.4f} ms ({nbytes} B at "
                  f"{HBM_BYTES_PER_S / 1e12} TB/s)")
    p1 = time_ms(lambda: dp.decode_blocks_plain(*rargs, **rkw), 2)
    k1 = time_ms(lambda: dp.decode_blocks(*rargs, **rkw), 5)
    k2 = time_ms(lambda: dp.decode_blocks(*rargs, **rkw), 5)
    p2 = time_ms(lambda: dp.decode_blocks_plain(*rargs, **rkw), 2)
    rows["decode_par.wide"] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                               "bytes": raw_max}
    log(card, f"decode_par at one row of a {len(raw)}-byte raw stream into "
              f"{raw_max} bytes (the wide-row path): kernel {k1:.4f}/"
              f"{k2:.4f} ms a call ({raw_max / min(k1, k2) / 1e6:.4f} GB/s), "
              f"plain {p1:.4f}/{p2:.4f} ms")
    shapes = {}
    for name in ("lazy chain", "run", "random", "period 3", "all 0xff"):
        args = [torch.from_numpy(a).to(dev)
                for a in ep.stage_blocks([edges[name]] * 64, 65536)]
        shapes[name] = profiled(lambda: ep.encode_blocks(*args), 5,
                                PROFILER_KEYS["encode_par"])["kernel_ms_mean"]
    log(card, f"encode_par at 64 rows of one hostile 64 KiB block, ms on "
              f"the card: {shapes}")
    return rows, errs


def _forbid(module, name: str, calls: list) -> None:
    """Replace ``module.name`` by a function that records its call in
    ``calls`` and raises."""
    def raiser(*args, **kwargs):
        calls.append(name)
        raise RuntimeError(f"{name} called with the native library off")

    setattr(module, name, raiser)


def no_native_child(tmp: str, raw_mib: int, stream_mib: int, layers: int,
                    seed: int) -> None:
    """Phase 19's child, run in an interpreter of its own (it patches
    modules): the port without its native library.  ``native.available()``
    returns False, and every public function of snappy_tpu_torch.native,
    the pure-Python CRC and the reference encoder raise and are counted
    (the runtime looks them up when it runs).  The eight codec entry
    points over ``tmp``/corpus.bin (the raw ones over its first
    ``raw_mib`` MiB), FramedWriter / FramedReader over ``stream_mib`` MiB
    and a ``layers``-layer GPT-2 medium checkpoint, each call timed with
    every launch counter set to 0 just before and read just after.  Its
    streams go to files in ``tmp``; one JSON report line to stdout."""
    import importlib
    import io
    import os

    from snappy_tpu_torch import native

    calls = {"native": [], "pure_python": []}
    for name in dir(native):
        fn = getattr(native, name)
        if (not name.startswith("_") and callable(fn)
                and getattr(fn, "__module__", None) == native.__name__):
            _forbid(native, name, calls["native"])
    native.available = lambda: False

    from snappy_tpu_torch import FramedReader, FramedWriter, checkpoint
    from snappy_tpu_torch.errors import ChecksumError
    from snappy_tpu_torch.runtime import device_codec as dc
    from snappy_tpu_torch.spec import reference

    # the module, not the function of that name the package exports (the
    # CRC kernel's constants keep their own name for a fixed segment's CRC)
    spec_crc = importlib.import_module("snappy_tpu_torch.spec.crc32c")
    _forbid(spec_crc, "crc32c", calls["pure_python"])
    _forbid(reference, "encode_block", calls["pure_python"])
    mods = _counters()
    dev = torch.device("cuda:0")
    report = {"device": str(dev), "calls": {}}

    def run(name, nbytes, fn):
        for m in mods.values():
            m.launches = 0
        for k in dc.ENCODE_REPLACED:
            dc.ENCODE_REPLACED[k] = 0
        res, secs = timed(fn)
        report["calls"][name] = {
            "bytes": nbytes, "s": secs,
            "launches": {k: m.launches for k, m in mods.items()},
            "replaced": dict(dc.ENCODE_REPLACED)}
        return res

    def path(name):
        return os.path.join(tmp, name)

    def write_file(name, blob):
        with open(path(name), "wb") as f:
            f.write(blob)

    with open(path("corpus.bin"), "rb") as f:
        data = f.read()
    with open(path("flipped.sz"), "rb") as f:
        flipped = f.read()
    n = len(data)
    data_t = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    raw_data = data[: raw_mib << 20]
    s_data = data[: stream_mib << 20]
    # warm-up, uncounted: each entry point once at 1 MiB
    w = data[: 1 << 20]
    dc.decompress_framed_to_device(dc.compress_framed(w))
    dc.decompress_framed(dc.compress_framed_from_device(data_t[: 1 << 20]))
    dc.decompress_to_device(dc.compress_from_device(data_t[: 1 << 20]))
    dc.decompress(dc.compress(w))

    fr = run("compress_framed", n, lambda: dc.compress_framed(data))
    write_file("compress_framed.sz", fr)
    assert run("decompress_framed", n,
               lambda: dc.decompress_framed(fr)) == data, "decompress_framed"
    arr = run("decompress_framed_to_device", n,
              lambda: dc.decompress_framed_to_device(fr))
    assert arr.device == dev and torch.equal(arr, data_t), "to-device"
    fr2 = run("compress_framed_from_device", n,
              lambda: dc.compress_framed_from_device(arr))
    assert fr2 == fr, "compress_framed_from_device != compress_framed"
    del arr, fr2
    nr = len(raw_data)
    raw = run("compress", nr, lambda: dc.compress(raw_data))
    write_file("compress.snappy", raw)
    assert run("decompress", nr, lambda: dc.decompress(raw)) == raw_data
    arr = run("decompress_to_device", nr, lambda: dc.decompress_to_device(raw))
    assert arr.device == dev and torch.equal(arr, data_t[:nr]), \
        "raw to-device"
    assert run("compress_from_device", nr,
               lambda: dc.compress_from_device(arr)) == raw, "raw from-device"

    def write():
        sink = io.BytesIO()
        with FramedWriter(sink, backend="torch") as wr:
            for i in range(0, len(s_data), 1 << 20):
                wr.write(s_data[i : i + (1 << 20)])
        return sink.getvalue()

    def read():
        r = FramedReader(io.BytesIO(written), backend="torch")
        out = bytearray()
        while piece := r.read(1 << 20):
            out += piece
        return bytes(out)

    written = run("FramedWriter", len(s_data), write)
    write_file("writer.sz", written)
    assert run("FramedReader", len(s_data), read) == s_data, "FramedReader"
    for fn in (dc.decompress_framed, dc.decompress_framed_to_device):
        try:
            fn(flipped)
        except ChecksumError:
            continue
        raise AssertionError(f"{fn.__name__}: flipped payload byte not caught")
    state = gpt2_state(layers, dev, seed)
    size = sum(t.numel() * t.element_size() for t in state.values())
    blob = run("save_pytree", size, lambda: checkpoint.save_pytree(state))
    back = run("load_pytree", size, lambda: checkpoint.load_pytree(blob))
    assert all(torch.equal(back[k], v) for k, v in state.items()), \
        "checkpoint"
    write_file("checkpoint.bin", blob)
    report["host_fallbacks"] = dict(dc.HOST_FALLBACKS)
    report["native_calls"] = len(calls["native"])
    report["pure_python_calls"] = len(calls["pure_python"])
    print(json.dumps(report), flush=True)


def _np_element(chunk: bytes) -> bytes:
    """``encode_np``'s element of one chunk (a process pool's task)."""
    from snappy_tpu_torch.kernels.encode_np import encode_block_np

    return encode_block_np(chunk)


def no_native_phase(card, dev, mib: int, layers: int, seed: int):
    """Phase 19: the port without its native library, in a child
    interpreter (``no_native_child``) where ``native.available()`` is
    False and every public native function, the pure-Python CRC and the
    reference encoder raise and count: the jnp engines with every CRC on
    the CRC kernel and the ratio guard's reference element on the
    sequential encoder.  Over ``mib`` MiB of make_corpus(seed):
    compress_framed, decompress_framed, decompress_framed_to_device,
    compress_framed_from_device; over its first 4 MiB (one
    decode_block_par row covers the stream) compress, decompress,
    decompress_to_device, compress_from_device; FramedWriter /
    FramedReader over 8 MiB; save_pytree / load_pytree of a
    ``layers``-layer GPT-2 medium state.  Here, with the library: the
    reference streams (``encode_np``'s emission, which the JAX package's
    jnp encoder and guard give, in a process pool while the child runs,
    framed with native CRCs), the host native codec's rates on the same
    bytes, a flipped payload byte, and the child's checkpoint loaded
    back.  Returns (rates, counts)."""
    import multiprocessing
    import os
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from snappy_tpu_torch import checkpoint, native
    from snappy_tpu_torch.runtime import device_codec as dc
    from snappy_tpu_torch.spec.format import STREAM_ID_CHUNK, put_uvarint

    t0 = time.perf_counter()
    data = corpus_bytes(mib << 20, seed)
    n = len(data)
    cs = 65536
    log(card, f"phase 19: {n} B of make_corpus(seed={seed}) made in "
              f"{time.perf_counter() - t0:.2f} s")
    raw_mib, stream_mib = 4, 8
    rates, counts = {}, {}
    host = {}
    ref_native, secs = timed(lambda: native.compress_framed(data, threads=4))
    host["compress_framed"] = n / secs / 1e9
    _, secs = timed(lambda: native.decompress_framed(ref_native, threads=4))
    host["decompress_framed"] = n / secs / 1e9
    raw_data = data[: raw_mib << 20]
    raw_native, secs = timed(lambda: native.compress(raw_data))
    host["compress"] = len(raw_data) / secs / 1e9
    _, secs = timed(lambda: native.decompress(raw_native))
    host["decompress"] = len(raw_data) / secs / 1e9
    root = os.path.dirname(os.path.abspath(__file__))
    workers = max(1, (os.cpu_count() or 2) - 2)
    with tempfile.TemporaryDirectory() as tmp, ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        with open(os.path.join(tmp, "corpus.bin"), "wb") as f:
            f.write(data)
        with open(os.path.join(tmp, "flipped.sz"), "wb") as f:
            f.write(flip_payload_byte(
                native.compress_framed(data[: stream_mib << 20])))
        t0 = time.perf_counter()
        elems = pool.map(_np_element,
                         [data[i : i + cs] for i in range(0, n, cs)],
                         chunksize=16)
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys, chip_smoke; chip_smoke.no_native_child("
             "sys.argv[1], *map(int, sys.argv[2:]))",
             tmp, str(raw_mib), str(stream_mib), str(layers), str(seed)],
            cwd=root, capture_output=True, text=True, timeout=900)
        child_s = time.perf_counter() - t0
        assert proc.returncode == 0, \
            f"phase 19 child failed:\n{proc.stderr[-4000:]}"
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        elems = list(elems)
        ref_s = time.perf_counter() - t0
        records = [dc._framed_record(
            len(e := data[i * cs : (i + 1) * cs]), el, native.crc32c(e), e)
            for i, el in enumerate(elems)]

        def read(name):
            with open(os.path.join(tmp, name), "rb") as f:
                return f.read()

        assert read("compress_framed.sz") == \
            bytes(STREAM_ID_CHUNK) + b"".join(records), \
            "native-off compress_framed != the reference"
        n_raw = -(-len(raw_data) // cs)
        assert read("compress.snappy") == \
            put_uvarint(len(raw_data)) + b"".join(elems[:n_raw]), \
            "native-off compress != the reference"
        n_st = -(-(stream_mib << 20) // cs)
        assert read("writer.sz") == \
            bytes(STREAM_ID_CHUNK) + b"".join(records[:n_st]), \
            "native-off FramedWriter != the reference"
        state = gpt2_state(layers, dev, seed)
        back = checkpoint.load_pytree(read("checkpoint.bin"))
        assert all(torch.equal(back[k], v) for k, v in state.items()), \
            "native-off checkpoint != its state, loaded with the library"
        del state, back
    assert report["device"] == str(dev), report
    assert report["native_calls"] == 0, report
    assert report["pure_python_calls"] == 0, report
    total = {k: sum(c["launches"][k] for c in report["calls"].values())
             for k in KERNELS}
    for name in ("crc32c_rows", "seq_encode", "decode_par", "encode_par"):
        assert total[name] > 0, f"{name} never launched without native"
    for name, c in report["calls"].items():
        rate = c["bytes"] / c["s"] / 1e9
        rates[f"no_native.{name}"] = rate
        counts[f"no_native.{name}"] = c["launches"]
        beside = {"FramedWriter": "compress_framed",
                  "FramedReader": "decompress_framed"}.get(name) or next(
            (k for k in host if name.startswith(k)), None)
        log(card, f"native off {name}: {c['bytes']} B in {c['s']:.4f} s = "
                  f"{rate:.4f} GB/s"
                  + (f" (host native.{beside} {host[beside]:.4f} GB/s)"
                     if beside else "")
                  + f", kernel launches {c['launches']}, rows replaced "
                    f"{c['replaced']}")
    rates.update({f"no_native.host native.{k}": v for k, v in host.items()})
    log(card, f"native off: launches over the child's calls {total}; "
              f"host fallbacks {report['host_fallbacks']}; native calls "
              f"{report['native_calls']}, pure-Python CRC and reference "
              f"encoder calls {report['pure_python_calls']}; the streams "
              f"equal encode_np's reference ({len(elems)} chunks in a "
              f"{workers}-process pool, {ref_s:.2f} s beside the child's "
              f"{child_s:.2f} s), the child's checkpoint loads with the "
              f"library, a flipped payload byte raised ChecksumError")
    return rates, counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--id-mib", type=int, default=256)
    ap.add_argument("--classify-mib", type=int, default=64)
    ap.add_argument("--seq-mib", type=int, default=256)
    ap.add_argument("--wave-mib", type=int, default=256)
    ap.add_argument("--devmatch-mib", type=int, default=256)
    ap.add_argument("--ckpt-layers", type=int,
                    default=GPT2_MEDIUM["n_layer"],
                    help="layers of the GPT-2 medium state of phases 15 "
                         "and 19")
    ap.add_argument("--stream-mib", type=int, default=256)
    ap.add_argument("--dist-mib", type=int, default=1024,
                    help="MiB of the phase-17 loader corpus")
    ap.add_argument("--hybrid-mib", type=int, default=256,
                    help="MiB of the phase-18 hybrid engine run")
    ap.add_argument("--jnp-mib", type=int, default=256,
                    help="MiB of the phase-18 jnp engines run")
    ap.add_argument("--no-native-mib", type=int, default=64,
                    help="MiB of the phase-19 framed calls without the "
                         "native library")
    ap.add_argument("--seed", type=int, default=20260816)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    info = gpu_info()
    print(info, flush=True)
    card = info
    dev = torch.device("cuda:0")
    log(card, f"phase 1: torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, python {sys.version.split()[0]}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # phase 2: builds from the checkout's sources
    from snappy_tpu_torch import native
    from snappy_tpu_torch.kernels import _build
    from snappy_tpu_torch.runtime import device_codec as dc

    t0 = time.perf_counter()
    _build.lib()
    cuda_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert native.available(), "native host codec failed to build"
    native_s = time.perf_counter() - t0
    log(card, f"phase 2: CUDA kernels built in {cuda_s:.2f} s "
              f"(nvcc {_build.build_seconds}), native codec ready in "
              f"{native_s:.2f} s")

    crc_err = crc_phase(card, dev, args.seed)
    flat_data = corpus_bytes(16 << 20, args.seed + 1)
    full = corpus_bytes(max(args.id_mib, args.seq_mib, args.wave_mib,
                            args.devmatch_mib, args.stream_mib) << 20,
                        args.seed)
    flat_err, plan, rplan, eplan = flat_phase(card, dev, flat_data)
    seq_dec_err, dec64, dec_wide, dec_plain_s = seq_decode_phase(
        card, dev, flat_data, full)
    seq_enc_err, enc64, enc_wide, enc_plain_s = seq_encode_phase(
        card, dev, flat_data[1 << 23 :], full)
    frame_err, frame_args, frame_plain_s = frame_phase(card, dev, full)
    wave_err, wave64, wave_wide = wave_phase(card, dev, flat_data[1 << 22 :],
                                             full)
    match_err, match64, match_wide = match_phase(
        card, dev, flat_data[3 << 22 :], full)

    for k in dc.HOST_FALLBACKS:
        dc.HOST_FALLBACKS[k] = 0
    rates, counts = main_path(card, dev, full, args.id_mib,
                              args.classify_mib, args.seq_mib, args.wave_mib,
                              args.devmatch_mib)
    launches = {name: sum(c[name] for c in counts.values())
                for name in KERNELS}
    log(card, f"launches on the main path (id + classify + seq + wave + "
              f"devmatch runs): {launches}; host fallbacks: "
              f"{dict(dc.HOST_FALLBACKS)}")

    times = kernel_times(
        card, dev, plan, rplan, eplan,
        {"seq_decode": dec64, "seq_encode": enc64},
        {"seq_decode": (dec_wide, dec_plain_s * 1e3),
         "seq_encode": (enc_wide, enc_plain_s * 1e3)},
        (wave64, wave_wide), (match64, match_wide),
        (frame_args, frame_plain_s * 1e3))

    ck_rates, ck_counts, info_blob = checkpoint_phase(
        card, dev, args.ckpt_layers, args.seed)
    st_rates, st_counts = stream_phase(
        card, dev, full[: args.stream_mib << 20], info_blob)
    del full
    di_rates, di_counts = dist_phase(card, dev, args.dist_mib, args.seed)
    po_rates, po_counts, po_times, po_errs = portable_phase(
        card, dev, args.hybrid_mib, args.jnp_mib, args.seed)
    times.update(po_times)
    nn_rates, nn_counts = no_native_phase(
        card, dev, args.no_native_mib, args.ckpt_layers, args.seed)
    rates.update(ck_rates, **st_rates, **di_rates, **po_rates, **nn_rates)
    counts.update(ck_counts, **st_counts, **di_counts, **po_counts,
                  **nn_counts)
    launches = {name: sum(c[name] for c in counts.values())
                for name in KERNELS}
    log(card, f"launches over every counted run (phases 9-13, 15-19): "
              f"{launches}")
    errs = {"crc32c_rows": crc_err, "flat_exec": flat_err,
            "seq_decode": seq_dec_err, "seq_encode": seq_enc_err,
            "wavegroup": wave_err, "match_cands": match_err,
            "frame_records": frame_err, **po_errs}
    # no single PyTorch call computes any of the ten functions (a CRC,
    # a plan copy, an LZ decode or encode, a wave plan, a candidate
    # search, a record executor, a framed-record assembly), so none has
    # a library yardstick
    table = {"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "device_ms": times[name]["device_ms"],
         "device_records": times[name]["records"],
         "rows": times[name]["rows"]}
        for name in KERNELS]}
    log(card, "rates GB/s: " + json.dumps(rates))
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
