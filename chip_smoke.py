"""Chip smoke test of snappy_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels (nvcc, sm_90a, one process per
source) and the shared native host codec from the sources, checks each
kernel bit for bit against its plain PyTorch version at the main path's
shapes, drives the framed to-device / from-device path through the
public entry points in each runtime engine (id: 256 MiB, classify:
64 MiB, the device LZ engine "seq": 256 MiB of the seeded benchmark
corpus) against the native codec, drives the two standalone engines
over 256 MiB of the same corpus (the wave-group decoder "wave" and the
device match finder "devmatch"), shows through the launch counters,
reset before each engine's run and read after it, that each run went
through its kernels, and times each kernel against its plain version.
Every check raises on failure (nothing is caught), so any failure exits
non-zero; without a GPU it exits non-zero before printing any result.

The last two lines are one JSON object per line: the kernel table,
then {"ok": true, "device": {...}}.
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
}
SEQ_ROWS = 64  # rows of the seq, wave and match phases and timings (BATCH)


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
    from snappy_tpu.bench.corpus import make_corpus

    return b"".join(d for _, d in make_corpus(total, seed=seed))


def crc_phase(card, dev, seed):
    """Phase 3: the CRC kernel against its plain version and the native
    CRC, including a 520-row panel read in place."""
    from snappy_tpu import native
    from snappy_tpu_torch.kernels import crc32c as kc

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
    log(card, f"crc32c: {nb} rows + 64 pitched rows bit-exact vs plain "
              f"and native.crc32c (max_abs_err {err})")
    return err


def _stage_decode_plans(data: bytes, nb: int):
    """Native flat decode plans (stage_flat_dec_batch) for the first nb
    chunks of native.compress_framed(data)."""
    from snappy_tpu import native
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
    from snappy_tpu import native
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
    from snappy_tpu import native
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
    log(card, f"flat_exec: {len(comp)} decode plans (trips "
              f"{int((ntr & 0xFFFF).min())}-{int((ntr & 0xFFFF).max())}, {clamp} "
              f"subpanel words past the clamp row) and {len(entr)} encode "
              f"plans byte-identical to plain and to the native codec "
              f"(max_abs_err {max(err_d, err_e)})")
    return max(err_d, err_e), plan, eplan


def _counters():
    from snappy_tpu_torch.kernels import crc32c as kc
    from snappy_tpu_torch.kernels import decode_flat as kf
    from snappy_tpu_torch.kernels import decode_seq as kds
    from snappy_tpu_torch.kernels import decode_wavegroup as kw
    from snappy_tpu_torch.kernels import encode_seq as kes
    from snappy_tpu_torch.kernels import match as km

    return {"crc32c_rows": kc, "flat_exec": kf, "seq_decode": kds,
            "seq_encode": kes, "wavegroup": kw, "match_cands": km}


def _bad_streams() -> list:
    """Corrupt element streams (raw format), one or more per error code
    of the sequential decoder, with its int32 wrap cases."""
    from snappy_tpu.spec.format import put_uvarint

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


def seq_decode_phase(card, dev, data):
    """Phase 5: the sequential decode kernel against its plain version and the
    native decoder: SEQ_ROWS corpus chunks as native.compress emits them
    in the runtime's 66,560-byte rows, plus corrupt rows hitting every
    error code (err vectors compared too)."""
    from snappy_tpu import native
    from snappy_tpu.spec.format import read_uvarint
    from snappy_tpu_torch.kernels import decode_seq as kds

    blocks = [data[i << 16 : (i + 1) << 16] for i in range(SEQ_ROWS)]
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
    pout, perr = kds.decode_blocks_seq_plain(*args, 65536)
    torch.cuda.synchronize()
    max_err = max(int((out.to(torch.int16) - pout.to(torch.int16)).abs().max()),
                  int((err - perr).abs().max()))
    assert torch.equal(out, pout) and torch.equal(err, perr), \
        "seq decode kernel != plain"
    codes = err.cpu().numpy()
    assert set(codes.tolist()) == {0, 1, 2, 3, 4}, codes
    out_h = out.cpu().numpy()
    for i, b in enumerate(blocks):
        assert codes[i] == 0 and out_h[i, : len(b)].tobytes() == b, i
    log(card, f"seq_decode: {SEQ_ROWS} corpus rows byte-identical to plain "
              f"and native.decompress, {nb - SEQ_ROWS} corrupt rows with err "
              f"{codes[SEQ_ROWS:].tolist()} equal to plain "
              f"(max_abs_err {max_err})")
    return max_err, tuple(t[:SEQ_ROWS] for t in args)


def seq_encode_phase(card, dev, data):
    """Phase 6: the sequential encode kernel against its plain version and the
    native encoder: SEQ_ROWS corpus chunks, plus edge rows (empty, 17 and
    18 bytes, zeros, run-length, random)."""
    from snappy_tpu import native
    from snappy_tpu.spec.format import read_uvarint
    from snappy_tpu_torch.kernels import encode_seq as kes

    rng = np.random.default_rng(11)
    samples = [data[i << 16 : (i + 1) << 16] for i in range(SEQ_ROWS)]
    samples += [b"", b"x" * 17, b"x" * 18, bytes(65536), b"ab" * 32768,
                rng.bytes(65536), rng.bytes(1000) + b"z" * 3000]
    blocks = np.zeros((len(samples), 65536), np.uint8)
    lens = np.array([len(s) for s in samples], np.int32)
    for i, s in enumerate(samples):
        blocks[i, : len(s)] = np.frombuffer(s, np.uint8)
    args = kes.stage_encode(blocks, lens, dev)
    comp, clens, err = kes.encode_blocks_seq(*args)
    pcomp, pclens, perr = kes.encode_blocks_seq_plain(*args)
    torch.cuda.synchronize()
    max_err = max(
        int((comp.to(torch.int16) - pcomp.to(torch.int16)).abs().max()),
        int((clens - pclens).abs().max()), int((err - perr).abs().max()))
    assert torch.equal(comp, pcomp) and torch.equal(clens, pclens) \
        and torch.equal(err, perr), "seq encode kernel != plain"
    comp_h, clens_h = comp.cpu().numpy(), clens.cpu().numpy()
    for i, s in enumerate(samples):
        nat = native.compress(s)
        assert comp_h[i, : clens_h[i]].tobytes() == \
            nat[read_uvarint(nat, 0)[1] :], f"encode row {i}"
    log(card, f"seq_encode: {SEQ_ROWS} corpus rows and {len(samples) - SEQ_ROWS}"
              f" edge rows byte-identical to plain and native.compress "
              f"(max_abs_err {max_err})")
    return max_err, tuple(t[:SEQ_ROWS] for t in args)


def wave_phase(card, dev, data):
    """Phase 7: the wave-group kernel against its plain version and the
    input bytes: SEQ_ROWS corpus chunks as native.compress emits them,
    planned natively (stage_waves), plus edge rows (zeros, run-length,
    random, empty)."""
    from snappy_tpu import native
    from snappy_tpu_torch.kernels import decode_wavegroup as kw

    rng = np.random.default_rng(12)
    blocks = [data[i << 16 : (i + 1) << 16] for i in range(SEQ_ROWS)]
    blocks += [bytes(65536), b"ab" * 32768, rng.bytes(65536), b""]
    staged = kw.stage_waves([native.compress(b) for b in blocks], device=dev)
    assert staged is not None, "a wave plan over WAVE_G_CAP"
    out = kw.decode_blocks_wavegroup(*staged, 65536)
    plain = kw.decode_blocks_wavegroup_plain(*staged, 65536)
    torch.cuda.synchronize()
    max_err = int((out.to(torch.int16) - plain.to(torch.int16)).abs().max())
    assert torch.equal(out, plain), "wavegroup kernel != plain"
    out_h = out.cpu().numpy()
    for i, b in enumerate(blocks):
        assert out_h[i, : len(b)].tobytes() == b, i
        assert not out_h[i, len(b) :].any(), i
    ng = staged[2].cpu().numpy()
    log(card, f"wavegroup: {SEQ_ROWS} corpus rows ({int(ng[:SEQ_ROWS].min())}"
              f"-{int(ng[:SEQ_ROWS].max())} groups) and "
              f"{len(blocks) - SEQ_ROWS} edge rows ({ng[SEQ_ROWS:].tolist()} "
              f"groups) byte-identical to plain and to the input "
              f"(max_abs_err {max_err})")
    return max_err, tuple(t[:SEQ_ROWS] for t in staged)


def match_phase(card, dev, data):
    """Phase 8: the match kernel against its plain version in both
    routes (home and sorted pairs), SEQ_ROWS corpus chunks plus edge
    blocks (empty, 3 B, 4 B, zeros, random, and exact 64 KiB blocks,
    whose last v-words wrap round), some rows against
    match_np.find_candidates."""
    from snappy_tpu.kernels import match_np
    from snappy_tpu_torch.kernels import match as km

    rng = np.random.default_rng(13)
    blocks = [data[i << 16 : (i + 1) << 16] for i in range(SEQ_ROWS)]
    blocks += [b"", b"abc", b"abcd", bytes(65536), rng.bytes(65536),
               bytes(range(256)) * 256, rng.bytes(40000)]
    w, n = km.stage_words(blocks)
    args = (torch.from_numpy(w).to(dev), torch.from_numpy(n).to(dev))
    max_err = 0
    for home in (True, False):
        got = km.find_candidates(*args, home=home)
        plain = km.find_candidates_plain(*args, home=home)
        torch.cuda.synchronize()
        max_err = max(max_err, int((got.long() - plain.long()).abs().max()))
        assert torch.equal(got, plain), f"match kernel != plain (home={home})"
        cands = got.cpu().numpy()
        if not home:
            cands = km.scatter_home(cands)
        cands = cands.reshape(len(blocks), -1)
        for i in [0, SEQ_ROWS - 1] + list(range(SEQ_ROWS, len(blocks))):
            assert np.array_equal(cands[i], match_np.find_candidates(
                blocks[i])), f"match row {i} != match_np (home={home})"
    log(card, f"match_cands: {SEQ_ROWS} corpus rows and "
              f"{len(blocks) - SEQ_ROWS} edge rows bit-exact to plain in both "
              f"routes, {len(blocks) - SEQ_ROWS + 2} rows to "
              f"match_np.find_candidates (max_abs_err {max_err})")
    return max_err, tuple(t[:SEQ_ROWS] for t in args)


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
    from snappy_tpu import native
    from snappy_tpu.errors import SnappyError
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


def main_path(card, dev, id_mib, classify_mib, seq_mib, wave_mib,
              devmatch_mib, seed):
    """Phases 9-13 through the public entry points, one engine at a time
    with the launch counters set to 0 just before its run and read just
    after.  Returns the rates and each engine's launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    import snappy_tpu_torch as st
    from snappy_tpu import native
    from snappy_tpu.spec import framing
    from snappy_tpu.spec.format import put_uvarint
    from snappy_tpu_torch.kernels import decode_wavegroup as kw
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

    def engine_run(name, fn):
        for m in mods.values():
            m.launches = 0
        fn()
        counts = {k: m.launches for k, m in mods.items()}
        log(card, f"{name} run: kernel launches {counts}")
        return counts

    full = corpus_bytes(max(id_mib, seq_mib, wave_mib, devmatch_mib) << 20,
                        seed)
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
        # stream parsed and planned on the host (stage_waves, 4 threads),
        # the plans run on the card in launches of SEQ_ROWS rows
        nblk = wave_mib << 4
        n = sum(len(b) for b in blocks[:nblk])
        ref = torch.zeros(nblk << 16, dtype=torch.uint8)
        ref[:n] = torch.frombuffer(bytearray(full[:n]), dtype=torch.uint8)
        ref = ref.to(dev).view(nblk, 65536)

        def stage(lo):
            t0 = time.perf_counter()
            staged = kw.stage_waves(streams[lo : lo + SEQ_ROWS])
            return staged, time.perf_counter() - t0

        outs, groups, launched, stage_s = [], [], [], 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            for staged, secs in pool.map(stage, range(0, nblk, SEQ_ROWS)):
                assert staged is not None, "a wave plan over WAVE_G_CAP"
                stage_s += secs
                args = tuple(t.to(dev) for t in staged)
                outs.append(kw.decode_blocks_wavegroup(*args, 65536))
                launched.append(args)
                groups.append(staged[2])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        replays["wave"] = (n, stage_s, wall, [
            lambda a=a: kw.decode_blocks_wavegroup(*a, 65536)
            for a in launched])
        assert torch.equal(torch.cat(outs), ref), "wave decode != input"
        ng = torch.cat(groups)
        log(card, f"wave: {nblk} blocks byte-identical to the input, 0 plans "
                  f"over the cap of {kw.WAVE_G_CAP}, {int(ng.min())}-"
                  f"{int(ng.max())} groups per block (mean "
                  f"{float(ng.float().mean()):.1f})")

    def devmatch_engine():
        # phase 13: the device match finder: stage_words, the kernel
        # (home route), D2H, then native.emit_from_cands in 4 threads
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
            for lo in range(0, nblk, SEQ_ROWS):
                t1 = time.perf_counter()
                w, npos = km.stage_words(blocks[lo : lo + SEQ_ROWS])
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

    counts = {"id": engine_run("id", id_engine),
              "classify": engine_run("classify", classify_engine),
              "seq": engine_run("seq", seq_engine),
              "wave": engine_run("wave", wave_engine),
              "devmatch": engine_run("devmatch", devmatch_engine)}
    for eng, kernels in (("id", ["crc32c_rows"]), ("classify", ["flat_exec"]),
                         ("seq", ["seq_decode", "seq_encode", "crc32c_rows"]),
                         ("wave", ["wavegroup"]),
                         ("devmatch", ["match_cands"])):
        for name in kernels:
            assert counts[eng][name] > 0, f"{name} never launched in {eng}"
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
        rates[f"{name}.call"] = n / wall / 1e9
        log(card, f"{name}: {n} B; staging {stage_s:.4f} s (sum over "
                  f"threads); its {len(launches)} launches replayed back to "
                  f"back {kern_s:.4f} s = {rates[f'{name}.kernel']:.3f} GB/s "
                  f"kernel-only; whole call {wall:.4f} s = "
                  f"{rates[f'{name}.call']:.3f} GB/s")
    return rates, counts


def kernel_times(card, dev, plan, eplan, seq_dec, seq_enc, wave, match):
    """Phase 14: each kernel against its plain version at the main
    path's shapes (BATCH rows; SEQ_ROWS corpus rows for the sequential,
    wave and match kernels), alternating plain, kernel, kernel, plain."""
    from snappy_tpu_torch.kernels import crc32c as kc
    from snappy_tpu_torch.kernels import decode_flat as kf
    from snappy_tpu_torch.kernels import decode_seq as kds
    from snappy_tpu_torch.kernels import decode_wavegroup as kw
    from snappy_tpu_torch.kernels import encode_seq as kes
    from snappy_tpu_torch.kernels import match as km
    from snappy_tpu_torch.runtime import device_codec as dc

    rng = np.random.default_rng(7)
    panel = torch.from_numpy(
        rng.integers(0, 256, (dc.BATCH, 520 * 128), dtype=np.uint8)).to(dev)
    rows = panel[:, :kc.CHUNK]
    lens = torch.full((dc.BATCH,), kc.CHUNK, dtype=torch.int32, device=dev)
    out = {}
    runs = {
        "crc32c_rows": (lambda: kc.crc32c_chunks(rows, lens),
                        lambda: kc.crc32c_chunks_plain(rows, lens), 200, 5,
                        dc.BATCH),
        "flat_exec": (lambda: kf.decode_blocks_flat(*plan, dst_max=65536),
                      lambda: kf.decode_blocks_flat_plain(*plan,
                                                          dst_max=65536),
                      200, 5, plan[0].shape[0]),
        "seq_decode": (lambda: kds.decode_blocks_seq(*seq_dec, 65536),
                       lambda: kds.decode_blocks_seq_plain(*seq_dec, 65536),
                       20, 1, seq_dec[0].shape[0]),
        "seq_encode": (lambda: kes.encode_blocks_seq(*seq_enc),
                       lambda: kes.encode_blocks_seq_plain(*seq_enc),
                       20, 1, seq_enc[0].shape[0]),
        "wavegroup": (lambda: kw.decode_blocks_wavegroup(*wave, 65536),
                      lambda: kw.decode_blocks_wavegroup_plain(*wave, 65536),
                      50, 2, wave[0].shape[0]),
        "match_cands": (lambda: km.find_candidates(*match),
                        lambda: km.find_candidates_plain(*match),
                        50, 5, match[0].shape[0]),
    }
    for name, (kern, plain, k_iters, p_iters, nrows) in runs.items():
        # a serial walk's single call needs no warm-up (seconds each)
        p1 = time_ms(plain, p_iters, warm=p_iters > 1)
        k1 = time_ms(kern, k_iters)
        k2 = time_ms(kern, k_iters)
        p2 = time_ms(plain, p_iters, warm=p_iters > 1)
        out[name] = (min(k1, k2), min(p1, p2))
        log(card, f"{name} at [{nrows} rows]: kernel {k1:.4f}/{k2:.4f} "
                  f"ms, plain {p1:.4f}/{p2:.4f} ms")
    enc_k = time_ms(lambda: kf.decode_blocks_flat(
        *eplan, dst_max=81920, out_rows=640), 200)
    log(card, f"flat_exec encode replay at [{eplan[0].shape[0]} rows]: "
              f"kernel {enc_k:.4f} ms")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--id-mib", type=int, default=256)
    ap.add_argument("--classify-mib", type=int, default=64)
    ap.add_argument("--seq-mib", type=int, default=256)
    ap.add_argument("--wave-mib", type=int, default=256)
    ap.add_argument("--devmatch-mib", type=int, default=256)
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
    from snappy_tpu import native
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
    flat_err, plan, eplan = flat_phase(card, dev, flat_data)
    seq_dec_err, seq_dec = seq_decode_phase(card, dev, flat_data)
    seq_enc_err, seq_enc = seq_encode_phase(card, dev, flat_data[1 << 23 :])
    wave_err, wave = wave_phase(card, dev, flat_data[1 << 22 :])
    match_err, match = match_phase(card, dev, flat_data[3 << 22 :])

    for k in dc.HOST_FALLBACKS:
        dc.HOST_FALLBACKS[k] = 0
    rates, counts = main_path(card, dev, args.id_mib, args.classify_mib,
                              args.seq_mib, args.wave_mib, args.devmatch_mib,
                              args.seed)
    launches = {name: sum(c[name] for c in counts.values())
                for name in KERNELS}
    log(card, f"launches on the main path (id + classify + seq + wave + "
              f"devmatch runs): {launches}; host fallbacks: "
              f"{dict(dc.HOST_FALLBACKS)}")

    times = kernel_times(card, dev, plan, eplan, seq_dec, seq_enc, wave,
                         match)
    errs = {"crc32c_rows": crc_err, "flat_exec": flat_err,
            "seq_decode": seq_dec_err, "seq_encode": seq_enc_err,
            "wavegroup": wave_err, "match_cands": match_err}
    table = {"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in KERNELS]}
    log(card, "rates GB/s: " + json.dumps(rates))
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
