"""Kernel-only rates of the standalone engines' kernels on one GPU: the
wave-group decoder (``wavegroup``) and the match finder (``match_cands``)
over the benchmark corpus, each at its engine's launch width.

    python3 snappy_tpu_torch/bench/wide_profile.py [--mib 256] [--seed 20260816]
    python3 snappy_tpu_torch/bench/wide_profile.py --root DIR    # DIR's package

``--root`` imports ``snappy_tpu_torch`` from another checkout, so two
commits can be compared in one run on one card.  The width is the
package's ``resident_rows`` where it has one, else 64 rows (the width
before it had one).  Every 64 KiB block of the corpus is staged as the
engines stage it (``stage_waves`` of its ``native.compress`` stream;
``stage_words``), each launch is checked (the wave rows against the
input, the candidates against ``find_candidates_plain``), then all
launches are replayed back to back three times (CUDA events): corpus
bytes over the fastest replay is the kernel-only rate.  Each kernel's
time at 64 rows (the first 64 blocks) is timed too, and so is
``stage_waves`` of one launch's streams staged to the CPU then copied,
against staged straight to the card.  ``--corpus FILE`` keeps the
corpus in FILE between runs.

Needs a CUDA device.  Prints one JSON object per line, the first the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def _replay(launches, reps: int = 3) -> list:
    """Seconds of each back-to-back replay of ``launches`` (CUDA events)."""
    from kernel_cost import replay

    return [ev for ev, _host in replay(launches, reps)]


def _ms(fn, iters: int = 20) -> float:
    return _replay([fn] * iters, 1)[0] * 1e3 / iters


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--seed", type=int, default=20260816)
    ap.add_argument("--corpus", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, here)

    import torch

    if not torch.cuda.is_available():
        print("wide_profile: no CUDA device visible to torch", file=sys.stderr)
        return 2
    from seq_profile import _corpus

    import snappy_tpu_torch
    from snappy_tpu_torch import native
    from snappy_tpu_torch.kernels import decode_wavegroup as kw
    from snappy_tpu_torch.kernels import match as km

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "root": root, "package": os.path.dirname(
        snappy_tpu_torch.__file__)}), flush=True)
    dev = torch.device("cuda:0")
    if args.corpus and os.path.exists(args.corpus):
        with open(args.corpus, "rb") as f:
            data = f.read()
    else:
        data = _corpus(args.mib << 20, args.seed)
        if args.corpus:
            with open(args.corpus, "wb") as f:
                f.write(data)
    n = len(data)
    blocks = [data[i << 16 : (i + 1) << 16] for i in range(-(-n >> 16))]
    with ThreadPoolExecutor(4) as pool:
        streams = list(pool.map(native.compress, blocks))

    # wavegroup
    width = (kw.resident_rows(dev, 65536) if hasattr(kw, "resident_rows")
             else 64)
    with ThreadPoolExecutor(4) as pool:
        staged = list(pool.map(
            lambda lo: kw.stage_waves(streams[lo : lo + width], device="cpu"),
            range(0, len(blocks), width)))
    launched = []
    for k, st in enumerate(staged):
        a = tuple(t.to(dev) for t in st)
        out = kw.decode_blocks_wavegroup(*a, 65536)
        lo = k * width
        want = torch.zeros(out.shape[0] << 16, dtype=torch.uint8)
        got = data[lo << 16 : (lo + out.shape[0]) << 16]
        want[: len(got)] = torch.frombuffer(bytearray(got), dtype=torch.uint8)
        assert torch.equal(out, want.to(dev).view(-1, 65536)), f"wave {k}"
        launched.append(a)
    reps = _replay([lambda a=a: kw.decode_blocks_wavegroup(*a, 65536)
                    for a in launched])
    a64 = tuple(t[:64] for t in launched[0])
    ms64 = _ms(lambda: kw.decode_blocks_wavegroup(*a64, 65536))
    batch = streams[:width]
    t_cpu = min(_host_s(lambda: tuple(
        t.to(dev) for t in kw.stage_waves(batch, device="cpu")))
        for _ in range(3))
    t_dev = min(_host_s(lambda: kw.stage_waves(batch, device=dev))
                for _ in range(3))
    print(json.dumps({"kernel": "wavegroup", "rows": width,
                      "launches": len(launched), "replays_s": reps,
                      "GBps_of_corpus": n / min(reps) / 1e9,
                      "ms_at_64_rows": ms64,
                      "stage_waves_cpu_then_copy_s": t_cpu,
                      "stage_waves_to_card_s": t_dev}), flush=True)
    del launched, staged

    # match_cands (home route, as the devmatch engine runs it)
    width = km.resident_rows(dev) if hasattr(km, "resident_rows") else 64
    launched = []
    for lo in range(0, len(blocks), width):
        w, npos = km.stage_words(blocks[lo : lo + width])
        a = (torch.from_numpy(w).to(dev), torch.from_numpy(npos).to(dev))
        assert torch.equal(km.find_candidates(*a),
                           km.find_candidates_plain(*a)), f"match {lo}"
        launched.append(a)
    reps = _replay([lambda a=a: km.find_candidates(*a) for a in launched])
    a64 = tuple(t[:64] for t in launched[0])
    ms64 = _ms(lambda: km.find_candidates(*a64))
    print(json.dumps({"kernel": "match_cands", "rows": width,
                      "launches": len(launched), "replays_s": reps,
                      "GBps_of_corpus": n / min(reps) / 1e9,
                      "ms_at_64_rows": ms64}), flush=True)
    return 0


def _host_s(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


if __name__ == "__main__":
    sys.exit(main())
