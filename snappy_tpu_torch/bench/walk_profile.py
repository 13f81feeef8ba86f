"""Card times of the serial decode walks, for comparing two packages in
one call.

    python3 snappy_tpu_torch/bench/walk_profile.py [--root DIR] [--reps N]

Imports ``snappy_tpu_torch`` from ``--root`` (default: this checkout),
builds its kernels, and times with CUDA events, back to back, the best of
``--reps`` runs of 20 calls:

* ``seq_decode`` (``decode_seq.decode_blocks_seq``) at 64 and at 396
  rows of ``make_corpus(seed=20260816)``'s 64 KiB chunks as
  ``native.compress`` encodes them;
* ``decode_par`` (``decode_par.decode_blocks``) at the first 64 of those
  rows, and at one row of the first 64 chunks' 4 MiB raw stream (its
  wide-row path), where the package has the kernel.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
of milliseconds a call.  Run parent, change, change, parent in one
command to compare two trees on the same card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _events_ms(fn, calls: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose snappy_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from snappy_tpu_torch import native
    from snappy_tpu_torch.bench.corpus import make_corpus
    from snappy_tpu_torch.kernels import _build
    from snappy_tpu_torch.kernels import decode_par as dp
    from snappy_tpu_torch.kernels import decode_seq as kds
    from snappy_tpu_torch.spec.format import read_uvarint

    if not torch.cuda.is_available():
        print("walk_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rows = 396
    data = b"".join(d for _, d in make_corpus(rows << 16, seed=20260816))
    chunks = [data[i << 16 : (i + 1) << 16] for i in range(rows)]
    streams = [native.compress(c) for c in chunks]
    comp = np.zeros((rows, 66560), np.uint8)
    starts, clens, dlens = (np.zeros(rows, np.int32) for _ in range(3))
    for i, s in enumerate(streams):
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
        dlens[i], starts[i] = read_uvarint(s, 0)
        clens[i] = len(s)
    batch = [torch.from_numpy(a).to(dev) for a in (comp, starts, clens, dlens)]

    res = {"root": args.root}
    for n in (64, rows):
        part = [x[:n] for x in batch]
        out, err = kds.decode_blocks_seq(*part, 65536)
        assert not err.any(), "seq_decode failed on the corpus"
        res[f"seq_decode.{n}"] = min(
            _events_ms(lambda: kds.decode_blocks_seq(*part, 65536))
            for _ in range(args.reps))
    lib = _build.lib()
    if hasattr(lib, "snc_decode_par"):
        part = [x[:64] for x in batch]
        res["decode_par.64"] = min(
            _events_ms(lambda: dp.decode_blocks(*part, out_max=65536))
            for _ in range(args.reps))
    if hasattr(lib, "snc_decode_par_scratch"):
        raw = native.compress(b"".join(chunks[:64]))
        dlen, hdr = read_uvarint(raw, 0)
        cmax = 1 << (len(raw) - 1).bit_length()
        row = np.zeros((1, cmax), np.uint8)
        row[0, : len(raw)] = np.frombuffer(raw, np.uint8)
        one = [torch.from_numpy(row).to(dev)] + [
            torch.tensor([v], dtype=torch.int32, device=dev)
            for v in (hdr, len(raw), dlen)]
        rounds = max(17, cmax.bit_length() + 1, dlen.bit_length() + 1)
        kw = {"out_max": dlen, "tag_rounds": rounds, "ptr_rounds": rounds}
        out, err = dp.decode_blocks(*one, **kw)
        assert int(err[0]) == 0 and out[0].cpu().numpy().tobytes() == \
            b"".join(chunks[:64]), "decode_par's wide row failed"
        res["decode_par.wide"] = min(
            _events_ms(lambda: dp.decode_blocks(*one, **kw))
            for _ in range(args.reps))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
