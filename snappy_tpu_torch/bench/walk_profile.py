"""Card times of the walking kernels, for comparing two packages in one
call.

    python3 snappy_tpu_torch/bench/walk_profile.py [--root DIR] [--reps N]

Imports ``snappy_tpu_torch`` from ``--root`` (default: this checkout),
builds its kernels, and times with CUDA events, back to back, the best of
``--reps`` runs of 20 calls:

* ``seq_decode`` (``decode_seq.decode_blocks_seq``) at 64 and at 396
  rows of ``make_corpus(seed=20260816)``'s 64 KiB chunks as
  ``native.compress`` encodes them;
* ``decode_par`` (``decode_par.decode_blocks``) at the first 64 of those
  rows, and at one row of the first 64 chunks' 4 MiB raw stream (its
  wide-row path), where the package has the kernel;
* ``encode_par`` (``encode_par.encode_blocks``) at the first 64 chunks,
  the jnp engine's 64-row batch, where the package has the kernels;
* ``decode_pretagged`` at the 64-row batch of the hybrid engine: the
  first 64 compressed chunks of those chunks' framed stream, the native
  parser's records.

Each output of the kernels is checked first (the decoded bytes, the
encoder's rows against its plain version).  Then each function's
kernels are profiled apart (``kernel_cost.kernel_split``: every kernel
of 20 calls by name, its records and their mean milliseconds), which
says what sets a multi-kernel function's pace.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
of milliseconds a call and the split.  Run parent, change, change,
parent in one command to compare two trees on the same card.
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
    sys.path.insert(1, here)
    import numpy as np
    import torch

    from kernel_cost import kernel_split
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
    split = {}

    def timed(name, fn):
        res[name] = min(_events_ms(fn) for _ in range(args.reps))
        split[name] = kernel_split(fn, 20)

    for n in (64, rows):
        part = [x[:n] for x in batch]
        out, err = kds.decode_blocks_seq(*part, 65536)
        assert not err.any(), "seq_decode failed on the corpus"
        timed(f"seq_decode.{n}", lambda: kds.decode_blocks_seq(*part, 65536))
    lib = _build.lib()
    blk = torch.from_numpy(np.frombuffer(b"".join(chunks[:64]), np.uint8)
                           .reshape(64, 65536).copy()).to(dev)
    if hasattr(lib, "snc_decode_par"):
        part = [x[:64] for x in batch]
        out, err = dp.decode_blocks(*part, out_max=65536)
        assert not err.any() and torch.equal(out, blk), \
            "decode_par failed on the corpus"
        timed("decode_par.64",
              lambda: dp.decode_blocks(*part, out_max=65536))
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
        timed("decode_par.wide", lambda: dp.decode_blocks(*one, **kw))
    if hasattr(lib, "snc_encode_par"):
        from snappy_tpu_torch.kernels import encode_par as ep

        lens = torch.full((64,), 65536, dtype=torch.int32, device=dev)
        got = ep.encode_blocks(blk, lens)
        want = ep.encode_blocks_plain(blk, lens)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), \
            "encode_par differs from its plain version on the corpus"
        timed("encode_par.64", lambda: ep.encode_blocks(blk, lens))
    if hasattr(lib, "snc_pretagged"):
        from snappy_tpu_torch.kernels import decode_pretagged as kp
        from snappy_tpu_torch.runtime import device_codec as dc

        fr = native.compress_framed(b"".join(chunks[:128]), threads=4)
        frames, _ = dc._scan_frames(fr)
        first = [ch for ch in frames if ch[0] == 0][:64]
        staged = kp.stage_records([fr[ch[1] : ch[1] + ch[2]] for ch in first],
                                  [ch[5] for ch in first],
                                  [ch[4] for ch in first], device=dev)
        timed("decode_pretagged.64",
              lambda: kp.decode_blocks_pretagged(*staged))
    print(json.dumps(res), flush=True)
    print(json.dumps({"split": split}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
