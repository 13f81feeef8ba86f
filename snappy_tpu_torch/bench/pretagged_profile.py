"""Card time against call time of the hybrid engine's record executor
(``decode_pretagged``) on one GPU, at the runtime's batch and over the
launches of a whole hybrid call, and the whole calls' rates.

    python3 snappy_tpu_torch/bench/pretagged_profile.py [--mib 256] [--seed 20260816]
    python3 snappy_tpu_torch/bench/pretagged_profile.py --root DIR    # DIR's package

``--root`` imports ``snappy_tpu_torch`` from another checkout, so two
commits can be compared in one run on one card.  On the seeded benchmark
corpus (``make_corpus``, ``--mib`` MiB, framed by the native codec) it
prints one JSON object per line:

- ``card``: the card's ``nvidia-smi`` name and power limit, the root;
- ``batch``: ``chip_smoke.py`` phase 18's batch (the first 64 compressed
  chunks, ``stage_records``): the kernel against its plain version
  (max_abs_err), its card time a launch (``device_ms``, the mean of its
  torch.profiler records; ``device_records`` [records, launches]),
  its call time (``call_ms``, CUDA events around 200 back-to-back
  calls), the host's time a call (``host_us``), its bound
  (``kernel_cost.kernel_bytes`` over 3.35 TB/s) and, where the package
  has ``execute_records_model``, the schedule's rounds a group of 32
  copies on that batch (the model runs on the host);
- ``gap``: the same batch, and ``seq_encode`` on the corpus' first 64
  blocks: one launch between two syncs (20 times), 1, 10 and 200
  back-to-back launches (events), the profiler's kernel records over 50
  launches (how many it saw, their mean), the SM clock before and after,
  and sampled while 1,000 launches run;
- ``call``: the hybrid engine's ``decompress_framed`` and
  ``decompress_framed_to_device`` (``SNAPPY_TPU_FLAT=0``) and the host's
  ``native.decompress_framed``, twice each, host clock ending in a sync;
- ``replay``: the record executor's launches of one hybrid
  ``decompress_framed_to_device``, recorded (arguments cloned with their
  strides) and replayed back to back: launches, call ms, card ms and
  host us a launch, the bound a launch, and the kernel time and the time
  lost against the bound over the whole call.

Needs a CUDA device.  The helpers (``kernel_cost``, the corpus) come from
this file's checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCH_ROWS = 64  # chip_smoke phase 18's batch and the runtime's BATCH


def _nvsmi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _keep(x):
    """A copy of a tensor argument with the same shape and strides."""
    import torch

    if not torch.is_tensor(x):
        return x
    c = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                            device=x.device)
    c.copy_(x)
    return c


def _events_ms(fn, n: int) -> tuple:
    """(ms a launch, host us a launch) of ``n`` back-to-back calls."""
    import torch

    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host * 1e6 / n


def gap(name: str, fn, key: str) -> dict:
    """Where a long kernel's call time and card time part: single
    launches between syncs, 1 / 10 / 200 back-to-back launches, the
    profiler's records, and the SM clock around them."""
    import torch

    from kernel_cost import profiled

    fn()
    torch.cuda.synchronize()
    clock_before = _nvsmi("clocks.sm")
    single = []
    for _ in range(20):
        torch.cuda.synchronize()
        single.append(_events_ms(fn, 1)[0])
    b2b = {n: _events_ms(fn, n) for n in (1, 10, 200)}
    prof = profiled(fn, 50, key)
    clock_after = _nvsmi("clocks.sm")
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        time.sleep(0.5)
        long_ms, _ = _events_ms(fn, 1000)
    finally:
        sampler.terminate()
        sampled, _ = sampler.communicate(timeout=60)
    mhz = [int(x) for x in sampled.split() if x.isdigit()]
    return {"gap": name, "single_ms_min": min(single),
            "single_ms_median": statistics.median(single),
            "b2b_ms": {n: v[0] for n, v in b2b.items()},
            "b2b_host_us": {n: v[1] for n, v in b2b.items()},
            "profiler": prof, "clock_before": clock_before,
            "clock_after": clock_after, "b2b_1000_ms": long_ms,
            "clock_sampled_mhz": mhz}


def batch(dev, fr: bytes) -> tuple:
    """Phase 18's batch: (its staged arguments, the batch line)."""
    import torch

    from kernel_cost import HBM_BYTES_PER_S, kernel_bytes, profiled
    from snappy_tpu_torch.kernels import decode_pretagged as kp
    from snappy_tpu_torch.runtime import device_codec as dc

    chunks, _ = dc._scan_frames(fr)
    first = [ch for ch in chunks if ch[0] == 0][:BATCH_ROWS]
    args = kp.stage_records([fr[ch[1] : ch[1] + ch[2]] for ch in first],
                            [ch[5] for ch in first], [ch[4] for ch in first],
                            device=dev)
    got = kp.decode_blocks_pretagged(*args)
    plain = kp.decode_blocks_pretagged_plain(*args)
    err = int((got.int() - plain.int()).abs().max())
    call_ms, host_us = _events_ms(lambda: kp.decode_blocks_pretagged(*args),
                                  200)
    recs = profiled(lambda: kp.decode_blocks_pretagged(*args), 50,
                    "pretagged")
    nbytes = kernel_bytes("decode_pretagged", args)
    line = {"batch": len(first), "payload_width": args[0].shape[1],
            "record_cap": args[1].shape[1], "records": int(args[2].sum()),
            "max_abs_err": err, "device_ms": recs["kernel_ms_mean"],
            "device_records": [recs["kernel_records"], recs["launches"]],
            "call_ms": call_ms,
            "host_us": host_us, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    model = getattr(kp, "execute_records_model", None)
    if model is not None:
        t0 = time.perf_counter()
        rows, rounds = model(*(a.cpu() for a in args))
        flat = [r for row in rounds for r in row]
        line.update(model_equal=bool((torch.from_numpy(rows) == got.cpu())
                                     .all()),
                    model_groups=len(flat),
                    model_rounds_per_group=sum(flat) / max(len(flat), 1),
                    model_rounds_per_row=[int(sum(r)) for r in rounds],
                    model_s=time.perf_counter() - t0)
    return args, line


def whole_calls(dev, data: bytes, fr: bytes, reps: int = 2) -> None:
    """Print the host-clock seconds and GB/s of the hybrid engine's two
    framed decodes and of the host-only native decode."""
    import torch

    import snappy_tpu_torch as st
    from snappy_tpu_torch import native
    from snappy_tpu_torch.runtime import device_codec as dc

    calls = {
        "host.native.decompress_framed":
            (False, lambda: native.decompress_framed(fr, threads=4)),
        "hybrid.decompress_framed":
            (True, lambda: st.decompress_framed(fr, device=dev)),
        "hybrid.decompress_framed_to_device":
            (True, lambda: st.decompress_framed_to_device(fr, device=dev)),
    }
    for name, (hybrid, fn) in calls.items():
        dc.FLAT, dc.HOST_PARSE = (False, True) if hybrid else (True, True)
        try:
            secs = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            ok = (out == data if isinstance(out, bytes)
                  else out.cpu().numpy().tobytes() == data)
            assert ok, f"{name}: output != input"
        finally:
            dc.FLAT, dc.HOST_PARSE = True, True
        print(json.dumps({"call": name, "bytes": len(data), "s": secs,
                          "GBps": [len(data) / s / 1e9 for s in secs]}),
              flush=True)


def replay_call(dev, fr: bytes) -> None:
    """Record the record executor's launches of one hybrid
    decompress_framed_to_device and replay them."""
    import snappy_tpu_torch as st
    from kernel_cost import HBM_BYTES_PER_S, kernel_bytes, profiled, replay
    from snappy_tpu_torch.kernels import decode_pretagged as kp
    from snappy_tpu_torch.runtime import device_codec as dc

    real = dc.decode_blocks_pretagged
    launches = []

    def record(*a, **k):
        launches.append((tuple(_keep(x) for x in a), dict(k)))
        return real(*a, **k)

    dc.decode_blocks_pretagged = record
    dc.FLAT, dc.HOST_PARSE = False, True
    try:
        st.decompress_framed_to_device(fr, device=dev)
    finally:
        dc.decode_blocks_pretagged = real
        dc.FLAT, dc.HOST_PARSE = True, True
    fns = [lambda a=a, k=k: kp.decode_blocks_pretagged(*a, **k)
           for a, k in launches]
    nbytes = sum(kernel_bytes("decode_pretagged", a,
                              k.get("out_max", 65536)) for a, k in launches)
    call_s, host_s = min(replay(fns))
    n = len(launches)
    recs = profiled(lambda: [fn() for fn in fns], 1, "pretagged")
    dev_ms = recs["kernel_ms_mean"]
    bound_ms = nbytes / n / HBM_BYTES_PER_S * 1e3
    print(json.dumps({
        "replay": "hybrid.decompress_framed_to_device", "launches": n,
        "call_ms": call_s * 1e3 / n, "device_ms": dev_ms,
        "device_records": [recs["kernel_records"], n],
        "host_us": host_s * 1e6 / n, "bound_ms": bound_ms,
        "kernel_ms_per_call": None if dev_ms is None else dev_ms * n,
        "lost_ms_per_call": (None if dev_ms is None
                             else n * (dev_ms - bound_ms))}), flush=True)


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--seed", type=int, default=20260816)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, here)

    import torch

    if not torch.cuda.is_available():
        print("pretagged_profile: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    from seq_profile import _corpus

    import snappy_tpu_torch
    from snappy_tpu_torch import native
    from snappy_tpu_torch.kernels import encode_seq as kes

    print(json.dumps({"card": _nvsmi("name,power.limit"), "root": root,
                      "package": os.path.dirname(snappy_tpu_torch.__file__)}),
          flush=True)
    dev = torch.device("cuda:0")
    data = _corpus(args.mib << 20, args.seed)
    fr = native.compress_framed(data, threads=4)

    from snappy_tpu_torch.kernels import decode_pretagged as kp

    staged, line = batch(dev, fr)
    print(json.dumps(line), flush=True)
    print(json.dumps(gap("decode_pretagged", lambda: kp.decode_blocks_pretagged(
        *staged), "pretagged")), flush=True)
    import numpy as np

    blocks = np.zeros((BATCH_ROWS, 65536), np.uint8)
    for i in range(BATCH_ROWS):
        blocks[i] = np.frombuffer(data[i << 16 : (i + 1) << 16], np.uint8)
    enc = kes.stage_encode(blocks, np.full(BATCH_ROWS, 65536, np.int32), dev)
    print(json.dumps(gap("seq_encode", lambda: kes.encode_blocks_seq(*enc),
                         "seq_encode")), flush=True)
    del staged, enc
    whole_calls(dev, data, fr)
    replay_call(dev, fr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
