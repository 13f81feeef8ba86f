"""Profile of the device LZ engine ("seq") on one GPU: whole-call rates,
kernel-only rates and the device's split of each call.

    python3 snappy_tpu_torch/bench/seq_profile.py [--mib 256] [--seed 20260816]
    python3 snappy_tpu_torch/bench/seq_profile.py --root DIR    # DIR's package

``--root`` imports ``snappy_tpu_torch`` (and ``chip_smoke.py``) from
another checkout, so two commits can be compared in one run on one
card.  With ``SNAPPY_TPU_FLAT=0 SNAPPY_TPU_HOST_PARSE=0`` set in code,
on the seeded benchmark corpus, each of ``compress_framed``,
``decompress_framed_to_device``, ``compress_framed_from_device`` and
``decompress_framed``, then ``checkpoint.save_pytree`` /
``load_pytree`` of chip_smoke's GPT-2-medium-shaped state
(``--ckpt-layers``), runs once to warm up, once timed on the host clock
(ending in a sync) and once under ``torch.profiler``.  From the profile:
the device's busy time (the union of its kernel and copy intervals)
over the profiled call's wall time, each kernel's time by name, and
the host-device copies.  Then the sequential kernels' launches of the
corpus calls, recorded with their arguments, are replayed back to back
(CUDA events): each kernel's kernel-only rate on the corpus.

Needs a CUDA device.  Prints one JSON object per line, the first the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time


def _corpus(total: int, seed: int) -> bytes:
    """The benchmark corpus, from this file's copy of corpus.py (an older
    checkout's package may lack it)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "corpus.py")
    spec = importlib.util.spec_from_file_location("_seq_profile_corpus", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return b"".join(d for _, d in mod.make_corpus(total, seed=seed))


def _device_split(prof, wall_s: float) -> dict:
    """Busy share, kernel milliseconds by name and copy milliseconds of
    one profiled call."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        raise SystemExit("torch.profiler recorded no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict = {}
    for e in evs:
        name = e.name
        if "Memcpy" in name:
            name = "memcpy " + ("HtoD" if "HtoD" in name else
                                "DtoH" if "DtoH" in name else "DtoD")
        elif "Memset" in name:
            name = "memset"
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_s * 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / 1e3 / (wall_s * 1e3),
            "device_ms": {k: round(v / 1e3, 4) for k, v in top}}


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--ckpt-layers", type=int, default=24)
    ap.add_argument("--seed", type=int, default=20260816)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("seq_profile: no CUDA device visible to torch", file=sys.stderr)
        return 2
    import chip_smoke
    import snappy_tpu_torch as st
    from kernel_cost import keep
    from snappy_tpu_torch import checkpoint as ck
    from snappy_tpu_torch.kernels import decode_seq as kds
    from snappy_tpu_torch.kernels import encode_seq as kes
    from snappy_tpu_torch.runtime import device_codec as dc
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "root": root,
                      "package": os.path.dirname(st.__file__)}), flush=True)
    dev = torch.device("cuda:0")
    data = _corpus(args.mib << 20, args.seed)
    n = len(data)
    dc.FLAT, dc.HOST_PARSE = False, False

    recorded = {"seq_decode": [], "seq_encode": []}
    real = {"seq_decode": dc.decode_blocks_seq,
            "seq_encode": dc.encode_blocks_seq}
    recording = [False]

    def recorder(name):
        def call(*a, **k):
            if recording[0]:
                recorded[name].append((tuple(keep(x) for x in a), k))
            return real[name](*a, **k)
        return call

    dc.decode_blocks_seq = recorder("seq_decode")
    dc.encode_blocks_seq = recorder("seq_encode")

    fr = st.compress_framed(data, device=dev)
    arr = st.decompress_framed_to_device(fr, device=dev)
    calls = {
        "compress_framed": lambda: st.compress_framed(data, device=dev),
        "decompress_framed_to_device":
            lambda: st.decompress_framed_to_device(fr, device=dev),
        "compress_framed_from_device":
            lambda: st.compress_framed_from_device(arr),
        "decompress_framed": lambda: st.decompress_framed(fr, device=dev),
    }
    state = chip_smoke.gpt2_state(args.ckpt_layers, dev, args.seed)
    nstate = sum(t.numel() * t.element_size() for t in state.values())
    blob = ck.save_pytree(state)
    ckpt = {"save_pytree": lambda: ck.save_pytree(state),
            "load_pytree": lambda: ck.load_pytree(blob)}

    def measure(name, fn, nbytes):
        fn()
        torch.cuda.synchronize()
        recording[0] = name in ("compress_framed",
                                "decompress_framed_to_device")
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        recording[0] = False
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(json.dumps({"call": name, "bytes": nbytes, "s": secs,
                          "GBps": nbytes / secs / 1e9,
                          "profiled": _device_split(prof, wall)}), flush=True)

    for name, fn in calls.items():
        measure(name, fn, n)
    for name, fn in ckpt.items():
        measure(f"checkpoint.{name}", fn, nstate)
    dc.decode_blocks_seq, dc.encode_blocks_seq = (real["seq_decode"],
                                                  real["seq_encode"])

    for name, fn in (("seq_decode", kds.decode_blocks_seq),
                     ("seq_encode", kes.encode_blocks_seq)):
        launches = recorded[name]
        for a, k in launches:  # warm
            fn(*a, **k)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for a, k in launches:
            fn(*a, **k)
        end.record()
        torch.cuda.synchronize()
        secs = start.elapsed_time(end) / 1e3
        print(json.dumps({"kernel": name, "launches": len(launches),
                          "rows": sorted({a[0].shape[0] for a, _ in launches}),
                          "s": secs, "GBps_of_corpus": n / secs / 1e9}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
