"""Device time against call time of the CRC and flat kernels on one GPU,
replayed from the runtime's own launches, and the whole calls that make
them.

    python3 snappy_tpu_torch/bench/flat_crc_profile.py [--mib 256] [--seed 20260816]
    python3 snappy_tpu_torch/bench/flat_crc_profile.py --root DIR    # DIR's package

``--root`` imports ``snappy_tpu_torch`` from another checkout, so two
commits can be compared in one run on one card.  On the seeded benchmark
corpus it runs the calls that launch ``crc32c_rows`` and ``flat_exec``
through the public entry points (id ``compress_framed`` and
``decompress_framed_to_device``, the same under the device LZ engine,
classify ``decompress_framed`` and ``compress_framed``), recording each
launch's arguments (cloned with their strides: the runtime reuses its
staging tensors).  Then each of those calls, and the host-only
``native.compress_framed`` / ``native.decompress_framed`` beside them,
is timed twice on the host clock (ending in a sync): the whole-call
rates.  Each group of launches is then replayed back to back
(``kernel_cost.replay``):

- ``call_ms``: CUDA events around the replay, over the launches;
- ``device_ms``: the card's kernel time per launch, the mean of the
  kernel's own ``torch.profiler`` records over one more replay
  (``kernel_cost.profiled``), with ``device_records`` [records,
  launches]: the profiler drops records now and then;
- ``host_us``: the host clock around the replay's loop, before the
  closing sync, per launch: what the wrapper costs the calling thread.

A call whose ``host_us`` exceeds its device time is host bound: the
events then time the host.  ``bound_ms`` is ``kernel_cost.kernel_bytes``
over 3.35 TB/s.  The helpers come from this file's checkout.  Single
shapes (one row, 64 rows, the seq width, the full trip cap) are timed by
``chip_smoke.py`` phase 14.

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


def _keep(x):
    """A copy of a tensor argument with the same shape and strides."""
    import torch

    if not torch.is_tensor(x):
        return x
    c = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                            device=x.device)
    c.copy_(x)
    return c


def record(dev, data: bytes) -> dict:
    """{group: [(wrapper, args, kwargs), ...]} of every CRC and flat
    launch the runtime makes for ``data``'s calls."""
    import torch

    import snappy_tpu_torch as st
    from snappy_tpu_torch.kernels import crc32c as kc
    from snappy_tpu_torch.kernels import decode_flat as kf
    from snappy_tpu_torch.runtime import device_codec as dc

    groups: dict = {}
    real = {"crc32c_rows": dc.crc32c_chunks,
            "flat_exec": dc.decode_blocks_flat,
            "flat_exec_enc": dc._enc.encode_blocks_flat}
    current = ["?"]

    def recorder(kind, wrapper):
        def call(*a, **k):
            groups.setdefault(f"{current[0]}.{kind}", []).append(
                (wrapper, tuple(_keep(x) for x in a),
                 {n: _keep(v) for n, v in k.items() if n != "out"}))
            return real[kind](*a, **k)
        return call

    dc.crc32c_chunks = recorder("crc32c_rows", kc.crc32c_chunks)
    dc.decode_blocks_flat = recorder("flat_exec", kf.decode_blocks_flat)
    dc._enc.encode_blocks_flat = recorder("flat_exec_enc",
                                          real["flat_exec_enc"])
    try:
        current[0] = "id"
        fr = st.compress_framed(data, device=dev)
        st.decompress_framed_to_device(fr, device=dev)
        current[0] = "classify"
        dc.FLAT_MODE = "classify"
        assert st.decompress_framed(fr, device=dev) == data
        assert st.compress_framed(data, device=dev) == fr
        dc.FLAT_MODE = "id"
        current[0] = "seq"
        dc.FLAT, dc.HOST_PARSE = False, False
        assert st.compress_framed(data, device=dev) == fr
        st.decompress_framed_to_device(fr, device=dev)
    finally:
        dc.FLAT, dc.HOST_PARSE, dc.FLAT_MODE = True, True, "id"
        dc.crc32c_chunks = real["crc32c_rows"]
        dc.decode_blocks_flat = real["flat_exec"]
        dc._enc.encode_blocks_flat = real["flat_exec_enc"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return groups


def whole_calls(dev, data: bytes, reps: int = 2) -> None:
    """Print the host-clock seconds and GB/s of each recorded call, per
    engine, and of the host-only native codec, ``reps`` times each."""
    import torch

    import snappy_tpu_torch as st
    from snappy_tpu_torch import native
    from snappy_tpu_torch.runtime import device_codec as dc

    fr = native.compress_framed(data)
    engines = {"id": (True, True, "id"), "classify": (True, True, "classify"),
               "seq": (False, False, "id")}
    calls = {
        "host.native.compress_framed": (None, lambda: native.compress_framed(data)),
        "host.native.decompress_framed":
            (None, lambda: native.decompress_framed(fr)),
        "id.compress_framed":
            ("id", lambda: st.compress_framed(data, device=dev)),
        "id.decompress_framed_to_device":
            ("id", lambda: st.decompress_framed_to_device(fr, device=dev)),
        "classify.decompress_framed":
            ("classify", lambda: st.decompress_framed(fr, device=dev)),
        "classify.compress_framed":
            ("classify", lambda: st.compress_framed(data, device=dev)),
        "seq.compress_framed":
            ("seq", lambda: st.compress_framed(data, device=dev)),
        "seq.decompress_framed_to_device":
            ("seq", lambda: st.decompress_framed_to_device(fr, device=dev)),
    }
    try:
        for name, (engine, fn) in calls.items():
            if engine:
                dc.FLAT, dc.HOST_PARSE, dc.FLAT_MODE = engines[engine]
            secs = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            print(json.dumps({"call": name, "bytes": len(data), "s": secs,
                              "GBps": [len(data) / s / 1e9 for s in secs]}),
                  flush=True)
    finally:
        dc.FLAT, dc.HOST_PARSE, dc.FLAT_MODE = True, True, "id"


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
        print("flat_crc_profile: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    from kernel_cost import HBM_BYTES_PER_S, kernel_bytes, profiled, replay
    from seq_profile import _corpus

    import snappy_tpu_torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "root": root, "package": os.path.dirname(
        snappy_tpu_torch.__file__)}), flush=True)
    dev = torch.device("cuda:0")
    data = _corpus(args.mib << 20, args.seed)
    groups = record(dev, data)
    whole_calls(dev, data)

    for name, launches in sorted(groups.items()):
        fns = [lambda w=w, a=a, k=k: w(*a, **k) for w, a, k in launches]
        enc = name.endswith("_enc")
        # the encode replay's wrapper takes the plan alone (its dst_max
        # 81,920, its panel 640 rows); decode calls name their dst_max
        nbytes = sum(kernel_bytes("flat_exec" if "flat" in name
                                  else "crc32c_rows", a,
                                  k.get("dst_max", 81920 if enc else 65536),
                                  640 if enc else k.get("out_rows", 520))
                     for _, a, k in launches)
        call_s, host_s = min(replay(fns))
        n = len(launches)
        recs = profiled(lambda: [fn() for fn in fns], 1,
                        "flat_exec" if "flat" in name else "crc32c_rows")
        dev_ms = recs["kernel_ms_mean"]
        print(json.dumps({
            "replay": name, "launches": n,
            "rows": sorted({a[0].shape[0] for _, a, _ in launches}),
            "GBps_of_corpus": len(data) / call_s / 1e9,
            "call_ms": call_s * 1e3 / n, "device_ms": dev_ms,
            "device_records": [recs["kernel_records"], n],
            "host_us": host_s * 1e6 / n,
            "bound_ms": nbytes / n / HBM_BYTES_PER_S * 1e3,
            "bound_by": (None if dev_ms is None else "host"
                         if host_s * 1e3 / n > dev_ms else "device")}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
