"""One run of one cell of the benchmark of ``snappy_tpu_torch``.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU.  The cell,
its configuration and its traffic mix are found by name:
``BENCHMARK.json`` names the cell; ``portbench/configs/<config>.json``
holds the deployment (the environment that picks the port's engine);
``portbench/traffic/<traffic>.json`` holds the pool's objects, each a
kind of ``portbench/corpus.py`` and a size, and the call
(``portbench/calls/<call>.py``); ``portbench/metrics/<name>.py`` reads
one per-layer metric.  A later cell, mix or metric is a new file.

A run: the pool is made from the seed, the call's inputs are set up
(streams framed by the reference encoder, or tensors uploaded), one
warm pass calls every object once, then one caller thread calls the
entry point in a closed loop, in passes through the objects, each pass
in an order drawn from the seed, until ``--seconds`` have passed and
the sampled calls (drawn from the seed across the passes that the warm
pass's pace fits into the window) are done; every call that started is
finished and counted.  With ``--trace 1`` the same window runs under
``torch.profiler`` with the benchmark's spans, and the per-layer metrics
are reported in place of the end-to-end ones.  Then the sampled answers
are compared with the reference, and one JSON line is printed.

Without a CUDA device, with fewer devices than the cell asks for, or
with ``jax``, ``jaxlib``, ``flax`` or ``snappy_tpu`` loaded, the run
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import pkgutil
import resource
import sys
import time

import numpy as np

from portbench import corpus, cost
from portbench import trace as tr

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "snappy_tpu")
KEPT_PER_OBJECT = 2  # answers of each object compared after the window
# the share of the passes that the warm pass's pace would fit into the
# window from which the sampled passes are drawn: a steady pass is no
# slower than the warm one, so the window reaches them
REACHED_SHARE = 0.5


def _process_age_s() -> float | None:
    """Seconds since this process started, from /proc (None where it
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return None
    return age if 0 <= age < 600 else None


_STARTED = time.perf_counter() - (_process_age_s() or 0.0)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find(items: list, name: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(name)


def load_module(kind: str, name: str, root: str = ROOT):
    """``portbench/<kind>/<name>.py``, loaded by path."""
    path = os.path.join(root, "portbench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(workload: str, root: str = ROOT) -> dict:
    """The cell, its configuration, its traffic mix, and the metrics it
    reports, from the files named in ``BENCHMARK.json``."""
    bench = load_json(root, "BENCHMARK.json")
    cell = find(bench["workloads"], workload)
    config = find(bench["configs"], cell["config"])
    config_file = load_json(root, config["file"])
    traffic = load_json(root, "portbench", "traffic", f"{cell['traffic']}.json")

    def reported(metric) -> bool:
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if reported(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if reported(m) and m["moves"] in names]
    return {"cell": cell, "config": config_file, "traffic": traffic,
            "end_to_end": e2e, "per_layer": layer}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole: ``snappy_tpu_torch`` is not ``snappy_tpu``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def sampled_calls(n_objects: int, seed, n_passes: int) -> set:
    """(pass, object) of the calls whose answers are kept: for each
    object, KEPT_PER_OBJECT different passes among the window's first
    ``n_passes``, at places drawn from the seed, so that the sample
    spreads over the whole window."""
    rng = corpus._rng(seed, "sample")
    n_passes = max(1, n_passes)
    out = set()
    for j in range(n_objects):
        places = np.sort(rng.random(KEPT_PER_OBJECT))
        passes = {min(int(u * n_passes), n_passes - 1) for u in places}
        out |= {(p, j) for p in passes}
    return out


def passes_in_window(seconds: float, warm_pass_s: float) -> int:
    """The passes from which the sample is drawn: REACHED_SHARE of those
    that the warm pass's pace fits into the window."""
    return max(1, int(REACHED_SHARE * seconds / max(warm_pass_s, 1e-9)))


def _set_environment(config: dict, root: str) -> None:
    """The configuration's engine variables, before the port is imported
    (its runtime reads them at import), and every cache of a build or a
    compiler at a fixed directory of the checkout."""
    os.environ.update({k: str(v) for k, v in config["env"].items()})
    build = os.path.join(root, "portbench", "_build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


def _launch_counters() -> dict:
    """Every module of ``snappy_tpu_torch.kernels`` with an integer
    ``launches`` counter, found when the run starts."""
    import importlib

    import snappy_tpu_torch.kernels as kernels

    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        module = importlib.import_module(f"{kernels.__name__}.{info.name}")
        if isinstance(getattr(module, "launches", None), int):
            out[info.name] = module
    return out


def end_to_end(durations, done_bytes: int, window_s: float, cpu_s: float,
               setup_s: float) -> dict:
    """The end-to-end metrics of a window: every completed call's bytes
    over the whole window (1e9 bytes a GB); the 95th percentile of every
    call's duration (linear between ranks); the process's CPU seconds,
    all threads, over the GB; set-up from the process's start."""
    gb = done_bytes / 1e9
    return {"GBps": gb / window_s,
            "call_p95_ms": float(np.percentile(durations, 95)) * 1e3,
            "host_core_s_per_GB": cpu_s / gb if gb else None,
            "setup_s": setup_s}


class Context:
    """What a per-layer metric's reader reads: the window's work, the
    launch counters, the native spans and the profiler's records.

    Its fields: ``gb`` completed; ``launches`` by kernel module;
    ``native`` (the wrappers' seconds and calls); ``device`` records and
    ``spans`` (every user annotation on the host, the benchmark's
    ``call`` and ``native.<fn>`` among them) from the profiler; ``lo``
    and ``hi``, the traced window; ``refs``, each pool object's
    reference framing (``reference.Framed``); ``calls_per_object``;
    ``hbm_bytes_per_s``, the card's published memory rate."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def window_bytes(self, bytes_of) -> int:
        """``bytes_of(ref)`` of each pool object's reference framing,
        summed over the window's calls."""
        return sum(n * bytes_of(r) for n, r in zip(self.calls_per_object,
                                                   self.refs))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             root: str = ROOT, device: str = "cuda", entry_wrapper=None,
             traffic: dict | None = None) -> dict:
    """One run; returns the result line as a dict.  ``device="cpu"``,
    ``entry_wrapper`` (wraps the port's entry point) and ``traffic`` (in
    place of the mix's file) are for the benchmark's own tests on a
    machine without a card."""
    spec = cell_spec(workload, root)
    if traffic is not None:
        spec["traffic"] = traffic
    _set_environment(spec["config"], root)

    import torch

    if device == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    import snappy_tpu_torch
    from snappy_tpu_torch import errors, native

    counters = _launch_counters()
    mix = spec["traffic"]
    call_mod = load_module("calls", mix["call"], root)
    entry = getattr(snappy_tpu_torch, call_mod.ENTRY)
    if entry_wrapper is not None:
        entry = entry_wrapper(entry)

    pool = corpus.make_pool(mix, seed, threads=min(8, os.cpu_count() or 1))
    session = call_mod.Session(pool, dev)
    session.reserve(KEPT_PER_OBJECT)
    t_warm = time.perf_counter()
    for j in corpus.call_order(len(pool), seed, -1):  # the warm pass
        session.call(entry, int(j))
    sampled = sampled_calls(len(pool), seed, passes_in_window(
        seconds, time.perf_counter() - t_warm))
    last_sampled = (max(p for p, _ in sampled) + 1) * len(pool)

    spans = prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        spans = tr.NativeSpans(native, record_function)
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
    gc.collect()
    gc.freeze()
    before = {k: m.launches for k, m in counters.items()}
    setup_s = time.perf_counter() - _STARTED

    if prof is not None:
        prof.start()
    durations, failures = [], []
    calls_per_object = [0] * len(pool)
    done_bytes = 0
    slices = [0] * 10  # bytes completed in each tenth of the window
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    t_end = t0
    k = 0
    while t_end - t0 < seconds or k < last_sampled:
        if k % len(pool) == 0:
            order = corpus.call_order(len(pool), seed, k // len(pool))
        j = int(order[k % len(pool)])
        ts = time.perf_counter()
        try:
            if prof is not None:
                with record_function("call"):
                    out = session.call(entry, j)
            else:
                out = session.call(entry, j)
        except Exception as exc:  # a failed call is counted, not fatal
            failures.append(f"{type(exc).__name__}: {exc}")
            out = None
        t_end = time.perf_counter()
        durations.append(t_end - ts)
        if out is not None:
            calls_per_object[j] += 1
            done_bytes += pool[j].size
            slices[min(int((t_end - t0) / seconds * len(slices)),
                       len(slices) - 1)] += pool[j].size
            if (k // len(pool), j) in sampled:
                session.keep(j, out)
        del out
        k += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    window_s = t_end - t0
    if window_s > seconds + max(durations):
        print(f"portbench: the window ran {window_s - seconds:.3f} s over to "
              f"reach its sampled calls", file=sys.stderr)
    print(f"portbench: window {window_s:.3f} s, user "
          f"{ru1.ru_utime - ru0.ru_utime:.3f} s, sys "
          f"{ru1.ru_stime - ru0.ru_stime:.3f} s; GB/s by tenth of the window "
          f"{[round(b / 1e8 / seconds, 3) for b in slices]}", file=sys.stderr)
    if prof is not None:
        prof.stop()
        spans.remove()
    gc.unfreeze()
    launches = {k: m.launches - before[k] for k, m in counters.items()}
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    checks = session.compare(entry, errors)
    checks["failed_calls"] = (len(failures), 0)
    # the configuration's engine ran: each kernel module it names launched
    # (the counters count launches on a card; the plain versions none)
    if dev.type == "cuda":
        checks["engine_kernels_idle"] = (sum(
            1 for name in spec["config"]["launches"][mix["call"]]
            if not launches.get(name)), 0)
    correct = all(v <= lim for v, lim in checks.values())

    gb = done_bytes / 1e9
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": spec["cell"]["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(durations),
              "failed": len(failures), "metrics": {}, "device": info}
    if not trace:
        cpu = (ru1.ru_utime + ru1.ru_stime) - (ru0.ru_utime + ru0.ru_stime)
        values = end_to_end(durations, done_bytes, window_s, cpu, setup_s)
        for m in spec["end_to_end"]:
            if values.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
    else:
        device_recs, host_spans = ([], [])
        t_read = time.perf_counter()
        if dev.type == "cuda":
            device_recs, host_spans = tr.kineto_events(prof)
        win = tr.window(host_spans)
        lo, hi = win if win else (0, 0)
        ctx = Context(gb=gb, launches=launches, native=spans, device=device_recs,
                      spans=host_spans, lo=lo, hi=hi,
                      calls_per_object=calls_per_object, refs=session.refs,
                      hbm_bytes_per_s=cost.HBM_BYTES_PER_S.get(info["kind"]))
        for m in spec["per_layer"]:
            value = load_module("metrics", m["name"], root).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if win:
            info["busy_s"] = tr.busy_ns(device_recs, lo, hi) / 1e9
            info["window_s"] = (hi - lo) / 1e9
            result["breakdown"] = {
                "device_ops": tr.device_ops(device_recs),
                "idle_gaps": tr.idle_gaps(device_recs, host_spans, lo, hi)}
        print(f"portbench: {len(device_recs)} device records and "
              f"{len(host_spans)} spans read in "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    result["_failures"] = failures[:5]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark measures the card "
              "and has no fallback", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"portbench: the cell needs {spec['cell']['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print("portbench: forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for msg in result.pop("_failures"):
        print(f"portbench: failed call: {msg}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0
