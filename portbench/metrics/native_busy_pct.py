"""How busy the native codec's threads are while the runtime waits on
them: 100 x ``native_cpu_ns`` / (``native_wall_ns`` x the runtime's
thread count, ``_threads()``), from the runtime's ``COUNTERS``.  The CPU
time is the whole process's during each call, so it reads high by what
else runs then (in a traced run, the profiler's threads).  The counters
run over the whole process: the warm pass (the same traffic) and, in the
load cells, the three CRC-flip calls after the window (under 2% of the
calls) are counted too.  None where the port has no counters or made
no native call."""

from portbench import spans


def read(ctx):
    c = spans.counters()
    if not c or not c.get("native_wall_ns"):
        return None
    threads = spans.runtime()._threads()
    return 100.0 * c["native_cpu_ns"] / (c["native_wall_ns"] * threads)
