"""The card's peaks, and a kernel's share of its roofline.

A per-layer metric counts the bytes its kernel must move from the cell's
data and its reference framing (``Context.refs``), never from the port's
launch arguments, so that whatever implements the work, the yardstick
stays the same: each byte the kernel's function must read counted once,
each byte it must write counted once.
"""

from __future__ import annotations

# Published device memory rates, by ``torch.cuda.get_device_name()``:
# NVIDIA's data sheet for the H100 SXM (80 GB HBM3), at its 700 W limit.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def roofline_pct(ctx, kernel: str, counter: str, bytes_of) -> float | None:
    """100 x (the window's needed bytes / peak rate) / (record mean x
    launches), where ``bytes_of(ref)`` is what one call on a pool
    object needs; None where the window has no record or launch of the
    kernel, or the card has no peak in the table."""
    from portbench import trace

    mean_s = trace.kernel_mean_s(ctx.device, kernel)
    launches = ctx.launches.get(counter, 0)
    if mean_s is None or not launches or not ctx.hbm_bytes_per_s:
        return None
    return (100.0 * ctx.window_bytes(bytes_of) / ctx.hbm_bytes_per_s
            / (mean_s * launches))
