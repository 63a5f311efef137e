"""What the metric readers (``end_to_end/*.py``, ``layer_metrics/*.py``)
share: each reader is ``read(run) -> float or None`` over a
``harness.Run``, and returns None where the run recorded nothing for it."""

from __future__ import annotations

from mfbench import counts, harness

KERNELS = {
    "knn": ("knn_kernel",),
    "min_dist": ("min_dist_split_kernel", "min_dist_finalize_kernel"),
}


def completed(run):
    return [u for u in run.record.units if u.get("ok", True)]


def per_second(run):
    """Work of the window's completed units (their ``size``: crops,
    frames) over the window's seconds."""
    if run.record.window_s <= 0 or not run.record.units:
        return None
    return sum(u["size"] for u in completed(run)) / run.record.window_s


def steady(run):
    """The window's units and seconds outside the traced stretch (the
    profiler's own cost included in what is left out)."""
    units, seconds = run.record.units, run.record.window_s
    stretch = run.record.extra.get("stretch")
    if stretch:
        a, n = stretch["first"], stretch["units"]
        units = units[:a] + units[a + n:]
        seconds -= stretch["seconds"]
    return units, seconds


def unit_ms(run):
    return [(u["end"] - u["start"]) * 1e3 for u in run.record.units]


def span_ms_p50(run, name):
    spans = run.record.spans.get(name)
    return harness.median(spans) * 1e3 if spans else None


def idle_pct(run):
    prof = run.record.profile
    if prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s() / prof.window_s)


def profiled_units(run):
    prof = run.record.profile
    if prof is None:
        return []
    return run.record.units[prof.first:prof.first + prof.units]


def steady_mfu(run, flops_per_unit):
    """FLOPs of the units outside the traced stretch over their seconds,
    against the fp32 peak."""
    units, seconds = steady(run)
    return mfu_pct(sum(flops_per_unit(u) for u in units), seconds)


def kernel_roofline(run, kernel):
    """Share (%) of the least time the profiled stretch's calls of
    ``kernel`` need (each call's work by ``counts``) in the kernel's device
    time there; None where the stretch ran none."""
    prof = run.record.profile
    if prof is None:
        return None
    names = KERNELS[kernel]
    seconds = prof.op_seconds(lambda n: any(k in n for k in names))
    least = sum(counts.least_seconds(*w)
                for u in profiled_units(run)
                for w in u.get("work", {}).get(kernel, []))
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds


def mfu_pct(flops, seconds):
    if not flops or seconds <= 0:
        return None
    return 100.0 * flops / seconds / counts.PEAK_FP32_FLOPS
