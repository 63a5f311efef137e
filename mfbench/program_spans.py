"""What the readers of the program's own spans and counters share.

The program's spans (``morefusion_tpu_torch/utils/profiling.py``:
``annotate``, ``count``, ``recorded``) are ``record_function`` ranges while
a profiler runs, so the traced stretch's ``profile.host_spans`` holds them
on the profiler's clock; ``recorded()`` keeps each span's interval on the
device and the counters of the same stretch. A program without them (no
``recorded``, no such span) gives None."""

from __future__ import annotations

from mfbench import harness


def recorded(run):
    """The program's record of the traced stretch, or None."""
    if run.record.profile is None:
        return None
    from morefusion_tpu_torch.utils import profiling

    read = getattr(profiling, "recorded", None)
    return read() if read is not None else None


def device_ms_p50(run, span):
    """Median interval on the device of the traced stretch's ``span``."""
    rec = recorded(run)
    ms = rec["device_ms"].get(span) if rec else None
    return harness.median(ms) if ms else None


def host_ms_p50(run, span):
    """Median host range (profiler's clock) of the traced stretch's
    ``span``."""
    prof = run.record.profile
    if prof is None:
        return None
    ms = [(b - a) * 1e-3 for n, a, b in prof.host_spans if n == span]
    return harness.median(ms) if ms else None


def launches_per_span(run, span):
    """Kernel launches inside the traced stretch's ``span`` ranges, per
    range; None where none was launched (no card)."""
    prof = run.record.profile
    if prof is None:
        return None
    n = sum(1 for name, _, _ in prof.host_spans if name == span)
    launches = prof.launches_in(span)
    return launches / n if n and launches else None


def counter_pct(run, part, whole):
    """100 x the counter ``part`` over the counter ``whole``."""
    rec = recorded(run)
    counters = rec["counters"] if rec else {}
    if not counters.get(whole):
        return None
    return 100.0 * counters.get(part, 0) / counters[whole]
