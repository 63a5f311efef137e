"""Kernel launches inside the traced frames' ICC refines, per iteration."""


def read(run):
    prof = run.record.profile
    refines = run.record.extra.get("icc_iterations")
    if prof is None or not refines:
        return None
    n = sum(1 for name, _, _ in prof.host_spans if name == "icc.refine")
    launches = prof.launches_in("icc.refine")
    return launches / (n * refines) if n and launches else None
