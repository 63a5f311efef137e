"""Wall-clock context-manager profiler.

Own copy of ``morefusion_tpu/utils/timer.py``.

Reference: ``morefusion/utils/timer.py:23-40``. Additionally exposes the
elapsed time on the context object so benches can collect it.
"""

from __future__ import annotations

import contextlib
import inspect
import time


class _Timer:
    def __init__(self):
        self.elapsed = None


@contextlib.contextmanager
def timer(name: str = None, quiet: bool = False):
    if name is None:
        frame = inspect.stack()[2]
        name = f"{frame.filename}:{frame.lineno}"
    t = _Timer()
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        t.elapsed = time.perf_counter() - t0
        if not quiet:
            print(f"[{name}] elapsed: {t.elapsed:.6f} s")
