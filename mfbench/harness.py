"""The harness: finds a cell's pieces by name, runs its driver, reduces
what it recorded to metrics, and prints the result line.

Everything that belongs to one configuration, cell, kind of traffic or
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``mfbench/configs/<config>.json``: the model's widths and recipe;
- ``mfbench/workloads/<cell>.json``: the driver, the traffic's parameters
  and the limits of the correctness check;
- ``mfbench/drivers/<driver>.py``: ``setup``, ``window`` and ``check``;
- ``mfbench/end_to_end/<metric>.py`` and ``mfbench/layer_metrics/<metric>.py``:
  ``read(run)``, the metric from what the run recorded, or None where it
  finds nothing to read.

A run: set-up (the driver builds the program, makes its inputs from the
seed and warms up every shape the cell uses), then the measured window of
``--seconds``, then the correctness check against the plain reference. With
``--trace 1`` a short steady stretch of the window runs under
``torch.profiler``, with spans around the driver's calls into each layer,
and the line carries the per-layer metrics; without, the end-to-end ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

# top-level module names that may not be loaded when the result is printed
BANNED_MODULES = ("jax", "jaxlib", "flax", "optax", "morefusion_tpu")


def process_start() -> float:
    """The wall time (``time.time()``) at which this process started, from
    its age in ``/proc`` (10 ms ticks); the import time of this module where
    ``/proc`` is missing."""
    try:
        with open("/proc/self/stat") as f:
            after = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(after[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - age
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


# ----------------------------------------------------------------- lookups


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in the file ``path`` (names may hold dots), loaded once
    a process."""
    key = "mfbench._loaded." + str(path).replace(".", "_").replace("/", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[key]
        raise
    return module


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with what its files hold."""

    name: str
    entry: dict  # BENCHMARK.json's entry
    spec: dict  # workloads/<name>.json
    config: dict  # configs/<config>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def params(self) -> dict:
        return self.spec["params"]

    @property
    def limits(self) -> dict:
        return self.spec["limits"]


def applies(metric: dict, cell: str, reported: Optional[set] = None) -> bool:
    """Whether ``metric`` is reported in ``cell``: the cells its
    ``workloads`` list, or without one every cell (a per-layer metric:
    every cell that reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if reported is not None:
        return metric["moves"] in reported
    return True


def load_cell(root: Path, name: str) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    base = root / "mfbench"
    spec = read_json(base / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json says {key} "
                             f"{spec[key]!r}, BENCHMARK.json {entry[key]!r}")
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[entry["config"]]["file"])
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m, name, reported)]
    return Cell(name=name, entry=entry, spec=spec, config=config,
                end_to_end=e2e, per_layer=per_layer)


# --------------------------------------------------------------- recording


@dataclasses.dataclass
class Record:
    """What a run recorded. ``units``: the host-clock ``(start, end)`` of
    each unit of work of the window (a train step's issue, a frame from
    hand-over to results on the host) with its ``size`` (crops, frames);
    ``spans``: host-clock seconds of each call into a layer, by layer;
    ``extra``: the driver's own numbers for the readers
    (shapes, counts of work); ``profile``: the traced stretch."""

    window_s: float = 0.0
    units: List[dict] = dataclasses.field(default_factory=list)
    failed: int = 0
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)
    profile: Optional["Profile"] = None


@dataclasses.dataclass
class Profile:
    """The traced stretch: its wall seconds, the units it held, the
    device's kernels and copies ``(name, start_us, end_us)``, the spans'
    ranges ``(name, start_us, end_us)`` and the host's kernel launches
    ``(name, start_us)``, on the profiler's clock."""

    window_s: float
    first: int
    units: int
    device_ops: list
    host_spans: list
    launches: list

    def busy_s(self) -> float:
        """Seconds with at least one operation on the device (the union of
        their intervals)."""
        total, end = 0.0, None
        for a, b in sorted((a, b) for _, a, b in self.device_ops):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total * 1e-6

    def op_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(b - a for n, a, b in self.device_ops if match(n)) * 1e-6

    def launches_in(self, span: str) -> int:
        """Host launches of kernels inside the spans named ``span``."""
        ranges = [(a, b) for n, a, b in self.host_spans if n == span]
        return sum(1 for _, t in self.launches
                   if any(a <= t <= b for a, b in ranges))

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the 10 longest
        idle gaps of the device, each named by the innermost span the host
        was in when the gap began."""
        by_name: Dict[str, float] = {}
        for n, a, b in self.device_ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = []
        end = None
        for _, a, b in sorted(self.device_ops, key=lambda e: e[1]):
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:10]:
            inside = [(s, e, n) for n, s, e in self.host_spans if s <= a <= e]
            name = (min(inside, key=lambda r: r[1] - r[0])[2] if inside
                    else "outside the spans")
            named.append([name, (b - a) * 1e-6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


class Tracer:
    """What a driver calls around its work. ``span(name)`` times a call
    into a layer (host clock) in a traced run and marks it for the
    profiler; ``unit(i)`` wraps unit ``i`` of the window and runs units
    ``[start, start + count)`` under ``torch.profiler``. In an untraced run
    both cost nothing. The profiler is started once before the window
    (``warm``), so that its start-up falls outside it; its events are read
    after the window (``finish``). ``record.extra["stretch"]`` keeps the
    traced units and the window's seconds spent on them, profiler included,
    for the readers of rates to leave out."""

    def __init__(self, record: Record, enabled: bool, device,
                 stretch=(0, 0)):
        self.record = record
        self.enabled = enabled
        self.device = device
        self.start, self.count = stretch
        self._prof = None
        self._done = None
        self._t0 = self._wall = 0.0
        self.active = False  # spans are kept inside the window only

    @contextlib.contextmanager
    def span(self, name: str):
        if not (self.enabled and self.active):
            yield
            return
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(name):
            yield
        self.record.spans.setdefault(name, []).append(
            time.perf_counter() - t0)

    @contextlib.contextmanager
    def unit(self, i: int):
        if self.enabled and i == self.start and self.count:
            self._begin()
        yield
        if self._prof is not None and i == self.start + self.count - 1:
            self._end()

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def warm(self):
        """Start and stop the profiler once, outside the window."""
        import torch

        if not self.enabled:
            return
        with self._profiler():
            torch.ones(8, device=self.device).sum()
            self._sync()

    def _begin(self):
        self._t_enter = time.perf_counter()
        self._sync()
        self._prof = self._profiler()
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def _end(self):
        self._sync()
        self._wall = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.record.extra["stretch"] = {
            "first": self.start, "units": self.count,
            "seconds": time.perf_counter() - self._t_enter}
        self._done, self._prof = self._prof, None

    def finish(self):
        """After the window: close a profile the window ended inside of,
        and reduce the profiler's events."""
        from torch.autograd import DeviceType

        if self._prof is not None:
            self.count = max(1, len(self.record.units) - self.start)
            self._end()
        if self._done is None:
            return
        spans = set(self.record.spans)
        device_ops, host_spans, launches = [], [], []
        for e in self._done.events():
            r = e.time_range
            if e.name in spans or getattr(e, "is_user_annotation", False):
                # the spans' own ranges, on the host and on the device's
                # timeline: no operation of the device
                if e.device_type != DeviceType.CUDA:
                    host_spans.append((e.name, r.start, r.end))
            elif e.device_type == DeviceType.CUDA:
                device_ops.append((e.name, r.start, r.end))
            elif "LaunchKernel" in e.name:
                launches.append((e.name, r.start))
        self.record.profile = Profile(
            window_s=self._wall, first=self.start, units=self.count,
            device_ops=device_ops, host_spans=host_spans,
            launches=launches)
        self._done = None


@dataclasses.dataclass
class Context:
    """What a driver is handed."""

    root: Path
    cell: Cell
    seed: int
    device: object  # torch.device
    record: Record
    tracer: Tracer


# ----------------------------------------------------------------- the run


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (linear between order statistics)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = (len(xs) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def median(values) -> float:
    return statistics.median(values)


def read_metrics(cell: Cell, run, section: str) -> dict:
    """Each metric of ``section`` (``end_to_end`` or ``layer_metrics``) its
    reader finds something for, as ``{name: {value, unit}}``."""
    entries = cell.end_to_end if section == "end_to_end" else cell.per_layer
    out = {}
    for m in entries:
        if m["name"] == "setup_s":
            value = run.setup_s
        else:
            path = run.root / "mfbench" / section / f"{m['name']}.py"
            value = load_module(path, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


@dataclasses.dataclass
class Run:
    """What readers get: the cell, the record, the set-up seconds."""

    root: Path
    cell: Cell
    record: Record
    setup_s: float


def loaded_banned() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED_MODULES))


def execute(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, device, *, started: Optional[float] = None,
            cell: Optional[Cell] = None):
    """Run one cell once; returns ``(result, checks)``: the result line's
    object (without its ``checks`` key) and the compared numbers
    ``[(name, value, limit)]``. ``cell`` overrides the files' cell (the
    tests run cells at a tiny size on the CPU this way)."""
    import torch

    started = process_start() if started is None else started
    cell = load_cell(root, workload) if cell is None else cell
    driver = load_module(root / "mfbench" / "drivers"
                         / f"{cell.spec['driver']}.py", cell.spec["driver"])
    record = Record()
    tracer = Tracer(record, trace, device,
                    tuple(cell.params.get("trace_units", (0, 0))))
    ctx = Context(root=root, cell=cell, seed=seed, device=device,
                  record=record, tracer=tracer)
    state = driver.setup(ctx)
    setup_s = time.time() - started
    tracer.warm()
    tracer.active = True
    driver.window(state, ctx, seconds)
    tracer.active = False
    tracer.finish()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    run = Run(root=root, cell=cell, record=record, setup_s=setup_s)
    metrics = read_metrics(cell, run,
                           "layer_metrics" if trace else "end_to_end")
    got = driver.answers(state, ctx)
    checks = driver.compare(got, driver.reference(state, ctx, got), ctx)
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": len(record.units),
              "failed": int(record.failed), "metrics": metrics,
              "device": dev}
    if trace and record.profile is not None:
        dev["busy_s"] = record.profile.busy_s()
        dev["window_s"] = record.profile.window_s
        result["breakdown"] = record.profile.breakdown()
    return result, checks
