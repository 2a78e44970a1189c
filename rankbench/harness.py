"""Runs one cell of ``BENCHMARK.json`` and builds the contract's result.

Everything that belongs to one cell is found by name: the configuration
file named in ``configs``, the traffic mix ``traffic/<traffic>.json``
(whose ``generator`` names the general load in ``loads/``), and one
reader ``metrics/<name>.py`` for each per-layer metric. A cell or a
metric is added by adding such files and entries.

A run: set-up (the program built from the seed, its kernels loaded and
the cell's shapes warmed), then the measured window, then, once the
window has closed, the device's peak memory is read, the program's state
is freed and the answers are held to the plain reference
(``reference.py``). With ``trace`` the window runs under
``torch.profiler`` and the per-layer metrics are read from it.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load (the JAX package and JAX)
BANNED = ("jax", "jaxlib", "flax", "repro")
WINDOW_MARK = "rankbench.window"


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    and the metrics it reports."""

    def __init__(self, name: str, root: Path = ROOT):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        found = [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"({[w['name'] for w in spec['workloads']]})")
        self.name = name
        self.workload = found[0]
        conf = [c for c in spec["configs"]
                if c["name"] == self.workload["config"]][0]
        self.config = json.loads((root / conf["file"]).read_text())
        traffic = HERE / "traffic" / f"{self.workload['traffic']}.json"
        self.traffic = json.loads(traffic.read_text())
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]


def reader(name: str):
    """The ``read(obs)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "rankbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Tracer:
    """Host spans the benchmark records around its calls into the
    program: (name, start, end) on ``time.perf_counter``. Off, a span
    costs one ``nullcontext``; on, the main thread's spans also enter the
    profiler as ``record_function`` ranges."""

    def __init__(self, on: bool):
        self.on = on
        self.spans = []

    @contextlib.contextmanager
    def _span(self, name: str):
        import torch
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def span(self, name: str):
        return self._span(name) if self.on else contextlib.nullcontext()


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _device_events(prof):
    """(start_ns, end_ns, name, on_device) of every profiled event, from
    the profiler's raw records (user annotations left out)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if e.is_user_annotation() and (on_device or e.name() != WINDOW_MARK):
            continue
        out.append((e.start_ns(), e.end_ns(), e.name(), on_device))
    return out


def _labels(points, intervals):
    """For each of the sorted ``points``, the name of the latest-starting
    interval (start, end, name) that holds it, or None: one pass over the
    intervals sorted by start, keeping those still open."""
    intervals = sorted(intervals)
    out, open_, j = [], [], 0
    for t in points:
        while j < len(intervals) and intervals[j][0] <= t:
            open_.append(intervals[j])
            j += 1
        open_ = [iv for iv in open_ if iv[1] >= t]
        out.append(max(open_)[2] if open_ else None)
    return out


def summarize_trace(prof, tracer: Tracer, mark_perf: float):
    """What the per-layer readers and the breakdown need from a profile:
    the window's length, the device's busy seconds (every kernel, copy
    and memset once), the kernels' busy seconds, device seconds by
    operation, and the idle gaps named by what the host was doing: the
    innermost profiled host op (the main thread's), else the benchmark's
    innermost span, on any thread.

    The profiler's clock is tied to the host clock by the window's mark,
    a ``record_function`` entered at ``mark_perf``."""
    events = _device_events(prof)
    marks = [(s, e) for s, e, n, d in events if n == WINDOW_MARK and not d]
    if not marks:
        raise RuntimeError("the profiler lost the window's mark")
    w0, w1 = marks[0]
    inside = [(max(s, w0), min(e, w1), n) for s, e, n, d in events
              if d and e > w0 and s < w1]
    busy = _union((s, e) for s, e, _ in inside)
    kernels = _union((s, e) for s, e, n in inside if not _is_copy(n))
    by_op = {}
    for s, e, n in inside:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e9
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    mids = [(s + e) / 2 for s, e in gaps]
    ops = _labels(mids, [(s, e, n) for s, e, n, d in events
                         if not d and n != WINDOW_MARK])
    to_ns = lambda t: w0 + (t - mark_perf) * 1e9  # noqa: E731
    spans = _labels(mids, [(to_ns(s), to_ns(e), n)
                           for n, s, e in tracer.spans])
    idle = {}
    for (s, e), op, span in zip(gaps, ops, spans):
        label = op or (f"{span} (host between ops)" if span
                       else "host outside every span")
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": _length(busy) / 1e9,
        "kernel_s": _length(kernels) / 1e9,
        "device_ops": top(by_op),
        "idle_gaps": top(idle),
    }


def banned_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             control: bool = False, overrides: dict | None = None,
             root: Path = ROOT) -> dict:
    """One run of cell ``name``; returns the contract's result object
    (``checks`` last). ``control`` switches the program to its
    lower-precision path; ``overrides`` (tests only) shrink the load."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(name, root)
    import torch
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.init()
    imports_s = time.perf_counter() - t_start

    def sync():
        if cuda:
            torch.cuda.synchronize()

    gen = importlib.import_module(
        f"rankbench.loads.{cell.traffic['generator']}")
    load = gen.Load(cell.config, cell.traffic, seed, device,
                    control=control, **(overrides or {}))
    load.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    phases = dict({"imports and card": imports_s}, **load.phases)
    tracer = Tracer(trace)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        mark_perf = time.perf_counter()
        with torch.profiler.record_function(WINDOW_MARK):
            load.window(seconds, tracer)
            sync()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    obs = load.observations()
    summary = summarize_trace(prof, tracer, mark_perf) if trace else None
    obs["trace"] = summary if cuda else None
    e2e = dict(load.end_to_end(), setup_s=setup_s)
    load.release()
    checks = load.check()
    bad = load.failed
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(obs) if trace else e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(memory_peak)}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values())
           and bad == 0,
           "attempted": int(load.attempted), "failed": int(bad),
           "metrics": metrics, "device": dev}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["setup_phases_s"] = phases
    out["checks"] = checks
    return out
