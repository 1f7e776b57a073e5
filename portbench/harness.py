"""One run of one cell: find its files by name, let its entry set up and
time the window, read the per-layer metrics, compare with the reference,
and build the result line.

The harness owns the window's bookkeeping (``Ctx.window``): the set-up
time (process start to the first timed call), the synchronised host
clock around the window, the profiler when ``--trace 1``, and the card's
peak memory, read as the window closes and before any reference runs.
An entry (``entries/<entry>.py``, named by the traffic file) owns what
it drives and how it is checked; it returns its end-to-end values, its
counts for the metric readers, and the numbers it compared, each with
its limit.

A cell's subject is its configuration's model or, where the traffic
names a ``call``, that compiled function at the configuration's widths:
``flops/<subject>.py`` counts its work and ``reference/<subject>.py``
recomputes it.  A per-layer metric ``<quantity>.<kind>`` is read by
``metrics/<quantity>.<kind>.py`` where that file exists, else by
``metrics/<quantity>.py``, which serves every kind.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import time
import types
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
PB = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None):
    """A module from a file whose name need not be an identifier
    (``reference/qwen2-1.5b.py``)."""
    name = name or "portbench_" + "".join(
        c if c.isalnum() else "_" for c in str(path.relative_to(PB)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names
                              else [])]
    return e2e, layer


def process_age() -> float:
    """Seconds since this process started (the kernel's start time of
    the process against the system's uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def card_state() -> dict:
    """The card's clocks, power, temperature and active clock-event
    reasons as ``nvidia-smi`` reads them (empty where it is missing): a
    run that reads far off can be told from a card that slowed."""
    tool = shutil.which("nvidia-smi")
    if tool is None:
        return {}
    base = ("clocks.sm", "clocks.mem", "power.draw", "power.limit",
            "temperature.gpu")
    for reasons in ("clocks_event_reasons.active",
                    "clocks_throttle_reasons.active"):
        keys = base + (reasons,)
        try:
            out = subprocess.run([tool, f"--query-gpu={','.join(keys)}",
                                  "--format=csv,noheader,nounits", "-i",
                                  "0"], capture_output=True, text=True,
                                 timeout=20)
        except (OSError, subprocess.TimeoutExpired):
            return {}
        vals = [v.strip() for v in out.stdout.split(",")]
        if out.returncode == 0 and len(vals) == len(keys):
            return dict(zip(keys, vals))
    return {}


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


class Ctx:
    """What an entry is given: the cell's files, seed, window length,
    device, and the window's bookkeeping."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", overrides: Optional[dict] = None,
                 control: bool = False):
        import torch
        self.torch = torch
        bench = benchmark()
        w = cell_entry(bench, cell)
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device = bool(trace), device
        self.config = load_json(PB / "configs" / f"{w['config']}.json")
        self.traffic = load_json(PB / "traffic" / f"{w['traffic']}.json")
        self.limits = load_json(PB / "limits" / f"{cell}.json")
        for key, val in (overrides or {}).items():
            if key == "limits":
                self.limits = dict(val)
            else:
                getattr(self, key).update(val)
        subject = self.traffic.get("call", w["config"])
        self.flops = load_module(PB / "flops" / f"{subject}.py")
        self.reference = load_module(PB / "reference" / f"{subject}.py")
        self.setup_s = self.window_s = None
        self.memory_peak_bytes = 0
        self.profile = None
        self.card = {}              # nvidia-smi's reading as the window ends
        self.control = control      # also read the fp8 control (control.py)

    def sync(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def span(self, name: str):
        """A named range in the profiler's trace (a no-op untraced)."""
        return self.torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends here, at the first timed
        call; the card is idle on entry and drained on exit."""
        torch = self.torch
        self.sync()
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.setup_s = process_age()
        prof = contextlib.nullcontext()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts = [ProfilerActivity.CUDA] + \
                    (acts if self.traffic.get("trace_host", True) else [])
            prof = profile(activities=acts)
        with prof as p:
            t0 = time.perf_counter()
            yield self
            self.sync()
            self.window_s = time.perf_counter() - t0
        self.profile = p if self.trace else None
        if self.device == "cuda":
            self.memory_peak_bytes = torch.cuda.max_memory_allocated()
            self.card = card_state()


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: its own file, or its
    quantity's (the name up to the first dot)."""
    own = PB / "metrics" / f"{metric}.py"
    return own if own.is_file() else \
        PB / "metrics" / f"{metric.split('.')[0]}.py"


def _reader_view(ctx: Ctx, data: dict, trace) -> types.SimpleNamespace:
    peaks = load_json(PB / "peaks.json")
    kind = device_kind(ctx)
    return types.SimpleNamespace(
        cell=ctx.cell, config=ctx.config, traffic=ctx.traffic,
        peak=peaks.get(kind), trace=trace,
        window_s=ctx.window_s, data=data)


def device_kind(ctx: Ctx) -> str:
    if ctx.device == "cuda":
        return ctx.torch.cuda.get_device_name(0)
    return "cpu"


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: Optional[dict] = None,
             control: bool = False) -> dict:
    """Run ``cell`` once; returns the result object (without printing).
    ``overrides`` replace keys of the config or traffic file, or the
    limits whole: the CPU tests drive whole runs at a small size so.
    ``control`` also reads the numbers compared with the fp8 reference
    in the program's place (under ``counters["control"]``)."""
    from portbench import devtrace
    ctx = Ctx(cell, seed, seconds, trace, device, overrides, control)
    entry = load_module(PB / "entries" / f"{ctx.traffic['entry']}.py")
    out = entry.run(ctx)
    bench = benchmark()
    e2e, layer = cell_metrics(bench, cell)
    metrics = {}
    breakdown = None
    tr = None
    if trace:
        tr = devtrace.Trace.from_profile(ctx.profile, ctx.window_s,
                                         on_card=device == "cuda")
        view = _reader_view(ctx, out["layer"], tr)
        for m in layer:
            val = load_module(reader_path(m["name"])).read(view)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
        breakdown = tr.breakdown()
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    checks = {name: {"value": float(v), "limit": float(lim)}
              for name, v, lim in out["checks"]}
    correct = bool(checks) and out["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": device_kind(ctx), "count": 1,
           "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["counters"] = dict(out.get("counters", {}), card=ctx.card)
    result["checks"] = checks
    return result
