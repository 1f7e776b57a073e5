"""Roofline cost model + tuning cache — the profitability layer for
``map_parallelism`` and ``fuse_elementwise`` (the model half of the
reference's ``repro.core.costmodel``, free of JAX).

* :class:`MachinePeaks` — machine ceilings (streaming bandwidth,
  scratch-tier bandwidth, dense-matmul flops, per-launch overhead),
  read from a fingerprinted JSON under the tune-cache directory when a
  peaks run has written one, else the documented defaults below.
* :class:`CostModel` — ``t(candidate) = max(bytes_moved / bandwidth,
  flops / peak) + launches * launch_overhead`` over the declared
  :class:`~repro_torch.core.backend.ParallelHierarchy`; a hierarchy that
  declares its own ceilings (the H100 record does) is modeled with them.
* :class:`TuneCache` — persisted autotune decisions.  The measurement
  itself (:func:`measure_callable`) waits for the autotune port.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
from typing import Callable, Optional, Sequence

# Bump when cost formulas change: stale tuning-cache entries keyed on an
# older model must not survive a formula change.
MODEL_VERSION = 1

# A launch cheaper than this is not a real dispatch boundary: the
# runtime jit-traces the "launches" into one program and fuses through
# them, so neither launch overhead nor intermediate round-trips can be
# saved by fusing ourselves (the downstream compiler already did).
JIT_LAUNCH_ELISION_S = 1e-7

# ---------------------------------------------------------------------------
# machine peaks — measured once per host, fingerprinted, persisted
# ---------------------------------------------------------------------------

# Data-driven defaults for a desktop-class host, used until
# `python -m benchmarks.machine_peaks` persists a measurement for this
# host's fingerprint.  These are deliberately conservative; they are the
# ONLY hardcoded performance constants outside backend hierarchy
# declarations (CI lint enforces this).
DEFAULT_PEAKS = {
    "bandwidth_bytes_per_s": 2.0e10,          # streaming main memory
    "scratch_bandwidth_bytes_per_s": 2.0e11,  # cache/scratch tier
    "flops_per_s": 5.0e10,                    # dense f32 matmul
    "launch_overhead_s": 5.0e-6,              # one real kernel dispatch
    "dispatch_overhead_s": 5.0e-6,            # one host->runtime call
}


@dataclasses.dataclass(frozen=True)
class MachinePeaks:
    """Measured (or default) machine ceilings the roofline model divides
    by.  ``measured=False`` marks the documented defaults."""

    bandwidth_bytes_per_s: float
    scratch_bandwidth_bytes_per_s: float
    flops_per_s: float
    launch_overhead_s: float
    dispatch_overhead_s: float
    fingerprint: str = ""
    measured: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MachinePeaks":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def machine_fingerprint() -> str:
    """Stable id of this host+runtime: peaks measured on one machine must
    never be trusted on another (or after a torch/CUDA change).  The card's
    name enters the id when one is present."""
    import torch
    card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")
    raw = "|".join([platform.machine(), platform.system(),
                    platform.processor() or "-",
                    str(os.cpu_count()), torch.__version__,
                    str(torch.version.cuda), card])
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def cache_dir() -> str:
    """Tuning-cache root: ``$REPRO_TUNE_CACHE`` or ``~/.cache/repro-tune``."""
    return os.environ.get("REPRO_TUNE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-tune")


def _peaks_path(root: Optional[str] = None) -> str:
    return os.path.join(root or cache_dir(),
                        f"machine_peaks_{machine_fingerprint()}.json")


_PEAKS_MEMO: dict = {}


def default_peaks() -> MachinePeaks:
    return MachinePeaks(fingerprint=machine_fingerprint(), measured=False,
                        **DEFAULT_PEAKS)


def load_peaks(root: Optional[str] = None) -> MachinePeaks:
    """The persisted measurement for this host fingerprint, else the
    documented defaults.  Never measures — measurement is an explicit,
    potentially multi-second act (``python -m benchmarks.machine_peaks``)."""
    path = _peaks_path(root)
    memo = _PEAKS_MEMO.get(path)
    if memo is not None:
        return memo
    peaks = default_peaks()
    if os.path.exists(path):
        try:
            with open(path) as f:
                peaks = MachinePeaks.from_dict(json.load(f))
        except (OSError, ValueError, TypeError):
            peaks = default_peaks()   # unreadable cache ≠ broken compile
    _PEAKS_MEMO[path] = peaks
    return peaks


# ---------------------------------------------------------------------------
# per-op arithmetic intensity (flops per element; counts, not machine data)
# ---------------------------------------------------------------------------

_FLOPS_PER_ELEM = {
    "linalg.tanh": 8.0, "linalg.sigmoid": 8.0, "linalg.exp": 8.0,
    "linalg.gelu": 12.0, "linalg.silu": 10.0, "linalg.sqrt": 4.0,
    "linalg.rsqrt": 4.0, "linalg.softmax": 12.0, "linalg.power": 8.0,
}


def flops_per_elem(opname: str) -> float:
    """Flop count per output element for an elementwise/reduction op
    (transcendentals expand to polynomial evaluations; everything else
    is ~one op per element)."""
    return _FLOPS_PER_ELEM.get(opname, 1.0)


# ---------------------------------------------------------------------------
# the roofline model
# ---------------------------------------------------------------------------

class CostModel:
    """Roofline-style time estimates over one declared hierarchy.

    Every quantity resolves hierarchy-first: a backend that declared
    ``bandwidth_bytes_per_s`` / ``flops_per_s`` / ``launch_overhead_s``
    on its :class:`~repro_torch.core.backend.ParallelHierarchy` is modeled with
    its own architecture's numbers; fields left ``None`` inherit the
    measured host peaks (or the documented defaults)."""

    def __init__(self, hierarchy, peaks: Optional[MachinePeaks] = None):
        self.hierarchy = hierarchy
        self.peaks = peaks if peaks is not None else load_peaks()

    @classmethod
    def for_options(cls, options) -> "CostModel":
        return cls(options.resolve_hierarchy())

    # -- resolved ceilings --------------------------------------------------
    @property
    def bandwidth(self) -> float:
        declared = getattr(self.hierarchy, "bandwidth_bytes_per_s", None)
        return declared if declared else self.peaks.bandwidth_bytes_per_s

    @property
    def scratch_bandwidth(self) -> float:
        # the scratch tier (VMEM / shared memory / cache) is modeled as a
        # fixed multiple faster unless the host measured its own
        ratio = (DEFAULT_PEAKS["scratch_bandwidth_bytes_per_s"] /
                 DEFAULT_PEAKS["bandwidth_bytes_per_s"])
        declared = getattr(self.hierarchy, "bandwidth_bytes_per_s", None)
        if declared:
            return declared * ratio
        return self.peaks.scratch_bandwidth_bytes_per_s

    @property
    def flops(self) -> float:
        declared = getattr(self.hierarchy, "flops_per_s", None)
        return declared if declared else self.peaks.flops_per_s

    @property
    def launch_overhead(self) -> float:
        declared = getattr(self.hierarchy, "launch_overhead_s", None)
        if declared is not None:          # 0.0 is a meaningful declaration
            return declared
        return self.peaks.launch_overhead_s

    # -- the roofline -------------------------------------------------------
    def roofline(self, bytes_moved: float, flops: float,
                 launches: int = 1, scratch_bytes: float = 0.0) -> float:
        """Seconds: max(memory time, compute time) + launch overhead.
        ``scratch_bytes`` is traffic that stays in the fast tier (fused
        intermediates), charged at scratch bandwidth."""
        mem = (bytes_moved / self.bandwidth +
               scratch_bytes / self.scratch_bandwidth)
        comp = flops / self.flops
        return max(mem, comp) + launches * self.launch_overhead

    # -- fusion profitability (fuse_elementwise's gate) ---------------------
    def fusion_gate(self, producer, consumer) -> bool:
        """True iff merging ``producer`` into ``consumer`` is predicted to
        beat the two separate launches: the saving is one launch overhead
        plus the fused edge's round-trip (write + re-read) moving from
        main memory to the scratch tier.

        When the effective per-launch overhead is below
        :data:`JIT_LAUNCH_ELISION_S` the "launches" are jit-traced into
        one program — the runtime fuses through op boundaries anyway, so
        neither term is really saved and the strict-improvement gate says
        no (this is exactly what ``BENCH_fusion.json`` measured on the
        host backends: launches 12→1 with flat-to-worse wall time)."""
        overhead = self.launch_overhead
        if overhead <= JIT_LAUNCH_ELISION_S:
            return False
        edge = producer.results[0].type
        edge_bytes = float(edge.nbytes)
        saved = overhead + 2.0 * edge_bytes * (1.0 / self.bandwidth -
                                               1.0 / self.scratch_bandwidth)
        return saved > 0.0

    # -- per-decision cost functions (candidates come from passes.py) -------
    def matmul_cost(self, m: int, n: int, k: int, itemsize: int,
                    tiling: dict) -> float:
        """Blocked matmul: each (bm×bn) output tile streams a (bm×bk) A
        tile and a (bk×bn) B tile per k-step, so A is re-read ceil(n/bn)
        times and B ceil(m/bm) times; padding to block multiples wastes
        both traffic and flops."""
        bm, bn, bk = (max(int(tiling[x]), 1) for x in ("bm", "bn", "bk"))
        gm, gn, gk = -(-m // bm), -(-n // bn), -(-k // bk)
        mp, np_, kp = gm * bm, gn * bn, gk * bk
        bytes_moved = float(mp * kp * gn + kp * np_ * gm) * itemsize \
            + 2.0 * mp * np_ * itemsize
        flops = 2.0 * mp * np_ * kp
        return self.roofline(bytes_moved, flops, launches=1)

    def map_cost(self, shape: Sequence[int], itemsize: int,
                 n_operands: int, tiling: dict,
                 flops_per_elem: float = 1.0,
                 n_scratch_bufs: int = 0) -> float:
        """Blocked elementwise nest: every operand and the result stream
        once per padded element; fused-region intermediates
        (``n_scratch_bufs``) stay in the scratch tier; each grid step
        beyond the first costs one launch-overhead on architectures whose
        outer level is a real dispatch."""
        if not shape:
            return self.roofline(itemsize * (n_operands + 1), flops_per_elem)
        block = tuple(max(int(b), 1)
                      for b in (tiling.get("block") or shape))
        grid = tiling.get("grid") or tuple(
            -(-s // b) for s, b in zip(shape, block))
        padded = 1.0
        for g, b in zip(grid, block):
            padded *= g * b
        bytes_moved = padded * itemsize * (n_operands + 1)
        scratch = padded * itemsize * max(n_scratch_bufs, 0)
        flops = padded * flops_per_elem
        n_tiles = 1
        for g in grid:
            n_tiles *= g
        return self.roofline(bytes_moved, flops, launches=n_tiles,
                             scratch_bytes=scratch)

    def spmv_cost(self, n_rows: int, nnz_mean: float, itemsize: int,
                  tiling: dict, n_cols_dense: int = 1) -> float:
        """ELL-style row-block SpMV/SpMM: padded storage (row_width per
        row) streams values + column indices + gathered dense entries;
        padding beyond the true nnz is pure waste the model charges."""
        width = max(int(tiling.get("row_width", 8)), 1)
        rb = max(int(tiling.get("row_block", max(n_rows, 1))), 1)
        padded = float(max(n_rows, 1)) * width
        bytes_moved = padded * (itemsize + 4 + itemsize * n_cols_dense) \
            + float(max(n_rows, 1)) * itemsize * n_cols_dense
        flops = 2.0 * padded * n_cols_dense
        n_tiles = -(-max(n_rows, 1) // rb)
        return self.roofline(bytes_moved, flops, launches=n_tiles)

    # -- ranking ------------------------------------------------------------
    def rank(self, candidates: Sequence[dict],
             cost_fn: Callable) -> list:
        """Candidates sorted by predicted cost, stable on generation
        order (the default heuristic is always candidate 0, so ties keep
        it — cache determinism)."""
        scored = [(cost_fn(c), i, c) for i, c in enumerate(candidates)]
        scored.sort(key=lambda t: (t[0], t[1]))
        return [(cost, cand) for cost, _, cand in scored]


# ---------------------------------------------------------------------------
# measurement (autotune's measure-verify step)
# ---------------------------------------------------------------------------

# Counters the cache-hit tests and autotune_bench read: a cache hit must
# show zero re-search (no new measurements).
CACHE_STATS = {"hits": 0, "misses": 0, "measured": 0}


def reset_cache_stats() -> dict:
    snap = dict(CACHE_STATS)
    for k in CACHE_STATS:
        CACHE_STATS[k] = 0
    return snap


def measure_callable(fn: Callable, args: tuple, reps: int = 3,
                     rounds: int = 3) -> float:
    """Autotune's measure-verify step.  Timing on the card (CUDA events
    around the candidate) arrives with the autotune port; until then a
    compile that asks to measure fails here instead of guessing."""
    raise NotImplementedError(
        "autotune measurement is not ported to the torch backends yet")


# ---------------------------------------------------------------------------
# the tuning cache
# ---------------------------------------------------------------------------

class TuneCache:
    """Persisted per-(backend, op, shape, hierarchy-fingerprint) tuning
    decisions under :func:`cache_dir` (override via ``REPRO_TUNE_CACHE``
    or ``CompileOptions.tune_cache_dir``).  One JSON file per key; a hit
    replays the stored tiling and cost attrs verbatim so repeat compiles
    are free and produce identical IR."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or cache_dir()

    @classmethod
    def for_options(cls, options) -> "TuneCache":
        return cls(getattr(options, "tune_cache_dir", None))

    def key(self, backend_name: str, opname: str,
            shapes: Sequence, hierarchy) -> str:
        sig = json.dumps([backend_name, opname, list(map(list, shapes)),
                          hierarchy.to_dict(), MODEL_VERSION],
                         sort_keys=True)
        digest = hashlib.sha1(sig.encode()).hexdigest()[:20]
        return f"{backend_name}__{opname.replace('.', '_')}__{digest}"

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    def get(self, key: str) -> Optional[dict]:
        path = self._path(key)
        if not os.path.exists(path):
            CACHE_STATS["misses"] += 1
            return None
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            CACHE_STATS["misses"] += 1
            return None
        CACHE_STATS["hits"] += 1
        return rec

    def put(self, key: str, record: dict) -> str:
        path = self._path(key)
        os.makedirs(self.root, exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=2, sort_keys=True)
        return path


def _json_tiling(t: dict) -> dict:
    """Round-trip-stable tiling attrs: JSON turns tuples into lists, so
    normalize tuples up front — a cache hit must reproduce the exact
    in-IR representation of the compile that filled it."""
    out = {}
    for k, v in t.items():
        if isinstance(v, (tuple, list)):
            out[k] = tuple(int(x) for x in v)
        elif isinstance(v, bool):
            out[k] = v
        elif isinstance(v, float):
            out[k] = v
        else:
            out[k] = int(v)
    return out
