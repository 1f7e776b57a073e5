"""Pluggable execution backends — the repro analogue of LAPIS's Kokkos
backends (paper §3: "a dialect built on the principles of the Kokkos
ecosystem allows extensibility of the framework to new architectures").

A :class:`Backend` bundles everything the compiler needs to know about one
architecture / lowering strategy:

* a **name** (``"torch"``, ``"cuda"``, ``"loops"``, …) used as the value of
  ``CompileOptions.target``;
* **capability flags** (``"library"``, ``"custom-kernels"``,
  ``"loop-nests"``, ``"sparse"``, ``"ell-layout"``, …) that passes query
  instead of comparing target strings — e.g. the ``sparsify`` pass lowers
  sparse-encoded linalg ops only for backends declaring ``sparse``, and
  inserts the CSR→ELL ``sparse.convert`` only for ``ell-layout`` backends;
* a declarative :class:`ParallelHierarchy` — the physical parallelism and
  memory geometry of the architecture (level names, widths, scratch
  budget, matmul unit).  The ``map_parallelism`` pass reads it to bind
  logical ``kokkos.*`` nests and tiling heuristics to this backend; a new
  architecture is a new *mapping*, declared here, never a new pass;
* a **pipeline spec** — the ordered pass names ``PassManager`` runs for this
  backend (the per-target lowering composition of the paper's Table 4.2);
* **per-op kernel registrations** in a central ``opname → {backend: fn}``
  table (:func:`register_kernel`), the Kokkos-Kernels interception surface;
* an optional **selector hook** implementing a cost/choice model per op
  (the linalg-to-kokkoskernels library-vs-generated-loops decision);
* an optional **op executor hook** letting the backend claim whole IR ops
  at emit time (how the ``loops`` reference backend interprets mapped
  ``kokkos.*_parallel`` nests without kernels).

Backends register themselves via :func:`register_backend`; third-party
backends live in the ``repro_torch.backends`` plugin package, which
:func:`load_plugins` imports on first use.  All registration paths are
idempotent (module-import semantics — no mutable "loaded" flags), so test
re-imports and repeated ``available_targets()`` calls are safe.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional, Sequence

# The default pass pipeline (resolved by repro_torch.core.passmgr at run time).
# One pipeline for every backend: lowering to the logical ``kokkos.*``
# dialect is backend-neutral, and the per-target divergence lives entirely
# in ``map_parallelism`` reading each backend's ParallelHierarchy (library
# backends collapse nests to fused ``kk.*``-style calls, loop backends get
# physical level bindings).  The seed kept two hand-maintained pipelines
# (TENSOR vs LOWERED) to encode that difference structurally.
DEFAULT_PIPELINE = ("fuse_elementwise", "sparsify", "paged_to_kokkos",
                    "linalg_to_library", "linalg_to_parallel",
                    "map_parallelism", "memory_space_management")


# ---------------------------------------------------------------------------
# ParallelHierarchy — the declarative per-architecture parallelism spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """One physical level of a backend's parallel hierarchy.

    ``width`` is the alignment unit a block extent should be a multiple
    of along this level (a GPU warp is 32; a TPU lane 128, sublane 8);
    ``max_extent`` caps a single block's extent (None =
    unbounded, e.g. a grid dimension)."""

    name: str
    width: int = 1
    max_extent: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ParallelHierarchy:
    """Declarative description of one architecture's parallelism — what
    the paper's Kokkos backends give LAPIS for free and the seed
    hard-coded as ``lane_width``/``sublane_width`` compile options.

    ``levels`` runs outermost → innermost.  ``exec_space`` names where
    mapped nests execute (``device``/``host``); ``scratch_bytes`` is the
    fast-memory budget one team may hold (GPU shared memory per block);
    ``compute_unit`` the matmul tile edge.
    The tiling heuristics in ``repro_torch.core.passes`` read ONLY this record,
    so retargeting them is declaring a new hierarchy, not editing a pass.
    """

    exec_space: str = "device"
    levels: tuple = ()
    scratch_bytes: int = 96 * 2**20
    compute_unit: int = 128
    # Performance ceilings the roofline cost model divides by
    # (repro_torch.core.costmodel).  ``None`` means "inherit the measured
    # host peaks" (``python -m repro_torch.benchmarks.machine_peaks``) —
    # the right default for host backends; a device backend declares its
    # architecture's numbers as data here.  ``launch_overhead_s=0.0`` is a
    # meaningful declaration: it says this backend's "launches" are
    # jit-traced into one program (no real dispatch boundary), so fusion
    # can't save launch overhead.
    bandwidth_bytes_per_s: Optional[float] = None
    flops_per_s: Optional[float] = None
    launch_overhead_s: Optional[float] = None

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def level_names(self) -> tuple:
        """Physical level names, outermost → innermost.  The dialect
        verifier (repro_torch.core.analysis) accepts exactly these names (plus
        ``"fused"``) in a ``level_map`` attr — a new backend legalizes
        its names by declaring levels, never by editing the verifier."""
        return tuple(s.name for s in self.levels)

    @property
    def vector_width(self) -> int:
        """Innermost (vector/lane) alignment width."""
        return self.levels[-1].width if self.levels else 1

    @property
    def team_width(self) -> int:
        """Second-innermost (team/sublane) alignment width."""
        return self.levels[-2].width if self.depth >= 2 else 1

    def map_levels(self, nest: Sequence[str]) -> tuple:
        """Bind a logical nest (outer→inner level names) to this
        hierarchy's physical level names.  The innermost logical level
        lands on the innermost physical level and so on outward; when
        the logical nest is deeper than the hierarchy, the extra outer
        logical levels all collapse onto the outermost physical level
        (a league deeper than the grid is still grid steps)."""
        if not self.levels:
            return ("fused",) * len(nest)
        phys = [s.name for s in self.levels]
        out = []
        for i, _ in enumerate(nest):
            j = len(phys) - (len(nest) - i)
            out.append(phys[max(j, 0)])
        return tuple(out)

    # -- declarative round-trip (plugins may ship hierarchies as data) ------
    def to_dict(self) -> dict:
        d = {"exec_space": self.exec_space,
             "scratch_bytes": self.scratch_bytes,
             "compute_unit": self.compute_unit,
             "levels": [dataclasses.asdict(s) for s in self.levels]}
        # perf ceilings only when declared — keeps the dict shape (and the
        # tuning-cache keys of) hierarchies that inherit host peaks stable
        for f in ("bandwidth_bytes_per_s", "flops_per_s",
                  "launch_overhead_s"):
            v = getattr(self, f)
            if v is not None:
                d[f] = v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ParallelHierarchy":
        return cls(exec_space=d.get("exec_space", "device"),
                   scratch_bytes=d.get("scratch_bytes", 96 * 2**20),
                   compute_unit=d.get("compute_unit", 128),
                   levels=tuple(LevelSpec(**s) for s in d.get("levels", ())),
                   bandwidth_bytes_per_s=d.get("bandwidth_bytes_per_s"),
                   flops_per_s=d.get("flops_per_s"),
                   launch_overhead_s=d.get("launch_overhead_s"))


    def summary(self) -> str:
        """One-line human summary (``--list-backends``, docs)."""
        def lv(s: LevelSpec) -> str:
            bits = []
            if s.width != 1:
                bits.append(f"w{s.width}")
            if s.max_extent is not None:
                bits.append(f"<={s.max_extent}")
            return s.name + (f"({','.join(bits)})" if bits else "")
        levels = " -> ".join(lv(s) for s in self.levels) or "flat"
        mib = self.scratch_bytes / 2**20
        scratch = (f"{mib:g}MiB" if mib >= 1
                   else f"{self.scratch_bytes // 1024}KiB")
        return (f"{self.exec_space} | {levels} | scratch {scratch} | "
                f"unit {self.compute_unit}")


# ---------------------------------------------------------------------------
# TranslateTarget — per-backend C++ spelling for lapis-translate
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TranslateTarget:
    """How ``lapis-translate`` (:mod:`repro_torch.core.translate`) spells
    this backend's types and policies in emitted Kokkos C++.  A backend
    overrides the spelling by declaring one (``Backend.translate_target``)
    — e.g. the ``openmp`` backend emits ``Kokkos::OpenMP`` nests; a host
    hierarchy defaults to ``Kokkos::Serial`` and a device one to
    ``Kokkos::DefaultExecutionSpace``, so the same unit retargets at
    Kokkos configure time."""

    exec_space: str = "Kokkos::DefaultExecutionSpace"
    layout: str = "Kokkos::LayoutRight"


# The H100 geometry, declared as data: a grid of thread blocks (CTAs),
# rows of a block tile in multiples of 8, and 32-lane warps innermost.
# `scratch_bytes` is the shared memory one block may opt into on sm_90
# (227 KiB).  `compute_unit` is the 64-row edge of a Hopper warpgroup
# MMA tile.  The ceilings are NVIDIA data-sheet values for the SXM part
# (HBM3 3.35 TB/s, 67 TFLOP/s of FP32 outside the tensor cores, which is
# what the hand kernels run) and a typical CUDA launch cost — data-sheet
# numbers until a measured peaks run on the card replaces them.
H100_HIERARCHY = ParallelHierarchy(
    exec_space="device",
    levels=(LevelSpec("grid"),
            LevelSpec("block", width=8, max_extent=1024),
            LevelSpec("warp", width=32, max_extent=1024)),
    scratch_bytes=232_448,
    compute_unit=64,
    bandwidth_bytes_per_s=3.35e12,
    flops_per_s=6.7e13,
    launch_overhead_s=4.0e-6)

# Ops for which the library path is known hand-optimized (paper: "operations
# that we know are hand-optimized" get intercepted with library calls).
LIBRARY_PREFERRED = {"kk.gemm", "kk.gemv", "kk.batched_gemm", "kk.conv2d"}

# Backend every selection chain ends on: the library path can execute any op.
DEFAULT_FALLBACK = "torch"

PLUGIN_PACKAGE = "repro_torch.backends"

_BACKENDS: dict = {}             # name -> Backend
_KERNELS: dict = {}              # opname -> {backend name: fn}


class UnknownBackendError(KeyError):
    """Raised when ``CompileOptions.target`` names no registered backend."""


@dataclasses.dataclass
class Backend:
    """One execution backend (a Kokkos backend analogue).

    ``selector``, ``op_executor`` and ``kernel_predicate`` are plain
    callables rather than subclass methods so a backend is a declarative
    record a plugin can assemble without inheriting from core classes.
    """

    name: str
    description: str = ""
    capabilities: frozenset = frozenset()
    pipeline: tuple = DEFAULT_PIPELINE
    hierarchy: ParallelHierarchy = H100_HIERARCHY
    fallbacks: tuple = ()                    # tried in order after `name`
    loader: Optional[Callable] = None        # imports kernel modules (idempotent)
    selector: Optional[Callable] = None      # (backend, opname, options) -> name
    op_executor: Optional[Callable] = None   # (op, options) -> callable | None
    kernel_predicate: Optional[Callable] = None  # (options) -> bool
    translate_target: Optional[TranslateTarget] = None  # C++ spelling hook

    def ensure_loaded(self) -> None:
        """Run the deferred kernel-module import.  Loaders import modules,
        so repeated calls are no-ops via ``sys.modules`` — no flag state."""
        if self.loader is not None:
            self.loader()

    def kernel(self, opname: str) -> Optional[Callable]:
        return _KERNELS.get(opname, {}).get(self.name)

    def registered_ops(self) -> list:
        self.ensure_loaded()
        return sorted(op for op, impls in _KERNELS.items()
                      if self.name in impls)

    def fallback_chain(self) -> tuple:
        """Selection order for this backend's ops: itself, its declared
        fallbacks, then the library (which can execute any op)."""
        chain, seen = [], set()
        for name in (self.name,) + tuple(self.fallbacks) + (DEFAULT_FALLBACK,):
            if name not in seen:
                seen.add(name)
                chain.append(name)
        return tuple(chain)

    def select_impl(self, opname: str, options) -> str:
        """Pick the backend whose implementation of ``opname`` runs — the
        paper's library-call-vs-generated-code decision.  The default walks
        the fallback chain; a ``selector`` hook overrides it."""
        if self.selector is not None:
            return self.selector(self, opname, options)
        chain = self.fallback_chain()
        for name in chain:
            b = _BACKENDS.get(name)
            if b is None:
                continue
            b.ensure_loaded()
            if b.kernel(opname) is not None:
                return name
        return DEFAULT_FALLBACK

    def wants_kernels(self, options) -> bool:
        """Should model-facing wrappers (attention, rwkv6, …) run this
        backend's hand-written kernels instead of the plain torch
        versions?"""
        if self.kernel_predicate is not None:
            return self.kernel_predicate(options)
        return "custom-kernels" in self.capabilities

    def has_capability(self, cap: str) -> bool:
        return cap in self.capabilities

    def resolve_translate_target(self) -> TranslateTarget:
        """The C++ spelling lapis-translate uses for this backend: an
        explicit ``translate_target`` wins; otherwise host-space
        hierarchies spell ``Kokkos::Serial`` and device hierarchies the
        configure-time ``Kokkos::DefaultExecutionSpace``."""
        if self.translate_target is not None:
            return self.translate_target
        if self.hierarchy.exec_space == "host":
            return TranslateTarget(exec_space="Kokkos::Serial")
        return TranslateTarget()


# ---------------------------------------------------------------------------
# registration + lookup
# ---------------------------------------------------------------------------

def register_backend(backend: Backend) -> Backend:
    """Idempotent: re-registering a name replaces the entry, so plugin
    modules can run their registration at import time and survive
    re-imports."""
    _BACKENDS[backend.name] = backend
    return backend


def register_kernel(opname: str, backend_name: str,
                    fn: Optional[Callable] = None):
    """Register an implementation of ``opname`` for ``backend_name``.
    Usable directly or as a decorator; the backend need not be registered
    yet (kernel modules and backend plugins import in either order)."""
    if fn is None:
        def deco(f: Callable) -> Callable:
            _KERNELS.setdefault(opname, {})[backend_name] = f
            return f
        return deco
    _KERNELS.setdefault(opname, {})[backend_name] = fn
    return fn


def load_plugins() -> None:
    """Import the backend plugin package (idempotent via ``sys.modules``).
    Adding an architecture = dropping a module into ``repro_torch/backends/`` —
    core files never enumerate backend names."""
    importlib.import_module(PLUGIN_PACKAGE)


def get_backend(name: str) -> Backend:
    load_plugins()
    try:
        return _BACKENDS[name]
    except KeyError:
        raise UnknownBackendError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None


def resolve(target: str) -> Backend:
    """``CompileOptions.target`` string → Backend object."""
    return get_backend(target)


def available_backends() -> list:
    load_plugins()
    return sorted(_BACKENDS)


def all_backends() -> list:
    load_plugins()
    return [_BACKENDS[n] for n in sorted(_BACKENDS)]


def available_targets(opname: str) -> list:
    """All backend names with an implementation registered for ``opname``."""
    load_plugins()
    for b in _BACKENDS.values():
        b.ensure_loaded()
    return sorted(_KERNELS.get(opname, {}))


def kernel_callable(opname: str, impl_name: str, options) -> Callable:
    """Resolve ``opname`` on ``impl_name`` to a ready-to-call function,
    applying the fallback chain."""
    load_plugins()
    b = _BACKENDS.get(impl_name)
    if b is not None:
        b.ensure_loaded()
    table = _KERNELS.get(opname)
    if not table:
        for other in _BACKENDS.values():
            other.ensure_loaded()
        table = _KERNELS.get(opname)
        if not table:
            raise KeyError(f"no implementations registered for {opname}")
    fn = table.get(impl_name)
    if fn is None:
        chain = (b.fallback_chain() if b is not None
                 else (impl_name, DEFAULT_FALLBACK))
        for name in chain:
            fb = _BACKENDS.get(name)
            if fb is not None:
                fb.ensure_loaded()   # lazily-registered impls count too
            if name in table:
                fn = table[name]
                break
        else:
            # never silently run an arbitrary backend's kernel — a miss
            # here is a registration bug worth surfacing (seed parity)
            raise KeyError(
                f"no implementation of {opname} for backend "
                f"{impl_name!r} or its fallbacks {chain}; registered: "
                f"{sorted(table)}")
    return fn
