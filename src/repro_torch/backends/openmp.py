"""``openmp`` backend — a new architecture declared purely as data.

This module is the end-to-end proof of the paper's extensibility claim
("a new architecture is a declaration, not a compiler edit"): it adds an
OpenMP-shaped host target to the whole pipeline — mapping, tiling,
static analysis, execution AND ``lapis-translate`` C++ emission — while
containing *no* logic of its own:

* the :class:`~repro_torch.core.backend.ParallelHierarchy` is a plain
  dict round-tripped through ``ParallelHierarchy.from_dict`` (the
  declarative serialization a plugin could just as well load from JSON).
  The ``map_parallelism`` pass binds ``kokkos.*`` nests to these level
  names, the dialect verifier accepts exactly them, and the tiling
  heuristics read the widths — all without knowing "openmp" exists;
* the C++ spelling is one :class:`~repro_torch.core.backend.
  TranslateTarget` datum: ``Kokkos::OpenMP``.  ``lapis-translate`` walks
  the same IR and prints the same nests; only the ``using lapis_exec =
  ...`` alias changes.  The emitted unit retargets to the OpenMP thread
  pool at Kokkos build time (and runs serially under the executable
  stub);
* execution reuses the ``loops`` serial-tile interpreter and kernel
  registrations via the fallback chain — zero new executor code.  Its
  tensors live where the compile's ``device`` says, as every backend's
  do.

Mirrors the OpenMP columns of the Godoy et al. Kokkos-portability
studies: same source, new execution space, selected by declaration.
"""
from __future__ import annotations

from repro_torch.backends.loops import loops_executor
from repro_torch.core.backend import (Backend, ParallelHierarchy,
                                      TranslateTarget, register_backend)

# The whole architecture, as data.  An OpenMP host: a league of thread
# teams over row blocks, simd lanes innermost.  Widths mirror the other
# host backend so tiling decisions stay comparable; launch_overhead_s=0.0
# because the "launches" are one host program, with no dispatch boundary
# for fusion to save.
OPENMP_HIERARCHY = {
    "exec_space": "host",
    "levels": [
        {"name": "omp-league"},
        {"name": "omp-thread", "width": 8, "max_extent": 512},
        {"name": "omp-simd", "width": 128, "max_extent": 1024},
    ],
    "scratch_bytes": 32 * 2**20,   # LLC-class per-team working set
    "compute_unit": 128,
    "launch_overhead_s": 0.0,
}

register_backend(Backend(
    name="openmp",
    description="OpenMP-shaped host backend declared purely as data "
                "(dict hierarchy + Kokkos::OpenMP translate spelling; "
                "executes via the loops serial-tile interpreter)",
    capabilities=frozenset({"loop-nests", "sparse", "ell-layout"}),
    hierarchy=ParallelHierarchy.from_dict(OPENMP_HIERARCHY),
    fallbacks=("loops", "torch"),
    op_executor=loops_executor,
    # the one line that retargets lapis-translate: data, not dispatch
    translate_target=TranslateTarget(exec_space="Kokkos::OpenMP"),
))
