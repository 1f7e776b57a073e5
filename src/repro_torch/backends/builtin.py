"""Built-in backends: ``torch`` (vendor library), ``cuda`` (hand-written
CUDA kernels) and ``auto`` (the paper's default per-op heuristic).

They register through the same plugin API any new architecture uses.

An eager kernel-backed op (``ops.matmul``, ``ops.gemv`` and the batched
``ops.matmul`` called outside tracing) is dispatched for the device its
tensors lie on, as the reference runs on any host: CPU tensors select on
the CPU (``auto`` then takes the library, ``cuda`` its kernels' plain
versions), CUDA tensors on the card, where ``cuda`` launches the kernel
or raises, and ``auto`` does so for every op outside
``LIBRARY_PREFERRED`` (all of them with ``prefer_library=False``).
Tensors on more than one device raise.  ``cuda`` never falls back to the
library where a kernel is registered.
"""
from __future__ import annotations

from repro_torch.core.backend import (Backend, H100_HIERARCHY,
                                      LIBRARY_PREFERRED, get_backend,
                                      register_backend)


def _load_kernels() -> None:
    # registers both the torch ("vendor library") and cuda implementations
    # of every kk.* op; idempotent via sys.modules
    import repro_torch.kernels.ops  # noqa: F401


def _on_card(options) -> bool:
    return options.resolve_device() == "cuda"


def _auto_select(backend: Backend, opname: str, options) -> str:
    """The reference's auto heuristic on the port's devices: the library
    for the known hand-optimized ops while ``prefer_library``; for the
    rest a hand kernel iff the module runs on the card and one is
    registered for ``opname`` (off the card the plain versions are a
    validation tool, not a performance path: auto stays on the
    library)."""
    if options.prefer_library and opname in LIBRARY_PREFERRED:
        return "torch"
    if not _on_card(options):
        return "torch"
    cuda = get_backend("cuda")
    cuda.ensure_loaded()
    return "cuda" if cuda.kernel(opname) is not None else "torch"


register_backend(Backend(
    name="torch",
    description="torch library path (torch.matmul → cuBLAS on the card; "
                "linalg-to-kokkoskernels analogue)",
    capabilities=frozenset({"library", "sparse"}),
    hierarchy=H100_HIERARCHY,    # same card; the library owns the mapping,
                                 # so map_parallelism collapses nests
    loader=_load_kernels,
))

register_backend(Backend(
    name="cuda",
    description="hand-written CUDA kernels for sm_90a (the pure-Kokkos "
                "lowering path); the library serves only ops with no "
                "kernel yet",
    # no "ell-layout": the SpMV / SpMM kernels read CSR directly, so the
    # sparsify pass inserts no per-call CSR→ELL sparse.convert
    capabilities=frozenset({"custom-kernels", "loop-nests", "sparse"}),
    hierarchy=H100_HIERARCHY,    # nests map onto grid × block × warp
    fallbacks=("torch",),
    loader=_load_kernels,
))

register_backend(Backend(
    name="auto",
    description="per-op heuristic: library for hand-optimized ops, "
                "kernels elsewhere when the module runs on the card",
    capabilities=frozenset({"library", "sparse"}),
    hierarchy=H100_HIERARCHY,
    fallbacks=("torch",),
    loader=_load_kernels,
    selector=_auto_select,
    kernel_predicate=_on_card,
))
