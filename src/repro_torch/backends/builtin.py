"""Built-in backends: ``torch`` (vendor library), ``cuda`` (hand-written
CUDA kernels) and ``auto`` (kernels iff the compile targets the card).

They register through the same plugin API any new architecture uses.

An eager kernel-backed op (``ops.matmul``, ``ops.gemv`` and the batched
``ops.matmul`` called outside tracing) is dispatched for the device its
tensors lie on, as the reference runs on any host: CPU tensors select on
the CPU (``auto`` then takes the library, ``cuda`` its kernels' plain
versions), CUDA tensors on the card, where ``auto`` and ``cuda`` launch
the kernel or raise.  Tensors on more than one device raise.  A CUDA
tensor never falls back to the library where a kernel is registered.
"""
from __future__ import annotations

from repro_torch.core.backend import (Backend, H100_HIERARCHY, get_backend,
                                      register_backend)


def _load_kernels() -> None:
    # registers both the torch ("vendor library") and cuda implementations
    # of every kk.* op; idempotent via sys.modules
    import repro_torch.kernels.ops  # noqa: F401


def _on_card(options) -> bool:
    return options.resolve_device() == "cuda"


def _auto_select(backend: Backend, opname: str, options) -> str:
    """Hand kernels iff the module runs on the card and one is
    registered for ``opname``; the library otherwise."""
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
    description="per-op choice: hand kernels for kk.* ops when the module "
                "runs on the card, the library otherwise",
    capabilities=frozenset({"library", "sparse"}),
    hierarchy=H100_HIERARCHY,
    fallbacks=("torch",),
    loader=_load_kernels,
    selector=_auto_select,
    kernel_predicate=_on_card,
))
