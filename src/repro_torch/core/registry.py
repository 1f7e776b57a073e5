"""Kernel implementation registry — the repro analogue of Kokkos Kernels.

This module is now a thin facade over the pluggable backend layer
(``repro_torch.core.backend``): implementations register per backend name via
:func:`register`, and selection/dispatch delegate to the resolved
:class:`~repro_torch.core.backend.Backend`'s fallback chain and selector hook —
exactly the paper's choice between generating a portable Kokkos loop nest
and intercepting the op with a Kokkos Kernels library call (§4, Table 4.2),
but extensible to any registered backend instead of two hardcoded strings.

Kernel modules load lazily through each backend's ``loader`` (a module
import — idempotent via ``sys.modules``, replacing the old mutable
``_PALLAS_LOADED`` flag), so repeated ``available_targets()`` calls and
test re-imports are safe.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core import backend as _backend
from repro_torch.core.backend import LIBRARY_PREFERRED  # noqa: F401  (re-export)
from repro_torch.core.options import CompileOptions, current_options


def register(opname: str, target: str) -> Callable:
    """Decorator: register ``fn`` as ``target``'s implementation of
    ``opname`` (kept from the seed API; kernels modules use it)."""
    return _backend.register_kernel(opname, target)


def available_targets(opname: str) -> list:
    return _backend.available_targets(opname)


def select_target(opname: str, options: Optional[CompileOptions] = None
                  ) -> str:
    """The linalg-to-kokkoskernels decision: library call or custom kernel.
    Delegates to the resolved backend's selector / fallback chain."""
    options = options or current_options()
    return options.backend().select_impl(opname, options)


def dispatch(opname: str, options: Optional[CompileOptions] = None,
             target: Optional[str] = None) -> Callable:
    options = options or current_options()
    impl = target or select_target(opname, options)
    return _backend.kernel_callable(opname, impl, options)
