"""Compile options — the repro analogue of LAPIS's pipeline flags.

``target`` names a registered execution backend the same way LAPIS selects
a Kokkos backend at compile time.  It is a lookup key into the backend
registry (``repro_torch.core.backend``), resolved by
:meth:`CompileOptions.backend` — never compared as a string outside the
backend layer.  Built-ins (from the ``repro_torch.backends`` plugin
package):

* ``"torch"``    — lower matmul-like ops to library calls (``torch.matmul``,
                   cuBLAS on the card) and everything else to eager torch
                   ops; this is ``linalg-to-kokkoskernels``.
* ``"cuda"``     — lower hot ops to the hand-written CUDA kernels (the
                   pure-Kokkos lowering path of the paper).
* ``"auto"``     — per-op choice (the paper's default pipeline
                   behaviour): the library for the ops known to be
                   hand-optimized (``LIBRARY_PREFERRED``, while
                   ``prefer_library``), the kernels for the rest iff the
                   options resolve to the card, the library otherwise.
* ``"loops"``    — eager-torch loop-nest reference interpreter (the paper's
                   generated-Kokkos-loops path), registered entirely through
                   the plugin API.

``device`` says where tensors live: ``"cuda"`` (the default) or ``"cpu"``.
A ``"cuda"`` request on a machine without a card raises — the compiler
never carries on on the CPU behind the caller's back.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch

DEVICES = ("cuda", "cpu")


@dataclasses.dataclass
class CompileOptions:
    target: str = "auto"                 # registered backend name
    device: str = "cuda"                 # "cuda" | "cpu" (see resolve_device)
    prefer_library: bool = True          # linalg-to-kokkoskernels on/off
    fuse_elementwise: bool = True        # beyond-paper fusion pass
    lazy_dualview: bool = True           # paper's lazy sync (False = eager
                                         # copies, the baseline-MLIR mode)
    hierarchy: Optional[object] = None   # ParallelHierarchy override; None →
                                         # the resolved backend's declared one
    verify_ir: object = False            # PassManager: False | True (dialect
                                         # verifier per pass) | "full" (also
                                         # the four analysis checkers)
    print_ir_after_all: bool = False     # PassManager: dump IR per pass
    cost_model: bool = False             # rank tilings / gate fusion with the
                                         # roofline model (core.costmodel)
    autotune: bool = False               # measure-verify the model's top-k
                                         # candidates on the real backend
                                         # (implies cost_model)
    autotune_top_k: int = 3              # candidates autotune measures
    tune_cache_dir: Optional[str] = None  # tuning-cache root override
                                          # (default: $REPRO_TUNE_CACHE or
                                          # ~/.cache/repro-tune)

    def resolve_cost_model(self) -> bool:
        """Autotuning needs the model's ranking to pick its top-k, so
        ``autotune`` implies ``cost_model``."""
        return self.cost_model or self.autotune

    def resolve_device(self) -> str:
        """The torch device every tensor of the compiled module lives on.
        ``"cuda"`` without a card raises instead of falling back."""
        if self.device not in DEVICES:
            raise ValueError(f"device must be one of {DEVICES}, "
                             f"got {self.device!r}")
        if self.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch sees no CUDA card; "
                "pass device='cpu' to run the plain versions on the host")
        return self.device

    def for_tensors(self, tensors) -> "CompileOptions":
        """These options with ``device`` taken from the tensors of an
        eager call: CPU tensors run on the CPU and CUDA tensors on the
        card, whatever ``device`` says.  Tensors on more than one device
        raise; with no tensor among them the options are returned as
        they are."""
        kinds = {t.device.type for t in tensors
                 if isinstance(t, torch.Tensor)}
        if not kinds:
            return self
        if len(kinds) > 1 or not kinds <= set(DEVICES):
            raise ValueError(f"operands on {sorted(kinds)}: an eager call "
                             "takes tensors on one device, the CPU or the "
                             "card")
        (kind,) = kinds
        return self if kind == self.device else \
            dataclasses.replace(self, device=kind)

    def backend(self):
        """Resolve ``target`` to its registered Backend object."""
        from repro_torch.core import backend as backend_mod
        return backend_mod.resolve(self.target)

    def resolve_hierarchy(self):
        """The ParallelHierarchy the mapping/tiling passes consult: an
        explicit override wins, else the resolved backend's declared
        spec."""
        return self.hierarchy if self.hierarchy is not None \
            else self.backend().hierarchy


_tls = threading.local()


def current_options() -> CompileOptions:
    opts = getattr(_tls, "options", None)
    return opts if opts is not None else _DEFAULT


_DEFAULT = CompileOptions()


@contextlib.contextmanager
def use_options(options: CompileOptions):
    prev = getattr(_tls, "options", None)
    _tls.options = options
    try:
        yield options
    finally:
        _tls.options = prev
