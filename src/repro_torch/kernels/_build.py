"""Build and load the hand-written CUDA kernels.

Every kernel is a CUDA C++ source with a plain ``extern "C"`` launcher,
compiled by ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  Libraries land
in ``build/repro_torch/`` at the root of the checkout, named by a hash of
everything that goes into them (source text, the headers in ``csrc/``,
the macro definitions and the flags), so a rebuild happens only when one
of those changes.  Builds run at first use; :func:`build_all` starts many
``nvcc`` processes at once for callers that know their kernels up front.

This is the ctypes pattern of the reference's ``core/native.py``, with
nvcc in place of g++.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LOADED: Dict[Path, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class KernelSource:
    """One shared library to build: ``name`` prefixes the file, ``source``
    is the CUDA text (a file of ``csrc/`` or generated), ``defines`` the
    ``-D`` macros that instantiate it."""

    name: str
    source: str
    defines: tuple = ()

    @property
    def digest(self) -> str:
        h = hashlib.sha1()
        h.update(self.source.encode())
        for p in sorted(CSRC.glob("*.h")) + sorted(CSRC.glob("*.cuh")):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(repr((self.defines, NVCC_FLAGS)).encode())
        return h.hexdigest()[:16]

    @property
    def library(self) -> Path:
        return BUILD_DIR / f"{self.name}_{self.digest}.so"


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location.  Raises where there is none (a machine without CUDA)."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels can only be "
                           "built on a machine with the CUDA toolkit")
    return found


def sass(ks: KernelSource) -> str:
    """The SASS of ``ks``'s library (built if needed), as the toolkit's
    ``cuobjdump -sass`` prints it: what the card runs, for checks that a
    kernel really issues the instructions its design names."""
    tool = Path(nvcc()).with_name("cuobjdump")
    lib = build_all([ks])[0]
    return subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout


def csrc(name: str) -> str:
    """The text of a hand-written source in ``csrc/``."""
    return (CSRC / name).read_text()


def _start(ks: KernelSource) -> Optional[subprocess.Popen]:
    if ks.library.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{ks.name}_{ks.digest}.cu"
    src.write_text(ks.source)
    tmp = ks.library.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, f"-I{CSRC}",
           *(f"-D{k}={v}" for k, v in ks.defines),
           "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(ks: KernelSource, proc: Optional[subprocess.Popen]) -> Path:
    if proc is not None:
        out, _ = proc.communicate()
        tmp = ks.library.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {ks.name} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, ks.library)   # atomic: concurrent builders agree
    return ks.library


def build_all(sources: Sequence[KernelSource]) -> list:
    """Build every library not yet built, one ``nvcc`` per source, all
    started together; returns the library paths in order."""
    unique = list(dict.fromkeys(sources))
    procs = [(ks, _start(ks)) for ks in unique]
    paths = {ks: _finish(ks, p) for ks, p in procs}
    return [paths[ks] for ks in sources]


def load(ks: KernelSource) -> ctypes.CDLL:
    """Build ``ks`` if needed and load it (memoized per library)."""
    path = ks.library
    lib = _LOADED.get(path)
    if lib is None:
        build_all([ks])
        lib = _LOADED[path] = ctypes.CDLL(str(path))
    return lib


def on_cpu(tensors: Sequence, what: str) -> bool:
    """True iff every tensor lies on the CPU, where a wrapper runs its
    plain version; False iff all lie on the card, where it launches its
    kernel.  Any other device, or a mix, raises: a kernel's plain version
    never stands in for it off the CPU."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"}:
        raise ValueError(f"{what}: operands on {sorted(kinds)}; the kernel "
                         "takes CUDA tensors, the plain version CPU ones")
    return False


def check(rc: int, what: str) -> None:
    """Raise on a launcher's nonzero ``cudaError_t``: a refused launch
    never runs, and a later synchronize would not report it."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
