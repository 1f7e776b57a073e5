"""Native execution of lapis-translate output — the differential oracle.

The paper's integration claim is that LAPIS-emitted Kokkos units are
*runnable* code, not pretty-printing.  This module closes that loop for
the repro: it compiles an emitted translation unit to a shared object,
loads it with ctypes through the unit's C-ABI harness (``lapis_run`` +
shape/arity/dtype descriptor — see :mod:`repro_torch.core.translate`), and
hands back a callable (numpy arrays or tensors in, numpy out) so the
*same* test inputs flow through the compiled torch callable and the
native binary:

    mod = pipeline.compile(fn, *specs, options=...)
    native = load_native(mod)
    np.testing.assert_allclose(native(*args), mod(*args).cpu(), atol=1e-4)

Two build flavours, selected by ``$KOKKOS_ROOT``:

* **real Kokkos** (``$KOKKOS_ROOT`` points at an install prefix): links
  ``-lkokkoscore`` and, when the unit spells ``Kokkos::OpenMP``, adds
  ``-fopenmp`` — Serial/OpenMP host builds of the very same unit;
* **executable stub** (default): compiles against the run-capable serial
  Kokkos subset in ``tests/kokkos_stub/`` — CI's differential oracle
  with no Kokkos install.

The unit is the serial oracle of the compiled module, so it builds and
runs on the host whatever device the module was compiled for: a tensor
argument on the card is copied to the host explicitly before the call.
A missing compiler or a failed build raises :class:`NativeBuildError`;
nothing skips or falls back.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.translate import CABI_DTYPE_CODES, CABI_MAX_RANK

# descriptor dtype code -> numpy dtype (inverse of translate's table)
_NP_DTYPES = {code: np.dtype(name) for name, code in
              {"float32": CABI_DTYPE_CODES["float"],
               "int32": CABI_DTYPE_CODES["int32_t"],
               "int64": CABI_DTYPE_CODES["int64_t"],
               "bool": CABI_DTYPE_CODES["bool"]}.items()}

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]


class NativeBuildError(RuntimeError):
    """g++ is missing or the emitted unit failed to compile/link."""


def compiler() -> Optional[str]:
    """The C++ compiler the harness uses ($CXX override, else g++)."""
    cxx = os.environ.get("CXX") or "g++"
    return shutil.which(cxx)


def kokkos_root() -> Optional[str]:
    """A real Kokkos install prefix, when the user points at one."""
    root = os.environ.get("KOKKOS_ROOT")
    return root if root and os.path.isdir(root) else None


def stub_include_dir() -> pathlib.Path:
    """The executable serial Kokkos subset ($LAPIS_KOKKOS_STUB override,
    else the in-repo ``tests/kokkos_stub``)."""
    override = os.environ.get("LAPIS_KOKKOS_STUB")
    if override:
        return pathlib.Path(override)
    return _REPO_ROOT / "tests" / "kokkos_stub"


def _build_cmd(src: pathlib.Path, out: pathlib.Path, *, shared: bool,
               root: Optional[str], extra_flags: Sequence[str]) -> list:
    cxx = compiler()
    if cxx is None:
        raise NativeBuildError(
            "no C++ compiler on PATH (set $CXX or install g++) — "
            "cannot build lapis-translate output natively")
    cmd = [cxx, "-std=c++17", "-O2"]
    if shared:
        cmd += ["-fPIC", "-shared"]
    text = src.read_text()
    if root:
        cmd += [f"-I{root}/include"]
        if "Kokkos::OpenMP" in text:
            cmd += ["-fopenmp"]
    else:
        cmd += [f"-I{stub_include_dir()}"]
    cmd += list(extra_flags) + [str(src), "-o", str(out)]
    if root:
        for libdir in ("lib", "lib64"):
            if (pathlib.Path(root) / libdir).is_dir():
                cmd += [f"-L{root}/{libdir}"]
        cmd += ["-lkokkoscore", "-ldl", "-lpthread"]
    return cmd


def _build(src, out_dir, suffix: str, *, shared: bool, root,
           extra_flags: Sequence[str]) -> pathlib.Path:
    src = pathlib.Path(src)
    out_dir = pathlib.Path(out_dir or src.parent)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / (src.stem + suffix)
    root = root if root is not None else kokkos_root()
    cmd = _build_cmd(src, out, shared=shared, root=root,
                     extra_flags=extra_flags)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"native build failed ({' '.join(cmd)}):\n{proc.stderr}")
    return out


def build_shared(src, out_dir=None, *, root: Optional[str] = None,
                 extra_flags: Sequence[str] = ()) -> pathlib.Path:
    """Compile an emitted ``.cpp`` unit to a ctypes-loadable ``.so``."""
    return _build(src, out_dir, ".so", shared=True, root=root,
                  extra_flags=extra_flags)


def build_exe(src, out_dir=None, *, root: Optional[str] = None,
              extra_flags: Sequence[str] = ()) -> pathlib.Path:
    """Compile an emitted ``.cpp`` unit to an executable (its ``main``
    runs the entry function on zero inputs and prints a checksum)."""
    return _build(src, out_dir, ".exe", shared=False, root=root,
                  extra_flags=extra_flags)


class NativeModule:
    """A ctypes-loaded translation unit, callable like the compiled
    module.

    Reads the unit's own shape/arity/dtype descriptor (the C ABI is the
    contract — nothing here consults the Python-side Graph), validates
    and re-packs the caller's arrays to dense row-major buffers of the
    declared dtypes, and drives ``lapis_run`` through uniform pointer
    tables."""

    def __init__(self, lib_path):
        self.path = pathlib.Path(lib_path)
        self._lib = ctypes.CDLL(str(self.path))
        for name, restype in (("lapis_num_inputs", ctypes.c_int),
                              ("lapis_num_outputs", ctypes.c_int),
                              ("lapis_input_rank", ctypes.c_int),
                              ("lapis_input_dim", ctypes.c_longlong),
                              ("lapis_input_dtype", ctypes.c_int),
                              ("lapis_output_rank", ctypes.c_int),
                              ("lapis_output_dim", ctypes.c_longlong),
                              ("lapis_output_dtype", ctypes.c_int)):
            getattr(self._lib, name).restype = restype
        self._lib.lapis_run.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                        ctypes.POINTER(ctypes.c_void_p)]
        self._lib.lapis_run.restype = None
        lib = self._lib
        self.input_specs = []
        for i in range(lib.lapis_num_inputs()):
            rank = lib.lapis_input_rank(i)
            shape = tuple(int(lib.lapis_input_dim(i, d))
                          for d in range(min(rank, CABI_MAX_RANK)))
            self.input_specs.append(
                (shape, _NP_DTYPES[lib.lapis_input_dtype(i)]))
        rank = lib.lapis_output_rank()
        self.output_spec = (tuple(int(lib.lapis_output_dim(d))
                                  for d in range(rank)),
                            _NP_DTYPES[lib.lapis_output_dtype()])

    def __call__(self, *args) -> np.ndarray:
        if len(args) != len(self.input_specs):
            raise TypeError(
                f"native module takes {len(self.input_specs)} arrays, "
                f"got {len(args)}")
        bufs = []
        for k, (a, (shape, dt)) in enumerate(zip(args, self.input_specs)):
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()   # the explicit d2h copy
            a = np.ascontiguousarray(np.asarray(a), dtype=dt)
            if a.shape != shape:
                raise TypeError(
                    f"input {k}: expected shape {shape}, got {a.shape}")
            bufs.append(a)            # keep alive across the call
        out_shape, out_dt = self.output_spec
        out = np.zeros(out_shape, out_dt)
        ins = (ctypes.c_void_p * max(len(bufs), 1))(
            *[b.ctypes.data for b in bufs])
        outs = (ctypes.c_void_p * 1)(out.ctypes.data)
        self._lib.lapis_run(ins, outs)
        return out


def load_native(compiled_module, build_dir=None, *,
                root: Optional[str] = None) -> NativeModule:
    """Emit, build and load the native form of a
    :class:`~repro_torch.core.pipeline.CompiledModule` — the backend oracle:
    ``load_native(mod)(*args)`` must match ``mod(*args)`` to f32
    tolerance on every registered backend."""
    if build_dir is None:
        build_dir = tempfile.mkdtemp(prefix="lapis_native_")
    build_dir = pathlib.Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    name = compiled_module.graph.name
    target = compiled_module.options.target
    src = build_dir / f"{name}_{target}.cpp"
    src.write_text(compiled_module.emit_cpp_source())
    return NativeModule(build_shared(src, build_dir, root=root))
