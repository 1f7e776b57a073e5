"""Op semantics: every reference op the port's tracer and library path
use, run by ``repro.core.refs`` (JAX) and ``repro_torch.core.refs``
(torch) on the same seeded inputs — values to 1e-5 in f32, and the same
result dtype.  Includes the spots where the two frameworks differ by
default (tanh gelu, clamped slices, filled out-of-range gathers, mixed
operand dtypes, integer sums)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import refs as jrefs  # noqa: E402
from repro_torch.core import refs as trefs  # noqa: E402
from repro_torch.core.tracer import dtype_name  # noqa: E402

_RNG = np.random.default_rng(7)
A = _RNG.standard_normal((4, 6)).astype(np.float32)
B = _RNG.standard_normal((4, 6)).astype(np.float32)
POS = np.abs(A) + 0.5
M = _RNG.standard_normal((6, 5)).astype(np.float32)
V = _RNG.standard_normal((6,)).astype(np.float32)
T3 = _RNG.standard_normal((2, 3, 4)).astype(np.float32)

CASES = [
    ("linalg.add", {}, (A, B)), ("linalg.sub", {}, (A, B)),
    ("linalg.mul", {}, (A, B)), ("linalg.div", {}, (A, POS)),
    ("linalg.maximum", {}, (A, B)), ("linalg.relu", {}, (A,)),
    ("linalg.gelu", {}, (A,)), ("linalg.silu", {}, (A,)),
    ("linalg.sigmoid", {}, (A,)), ("linalg.tanh", {}, (A,)),
    ("linalg.exp", {}, (A,)), ("linalg.neg", {}, (A,)),
    ("linalg.sqrt", {}, (POS,)), ("linalg.rsqrt", {}, (POS,)),
    ("linalg.power", {"exponent": 3.0}, (A,)),
    ("linalg.matmul", {}, (A, M)), ("linalg.gemv", {}, (A, V)),
    ("linalg.dot", {}, (A, M)), ("linalg.dot", {}, (T3, T3[0].T)),
    ("linalg.matmul", {}, (A, M.astype(np.float64))),
    ("kk.gemm", {}, (A, M)),
    ("linalg.reduce_sum", {"axis": 1, "keepdims": True}, (A,)),
    ("linalg.reduce_sum", {"axis": None}, (A,)),
    ("linalg.reduce_sum", {"axis": 0},
     (np.arange(12, dtype=np.int32).reshape(3, 4),)),
    ("linalg.reduce_max", {"axis": (0, 1)}, (T3,)),
    ("linalg.mean", {"axis": -1}, (T3,)),
    ("linalg.softmax", {"axis": -1}, (A * 30,)),
    ("linalg.softmax", {"axis": 0}, (A,)),
    ("tensor.reshape", {"shape": (6, 4)}, (A,)),
    ("tensor.transpose", {"perm": None}, (T3,)),
    ("tensor.transpose", {"perm": (1, 0, 2)}, (T3,)),
    ("tensor.cast", {"dtype": "int32"}, (A * 10,)),
    ("tensor.slice", {"starts": (1, 4), "sizes": (2, 3)}, (A,)),
    ("tensor.slice", {"starts": (3, -2), "sizes": (2, 3)}, (A,)),
    ("tensor.slice", {"starts": (-9, 0), "sizes": (2, 6)}, (A,)),
    ("tensor.concat", {"axis": 1}, (A, B)),
    ("tensor.broadcast", {"shape": (3, 4, 6)}, (A,)),
    ("tensor.pad", {"pads": ((1, 0), (2, 3)), "value": 0.5}, (A,)),
    ("tensor.gather", {"axis": 1},
     (A, np.array([0, 5, -1, 6, -7, 2], np.int32))),
    ("tensor.gather", {"axis": 0},
     (np.arange(12, dtype=np.int32).reshape(4, 3),
      np.array([[1, 4], [-1, 0]], np.int32))),
]


@pytest.mark.parametrize("opname,attrs,args", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_semantics_match_reference(opname, attrs, args):
    want = np.asarray(jrefs.op_ref(opname, attrs)(*args))
    got = trefs.op_ref(opname, attrs)(*[torch.from_numpy(a) for a in args])
    assert tuple(got.shape) == want.shape
    # JAX without x64 computes in 32 bits where torch keeps 64
    want_dtype = {"float64": "float32", "int64": "int32"}.get(
        want.dtype.name, want.dtype.name)
    assert {"float64": "float32", "int64": "int32"}.get(
        dtype_name(got.dtype), dtype_name(got.dtype)) == want_dtype
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               want.astype(np.float64), rtol=1e-5,
                               atol=1e-5)
