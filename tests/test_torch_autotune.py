"""Autotune in the port: measure-verify on the backend, the tuning cache,
and the replay (``tests/test_costmodel.py``'s tuning-cache cases, on
``loops`` and ``cuda``).

On the CPU (``device="cpu"``) ``measure_callable`` times the candidates
by the host clock through the kernels' plain versions; on the card it
times them with CUDA events.  The conftest autouse fixture points
``REPRO_TUNE_CACHE`` at a per-test directory.  A replay from the cache
makes no measurement and gives the first compile's tiling, cost attrs
and Kokkos C++ verbatim; a tuned compile computes what an untuned one
does, to 1e-5.  The port also tunes the sparse kernels' ``row_block``
(the reference's sparsify pass only ranks it).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import costmodel, ops, pipeline
from repro_torch.core.backend import H100_HIERARCHY
from repro_torch.core.costmodel import TuneCache
from repro_torch.core.options import CompileOptions


def _gemm_workload(m=256, k=128, n=128):
    w = np.random.default_rng(1).standard_normal((k, n)).astype(np.float32)

    def fn(x):
        return ops.matmul(x, ops.constant(w))

    x = np.random.default_rng(0).standard_normal((m, k)).astype(np.float32)
    return fn, x


def _spmv_workload(n=300):
    rng = np.random.default_rng(3)
    lens = np.maximum(rng.poisson(9.0, n), 1).astype(np.int32)
    ip = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=ip[1:])
    nnz = int(ip[-1])
    args = (ip, rng.integers(0, n, nnz).astype(np.int32),
            rng.standard_normal(nnz).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))

    def fn(ip_, ind, val, x):
        return ops.relu(ops.spmv_csr(ip_, ind, val, x, n_rows=n,
                                     max_nnz_row=int(lens.max())))
    return fn, args


def _opts(target, **kw):
    return CompileOptions(target=target, device="cpu", **kw)


def _op(mod, opname):
    return next(op for op in mod.graph.ops if op.opname == opname)


def test_tune_cache_key_is_sensitive():
    cache = TuneCache()
    h2 = dataclasses.replace(H100_HIERARCHY, scratch_bytes=2**16)
    shapes = [(256, 128), (128, 128)]
    base = cache.key("cuda", "kk.gemm", shapes, H100_HIERARCHY)
    assert base.startswith("cuda__kk_gemm__")
    assert base == cache.key("cuda", "kk.gemm", shapes, H100_HIERARCHY)
    assert base != cache.key("loops", "kk.gemm", shapes, H100_HIERARCHY)
    assert base != cache.key("cuda", "kk.gemm", [(512, 128), (128, 128)],
                             H100_HIERARCHY)
    assert base != cache.key("cuda", "kk.gemm", shapes, h2)


@pytest.mark.parametrize("target", ["loops", "cuda"])
def test_autotune_second_compile_hits_cache_identical_ir(target):
    fn, x = _gemm_workload()
    opts = _opts(target, autotune=True)
    costmodel.reset_cache_stats()
    first = pipeline.compile(fn, x, options=opts)
    stats1 = costmodel.reset_cache_stats()
    assert stats1["measured"] >= 2          # a real search happened
    second = pipeline.compile(fn, x, options=opts)
    stats2 = costmodel.reset_cache_stats()
    assert stats2["hits"] >= 1 and stats2["measured"] == 0
    assert second.emit_cpp_source() == first.emit_cpp_source()
    gemm, gemm1 = _op(second, "kk.gemm"), _op(first, "kk.gemm")
    assert gemm.attrs["cost"]["source"] == "autotune"
    assert gemm.attrs["cost"]["measured_us"] > 0
    assert gemm.attrs["tiling"] == gemm1.attrs["tiling"]
    assert gemm.attrs["cost"] == gemm1.attrs["cost"]
    torch.testing.assert_close(second(x), first(x), rtol=1e-6, atol=0)


def test_cuda_autotune_measure_verify_and_cache_replay():
    """The cuda backend is wired into the measure-verify path: candidates
    are timed through its kernels (their plain versions on the CPU), the
    winner persists under a cuda cache key, and a repeat compile replays
    it verbatim (tiling, cost attrs, emitted C++)."""
    fn, x = _gemm_workload()
    opts = _opts("cuda", autotune=True)
    costmodel.reset_cache_stats()
    first = pipeline.compile(fn, x, options=opts)
    assert costmodel.reset_cache_stats()["measured"] == \
        opts.autotune_top_k
    cdir = os.environ["REPRO_TUNE_CACHE"]
    (name,) = os.listdir(cdir)
    assert name.startswith("cuda__kk_gemm__")
    with open(os.path.join(cdir, name)) as f:
        rec = json.load(f)
    gemm = _op(first, "kk.gemm")
    assert rec["cost"] == gemm.attrs["cost"]
    # every measured candidate is in the record, the winner the fastest
    assert len(rec["candidates"]) == opts.autotune_top_k
    assert min(c["measured_us"] for c in rec["candidates"]) == \
        gemm.attrs["cost"]["measured_us"]
    second = pipeline.compile(fn, x, options=opts)
    assert costmodel.reset_cache_stats()["measured"] == 0
    gemm2 = _op(second, "kk.gemm")
    assert gemm2.attrs["tiling"] == gemm.attrs["tiling"]
    assert gemm2.attrs["cost"] == gemm.attrs["cost"]
    assert second.emit_cpp_source() == first.emit_cpp_source()
    plain = pipeline.compile(fn, x, options=_opts("cuda"))
    torch.testing.assert_close(second(x), plain(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("target", ["loops", "cuda"])
def test_autotuned_result_is_numerically_correct(target):
    fn, x = _gemm_workload(m=96, k=64, n=64)
    tuned = pipeline.compile(fn, x, options=_opts(target, autotune=True))
    plain = pipeline.compile(fn, x, options=_opts(target))
    torch.testing.assert_close(tuned(x), plain(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("target", ["loops", "cuda"])
def test_sparse_row_block_is_autotuned_and_replayed(target):
    fn, args = _spmv_workload()
    opts = _opts(target, autotune=True)
    costmodel.reset_cache_stats()
    first = pipeline.compile(fn, *args, options=opts)
    assert costmodel.reset_cache_stats()["measured"] == 3
    spmv = _op(first, "kk.spmv")
    assert spmv.attrs["cost"]["source"] == "autotune"
    assert spmv.attrs["cost"]["measured_us"] > 0
    assert any(p.startswith(f"{target}__kk_spmv__")
               for p in os.listdir(os.environ["REPRO_TUNE_CACHE"]))
    if target == "loops":      # the ELL conversion carries the tiling too
        assert _op(first, "sparse.convert").attrs["tiling"] == \
            spmv.attrs["tiling"]
    second = pipeline.compile(fn, *args, options=opts)
    assert costmodel.reset_cache_stats()["measured"] == 0
    spmv2 = _op(second, "kk.spmv")
    assert spmv2.attrs["tiling"] == spmv.attrs["tiling"]
    assert spmv2.attrs["cost"] == spmv.attrs["cost"]
    assert second.emit_cpp_source() == first.emit_cpp_source()
    plain = pipeline.compile(fn, *args, options=_opts(target))
    assert _op(plain, "kk.spmv").attrs["cost"]["source"] == "heuristic"
    torch.testing.assert_close(second(*args), plain(*args), rtol=1e-5,
                               atol=1e-5)


def test_top_k_bounds_the_measurements():
    fn, x = _gemm_workload()
    costmodel.reset_cache_stats()
    pipeline.compile(fn, x, options=_opts("loops", autotune=True,
                                          autotune_top_k=1))
    assert costmodel.reset_cache_stats()["measured"] == 1


def test_tune_cache_dir_option_overrides_env(tmp_path):
    fn, x = _gemm_workload()
    cdir = tmp_path / "explicit-cache"
    pipeline.compile(fn, x, options=_opts("cuda", autotune=True,
                                          tune_cache_dir=str(cdir)))
    assert any(p.name.startswith("cuda__kk_gemm__") for p in cdir.iterdir())


def test_json_tiling_round_trip():
    from repro_torch.core.costmodel import _json_tiling
    t = {"block": (8, 128), "grid": (4, 1), "bm": 64,
         "vectorize_batch": True}
    back = _json_tiling(json.loads(json.dumps(
        {k: (list(v) if isinstance(v, tuple) else v)
         for k, v in t.items()})))
    assert back == t and isinstance(back["vectorize_batch"], bool)


def test_cost_attrs_visible_in_ir_and_cpp():
    def fn(x):
        return ops.relu(ops.matmul(x, ops.add(x, x)))

    x = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    mod = pipeline.compile(fn, x, options=_opts("loops", cost_model=True))
    gemm = _op(mod, "kk.gemm")
    assert gemm.attrs["cost"]["source"] == "model"
    assert gemm.attrs["cost"]["predicted_us"] > 0
    dump = str(mod.graph)
    assert "cost=" in dump and "'source': 'model'" in dump
    assert "cost={" in mod.emit_cpp_source()
    mod2 = pipeline.compile(fn, x, options=_opts("loops"))
    assert _op(mod2, "kk.gemm").attrs["cost"]["source"] == "heuristic"


def test_measure_callable_protocol():
    """One untimed warm-up, then ``rounds`` rounds of ``reps`` calls on
    the host clock for CPU tensors; arguments on two devices raise."""
    calls = []
    x = torch.ones(4)
    costmodel.reset_cache_stats()
    sec = costmodel.measure_callable(lambda t: calls.append(t), (x,),
                                     reps=2, rounds=5)
    assert len(calls) == 1 + 2 * 5 and sec >= 0
    assert costmodel.reset_cache_stats()["measured"] == 1
    with pytest.raises(ValueError, match="arguments on"):
        costmodel.measure_callable(lambda *a: None,
                                   (x, torch.empty(4, device="meta")))


def test_autotune_cli_flags_plumb_through(capsys):
    assert pipeline.main(["--demo", "mlp", "--target", "loops", "--device",
                          "cpu", "--cost-model", "--print-ir"]) == 0
    assert "'source': 'model'" in capsys.readouterr().out
    costmodel.reset_cache_stats()
    assert pipeline.main(["--demo", "mlp", "--target", "cuda", "--device",
                          "cpu", "--autotune", "--autotune-top-k", "2",
                          "--print-ir"]) == 0
    out = capsys.readouterr().out
    assert "'source': 'autotune'" in out and "'measured_us'" in out
    assert "output shape: (8, 10) sum: 8.0" in out
    assert costmodel.reset_cache_stats()["measured"] == 4   # 2 gemms x 2
    assert pipeline.main(["--demo", "spmv", "--target", "cuda", "--device",
                          "cpu", "--autotune", "--print-ir"]) == 0
    out = capsys.readouterr().out
    assert "kk.spmv" in out and "'source': 'autotune'" in out
