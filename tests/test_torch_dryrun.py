"""The port's dry-run (``repro_torch.launch.{shapes,opcount,dryrun}``)
and ``Model.abstract`` / ``Model.axes``, held to the JAX reference on
the CPU.

* ``Model.abstract()`` (meta tensors) and ``Model.axes()`` give the
  reference's shapes, dtypes and logical axes for all ten configs.
* ``batch_specs`` / ``decode_specs`` give the reference's
  ``ShapeDtypeStruct`` trees, full and ``reduced=True``;
  ``cell_supported`` the reference's skips.
* **FLOPs against the reference.**  The train step of ``qwen2-1.5b``,
  ``rwkv6-3b`` and ``grok-1-314b`` (``--reduced``, 8 × 32, AdamW,
  ``microbatches=1``), counted by ``launch/opcount.py`` on meta tensors,
  within 5% of the reference's ``launch/hlo.py::analyse_hlo`` of the
  same step jitted for one CPU device.  The two counts:

  ==============  ============  =============  =======================
  arch            port          reference      difference
  ==============  ============  =============  =======================
  qwen2-1.5b      209,715,200   209,715,200    none
  rwkv6-3b        247,463,936   246,415,360    +1,048,576 (+0.43%)
  grok-1-314b     6,560,940,032 6,560,940,032  none
  ==============  ============  =============  =======================

  rwkv6-3b's difference is one op of the WKV scan's backward: the
  gradient of the state operand of its ``bhk,bhkv->bhv`` einsum is an
  outer product, which autograd computes as a ``bmm`` with a contraction
  of 1 (2 · 32 · 16 · 16 = 16,384 a step, over 32 steps and 2 layers:
  1,048,576) and XLA as a broadcast multiply, which ``analyse_hlo`` does
  not count as a ``dot``.
* ``model_flops`` equals the reference's (run in a subprocess: the
  reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported).
* ``python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape
  decode_32k --mesh single`` (a subprocess: the fake process group of
  256 ranks wants a fresh process) writes a record with the reference's
  keys, ``status: "ok"``, collective bytes > 0 and ``peaks.measured``
  false (no peaks file on this host).
* The ``ok`` / ``error`` status of every arch on ``train_4k --mesh
  single`` is pinned, the op named for each error.  The cells run at
  their batch, sequence and widths with the depth cut to one layer (one
  pattern group) and one microbatch (``dryrun.cut_depth``): every layer
  and microbatch runs the same ops, so the status is the full cell's.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import all_arch_ids  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import hlo as jhlo  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import OptimizerConfig as JOptConfig  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core.options import use_options  # noqa: E402
from repro_torch.launch import dryrun as tdryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import opcount  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.models.spec import tree_leaves_with_path  # noqa: E402
from repro_torch.optim import OptimizerConfig as TOptConfig  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread while this module runs: the suite runs
    in several worker processes at once, and torch's default of a thread
    a core has them fight over the cores (a test here ran ~30x slower
    beside the other workers than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
ARCHS = tuple(all_arch_ids())
SHAPES = tuple(tshapes.SHAPES)


@pytest.fixture(scope="module", autouse=True)
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jleaves(tree):
    """(path, shape, dtype name) of a reference tree's arrays."""
    out = []
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(p.key for p in path)
        out.append((keys, tuple(a.shape), jnp.dtype(a.dtype).name))
    return out


def _tleaves(tree):
    return [(path, tuple(a.shape), str(a.dtype).removeprefix("torch."))
            for path, a in tree_leaves_with_path(tree)]


# ---------------------------------------------------------------------------
# abstract trees and the cells' specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_and_axes_match_reference(arch):
    jm, tm = jbuild(jget_config(arch)), tbuild(tget_config(arch))
    abstract = tm.abstract()
    assert all(t.device.type == "meta"
               for _, t in tree_leaves_with_path(abstract))
    assert _tleaves(abstract) == _jleaves(jm.abstract())
    jaxes = jax.tree_util.tree_flatten_with_path(
        jm.axes(), is_leaf=lambda x: isinstance(x, tuple))[0]
    assert [(tuple(p.key for p in path), ax) for path, ax in jaxes] == \
        tree_leaves_with_path(tm.axes())


@pytest.mark.parametrize("reduced", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_specs_match_reference(arch, reduced):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    for shape in SHAPES:
        jb = jshapes.batch_specs(jcfg, shape, reduced=reduced)
        tb = tshapes.batch_specs(tcfg, shape, reduced=reduced)
        assert _tleaves(tb) == _jleaves(jb), shape
        if tshapes.SHAPES[shape]["kind"] != "decode":
            continue
        for quantized in (False, True):
            jd = jshapes.decode_specs(jcfg, shape, quantized_kv=quantized,
                                      reduced=reduced)
            td = tshapes.decode_specs(tcfg, shape, quantized_kv=quantized,
                                      reduced=reduced)
            assert _tleaves(td) == _jleaves(jd), (shape, quantized)
            assert all(t.device.type == "meta"
                       for _, t in tree_leaves_with_path(td))


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_supported_matches_reference(arch):
    for shape in SHAPES:
        assert tshapes.cell_supported(tget_config(arch), shape) == \
            jshapes.cell_supported(jget_config(arch), shape), shape


# ---------------------------------------------------------------------------
# FLOPs of the train step against the reference's HLO count
# ---------------------------------------------------------------------------

# (port's count, the reference's analyse_hlo), as the docstring states
FLOPS = {"qwen2-1.5b": (209_715_200, 209_715_200),
         "rwkv6-3b": (247_463_936, 246_415_360),
         "grok-1-314b": (6_560_940_032, 6_560_940_032)}
B, S = 8, 32


def _reference_hlo_flops(arch) -> float:
    model = jbuild(jget_config(arch, reduced=True))
    hp = jsteps.TrainHParams(optimizer=JOptConfig(), microbatches=1)
    step = jsteps.make_train_step(model, hp)
    specs = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    compiled = jax.jit(step).lower(
        jsteps.abstract_train_state(model, hp), specs).compile()
    return jhlo.analyse_hlo(compiled.as_text())["flops"]


def _port_flops(arch) -> dict:
    model = tbuild(tget_config(arch, reduced=True))
    hp = tsteps.TrainHParams(optimizer=TOptConfig(), microbatches=1)
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    with use_options(tdryrun.COUNT_OPTIONS):
        _, counts = opcount.count(tsteps.make_train_step(model, hp),
                                  tsteps.abstract_train_state(model, hp),
                                  batch)
    return counts


@pytest.mark.parametrize("arch", sorted(FLOPS))
def test_train_step_flops_match_the_reference_hlo(arch):
    counts = _port_flops(arch)
    ref = _reference_hlo_flops(arch)
    assert (counts["flops"], ref) == FLOPS[arch]
    assert abs(counts["flops"] - ref) <= 0.05 * ref
    assert counts["bytes"] > 0 and counts["peak_bytes"] > 0
    assert counts["collectives"] == {"total": 0.0}      # one device


# ---------------------------------------------------------------------------
# model_flops and the CLI, in subprocesses
# ---------------------------------------------------------------------------

_MODEL_FLOPS = """
import json
from repro.configs import all_arch_ids, get_config
from repro.launch import dryrun
from repro.launch.shapes import SHAPES
from repro.models.model import build_model
out = {}
for arch in all_arch_ids():
    cfg = get_config(arch)
    model = build_model(cfg)
    for shape in SHAPES:
        out[arch + "/" + shape] = dryrun.model_flops(cfg, model, shape)
print(json.dumps(out))
"""


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_model_flops_matches_reference():
    ref = json.loads(subprocess.run(
        [sys.executable, "-c", _MODEL_FLOPS], env=_env(), check=True,
        capture_output=True, text=True, timeout=300).stdout)
    for arch in ARCHS:
        cfg = tget_config(arch)
        model = tbuild(cfg)
        for shape in SHAPES:
            assert tdryrun.model_flops(cfg, model, shape) == \
                ref[f"{arch}/{shape}"], (arch, shape)


def _reference_record_keys() -> dict:
    """The keys of the reference's record (``analyse``'s dict literal in
    ``src/repro/launch/dryrun.py``), read from its source: importing it
    would set ``XLA_FLAGS`` for this process."""
    path = os.path.join(SRC, "repro", "launch", "dryrun.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "analyse")
    ret = next(n for n in ast.walk(fn)
               if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict))
    keys = {"": [k.value for k in ret.value.keys]}
    for k, v in zip(ret.value.keys, ret.value.values):
        if isinstance(v, ast.Dict):
            keys[k.value] = [kk.value for kk in v.keys if kk is not None]
    # the roofline's ``**terms`` (compute, memory and collective terms)
    keys["roofline"] += ["compute_s", "memory_s", "collective_s"]
    return keys


def test_dryrun_cli_writes_the_reference_record(tmp_path):
    out = tmp_path / "dry"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(out)], env=_env(), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK   qwen2-1.5b__decode_32k__single" in proc.stdout
    rec = json.loads((out / "qwen2-1.5b__decode_32k__single.json")
                     .read_text())
    for sub, keys in _reference_record_keys().items():
        have = rec if not sub else rec[sub]
        assert set(keys) <= set(have), (sub, set(keys) - set(have))
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["collective_bytes_per_device"] > 0
    assert rec["collective_breakdown"]["all-gather"] > 0
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["peaks"]["measured"] is False
    roof = rec["roofline"]
    assert roof["collective_s"] is None and roof["collective_s_reason"]
    assert roof["dominant"] in ("compute_s", "memory_s")
    assert roof["memory_s"] == rec["bytes_per_device"] / \
        rec["peaks"]["bandwidth_bytes_per_s"]
    assert roof["compute_s"] == rec["flops_per_device"] / \
        rec["peaks"]["bf16_flops_per_s"]


# ---------------------------------------------------------------------------
# every arch's train_4k status on the 16 × 16 mesh
# ---------------------------------------------------------------------------

# status, and for an error the op DTensor could not run
TRAIN_4K_STATUS = {arch: ("ok", None) for arch in ARCHS}
TRAIN_4K_STATUS["arctic-480b"] = ("error", "aten.view.default")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_4k_status_is_pinned(arch):
    mesh = tmesh.make_production_mesh()
    cfg = tget_config(arch)
    hp = dataclasses.replace(tdryrun.default_hparams(tbuild(cfg)),
                             microbatches=1)
    status, op = TRAIN_4K_STATUS[arch]
    run, _, model, args = tdryrun.build_cell(arch, "train_4k", mesh, hp=hp,
                                             layers=1)
    assert model.cfg.n_layers == (len(cfg.pattern) if cfg.pattern else 1)
    if status == "ok":
        out, counts = run()
        assert counts["flops"] > 0 and counts["collectives"]["total"] > 0
        assert np.isfinite(counts["bytes"])
    else:
        with pytest.raises(RuntimeError, match=op.replace(".", r"\.")):
            run()
