"""The port's sharding rules (``repro_torch.dist.sharding``) and the
sharding half of ``launch/steps.py``, held to the JAX reference on the
CPU.

* The reference's 7 cases (``tests/test_sharding.py``) run through both
  packages on the same device-free meshes (16 × 16 and 2 × 16 × 16), and
  the specs are compared.
* ``param_shardings`` of all ten full configs, ``train_state_shardings``
  (AdamW and Adafactor), ``batch_shardings`` of every ``batch_specs`` and
  ``cache_shardings`` of every ``decode_specs`` equal the reference's,
  leaf for leaf, on both production meshes; the same specs come out of a
  ``DeviceMesh`` over a fake process group, and its DTensor placements
  shard what the spec names.
* ``constrain`` / ``constrain_params`` pass tensors through without a
  mesh.
* On a world-size-1 gloo mesh, ``forward_train``'s logits, ``lm_loss``
  and every gradient of the three families (reduced), run on DTensors
  under ``use_mesh``, equal the unmeshed ones exactly; and
  ``CheckpointManager.restore(shardings=...)`` gives every leaf back bit
  for bit with its placements.

A process holds one default process group, so each test that needs a
mesh makes its own (``launch/mesh.py`` replaces a group of another
backend or size) and the module tears the last one down.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import all_arch_ids  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import OptimizerConfig as JOptConfig  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.core.options import use_options  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.models.spec import tree_leaves  # noqa: E402
from repro_torch.models.spec import tree_map  # noqa: E402
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


ARCHS = tuple(all_arch_ids())
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
OPTIMIZERS = ("adamw", "adafactor")


@pytest.fixture(scope="module", autouse=True)
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jmesh(name):
    sizes, names = MESHES[name]
    try:
        return JAbstractMesh(sizes, names)          # jax >= 0.5 signature
    except TypeError:
        return JAbstractMesh(tuple(zip(names, sizes)))


def _tmesh(name):
    return tshd.AbstractMesh(*MESHES[name])


def _jspecs(tree):
    """The reference's sharding tree → its specs as tuples, in leaf
    order."""
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: hasattr(x, "spec"))
    return [tuple(s.spec) for s in leaves]


def _tspecs(tree):
    return [tuple(s.spec) for s in tree_leaves(tree)]


@dataclasses.dataclass
class Models:
    j: object
    t: object


_MODELS = {}


def _models(arch) -> Models:
    if arch not in _MODELS:
        _MODELS[arch] = Models(jbuild(jget_config(arch)),
                               tbuild(tget_config(arch)))
    return _MODELS[arch]


# ---------------------------------------------------------------------------
# the reference's seven cases, through both packages
# ---------------------------------------------------------------------------

def _spec_case(name, multi, shape, axes, want):
    def run(shd, mesh):
        return shd.spec_for(mesh, shape, axes, shd.PARAM_RULES)
    return name, multi, run, want


SPEC_CASES = [
    _spec_case("param_rules_fsdp_plus_tp", False, (1536, 8960),
               ("embed", "ffn"), ("data", "model")),
    _spec_case("param_rules_multi_pod_fsdp_spans_pod_and_data", True,
               (6144, 24576), ("embed", "ffn"), (("pod", "data"), "model")),
    _spec_case("non_divisible_dim_left_unsharded", False, (28, 12, 128),
               ("layers", "heads", None), ()),
    _spec_case("layers_scan_dim_never_sharded", False, (64, 5120, 5120),
               ("layers", "embed", "qkv"), (None, "data", "model")),
    _spec_case("no_axis_reuse_within_one_param", False, (25600, 25600),
               ("ffn", "vocab"), ("model",)),
]


@pytest.mark.parametrize("case", SPEC_CASES, ids=[c[0] for c in SPEC_CASES])
def test_reference_spec_cases(case):
    _, multi, run, want = case
    mesh = "multi" if multi else "single"
    jspec = run(jshd, _jmesh(mesh))
    tspec = run(tshd, _tmesh(mesh))
    assert tuple(tspec) == tuple(jspec) == want
    assert isinstance(tspec, tshd.PartitionSpec)
    assert tspec == tshd.P(*want)


def test_reference_case_every_arch_param_tree_builds_shardings():
    mesh = _tmesh("single")
    for arch in ARCHS:
        m = _models(arch)
        sh = tshd.param_shardings(mesh, m.t.abstract(), m.t.axes())
        leaves = tree_leaves(sh)
        assert leaves, arch
        assert _tspecs(sh) == _jspecs(jshd.param_shardings(
            _jmesh("single"), m.j.abstract(), m.j.axes())), arch
        # every param ≥ 4M elements must be sharded somehow
        for a, s in zip(tree_leaves(m.t.abstract()), leaves):
            if a.numel() >= (1 << 22):
                assert len(s.spec) > 0, (arch, tuple(a.shape), s)


def test_reference_case_batch_sharding_drops_non_divisible():
    for shd, mesh in ((jshd, _jmesh("single")), (tshd, _tmesh("single"))):
        assert shd.batch_sharding(mesh, (256, 4096)).spec[0] == "data"
        assert tuple(shd.batch_sharding(mesh, (1,)).spec) == (None,)
    assert tshd.batch_sharding(_tmesh("single"), (1,)).spec == tshd.P(None)
    assert tshd.P(None) != tshd.P()          # JAX's tuple equality
    assert JP(None) != JP()


# ---------------------------------------------------------------------------
# every tree of the ten full configs, on both production meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_train_state_shardings_match_reference(arch, mesh):
    m = _models(arch)
    jm, tm = _jmesh(mesh), _tmesh(mesh)
    assert _tspecs(tshd.param_shardings(tm, m.t.abstract(), m.t.axes())) \
        == _jspecs(jshd.param_shardings(jm, m.j.abstract(), m.j.axes()))
    for kind in OPTIMIZERS:
        jhp = jsteps.TrainHParams(optimizer=JOptConfig(kind=kind))
        thp = tsteps.TrainHParams(optimizer=TOptConfig(kind=kind))
        jsh = jsteps.train_state_shardings(jm, m.j, jhp)
        tsh = tsteps.train_state_shardings(tm, m.t, thp)
        assert sorted(tsh["opt"]) == sorted(jsh["opt"]), kind
        assert _tspecs(tsh) == _jspecs(jsh), kind


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shardings_match_reference(arch, mesh):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    jm, tm = _jmesh(mesh), _tmesh(mesh)
    for shape in tshapes.SHAPES:
        jb = jsteps.batch_shardings(jm, jshapes.batch_specs(jcfg, shape))
        tb = tsteps.batch_shardings(tm, tshapes.batch_specs(tcfg, shape))
        assert sorted(tb) == sorted(jb), shape
        assert {k: tuple(v.spec) for k, v in tb.items()} == \
            {k: tuple(v.spec) for k, v in jb.items()}, shape
        if tshapes.SHAPES[shape]["kind"] != "decode":
            continue
        for quantized in (False, True):
            jc = jshapes.decode_specs(jcfg, shape, quantized_kv=quantized)
            tc = tshapes.decode_specs(tcfg, shape, quantized_kv=quantized)
            assert _tspecs(tsteps.cache_shardings(tm, tc["cache"])) == \
                _jspecs(jsteps.cache_shardings(jm, jc["cache"])), \
                (shape, quantized)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fake_group_device_mesh_gives_the_same_specs(mesh):
    """A ``DeviceMesh`` over a fake process group of 256 / 512 ranks in
    this one process: every spec equals the device-free mesh's (so the
    reference's), and each sharding's placements shard the tensor dims
    its spec names."""
    from torch.distributed.tensor import Replicate, Shard
    dm = tmesh.make_production_mesh(multi_pod=(mesh == "multi"))
    assert dm.mesh_dim_names == MESHES[mesh][1]
    assert tshd.mesh_size(dm) == int(np.prod(MESHES[mesh][0]))
    am = _tmesh(mesh)
    for arch in ARCHS:
        m = _models(arch)
        hp = tsteps.TrainHParams()
        got = tsteps.train_state_shardings(dm, m.t, hp)
        assert _tspecs(got) == \
            _tspecs(tsteps.train_state_shardings(am, m.t, hp)), arch
        cache = tshapes.decode_specs(tget_config(arch), "decode_32k")["cache"]
        assert _tspecs(tsteps.cache_shardings(dm, cache)) == \
            _tspecs(tsteps.cache_shardings(am, cache)), arch
        for s in tree_leaves(got["params"]):
            dims = {}
            for d, part in enumerate(s.spec):
                for name in ((part,) if isinstance(part, str)
                             else part or ()):
                    dims[name] = d
            assert s.placements == tuple(
                Shard(dims[n]) if n in dims else Replicate()
                for n in dm.mesh_dim_names), (arch, s)


@pytest.mark.parametrize("shape,local", [((16, 16), (96, 560)),
                                         ((2, 4), (768, 2240))])
def test_meta_tensors_place_as_local_shards(shape, local):
    """``distribute`` of a meta tensor gives a meta DTensor of the global
    shape whose local tensor is one device's shard, on the production
    mesh and on the small test mesh."""
    dm = (tmesh.make_production_mesh() if shape == (16, 16)
          else tmesh.make_test_mesh(shape))
    sh = tshd.NamedSharding(dm, tshd.P("data", "model"))
    t = tshd.distribute(torch.empty(1536, 8960, device="meta"), sh)
    assert t.shape == (1536, 8960) and t.device.type == "meta"
    assert tuple(t.to_local().shape) == local


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(4, 8, 16)
    assert tshd.current_mesh() is None
    assert tshd.constrain(x, "batch", None, "ffn") is x
    tree = {"a": torch.randn(8, 4), "b": {"c": torch.randn(3)}}
    axes = {"a": ("embed", "ffn"), "b": {"c": (None,)}}
    assert tshd.constrain_params(tree, axes) is tree
    with tshd.use_mesh(_tmesh("single")):      # a device-free mesh
        assert tshd.constrain(x, "batch", None, "ffn") is x
        assert tshd.reshape(x, 4, 8, 4, 4).shape == (4, 8, 4, 4)
    assert tshd.current_mesh() is None


# ---------------------------------------------------------------------------
# a world-size-1 gloo mesh: DTensors through the model, exactly
# ---------------------------------------------------------------------------

FAMILIES = ("qwen2-1.5b", "rwkv6-3b", "recurrentgemma-9b")
B, S = 2, 24      # past the reduced hybrid's window of 16


def _loss_logits_grads(model, params, batch):
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    logits, aux = model.forward(params, batch)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return logits, loss, grads


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


# ``cuda`` for the three families; ``torch`` (DTensor's propagation of
# every op) for the dense one
MESHED_CASES = [(a, "cuda") for a in FAMILIES] + [("qwen2-1.5b", "torch")]


@pytest.mark.parametrize("arch,target", MESHED_CASES)
def test_meshed_forward_loss_and_grads_equal_the_unmeshed(arch, target):
    """The reduced model in f32 on CPU tensors, unmeshed and as DTensors
    on a 1 × 1 gloo mesh (params by ``param_shardings``, the batch by
    ``batch_shardings``): logits, loss and every gradient bit for bit.
    ``cuda`` runs the kernel wrappers' DTensor rule (the plain versions
    on the local tensors), ``torch`` the plain versions through DTensor's
    own sharding propagation (the scans on local batch shards)."""
    cfg = dataclasses.replace(tget_config(arch, reduced=True),
                              compute_dtype="float32")
    model = tbuild(cfg)
    params = model.init(0, "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    mesh = tmesh.make_device_mesh("cpu")
    with use_options(CompileOptions(target=target, device="cpu")):
        want = _loss_logits_grads(
            model, tree_map(lambda t: t.detach().clone(), params), batch)
        psh = tshd.param_shardings(mesh, model.abstract(), model.axes())
        with tshd.use_mesh(mesh):
            dparams = tshd.distribute_tree(
                tree_map(lambda t: t.detach().clone(), params), psh)
            dbatch = tshd.distribute_tree(
                batch, tsteps.batch_shardings(mesh, batch))
            got = _loss_logits_grads(model, dparams, dbatch)
    assert type(got[1]).__name__ == "DTensor"
    assert torch.equal(_whole(got[0]), want[0])
    assert torch.equal(_whole(got[1]), want[1])
    assert len(got[2]) == len(want[2])
    for gg, gw in zip(got[2], want[2]):
        assert (gg is None) == (gw is None)
        if gw is not None:
            assert torch.equal(_whole(gg), gw)


def test_meshed_train_step_equals_the_unmeshed():
    """Two ``make_train_step`` steps (microbatches 2, so the accumulator
    is constrained too) from one state, unmeshed and on the 1 × 1 mesh:
    the same losses, gradient norms and new params."""
    cfg = dataclasses.replace(tget_config("qwen2-1.5b", reduced=True),
                              compute_dtype="float32")
    model = tbuild(cfg)
    hp = tsteps.TrainHParams(compute_dtype="float32", microbatches=2,
                             remat_policy="none")
    step = tsteps.make_train_step(model, hp)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    mesh = tmesh.make_device_mesh("cpu")
    with use_options(CompileOptions(target="cuda", device="cpu")):
        state = tsteps.init_train_state(model, hp, device="cpu")
        want = []
        for _ in range(2):
            state, met = step(state, batch)
            want.append((met["loss"], met["grad_norm"]))
        with tshd.use_mesh(mesh):
            dstate = tshd.distribute_tree(
                tsteps.init_train_state(model, hp, device="cpu"),
                tsteps.train_state_shardings(mesh, model, hp))
            dbatch = tshd.distribute_tree(
                batch, tsteps.batch_shardings(mesh, batch))
            for (loss, gnorm) in want:
                dstate, met = step(dstate, dbatch)
                assert torch.equal(_whole(met["loss"]), loss)
                assert torch.equal(_whole(met["grad_norm"]), gnorm)
    for a, b in zip(tree_leaves(dstate), tree_leaves(state)):
        assert torch.equal(_whole(a), b)


def test_restore_onto_shardings_round_trips_bit_for_bit(tmp_path):
    cfg = tget_config("qwen2-1.5b", reduced=True)
    model = tbuild(cfg)
    hp = tsteps.TrainHParams(master_dtype="bfloat16")
    mesh = tmesh.make_device_mesh("cpu")
    shardings = tsteps.train_state_shardings(mesh, model, hp)
    state = tshd.distribute_tree(
        tsteps.init_train_state(model, hp, device="cpu"), shardings)
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(3, state)
    back, step = ckpt.restore(shardings=shardings)
    assert step == 3
    got, want = tree_leaves(back), tree_leaves(state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert type(a).__name__ == "DTensor"
        assert a.placements == b.placements
        assert a.dtype == b.dtype
        assert torch.equal(a.to_local(), b.to_local())
    plain, _ = ckpt.restore(device="cpu")
    for a, b in zip(tree_leaves(plain), want):
        assert type(a) is torch.Tensor and torch.equal(a, b.full_tensor())
