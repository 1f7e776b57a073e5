"""Logical-axis sharding rules: spec trees for params / batches / caches
and in-graph constraints — the port of the reference's
``dist/sharding.py``, onto torch's ``DeviceMesh`` and DTensor
placements.

Parameters declare *logical* axis names once (``models/spec.py``); this
module maps them onto whatever mesh is in scope:

* ``embed`` (d_model) is FSDP-sharded over the data axes — ``("pod",
  "data")`` when a multi-pod mesh provides both, just ``"data"``
  otherwise;
* ``ffn``/``qkv``/``kv``/``vocab``/``heads``/``experts`` are
  tensor/expert-parallel over ``"model"``;
* ``layers`` (the stacked-layer dim) is never sharded;
* a dim whose size does not divide the mesh axis product is left
  **unsharded** (dropped, not padded), and a mesh axis is never reused
  within one parameter's spec.

A mesh is one of three kinds, all read through the same two questions
(its axis names, each axis's size):

* :class:`AbstractMesh` — sizes and names, no device (the counterpart
  of JAX's ``AbstractMesh``: the rules alone);
* a ``torch.distributed.device_mesh.DeviceMesh`` over a fake process
  group (``launch/mesh.py``: the production meshes on one host, for the
  dry-run's meta tensors);
* a real ``DeviceMesh`` (one H100: 1 × 1 over a world-size-1 NCCL
  group).

A spec is a :class:`PartitionSpec` (a tuple, compared as one, as JAX's
is); a :class:`NamedSharding` pairs it with its mesh and gives the
DTensor placements (``Shard(d)`` on each mesh dim that shards tensor dim
``d``, ``Replicate()`` on the rest).

Everything degrades to a no-op without a mesh: ``constrain`` /
``constrain_params`` pass their input through unless a ``DeviceMesh``
is active via :func:`use_mesh` and the input is a DTensor on it, so
model code can constrain unconditionally.  Under a ``DeviceMesh``,
:func:`use_mesh` also treats the plain tensors the model makes
(positions, masks, zeros) as replicated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Sequence, Tuple

from repro_torch.models.spec import tree_map

# Mesh axes FSDP spans, outermost first (a multi-pod mesh shards the embed
# dim over pod×data; a single-pod mesh over data alone).
FSDP_AXES = ("pod", "data")

# logical param axis -> candidate mesh axes (see models/spec.py)
PARAM_RULES = {
    "embed": FSDP_AXES,
    "ffn": ("model",),
    "qkv": ("model",),
    "kv": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "heads": ("model",),
    "layers": (),
    None: (),
}

# logical activation axis -> candidate mesh axes (constrain())
ACT_RULES = {
    "batch": FSDP_AXES,
    "seq": (),
    "ffn": ("model",),
    "qkv": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    None: (),
}


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    None (replicated).  Compared as a tuple, as JAX's: ``P("data",
    None) != P("data")``; :func:`spec_for` trims trailing Nones, so a
    fully replicated tensor gets ``P()``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class AbstractMesh:
    """A device-free mesh: axis sizes and names, nothing else."""

    def __init__(self, axis_sizes: Sequence[int],
                 axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"sizes {axis_sizes} and names {axis_names} "
                             "differ in length")
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names")


def axis_names(mesh) -> tuple:
    """The mesh's axis names, outermost first, for any of the three
    kinds."""
    if is_device_mesh(mesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """Axis name → size."""
    if is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def mesh_size(mesh) -> int:
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

def _mesh_axes(mesh, names: Sequence[str]) -> tuple:
    """The subset of ``names`` actually present on ``mesh`` (order kept)."""
    present = set(axis_names(mesh))
    return tuple(n for n in names if n in present)


def _axis_size(mesh, axes) -> int:
    """Product of the mesh sizes of ``axes`` (a name or a tuple of names)."""
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: ``Shard(d)`` where mesh
        axis names tensor dim ``d`` in the spec, ``Replicate()``
        elsewhere.  Two mesh axes on one dim (``("pod", "data")``) shard
        it in mesh order, pod outermost, as JAX lays it out."""
        from torch.distributed.tensor import Replicate, Shard
        dim_of = {}
        for d, part in enumerate(self.spec):
            for name in ((part,) if isinstance(part, str) else part or ()):
                dim_of[name] = d
        return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                     for n in axis_names(self.mesh))

    def placements_for(self, shape) -> tuple:
        """:attr:`placements` for a tensor of ``shape``: a dim of size 1
        (which a spec shards only over axes of size 1) is replicated
        instead, the same layout — DTensor will not view a sharded size-1
        dim away (a batch of one through a product's reshape)."""
        from torch.distributed.tensor import Replicate
        return tuple(Replicate() if pl.is_shard() and shape[pl.dim] == 1
                     else pl for pl in self.placements)


# ---------------------------------------------------------------------------
# spec construction
# ---------------------------------------------------------------------------

def spec_for(mesh, shape: Tuple[int, ...],
             axes: Sequence[Optional[str]], rules: dict) -> PartitionSpec:
    """Build a PartitionSpec for one tensor from its logical axes.

    Per dim: look up the rule's candidate mesh axes, keep only axes the
    mesh has, and shard iff the dim size divides their product and none of
    them was already used by an earlier dim of this tensor.  Trailing
    replicated dims are trimmed so fully-replicated tensors compare equal
    to ``P()``.
    """
    used: set = set()
    parts: list = []
    for dim, ax in zip(shape, axes):
        cands = _mesh_axes(mesh, rules.get(ax, ()))
        if cands and not (set(cands) & used) and \
                dim % _axis_size(mesh, cands) == 0:
            parts.append(cands if len(cands) > 1 else cands[0])
            used.update(cands)
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def param_shardings(mesh, abstract_tree, axes_tree) -> Any:
    """Abstract (meta) tree + logical-axes tree -> NamedSharding tree."""
    return tree_map(
        lambda a, ax: NamedSharding(
            mesh, spec_for(mesh, tuple(a.shape), tuple(ax), PARAM_RULES)),
        abstract_tree, axes_tree)


def batch_sharding(mesh, shape: Tuple[int, ...]) -> NamedSharding:
    """Data-parallel sharding: dim 0 over the FSDP axes when divisible,
    everything else replicated."""
    parts: list = [None] * len(shape)
    fsdp = _mesh_axes(mesh, FSDP_AXES)
    if shape and fsdp and shape[0] % _axis_size(mesh, fsdp) == 0:
        parts[0] = fsdp if len(fsdp) > 1 else fsdp[0]
    return NamedSharding(mesh, P(*parts))


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------

def distribute(t, sharding: NamedSharding):
    """``t`` (its global value, or a meta tensor of its global shape) as
    a DTensor on the sharding's ``DeviceMesh`` with its placements.  A
    meta tensor becomes a meta DTensor of the local shard's shape, with
    no collective."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh, placements = sharding.mesh, sharding.placements_for(t.shape)
    if t.device.type == "meta":
        import torch
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        local, _ = compute_local_shape_and_global_offset(
            t.shape, mesh, placements)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), mesh,
            placements, run_check=False, shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, placements)


def distribute_tree(tree, shardings) -> Any:
    """Every leaf of ``tree`` placed by the matching leaf of
    ``shardings`` (:func:`distribute`)."""
    return tree_map(distribute, tree, shardings)


# ---------------------------------------------------------------------------
# active mesh + in-graph constraints
# ---------------------------------------------------------------------------

_tls = threading.local()


def current_mesh():
    return getattr(_tls, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for :func:`constrain` within the block.  Under a
    ``DeviceMesh`` the plain tensors the model makes (positions, masks,
    zeros) meet DTensors as replicated ones (DTensor's
    ``implicit_replication``)."""
    prev = getattr(_tls, "mesh", None)
    _tls.mesh = mesh
    try:
        if is_device_mesh(mesh):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield mesh
        else:
            yield mesh
    finally:
        _tls.mesh = prev


def _on_active_mesh(x, mesh) -> bool:
    if mesh is None or not is_device_mesh(mesh):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor) and x.device_mesh == mesh


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` by logical activation
    axes: a DTensor on the active ``DeviceMesh`` is redistributed to the
    spec's placements (differentiable: the backward redistributes the
    gradient back); anything else passes through unchanged."""
    mesh = current_mesh()
    if not _on_active_mesh(x, mesh):
        return x
    spec = spec_for(mesh, tuple(x.shape), tuple(axes), ACT_RULES)
    return x.redistribute(
        mesh, NamedSharding(mesh, spec).placements_for(x.shape))


def constrain_batch(x):
    """``x`` constrained to its rows' sharding: dim 0 over the data axes,
    every other dim whole.  A block's output product contracts a dim
    sharded over ``model``, so DTensor leaves it a partial sum, and keeps
    it one through the residual add and the next norm (it reduces lazily,
    where GSPMD reduces where it pays); constraining the block's output
    reduces it there, as tensor parallelism does."""
    return constrain(x, "batch", *([None] * (x.dim() - 1)))


def reshape(x, *shape):
    """``x.reshape(shape)``.  GSPMD reshards a sharded dim that a reshape
    splits unevenly (12 heads of a 16-way model axis); DTensor refuses
    such a view.  So under an active ``DeviceMesh`` a DTensor whose
    view fails is first replicated on every dim from the first one the
    reshape changes, then reshaped (the all-gather GSPMD would insert
    too); anything else is reshaped as it is.  ``shape`` is given as
    ``Tensor.reshape`` takes it: sizes, or one tuple of them."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    if not _on_active_mesh(x, current_mesh()):
        return x.reshape(*shape)
    try:
        return x.reshape(*shape)
    except RuntimeError:
        from torch.distributed.tensor import Replicate
        keep = 0
        for a, b in zip(x.shape, shape):
            if a != b:
                break
            keep += 1
        placements = [Replicate() if pl.is_shard() and pl.dim >= keep
                      else pl for pl in x.placements]
        return x.redistribute(x.device_mesh, placements).reshape(*shape)


def constrain_params(tree, axes_tree):
    """Constrain a whole param-shaped tree (grads, accumulators) to the
    param sharding rules; identity without an active ``DeviceMesh``."""
    mesh = current_mesh()
    if mesh is None or not is_device_mesh(mesh):
        return tree

    def one(p, ax):
        if not _on_active_mesh(p, mesh):
            return p
        spec = spec_for(mesh, tuple(p.shape), tuple(ax), PARAM_RULES)
        return p.redistribute(
            mesh, NamedSharding(mesh, spec).placements_for(p.shape))
    return tree_map(one, tree, axes_tree)
