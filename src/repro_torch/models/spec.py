"""Declarative parameter specs — the port of the reference's
``models/spec.py``.

Each model layer declares its parameters once as a tree of ``Spec``s
(shape, logical axes, initializer).  From that tree come materialized
parameters (:func:`init_params`), abstract shapes for the dry-run
(:func:`abstract_params`: meta-device tensors, no allocation), the
logical-axes tree (:func:`axes_tree`, which ``dist/sharding.py`` maps
onto a mesh) and parameter counts.

:func:`init_params` takes a ``torch.Generator`` and derives one
generator per leaf from the leaf's tree path (crc32, stable across
processes), so a leaf's values do not move when the tree grows.  Shapes,
init kinds and tree paths are the reference's; the random bits are
torch's, not JAX's.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal[:std] | xavier | zeros | ones | const:v
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf of a tree of dicts (a ``Spec``, a
    tensor), keys in sorted order as JAX maps dicts; each tree of
    ``rest`` is walked down to ``tree``'s leaves, so what sits there (a
    tensor, or a dict such as Adafactor's factors) is passed whole."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path=()):
    """(path, leaf) pairs in key-sorted order, as JAX flattens dicts."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves_with_path(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def tree_leaves(tree) -> list:
    """The leaves in :func:`tree_leaves_with_path`'s (and
    :func:`tree_map`'s) order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def stack(spec_tree, n: int):
    """Add a leading stacked-layers dim to every Spec in the tree."""
    return tree_map(lambda s: Spec((n,) + s.shape, ("layers",) + s.axes,
                                   s.init, s.dtype), spec_tree)


def _init_leaf(spec: Spec, gen: torch.Generator, device,
               shape=None) -> torch.Tensor:
    """The leaf, or (``shape``: the spec's trailing dims) one leading
    entry of it, its scale taken from the whole spec."""
    shape = spec.shape if shape is None else tuple(shape)
    kind, _, arg = spec.init.partition(":")
    if kind == "zeros":
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=spec.dtype, device=device)
    if kind == "const":
        return torch.full(shape, float(arg), dtype=spec.dtype,
                          device=device)
    if kind in ("normal", "xavier"):
        if kind == "normal":
            std = float(arg) if arg else 0.02
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 \
                else spec.shape[-1]
            std = (1.0 / fan_in) ** 0.5
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * std).to(spec.dtype)
    if kind == "uniform_decay":
        n = spec.shape[-1]
        base = torch.linspace(0.0, 1.0, n, dtype=torch.float32,
                              device=device)
        return base.expand(shape).to(spec.dtype).clone()
    raise ValueError(f"unknown init {spec.init!r}")


def _path_str(path) -> str:
    return "/".join(f"['{k}']" for k in path)


def init_params(spec_tree, gen: torch.Generator, device="cuda",
                dtype=None) -> Any:
    """Materialize a spec tree on ``device``; each leaf draws from its own
    generator, seeded from ``gen``'s seed and the crc32 of its path.

    A leaf stacked over layers is drawn in f32 one layer at a time, each
    layer cast as it is drawn, so with ``dtype`` (a torch dtype or its
    name: the floating leaves' dtype in place of the spec's) a model is
    never held in f32, nor is a stacked leaf (a 64-layer MLP weight of
    qwen3-32b is 33.5 GB in f32)."""
    seed = gen.initial_seed()
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)

    def build(path, tree):
        if isinstance(tree, dict):
            return {k: build(path + (k,), v) for k, v in tree.items()}
        leaf_gen = torch.Generator(device=device)
        leaf_gen.manual_seed(
            (seed * 0x9E3779B1 + zlib.crc32(_path_str(path).encode()))
            % (2**63))
        want = dtype if dtype is not None and \
            tree.dtype.is_floating_point else tree.dtype
        if tree.axes[:1] != ("layers",):
            return _init_leaf(tree, leaf_gen, device).to(want)
        out = torch.empty(tree.shape, dtype=want, device=device)
        for i in range(tree.shape[0]):
            out[i] = _init_leaf(tree, leaf_gen, device, tree.shape[1:])
        return out

    return build((), spec_tree)


def abstract_params(spec_tree) -> Any:
    """Meta-device tensors of the specs' shapes and dtypes — the port's
    ``ShapeDtypeStruct`` tree, what the dry-run counts on."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), spec_tree)


def axes_tree(spec_tree) -> Any:
    """Each leaf's logical axes (a tuple of names or None)."""
    return tree_map(lambda s: s.axes, spec_tree)


def param_count(spec_tree) -> int:
    n = 0
    for _, s in tree_leaves_with_path(spec_tree):
        size = 1
        for dim in s.shape:
            size *= dim
        n += size
    return n
