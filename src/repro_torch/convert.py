"""Carry weights from the reference into the port.

The reference's parameter trees are nested dicts (keys such as
``w_gate`` / ``w_up`` / ``w_down``) whose leaves, after a device-to-host
copy, are numpy arrays.  :func:`from_numpy_tree` maps such a tree to the
same keys and dtypes as torch tensors on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch


def numpy_to_torch(arr) -> torch.Tensor:
    """A host array as a CPU tensor of the same dtype.  bfloat16 arrays
    (numpy's ``ml_dtypes`` extension type) are refused by
    ``torch.from_numpy``, so their bits travel as int16."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:       # torch tensors are always writable
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_numpy_tree(tree, device: str = "cuda"):
    """Map a tree of dicts / lists / tuples with array leaves to the same
    tree of torch tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    return numpy_to_torch(np.asarray(tree)).to(device)


def model_params_from_numpy(tree, cfg, device: str = "cuda"):
    """The reference's parameter tree for ``cfg`` (host arrays, e.g. the
    reference model's ``init(0)`` after its compute-dtype cast, copied to
    the host) as the port's tree on ``device``.  The two trees share
    keys, stacked-layer shapes and dtypes; a tree that differs from the
    port's ``model_spec(cfg)`` in keys or shapes raises."""
    from repro_torch.models.spec import tree_leaves_with_path
    from repro_torch.models.transformer import model_spec
    want = {path: tuple(s.shape) for path, s in
            tree_leaves_with_path(model_spec(cfg))}
    got = {path: tuple(np.shape(a)) for path, a in
           tree_leaves_with_path(tree)}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"parameter tree differs from the port's "
                         f"model_spec for {cfg.name}: {diff[:4]}")
    return from_numpy_tree(tree, device)
