"""Fault-tolerant checkpointing — the port of the reference's
``checkpoint/manager.py``.

* **Atomic**: write into ``<dir>/tmp.<step>`` then ``os.replace`` to
  ``<dir>/step_<n>`` — a crash mid-write never corrupts the latest
  checkpoint; ``latest()`` only ever sees completed renames.
* **Device→host staging via DualView** (the paper's memory model): a
  save wraps each tensor leaf in a DualView whose device side is the
  leaf, and ``host()`` copies it (counted in
  ``core.dualview.TRANSFERS``), while a host leaf (numpy, a Python
  number) is staged with no copy (the manifest's ``lazy_hits``).  The
  DualViews live for one save: the reference keeps one a leaf across
  saves, and so holds on to the last saved state; here a state the
  caller drops is freed (a device state of a full-width model is tens
  of GB).
* **Async**: the staging happens on the caller thread; file writes can
  run on a background thread.
* **Elastic restore**: leaves are stored with their global shapes (a
  DTensor leaf is saved whole, ``full_tensor()``) and a tree manifest;
  ``restore(shardings=...)`` places every leaf on its
  ``dist.sharding.NamedSharding``'s mesh with its placements, whatever
  mesh saved it — the reference's restore onto any mesh.  Without
  shardings every leaf is a tensor on ``device`` (one device).
* **keep_k** garbage collection.

numpy has no bfloat16, so a leaf whose host copy numpy cannot hold is
stored as integers of its width (bf16 as int16) and its dtype is named
in the manifest's ``dtypes``; ``restore`` views the bits back.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.dualview import TRANSFERS, DualView
from repro_torch.models.spec import tree_map

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _flatten(tree, prefix=""):
    """→ list of (key, leaf); keys are /-joined paths."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(_flatten(v, f"{prefix}{i}/"))
    else:
        out.append((prefix[:-1], tree))
    return out


def _unflatten(manifest: dict, leaves: dict):
    kind = manifest["kind"]
    if kind == "dict":
        return {k: _unflatten(v, leaves)
                for k, v in manifest["children"].items()}
    if kind in ("list", "tuple"):
        seq = [_unflatten(v, leaves) for v in manifest["children"]]
        return tuple(seq) if kind == "tuple" else seq
    return leaves[manifest["key"]]


def _manifest_of(tree, prefix=""):
    if isinstance(tree, dict):
        return {"kind": "dict",
                "children": {k: _manifest_of(tree[k], f"{prefix}{k}/")
                             for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return {"kind": kind,
                "children": [_manifest_of(v, f"{prefix}{i}/")
                             for i, v in enumerate(tree)]}
    return {"kind": "leaf", "key": prefix[:-1]}


def _host_array(host) -> tuple:
    """A staged host copy → (numpy array, dtype name or None): a CPU
    tensor (a dtype numpy lacks) travels as integers of its width."""
    if isinstance(host, torch.Tensor):
        bits = host.view(_BITS[host.element_size()]).numpy()
        return bits, str(host.dtype).removeprefix("torch.")
    return np.asarray(host), None


class CheckpointManager:
    def __init__(self, directory: str, keep_k: int = 3,
                 async_write: bool = False):
        self.dir = directory
        self.keep_k = keep_k
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree: Any, *, block: bool = True) -> str:
        self.wait()
        leaves = _flatten(tree)
        staged, dtypes = {}, {}
        lazy_hits = 0
        for key, arr in leaves:
            if hasattr(arr, "full_tensor"):    # a DTensor: its global value
                arr = arr.full_tensor()
            if isinstance(arr, torch.Tensor):
                dv = DualView.from_device(arr, name=key)
            else:                          # numpy or a Python number
                dv = DualView.from_host(np.asarray(arr), name=key)
            before = TRANSFERS["d2h"]
            host = dv.host()               # lazy: copies only if modified
            lazy_hits += int(TRANSFERS["d2h"] == before)
            staged[key], dtype = _host_array(host)
            if dtype is not None:
                dtypes[key] = dtype
        manifest = {"step": step, "tree": _manifest_of(tree),
                    "dtypes": dtypes, "lazy_hits": lazy_hits,
                    "n_leaves": len(leaves)}

        def write():
            tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
            os.makedirs(tmp, exist_ok=True)
            for key, host in staged.items():
                fn = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fn), host)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.dir, f"step_{step:08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)         # atomic publish
            self._gc()

        if self.async_write and not block:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        else:
            write()
        return os.path.join(self.dir, f"step_{step:08d}")

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_k] if self.keep_k else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, shardings: Any = None,
                device: str = "cuda") -> tuple:
        """Load a checkpoint (the latest by default) → (tree, step).  With
        ``shardings`` (a tree of ``NamedSharding`` matching the saved one)
        every leaf is a DTensor on its sharding's mesh with its
        placements (``dist.sharding.distribute``); else a tensor on
        ``device``."""
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        leaves = {}
        for name in os.listdir(path):
            if name.endswith(".npy"):
                key = name[:-4].replace("__", "/")
                t = torch.from_numpy(np.load(os.path.join(path, name)))
                if key in dtypes:
                    t = t.view(getattr(torch, dtypes[key]))
                leaves[key] = t if shardings is not None else t.to(device)
        tree = _unflatten(manifest["tree"], leaves)
        if shardings is not None:
            from repro_torch.dist import sharding as shd
            tree = tree_map(
                lambda t, s: shd.distribute(t.to(s.mesh.device_type), s),
                tree, shardings)
        return tree, manifest["step"]
