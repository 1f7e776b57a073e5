"""Per-device operation counts of one step on meta tensors — the port's
counterpart of the reference's ``launch/hlo.py``.

``hlo.py`` parses XLA's post-SPMD HLO text; torch has no such text.
Here the step runs once on meta tensors (DTensors of local shard shapes
on a ``DeviceMesh``, or plain tensors for one device) under a dispatch
mode that sees every op DTensor hands down to the local shards: the
local ops themselves and the ``_c10d_functional`` collectives DTensor's
sharding propagation emits.  No data exists, so nothing is computed;
the mode counts:

* ``flops`` — the formulas of ``torch.utils.flop_counter``
  (``FlopCounterMode``'s ``flop_registry``: matrix products,
  convolutions, attention) at local shapes, so per device;
* ``bytes`` — |result| + Σ|operands| of each executed op (a kernel that
  reads its inputs once and writes its outputs once, as ``hlo.py``'s
  model of a fusion), free ops skipped: views, ``detach``, allocations,
  ``_to_copy`` that keeps the dtype, the collectives' waits;
* ``collectives`` by kind (the reference's names: ``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``) plus ``total``,
  with ``collective_counts``: Σ operand bytes of each collective;
* ``top_bytes`` / ``top_collectives`` — the ops with the most bytes,
  summed by op (``(bytes, op, "", "<n> calls")``), and the collectives
  by kind and operand shape (``(bytes, kind, op, shape, n)``);
* ``peak_bytes`` — the peak of live meta-tensor bytes the step made
  (the step's inputs excluded), standing in for XLA's
  ``temp_size_in_bytes``.

The port's layers and microbatches are Python loops, so every iteration
runs and is counted: no trip-count pass is needed.  Ops that DTensor
runs on fake tensors to propagate shardings are not counted.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}

_aten = torch.ops.aten
_FREE = {
    _aten.detach, _aten.alias, _aten.lift_fresh, _aten._unsafe_view,
    _aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
    _aten.new_empty_strided,
}


def _bytes(t) -> int:
    return t.numel() * t.element_size() \
        if isinstance(t, torch.Tensor) else 0


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _propagating() -> bool:
    """True while DTensor propagates a sharding on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def _is_free(func, args, out) -> bool:
    packet = func._overloadpacket
    if func.is_view or packet in _FREE:
        return True
    if packet is _aten._to_copy:
        src = args[0]
        return isinstance(out, torch.Tensor) and out.dtype == src.dtype
    return func.namespace == "_c10d_functional" and \
        func.__name__.split(".")[0] not in _COLLECTIVES


class OpCounter(TorchDispatchMode):
    """Counts the local ops of whatever runs under it (see the module
    docstring); ``skip`` holds tensors whose storage is not the step's
    own (its inputs), left out of the live bytes."""

    def __init__(self, skip=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, float] = defaultdict(float)
        self.coll_counts: Dict[str, int] = defaultdict(int)
        self._by_op: Dict[str, list] = defaultdict(lambda: [0.0, 0])
        self._by_coll: Dict[tuple, list] = defaultdict(lambda: [0.0, 0])
        self._skip = {_storage_key(t) for t in skip}
        self._refs: Dict[int, list] = {}
        self.live = 0
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        DT = _dtensor_type()
        if any(issubclass(t, DT) for t in types):
            return NotImplemented          # let DTensor desugar first
        try:
            out = func(*args, **kwargs)
        except RuntimeError as e:
            if _propagating():
                raise
            raise RuntimeError(f"{func} on local shards: {e}") from e
        if not _propagating():
            self._count(func, args, kwargs, out)
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in self._formulas:
            self.flops += float(self._formulas[packet](
                *args, **kwargs, out_val=out))
        if _is_free(func, args, out):
            return
        ins = sum(_bytes(a) for a in tree_leaves((args, kwargs)))
        b = float(ins + sum(_bytes(o) for o in tree_leaves(out)))
        self.bytes += b
        name = str(func)
        slot = self._by_op[name]
        slot[0] += b
        slot[1] += 1
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES[func.__name__.split(".")[0]]
            self.coll[kind] += ins
            self.coll_counts[kind] += 1
            shape = tuple(args[0].shape) if isinstance(
                args[0], torch.Tensor) else ()
            cslot = self._by_coll[(kind, name, str(shape))]
            cslot[0] += ins
            cslot[1] += 1

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._skip:
            return
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [0, t.untyped_storage().nbytes()]
            self.live += ref[1]
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def result(self) -> dict:
        coll = {k: float(v) for k, v in self.coll.items()}
        coll["total"] = float(sum(self.coll.values()))
        top_bytes = sorted(((b, op, "", f"{n} calls")
                            for op, (b, n) in self._by_op.items()),
                           reverse=True)
        top_coll = sorted(((b, kind, op, shape, n) for (kind, op, shape),
                           (b, n) in self._by_coll.items()), reverse=True)
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": coll,
                "collective_counts": dict(self.coll_counts),
                "top_bytes": top_bytes[:25],
                "top_collectives": top_coll[:25],
                "peak_bytes": self.peak}


def local_tensors(tree) -> list:
    """The local tensors of a tree's leaves (a DTensor's shard)."""
    DT = _dtensor_type()
    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, DT):
            out.append(leaf.to_local())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def count(fn: Callable, *args) -> tuple:
    """→ (fn(*args), counts): ``fn`` run once under :class:`OpCounter`,
    its arguments' storages left out of the live bytes."""
    with OpCounter(skip=local_tensors(args)) as counter:
        out = fn(*args)
    return out, counter.result()


def tree_bytes(tree: Any) -> int:
    """Σ local (per-device) bytes of a tree's tensors."""
    return sum(_bytes(t) for t in local_tensors(tree))
