"""LAPIS::DualView runtime (paper §4.3), adapted to numpy/torch.

A DualView manages a buffer that may be used on both host (a numpy array,
or a CPU tensor for a dtype numpy lacks) and device (a torch tensor on the
view's ``device``, ``"cuda"`` unless the caller asks for the CPU).  Each
side carries a *modified* flag; ``sync_host`` / ``sync_device`` copy
**lazily** — only when the opposite side has unsynchronized modifications.
When no transfer is needed the cost of a sync is one boolean check (the
paper's headline property).

Subviews ("children") alias the parent's buffer: they own no storage and
dereference the root's buffers through their slice.  As in the paper,
children share modified flags with their root so multiple children stay
consistent, and ``sync`` on a child syncs its parent.  Root allocations are
kept alive by ordinary Python references (the std::shared_ptr analogue).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

# module-level transfer counters (tests + benchmarks read these)
TRANSFERS = {"h2d": 0, "d2h": 0, "sync_calls": 0}


def reset_transfer_stats() -> None:
    TRANSFERS.update(h2d=0, d2h=0, sync_calls=0)


def _to_device(host, device: str) -> torch.Tensor:
    if isinstance(host, torch.Tensor):
        return host.to(device)
    from repro_torch.convert import numpy_to_torch
    return numpy_to_torch(host).to(device)


def _to_host(dev: torch.Tensor):
    """Writable host copy: numpy where numpy has the dtype, else a CPU
    tensor (bfloat16)."""
    cpu = dev.detach().to("cpu", copy=True)
    try:
        return cpu.numpy()
    except TypeError:
        return cpu


class _Flags:
    """Shared modified-flags object (root-owned; children alias it)."""

    __slots__ = ("modified_host", "modified_device")

    def __init__(self):
        self.modified_host = False
        self.modified_device = False


class DualView:
    """host/device mirrored buffer with lazy flag-driven synchronization."""

    def __init__(self, host=None, device_buf: Optional[torch.Tensor] = None,
                 name: str = "", device: str = "cuda"):
        if host is None and device_buf is None:
            raise ValueError("DualView needs at least one side")
        self._host = host
        self._device = device_buf
        self.device_name = (str(device_buf.device) if device_buf is not None
                            else device)
        self.parent: Optional["DualView"] = None
        self._slice: Tuple = ()
        self.name = name
        self._flags = _Flags()
        if host is not None and device_buf is None:
            self._flags.modified_host = True
        elif device_buf is not None and host is None:
            self._flags.modified_device = True

    # -- construction helpers -------------------------------------------------
    @classmethod
    def from_host(cls, arr, name: str = "",
                  device: str = "cuda") -> "DualView":
        host = arr if isinstance(arr, torch.Tensor) else np.asarray(arr)
        return cls(host=host, name=name, device=device)

    @classmethod
    def from_device(cls, arr: torch.Tensor, name: str = "") -> "DualView":
        return cls(device_buf=arr, name=name)

    def _root(self) -> "DualView":
        dv = self
        while dv.parent is not None:
            dv = dv.parent
        return dv

    @property
    def is_child(self) -> bool:
        return self.parent is not None

    # -- shape/dtype ------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        root = self._root()
        base = root._host if root._host is not None else root._device
        if not self.is_child:
            return tuple(base.shape)
        # slice shape without materializing: index a zero-stride dummy
        return tuple(np.broadcast_to(np.empty((), np.float32),
                                     base.shape)[self._slice].shape)

    @property
    def dtype(self):
        root = self._root()
        side = root._host if root._host is not None else root._device
        return side.dtype

    # -- flags --------------------------------------------------------------------
    @property
    def modified_host(self) -> bool:
        return self._root()._flags.modified_host

    @property
    def modified_device(self) -> bool:
        return self._root()._flags.modified_device

    def modify_host(self) -> None:
        """Mark the host side modified (paper: kokkos.modify)."""
        self._root()._flags.modified_host = True

    def modify_device(self) -> None:
        self._root()._flags.modified_device = True

    # -- materialization -------------------------------------------------------------
    def _ensure_host(self) -> None:
        assert not self.is_child
        if self._host is None:
            self._host = _to_host(self._device)
            TRANSFERS["d2h"] += 1

    def _ensure_device(self) -> None:
        assert not self.is_child
        if self._device is None:
            self._device = _to_device(self._host, self.device_name)
            TRANSFERS["h2d"] += 1

    # -- the lazy syncs (the paper's core mechanism) -----------------------------------
    def sync_device(self) -> None:
        """Make the device side current.  Copies host→device only if the
        host has unsynchronized modifications; otherwise one flag check.
        Child syncs delegate to the root (paper: child sync → parent sync)."""
        TRANSFERS["sync_calls"] += 1
        root = self._root()
        if root._flags.modified_host or root._device is None:
            root._ensure_host()
            root._device = _to_device(root._host, root.device_name)
            TRANSFERS["h2d"] += 1
            root._flags.modified_host = False

    def sync_host(self) -> None:
        TRANSFERS["sync_calls"] += 1
        root = self._root()
        if root._flags.modified_device or root._host is None:
            if root._device is not None:
                root._host = _to_host(root._device)
                TRANSFERS["d2h"] += 1
            root._flags.modified_device = False

    # -- accessors -----------------------------------------------------------------------
    def host_view(self):
        """Host buffer view (no sync — caller syncs for freshness).  Child
        views alias the root's buffer."""
        root = self._root()
        root._ensure_host()
        return root._host[self._slice] if self.is_child else root._host

    def device_view(self) -> torch.Tensor:
        root = self._root()
        root._ensure_device()
        return root._device[self._slice] if self.is_child else root._device

    def host(self):
        """sync_host + host_view."""
        self.sync_host()
        return self.host_view()

    def device(self) -> torch.Tensor:
        self.sync_device()
        return self.device_view()

    # -- writes ------------------------------------------------------------------------------
    def set_host(self, value) -> None:
        """In-place host write through the (possibly aliased) view, then
        mark modified — multiple children of one parent see each other's
        writes immediately, as in the paper."""
        root = self._root()
        if self.is_child:
            # read-modify-write: pull pending device changes first
            self.sync_host()
            root._ensure_host()
            root._host[self._slice] = value
        else:
            root._ensure_host()
            root._host[...] = value
            # whole-buffer replacement supersedes pending device state
            root._flags.modified_device = False
        self.modify_host()

    def set_device(self, value: torch.Tensor) -> None:
        root = self._root()
        if self.is_child:
            # read-modify-write of the root buffer: bring the device side
            # current first (else pending host writes would clobber this
            # update on the next sync_device)
            self.sync_device()
            root._ensure_device()
            root._device[self._slice] = value     # in place on the card
        else:
            root._device = _to_device(value, root.device_name)
            # whole-buffer replacement supersedes any pending host state
            root._flags.modified_host = False
        self.modify_device()

    # -- subviews -------------------------------------------------------------------------------
    def subview(self, slc: Union[slice, Tuple, int],
                name: str = "") -> "DualView":
        """An aliasing child view (paper §4.3: parent/child tree, shared
        flags, refcounted lifetime).  Children of children are supported;
        all share the root's flags."""
        child = DualView.__new__(DualView)
        child._host = None
        child._device = None
        child.device_name = self._root().device_name
        child.parent = self
        child.name = name or f"{self.name}[sub]"
        child._flags = self._root()._flags
        if isinstance(slc, tuple):
            base = self._slice
            child._slice = base + slc if base else slc
        else:
            child._slice = self._slice + (slc,)
        return child

    def __repr__(self) -> str:
        root = self._root()
        side = "host" if root._host is not None else ""
        side += "+device" if root._device is not None else ""
        kind = "child" if self.is_child else side
        return (f"DualView({self.name or hex(id(self))}, "
                f"{kind}, mh={self.modified_host}, "
                f"md={self.modified_device})")


def tree_sync_host(tree) -> int:
    """sync_host every DualView leaf of a tree of dicts, lists and tuples;
    returns the number of actual copies (lazy d2h staging of a whole
    tree, as a checkpoint writer stages its leaves)."""
    before = TRANSFERS["d2h"]
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, DualView):
            node.sync_host()
    return TRANSFERS["d2h"] - before
