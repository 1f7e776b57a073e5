"""Block-paged KV-cache kernels (``kokkos.page_gather`` / ``page_append``
/ ``page_copy``) — the port of the reference's ``kernels/paged_kv.py``.

The serving engine keeps each sequence's KV history in fixed-size blocks
drawn from a shared pool; a per-slot page table names the blocks in
order.  ``paged_to_kokkos`` lowers the tensor-level ``paged.*`` ops to
the ``kokkos.*`` dialect and the emitter dispatches them here through the
backend registry; this module is the backend *implementation* of those
ops, never the IR's meaning (that lives in ``repro_torch.core.refs``).

Layouts:

* pool    — ``(n_blocks, Hkv, block_size, hd)``; block 0 is the scrap
            block inactive slots write into.
* table   — ``(n_slots, max_blocks)`` int32 block ids.
* lengths — ``(n_slots,)`` int32 valid positions per slot; stale data
            past a slot's length is masked by the consumer, so gather
            never zeroes it.

Implementations per op: ``torch`` (the library gather/scatter, the plain
versions of ``core.ops``), ``loops`` (an explicit league loop over slots;
registered by ``backends/loops.py``), and for the gather the hand CUDA
kernel :func:`page_gather` (``csrc/page_gather.cu``), registered for
``cuda``.  There is no ``cuda`` append or copy, as the reference has no
Pallas one: the ``cuda`` backend's fallback chain serves both from the
``torch`` scatter.  Every op is functional: append and copy return a new
pool.

``kokkos.page_copy`` is the block-granular bulk copy behind the engine's
copy-on-write forks and the preemption/swap tier: operands are
``(dst, src, src_ids, dst_ids)`` arenas of rank 4 (one layer) or rank 5
(layer-stacked pools), and block ``src_ids[c]`` of ``src`` is copied over
block ``dst_ids[c]`` of ``dst``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import refs
from repro_torch.core.backend import register_kernel
from repro_torch.core.ops import (_page_append_ref, _page_copy_ref,
                                  _page_gather_ref)
from repro_torch.kernels import _build


# ---------------------------------------------------------------------------
# torch — the library path (the plain versions)
# ---------------------------------------------------------------------------

def page_gather_torch(pool, table, lengths, *, block_size):
    return _page_gather_ref(block_size)(pool, table, lengths)


def page_append_torch(pool, table, lengths, kv, *, block_size):
    return _page_append_ref(block_size)(pool, table, lengths, kv)


def page_copy_torch(dst, src, src_ids, dst_ids, *, block_size):
    return _page_copy_ref(block_size)(dst, src, src_ids, dst_ids)


# ---------------------------------------------------------------------------
# loops — explicit league loop over slots (the nest attrs, interpreted)
# ---------------------------------------------------------------------------

def page_gather_loops(pool, table, lengths, *, block_size):
    n_slots, blocks_per_slot = table.shape
    rows = []
    for s in range(n_slots):                 # league loop over slots
        blocks = refs.take(pool, table[s], 0)    # (MB, Hkv, bs, hd)
        rows.append(blocks.movedim(0, 1).reshape(
            pool.shape[1], blocks_per_slot * pool.shape[2], pool.shape[3]))
    return torch.stack(rows)


def page_append_loops(pool, table, lengths, kv, *, block_size):
    out = pool.clone()
    for s in range(table.shape[0]):          # league loop over slots
        pos = int(lengths[s])
        blk = int(table[s, pos // block_size])
        out[blk, :, pos % block_size, :] = kv[s].to(out.dtype)
    return out


def page_copy_loops(dst, src, src_ids, dst_ids, *, block_size):
    lead = (slice(None),) * (dst.ndim - 4)   # block axis at ndim - 4
    out = dst.clone()
    for c in range(src_ids.shape[0]):        # league loop over copies
        out[lead + (int(dst_ids[c]),)] = \
            src[lead + (int(src_ids[c]),)].to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# cuda — the hand gather kernel
# ---------------------------------------------------------------------------

MAX_SLOTS = 65535          # grid.y limit
_LAUNCHER: list = []       # the ctypes function, once loaded


def page_gather_kernel() -> _build.KernelSource:
    """The build record of ``csrc/page_gather.cu``."""
    return _build.KernelSource("page_gather", _build.csrc("page_gather.cu"))


def _launcher():
    if not _LAUNCHER:
        fn = _build.load(page_gather_kernel()).lapis_page_gather
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
            [ctypes.c_long, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHER.append(fn)
    return _LAUNCHER[0]


def page_gather(pool, table, lengths, *, block_size):
    """Each slot's contiguous KV view, (n_slots, Hkv, blocks_per_slot ·
    block_size, hd).  On CPU tensors the plain version; on the card one
    thread block per (slot, page) copies the page's slabs (any dtype)."""
    if _build.on_cpu([pool, table, lengths], "page_gather"):
        page_gather.plain_calls += 1
        return _page_gather_ref(block_size)(pool, table, lengths)
    if pool.ndim != 4 or table.ndim != 2 or pool.shape[2] != block_size:
        raise ValueError(f"page_gather: pool {tuple(pool.shape)} and table "
                         f"{tuple(table.shape)} at block_size {block_size}")
    if table.dtype != torch.int32:
        raise TypeError(f"page_gather: table must be int32, not "
                        f"{table.dtype}")
    n_blocks, heads, bs, hd = pool.shape
    n_slots, blocks_per_slot = table.shape
    if n_slots > MAX_SLOTS or n_blocks >= 2**31:
        raise ValueError(f"page_gather: {n_slots} slots (at most "
                         f"{MAX_SLOTS}) over {n_blocks} blocks")
    fn = _launcher()
    pool, table = pool.contiguous(), table.contiguous()
    out = torch.empty((n_slots, heads, blocks_per_slot * bs, hd),
                      dtype=pool.dtype, device=pool.device)
    if out.numel() == 0:
        return out
    slab = bs * hd * pool.element_size()
    vec16 = slab % 16 == 0 and pool.data_ptr() % 16 == 0 and \
        out.data_ptr() % 16 == 0
    _build.check(fn(pool.data_ptr(), table.data_ptr(), out.data_ptr(),
                    n_slots, blocks_per_slot, heads, n_blocks, slab,
                    int(vec16),
                    torch.cuda.current_stream(pool.device).cuda_stream),
                 "page_gather")
    page_gather.launches += 1
    return out


page_gather.launches = 0
page_gather.plain_calls = 0


register_kernel("kokkos.page_gather", "torch", page_gather_torch)
register_kernel("kokkos.page_append", "torch", page_append_torch)
register_kernel("kokkos.page_copy", "torch", page_copy_torch)
register_kernel("kokkos.page_gather", "cuda", page_gather)
# no cuda page_append or page_copy on purpose: the fallback chain routes
# both to the torch scatter (the reference has no Pallas kernel for them)
