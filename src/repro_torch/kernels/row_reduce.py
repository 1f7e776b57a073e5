"""The launch plan of the row reductions — the twin of ``plan`` in
``csrc/row_reduce.cuh``, which RMSNorm (``csrc/rmsnorm.cu``) and the row
softmax (``csrc/row_softmax.cu``) launch by; the card tests hold the two
equal through each library's exported ``lapis_*_plan``.

A row of ``d`` values is split into 16-byte vectors (8 bf16 or 4 f32
values); a thread of a row holds vectors t, t + tpr, t + 2·tpr, ... in
registers.  The plan picks, from the row count, the width and the card's
SM count:

* ``"warp"``: many rows — a row on one warp (two to eight where its
  vectors would exceed ``MAX_VPT`` a thread), ``ROWS_THREADS`` threads a
  block, when those blocks fill every SM;
* ``"block"``: few rows — one block a row, ceil(vectors / ``ROW_THREADS``)
  vectors a thread;
* ``"general"``: a width off a multiple of the vector, an unaligned base,
  or a width the register instances (or ``max_d``) do not take — one
  block a row, a block-stride loop of scalar loads.
"""
from __future__ import annotations

import ctypes

MAX_VPT = 8              # register instances: 1..8 vectors a thread
ROWS_THREADS = 256       # a "warp" block: its rows share it
ROW_THREADS = 256        # most threads a "block" row takes
GENERAL_THREADS = 256    # most threads a "general" row takes
SOFTMAX_MAX_COLS = 1024  # the widest row the softmax's register path takes
PATHS = ("general", "warp", "block")   # the C plan's path codes
FIELDS = ("path", "vec", "vpt", "tpr", "rows_per_block", "threads", "grid")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_plan(rows: int, d: int, item: int, aligned: bool, sm_count: int,
             max_d: int = 0) -> dict:
    """The launch of ``rows`` rows of ``d`` values of ``item`` bytes.
    ``aligned``: every base 16-byte aligned; ``max_d``: the widest row
    the register path takes (0: no limit but ``MAX_VPT``).  Returns
    ``path``, ``vec`` (values a vector; 1 on the general path), ``vpt``
    (vectors a thread; 0 on the general path), ``tpr`` (threads a row),
    ``rows_per_block``, ``threads`` (a block) and ``grid`` (blocks; the
    general path's kernel walks rows beyond 2**31 - 1)."""
    vec = 16 // item
    if aligned and d > 0 and d % vec == 0 and (max_d <= 0 or d <= max_d):
        nvec = d // vec
        tpr = 32
        while _cdiv(nvec, tpr) > MAX_VPT and tpr < ROWS_THREADS:
            tpr *= 2
        if _cdiv(nvec, tpr) <= MAX_VPT:
            rpb = ROWS_THREADS // tpr
            blocks = _cdiv(rows, rpb)
            if blocks >= sm_count:
                return dict(path="warp", vec=vec, vpt=_cdiv(nvec, tpr),
                            tpr=tpr, rows_per_block=rpb,
                            threads=ROWS_THREADS, grid=blocks)
        vpt = _cdiv(nvec, ROW_THREADS)
        if vpt <= MAX_VPT:
            t = _cdiv(_cdiv(nvec, vpt), 32) * 32
            return dict(path="block", vec=vec, vpt=vpt, tpr=t,
                        rows_per_block=1, threads=t, grid=rows)
    t = min(_cdiv(max(d, 1), 32) * 32, GENERAL_THREADS)
    return dict(path="general", vec=1, vpt=0, tpr=t, rows_per_block=1,
                threads=t, grid=rows)


def c_plan(lib, fn_name: str, rows: int, d: int, item: int, aligned: bool,
           sm_count: int) -> dict:
    """The plan a library's exported ``fn_name`` (``lapis_rmsnorm_plan``,
    ``lapis_row_softmax_plan``) computes, in :func:`row_plan`'s form."""
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(FIELDS))()
    rc = fn(rows, d, item, int(aligned), sm_count, out)
    if rc != 0:
        raise ValueError(f"{fn_name}({rows}, {d}, {item}): error {rc}")
    vals = list(out)
    return dict(zip(FIELDS, [PATHS[vals[0]]] + vals[1:]))

