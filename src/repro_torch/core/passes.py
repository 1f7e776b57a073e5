"""The LAPIS lowering pipeline (paper §4, Table 4.2) — backend-neutral.

Pass order (mirrors the paper's pipeline; one pipeline for every backend):

1. ``fuse_elementwise``          [beyond paper] chain-fuse elementwise ops
                                 into IR-visible ``kokkos.fused`` region
                                 ops (structured sub-op bodies, no
                                 closures) later lowered to ONE nest.
2. ``sparsify``                  [sparse-compiler-kokkos] pick the storage
                                 layout for sparse-encoded operands (CSR→ELL
                                 ``sparse.convert`` when the backend wants
                                 the vector-parallel layout and the stats
                                 allow) and lower ``linalg.spmv_csr``/
                                 ``linalg.spmm_csr`` to ``kk.spmv``/
                                 ``kk.spmm`` with §4.2 tiling.
3. ``paged_to_kokkos``           [beyond paper] serving-engine paged-KV
                                 cache ops (``paged.gather``/``paged.append``)
                                 → ``kokkos.page_*`` with nest/level_map/
                                 tiling attrs and a SCRATCH-typed block
                                 pool.
4. ``linalg_to_library``         [linalg-to-kokkoskernels] matmul/gemv →
                                 ``kk.*`` library-call ops.
5. ``linalg_to_parallel``        [dense-linalg-to-parallel-loops] remaining
                                 dense ops → *logical* ``kokkos.*`` nests:
                                 the §4.2 decision table (depth 1 → range,
                                 2 → team+vector, ≥3 → league+team+vector),
                                 no hardware names anywhere.
6. ``map_parallelism``           [kokkos-loop-mapping] bind each logical
                                 nest and each ``kk.*`` op to the backend's
                                 declared ParallelHierarchy: physical level
                                 names, exec space, and heuristic block
                                 shapes (team-size / vector-length).
                                 Library backends collapse nests to fused
                                 ``kk.*``-style calls instead.
7. ``memory_space_management``   [kokkos-dualview-management] assign memory
                                 spaces to every value and insert the lazy
                                 ``kokkos.sync`` / ``kokkos.modify`` ops.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import refs
from repro_torch.core.ir import (Graph, KOKKOS_PARALLEL_OPS, LINALG_ELEMENTWISE,
                           LINALG_MATMUL_LIKE, LINALG_REDUCTION,
                           LINALG_SPARSE, LoopLevel, MemorySpace, Op,
                           Region, TensorType, Value, dtype_itemsize)
from repro_torch.core.options import CompileOptions, current_options
from repro_torch.core.passmgr import PassManager, register_pass

# ---------------------------------------------------------------------------
# 1. elementwise fusion (beyond paper — XLA-style producer/consumer fusion)
# ---------------------------------------------------------------------------

_FUSABLE = LINALG_ELEMENTWISE | {"kokkos.fused"}


@register_pass(
    reads="single-use producer->consumer chains of linalg elementwise ops; "
          "the cost model's fusion gate when options.cost_model",
    writes="kokkos.fused region ops (structured sub-op bodies)")
def fuse_elementwise(graph: Graph, options: Optional[CompileOptions] = None
                     ) -> int:
    """Fuse producer→consumer chains of elementwise ops where the
    intermediate value has exactly one use.  Returns #fusions performed.

    With ``options.cost_model`` (or ``autotune``), each candidate pair is
    additionally gated by :meth:`repro_torch.core.costmodel.CostModel.
    fusion_gate`: fuse only when the predicted fused time beats the two
    separate launches (one saved launch overhead plus the fused edge's
    write+re-read moving from main memory to the scratch tier).  On
    backends whose hierarchy declares ``launch_overhead_s=0.0`` — host
    backends whose "launches" jit-trace into one XLA program — the gate
    rejects every pair, which is exactly what ``BENCH_fusion.json``
    measured there (launches 12→1, wall time flat to worse).

    Worklist formulation: the users map is built once and maintained
    incrementally, only the newly fused op is re-enqueued (a fusion can
    enable no other new pair — use counts of uninvolved values never
    change and op kinds never become fusable), and list surgery is O(1)
    per fusion (position map + tombstones compacted once).  The seed
    re-walked the whole op list from the top after every single fusion
    (O(n²) restarts).
    """
    options = options or current_options()
    if not options.fuse_elementwise:
        return 0
    gate = None
    if options.resolve_cost_model():
        from repro_torch.core.costmodel import CostModel
        gate = CostModel.for_options(options)
    fused = 0
    users = graph.users()
    pos = {id(op): i for i, op in enumerate(graph.ops)}
    worklist = collections.deque(op for op in graph.ops
                                 if op.opname in _FUSABLE)
    while worklist:
        op = worklist.popleft()
        if id(op) not in pos:
            continue                        # fused away earlier
        uses = users.get(op.results[0].id, [])
        if len(uses) != 1:
            continue
        user_op, operand_idx = uses[0]
        if user_op is None or user_op.opname not in _FUSABLE:
            continue
        if user_op.results[0].shape != op.results[0].shape:
            continue  # only same-shape chains (no broadcast re-analysis)
        if gate is not None and not gate.fusion_gate(op, user_op):
            continue  # predicted fused time does not beat the two launches
        new = _build_fused_op(op, user_op, operand_idx)
        # O(1) surgery: the fused op takes the consumer's slot; the
        # producer's slot becomes a tombstone compacted after the loop
        graph.ops[pos[id(user_op)]] = new
        pos[id(new)] = pos.pop(id(user_op))
        graph.ops[pos.pop(id(op))] = None
        # targeted rewire: the fused op takes over the consumer's uses …
        taken = users.pop(user_op.results[0].id, [])
        for use_op, i in taken:
            if use_op is None:
                graph.outputs[i] = new.results[0]
            else:
                use_op.operands[i] = new.results[0]
        users[new.results[0].id] = taken
        users.pop(op.results[0].id, None)   # fused-away internal edge
        # … and becomes the user of its operands at the merged indices
        rebuilt = set()
        for i, v in enumerate(new.operands):
            if v.id not in rebuilt:
                rebuilt.add(v.id)
                users[v.id] = [u for u in users.get(v.id, [])
                               if u[0] is not op and u[0] is not user_op]
            users[v.id].append((new, i))
        fused += 1
        worklist.append(new)
    if fused:
        graph.ops = [o for o in graph.ops if o is not None]
    return fused


def _fusion_body(op: Op) -> tuple:
    """``op`` as a fusion body: ``(block_args, sub_ops, out_value)``.

    A ``kokkos.fused`` op contributes its existing region (the op itself
    is discarded by the caller, so reusing its inner ops is safe); a
    plain elementwise op becomes a one-op body over fresh block args
    mirroring its operands positionally.
    """
    if op.opname == "kokkos.fused":
        r = op.regions[0]
        return list(r.inputs), list(r.ops), r.outputs[0]
    args = [Value(o.type) for o in op.operands]
    sub = Op(op.opname, args, [op.results[0].type], attrs=dict(op.attrs))
    return args, [sub], sub.results[0]


def _build_fused_op(producer: Op, consumer: Op, operand_idx: int) -> Op:
    """Merge producer and consumer into one ``kokkos.fused`` region op.

    The fused body is *data*: a Region whose block args correspond
    positionally to the outer operands (producer's first, then the
    consumer's minus the fused edge) and whose ops are the recorded
    sub-op chain — printable by the IR dumper, serializable by the
    emitter, and executable via :func:`repro_torch.core.refs.region_ref`.
    """
    p_args, p_ops, p_out = _fusion_body(producer)
    c_args, c_ops, c_out = _fusion_body(consumer)
    # operand routing: the consumer's block arg at the fused edge becomes
    # the producer body's yielded value
    edge = {c_args[operand_idx].id: p_out}
    for sub in c_ops:
        sub.operands = [edge.get(v.id, v) for v in sub.operands]
    region = Region(inputs=p_args + [a for j, a in enumerate(c_args)
                                     if j != operand_idx],
                    ops=p_ops + c_ops,
                    outputs=[edge.get(c_out.id, c_out)])
    operands = list(producer.operands) + [
        v for j, v in enumerate(consumer.operands) if j != operand_idx]
    return Op("kokkos.fused", operands, [consumer.results[0].type],
              attrs={"ops": tuple(s.opname for s in region.ops)},
              regions=[region])


def _fuse_pair(graph: Graph, producer: Op, consumer: Op,
               operand_idx: int) -> Op:
    """Seed-semantics fusion step (full-graph rewire) — kept as the
    oracle the worklist pass is tested against."""
    new = _build_fused_op(producer, consumer, operand_idx)
    graph.ops[graph.ops.index(consumer)] = new
    graph.ops.remove(producer)
    graph._rewire({consumer.results[0]: new.results[0]})
    return new


# ---------------------------------------------------------------------------
# 2. sparsify (the `--sparse-compiler-kokkos` stage)
# ---------------------------------------------------------------------------

_SPARSE_TO_KK = {
    "linalg.spmv_csr": "kk.spmv",
    "linalg.spmm_csr": "kk.spmm",
}


@register_pass(
    reads="linalg.spmv_csr / linalg.spmm_csr over sparse-encoded operands",
    writes="kk.spmv / kk.spmm with §4.2 tiling (+ CSR->ELL sparse.convert on ell-layout backends)")
def sparsify(graph: Graph,
             options: Optional[CompileOptions] = None) -> int:
    """Lower linalg ops with sparse-encoded operands (paper §5: the
    sparsifier as an ordinary composable pass, not a bolt-on).

    Per op: (i) fold the §4.2 vector-length heuristic
    (:func:`choose_spmv_tiling`) into ``attrs["tiling"]``; (ii) when the
    backend declares the ``ell-layout`` capability *and* the encoding
    carries the static ``max_nnz_row`` bound (Table 6.1 — required for a
    jit-safe fixed ELL width), materialize the layout change as an
    IR-visible ``sparse.convert`` op; (iii) rewrite the linalg op to its
    ``kk.*`` library-call form.  Backends without the ``sparse``
    capability keep the linalg op (the emitter's reference fallback runs
    it), so new plugins opt in by declaring a flag — never by editing
    this pass."""
    options = options or current_options()
    backend = options.backend()
    if not backend.has_capability("sparse"):
        return 0
    from repro_torch.core.costmodel import CostModel
    hier = options.resolve_hierarchy()
    model = CostModel(hier)
    use_model = options.resolve_cost_model()
    rewritten = 0
    for op in list(graph.ops):
        kk = _SPARSE_TO_KK.get(op.opname)
        if kk is None:
            continue
        a, dense = op.operands
        enc = a.type.encoding
        if enc is None or enc.format != "csr":
            continue
        n_rows = a.type.shape[0]
        nnz_mean = (op.attrs.get("nnz_mean") or enc.nnz_mean or
                    (enc.nnz / max(n_rows, 1) if enc.nnz else 1.0))
        itemsize = dtype_itemsize(a.type.dtype)
        n_cols = dense.type.shape[1] if len(dense.type.shape) == 2 else 1
        cands = candidate_spmv_tilings(n_rows, nnz_mean, hier)

        def spmv_cost(t, _n=n_rows, _z=nnz_mean, _i=itemsize, _c=n_cols):
            return model.spmv_cost(_n, _z, _i, t, _c)
        if use_model:
            pred, tiling = model.rank(cands, spmv_cost)[0]
            source = "model"
        else:
            tiling = cands[0]
            pred, source = spmv_cost(tiling), "heuristic"
        cost = {"predicted_us": round(pred * 1e6, 3), "source": source}
        # logical nest of the sparse contraction (bound to physical
        # levels the same way map_parallelism binds dense nests)
        nest = ("league", "team", "vector")
        new_ops = []
        if backend.has_capability("ell-layout") and \
                enc.max_nnz_row is not None:
            ell_type = dataclasses.replace(
                a.type, encoding=enc.with_format("ell"))
            conv = Op("sparse.convert", [a], [ell_type],
                      attrs={"from": "csr", "to": "ell",
                             "max_nnz_row": enc.max_nnz_row,
                             "tiling": tiling})
            new_ops.append(conv)
            a = conv.results[0]
        new = Op(kk, [a, dense], [r.type for r in op.results],
                 attrs={**op.attrs, "tiling": tiling, "cost": cost,
                        "exec_space": hier.exec_space,
                        "level_map": hier.map_levels(nest)})
        new_ops.append(new)
        graph.replace_op(op, new_ops, dict(zip(op.results, new.results)))
        rewritten += 1
    return rewritten


# ---------------------------------------------------------------------------
# 2b. paged_to_kokkos (the serving engine's cache ops)
# ---------------------------------------------------------------------------

_PAGED_TO_KOKKOS = {
    "paged.gather": "kokkos.page_gather",
    "paged.append": "kokkos.page_append",
    "paged.copy": "kokkos.page_copy",
    "paged.swap_out": "kokkos.page_copy",
    "paged.swap_in": "kokkos.page_copy",
}

# block-granular bulk copies (CoW fork, swap-out to the host-side pool,
# swap-in on resume) all lower to one kokkos.page_copy spelling; the
# `direction` attr records which engine path emitted the op
_PAGED_COPY_DIRECTION = {
    "paged.copy": "copy",
    "paged.swap_out": "swap_out",
    "paged.swap_in": "swap_in",
}


@register_pass(
    reads="paged.gather / paged.append over a shared KV block pool + per-slot page table; paged.copy / paged.swap_out / paged.swap_in block-granular arena copies",
    writes="kokkos.page_gather / kokkos.page_append / kokkos.page_copy (direction=copy|swap_out|swap_in) with nest, level_map, tiling, cost; SCRATCH-typed block pool")
def paged_to_kokkos(graph: Graph,
                    options: Optional[CompileOptions] = None) -> int:
    """Lower the block-paged KV-cache ops to the ``kokkos.*`` dialect.

    The serving engine's page-table gather and per-token append are
    ordinary compiled kernels, not host Python: each ``paged.*`` op
    becomes a ``kokkos.page_*`` op carrying (i) a *logical* nest —
    league over cache slots, team over the blocks (gather) or heads
    (append) a slot touches, vector over the contiguous head dim; (ii)
    the physical ``level_map``/``exec_space`` binding from the backend's
    declared :class:`~repro_torch.core.backend.ParallelHierarchy`, exactly like
    ``map_parallelism`` binds dense nests; (iii) a ``tiling`` record
    charging staged blocks against the hierarchy's ``scratch_bytes``
    (``blocks_per_team`` = how many fixed-size KV blocks fit the fast
    tier at once) — which is why the shared block pool operand is typed
    ``MemorySpace.SCRATCH``: pool blocks are the staging unit of the
    paged decode step, sized by the pass to fit the scratch budget, and
    the memory-space machinery from the DualView framework records that
    in the type system.  The emitter dispatches the lowered ops through
    the backend kernel table (``kernels/paged_kv.py``), so
    ``--print-ir-after-all`` shows structured IR and never an opaque
    Python closure.

    The engine's block-granular bulk copies — copy-on-write forks
    (``paged.copy``) and the preemption/swap tier
    (``paged.swap_out`` / ``paged.swap_in``) — lower to one
    ``kokkos.page_copy`` spelling whose ``direction`` attr records which
    engine path emitted it; the nest is league over the copied blocks,
    team over heads, vector over the head dim, and the cost attr charges
    one read + one write of each copied block."""
    options = options or current_options()
    from repro_torch.core.costmodel import CostModel
    hier = options.resolve_hierarchy()
    model = CostModel(hier)
    source = "model" if options.resolve_cost_model() else "heuristic"
    rewritten = 0
    for op in list(graph.ops):
        kk = _PAGED_TO_KOKKOS.get(op.opname)
        if kk is None:
            continue
        if kk == "kokkos.page_copy":
            # block-granular arena-to-arena copy: (dst, src, src_ids,
            # dst_ids).  Arenas are rank 4 (one layer) or rank 5 (the
            # engine's L-stacked pools); the block axis is ndim-4.
            dst, src, src_ids = op.operands[0], op.operands[1], op.operands[2]
            n_blocks, heads, bs, hd = dst.type.shape[-4:]
            layers = 1
            for dim in dst.type.shape[:-4]:
                layers *= dim
            itemsize = dtype_itemsize(dst.type.dtype)
            block_bytes = layers * heads * bs * hd * itemsize
            n_copies = src_ids.type.shape[0]
            dst.type = dst.type.with_space(MemorySpace.SCRATCH)
            src.type = src.type.with_space(MemorySpace.SCRATCH)
            blocks_per_team = max(
                1, min(n_copies,
                       hier.scratch_bytes // max(2 * block_bytes, 1) or 1))
            nest = (LoopLevel("league", n_copies),
                    LoopLevel("team", heads),
                    LoopLevel("vector", hd))
            moved = 2 * n_copies * block_bytes
            pred = model.roofline(bytes_moved=float(moved), flops=0.0,
                                  launches=1)
            new = Op(kk, op.operands, [r.type for r in op.results],
                     attrs={**op.attrs,
                            "direction": _PAGED_COPY_DIRECTION[op.opname],
                            "nest": nest,
                            "tiling": {"blocks_per_team": blocks_per_team,
                                       "block_bytes": block_bytes},
                            "exec_space": hier.exec_space,
                            "level_map": hier.map_levels(
                                tuple(lv.name for lv in nest)),
                            "cost": {"predicted_us": round(pred * 1e6, 3),
                                     "source": source}})
            graph.replace_op(op, [new], dict(zip(op.results, new.results)))
            rewritten += 1
            continue
        pool, table = op.operands[0], op.operands[1]
        n_blocks, heads, bs, hd = pool.type.shape
        n_slots, blocks_per_slot = table.type.shape
        itemsize = dtype_itemsize(pool.type.dtype)
        block_bytes = heads * bs * hd * itemsize
        # fixed-size blocks from the shared pool are the staging unit —
        # typed with the SCRATCH space machinery; the tiling bounds how
        # many a team stages in the fast tier at once
        pool.type = pool.type.with_space(MemorySpace.SCRATCH)
        blocks_per_team = max(
            1, min(blocks_per_slot,
                   hier.scratch_bytes // max(2 * block_bytes, 1) or 1))
        tiling = {"blocks_per_team": blocks_per_team,
                  "block_bytes": block_bytes}
        if kk == "kokkos.page_gather":
            nest = (LoopLevel("league", n_slots),
                    LoopLevel("team", blocks_per_slot),
                    LoopLevel("vector", hd))
            moved = 2 * n_slots * blocks_per_slot * block_bytes
        else:
            nest = (LoopLevel("league", n_slots),
                    LoopLevel("team", heads),
                    LoopLevel("vector", hd))
            moved = 2 * n_slots * heads * hd * itemsize
        pred = model.roofline(bytes_moved=float(moved), flops=0.0,
                              launches=1)
        new = Op(kk, op.operands, [r.type for r in op.results],
                 attrs={**op.attrs, "nest": nest, "tiling": tiling,
                        "exec_space": hier.exec_space,
                        "level_map": hier.map_levels(
                            tuple(lv.name for lv in nest)),
                        "cost": {"predicted_us": round(pred * 1e6, 3),
                                 "source": source}})
        graph.replace_op(op, [new], dict(zip(op.results, new.results)))
        rewritten += 1
    return rewritten


# ---------------------------------------------------------------------------
# 3. linalg-to-kokkoskernels
# ---------------------------------------------------------------------------

_TO_KK = {
    "linalg.matmul": "kk.gemm",
    "linalg.batch_matmul": "kk.batched_gemm",
    "linalg.gemv": "kk.gemv",
}


@register_pass(
    reads="linalg.matmul / linalg.batch_matmul / linalg.gemv",
    writes="kk.gemm / kk.batched_gemm / kk.gemv library-call ops")
def linalg_to_library(graph: Graph,
                      options: Optional[CompileOptions] = None) -> int:
    """Replace recognized linear-algebra ops with ``kk.*`` library-call ops
    (paper: linalg.matmul → kokkos.gemm).  The registry later decides, per
    op, whether the library ("torch") or the custom-kernel ("cuda")
    implementation runs — LAPIS's choice of KokkosBlas vs generated loops."""
    options = options or current_options()
    replaced = 0
    for op in list(graph.ops):
        kk = _TO_KK.get(op.opname)
        if kk is None:
            continue
        new = Op(kk, op.operands, [r.type for r in op.results],
                 attrs=dict(op.attrs))
        graph.replace_op(op, [new],
                         dict(zip(op.results, new.results)))
        replaced += 1
    return replaced


# ---------------------------------------------------------------------------
# 4. dense-linalg-to-parallel-loops (logical kokkos.* nests)
# ---------------------------------------------------------------------------

_LOOPABLE = LINALG_ELEMENTWISE | LINALG_REDUCTION | {"kokkos.fused"}


def _logical_nest(shape: tuple) -> tuple:
    """The paper's nesting-depth → policy decision table (§4.2), producing
    logical level names only: depth 1 → a flat RangePolicy, depth 2 →
    team+vector, depth ≥3 → league(s)+team+vector.  Physical meaning is
    assigned later by ``map_parallelism`` per backend."""
    if not shape:
        return ()
    if len(shape) == 1:
        return (LoopLevel("range", shape[0]),)
    levels = [LoopLevel("league", d) for d in shape[:-2]]
    levels.append(LoopLevel("team", shape[-2]))
    levels.append(LoopLevel("vector", shape[-1]))
    return tuple(levels)


@register_pass(
    reads="remaining dense elementwise / last-axis-softmax ops and kokkos.fused regions",
    writes="logical kokkos.range_parallel / kokkos.team_parallel nests (named LoopLevels, no hardware binding)")
def linalg_to_parallel(graph: Graph,
                       options: Optional[CompileOptions] = None) -> int:
    """Lower remaining dense elementwise/reduction ops to *logical*
    ``kokkos.range_parallel`` / ``kokkos.team_parallel`` nests over their
    iteration space.  Runs for every backend — the nest carries named
    levels (league/team/vector) and trip counts but no hardware mapping,
    so this pass never needs to know whether the target is a TPU grid, a
    GPU block, or a sequential host loop (that is ``map_parallelism``'s
    job, and library backends collapse the nest there)."""
    options = options or current_options()
    lowered = 0
    for op in list(graph.ops):
        if op.opname not in _LOOPABLE:
            continue
        if op.opname in LINALG_REDUCTION:
            # only shape-preserving row reductions (softmax over the last
            # dim) lower to blocked nests — the reduced axis must fit one
            # block and in/out blocks must agree (paper: loops whose
            # structure the mapping can't prove stay at the higher level)
            if op.opname != "linalg.softmax":
                continue
            axis = op.attrs.get("axis", -1)
            ndim = len(op.operands[0].type.shape)
            if axis not in (-1, ndim - 1) or \
                    op.operands[0].type.shape[-1] > 1024:
                continue
            kind = "reduce"
        else:
            kind = "map"
        if any(o.type.shape != op.operands[0].type.shape
               for o in op.operands):
            continue  # broadcasting nests stay at tensor level
        shape = tuple(op.results[0].type.shape)
        nest = _logical_nest(shape)
        opname = ("kokkos.range_parallel" if len(nest) <= 1
                  else "kokkos.team_parallel")
        regions = []
        if op.opname == "kokkos.fused":
            # the whole fused region lowers to ONE logical nest: the body
            # rides along as IR data, its executable meaning derived by
            # region_ref, and every intermediate lives in fast per-team
            # memory for the life of a block (one kernel, no round-trips)
            region = op.regions[0]
            for sub in region.ops:
                for r in sub.results:
                    if r is not region.outputs[0]:
                        r.type = r.type.with_space(MemorySpace.SCRATCH)
            regions.append(region)
            fn = refs.region_ref(region)
        else:
            fn = refs.op_ref(op.opname, op.attrs)
        carried = {k: v for k, v in op.attrs.items()
                   if k in ("axis", "keepdims", "ops")}
        if "exponent" in op.attrs:
            # a 0-d array: the kernel generator spells it, and the IR
            # printer skips arrays, so the dump stays the reference's
            carried["exponent"] = np.asarray(float(op.attrs["exponent"]))
        new = Op(opname, op.operands,
                 [r.type for r in op.results],
                 attrs={"kind": kind, "fn": fn, "src": op.opname,
                        "nest": nest, "iter_space": shape, **carried},
                 regions=regions)
        graph.replace_op(op, [new], dict(zip(op.results, new.results)))
        lowered += 1
    return lowered


# ---------------------------------------------------------------------------
# 5. kokkos-loop-mapping → map_parallelism
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_down_pow2(x: int) -> int:
    return 1 if x <= 1 else 2 ** int(math.log2(x))


def choose_matmul_blocks(m: int, n: int, k: int, itemsize: int,
                         hier) -> dict:
    """Heuristic matmul block shapes — the paper's TeamPolicy team-size /
    vector-length heuristics, driven by the backend's declared
    :class:`~repro_torch.core.backend.ParallelHierarchy`.

    Goals (paper §4.2 adapted): (i) last dim a multiple of the vector
    width so loads coalesce into full registers (TPU: (8,128) tiles);
    (ii) both matmul operands + accumulator fit the scratch budget;
    (iii) contraction dims multiples of the compute unit so the matmul
    engine (MXU / tensor core) is fully occupied.
    """
    unit = hier.compute_unit
    bm = min(_round_up(m, hier.team_width), 64 * hier.team_width)
    bn = min(_round_up(n, hier.vector_width), 4 * hier.vector_width)
    bk = min(_round_up(k, hier.vector_width), 16 * hier.vector_width)
    # shrink until the working set fits scratch: bm*bk + bk*bn + bm*bn
    # (f32 accumulator).  Shrinking must preserve the width alignment the
    # _round_up calls above established — a plain //= 2 can leave e.g.
    # bm=24 → 12 with team_width 8, losing the coalesced-load guarantee —
    # so each step halves *to the next width-aligned value* and stops
    # once a dimension is down to a single width.
    def footprint(bm, bn, bk):
        return (bm * bk + bk * bn) * itemsize + bm * bn * 4

    def shrink(x, width):
        return max(_round_up(x // 2, width), width)
    while footprint(bm, bn, bk) > hier.scratch_bytes // 2:
        nbk = shrink(bk, hier.vector_width)
        nbm = shrink(bm, hier.team_width)
        nbn = shrink(bn, hier.vector_width)
        if bk > unit and nbk < bk:
            bk = nbk
        elif bm >= bn and nbm < bm:
            bm = nbm
        elif nbn < bn:
            bn = nbn
        else:
            break
    return {"bm": bm, "bn": bn, "bk": bk}


def choose_spmv_tiling(n_rows: int, nnz_mean: float, hier) -> dict:
    """The paper's CSR heuristic (§4.2): vector length = ceil(avg nnz/row),
    clamped to the hardware vector width.  On GPU that clamp is the warp
    size (32); on TPU the 128-wide lane unit — either way it is
    ``hier.vector_width``, and the "vector loop" becomes the padded
    per-row width of an ELL-style row block.  Because that width is an
    ELL *storage* width it is always a multiple of the 8-element padding
    unit: a hierarchy declaring a vector width below 8 still gets
    row_width 8."""
    vec = int(math.ceil(max(nnz_mean, 1.0)))
    vec = _round_up(vec, 8)
    # clamp to the *declared* vector width (paper: warp 32; TPU: lane
    # 128) — no hidden 4× padding factor; the floor is the ELL 8-unit
    vec = min(vec, max(hier.vector_width, 8))
    rows_per_block = max(
        hier.team_width,
        _round_down_pow2(hier.scratch_bytes // (8 * vec * 8)))
    rows_per_block = min(rows_per_block, 8 * hier.vector_width,
                         _round_up(n_rows, 8))
    return {"row_block": rows_per_block, "row_width": vec}


def choose_map_blocks(shape: tuple, itemsize: int, n_operands: int,
                      hier) -> dict:
    """Block an elementwise iteration space onto the hierarchy: innermost
    dim → vector lanes, next → team rows, leading dims → outer steps.

    ``n_operands`` counts the live per-block buffers the scratch budget
    must hold at once — the nest's operands plus its result, and for a
    ``kokkos.fused`` region every sub-op intermediate too (they stay
    resident in scratch for the life of the block)."""
    if not shape:
        return {"block": (), "grid": ()}
    if not hier.levels:
        # depth-0 hierarchy (pure library record): nothing to block against
        return {"block": tuple(shape), "grid": (1,) * len(shape)}
    vec, team = hier.levels[-1], (hier.levels[-2] if hier.depth >= 2
                                  else hier.levels[-1])
    block = list(shape)
    block[-1] = min(_round_up(shape[-1], vec.width), vec.max_extent or
                    _round_up(shape[-1], vec.width))
    if len(shape) >= 2:
        block[-2] = min(_round_up(shape[-2], team.width), team.max_extent or
                        _round_up(shape[-2], team.width))
    budget = hier.scratch_bytes // max(2 * n_operands, 2)
    def fp():
        return int(np.prod(block)) * itemsize
    # collapse leading dims into outer steps until it fits
    i = 0
    while fp() > budget and i < len(block):
        block[i] = 1
        i += 1
    while fp() > budget and len(shape) >= 2 and block[-2] > team.width:
        block[-2] //= 2
    grid = tuple(-(-s // b) for s, b in zip(shape, block))
    return {"block": tuple(block), "grid": grid}


# ---------------------------------------------------------------------------
# candidate generation — the choose_* heuristics as candidate generators
# ---------------------------------------------------------------------------
# Each candidate_* function returns a list of legal tilings: the heuristic
# first (candidate 0 — ties in the cost model's stable ranking keep it),
# then width-aligned scalings of each dimension, deduplicated and filtered
# to the same scratch-budget constraint the heuristic honors.  The cost
# model ranks them (options.cost_model); autotune measure-verifies the
# top-k (options.autotune); default compiles just take candidate 0, which
# is exactly the old behaviour.

_CAND_SCALES = (0.5, 2.0, 0.25, 4.0)


def candidate_matmul_blocks(m: int, n: int, k: int, itemsize: int,
                            hier) -> list:
    """Legal matmul block-shape candidates, heuristic first.  Every
    candidate keeps the width alignment and the scratch constraint of
    :func:`choose_matmul_blocks` (working set ≤ scratch_bytes/2)."""
    base = choose_matmul_blocks(m, n, k, itemsize, hier)

    def fits(t):
        return (t["bm"] * t["bk"] + t["bk"] * t["bn"]) * itemsize \
            + t["bm"] * t["bn"] * 4 <= hier.scratch_bytes // 2

    dims = (("bm", hier.team_width, m), ("bn", hier.vector_width, n),
            ("bk", hier.vector_width, k))
    cands, seen = [], set()

    def add(t):
        key = (t["bm"], t["bn"], t["bk"])
        if key not in seen and fits(t):
            seen.add(key)
            cands.append(t)

    add(base)
    for name, width, extent in dims:
        for scale in _CAND_SCALES:
            t = dict(base)
            v = max(_round_up(int(base[name] * scale), width), width)
            t[name] = min(v, _round_up(extent, width))
            add(t)
    for scale in (0.5, 2.0):    # all dims together (isotropic rescale)
        t = {nm: min(max(_round_up(int(base[nm] * scale), w), w),
                     _round_up(ext, w)) for nm, w, ext in dims}
        add(t)
    return cands or [base]      # over-tight scratch: keep the heuristic


def candidate_map_blocks(shape: tuple, itemsize: int, n_operands: int,
                         hier) -> list:
    """Legal elementwise block candidates, heuristic first.  Variants
    rescale the team (second-innermost) block dimension and toggle
    leading-dim collapsing; all stay within the per-block scratch budget
    :func:`choose_map_blocks` charges (footprint ≤ scratch /
    (2 · n_operands))."""
    base = choose_map_blocks(shape, itemsize, n_operands, hier)
    if not shape or not hier.levels:
        return [base]
    budget = hier.scratch_bytes // max(2 * n_operands, 2)
    team_w = hier.team_width
    cands, seen = [], set()

    def add(block):
        block = tuple(int(b) for b in block)
        if any(b < 1 for b in block):
            return
        if int(np.prod(block)) * itemsize > budget:
            return
        if block not in seen:
            seen.add(block)
            cands.append({"block": block,
                          "grid": tuple(-(-s // b)
                                        for s, b in zip(shape, block))})

    bb = list(base["block"])
    add(bb)
    if len(shape) >= 2:
        for scale in _CAND_SCALES:
            b = list(bb)
            v = max(_round_up(int(bb[-2] * scale), team_w), team_w)
            b[-2] = min(v, _round_up(shape[-2], team_w))
            add(b)
    for i in range(len(shape) - 2):   # un-collapse / collapse outer dims
        b = list(bb)
        b[i] = 1 if bb[i] != 1 else shape[i]
        add(b)
    return cands or [base]


def candidate_spmv_tilings(n_rows: int, nnz_mean: float, hier) -> list:
    """Legal SpMV row-block candidates, heuristic first.  Variants
    rescale the row block within the same storage bound the heuristic
    derives from scratch (a row block's padded values+indices planes)."""
    base = choose_spmv_tiling(n_rows, nnz_mean, hier)

    def fits(rb):
        return rb * base["row_width"] * 64 <= hier.scratch_bytes

    cands, seen = [], set()

    def add(rb):
        rb = max(min(int(rb), _round_up(max(n_rows, 1), 8)), 1)
        if rb not in seen and fits(rb):
            seen.add(rb)
            cands.append({"row_block": rb,
                          "row_width": base["row_width"]})

    add(base["row_block"])
    for scale in _CAND_SCALES:
        add(_round_down_pow2(max(int(base["row_block"] * scale), 1)))
    return cands or [base]


def _decide_tiling(op, cands, cost_fn, *, options, model, cache=None,
                   measure_fn=None, shapes=()) -> dict:
    """Pick ``op``'s tiling from ``cands``, set ``attrs["tiling"]`` and
    the ``attrs["cost"]`` record explaining the decision
    (``predicted_us`` + ``source``: heuristic | model | autotune —
    satellite: the IR shows *why* a mapping was picked).

    Autotune path: the per-(backend, op, shape, hierarchy) tuning cache
    is consulted first; a hit replays the stored tiling *and* cost attrs
    verbatim (IR identical to the compile that filled the cache, zero
    re-search).  On a miss the model's top-k candidates are measured on
    the real backend, the winner persisted."""
    from repro_torch.core.costmodel import _json_tiling
    if not options.resolve_cost_model():
        tiling = cands[0]
        op.attrs["tiling"] = tiling
        op.attrs["cost"] = {"predicted_us": round(cost_fn(tiling) * 1e6, 3),
                            "source": "heuristic"}
        return tiling
    ranked = model.rank(cands, cost_fn)
    if options.autotune and cache is not None and measure_fn is not None \
            and len(cands) > 1:
        key = cache.key(options.backend().name, op.opname, shapes,
                        model.hierarchy)
        rec = cache.get(key)
        if rec is not None:
            tiling = _json_tiling(rec["tiling"])
            op.attrs["tiling"] = tiling
            op.attrs["cost"] = dict(rec["cost"])
            return tiling
        top = ranked[:max(int(options.autotune_top_k), 1)]
        measured = [(measure_fn(cand), i, pred, cand)
                    for i, (pred, cand) in enumerate(top)]
        measured.sort(key=lambda t: (t[0], t[1]))   # stable: model order
        sec, _, pred, tiling = measured[0]
        cost = {"predicted_us": round(pred * 1e6, 3),
                "measured_us": round(sec * 1e6, 3),
                "source": "autotune"}
        op.attrs["tiling"] = tiling
        op.attrs["cost"] = cost
        cache.put(key, {
            "opname": op.opname, "backend": options.backend().name,
            "shapes": [list(s) for s in shapes],
            "tiling": {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in tiling.items()},
            "cost": cost})
        return tiling
    pred, tiling = ranked[0]
    op.attrs["tiling"] = tiling
    op.attrs["cost"] = {"predicted_us": round(pred * 1e6, 3),
                        "source": "model"}
    return tiling


def _gemm_measure_fn(op, options):
    """Measure one gemm tiling candidate on the real backend: dispatch
    the op through the registry exactly as the emitter would, with the
    candidate tiling bound, on seeded inputs (measurement is
    deterministic in everything but the clock)."""
    opname = op.opname
    shapes = tuple(tuple(o.type.shape) for o in op.operands)
    dtypes = tuple(o.type.dtype for o in op.operands)

    def measure(tiling):
        import torch
        from repro_torch.core import registry
        from repro_torch.core.costmodel import measure_callable
        from repro_torch.core.tracer import torch_dtype
        fn = registry.dispatch(opname, options)
        rng = np.random.default_rng(0)
        device = options.resolve_device()
        args = tuple(torch.from_numpy(rng.standard_normal(s)).to(
            device=device, dtype=torch_dtype(d))
            for s, d in zip(shapes, dtypes))
        return measure_callable(lambda *xs: fn(*xs, tiling=tiling), args)
    return measure


@register_pass(
    reads="logical kokkos.* nests and kk.gemm / kk.batched_gemm; the backend's ParallelHierarchy; the roofline cost model + tuning cache when options.cost_model/autotune",
    writes='attrs: exec_space, level_map, tiling, cost (predicted_us + decision source; or collapse=True on library backends)')
def map_parallelism(graph: Graph,
                    options: Optional[CompileOptions] = None) -> int:
    """Bind logical parallelism to the backend's declared hierarchy — the
    kokkos-loop-mapping pass, made a pure function of the
    :class:`~repro_torch.core.backend.ParallelHierarchy` record.

    * ``kk.gemm`` / ``kk.batched_gemm`` get block shapes
      (``attrs["tiling"]``) and the hierarchy's physical level names.
    * logical ``kokkos.range_parallel`` / ``kokkos.team_parallel`` nests
      get an ``exec_space``, a logical→physical ``level_map``
      (league/team/vector → e.g. grid/block/lane), and block shapes; on
      backends without the ``loop-nests`` capability the nest is instead
      *collapsed* — marked to execute as a single fused library call
      (``level_map=("fused",)``), the paper's library-interception path.
    * ``kk.spmv`` / ``kk.spmm`` carry tiling + level maps from the
      sparsify pass (their only producer) — nothing to do here.

    Every tiling decision goes through the ``candidate_*`` generators and
    :func:`_decide_tiling`: by default candidate 0 (the old heuristic) is
    taken; with ``options.cost_model`` the roofline model
    (:mod:`repro_torch.core.costmodel`) ranks the candidates; with
    ``options.autotune`` the model's top-k are measure-verified on the
    real backend and the winner persisted in the tuning cache, so repeat
    compiles replay the decision with zero re-search.  Either way the
    decision is recorded on the op as ``attrs["cost"]`` (predicted µs +
    source), visible in ``--print-ir-after-all`` and the emitted C++.

    Supporting a new architecture is therefore declaring a hierarchy on
    its Backend record; this pass is never edited per target.
    """
    from repro_torch.core.costmodel import CostModel, TuneCache
    options = options or current_options()
    hier = options.resolve_hierarchy()
    model = CostModel(hier)
    cache = TuneCache.for_options(options) if options.autotune else None
    loop_nests = options.backend().has_capability("loop-nests")
    mapped = 0
    for op in list(graph.ops):
        if op.opname == "kk.gemm":
            a, b = op.operands
            m, k = a.type.shape
            n = b.type.shape[1]
            itemsize = dtype_itemsize(a.type.dtype)
            _decide_tiling(
                op, candidate_matmul_blocks(m, n, k, itemsize, hier),
                lambda t, _m=m, _n=n, _k=k, _i=itemsize:
                    model.matmul_cost(_m, _n, _k, _i, t),
                options=options, model=model, cache=cache,
                measure_fn=_gemm_measure_fn(op, options),
                shapes=(a.type.shape, b.type.shape))
            op.attrs["exec_space"] = hier.exec_space
            op.attrs["level_map"] = hier.map_levels(
                ("league", "team", "vector"))
            mapped += 1
        elif op.opname == "kk.batched_gemm":
            a, b = op.operands
            *batch, m, k = a.type.shape
            n = b.type.shape[-1]
            itemsize = dtype_itemsize(a.type.dtype)
            # paper §6: for small matrices vectorize the *batch* dimension
            small = m * n <= hier.compute_unit ** 2 // 4
            batch_block = (min(int(np.prod(batch)), hier.team_width * 4)
                           if small else 1)
            cands = [dict(t, batch_block=batch_block,
                          vectorize_batch=small)
                     for t in candidate_matmul_blocks(m, n, k, itemsize,
                                                      hier)]
            nb = int(np.prod(batch))
            _decide_tiling(
                op, cands,
                lambda t, _m=m, _n=n, _k=k, _i=itemsize, _b=nb:
                    _b * model.matmul_cost(_m, _n, _k, _i, t),
                options=options, model=model, cache=cache,
                measure_fn=_gemm_measure_fn(op, options),
                shapes=(a.type.shape, b.type.shape))
            op.attrs["exec_space"] = hier.exec_space
            op.attrs["level_map"] = hier.map_levels(
                ("league(batch)", "team", "vector"))
            mapped += 1
        elif op.opname in KOKKOS_PARALLEL_OPS:
            nest = op.attrs.get("nest", ())
            if not loop_nests:
                # library backends: collapse the nest to one fused
                # kk.*-style call — the vendor library owns the mapping
                op.attrs["exec_space"] = hier.exec_space
                op.attrs["level_map"] = ("fused",) * max(len(nest), 1)
                op.attrs["collapse"] = True
                mapped += 1
                continue
            shape = op.attrs["iter_space"]
            itemsize = dtype_itemsize(op.results[0].type.dtype)
            # live block buffers: one per operand plus one per region
            # sub-op result (fused intermediates stay in scratch for the
            # life of a block), or just the output for a plain nest
            n_scratch = len(op.regions[0].ops) if op.regions else 0
            n_bufs = len(op.operands) + (n_scratch or 1)
            fpe = _nest_flops_per_elem(op)
            _decide_tiling(
                op, candidate_map_blocks(shape, itemsize, n_bufs, hier),
                lambda t, _s=shape, _i=itemsize, _n=len(op.operands),
                       _f=fpe, _sc=n_scratch:
                    model.map_cost(_s, _i, _n, t, flops_per_elem=_f,
                                   n_scratch_bufs=_sc),
                options=options, model=model)
            op.attrs["exec_space"] = hier.exec_space
            op.attrs["level_map"] = hier.map_levels(
                tuple(lv.name for lv in nest))
            mapped += 1
    return mapped


def _nest_flops_per_elem(op: Op) -> float:
    """Per-element flop count of a mapped nest: the sum over its fused
    region's sub-ops, or the single source op's intensity."""
    from repro_torch.core.costmodel import flops_per_elem
    if op.regions:
        return float(sum(flops_per_elem(s.opname)
                         for s in op.regions[0].ops))
    return flops_per_elem(op.attrs.get("src", ""))


# ---------------------------------------------------------------------------
# 6. kokkos-dualview-management → memory_space_management
# ---------------------------------------------------------------------------

@register_pass(
    reads="memory spaces of every SSA value",
    writes="space type attrs; kokkos.sync / kokkos.modify coherence ops")
def memory_space_management(graph: Graph,
                            options: Optional[CompileOptions] = None
                            ) -> int:
    """Assign a memory space to every value and insert the lazy
    ``kokkos.sync`` / ``kokkos.modify`` coherence ops (paper §4.3) — the
    DualView insertion folded into the same space framework the parallel
    dialect uses: spaces are type attrs, coherence is IR-visible ops, and
    "device" means the resolved hierarchy's exec space, not TPU.

    * graph inputs/outputs: DEVICE (they arrive as device tensors);
    * ``tensor.constant``: DUAL — host-resident weights mirrored to device
      on first use (the paper's weights-embedded-in-source story);
    * before the first compute use of a DUAL value: ``kokkos.sync
      {exec_space}`` (lazy: runtime checks the modified flag);
    * after any op writing a DUAL value: ``kokkos.modify {exec_space}``.

    With ``options.lazy_dualview == False`` we emulate baseline-MLIR
    behaviour instead (paper: sparse-gpu-codegen): *eager* copies around
    every kernel — used as the benchmark baseline to show the lazy model's
    win on multi-kernel programs (e.g. per-layer copies in ResNet).
    """
    options = options or current_options()
    exec_space = options.resolve_hierarchy().exec_space
    inserted = 0
    for v in graph.inputs:
        if v.type.memory_space is MemorySpace.ANY:
            v.type = v.type.with_space(MemorySpace.DEVICE)
    synced: set = set()
    new_ops = []
    for op in graph.ops:
        if op.opname == "tensor.constant":
            op.results[0].type = op.results[0].type.with_space(
                MemorySpace.DUAL)
            new_ops.append(op)
            continue
        for operand in op.operands:
            if operand.type.memory_space is MemorySpace.DUAL:
                need = options.lazy_dualview and operand.id not in synced
                need = need or not options.lazy_dualview  # eager: every use
                if need:
                    new_ops.append(Op("kokkos.sync", [operand], [],
                                      attrs={"space": exec_space,
                                             "lazy": options.lazy_dualview}))
                    synced.add(operand.id)
                    inserted += 1
        new_ops.append(op)
        for res in op.results:
            if res.type.memory_space is MemorySpace.ANY:
                res.type = res.type.with_space(MemorySpace.DEVICE)
        if not options.lazy_dualview and op.results \
                and not op.opname.startswith("tensor."):
            # baseline-MLIR emulation (paper §4.3, sparse-gpu-codegen):
            # every kernel's outputs are eagerly copied back to host
            for res in op.results:
                new_ops.append(Op("kokkos.sync", [res], [],
                                  attrs={"space": "host_roundtrip",
                                         "lazy": False}))
                inserted += 1
    graph.ops = new_ops
    return inserted


# ---------------------------------------------------------------------------
# pipeline driver (lapis-opt)
# ---------------------------------------------------------------------------

def run_pipeline(graph: Graph,
                 options: Optional[CompileOptions] = None) -> Graph:
    """``lapis-opt --sparse-compiler-kokkos`` analogue: run the resolved
    backend's pipeline through the PassManager."""
    options = options or current_options()
    pm = PassManager(options.backend().pipeline,
                     verify=options.verify_ir,
                     print_ir_after_all=options.print_ir_after_all)
    return pm.run(graph, options)


# The static-analysis checkers register themselves as named passes here
# (not in analysis.py's import, which must stay passmgr-free to avoid an
# import cycle): importing repro_torch.core.passes is how the registry fills,
# so the analysis passes appear alongside the lowering passes in
# `registered_passes()` and docs/passes.md.
from repro_torch.core import analysis as _analysis  # noqa: E402

_analysis.register_analysis_passes()
