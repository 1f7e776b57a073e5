"""Static analysis & verification for the ``kokkos.*`` IR (lapis-opt's
between-pass discipline).

MLIR's reliability story — every dialect op verified between passes,
structured analyses instead of after-the-fact numeric debugging — ported
to this repo's IR.  Three layers:

* a small **dataflow framework** over :class:`~repro_torch.core.ir.Graph` +
  :class:`~repro_torch.core.ir.Region`: def-use chains that descend into
  region sub-op records (:func:`def_use`), a forward transfer-function
  driver (:func:`run_forward`), and buffer **alias sets**
  (:func:`buffer_alias_sets`) that understand the functional-update
  aliasing of ``paged.*`` pool/arena operands, ``sparse.pack``
  composites, and the positional block-arg ↔ operand mirror of fused
  regions;

* a per-op **dialect verifier** (:func:`verify_module`): SSA form
  including region scopes (the old ``passmgr.verify_graph`` treated
  region bodies as opaque), operand/result arity per ``kokkos.*`` /
  ``paged.*`` / ``sparse.*`` op, ``level_map`` ⊆ the declared
  :class:`~repro_torch.core.backend.ParallelHierarchy` level names,
  region block args mirroring the outer operands positionally, and
  ``direction`` attrs ∈ ``{copy, swap_out, swap_in}``;

* four **checkers** (each also registered as a named analysis pass via
  :func:`register_analysis_passes`):

  ========================  ==================================================
  :func:`check_parallel_races`    write-write / read-write conflicts across
                                  league/team/vector iterations of a nest
  :func:`check_sync_state`        DualView lattice (clean spaces per DUAL
                                  value): device reads of host-modified
                                  buffers without ``kokkos.sync`` are errors,
                                  redundant lazy syncs are warnings
  :func:`check_scratch_budget`    the *decided* tiling of every nest /
                                  library call (fused-region intermediates
                                  included) must fit the backend's declared
                                  ``scratch_bytes``
  :func:`check_paged_alias`       the allocator's CoW contract in IR: no
                                  ``paged.append`` / ``paged.copy`` write
                                  into a block declared refcount-shared
                                  (``attrs["shared_block_ids"]``, exported by
                                  ``runtime.scheduler.BlockAllocator.
                                  shared_blocks``) without a preceding fork
                                  (``paged.copy`` direction=copy with
                                  ``attrs["fork_block_ids"]``)
  ========================  ==================================================

Everything the checkers read about the machine comes from the backend's
*declared* ``ParallelHierarchy`` (``exec_space``, ``levels``,
``scratch_bytes``) — a new backend opts in by declaring a hierarchy,
never by editing a checker.

Entry points: ``PassManager(verify="full")`` runs the verifier + all
four checkers between every pass (diagnostics carry the pass name),
``python -m repro_torch.core.pipeline --demo X --analyze`` prints a per-module
report, and :class:`Diagnostic` records (op, nest path, severity, fix
hint) ride on ``graph.diagnostics`` where the emitter / translate
stages render them as comments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.ir import (KOKKOS_FUSED, KOKKOS_PARALLEL_OPS,
                           LINALG_REDUCTION, PAGE_COPY_DIRECTIONS,
                           Graph, LoopLevel, MemorySpace, Op, Region,
                           dtype_itemsize)

# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One structured finding: which checker, where (op + nest path into
    region bodies), how bad, and how to fix it.  ``pass_name`` is the
    provenance ``PassManager(verify=...)`` attaches — the pass after
    which the graph first exhibited the problem."""

    severity: str                 # ERROR | WARNING
    checker: str                  # dialect | race | sync | scratch | paged-alias
    op: str                       # opname of the offending op
    path: str                     # e.g. "mlp/kokkos.team_parallel(%7)/linalg.exp(%4)"
    message: str
    hint: str = ""                # how to fix it
    pass_name: str = ""           # provenance: pass after which it was found

    def format(self) -> str:
        where = f" after {self.pass_name!r}" if self.pass_name else ""
        s = f"{self.severity}[{self.checker}]{where} {self.path}: {self.message}"
        if self.hint:
            s += f" (hint: {self.hint})"
        return s

    __str__ = format


class AnalysisError(RuntimeError):
    """Raised when verification/analysis finds error-severity
    diagnostics.  ``.diagnostics`` carries the structured records."""

    def __init__(self, message: str = "",
                 diagnostics: Tuple[Diagnostic, ...] = ()):
        if not message and diagnostics:
            message = "; ".join(d.format() for d in diagnostics)
        super().__init__(message)
        self.diagnostics = tuple(diagnostics)


def _path(graph: Graph, op: Op, sub: Optional[Op] = None) -> str:
    name = getattr(graph, "name", None) or "module"

    def one(o: Op) -> str:
        return f"{o.opname}({o.results[0]!r})" if o.results else o.opname

    p = f"{name}/{one(op)}"
    if sub is not None:
        p += f"/{one(sub)}"
    return p


def _resolve_hier(options):
    if options is None:
        return None
    try:
        return options.resolve_hierarchy()
    except Exception:
        return None


# ---------------------------------------------------------------------------
# dataflow framework: def-use chains, forward driver, alias sets
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DefUse:
    """Def-use chains over a graph, *descending into regions* (unlike
    ``Graph.users``, which only reports top-level uses): ``defs`` maps
    value id → ``(kind, obj)`` with kind one of ``input`` / ``op`` /
    ``block-arg`` / ``sub-op``; ``uses`` maps value id → list of
    ``(user_op_or_None, operand_index, path)`` where ``None`` marks a
    graph/region output position."""

    defs: Dict[int, Tuple[str, object]]
    uses: Dict[int, List[Tuple[Optional[Op], int, str]]]


def def_use(graph: Graph) -> DefUse:
    defs: Dict[int, Tuple[str, object]] = {}
    uses: Dict[int, List[Tuple[Optional[Op], int, str]]] = {}
    for v in graph.inputs:
        defs[v.id] = ("input", v)

    def visit_region(owner: Op, region: Region) -> None:
        for arg in region.inputs:
            defs[arg.id] = ("block-arg", arg)
        for sub in region.ops:
            p = _path(graph, owner, sub)
            for i, o in enumerate(sub.operands):
                uses.setdefault(o.id, []).append((sub, i, p))
            for r in sub.results:
                defs[r.id] = ("sub-op", sub)
            for inner in sub.regions:
                visit_region(sub, inner)
        for i, out in enumerate(region.outputs):
            uses.setdefault(out.id, []).append((None, i, _path(graph, owner)))

    for op in graph.ops:
        p = _path(graph, op)
        for i, o in enumerate(op.operands):
            uses.setdefault(o.id, []).append((op, i, p))
        for r in op.results:
            defs[r.id] = ("op", op)
        for region in op.regions:
            visit_region(op, region)
    for i, out in enumerate(graph.outputs):
        uses.setdefault(out.id, []).append((None, i, graph.name))
    return DefUse(defs=defs, uses=uses)


def run_forward(graph: Graph, transfer: Callable, state):
    """Minimal forward dataflow driver: graphs are straight-line SSA
    schedules (no back-edges), so one sweep threading ``state`` through
    ``transfer(state, op) -> state`` reaches the fixpoint."""
    for op in graph.ops:
        state = transfer(state, op)
    return state


class AliasSets:
    """Union-find over value ids — two ids in one set may denote the
    same underlying buffer."""

    def __init__(self):
        self._parent: Dict[int, int] = {}

    def _find(self, x: int) -> int:
        p = self._parent.setdefault(x, x)
        while p != x:
            self._parent[x] = p = self._parent.setdefault(p, p)
            x, p = p, self._parent[p]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self._parent[rb] = ra

    def same(self, a: int, b: int) -> bool:
        return self._find(a) == self._find(b)

    def set_of(self, a: int) -> frozenset:
        root = self._find(a)
        return frozenset(x for x in self._parent if self._find(x) == root)


# ops whose result is a functional update of operand 0 (same logical
# buffer: the serving engine donates it) — the pool/arena aliasing the
# alias analysis must see through
_FUNCTIONAL_UPDATE_OPS = {
    "paged.append", "kokkos.page_append",
    "paged.copy", "paged.swap_out", "paged.swap_in", "kokkos.page_copy",
}


def buffer_alias_sets(graph: Graph) -> AliasSets:
    """Conservative may-alias sets: ``paged.*`` / ``kokkos.page_*``
    results alias their pool/arena operand (functional update of the
    same buffer), ``sparse.pack`` composites alias their component
    planes, and region block args alias the outer operands they mirror
    positionally.  ``sparse.convert`` results are fresh buffers (a
    layout change materializes new storage)."""
    als = AliasSets()

    def visit(op: Op) -> None:
        if op.opname in _FUNCTIONAL_UPDATE_OPS and op.results and op.operands:
            als.union(op.results[0].id, op.operands[0].id)
        elif op.opname == "sparse.pack" and op.results:
            for o in op.operands:
                als.union(op.results[0].id, o.id)
        for region in op.regions:
            for arg, outer in zip(region.inputs, op.operands):
                als.union(arg.id, outer.id)
            for sub in region.ops:
                visit(sub)

    for op in graph.ops:
        visit(op)
    return als


# ---------------------------------------------------------------------------
# per-op kokkos.* dialect verifier
# ---------------------------------------------------------------------------

# opname -> (n_operands, n_results); parallel/fused ops are variadic and
# handled separately
_ARITY = {
    "kokkos.sync": (1, 0),
    "kokkos.modify": (1, 0),
    "kokkos.page_gather": (3, 1),     # pool, table, lengths
    "kokkos.page_append": (4, 1),     # pool, table, lengths, kv
    "kokkos.page_copy": (4, 1),       # dst, src, src_ids, dst_ids
    "paged.gather": (3, 1),
    "paged.append": (4, 1),
    "paged.copy": (4, 1),
    "paged.swap_out": (4, 1),
    "paged.swap_in": (4, 1),
    "sparse.pack": (3, 1),            # indptr, indices, values
    "sparse.convert": (1, 1),
}

# ops whose single region's block args mirror the outer operands
# positionally (the fused-body operand routing contract)
_MIRROR_REGION_OPS = KOKKOS_PARALLEL_OPS | {KOKKOS_FUSED}


def verify_module(graph: Graph, options=None, *,
                  pass_name: str = "") -> List[Diagnostic]:
    """The dialect verifier: SSA form (region scopes included), per-op
    arity, attr domains, block-arg mirroring, level-map validity.
    Returns diagnostics; :func:`verify_or_raise` and
    ``passmgr.verify_graph`` raise on error severity."""
    diags: List[Diagnostic] = []
    hier = _resolve_hier(options)

    def err(op: Op, msg: str, hint: str = "", sub: Optional[Op] = None):
        diags.append(Diagnostic(ERROR, "dialect",
                                (sub or op).opname, _path(graph, op, sub),
                                msg, hint, pass_name))

    def check_attrs(op: Op) -> None:
        nest = op.attrs.get("nest", ())
        if nest and not all(isinstance(lv, LoopLevel) for lv in nest):
            err(op, f"nest attr must be a tuple of LoopLevels, got {nest!r}")
            nest = ()
        level_map = op.attrs.get("level_map")
        if level_map is not None:
            if op.opname in KOKKOS_PARALLEL_OPS and nest and \
                    len(level_map) != len(nest):
                err(op, f"level_map has {len(level_map)} entries for a "
                        f"{len(nest)}-deep nest",
                    "map_parallelism binds one physical level per "
                    "logical nest level")
            if hier is not None:
                legal = set(hier.level_names) | {"fused"}
                bad = [n for n in level_map if n not in legal]
                if bad:
                    err(op, f"level_map names {bad} not declared by the "
                            f"{hier.exec_space!r} hierarchy "
                            f"(legal: {sorted(legal)})",
                        "declare the level on the backend's "
                        "ParallelHierarchy; checkers read declarations, "
                        "not hardcoded names")
        if op.opname == "kokkos.page_copy":
            direction = op.attrs.get("direction")
            if direction not in PAGE_COPY_DIRECTIONS:
                err(op, f"direction attr {direction!r} not in "
                        f"{PAGE_COPY_DIRECTIONS}",
                    "paged_to_kokkos records which engine path (CoW "
                    "fork / swap tier) emitted the copy")
        if op.opname == "kokkos.sync" and "space" not in op.attrs:
            err(op, "kokkos.sync without a space attr",
                "memory_space_management stamps the resolved exec space")
        if op.opname == "sparse.pack" and op.results and \
                not op.results[0].type.is_sparse:
            err(op, "sparse.pack result carries no sparse encoding")

    def check_shape(op: Op) -> None:
        expected = _ARITY.get(op.opname)
        if expected is not None:
            n_in, n_out = expected
            if len(op.operands) != n_in:
                err(op, f"expects {n_in} operands, has {len(op.operands)}")
            if len(op.results) != n_out:
                err(op, f"expects {n_out} results, has {len(op.results)}")
        elif op.opname in _MIRROR_REGION_OPS:
            if not op.operands:
                err(op, "parallel/fused op with no operands")
            if len(op.results) != 1:
                err(op, f"expects exactly 1 result, has {len(op.results)}")
        if op.opname == KOKKOS_FUSED:
            if len(op.regions) != 1:
                err(op, f"kokkos.fused needs exactly 1 region, "
                        f"has {len(op.regions)}")
            else:
                recorded = op.attrs.get("ops")
                actual = tuple(s.opname for s in op.regions[0].ops)
                if recorded is not None and tuple(recorded) != actual:
                    err(op, f"attrs['ops'] {tuple(recorded)} does not match "
                            f"region body {actual}")

    def check_region(op: Op, region: Region) -> None:
        if op.opname in _MIRROR_REGION_OPS:
            if len(region.inputs) != len(op.operands):
                err(op, f"region has {len(region.inputs)} block args for "
                        f"{len(op.operands)} operands",
                    "block args mirror the outer operands positionally "
                    "(the fused-body operand routing)")
            for i, (arg, outer) in enumerate(zip(region.inputs,
                                                 op.operands)):
                if (arg.type.shape, arg.type.dtype) != \
                        (outer.type.shape, outer.type.dtype):
                    err(op, f"block arg {i} is {arg.type.shape}x"
                            f"{arg.type.dtype} but operand {i} is "
                            f"{outer.type.shape}x{outer.type.dtype}")
            if op.opname == KOKKOS_FUSED and len(region.outputs) != 1:
                err(op, f"fused region yields {len(region.outputs)} "
                        f"values, expected 1")
        # region-scope SSA: sub-ops may use block args and earlier
        # sub-op results ONLY (region_ref binds exactly that — outer
        # capture would not execute)
        scope = {a.id for a in region.inputs}
        for sub in region.ops:
            for o in sub.operands:
                if o.id not in scope:
                    err(op, f"uses {o!r} which is neither a block arg "
                            f"nor an earlier sub-op result", sub=sub)
            for r in sub.results:
                scope.add(r.id)
            for inner in sub.regions:
                check_region(sub, inner)
            check_attrs(sub)
        for out in region.outputs:
            if out.id not in scope:
                err(op, f"region yields undefined value {out!r}")

    defined = {v.id for v in graph.inputs}
    for op in graph.ops:
        for o in op.operands:
            if o.id not in defined:
                err(op, f"uses {o!r} before definition")
        check_shape(op)
        check_attrs(op)
        for region in op.regions:
            check_region(op, region)
        for r in op.results:
            defined.add(r.id)
    for v in graph.outputs:
        if v.id not in defined:
            diags.append(Diagnostic(
                ERROR, "dialect", "func.return",
                f"{getattr(graph, 'name', 'module')}/return",
                f"graph output {v!r} is undefined", "", pass_name))
    return diags


def verify_or_raise(graph: Graph, options=None, *,
                    pass_name: str = "") -> None:
    errors = [d for d in verify_module(graph, options, pass_name=pass_name)
              if d.severity == ERROR]
    if errors:
        raise AnalysisError(diagnostics=tuple(errors))


# ---------------------------------------------------------------------------
# checker 1: parallel race detector
# ---------------------------------------------------------------------------

def check_parallel_races(graph: Graph, options=None, *,
                         pass_name: str = "") -> List[Diagnostic]:
    """Flag write-write / read-write conflicts on one buffer across the
    league/team/vector iterations of a ``kokkos.range_parallel`` /
    ``team_parallel`` nest (``kokkos.fused`` bodies ride inside one).

    A mapped nest writes its output with the identity iteration→element
    map, so a conflict needs one of:

    * **surjectivity overflow** — a ``kind="map"`` nest with more
      iterations than output elements: two iterations land on the same
      element (write-write).  Reduction nests (``kind="reduce"``) are
      exempt — their combine semantics make concurrent accumulation
      well-defined.
    * **in-place aliasing** — the nest's result buffer may-alias one of
      its operands (:func:`buffer_alias_sets`): an iteration's write
      races another's read (read-write).  The ``kokkos.page_*`` ops are
      excluded; their block-disjointness contract is
      :func:`check_paged_alias`'s job.
    * **reduction inside a map body** — a fused-region sub-op from
      ``LINALG_REDUCTION`` inside a ``kind="map"`` nest reads across
      the very iterations the map parallelizes.
    * **declared non-injective index map** — a sub-op whose
      ``attrs["index_map"]`` (tuple: output dim written per nest level,
      ``-1`` = the write does not vary with that level) repeats a dim
      or contains ``-1``: distinct iterations of that level collide.
    """
    diags: List[Diagnostic] = []
    als = buffer_alias_sets(graph)

    def emit(op: Op, msg: str, hint: str, sub: Optional[Op] = None):
        diags.append(Diagnostic(ERROR, "race", (sub or op).opname,
                                _path(graph, op, sub), msg, hint,
                                pass_name))

    for op in graph.ops:
        if op.opname not in KOKKOS_PARALLEL_OPS:
            continue
        nest = op.attrs.get("nest", ())
        if not nest or op.attrs.get("collapse"):
            continue          # logical-only or library-collapsed: serialized
        kind = op.attrs.get("kind", "map")
        trips = int(np.prod([lv.trip for lv in nest], initial=1))
        out_elems = int(np.prod(op.results[0].type.shape, initial=1))
        if kind == "map" and trips > out_elems:
            emit(op, f"write-write: {trips} parallel iterations map onto "
                     f"{out_elems} output elements",
                 "shrink the nest to the output shape, or mark the op "
                 "kind=\"reduce\" if iterations combine")
        for o in op.operands:
            if als.same(op.results[0].id, o.id):
                emit(op, f"read-write: result buffer may alias operand "
                         f"{o!r} — an iteration's write races another's "
                         f"read",
                     "materialize the output out-of-place (SSA results "
                     "are fresh buffers)")
                break
        for region in op.regions:
            for sub in region.ops:
                if kind == "map" and sub.opname in LINALG_REDUCTION:
                    emit(op, f"reduction sub-op inside a kind=\"map\" "
                             f"nest reads across parallel iterations",
                         "keep reductions out of fused map bodies "
                         "(linalg_to_parallel lowers them as "
                         "kind=\"reduce\" nests)", sub=sub)
                imap = sub.attrs.get("index_map")
                if imap is not None:
                    ims = tuple(imap)
                    if -1 in ims or len(set(ims)) < len(ims):
                        emit(op, f"non-injective index_map {ims}: "
                                 f"distinct iterations write the same "
                                 f"element",
                             "every nest level must map to a distinct "
                             "output dim", sub=sub)
    return diags


# ---------------------------------------------------------------------------
# checker 2: DualView sync-state
# ---------------------------------------------------------------------------

def check_sync_state(graph: Graph, options=None, *,
                     pass_name: str = "") -> List[Diagnostic]:
    """DualView coherence as a forward lattice: each DUAL-space value
    carries the set of memory spaces whose copy is clean.

    * ``tensor.constant`` results start host-clean (host authoritative,
      device stale) — as does any DUAL value with no recorded producer;
    * ``kokkos.sync {space}`` adds ``space`` to the clean set (a second
      lazy sync of the same value to a space an earlier sync already
      established — with no ``kokkos.modify`` in between — is a
      **warning**: redundant);
    * ``kokkos.modify {space}`` collapses the clean set to ``{space}``;
    * any other op reading a DUAL operand needs its execution space
      (``attrs["exec_space"]``, else the resolved hierarchy's) in the
      clean set — a device read of a host-modified buffer without an
      intervening sync is an **error**.

    Eager-baseline ``host_roundtrip`` syncs (``lazy_dualview=False``)
    mark the host copy clean and are never flagged redundant.
    """
    diags: List[Diagnostic] = []
    hier = _resolve_hier(options)
    default_space = hier.exec_space if hier is not None else None
    state: Dict[int, frozenset] = {}
    synced: set = set()           # (vid, space) pairs an explicit sync set

    def clean_of(v) -> frozenset:
        return state.get(v.id, frozenset({"host"}))

    def transfer(st, op: Op):
        if op.opname == "kokkos.sync" and op.operands:
            v = op.operands[0]
            if v.type.memory_space is MemorySpace.DUAL:
                space = op.attrs.get("space", default_space)
                if space == "host_roundtrip":
                    st[v.id] = clean_of(v) | {"host"}
                elif space is not None:
                    if (v.id, space) in synced and \
                            op.attrs.get("lazy", True):
                        diags.append(Diagnostic(
                            WARNING, "sync", op.opname, _path(graph, op),
                            f"redundant kokkos.sync: an earlier sync "
                            f"already made {v!r} {space}-clean",
                            "the lazy DualView model syncs once per "
                            "value; drop the extra sync", pass_name))
                    synced.add((v.id, space))
                    st[v.id] = clean_of(v) | {space}
            return st
        if op.opname == "kokkos.modify" and op.operands:
            v = op.operands[0]
            if v.type.memory_space is MemorySpace.DUAL:
                space = op.attrs.get("space", default_space) or "host"
                st[v.id] = frozenset({space})
                # a modify dirties the other copies: earlier syncs no
                # longer shield a later (now necessary) sync
                synced.difference_update({p for p in synced
                                          if p[0] == v.id})
            return st
        space = op.attrs.get("exec_space", default_space)
        if space is not None:
            for o in op.operands:
                if o.type.memory_space is MemorySpace.DUAL and \
                        space not in clean_of(o):
                    dirty = "/".join(sorted(clean_of(o))) or "nowhere"
                    diags.append(Diagnostic(
                        ERROR, "sync", op.opname, _path(graph, op),
                        f"{space} read of DUAL buffer {o!r} that is "
                        f"clean only on {dirty}",
                        f"insert kokkos.sync {{space={space}}} before "
                        f"the first use (memory_space_management does)",
                        pass_name))
        for r in op.results:
            if r.type.memory_space is MemorySpace.DUAL:
                # freshly produced DUAL data is authoritative where the
                # producer ran; tensor.constant materializes host-side
                st[r.id] = frozenset({"host"} if op.opname ==
                                     "tensor.constant"
                                     else {space or "host"})
        return st

    run_forward(graph, transfer, state)
    return diags


# ---------------------------------------------------------------------------
# checker 3: scratch budget
# ---------------------------------------------------------------------------

def check_scratch_budget(graph: Graph, options=None, *,
                         pass_name: str = "") -> List[Diagnostic]:
    """Hard-fail any op whose *decided* tiling needs more fast-tier
    bytes than the backend's declared ``scratch_bytes``.  The tiling
    heuristics (``choose_*`` in passes.py) *aim* for the budget; this
    checker verifies the IR they actually produced — including the
    clamp-to-one floors that can silently exceed it.

    Footprints mirror the deciders' own accounting:

    * mapped nests — ``prod(block) × itemsize × n_bufs`` where
      ``n_bufs`` counts operands + result and, for a fused region,
      every sub-op intermediate (they stay scratch-resident for the
      life of a block);
    * ``kk.gemm`` / ``kk.batched_gemm`` — both input panels at operand
      width plus the f32 accumulator block;
    * ``kk.spmv`` / ``kk.spmm`` — a row block's padded values+indices
      planes (the ``candidate_spmv_tilings`` storage bound);
    * ``kokkos.page_*`` — ``2 × blocks_per_team × block_bytes`` staged
      blocks (source + destination staging).
    """
    hier = _resolve_hier(options)
    if hier is None or not getattr(hier, "scratch_bytes", 0):
        return []
    budget = hier.scratch_bytes
    diags: List[Diagnostic] = []
    for op in graph.ops:
        tiling = op.attrs.get("tiling")
        if not isinstance(tiling, dict):
            continue
        footprint = None
        detail = ""
        if "block" in tiling and op.opname in KOKKOS_PARALLEL_OPS:
            itemsize = dtype_itemsize(op.results[0].type.dtype)
            n_scratch = len(op.regions[0].ops) if op.regions else 0
            n_bufs = len(op.operands) + (n_scratch or 1)
            footprint = int(np.prod(tiling["block"], initial=1)) \
                * itemsize * n_bufs
            detail = (f"block {tuple(tiling['block'])} × {n_bufs} live "
                      f"buffers ({len(op.operands)} operands + "
                      f"{n_scratch or 1} scratch/output)")
        elif {"bm", "bn", "bk"} <= tiling.keys():
            itemsize = dtype_itemsize(op.operands[0].type.dtype)
            bm, bn, bk = tiling["bm"], tiling["bn"], tiling["bk"]
            footprint = (bm * bk + bk * bn) * itemsize + bm * bn * 4
            detail = f"panels bm={bm} bn={bn} bk={bk} + f32 accumulator"
        elif "blocks_per_team" in tiling:
            footprint = 2 * tiling["blocks_per_team"] \
                * tiling["block_bytes"]
            detail = (f"{tiling['blocks_per_team']} staged KV blocks × "
                      f"{tiling['block_bytes']}B × 2 (src+dst staging)")
        elif "row_block" in tiling and "row_width" in tiling:
            footprint = tiling["row_block"] * tiling["row_width"] * 64
            detail = (f"row block {tiling['row_block']} × padded width "
                      f"{tiling['row_width']} values+indices planes")
        if footprint is not None and footprint > budget:
            diags.append(Diagnostic(
                ERROR, "scratch", op.opname, _path(graph, op),
                f"scratch footprint {footprint}B exceeds the declared "
                f"scratch_bytes={budget}B ({detail})",
                "shrink the tiling or declare a larger scratch tier on "
                "the backend's ParallelHierarchy", pass_name))
    return diags


# ---------------------------------------------------------------------------
# checker 4: paged-alias (the allocator's CoW contract, in IR)
# ---------------------------------------------------------------------------

_PAGED_WRITE_OPS = {"paged.append", "kokkos.page_append",
                    "paged.copy", "paged.swap_out", "paged.swap_in",
                    "kokkos.page_copy"}


def check_paged_alias(graph: Graph, options=None, *,
                      pass_name: str = "") -> List[Diagnostic]:
    """Enforce the block allocator's copy-on-write contract in IR: no
    ``paged.append`` / ``paged.copy`` may write into a block reachable
    through a refcount-shared (rc > 1) page-table mapping without a
    preceding fork.

    Refcounts are runtime state, so the invariant crosses into IR as
    attrs: ``runtime.scheduler.BlockAllocator.shared_blocks()`` exports
    the rc > 1 ids, a write op declares the shared ids it targets as
    ``attrs["shared_block_ids"]``, and a CoW fork — ``paged.copy`` with
    ``direction="copy"`` — declares the ids it privatized as
    ``attrs["fork_block_ids"]`` (``ContinuousScheduler.prepare_append``
    is the engine path producing exactly that fork).  Walking the ops
    in program order, any declared shared target not yet forked is an
    error."""
    diags: List[Diagnostic] = []
    forked: set = set()
    for op in graph.ops:
        if op.opname not in _PAGED_WRITE_OPS:
            continue
        direction = op.attrs.get(
            "direction",
            {"paged.swap_out": "swap_out",
             "paged.swap_in": "swap_in"}.get(op.opname, "copy"))
        if direction == "copy":
            forked |= {int(b) for b in
                       op.attrs.get("fork_block_ids", ()) or ()}
        shared = {int(b) for b in
                  op.attrs.get("shared_block_ids", ()) or ()}
        offenders = sorted(shared - forked)
        if offenders:
            diags.append(Diagnostic(
                ERROR, "paged-alias", op.opname, _path(graph, op),
                f"writes into refcount-shared block(s) {offenders} "
                f"without a copy-on-write fork",
                "fork first: paged.copy direction=copy with "
                "fork_block_ids (ContinuousScheduler.prepare_append "
                "returns the (src, dst) fork)", pass_name))
    return diags


# ---------------------------------------------------------------------------
# driver: all checkers, full report, pass registration
# ---------------------------------------------------------------------------

CHECKERS: Dict[str, Callable] = {
    "race": check_parallel_races,
    "sync": check_sync_state,
    "scratch": check_scratch_budget,
    "paged-alias": check_paged_alias,
}


def run_checkers(graph: Graph, options=None, *,
                 pass_name: str = "") -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for checker in CHECKERS.values():
        diags.extend(checker(graph, options, pass_name=pass_name))
    return diags


def analyze_graph(graph: Graph, options=None, *,
                  pass_name: str = "") -> List[Diagnostic]:
    """Dialect verifier + all four checkers over one graph."""
    diags = verify_module(graph, options, pass_name=pass_name)
    diags.extend(run_checkers(graph, options, pass_name=pass_name))
    return diags


def format_report(graph_name: str, target: str,
                  diags: Iterable[Diagnostic]) -> str:
    """The ``--analyze`` per-module report."""
    diags = list(diags)
    errors = [d for d in diags if d.severity == ERROR]
    warnings = [d for d in diags if d.severity == WARNING]
    lines = [f"== analysis: {graph_name} (target={target}) ==",
             f"checks: dialect, {', '.join(CHECKERS)}",
             f"errors: {len(errors)}  warnings: {len(warnings)}"]
    for d in errors + warnings:
        lines.append(f"  {d.format()}")
    if not diags:
        lines.append("  clean")
    return "\n".join(lines)


def register_analysis_passes() -> None:
    """Register the verifier and checkers as named passes (idempotent),
    so pipelines can interleave them explicitly and ``docs/passes.md``
    documents them.  As a pass, a checker raises :class:`AnalysisError`
    on error severity, records everything on ``graph.diagnostics``, and
    returns its diagnostic count."""
    from repro_torch.core.passmgr import register_pass

    def as_pass(fn, name, reads):
        def pass_fn(graph, options=None):
            diags = fn(graph, options)
            record_diagnostics(graph, diags)
            errors = [d for d in diags if d.severity == ERROR]
            if errors:
                raise AnalysisError(diagnostics=tuple(errors))
            return len(diags)
        pass_fn.__name__ = name
        pass_fn.__doc__ = fn.__doc__
        register_pass(name, reads=reads,
                      writes="diagnostics only (graph.diagnostics); "
                             "raises AnalysisError on error severity")(
            pass_fn)

    as_pass(lambda g, o: verify_module(g, o), "verify_kokkos_dialect",
            "every op: SSA form incl. region scopes, arity, level_map "
            "vs the declared hierarchy, direction/space attr domains")
    as_pass(check_parallel_races, "check_parallel_races",
            "kokkos.range_parallel / team_parallel nests, fused-region "
            "sub-ops, buffer alias sets")
    as_pass(check_sync_state, "check_sync_state",
            "DUAL-space values, kokkos.sync / kokkos.modify ops, "
            "per-op exec_space")
    as_pass(check_scratch_budget, "check_scratch_budget",
            "tiling attrs of mapped nests / kk.gemm / kk.spmv / "
            "kokkos.page_* vs the hierarchy's scratch_bytes")
    as_pass(check_paged_alias, "check_paged_alias",
            "shared_block_ids / fork_block_ids attrs on paged write "
            "ops (the allocator's exported rc invariant)")
    # the verifier's docstring lives on verify_module
    register_analysis_passes.done = True


def record_diagnostics(graph: Graph,
                       diags: Iterable[Diagnostic]) -> None:
    """Accumulate diagnostics on ``graph.diagnostics``, deduplicated by
    (checker, path, message) so a warning re-found after every pass
    keeps its earliest pass provenance."""
    diags = list(diags)
    if not diags:
        return
    existing = list(getattr(graph, "diagnostics", ()))
    seen = {(d.checker, d.path, d.message) for d in existing}
    for d in diags:
        key = (d.checker, d.path, d.message)
        if key not in seen:
            seen.add(key)
            existing.append(d)
    graph.diagnostics = existing
