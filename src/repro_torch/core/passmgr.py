"""PassManager — named, composable lowering pipelines (lapis-opt's driver).

The seed hardcoded one module-level ``PIPELINE`` tuple for every target;
here passes register by name (:func:`register_pass`) and each
:class:`~repro_torch.core.backend.Backend` declares its pipeline as an ordered
tuple of those names, so per-target composition is data, not code — the
paper's per-backend pass sequencing (Table 4.2) made explicit.

The manager also carries the debugging machinery MLIR's pass manager has
and the seed lacked: per-pass wall time and op-count statistics
(``graph.pass_stats``), between-pass verification (``verify=True`` runs
the dialect verifier, ``verify="full"`` additionally runs every
dataflow checker in ``repro_torch.core.analysis`` — race, sync-state,
scratch-budget, paged-alias — attaching pass-name provenance to each
diagnostic), and ``print_ir_after_all`` IR dumps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

from repro_torch.core.analysis import AnalysisError
from repro_torch.core.ir import Graph
from repro_torch.core.options import CompileOptions, current_options

_PASSES: dict = {}               # name -> pass fn(graph, options) -> int


class IRVerificationError(AnalysisError):
    """The graph violated the dialect/SSA rules after a pass.
    ``.diagnostics`` (inherited from :class:`AnalysisError`) carries the
    structured records, each stamped with the offending pass's name."""


def register_pass(name: Optional[str] = None, *,
                  reads: str = "", writes: str = ""):
    """Decorator registering a pass under ``name`` (default: fn name).
    Idempotent — re-registration replaces the entry, keeping re-imports
    safe.  A pass is ``fn(graph, options) -> int`` (rewrite count).

    ``reads``/``writes`` are one-line IR-contract summaries (what the
    pass consumes and produces); :func:`generate_pass_doc` renders them
    into ``docs/passes.md``, so the reference cannot drift from the
    registry."""
    def deco(fn: Callable) -> Callable:
        pname = name or fn.__name__
        fn.pass_name = pname
        fn.pass_reads = reads
        fn.pass_writes = writes
        _PASSES[pname] = fn
        return fn
    return deco


def get_pass(name: str) -> Callable:
    if name not in _PASSES:
        # builtin passes register on import of repro_torch.core.passes
        import repro_torch.core.passes  # noqa: F401
    try:
        return _PASSES[name]
    except KeyError:
        raise KeyError(f"unknown pass {name!r}; registered: "
                       f"{registered_passes()}") from None


def registered_passes() -> list:
    import repro_torch.core.passes  # noqa: F401
    return sorted(_PASSES)


@dataclasses.dataclass
class PassStat:
    """Per-pass record: what ran, what it did, and what it cost."""

    name: str
    rewrites: int
    seconds: float
    ops_before: int
    ops_after: int


def verify_graph(graph: Graph, options: Optional[CompileOptions] = None,
                 *, pass_name: str = "") -> None:
    """Run the dialect verifier (MLIR's between-pass verifier analogue):
    SSA form *including region scopes*, per-op arity, attr domains.

    Historical note: this used to be a top-level-only SSA walk that
    added region sub-op results to the defined set without ever checking
    region sub-op operands or block-arg arity — region bodies were
    effectively unverified.  It now delegates to
    :func:`repro_torch.core.analysis.verify_module`, which descends."""
    from repro_torch.core import analysis
    errors = [d for d in analysis.verify_module(graph, options,
                                                pass_name=pass_name)
              if d.severity == analysis.ERROR]
    if errors:
        raise IRVerificationError(diagnostics=tuple(errors))


class PassManager:
    """Run an ordered pipeline of registered passes over a graph.

    ``pipeline`` entries are pass names (or bare callables, for tests);
    the default is the resolved backend's pipeline spec.

    ``verify`` levels: ``False`` — nothing; ``True`` — the dialect
    verifier between every pass; ``"full"`` — dialect verifier plus all
    four dataflow checkers (parallel-race, sync-state, scratch-budget,
    paged-alias) between every pass.  Every diagnostic is stamped with
    the name of the pass it first appeared after and accumulated on
    ``graph.diagnostics``; error severity raises
    :class:`IRVerificationError`.
    """

    def __init__(self, pipeline: Optional[Sequence] = None, *,
                 verify=False, print_ir_after_all: bool = False,
                 sink: Callable = print):
        self.pipeline = tuple(pipeline) if pipeline is not None else None
        self.verify = verify
        self.print_ir_after_all = print_ir_after_all
        self.sink = sink

    def _verify_after(self, graph: Graph, options: CompileOptions,
                      pass_name: str) -> None:
        from repro_torch.core import analysis
        diags = analysis.verify_module(graph, options, pass_name=pass_name)
        if self.verify == "full":
            diags.extend(analysis.run_checkers(graph, options,
                                               pass_name=pass_name))
        analysis.record_diagnostics(graph, diags)
        errors = [d for d in diags if d.severity == analysis.ERROR]
        if errors:
            raise IRVerificationError(
                f"IR invalid after pass {pass_name!r}: "
                + "; ".join(d.format() for d in errors),
                diagnostics=tuple(errors))

    def _resolved_pipeline(self, options: CompileOptions) -> tuple:
        if self.pipeline is not None:
            return self.pipeline
        return options.backend().pipeline

    def run(self, graph: Graph,
            options: Optional[CompileOptions] = None) -> Graph:
        options = options or current_options()
        stats: dict = {}
        records: list = []
        for entry in self._resolved_pipeline(options):
            fn = entry if callable(entry) else get_pass(entry)
            name = getattr(fn, "pass_name", getattr(fn, "__name__", str(fn)))
            ops_before = len(graph.ops)
            t0 = time.perf_counter()
            rewrites = int(fn(graph, options) or 0)
            records.append(PassStat(name=name, rewrites=rewrites,
                                    seconds=time.perf_counter() - t0,
                                    ops_before=ops_before,
                                    ops_after=len(graph.ops)))
            stats[name] = rewrites
            if self.print_ir_after_all:
                self.sink(f"// ----- IR after {name} "
                          f"({rewrites} rewrites) -----")
                self.sink(str(graph))
            if self.verify:
                self._verify_after(graph, options, name)
        graph.dce()
        if self.verify:
            self._verify_after(graph, options, "dce")
        graph.pipeline_stats = stats      # name -> rewrite count (seed shape)
        graph.pass_stats = records        # rich per-pass records
        return graph


# ---------------------------------------------------------------------------
# pass reference generation (docs/passes.md — `--doc` subcommand)
# ---------------------------------------------------------------------------

def generate_pass_doc() -> str:
    """Render the pass registry as the markdown reference committed at
    ``docs/passes.md``.  Generated, never hand-edited: the docs-freshness
    test (and CI's docs job) diff the committed file against this
    function's output, so the reference cannot drift from the code."""
    import inspect

    from repro_torch.core.backend import DEFAULT_PIPELINE

    names = registered_passes()
    ordered = [n for n in DEFAULT_PIPELINE if n in names]
    extra = [n for n in names if n not in DEFAULT_PIPELINE]

    lines = [
        "# Pass reference",
        "",
        "<!-- AUTO-GENERATED by `python -m repro_torch.core.passmgr --doc` — do "
        "not edit by hand.",
        "     Regenerate: PYTHONPATH=src python -m repro_torch.core.passmgr "
        "--doc > docs/passes.md",
        "     CI's docs job fails when this file drifts from the pass "
        "registry. -->",
        "",
        "Passes register by name (`repro_torch.core.passmgr.register_pass`); a "
        "backend's",
        "pipeline is an ordered tuple of those names "
        "(see [ARCHITECTURE.md](../ARCHITECTURE.md)).",
        "The default pipeline every shipped backend runs",
        "(`repro_torch.core.backend.DEFAULT_PIPELINE`):",
        "",
        "`" + "` -> `".join(DEFAULT_PIPELINE) + "`",
        "",
        "| # | pass | reads | writes |",
        "|---|------|-------|--------|",
    ]
    for i, n in enumerate(ordered, 1):
        fn = _PASSES[n]
        lines.append(f"| {i} | [`{n}`](#{n}) "
                     f"| {fn.pass_reads or '—'} "
                     f"| {fn.pass_writes or '—'} |")
    for n in extra:
        fn = _PASSES[n]
        lines.append(f"| — | [`{n}`](#{n}) "
                     f"| {fn.pass_reads or '—'} "
                     f"| {fn.pass_writes or '—'} |")
    lines.append("")
    for n in ordered + extra:
        fn = _PASSES[n]
        lines.append(f"## {n}")
        lines.append("")
        if n in ordered:
            lines.append(f"*Position {ordered.index(n) + 1} of "
                         f"{len(ordered)} in `DEFAULT_PIPELINE`.*")
        else:
            lines.append("*Registered, but not part of "
                         "`DEFAULT_PIPELINE`.*")
        if fn.pass_reads or fn.pass_writes:
            lines.append("")
            lines.append(f"**Reads:** {fn.pass_reads or '—'}  ")
            lines.append(f"**Writes:** {fn.pass_writes or '—'}")
        doc = inspect.getdoc(fn)
        if doc:
            lines.append("")
            lines.append(doc)
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.passmgr",
        description="PassManager utilities (lapis-opt's driver)")
    p.add_argument("--doc", action="store_true",
                   help="print the generated pass reference "
                        "(docs/passes.md) and exit")
    args = p.parse_args(argv)
    if args.doc:
        print(generate_pass_doc(), end="")
        return 0
    p.print_help()
    return 0


if __name__ == "__main__":
    # run through the canonical module instance: under `python -m` this
    # file is `__main__`, but passes register into `repro_torch.core.passmgr`
    from repro_torch.core.passmgr import main as _canonical_main
    raise SystemExit(_canonical_main())
