"""IR walk helpers shared by the translation layers (paper §4.4).

Both emitters — ``repro_torch.core.emitter`` (executable + freestanding Python)
and ``repro_torch.core.translate`` (freestanding Kokkos C++) — are thin per-op
walks over the post-pipeline graph, in the spirit of *Composable and
Modular Code Generation in MLIR*: fully-structured IR in, one syntax out.
What they share is not syntax but bookkeeping, and that lives here:

* :class:`ValueNamer` — stable SSA-value → variable-name assignment.
  Names are dense and walk-ordered (``arg0…``, ``v1, v2, …``), never
  derived from ``Value.id`` (a process-global counter), so emitted text
  is deterministic across sessions — the property golden-file tests
  depend on.
* :func:`bind_region_args` — the operand routing of a ``kokkos.fused``
  region: block arguments bind positionally to the owning op's operand
  names, giving the region body a local scope both emitters replay the
  same way.
* :func:`constant_label` — the shared ``w0, w1, …`` weight-table naming
  for embedded constants.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.ir import Graph, Op, Value


class ValueNamer:
    """Assign deterministic, emission-order variable names to SSA values.

    ``fresh()`` hands out ``v1, v2, …``; ``bind``/``bind_fresh`` attach a
    name to a :class:`Value`; ``name`` looks it up.  A namer is one
    emission's scope — create a new one per emitted module.
    """

    def __init__(self, prefix: str = "v"):
        self.prefix = prefix
        self._names: dict = {}      # value.id -> name
        self._n = 0

    def fresh(self) -> str:
        self._n += 1
        return f"{self.prefix}{self._n}"

    def bind(self, value: Value, name: str) -> str:
        self._names[value.id] = name
        return name

    def bind_fresh(self, value: Value) -> str:
        return self.bind(value, self.fresh())

    def name(self, value: Value) -> str:
        return self._names[value.id]

    def get(self, value: Value, default: Optional[str] = None):
        return self._names.get(value.id, default)

    def __contains__(self, value: Value) -> bool:
        return value.id in self._names

    # dict-style access keyed by *value id* — lets per-op formatting code
    # accept either a namer (graph scope) or a plain dict (region-local
    # scope) interchangeably
    def __getitem__(self, value_id: int) -> str:
        return self._names[value_id]

    def __setitem__(self, value_id: int, name: str) -> None:
        self._names[value_id] = name

    def bind_inputs(self, graph: Graph, fmt: str = "arg{i}") -> list:
        """Bind every graph input to ``fmt`` (``arg0, arg1, …``); returns
        the names in signature order."""
        return [self.bind(v, fmt.format(i=i))
                for i, v in enumerate(graph.inputs)]


def bind_region_args(op: Op, namer: ValueNamer) -> dict:
    """Region operand routing: map each block argument of ``op``'s first
    region to the *name* of the owning op's operand at the same position
    (the positional-mirroring contract of :class:`repro_torch.core.ir.Region`).
    Returns a local ``value.id -> name`` scope seeded with the bindings.
    """
    region = op.regions[0]
    return {ba.id: namer.name(o)
            for ba, o in zip(region.inputs, op.operands)}


def constant_label(index: int) -> str:
    """The shared weight-table key for the ``index``-th embedded constant
    (``w0, w1, …`` — the paper's globally scoped weight Views)."""
    return f"w{index}"
