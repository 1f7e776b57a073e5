"""End-to-end LAPIS pipeline driver (paper §5 + A.1), on torch.

``compile(fn, *specs)`` is the KokkosBackend analogue: trace Python →
tensor IR (torch-mlir analogue), run the lowering pipeline (lapis-opt),
and build an executable torch callable whose hot ops launch the hand
CUDA kernels on the card (``target="cuda"``) or the library (``"torch"``).

CLI (the lapis-opt half, plus running the result)::

    PYTHONPATH=src python -m repro_torch.core.pipeline --demo mlp --target cuda
    PYTHONPATH=src python -m repro_torch.core.pipeline --demo mlp \\
        --target cuda --device cpu --print-ir-after-all
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from repro_torch.core import backend as backend_mod
from repro_torch.core import emitter, passes, tracer
from repro_torch.core.ir import Graph
from repro_torch.core.options import (DEVICES, CompileOptions,
                                      current_options, use_options)


@dataclasses.dataclass
class CompiledModule:
    """Result of the end-to-end pipeline (the paper's kokkosModule)."""

    graph: Graph
    options: CompileOptions
    _callable: Callable

    def __call__(self, *args):
        return self._callable(*args)

    @property
    def forward(self) -> Callable:  # paper: kokkosModule.forward(image)
        return self._callable

    def print_ir(self) -> str:
        return str(self.graph)

    @property
    def launch_count(self):
        """Static kernel-launch count of the built callable (one per
        bound executor; a fused region counts ONE)."""
        return getattr(self._callable, "launch_count", None)


def lapis_opt(graph: Graph,
              options: Optional[CompileOptions] = None) -> Graph:
    """Run the lowering pipeline in place (lapis-opt)."""
    return passes.run_pipeline(graph, options or current_options())


def lapis_translate(graph: Graph,
                    options: Optional[CompileOptions] = None) -> Callable:
    """Build an executable from lowered IR (lapis-translate + build)."""
    return emitter.build_callable(graph, options or current_options())


def compile(fn: Callable, *arg_specs,
            options: Optional[CompileOptions] = None,
            name: Optional[str] = None,
            encodings: Optional[Sequence] = None) -> CompiledModule:
    """Trace → lower → build.  ``arg_specs`` are :class:`~repro_torch.
    core.tracer.TensorSpec`\\ s, or tensors / arrays whose shapes and
    dtypes are taken (the paper's compile-with-concrete-tensors mode);
    ``encodings`` put a ``SparseEncoding`` on argument types.  Runs on
    the card unless ``options.device == "cpu"``; a ``"cuda"`` request
    without a card raises before anything is traced."""
    options = options or current_options()
    options.resolve_device()
    specs = [tracer.TensorSpec.of(a) for a in arg_specs]
    with use_options(options):
        graph = tracer.trace(fn, *specs, name=name, encodings=encodings)
        lapis_opt(graph, options)
        call = lapis_translate(graph, options)
    return CompiledModule(graph=graph, options=options, _callable=call)


# ---------------------------------------------------------------------------
# CLI demo (mirrors `cat input.mlir | lapis-opt | lapis-translate`)
# ---------------------------------------------------------------------------

def _demo_mlp():
    import numpy as np

    from repro_torch.core import ops
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((64, 128), dtype=np.float32)
    b1 = rng.standard_normal((8, 128), dtype=np.float32)
    w2 = rng.standard_normal((128, 10), dtype=np.float32)

    def mlp(x):
        # bias-add → relu is an elementwise chain: fuse_elementwise folds
        # it into one kokkos.fused region (visible in the IR dump, and
        # lowered to a single mapped nest)
        h = ops.relu(ops.add(ops.matmul(x, ops.constant(w1)),
                             ops.constant(b1)))
        return ops.softmax(ops.matmul(h, ops.constant(w2)))

    x = tracer.TensorSpec((8, 64), "float32")
    ex = np.random.default_rng(1).standard_normal((8, 64)) \
        .astype("float32")
    return mlp, (x,), (ex,)


def _demo_spmv():
    """The paper's headline sparse demo: y = relu(A @ x) with A a CSR
    matrix carried as one sparse-encoded composite value and lowered by
    the `sparsify` pass (`lapis-opt --sparse-compiler-kokkos`)."""
    import numpy as np

    from repro_torch.core import ops
    rng = np.random.default_rng(0)
    n, nnz_mean = 512, 12
    lens = np.maximum(rng.poisson(nnz_mean, n), 1).astype(np.int32)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=indptr[1:])
    nnz = int(indptr[-1])
    max_nnz_row = int(lens.max())

    def spmv(ip, ind, val, x):
        return ops.relu(ops.spmv_csr(ip, ind, val, x, n_rows=n,
                                     max_nnz_row=max_nnz_row))

    specs = (tracer.TensorSpec((n + 1,), "int32"),
             tracer.TensorSpec((nnz,), "int32"),
             tracer.TensorSpec((nnz,), "float32"),
             tracer.TensorSpec((n,), "float32"))
    example = (indptr,
               rng.integers(0, n, nnz).astype(np.int32),
               rng.standard_normal(nnz).astype(np.float32),
               rng.standard_normal(n).astype(np.float32))
    return spmv, specs, example


def _demo_paged():
    """The serving engine's paged decode-step cache plumbing: append one
    new KV position per slot into its page-table tail block, then gather
    each slot's contiguous view from the shared pool (lowered by the
    `paged_to_kokkos` pass — the IR dump shows kokkos.page_append /
    kokkos.page_gather with a #scratch-typed block pool)."""
    import numpy as np

    from repro_torch.core import ops
    rng = np.random.default_rng(0)
    n_blocks, heads, bs, hd, n_slots, mb = 17, 2, 8, 16, 4, 4

    def paged_step(pool, table, lengths, kv):
        pool2 = ops.page_append(pool, table, lengths, kv, block_size=bs)
        return ops.page_gather(pool2, table, lengths, block_size=bs)

    specs = (tracer.TensorSpec((n_blocks, heads, bs, hd), "float32"),
             tracer.TensorSpec((n_slots, mb), "int32"),
             tracer.TensorSpec((n_slots,), "int32"),
             tracer.TensorSpec((n_slots, heads, hd), "float32"))
    example = (rng.standard_normal((n_blocks, heads, bs, hd))
               .astype(np.float32),
               rng.integers(1, n_blocks, (n_slots, mb)).astype(np.int32),
               np.array([5, 0, 17, 30], np.int32),
               rng.standard_normal((n_slots, heads, hd)).astype(np.float32))
    return paged_step, specs, example


def _demo_paged_swap():
    """The serving engine's preemption/swap tier: evict a preempted
    request's blocks into the host-side swap arena (paged.swap_out), then
    restore them into freshly allocated pool blocks (paged.swap_in) —
    both lowered by `paged_to_kokkos` to kokkos.page_copy nests whose
    `direction` attr records the engine path."""
    import numpy as np

    from repro_torch.core import ops
    rng = np.random.default_rng(0)
    n_blocks, n_swap, heads, bs, hd = 9, 5, 2, 8, 16

    def swap_round_trip(pool, swap, pool_ids, swap_ids, fresh_ids):
        swap2 = ops.page_swap_out(swap, pool, pool_ids, swap_ids,
                                  block_size=bs)
        return ops.page_swap_in(pool, swap2, swap_ids, fresh_ids,
                                block_size=bs)

    specs = (tracer.TensorSpec((n_blocks, heads, bs, hd), "float32"),
             tracer.TensorSpec((n_swap, heads, bs, hd), "float32"),
             tracer.TensorSpec((3,), "int32"),
             tracer.TensorSpec((3,), "int32"),
             tracer.TensorSpec((3,), "int32"))
    example = (rng.standard_normal((n_blocks, heads, bs, hd))
               .astype(np.float32),
               np.zeros((n_swap, heads, bs, hd), np.float32),
               np.array([2, 5, 7], np.int32),
               np.array([1, 2, 3], np.int32),
               np.array([4, 6, 8], np.int32))
    return swap_round_trip, specs, example


_DEMOS = {"mlp": _demo_mlp, "spmv": _demo_spmv, "paged": _demo_paged,
          "paged_swap": _demo_paged_swap}


_CLI_EPILOG = """\
the demos (--demo):
  mlp    dense 2-layer MLP: matmul -> fused bias+relu region -> matmul ->
         softmax (shows kokkos.fused, TeamPolicy nests, DualView syncs)
  spmv   y = relu(A @ x), A a CSR sparse composite value (shows
         sparse.pack, CSR->ELL sparse.convert on ell-layout backends,
         the kk.spmv row-loop kernel)
  paged  serving-engine paged KV-cache step: page_append then page_gather
         over a shared block pool (shows kokkos.page_* ops with nest/
         level_map/tiling attrs and the #scratch-typed pool)
  paged_swap  the engine's preemption/swap tier: swap_out to the swap
         arena then swap_in to fresh pool blocks, both lowered to
         kokkos.page_copy with a direction attr

examples:
  python -m repro_torch.core.pipeline --demo mlp --target cuda
  python -m repro_torch.core.pipeline --demo spmv --target cuda --device cpu
  python -m repro_torch.core.pipeline --demo paged --target loops \\
      --device cpu --print-ir-after-all
  python -m repro_torch.core.pipeline --demo paged_swap --analyze --device cpu
"""


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="LAPIS pipeline driver (lapis-opt | lapis-translate), "
                    "torch + CUDA",
        epilog=_CLI_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--demo", default="mlp", choices=sorted(_DEMOS),
                   help="which built-in demo graph to compile "
                        "(see epilog; default: %(default)s)")
    p.add_argument("--target", default="auto",
                   choices=backend_mod.available_backends(),
                   help="execution backend (any registered plugin)")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where tensors live; 'cuda' without a card is an "
                        "error (default: %(default)s)")
    p.add_argument("--print-ir", action="store_true")
    p.add_argument("--print-ir-after-all", action="store_true",
                   help="dump IR after every pass (PassManager)")
    p.add_argument("--cost-model", action="store_true",
                   help="rank candidate tilings and gate fusion with the "
                        "roofline cost model (repro_torch.core.costmodel); "
                        "the decision lands on each op as a `cost` attr")
    p.add_argument("--analyze", action="store_true",
                   help="compile with verify=\"full\" (dialect verifier + "
                        "race/sync/scratch/paged-alias checkers between "
                        "every pass) and print the per-module diagnostic "
                        "report; exit 1 on any error-severity diagnostic")
    p.add_argument("--list-backends", action="store_true",
                   help="list registered backends (capabilities, declared "
                        "ParallelHierarchy, pipeline) and exit")
    args = p.parse_args(argv)

    if args.list_backends:
        for b in backend_mod.all_backends():
            caps = ",".join(sorted(b.capabilities)) or "-"
            print(f"{b.name:8s}  caps=[{caps}]")
            print(f"{'':8s}  hierarchy: {b.hierarchy.summary()}")
            print(f"{'':8s}  pipeline=[{' -> '.join(b.pipeline)}]")
            if b.description:
                print(f"{'':8s}  {b.description}")
        return 0

    fn, specs, example = _DEMOS[args.demo]()
    opts = CompileOptions(target=args.target, device=args.device,
                          print_ir_after_all=args.print_ir_after_all,
                          cost_model=args.cost_model,
                          verify_ir="full" if args.analyze else False)
    if args.analyze:
        from repro_torch.core import analysis
        try:
            mod = compile(fn, *specs, options=opts)
        except analysis.AnalysisError as e:
            print(analysis.format_report(args.demo, args.target,
                                         e.diagnostics))
            return 1
        diags = tuple(getattr(mod.graph, "diagnostics", ()))
        print(analysis.format_report(args.demo, args.target, diags))
        return 1 if any(d.severity == analysis.ERROR for d in diags) else 0
    mod = compile(fn, *specs, options=opts)
    if args.print_ir:
        print(mod.print_ir())
    y = mod(*example)
    # the checksum is printed to 1e-5: f32 sums taken in another order
    # (torch's reduction vs the reference's) differ in the last ulps
    print("output shape:", tuple(y.shape), "sum:", round(float(y.sum()), 5))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
