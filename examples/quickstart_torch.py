"""Quickstart on the torch port: the paper's end-to-end story in 50 lines.

Write a model in plain Python → LAPIS traces it to tensor IR → lowering
passes pick library calls vs hand CUDA kernels and insert the lazy memory
model → you get (a) an executable on the card, (b) a freestanding torch
module with the weights embedded, (c) a freestanding Kokkos C++ unit
(the paper's "C++ file with no dependencies besides Kokkos").

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # the host
"""
import argparse
import importlib.util
import pathlib
import tempfile

import numpy as np
import torch

from repro_torch.core import ops, pipeline
from repro_torch.core.options import CompileOptions

rng = np.random.default_rng(0)
w1 = rng.standard_normal((64, 256), dtype=np.float32) * 0.05
b1 = rng.standard_normal((8, 256), dtype=np.float32) * 0.05
w2 = rng.standard_normal((256, 10), dtype=np.float32) * 0.05


def model(x):
    # the bias→gelu chain fuses into one kokkos.fused region — visible
    # in the IR below, executed as a single kernel, and still emittable
    # as freestanding source (the fused body is IR data, not a closure)
    h = ops.gelu(ops.add(ops.matmul(x, ops.constant(w1)),
                         ops.constant(b1)))
    return ops.softmax(ops.matmul(h, ops.constant(w2)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    x = rng.standard_normal((8, 64)).astype(np.float32)

    # 1. compile (trace → lapis-opt → build) for the hand kernels; fusion
    # stays on — the source path is total on fused graphs
    mod = pipeline.compile(model, x, options=CompileOptions(
        target="cuda", device=args.device))
    print("=== lowered IR ===")
    print(mod.print_ir())

    # 2. run it
    probs = mod(x)
    print("\noutput:", tuple(probs.shape), "row sums:",
          probs.sum(-1)[:3].tolist())

    with tempfile.TemporaryDirectory(prefix="lapis_quickstart_") as tmp:
        # 3. emit a freestanding artifact (weights embedded)
        path = pathlib.Path(tmp) / "quickstart_generated.py"
        mod.save_source(str(path))
        print(f"\nwrote {path.name} ({len(path.read_text())} bytes) — "
              "runs with only torch+numpy installed")

        # 4. prove it: import and execute the generated module (its
        # weights load on the compile's device)
        spec = importlib.util.spec_from_file_location("generated", path)
        gen = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gen)
        probs2 = gen.model(x)
        np.testing.assert_allclose(probs.cpu().numpy(),
                                   probs2.cpu().numpy(), rtol=1e-5,
                                   atol=1e-6)
        print(f"generated module output on {probs2.device} matches: OK")

        # 5. the paper's actual artifact: a freestanding Kokkos C++
        # translation unit (lapis-translate) — weights as constant
        # arrays, kokkos.* nests as RangePolicy/TeamPolicy parallel_for
        # launches.  Syntax-check:
        # g++ -std=c++17 -fsyntax-only -I tests/kokkos_stub
        cpp_path = pathlib.Path(tmp) / "quickstart_generated.cpp"
        mod.save_cpp(str(cpp_path))
        cpp = cpp_path.read_text()
        print(f"\nwrote {cpp_path.name} ({len(cpp)} bytes) — depends only "
              "on Kokkos; first kernel:")
        start = cpp.index("Kokkos::parallel_for")
        print("  ..." + cpp[start:start + 120].replace("\n", "\n  ") + "...")
    if args.device == "cuda":
        torch.cuda.synchronize()
    print("OK")


if __name__ == "__main__":
    main()
