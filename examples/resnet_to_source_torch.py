"""The paper's §5 integration demo on the torch port: take a ResNet18
(written in Python), compile it through the LAPIS pipeline for the hand
kernels, and emit a freestanding module with every weight embedded — the
artifact a C++ simulation team would vendor (here a .py needing only
torch+numpy; ``save_cpp`` gives the Kokkos C++ form).

    PYTHONPATH=src python examples/resnet_to_source_torch.py               # the card
    PYTHONPATH=src python examples/resnet_to_source_torch.py --device cpu  # the host
"""
import argparse
import importlib.util
import pathlib
import tempfile

import numpy as np

from repro_torch.core import pipeline
from repro_torch.core.options import CompileOptions
from repro_torch.models.resnet import init_resnet18_weights, resnet18_forward


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    rng = np.random.default_rng(0)
    weights = init_resnet18_weights(rng, width_mult=0.25,
                                    device=args.device)
    image = rng.standard_normal((1, 3, 32, 32)).astype(np.float32)

    # fusion stays on: kokkos.fused regions re-emit their recorded sub-op
    # chains, so the freestanding artifact covers fused graphs too
    mod = pipeline.compile(
        lambda x: resnet18_forward(weights, x, width_mult=0.25), image,
        options=CompileOptions(target="cuda", device=args.device),
        name="forward")
    n_ops = len(mod.graph.ops)
    n_syncs = sum(1 for op in mod.graph.ops if op.opname == "kokkos.sync")
    print(f"[example] lowered ResNet18: {n_ops} IR ops, "
          f"{n_syncs} lazy weight syncs")

    # paper §5: "probabilities = kokkosModule.forward(image)"
    probs = mod.forward(image).cpu().numpy()
    print(f"[example] top-1 class {probs.argmax()}, "
          f"p={probs.max():.4f}, sum={probs.sum():.4f}")

    with tempfile.TemporaryDirectory(prefix="lapis_resnet_") as tmp:
        path = pathlib.Path(tmp) / "resnet18_generated.py"
        mod.save_source(str(path))
        size = len(path.read_text())
        print(f"[example] wrote {path.name} ({size / 1e6:.1f} MB, weights "
              "embedded)")
        spec = importlib.util.spec_from_file_location("resnet_gen", path)
        gen = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gen)
        gen.lapis_initialize()                      # paper §4.4
        probs2 = gen.forward(image).cpu().numpy()
        np.testing.assert_allclose(probs, probs2, rtol=1e-4, atol=1e-5)
        print("[example] freestanding module matches pipeline output: OK")
        gen.lapis_finalize()
    print("OK")


if __name__ == "__main__":
    main()
