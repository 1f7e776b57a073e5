"""ResNet18 and the MALA LDOS surrogate on ``repro_torch.core.ops`` — the
paper's §5 / §6.3 CSE↔ML exemplars (Fig 6.2).  Written once in Python,
they run eagerly or trace into the pipeline, weights embedded as
constants.

The initialisers draw from a ``numpy.random.Generator`` in the
reference's order (``repro.models.resnet``), so one seed gives the same
arrays in both packages; they return torch tensors on ``device``
(``convert.from_numpy_tree`` carries a reference dict the same way).
"""
from __future__ import annotations

import numpy as np

from repro_torch import convert
from repro_torch.core import ops

STAGES = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))


def init_resnet18_weights(rng: np.random.Generator, *, num_classes=1000,
                          width_mult: float = 1.0,
                          device: str = "cuda") -> dict:
    """He-init weights + identity-folded BN stats (inference mode)."""
    def conv(cin, cout, k):
        std = (2.0 / (cin * k * k)) ** 0.5
        return (rng.standard_normal((cout, cin, k, k)) * std).astype(
            np.float32)

    def bn(c):
        return {"scale": np.ones(c, np.float32),
                "bias": np.zeros(c, np.float32),
                "mean": np.zeros(c, np.float32),
                "var": np.ones(c, np.float32)}

    w = int(64 * width_mult)
    p = {"stem": conv(3, w, 7), "stem_bn": bn(w)}
    cin = w
    for si, (cout_base, blocks, stride) in enumerate(STAGES):
        cout = int(cout_base * width_mult)
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            key = f"s{si}b{bi}"
            p[key] = {
                "conv1": conv(cin, cout, 3), "bn1": bn(cout),
                "conv2": conv(cout, cout, 3), "bn2": bn(cout),
            }
            if s != 1 or cin != cout:
                p[key]["down"] = conv(cin, cout, 1)
                p[key]["down_bn"] = bn(cout)
            cin = cout
    p["fc_w"] = (rng.standard_normal((cin, num_classes)) /
                 cin ** 0.5).astype(np.float32)
    p["fc_b"] = np.zeros(num_classes, np.float32)
    return convert.from_numpy_tree(p, device)


def _bn(x, b):
    return ops.batch_norm_inference(x, ops.constant(b["scale"]),
                                    ops.constant(b["bias"]),
                                    ops.constant(b["mean"]),
                                    ops.constant(b["var"]))


def resnet18_forward(weights: dict, x, *, width_mult: float = 1.0):
    """x: (N, 3, H, W) float32 → class probabilities."""
    h = ops.conv2d(x, ops.constant(weights["stem"]), stride=(2, 2),
                   padding="SAME")
    h = ops.relu(_bn(h, weights["stem_bn"]))
    h = ops.max_pool2d(h, window=(3, 3), stride=(2, 2), padding="SAME")
    for si, (cout, blocks, stride) in enumerate(STAGES):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            b = weights[f"s{si}b{bi}"]
            identity = h
            y = ops.conv2d(h, ops.constant(b["conv1"]), stride=(s, s),
                           padding="SAME")
            y = ops.relu(_bn(y, b["bn1"]))
            y = ops.conv2d(y, ops.constant(b["conv2"]), stride=(1, 1),
                           padding="SAME")
            y = _bn(y, b["bn2"])
            if "down" in b:
                identity = _bn(ops.conv2d(identity,
                                          ops.constant(b["down"]),
                                          stride=(s, s), padding="SAME"),
                               b["down_bn"])
            h = ops.relu(ops.add(y, identity))
    h = ops.avg_pool_global(h)                      # (N, C)
    logits = ops.add(ops.matmul(h, ops.constant(weights["fc_w"])),
                     ops.constant(weights["fc_b"]))
    return ops.softmax(logits)


# ---------------------------------------------------------------------------
# MALA-style DNN surrogate (paper §6.3): per-grid-point LDOS prediction MLP
# ---------------------------------------------------------------------------

def init_mala_weights(rng: np.random.Generator, *, fingerprint=91,
                      hidden=(400, 400, 400), ldos=201,
                      device: str = "cuda") -> dict:
    dims = (fingerprint,) + tuple(hidden) + (ldos,)
    p = {f"w{i}": (rng.standard_normal((a, b)) / a ** 0.5).astype(
        np.float32) for i, (a, b) in enumerate(zip(dims, dims[1:]))} | \
        {f"b{i}": np.zeros(b, np.float32)
         for i, b in enumerate(dims[1:])}
    return convert.from_numpy_tree(p, device)


def mala_forward(weights: dict, x):
    """x: (n_grid_points, fingerprint) → LDOS (n_grid_points, ldos)."""
    n = len([k for k in weights if k.startswith("w")])
    h = x
    for i in range(n):
        h = ops.add(ops.matmul(h, ops.constant(weights[f"w{i}"])),
                    ops.constant(weights[f"b{i}"]))
        if i < n - 1:
            h = ops.relu(h)
    return h
