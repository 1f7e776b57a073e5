"""The benchmark's weights and inputs, drawn on the device from the seed.

One ``torch.Generator`` per run, seeded with ``--seed``, draws every
leaf in one call in the dtype it is used in, in the tree's sorted order,
so the same seed gives the same tensors.  The tree's shapes and the kind
of each leaf come from the port's parameter specs (its interface); the
values are the benchmark's, and the reference reads the same tensors.

Scales: a matrix N(0, 1/fan_in) (fan_in its second-last dim, as the
port's ``xavier``), an embedding or head N(0, 0.02²), a bias N(0, 0.02²)
and a norm scale 1 + N(0, 0.1²), so the biases and the norm scales are
exercised, not zeros and ones.
"""
from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    return g


def normal(gen: torch.Generator, shape, std: float, dtype, device,
           mean: float = 0.0) -> torch.Tensor:
    t = torch.randn(tuple(shape), generator=gen, dtype=dtype, device=device)
    t.mul_(std)
    if mean:
        t.add_(mean)
    return t


def leaf(spec, gen: torch.Generator, dtype, device) -> torch.Tensor:
    """One leaf of a port spec (``repro_torch.models.spec.Spec``)."""
    kind = spec.init.partition(":")[0]
    shape = spec.shape
    if kind == "xavier":
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return normal(gen, shape, fan_in ** -0.5, dtype, device)
    if kind == "normal":
        return normal(gen, shape, 0.02, dtype, device)
    if kind == "zeros":
        return normal(gen, shape, 0.02, dtype, device)
    if kind == "ones":
        return normal(gen, shape, 0.1, dtype, device, mean=1.0)
    raise ValueError(f"no draw for init {spec.init!r}")


def tree(spec_tree, seed: int, dtype, device):
    """Every leaf of a spec tree, drawn in sorted key order."""
    gen = generator(seed, device)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return leaf(node, gen, dtype, device)
    return build(spec_tree)


def tokens(gen: torch.Generator, shape, vocab: int, device) -> torch.Tensor:
    """Token ids in [1, vocab) (id 0 is the engine's scrap token)."""
    return torch.randint(1, vocab, tuple(shape), generator=gen,
                         device=device, dtype=torch.int64)
