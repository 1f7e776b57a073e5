"""The fused AdamW update (``kernels/adamw.py``, ``csrc/adamw.cu``).

On the CPU: which path ``opt_update`` takes, read from its leaves alone
(the wrapper's plain version for CPU tensors, the plain branch for
DTensors and meta tensors, Adafactor's own branch), and what the wrapper
refuses.

On the card (the ``cuda`` marker; they skip where torch sees none): the
fused ``opt_update`` against its plain branch on the same CUDA tensors
(``_fusable`` patched to refuse), at leaves of 1, 7 and 4097 entries, a
matrix, and a view one element off 16 bytes, with bf16 and f32
gradients, f32 and bf16 masters, and the gradient transforms.  Without
clipping p, m, v and lr agree bit for bit (the kernels run the plain
branch's f32 operations in its order); with clipping each leaf agrees to
1e-6 of its largest entry and the gradient norm to 1e-6 relative (the
norm's partial sums are taken in another order).  Also: the inputs are
left as they were, two runs give the same bits, no call synchronises
with the host, and a call launches 2 × leaves + 1 kernels.  Run them
with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_adamw.py

No JAX here: the machine with the card has none.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as kadamw
from repro_torch.models.spec import (tree_leaves, tree_leaves_with_path,
                                     tree_map)
from repro_torch.optim import optimizer as topt

HP = topt.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          weight_decay=0.1, clip_norm=1.0)
SIZES = {"a": (1,), "b": (7,), "c": (4097,), "w": (64, 96)}
VIEW = 4101      # entries of the leaf that is a view one element in


def _counts():
    return kadamw.adamw.launches, kadamw.adamw.plain_calls


def _base(rng, shape, scale, dtype, device, positive=False):
    a = rng.standard_normal(shape) * scale
    return torch.from_numpy(np.abs(a) if positive else a).to(device, dtype)


def _tree(rng, scale=1.0, dtype=torch.float32, device="cpu", view=False,
          positive=False):
    """A parameter-shaped tree: SIZES' leaves, and with ``view`` a leaf
    that views its own buffer from the second element on (a base 4 or 2
    bytes off 16)."""
    tree = {k: _base(rng, s, scale, dtype, device, positive)
            for k, s in SIZES.items()}
    if view:
        tree["x"] = _base(rng, (VIEW + 1,), scale, dtype, device,
                          positive)[1:]
    return tree


def _state(rng, params, mv_dtype, device, view=False):
    return {"m": _tree(rng, 1e-2, mv_dtype, device, view),
            "v": _tree(rng, 1e-4, mv_dtype, device, view, positive=True),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# the CPU: the path chosen from the leaves, the wrapper's checks
# ---------------------------------------------------------------------------

def test_cpu_leaves_run_the_wrappers_plain_version(rng):
    params = _tree(rng)
    state = topt.init_opt_state(params, HP)
    grads = _tree(rng, 0.3, torch.bfloat16)
    before = _counts()
    new_p, new_s, met = topt.opt_update(params, grads, state, HP)
    assert _counts() == (before[0], before[1] + 1)
    want = kadamw.plain(tree_leaves(params), tree_leaves(grads),
                        tree_leaves(state["m"]), tree_leaves(state["v"]),
                        state["step"], HP)
    for got, exp in zip(tree_leaves(new_p), want[0]):
        assert torch.equal(got, exp)
    assert int(new_s["step"]) == 1
    assert torch.equal(met["grad_norm"], want[4])
    assert torch.equal(met["lr"], want[5])


@pytest.mark.parametrize("transform", ["bf16", "int8_ef"])
def test_cpu_gradient_transforms_feed_the_wrapper_f32(rng, monkeypatch,
                                                     transform):
    hp = dataclasses.replace(HP, grad_transform=transform)
    params = _tree(rng)
    state = topt.init_opt_state(params, hp)
    grads = _tree(rng, 0.3, torch.bfloat16)
    seen = []
    real = kadamw.plain

    def spy(ps, gs, *rest):
        seen.extend(g.dtype for g in gs)
        return real(ps, gs, *rest)
    monkeypatch.setattr(kadamw, "plain", spy)
    before = _counts()
    _, new_s, _ = topt.opt_update(params, grads, state, hp)
    assert _counts() == (before[0], before[1] + 1)
    assert seen == [torch.float32] * len(SIZES)
    assert ("ef" in new_s) == (transform == "int8_ef")


def test_adafactor_keeps_its_plain_branch(rng):
    hp = dataclasses.replace(HP, kind="adafactor")
    params = _tree(rng)
    state = topt.init_opt_state(params, hp)
    before = _counts()
    new_p, new_s, _ = topt.opt_update(params, _tree(rng, 0.3), state, hp)
    assert _counts() == before
    assert int(new_s["step"]) == 1 and "fac" in new_s
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(new_p))


def test_meta_leaves_keep_the_plain_branch(rng):
    """The dry-run's one-device cell runs the step on plain meta tensors."""
    params = tree_map(lambda t: t.to("meta"), _tree(rng))
    state = topt.init_opt_state(params, HP)
    before = _counts()
    new_p, new_s, met = topt.opt_update(
        params, tree_map(lambda t: t.to(torch.bfloat16), params), state, HP)
    assert _counts() == before
    for p, q in zip(tree_leaves(new_p), tree_leaves(params)):
        assert p.is_meta and p.shape == q.shape and p.dtype == q.dtype
    assert new_s["step"].is_meta and met["lr"].is_meta


def test_dtensor_leaves_keep_the_plain_branch(rng):
    """On a 1 × 1 gloo mesh the DTensor tree takes the plain branch (the
    norm over sharded leaves needs a reduction the kernels do not make)
    and gives the unmeshed update's bits."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_device_mesh("cpu")
    rep = [Replicate(), Replicate()]
    params, grads = _tree(rng), _tree(rng, 0.3, torch.bfloat16)
    state = topt.init_opt_state(params, HP)
    want = topt.opt_update(params, grads, state, HP)

    def dist(tree):
        return tree_map(lambda t: distribute_tensor(t, mesh, rep), tree)
    before = _counts()
    got = topt.opt_update(dist(params), dist(grads),
                          dict(state, m=dist(state["m"]),
                               v=dist(state["v"])), HP)
    assert _counts() == before
    assert type(tree_leaves(got[0])[0]).__name__ == "DTensor"
    for tree_got, tree_want in ((got[0], want[0]), (got[1]["m"], want[1]["m"]),
                                (got[1]["v"], want[1]["v"])):
        for a, b in zip(tree_leaves(tree_got), tree_leaves(tree_want)):
            assert torch.equal(a.full_tensor(), b)
    assert int(got[1]["step"]) == 1


def _leaves(rng, **kw):
    p = _tree(rng, **kw)
    return ([p["a"], p["w"]], [t.clone() for t in (p["a"], p["w"])],
            [t.clone() for t in (p["a"], p["w"])],
            [t.clone() for t in (p["a"], p["w"])])


def test_wrapper_raises_on_a_device_mix(rng):
    """CPU and meta leaves (the CPU and card mix raises the same way, on
    the card below)."""
    ps, gs, ms, vs = _leaves(rng)
    gs[1] = gs[1].to("meta")
    with pytest.raises(ValueError, match="operands on"):
        kadamw.adamw(ps, gs, ms, vs, torch.zeros((), dtype=torch.int32), HP)


@pytest.mark.parametrize("case", ["shape", "count"])
def test_wrapper_raises_on_mismatched_leaves(rng, case):
    ps, gs, ms, vs = _leaves(rng)
    if case == "shape":
        vs[1] = vs[1].reshape(-1)
    else:
        ms = ms[:1]
    with pytest.raises(ValueError):
        kadamw.adamw(ps, gs, ms, vs, torch.zeros((), dtype=torch.int32), HP)


@pytest.mark.parametrize("case", ["grad_f16", "param_f64", "m_v_apart",
                                  "step_int64"])
def test_wrapper_raises_on_an_unsupported_dtype(rng, case):
    ps, gs, ms, vs = _leaves(rng)
    step = torch.zeros((), dtype=torch.int32)
    if case == "grad_f16":
        gs[0] = gs[0].half()
    elif case == "param_f64":
        ps[1] = ps[1].double()
    elif case == "m_v_apart":
        ms[0] = ms[0].to(torch.bfloat16)
    else:
        step = step.long()
    before = _counts()
    with pytest.raises(TypeError):
        kadamw.adamw(ps, gs, ms, vs, step, HP)
    assert _counts() == before


@pytest.mark.parametrize("n", [0, 1, 7, 2048, 2049, 4097, 10 ** 9])
@pytest.mark.parametrize("sms", [1, 132])
def test_blocks_cover_a_leaf_within_the_cards_residency(n, sms):
    b = kadamw.blocks_for(n, sms)
    assert b == 0 if n == 0 else 1 <= b <= kadamw.BLOCKS_PER_SM * sms
    if 0 < n <= 8 * kadamw.THREADS * kadamw.BLOCKS_PER_SM * sms:
        assert b * kadamw.THREADS * 8 >= n        # one pass, no stride


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _plain_opt_update(monkeypatch, *args):
    """``opt_update`` as its plain branch runs it on the same tensors."""
    with monkeypatch.context() as mp:
        mp.setattr(topt, "_fusable", lambda leaves: False)
        return topt.opt_update(*args)


def _card_case(rng, grad_dtype, master):
    params = _tree(rng, 0.05, master, "cuda", view=True)
    state = _state(rng, params, master, "cuda", view=True)
    return params, state, [_tree(rng, 0.3 + s, grad_dtype, "cuda", view=True)
                           for s in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("master", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32])
def test_fused_update_matches_the_plain_branch(card, rng, monkeypatch,
                                               grad_dtype, master, clip):
    """Three steps (the third past the warmup), each from the plain
    branch's last state.  With clipping a bf16 master may round one ulp
    apart (2^-7 of the entry at most): its f32 value moved by ~1e-7."""
    hp = dataclasses.replace(HP, clip_norm=clip)
    params, state, grads = _card_case(rng, grad_dtype, master)
    n_leaves = len(tree_leaves(params))
    for step in range(3):
        before = _counts()
        got_p, got_s, got_m = topt.opt_update(params, grads[step], state, hp)
        assert _counts() == (before[0] + 2 * n_leaves + 1, before[1])
        params, state, want_m = _plain_opt_update(
            monkeypatch, params, grads[step], state, hp)
        assert int(got_s["step"]) == int(state["step"]) == step + 1
        for tree in ("params", "m", "v"):
            g_t = got_p if tree == "params" else got_s[tree]
            w_t = params if tree == "params" else state[tree]
            for (path, a), b in zip(tree_leaves_with_path(g_t),
                                    tree_leaves(w_t)):
                what = f"{tree} {path} step {step}"
                assert a.dtype == b.dtype and a.shape == b.shape, what
                if clip == 0.0:
                    assert torch.equal(a, b), what
                elif a.dtype == torch.bfloat16:
                    torch.testing.assert_close(a.float(), b.float(),
                                               rtol=2 ** -7, atol=0,
                                               msg=what)
                else:
                    scale = float(b.abs().max())
                    torch.testing.assert_close(a, b, rtol=0,
                                               atol=1e-6 * scale, msg=what)
        torch.testing.assert_close(got_m["grad_norm"], want_m["grad_norm"],
                                   rtol=1e-6, atol=0)
        assert torch.equal(got_m["lr"], want_m["lr"])


@pytest.mark.cuda
@pytest.mark.parametrize("transform", ["bf16", "int8_ef"])
def test_fused_update_after_a_gradient_transform(card, rng, monkeypatch,
                                                 transform):
    hp = dataclasses.replace(HP, clip_norm=0.0, grad_transform=transform)
    params = _tree(rng, 0.05, torch.float32, "cuda")
    state = topt.init_opt_state(params, hp)
    grads = _tree(rng, 0.3, torch.bfloat16, "cuda")
    got = topt.opt_update(params, grads, state, hp)
    want = _plain_opt_update(monkeypatch, params, grads, state, hp)
    for a, b in zip(tree_leaves(dict(zip("ps", got))),
                    tree_leaves(dict(zip("ps", want)))):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_update_is_deterministic_and_leaves_its_inputs(card, rng):
    params, state, grads = _card_case(rng, torch.bfloat16, torch.float32)
    inputs = {"params": params, "grads": grads[0], "state": state}
    before = [t.clone() for t in tree_leaves(inputs)]
    one, two = ({k: v for k, v in zip("psm", topt.opt_update(
        params, grads[0], state, HP))} for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves(inputs), before):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(one), tree_leaves(two)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_update_makes_no_host_sync(card, rng):
    params, state, grads = _card_case(rng, torch.bfloat16, torch.float32)
    topt.opt_update(params, grads[0], state, HP)     # the library built
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new_p, new_s, met = topt.opt_update(params, grads[0], state, HP)
        topt.opt_update(new_p, grads[1], new_s, HP)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(met["grad_norm"]))


@pytest.mark.cuda
def test_wrapper_raises_on_a_card_and_cpu_mix(card, rng):
    ps, gs, ms, vs = _leaves(rng, device="cuda")
    gs[1] = gs[1].cpu()
    before = _counts()
    with pytest.raises(ValueError, match="operands on"):
        kadamw.adamw(ps, gs, ms, vs,
                     torch.zeros((), dtype=torch.int32, device="cuda"), HP)
    assert _counts() == before
