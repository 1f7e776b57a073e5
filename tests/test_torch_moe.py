"""The port's MoE layer (``repro_torch.models.moe``), held to the JAX
reference's ``repro.models.moe`` on the CPU at f32 compute.

grok-1-314b (8 experts top-2 reduced to 4; the port's config as its
twin, ``tests/jax_twin.py``: renormalised gates and drops, as the
reference routes) and arctic-480b (128 experts
top-2 plus the dense residual, reduced to 8), with the reference's
parameters from its own initializer and inputs from a numpy seed, in
four cases:

* ``g32``: 2 × 64 tokens, so the dispatch runs 32 groups;
* ``g1``: 37 tokens, an odd count, so it runs one group;
* ``drops``: 301 tokens whose first choice is one expert (a large first
  input feature meets a biased router row), more than its 256 (grok) or
  128 (arctic) slots, so tokens are dropped;
* ``ties``: the same first choice, and router columns of zeros for the
  second and third experts, so every token's second choice is an exact
  tie that ``jax.lax.top_k`` gives to the lower index.

``apply_moe``'s output within 1e-5 of its largest entry and the aux loss
within 1e-5 relative, on both of its paths: the padded einsums (which
the CPU always takes) and the grouped products over the routed rows
alone (which the card takes; here :func:`grouped_path` is patched so the
plain versions of ``kernels/grouped_gemm.py`` run); the gradients of
⟨out, g⟩ + aux with respect to every parameter and the input (autograd
against ``jax.grad``, so the padded path) within 1e-5 of each leaf's
largest entry.  The grouped products are held to the padded einsum at
loads the layer's routing rarely gives (an empty expert, one expert
taking every row, 128 experts), and the path choice and the row counter
to what the call can observe.
"""
import contextlib
import dataclasses
import types
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.spec import init_params as jinit  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.kernels import grouped_gemm as gg  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.spec import tree_leaves_with_path  # noqa: E402
from repro_torch.runtime import spans  # noqa: E402

from jax_twin import twin  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread while this module runs: the suite runs
    in several worker processes at once, and torch's default of a thread
    a core has them fight over the cores (a test here ran ~30x slower
    beside the other workers than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("grok-1-314b", "arctic-480b")
CASES = {"g32": (2, 64), "g1": (1, 37), "drops": (1, 301),
         "ties": (1, 301)}


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _near(got, want, tol, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=str(what))


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """The reduced config in both packages and the reference's seeded
    MoE parameters (host arrays)."""
    arch = request.param
    jcfg = _f32(jget_config(arch, reduced=True))
    tcfg = _f32(twin(tget_config(arch, reduced=True)))
    host = jax.device_get(jinit(jmoe.moe_spec(jcfg), jax.random.PRNGKey(0)))
    return {"arch": arch, "jcfg": jcfg, "tcfg": tcfg,
            "host": {k: np.array(v, np.float32) for k, v in host.items()}}


def _inputs(layer, case):
    """(params, x, g) host arrays for one case."""
    B, S = CASES[case]
    M, E = layer["jcfg"].d_model, layer["jcfg"].n_experts
    rng = np.random.default_rng(7)
    p = {k: v.copy() for k, v in layer["host"].items()}
    x = rng.standard_normal((B, S, M)).astype(np.float32)
    if case in ("drops", "ties"):
        # expert 0 first for every token: input feature 0 meets a router
        # row that lifts expert 0 and lowers the rest.  The drop case
        # lifts it 3 logits (the other features' part has a standard
        # deviation near 1): the softmax is not saturated, so the router
        # gradient is not a sum that cancels to a sliver of its terms —
        # where, at 8 logits, the reference's own f32 gradient strays
        # 2e-4 of its largest entry from an f64 evaluation.  The tie
        # case lowers the rest 8 logits, so the tie is always second.
        x0, w = (2.0, 1.5) if case == "drops" else (4.0, 2.0)
        x[..., 0] = x0
        p["router"][0, :] = -w
        p["router"][0, 0] = w
    if case == "ties":
        # experts 1 and 2: logits of exactly 0 for every token, above
        # every other expert's, so the second choice is an exact tie
        p["router"][:, 1:3] = 0.0
    g = rng.standard_normal((B, S, M)).astype(np.float32)
    return p, x, g


@pytest.fixture(scope="module")
def reference(layer):
    """Every case's (out, aux, grads) from the reference, each one jit."""
    cfg = layer["jcfg"]

    def f(p, x, g):
        out, aux = jmoe.apply_moe(p, x, cfg)
        return jnp.sum(out * g) + aux, (out, aux)

    vg = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    res = {}
    for case in CASES:
        p, x, g = _inputs(layer, case)
        (_, (out, aux)), (gp, gx) = vg(p, jnp.asarray(x), jnp.asarray(g))
        res[case] = {"out": np.asarray(out), "aux": float(aux),
                     "grads": dict(jax.device_get(gp), x=np.asarray(gx))}
    return res


def _grouped():
    """The grouped path taken on the CPU, as the card takes it."""
    return mock.patch.object(tmoe, "grouped_path", lambda p, x: True)


def _port(layer, case, path="padded"):
    """The port's layer on a case's inputs: on the padded path with
    leaves that require grad, on the grouped path with plain tensors."""
    p, x, g = _inputs(layer, case)
    grad = path == "padded"
    tp = {k: torch.from_numpy(v).requires_grad_(grad) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(grad)
    with _grouped() if path == "grouped" else contextlib.nullcontext():
        out, aux = tmoe.apply_moe(tp, tx, layer["tcfg"])
    return tp, tx, torch.from_numpy(g), out, aux


@pytest.mark.parametrize("path", ["padded", "grouped"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_matches_reference(layer, reference, case, path):
    before = (gg.gate_up.plain_calls, gg.down.plain_calls)
    _, _, _, out, aux = _port(layer, case, path)
    took = (gg.gate_up.plain_calls - before[0],
            gg.down.plain_calls - before[1])
    assert took == ((1, 1) if path == "grouped" else (0, 0))
    want = reference[case]
    assert out.shape == want["out"].shape and out.dtype == torch.float32
    _near(out.detach().numpy(), want["out"], 1e-5, (layer["arch"], case))
    np.testing.assert_allclose(float(aux.detach()), want["aux"], rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_grads_match_reference(layer, reference, case):
    tp, tx, g, out, aux = _port(layer, case)
    keys = sorted(tp)
    grads = torch.autograd.grad((out * g).sum() + aux,
                                [tp[k] for k in keys] + [tx])
    want = reference[case]["grads"]
    for key, got in zip(keys + ["x"], grads):
        _near(got.numpy(), want[key], 1e-5, (layer["arch"], case, key))


@pytest.mark.parametrize("case", ["drops", "ties"])
def test_the_cases_drop_and_tie(layer, case):
    """The inputs do what the cases claim: every token's first choice is
    expert 0, more tokens than its capacity, and (ties) every second
    choice an exact tie of experts 1 and 2, given to expert 1 by both
    packages' top-k."""
    cfg = layer["tcfg"]
    p, x, _ = _inputs(layer, case)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(
        p["router"]), dim=-1)[0]
    vals, idx = tmoe.top_k(probs, cfg.experts_per_tok)
    assert (idx[:, 0] == 0).all()
    assert probs.shape[0] > tmoe.capacity(probs.shape[0], cfg)
    if case == "ties":
        assert torch.equal(probs[:, 1], probs[:, 2])
        assert (idx[:, 1] == 1).all()
        jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
        np.testing.assert_array_equal(np.asarray(ji), idx.numpy())
        np.testing.assert_array_equal(np.asarray(jv), vals.numpy())


def test_top_k_breaks_ties_as_jax_does():
    """Probabilities rounded to bf16 tie often (most of all over 128
    experts); the port's top-k picks jax.lax.top_k's experts, in its
    order, where torch.topk promises no order for ties."""
    rng = np.random.default_rng(3)
    for e, k in ((4, 2), (8, 2), (128, 2), (128, 8)):
        logits = np.round(rng.standard_normal((64, e)) * 2) / 2
        probs = torch.softmax(torch.from_numpy(logits.astype(np.float32)),
                              dim=-1).to(torch.bfloat16).float()
        vals, idx = tmoe.top_k(probs, k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_groups_and_capacity_match_reference(arch):
    for reduced in (False, True):
        jcfg = jget_config(arch, reduced=reduced)
        tcfg = tget_config(arch, reduced=reduced)
        want = {path: (s.shape, s.axes, s.init) for path, s in
                tree_leaves_with_path(jmoe.moe_spec(jcfg))}
        got = {path: (s.shape, s.axes, s.init) for path, s in
               tree_leaves_with_path(tmoe.moe_spec(tcfg))}
        assert got == want
        assert tmoe._expert_axes(tcfg) == jmoe._expert_axes(jcfg)
        for t in (1, 2, 8, 37, 64, 128, 301, 512, 4096):
            assert tmoe._n_groups(t) == jmoe._n_groups(t)
            assert tmoe.capacity(t, tcfg) == jmoe.capacity(t, jcfg)


def _rows_case(case):
    """(cfg, loads) of a grouped-product case: arctic's reduced widths,
    8 experts (128 for ``e128``), and each expert's row count."""
    cfg = _f32(tget_config("arctic-480b", reduced=True))
    rng = np.random.default_rng(11)
    if case == "random":
        loads = rng.integers(1, 40, cfg.n_experts)
    elif case == "empty_expert":
        loads = rng.integers(1, 40, cfg.n_experts)
        loads[3] = 0
    elif case == "one_expert":      # every row to one expert, past 256
        loads = np.zeros(cfg.n_experts, np.int64)
        loads[5] = 300
    else:                           # e128: many small experts, some empty
        cfg = dataclasses.replace(cfg, n_experts=128)
        loads = rng.integers(0, 5, 128)
    return cfg, [int(n) for n in loads]


@pytest.mark.parametrize("case", ["random", "empty_expert", "one_expert",
                                  "e128"])
def test_grouped_products_match_the_padded_einsum(case):
    """gate_up then down over rows sorted by expert equal the padded
    einsums (``expert_ffn``) over the same rows placed in capacity slots,
    at f32 within 1e-5 of the largest entry; rows past the offsets stay
    zero."""
    cfg, loads = _rows_case(case)
    E, M, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(5)
    p = {k: torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32)
                             * s.shape[-2] ** -0.5)
         for k, s in tmoe.moe_spec(cfg).items()}
    R = sum(loads)
    x = torch.from_numpy(rng.standard_normal((R + 3, M)).astype(np.float32))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(loads)]),
                           dtype=torch.int32)
    y = gg.down(gg.gate_up(x, p["w_gate"], p["w_up"], offsets, cfg.act),
                p["w_down"], offsets)
    assert y.shape == (R + 3, M) and not y[R:].any()
    C = max(loads)
    buf = torch.zeros((1, E, C, M))
    for e in range(E):
        buf[0, e, :loads[e]] = x[offsets[e]:offsets[e + 1]]
    want = tmoe.expert_ffn(p, buf, cfg)[0]
    want = torch.cat([want[e, :loads[e]] for e in range(E)])
    _near(y[:R].numpy(), want.numpy(), 1e-5, case)


def _fake(kind, dtype, grad=False):
    return types.SimpleNamespace(device=torch.device(kind), dtype=dtype,
                                 requires_grad=grad)


def test_grouped_path_follows_grad_mesh_and_dtype():
    """The grouped products run where autograd records nothing, no mesh
    is active and the tensors are bf16 / f16 on the card; training, the
    meshed path, f32 on the card, CPU and meta tensors keep the padded
    einsums."""
    w = {k: torch.zeros(2, 8, 8) for k in ("w_gate", "w_up", "w_down")}
    x = _fake("cuda", torch.bfloat16)
    assert tmoe.grouped_path(w, x)
    assert not tmoe.grouped_path(w, _fake("cuda", torch.bfloat16, True))
    with torch.no_grad():
        assert tmoe.grouped_path(w, _fake("cuda", torch.bfloat16, True))
    trained = dict(w, w_up=w["w_up"].clone().requires_grad_())
    assert not tmoe.grouped_path(trained, x)
    with torch.no_grad():
        assert tmoe.grouped_path(trained, x)
    with sharding.use_mesh(object()):
        assert not tmoe.grouped_path(w, x)
    assert tmoe.grouped_path(w, x)
    for dtype, want in ((torch.bfloat16, True), (torch.float16, True),
                        (torch.float32, False)):
        assert tmoe.grouped_path(w, _fake("cuda", dtype)) == want
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        assert not tmoe.grouped_path(w, torch.zeros(1, 4, 8, dtype=dtype))
        assert not tmoe.grouped_path(w, torch.zeros(1, 4, 8, dtype=dtype,
                                                    device="meta"))


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_rows_count_what_the_products_are_given(arch):
    """``moe.slot_rows``: T · k on the grouped path, G · E · C on the
    padded one; ``moe.routed_rows`` T · k on both."""
    cfg = _f32(tget_config(arch, reduced=True))
    B, S = CASES["g32"]
    T, k = B * S, cfg.experts_per_tok
    G = tmoe._n_groups(T)
    p = {key: torch.randn(s.shape) for key, s in tmoe.moe_spec(cfg).items()}
    x = torch.randn(B, S, cfg.d_model)
    want = {"grouped": T * k,
            "padded": G * cfg.n_experts * tmoe.capacity(T // G, cfg)}
    for path in ("grouped", "padded"):
        spans.take_counts()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]), \
                _grouped() if path == "grouped" else contextlib.nullcontext():
            tmoe.apply_moe(p, x, cfg)
        counts = spans.take_counts()
        assert counts == {"moe.slot_rows": want[path],
                          "moe.routed_rows": T * k}, path
