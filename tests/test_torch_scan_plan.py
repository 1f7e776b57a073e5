"""The launch plans of the RG-LRU scan (``kernels/rglru.py::rglru_plan``)
and of SpMV (``kernels/spmv.py::spmv_plan``) — the twins of ``plan`` in
``csrc/rglru.cu`` and ``csrc/spmv.cu``; the card tests hold each pair
equal — and the scan's segmented algorithm in torch (``_scan_segmented``,
the kernel's order of work) against the JAX reference, on the CPU.  No
card: the plans are arithmetic on the extents."""
import itertools

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru import rglru_scan as jrglru_pallas  # noqa: E402
from repro_torch.core.backend import H100_HIERARCHY  # noqa: E402
from repro_torch.core.costmodel import CostModel  # noqa: E402
from repro_torch.core.passes import (candidate_spmv_tilings,  # noqa: E402
                                     choose_spmv_tiling)
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rglru as rg  # noqa: E402
from repro_torch.kernels import spmv as sp  # noqa: E402

SMS = 132   # H100 SXM
DTYPES = [torch.float32, torch.bfloat16]
SEG = 4     # a vector-path segment's steps
# T at 1, 2, one below / at / above a segment, and the served lengths
T_LENGTHS = (1, 2, SEG - 1, SEG, SEG + 1, 2040, 4096)


def _segments(plan: dict, t_len: int) -> list:
    """The [start, end) time range of every segment the plan launches
    (for one channel), in order: chunk by chunk, a chunk's segments in
    turn; the last ones may run past T (their steps are masked)."""
    seg_len, per_chunk = plan["steps"], plan["segs"]
    return [((c * per_chunk + s) * seg_len,
             min((c * per_chunk + s + 1) * seg_len, t_len))
            for c in range(plan["chunks"]) for s in range(per_chunk)]


def _scan_segmented(x, r_gate, i_gate, log_a_param, state=None, *,
                    steps: int) -> tuple:
    """The kernel's algorithm in torch (for the CPU tests): every step's
    (a_t, b_t) once, each segment of ``steps`` steps scanned from h = 0
    to (running product of a, h), the segments' starting h carried in
    order from ``state`` (or zeros), and each segment re-run from its
    starting h.  Same signature and result as ``ref.rglru_scan``."""
    B, T, D = x.shape
    log_a = -tref.RGLRU_C * torch.nn.functional.softplus(
        log_a_param.float())
    la_r = log_a * torch.sigmoid(r_gate.float())
    a = torch.exp(la_r)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * la_r), min=1e-12)) * \
        (torch.sigmoid(i_gate.float()) * x.float())
    n_seg = max(-(-T // steps), 1)
    pad = n_seg * steps - T
    a = torch.cat([a, a.new_ones((B, pad, D))], 1).view(B, n_seg, steps, D)
    b = torch.cat([b, b.new_zeros((B, pad, D))], 1).view(B, n_seg, steps, D)
    seg_a = a.new_ones((B, n_seg, D))
    seg_h = a.new_zeros((B, n_seg, D))
    for u in range(steps):                    # each segment from h = 0
        seg_h = a[:, :, u] * seg_h + b[:, :, u]
        seg_a = seg_a * a[:, :, u]
    h = a.new_zeros((B, D)) if state is None else state.float()
    start = []
    for s in range(n_seg):                    # the carry, in order
        start.append(h)
        h = seg_a[:, s] * h + seg_h[:, s]
    h = torch.stack(start, 1)
    ys = []
    for u in range(steps):                    # each segment again
        h = a[:, :, u] * h + b[:, :, u]
        ys.append(h)
    y = torch.stack(ys, 2).reshape(B, n_seg * steps, D)[:, :T]
    final = y[:, -1] if T else (a.new_zeros((B, D)) if state is None
                                else state.float())
    return y.to(x.dtype), final.clone()


def _covered(plan: dict, t_len: int) -> list:
    """The time steps the plan's segments hold, in launch order."""
    return [t for a, b in _segments(plan, t_len) for t in range(a, b)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [48, 4096, 4099])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("t_len", T_LENGTHS)
def test_rglru_segments_cover_time_once(t_len, b, d, dtype):
    """Segments cover [0, T) exactly, in order, with no overlap; a
    segment past T is the masked tail of the last chunk only."""
    p = rg.rglru_plan(b, t_len, d, dtype, SMS)
    assert _covered(p, t_len) == list(range(t_len))
    segs = _segments(p, t_len)
    assert len(segs) == p["chunks"] * p["segs"]
    assert all(a < b_ for a, b_ in segs[:-p["segs"]])     # full chunks
    assert p["chunks"] == 1 or (p["chunks"] - 1) * p["segs"] * \
        p["steps"] < t_len <= p["chunks"] * p["segs"] * p["steps"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 4096, 4099])
def test_rglru_decode_step_is_one_segment(d, dtype):
    """T = 1, the serving decode step against the cached h: one step and
    one channel a thread, one segment, one chunk (no scratch, no flags),
    one launch."""
    p = rg.rglru_plan(4, 1, d, dtype, SMS)
    assert (p["vec"], p["steps"], p["segs"], p["chunks"]) == (1, 1, 1, 1)
    assert p["threads"] == 32 and p["grid"] == p["tickets"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t_len", [2, 3, 4])
def test_rglru_short_t_is_one_segment(t_len, dtype):
    p = rg.rglru_plan(4, t_len, 4096, dtype, SMS)
    assert p["segs"] == p["chunks"] == 1 and p["steps"] >= t_len


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t_len,d", itertools.product(
    (1, 4, 7, rg.MAX_BATCH), (0, 1, 5, 129, 2040, 4096), (1, 33, 4096, 4099)))
def test_rglru_plan_fits_the_card(b, t_len, d, dtype):
    """A block of at most 256 threads, whole warps once segments share
    one, the warp exchange and h's staging within their shared arrays,
    the vector only where D takes it and T > 1 (with 2 or 4 steps a
    thread: the instances the library holds), and a resident grid no
    larger than the tickets (the 1-D grid never meets grid.y's limit)."""
    p = rg.rglru_plan(b, t_len, d, dtype, SMS)
    v16 = 16 // dtype.itemsize
    assert p["vec"] == (v16 if d % v16 == 0 and t_len > 1 else 1)
    assert p["vec"] == 1 or p["steps"] >= 2
    assert p["threads"] == p["lanes"] * p["segs"] <= rg.THREADS
    assert p["segs"] == 1 or p["threads"] % 32 == 0
    assert p["lanes"] * p["vec"] <= rg.THREADS
    assert p["segs"] == 1 or \
        max(p["threads"] // 32, 1) * p["lanes"] * p["vec"] <= 512
    assert p["colgroups"] * p["lanes"] * p["vec"] >= d
    assert p["tickets"] == b * p["colgroups"] * p["chunks"]
    assert 1 <= p["grid"] <= min(p["tickets"], SMS * rg.BLOCKS_PER_SM *
                                 (rg.THREADS // p["threads"]))
    assert p["grid"] < 2 ** 31


def test_rglru_plan_unaligned_takes_the_scalar_path():
    for dtype in DTYPES:
        assert rg.rglru_plan(4, 2040, 4096, dtype, SMS, aligned=False)[
            "vec"] == 1


def test_rglru_served_prefill_plan():
    """recurrentgemma-9b's wave prefill, 4 x 2040 x 4096 bf16: 8 channels
    a thread, 4 steps a segment, 32 segments a block of 256 threads, 16
    chunks of 128 steps along T."""
    p = rg.rglru_plan(4, 2040, 4096, torch.bfloat16, SMS)
    assert (p["vec"], p["steps"], p["lanes"], p["segs"], p["chunks"]) == \
        (8, 4, 8, 32, 16)


def _rglru_inputs(rng, t, d, B=2):
    x, r, i = (rng.standard_normal((B, t, d), dtype=np.float32)
               for _ in range(3))
    la = rng.standard_normal(d).astype(np.float32)
    h0 = rng.standard_normal((B, d), dtype=np.float32)
    return x, r, i, la, h0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("steps", [1, 4, 8])
@pytest.mark.parametrize("t,d", [(37, 48), (129, 16), (1, 32)])
def test_segmented_scan_matches_the_references(rng, t, d, steps,
                                               with_state):
    """The kernel's algorithm (segments from h = 0, the carry in order,
    each segment again from its starting h), at an odd T, held to the JAX
    reference (with a given state) and its Pallas kernel (interpret, from
    zero) at 1e-5 in f32."""
    x, r, i, la, h0 = _rglru_inputs(rng, t, d)
    state = h0 if with_state else None
    y, h = _scan_segmented(*map(_t, (x, r, i, la)),
                                   None if state is None else _t(state),
                                   steps=steps)
    want_y, want_h = jref.rglru_scan(x, r, i, la, state)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-5,
                               atol=1e-5)
    if not with_state:
        pallas = jrglru_pallas(jnp.asarray(x), jnp.asarray(r),
                               jnp.asarray(i), jnp.asarray(la),
                               chunk=min(16, t), d_block=d, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(pallas),
                                   rtol=1e-5, atol=1e-5)


def test_segmented_scan_keeps_dtypes_and_t0(rng):
    x, r, i, la, h0 = _rglru_inputs(rng, 5, 16)
    y, h = _scan_segmented(*(_t(a).bfloat16() for a in (x, r, i, la)),
                                   steps=4)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y, h = _scan_segmented(*(_t(a)[:, :0] for a in (x, r, i)),
                                   _t(la), _t(h0), steps=4)
    assert tuple(y.shape) == (2, 0, 16) and torch.equal(h, _t(h0))


def _h100_tilings() -> set:
    """Every tiling the sparsify pass can pick on the H100 hierarchy (the
    sweep of tests/test_torch_sparse.py::
    test_h100_hierarchy_only_yields_tilings_the_kernels_run)."""
    model = CostModel(H100_HIERARCHY)
    rows = (0, 1, 5, 8, 100, 1000, 65_536, 648_000, 742_793, 1_465_137)
    means = (0.0, 0.5, 1.0, 7.9, 8.0, 12.0, 14.34, 24.0, 31.0, 33.0, 50.0,
             78.33, 82.28, 345.0)
    seen = set()
    for n_rows, mean in itertools.product(rows, means):
        cands = candidate_spmv_tilings(n_rows, mean, H100_HIERARCHY)
        picked = model.rank(cands, lambda t: model.spmv_cost(
            n_rows, mean, 4, t))[0][1]
        tilings = cands + [picked]
        if n_rows:
            tilings.append(choose_spmv_tiling(n_rows, mean, H100_HIERARCHY))
        seen |= {(n_rows, *sp.check_tiling(t)) for t in tilings}
    return seen


H100_TILINGS = sorted(_h100_tilings())


@pytest.mark.parametrize("aligned", [True, False])
def test_spmv_plan_launches_every_h100_tiling(aligned):
    """Every tiling the H100 hierarchy yields maps to a launchable plan:
    a row's lanes a power of two within one warp, whole warps of at most
    256 threads, groups x lanes = threads, each iteration covering the
    tiling's row_width (twice it at the warp's 32), and a grid that
    covers the rows within the grid's limit."""
    assert len(H100_TILINGS) > 50
    for n_rows, rb, rw in H100_TILINGS:
        p = sp.spmv_plan(n_rows, rb, rw, aligned)
        assert p["vec"] == (sp.VEC if aligned else 1)
        lanes = p["lanes"]
        assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
        assert lanes * p["vec"] >= min(rw * (2 if rw == 32 else 1),
                                       32 * p["vec"])
        assert p["threads"] % 32 == 0 and p["threads"] <= sp.MAX_THREADS
        assert p["groups"] * lanes == p["threads"]
        assert p["grid"] * rb >= n_rows and (p["grid"] - 1) * rb < \
            max(n_rows, 1) and p["grid"] < 2 ** 31
        assert p["unroll"] >= 1


def test_spmv_plan_at_the_table_6_1_tilings():
    """The cost model's tilings for the synthetic Table 6.1 matrices:
    StocF-1465 (row_width 16) on 4 lanes of 4 entries, the others (32)
    on 16 lanes of 4 — a row as wide as the warp walks 64 entries an
    iteration."""
    assert sp.spmv_plan(1_465_137, 128, 16)["lanes"] == 4
    assert sp.spmv_plan(943_695, 64, 32)["lanes"] == 16
    assert sp.spmv_plan(943_695, 64, 32, aligned=False)["lanes"] == 32
