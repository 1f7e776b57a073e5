"""The RWKV6 WKV scan's chunked algorithm and the launch plans of the WKV
scan (``kernels/rwkv6.py::wkv_plan``) and the f32 flash kernel
(``kernels/flash_attention.py::ffma_plan``) — twins of ``plan`` in
``csrc/rwkv6.cu`` and ``csrc/flash_attention.cu``; the card tests hold
each pair equal — on the CPU.

``_wkv_chunked`` is the kernel's order of work in torch: chunks of
``16 * nsub`` steps, each from a zero state with its decay factors taken
as products of w ending at a 16-step anchor (never a quotient), the chunks'
end states handed along T in order, and each chunk's y corrected by the
state it was handed.  It is held at 1e-5 to an f64 evaluation of the
recurrence, and to the JAX reference, its Pallas kernel (interpret, from a
zero state) and the port's plain version at 1e-5 beyond each one's own
distance from the f64 evaluation, at decays from 0 (and below 1e-30) to
exactly 1.  (Those three are serial f32 sums: at decays of exactly 1 over
512 steps they sit up to 1.2x the bar from the f64 evaluation, further
than the chunked order does.)"""
import numpy as np
import pytest

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv6 import rwkv6_scan as jwkv_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rwkv6 as rw  # noqa: E402

SMEM_LIMIT = 232_448   # shared memory a block may opt in to (H100)
SMS = 132
CHUNK = rw.SUB * rw.MAX_NSUB          # 64 steps at T above 32
T_LENGTHS = (1, 2, CHUNK - 1, CHUNK, CHUNK + 1, 512)
DECAYS = {"0.5-0.9": (0.5, 0.9), "0.97-0.999": (0.97, 0.999),
          "0-1e-30": (0.0, 1e-30), "zero": (0.0, 0.0), "one": (1.0, 1.0)}


def _excl_cumprod(x: torch.Tensor, dim: int) -> torch.Tensor:
    """prod of x over the steps before each one along ``dim`` (1 first),
    as a running product in order."""
    out, run = [], torch.ones_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        out.append(run)
        run = run * x.select(dim, i)
    return torch.stack(out, dim)


def _wkv_chunked(r, k, v, w, u, state=None, *, nsub: int) -> tuple:
    """The kernel's algorithm in torch; same signature and result as
    ``ref.rwkv6_scan``.  With p_t the product of w from the sub-chunk's
    start to t - 1, q_s from s + 1 to its end and P_J its whole product:
    r^ = r p, k^ = k q; A = the chunk's decayed r . k (pairs in one
    sub-chunk by running products, the bonus u on the diagonal, pairs
    across sub-chunks as (r^_J M_IJ) . k^_I with M_IJ the P between);
    y_loc = A V, dS = sum_I diag(Q_I) k^_I^T V_I, P_c = prod P_J; then in
    order S_c = diag(P_c) S_{c-1} + dS and y = y_loc + (r^ Pi_J) . S_{c-1}."""
    B, T, H, K = r.shape
    V = v.shape[3]
    sub = rw.SUB
    L = sub * nsub
    C = max(-(-T // L), 1)
    pad = C * L - T

    def prep(x, fill):
        x = x.float().permute(0, 2, 1, 3)                  # (B, H, T, .)
        x = torch.cat([x, x.new_full((B, H, pad, x.shape[3]), fill)], 2)
        return x.reshape(B, H, C, nsub, sub, x.shape[3])

    rf, kf, vf = prep(r, 0.0), prep(k, 0.0), prep(v, 0.0)
    wf = prep(w, 1.0)                     # the tail keeps the state: w = 1
    uf = u.float()[None, :, None, None, :]                 # (1, H, 1, 1, K)
    p = _excl_cumprod(wf, 4)                               # (B,H,C,J,16,K)
    pj = p[:, :, :, :, -1] * wf[:, :, :, :, -1]            # (B,H,C,J,K)
    q = _excl_cumprod(wf.flip(4), 4).flip(4)
    rh, kh = rf * p, kf * q
    pi = _excl_cumprod(pj, 3)                              # before J
    qj = _excl_cumprod(pj.flip(3), 3).flip(3)              # after J
    pc = pi[:, :, :, -1] * pj[:, :, :, -1]                 # (B,H,C,K)

    A = rf.new_zeros((B, H, C, L, L))
    for J in range(nsub):                 # the diagonal blocks
        for t in range(sub):
            rt = rf[:, :, :, J, t]
            A[..., J * sub + t, J * sub + t] = (rt * uf[:, :, :, 0] *
                                                kf[:, :, :, J, t]).sum(-1)
            d = torch.ones_like(rt)
            for s in range(t - 1, -1, -1):
                A[..., J * sub + t, J * sub + s] = (
                    rt * d * kf[:, :, :, J, s]).sum(-1)
                d = d * wf[:, :, :, J, s]
        for I in range(J):                # below it: matrix products
            m = torch.ones_like(pj[:, :, :, 0])
            for i in range(I + 1, J):
                m = m * pj[:, :, :, i]
            A[..., J * sub:(J + 1) * sub, I * sub:(I + 1) * sub] = torch.einsum(
                "bhctk,bhcsk->bhcts", rh[:, :, :, J],
                kh[:, :, :, I] * m[:, :, :, None])
    vc = vf.reshape(B, H, C, L, V)
    y_loc = A @ vc
    ds = sum(qj[:, :, :, i, :, None] * torch.einsum(
        "bhcsk,bhcsv->bhckv", kh[:, :, :, i], vf[:, :, :, i])
        for i in range(nsub))
    rt_ = (rh * pi[:, :, :, :, None]).reshape(B, H, C, L, K)
    s = (rf.new_zeros((B, H, K, V)) if state is None else state.float())
    ys = []
    for c in range(C):                    # the chain, in order
        ys.append(y_loc[:, :, c] + rt_[:, :, c] @ s)
        s = pc[:, :, c, :, None] * s + ds[:, :, c]
    y = torch.stack(ys, 2).reshape(B, H, C * L, V)[:, :, :T]
    return y.permute(0, 2, 1, 3).to(v.dtype), s


def _inputs(rng, t, decay, B=2, H=2, K=8, V=16):
    r, k, v = (rng.standard_normal((B, t, H, n), dtype=np.float32) * 0.5
               for n in (K, K, V))
    lo, hi = DECAYS[decay]
    w = (lo + (hi - lo) * rng.random((B, t, H, K))).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, V), dtype=np.float32)
    return r, k, v, w, u, s0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _wkv_f64(r, k, v, w, u, state=None) -> tuple:
    """The recurrence one step at a time in f64 (numpy inputs)."""
    r, k, v, w, u = (torch.from_numpy(np.asarray(a, np.float64))
                     for a in (r, k, v, w, u))
    B, T, H, K = r.shape
    s = torch.zeros((B, H, K, v.shape[3]), dtype=torch.float64) \
        if state is None else torch.from_numpy(np.asarray(state, np.float64))
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    y = torch.stack(ys, 1) if ys else torch.zeros((B, 0, H, v.shape[3]),
                                                  dtype=torch.float64)
    return y.numpy(), s.numpy()


def _close(got, want, exact=None):
    """|got - want| <= 1e-5 (1 + |want|), plus want's own distance from
    the f64 evaluation ``exact`` where one is given."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    slack = 0.0 if exact is None else np.abs(want - exact)
    assert got.shape == want.shape
    excess = np.abs(got - want) - (1e-5 + 1e-5 * np.abs(want) + slack)
    assert excess.size == 0 or excess.max() <= 0, float(excess.max())


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("t", T_LENGTHS)
def test_chunked_wkv_matches_the_references(rng, t, decay, with_state):
    """The kernel's algorithm at the plan's chunk, T around a chunk and at
    the prefill's 512, from zeros and from a given state, held to an f64
    evaluation at 1e-5, and to the JAX reference, the port's plain version
    and (from zeros) the reference's Pallas kernel (interpret) at 1e-5
    beyond their own f32 error."""
    r, k, v, w, u, s0 = _inputs(rng, t, decay)
    state = s0 if with_state else None
    nsub = rw.wkv_plan(2, t, 2, 8, 16, torch.float32)["nsub"]
    y, s = _wkv_chunked(*map(_t, (r, k, v, w, u)),
                        None if state is None else _t(state), nsub=nsub)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    exact_y, exact_s = _wkv_f64(r, k, v, w, u, state)
    _close(y, exact_y)
    _close(s, exact_s)
    want_y, want_s = jref.rwkv6_scan(r, k, v, w, u, state)
    _close(y, want_y, exact_y)
    _close(s, want_s, exact_s)
    plain_y, plain_s = tref.rwkv6_scan(*map(_t, (r, k, v, w, u)),
                                       None if state is None else _t(state))
    _close(y, plain_y, exact_y)
    _close(s, plain_s, exact_s)
    if not with_state:
        pallas = jwkv_pallas(*map(jnp.asarray, (r, k, v, w, u)),
                             chunk=min(64, t), interpret=True)
        _close(y, pallas, exact_y)


@pytest.mark.parametrize("nsub", [1, 2, 4])
def test_chunked_wkv_at_every_chunk_length(rng, nsub):
    """Each chunk length a plan may pick (16, 32, 64 steps) over several
    chunks, K and V off the 16-multiples, from a given state."""
    r, k, v, w, u, s0 = _inputs(rng, 150, "0.97-0.999", K=5, V=7)
    y, s = _wkv_chunked(*map(_t, (r, k, v, w, u, s0)), nsub=nsub)
    exact_y, exact_s = _wkv_f64(r, k, v, w, u, s0)
    _close(y, exact_y)
    _close(s, exact_s)
    want_y, want_s = jref.rwkv6_scan(r, k, v, w, u, s0)
    _close(y, want_y, exact_y)
    _close(s, want_s, exact_s)


def test_chunked_wkv_keeps_dtypes_and_t0(rng):
    r, k, v, w, u, s0 = _inputs(rng, 5, "0.5-0.9")
    y, s = _wkv_chunked(*(_t(a).bfloat16() for a in (r, k, v, w, u)),
                        nsub=1)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y, s = _wkv_chunked(*(_t(a)[:, :0] for a in (r, k, v, w)), _t(u),
                        _t(s0), nsub=1)
    assert tuple(y.shape) == (2, 0, 2, 16) and torch.equal(s, _t(s0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_len", [0, 1, 2, 15, 16, 17, 31, 32, 33, 63, 64,
                                   65, 512, 2040])
def test_wkv_chunks_cover_time_once(t_len, dtype):
    p = rw.wkv_plan(4, t_len, 40, 64, 64, dtype)
    assert p["chunk"] == rw.SUB * p["nsub"] and p["nsub"] in (1, 2, 4)
    steps = [t for c in range(p["chunks"])
             for t in range(c * p["chunk"], min((c + 1) * p["chunk"], t_len))]
    assert steps == list(range(t_len))
    assert p["chunks"] >= 1 and (p["chunks"] - 1) * p["chunk"] < max(t_len, 1)
    # the chunk is no longer than T needs: a shorter one would cover it too
    assert p["nsub"] == 1 or p["chunk"] // 2 < t_len


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kd,vd", [(1, 1), (5, 7), (8, 16), (16, 5),
                                   (64, 64), (100, 48), (128, 256),
                                   (128, 64), (33, 65)])
@pytest.mark.parametrize("t_len", [1, 17, 40, 512])
def test_wkv_plan_fits_the_card(t_len, kd, vd, dtype):
    """Every plan fits a block's shared memory and 256 threads; the
    blocks cover every state row and column."""
    p = rw.wkv_plan(3, t_len, 5, kd, vd, dtype)
    assert p["smem_bytes"] <= SMEM_LIMIT and p["blocks_per_sm"] >= 1
    assert p["threads"] == rw.THREADS <= 1024
    assert kd <= p["kmax"] <= 128 and p["kmax"] in (16, 32, 64, 128)
    assert p["vslices"] * rw.VS >= vd > (p["vslices"] - 1) * rw.VS
    assert p["tickets"] == 3 * 5 * p["vslices"] * p["chunks"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_served_prefill_plan(dtype):
    """rwkv6-3b's wave prefill (4 x 512 tokens, 40 heads x 64): chunks of
    64 steps, 1280 units (8 times the 160 (b, h) of one block each) and
    two blocks an SM."""
    p = rw.wkv_plan(4, 512, 40, 64, 64, dtype)
    assert (p["kmax"], p["nsub"], p["chunk"], p["chunks"], p["vslices"]) \
        == (64, 4, 64, 8, 1)
    assert p["tickets"] == 1280 >= 4 * 4 * 40
    assert p["blocks_per_sm"] >= 2 and p["tickets"] > SMS * p["blocks_per_sm"]


@pytest.mark.parametrize("d", range(16, 257, 16))
def test_flash_f32_plan_fits_the_card(d):
    """Every head dim 16 ... 256: the f32 flash kernel's shared memory fits
    a block, its threads' rows cover the 64-query tile, and up to D = 128
    two blocks share an SM."""
    p = fa.ffma_plan(d)
    assert p["smem_bytes"] <= SMEM_LIMIT
    assert p["threads"] // 16 * p["rows"] == p["block_q"] == 64
    assert p["block_kv"] == 64 and p["rows"] in (4, 8)
    assert p["blocks_per_sm"] >= (2 if d <= 128 else 1)
    assert p["smem_bytes"] == 4 * (64 * d * 3 + 64 * 64)
