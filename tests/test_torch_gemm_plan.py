"""The launch plan of the port's GEMM (``kernels/matmul.py::gemm_plan``,
the twin of ``gemm_plan`` in ``csrc/gemm.cuh``; the card tests hold the
two equal) on the CPU: its route rules, the tiles and grid it launches,
split-K and the broadcast fold.  No card and no JAX: the plan is
arithmetic on the extents."""
import itertools
import re

import pytest
import torch

from repro_torch.core import pipeline
from repro_torch.core.options import CompileOptions
from repro_torch.core.tracer import TensorSpec
from repro_torch.kernels import _build
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops as kops

DTYPES = [torch.float32, torch.bfloat16]
EXTENTS = (1, 7, 8, 91, 128, 201, 512, 1000, 1536, 8960)
# (m, n, k, batch): the main paths' products — the qwen2-1.5b MLP block,
# ResNet18's fc, MALA's layers, kk.gemv, phase 12's tiled cases
PATH_SHAPES = [(2048, 8960, 1536, 1), (2048, 1536, 8960, 1),
               (8, 1000, 512, 1), (8748, 400, 91, 1), (8748, 400, 400, 1),
               (8748, 201, 400, 1), (1000, 1, 777, 1), (64, 64, 64, 64),
               (128, 128, 128, 16), (2048, 2048, 128, 12),
               (256, 8960, 1536, 8)]


def _check_launch(p: dict, m: int, n: int, k: int, batch: int) -> None:
    """Whole tiles within a block's limits, and a grid that covers every
    output and every K step exactly once."""
    bm, bn, bk = p["bm"], p["bn"], p["bk"]
    assert bm % 8 == 0 and bn % 8 == 0
    assert 1 <= p["threads"] <= 1024
    assert p["smem_bytes"] <= mm.MAX_SMEM_BYTES
    if p["route"] == "ffma":
        assert p["threads"] == (bm // 8) * (bn // 8)   # one 8 × 8 micro-tile
        assert (bm, bn) in [t[:2] for t in mm.FFMA_TILES]
    else:
        assert (bm, bn, bk) == mm.WGMMA_TILE and p["threads"] == 384
    assert p["m"] * p["batch"] == m * batch
    tx, ty, tz = p["tiles"]
    assert (tx - 1) * bm < p["m"] <= tx * bm
    assert (ty - 1) * bn < n <= ty * bn
    assert tz == p["batch"] * p["split"]
    if p["route"] == "wgmma":   # one block an SM walks the tiles
        assert p["grid"] == (min(tx * ty * tz, mm.SMS), 1, 1)
    else:
        assert p["grid"] == (tx, ty, min(tz, mm.MAX_GRID_Z))
    assert p["k_chunk"] % bk == 0 and p["k_chunk"] >= bk
    if k:
        assert (p["split"] - 1) * p["k_chunk"] < k <= p["split"] * p["k_chunk"]
    else:
        assert p["split"] == 1
    assert p["workspace_bytes"] == (
        4 * p["split"] * p["batch"] * p["m"] * n if p["split"] > 1 else 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_route_rules(dtype, aligned):
    """Aligned bf16 with K and N multiples of 8 goes to wgmma; f32, an
    unaligned operand, K or N off a multiple of 8, K = 0 and kk.gemv's
    N = 1 go to FFMA."""
    for m, n, k in itertools.product((1, 8, 130), EXTENTS, EXTENTS + (0,)):
        p = mm.gemm_plan(m, n, k, 1, dtype, aligned)
        want = (dtype == torch.bfloat16 and aligned and k > 0
                and k % 8 == 0 and n % 8 == 0)
        assert p["route"] == ("wgmma" if want else "ffma"), (m, n, k)
    for k in (91, 777, 1536):
        assert mm.gemm_plan(1000, 1, k, 1, dtype, aligned)["route"] == "ffma"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 3, 70000])
def test_plan_tiles_fit_a_block_and_cover_the_output(dtype, batch):
    for m, n, k in itertools.product(EXTENTS, EXTENTS, (0, 8, 91, 1536)):
        for aligned in (True, False):
            p = mm.gemm_plan(m, n, k, batch, dtype, aligned)
            _check_launch(p, m, n, k, batch)


@pytest.mark.parametrize("shape", PATH_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_at_the_main_paths_shapes(shape, dtype):
    m, n, k, batch = shape
    p = mm.gemm_plan(m, n, k, batch, dtype, True, fold=batch > 1 and
                     shape == (256, 8960, 1536, 8))
    _check_launch(p, m, n, k, batch)


@pytest.mark.parametrize("aligned", [True, False])
def test_fc_gemm_splits_k_to_fill_the_card(aligned):
    """ResNet18's fc (8 × 512 × 1000, f32): 16 tiles alone would leave 116
    of 132 SMs idle; split-K gives the grid at least one block an SM."""
    p = mm.gemm_plan(8, 1000, 512, 1, torch.float32, aligned)
    assert p["split"] > 1
    gx, gy, gz = p["grid"]
    assert gx * gy * gz >= mm.SMS
    assert p["k_chunk"] >= 2 * p["bk"]      # ranges of at least two K steps
    _check_launch(p, 8, 1000, 512, 1)


def test_bf16_fc_gemm_splits_k_into_ranges_of_two_steps():
    """The same fc in bf16 runs on wgmma (8 tiles of 128 × 128, K steps
    of 64): four ranges of two steps each."""
    p = mm.gemm_plan(8, 1000, 512, 1, torch.bfloat16, True)
    assert (p["route"], p["split"], p["k_chunk"]) == ("wgmma", 4, 128)
    assert p["tiles"] == (1, 8, 4) and p["grid"] == (32, 1, 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k", [(2048, 8960, 1536), (8748, 400, 400),
                                   (2048, 2048, 128), (8, 1000, 128),
                                   (2048, 1536, 1536)])
def test_plan_does_not_split_where_the_tiles_fill_the_card(dtype, m, n, k):
    """No split where the tiles fill the card and K is too short for two
    ranges of BALANCE_MIN_K (the MLP block's up-projections among them),
    nor for a short K on a small grid."""
    p = mm.gemm_plan(m, n, k, 1, dtype, True)
    assert p["split"] == 1 and p["workspace_bytes"] == 0
    assert p["k_chunk"] >= k


def test_ffma_splits_deep_k_to_balance_the_sms():
    """The MLP block's f32 down-projection (2048 × 8960 → 1536): 192 tiles
    of 128² would be 1.45 an SM, so K splits in two ranges of 4480 (384
    tiles, 2.9 an SM); the bf16 route keeps one range, and so does a K
    too short for two ranges of BALANCE_MIN_K."""
    p = mm.gemm_plan(2048, 1536, 8960, 1, torch.float32, True)
    assert (p["bm"], p["bn"], p["split"], p["k_chunk"]) == (128, 128, 2, 4480)
    assert p["tiles"] == (16, 12, 2) and p["k_chunk"] >= mm.BALANCE_MIN_K
    assert p["workspace_bytes"] == 2 * 2048 * 1536 * 4
    assert mm.gemm_plan(2048, 1536, 8960, 1, torch.bfloat16, True)["split"] \
        == 1
    assert mm.gemm_plan(2048, 1536, 2 * mm.BALANCE_MIN_K - 16, 1,
                        torch.float32, True)["split"] == 1
    for k in (4096, 8960, 30000):
        p = mm.gemm_plan(2048, 1536, k, 1, torch.float32, True)
        assert 1 <= p["split"] <= mm.BALANCE_MAX_SPLIT
        assert p["split"] == 1 or p["k_chunk"] >= mm.BALANCE_MIN_K


def test_ffma_tile_follows_the_card_fill():
    """2048 × 8960 fills the card with 128 × 128 tiles; 2048 × 1536 at a
    K too short to split (192 such tiles, 1.45 a SM) takes 128 × 64
    (384, 2.9 a SM)."""
    f32 = torch.float32
    p = mm.gemm_plan(2048, 8960, 1536, 1, f32, True)
    assert (p["bm"], p["bn"]) == (128, 128)
    p = mm.gemm_plan(2048, 1536, 1536, 1, f32, True)
    assert (p["bm"], p["bn"], p["split"]) == (128, 64, 1)
    assert mm.gemm_plan(8, 1000, 512, 1, f32, True)["bm"] == 64


def test_wgmma_grid_is_one_block_an_sm():
    """The wgmma route is persistent: the MLP up-projection's 1120 tiles
    go to 132 blocks, a batch of 64 one-tile products to 64."""
    bf16 = torch.bfloat16
    assert mm.gemm_plan(2048, 8960, 1536, 1, bf16, True)["grid"] == \
        (132, 1, 1)
    assert mm.gemm_plan(64, 64, 64, 64, bf16, True)["grid"] == (64, 1, 1)


def test_plans_are_cached_and_not_shared():
    """The plan is computed once per extents; callers get their own dict."""
    p = mm.gemm_plan(2048, 8960, 1536, 1, torch.float32, True)
    p["split"] = 99
    assert mm.gemm_plan(2048, 8960, 1536, 1, torch.float32, True)["split"] \
        == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_broadcast_b_folds_into_one_product(dtype):
    """(8, 256, 1536) @ (1536, 8960) with B shared and A packed is one
    2048 × 8960 product; without the fold it stays a batch of 8."""
    folded = mm.gemm_plan(256, 8960, 1536, 8, dtype, True, fold=True)
    plain = mm.gemm_plan(2048, 8960, 1536, 1, dtype, True)
    assert (folded["m"], folded["batch"]) == (2048, 1)
    assert folded == plain
    kept = mm.gemm_plan(256, 8960, 1536, 8, dtype, True, fold=False)
    assert (kept["m"], kept["batch"], kept["tiles"][2]) == (256, 8, 8)
    # a batch of one has nothing to fold
    one = mm.gemm_plan(256, 8960, 1536, 1, dtype, True, fold=True)
    assert (one["m"], one["batch"]) == (256, 1)


def test_plan_constants_are_the_headers():
    """The twin's constants are the CUDA sources' own."""
    gemm = _build.csrc("gemm.cuh")
    sm90 = _build.csrc("gemm_sm90.cuh")
    tile = _build.csrc("gemm_tile.cuh")
    tiles = re.search(r"FFMA_TILES\[3\]\[3\] = \{(.*?)\};", gemm).group(1)
    assert tuple(tuple(int(x) for x in re.findall(r"\d+", t)) for t in
                 re.findall(r"\{([^{}]*)\}", tiles)) == mm.FFMA_TILES
    assert f"SMS = {mm.SMS};" in gemm
    assert f"SPLIT_MIN_K = {mm.SPLIT_MIN_K};" in gemm
    assert f"BALANCE_MIN_K = {mm.BALANCE_MIN_K};" in gemm
    assert f"BALANCE_MAX_SPLIT = {mm.BALANCE_MAX_SPLIT};" in gemm
    assert (f"REDUCE_PER_WORD = {mm.REDUCE_PER_WORD}, REDUCE_LAUNCH = "
            f"{mm.REDUCE_LAUNCH:d};") in gemm
    bm, bn, bk = mm.WGMMA_TILE
    assert f"BM = {bm}, BN = {bn}, BK = {bk};" in sm90
    assert f"STAGES = {mm.WGMMA_STAGES};" in sm90
    assert f"THREADS = {mm.WGMMA_THREADS};" in sm90
    assert f"BK = {mm.FFMA_BK};" in tile and \
        f"STAGES = {mm.FFMA_STAGES};" in tile


def test_one_matmul_library_serves_every_gemm_of_a_graph():
    """The prebuild list names ``csrc/matmul.cu`` once, with no tiling
    defines, whatever tilings the pass gave the block's three gemms."""
    from repro_torch.models.mlp import gated_mlp_block
    gen = torch.Generator().manual_seed(0)
    p = {k: torch.randn(s, generator=gen) for k, s in
         (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    mod = pipeline.compile(lambda x: gated_mlp_block(p, x, act="silu"),
                           TensorSpec((32, 64), "float32"),
                           options=CompileOptions(target="cuda",
                                                  device="cpu"))
    gemms = [ks for ks in kops.kernel_sources(mod.graph)
             if ks.name == "matmul"]
    assert len(gemms) == 3 and len(set(gemms)) == 1
    assert gemms[0].defines == () and gemms[0] == mm.matmul_kernel()


def test_cpu_workspace_is_not_allocated_for_an_unsplit_plan():
    plan = mm.gemm_plan(2048, 8960, 1536, 1, torch.float32, True)
    assert mm.workspace(plan, "cpu") == (None, None, 0)
    plan = mm.gemm_plan(8, 1000, 512, 1, torch.float32, True)
    ws, ptr, nbytes = mm.workspace(plan, "cpu")
    assert ws.dtype == torch.float32 and ws.numel() * 4 == nbytes
    assert ptr == ws.data_ptr() and nbytes == plan["workspace_bytes"]
