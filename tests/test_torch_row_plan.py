"""The launch plan of RMSNorm and the row softmax
(``kernels/row_reduce.py::row_plan``, the twin of ``plan`` in
``csrc/row_reduce.cuh``; the card tests hold the two equal) on the CPU:
which path a row takes, how many threads a row and vectors a thread, and
that the threads' vectors cover a row exactly.  No card and no JAX: the
plan is arithmetic on the extents."""
import itertools

import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import generic, row_reduce
from repro_torch.kernels import rmsnorm as rn

DTYPES = [torch.float32, torch.bfloat16]
SMS = 132   # H100 SXM
# the published d_model of the architectures the reference serves
# (whisper-base 512 ... arctic-480b 7168); the port's configs are among them
PUBLISHED_WIDTHS = (512, 1536, 2560, 4096, 5120, 6144, 7168)
CONFIG_WIDTHS = sorted({get_config(a, reduced=r).d_model
                        for a in ARCHS for r in (False, True)})
ROW_COUNTS = (1, 4, 8, 2048)
# softmax rows of the pass's widths that the vectors take: the
# ResNet18 head's 1000 classes, powers of two up to the pass's 1024
SOFTMAX_WIDTHS = (8, 64, 128, 512, 1000, 1024)
GENERAL_WIDTHS = (33, 100, 130)


def _covers_exactly(p: dict, d: int) -> None:
    """Thread t of a row holds vectors t, t + tpr, ...: every vector of
    the row once, and no thread a slot past the last vector's column."""
    nvec = d // p["vec"]
    held = [t + j * p["tpr"] for t in range(p["tpr"]) for j in range(p["vpt"])
            if t + j * p["tpr"] < nvec]
    assert sorted(held) == list(range(nvec))
    assert p["tpr"] * (p["vpt"] - 1) < nvec <= p["tpr"] * p["vpt"]


def _launch_fits(p: dict, rows: int) -> None:
    assert p["tpr"] % 32 == 0 and 32 <= p["tpr"] <= p["threads"] <= 1024
    assert p["threads"] == p["tpr"] * p["rows_per_block"]
    assert (p["grid"] - 1) * p["rows_per_block"] < max(rows, 1) \
        <= p["grid"] * p["rows_per_block"] or rows == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", ROW_COUNTS)
@pytest.mark.parametrize("d", sorted(set(PUBLISHED_WIDTHS) | set(CONFIG_WIDTHS)))
def test_rms_plan_takes_every_model_width_on_the_register_path(dtype, rows,
                                                                d):
    p = rn.rms_plan(rows, d, dtype, SMS)
    assert p["path"] in ("warp", "block")
    assert p["vec"] == 16 // dtype.itemsize
    assert 1 <= p["vpt"] <= row_reduce.MAX_VPT
    _covers_exactly(p, d)
    _launch_fits(p, rows)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", ROW_COUNTS)
@pytest.mark.parametrize("cols", SOFTMAX_WIDTHS)
def test_softmax_plan_takes_the_pass_widths_on_the_register_path(dtype, rows,
                                                                 cols):
    p = generic.softmax_plan(rows, cols, dtype, SMS)
    assert p["path"] in ("warp", "block")
    assert 1 <= p["vpt"] <= row_reduce.MAX_VPT
    _covers_exactly(p, cols)
    _launch_fits(p, rows)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", ROW_COUNTS)
def test_plans_take_the_general_path_off_the_vector(dtype, rows):
    """Widths off a multiple of the 16-byte vector (33, 100 and 130 in
    bf16; 33 and 130 in f32, where 100 is 25 vectors of 4), unaligned
    bases, a softmax row wider than the pass admits, and a row too wide
    for the register instances take the block-stride loop."""
    vec = 16 // dtype.itemsize
    for d in GENERAL_WIDTHS:
        for plan in (rn.rms_plan, generic.softmax_plan):
            p = plan(rows, d, dtype, SMS)
            assert (p["path"] == "general") == (d % vec != 0), (d, p)
            if d % vec:
                assert p["vpt"] == 0 and p["vec"] == 1
    for d in (1536, 1000):
        for plan in (rn.rms_plan, generic.softmax_plan):
            assert plan(rows, d, dtype, SMS, aligned=False)["path"] == \
                "general"
    for cols in (1032, 2048, 4096, 7168):
        assert generic.softmax_plan(rows, cols, dtype, SMS)["path"] == \
            "general"
        assert rn.rms_plan(rows, cols, dtype, SMS)["path"] != "general"
    widest = row_reduce.MAX_VPT * row_reduce.ROW_THREADS * 16 // \
        dtype.itemsize
    assert rn.rms_plan(rows, widest, dtype, SMS)["path"] != "general"
    p = rn.rms_plan(rows, widest + 16 // dtype.itemsize, dtype, SMS)
    assert p["path"] == "general"


@pytest.mark.parametrize("d", [1, 10, 33, 100, 130, 256, 4097, 40000])
def test_general_path_threads(d):
    """A block a row, a multiple of 32 threads up to GENERAL_THREADS
    (an unaligned base sends every width there)."""
    p = row_reduce.row_plan(5, d, 4, False, SMS)
    assert p["path"] == "general"
    assert p["threads"] == p["tpr"] == min(-(-d // 32) * 32,
                                           row_reduce.GENERAL_THREADS)
    assert p["grid"] == 5 and p["rows_per_block"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_count_picks_warp_or_block(dtype):
    """Many rows (a prefill) share blocks, a warp a row at the served
    widths; few rows (a decode step) take a block each; the switch is
    where the shared blocks stop filling the card's SMs."""
    vec = 16 // dtype.itemsize
    for d in (1536, 2560, 4096):
        prefill = rn.rms_plan(2048, d, dtype, SMS)
        assert prefill["path"] == "warp"
        assert prefill["grid"] >= SMS
        if d // vec <= 32 * row_reduce.MAX_VPT:
            assert prefill["tpr"] == 32
        for rows in (1, 4, 8):
            p = rn.rms_plan(rows, d, dtype, SMS)
            assert p["path"] == "block" and p["grid"] == rows
        rpb = rn.rms_plan(10 ** 6, d, dtype, SMS)["rows_per_block"]
        assert rn.rms_plan(SMS * rpb, d, dtype, SMS)["path"] == "warp"
        assert rn.rms_plan(SMS * rpb - rpb, d, dtype, SMS)["path"] == "block"
        # a smaller card fills sooner
        assert rn.rms_plan(64, d, dtype, 1)["path"] == "warp"


def test_decode_rows_hold_one_or_two_vectors_a_thread():
    """The served bf16 widths at a decode step: one or two vectors a
    thread (1536: 192 x 1; 2560: 160 x 2; 4096: 256 x 2)."""
    got = {d: (p["tpr"], p["vpt"]) for d in (1536, 2560, 4096)
           for p in [rn.rms_plan(8, d, torch.bfloat16, SMS)]}
    assert got == {1536: (192, 1), 2560: (160, 2), 4096: (256, 2)}


def test_plan_is_the_c_plans_form():
    """The fields and path codes the exported C plan writes."""
    p = row_reduce.row_plan(8, 1536, 2, True, SMS)
    assert tuple(p) == row_reduce.FIELDS
    assert row_reduce.PATHS.index(p["path"]) == 2


@pytest.mark.parametrize("rows,d,item", list(itertools.product(
    (0, 1, 1055, 1056, 70000), (8, 1000, 1024, 1536, 7168, 16384), (2, 4))))
def test_plan_grid_covers_the_rows(rows, d, item):
    for max_d in (0, row_reduce.SOFTMAX_MAX_COLS):
        p = row_reduce.row_plan(rows, d, item, True, SMS, max_d)
        _launch_fits(p, rows)
        if p["path"] != "general":
            _covers_exactly(p, d)
