"""Whole runs of every cell on the CPU at a small size, the look for a
card skipped: a sound run comes out correct; each fault the cell can
have, planted under the timed path, and the fp8 control in the
program's place, come out not correct by the cell's own limits."""
import contextlib

import pytest

from portbench import faults, harness
from portbench.tests.small import CELLS

SEED = 2**31 + 2026
ENTRY = {cell: harness.load_json(
    harness.PB / "traffic" /
    f"{harness.cell_entry(harness.benchmark(), cell)['traffic']}.json")
    ["entry"] for cell in CELLS}


def _run(cell, fault=None, trace=False):
    plant = faults.planted(ENTRY[cell], fault) if fault \
        else contextlib.nullcontext()
    with plant:
        return harness.run_cell(cell, SEED, 0.2, trace, device="cpu",
                                overrides=CELLS[cell], control=True)


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct_and_the_control_is_not(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    low = r["counters"]["control"]
    assert any(v > r["checks"][k]["limit"] for k, v in low.items()
               if k in r["checks"]), low
    e2e, _ = harness.cell_metrics(harness.benchmark(), cell)
    assert set(r["metrics"]) == {m["name"] for m in e2e}


@pytest.mark.parametrize("cell, fault", [
    (cell, f) for cell in CELLS for f in faults.FAULTS[ENTRY[cell]]])
def test_fault_under_the_timed_path_is_caught(cell, fault):
    r = _run(cell, fault)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("cell", ["qwen2-1.5b.mlp-compile-t4096",
                                  "qwen2-1.5b.train-8x512"])
def test_traced_run_reports_the_layer_metrics(cell):
    r = _run(cell, trace=True)
    assert r["correct"] and "breakdown" in r
    assert r["device"]["window_s"] > 0
    assert list(r)[-1] == "checks"
    _, layer = harness.cell_metrics(harness.benchmark(), cell)
    # on the CPU no card peak is known: the shares of a peak stay silent
    assert set(r["metrics"]) <= {m["name"] for m in layer}
    assert any(n.startswith("idle_pct.") for n in r["metrics"])


def test_run_without_a_card_prints_no_result():
    """``run.py`` exits nonzero with nothing on standard output where
    torch sees no card (the look for a card is the only step skipped
    above)."""
    import subprocess
    import sys

    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: run.py would run the cell")
    out = subprocess.run(
        [sys.executable, str(harness.PB / "run.py"), "--workload",
         "qwen2-1.5b.mlp-compile-t4096", "--seed", str(SEED), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr
