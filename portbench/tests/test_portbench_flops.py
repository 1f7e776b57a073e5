"""The FLOP and byte counters against sums worked out by hand, and the
per-layer readers against a made-up trace."""
import types
from pathlib import Path

import pytest

from portbench import harness

PB = Path(__file__).resolve().parents[1]
Q = harness.load_json(PB / "configs" / "qwen2-1.5b.json")
QF = harness.load_module(PB / "flops" / "qwen2-1.5b.py")
MF = harness.load_module(PB / "flops" / "gated_mlp_block.py")
MLP = harness.load_json(PB / "traffic" / "mlp-compile-t4096.json")
TRAIN = harness.load_json(PB / "traffic" / "train-8x512.json")
PEAK = harness.load_json(PB / "peaks.json")["NVIDIA H100 80GB HBM3"]


def test_mlp_block():
    assert MF.call_flops(Q, MLP) == 3 * 2 * 4096 * 1536 * 8960
    assert MF.call_flops(Q, MLP) == pytest.approx(3.3823e11, rel=1e-4)
    up = 4096 * 1536 + 1536 * 8960 + 4096 * 8960
    down = 4096 * 8960 + 8960 * 1536 + 4096 * 1536
    assert MF.call_products(Q, MLP) == (MF.call_flops(Q, MLP),
                                        2 * (2 * up + down))
    f32 = dict(MLP, dtype="float32", rows=8)
    assert MF.call_products(Q, f32)[1] == 4 * (
        2 * (8 * 1536 + 1536 * 8960 + 8 * 8960)
        + 8 * 8960 + 8960 * 1536 + 8 * 1536)


def test_qwen2_train_step():
    layer = 1536 * 1536 * 2 + 2 * 1536 * 256 + 3 * 1536 * 8960
    n = 28 * layer + 151936 * 1536
    assert QF.matmul_params(Q) == n
    attn = 6 * 28 * 8 * 512 * 512 * 1536
    assert QF.train_flops(Q, TRAIN) == 6 * n * 4096 + attn
    assert QF.train_flops(Q, TRAIN) == pytest.approx(3.8476e13, rel=1e-3)


def test_qwen2_token():
    layer = 1536 * 1536 * 2 + 2 * 1536 * 256 + 3 * 1536 * 8960
    head = 151936 * 1536
    attn = 4 * 28 * 100 * 1536
    assert QF.token_flops(Q, 100) == 2 * (28 * layer + head) + attn
    assert QF.token_flops(Q, 100, head=False) == 2 * 28 * layer + attn


def _run(data, kernels=(), window_s=2.0, busy_s=1.5):
    trace = types.SimpleNamespace(
        busy_s=busy_s, kernel_count=lambda: len(kernels),
        kernel_s=lambda pick: sum(t for n, t in kernels if pick(n)))
    return types.SimpleNamespace(peak=PEAK, data=data, trace=trace,
                                 window_s=window_s)


def _reader(metric):
    return harness.load_module(harness.reader_path(metric))


def test_readers_by_hand():
    kernels = [("lapis_gemm_sm90_kernel", 0.8), ("nvjet_tst_x", 0.2),
               ("lapis_map::map_kernel", 0.3), ("elementwise_kernel", 0.1)]
    data = {"calls": 10, "steps": 4, "dtype": "bfloat16", "flops": 989e12,
            "product_flops": 0.5 * 989e12, "product_bytes": 3.35e12}
    run = _run(data, kernels)
    assert _reader("mfu.compile").read(run) == pytest.approx(50.0)
    assert _reader("mfu.train").read(run) == pytest.approx(50.0)
    assert _reader("idle_pct.compile").read(run) == pytest.approx(25.0)
    assert _reader("kernels_per_call.compile").read(run) == 0.4
    # bound 1 s (the bytes) over 1.0 s of GEMM kernels
    assert _reader("products_roofline.compile").read(run) == \
        pytest.approx(100.0)
    assert _reader("elementwise_ms.train").read(run) == pytest.approx(25.0)


def test_readers_find_nothing_to_read():
    run = _run({"dtype": "bfloat16"})
    for metric in ("mfu.compile", "products_roofline.compile",
                   "kernels_per_call.compile", "elementwise_ms.train"):
        assert _reader(metric).read(run) is None, metric
    run = _run({"calls": 3, "dtype": "float4", "flops": 1.0,
                "product_flops": 1.0, "product_bytes": 1.0},
               [("nvjet", 1.0)])
    assert _reader("mfu.compile").read(run) is None
    assert _reader("products_roofline.compile").read(run) is None


def test_reader_lookup():
    assert harness.reader_path("idle_pct.train").name == "idle_pct.py"
    assert harness.reader_path("mfu.compile").name == "mfu.py"
