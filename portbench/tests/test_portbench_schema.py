"""BENCHMARK.json against the benchmark's contract: keys, names and
units, bounds, each cell's metrics, and a file under ``portbench/`` for
everything the harness finds by name."""
import json
import re
import statistics
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    every = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    assert all(NAME.match(x["name"]) for x in every)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names)), group
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] == 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_e2e_and_a_layer_metric(cell):
    from portbench import harness
    e2e, layer = harness.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_names_an_e2e_metric_of_every_cell_it_lists(metric):
    moved = E2E[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS)
    from portbench import harness
    assert harness.reader_path(metric["name"]).is_file()


def test_metrics_of_one_layer_share_its_name():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"compiled call", "execution", "kernels", "device",
                      "train step"}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    cfg = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert (ROOT / cfg["file"]).is_file()
    assert (PB / "traffic" / f"{cell['traffic']}.json").is_file()
    assert (PB / "limits" / f"{cell['name']}.json").is_file()
    traffic = json.loads((PB / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    subject = traffic.get("call", cell["config"])
    assert (PB / "flops" / f"{subject}.py").is_file()
    assert (PB / "reference" / f"{subject}.py").is_file()
    assert (PB / "entries" / f"{traffic['entry']}.py").is_file()
    if "call" in traffic:
        assert (PB / "calls" / f"{traffic['call']}.py").is_file()


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cuts(cfg):
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["reduced"] == cfg["reduced"]
    assert all(k in body for k in cfg["reduced"])
    assert not any(k.endswith(("_dim", "_rank", "_size")) for k in
                   cfg["reduced"])


def test_port_fields_agree_with_the_published_keys():
    q = json.loads((PB / "configs" / "qwen2-1.5b.json").read_text())
    f = q["port"]["fields"]
    assert (f["n_layers"], f["d_model"], f["n_heads"], f["n_kv_heads"],
            f["d_ff"], f["vocab_size"]) == (
        q["num_hidden_layers"], q["hidden_size"], q["num_attention_heads"],
        q["num_key_value_heads"], q["intermediate_size"], q["vocab_size"])


def test_port_configs_match_the_files():
    """The port's config with the file's fields put in keeps the port's
    other settings that the references read (RoPE base, the q / k / v
    biases, the tied head, the activation)."""
    import types

    from portbench import portcfg
    body = json.loads((PB / "configs" / "qwen2-1.5b.json").read_text())
    cfg = portcfg.model_config(types.SimpleNamespace(config=body))
    assert cfg.rope_theta == body["rope_theta"] and cfg.qkv_bias
    assert cfg.tie_embeddings and cfg.act == body["hidden_act"]


def test_check_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_quartile_spread_helper_matches_the_contract():
    from portbench import spread
    vals = [10.0, 10.2, 9.9, 10.1, 10.05, 9.95]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert spread.iqr_share(vals) == pytest.approx(
        (q3 - q1) / statistics.median(vals))


def test_spread_without_the_farthest_run_and_range():
    from portbench import spread
    vals = [10.0, 10.1, 9.9, 10.0, 10.05, 12.0]
    assert spread.trimmed(vals) == [10.0, 10.1, 9.9, 10.0, 10.05]
    assert spread.range_share(vals) == pytest.approx(2.1 / 10.025)
