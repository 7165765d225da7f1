"""BENCHMARK.json against the benchmark's contract, the files each entry
names, the result line's keys, and a cell added as files alone."""

import json
import re
import shutil

import pytest
import torch
from conftest import ROOT, SEED, SMALL, find

from gnnbench import run as cli
from gnnbench.harness import Cell, load_module, run_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gnnbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gnnbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["name"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_file_matches_its_entry(metric):
    reader = load_module(ROOT / "gnnbench" / "metrics" / f"{metric['name']}.py", "m")
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (
        metric["unit"], metric["layer"], metric["moves"])
    moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert cell in moves.get("workloads", [cell])


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(workload):
    cell = find(workload["name"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}
    # the configuration's graph shape is what the traffic draws
    assert all(cell.traffic.graph[k] == cell.config[k]
               for k in ("num_nodes", "num_features", "num_classes"))
    reduced = next(c["reduced"] for c in BENCH["configs"] if c["name"] == workload["config"])
    assert set(reduced) == set(cell.config["published"]) - {"num_edges"}


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_holds_the_contract_keys(trace):
    cell = find("gcn-products-train", overrides=SMALL)
    result, lines, _ = run_cell(cell, SEED, 0.2, bool(trace), "cpu")
    assert set(result) == RESULT_KEYS | ({"breakdown"} if trace else set())
    assert list(result)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert len(lines) == len(result["checks"])
    json.dumps(result)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--workload", "gat-products-train", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_cell_added_as_files_runs(tmp_path):
    """A later cell adds a configuration, a traffic file, a limits file and
    entries in BENCHMARK.json; nothing that is there is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "gnnbench", root / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "gnnbench" / "configs" / "gcn-products.json").read_text())
    config.update(name="gcn-small", hidden=32, num_nodes=2048)
    (root / "gnnbench" / "configs" / "gcn-small.json").write_text(json.dumps(config))
    spec = json.loads((ROOT / "gnnbench" / "traffic" / "products-train.json").read_text())
    spec.update(chunks=4, max_degree=16)
    (root / "gnnbench" / "traffic" / "c4-train.json").write_text(json.dumps(spec))
    (root / "gnnbench" / "limits" / "gcn-small-c4-train.json").write_text(
        (ROOT / "gnnbench" / "limits" / "gcn-products-train.json").read_text())
    bench["configs"].append({"name": "gcn-small", "source": "a test", "why": "a test",
                             "file": "gnnbench/configs/gcn-small.json", "reduced": []})
    bench["workloads"].append({"name": "gcn-small-c4-train", "config": "gcn-small",
                               "traffic": "c4-train", "chips": 1, "why": "added as files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "gcn-products-train" in m.get("workloads", []):
            m["workloads"].append("gcn-small-c4-train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell.find("gcn-small-c4-train", root=root, overrides={"graph": {"block_size": 512}})
    assert cell.traffic.graph["num_nodes"] == 2048 and cell.traffic.chunks == 4
    result, *_ = run_cell(cell, SEED, 0.2, True, "cpu")
    assert set(result["metrics"]) == {"plan_build_s"}  # the CPU has no device trace
    assert result["correct"] and result["attempted"] >= 1
