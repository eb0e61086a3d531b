"""Every file the benchmark finds by name is there and agrees with
``BENCHMARK.json`` and with the program."""

from __future__ import annotations

import json
import re

import pytest

from colonybench import harness

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["colonybench"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    entry = harness.cell_entry(BENCH, cell)
    cfg = harness.config_file(BENCH, entry["config"])
    mix = harness.mix_file(entry["traffic"])
    limits = harness.load_json(harness.HERE / "cells" / f"{cell}.json")
    assert cfg["name"] == entry["config"]
    assert (harness.HERE / "traffic" / f"{mix['kind']}.py").exists()
    if mix["kind"] == "serve_generator":
        assert {"check_requests", "check_chunk"} < set(limits) <= {
            "check_requests", "check_chunk", "max_logit_gap", "max_logit_error",
            "median_logit_error"}
    else:
        assert set(limits) == {"loss_gap", "grad_norm_gap", "change_norm_gap"}
    assert entry["chips"] == 1 and len(entry["why"]) <= 200


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_matches_the_program(name):
    cfg = harness.config_file(BENCH, name)
    harness.check_config(cfg, cfg["port"]["variant"])
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["source"] == cfg["source"] and entry["reduced"] == []
    assert any(w["config"] == name for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(metric):
    assert NAME.match(metric["name"])
    assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=[m["name"] for m in BENCH["per_layer"]])
def test_per_layer_moves_a_metric_its_cells_report(metric):
    """``moves`` names an end-to-end metric that every cell listed reports,
    and the metric has a reader."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    target = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in target.get("workloads", CELLS)
    assert callable(harness.reader(metric["name"]))
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in harness.metrics_of(BENCH, cell, trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(BENCH, cell, trace=True)


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25


def test_kernel_files_name_the_programs_ops():
    import repro_torch.kernels.ops  # noqa: F401  (registers the custom ops)
    import torch

    for path in sorted((harness.HERE / "metrics" / "kernels").glob("*.json")):
        spec = json.loads(path.read_text())
        ns, op = spec["op"].split("::")
        assert hasattr(getattr(torch.ops, ns), op), spec["op"]
