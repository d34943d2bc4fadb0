"""BENCHMARK.json against the contract's form and the harness's data files:
names and units, each per-layer metric's end-to-end metric reported by
all its cells, the share of four-card cells, the files each entry
names."""
import json
import os
import re

import pytest

from perfbench.harness import cell as cell_mod

ROOT = cell_mod.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + [
        w["name"] for w in bench["workloads"]] + [
        m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 0 < len(w["why"]) <= 200 and "\n" not in w["why"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


def _reports(bench, cell, metric) -> bool:
    m = next(e for e in bench["end_to_end"] if e["name"] == metric)
    return "workloads" not in m or cell in m["workloads"]


def test_per_layer_moves_a_metric_of_each_cell(bench):
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        for c in m.get("workloads", cells):
            assert _reports(bench, c, m["moves"]), (m["name"], c)


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if _reports(bench, w["name"], m["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", ()) or
                   ("workloads" not in m and m["moves"] in e2e)
                   for m in bench["per_layer"])


def test_four_card_cells_at_most_a_quarter(bench):
    four = sum(1 for w in bench["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_entries_match_the_harness_files(bench):
    """Each cell's workload file names the same configuration, traffic,
    chips and end-to-end metrics as BENCHMARK.json; each per-layer metric
    has its reader, which runs exactly in the cells it lists."""
    for c in bench["configs"]:
        assert c["file"] == "perfbench/configs/%s.json" % c["name"]
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = cell_mod.load(w["name"])
        assert (cell.config_name, cell.traffic_name, cell.chips) == (
            w["config"], w["traffic"], w["chips"])
        with open(os.path.join(cell_mod.BENCH, "workloads",
                               w["name"] + ".json")) as f:
            assert json.load(f)["why"] == w["why"]
        e2e = sorted(m["name"] for m in bench["end_to_end"]
                     if _reports(bench, w["name"], m["name"]))
        assert sorted(cell.end_to_end) == e2e
        readers = cell_mod.metric_readers(cell.end_to_end)
        listed = sorted(m["name"] for m in bench["per_layer"]
                        if w["name"] in m["workloads"])
        assert sorted(readers) == listed
    for m in bench["per_layer"]:
        mod = cell_mod.metric_readers([m["moves"]])[m["name"]]
        assert mod.MOVES == m["moves"] and mod.UNIT == m["unit"]


def test_paths_hold_the_command(bench):
    assert bench["paths"] == ["perfbench"]
    assert bench["command"][1].startswith("perfbench/")
