"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""

import json
import os
import re

import pytest

from conftest import BENCH_DIR, ROOT
from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
WIDTH_KEYS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                        r"projection|head|expansion|experts_per_token")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 \
        and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for word in cmd:
        if "/" in word and not word.startswith("-"):
            assert any(word.startswith(p + "/") for p in bench["paths"])


def test_run_seconds_fit_a_full_check_of_24_cells(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_well_formed(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_resolve_by_name(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert one_line(c["source"]) and one_line(c["why"])
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH_KEYS.search(key)
            assert key in config


def test_cells_resolve_by_name(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        cell = spec.cell(w["name"])
        assert os.path.isfile(spec.traffic_path(w["traffic"]))
        assert cell.limits, "every cell compares at least one number"
        for lim in cell.limits.values():
            assert lim["limit"] >= 0
        if cell.traffic["loop"] == "sharded":
            c, t = cell.traffic["mesh"]
            assert c * t == w["chips"]


def test_metrics_resolve_by_name(bench):
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert os.path.isfile(spec.metric_path(m["name"])), m["name"]
            assert callable(spec.reader(m["name"]))
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                            "higher")
            assert m["source"] in SOURCES


def test_end_to_end_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_moves_a_metric_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert one_line(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells and spec.reports(moved, cell), \
                (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_benchmark_files_are_named_from_names():
    for dirpath, _dirs, files in os.walk(BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        rel = os.path.relpath(dirpath, os.path.dirname(BENCH_DIR))
        assert PATH.match(rel)
        for f in files:
            assert NAME.match(f), os.path.join(rel, f)
