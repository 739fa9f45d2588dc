"""The harness finds every cell, configuration, traffic mix, limit file and
metric reader by name, refuses what it cannot find, and BENCHMARK.json
keeps to the characters and sizes its contract allows."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import catalog, harness

BENCH = catalog.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_finds_its_files(workload):
    cell = catalog.find_cell(BENCH, workload)
    cfg = catalog.read("configs", cell.config)
    assert cfg["regime"] in ("sim", "lm")
    traffic = catalog.read("traffic", cell.traffic)
    assert traffic["clients"] > 1
    limits = catalog.read("limits", cell.name)
    assert set(limits) >= {"loss_gap", "grad_gap", "change_gap"}
    assert [m["name"] for m in cell.end_to_end][:2] == ["setup_s", "round_ms"]
    assert {"mfu", "device_idle_share"} <= {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("metric", METRICS)
def test_every_metric_has_a_reader(metric):
    assert callable(catalog.reader(metric).read)


@pytest.mark.parametrize("kind,name", [("configs", "no-such-config"),
                                       ("traffic", "no-such-mix"),
                                       ("limits", "no-such-cell"),
                                       ("configs", "../BENCHMARK"),
                                       ("traffic", "a b")])
def test_unknown_or_malformed_names_are_refused(kind, name):
    with pytest.raises(ValueError):
        catalog.read(kind, name)


def test_unknown_workload_and_metric_are_refused():
    with pytest.raises(ValueError, match="no workload named"):
        catalog.find_cell(BENCH, "no-such-cell")
    with pytest.raises(ValueError, match="no reader"):
        catalog.reader("no_such_metric")
    assert harness.main(["--workload", "no-such-cell", "--seed", "1",
                         "--seconds", "1"]) == 2


def test_names_units_and_sizes_follow_the_contract():
    text = (catalog.ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    configs = [c["name"] for c in BENCH["configs"]]
    for group in (configs, CELLS, METRICS):
        assert len(group) == len(set(group))
    names = configs + CELLS + METRICS
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and \
            Path(catalog.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    ends = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in ends and "\n" not in m["layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 <= 43200 // (BENCH["run_seconds"] + 60)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(catalog.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(catalog.HERE)))
def test_nothing_imports_jax_or_the_jax_package(path):
    found = _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks",
                              "chip_smoke", "kernel_ab"}
    assert not found, found
    if "reference" in path.parts:
        assert "repro_torch" not in _imports(path)


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, str(catalog.HERE / "run.py"), "--workload",
         CELLS[0], "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
