"""BENCHMARK.json against the benchmark's contract: names and units in the
allowed characters, the keys each entry may have, every metric's
``workloads`` and ``moves`` consistent, every cell's files found by name."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = MAN[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_configs_and_cells():
    configs = {c["name"]: c for c in MAN["configs"]}
    assert len({c["file"] for c in configs.values()}) == len(configs)
    for c in configs.values():
        assert c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    used = set()
    pairs = set()
    for w in MAN["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    w = next(x for x in MAN["workloads"] if x["name"] == cell)
    conf = next(c for c in MAN["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    spec = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())
    for mod in (f"benchmark.families.{cfg['family']}", f"benchmark.reference.{cfg['family']}",
                f"benchmark.tasks.{traffic['task']}"):
        importlib.import_module(mod)
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())
    assert cfg["dtype"] == "float32"


def test_metrics_consistent():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in MAN["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = {n for n, m in e2e.items() if cell in m.get("workloads", cells)}
        assert "setup_s" in reported and len(reported) >= 2, cell
        layer = [m for m in MAN["per_layer"] if cell in m.get("workloads", ())]
        assert layer, cell
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(1 <= len(layer) <= 200 for layer in layers)


def test_paths_named_from_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
