"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""
import json
import pathlib
import re

import pytest

from portbench.harness import load_cell, load_reader

ROOT = pathlib.Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for word in MANIFEST["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word


def test_names_units_and_lines_use_the_allowed_characters():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metric_entries_keep_to_the_contract():
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in MANIFEST["end_to_end"])
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for cell in m["workloads"]:
            assert cell in CELLS
            assert m["moves"] in load_cell(ROOT, cell).end_to_end
        if m["unit"] == "%":
            assert m["name"].endswith("_roofline") or "_roofline." in m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    c = load_cell(ROOT, cell)
    assert c.config["name"] == next(w["config"] for w in MANIFEST["workloads"]
                                    if w["name"] == cell)
    assert c.traffic["loop"] == "closed"
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer
    for name in c.end_to_end + c.per_layer:
        assert callable(load_reader(c.bench_dir, name).read)


def test_every_configuration_is_used_and_lists_its_cuts():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg.get("reduced_from_source", {}))


def test_every_traffic_mix_is_used():
    used = {w["traffic"] for w in MANIFEST["workloads"]}
    assert {p.stem for p in (ROOT / "portbench" / "traffic").iterdir()} == used


def test_at_most_a_quarter_of_the_cells_ask_for_four_chips():
    four = sum(1 for w in MANIFEST["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(CELLS) // 4)
