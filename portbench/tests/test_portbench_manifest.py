"""The manifest against the contract's names, and every file found by
name; a new cell, configuration and metric added as files alone."""
import json
import math
import shutil

import pytest

from portbench.manifest import NAME, ROOT, UNIT, Manifest

MAN = Manifest(ROOT)
DATA = MAN.data


def test_top_level_keys():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["paths"] == ["portbench"]
    assert DATA["command"] == ["python3", "portbench/run.py"]
    assert 1 <= DATA["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in DATA[kind]]
    assert len(names) == len(set(names))
    for e in DATA[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_entry_keys():
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["moves"] == "samples_per_s"
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    assert {m["name"] for m in DATA["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("cell", [w["name"] for w in DATA["workloads"]])
def test_every_cell_file_found(cell):
    merged = MAN.workload(cell)
    config = MAN.config(merged["config"])
    assert int(config["rank"]) > 0
    assert MAN.metrics_for(cell, "end_to_end")
    for m in MAN.metrics_for(cell, "per_layer"):
        assert callable(MAN.reader(m["name"]))
    ref = (ROOT / "portbench" / "reference" / "sampler.py")
    assert ref.is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in DATA["workloads"]])
def test_every_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"] for m in MAN.metrics_for(cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = MAN.metrics_for(cell, "per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_metric_workloads_name_cells():
    cells = {w["name"] for w in DATA["workloads"]}
    for m in DATA["per_layer"] + DATA["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_run_seconds_fit_a_full_check():
    """2 + 14 runs a cell, each run_seconds + 60 s, 2 × 90 s a cell to
    compile and 1,200 s spare, for the full 24 cells."""
    cells = 24
    total = (2 + 14 * cells) * (DATA["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


def test_new_cell_config_and_metric_are_files_alone(tmp_path):
    """A throwaway cell, configuration and metric in a copy of the root,
    each a new file, found by the names in BENCHMARK.json."""
    root = tmp_path / "root"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "data"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "portbench/configs/femur-gpmm100.json").read_text())
    config["name"] = "femur-gpmm50"
    config["rank"] = 51
    (root / "portbench/configs/femur-gpmm50.json").write_text(json.dumps(config))
    cell = json.loads((ROOT / "portbench/workloads/femur100.rw.c16384.json").read_text())
    cell["config"] = "femur-gpmm50"
    (root / "portbench/workloads/femur50.rw.c4096.json").write_text(json.dumps(cell))
    (root / "portbench/metrics/steps_traced.py").write_text(
        "def read(view):\n    return float(view.steps)\n")
    data["configs"].append({"name": "femur-gpmm50", "source": "https://example.org/x",
                            "file": "portbench/configs/femur-gpmm50.json",
                            "reduced": [], "why": "a throwaway"})
    data["workloads"].append({"name": "femur50.rw.c4096", "config": "femur-gpmm50",
                              "traffic": "rw.c4096", "chips": 1, "why": "a throwaway"})
    data["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "samples_per_s", "workloads": ["femur50.rw.c4096"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    man = Manifest(root)
    assert man.workload("femur50.rw.c4096")["config"] == "femur-gpmm50"
    assert man.config("femur-gpmm50")["rank"] == 51
    names = [m["name"] for m in man.metrics_for("femur50.rw.c4096", "per_layer")]
    assert "steps_traced" in names and "factor_roofline" not in names

    class View:
        steps = 7
    assert man.reader("steps_traced")(View()) == 7.0
    assert math.isclose(man.reader("host_ms_per_step")(
        type("V", (), {"host_s_per_step": 0.002})()), 2.0)
