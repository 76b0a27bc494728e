"""Find a cell's files by the names in ``BENCHMARK.json``.

    <root>/BENCHMARK.json                 the manifest
    <root>/portbench/workloads/<cell>.json the cell: configuration, setup,
                                          chains, check sizes and limits
    <root>/<config file>                  the configuration (``file`` in the
                                          manifest's ``configs`` entry)
    <root>/portbench/metrics/<metric>.py   one reader per per-layer metric

A new cell, configuration or metric is a new file; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        """The manifest's entry of cell ``name`` merged with its cell file."""
        entry = next((w for w in self.data["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        cell = json.loads((self.root / "portbench" / "workloads" / f"{name}.json")
                          .read_text())
        if cell.get("config") != entry["config"]:
            raise ValueError(f"{name}: cell file names config {cell.get('config')!r}, "
                             f"the manifest {entry['config']!r}")
        return {**cell, **entry}

    def config(self, name: str) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def metrics_for(self, cell: str, kind: str) -> list[dict]:
        """``end_to_end`` or ``per_layer`` metrics that cell ``cell`` reports."""
        out = []
        for m in self.data[kind]:
            if "workloads" not in m or cell in m["workloads"]:
                out.append(m)
        return out

    def reader(self, metric: str):
        """The ``read(view)`` function of a per-layer metric's file."""
        path = self.root / "portbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
