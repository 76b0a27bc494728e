"""Small cells for the CPU tests: a throwaway root beside the real one,
holding a copy of ``BENCHMARK.json`` and a cell and configuration cut to
a tiny rank and a few chains.  A cell that ``BENCHMARK.json`` does not
list is read from ``tests/cells/`` and gets an entry in the copy: the
hybrid's, whose MALA gradient and adaptive scales the reference keeps so
that the cell can come back as data alone."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from portbench.manifest import ROOT, Manifest


def tiny_root(tmp: Path, cell_name: str, rank: int, chains: int, pairs: int = 24,
              subdivisions: int | None = None) -> tuple[Manifest, dict]:
    """A root under ``tmp`` whose cell ``cell_name`` runs the real cell's
    setup at ``rank`` with ``chains`` chains; → (manifest, cell)."""
    real = Manifest(ROOT)
    path = ROOT / "portbench" / "workloads" / f"{cell_name}.json"
    if not path.is_file():
        path = Path(__file__).resolve().parent / "cells" / f"{cell_name}.json"
    cell = json.loads(path.read_text())
    config = copy.deepcopy(real.config(cell["config"]))
    old = int(config["rank"])
    config["rank"] = rank
    if config["model"]["builder"] == "femur-standin":
        config["model"]["nystrom_points"] = 2 * rank
    if subdivisions is not None:
        config["model"]["subdivisions"] = subdivisions
    for c in cell["mixture"]:
        if c["kind"] == "icp":
            c["n_points"] = c["n_points"] * rank // old
    cell["evaluator"]["n_points"] = cell["evaluator"]["n_points"] * rank // old
    cell["chains"] = chains
    cell["warmup_steps"] = 2
    cell["segment_steps"] = 3
    cell["check"].update(chains=min(chains, 4), pairs=pairs, batch=8)
    (tmp / "portbench" / "workloads").mkdir(parents=True, exist_ok=True)
    (tmp / "portbench" / "configs").mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "portbench" / "metrics", tmp / "portbench" / "metrics",
                    dirs_exist_ok=True)
    bench = copy.deepcopy(real.data)
    if not any(w["name"] == cell_name for w in bench["workloads"]):  # a cell file alone
        bench["workloads"].append({"name": cell_name, "config": cell["config"],
                                   "traffic": cell_name.split(".", 1)[1], "chips": 1,
                                   "why": cell["why"]})
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    entry["file"] = f"portbench/configs/{cell['config']}.json"
    (tmp / entry["file"]).write_text(json.dumps(config))
    (tmp / "portbench" / "workloads" / f"{cell_name}.json").write_text(json.dumps(cell))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    man = Manifest(tmp)
    return man, man.workload(cell_name)
