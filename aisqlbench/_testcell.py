"""A throwaway copy of the benchmark for the CPU tests: the data files of
``aisqlbench/`` and ``BENCHMARK.json`` copied into a temporary directory,
then cells, configurations and architectures added to it the way a later
change adds one, by new files and new entries only.  Runs there take the
configurations' smoke models."""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict

from aisqlbench import spec

TINY_MIXES = {
    "tiny-filter": {
        "loop": "closed", "tenants": 2, "workers": 2, "operator": "filter",
        "prompt": "Does this document report a product defect? {0}",
        "rows_per_query": [4],
        "body_bytes": {"median": 40, "sigma": 0.5, "lo": 16, "hi": 96},
        "pool_rows_per_s": 400},
}


def copy_bench(tmp: Path) -> Path:
    """The benchmark's data files and ``BENCHMARK.json`` under ``tmp``;
    returns the copy's folder."""
    folder = tmp / "aisqlbench"
    for sub in ("configs", "archs", "traffic", "workloads", "metrics"):
        shutil.copytree(spec.HERE / sub, folder / sub)
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return folder


def add_arch(tmp: Path, name: str, source: str) -> None:
    """Add the architecture ``name`` with the module text ``source``."""
    (tmp / "aisqlbench" / "archs" / f"{name}.py").write_text(source)


def add_config(tmp: Path, conf: Dict[str, Any]) -> None:
    """Add a configuration file (its entry comes with its first cell)."""
    (tmp / "aisqlbench" / "configs" / f"{conf['name']}.json").write_text(
        json.dumps(conf, indent=1))


def add_cell(tmp: Path, config: str, mix: str, *, limits=None,
             check_rows: int = 4) -> str:
    """Add a cell of ``config`` under the tiny mix ``mix``: a traffic file,
    a cell file and entries in ``BENCHMARK.json`` (the configuration's too,
    where it has none).  Returns its name."""
    folder = tmp / "aisqlbench"
    (folder / "traffic" / f"{mix}.json").write_text(
        json.dumps(TINY_MIXES[mix]))
    name = f"{config}.{mix}"
    cell = {"check_rows": check_rows, "limits": limits or {}}
    (folder / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    doc = json.loads((tmp / "BENCHMARK.json").read_text())
    if config not in {c["name"] for c in doc["configs"]}:
        conf = json.loads((folder / "configs" / f"{config}.json").read_text())
        doc["configs"].append({
            "name": config, "source": conf["source"],
            "file": f"aisqlbench/configs/{config}.json", "reduced": [],
            "why": "a CPU test's configuration"})
    doc["workloads"].append({"name": name, "config": config, "traffic": mix,
                             "chips": 1, "why": "a CPU test's cell"})
    for m in doc["end_to_end"]:
        if m["name"] == "rows_per_s":
            m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return name


def bench(tmp: Path) -> spec.Bench:
    return spec.Bench(root=tmp, folder=tmp / "aisqlbench")
