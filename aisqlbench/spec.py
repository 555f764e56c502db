"""The benchmark's description, read from ``BENCHMARK.json`` at the root
of the checkout, and the data files it names.

Every cell, configuration, traffic mix and per-layer metric is found by
its name: a configuration in ``configs/<name>.json``, a traffic mix in
``traffic/<name>.json``, a cell's own parameters in
``workloads/<name>.json`` and a per-layer metric's reader in
``metrics/<name>.py``.  A configuration names its architecture
(``"arch"``), whose module ``archs/<arch>.py`` gives everything that is
the architecture's own: ``groups(model)``, its seeded leaves in drawing
order; ``Reference(model, seed, device, precision)`` with ``.run(rows,
positions)``, the plain reference; and ``step_flops(model, start, count,
logits)``, its useful operations.  Adding any of them is adding a file and
an entry in ``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str):
    """The Python file at ``path``, loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_arch(name: str, folder: Path = HERE):
    """The module ``archs/<name>.py`` of the benchmark's folder."""
    path = Path(folder) / "archs" / f"{name}.py"
    if not NAME_RE.match(name) or not path.is_file():
        raise KeyError(f"no architecture {name!r} in {path.parent}")
    return load_module(path, "aisqlbench_arch_")


class Bench:
    """``BENCHMARK.json`` and the files of the benchmark's folder."""

    def __init__(self, root: Path = ROOT, folder: Path = HERE):
        self.root = Path(root)
        self.folder = Path(folder)
        self.doc = load_json(self.root / "BENCHMARK.json")
        self.configs = {c["name"]: c for c in self.doc["configs"]}
        self.workloads = {w["name"]: w for w in self.doc["workloads"]}
        self.end_to_end = {m["name"]: m for m in self.doc["end_to_end"]}
        self.per_layer = {m["name"]: m for m in self.doc["per_layer"]}
        self._archs: Dict[str, Any] = {}

    # -- a cell and what it names ------------------------------------------
    def workload(self, name: str) -> Dict[str, Any]:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{sorted(self.workloads)}")
        return self.workloads[name]

    def config_file(self, config: str) -> Dict[str, Any]:
        return load_json(self.root / self.configs[config]["file"])

    def arch(self, config: str):
        """The architecture module that the configuration's file names."""
        name = self.config_file(config).get("arch")
        if name is None:
            raise KeyError(f"configuration {config!r} names no \"arch\"")
        if name not in self._archs:
            self._archs[name] = load_arch(name, self.folder)
        return self._archs[name]

    def traffic_file(self, traffic: str) -> Dict[str, Any]:
        return load_json(self.folder / "traffic" / f"{traffic}.json")

    def cell_file(self, workload: str) -> Dict[str, Any]:
        return load_json(self.folder / "workloads" / f"{workload}.json")

    def metrics_of(self, workload: str, kind: str) -> List[Dict[str, Any]]:
        """The end-to-end (``kind`` "end_to_end") or per-layer metrics
        this cell reports: those listing it, and those that list no cells
        and move an end-to-end metric the cell reports."""
        e2e = [m for m in self.doc["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.doc["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def reader(self, metric: str) -> Callable[[Any], Optional[float]]:
        """The ``read(run)`` function of ``metrics/<metric>.py``."""
        return load_module(self.folder / "metrics" / f"{metric}.py",
                           "aisqlbench_metric_").read


def problems(doc: Dict[str, Any]) -> List[str]:
    """What in a ``BENCHMARK.json`` breaks the naming rules: names, units,
    ``better``, and the cross references between its entries."""
    out = []
    metrics = doc["end_to_end"] + doc["per_layer"]
    entries = doc["configs"] + doc["workloads"] + metrics
    for e in entries:
        if not NAME_RE.match(e["name"]):
            out.append(f"bad name {e['name']!r}")
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in doc[kind]]
        if len(set(names)) != len(names):
            out.append(f"duplicate {kind} names")
    names = [m["name"] for m in metrics]
    if len(set(names)) != len(names):
        out.append("duplicate metric names")
    for m in metrics:
        if not UNIT_RE.match(m["unit"]):
            out.append(f"bad unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"bad 'better' of {m['name']}")
    configs = {c["name"] for c in doc["configs"]}
    cells = {w["name"] for w in doc["workloads"]}
    for w in doc["workloads"]:
        for key in ("config", "traffic"):
            if not NAME_RE.match(w[key]):
                out.append(f"bad {key} {w[key]!r} of {w['name']}")
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']!r}")
    for c in doc["configs"]:
        for k in c["reduced"]:
            if not NAME_RE.match(k):
                out.append(f"bad reduced key {k!r} of {c['name']}")
    e2e = {m["name"] for m in doc["end_to_end"]}
    for m in metrics:
        for w in m.get("workloads", ()):
            if w not in cells:
                out.append(f"{m['name']}: unknown workload {w!r}")
    for m in doc["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves unknown {m['moves']!r}")
    return out
