"""Find what belongs to a cell by name.

``BENCHMARK.json`` (at the repository root) lists the cells and metrics.
Everything else is a file of its own, found by name under ``bench/``:

* a cell ``<config>.<traffic>``: ``workloads/<cell>.json`` (its pipeline
  kind, backend, workers, the traffic's parameters and the limits of its
  check);
* a configuration: ``configs/<config>.json``;
* a pipeline kind: ``pipelines/<kind>.py`` (drives the port's entry
  point) and ``reference/<kind>.py`` (the plain reference, its control
  and the comparison that decides ``correct``);
* a metric: ``metrics/<metric>.py``, whose ``read(run)`` returns the
  value or ``None`` where it finds nothing to read.

Adding a cell, a configuration, a kind or a metric adds files; no file
here changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    workload: dict       # workloads/<cell>.json
    config: dict         # configs/<config>.json
    root: pathlib.Path   # the checkout's root

    @property
    def kind(self) -> str:
        return self.workload["kind"]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_benchmark(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Optional[pathlib.Path] = None,
              bench: Optional[pathlib.Path] = None) -> Cell:
    """The cell called ``name``; raises ``KeyError`` if BENCHMARK.json
    does not list it."""
    bench = bench or BENCH
    root = root or bench.parent
    spec = load_benchmark(root)
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(entries)})")
    entry = entries[name]
    workload = json.loads((bench / "workloads" / f"{name}.json").read_text())
    config = json.loads((bench / "configs" / f"{entry['config']}.json").read_text())
    return Cell(name, entry, workload, config, root)


def metrics_for(spec: dict, cell: str, group: str) -> List[dict]:
    """The metrics of ``group`` ("end_to_end" or "per_layer") that the
    cell reports: those without a ``workloads`` key, and those listing it."""
    return [m for m in spec[group] if "workloads" not in m or cell in m["workloads"]]


_loaded: Dict[str, ModuleType] = {}


def module(kind: str, name: str, bench: Optional[pathlib.Path] = None) -> ModuleType:
    """``bench/<kind>/<name>.py``, loaded by path (a name may hold dots)."""
    path = (bench or BENCH) / kind / f"{name}.py"
    key = str(path)
    if key not in _loaded:
        mod_name = f"bench_{kind}_{name}".replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        _loaded[key] = mod
    return _loaded[key]
