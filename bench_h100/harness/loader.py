"""Finds a cell's parts by the names in `BENCHMARK.json`.

A cell `<config>.<traffic>` is an entry of `workloads`. Its configuration
is `configs/<config>.json` (the sizes as run) with `configs/<config>.py`
(how the program and the reference are built, and the counts from
shapes); its traffic mix is `traffic/<traffic>.json`, whose `kind` names
the generator `traffic/<kind>.py`; `workloads/<cell>.json` holds what the
cell's check compares; each metric is `metrics/<metric>.py`. Adding a
cell, a configuration, a mix or a metric is adding such files and entries.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import pathlib
import sys
from types import ModuleType

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_module(path: pathlib.Path) -> ModuleType:
    """Imports the Python file at `path` under a name of its own, made from
    its path (file names here may hold `-` and `.`)."""
    path = pathlib.Path(path).resolve()
    digest = hashlib.sha1(str(path).encode()).hexdigest()[:12]
    name = f"bench_h100._loaded.{path.stem.replace('.', '_').replace('-', '_')}_{digest}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: ModuleType          # metrics/<name>.py: read(run) -> value | None
    end_to_end: bool


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                 # the cell's entry in BENCHMARK.json
    config: dict                # configs/<config>.json
    family: ModuleType          # configs/<config>.py
    mix: dict                   # traffic/<traffic>.json
    kind: ModuleType            # traffic/<kind>.py
    check: dict                 # workloads/<cell>.json
    metrics: list               # Metric, end-to-end then per-layer


def manifest(root: pathlib.Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def metrics_for(man: dict, cell: str, bench: pathlib.Path = BENCH) -> list:
    """The cell's metrics: every entry whose `workloads` names the cell or
    that has no `workloads` key."""
    out = []
    for group, e2e in (("end_to_end", True), ("per_layer", False)):
        for m in man[group]:
            cells = m.get("workloads")
            if cells is not None and cell not in cells:
                continue
            reader = load_module(bench / "metrics" / f"{m['name']}.py")
            if getattr(reader, "UNIT", m["unit"]) != m["unit"]:
                raise ValueError(f"metric {m['name']}: unit {reader.UNIT!r} "
                                 f"in its reader, {m['unit']!r} in the manifest")
            out.append(Metric(m["name"], m["unit"], reader, e2e))
    return out


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = root / "bench_h100"
    man = manifest(root)
    entries = [w for w in man["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    conf = [c for c in man["configs"] if c["name"] == entry["config"]][0]
    config = read_json(root / conf["file"])
    family = load_module(bench / "configs" / f"{entry['config']}.py")
    mix = read_json(bench / "traffic" / f"{entry['traffic']}.json")
    kind = load_module(bench / "traffic" / f"{mix['kind']}.py")
    check = read_json(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if check.get(key, entry[key]) != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} {check[key]!r}, "
                             f"BENCHMARK.json: {entry[key]!r}")
    return Cell(name, entry, config, family, mix, kind, check,
                metrics_for(man, name, bench))
