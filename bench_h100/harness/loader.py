"""Finds a cell's parts by the names in `BENCHMARK.json`.

A cell `<config>.<traffic>` is an entry of `workloads`. Its configuration
is `configs/<config>.json` (the sizes as run) with `configs/<config>.py`,
the configuration's module; its traffic mix is `traffic/<traffic>.json`,
whose `kind` names the generator `traffic/<kind>.py`;
`workloads/<cell>.json` holds what the cell's check compares; each metric
is `metrics/<metric>.py`. Adding a cell, a configuration, a mix or a metric
is adding such files and entries.

Everything the harness knows of a model comes from the configuration's
module, which has these names (`FAMILY`; `harness/sd_family.py` has the
Stable Diffusion family's):

- `build(cfg, state_dicts, labels, device, modes=None)`: the program, with
  `generate(cond_ids, uncond_ids, seeds, steps, guidance)` -> images (B, 3,
  H, W) in [0, 1]; `denoiser`, the module whose `*.ff` and `*.attn1` calls
  the tracer wraps; for serving traffic `engine(tokenize, **kw)`. `modes`:
  a control's keywords, or None.
- `reference(cfg, device)`: the plain reference, with `load(state_dicts)`,
  `set_routing(labels, topk_ratio)` and `generate(cond_ids, uncond_ids,
  noise, steps, guidance, bf16=False)`.
- `skeleton(cfg)` -> {group: nn.Module}: the parameters the weights are
  made for (the meta device will do).
- `NORMS`: the module classes whose parameters draw as norms.
- `ff_widths(cfg)` -> [H]: the hidden width of each routed FF, in execution
  order; the expert labels are drawn for them.
- `latent_shape(cfg)` -> (C, s, s): one request's initial noise.
- `ff_work(cfg, shape)`, `attn_work(cfg, shape)` -> (operations, bytes) of
  one `*.ff` or `*.attn1` call on an input of `shape`.
- `generate_flops(cfg, images, steps, guidance)`: a generate's operations.
- `CONTROLS`: {name: modes}, the lower-precision controls of
  `control.py --variant`.

`load_cell` refuses a module that lacks one of them.
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
FAMILY = ("build", "reference", "skeleton", "NORMS", "ff_widths",
          "latent_shape", "ff_work", "attn_work", "generate_flops", "CONTROLS")


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


def check_family(family, where: str) -> None:
    """Raises, naming them, where a configuration's module lacks names of
    the interface (`FAMILY`)."""
    missing = [n for n in FAMILY if not hasattr(family, n)]
    if missing:
        raise ValueError(f"{where} lacks {', '.join(missing)} of the "
                         "configuration-module interface (harness/loader.py)")


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
    check_family(family, f"configs/{entry['config']}.py")
    mix = read_json(bench / "traffic" / f"{entry['traffic']}.json")
    kind = load_module(bench / "traffic" / f"{mix['kind']}.py")
    check = read_json(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if check.get(key, entry[key]) != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} {check[key]!r}, "
                             f"BENCHMARK.json: {entry[key]!r}")
    return Cell(name, entry, config, family, mix, kind, check,
                metrics_for(man, name, bench))
