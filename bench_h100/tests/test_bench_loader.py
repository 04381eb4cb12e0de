"""Every cell, configuration, traffic mix and metric loads by name from its
own files; a cell added as new files alone is found, of a configuration of
another family too; a configuration module that lacks a name of the
interface is refused."""
import json
import shutil

import pytest

from bench_h100.harness import loader
from bench_h100.tests import pixart_family


def test_every_cell_loads_its_parts():
    man = loader.manifest()
    for w in man["workloads"]:
        cell = loader.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert all(hasattr(cell.family, n) for n in loader.FAMILY)
        assert hasattr(cell.kind, "Session")
        assert cell.check["limits"]
        names = {m.name for m in cell.metrics}
        assert "setup_s" in names and len(names) >= 3
        assert any(not m.end_to_end for m in cell.metrics)


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(group):
    for m in loader.manifest()[group]:
        reader = loader.load_module(loader.BENCH / "metrics" / f"{m['name']}.py")
        assert reader.UNIT == m["unit"] and callable(reader.read)


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(loader.BENCH, root / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(loader.MANIFEST, root / "BENCHMARK.json")
    return root


def _add_sd15_b2(root):
    """An SD1.5 cell of batch 2 with a per-layer metric of its own."""
    bench = root / "bench_h100"
    man = json.loads((root / "BENCHMARK.json").read_text())
    (bench / "traffic" / "gen-b2.json").write_text(json.dumps(
        {"kind": "closed_batch", "batch": 2, "steps": 50, "guidance": 7.5,
         "warmup_steps": 2}))
    (bench / "workloads" / "sd15-moe.gen-b2.json").write_text(json.dumps(
        {"config": "sd15-moe", "traffic": "gen-b2", "requests": 2,
         "limits": {"img_rel_l2": 0.1}}))
    (bench / "metrics" / "images.gen.py").write_text(
        'UNIT = "images"\n\n\ndef read(run):\n'
        '    return len(run.outcome.completed_in_window)\n')
    man["workloads"].append({"name": "sd15-moe.gen-b2", "config": "sd15-moe",
                             "traffic": "gen-b2", "chips": 1, "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] == "img_per_s":
            m["workloads"].append("sd15-moe.gen-b2")
    man["per_layer"].append({"name": "images.gen", "unit": "images",
                             "better": "higher", "source": "host_clock",
                             "layer": "device", "moves": "img_per_s",
                             "workloads": ["sd15-moe.gen-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return "sd15-moe.gen-b2"


@pytest.mark.parametrize("family", ["sd15", "pixart"])
def test_a_cell_added_as_files_alone_is_found(tmp_path, family):
    """An SD1.5 cell with a metric of its own; a cell of a configuration
    with no UNet (its JSON has no `unet` key) with its module, mix and
    check file."""
    root = _checkout(tmp_path)
    name = (_add_sd15_b2(root) if family == "sd15"
            else pixart_family.add_to_checkout(root))
    cell = loader.load_cell(name, root=root)
    assert cell.mix["batch"] == 2 and cell.kind.__file__.startswith(str(root))
    assert cell.family.__file__.startswith(str(root))
    names = {m.name for m in cell.metrics}
    assert {"img_per_s", "setup_s"} <= names
    if family == "sd15":
        assert "images.gen" in names
        assert cell.check["limits"] == {"img_rel_l2": 0.1}
    else:
        assert {"roofline.ff.gen", "roofline.attn.gen"} <= names
        assert "unet" not in cell.config
        assert cell.family.ff_widths(cell.config) == [128] * 3
        assert cell.family.latent_shape(cell.config) == (4, 8, 8)
        assert cell.check["limits"] == pixart_family.CHECK["limits"]


def test_a_module_missing_a_name_of_the_interface_is_refused(tmp_path):
    root = _checkout(tmp_path)
    module = root / "bench_h100" / "configs" / "sd15-moe.py"
    module.write_text(module.read_text().replace(
        "attn_work, ff_widths, ff_work,", "attn_work, ff_work,"))
    with pytest.raises(ValueError, match="ff_widths"):
        loader.load_cell("sd15-moe.gen-b8", root=root)


def test_a_check_file_that_names_another_cell_is_refused(tmp_path):
    root = _checkout(tmp_path)
    path = root / "bench_h100" / "workloads" / "sd15-moe.gen-b8.json"
    check = json.loads(path.read_text())
    path.write_text(json.dumps(dict(check, traffic="gen-b4")))
    with pytest.raises(ValueError):
        loader.load_cell("sd15-moe.gen-b8", root=root)
