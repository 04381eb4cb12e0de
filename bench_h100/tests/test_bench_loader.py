"""Every cell, configuration, traffic mix and metric loads by name from its
own files, and a cell added as new files alone is found."""
import json
import shutil

import pytest

from bench_h100.harness import loader


def test_every_cell_loads_its_parts():
    man = loader.manifest()
    for w in man["workloads"]:
        cell = loader.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.family.PORT_PRESET
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


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(loader.BENCH, root / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    man = loader.manifest()
    bench = root / "bench_h100"
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
    cell = loader.load_cell("sd15-moe.gen-b2", root=root)
    assert cell.mix["batch"] == 2 and cell.kind.__file__.startswith(str(root))
    assert "images.gen" in {m.name for m in cell.metrics}
    assert "img_per_s" in {m.name for m in cell.metrics}
    assert cell.check["limits"] == {"img_rel_l2": 0.1}


def test_a_check_file_that_names_another_cell_is_refused(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(loader.BENCH, root / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(loader.MANIFEST, root / "BENCHMARK.json")
    path = root / "bench_h100" / "workloads" / "sd15-moe.gen-b8.json"
    check = json.loads(path.read_text())
    path.write_text(json.dumps(dict(check, traffic="gen-b4")))
    with pytest.raises(ValueError):
        loader.load_cell("sd15-moe.gen-b8", root=root)
