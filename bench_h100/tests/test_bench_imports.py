"""What a run imports: nothing of JAX or the JAX package anywhere under
`bench_h100/`, and nothing of the port in the reference; compared by whole
top-level names (the part before the first dot)."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

from bench_h100.harness import loader

JAX = {"jax", "jaxlib", "flax", "diffusion_models_moe_tpu"}
PORT = "diffusion_models_moe_tpu_torch"


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub: str = ""):
    return sorted((loader.BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not (_imports(path) & JAX)


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    names = _imports(path)
    assert PORT not in names and not names & JAX
    assert "bench_h100" not in names


def test_a_tiny_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, '.');"
            "from bench_h100.tests.tiny import tiny_cell;"
            "from bench_h100.harness.cell import run_cell;"
            "run_cell(tiny_cell('gen-b8', {'batch': 2, 'steps': 2}), 3, 0.2,"
            " False, 'cpu');"
            "import importlib.util, pathlib;"
            "spec = importlib.util.spec_from_file_location('r', 'bench_h100/run.py');"
            "r = importlib.util.module_from_spec(spec); spec.loader.exec_module(r);"
            "print('FORBIDDEN', r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=loader.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", "sd15-moe.gen-b8",
         "--seed", str(2 ** 40), "--seconds", "1", "--trace", "0"],
        cwd=loader.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
