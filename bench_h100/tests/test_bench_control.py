"""The control on the card: the program with its own int8 path on
(`quant_int8=True`), at each cell's own size, fails the cell's compared
number, and the program as configured passes it on the same seed. Needs
an NVIDIA card; run there with

    python -m pytest -q -m cuda bench_h100/tests/test_bench_control.py
"""
import json
import os
import subprocess
import sys

import pytest

from bench_h100.harness import loader

CELLS = {"sd15-moe.gen-b8": 1, "sd15-moe.serve-poisson": 8,
         "sdxl-moe.gen-b4": 1}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's size")


def _reading(cell: str, variant: str, seed: int) -> dict:
    out = subprocess.run(
        [sys.executable, "bench_h100/control.py", "--workload", cell,
         "--seconds", str(CELLS[cell]), "--variant", variant, "--seeds",
         str(seed)], cwd=loader.ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_int8_control_fails_and_the_program_passes(card, cell):
    seed = 2 ** 41 + 77
    for name, c in _reading(cell, "int8", seed).items():
        assert c["value"] > c["limit"], (name, c)
    for name, c in _reading(cell, "program", seed).items():
        assert c["value"] <= c["limit"], (name, c)
