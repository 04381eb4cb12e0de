"""Repository-wide pytest set-up, read before `tests/conftest.py`.

The native libraries of the JAX package (`native/libbalanced_assign.so`,
`native/libbpe_core.so`) are built by g++ in place on first use, under a
thread lock only. Under pytest-xdist every worker would build them at once
on a fresh checkout, and a worker that loads a half-written library skips
`tests/test_native_assign.py` ("g++ toolchain unavailable"). So the
controller (the process without `workerinput`, or the only process without
xdist) builds both once, before any worker starts. Their modules are loaded
from their files, so that the controller does not import the JAX package's
`__init__` (which loads JAX).
"""
import importlib.util
import os
import subprocess

ROOT = os.path.dirname(os.path.abspath(__file__))
NATIVE_LOADERS = ("diffusion_models_moe_tpu/moefication/native.py",
                  "diffusion_models_moe_tpu/data/_native_bpe.py")


def build_native_libraries() -> None:
    """Runs each loader's `_load` once: a build where the library is
    missing or older than its source. Where g++ is missing the tests that
    need the library decide for themselves."""
    for i, rel in enumerate(NATIVE_LOADERS):
        spec = importlib.util.spec_from_file_location(
            f"_native_prebuild_{i}", os.path.join(ROOT, rel))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        try:
            module._load()
        except (OSError, subprocess.CalledProcessError):
            pass


def pytest_configure(config):
    if not hasattr(config, "workerinput"):
        build_native_libraries()
