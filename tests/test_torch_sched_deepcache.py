"""DeepCache at interval 2 under DDIM, Euler, DPM-Solver++ 2M and LCM: the
torch port's `denoise` against the JAX pipeline's, on the CPU, as the cases
of tests/test_torch_sched_pipeline.py (PNDM's: tests/test_torch_deepcache.py):
f32 `tiny_config`, MoE on all 16 FFs, CFG 7.5, 3 steps, within 1e-3. The
branch is on the index over each scheduler's table; under LCM the shallow
forward takes the guidance embedding too. A file of its own so that the test
workers share out the JAX compiles (about 10 s each on one CPU).
"""
import pytest

import torch_parity
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

REL_TOL = 1e-3
STEPS, GUIDANCE = 3, 7.5
LCM_UNET = {"time_cond_proj_dim": 32}


@pytest.fixture(scope="module")
def data():
    return torch_parity.scheduler_data(LCM_UNET)


@pytest.mark.parametrize("scheduler", ["ddim", "euler", "dpm", "lcm"])
def test_denoise_with_deep_cache_matches_jax(data, scheduler):
    torch_parity.check_denoise(data, scheduler, 2, LCM_UNET, STEPS, GUIDANCE,
                               REL_TOL)
