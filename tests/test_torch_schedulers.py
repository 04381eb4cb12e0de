"""The torch port's schedulers against the JAX package's, on the CPU, with
no UNet.

Each scheduler runs a whole schedule in both packages from one numpy-seeded
initial sample and one eps a step (the model's output stands in as data):
timesteps exactly equal, every coefficient table equal to the bit (both
are f64 tables rounded to f32), every step's sample within 1e-6 relative
(max |diff| / max |ref|). DPM at 1, 2, 14, 15 and 50 steps takes both sides
of its `lower_order_final` cut; LCM gets JAX's own step noise, drawn here
from JAX's key sequence and handed in through `noise=` (noise never crosses
frameworks otherwise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from diffusion_models_moe_tpu.schedulers import common as jcommon
from diffusion_models_moe_tpu.schedulers.ddim import DDIMScheduler as JDDIM
from diffusion_models_moe_tpu.schedulers.dpm import \
    DPMSolverScheduler as JDPM
from diffusion_models_moe_tpu.schedulers.euler import \
    EulerDiscreteScheduler as JEuler
from diffusion_models_moe_tpu.schedulers.lcm import LCMScheduler as JLCM
from diffusion_models_moe_tpu.schedulers.pndm import PNDMScheduler as JPNDM
from diffusion_models_moe_tpu_torch.schedulers import common
from diffusion_models_moe_tpu_torch.schedulers.ddim import DDIMScheduler
from diffusion_models_moe_tpu_torch.schedulers.dpm import DPMSolverScheduler
from diffusion_models_moe_tpu_torch.schedulers.euler import \
    EulerDiscreteScheduler
from diffusion_models_moe_tpu_torch.schedulers.lcm import LCMScheduler
from diffusion_models_moe_tpu_torch.schedulers.pndm import PNDMScheduler

REL_TOL = 1e-6
SHAPE = (2, 4, 8, 8)
PAIRS = {"ddim": (DDIMScheduler, JDDIM), "pndm": (PNDMScheduler, JPNDM),
         "euler": (EulerDiscreteScheduler, JEuler),
         "dpm": (DPMSolverScheduler, JDPM), "lcm": (LCMScheduler, JLCM)}
CASES = ([("ddim", n) for n in (1, 3, 50)] + [("pndm", n) for n in (2, 5, 50)]
         + [("euler", n) for n in (1, 3, 50)]
         + [("dpm", n) for n in (1, 2, 14, 15, 50)]
         + [("lcm", n) for n in (1, 2, 4, 8)])


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _data(n_steps: int, seed: int = 0):
    """The initial sample and one eps a model call (PNDM makes one more)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(*SHAPE).astype(np.float32),
            rng.randn(n_steps + 1, *SHAPE).astype(np.float32))


def _run(name: str, n_steps: int):
    """Both packages over one schedule: (port timesteps, JAX timesteps, port
    coefficients, JAX coefficients, port samples, JAX samples, scaled model
    inputs of each)."""
    port_cls, jax_cls = PAIRS[name]
    port, ref = port_cls.create(), jax_cls.create()
    p_ts, p_c = port.set_timesteps(n_steps)
    j_ts, j_c, j_state = ref.set_timesteps(n_steps)
    sample, eps = _data(n_steps)
    key = jax.random.PRNGKey(7)
    if name == "lcm":
        j_state = ref.init_state(SHAPE, key=key)
        noise = torch_parity.jax_lcm_noise(key, SHAPE, len(p_ts))
        p_state = port.init_state()
    else:
        if j_state is None:
            j_state = ref.init_state(SHAPE)
        p_state = port.init_state()
    x_p, x_j = torch.from_numpy(sample), jnp.asarray(sample)
    outs_p, outs_j, ins_p, ins_j = [], [], [], []
    for i in range(len(p_ts)):
        ins_p.append(port.scale_model_input(p_c, i, x_p).numpy())
        ins_j.append(np.asarray(ref.scale_model_input(j_c, i, x_j)))
        e = eps[i]
        if name == "lcm":
            p_state, x_p = port.step(p_state, p_c, torch.from_numpy(e), i, x_p,
                                     noise=torch.from_numpy(noise[i]))
        else:
            p_state, x_p = port.step(p_state, p_c, torch.from_numpy(e), i, x_p)
        j_state, x_j = ref.step(j_state, j_c, jnp.asarray(e), i, x_j)
        outs_p.append(x_p.numpy())
        outs_j.append(np.asarray(x_j))
    return p_ts, np.asarray(j_ts), p_c, j_c, outs_p, outs_j, ins_p, ins_j


@pytest.mark.parametrize("name,n_steps", CASES)
def test_schedule_matches_jax(name, n_steps):
    p_ts, j_ts, p_c, j_c, outs_p, outs_j, ins_p, ins_j = _run(name, n_steps)
    np.testing.assert_array_equal(p_ts, j_ts)
    assert p_c.keys() == j_c.keys()
    for k in p_c:
        np.testing.assert_array_equal(np.asarray(p_c[k]), np.asarray(j_c[k]),
                                      err_msg=k)
        if np.asarray(p_c[k]).dtype != bool:
            assert np.asarray(p_c[k]).dtype == np.float32, k
    assert all(np.isfinite(o).all() for o in outs_p)
    for i, (a, b) in enumerate(zip(ins_p, ins_j)):
        assert _rel(a, b) <= REL_TOL, f"{name} scaled input {i}"
    for i, (a, b) in enumerate(zip(outs_p, outs_j)):
        assert _rel(a, b) <= REL_TOL, f"{name} step {i}: {_rel(a, b)}"


@pytest.mark.parametrize("schedule", ["scaled_linear", "linear"])
def test_noise_tables_and_timesteps_match_jax(schedule):
    np.testing.assert_array_equal(common.make_betas(beta_schedule=schedule),
                                  jcommon.make_betas(beta_schedule=schedule))
    np.testing.assert_array_equal(
        common.NoiseTables.create(beta_schedule=schedule).alphas_cumprod,
        jcommon.NoiseTables.create(beta_schedule=schedule).alphas_cumprod)
    for n in (1, 4, 20, 50, 1000):
        np.testing.assert_array_equal(common.spaced_timesteps(1000, n),
                                      jcommon.spaced_timesteps(1000, n))
    with pytest.raises(ValueError):
        common.make_betas(beta_schedule="cosine")


def test_pndm_keeps_its_numbers_on_the_shared_timesteps():
    """PNDM's table from `spaced_timesteps`: T = steps + 1 entries, the
    second-highest timestep twice, and an identity `scale_model_input`."""
    ts, _ = PNDMScheduler.create().set_timesteps(50)
    base = common.spaced_timesteps(1000, 50)
    assert len(ts) == 51 and ts[1] == ts[2] == base[1] and ts[0] == base[0]
    np.testing.assert_array_equal(ts[2:], base[1:])
    x = torch.randn(SHAPE)
    assert PNDMScheduler.create().scale_model_input({}, 3, x) is x


@pytest.mark.parametrize("n_steps", [1, 4, 50, 100])
def test_euler_initial_sigma_matches_jax(n_steps):
    """`init_noise_sigma_for` (the scale a pipeline applies) and the
    training-table `init_noise_sigma` equal JAX's; at 50 steps about 13.2
    against about 14.6."""
    port, ref = EulerDiscreteScheduler.create(), JEuler.create()
    assert port.init_noise_sigma_for(n_steps) == ref.init_noise_sigma_for(
        n_steps)
    assert port.init_noise_sigma == ref.init_noise_sigma
    if n_steps == 50:
        assert 13.0 < port.init_noise_sigma_for(50) < 13.4
        assert 14.4 < port.init_noise_sigma < 14.8


def test_dpm_lower_order_final_only_below_15_steps():
    for n in (1, 2, 14, 15, 50):
        _, c = DPMSolverScheduler.create().set_timesteps(n)
        assert c["first_order"][-1] == (n < 15)
        assert c["first_order"][:-1].sum() == 0 and c["r"][0] == 1.0


def test_lcm_timesteps_are_strided_origin_steps():
    ts, c = LCMScheduler.create().set_timesteps(4)
    np.testing.assert_array_equal(ts, [999, 759, 519, 279])
    assert ts.dtype == np.int32
    assert c["is_last"].tolist() == [0, 0, 0, 1]
    assert c["sqrt_a_prev"][-1] == 1.0 and c["sqrt_1m_a_prev"][-1] == 0.0


def test_lcm_noise_does_not_depend_on_the_batch():
    """The port's own step noise: sample 0 of a batch of 1 equals sample 0
    of a batch of 3 when its generator is seeded alike; the other samples'
    generators change it not."""
    sched = LCMScheduler.create()
    _, c = sched.set_timesteps(4)
    sample, eps = _data(4)
    x1, x3 = torch.from_numpy(sample[:1]), torch.from_numpy(
        np.concatenate([sample[:1]] * 3))
    s1 = sched.init_state([torch.Generator().manual_seed(5)])
    s3 = sched.init_state([torch.Generator().manual_seed(sd)
                           for sd in (5, 6, 7)])
    for i in range(4):
        e = torch.from_numpy(eps[i][:1])
        s1, x1 = sched.step(s1, c, e, i, x1)
        s3, x3 = sched.step(s3, c, torch.cat([e] * 3), i, x3)
        torch.testing.assert_close(x1[0], x3[0], rtol=0, atol=0)
        if i < 3:
            assert (x3[1] - x3[0]).abs().max() > 1e-3
    with pytest.raises(ValueError, match="generators"):
        sched.step(sched.init_state(), c, e, 0, x1)
