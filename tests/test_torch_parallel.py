"""The port's parallel layer (`parallel/{mesh,distributed}.py`) against the
JAX package's, on the CPU, in one process.

  * the mesh shape: `mesh_shape` / `create_mesh` against JAX's
    `create_mesh` on its 8 virtual CPU devices (tests/conftest.py), for
    n = 1-8 and every explicit dp or tp; `create_mesh_3d` likewise;
  * the layout: every parameter of a tiny SD pipeline (UNet, CLIP, VAE),
    T5 and Llama, filled with distinct values, is sharded by the port's plan
    for each (dp, tp) device and by JAX's `NamedSharding(...)
    .devices_indices_map`; the values each device holds agree (the port's
    (out, in) weight is JAX's (in, out) kernel transposed); the MoE
    patterns over `create_mesh_3d` likewise;
  * one process: `init_multihost` is a no-op, `create_mesh()` gives dp = tp
    = 1 and `generate(mesh=)` is bit-equal to `generate()`.

The runs over two processes are in `tests/test_torch_parallel_gloo.py`.
"""
import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.parallel import mesh as jmesh
from diffusion_models_moe_tpu_torch import config as pcfg
from diffusion_models_moe_tpu_torch.parallel import mesh as pmesh
from diffusion_models_moe_tpu_torch.weights import bridge


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    """(dp, tp) of the port's rule equals JAX's mesh shape for n devices,
    with neither axis given and with each explicit dp or tp that divides
    n; the 3-D mesh likewise."""
    cases = [{}] + [{"dp": d} for d in range(1, n + 1) if n % d == 0] + [
        {"tp": t} for t in range(1, n + 1) if n % t == 0]
    for kw in cases:
        want = jmesh.create_mesh(n, **kw).shape
        assert pmesh.mesh_shape(n, **kw) == (want["dp"], want["tp"]), kw
    want3 = jmesh.create_mesh_3d(n).shape
    assert pmesh.mesh_shape_3d(n) == (want3["dp"], want3["ep"], want3["tp"])
    with pytest.raises(ValueError):
        pmesh.mesh_shape(n, dp=n + 1, tp=1)


def _distinct(tree, start: int = 0):
    """The tree with every leaf replaced by float64 values start, start + 1,
    ... (distinct over the whole tree), and the next free value."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = []
    for leaf in leaves:
        n = int(np.prod(np.shape(leaf)))
        out.append(np.arange(start, start + n, dtype=np.float64).reshape(
            np.shape(leaf)))
        start += n
    return jax.tree_util.tree_unflatten(treedef, out), start


def _assert_same_layout(jax_params, jax_shardings, port_sd: dict, plan: dict,
                        total: int, mesh) -> None:
    """For each device of `mesh`: the values that JAX's shardings place on
    it, and those that the port's `plan` gives the rank at the same
    coordinates, agree tensor by tensor."""
    flat = jax.tree_util.tree_leaves(jax_params)
    shards = jax.tree_util.tree_leaves(
        jax_shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(flat) == len(shards)
    shape = dict(mesh.shape)
    assert set(plan) == set(port_sd)
    for pos in np.ndindex(*mesh.devices.shape):
        device = mesh.devices[pos]
        owned = np.zeros(total, bool)
        for leaf, sh in zip(flat, shards):
            idx = sh.devices_indices_map(leaf.shape)[device]
            owned[leaf[idx].astype(np.int64).ravel()] = True
        coords = dict(zip(mesh.axis_names, pos))
        for name, value in port_sd.items():
            value = np.asarray(value)
            ids = torch.arange(value.size).reshape(value.shape)
            mine = np.zeros(value.size, bool)
            mine[pmesh.local_shard(ids, plan[name], shape,
                                   coords).reshape(-1).numpy()] = True
            np.testing.assert_array_equal(
                mine, owned[value.astype(np.int64).ravel()],
                err_msg=f"{name} at {coords}")


@pytest.fixture(scope="module")
def sd_params():
    from diffusion_models_moe_tpu import StableDiffusionPipeline
    params = StableDiffusionPipeline(jcfg.tiny_config()).init_params(
        jax.random.PRNGKey(0))
    return _distinct(jax.device_get(params))


@pytest.mark.parametrize("tp", [2, 4])
def test_unet_clip_vae_layout_matches_jax(sd_params, tp):
    """The tiny SD pipeline's UNet, CLIP text encoder and VAE decoder: each
    device's values under the port's `param_shardings` equal those under
    JAX's `param_shardings` on the (8 // tp, tp) mesh."""
    params, total = sd_params
    cfg = pcfg.tiny_config()
    mesh = jmesh.create_mesh(8, tp=tp)
    sd = {}
    for key, fn, c in (("unet", bridge.unet_numpy_state_dict, cfg.unet),
                       ("text_encoder", bridge.clip_text_numpy_state_dict,
                        cfg.text_encoder),
                       ("vae", bridge.vae_decoder_numpy_state_dict, cfg.vae)):
        sd.update({f"{key}.{n}": v for n, v in fn(params[key], c).items()})
    plan = {}
    for key in ("unet", "text_encoder", "vae"):
        names = [n[len(key) + 1:] for n in sd if n.startswith(key + ".")]
        plan.update({f"{key}.{n}": s
                     for n, s in pmesh.param_shardings(names).items()})
    # what the rules shard: q/k/v, to_out, the FF's out projection, fc1/fc2
    sharded = {n for n, s in plan.items() if "tp" in s}
    assert sharded and all(n.startswith(("unet.", "text_encoder."))
                           for n in sharded)
    assert plan["unet.down_blocks.0.attentions.0.transformer_blocks.0.ff"
                ".net.0.proj.weight"] == (None, None)
    _assert_same_layout(params, jmesh.param_shardings(params, mesh), sd, plan,
                        total, mesh)


@pytest.mark.parametrize("tp", [2, 4])
def test_t5_layout_matches_jax(tp):
    """The tiny T5 encoder: the port's plan against JAX's rules."""
    import jax.numpy as jnp

    from diffusion_models_moe_tpu.models.t5 import T5Encoder as JaxT5
    from diffusion_models_moe_tpu.models.t5 import tiny_t5_config as jt5
    from diffusion_models_moe_tpu_torch.models.t5 import tiny_t5_config
    jc = jt5()
    ids = jnp.zeros((1, jc.max_length), jnp.int32)
    params, total = _distinct(jax.device_get(
        JaxT5(jc).init(jax.random.PRNGKey(0), ids)["params"]))
    sd = bridge.t5_numpy_state_dict(params, tiny_t5_config())
    mesh = jmesh.create_mesh(8, tp=tp)
    plan = pmesh.param_shardings(sd)
    assert {n.rsplit(".", 2)[-2] for n, s in plan.items() if "tp" in s} == {
        "q", "k", "v", "o", "wi_0", "wi_1", "wo"}
    _assert_same_layout(params, jmesh.param_shardings(params, mesh), sd, plan,
                        total, mesh)


@pytest.mark.parametrize("tp", [2, 4])
def test_llama_layout_matches_jax(tp):
    """A tiny Llama with q/k/v biases: `llama_param_shardings` against
    JAX's, the port's weights carried into JAX by its porter."""
    from diffusion_models_moe_tpu.models import llama as jllama
    from diffusion_models_moe_tpu.weights import port_llava as jport
    from diffusion_models_moe_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.tiny_llama_config(128),
                              attention_bias=True)
    jc = dataclasses.replace(jllama.tiny_llama_config(128),
                             attention_bias=True)
    names = llama.LlamaModel(cfg, device="cpu").state_dict()
    sd, total = _distinct({n: np.zeros(tuple(t.shape))
                           for n, t in names.items()})
    params = jport.port_llama(sd, jc)
    mesh = jmesh.create_mesh(8, tp=tp)
    plan = pmesh.llama_param_shardings(sd)
    assert plan["lm_head.weight"] == ("tp", None)
    assert plan["model.layers.0.self_attn.q_proj.bias"] == ("tp",)
    _assert_same_layout(params, jmesh.llama_param_shardings(params, mesh), sd,
                        plan, total, mesh)


def test_moe_patterns_layout_matches_jax():
    """MoE interventions over the 3-D mesh: each device's rows of each
    layer's (E, H) patterns, by the port's `moe_intervention_shardings` and
    by JAX's; every other field replicated."""
    from diffusion_models_moe_tpu.moefication.moefy import \
        build_moe_interventions as jbuild
    from diffusion_models_moe_tpu_torch import build_moe_interventions
    from diffusion_models_moe_tpu_torch.taps import layer_name
    rng = np.random.RandomState(0)
    dims = pcfg.tiny_config().unet.ff_dims()
    labels = {layer_name(i): rng.permutation(np.arange(4 * d) % (4 * d // 8))
              for i, d in enumerate(dims)}
    jivs = jbuild(labels, 0.3)
    pivs = build_moe_interventions(labels, 0.3, device="cpu")
    mesh = jmesh.create_mesh_3d(8)
    jsh = jmesh.moe_intervention_shardings(jivs, mesh)
    specs = pmesh.moe_intervention_shardings(pivs)
    shape = dict(mesh.shape)
    for layer, (jiv, piv, spec) in enumerate(zip(jivs, pivs, specs)):
        assert spec["patterns"] == ("ep", None)
        assert all(s == () for f, s in spec.items() if f != "patterns")
        pat = np.asarray(jiv.patterns)
        np.testing.assert_array_equal(piv.patterns.numpy(), pat)
        for pos in np.ndindex(*mesh.devices.shape):
            idx = jsh[layer].patterns.devices_indices_map(pat.shape)[
                mesh.devices[pos]]
            got = pmesh.local_shard(piv.patterns, spec["patterns"], shape,
                                    dict(zip(mesh.axis_names, pos)))
            np.testing.assert_array_equal(got.numpy(), pat[idx])


def test_batch_specs_and_slices():
    """`batch_sharding` is JAX's P("dp", None, ...); `batch_slice` takes
    the rank's rows and refuses a batch that dp does not divide."""
    assert pmesh.batch_sharding(4) == ("dp", None, None, None)
    assert pmesh.replicated() == ()
    assert tuple(jmesh.batch_sharding(jmesh.create_mesh(8), 4).spec) == \
        pmesh.batch_sharding(4)
    mesh = pmesh.Mesh({"dp": 4, "tp": 2}, {"dp": 2, "tp": 1}, {})
    assert pmesh.batch_slice(mesh, 8) == slice(4, 6)
    assert pmesh.coords_of(5, {"dp": 4, "tp": 2}) == {"dp": 2, "tp": 1}
    with pytest.raises(ValueError):
        pmesh.batch_slice(mesh, 6)


def test_init_multihost_single_process_noop():
    """One process: `init_multihost` joins no group and reports one
    process; `create_mesh()` is dp = tp = 1 with no group; a mesh of more
    devices than processes is refused (JAX
    tests/test_parallel_and_kernels.py::test_init_multihost_single_process_noop)."""
    import torch.distributed as dist

    from diffusion_models_moe_tpu_torch.parallel.distributed import (
        init_multihost, is_coordinator)
    info = init_multihost(device="cpu")
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 1, "global_devices": 1}
    assert not dist.is_initialized() and is_coordinator()
    mesh = pmesh.create_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1}
    assert mesh.group("dp") is None and mesh.group("tp") is None
    with pytest.raises(ValueError):
        pmesh.create_mesh(2)


def test_generate_world_size_one_mesh_bit_equal():
    """`generate(mesh=create_mesh())` in one process is `generate()` to the
    bit: the world-size-1 mesh splits nothing."""
    from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                                tiny_config)
    pipe = StableDiffusionPipeline(tiny_config(), device="cpu")
    pipe.init_params(torch.Generator().manual_seed(0))
    cond = torch.randint(0, 1000, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    kw = dict(num_steps=2)
    a, _ = pipe.generate(cond, torch.zeros_like(cond),
                         torch.Generator().manual_seed(2), **kw)
    b, _ = pipe.generate(cond, torch.zeros_like(cond),
                         torch.Generator().manual_seed(2),
                         mesh=pmesh.create_mesh(), **kw)
    assert torch.equal(a, b)


def test_dist_worker_imports_without_jax():
    """The rank functions' module, as a spawned child imports it, loads
    neither JAX nor the JAX package."""
    code = ("import sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_dist_worker\n"
            "import diffusion_models_moe_tpu_torch.serving\n"
            "import diffusion_models_moe_tpu_torch.benchmarks.runner\n"
            "import diffusion_models_moe_tpu_torch.training.trainer\n"
            "import diffusion_models_moe_tpu_torch.models.llava\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'diffusion_models_moe_tpu')]\n"
            "assert not bad, bad\n")
    root = __file__.rsplit("/tests/", 1)[0]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
