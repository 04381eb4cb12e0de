"""Skill attribution (analysis/) and concept erasure (erasure/) of the torch
port against the JAX package, on the CPU (tiny_config, f32).

Both packages run the same weights (tests/torch_parity.py), the same prompt
ids (the snapshot-less hash tokenizer of the JAX CLI and its port) and the
same initial noise: JAX's `generate` draws it from PRNGKey(seed), and the
port's `initial_noise` is handed the same array. Statistics agree within
REL_TOL; masks made from the same statistics, and baked weights, agree
exactly; masks made from each package's own statistics differ at most on a
small share of entries that sit on a decision boundary to rounding; erased
`denoise` runs agree within LATENT_REL_TOL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.analysis import collect as jcollect
from diffusion_models_moe_tpu.analysis import selectors as jsel
from diffusion_models_moe_tpu.analysis.sparsity import \
    measure_sparsity as jax_measure_sparsity
from diffusion_models_moe_tpu.cli import _hash_tokenize
from diffusion_models_moe_tpu.erasure import masks as jmasks
from diffusion_models_moe_tpu.moefication.moefy import \
    build_moe_interventions as jax_build_ivs
from diffusion_models_moe_tpu.moefication.moefy import \
    ff_param_paths as jax_ff_param_paths
from diffusion_models_moe_tpu.pipelines.stable_diffusion import \
    StableDiffusionPipeline as JaxPipeline
from diffusion_models_moe_tpu_torch import (StableDiffusionPipeline,
                                            build_moe_interventions,
                                            tiny_config)
from diffusion_models_moe_tpu_torch.analysis import collect, selectors
from diffusion_models_moe_tpu_torch.analysis.sparsity import measure_sparsity
from diffusion_models_moe_tpu_torch.data.tokenize import hash_tokenize
from diffusion_models_moe_tpu_torch.erasure import masks
from diffusion_models_moe_tpu_torch.moefication.moefy import (
    build_add_experts_boost, ff_param_paths, load_labels)
from diffusion_models_moe_tpu_torch.weights import bridge

REL_TOL = 2e-4
LATENT_REL_TOL = 1e-3
WANDA_FLIPS = 1e-4      # share of Wanda mask entries on the top-k cut
T_TEST_FLIPS = 1e-3     # share of t-test mask entries on the critical value
STEPS, SEED = 2, 0
BASE = ["a photo of a dog", "a photo of a house"]
ADJ = ["a dog in the style of Van Gogh", "a house in the style of Van Gogh"]


def _inject_jax_noise(port, seed: int) -> None:
    """Make the port's generate start from JAX's noise for PRNGKey(seed)."""
    s = port.config.sample_size

    def noise(batch, generator):
        z = jax.random.normal(jax.random.PRNGKey(seed), (batch, s, s, 4),
                              jnp.float32)
        return torch.from_numpy(np.array(z)).permute(0, 3, 1, 2)
    port.initial_noise = noise


@pytest.fixture(scope="module")
def setup():
    cfg = jcfg.tiny_config()
    params, port = torch_parity.pipelines(cfg)
    _inject_jax_noise(port, SEED)
    t = cfg.text_encoder
    return dict(cfg=cfg, jpipe=JaxPipeline(cfg), params=params, port=port,
                labels=torch_parity.labels(cfg.unet),
                jtok=_hash_tokenize(t.vocab_size, t.max_length),
                tok=hash_tokenize(t.vocab_size, t.max_length))


def test_hash_tokenize_matches_the_jax_cli(setup):
    for texts in (BASE, ADJ[:1], [""]):
        np.testing.assert_array_equal(setup["tok"](texts).numpy(),
                                      setup["jtok"](texts))


@pytest.fixture(scope="module")
def predictivity(setup):
    """collect_predictivity of both packages, plain and under MoE routing."""
    out = {}
    for routed in (False, True):
        jivs = jax_build_ivs(setup["labels"], 0.3) if routed else None
        ivs = (build_moe_interventions(setup["labels"], 0.3, device="cpu")
               if routed else None)
        out[routed] = (
            jcollect.collect_predictivity(
                setup["jpipe"], setup["params"], setup["jtok"], BASE, ADJ,
                seed=SEED, num_steps=STEPS, ivs=jivs),
            collect.collect_predictivity(
                setup["port"], setup["tok"], BASE, ADJ, seed=SEED,
                num_steps=STEPS, ivs=ivs))
    return out


@pytest.mark.parametrize("routed", [False, True])
def test_collect_predictivity_and_t_test_match_jax(predictivity, routed):
    ref, got = predictivity[routed]
    assert got.n_prompts == ref.n_prompts == len(BASE)
    for acc in ("base", "adj"):
        r, g = getattr(ref, acc).mean(), getattr(got, acc).mean()
        assert set(g) == set(r) == set(range(16))
        for l in r:
            assert g[l].shape == r[l].shape == (STEPS + 1, r[l].shape[1])
            assert torch_parity.rel_err(g[l], r[l]) < REL_TOL, (acc, l)
    r_std, g_std = ref.diff_std.std(), got.diff_std.std()
    for l in r_std:
        assert torch_parity.rel_err(g_std[l], r_std[l]) < REL_TOL, l
    # the t-test on the same statistics gives the same masks
    r_mask = jcollect.t_test_pipeline(ref, conf=0.3)
    for l, m in collect.t_test_pipeline(ref, conf=0.3).items():
        np.testing.assert_array_equal(m, r_mask[l], err_msg=str(l))
    # on each package's own statistics, which agree within REL_TOL, only
    # neurons whose t-value sits on the critical value to rounding may
    # differ (with 2 prompts, t = (d1 + d2) / |d1 - d2| of the paired
    # differences, so tiny differences make t rounding noise)
    g_mask = collect.t_test_pipeline(got, conf=0.3)
    assert sum(int(m.sum()) for m in g_mask.values()) > 0
    flips = sum(int((g_mask[l] != r_mask[l]).sum()) for l in r_mask)
    assert flips <= T_TEST_FLIPS * sum(m.size for m in r_mask.values())


def test_predictivity_save_writes_the_jax_artifacts(predictivity, tmp_path):
    ref, got = predictivity[False]
    ref.save(str(tmp_path / "jax"))
    got.save(str(tmp_path / "port"))
    for name in ("predictivity_base.json", "predictivity_adj.json",
                 "diff_std.npz"):
        assert (tmp_path / "port" / name).exists()
    with np.load(tmp_path / "jax" / "diff_std.npz") as r, \
            np.load(tmp_path / "port" / "diff_std.npz") as g:
        assert set(r.files) == set(g.files)
        for key in r.files:
            assert torch_parity.rel_err(g[key], r[key]) < REL_TOL


@pytest.fixture(scope="module")
def wanda(setup, tmp_path_factory):
    """wanda_pipeline of both packages; JAX's norms land in its cache."""
    cache = str(tmp_path_factory.mktemp("wanda_jax"))
    ref = jcollect.wanda_pipeline(setup["jpipe"], setup["params"],
                                  setup["jtok"], BASE, ADJ, skill_ratio=0.1,
                                  seed=SEED, num_steps=STEPS, cache_dir=cache)
    got = collect.wanda_pipeline(setup["port"], setup["tok"], BASE, ADJ,
                                 skill_ratio=0.1, seed=SEED, num_steps=STEPS)
    return dict(ref=ref, got=got, cache=cache)


def test_collect_wanda_norms_match_jax(setup, wanda):
    from diffusion_models_moe_tpu.analysis.stats import load_colnorms
    ref = load_colnorms(f"{wanda['cache']}/base_norms.npz")
    got = collect.collect_wanda_norms(setup["port"], setup["tok"], BASE,
                                      seed=SEED, num_steps=STEPS)
    assert set(got) == set(ref) == set(range(16))
    for l in ref:
        assert got[l].shape == ref[l].shape
        assert torch_parity.rel_err(got[l], ref[l]) < REL_TOL, l


def test_wanda_pipeline_masks_match_jax(setup, wanda):
    """From JAX's norms (its cache) the port's Wanda flow gives JAX's masks.
    From its own norms, which agree within REL_TOL, only entries whose
    metric ties the top-k cut to rounding may differ: at most WANDA_FLIPS
    of them."""
    ref, got = wanda["ref"], wanda["got"]
    cached = collect.wanda_pipeline(setup["port"], setup["tok"], [], [],
                                    skill_ratio=0.1, cache_dir=wanda["cache"])
    assert set(cached) == set(got) == set(ref) == set(range(16))
    flips = total = 0
    for l in ref:
        assert got[l].shape == cached[l].shape == ref[l].shape   # (T, D, H)
        np.testing.assert_array_equal(cached[l], ref[l], err_msg=str(l))
        flips += int((got[l] != ref[l]).sum())
        total += ref[l].size
    assert sum(int(m.sum()) for m in got.values()) > 0
    assert flips <= WANDA_FLIPS * total


def test_measure_sparsity_matches_jax(setup):
    """On the ReLUfied model, where the gate has exact zeros."""
    cfg = dataclasses.replace(setup["cfg"], unet=dataclasses.replace(
        setup["cfg"].unet, ff_activation="geglu-relu"))
    tcfg = tiny_config()
    port = StableDiffusionPipeline(dataclasses.replace(
        tcfg, unet=dataclasses.replace(tcfg.unet, ff_activation="geglu-relu")),
        device="cpu")
    port.load_state_dicts({k: m.state_dict()
                           for k, m in setup["port"].modules().items()})
    _inject_jax_noise(port, SEED)
    ref = jax_measure_sparsity(JaxPipeline(cfg), setup["params"],
                               setup["jtok"], BASE, seed=SEED,
                               num_steps=STEPS)
    got = measure_sparsity(port, setup["tok"], BASE, seed=SEED,
                           num_steps=STEPS)
    assert set(got) == set(ref) == set(range(16))
    for l in ref:
        assert got[l].shape == (STEPS + 1,)
        assert 0.2 < float(np.min(ref[l]))
        assert torch_parity.rel_err(got[l], ref[l]) < REL_TOL, l


def _merge(moe, removal, field_names):
    """Removal fields merged into the MoE routing interventions."""
    out = []
    for m, r in zip(moe, removal):
        if r is None:
            out.append(m)
        else:
            fields = {f: getattr(r, f) for f in field_names}
            out.append(m.replace(**fields) if hasattr(m, "replace")
                       else dataclasses.replace(m, **fields))
    return tuple(out)


def _denoise_both(setup, jivs, ivs) -> float:
    rng = np.random.RandomState(6)
    ucfg, s = setup["cfg"].unet, setup["cfg"].sample_size
    ctx = rng.randn(2, 16, ucfg.cross_attention_dim).astype(np.float32)
    lat = rng.randn(1, s, s, 4).astype(np.float32)
    jivs = jax.tree_util.tree_map(jnp.asarray, jivs)
    ref, _ = setup["jpipe"].denoise(setup["params"], jnp.asarray(ctx),
                                    jnp.asarray(lat), STEPS, 7.5, ivs=jivs)
    got, _ = setup["port"].denoise(torch.from_numpy(ctx),
                                   torch.from_numpy(lat).permute(0, 3, 1, 2),
                                   STEPS, 7.5, ivs=ivs)
    plain, _ = setup["port"].denoise(
        torch.from_numpy(ctx), torch.from_numpy(lat).permute(0, 3, 1, 2),
        STEPS, 7.5, ivs=build_moe_interventions(setup["labels"], 0.3,
                                              device="cpu"))
    assert torch_parity.rel_err(got, plain) > 1e-3      # the removal acts
    return torch_parity.rel_err(got.permute(0, 2, 3, 1).numpy(),
                                np.asarray(ref))


def test_neuron_removal_matches_jax(setup, predictivity):
    ref_pred, got_pred = predictivity[True]
    skilled = collect.t_test_pipeline(got_pred, conf=0.3)
    names = ("neuron_mask", "neuron_fill")
    jivs = _merge(jax_build_ivs(setup["labels"], 0.3),
                  jmasks.neuron_removal_interventions(skilled), names)
    ivs = _merge(build_moe_interventions(setup["labels"], 0.3, device="cpu"),
                 masks.neuron_removal_interventions(skilled, device="cpu"),
                 names)
    assert _denoise_both(setup, jivs, ivs) < LATENT_REL_TOL


def test_expert_removal_matches_jax(setup):
    """Static (E,) expert masks under a window of 1 step: (2, E) masks with
    an all-False last row, read by 3 UNet calls."""
    rng = np.random.RandomState(7)
    expert = {l: rng.rand(int(lab.max()) + 1) < 0.3
              for l, lab in enumerate(v for _, v in sorted(setup["labels"].items()))}
    jivs = jmasks.expert_removal_interventions(expert, setup["labels"], 0.3,
                                               max_timestep=1)
    ivs = masks.expert_removal_interventions(expert, setup["labels"], 0.3,
                                             max_timestep=1, device="cpu")
    assert all(iv.expert_remove.shape[0] == 2 for iv in ivs)
    assert _denoise_both(setup, jivs, ivs) < LATENT_REL_TOL


def test_wanda_removal_matches_jax(setup, wanda):
    names = ("out_weight_mask",)
    jivs = _merge(jax_build_ivs(setup["labels"], 0.3),
                  jmasks.wanda_removal_interventions(wanda["ref"]), names)
    ivs = _merge(build_moe_interventions(setup["labels"], 0.3, device="cpu"),
                 masks.wanda_removal_interventions(wanda["got"], device="cpu"),
                 names)
    assert _denoise_both(setup, jivs, ivs) < LATENT_REL_TOL


def _flat(unet_params, cfg) -> dict:
    return bridge.unet_numpy_state_dict(unet_params, cfg)


def test_bake_wanda_masks_equals_jax(setup, wanda):
    static = masks.union_over_timesteps(wanda["got"], 0.3)
    assert sum(int(m.sum()) for m in static.values()) > 0
    ref = _flat(jmasks.bake_wanda_masks(setup["params"]["unet"],
                                        setup["cfg"].unet, static),
                setup["port"].config.unet)
    state = setup["port"].unet.state_dict()
    got = masks.bake_wanda_masks(state, setup["port"].config.unet, static)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)
    # the input state dict is left as it was
    key = f"{ff_param_paths(setup['port'].config.unet)[0]}.net.2.weight"
    assert not torch.equal(got[key], state[key])


def test_bake_gate_masks_equals_jax(setup):
    rng = np.random.RandomState(8)
    gate = {l: rng.rand(4 * d) < 0.2
            for l, d in enumerate(setup["cfg"].unet.ff_dims())}
    ref = _flat(jmasks.bake_gate_masks(setup["params"]["unet"],
                                       setup["cfg"].unet, gate),
                setup["port"].config.unet)
    got = masks.bake_gate_masks(setup["port"].unet.state_dict(),
                                setup["port"].config.unet, gate)
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)


def test_ff_param_paths_name_the_jax_layers(setup):
    """Port prefix l holds JAX FF layer l's W2, through the bridge."""
    ucfg = setup["cfg"].unet
    state = setup["port"].unet.state_dict()
    jpaths = jax_ff_param_paths(ucfg)
    for path, jpath in zip(ff_param_paths(setup["port"].config.unet), jpaths,
                           strict=True):
        node = setup["params"]["unet"]
        for k in jpath:
            node = node[k]
        np.testing.assert_array_equal(state[f"{path}.net.2.weight"].numpy(),
                                      node["out_proj_kernel"].T)


def _random_masks(seed, shapes):
    rng = np.random.RandomState(seed)
    return {l: rng.rand(*s) < 0.3 for l, s in shapes.items()}


def test_mask_set_operations_match_jax(tmp_path):
    shapes = {0: (5, 8, 12), 3: (5, 4, 6), 7: (5, 16)}
    a, b = _random_masks(0, shapes), _random_masks(1, shapes)
    for ratio in (0.0, 0.4, 0.9):
        ref, got = (jmasks.union_over_timesteps(a, ratio),
                    masks.union_over_timesteps(a, ratio))
        for l in ref:
            np.testing.assert_array_equal(got[l], ref[l])
    assert masks.mask_iou(a, b) == jmasks.mask_iou(a, b)
    assert masks.mask_iou(a, a) == 1.0 and masks.mask_iou({}, {}) == 0.0
    ref, got = jmasks.union_masks([a, b]), masks.union_masks([a, b])
    for l in ref:
        np.testing.assert_array_equal(got[l], ref[l])
    masks.save_masks(str(tmp_path / "m.npz"), a)
    back = masks.load_masks(str(tmp_path / "m.npz"))
    assert set(back) == set(a)
    for l in a:
        np.testing.assert_array_equal(back[l], a[l])
    np.testing.assert_array_equal(jmasks.load_masks(str(tmp_path / "m.npz"))[3],
                                  a[3])


@pytest.mark.parametrize("max_timestep", [None, 1, 3])
@pytest.mark.parametrize("static", [False, True])
def test_removal_windows_match_jax(max_timestep, static):
    m = _random_masks(2, {0: (6,) if static else (4, 6)})
    assert_same = np.testing.assert_array_equal
    assert_same(masks._windowed(m[0], max_timestep),
                jmasks._windowed(m[0], max_timestep))
    ref = jmasks.neuron_removal_interventions(m, max_timestep=max_timestep)
    got = masks.neuron_removal_interventions(m, max_timestep=max_timestep,
                                             device="cpu")
    assert len(got) == len(ref) == 16
    assert_same(got[0].neuron_mask.numpy(), np.asarray(ref[0].neuron_mask))
    assert got[0].neuron_fill == ref[0].neuron_fill


def test_labels_and_boost_helpers_match_jax(tmp_path):
    from diffusion_models_moe_tpu.moefication.moefy import (
        build_add_experts_boost as jax_boost, load_labels as jax_load_labels)
    rng = np.random.RandomState(3)
    labels = {"ff_00": rng.permutation(np.arange(40) % 2)}
    np.savez(tmp_path / "labels.npz", **labels)
    assert load_labels(str(tmp_path / "labels.npz")).keys() == \
        jax_load_labels(str(tmp_path / "labels.npz")).keys()
    avg = rng.rand(3, 5).astype(np.float32)
    for skilled in (rng.rand(5) < 0.5, rng.rand(3, 5) < 0.5):
        np.testing.assert_array_equal(build_add_experts_boost(avg, skilled),
                                      jax_boost(avg, skilled))


def _selector_cases():
    rng = np.random.RandomState(9)
    t, h, e, p = 3, 40, 4, 5
    lab = rng.permutation(np.arange(h) % e)
    base, adj = rng.rand(t, h), rng.rand(t, h)
    return {
        "t_test_skilled": lambda m: m.t_test_skilled(base, adj,
                                                     rng.rand(t, h), 4, 0.2),
        "random_masks_like": lambda m: m.random_masks_like(base > 0.5, seed=1),
        "prediction_accuracy_skilled": lambda m: m.prediction_accuracy_skilled(
            rng.rand(p, t, h), rng.rand(p, t, h), rng.rand(p) < 0.5, 0.1),
        "wanda_skilled": lambda m: m.wanda_skilled(
            rng.rand(6, h), rng.rand(t, h), rng.rand(t, h), 0.2),
        "wanda_mask_to_flax": lambda m: m.wanda_mask_to_flax(rng.rand(t, 6, h) > 0.5),
        "greater_skilled_experts": lambda m: m.greater_skilled_experts(
            base, adj, 0.1 * rng.rand(t, h), lab, 0.3),
        "skilled_neurons_to_experts": lambda m: m.skilled_neurons_to_experts(
            adj > 0.5, lab, 0.4),
        "intersect_over_seeds": lambda m: m.intersect_over_seeds(
            [rng.rand(t, h) > 0.3 for _ in range(3)]),
        "moefy_compare_skilled_experts": lambda m: m.moefy_compare_skilled_experts(
            rng.randint(0, 2, (t, e)), rng.randint(0, 2, (t, e))),
        "moefy_compare_skilled_experts_per_prompt":
            lambda m: m.moefy_compare_skilled_experts_per_prompt(
                rng.rand(p, t, e) > 0.5, rng.rand(p, t, e) > 0.5, 0.3),
    }


@pytest.mark.parametrize("name", sorted(_selector_cases()))
def test_selectors_match_jax(name):
    """The copied selectors give the JAX package's results on the same
    random inputs (each side draws them from the same seed)."""
    got = _selector_cases()[name](selectors)
    ref = _selector_cases()[name](jsel)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_array_equal(g, r)
