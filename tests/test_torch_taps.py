"""Taps and interventions of the torch port against the JAX pipeline, on the
CPU (tiny_config, f32, weights through `weights/bridge.py`).

- Per-step interventions are read with the step clamped to their last row,
  as JAX's traced indexing does: a (1, E) removal mask and a windowed
  (max_timestep + 1, E) one give JAX's latents.
- `generate` with every tap on, under each intervention, gives JAX's stacked
  (T, ...) statistics: within REL_TOL, the expert selections exactly. The
  initial noise is JAX's, handed to the port (noise never crosses
  frameworks through an RNG).
- CLIP MLP taps and text interventions match `encode_text`.
- The FF layer picks the fused FF kernel, the routing kernel or the torch
  routing exactly where the JAX module's conditions do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from diffusion_models_moe_tpu import config as jcfg
from diffusion_models_moe_tpu.moefication.moefy import \
    build_moe_interventions as jax_build_ivs
from diffusion_models_moe_tpu.pipelines.stable_diffusion import \
    StableDiffusionPipeline as JaxPipeline
from diffusion_models_moe_tpu.taps import LayerIntervention as JaxIV
from diffusion_models_moe_tpu.taps import TapSpec as JaxTapSpec
from diffusion_models_moe_tpu_torch import (LayerIntervention, TapSpec,
                                            build_moe_interventions)
from diffusion_models_moe_tpu_torch.models import attention
from diffusion_models_moe_tpu_torch.taps import step_row

REL_TOL = 2e-4          # tap statistics, as the torch mirrors' tolerance
LATENT_REL_TOL = 1e-3   # latents, as tests/test_torch_pipeline.py
STEPS, GUIDANCE = 2, 7.5
CALLS = STEPS + 1       # PNDM's warm-up takes one extra UNet call
ALL_TAPS = dict(max_gate=True, mean_gate=True, gate_sparsity=True,
                save_gate=True, ff_out_colnorm_sq=True,
                expert_scores_max=True, expert_freq=True, expert_sel=True,
                save_eps=True)
SELECTION_STATS = ("expert_freq", "expert_sel")


@pytest.fixture(scope="module")
def setup():
    cfg = jcfg.tiny_config()
    params, port = torch_parity.pipelines(cfg)
    rng = np.random.RandomState(1)
    t = cfg.text_encoder
    return dict(
        cfg=cfg, jpipe=JaxPipeline(cfg), params=params, port=port,
        labels=torch_parity.labels(cfg.unet),
        cond=rng.randint(0, t.vocab_size, size=(1, t.max_length)).astype(np.int32),
        context=rng.randn(2, t.max_length,
                          cfg.unet.cross_attention_dim).astype(np.float32),
        latents=rng.randn(1, cfg.sample_size, cfg.sample_size,
                          4).astype(np.float32))


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def test_step_row_clamps_like_a_jax_scan_index():
    """lax.scan over x[i] with 3 rows and i up to 5 reads rows 0,1,2,2,2,2;
    `step_row` reads the same."""
    x = np.arange(3, dtype=np.float32)
    _, ys = jax.lax.scan(lambda c, i: (c, jnp.asarray(x)[i]), 0,
                         jnp.arange(6))
    got = [step_row(torch.from_numpy(x), i).item() for i in range(6)]
    assert got == np.asarray(ys).tolist() == [0, 1, 2, 2, 2, 2]


def test_static_and_windowed_expert_remove_match_jax(setup):
    """A (1, E) removal mask (applied at every step) on even layers and a
    windowed (2, E) one (max_timestep = 1, an all-False last row) on odd
    layers, over 3 UNet calls with MoE on every FF."""
    rng = np.random.RandomState(2)
    remove = {}
    for i, (name, lab) in enumerate(sorted(setup["labels"].items())):
        static = rng.rand(int(lab.max()) + 1) < 0.3
        remove[name] = (static[None] if i % 2 == 0
                        else np.stack([static, np.zeros_like(static)]))
    ref, _ = setup["jpipe"].denoise(
        setup["params"], jnp.asarray(setup["context"]),
        jnp.asarray(setup["latents"]), STEPS, GUIDANCE,
        ivs=jax_build_ivs(setup["labels"], 0.3, expert_remove={
            k: jnp.asarray(v) for k, v in remove.items()}))
    got, _ = setup["port"].denoise(
        torch.from_numpy(setup["context"]), _nchw(setup["latents"]), STEPS,
        GUIDANCE, ivs=build_moe_interventions(setup["labels"], 0.3,
                                              expert_remove=remove,
                                              device="cpu"))
    assert torch_parity.rel_err(got.permute(0, 2, 3, 1).numpy(),
                                np.asarray(ref)) < LATENT_REL_TOL


def _ff_tokens(cfg) -> list[int]:
    """Tokens each FF layer sees, in canonical order."""
    ucfg, s = cfg.unet, cfg.sample_size
    n = len(ucfg.block_out_channels)
    levels = [i for i, kind in enumerate(ucfg.down_block_types)
              if kind == "cross" for _ in range(ucfg.layers_per_block)]
    levels += [n - 1]
    levels += [n - 1 - i for i, kind in enumerate(ucfg.up_block_types)
               if kind == "cross" for _ in range(ucfg.layers_per_block + 1)]
    return [(s >> lv) ** 2 for lv in levels]


def _scenario_ivs(name: str, setup):
    """The same interventions for JAX and the port, from numpy arrays."""
    cfg, labels = setup["cfg"], setup["labels"]
    rng = np.random.RandomState(3)
    dims, tokens = cfg.unet.ff_dims(), _ff_tokens(cfg)
    boost = None
    if name == "expert_boost":
        boost = {n: (3.0 * rng.rand(CALLS, int(lab.max()) + 1)).astype(np.float32)
                 for n, lab in labels.items()}
    jivs = list(jax_build_ivs(labels, 0.3, expert_boost=None if boost is None
                              else {k: jnp.asarray(v) for k, v in boost.items()}))
    pivs = list(build_moe_interventions(labels, 0.3, expert_boost=boost,
                                        device="cpu"))
    for l, (d, s) in enumerate(zip(dims, tokens)):
        h = 4 * d
        if name == "neuron_mask":
            m = rng.rand(CALLS, h) < 0.1
            jivs[l] = jivs[l].replace(neuron_mask=jnp.asarray(m))
            pivs[l] = dataclasses.replace(pivs[l], neuron_mask=torch.from_numpy(m))
        elif name == "out_weight_mask":
            m = rng.rand(CALLS, d, h) < 0.1                     # (T, D, H)
            jivs[l] = jivs[l].replace(
                out_weight_mask=jnp.asarray(np.swapaxes(m, 1, 2)))
            pivs[l] = dataclasses.replace(pivs[l],
                                          out_weight_mask=torch.from_numpy(m))
        elif name == "observe":
            k = -2 if l % 2 == 0 else 0            # top-2, and top-1 for k=0
            jivs[l] = JaxIV(patterns=jivs[l].patterns, k=k)
            pivs[l] = LayerIntervention(patterns=pivs[l].patterns, k=k)
        elif name == "token_mask":
            m = rng.rand(s) < 0.5
            m[0] = True
            jivs[l] = jivs[l].replace(token_mask=jnp.asarray(m))
            pivs[l] = dataclasses.replace(pivs[l], token_mask=torch.from_numpy(m))
    return tuple(jivs), tuple(pivs)


@pytest.mark.parametrize("scenario", ["moe", "neuron_mask", "out_weight_mask",
                                      "expert_boost", "observe", "token_mask"])
def test_generate_taps_match_jax(setup, monkeypatch, scenario):
    """generate(tap=every flag, ivs=..., decode=False), 2 PNDM steps: every
    stat of every layer, (T, ...), against JAX's."""
    cfg, port = setup["cfg"], setup["port"]
    jivs, pivs = _scenario_ivs(scenario, setup)
    cond = setup["cond"]
    key = jax.random.PRNGKey(4)
    s = cfg.sample_size
    noise = np.asarray(jax.random.normal(key, (1, s, s, 4), jnp.float32))
    monkeypatch.setattr(port, "initial_noise", lambda b, g: _nchw(noise))
    ref_lat, ref = setup["jpipe"].generate(
        setup["params"], cond, np.zeros_like(cond), key, num_steps=STEPS,
        guidance_scale=GUIDANCE, tap=JaxTapSpec(**ALL_TAPS), ivs=jivs,
        decode=False)
    got_lat, got = port.generate(
        torch.from_numpy(cond).long(), torch.zeros(cond.shape, dtype=torch.long),
        torch.Generator(), num_steps=STEPS, guidance_scale=GUIDANCE,
        tap=TapSpec(**ALL_TAPS), ivs=pivs, decode=False)
    assert torch_parity.rel_err(got_lat.permute(0, 2, 3, 1).numpy(),
                                np.asarray(ref_lat)) < LATENT_REL_TOL
    expected_stats = {"max_gate", "mean_gate", "gate_sparsity", "save_gate",
                      "ff_out_colnorm_sq", "expert_scores_max", "expert_freq",
                      "expert_sel", "eps", "text_colnorm_sq"}
    assert set(got) == set(ref) == expected_stats
    for stat, layers in ref.items():
        assert set(got[stat]) == set(layers), stat
        for l, r in layers.items():
            g = got[stat][l]
            if stat == "eps":                     # (T, B, C, h, w) -> NHWC
                g = g.permute(0, 1, 3, 4, 2)
            g, r = g.numpy(), np.asarray(r)
            assert g.shape == r.shape, (stat, l)
            if stat != "text_colnorm_sq":
                assert g.shape[0] == CALLS, (stat, l)
            if stat in SELECTION_STATS:
                np.testing.assert_array_equal(g, r, err_msg=f"{stat} {l}")
            else:
                assert torch_parity.rel_err(g, r) < REL_TOL, (stat, l)


def test_text_taps_and_interventions_match_jax(setup):
    """encode_text with the Wanda tap, a neuron mask on CLIP layer 0 and an
    fc2 mask on layer 1."""
    t = setup["cfg"].text_encoder
    rng = np.random.RandomState(5)
    nm = rng.rand(t.intermediate_size) < 0.2
    owm = rng.rand(t.hidden_size, t.intermediate_size) < 0.2   # fc2 (D, I)
    jivs = (JaxIV(neuron_mask=jnp.asarray(nm)),
            JaxIV(out_weight_mask=jnp.asarray(owm.T)))
    pivs = (LayerIntervention(neuron_mask=torch.from_numpy(nm)),
            LayerIntervention(out_weight_mask=torch.from_numpy(owm)))
    cond = setup["cond"]
    ref_emb, ref = setup["jpipe"].encode_text(
        setup["params"], jnp.asarray(cond),
        JaxTapSpec(ff_out_colnorm_sq=True), jivs)
    emb, got = setup["port"].encode_text(torch.from_numpy(cond).long(),
                                         TapSpec(ff_out_colnorm_sq=True), pivs)
    assert torch_parity.rel_err(emb.numpy(), np.asarray(ref_emb)) < REL_TOL
    plain, _ = setup["port"].encode_text(torch.from_numpy(cond).long())
    assert torch_parity.rel_err(emb.numpy(), plain.numpy()) > 1e-3  # masks act
    assert set(got) == set(ref) == {"text_colnorm_sq"}
    for l in range(t.num_layers):
        assert torch_parity.rel_err(got["text_colnorm_sq"][l].numpy(),
                                    ref["text_colnorm_sq"][l]) < REL_TOL


_PAT = torch.from_numpy(
    (np.arange(128)[None, :] % 8 == np.arange(8)[:, None]).astype(np.float32))
_CASES = {
    # case: (intervention fields, tap, the functions the FF calls)
    "plain": (None, None, ["geglu_ff_fused"]),
    "moe": (dict(k=3), None, ["geglu_ff_fused"]),
    "moe_expert_remove": (dict(k=3, expert_remove=torch.eye(8, dtype=torch.bool)[:2]),
                          None, ["geglu_ff_fused"]),
    "moe_eps_tap_only": (dict(k=3), TapSpec(save_eps=True), ["geglu_ff_fused"]),
    "moe_gate_tap": (dict(k=3), TapSpec(max_gate=True), ["fused_route_multiply"]),
    "moe_wanda_tap": (dict(k=3), TapSpec(ff_out_colnorm_sq=True),
                      ["fused_route_multiply"]),
    "moe_neuron_mask": (dict(k=3, neuron_mask=torch.zeros(1, 128, dtype=torch.bool)),
                        None, ["fused_route_multiply"]),
    "moe_out_weight_mask": (dict(k=3, out_weight_mask=torch.zeros(32, 128,
                                                                  dtype=torch.bool)),
                            None, ["fused_route_multiply"]),
    "moe_expert_boost": (dict(k=3, expert_boost=torch.ones(1, 8)), None,
                         ["routing_mask"]),
    "moe_expert_tap": (dict(k=3), TapSpec(expert_sel=True), ["routing_mask"]),
    "observe_expert_tap": (dict(k=-2), TapSpec(expert_freq=True), ["routing_mask"]),
    "observe_no_tap": (dict(k=-2), None, []),
    "gate_tap_no_moe": ({}, TapSpec(max_gate=True), []),
    "neuron_mask_no_moe": (dict(neuron_mask=torch.zeros(1, 128, dtype=torch.bool)),
                           None, []),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_ff_takes_the_path_the_jax_module_takes(monkeypatch, case):
    """Fused FF kernel exactly when nothing collects a gate or expert stat
    and no neuron mask, output-weight mask or boost is set, and the routing
    is plain or absent (JAX models/attention.py:405-412); otherwise the
    unfused path, routing through the fused routing kernel unless a boost or
    an expert tap needs the selection (:518-555)."""
    fields, tap, expected = _CASES[case]
    calls = []
    for name in ("geglu_ff_fused", "fused_route_multiply", "routing_mask"):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *a, _fn=fn, _n=name, **kw:
                            calls.append(_n) or _fn(*a, **kw))
    iv = None if fields is None else LayerIntervention(
        patterns=_PAT if "k" in fields else None, **fields)
    ff = attention.GEGLUFeedForward(32, 4).eval()
    taps: dict = {}
    with torch.no_grad():
        y = ff(torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(0)),
               tap=tap, iv=iv, taps_out=taps)
    assert calls == expected
    assert y.shape == (2, 16, 32) and torch.isfinite(y).all()
    assert bool(taps) == (tap is not None and (tap.any_gate_stat()
                                               or tap.any_expert_stat()))
    assert all(list(layers) == [0] for layers in taps.values())
