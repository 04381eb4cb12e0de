"""The training step's pieces on the CPU: Adafactor and the LR schedules
against optax, `trainable_mask` against the JAX package's over the bridge,
remat against no remat, and gradients through the kernel wrappers (kernels
2 and 3 carry them through `torch.autograd.Function`s; kernels 1 and 4-8
give way to their plain versions under grad on the card). No UNet train
step is compiled by JAX here; seconds in all.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from diffusion_models_moe_tpu.training import train as jtrain
from diffusion_models_moe_tpu_torch import StableDiffusionPipeline
from diffusion_models_moe_tpu_torch.models import attention, layers
from diffusion_models_moe_tpu_torch.models.attention import (
    Attention, GEGLUFeedForward, _route_kernel)
from diffusion_models_moe_tpu_torch.models.layers import ResnetBlock2D, WinoConv
from diffusion_models_moe_tpu_torch.ops import _build, sd_flash
from diffusion_models_moe_tpu_torch.schedulers.common import NoiseTables
from diffusion_models_moe_tpu_torch.training import train

TOL = 2e-4


# ------------------------------------------------------------ optimizer
class _Three(nn.Module):
    """A conv kernel, a matrix and a 1-D parameter, in the port's layouts:
    (Cout, Cin, 3, 3) = (192, 128, 3, 3) and (out, in) = (256, 160), both
    factored; (64,) not."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Parameter(torch.zeros(192, 128, 3, 3))
        self.dense = nn.Parameter(torch.zeros(256, 160))
        self.vec = nn.Parameter(torch.zeros(64))


TO_JAX = {"conv": (2, 3, 1, 0), "dense": (1, 0), "vec": (0,)}


@pytest.mark.parametrize("weight_decay", [1e-2, 0.0])
def test_adafactor_matches_optax(weight_decay):
    """Three steps of the port's clip + Adafactor against JAX's
    `make_optimizer` (`clip_by_global_norm` then `optax.adafactor` with its
    defaults and `weight_decay_rate`), each parameter in its own layout, on
    seeded parameters and gradients (the clip runs: the global norm is
    above 1)."""
    rng = np.random.RandomState(0)
    mod = _Three()
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)
                                     * 0.1))
    cfg = dict(learning_rate=1e-2, optimizer="adafactor",
               weight_decay=weight_decay, use_ema=False)
    tcfg = train.TrainConfig(**cfg)
    state = train.create_train_state(mod, tcfg)
    assert state.opt_state["v_row"]["conv"].shape == (128, 3, 3)
    assert state.opt_state["v_col"]["conv"].shape == (192, 3, 3)
    assert state.opt_state["v"]["vec"].shape == (64,)
    # copies: jnp.asarray of a plain view would share the port's memory,
    # which the port's step updates in place
    jp = {n: jnp.array(np.transpose(t.numpy(), TO_JAX[n]), copy=True)
          for n, t in state.params.items()}
    tx = jtrain.make_optimizer(jtrain.TrainConfig(**cfg), jp)
    opt = tx.init(jp)
    schedule = train.make_lr_schedule(tcfg)
    for _ in range(3):
        grads = {n: rng.randn(*t.shape).astype(np.float32)
                 for n, t in state.params.items()}
        train.apply_gradients(state, {n: torch.from_numpy(g)
                                      for n, g in grads.items()},
                              tcfg, schedule)
        upd, opt = tx.update({n: jnp.asarray(np.transpose(g, TO_JAX[n]))
                              for n, g in grads.items()}, opt, jp)
        jp = optax.apply_updates(jp, upd)
        for n, t in state.params.items():
            ref = np.transpose(np.asarray(jp[n]), np.argsort(TO_JAX[n]))
            assert tp.rel_err(t.numpy(), ref) < TOL, n
    assert state.opt_state["count"] == 3


@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_lr_schedules_match_optax(schedule, warmup):
    """The port's schedule equals JAX's `make_lr_schedule` (optax's
    schedules and `join_schedules`) at every step from 0 past the horizon,
    the warm-up join included."""
    kw = dict(learning_rate=1e-3, lr_schedule=schedule,
              lr_warmup_steps=warmup, max_train_steps=60)
    got = train.make_lr_schedule(train.TrainConfig(**kw))
    ref = jtrain.make_lr_schedule(jtrain.TrainConfig(**kw))
    for step in range(75):
        # optax computes in f32: within a few of its units in the last place
        assert abs(got(step) - float(ref(step))) <= 1e-6 * 1e-3, step
    if warmup:
        assert got(0) == 0.0 and got(warmup) == pytest.approx(1e-3)


def test_unknown_choices_raise():
    with pytest.raises(ValueError, match="lr_schedule"):
        train.make_lr_schedule(train.TrainConfig(lr_schedule="step"))
    with pytest.raises(ValueError, match="optimizer"):
        train.create_train_state(_Three(), train.TrainConfig(optimizer="sgd"))


# ------------------------------------------------------------ masks
@pytest.fixture(scope="module")
def setup():
    return tp.train_setup()


@pytest.mark.parametrize("method", sorted(jtrain.FT_METHODS))
def test_trainable_mask_equals_jax(setup, method):
    """For every method, the port keys that train are the bridge's image of
    the JAX leaves that `trainable_mask` marks true (each leaf filled with
    its mask bit and carried through the bridge)."""
    _, pcfg, params, port, _ = setup
    assert train.FT_METHODS.keys() == jtrain.FT_METHODS.keys()
    mask_j = jtrain.trainable_mask(params["unet"], method)
    filled = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), mask_j,
        params["unet"])
    image = tp.unet_tree_to_port(filled, pcfg.unet)
    for v in image.values():
        assert v.min() == v.max()
    want = {k for k, v in image.items() if v.max() == 1.0}
    names = [n for n, _ in port.unet.named_parameters()]
    got = train.trainable_mask(names, method)
    assert set(got) == set(image)
    assert {n for n, t in got.items() if t} == want
    report = train_param_report(port, got)
    assert report["trainable"] == sum(port.unet.get_parameter(n).numel()
                                      for n in want)


def train_param_report(port, mask):
    from diffusion_models_moe_tpu_torch.training.trainer import \
        param_count_report
    return param_count_report(dict(port.unet.named_parameters()), mask)


# ------------------------------------------------------------ remat
def test_remat_equals_no_remat(setup):
    """`UNetConfig.remat` recomputes each block in the backward: the loss
    and every gradient equal the plain forward's, and a forward without a
    gradient, or with a tap, runs no checkpoint."""
    _, pcfg, _, port, batch = setup
    pb = tp.port_batch(batch)
    draws = train.draw_step(torch.Generator().manual_seed(0),
                            pb["latents"].shape)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(
            pcfg, unet=dataclasses.replace(pcfg.unet, remat=remat))
        pipe = StableDiffusionPipeline(cfg, device="cpu")
        pipe.load_state_dicts({k: m.state_dict()
                               for k, m in port.modules().items()})
        loss = train.loss_fn(pipe.unet, pb["latents"], pb["text_emb"], draws,
                             train.TrainConfig(snr_gamma=5.0),
                             NoiseTables.create())
        loss.backward()
        out.append((loss.item(), {n: p.grad.clone() for n, p
                                  in pipe.unet.named_parameters()}))
    assert out[0][0] == out[1][0]
    for n, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][n], g, rtol=0, atol=0)

    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    import diffusion_models_moe_tpu_torch.models.unet as unet_mod
    cfg = dataclasses.replace(pcfg, unet=dataclasses.replace(pcfg.unet,
                                                             remat=True))
    pipe = StableDiffusionPipeline(cfg, device="cpu")
    t = torch.tensor([10, 500])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(unet_mod, "checkpoint", spy)
        with torch.no_grad():
            pipe.unet(pb["latents"], t, pb["text_emb"])
        assert not calls
        pipe.unet(pb["latents"], t, pb["text_emb"]).sum().backward()
        # 22 resblocks and 16 transformers (tiny_config has SD1.5's topology)
        assert len(calls) == 22 + 16


# ------------------------------------------------------------ kernel grads
def _attention_in_dtype(q, k, v, s, valid=None):
    """Softmax attention in q's own dtype (f64 for the finite differences
    of gradcheck; the plain versions compute in f32)."""
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * s
    if valid is not None:
        sc = sc.masked_fill(torch.arange(k.shape[1]) >= valid, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)


def _stub_launchers(monkeypatch):
    """Kernels 2 and 3's launchers replaced by attention math with no graph
    (a kernel writes its output outside autograd), counting launches."""
    def self_stub(q, k, v, s):
        _build.LAUNCHES["sd_self_attention"] += 1
        with torch.no_grad():
            return _attention_in_dtype(q, k, v, s)

    def cross_stub(q, k, v, s, valid):
        _build.LAUNCHES["sd_cross_attention"] += 1
        with torch.no_grad():
            return _attention_in_dtype(q, k, v, s, valid)

    monkeypatch.setattr(sd_flash, "_launch_self", self_stub)
    monkeypatch.setattr(sd_flash, "_launch_cross", cross_stub)


def test_attention_kernel_wrappers_carry_gradients(monkeypatch):
    """Through a stub launcher: `kernel_self_attention` and
    `kernel_cross_attention` take their Function under grad (gradcheck in
    f64 against finite differences; gradients in f32 equal the plain
    version's autograd), launch once a forward, and call the launcher
    alone without grad."""
    _stub_launchers(monkeypatch)
    g = torch.Generator().manual_seed(0)

    def qkv(dtype, s_kv):
        return [torch.randn(2, s, 2, 8, generator=g, dtype=dtype
                            ).requires_grad_() for s in (5, s_kv, s_kv)]

    fns = {"self": (lambda q, k, v: sd_flash.kernel_self_attention(
                        q, k, v, 0.35),
                    lambda q, k, v: sd_flash.sd_self_attention_reference(
                        q, k, v, 0.35), 5),
           "cross": (lambda q, k, v: sd_flash.kernel_cross_attention(
                         q, k, v, 0.35, 3),
                     lambda q, k, v: sd_flash.sd_cross_attention_reference(
                         q, k, v, 0.35, 3), 4)}
    for name, (kern, plain, s_kv) in fns.items():
        _build.reset_launch_counts()
        assert torch.autograd.gradcheck(kern, qkv(torch.float64, s_kv),
                                        atol=1e-5, rtol=1e-3)
        ins = qkv(torch.float32, s_kv)
        do = torch.randn(2, 5, 2, 8, generator=g)
        _build.reset_launch_counts()
        out = kern(*ins)
        assert out.grad_fn is not None
        key = f"sd_{name}_attention"
        assert _build.LAUNCHES[key] == 1
        got = torch.autograd.grad(out, ins, do)
        assert _build.LAUNCHES[key] == 1       # the backward is plain math
        ref_ins = [t.detach().requires_grad_() for t in ins]
        ref = torch.autograd.grad(plain(*ref_ins), ref_ins, do)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        # q alone requires grad: no gradient for k, v
        q, k, v = (t.detach() for t in ins)
        q.requires_grad_()
        (gq,) = torch.autograd.grad(kern(q, k, v), [q], do)
        torch.testing.assert_close(gq, ref[0], rtol=1e-6, atol=1e-7)
        with torch.no_grad():
            assert kern(*ins).grad_fn is None


def _spy(monkeypatch, module, name, seen: list):
    """Replaces `module.name` by a wrapper recording its `use_kernels` (or
    `absorb_kernels`) keyword."""
    orig = getattr(module, name)

    def wrapper(*a, **k):
        seen.append(k.get("absorb_kernels", k.get("use_kernels", True)))
        return orig(*a, **k)

    monkeypatch.setattr(module, name, wrapper)


def _both_modes(run, params, key, seen) -> None:
    """`run()` under grad takes the plain version, counted under `key`, and
    gives its parameters gradients; under no_grad the kernel is asked for
    and nothing is counted."""
    for grad in (True, False):
        _build.reset_launch_counts()
        seen.clear()
        with torch.set_grad_enabled(grad):
            out = run()
        if grad:
            out.float().sum().backward()
            assert all(p.grad is not None for p in params)
        assert seen and all(s is not grad for s in seen), (grad, seen)
        assert (_build.LAUNCHES[key] > 0) is grad


def test_forward_only_kernels_give_way_under_grad(monkeypatch):
    """Kernels 1 and 4-8 (no backward): with the tensors taken to lie on
    the card (`_build.on_card`), a call that autograd records goes to the
    plain version and is counted under `plain:<kernel>`; under no_grad
    the same call asks for the kernel (on the CPU its wrapper runs the
    plain version) and counts nothing."""
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    seen: list = []

    # kernel 1: the fused FF, LN and residual absorbed
    ff = GEGLUFeedForward(32, activation="geglu-relu").to(bf)
    ln = nn.LayerNorm(32)
    x = torch.randn(2, 6, 32, generator=g).to(bf)
    _spy(monkeypatch, attention, "geglu_ff_fused", seen)
    _both_modes(lambda: ff(x, ln=ln), list(ff.parameters()),
                "plain:geglu_ff_fused", seen)

    # kernel 4: the routing multiply of the unfused FF
    h = torch.randn(12, 64, generator=g).to(bf).requires_grad_()
    gate = torch.rand(12, 64, generator=g).to(bf).requires_grad_()
    pats = (torch.arange(64)[None, :] // 16 == torch.arange(4)[:, None]
            ).to(bf)
    for grad, want in ((True, False), (False, True)):
        _build.reset_launch_counts()
        with torch.set_grad_enabled(grad):
            assert _route_kernel(h, gate, pats, True) is want
        assert _build.LAUNCHES["plain:fused_route_multiply"] == int(grad)

    # kernels 5 and 6: the absorbed self-attention
    attn = Attention(32, heads=4).to(bf)
    _spy(monkeypatch, attention, "absorbed_self_attention", seen)
    _both_modes(lambda: attn(x, ln=ln, absorb="1"),
                list(attn.parameters()) + list(ln.parameters()),
                "plain:ln_qkv_fused", seen)
    _build.reset_launch_counts()
    attn(x, ln=ln, absorb="1")
    assert _build.LAUNCHES["plain:attn_out_residual_fused"] == 1

    # kernel 7: the resblock conv chain
    res = ResnetBlock2D(16, 16, 8, temb_channels=32, conv_chain=True)
    layers.cast_model(res, bf)
    xc = torch.randn(2, 16, 8, 8, generator=g).to(bf)
    temb = torch.randn(2, 32, generator=g).to(bf)
    _spy(monkeypatch, layers, "conv3x3_chain", seen)
    _both_modes(lambda: res(xc, temb), list(res.parameters()),
                "plain:conv3x3_chain", seen)

    # kernel 8: the fused Winograd conv (its filter transformed at each call
    # under grad, so that the weight takes a gradient)
    conv = WinoConv(16, 128, mode="fused").to(bf)
    xw = torch.randn(1, 16, 16, 16, generator=g).to(bf)
    _spy(monkeypatch, layers, "winograd3x3_fused", seen)
    _both_modes(lambda: conv(xw), list(conv.parameters()),
                "plain:winograd3x3_fused", seen)
