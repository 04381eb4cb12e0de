"""The port's image-statistics judges against the JAX package's, on the
CPU: the ResNet-50 / SSCD and AlexNet / LPIPS backbones, the FID
Inception-v3, the torchvision porter, FID, the directory scores, the
memorization scores and the text metrics.

Weights are seeded numpy state dicts in torchvision's / lpips' / SSCD's
layout (with batch norm's `num_batches_tracked`, which the porters drop):
they go into JAX through its porters and into the port through its key
mappings, and the bridge's JAX-params -> state-dict direction gives them
back bit for bit. The backbones run at their tiny configs, the
Inception-v3 at full width on an 80 x 80 input through one module-scoped
JAX compile; everything else in JAX runs op by op. Tolerances: model
outputs 2e-4 relative (max error over max magnitude), `frechet_distance`
1e-6 relative, resized images 1e-5, BLEU / ROUGE exact.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from diffusion_models_moe_tpu.benchmarks import fid as jfid
from diffusion_models_moe_tpu.benchmarks import memorization as jmem
from diffusion_models_moe_tpu.benchmarks import scores as jscores
from diffusion_models_moe_tpu.benchmarks import text_metrics as jtext
from diffusion_models_moe_tpu.models import backbones as jbb
from diffusion_models_moe_tpu.models import inception as jinc
from diffusion_models_moe_tpu.weights import port_torchvision as jptv
from diffusion_models_moe_tpu_torch.benchmarks import (fid, memorization,
                                                       scores, text_metrics)
from diffusion_models_moe_tpu_torch.models import backbones as bb
from diffusion_models_moe_tpu_torch.models import inception as inc
from diffusion_models_moe_tpu_torch.weights import bridge
from diffusion_models_moe_tpu_torch.weights import port_torchvision as ptv

TOL = 2e-4            # model outputs, relative
FD_TOL = 1e-6         # frechet_distance on the same features, relative
IMG_TOL = 1e-5        # resized images, relative


def seeded_state(module: torch.nn.Module, rng, tracked: bool = True) -> dict:
    """numpy weights for `module`'s state dict in torchvision's layout:
    kernels N(0, 2/fan_in), linear weights N(0, 1/fan_in), batch norm
    weights U(0.5, 1.5), biases and running means N(0, 0.1^2), running
    variances U(0.5, 1.5); with `tracked`, batch norm's
    `num_batches_tracked` as a torchvision file has it."""
    out = {}
    for name, t in module.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("running_var") or (
                len(shape) == 1 and name.endswith("weight")):
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) == 1:
            v = 0.1 * rng.randn(*shape)
        else:
            gain = 2.0 if len(shape) == 4 else 1.0
            v = rng.randn(*shape) * (gain / np.prod(shape[1:])) ** 0.5
        out[name] = v.astype(np.float32)
        if tracked and name.endswith("running_var"):
            out[name[:-len("running_var")] + "num_batches_tracked"] = \
                np.array(7, np.int64)
    return out


def torch_sd(sd: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def held_equal(back: dict, want: dict) -> None:
    """`back` has exactly `want`'s keys (batch norm's counters aside), each
    value bit-equal."""
    want = {k: v for k, v in want.items()
            if not k.endswith("num_batches_tracked")}
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v),
                                      err_msg=k)


def images(seed: int, b: int = 2, side: int = 64) -> np.ndarray:
    """(B, H, W, 3) f32 in [0, 1], JAX's layout."""
    return np.random.RandomState(seed).rand(b, side, side, 3).astype(
        np.float32)


def loaded(module, sd: dict):
    module.load_state_dict(torch_sd(sd))
    return module


# -------------------------------------------------------------- ResNet, SSCD
@pytest.fixture(scope="module")
def resnet():
    cfg, jcfg = bb.tiny_resnet_config(), jbb.tiny_resnet_config()
    model = bb.ResNet(cfg, device="cpu")
    sd = seeded_state(model, np.random.RandomState(0))
    params = jptv.port_resnet(torch_sd(sd), jcfg)
    held_equal(bridge.resnet_numpy_state_dict(params, cfg), sd)
    held_equal(ptv.resnet_state_dict(sd, cfg), sd)
    loaded(model, ptv.resnet_state_dict(sd, cfg))
    return dict(cfg=cfg, jcfg=jcfg, sd=sd, params=params, model=model)


def test_resnet_matches_jax(resnet):
    x = jbb.preprocess_imagenet(jnp.asarray(images(1)))
    px = bb.preprocess_imagenet(tp.nchw(images(1)))
    assert tp.rel_err(tp.nhwc(px), x) < IMG_TOL
    ref = jbb.resnet_logits(resnet["params"], x, resnet["jcfg"])
    got = bb.resnet_logits(resnet["model"], px)
    assert got.shape == (2, 7) and tp.rel_err(got.numpy(), ref) < TOL
    ref = jbb.resnet_features(resnet["params"], x, resnet["jcfg"])
    got = bb.resnet_features(resnet["model"], px)
    assert tp.rel_err(tp.nhwc(got), ref) < TOL


def test_sscd_matches_jax(resnet):
    """SSCD's file: the trunk under `backbone.`, the projection as
    `embeddings.weight` and bias; unit-norm embeddings equal to JAX's."""
    cfg, rng = resnet["cfg"], np.random.RandomState(2)
    model = bb.SSCD(cfg, dims=16, device="cpu")
    sd = {f"backbone.{k}": v for k, v in resnet["sd"].items()
          if not k.startswith("fc.")}
    sd["embeddings.weight"] = (rng.randn(16, 256) * 0.1).astype(np.float32)
    sd["embeddings.bias"] = (rng.randn(16) * 0.1).astype(np.float32)
    params = jptv.port_sscd(torch_sd(sd), resnet["jcfg"])
    held_equal(bridge.sscd_numpy_state_dict(params, cfg), sd)
    loaded(model, ptv.sscd_state_dict(sd, cfg))
    x = images(3)
    ref = jbb.sscd_embed(params, jbb.preprocess_imagenet(jnp.asarray(x)),
                         resnet["jcfg"])
    got = bb.sscd_embed(model, bb.preprocess_imagenet(tp.nchw(x)))
    assert tp.rel_err(got.numpy(), ref) < TOL
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    feats = np.random.RandomState(4).rand(2, 5, 3, 3).astype(np.float32)
    assert tp.rel_err(bb.gem_pool(torch.from_numpy(feats)).numpy(),
                      jbb.gem_pool(jnp.asarray(feats.transpose(0, 2, 3, 1)))
                      ) < TOL


# ------------------------------------------------------------ AlexNet, LPIPS
@pytest.fixture(scope="module")
def lpips_weights():
    cfg = bb.tiny_alexnet_config()
    rng = np.random.RandomState(5)
    alex = seeded_state(bb.AlexNet(cfg, device="cpu"), rng)
    lins = {f"lin{i}.model.1.weight":
            rng.uniform(0.0, 1.0, (1, c, 1, 1)).astype(np.float32)
            for i, c in enumerate(cfg.channels)}
    params = jptv.port_lpips(torch_sd(alex), torch_sd(lins), cfg)
    model = loaded(bb.LPIPS(cfg, device="cpu"),
                   ptv.lpips_state_dict(alex, lins, cfg))
    return dict(cfg=cfg, alex=alex, lins=lins, params=params, model=model)


def test_alexnet_and_lpips_match_jax(lpips_weights):
    w = lpips_weights
    cfg = w["cfg"]
    held_equal(bridge.alexnet_numpy_state_dict(w["params"]["net"]), w["alex"])
    held_equal(bridge.lpips_numpy_state_dict(w["params"]),
               {k: v.numpy() for k, v in
                ptv.lpips_state_dict(w["alex"], w["lins"], cfg).items()})
    a, b = images(6) * 2 - 1, images(7) * 2 - 1
    ref = jbb.alexnet_features(w["params"]["net"], jnp.asarray(a), cfg)
    got = bb.alexnet_features(w["model"].net, tp.nchw(a))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert tp.rel_err(tp.nhwc(g), r) < TOL
    ref = jbb.lpips_distance(w["params"], jnp.asarray(a), jnp.asarray(b), cfg)
    got = bb.lpips_distance(w["model"], tp.nchw(a), tp.nchw(b))
    assert tp.rel_err(got.numpy(), ref) < TOL
    assert (got > 0).all()
    ref = jbb.make_lpips_fn(w["params"], cfg)(images(6), images(7))
    fn = bb.make_lpips_fn(w["model"])
    assert fn.metric_name == "lpips_alex_native"
    assert tp.rel_err(fn(tp.nchw(images(6)), tp.nchw(images(7))), ref) < TOL


# -------------------------------------------------------------- Inception-v3
@pytest.fixture(scope="module")
def inception():
    """The full-width FID Inception-v3 with seeded weights in both packages;
    JAX's pool features and logits of two 80 x 80 images from one jit."""
    model = inc.InceptionV3(device="cpu")
    sd = seeded_state(model, np.random.RandomState(8))
    sd["AuxLogits.fc.weight"] = np.zeros((3, 3), np.float32)  # dropped
    params = jptv.port_inception(torch_sd(sd))
    held_equal(bridge.inception_numpy_state_dict(params),
               {k: v for k, v in sd.items() if not k.startswith("AuxLogits")})
    loaded(model, ptv.inception_state_dict(sd))
    x = images(9, side=80) * 2 - 1

    @jax.jit
    def run(p, x):
        return (jinc.inception_pool_features(p, x),
                jinc.inception_logits(p, x))
    pool, logits = run(params, jnp.asarray(x))
    return dict(model=model, sd=sd, x=x, pool=np.asarray(pool),
                logits=np.asarray(logits))


def test_inception_matches_jax(inception):
    m, x = inception["model"], tp.nchw(inception["x"])
    got = inc.inception_pool_features(m, x)
    assert got.shape == (2, 2048)
    assert tp.rel_err(got.numpy(), inception["pool"]) < TOL
    got = inc.inception_logits(m, x)
    assert got.shape == (2, 1008)
    assert tp.rel_err(got.numpy(), inception["logits"]) < TOL


@pytest.mark.parametrize("exclude", [True, False])
def test_inception_pools_match_jax(exclude):
    """The FID variant's average pool without the padding in the divisor,
    and stock torchvision's with it."""
    x = np.random.RandomState(10).randn(2, 7, 7, 5).astype(np.float32)
    ref = jinc._avg_pool_3x3(jnp.asarray(x), exclude)
    got = inc._avg_pool_3x3(tp.nchw(x), exclude)
    assert tp.rel_err(tp.nhwc(got), ref) < TOL


@pytest.mark.parametrize("src", [512, 80, 299])
def test_preprocess_fid_matches_jax(src):
    x = images(11, b=1, side=src)
    ref = jinc.preprocess_fid(jnp.asarray(x))
    got = inc.preprocess_fid(tp.nchw(x))
    assert got.shape == (1, 3, 299, 299)
    assert tp.rel_err(tp.nhwc(got), ref) < IMG_TOL


def test_inception_featurizers(inception, tmp_path):
    """The featurizer is preprocess_fid then the pool features, on the
    model's device; from a file, the same numbers."""
    m = inception["model"]
    x = tp.nchw(images(12, b=1, side=96))
    want = inc.inception_pool_features(m, inc.preprocess_fid(x))
    assert torch.equal(fid.make_inception_featurizer(m)(x), want)
    path = str(tmp_path / "inception.pt")
    torch.save(torch_sd(inception["sd"]), path)
    got = fid.load_inception_featurizer(path, device="cpu")(x)
    assert torch.equal(got, want)


# ------------------------------------------------------------------ porters
def test_load_state_dict_reads_every_format(tmp_path, resnet):
    sd = torch_sd(resnet["sd"])
    files = {"plain.pt": sd, "wrapped.pth": {"state_dict": sd}}
    for name, obj in files.items():
        torch.save(obj, str(tmp_path / name))
    np.savez(str(tmp_path / "arrays.npz"), **resnet["sd"])
    scripted = torch.jit.trace(resnet["model"].layer1,
                               torch.zeros(1, 8, 8, 8))
    scripted.save(str(tmp_path / "scripted.pt"))
    for name in ("plain.pt", "wrapped.pth", "arrays.npz", "scripted.pt"):
        got = ptv.load_state_dict(str(tmp_path / name))
        ref = jptv.load_state_dict(str(tmp_path / name))
        assert got.keys() == ref.keys(), name
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=f"{name}: {k}")


def test_porter_names_and_refusals(lpips_weights, resnet):
    w, cfg = lpips_weights, lpips_weights["cfg"]
    want = ptv.lpips_state_dict(w["alex"], w["lins"], cfg)
    for style in ("bare", "short"):
        lins = {(f"lin{i}.weight" if style == "bare" else f"lin{i}"):
                v.reshape(-1) for i, v in enumerate(w["lins"].values())}
        got = ptv.lpips_state_dict(w["alex"], lins, cfg)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        jgot = jptv.port_lpips(torch_sd(w["alex"]), torch_sd(lins), cfg)
        for i, v in enumerate(jgot["lins"]):
            np.testing.assert_array_equal(v, want[f"lins.{i}"].numpy())
    bare = {k[len("features."):]: v for k, v in w["alex"].items()}
    for k, v in ptv.alexnet_state_dict(bare).items():
        np.testing.assert_array_equal(v.numpy(), w["alex"][k])
    missing = dict(list(w["lins"].items())[:-1])
    narrow = dict(w["lins"], **{"lin0.model.1.weight": np.zeros((1, 3, 1, 1),
                                                                np.float32)})
    for mod, a in ((ptv, w["alex"]), (jptv, torch_sd(w["alex"]))):
        with pytest.raises(KeyError, match="no LPIPS linear head"):
            (mod.lpips_state_dict if mod is ptv else mod.port_lpips)(
                a, missing, cfg)
        with pytest.raises(ValueError, match="channels"):
            (mod.lpips_state_dict if mod is ptv else mod.port_lpips)(
                a, narrow, cfg)
    keys = ptv.census(resnet["model"])
    assert keys == sorted(resnet["model"].state_dict())
    assert ptv.census(resnet["sd"], "m.")[0] == "m." + sorted(resnet["sd"])[0]


@pytest.mark.parametrize("entry", ["resnet", "sscd", "alexnet", "lpips",
                                   "inception", "native_lpips", "native_sscd",
                                   "inception_file", "sscd_file",
                                   "lpips_package"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """Every judge entry point runs on the card unless the caller asks for
    the CPU: with no CUDA device the default raises before any weights are
    read, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    path = str(tmp_path / "none.pt")
    calls = {
        "resnet": lambda: bb.ResNet(bb.tiny_resnet_config()),
        "sscd": lambda: bb.SSCD(bb.tiny_resnet_config()),
        "alexnet": lambda: bb.AlexNet(bb.tiny_alexnet_config()),
        "lpips": lambda: bb.LPIPS(bb.tiny_alexnet_config()),
        "inception": lambda: inc.InceptionV3(),
        "native_lpips": lambda: scores.load_native_lpips(path, path),
        "native_sscd": lambda: memorization.make_native_sscd(path),
        "inception_file": lambda: fid.load_inception_featurizer(path),
        "sscd_file": lambda: memorization.load_sscd(path),
        "lpips_package": lambda: scores.load_lpips(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device is present"):
        calls[entry]()


def test_f32_convs_restores_the_flag_across_threads():
    """Judge blocks that overlap on two threads keep cuDNN's TF32 off until
    the last one closes, then leave the process's setting as it was."""
    import threading
    from diffusion_models_moe_tpu_torch.models.layers import f32_convs
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    try:
        for setting in (True, False):
            cudnn.allow_tf32 = setting
            a_in, b_in, a_out = (threading.Event() for _ in range(3))
            seen = []

            def a():
                with f32_convs():
                    a_in.set()
                    b_in.wait()
                a_out.set()

            def b():
                a_in.wait()
                with f32_convs():
                    b_in.set()
                    a_out.wait()
                    seen.append(cudnn.allow_tf32)

            threads = [threading.Thread(target=f) for f in (a, b)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert seen == [False] and cudnn.allow_tf32 is setting
            with pytest.raises(ValueError):
                with f32_convs(), f32_convs():
                    assert cudnn.allow_tf32 is False
                    raise ValueError
            assert cudnn.allow_tf32 is setting
    finally:
        cudnn.allow_tf32 = before


# ---------------------------------------------------------------------- FID
def test_frechet_distance_matches_jax():
    rng = np.random.RandomState(13)
    real = rng.randn(40, 6).astype(np.float32)
    fake = (rng.randn(40, 6) * 1.3 + 0.2).astype(np.float32)
    ref = jfid.fid_from_features(real, fake)
    got = fid.fid_from_features(torch.from_numpy(real), fake)
    assert abs(got - ref) <= FD_TOL * abs(ref)
    a, b = fid.FeatureStats(), jfid.FeatureStats()
    for chunk in np.array_split(real, 3):
        a.update(torch.from_numpy(chunk))
        b.update(chunk)
    for x, y in zip(a.finalize(), b.finalize()):
        np.testing.assert_array_equal(x, y)
    # fewer samples than dimensions: singular covariances, the eps retry
    few_r, few_f = rng.randn(3, 8), rng.randn(3, 8)
    ref = jfid.fid_from_features(few_r, few_f)
    got = fid.fid_from_features(few_r, few_f)
    assert np.isfinite(got) and abs(got - ref) <= FD_TOL * abs(ref)
    mu, cov = a.finalize()
    assert abs(fid.frechet_distance(mu, cov, mu, cov)) < 1e-6


# ------------------------------------------------------------------- scores
@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("pairs")
    a, b = root / "a", root / "b"
    a.mkdir()
    b.mkdir()
    rng = np.random.RandomState(14)
    for i in range(5):
        for d, prefix in ((a, "sd_"), (b, "removed_")):
            Image.fromarray(rng.randint(0, 256, (40, 40, 3), np.uint8)).save(
                str(d / f"{prefix}{i}.png"))
    (a / "sd_9.png").write_bytes((a / "sd_0.png").read_bytes())  # no mate
    (a / "notes.txt").write_text("not an image")
    return str(a), str(b)


def _stats_featurizer(nchw: bool):
    """Per-channel means and standard deviations in f64 on NHWC numpy: the
    same numbers from either package's layout."""
    def f(x):
        x = np.asarray(x, np.float64)
        if nchw:
            x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        return np.concatenate([x.mean(axis=(1, 2)), x.std(axis=(1, 2))], 1)
    return f


def test_directory_scores_match_jax(image_dirs, lpips_weights, tmp_path):
    a, b = image_dirs
    assert scores.list_image_pairs(a, b) == jscores.list_image_pairs(a, b)
    assert len(scores.list_image_pairs(a, b)) == 5
    paths = [p for p, _ in scores.list_image_pairs(a, b)]
    for size in (32, None):
        got = scores.load_images(paths, size)
        ref = jscores.load_images(paths, size)
        np.testing.assert_array_equal(tp.nhwc(got), ref)
    ref = jscores.fid_between_dirs(a, b, _stats_featurizer(False), batch=2)
    got = scores.fid_between_dirs(a, b, _stats_featurizer(True), batch=2)
    assert abs(got - ref) <= FD_TOL * abs(ref)
    w = lpips_weights
    ref = jscores.perceptual_between_dirs(
        a, b, jbb.make_lpips_fn(w["params"], w["cfg"]), batch=2)
    got = scores.perceptual_between_dirs(a, b, bb.make_lpips_fn(w["model"]),
                                         batch=2)
    assert got["metric"] == ref["metric"] and got["n"] == ref["n"] == 5
    assert abs(got["mean"] - ref["mean"]) <= TOL * abs(ref["mean"])
    ref = jscores.perceptual_between_dirs(
        a, b, jscores.clip_perceptual_distance(_stats_featurizer(False)))
    got = scores.perceptual_between_dirs(
        a, b, scores.clip_perceptual_distance(_stats_featurizer(True)))
    assert got["metric"] == ref["metric"] == "clip_cosine_distance"
    assert abs(got["mean"] - ref["mean"]) <= TOL * abs(ref["mean"])
    for load in (lambda: scores.load_lpips(device="cpu"), jscores.load_lpips):
        with pytest.raises(RuntimeError, match="LPIPS is not available"):
            load()


class _StubLPIPS(torch.nn.Module):
    """Stands in for the lpips package's LPIPS: a learned per-channel
    weighting of squared differences, so that its weights must follow the
    module to its device."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        self.net = net
        self.w = torch.nn.Parameter(torch.tensor([0.5, 1.0, 2.0]))

    def forward(self, a, b):
        d = (a - b).square() * self.w.view(1, 3, 1, 1)
        return d.mean(dim=(1, 2, 3), keepdim=True)


def test_lpips_package_path_matches_jax(monkeypatch):
    """`load_lpips` through an installed lpips package (a stub module here,
    as no environment of the repo has the package): the port's on its
    device against JAX's host-side judge on the same images."""
    import types
    stub = types.ModuleType("lpips")
    stub.LPIPS = _StubLPIPS
    monkeypatch.setitem(sys.modules, "lpips", stub)
    x, y = images(18, side=24), images(19, side=24)
    ref = jscores.load_lpips()(x, y)
    fn = scores.load_lpips("alex", device="cpu")
    got = fn(tp.nchw(x), tp.nchw(y))
    assert fn.metric_name == "lpips_alex" and got.shape == ref.shape == (2,)
    np.testing.assert_allclose(got, ref, rtol=TOL)


def test_native_lpips_from_files_matches_jax(lpips_weights, tmp_path):
    """The full-width LPIPS from files (.npz for the AlexNet, .pt for the
    heads) against JAX's `load_native_lpips`, which reads the full-width
    geometry too."""
    cfg = bb.AlexNetConfig()
    rng = np.random.RandomState(15)
    alex = seeded_state(bb.AlexNet(cfg, device="cpu"), rng)
    lins = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate(cfg.channels)}
    np.savez(str(tmp_path / "alex.npz"), **alex)
    torch.save(lins, str(tmp_path / "lins.pt"))
    ref = jscores.load_native_lpips(str(tmp_path / "alex.npz"),
                                    str(tmp_path / "lins.pt"))
    got = scores.load_native_lpips(str(tmp_path / "alex.npz"),
                                   str(tmp_path / "lins.pt"), device="cpu")
    x, y = images(16, side=64), images(17, side=64)
    assert tp.rel_err(got(tp.nchw(x), tp.nchw(y)), ref(x, y)) < TOL


# ------------------------------------------------------------- memorization
class _Descriptor(torch.nn.Module):
    """SSCD's module layout (`backbone`, `embeddings`) for tracing."""

    def __init__(self, sscd):
        super().__init__()
        self.backbone, self.embeddings = sscd.backbone, sscd.embeddings

    def forward(self, x):
        return bb.sscd_embed(self, x)


def test_memorization_scores_match_jax(tmp_path, resnet):
    rng = np.random.RandomState(18)
    ga, gb = rng.randn(4, 8), rng.randn(4, 8)
    np.testing.assert_array_equal(memorization.similarity_matrix(
        torch.from_numpy(ga), gb), jmem.similarity_matrix(ga, gb))
    assert memorization.memorization_scores(ga, gb) == \
        jmem.memorization_scores(ga, gb)
    # a torchscript SSCD: the tiny trunk, GeM, a projection, L2
    sscd = bb.SSCD(resnet["cfg"], dims=8, device="cpu")
    sd = {f"backbone.{k}": v
          for k, v in ptv.resnet_state_dict(resnet["sd"], resnet["cfg"],
                                            with_fc=False).items()}
    sd["embeddings.weight"] = torch.from_numpy(
        rng.randn(8, 256).astype(np.float32) * 0.1)
    sd["embeddings.bias"] = torch.zeros(8)
    sscd.load_state_dict(sd)

    path = str(tmp_path / "sscd.torchscript.pt")
    torch.jit.trace(_Descriptor(sscd), torch.zeros(1, 3, 64, 64)).save(path)
    x = images(19)
    ref = jmem.load_sscd(path)(x)
    got = memorization.load_sscd(path, device="cpu")(tp.nchw(x))
    assert tp.rel_err(got, ref) < TOL
    want = bb.sscd_embed(sscd, bb.preprocess_imagenet(tp.nchw(x))).numpy()
    assert tp.rel_err(got, want) < TOL
    s = memorization.memorization_scores(got, got)
    np.testing.assert_allclose(s["per_prompt"], 1.0, atol=1e-6)


def test_native_sscd_from_torchscript(tmp_path):
    """`make_native_sscd` reads a full-width SSCD torchscript file (its
    `.state_dict()`) into the ResNet-50 + GeM judge: embeddings unit-norm,
    equal to `sscd_embed` on the same weights, in batches."""
    cfg = bb.ResNetConfig()
    model = bb.SSCD(cfg, dims=512, device="cpu")
    sd = seeded_state(model, np.random.RandomState(20), tracked=False)
    model.load_state_dict(torch_sd(sd))
    path = str(tmp_path / "sscd_full.pt")
    traced = torch.jit.trace(_Descriptor(model), torch.zeros(1, 3, 64, 64))
    traced.save(path)
    x = tp.nchw(images(21, b=3, side=64))
    got = memorization.make_native_sscd(path, batch=2, device="cpu")(x)
    want = bb.sscd_embed(model, bb.preprocess_imagenet(x)).numpy()
    assert got.shape == (3, 512)
    assert tp.rel_err(got, want) < TOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


# ------------------------------------------------------------- text metrics
def test_text_metrics_equal_jax():
    refs = ["a photo of a dog on the grass", "the cat sat on the mat",
            "", "van gogh style painting of a house"]
    hyps = ["a photo of a dog", "the cat sat on a mat today", "anything",
            "a house painted by van gogh"]
    for r, h in zip(refs, hyps):
        assert text_metrics.sentence_bleu(r, h) == jtext.sentence_bleu(r, h)
        assert text_metrics.rouge_l(r, h) == jtext.rouge_l(r, h)
    assert text_metrics.sentence_bleu("a b c", "") == 0.0
    assert text_metrics.corpus_scores(refs, hyps) == jtext.corpus_scores(
        refs, hyps)
    assert text_metrics.corpus_scores([], []) == jtext.corpus_scores([], [])
