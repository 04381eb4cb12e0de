"""Judge backbones (PyTorch port): ResNet-50 classifier and SSCD trunk,
AlexNet features, LPIPS.

Counterpart of `diffusion_models_moe_tpu/models/backbones.py`. The reference
delegates three judge roles to torch libraries: ResNet-50 top-k
classification of erased-object images (reference:
benchmarks/object_erase.py:77-100), SSCD copy-detection embeddings — a
ResNet-50 trunk with GeM pooling + projection (reference:
benchmarks/inference_mem.py:46-68) — and LPIPS perceptual distance —
AlexNet features + learned linear heads (reference:
benchmarks/calculate_scores.py:10,70-79).

Here they are `nn.Module`s in NCHW whose state dicts carry torchvision's
names (`weights/port_torchvision.py` maps SSCD's and lpips' files onto them),
built on the card unless the caller asks for another device. They are
inference-only judges: batch norm applies its running statistics
(`FrozenBatchNorm2d`, no `num_batches_tracked`), there is no dropout, and
convolutions run in full f32 (`layers.f32_convs`: no TF32). The functions
`resnet_features`, `resnet_logits`, `sscd_embed`, `alexnet_features` and
`lpips_distance` take the module where the JAX functions take params.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.config import resolve_device
from diffusion_models_moe_tpu_torch.models.layers import f32_convs

# torchvision ImageNet preprocessing (object_erase / SSCD protocols)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class FrozenBatchNorm2d(nn.Module):
    """Inference batch norm on ported running statistics, computed as the
    JAX package's `_bn`: x * (w / sqrt(var + eps)) + (b - mean * that)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(name, torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


def _to(module: nn.Module, device) -> nn.Module:
    return module.to(resolve_device(device)).eval()


# --------------------------------------------------------------------- ResNet
@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """Bottleneck ResNet geometry (torchvision layout). resnet50 is the
    reference's judge; tiny configs keep parity tests cheap."""
    stage_blocks: Sequence[int] = (3, 4, 6, 3)
    stem_width: int = 64
    num_classes: int = 1000
    expansion: int = 4


def resnet50_config(num_classes: int = 1000) -> ResNetConfig:
    return ResNetConfig(num_classes=num_classes)


def tiny_resnet_config(num_classes: int = 7) -> ResNetConfig:
    return ResNetConfig(stage_blocks=(1, 1, 1, 1), stem_width=8,
                        num_classes=num_classes)


class Bottleneck(nn.Module):
    """torchvision's v1.5 bottleneck: the stride on the 3x3 conv."""

    def __init__(self, cin: int, width: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 1, stride,
                                                   bias=False),
                                         FrozenBatchNorm2d(cout))
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


class ResNet(nn.Module):
    """torchvision's bottleneck ResNet without its average pool: `conv1`,
    `bn1`, `layer1`-`layer4`, and `fc` where `with_fc` (the SSCD trunk has
    none)."""

    def __init__(self, cfg: ResNetConfig = ResNetConfig(), with_fc: bool = True,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        w = cfg.stem_width
        self.conv1 = nn.Conv2d(3, w, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(w)
        cin = w
        for si, n_blocks in enumerate(cfg.stage_blocks):
            width = w * 2 ** si
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(Bottleneck(cin, width, width * cfg.expansion,
                                         stride))
                cin = width * cfg.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.out_channels = cin
        self.fc = nn.Linear(cin, cfg.num_classes) if with_fc else None
        _to(self, device)

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) normalized images -> (B, C, h, w) trunk features."""
        with f32_convs():
            x = F.relu(self.bn1(self.conv1(images)))
            x = F.max_pool2d(x, 3, 2, 1)
            for si in range(len(self.cfg.stage_blocks)):
                x = getattr(self, f"layer{si + 1}")(x)
        return x


def resnet_features(model: ResNet, images: torch.Tensor) -> torch.Tensor:
    """Trunk forward: (B, 3, H, W) normalized images -> (B, C, h, w)
    features before pooling (the SSCD trunk output; GeM attaches here)."""
    return model(images)


@torch.no_grad()
def resnet_logits(model: ResNet, images: torch.Tensor) -> torch.Tensor:
    """Classifier forward: global average pool + fc (torchvision semantics)."""
    pooled = resnet_features(model, images).mean(dim=(2, 3))
    return model.fc(pooled)


def preprocess_imagenet(images: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype,
                        device=images.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype,
                       device=images.device).view(1, 3, 1, 1)
    return (images - mean) / std


def gem_pool(feats: torch.Tensor, p: float = 3.0, eps: float = 1e-6
             ) -> torch.Tensor:
    """Generalized-mean pooling (SSCD's head): (B, C, h, w) -> (B, C)."""
    x = feats.float().clamp_min(eps) ** p
    return x.mean(dim=(2, 3)) ** (1.0 / p)


class SSCD(nn.Module):
    """SSCD copy-detection descriptor: a ResNet trunk (`backbone.*`, no fc)
    and its projection (`embeddings`, weight and bias)."""

    def __init__(self, cfg: ResNetConfig = ResNetConfig(), dims: int = 512,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet(cfg, with_fc=False, device="cpu")
        self.embeddings = nn.Linear(self.backbone.out_channels, dims)
        _to(self, device)


@torch.no_grad()
def sscd_embed(model: SSCD, images: torch.Tensor, p: float = 3.0
               ) -> torch.Tensor:
    """SSCD copy-detection embedding: ResNet trunk -> GeM(p=3) -> linear
    projection -> L2 normalize (reference judge: benchmarks/inference_mem.py:46-68;
    SSCD = "A Self-Supervised Descriptor for Image Copy Detection")."""
    emb = model.embeddings(gem_pool(resnet_features(model.backbone, images),
                                    p=p))
    return emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-12)


# -------------------------------------------------------------------- AlexNet
@dataclasses.dataclass(frozen=True)
class AlexNetConfig:
    """torchvision AlexNet feature-extractor geometry (LPIPS 'alex' backbone).
    channels/kernels/strides/pads per conv stage; pools follow stages 0, 1, 4."""
    channels: Sequence[int] = (64, 192, 384, 256, 256)
    kernels: Sequence[int] = (11, 5, 3, 3, 3)
    strides: Sequence[int] = (4, 1, 1, 1, 1)
    pads: Sequence[int] = (2, 2, 1, 1, 1)


def tiny_alexnet_config() -> AlexNetConfig:
    return AlexNetConfig(channels=(4, 6, 8, 8, 8))


_ALEX_POOL_AFTER = (0, 1, 4)
# torchvision AlexNet `features` indices of the 5 convs
ALEX_FEATURE_IDX = (0, 3, 6, 8, 10)


class AlexNet(nn.Module):
    """torchvision AlexNet's `features` Sequential (convs at indices 0, 3,
    6, 8 and 10, ReLUs and max pools between)."""

    def __init__(self, cfg: AlexNetConfig = AlexNetConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        layers: list[nn.Module] = []
        cin = 3
        for i, c in enumerate(cfg.channels):
            layers += [nn.Conv2d(cin, c, cfg.kernels[i], cfg.strides[i],
                                 cfg.pads[i]), nn.ReLU()]
            if i in _ALEX_POOL_AFTER:
                layers.append(nn.MaxPool2d(3, 2))
            cin = c
        self.features = nn.Sequential(*layers)
        _to(self, device)


@torch.no_grad()
def alexnet_features(model: AlexNet, images: torch.Tensor
                     ) -> list[torch.Tensor]:
    """The 5 post-ReLU stage outputs (the LPIPS feature taps)."""
    taps = []
    x = images
    with f32_convs():
        for layer in model.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                taps.append(x)
    return taps


# ---------------------------------------------------------------------- LPIPS
# LPIPS input scaling layer constants (Zhang et al. 2018 reference impl).
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """LPIPS 'alex': the AlexNet features (`net.features.*`) and one learned
    per-channel weight vector a tap (`lins.{i}`, (C,))."""

    def __init__(self, cfg: AlexNetConfig = AlexNetConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.net = AlexNet(cfg, device="cpu")
        self.lins = nn.ParameterList(nn.Parameter(torch.zeros(c))
                                     for c in cfg.channels)
        _to(self, device)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = x.float().pow(2).sum(dim=1, keepdim=True).sqrt()
    return x / norm.clamp_min(eps).to(x.dtype)


@torch.no_grad()
def lpips_distance(model: LPIPS, img_a: torch.Tensor, img_b: torch.Tensor
                   ) -> torch.Tensor:
    """LPIPS(a, b) for (B, 3, H, W) images in [-1, 1].

    Per tap: channel-unit-normalize both activations, squared difference,
    weight by the learned per-channel head, spatial mean, sum over taps."""
    shift = torch.tensor(LPIPS_SHIFT, dtype=img_a.dtype,
                         device=img_a.device).view(1, 3, 1, 1)
    scale = torch.tensor(LPIPS_SCALE, dtype=img_a.dtype,
                         device=img_a.device).view(1, 3, 1, 1)
    fa = alexnet_features(model.net, (img_a - shift) / scale)
    fb = alexnet_features(model.net, (img_b - shift) / scale)
    total = torch.zeros(img_a.shape[0], dtype=torch.float32,
                        device=img_a.device)
    for w, a, b in zip(model.lins, fa, fb):
        diff = (_unit_normalize(a) - _unit_normalize(b)).float() ** 2
        total = total + (diff * w.float()[:, None, None]).sum(dim=1).mean(
            dim=(1, 2))
    return total


def make_lpips_fn(model: LPIPS):
    """(B, 3, H, W) float [0, 1] pairs -> (B,) LPIPS as numpy, on the
    model's device. Plugs into `benchmarks.scores.perceptual_between_dirs`."""
    dev = model.lins[0].device

    def dist(a, b) -> np.ndarray:
        a = torch.as_tensor(a, dtype=torch.float32).to(dev) * 2.0 - 1.0
        b = torch.as_tensor(b, dtype=torch.float32).to(dev) * 2.0 - 1.0
        return lpips_distance(model, a, b).cpu().numpy()

    dist.metric_name = "lpips_alex_native"
    return dist
