"""The FID Inception-v3 (PyTorch port of
`diffusion_models_moe_tpu/models/inception.py`).

The reference computes FID with torchmetrics' InceptionV3 features
(reference: benchmarks/eval_coco.py:16,25-29). This is an NCHW Inception-v3
whose state dict carries torchvision's / torch-fidelity's names
(`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.running_mean`, ...,
`fc`; no aux head), so their files load as they are
(`weights/port_torchvision.py:inception_state_dict`).

`fid_variant=True` (default) reproduces torch-fidelity's FID network deltas
vs stock torchvision: the average pools inside InceptionA/C and Mixed_7b
exclude the zero padding from the divisor (`count_include_pad=False`), and
Mixed_7c's pool branch takes the max. With `fid_variant=False` the graph is
stock torchvision InceptionV3 (eval mode, no aux head).

Inference-only (a frozen judge): batch norm (eps 1e-3) applies its running
statistics, convolutions run in full f32 (no TF32); built on the card
unless the caller asks for another device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.models.backbones import (
    FrozenBatchNorm2d, _to)
from diffusion_models_moe_tpu_torch.models.layers import (f32_convs,
                                                          resize_bilinear)


class BasicConv2d(nn.Module):
    """conv (no bias) -> BN (eps 1e-3) -> relu."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = FrozenBatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3(x: torch.Tensor, exclude_pad: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=not exclude_pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x, exclude_pad: bool):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x),
                          self.branch5x5_2(self.branch5x5_1(x)), b3,
                          self.branch_pool(_avg_pool_3x3(x, exclude_pad))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x, exclude_pad: bool = False):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x, exclude_pad: bool):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool_3x3(x, exclude_pad))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x, exclude_pad: bool = False):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x, pool: str):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if pool == "max":
            bp = F.max_pool2d(x, 3, 1, 1)
        else:
            bp = _avg_pool_3x3(x, exclude_pad=pool == "avg_exclude")
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


@dataclasses.dataclass(frozen=True)
class InceptionConfig:
    fid_variant: bool = True
    num_classes: int = 1008  # torch-fidelity FID weights head (1008 logits)


# (module name, block kind) in forward order
INCEPTION_BLOCKS: Sequence[tuple[str, str]] = (
    ("Mixed_5b", "a"), ("Mixed_5c", "a"), ("Mixed_5d", "a"),
    ("Mixed_6a", "b"),
    ("Mixed_6b", "c"), ("Mixed_6c", "c"), ("Mixed_6d", "c"), ("Mixed_6e", "c"),
    ("Mixed_7a", "d"),
    ("Mixed_7b", "e1"), ("Mixed_7c", "e2"),
)


class InceptionV3(nn.Module):
    """torchvision's Inception3 trunk and `fc` (no aux head)."""

    def __init__(self, cfg: InceptionConfig = InceptionConfig(),
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, cfg.num_classes)
        _to(self, device)

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [-1, 1] -> (B, 2048) pool features."""
        ex = self.cfg.fid_variant
        with f32_convs():
            x = self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(images))
            x = F.max_pool2d(self.Conv2d_2b_3x3(x), 3, 2)
            x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
            for name, kind in INCEPTION_BLOCKS:
                block = getattr(self, name)
                if kind == "e1":
                    x = block(x, "avg_exclude" if ex else "avg")
                elif kind == "e2":    # the FID variant's max-pool branch
                    x = block(x, "max" if ex else "avg")
                else:
                    x = block(x, ex)
        return x.mean(dim=(2, 3))


def inception_pool_features(model: InceptionV3, images: torch.Tensor
                            ) -> torch.Tensor:
    """(B, 3, 299, 299) in [-1, 1] -> (B, 2048) pool features (the FID
    space)."""
    return model(images)


@torch.no_grad()
def inception_logits(model: InceptionV3, images: torch.Tensor
                     ) -> torch.Tensor:
    return model.fc(inception_pool_features(model, images))


def preprocess_fid(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """(B, 3, H, W) float [0, 1] -> bilinear-resized to `size` (antialiased
    where it shrinks, as JAX's resize), scaled to [-1, 1] (torchmetrics FID
    normalize=True semantics)."""
    return resize_bilinear(images, size) * 2.0 - 1.0
