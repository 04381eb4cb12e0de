"""YOLOv8 detector as an `nn.Module`: the NudeNet judge's architecture
(PyTorch port).

Counterpart of `diffusion_models_moe_tpu/models/yolo.py`. The reference's
I2P nudity protocol delegates detection to the NudeNet package (reference:
benchmarks/i2p_eval.py:16,238-248, modularity/nudity_score.py:14), whose v3
detector is a YOLOv8n exported to ONNX at 320x320. Here it is that
architecture in NCHW and f32, with cuDNN's TF32 off for its convolutions
(`layers.f32_convs`), as the other judges run; like the JAX version it is
XLA-level work in the reference (convolutions, no Pallas kernel), so it
stays torch here.

The module keeps ultralytics' names: `model.{i}` for the 23 layers of the
YOLOv8 topology, `.conv` for each fused conv (BatchNorm folded into its
bias), `cv1`/`cv2`/`m.{j}` inside C2f and SPPF, and the Detect head at
`model.22` with its `cv2` (box) and `cv3` (class) branches, whose last 1x1
conv is a bare `Conv2d`, and its frozen DFL conv `model.22.dfl.conv`
(the arange over the `reg_max` bins). A fused ultralytics state dict
therefore loads straight in; `weights/port_nudenet.py` makes one from the
ONNX file or an unfused checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusion_models_moe_tpu_torch.config import resolve_device
from diffusion_models_moe_tpu_torch.models.layers import f32_convs

DETECT_IDX = 22     # the Detect head's index in the 23-layer topology


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    """YOLOv8 geometry. Defaults are the 'n' scale at NudeNet's operating
    point: width 0.25 -> stage channels (16,32,64,128,256), depth 0.33 ->
    C2f repeats (1,2,2,1), 18 classes, reg_max=16 DFL bins, 320px input."""
    nc: int = 18
    reg_max: int = 16
    channels: Sequence[int] = (16, 32, 64, 128, 256)   # P1..P5 stage widths
    depths: Sequence[int] = (1, 2, 2, 1)               # backbone C2f repeats
    head_depth: int = 1                                 # head C2f repeats
    imgsz: int = 320

    @property
    def strides(self) -> tuple[int, int, int]:
        return (8, 16, 32)

    @property
    def detect_channels(self) -> tuple[int, int, int]:
        """Per-scale input widths of the Detect head (P3, P4, P5)."""
        c = self.channels
        return (c[2], c[3], c[4])

    @property
    def box_width(self) -> int:
        """Hidden width of the Detect box branch (ultralytics c2)."""
        return max(16, self.detect_channels[0] // 4, self.reg_max * 4)

    @property
    def cls_width(self) -> int:
        """Hidden width of the Detect class branch (ultralytics c3)."""
        return max(self.detect_channels[0], min(self.nc, 100))

    @property
    def num_anchors(self) -> int:
        return sum((self.imgsz // s) ** 2 for s in self.strides)


def yolov8n_config(nc: int = 18, imgsz: int = 320) -> YoloConfig:
    return YoloConfig(nc=nc, imgsz=imgsz)


def tiny_yolo_config(nc: int = 3, imgsz: int = 64) -> YoloConfig:
    """Small enough for CPU parity tests; same topology."""
    return YoloConfig(nc=nc, reg_max=4, channels=(4, 8, 8, 16, 16),
                      depths=(1, 1, 1, 1), imgsz=imgsz)


# ------------------------------------------------------------------- modules
class Conv(nn.Module):
    """Fused Conv(+SiLU) with torch's symmetric k//2 padding (ultralytics
    autopad)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv(x))


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool):
        super().__init__()
        self.cv1 = Conv(c, c, 3)
        self.cv2 = Conv(c, c, 3)
        self.add = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, c1: int, c2: int, n: int, shortcut: bool):
        super().__init__()
        h = c2 // 2
        self.cv1 = Conv(c1, 2 * h, 1)
        self.cv2 = Conv((2 + n) * h, c2, 1)
        self.m = nn.ModuleList(Bottleneck(h, shortcut) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = list(self.cv1(x).chunk(2, 1))      # (a, b): b feeds m.0
        for m in self.m:
            chunks.append(m(chunks[-1]))
        return self.cv2(torch.cat(chunks, 1))


class SPPF(nn.Module):
    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        self.cv1 = Conv(c1, c1 // 2, 1)
        self.cv2 = Conv(c1 * 2, c2, 1)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.cv1(x)]
        for _ in range(3):          # max-pool pads with -inf (SAME, stride 1)
            pools.append(F.max_pool2d(pools[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(pools, 1))


class Upsample2(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2, mode="nearest")


class DFL(nn.Module):
    """The frozen distribution-focal decode: its 1x1 conv holds the arange
    over the bins."""

    def __init__(self, reg_max: int):
        super().__init__()
        self.conv = nn.Conv2d(reg_max, 1, 1, bias=False).requires_grad_(False)
        with torch.no_grad():
            self.conv.weight.copy_(dfl_weight(reg_max))

    def forward(self, box: torch.Tensor) -> torch.Tensor:
        """(B, A, 4 * reg_max) -> (B, A, 4): each side's expected distance,
        softmax-weighted over the bins."""
        b, a, _ = box.shape
        n = self.conv.weight.shape[1]
        probs = torch.softmax(box.view(b, a, 4, n).float(), dim=-1)
        return probs @ self.conv.weight.view(n).float()


class Detect(nn.Module):
    def __init__(self, cfg: YoloConfig):
        super().__init__()
        bw, cw = cfg.box_width, cfg.cls_width
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(c, bw, 3), Conv(bw, bw, 3),
                          nn.Conv2d(bw, 4 * cfg.reg_max, 1))
            for c in cfg.detect_channels)
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(c, cw, 3), Conv(cw, cw, 3),
                          nn.Conv2d(cw, cfg.nc, 1))
            for c in cfg.detect_channels)
        self.dfl = DFL(cfg.reg_max)


class YOLOv8(nn.Module):
    """images (B, 3, H, W) in [0, 1] at `cfg.imgsz` -> (boxes (B, A, 4) as
    centre-x, centre-y, w, h in input pixels, class probabilities (B, A, nc)
    sigmoid scores), A = cfg.num_anchors: the ONNX model's (B, 4 + nc, A)
    output split and transposed (the JAX package's `yolo_detect`).

    Built on `device` (the card unless the caller asks for another) with
    torch's default initialisation: load a state dict
    (`weights/port_nudenet.py`)."""

    def __init__(self, cfg: YoloConfig = YoloConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        c, d, hd = list(cfg.channels), list(cfg.depths), cfg.head_depth
        self.model = nn.ModuleList([
            Conv(3, c[0], 3, 2),                        # 0  P1/2
            Conv(c[0], c[1], 3, 2),                     # 1  P2/4
            C2f(c[1], c[1], d[0], True),                # 2
            Conv(c[1], c[2], 3, 2),                     # 3  P3/8
            C2f(c[2], c[2], d[1], True),                # 4
            Conv(c[2], c[3], 3, 2),                     # 5  P4/16
            C2f(c[3], c[3], d[2], True),                # 6
            Conv(c[3], c[4], 3, 2),                     # 7  P5/32
            C2f(c[4], c[4], d[3], True),                # 8
            SPPF(c[4], c[4]),                           # 9
            Upsample2(),                                # 10
            nn.Identity(),                              # 11 concat
            C2f(c[3] + c[4], c[3], hd, False),          # 12
            Upsample2(),                                # 13
            nn.Identity(),                              # 14 concat
            C2f(c[2] + c[3], c[2], hd, False),          # 15
            Conv(c[2], c[2], 3, 2),                     # 16
            nn.Identity(),                              # 17 concat
            C2f(c[2] + c[3], c[3], hd, False),          # 18
            Conv(c[3], c[3], 3, 2),                     # 19
            nn.Identity(),                              # 20 concat
            C2f(c[3] + c[4], c[4], hd, False),          # 21
            Detect(cfg),                                # 22
        ])
        self.to(resolve_device(device)).eval()

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Backbone + FPN/PAN neck: the three Detect inputs (P3, P4, P5)."""
        m = self.model
        x = m[2](m[1](m[0](x)))
        p3 = x = m[4](m[3](x))
        p4 = x = m[6](m[5](x))
        p5 = x = m[9](m[8](m[7](x)))
        n4 = x = m[12](torch.cat([m[10](x), p4], 1))      # top-down
        o3 = x = m[15](torch.cat([m[13](x), p3], 1))
        o4 = x = m[18](torch.cat([m[16](x), n4], 1))      # bottom-up
        o5 = m[21](torch.cat([m[19](x), p5], 1))
        return [o3, o4, o5]

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
        cfg, det = self.cfg, self.model[DETECT_IDX]
        with f32_convs():
            feats = self.features(images.float())
            box = torch.cat([det.cv2[i](f).flatten(2) for i, f in
                             enumerate(feats)], 2).transpose(1, 2)
            cls = torch.cat([det.cv3[i](f).flatten(2) for i, f in
                             enumerate(feats)], 2).transpose(1, 2)
        anchors, strides = make_anchors(cfg, images.device)
        dist = det.dfl(box)                             # (B, A, 4) ltrb
        x1y1 = anchors[None] - dist[..., :2]
        x2y2 = anchors[None] + dist[..., 2:]
        boxes = torch.cat([(x1y1 + x2y2) / 2.0, x2y2 - x1y1], dim=-1)
        return boxes * strides[None, :, None], torch.sigmoid(cls.float())


def make_anchors(cfg: YoloConfig, device=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Grid-cell centres (+0.5, grid units) and per-anchor strides of the
    three scales, concatenated in scale order: the ultralytics
    make_anchors layout (row-major per grid)."""
    points, strides = [], []
    for s in cfg.strides:
        n = cfg.imgsz // s
        xs = torch.arange(n, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(xs, xs, indexing="ij")
        points.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        strides.append(torch.full((n * n,), float(s), device=device))
    return torch.cat(points), torch.cat(strides)


# ----------------------------------------------------------- conv inventory
def conv_execution_order(cfg: YoloConfig) -> list[str]:
    """The state-dict prefix of every conv in forward-execution order: the
    order conv nodes appear in a torch-exported ONNX graph of this model
    (the structural ONNX porter zips them). The export's trailing DFL conv
    is not listed: its weight is the frozen arange."""
    return list(conv_shapes(cfg))


def conv_shapes(cfg: YoloConfig) -> dict[str, tuple[int, int, int, int]]:
    """(cout, cin, kh, kw) of each conv by its state-dict prefix, in
    forward-execution order (Detect's in its forward order: per scale, the
    box branch, then the class branch)."""
    c = list(cfg.channels)
    shapes: dict[str, tuple[int, int, int, int]] = {}

    def conv(name: str, k: int, cin: int, cout: int) -> None:
        shapes[name] = (cout, cin, k, k)

    def c2f(idx: int, cin: int, cout: int, n: int) -> None:
        h = cout // 2
        conv(f"model.{idx}.cv1.conv", 1, cin, 2 * h)
        for j in range(n):
            conv(f"model.{idx}.m.{j}.cv1.conv", 3, h, h)
            conv(f"model.{idx}.m.{j}.cv2.conv", 3, h, h)
        conv(f"model.{idx}.cv2.conv", 1, (2 + n) * h, cout)

    d, hd = cfg.depths, cfg.head_depth
    conv("model.0.conv", 3, 3, c[0])
    conv("model.1.conv", 3, c[0], c[1])
    c2f(2, c[1], c[1], d[0])
    conv("model.3.conv", 3, c[1], c[2])
    c2f(4, c[2], c[2], d[1])
    conv("model.5.conv", 3, c[2], c[3])
    c2f(6, c[3], c[3], d[2])
    conv("model.7.conv", 3, c[3], c[4])
    c2f(8, c[4], c[4], d[3])
    conv("model.9.cv1.conv", 1, c[4], c[4] // 2)
    conv("model.9.cv2.conv", 1, c[4] * 2, c[4])
    c2f(12, c[3] + c[4], c[3], hd)
    c2f(15, c[2] + c[3], c[2], hd)
    conv("model.16.conv", 3, c[2], c[2])
    c2f(18, c[2] + c[3], c[3], hd)
    conv("model.19.conv", 3, c[3], c[3])
    c2f(21, c[3] + c[4], c[4], hd)
    dch, bw, cw = cfg.detect_channels, cfg.box_width, cfg.cls_width
    for i in range(3):
        pre = f"model.{DETECT_IDX}"
        conv(f"{pre}.cv2.{i}.0.conv", 3, dch[i], bw)
        conv(f"{pre}.cv2.{i}.1.conv", 3, bw, bw)
        conv(f"{pre}.cv2.{i}.2", 1, bw, 4 * cfg.reg_max)
        conv(f"{pre}.cv3.{i}.0.conv", 3, dch[i], cw)
        conv(f"{pre}.cv3.{i}.1.conv", 3, cw, cw)
        conv(f"{pre}.cv3.{i}.2", 1, cw, cfg.nc)
    return shapes


def dfl_weight(reg_max: int) -> torch.Tensor:
    """The frozen DFL conv's weight (1, reg_max, 1, 1): the arange."""
    return torch.arange(reg_max, dtype=torch.float32).view(1, reg_max, 1, 1)
