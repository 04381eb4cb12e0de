"""NudeNet / YOLOv8 detector weights into the port's `YOLOv8` state dict
(PyTorch port of `diffusion_models_moe_tpu/weights/port_nudenet.py`).

Two input formats:

* **ONNX** (`port_yolo_from_onnx`): the format NudeNet ships (reference:
  benchmarks/i2p_eval.py:16 uses the nudenet package's bundled
  `320n.onnx`), read by the port's own protobuf reader
  (weights/onnx_reader.py). Initializers named by module path (torch
  exports keep them, `model.0.conv.weight`) go through the state-dict path;
  otherwise the Conv nodes are matched in graph order against
  `models/yolo.py:conv_execution_order`, the DFL conv dropped after a check
  that it holds the arange, each shape validated.
* **torch state dict** (`port_yolo_from_torch`): ultralytics naming, fused
  (`N.conv.weight` + `.bias`) or unfused (a conv without bias and an
  `N.bn.*` BatchNorm, folded here in f64 at ultralytics' eps 1e-3).

The output is `YOLOv8(cfg)`'s state dict, f32, with the DFL arange. The
port's module carries ultralytics' names, so where the JAX porter
transposes OIHW to HWIO this one keeps the layout.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from diffusion_models_moe_tpu_torch.models.yolo import (DETECT_IDX, YoloConfig,
                                                        conv_shapes, dfl_weight)
from diffusion_models_moe_tpu_torch.weights.onnx_reader import read_onnx

_BN_EPS = 1e-3  # ultralytics BatchNorm2d(eps=0.001)
StateDict = dict[str, torch.Tensor]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _fused(name: str, weight, bias: Optional[np.ndarray], shape: tuple
           ) -> StateDict:
    w = np.array(weight, np.float32)        # a copy: ONNX buffers are read-only
    if tuple(w.shape) != tuple(shape):
        raise ValueError(
            f"conv {name}: weight shape {tuple(w.shape)} != expected {shape} "
            "(wrong YoloConfig for this checkpoint?)")
    b = (np.zeros((w.shape[0],), np.float32) if bias is None
         else np.array(bias, np.float32))
    return {f"{name}.weight": torch.from_numpy(w),
            f"{name}.bias": torch.from_numpy(b)}


def _with_dfl(sd: StateDict, cfg: YoloConfig) -> StateDict:
    sd[f"model.{DETECT_IDX}.dfl.conv.weight"] = dfl_weight(cfg.reg_max)
    return sd


def _torch_conv(sd: Mapping, name: str, shape: tuple) -> StateDict:
    """One conv of an ultralytics state dict (keys without the `model.`
    prefix) by the port's prefix `name`: a bare `Conv2d` (Detect's last
    1x1) or a Conv module's `conv`, fused or with its `bn` folded in."""
    if not name.endswith(".conv"):
        key = name[len("model."):]
        return _fused(name, _np(sd[f"{key}.weight"]),
                      _np(sd[f"{key}.bias"]) if f"{key}.bias" in sd else None,
                      shape)
    key = name[len("model."):-len(".conv")]
    w = _np(sd[f"{key}.conv.weight"]).astype(np.float64)
    if f"{key}.bn.weight" in sd:                 # unfused: fold BN in
        gamma = _np(sd[f"{key}.bn.weight"]).astype(np.float64)
        beta = _np(sd[f"{key}.bn.bias"]).astype(np.float64)
        mean = _np(sd[f"{key}.bn.running_mean"]).astype(np.float64)
        var = _np(sd[f"{key}.bn.running_var"]).astype(np.float64)
        scale = gamma / np.sqrt(var + _BN_EPS)
        return _fused(name, w * scale[:, None, None, None],
                      beta - mean * scale, shape)
    return _fused(name, w, _np(sd[f"{key}.conv.bias"])
                  if f"{key}.conv.bias" in sd else None, shape)


def port_yolo_from_torch(sd: Mapping, cfg: YoloConfig,
                         prefix: str = "model.") -> StateDict:
    """Ultralytics-style state dict (tensors or arrays) -> `YOLOv8(cfg)`'s
    state dict; shapes validated against the config."""
    sd = {k[len(prefix):] if k.startswith(prefix) else k: v
          for k, v in sd.items()}
    out: StateDict = {}
    for name, shape in conv_shapes(cfg).items():
        out.update(_torch_conv(sd, name, shape))
    return _with_dfl(out, cfg)


def port_yolo_from_onnx(data: bytes | str, cfg: YoloConfig) -> StateDict:
    """NudeNet / ultralytics ONNX export (bytes or a path) -> `YOLOv8(cfg)`'s
    state dict: module-path initializer names first, else the structural
    graph-order match."""
    graph = read_onnx(data)
    by_name = graph.initializers
    if "model.0.conv.weight" in by_name or "0.conv.weight" in by_name:
        prefix = "model." if "model.0.conv.weight" in by_name else ""
        return port_yolo_from_torch(by_name, cfg, prefix=prefix)
    return _port_structural(graph, cfg)


def _port_structural(graph, cfg: YoloConfig) -> StateDict:
    shapes = conv_shapes(cfg)
    kept = []
    # the DFL conv (the frozen arange over reg_max bins), wherever the export
    # placed it
    for w, b in graph.conv_weights_in_order():
        if w.shape == (1, cfg.reg_max, 1, 1):
            if not np.allclose(np.asarray(w, np.float32),
                               dfl_weight(cfg.reg_max).numpy()):
                raise ValueError(
                    "found a (1, reg_max, 1, 1) Conv that is not the DFL "
                    "arange: the graph does not look like a YOLOv8 export")
            continue
        kept.append((w, b))
    if len(kept) != len(shapes):
        raise ValueError(
            f"graph has {len(kept)} Conv nodes (after DFL removal) but the "
            f"config expects {len(shapes)}: wrong YoloConfig or not YOLOv8?")
    out: StateDict = {}
    for (name, shape), (w, b) in zip(shapes.items(), kept):
        out.update(_fused(name, w, b, shape))
    return _with_dfl(out, cfg)
