"""The port's NudeNet judge against the JAX package's, on the CPU: the ONNX
reader, the YOLOv8 forward and its decode, the three porter paths (module
names in an ONNX file, the structural graph-order match, an unfused
BatchNorm state dict), `letterbox`, `nms`, the native detector and
`load_nudenet_native`.

Weights are seeded numpy in ultralytics' unfused layout (conv + BatchNorm at
eps 1e-3) at `tiny_yolo_config`; both porters fold them, and the bridge's
JAX-params -> state-dict direction gives the JAX tree back as the port's
state dict bit for bit. Tolerance: max |port - JAX| / max |JAX| <= 1e-5 on
the forward, boxes and probabilities; detections equal in labels, scores
within 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from diffusion_models_moe_tpu.benchmarks import nudity as jnud
from diffusion_models_moe_tpu.models import yolo as jyolo
from diffusion_models_moe_tpu.weights import onnx_reader as jonnx
from diffusion_models_moe_tpu.weights import port_nudenet as jport
from diffusion_models_moe_tpu_torch.benchmarks import nudity
from diffusion_models_moe_tpu_torch.models import yolo
from diffusion_models_moe_tpu_torch.weights import bridge, onnx_reader
from diffusion_models_moe_tpu_torch.weights import port_nudenet

TOL = 1e-5
LABELS = ["FEMALE_BREAST_EXPOSED", "FEET_EXPOSED", "FACE_MALE"]


# ------------------------------------------------ a small ONNX wire writer
def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _ld(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _tensor_pb(name: str, arr: np.ndarray, form: str = "raw") -> bytes:
    """TensorProto with its data as raw_data, float_data (packed f32) or
    int64_data (packed varints)."""
    out = _ld(1, b"".join(_varint(d) for d in arr.shape))
    code = {"raw": 1, "float": 1, "int64": 7}[form]
    out += _varint(2 << 3) + _varint(code) + _ld(8, name.encode())
    if form == "raw":
        out += _ld(9, np.ascontiguousarray(arr, "<f4").tobytes())
    elif form == "float":
        out += _ld(4, np.ascontiguousarray(arr, "<f4").tobytes())
    else:
        out += _ld(7, b"".join(_varint(int(v) & (2 ** 64 - 1))
                               for v in arr.reshape(-1)))
    return out


def _node_pb(op: str, inputs, outputs, name: str = "") -> bytes:
    out = b"".join(_ld(1, i.encode()) for i in inputs)
    out += b"".join(_ld(2, o.encode()) for o in outputs)
    if name:
        out += _ld(3, name.encode())
    return out + _ld(4, op.encode())


def _model_pb(nodes, tensors) -> bytes:
    graph = b"".join(_ld(1, n) for n in nodes)
    graph += b"".join(_ld(5, t) for t in tensors)
    return _varint(1 << 3) + _varint(8) + _ld(7, graph)


def fused_onnx(sd: dict, cfg, mangled: bool) -> bytes:
    """A fused export of the port's state dict: Conv nodes in execution
    order, initializers under their module names or under mangled names
    (then with the DFL conv as the last node, as a real export has it)."""
    nodes, tensors = [], []
    for i, name in enumerate(yolo.conv_execution_order(cfg)):
        w_name, b_name = ((f"oc_{i}_w", f"oc_{i}_b") if mangled
                          else (f"{name}.weight", f"{name}.bias"))
        nodes.append(_node_pb("Conv", [f"t{i}", w_name, b_name],
                              [f"t{i + 1}"]))
        tensors += [_tensor_pb(w_name, sd[f"{name}.weight"].numpy()),
                    _tensor_pb(b_name, sd[f"{name}.bias"].numpy(),
                               "float" if i % 2 else "raw")]
    if mangled:
        nodes.append(_node_pb("Conv", ["tb", "dfl_w"], ["td"]))
        tensors.append(_tensor_pb("dfl_w", yolo.dfl_weight(cfg.reg_max).numpy()))
    return _model_pb(nodes, tensors)


def unfused_state(cfg, seed: int = 0) -> dict:
    """Seeded ultralytics-style unfused state dict (`model.` keys): conv
    weights N(0, 2/fan_in), BatchNorm statistics and affines off identity,
    Detect's bare 1x1 convs with biases."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, (cout, cin, k, _) in yolo.conv_shapes(cfg).items():
        w = (rng.randn(cout, cin, k, k) * (2.0 / (cin * k * k)) ** 0.5
             ).astype(np.float32)
        if name.endswith(".conv"):
            m = name[:-len(".conv")]
            sd[f"{m}.conv.weight"] = w
            sd[f"{m}.bn.weight"] = rng.uniform(0.8, 1.2, cout).astype(np.float32)
            sd[f"{m}.bn.bias"] = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
            sd[f"{m}.bn.running_mean"] = rng.uniform(-0.2, 0.2, cout).astype(
                np.float32)
            sd[f"{m}.bn.running_var"] = rng.uniform(0.5, 1.5, cout).astype(
                np.float32)
        else:
            sd[f"{name}.weight"] = w
            sd[f"{name}.bias"] = (0.1 * rng.randn(cout)).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX params, the port's YOLOv8 on the CPU), same weights."""
    cfg, jcfg_ = yolo.tiny_yolo_config(), jyolo.tiny_yolo_config()
    raw = unfused_state(cfg)
    params = jport.port_yolo_from_torch(raw, jcfg_, prefix="model.")
    sd = port_nudenet.port_yolo_from_torch(
        {k: torch.from_numpy(v) for k, v in raw.items()}, cfg)
    back = bridge.yolo_numpy_state_dict(params)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    model = yolo.YOLOv8(cfg, device="cpu")
    model.load_state_dict(sd)
    return cfg, jcfg_, params, model, raw


def test_onnx_reader_equals_jax():
    """Raw, float_data and int64_data initializers and the node list read
    the same as by JAX's reader."""
    rng = np.random.RandomState(0)
    w1 = rng.randn(4, 3, 3, 3).astype(np.float32)
    b1 = rng.randn(4).astype(np.float32)
    w2 = rng.randn(2, 4, 1, 1).astype(np.float32)
    shape = np.asarray([1, -2, 3], np.int64)
    data = _model_pb(
        [_node_pb("Conv", ["x", "w1", "b1"], ["h"], "conv1"),
         _node_pb("Sigmoid", ["h"], ["hs"]),
         _node_pb("Reshape", ["hs", "shape"], ["r"]),
         _node_pb("Conv", ["r", "w2"], ["y"], "conv2")],
        [_tensor_pb("w1", w1), _tensor_pb("b1", b1, "float"),
         _tensor_pb("w2", w2), _tensor_pb("shape", shape, "int64")])
    ours, ref = onnx_reader.read_onnx(data), jonnx.read_onnx(data)
    assert ours.initializers.keys() == ref.initializers.keys()
    for k, v in ref.initializers.items():
        assert ours.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(ours.initializers[k], v, err_msg=k)
    np.testing.assert_array_equal(ours.initializers["shape"], shape)
    assert [(n.op_type, n.inputs, n.outputs, n.name) for n in ours.nodes] == \
        [(n.op_type, n.inputs, n.outputs, n.name) for n in ref.nodes]
    convs, jconvs = ours.conv_weights_in_order(), ref.conv_weights_in_order()
    assert len(convs) == len(jconvs) == 2 and convs[1][1] is None
    for (w, b), (jw, jb) in zip(convs, jconvs):
        np.testing.assert_array_equal(w, jw)
        assert (b is None) == (jb is None)


def test_yolo_forward_matches_jax(pair):
    """The neck's three outputs, the decoded xywh boxes and the class
    probabilities on the same images, within TOL of max |JAX|."""
    cfg, jcfg_, params, model, _ = pair
    x = np.random.RandomState(1).rand(2, cfg.imgsz, cfg.imgsz, 3).astype(
        np.float32)
    feats = jyolo.yolo_features(params, jnp.asarray(x), jcfg_)
    boxes, probs = jax.device_get(jyolo.yolo_detect(params, jnp.asarray(x),
                                                    jcfg_))
    with torch.no_grad():
        ours = model.features(tp.nchw(x))
    for f, o in zip(feats, ours):
        assert tp.rel_err(tp.nhwc(o), np.asarray(f)) <= TOL
    got_boxes, got_probs = model(tp.nchw(x))
    assert got_boxes.shape == (2, cfg.num_anchors, 4)
    assert tp.rel_err(got_boxes.numpy(), boxes) <= TOL
    assert tp.rel_err(got_probs.numpy(), probs) <= TOL
    anchors, strides = yolo.make_anchors(cfg)
    janchors, jstrides = jyolo.make_anchors(jcfg_)
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(janchors))
    np.testing.assert_array_equal(strides.numpy(), np.asarray(jstrides))


@pytest.mark.parametrize("path", ["names", "structural", "unfused"])
def test_porter_paths_match_jax(pair, path):
    """Each porter path of the port gives the bridge of JAX's tree for the
    same file: module-named fused initializers, mangled names matched in
    graph order (the DFL conv dropped), and the unfused state dict."""
    cfg, jcfg_, params, model, raw = pair
    sd = model.state_dict()
    if path == "unfused":
        ours = port_nudenet.port_yolo_from_torch(raw, cfg)
        ref = params
    else:
        data = fused_onnx(sd, cfg, mangled=path == "structural")
        ours = port_nudenet.port_yolo_from_onnx(data, cfg)
        ref = jport.port_yolo_from_onnx(data, jcfg_)
    back = bridge.yolo_numpy_state_dict(jax.device_get(ref))
    assert ours.keys() == back.keys() == sd.keys()
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), back[k], err_msg=k)
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


def test_structural_port_refuses_a_wrong_graph(pair):
    cfg = pair[0]
    sd = pair[3].state_dict()
    data = fused_onnx(sd, cfg, mangled=True)
    small = yolo.YoloConfig(nc=3, reg_max=4, channels=(4, 8, 8, 16, 16),
                            depths=(1, 2, 1, 1), imgsz=64)
    with pytest.raises(ValueError, match="Conv nodes"):
        port_nudenet.port_yolo_from_onnx(data, small)


def test_letterbox_and_nms_equal_jax():
    rng = np.random.RandomState(2)
    for shape in ((100, 200, 3), (37, 21, 3), (64, 64, 3)):
        img = (rng.rand(*shape) * 255).astype(np.uint8)
        canvas, scale, pad = nudity.letterbox(img, 64)
        jcanvas, jscale, jpad = jnud.letterbox(img, 64)
        np.testing.assert_array_equal(canvas, jcanvas)
        assert (scale, pad) == (jscale, jpad)
    boxes = rng.rand(40, 2) * 50
    boxes = np.concatenate([boxes, boxes + rng.rand(40, 2) * 30 + 1], 1)
    scores = rng.rand(40).astype(np.float32)
    for iou in (0.1, 0.45, 0.9):
        assert nudity.nms(boxes, scores, iou) == jnud.nms(boxes, scores, iou)


def _images():
    rng = np.random.RandomState(3)
    return [(rng.rand(48, 80, 3) * 255).astype(np.uint8),
            np.full((64, 64, 3), 255, np.uint8),
            (rng.rand(100, 30, 3) * 255).astype(np.uint8)]


def _same_detections(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert [d["class"] for d in a] == [d["class"] for d in b]
        for da, db in zip(a, b):
            assert abs(da["score"] - db["score"]) <= TOL
            np.testing.assert_allclose(da["box"], db["box"], rtol=0,
                                       atol=1e-3)


def test_native_detector_matches_jax(pair):
    """Detections at a low confidence threshold (many boxes through NMS)
    over 3 images in chunks of 2: the same labels in the same order, scores
    within TOL, boxes in original pixels."""
    cfg, jcfg_, params, model, _ = pair
    kw = dict(labels=LABELS, batch_size=2, conf_threshold=0.3)
    det = nudity.make_native_detector(model, **kw)
    jdet = jnud.make_native_detector(params, jcfg_, **kw)
    imgs = _images()
    full, jfull = det.full(imgs), jdet.full(imgs)
    assert sum(len(d) for d in full) > 3
    _same_detections(full, jfull)
    assert det(imgs) == [[(d["class"], d["score"]) for d in dets]
                         for dets in full]
    report = nudity.count_harmful(det(imgs), threshold=0.4)
    assert report == jnud.count_harmful(jdet(imgs), threshold=0.4)


def test_load_nudenet_native_matches_jax(pair, tmp_path):
    cfg, jcfg_, params, model, _ = pair
    path = os.path.join(tmp_path, "320n.onnx")
    with open(path, "wb") as f:
        f.write(fused_onnx(model.state_dict(), cfg, mangled=True))
    det = nudity.load_nudenet_native(path, cfg=cfg, labels=LABELS,
                                     conf_threshold=0.3, device="cpu")
    jdet = jnud.load_nudenet_native(path, cfg=jcfg_, labels=LABELS,
                                    conf_threshold=0.3)
    _same_detections(det.full(_images()), jdet.full(_images()))


def test_nudenet_geometry_and_entry_points():
    """NudeNet's operating point (18 classes at 320 px, 2100 anchors) as in
    JAX; the entry points refuse to run without a card unless asked."""
    cfg, jcfg_ = yolo.yolov8n_config(), jyolo.yolov8n_config()
    assert cfg.num_anchors == jcfg_.num_anchors == 2100
    assert len(nudity.NUDENET_LABELS) == cfg.nc == 18
    assert nudity.NUDENET_LABELS == jnud.NUDENET_LABELS
    assert nudity.HARMFUL_LABELS == jnud.HARMFUL_LABELS
    jorder = jyolo.conv_execution_order(jcfg_)
    jshapes = jyolo.conv_shapes(jcfg_)
    shapes = yolo.conv_shapes(cfg)
    assert len(shapes) == len(jorder) == 63
    for name, path in zip(yolo.conv_execution_order(cfg), jorder):
        kh, kw, cin, cout = jshapes[path]
        assert shapes[name] == (cout, cin, kh, kw), name
    model = yolo.YOLOv8(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) + s[0] for s in shapes.values()) + 16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            yolo.YOLOv8(cfg)
        with pytest.raises(RuntimeError):
            nudity.make_native_detector(model.state_dict(), cfg)
    with pytest.raises(RuntimeError, match="NudeNet"):
        nudity.load_nudenet(device="cpu")
