"""Minimal ONNX reader: protobuf wire-format parser for weight extraction
(PyTorch port; a copy of `diffusion_models_moe_tpu/weights/onnx_reader.py`,
which imports nothing of JAX but lives in a package that does).

The NudeNet judge ships as an ONNX file (reference: benchmarks/i2p_eval.py:16
via the nudenet package); the port reads it without `onnx` or
`onnxruntime`. ONNX files are plain protobuf; the wire format is tiny
(varints + length-delimited submessages) and the field numbers below are
stable public schema (onnx/onnx.proto). This module parses just enough of
ModelProto to recover the graph's initializers (name -> ndarray), stored as
`raw_data` or as typed fields (`float_data`, `int32_data`, `int64_data`,
`double_data`), and the Conv nodes in graph order: everything
weights/port_nudenet.py needs to port a YOLOv8 checkpoint into the state
dict of models/yolo.py.

Not a general ONNX runtime: no attribute decoding, no execution, no writing.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

# TensorProto.DataType -> numpy dtype (little-endian raw_data layout)
_DTYPES = {
    1: np.dtype("<f4"),    # FLOAT
    2: np.dtype("u1"),     # UINT8
    3: np.dtype("i1"),     # INT8
    6: np.dtype("<i4"),    # INT32
    7: np.dtype("<i8"),    # INT64
    9: np.dtype("?"),      # BOOL
    10: np.dtype("<f2"),   # FLOAT16
    11: np.dtype("<f8"),   # DOUBLE
}


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value). Length-delimited values are
    bytes; varints are ints; 32/64-bit fixed are raw little-endian bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, val


def _packed_varints(val: object, wire: int) -> list[int]:
    if wire == 0:
        return [int(val)]  # unpacked repeated element
    out = []
    buf = bytes(val)  # packed
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    """TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
    int64_data=7, name=8, raw_data=9, double_data=10."""
    dims: list[int] = []
    dtype_code = 1
    name = ""
    raw: Optional[bytes] = None
    typed: list[np.ndarray] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            dims.extend(_packed_varints(val, wire))
        elif field == 2:
            dtype_code = int(val)
        elif field == 8:
            name = bytes(val).decode("utf-8")
        elif field == 9:
            raw = bytes(val)
        elif field == 4:   # float_data (packed or single fixed32 element)
            typed.append(np.frombuffer(bytes(val), dtype="<f4"))
        elif field in (5, 7):  # int32_data / int64_data (varint packed)
            vals = [v - (1 << 64) if v >= (1 << 63) else v
                    for v in _packed_varints(val, wire)]  # two's complement
            typed.append(np.asarray(vals, dtype=np.int64))
        elif field == 10:  # double_data
            typed.append(np.frombuffer(bytes(val), dtype="<f8"))
        elif field == 13:
            raise ValueError(
                f"tensor '{name}': external data is not supported")
    if dtype_code not in _DTYPES:
        raise ValueError(f"tensor '{name}': unsupported dtype {dtype_code}")
    np_dtype = _DTYPES[dtype_code]
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif typed:
        arr = np.concatenate(typed).astype(np_dtype, copy=False)
    else:
        arr = np.zeros((0,), dtype=np_dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""


def _parse_node(buf: bytes) -> OnnxNode:
    """NodeProto: input=1, output=2, name=3, op_type=4."""
    node = OnnxNode(op_type="", inputs=[], outputs=[])
    for field, _wire, val in _iter_fields(buf):
        if field == 1:
            node.inputs.append(bytes(val).decode("utf-8"))
        elif field == 2:
            node.outputs.append(bytes(val).decode("utf-8"))
        elif field == 3:
            node.name = bytes(val).decode("utf-8")
        elif field == 4:
            node.op_type = bytes(val).decode("utf-8")
    return node


@dataclasses.dataclass
class OnnxGraph:
    initializers: dict[str, np.ndarray]
    nodes: list[OnnxNode]

    def conv_weights_in_order(self) -> list[tuple[np.ndarray,
                                                  Optional[np.ndarray]]]:
        """(weight OIHW, bias-or-None) of every Conv node in graph order:
        torch exports nodes in execution order, so this matches
        models/yolo.py conv_execution_order for a YOLOv8 export."""
        out = []
        for node in self.nodes:
            if node.op_type != "Conv":
                continue
            w = self.initializers.get(node.inputs[1]) if len(
                node.inputs) > 1 else None
            if w is None:
                raise ValueError(
                    f"Conv node '{node.name}': weight '{node.inputs[1:2]}' "
                    "is not an initializer (dynamic weights unsupported)")
            b = None
            if len(node.inputs) > 2 and node.inputs[2]:
                b = self.initializers.get(node.inputs[2])
                if b is None:
                    raise ValueError(
                        f"Conv node '{node.name}': bias is not an initializer")
            out.append((w, b))
        return out


def read_onnx(data: bytes | str) -> OnnxGraph:
    """Parse an ONNX ModelProto (bytes or file path) into its graph's
    initializers and node list. ModelProto.graph is field 7; GraphProto.node
    is field 1 and GraphProto.initializer is field 5."""
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    graph_buf: Optional[bytes] = None
    for field, wire, val in _iter_fields(data):
        if field == 7 and wire == 2:
            graph_buf = bytes(val)
            break
    if graph_buf is None:
        raise ValueError("no GraphProto found: not an ONNX ModelProto?")
    initializers: dict[str, np.ndarray] = {}
    nodes: list[OnnxNode] = []
    for field, wire, val in _iter_fields(graph_buf):
        if field == 5 and wire == 2:
            name, arr = _parse_tensor(bytes(val))
            initializers[name] = arr
        elif field == 1 and wire == 2:
            nodes.append(_parse_node(bytes(val)))
    return OnnxGraph(initializers=initializers, nodes=nodes)
