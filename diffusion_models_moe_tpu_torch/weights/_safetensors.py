"""Reader and writer of the safetensors format, without the `safetensors`
package (the port's GPU host does not have it).

A file is an 8-byte little-endian header length, a JSON header mapping each
tensor's name to `{"dtype", "shape", "data_offsets": [begin, end]}` (offsets
into the data that follows; files written elsewhere may add a
`"__metadata__"` entry of strings, which the reader skips), then the
tensors' raw little-endian bytes, one after another.
"""
from __future__ import annotations

import json
import os
import struct

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
NAMES = {v: k for k, v in DTYPES.items()}
# a header longer than this is not a safetensors header (the package's limit)
MAX_HEADER = 100_000_000


def _header(f, path: str) -> dict:
    (n,) = struct.unpack("<Q", f.read(8))
    if n > MAX_HEADER:
        raise ValueError(f"{path}: header of {n} bytes is not safetensors")
    header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header


def header(path: str) -> dict[str, tuple]:
    """Each tensor's shape, from the header alone (no tensor is read)."""
    with open(path, "rb") as f:
        return {name: tuple(spec["shape"])
                for name, spec in _header(f, path).items()}


def read(path: str) -> dict[str, torch.Tensor]:
    """All tensors of a file, on the CPU, in their stored dtypes. They share
    one buffer that holds the file's data."""
    with open(path, "rb") as f:
        specs = _header(f, path)
        size = os.fstat(f.fileno()).st_size - f.tell()
        data = bytearray(size)
        if f.readinto(memoryview(data)) != size:
            raise ValueError(f"{path}: file ended early")
    out = {}
    for name, spec in specs.items():
        dtype = DTYPES.get(spec["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {spec['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        begin, end = spec["data_offsets"]
        shape = tuple(spec["shape"])
        count = 1
        for d in shape:
            count *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= size or end - begin != count * itemsize:
            raise ValueError(f"{path}: {name}'s offsets {begin}..{end} do not "
                             f"hold {shape} {spec['dtype']}")
        out[name] = (torch.frombuffer(data, dtype=dtype, count=count,
                                      offset=begin).reshape(shape)
                     if count else torch.empty(shape, dtype=dtype))
    return out


def write(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Writes `tensors` (any device) in name order, one tensor at a time
    through host memory, to a temporary file renamed into place."""
    header, offset = {}, 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        if t.dtype not in NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)          # the data starts 8-byte aligned
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    os.replace(tmp, path)
