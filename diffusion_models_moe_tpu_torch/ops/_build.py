"""Builds and loads the hand-written CUDA kernels in `ops/csrc/`, and the
repository's host C++ libraries in `native/`.

Each source is compiled by its own `nvcc` for `sm_90a`, all at once, and the
objects are linked into one shared library with a plain C interface, at
first use, into `ops/_build/` (git-ignored), and loaded with ctypes. The
library's name carries a hash of the sources and flags, so an edited source
is rebuilt. Nothing here runs at import time: the
package imports and runs on a machine without `nvcc` or a GPU, where every
op takes its plain PyTorch version.

A failed build or a refused launch raises; no wrapper falls back to the
plain version. Where a kernel does not take a shape or a dtype, the model
asks the kernel's predicate first and takes the plain version, and counts
that call under `plain:<kernel>` in LAUNCHES.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from diffusion_models_moe_tpu_torch.profiling import annotate

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NATIVE = pathlib.Path(__file__).resolve().parents[2] / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

# Kernel launches made by the wrappers, by kernel name: each wrapper adds one
# where it launches its kernel. A run resets the counts with
# `reset_launch_counts()` and reads them after, to show which kernels ran.
# The `plain:` keys count the calls on CUDA tensors that the model handed to
# a kernel's plain version because the kernel's predicate said no, or
# because a gradient is taken through a kernel that has no backward
# (`grad_through`: every kernel but 2 and 3). The `tp:` keys count the calls
# that tensor parallelism sent past a kernel that cannot take a shard: an FF
# whose output projection is row-parallel takes the unfused path (kernel 4
# over the whole hidden width) where it would have taken kernel 1.
KERNELS = ("geglu_ff_fused", "sd_self_attention", "sd_cross_attention",
           "fused_route_multiply", "ln_qkv_fused", "attn_out_residual_fused",
           "conv3x3_chain", "winograd3x3_fused", "group_norm_nhwc")
PLAIN = tuple(f"plain:{k}" for k in KERNELS)
TP = ("tp:geglu_ff_fused",)
LAUNCHES = dict.fromkeys(KERNELS + PLAIN + TP, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "dmoe_ff_front": [_P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "dmoe_ff_down": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "dmoe_route_multiply": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                            _P, _P, _P],
    "dmoe_sd_self_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                               _I, _LL, _P],
    "dmoe_sd_cross_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                _I, _I, _LL, _P],
    "dmoe_ln_qkv": [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _P,
                    _P],
    "dmoe_attn_out_residual": [_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I,
                               _I, _I, _P, _P, _P],
    "dmoe_conv3x3_chain": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P, _P, _P],
    "dmoe_winograd3x3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                         _P, _P],
    "dmoe_group_norm_nhwc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                             _I, _P, _P, _P, _P],
}
# each launcher's profiler range: `dmoe.kernel.` and its name without `dmoe_`
_RANGES = {name: "dmoe.kernel." + name.removeprefix("dmoe_")
           for name in _SIGNATURES}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded kernel library and how it was built."""
    lib: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float     # 0.0 when an earlier build was reused
    compiler_log: str        # nvcc's output (register and spill report)

    def call(self, name: str, *args) -> None:
        """Calls launcher `name` and raises if CUDA refused the launch. The
        host call is the range `dmoe.kernel.<name without dmoe_>` while the
        profiler runs."""
        with annotate(_RANGES[name]):
            err = getattr(self.lib, name)(*args)
        if err != 0:
            msg = self.lib.dmoe_error_string(err).decode()
            raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def on_card(t: torch.Tensor) -> bool:
    """Whether t lies on a CUDA device, where the wrappers launch kernels."""
    return t.device.type == "cuda"


def grad_through(*tensors) -> bool:
    """Whether autograd records a call on `tensors` (inputs and parameters;
    None entries are skipped): grad mode is on and one of them requires a
    gradient. Kernels 1, 4-8 and the GroupNorm kernel compute forward only,
    so where this holds on the card the model takes their plain versions."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def plain_under_grad(kernels, use_kernels: bool, x: torch.Tensor,
                     *tensors) -> bool:
    """Whether a call of forward-only kernels (a name or names) on `x` and
    `tensors` must take the plain version because autograd records it on
    the card; where so, counts the call under `plain:<kernel>` for each."""
    if not (use_kernels and on_card(x) and grad_through(x, *tensors)):
        return False
    for k in (kernels,) if isinstance(kernels, str) else kernels:
        LAUNCHES[f"plain:{k}"] += 1
    return True


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _compile_and_link(so_path: pathlib.Path) -> str:
    """One `nvcc -c` per source, all started together, then one link.
    Returns the compilers' output; raises if any step fails."""
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = so_path.with_name(f"{so_path.stem}.{src.stem}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    log = "".join(out for out, _ in outs)
    if any(rc != 0 for _, rc in outs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    tmp = so_path.with_suffix(f".{tag}")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    os.replace(tmp, so_path)
    return log


@functools.lru_cache(maxsize=1)
def load_library() -> KernelLibrary:
    """Builds the kernels if needed (once per process) and loads them."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"libdmoe_kernels_{digest.hexdigest()[:16]}.so"
    build_seconds, log = 0.0, ""
    if not so_path.exists():
        t0 = time.perf_counter()
        log = _compile_and_link(so_path)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dmoe_error_string.argtypes = [ctypes.c_int]
    lib.dmoe_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, so_path, build_seconds, log)


@functools.lru_cache(maxsize=None)
def load_host_library(name: str) -> ctypes.CDLL:
    """Builds `native/<name>.cpp` with g++ (once per process, into
    BUILD_DIR, under a name that carries a hash of the source and flags)
    and loads it. The JAX package builds the same sources into `native/`;
    the port keeps its own copy, written to a temporary name and renamed
    into place, so concurrent processes never load a half-written file.
    Raises OSError or CalledProcessError where it cannot build or load."""
    src = NATIVE / f"{name}.cpp"
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if not so_path.exists():
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, so_path)
    return ctypes.CDLL(str(so_path))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA device (the wrappers plan their
    grids against it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def scratch(device: torch.device, sizes) -> tuple[torch.Tensor, list[int]]:
    """One uninitialised device buffer carved into pieces of `sizes` bytes,
    each on a 1024-byte boundary: (the buffer, the pieces' addresses). One
    allocation where a launcher needs several scratch tensors; the caller
    keeps the buffer until its launches are queued (the caching allocator
    reuses it only for later work on the same stream)."""
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total)
        total += -(-size // 1024) * 1024
    buf = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    return buf, [buf.data_ptr() + off for off in offsets]


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current CUDA stream on `device`, as a pointer value."""
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      device: torch.device, contiguous: bool = True) -> None:
    """Raises on what the kernels do not take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
